"""msd_tpu_torch's K2 (the fused SDF loss and gradients) on the CPU:
its plain PyTorch version against msd_tpu's Pallas kernel in interpret mode
and against a torch-autograd oracle, in float32 on small decoders. Weights
are made by msd_tpu from a seed; latents, points and ground truth by numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msd_tpu.models.deepsdf import DeepSDFDecoder as JaxDecoder
from msd_tpu.ops import fused_train as jax_ft
from msd_tpu_torch.losses.sdf import eikonal_loss
from msd_tpu_torch.models.deepsdf import DeepSDFDecoder
from msd_tpu_torch.ops import fused_train as ft
from msd_tpu_torch.utils.checkpoint import msd_tpu_names
from test_torch_decoder import make_pair

CLAMP = 0.1
L = 16


def make_case(weight_norm=False, latent_in=(2,), seed=0, B=4, P=256, width=64, nl=5):
    """The shape of tests/test_fused_train.py:make_case: (jax decoder, jax
    params as numpy, port decoder, lat [B, L], xyz [B, P, 3], gt [B, P])."""
    cfg = dict(dims=[width] * nl, latent_in=list(latent_in), weight_norm=weight_norm,
               norm_layers=list(range(nl)) if weight_norm else [])
    jdec, params, tdec = make_pair(cfg, seed=seed, latent_size=L)
    rng = np.random.default_rng(seed + 1)
    lat = (0.3 * rng.standard_normal((B, L))).astype(np.float32)
    xyz = rng.uniform(-1, 1, (B, P, 3)).astype(np.float32)
    # gt mixing in- and out-of-band values so the clamp mask is exercised
    gt = (0.25 * rng.standard_normal((B, P))).astype(np.float32)
    return jdec, params, tdec, lat, xyz, gt


def to_jax_layout(tdec, grads):
    """{msd_tpu leaf path: numpy} from the port's parameter gradients."""
    out = {}
    for path, name, transposed in msd_tpu_names(tdec):
        g = grads[name].detach().numpy()
        out[path] = g.T if transposed else (g.reshape(-1) if g.ndim == 2 else g)
    return out


def port_fused(tdec, lat, xyz, gt, use_eikonal, dtype=torch.float32):
    """Loss parts and gradients through the port's autograd.Function."""
    tdec.zero_grad()
    z = torch.tensor(lat, requires_grad=True)
    B, P = xyz.shape[:2]
    total, sdf, eik = ft.fused_sdf_loss(tdec, z, torch.tensor(xyz), torch.tensor(gt), CLAMP,
                                        use_eikonal, B * P, dtype=dtype)
    total.backward()
    grads = {n: p.grad.clone() for n, p in tdec.named_parameters()}
    return float(sdf), float(eik), z.grad.numpy(), to_jax_layout(tdec, grads)


def torch_oracle(tdec, lat, xyz, gt, use_eikonal):
    """Stage-1 point losses by torch autograd (create_graph for the
    eikonal), the counterpart of Stage1Trainer.point_losses."""
    tdec.zero_grad()
    B, P = xyz.shape[:2]
    z = torch.tensor(lat, requires_grad=True)
    x = torch.tensor(xyz.reshape(-1, 3), requires_grad=True)
    pred = tdec(torch.cat([z.repeat_interleave(P, 0), x], 1)).clamp(-CLAMP, CLAMP)
    sdf = (pred[:, 0] - torch.tensor(gt.reshape(-1)).clamp(-CLAMP, CLAMP)).abs().sum() / (B * P)
    eik = torch.zeros(())
    if use_eikonal:
        (g,) = torch.autograd.grad(pred.sum(), x, create_graph=True)
        eik = eikonal_loss(g)
    (sdf + eik).backward()
    grads = {n: p.grad.clone() for n, p in tdec.named_parameters()}
    return float(sdf.detach()), float(eik.detach()), z.grad.numpy(), to_jax_layout(tdec, grads)


def assert_match(ours, ref, loss_rtol=1e-5, rtol=2e-4, atol=1e-7):
    sdf, eik, dlat, g = ours
    sdf_r, eik_r, dlat_r, g_r = ref
    np.testing.assert_allclose(sdf, sdf_r, rtol=loss_rtol, atol=1e-7)
    np.testing.assert_allclose(eik, eik_r, rtol=loss_rtol, atol=1e-7)
    np.testing.assert_allclose(dlat, dlat_r, rtol=rtol, atol=atol)
    assert sorted(g) == sorted(g_r)
    for k in g_r:
        np.testing.assert_allclose(g[k], g_r[k], rtol=rtol, atol=atol, err_msg=k)


CASES = {
    "b_latent_in": dict(use_eikonal=True),
    "a_latent_in": dict(use_eikonal=False),
    "b_weight_norm": dict(use_eikonal=True, weight_norm=True),
    "b_no_latent_in": dict(use_eikonal=True, latent_in=()),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_pallas_interpret(case):
    """Tolerances of tests/test_fused_train.py:89-101: loss sums rtol 1e-5,
    gradients rtol 2e-4 / atol 1e-7 (float32, two summation orders)."""
    kw = dict(CASES[case])
    use_eik = kw.pop("use_eikonal")
    jdec, params, tdec, lat, xyz, gt = make_case(**kw)
    B, P = xyz.shape[:2]
    assert ft.supports_fused_train(tdec, P)
    g_net, g_lat, aux = jax_ft.fused_point_grads(
        jdec, jax.tree.map(jnp.asarray, params), jnp.asarray(lat), jnp.asarray(xyz),
        jnp.asarray(gt[..., None]), CLAMP, use_eik, B * P, dtype=jnp.float32, interpret=True,
    )
    flat = {".".join(p.key for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(g_net)[0]}
    ref = (float(aux["sdf"]), float(aux["eikonal"]), np.asarray(g_lat), flat)
    assert_match(port_fused(tdec, lat, xyz, gt, use_eik), ref)


def test_bf16_plain_matches_pallas_interpret_bf16():
    """In bf16 (the card's route) the plain version rounds where the TPU
    kernel rounds: against the Pallas kernel run with bf16 operands in
    interpret mode, every gradient agrees to 1e-5 relative Frobenius (both
    sum exact products of the same bf16 values in float32; only the order
    differs)."""
    jdec, params, tdec, lat, xyz, gt = make_case(seed=7)
    B, P = xyz.shape[:2]
    g_net, g_lat, aux = jax_ft.fused_point_grads(
        jdec, jax.tree.map(jnp.asarray, params), jnp.asarray(lat), jnp.asarray(xyz),
        jnp.asarray(gt[..., None]), CLAMP, True, B * P, dtype=jnp.bfloat16, interpret=True,
    )
    sdf, eik, dlat, g = port_fused(tdec, lat, xyz, gt, True, torch.bfloat16)
    np.testing.assert_allclose([sdf, eik], [float(aux["sdf"]), float(aux["eikonal"])], rtol=1e-5)
    pairs = [(dlat, np.asarray(g_lat))] + [
        (g[".".join(p.key for p in path)], np.asarray(v))
        for path, v in jax.tree_util.tree_flatten_with_path(g_net)[0]]
    for ours, ref in pairs:
        assert np.linalg.norm(ours - ref) <= 1e-5 * np.linalg.norm(ref)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_torch_autograd(case):
    kw = dict(CASES[case])
    use_eik = kw.pop("use_eikonal")
    _, _, tdec, lat, xyz, gt = make_case(seed=3, **kw)
    assert_match(port_fused(tdec, lat, xyz, gt, use_eik), torch_oracle(tdec, lat, xyz, gt, use_eik))


@pytest.mark.parametrize("use_eikonal", [True, False], ids=["b", "a"])
def test_chunked_plain_equals_one_chunk(use_eikonal, monkeypatch):
    """The plain version's scene chunks change nothing but summation order."""
    _, _, tdec, lat, xyz, gt = make_case(seed=5)
    whole = port_fused(tdec, lat, xyz, gt, use_eikonal)
    monkeypatch.setattr(ft, "CHUNK_POINTS", 2 * xyz.shape[1])
    assert_match(port_fused(tdec, lat, xyz, gt, use_eikonal), whole, loss_rtol=1e-6, rtol=1e-5)


def test_bf16_plain_near_float32():
    """bf16 operands (the card's route) against float32 on the same inputs:
    relative Frobenius error of every gradient under 5e-2 and loss sums
    within 1e-2 (bf16 keeps 8 bits of mantissa; h, u, t and delta are
    rounded at every layer)."""
    _, _, tdec, lat, xyz, gt = make_case(seed=7)
    f32 = port_fused(tdec, lat, xyz, gt, True, torch.float32)
    b16 = port_fused(tdec, lat, xyz, gt, True, torch.bfloat16)
    np.testing.assert_allclose(b16[0], f32[0], rtol=1e-2)
    np.testing.assert_allclose(b16[1], f32[1], rtol=1e-2)
    for a, b in [(b16[2], f32[2])] + [(b16[3][k], f32[3][k]) for k in f32[3]]:
        assert np.linalg.norm(a - b) <= 5e-2 * np.linalg.norm(b)


SUPPORT_TABLE = [
    (dict(dims=[64] * 5, latent_in=[2]), 256),
    (dict(dims=[64] * 5, latent_in=[2]), 100),
    (dict(dims=[64] * 5, latent_in=[2], norm_layers=[1]), 256),
    (dict(dims=[64] * 5, latent_in=[2], norm_layers=[1], weight_norm=True), 256),
    (dict(dims=[64] * 5, latent_in=[2], xyz_in_all=True), 256),
    (dict(dims=[64] * 5, latent_in=[2], use_tanh=True), 256),
    (dict(dims=[64] * 5, latent_in=[4]), 256),
    (dict(dims=[64] * 5, latent_in=[3]), 256),
    (dict(dims=[64] * 5, latent_in=[1, 3]), 256),
    (dict(dims=[64] * 5), 128),
]


@pytest.mark.parametrize("cfg,P", SUPPORT_TABLE)
def test_supports_fused_train_agrees_with_jax(cfg, P):
    assert ft.supports_fused_train(DeepSDFDecoder(L, **cfg), P) == jax_ft.supports_fused_train(
        JaxDecoder(L, **cfg), P)


def test_unsupported_config_raises():
    dec = DeepSDFDecoder(L, dims=[32, 32], norm_layers=[0])  # LayerNorm
    with pytest.raises(ft.UnsupportedConfig):
        ft.fused_point_grads(dec, [], [], torch.zeros(1, L), torch.zeros(1, 128, 3), torch.zeros(1, 128),
                             CLAMP, True, 128)


def test_flop_and_byte_counts_at_flagship_width():
    from chip_smoke import design_bytes, step_flops

    dec = DeepSDFDecoder(256, dims=[512] * 8, latent_in=[4])
    assert step_flops(dec, 1, "b") == 2 * 6 * 1573376  # 18.9 MFLOP per point
    assert step_flops(dec, 1, "a") == 2 * 3 * 1573376
    assert step_flops(dec, 1, "d") == 2 * 2 * 1573376  # 6.29 MFLOP per point
    hidden = (7 * 512 + 256) * 2  # bf16 bytes of one point's hidden widths, 253 padded to 256
    assert design_bytes(dec, 1, "b") == hidden * 15 + 64
    assert design_bytes(dec, 1, "a") == hidden * 7 + 64
    # d: h written once and read twice; delta of layers 1-7 written and read once
    assert design_bytes(dec, 1, "d") == hidden * 3 + (hidden - 512 * 2) * 2 + 64


# K2 variant d (want_wgrad=False, the frozen decoder of the Stage-2 step):
# loss and dlat only, against msd_tpu's Pallas kernel built with
# want_wgrad=False in interpret mode.
D_CASES = {
    "latent_in": dict(),
    "weight_norm": dict(weight_norm=True),
    "no_latent_in": dict(latent_in=()),
}


def _port_d(tdec, lat, xyz, gt, dtype=torch.float32):
    B, P = xyz.shape[:2]
    n = tdec.num_layers - 1
    with torch.no_grad():
        weights = [tdec.layer_weight(layer) for layer in range(n)]
        biases = [getattr(tdec, f"lin{layer}").bias for layer in range(n)]
        return ft.fused_point_grads(tdec, weights, biases, torch.tensor(lat), torch.tensor(xyz),
                                    torch.tensor(gt), CLAMP, False, B * P, dtype=dtype, want_wgrad=False)


@pytest.mark.parametrize("case", list(D_CASES))
def test_variant_d_plain_matches_pallas_interpret(case):
    """Loss to rtol 1e-5 and dlat to rtol 2e-4 / atol 1e-7 (the float32
    tolerances of the other variants); no weight gradients at all."""
    jdec, params, tdec, lat, xyz, gt = make_case(seed=11, **D_CASES[case])
    B, P = xyz.shape[:2]
    g_net, g_lat, aux = jax_ft.fused_point_grads(
        jdec, jax.tree.map(jnp.asarray, params), jnp.asarray(lat), jnp.asarray(xyz),
        jnp.asarray(gt[..., None]), CLAMP, False, B * P, dtype=jnp.float32, interpret=True,
        want_net_grads=False,
    )
    dW, db, dlat, sdf, eik = _port_d(tdec, lat, xyz, gt)
    assert dW is None and db is None
    assert all(float(jnp.max(jnp.abs(leaf))) == 0.0 for leaf in jax.tree.leaves(g_net))
    np.testing.assert_allclose(float(sdf), float(aux["sdf"]), rtol=1e-5, atol=1e-7)
    assert float(eik) == 0.0
    np.testing.assert_allclose(dlat.numpy(), np.asarray(g_lat), rtol=2e-4, atol=1e-7)


def test_variant_d_bf16_matches_pallas_interpret_bf16():
    """bf16 operands, as on the card: loss to 1e-5 relative and dlat to 1e-5
    relative Frobenius against the Pallas kernel's bf16 rounding."""
    jdec, params, tdec, lat, xyz, gt = make_case(seed=12)
    B, P = xyz.shape[:2]
    _, g_lat, aux = jax_ft.fused_point_grads(
        jdec, jax.tree.map(jnp.asarray, params), jnp.asarray(lat), jnp.asarray(xyz),
        jnp.asarray(gt[..., None]), CLAMP, False, B * P, dtype=jnp.bfloat16, interpret=True,
        want_net_grads=False,
    )
    _, _, dlat, sdf, _ = _port_d(tdec, lat, xyz, gt, torch.bfloat16)
    np.testing.assert_allclose(float(sdf), float(aux["sdf"]), rtol=1e-5)
    ref = np.asarray(g_lat)
    assert np.linalg.norm(dlat.numpy() - ref) <= 1e-5 * np.linalg.norm(ref)


def test_variant_d_equals_variant_a_dlat(monkeypatch):
    """d is a without the weight gradients: the same loss and dlat, bit for
    bit, also across scene chunks."""
    _, _, tdec, lat, xyz, gt = make_case(seed=13)
    B, P = xyz.shape[:2]
    n = tdec.num_layers - 1
    with torch.no_grad():
        weights = [tdec.layer_weight(layer) for layer in range(n)]
        biases = [getattr(tdec, f"lin{layer}").bias for layer in range(n)]
        a = ft.fused_point_grads(tdec, weights, biases, torch.tensor(lat), torch.tensor(xyz), torch.tensor(gt),
                                 CLAMP, False, B * P, dtype=torch.float32)
    d = _port_d(tdec, lat, xyz, gt)
    assert torch.equal(a[2], d[2]) and torch.equal(a[3], d[3])
    monkeypatch.setattr(ft, "CHUNK_POINTS", 2 * P)
    chunked = _port_d(tdec, lat, xyz, gt)
    np.testing.assert_allclose(chunked[2].numpy(), d[2].numpy(), rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(float(chunked[3]), float(d[3]), rtol=1e-6)


def test_variant_d_refuses_eikonal():
    _, _, tdec, lat, xyz, gt = make_case(seed=13, B=1, P=128)
    n = tdec.num_layers - 1
    with torch.no_grad(), pytest.raises(ValueError, match="want_wgrad"):
        ft.fused_point_grads(tdec, [tdec.layer_weight(i) for i in range(n)],
                             [getattr(tdec, f"lin{i}").bias for i in range(n)], torch.tensor(lat),
                             torch.tensor(xyz), torch.tensor(gt), CLAMP, True, 128, want_wgrad=False)


@pytest.mark.parametrize("train_net", [True, False], ids=["a", "d"])
def test_fused_sdf_l1_matches_make_fused_sdf_l1(train_net):
    """The port's Stage-2 SDF-consistency term against msd_tpu's
    make_fused_sdf_l1 (interpret mode) through a nonlinear consumer, as
    tests/test_fused_train.py:353-430: value rtol 1e-5, gradients rtol 2e-4 /
    atol 1e-7; with train_net=False the decoder takes no gradient."""
    jdec, params, tdec, lat, xyz, gt = make_case(weight_norm=True, seed=14)
    fused_j = jax_ft.make_fused_sdf_l1(jdec, CLAMP, dtype=jnp.float32, interpret=True, train_net=train_net)

    def chained(p, z):
        return jnp.tanh(3.0 * fused_j(p, z, jnp.asarray(xyz), jnp.asarray(gt[..., None]))) * 2.0

    v_j, (g_net_j, g_lat_j) = jax.value_and_grad(chained, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(lat))
    tdec.zero_grad()
    z = torch.tensor(lat, requires_grad=True)
    v = torch.tanh(3.0 * ft.fused_sdf_l1(tdec, z, torch.tensor(xyz), torch.tensor(gt), CLAMP,
                                         train_net=train_net, dtype=torch.float32)) * 2.0
    v.backward()
    np.testing.assert_allclose(float(v.detach()), float(v_j), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(g_lat_j), rtol=2e-4, atol=1e-7)
    if not train_net:
        assert all(p.grad is None for p in tdec.parameters())
        return
    ours = to_jax_layout(tdec, {n: p.grad for n, p in tdec.named_parameters()})
    flat = {".".join(p.key for p in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(g_net_j)[0]}
    assert sorted(ours) == sorted(flat)
    for k in flat:
        np.testing.assert_allclose(ours[k], flat[k], rtol=2e-4, atol=1e-7, err_msg=k)
