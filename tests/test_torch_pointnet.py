"""msd_tpu_torch's point encoders against msd_tpu's, in float32 on the CPU:
BatchNorm with its running statistics, PointNetEncoder, ResnetPointnet and
PointNet2Encoder (with FPS and the ball query alone) and PointNetLatentVAE.
msd_tpu's seeded params (BatchNorm affine and statistics moved off their
init) go into the port through ``params_from_jax``; the same numpy inputs,
and msd_tpu's FPS starts and reparameterisation noise, go through both.
PointNet++'s widths are fixed (512 and 128 centres), so clouds stay small:
B <= 4, N <= 256."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msd_tpu.models import pointnet as jpn
from msd_tpu.models import pointnet2 as jpn2
from msd_tpu.models.pointnet_vae import PointNetLatentVAE as JaxVAE
from msd_tpu_torch.models import pointnet, pointnet2
from msd_tpu_torch.models.common import BatchNorm
from msd_tpu_torch.models.pointnet_vae import PointNetLatentVAE

LATENT = 8
B, N = 4, 256
ENCODERS = {
    "pointnet_encoder": (jpn.PointNetEncoder, pointnet.PointNetEncoder, pointnet.pointnet_encoder_from_jax),
    "resnet_pointnet": (jpn.ResnetPointnet, pointnet.ResnetPointnet, pointnet.resnet_pointnet_from_jax),
    "pointnet2": (jpn2.PointNet2Encoder, pointnet2.PointNet2Encoder, pointnet2.pointnet2_from_jax),
}


def close(ours, ref, what, rtol=1e-5):
    """rtol 1e-5 with an absolute floor of 1e-5 of the reference's largest
    entry (as tests/test_torch_stage2.py's ``close``)."""
    ours = ours.detach().numpy() if torch.is_tensor(ours) else np.asarray(ours)
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=rtol * float(np.abs(ref).max()) + 1e-30, err_msg=what)


# PointNet++ in training mode normalises SA1's first layer over B x 512 x 32
# grouped rows whose channels have a std near 0.01 beside a mean near 0.5.
# msd_tpu's float32 mean of such a channel is 9.3e-6 off its float64 value
# (the port's 1e-7), about 1e-3 after normalising, and the nine BatchNorms
# after it carry that on: msd_tpu's outputs sit 2.0-2.5e-3 of their largest
# entry from a float64 run of the same module, its running statistics
# 2.1e-4 (the port's float32 run: 1.5-2.7e-5 and 1.9e-6). So training-mode
# PointNet++ is held to msd_tpu at 1e-2 and to the port's own float64 run
# at 1e-4 (outputs) and 1e-5 (statistics). Its gradients go back through
# those BatchNorms, which subtract each channel's mean gradient: msd_tpu's
# float32 SA1 gradients sit 6.5e-2 and 1.02e-1 of the largest gradient
# from a float64 run for two probe functions of (mu, logvar), the port's
# float32 ones 2.1e-3 (measured). So float32 gradients are held to the
# float64 run at 1e-2 of the largest and to msd_tpu's float32 ones at 2e-1
# (the Stage-2 step, tests/test_torch_stage2_points.py), and the two
# packages' float64 gradients to each other at 1e-3
# (test_pointnet2_train_gradients).
PN2_TRAIN_RTOL = {"jax": 1e-2, "float64": 1e-4, "grad_jax": 2e-1, "grad_float64": 1e-2}


def float64_run(module, x, **kw):
    """The module's outputs and state, computed in float64 on a copy."""
    m64 = copy.deepcopy(module).double()
    out = m64(torch.tensor(x).double(), **kw)
    return out, m64.state_dict()


def cloud(b=B, n=N, seed=0):
    """b clouds of n points on jittered ellipsoids in [-0.8, 0.8]^3."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((b, n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    axes = rng.uniform(0.3, 0.7, (b, 1, 3))
    return (d * axes + 0.01 * rng.standard_normal((b, n, 3))).astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def perturb_bns(tree, rng):
    """Every BatchNorm dict of an msd_tpu params tree moved off its init."""
    if isinstance(tree, dict) and set(tree) == {"scale", "bias", "mean", "var"}:
        c = tree["scale"].shape
        return {"scale": (1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(c)).astype(np.float32),
                "mean": (0.1 * rng.standard_normal(c)).astype(np.float32),
                "var": (1 + 0.2 * rng.uniform(size=c)).astype(np.float32)}
    if isinstance(tree, dict):
        return {k: perturb_bns(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [perturb_bns(v, rng) for v in tree]
    return tree


def fps_starts(key, b, n):
    """The FPS starts PointNet2Encoder.apply draws from ``key``
    (msd_tpu/models/pointnet2.py:33, :140)."""
    k1, k2 = jax.random.split(key)
    s1 = jax.random.randint(k1, (b,), 0, n)
    s2 = jax.random.randint(k2, (b,), 0, jpn2.PointNet2Encoder.SA_CONFIG[0]["npoint"])
    return torch.tensor(np.asarray(s1)).long(), torch.tensor(np.asarray(s2)).long()


def encoder_pair(name, kl, seed=0):
    jcls, tcls, from_jax = ENCODERS[name]
    jenc = jcls(latent_size=LATENT, kl_div_loss=kl)
    params = perturb_bns(_np(jenc.init(jax.random.PRNGKey(seed))), np.random.default_rng(seed + 1))
    tenc = tcls(latent_size=LATENT, kl_div_loss=kl)
    tenc.load_state_dict(from_jax(params))
    return jenc, params, tenc


# ---------------------------------------------------------------------------
# BatchNorm


@pytest.mark.parametrize("shape", [(4, 32, 16), (2, 8, 6, 16), (1, 16)])
def test_batch_norm_updates_running_stats_as_jax(shape):
    """Training mode: output and the updated running statistics (biased
    variance to normalise, unbiased to update, momentum 0.1) against
    ``batch_norm_apply``; eval mode: the running statistics. One row (n = 1)
    divides by max(n - 1, 1)."""
    rng = np.random.default_rng(3)
    p = perturb_bns({"scale": np.ones(16), "bias": np.zeros(16), "mean": np.zeros(16), "var": np.ones(16)}, rng)
    x = (2 * rng.standard_normal(shape) + 0.5).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    y_ref, stats = jpn.batch_norm_apply(jp, jnp.asarray(x), True)
    bn = BatchNorm(16, update_stats=True)
    bn.load_state_dict({"weight": torch.tensor(p["scale"]), "bias": torch.tensor(p["bias"]),
                        "running_mean": torch.tensor(p["mean"]), "running_var": torch.tensor(p["var"])})
    xt = torch.tensor(x, requires_grad=True)
    y = bn.train()(xt)
    close(y, y_ref, "train output")
    close(bn.running_mean, stats["mean"], "running mean")
    close(bn.running_var, stats["var"], "running var")
    y.sum().backward()  # the update is outside the graph
    assert bn.running_mean.grad_fn is None and not bn.running_var.requires_grad
    y_eval, none = jpn.batch_norm_apply(dict(jp, mean=stats["mean"], var=stats["var"]), jnp.asarray(x), False)
    assert none is None
    close(bn.eval()(torch.tensor(x)).detach(), y_eval, "eval output")
    before = bn.running_mean.clone()
    bn.eval()(torch.tensor(x))
    assert torch.equal(before, bn.running_mean)  # eval mode leaves them


def test_batch_norm_without_switch_keeps_stats():
    """The default (SIREN's): training mode never touches the statistics."""
    bn = BatchNorm(8)
    bn.train()(torch.randn(5, 8))
    assert torch.equal(bn.running_mean, torch.zeros(8)) and torch.equal(bn.running_var, torch.ones(8))


# ---------------------------------------------------------------------------
# FPS, ball query, grouping


@pytest.mark.parametrize("b,n,npoint", [(3, 256, 128), (2, 200, 200), (2, 100, 160), (1, 64, 512)])
def test_fps_indices_equal_jax(b, n, npoint):
    """The same start, the same indices, also when npoint > n (index 0
    repeats once every point is taken)."""
    x = cloud(b, n, seed=n)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        ref = np.asarray(jpn2.farthest_point_sample(key, jnp.asarray(x), npoint))
        start = torch.tensor(np.asarray(jax.random.randint(key, (b,), 0, n))).long()
        ours = pointnet2.farthest_point_sample(torch.tensor(x), npoint, start).numpy()
        np.testing.assert_array_equal(ours, ref)
    if npoint > n:
        assert (ours[:, n:] == 0).all()


@pytest.mark.parametrize("radius,nsample,s", [(0.2, 32, 64), (0.4, 64, 128), (0.05, 8, 32)])
def test_ball_query_equal_jax(radius, nsample, s):
    """Neighbour indices equal, apart from centres with a pair within 1e-5
    of r^2 (float32 may put it on either side in either package); the test
    prints how many it left out. Ragged rows and empty balls included at
    r = 0.05."""
    x = cloud(2, 256, seed=7)
    centres = x[:, :s] + np.float32(0.02)
    ref = np.asarray(jpn2.query_ball_point(radius, nsample, jnp.asarray(x), jnp.asarray(centres)))
    ours = pointnet2.query_ball_point(radius, nsample, torch.tensor(x), torch.tensor(centres)).numpy()
    d = ((centres[:, :, None, :].astype(np.float64) - x[:, None, :, :]) ** 2).sum(-1)
    keep = ~(np.abs(d - radius * radius) < 1e-5).any(-1)
    print(f"ball query r={radius}: {int((~keep).sum())} of {keep.size} centres left out (pair within 1e-5 of r^2)")
    assert keep.mean() > 0.9
    np.testing.assert_array_equal(ours[keep], ref[keep])
    close(pointnet2.square_distance(torch.tensor(centres), torch.tensor(x)),
          jpn2.square_distance(jnp.asarray(centres), jnp.asarray(x)), "square_distance")


def test_sample_and_group_matches_jax():
    x = cloud(2, 256, seed=9)
    feats = np.random.default_rng(9).standard_normal((2, 256, 5)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    new_xyz, grouped = jpn2.sample_and_group(key, 64, 0.4, 16, jnp.asarray(x), jnp.asarray(feats))
    start = torch.tensor(np.asarray(jax.random.randint(key, (2,), 0, 256))).long()
    ox, og = pointnet2.sample_and_group(64, 0.4, 16, torch.tensor(x), torch.tensor(feats), start)
    np.testing.assert_array_equal(ox.numpy(), np.asarray(new_xyz))
    close(og, grouped, "grouped points")


# ---------------------------------------------------------------------------
# encoders


@pytest.fixture(scope="module")
def encoder_refs():
    """msd_tpu's outputs, in train and eval mode with KL on and off, and its
    updated params after the train-mode call, for each encoder."""
    x = cloud()
    refs = {}
    for name, (jcls, _, _) in ENCODERS.items():
        for kl in (True, False):
            jenc, params, _ = encoder_pair(name, kl)
            jp = jax.tree.map(jnp.asarray, params)
            kw = {"rng": jax.random.PRNGKey(5)} if name == "pointnet2" else {}
            out_t, upd = jax.jit(lambda p, xx, kw: jenc.apply(p, xx, train=True, **kw))(jp, jnp.asarray(x), kw)
            new_params = _np(jenc.update_bn_stats(jp, upd))
            out_e, _ = jax.jit(lambda p, xx, kw: jenc.apply(p, xx, train=False, **kw))(jp, jnp.asarray(x), kw)
            refs[name, kl] = (_np(out_t), new_params, _np(out_e), upd)
    return x, refs


@pytest.mark.parametrize("kl", [True, False], ids=["kl", "no_kl"])
@pytest.mark.parametrize("name", list(ENCODERS))
def test_encoder_matches_jax(encoder_refs, name, kl):
    """Eval mode: (mu, logvar) or z. Training mode: the same, then every
    state entry (parameters unchanged, running statistics as
    ``update_bn_stats(bn_updates)``); with KL on the z head's statistics
    stay put, as msd_tpu's are None in ``bn_updates``."""
    x, refs = encoder_refs
    out_t, new_params, out_e, upd = refs[name, kl]
    _, params, tenc = encoder_pair(name, kl)
    from_jax = ENCODERS[name][2]
    kw = {"fps_start": fps_starts(jax.random.PRNGKey(5), B, N)} if name == "pointnet2" else {}
    with torch.no_grad():
        got_e = tenc.eval()(torch.tensor(x), **kw)
    for o, r in zip(jax.tree.leaves(got_e), jax.tree.leaves(out_e)):
        close(o, r, f"{name} eval")
    pn2 = name == "pointnet2"
    rtol = PN2_TRAIN_RTOL["jax"] if pn2 else 1e-5
    if pn2:
        out64, sd64 = float64_run(tenc.train(), x, **kw)
    got_t = tenc.train()(torch.tensor(x), **kw)
    for o, r in zip(jax.tree.leaves(got_t), jax.tree.leaves(out_t)):
        close(o, r, f"{name} train", rtol=rtol)
    ref_sd = from_jax(new_params)
    sd = tenc.state_dict()
    assert sorted(sd) == sorted(ref_sd)
    for k, v in ref_sd.items():
        close(sd[k], v, f"{name} {k}", rtol=rtol)
    if pn2:
        for o, r in zip(jax.tree.leaves(got_t), jax.tree.leaves(out64)):
            close(o, r.detach().numpy(), "pointnet2 train vs float64", rtol=PN2_TRAIN_RTOL["float64"])
        for k, v in sd64.items():
            close(sd[k], v.numpy(), f"pointnet2 {k} vs float64")
    if name != "resnet_pointnet":
        assert (upd["heads"].get("z") is None) == kl
        assert torch.equal(sd["fc_z.bn.running_mean"], torch.tensor(params["fc_z"]["bn"]["mean"])) == kl


def test_pointnet2_train_gradients():
    """Training-mode PointNet++'s outputs and parameter gradients of a fixed
    linear function of (mu, logvar), in float64: msd_tpu's (params in
    float64 under jax.enable_x64, its FPS starts drawn there) against a
    float64 copy of the port's module: outputs to 1e-4 and gradients to
    1e-3 of the largest entry (measured up to 6.5e-7 and 1.2e-4: msd_tpu
    casts the clouds to float32 and groups them in float32, the float64
    copy of the port in float64). Then the port's float32 gradients
    against its float64 ones, to ``PN2_TRAIN_RTOL["grad_float64"]`` of the
    largest."""
    jenc, params, tenc = encoder_pair("pointnet2", True)
    x = cloud()
    key = jax.random.PRNGKey(5)
    rng = np.random.default_rng(6)
    w_mu, w_lv = (rng.standard_normal((B, LATENT)) for _ in range(2))
    with jax.enable_x64(True):
        starts = fps_starts(key, B, N)

        def jax_loss(p):
            (mu, lv), _ = jenc.apply(p, jnp.asarray(x, jnp.float64), train=True, rng=key)
            return jnp.sum(mu * w_mu) + jnp.sum(lv * w_lv), (mu, lv)

        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        (_, ref_out), ref = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(p64)
        ref = {k: v.numpy() for k, v in pointnet2.pointnet2_from_jax(_np(ref)).items()}

    def grads(dtype):
        m = copy.deepcopy(tenc).to(dtype).train()
        mu, lv = m(torch.tensor(x).to(dtype), fps_start=starts)
        ((mu * torch.tensor(w_mu).to(dtype)).sum() + (lv * torch.tensor(w_lv).to(dtype)).sum()).backward()
        return (mu, lv), {k: p.grad.double() for k, p in m.named_parameters() if p.grad is not None}

    (_, g32), (out64, g64) = grads(torch.float32), grads(torch.float64)
    for o, r in zip(out64, ref_out):
        close(o, r, "float64 outputs", rtol=1e-4)
    assert sorted(g64) == sorted(k for k in ref if "running_" not in k and not k.startswith("fc_z."))
    scale = max(float(v.abs().max()) for v in g64.values())
    for k, g in g64.items():
        assert float(np.abs(g.numpy() - ref[k]).max()) <= 1e-3 * scale, k
        assert float((g32[k] - g).abs().max()) <= PN2_TRAIN_RTOL["grad_float64"] * scale, k


def test_resnet_pointnet_inits():
    """fc_1 starts at zero (ref :135), the heads' biases at zero and
    fc_logvar's weights at 0.01 times a standard normal (ref :156-167)."""
    enc = pointnet.ResnetPointnet(latent_size=LATENT, kl_div_loss=True, generator=torch.Generator().manual_seed(0))
    assert all(torch.count_nonzero(b.fc_1.weight) == 0 for b in enc.blocks)
    assert all(torch.count_nonzero(getattr(enc, h).bias) == 0 for h in ("fc_c", "fc_mu", "fc_logvar"))
    assert 0.5 < float(enc.fc_mu.weight.detach().std()) < 1.5 and 0.005 < float(enc.fc_logvar.weight.detach().std()) < 0.015


# ---------------------------------------------------------------------------
# PointNetLatentVAE


@pytest.mark.parametrize("kind", ["pointnet", "pointnet2", "pointnet++", "pointnet_encoder", "resnet_pointnet"])
def test_point_vae_matches_jax(kind):
    """{mu, logvar, z, z_hat} in training mode from msd_tpu's key chain
    (split(rng, 4) -> k_enc, k_rep, k_dec; PointNet++ splits k_enc), and the
    BatchNorm statistics after it (PointNet++ at ``PN2_TRAIN_RTOL``); decode
    on its own."""
    jv = JaxVAE(latent_dim=LATENT, output_dim=16, encoder_type=kind, decoder_hidden_dims=(8, 16))
    params = perturb_bns(_np(jv.init(jax.random.PRNGKey(1))), np.random.default_rng(2))
    x = cloud(seed=11)
    key = jax.random.PRNGKey(21)
    ref = jax.jit(lambda p, xx, k: jv.apply(p, xx, rng=k, train=True))(jax.tree.map(jnp.asarray, params),
                                                                      jnp.asarray(x), key)
    _, k_enc, k_rep, _ = jax.random.split(key, 4)
    noise = torch.tensor(np.asarray(jax.random.normal(k_rep, (B, LATENT))))
    tv = PointNetLatentVAE(latent_dim=LATENT, output_dim=16, encoder_type=kind, decoder_hidden_dims=(8, 16))
    tv.load_state_dict(tv.params_from_jax(params))
    fps = fps_starts(k_enc, B, N) if kind in ("pointnet2", "pointnet++") else None
    rtol = PN2_TRAIN_RTOL["jax"] if fps is not None else 1e-5
    out = tv.train()(torch.tensor(x), noise=noise, fps_start=fps)
    for k in ("mu", "logvar", "z", "z_hat"):
        close(out[k], ref[k], f"{kind} {k}", rtol=rtol)
    new = tv.params_from_jax(_np(jv.update_bn_stats(jax.tree.map(jnp.asarray, params), ref["bn_updates"])))
    for k, v in tv.state_dict().items():
        close(v, new[k], f"{kind} {k}", rtol=rtol)
    z = np.random.default_rng(0).standard_normal((3, LATENT)).astype(np.float32)
    close(tv.eval().decode(torch.tensor(z)).detach(), jv.decode(jax.tree.map(jnp.asarray, params), jnp.asarray(z)),
          "decode")


def test_point_vae_draws_from_generator():
    """Without noise or FPS starts the VAE draws both from the generator:
    the same seed, the same outputs; another seed, others."""
    tv = PointNetLatentVAE(latent_dim=LATENT, output_dim=16, decoder_hidden_dims=(8, 16)).eval()
    x = torch.tensor(cloud(2, 128, seed=1))
    with torch.no_grad():
        a, b, c = (tv(x, generator=torch.Generator().manual_seed(s)) for s in (0, 0, 1))
    assert torch.equal(a["z"], b["z"]) and not torch.equal(a["z"], c["z"])
    with pytest.raises(ValueError, match="Unsupported encoder_type"):
        PointNetLatentVAE(encoder_type="dgcnn")
