"""msd_tpu_torch's SIREN and local-shapes decoders against msd_tpu's, in
float32 on the CPU: msd_tpu's seeded params go into the port through each
module's ``params_from_jax``, and the same numpy inputs through both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msd_tpu.models.local_shapes import LocalShapesDecoder as JaxLocal
from msd_tpu.models.pointnet import batch_norm_apply
from msd_tpu.models.siren import SirenDecoder as JaxSiren
from msd_tpu_torch.mesh import PointEvaluator
from msd_tpu_torch.models import build_decoder
from msd_tpu_torch.models import local_shapes, siren
from msd_tpu_torch.models.common import BatchNorm

LATENT = 16
SIREN = dict(dims=[64, 64, 64, 64], latent_in=[2], xyz_in=[2], norm_layers=[], weight_norm=False)
SIREN_CASES = {
    "sine": dict(nonlinearity="sine"),
    "relu": dict(nonlinearity="relu"),
    "sine_relu_line": dict(nonlinearity="sine_relu_line"),
    "sine_relu_plane": dict(nonlinearity="sine_relu_plane"),
    "fourier": dict(nonlinearity="sine", encoding_features=16, encoding_sigma=1.2, xyz_in_all=True),
    "weight_norm": dict(nonlinearity="relu", weight_norm=True, norm_layers=[0, 1, 3], use_tanh=True),
    "batch_norm": dict(nonlinearity="relu", norm_layers=[0, 2, 3]),
}


def _siren_pair(case, seed=0):
    cfg = dict(SIREN, **SIREN_CASES[case])
    jdec = JaxSiren(LATENT, **cfg)
    params = jax.tree.map(np.asarray, jdec.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)
    for k, p in params.items():  # blends, BatchNorm affine and statistics away from their init
        if k.startswith("nl_"):
            params[k] = (p + 0.2 * rng.standard_normal(p.shape)).astype(np.float32)
        elif k.startswith("bn"):
            params[k] = {"scale": 1 + 0.1 * rng.standard_normal(p["scale"].shape),
                         "bias": 0.1 * rng.standard_normal(p["bias"].shape),
                         "mean": 0.1 * rng.standard_normal(p["mean"].shape),
                         "var": 1 + 0.2 * rng.uniform(size=p["var"].shape)}
            params[k] = {n: v.astype(np.float32) for n, v in params[k].items()}
    tdec = build_decoder("siren_decoder", LATENT, cfg)
    tdec.load_state_dict(siren.params_from_jax(tdec, params))
    return jdec, params, tdec


def _inputs(n=200, seed=2):
    rng = np.random.default_rng(seed)
    return np.concatenate([0.3 * rng.standard_normal((n, LATENT)), rng.uniform(-1, 1, (n, 3))], 1).astype(np.float32)


@pytest.mark.parametrize("case", list(SIREN_CASES))
def test_siren_matches_jax(case):
    """Eval mode against apply(train=False); every SIREN param loaded."""
    jdec, params, tdec = _siren_pair(case)
    assert len(tdec.state_dict()) == len(jax.tree.leaves(params))
    x = _inputs()
    ref = np.asarray(jdec.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    with torch.no_grad():
        ours = tdec.eval()(torch.tensor(x)).numpy()
    assert ours.shape == (200, 1)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)


def test_siren_batch_norm_train_mode_matches_jax():
    """Training mode: the batch's statistics, as apply(train=True); the
    running statistics stay as loaded (msd_tpu drops the new ones)."""
    jdec, params, tdec = _siren_pair("batch_norm")
    x = _inputs()
    ref = np.asarray(jdec.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x), train=True))
    before = {k: v.clone() for k, v in tdec.state_dict().items() if "running" in k}
    out = tdec.train()(torch.tensor(x))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-4, atol=1e-5)
    after = {k: v for k, v in tdec.state_dict().items() if "running" in k}
    assert before and all(torch.equal(before[k], after[k]) for k in before)
    eval_out = tdec.eval()(torch.tensor(x)).detach().numpy()
    assert not np.allclose(eval_out, ref, rtol=1e-3)  # eval mode reads the running statistics


def test_batch_norm_matches_jax():
    """``models.common.BatchNorm`` against ``msd_tpu``'s ``batch_norm_apply``
    in both modes, over [N, C] and [B, N, C]; the running statistics stay
    as they were."""
    rng = np.random.default_rng(3)
    p = {"scale": 1 + 0.1 * rng.standard_normal(8), "bias": 0.1 * rng.standard_normal(8),
         "mean": 0.1 * rng.standard_normal(8), "var": 1 + 0.2 * rng.uniform(size=8)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    bn = BatchNorm(8)
    bn.load_state_dict({"weight": torch.tensor(p["scale"]), "bias": torch.tensor(p["bias"]),
                        "running_mean": torch.tensor(p["mean"]), "running_var": torch.tensor(p["var"])})
    for shape in ((50, 8), (3, 20, 8)):
        x = rng.standard_normal(shape).astype(np.float32)
        for train in (True, False):
            y, _ = batch_norm_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), train)
            with torch.no_grad():
                ours = bn.train(train)(torch.tensor(x))
            np.testing.assert_allclose(ours.numpy(), np.asarray(y), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(bn.running_mean.numpy(), p["mean"])
    np.testing.assert_array_equal(bn.running_var.numpy(), p["var"])


def test_siren_init_is_seeded_and_bounded():
    cfg = dict(SIREN, nonlinearity="sine", encoding_features=8, encoding_sigma=2.0)
    a = build_decoder("siren_decoder", LATENT, cfg, generator=torch.Generator().manual_seed(1))
    b = build_decoder("siren_decoder", LATENT, cfg, generator=torch.Generator().manual_seed(1))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    in0 = a.lin0.weight.shape[1]
    assert float(a.lin0.weight.detach().abs().max()) <= 1.0 / in0
    in1 = a.lin1.weight.shape[1]
    assert float(a.lin1.weight.detach().abs().max()) <= np.sqrt(6.0 / in1) / 30.0
    assert 2.0 < float(a.encoding_B.detach().std()) < 6.0  # sigma^2 = 4 as the std
    with pytest.raises(ValueError, match="TOO SMALL"):
        build_decoder("siren_decoder", LATENT, dict(dims=[16, 16], latent_in=[1]))


def _local_pair(seed=0):
    cfg = dict(dims=[64, 64, 64], grid_size=4, global_latent_size=8, latent_in=[2], weight_norm=True,
               norm_layers=[0, 1])
    jdec = JaxLocal(LATENT, **cfg)
    params = jax.tree.map(np.asarray, jdec.init(jax.random.PRNGKey(seed)))
    tdec = build_decoder("local_decoder", LATENT, cfg)
    tdec.load_state_dict(local_shapes.params_from_jax(tdec, params))
    return jdec, params, tdec


def test_local_shapes_matches_jax():
    """Three shapes' 4^3 grids; points inside the box and beyond it (the
    edge cell extrapolates), through msd_tpu's per-point grid gather and
    the port's corner gather."""
    jdec, params, tdec = _local_pair()
    rng = np.random.default_rng(5)
    codes = (0.1 * rng.standard_normal((3, 64, LATENT))).astype(np.float32)
    xyz = rng.uniform(-1.1, 1.1, (300, 3)).astype(np.float32)
    xyz[:3] = [[-1, -1, -1], [1, 1, 1], [0.0, 0.5, -0.5]]
    glob = (0.2 * rng.standard_normal((300, 8))).astype(np.float32)
    idx = rng.integers(0, 3, 300)
    ref = np.asarray(jdec.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(xyz), jnp.asarray(glob),
                                jnp.asarray(codes), jnp.asarray(idx)))
    t = torch.tensor
    with torch.no_grad():
        ours = tdec.eval()(t(xyz), t(glob), t(codes), t(idx)).numpy()
        interp = tdec.interpolate(t(xyz), t(codes), t(idx)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)
    grids = codes.reshape(3, 4, 4, 4, LATENT)
    for i in range(3):
        one = np.asarray(jdec.trilinear_interpolate(jnp.asarray(xyz[i:i + 1]), jnp.asarray(grids[idx[i]])))
        np.testing.assert_allclose(interp[i:i + 1], one, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(interp[0], grids[idx[0], 0, 0, 0], atol=1e-7)  # a grid corner
    np.testing.assert_allclose(interp[1], grids[idx[1], 3, 3, 3], atol=1e-7)
    assert tdec.init_local_codes(2, generator=torch.Generator().manual_seed(0)).shape == (2, 64, LATENT)


def test_other_decoders_take_the_plain_decoder_in_point_evaluator():
    """K1 serves DeepSDFDecoder only (msd_tpu/ops/fused_mlp.py:21):
    ``FusedDecoderSpec`` refuses a SIREN decoder with UnsupportedConfig, so
    ``PointEvaluator`` evaluates it through the decoder itself."""
    _, _, tdec = _siren_pair("sine")
    ev = PointEvaluator(tdec.eval())
    assert not ev.fused
    x = _inputs(50)
    latent, pts = x[0, :LATENT], x[:, LATENT:]
    with torch.no_grad():
        ref = tdec(torch.tensor(np.concatenate([np.broadcast_to(latent, (50, LATENT)), pts], 1)))[:, 0]
    torch.testing.assert_close(ev.eval_points(latent, pts), ref)
