"""The fused fit's host side (``msd_tpu_torch/ops/fused_fit.py``) on the CPU:
the decoder's folding (per-shape constants, xyz weights, transposed
weights), the row padding and the map from column sums to the latent
gradient, run through the plain float64 chain, against the reconstruct
loop's autograd route; and the route each decoder and device takes. The
kernels themselves run only on the card (``tests/test_torch_cuda.py``)."""

import json
import os

import numpy as np
import pytest
import torch

from msd_tpu_torch.models import build_decoder
from msd_tpu_torch.models.deepsdf import DeepSDFDecoder, give_surface_
from msd_tpu_torch.ops import fused_fit
from msd_tpu_torch.train import reconstruct

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "examples", "ADNI", "minimal_eikonal", "specs.json")


def flagship(generator):
    with open(FLAGSHIP) as f:
        specs = json.load(f)
    return build_decoder(specs["NetworkArch"], specs["CodeLength"], specs["NetworkSpecs"], generator=generator)


# (decoder, shapes, rows per shape): the flagship at a small n; latent_in at
# another layer, with weight norm on every layer; and n below a tile and not
# a multiple of one (the half batch)
CASES = {
    "flagship": (lambda g: flagship(g), 2, 200),
    "latent_in_2_weight_norm": (lambda g: DeepSDFDecoder(16, [48, 64, 40, 32], latent_in=[2], weight_norm=True,
                                                         norm_layers=[0, 1, 2, 3], generator=g), 3, 130),
    "half_batch": (lambda g: DeepSDFDecoder(16, [32] * 6, latent_in=[3], weight_norm=True, generator=g), 3, 61),
}


def _inputs(L, S, n, seed):
    rng = np.random.default_rng(seed)
    latent = torch.tensor(0.3 * rng.standard_normal((S, 1, L)), dtype=torch.float64)
    xyz = rng.uniform(-1, 1, (S, n, 3))
    sdf = np.linalg.norm(xyz, axis=2, keepdims=True) - 0.6
    return latent, torch.tensor(np.concatenate([xyz, sdf], axis=2), dtype=torch.float64)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_chain_matches_autograd_float64(case):
    make, S, n = CASES[case]
    dec = make(torch.Generator().manual_seed(3))
    give_surface_(dec, torch.zeros(dec.latent_size))  # outputs past the clamp, so its mask matters
    dec = dec.double().eval()
    latent, batch = _inputs(dec.latent_size, S, n, seed=len(case))
    clamp = 0.1
    cfg = reconstruct.ReconstructConfig(10, dec.latent_size, clamp, n, 1e-3, False)
    weights = torch.tensor(np.random.default_rng(0).uniform(0.5, 2.0, S), dtype=torch.float64)

    lat = latent.clone().requires_grad_(True)
    ref = reconstruct.reconstruct_loss(dec, cfg, lat, batch, 0.0, 1.0)
    (g_ref,) = torch.autograd.grad((ref * weights).sum(), lat)

    plan = fused_fit.fold(dec)
    assert fused_fit.padded_rows(n) % fused_fit.TILE == 0 and fused_fit.padded_rows(n) > n
    lat = latent.clone().requires_grad_(True)
    out = fused_fit.fit_loss(plan, lat, batch, clamp)
    (g,) = torch.autograd.grad((out * weights).sum(), lat)

    assert 0.0 < float(ref.detach().min())
    torch.testing.assert_close(out, ref.detach(), rtol=1e-10, atol=0.0)
    assert float((g - g_ref).norm() / g_ref.norm()) <= 1e-10
    for s in range(S):  # each shape's gradient, not only their sum
        assert float((g[s] - g_ref[s]).norm() / g_ref[s].norm()) <= 1e-10


def test_fold_pads_and_transposes_the_flagship():
    dec = flagship(torch.Generator().manual_seed(0))
    plan = fused_fit.fold(dec)
    assert plan.wpad == (512, 512, 512, 256, 512, 512, 512, 512)
    assert plan.groups == (0, 4)
    w4 = dec.layer_weight(4).detach()
    torch.testing.assert_close(plan.fwd[4][:253], w4[:, :253].t(), rtol=0, atol=0)
    assert float(plan.fwd[4][253:].abs().max()) == 0.0 and float(plan.bwd[4][:, 253:].abs().max()) == 0.0
    torch.testing.assert_close(plan.wz[4], w4[:, 253:509], rtol=0, atol=0)
    torch.testing.assert_close(plan.wx[4][:, :3], w4[:, 509:], rtol=0, atol=0)
    assert float(plan.wx[4][:, 3].abs().max()) == 0.0
    torch.testing.assert_close(plan.wzt[0], dec.layer_weight(0).detach()[:, :256].t(), rtol=0, atol=0)


def test_plan_refolds_after_a_weight_change():
    dec = DeepSDFDecoder(8, [32, 32, 32], latent_in=[1], weight_norm=True, norm_layers=[0, 1, 2],
                         generator=torch.Generator().manual_seed(1))
    plan = fused_fit.plan_for(dec)
    assert fused_fit.plan_for(dec) is plan
    with torch.no_grad():
        dec.lin1.weight_g.mul_(2.0)
    again = fused_fit.plan_for(dec)
    assert again is not plan
    torch.testing.assert_close(again.bwd[1], 2.0 * plan.bwd[1])


# decoders that keep the autograd route: the kernels' form is False for all
# but the flagship, which keeps it on the CPU
ROUTES = {
    "layer_norm": (dict(dims=[32, 32, 32], latent_in=[1], weight_norm=False, norm_layers=[0, 1]), False),
    "xyz_in_all": (dict(dims=[32, 32, 32], latent_in=[1], xyz_in_all=True), False),
    "use_tanh": (dict(dims=[32, 32, 32], latent_in=[1], use_tanh=True), False),
    "wider_than_512": (dict(dims=[64, 640, 64], latent_in=[1]), False),
    "latent_in_last_hidden": (dict(dims=[32, 32, 32], latent_in=[2]), False),
    "one_hidden_layer": (dict(dims=[32]), False),
    "cpu": (dict(dims=[64] * 8, latent_in=[4], weight_norm=True), True),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_route_keeps_autograd(name):
    kw, form = ROUTES[name]
    dec = DeepSDFDecoder(8, generator=torch.Generator().manual_seed(0), **kw).eval()
    assert fused_fit.supports_fused_fit(dec) is form
    assert fused_fit.route(dec, torch.zeros(1, 1, 8)) == "autograd"


def test_fit_iterations_counted_by_route():
    dec = DeepSDFDecoder(8, [16, 16, 16], latent_in=[1], generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (64, 3))
    rows = np.concatenate([pts, np.linalg.norm(pts, axis=1, keepdims=True) - 0.5], axis=1).astype(np.float32)
    before = dict(reconstruct.FIT_ITERATIONS)
    reconstruct.reconstruct_batch(dec, 3, 8, [(rows[rows[:, 3] > 0], rows[rows[:, 3] <= 0])] * 2, 0.01, 0.1,
                                  num_samples=32)
    assert reconstruct.FIT_ITERATIONS["autograd"] - before["autograd"] == 3
    assert reconstruct.FIT_ITERATIONS["kernel"] == before["kernel"]


def test_subclass_keeps_the_kernels_form():
    class Tagged(DeepSDFDecoder):
        pass

    dec = Tagged(8, [64] * 8, latent_in=[4], weight_norm=True, generator=torch.Generator().manual_seed(0))
    assert fused_fit.supports_fused_fit(dec)
    assert not fused_fit.supports_fused_fit(torch.nn.Linear(8, 8))


# (hidden layers, point tiles) -> launches of the GEMM and of each per-point
# kernel: one shape of 8000 rows (63 tiles, two chains), one tile (one chain),
# 8 shapes of 8000 rows
LAUNCH_CASES = {"one_shape": (8, 63, 28, 2), "one_tile": (8, 1, 14, 1), "eight_shapes": (3, 504, 8, 2)}


@pytest.mark.parametrize("case", list(LAUNCH_CASES))
def test_iteration_launches(case):
    H, tiles, gemm, per_point = LAUNCH_CASES[case]
    assert fused_fit.iteration_launches(H, tiles) == {
        "fit_consts_kernel": 1, "fit_first_kernel": per_point, "fit_gemm_kernel": gemm,
        "fit_last_kernel": per_point, "fit_loss_kernel": 1, "fit_grad_kernel": 1}
    assert set(fused_fit.iteration_launches(H, tiles)) == set(fused_fit.KERNELS)
