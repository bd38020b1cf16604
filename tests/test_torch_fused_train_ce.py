"""K2 variants c (EikonalNumPoints: the eikonal on the first E points of
each scene) and e (per-scene 0/1 weights of a padded batch) in the port's
plain version, against msd_tpu's Pallas kernel in interpret mode
(``fused_point_grads_t``), in float32 and bf16 on small decoders: the
shapes of tests/test_fused_train.py:105-263. Tolerances as there: loss
sums 1e-5 relative, gradients 2e-4 relative / 1e-7 absolute; bf16 1e-5
relative Frobenius."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msd_tpu.ops import fused_train as jax_ft
from msd_tpu_torch.ops import fused_train as ft
from test_torch_fused_train import CLAMP, make_case, to_jax_layout

# name: (P, E, weights, use_eikonal)
CASES = {
    "c_gated_256_of_512": (512, 256, None, True),
    "c_tile_step_down_384_100": (384, 100, None, True),
    "e_weighted_eikonal": (256, None, [1, 1, 1, 0], True),
    "e_weighted_no_eikonal": (256, None, [1, 1, 1, 0], False),
    "ce_weighted_gated": (512, 200, [1, 0, 1, 1], True),
}


def _jax(jdec, params, lat, xyz, gt, use_eik, num_total, E, w, dtype):
    xyzgt_t = jnp.asarray(np.concatenate([xyz, gt[..., None]], axis=2).transpose(2, 0, 1))
    kw = {}
    if w is not None:
        kw = dict(weights=jnp.asarray(w, jnp.float32), n_real=int(np.sum(w)))
    g_net, g_lat, aux = jax_ft.fused_point_grads_t(
        jdec, jax.tree.map(jnp.asarray, params), jnp.asarray(lat), xyzgt_t, CLAMP, use_eik, num_total,
        dtype=dtype, interpret=True, eik_points=E, **kw)
    flat = {".".join(p.key for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(g_net)[0]}
    return float(aux["sdf"]), float(aux["eikonal"]), np.asarray(g_lat), flat


def _port(tdec, lat, xyz, gt, use_eik, num_total, E, w, dtype):
    tdec.zero_grad()
    z = torch.tensor(lat, requires_grad=True)
    kw = {}
    if w is not None:
        kw = dict(scene_weights=torch.tensor(w, dtype=torch.float32), n_real=int(np.sum(w)))
    total, sdf, eik = ft.fused_sdf_loss(tdec, z, torch.tensor(xyz), torch.tensor(gt), CLAMP, use_eik, num_total,
                                        dtype=dtype, eik_points=E, **kw)
    total.backward()
    grads = {n: p.grad.clone() for n, p in tdec.named_parameters()}
    return float(sdf), float(eik), z.grad.numpy(), to_jax_layout(tdec, grads)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_pallas_interpret(case):
    P, E, w, use_eik = CASES[case]
    jdec, params, tdec, lat, xyz, gt = make_case(seed=21, P=P, width=32)
    B = xyz.shape[0]
    num_total = (B if w is None else int(np.sum(w))) * P
    ref = _jax(jdec, params, lat, xyz, gt, use_eik, num_total, E, w, jnp.float32)
    ours = _port(tdec, lat, xyz, gt, use_eik, num_total, E, w, torch.float32)
    np.testing.assert_allclose(ours[0], ref[0], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ours[1], ref[1], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ours[2], ref[2], rtol=2e-4, atol=1e-7)
    assert sorted(ours[3]) == sorted(ref[3])
    for k in ref[3]:
        np.testing.assert_allclose(ours[3][k], ref[3][k], rtol=2e-4, atol=1e-7, err_msg=k)
    if w is not None:  # a pad scene's latent gets exactly zero
        assert np.all(ours[2][np.asarray(w) == 0] == 0.0)
    if E is not None:  # the gate does something
        full = _port(tdec, lat, xyz, gt, use_eik, num_total, None, w, torch.float32)
        assert abs(full[1] - ours[1]) > 0


def test_weighted_gated_bf16_matches_pallas_interpret_bf16():
    """c and e together in bf16, the card's route: the plain version rounds
    where the TPU kernel rounds."""
    P, E, w, use_eik = CASES["ce_weighted_gated"]
    jdec, params, tdec, lat, xyz, gt = make_case(seed=22, P=P, width=32)
    num_total = int(np.sum(w)) * P
    ref = _jax(jdec, params, lat, xyz, gt, use_eik, num_total, E, w, jnp.bfloat16)
    ours = _port(tdec, lat, xyz, gt, use_eik, num_total, E, w, torch.bfloat16)
    np.testing.assert_allclose(ours[:2], ref[:2], rtol=1e-5)
    for a, b in [(ours[2], ref[2])] + [(ours[3][k], ref[3][k]) for k in ref[3]]:
        assert np.linalg.norm(a - b) <= 1e-5 * np.linalg.norm(b)
    assert np.all(ours[2][1] == 0.0)


@pytest.mark.parametrize("P,E,rows", [(512, 256, 256), (384, 100, 128), (512, 200, 256), (1024, 300, 512),
                                      (16384, 4096, 4096), (256, 256, 256), (256, None, 256), (640, 600, 640)])
def test_eikonal_rows_match_kernel_tiling(P, E, rows):
    """The gated row count is the TPU kernel's eik_tps * tile
    (``fn.eik_points_effective`` of msd_tpu's build), not E."""
    assert ft.eikonal_rows(P, E) == rows
    if E is not None and E < P:
        jdec, *_ = make_case(P=128, width=32)
        tile = 512 if (-(-E // 256) * 256) % 512 == 0 else 256
        fn = jax_ft.build_fused_train(jdec, 1, P, CLAMP, P, True, interpret=True, tile=tile, eik_points=E)
        assert fn.eik_points_effective == rows


def test_gated_plain_equals_masked_full_rows():
    """Variant c's plain version equals the ungated plain version on the
    gated rows alone plus the L1 terms of the other rows: the eikonal sum
    of the gated run is the full run's over the first E points of each
    scene."""
    _, _, tdec, lat, xyz, gt = make_case(seed=23, P=512, width=32)
    B, P = xyz.shape[:2]
    n = tdec.num_layers - 1
    with torch.no_grad():
        w = [tdec.layer_weight(i) for i in range(n)]
        b = [getattr(tdec, f"lin{i}").bias for i in range(n)]
        gated = ft.fused_point_grads(tdec, w, b, torch.tensor(lat), torch.tensor(xyz), torch.tensor(gt), CLAMP,
                                     True, B * P, dtype=torch.float32, eik_points=256)
        head = ft.fused_point_grads(tdec, w, b, torch.tensor(lat), torch.tensor(xyz[:, :256]),
                                    torch.tensor(gt[:, :256]), CLAMP, True, B * P, dtype=torch.float32)
    np.testing.assert_allclose(float(gated[4]), float(head[4]), rtol=1e-6)
