"""K1's wide kernels in msd_tpu_torch on the CPU: decoders with a hidden
layer over 512 wide (or none) take route wgmma_wide in bf16 and f32_wide
in float32 at any width the 10 MB weight cap admits; the weights the
wide kernels read (wgmma tiles, pass-major float32), inverted and held
against msd_tpu's FusedDecoderSpec weights; the persistent grid; and the
plain version of wide specs, LayerNorm or not, against msd_tpu's Pallas
kernel (interpret mode). The kernels and their device scratch are checked
in tests/test_torch_cuda.py, on a GPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msd_tpu.ops.fused_mlp import FusedDecoderSpec as JaxSpec
from msd_tpu.ops.fused_mlp import fused_eval_points
from msd_tpu_torch.models.deepsdf import DeepSDFDecoder
from msd_tpu_torch.ops import fused_mlp
from msd_tpu_torch.ops.fused_mlp import (
    FusedDecoderSpec, f32_pass_weights, fused_eval_plain, route_for, swizzle128, wide_grid,
)
from test_torch_decoder import inputs, make_pair

# chip_smoke's WIDE_NET, tests/test_torch_cuda.py's wide_layer_norm, and the
# widest shapes the 10 MB weight cap admits at latent 256 (dims [2048, 2048]
# in bf16, [1408, 1408] in float32, one hidden layer of 16384 in bf16)
WIDE = {
    "wide": dict(dims=[1024, 1024, 512], latent_in=[1], weight_norm=False, norm_layers=[]),
    "wide_layer_norm": dict(dims=[1000, 700], latent_in=[], weight_norm=False, norm_layers=[0, 1]),
    "bf16_2048": dict(dims=[2048, 2048], latent_in=[], weight_norm=False, norm_layers=[]),
    "f32_1408": dict(dims=[1408, 1408], latent_in=[], weight_norm=False, norm_layers=[]),
    "one_16384": dict(dims=[16384], latent_in=[], weight_norm=False, norm_layers=[]),
    "no_hidden": dict(dims=[], latent_in=[], weight_norm=False, norm_layers=[]),
}
# a wide LayerNorm decoder past 512 (layer 0 581 = 600 - 19 wide, padded to
# 768 or 640) and past 1024 (1100, padded to 1280 or 1152), latent_in [1]
LN_WIDE = dict(dims=[600, 1100], latent_in=[1], weight_norm=False, norm_layers=[0, 1])


def _jnp(params):
    return {k: {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in params.items()}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("name", list(WIDE))
def test_wide_configs_take_their_route(name, dtype):
    """Every wide config is admitted at latent 256 (the flagship's), the
    2048 and 16384 shapes in bf16 only, as the 10 MB cap allows, and takes
    its route's wide kernel, widths padded to 256 (bf16) or 64 (float32)."""
    if name in ("bf16_2048", "one_16384") and dtype == torch.float32:
        with pytest.raises(fused_mlp.UnsupportedConfig, match="too large"):
            FusedDecoderSpec(DeepSDFDecoder(256, **WIDE[name]), dtype)
        return
    dec = DeepSDFDecoder(256, **WIDE[name])
    spec = FusedDecoderSpec(dec, dtype)
    assert spec.route == route_for(dec, dtype) == ("wgmma_wide" if dtype == torch.bfloat16 else "f32_wide")
    tile = 256 if dtype == torch.bfloat16 else 64
    assert all(o % tile == 0 and o - tile < t <= o for o, t in zip(spec.out_pad[:-1], spec.out_true[:-1]))
    assert spec.out_pad[-1] == 1 and spec.kmax == max([tile] + spec.out_pad[:-1])
    if dtype == torch.bfloat16:
        hidden = range(1, spec.n_layers - 1)
        assert spec.n_wtiles == sum(spec.out_pad[i] // 256 * (spec.in_pad[i] // 64) for i in hidden)
        assert (spec.wtiles is None) == (spec.n_wtiles == 0)
    else:
        assert spec.wk[0] is None and spec.wk[-1] is None
        assert all(spec.wk[i].numel() == spec.in_pad[i] * spec.out_pad[i] for i in range(1, spec.n_layers - 1))


def _untile(spec, layer, tiles):
    o, i = spec.out_pad[layer], spec.in_pad[layer]
    t = swizzle128(tiles).reshape(o // 256, i // 64, 256, 64)
    return t.permute(0, 2, 1, 3).reshape(o, i)


def _unpass(spec, layer, flat):
    """A layer's [out_pad, in_pad] float32 weights back from its pass-major layout."""
    o, i = spec.out_pad[layer], spec.in_pad[layer]
    rows, off = [], 0
    for c in range(0, o, 512):
        pw = min(512, o - c)
        rows.append(flat[off:off + i * pw].reshape(i, pw).t())
        off += i * pw
    assert off == flat.numel()
    return torch.cat(rows)


@pytest.mark.parametrize("width", [600, 1100], ids=["over_512", "over_1024"])
def test_wide_wgmma_tiles_invert_to_jax_weights(width):
    """The wide wgmma kernel's weight tiles (N tile major, K tiles, swizzled)
    are msd_tpu's weights (through params_from_jax), zero-padded to 256."""
    cfg = dict(dims=[width, width, 300], latent_in=[1], weight_norm=False, norm_layers=[])
    jdec, params, tdec = make_pair(cfg, seed=1)
    spec = FusedDecoderSpec(tdec, torch.bfloat16)
    jspec = JaxSpec(jdec, _jnp(params), jnp.bfloat16)
    assert spec.route == "wgmma_wide" and spec.out_pad[1] == -(-width // 256) * 256
    tiles, off = spec.wtiles.reshape(-1, 256, 64), 0
    for layer in range(1, spec.n_layers - 1):
        k = spec.out_pad[layer] // 256 * (spec.in_pad[layer] // 64)
        w = _untile(spec, layer, tiles[off:off + k])
        off += k
        assert torch.equal(w, spec.wp[layer])
        t = np.asarray(jspec.w_prev_t[layer].astype(jnp.float32))
        m = w.float().numpy()
        np.testing.assert_array_equal(m[: t.shape[0], : t.shape[1]], t)
        assert not m[t.shape[0]:].any() and not m[:, t.shape[1]:].any()
    assert off == spec.n_wtiles


@pytest.mark.parametrize("width", [600, 1100], ids=["over_512", "over_1024"])
def test_f32_pass_weights_invert_to_jax_weights(width):
    """The wide f32 kernel's pass-major weights ([in_pad][pass width] per
    512 outputs, the last pass narrower) are msd_tpu's weights, zero-padded
    to 64, bit for bit, as are its xyz columns."""
    cfg = dict(dims=[width, width, 300], latent_in=[1], weight_norm=False, norm_layers=[])
    jdec, params, tdec = make_pair(cfg, seed=2)
    spec = FusedDecoderSpec(tdec, torch.float32)
    jspec = JaxSpec(jdec, _jnp(params), jnp.float32)
    assert spec.route == "f32_wide" and spec.wk[0] is None and spec.wk[-1] is None
    for layer in range(1, spec.n_layers - 1):
        wk = spec.wk[layer]
        assert wk.dim() == 1 and wk.is_contiguous() and torch.equal(wk, f32_pass_weights(spec.wp[layer]))
        w = _unpass(spec, layer, wk)
        assert torch.equal(w, spec.wp[layer])
        t = np.asarray(jspec.w_prev_t[layer])
        m = w.numpy()
        np.testing.assert_array_equal(m[: t.shape[0], : t.shape[1]], t)
        assert not m[t.shape[0]:].any() and not m[:, t.shape[1]:].any()
    for layer in range(spec.n_layers):
        if spec.wx[layer] is not None:
            t = np.asarray(jspec.w_xyz_t[layer][:, :3])
            np.testing.assert_array_equal(spec.wx4[layer].numpy()[: t.shape[0], :3], t)


def test_f32_pass_weights_narrow_is_k_major():
    """Up to 512 outputs the pass-major layout is the narrow kernel's
    K-major one."""
    w = torch.randn(448, 192)
    assert torch.equal(f32_pass_weights(w), w.t().reshape(-1))
    w = torch.randn(1088, 64)  # passes of 512, 512 and 64
    flat = f32_pass_weights(w)
    assert torch.equal(flat[: 512 * 64], w[:512].t().reshape(-1))
    assert torch.equal(flat[2 * 512 * 64:], w[1024:].t().reshape(-1))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("ln", [False, True], ids=["relu", "ln"])
def test_wide_spec_plain_matches_pallas_interpret(ln, dtype):
    """A decoder past 512 and past 1024 wide (latent_in [1]), LayerNorm on
    every hidden layer or none, on the wide kernels' padding: the plain
    version against msd_tpu's Pallas kernel on 40 points. float32 within
    1e-5 (two summation orders); bf16 within 2e-2, mean 2e-3 (two summation
    orders can flip a bf16 rounding, as for the narrow kernels)."""
    cfg = dict(LN_WIDE, norm_layers=LN_WIDE["norm_layers"] if ln else [])
    jdec, params, tdec = make_pair(cfg, seed=5)
    latent, xyz = inputs(n=40, seed=6)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = np.asarray(fused_eval_points(jdec, _jnp(params), jnp.asarray(latent), jnp.asarray(xyz),
                                       dtype=jdt, tile=256, interpret=True), np.float32)
    spec = FusedDecoderSpec(tdec, dtype)
    assert spec.route.endswith("_wide") and spec.out_true[:2] == [581, 1100]
    assert all((ln_ is not None) == ln for ln_ in spec.ln[:2])
    out = fused_eval_plain(spec, torch.tensor(latent), torch.tensor(xyz)).numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-4)
    else:
        np.testing.assert_allclose(out, ref, atol=2e-2)
        assert float(np.abs(out - ref).mean()) < 2e-3


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("cfg", [dict(dims=[], latent_in=[], weight_norm=False, norm_layers=[]),
                                 dict(dims=[1300], latent_in=[], weight_norm=False, norm_layers=[0])],
                         ids=["no_hidden", "one_1300_ln"])
def test_one_or_no_hidden_layer_plain_matches_pallas_interpret(cfg, dtype):
    """A decoder with no hidden layer (layer 0 is the last) and one whose
    only hidden layer (LayerNorm, no products: the wide kernels recompute
    it instead of parking it) feeds the last layer's dot product: the wide
    kernels' specs, plain against msd_tpu's Pallas kernel."""
    jdec, params, tdec = make_pair(cfg, seed=7)
    latent, xyz = inputs(n=40, seed=8)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = np.asarray(fused_eval_points(jdec, _jnp(params), jnp.asarray(latent), jnp.asarray(xyz),
                                       dtype=jdt, tile=256, interpret=True), np.float32)
    spec = FusedDecoderSpec(tdec, dtype)
    assert spec.route.endswith("_wide") and spec.n_wtiles == 0
    out = fused_eval_plain(spec, torch.tensor(latent), torch.tensor(xyz)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5 if dtype == torch.float32 else 2e-2, rtol=1e-4)


def test_wide_grid(monkeypatch):
    """One persistent block per SM, fewer with fewer point tiles, and fewer
    when their scratch would pass the cap (at least one)."""
    per = 917504  # wide_layer_norm's bf16 block (tests/test_torch_cuda.py)
    assert wide_grid(8193, per, 132) == 132
    assert wide_grid(6, per, 132) == 6
    assert wide_grid(1, per, 132) == 1
    monkeypatch.setattr(fused_mlp, "SCRATCH_CAP_BYTES", 5 * per + 1)
    assert wide_grid(8193, per, 132) == 5
    monkeypatch.setattr(fused_mlp, "SCRATCH_CAP_BYTES", per - 1)
    assert wide_grid(8193, per, 132) == 1
    assert wide_grid(8193, 0, 132) == 132  # no scratch: no cap
