"""K1's routes in msd_tpu_torch on the CPU: which configs take the wgmma
and f32 routes, the weights the wgmma and f32 kernels read (laid out once
per spec), inverted and held against msd_tpu's FusedDecoderSpec weights,
and the plain version of wgmma- and f32-route specs, LayerNorm ones
included, against msd_tpu's Pallas kernel (interpret mode). Decoders wider
than 512 are in tests/test_torch_fused_mlp_wide.py. The kernels themselves
run in tests/test_torch_cuda.py, on a GPU."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msd_tpu.ops.fused_mlp import FusedDecoderSpec as JaxSpec
from msd_tpu.ops.fused_mlp import fused_eval_points
from msd_tpu_torch.models import build_decoder
from msd_tpu_torch.ops import fused_mlp
from msd_tpu_torch.ops.fused_mlp import FusedDecoderSpec, fused_eval_plain, route_for, swizzle128
from test_torch_decoder import CONFIGS, IDS, inputs, make_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "examples", "ADNI", "minimal_eikonal", "specs.json")
# bf16 route of each config of test_torch_decoder (xyz_in_all: no spec);
# float32 operands take "f32" on every one of them
ROUTE_BF16 = {"flagship_shape": "wgmma", "weight_norm": "wgmma", "layer_norm": "wgmma", "use_tanh": "wgmma"}
# a LayerNorm decoder on the wgmma and f32 routes whose true widths (200,
# and the 200 - 19 = 181 before the latent_in layer) are no multiple of a tile
LN_CFG = dict(dims=[200, 200, 200], latent_in=[2], weight_norm=False, norm_layers=[0, 1, 2])


def _flagship():
    with open(FLAGSHIP) as f:
        specs = json.load(f)
    return build_decoder(specs["NetworkArch"], specs["CodeLength"], specs["NetworkSpecs"],
                         generator=torch.Generator().manual_seed(0)).eval()


def _jnp(params):
    return {k: {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in params.items()}


def _untile(spec, layer, tiles):
    """A layer's [out_pad, in_pad] weights back from its wgmma tiles."""
    o, i = spec.out_pad[layer], spec.in_pad[layer]
    t = swizzle128(tiles).reshape(o // 256, i // 64, 256, 64)
    return t.permute(0, 2, 1, 3).reshape(o, i)


def _layer_tiles(spec):
    """Each hidden layer's slice of ``spec.wtiles`` as [k, 256, 64]."""
    tiles = spec.wtiles.reshape(-1, 256, 64)
    out, off = {}, 0
    for layer in range(1, spec.n_layers - 1):
        k = spec.out_pad[layer] // 256 * (spec.in_pad[layer] // 64)
        out[layer] = tiles[off:off + k]
        off += k
    assert off == spec.n_wtiles == tiles.shape[0]
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("name", IDS)
def test_route_by_config(name, dtype):
    cfg = CONFIGS[IDS.index(name)]
    _, _, tdec = make_pair(cfg)
    if name == "xyz_in_all":
        with pytest.raises(fused_mlp.UnsupportedConfig):
            FusedDecoderSpec(tdec, dtype)
        return
    spec = FusedDecoderSpec(tdec, dtype)
    route = ROUTE_BF16[name] if dtype == torch.bfloat16 else "f32"
    assert spec.route == route_for(tdec, dtype) == route
    tile = 256 if route == "wgmma" else fused_mlp.F32_TILE_N
    assert all(o % tile == 0 for o in spec.out_pad[:-1]) and spec.out_pad[-1] == 1
    assert (spec.wtiles is not None) == (route == "wgmma" and spec.n_layers > 2)
    assert (spec.wk is not None) == (route == "f32")


def test_route_flagship_and_wide():
    dec = _flagship()
    spec = FusedDecoderSpec(dec, torch.bfloat16)
    assert spec.route == "wgmma" and spec.n_wtiles == 96
    assert spec.out_pad == [512, 512, 512, 256, 512, 512, 512, 512, 1]
    assert FusedDecoderSpec(dec, torch.float32).route == "f32"
    from msd_tpu_torch.models.deepsdf import DeepSDFDecoder

    for dtype, route in ((torch.bfloat16, "wgmma"), (torch.float32, "f32")):
        over = DeepSDFDecoder(8, dims=[513, 64])
        assert route_for(over, dtype) == route + "_wide"  # over 512: the wide kernel
        at = DeepSDFDecoder(8, dims=[512, 64])
        assert route_for(at, dtype) == route
        ln = DeepSDFDecoder(8, dims=[512, 512], norm_layers=[0, 1], weight_norm=False)
        assert route_for(ln, dtype) == route
        wide_ln = DeepSDFDecoder(8, dims=[1000, 700], norm_layers=[0, 1], weight_norm=False)
        assert route_for(wide_ln, dtype) == route + "_wide"


def test_swizzle128_is_its_own_inverse_and_matches_the_address_rule():
    t = torch.arange(3 * 256 * 64, dtype=torch.int32).reshape(3, 256, 64)
    s = swizzle128(t)
    assert torch.equal(swizzle128(s), t)
    # element (r, k) of a tile sits at byte r*128 + ((k/8) ^ (r%8))*16 + (k%8)*2
    r, k = torch.meshgrid(torch.arange(256), torch.arange(64), indexing="ij")
    flat = (r * 64 + (((k // 8) ^ (r % 8)) * 8) + k % 8).reshape(-1)
    for i in range(3):
        assert torch.equal(s[i].reshape(-1)[flat], t[i].reshape(-1))


@pytest.mark.parametrize("name", ["flagship_shape", "weight_norm", "use_tanh"])
def test_wgmma_tiles_invert_to_jax_weights(name):
    jdec, params, tdec = make_pair(CONFIGS[IDS.index(name)])
    spec = FusedDecoderSpec(tdec, torch.bfloat16)
    jspec = JaxSpec(jdec, _jnp(params), jnp.bfloat16)
    tiles = _layer_tiles(spec)
    for layer in range(1, spec.n_layers - 1):
        w = _untile(spec, layer, tiles[layer])
        assert torch.equal(w, spec.wp[layer])
        t = np.asarray(jspec.w_prev_t[layer].astype(jnp.float32))
        m = w.float().numpy()
        np.testing.assert_array_equal(m[: t.shape[0], : t.shape[1]], t)
        assert not m[t.shape[0]:].any() and not m[:, t.shape[1]:].any()
    for layer in range(spec.n_layers):
        if spec.wx[layer] is None:
            assert spec.wx4[layer] is None
            continue
        t = np.asarray(jspec.w_xyz_t[layer][:, :3].astype(jnp.float32))
        x4 = spec.wx4[layer].numpy()
        np.testing.assert_array_equal(x4[: t.shape[0], :3], t)
        assert not x4[:, 3].any() and not x4[t.shape[0]:].any()


def test_wgmma_tiles_flagship_width():
    spec = FusedDecoderSpec(_flagship(), torch.bfloat16)
    tiles = _layer_tiles(spec)
    assert [tiles[layer].shape[0] for layer in range(1, 8)] == [16, 16, 8, 8, 16, 16, 16]
    for layer, t in tiles.items():
        assert torch.equal(_untile(spec, layer, t), spec.wp[layer])


@pytest.mark.parametrize("name", ["flagship_shape", "use_tanh"])
def test_wgmma_spec_plain_matches_pallas_interpret_bf16(name):
    """The plain version of a wgmma-route spec (widths padded to 256) and
    the Pallas kernel in bf16: the same rounding points, two summation
    orders (which can flip a bf16 rounding)."""
    jdec, params, tdec = make_pair(CONFIGS[IDS.index(name)], seed=3)
    latent, xyz = inputs(n=300, seed=9)
    ref = fused_eval_points(jdec, _jnp(params), jnp.asarray(latent), jnp.asarray(xyz),
                            dtype=jnp.bfloat16, tile=256, interpret=True)
    spec = FusedDecoderSpec(tdec, torch.bfloat16)
    assert spec.route == "wgmma"
    out = fused_eval_plain(spec, torch.tensor(latent), torch.tensor(xyz)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref, np.float32), atol=2e-2)
    assert float(np.abs(out - np.asarray(ref, np.float32)).mean()) < 2e-3


def test_wgmma_padding_is_exact_on_the_plain_version():
    """Padding hidden widths to 256 instead of 128 adds zero columns only:
    the plain version gives the same bits on both paddings."""
    _, _, tdec = make_pair(CONFIGS[0], seed=4)
    latent, xyz = (torch.tensor(a) for a in inputs(n=200, seed=3))
    wide = FusedDecoderSpec(tdec, torch.bfloat16)
    narrow = FusedDecoderSpec.__new__(FusedDecoderSpec)
    narrow.__dict__.update(wide.__dict__)
    narrow.wp = [None if w is None else w[:128, :128] if w.shape[0] > 1 else w[:, :128] for w in wide.wp]
    narrow.wx = [None if w is None else w[:128] if w.shape[0] > 1 else w for w in wide.wx]
    narrow.bias = [b[:128] for b in wide.bias]
    narrow.wz = [None if z is None else z[:, :128] for z in wide.wz]
    assert torch.equal(fused_eval_plain(wide, latent, xyz), fused_eval_plain(narrow, latent, xyz))


def test_route_flagship_width_layer_norm():
    """chip_smoke's flagship-width LayerNorm decoder: wgmma in bf16 (8 x 512,
    layer 3 253 wide), f32 in float32; its LayerNorm scale in [0.5, 1.5]
    and bias in +-0.1, zero-padded."""
    from chip_smoke import ln_decoder

    with open(FLAGSHIP) as f:
        dec, _ = ln_decoder(json.load(f), 0, "cpu")
    for dtype, route, pad in ((torch.bfloat16, "wgmma", 256), (torch.float32, "f32", 64)):
        spec = FusedDecoderSpec(dec, dtype)
        assert spec.route == route
        assert spec.out_true[3] == 253 and spec.out_pad[3] == 256
        assert all(ln is not None for ln in spec.ln[:8]) and spec.ln[8] is None
        for layer in range(8):
            scale, bias = spec.ln[layer]
            w = spec.out_true[layer]
            assert scale.shape == bias.shape == (spec.out_pad[layer],)
            assert not scale[w:].any() and not bias[w:].any()
            assert float(scale[:w].min()) >= 0.5 and float(bias[:w].abs().max()) <= 0.1
        assert all(o % pad == 0 for o in spec.out_pad[:-1])


@pytest.mark.parametrize("name", ["flagship_shape", "layer_norm", "use_tanh", "ln_200"])
def test_f32_weights_invert_to_jax_weights(name):
    """The f32 kernel's K-major weights, transposed back, are msd_tpu's
    FusedDecoderSpec weights (zero-padded to 64), as are its xyz columns.
    Bit for bit in float32, so not on the weight_norm config: there the two
    frameworks' weight norms differ in the last bit of some weights."""
    cfg = LN_CFG if name == "ln_200" else CONFIGS[IDS.index(name)]
    jdec, params, tdec = make_pair(cfg)
    spec = FusedDecoderSpec(tdec, torch.float32)
    jspec = JaxSpec(jdec, _jnp(params), jnp.float32)
    assert spec.route == "f32" and spec.wk[0] is None and spec.wk[-1] is None
    for layer in range(1, spec.n_layers - 1):
        wk = spec.wk[layer]
        assert wk.shape == (spec.in_pad[layer], spec.out_pad[layer]) and wk.is_contiguous()
        assert torch.equal(wk.t(), spec.wp[layer])
        t = np.asarray(jspec.w_prev_t[layer])
        m = wk.t().numpy()
        np.testing.assert_array_equal(m[: t.shape[0], : t.shape[1]], t)
        assert not m[t.shape[0]:].any() and not m[:, t.shape[1]:].any()
    for layer in range(spec.n_layers):
        if spec.wx[layer] is None:
            assert spec.wx4[layer] is None
            continue
        t = np.asarray(jspec.w_xyz_t[layer][:, :3])
        x4 = spec.wx4[layer].numpy()
        np.testing.assert_array_equal(x4[: t.shape[0], :3], t)
        assert not x4[:, 3].any() and not x4[t.shape[0]:].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_layer_norm_spec_plain_matches_pallas_interpret(dtype):
    """A LayerNorm decoder on the wgmma (bf16, widths padded to 256) and f32
    (float32, padded to 64) routes, true widths 200 and 181: the plain
    version against the Pallas kernel. float32 within 1e-5 (two summation
    orders); bf16 as the wgmma test above (a flipped bf16 rounding)."""
    jdec, params, tdec = make_pair(LN_CFG, seed=5)
    latent, xyz = inputs(n=300, seed=6)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = np.asarray(fused_eval_points(jdec, _jnp(params), jnp.asarray(latent), jnp.asarray(xyz),
                                       dtype=jdt, tile=256, interpret=True), np.float32)
    spec = FusedDecoderSpec(tdec, dtype)
    assert spec.route == ("wgmma" if dtype == torch.bfloat16 else "f32")
    assert spec.out_true[:3] == [200, 181, 200] and all(ln is not None for ln in spec.ln[:3])
    out = fused_eval_plain(spec, torch.tensor(latent), torch.tensor(xyz)).numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-4)
    else:
        np.testing.assert_allclose(out, ref, atol=2e-2)
        assert float(np.abs(out - ref).mean()) < 2e-3


def _repad(spec, width):
    """A copy of a spec with every hidden width zero-padded to ``width``."""
    wide = FusedDecoderSpec.__new__(FusedDecoderSpec)
    wide.__dict__.update(spec.__dict__)

    def pad(t, rows, cols=None):
        z = torch.zeros(rows if cols is None else (rows, cols), dtype=t.dtype)
        if cols is None:
            z[: t.shape[0]] = t
        else:
            z[: t.shape[0], : t.shape[1]] = t
        return z

    last = spec.n_layers - 1
    wide.wp = [None if w is None else pad(w, w.shape[0] if i == last else width, width)
               for i, w in enumerate(spec.wp)]
    wide.wx = [None if w is None else w if i == last else pad(w, width, 3) for i, w in enumerate(spec.wx)]
    wide.bias = [b if i == last else pad(b, width) for i, b in enumerate(spec.bias)]
    wide.wz = [None if z is None else z if i == last else pad(z, z.shape[0], width) for i, z in enumerate(spec.wz)]
    wide.ln = [None if ln is None else (pad(ln[0], width), pad(ln[1], width)) for ln in spec.ln]
    return wide


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_layer_norm_padding_is_exact_on_the_plain_version(dtype):
    """Zero padding stays exact under LayerNorm: statistics over the true
    width, zero scale and bias on the padded columns, so padding every
    hidden width to 512 gives the same bits as the route's own padding, and
    each padded LayerNorm output column is exactly 0."""
    _, _, tdec = make_pair(LN_CFG, seed=7)
    latent, xyz = (torch.tensor(a) for a in inputs(n=200, seed=8))
    spec = FusedDecoderSpec(tdec, dtype)
    wide = _repad(spec, 512)
    assert torch.equal(fused_eval_plain(spec, latent, xyz), fused_eval_plain(wide, latent, xyz))
    # one LayerNorm layer by hand, as fused_eval_plain computes it: padded columns are 0
    h = fused_mlp._mm(xyz, wide.wx[0], dtype) + wide.latent_consts(latent)[0]
    w = spec.out_true[0]
    mean = h[:, :w].mean(dim=1, keepdim=True)
    var = ((h[:, :w] - mean) ** 2).mean(dim=1, keepdim=True)
    scale, bias = wide.ln[0]
    out = torch.relu((h - mean) * torch.rsqrt(var + fused_mlp.LAYER_NORM_EPS) * scale + bias)
    assert not out[:, w:].any() and out[:, :w].any()
