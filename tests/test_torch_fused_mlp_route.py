"""K1's routes in msd_tpu_torch on the CPU: which configs take the wgmma
route, the weight tiles that route's kernel reads (laid out once per spec),
inverted and held against msd_tpu's FusedDecoderSpec weights, and the plain
version of a wgmma-route spec against msd_tpu's Pallas kernel (interpret
mode). The kernels themselves run in tests/test_torch_cuda.py, on a GPU."""

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
# bf16 route of each config of test_torch_decoder (xyz_in_all: no spec)
ROUTE_BF16 = {"flagship_shape": "wgmma", "weight_norm": "wgmma", "layer_norm": "mma_sync", "use_tanh": "wgmma"}


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
    route = ROUTE_BF16[name] if dtype == torch.bfloat16 else "mma_sync"
    assert spec.route == route_for(tdec, dtype) == route
    tile = 256 if route == "wgmma" else fused_mlp.TILE_N[dtype]
    assert all(o % tile == 0 for o in spec.out_pad[:-1]) and spec.out_pad[-1] == 1
    assert (spec.wtiles is not None) == (route == "wgmma" and spec.n_layers > 2)


def test_route_flagship_and_wide():
    dec = _flagship()
    spec = FusedDecoderSpec(dec, torch.bfloat16)
    assert spec.route == "wgmma" and spec.n_wtiles == 96
    assert spec.out_pad == [512, 512, 512, 256, 512, 512, 512, 512, 1]
    assert FusedDecoderSpec(dec, torch.float32).route == "mma_sync"
    from msd_tpu_torch.models.deepsdf import DeepSDFDecoder

    assert route_for(DeepSDFDecoder(8, dims=[513, 64]), torch.bfloat16) == "mma_sync"  # pads to 768
    assert route_for(DeepSDFDecoder(8, dims=[512, 64]), torch.bfloat16) == "wgmma"


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
