"""K1 in msd_tpu_torch: the plain version and the CPU wrapper against
msd_tpu's Pallas kernel (interpret mode) and its decoder, in float32. The
CUDA kernel itself is held against the plain version in
tests/test_torch_cuda.py, on a GPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msd_tpu.ops.fused_mlp import FusedDecoderSpec as JaxSpec
from msd_tpu.ops.fused_mlp import fused_eval_points
from msd_tpu_torch.models.deepsdf import DeepSDFDecoder, decode_sdf
from msd_tpu_torch.ops import fused_mlp
from msd_tpu_torch.ops.fused_mlp import (
    FusedDecoderSpec, UnsupportedConfig, fused_eval, fused_eval_plain,
)
from test_torch_decoder import CONFIGS, IDS, inputs, jax_forward, make_pair

FUSED = CONFIGS[:4]
FUSED_IDS = IDS[:4]


@pytest.mark.parametrize("cfg", FUSED, ids=FUSED_IDS)
def test_plain_matches_pallas_interpret(cfg):
    jdec, params, tdec = make_pair(cfg)
    latent, xyz = inputs(n=300)  # ragged: not a multiple of 64 or of the TPU tile
    ref = fused_eval_points(
        jdec, jnp_params(params), jnp.asarray(latent), jnp.asarray(xyz),
        dtype=jnp.float32, tile=256, interpret=True,
    )
    spec = FusedDecoderSpec(tdec, torch.float32)
    out = fused_eval_plain(spec, torch.tensor(latent), torch.tensor(xyz)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("cfg", FUSED, ids=FUSED_IDS)
def test_cpu_wrapper_matches_decoder(cfg):
    jdec, params, tdec = make_pair(cfg, seed=1)
    latent, xyz = inputs(n=77, seed=5)
    spec = FusedDecoderSpec(tdec, torch.float32)
    launches = fused_mlp.LAUNCHES
    out = fused_eval(spec, torch.tensor(latent), torch.tensor(xyz)).numpy()
    assert fused_mlp.LAUNCHES == launches  # the CPU path launches nothing
    np.testing.assert_allclose(out, jax_forward(jdec, params, latent, xyz)[:, 0], atol=1e-5, rtol=1e-4)
    with torch.no_grad():
        port = decode_sdf(tdec, torch.tensor(latent), torch.tensor(xyz))[:, 0].numpy()
    np.testing.assert_allclose(out, port, atol=1e-5, rtol=1e-4)


def jnp_params(params):
    return {k: {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in params.items()}


def test_unsupported_xyz_in_all():
    _, params, tdec = make_pair(CONFIGS[4])
    with pytest.raises(UnsupportedConfig, match="xyz_in_all"):
        FusedDecoderSpec(tdec)


def test_unsupported_weights_over_10mb():
    with pytest.raises(UnsupportedConfig, match="too large"):
        FusedDecoderSpec(DeepSDFDecoder(8, dims=[1700, 1700]), torch.float32)


def test_operand_dtype_not_ported_raises():
    with pytest.raises(ValueError, match="not ported") as info:
        FusedDecoderSpec(DeepSDFDecoder(8, dims=[32, 32]), torch.float16)
    assert not isinstance(info.value, UnsupportedConfig)


def test_wide_config_matches_pallas_interpret():
    """Hidden widths of 1024 (more than a tile's activations in shared
    memory hold on the card) are supported, as on the TPU; layer 0 outputs
    the ragged 1024 - 19 = 1005."""
    cfg = dict(dims=[1024, 1024], latent_in=[1], weight_norm=False, norm_layers=[])
    jdec, params, tdec = make_pair(cfg, seed=6)
    latent, xyz = inputs(n=70, seed=4)
    spec = FusedDecoderSpec(tdec, torch.float32)
    assert spec.kmax == 1024 and spec.out_true[0] == 1005 and spec.out_pad[0] == 1024
    ref = fused_eval_points(
        jdec, jnp_params(params), jnp.asarray(latent), jnp.asarray(xyz),
        dtype=jnp.float32, tile=256, interpret=True,
    )
    out = fused_eval(spec, torch.tensor(latent), torch.tensor(xyz)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5, rtol=1e-4)


def test_bf16_plain_close_to_f32():
    _, _, tdec = make_pair(CONFIGS[0], seed=2)
    latent, xyz = inputs(n=500, seed=7)
    lat, pts = torch.tensor(latent), torch.tensor(xyz)
    f32 = fused_eval_plain(FusedDecoderSpec(tdec, torch.float32), lat, pts)
    bf16 = fused_eval_plain(FusedDecoderSpec(tdec, torch.bfloat16), lat, pts)
    assert float((f32 - bf16).abs().max()) < 2e-2
    assert float((f32 - bf16).abs().max()) > 0  # the operands really were rounded


def test_spec_layout_flagship_shape():
    """latent_in split and padding at the flagship's shape (widths cut to
    64): layer 3 outputs 64 - 19 = 45 padded to 64; layer 4 splits its
    weight into rows [:45] (h), [45:61] (latent), [61:] (xyz)."""
    jdec, params, tdec = make_pair(CONFIGS[0])
    spec = FusedDecoderSpec(tdec, torch.float32)
    jspec = JaxSpec(jdec, jnp_params(params), jnp.float32)
    assert spec.out_true[3] == 45 and spec.out_pad[3] == 64 and spec.in_pad[4] == 64
    assert spec.out_pad[-1] == 1 and spec.kmax == 64
    for layer in range(spec.n_layers):
        for mine, theirs in ((spec.wp, jspec.w_prev_t), (spec.wx, jspec.w_xyz_t)):
            if theirs[layer] is None:
                assert mine[layer] is None
                continue
            t = np.asarray(theirs[layer])
            if mine is spec.wx:
                t = t[:, :3]
            m = mine[layer].numpy()
            np.testing.assert_array_equal(m[: t.shape[0], : t.shape[1]], t)
            assert not m[t.shape[0]:].any() and not m[:, t.shape[1]:].any()
    latent = torch.tensor(inputs()[0])
    for mine, theirs in zip(spec.latent_consts(latent), jspec.latent_consts(jnp.asarray(latent.numpy()))):
        t = np.asarray(theirs)[:, 0]
        np.testing.assert_allclose(mine.numpy()[: t.size], t, atol=1e-6)
        assert not mine.numpy()[t.size:].any()
