"""msd_tpu_torch's DeepSDFDecoder against msd_tpu's, in float32 on the CPU:
the same weights (made by msd_tpu from a seed) and the same inputs (numpy)
go through both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msd_tpu.models.deepsdf import DeepSDFDecoder as JaxDecoder
from msd_tpu.utils import checkpoint as jax_ckpt
from msd_tpu_torch.models import build_decoder
from msd_tpu_torch.models.deepsdf import DeepSDFDecoder, decode_sdf, give_surface_, params_from_jax
from msd_tpu_torch.utils import checkpoint as torch_ckpt

LATENT = 16
# the configs of tests/test_fused_mlp.py plus xyz_in_all
CONFIGS = [
    dict(dims=[64] * 8, latent_in=[4], weight_norm=True, norm_layers=[]),
    dict(dims=[32, 32, 32], latent_in=[2], weight_norm=True, norm_layers=[0, 1, 2]),
    dict(dims=[32, 32], latent_in=[], weight_norm=False, norm_layers=[0, 1]),
    dict(dims=[32, 32], latent_in=[1], weight_norm=False, norm_layers=[], use_tanh=True),
    dict(dims=[32, 32, 32], latent_in=[2], weight_norm=False, norm_layers=[], xyz_in_all=True),
]
IDS = ["flagship_shape", "weight_norm", "layer_norm", "use_tanh", "xyz_in_all"]


def make_pair(cfg, seed=0, latent_size=LATENT, surface=False):
    """(jax decoder, jax params as numpy, port decoder with the same weights).
    ``surface`` applies ``give_surface_`` (gain + bias shift) to both."""
    jdec = JaxDecoder(latent_size, **cfg)
    params = jdec.init(jax.random.PRNGKey(seed))
    # give LayerNorm non-trivial scale/bias so the affine part is checked
    rng = np.random.default_rng(seed + 100)
    params = jax.tree.map(np.asarray, params)
    for k in params:
        if k.startswith("bn"):
            params[k]["scale"] = (1 + 0.1 * rng.standard_normal(params[k]["scale"].shape)).astype(np.float32)
            params[k]["bias"] = (0.1 * rng.standard_normal(params[k]["bias"].shape)).astype(np.float32)
    tdec = DeepSDFDecoder(latent_size, **cfg)
    tdec.load_state_dict(params_from_jax(tdec, params))
    if surface:
        give_surface_(tdec, torch.zeros(latent_size))
        params = jax.tree.map(np.asarray, jdec.params_from_torch_state_dict(tdec.state_dict()))
    return jdec, params, tdec.eval()


def inputs(n=300, seed=2, latent_size=LATENT):
    rng = np.random.default_rng(seed)
    latent = (0.1 * rng.standard_normal(latent_size)).astype(np.float32)
    xyz = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    return latent, xyz


def jax_forward(jdec, params, latent, xyz):
    inp = np.concatenate([np.broadcast_to(latent, (xyz.shape[0], latent.size)), xyz], axis=1)
    return np.asarray(jdec.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(inp)))


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_decoder_matches_jax(cfg):
    jdec, params, tdec = make_pair(cfg)
    latent, xyz = inputs()
    ref = jax_forward(jdec, params, latent, xyz)
    with torch.no_grad():
        out = decode_sdf(tdec, torch.tensor(latent), torch.tensor(xyz)).numpy()
    assert out.shape == ref.shape == (300, 1)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_layer_shapes_match_jax(cfg):
    jdec, params, tdec = make_pair(cfg)
    assert tdec.layer_shapes == jdec.layer_shapes
    assert sum(p.numel() for p in tdec.parameters()) == jdec.num_params(params)


@pytest.mark.parametrize("cfg", CONFIGS[:3], ids=IDS[:3])
def test_jax_checkpoint_loads_in_port(cfg, tmp_path):
    jdec, params, _ = make_pair(cfg, seed=3)
    jax_ckpt.save_model(str(tmp_path), "7.pth", jdec, params, 7)
    tdec = DeepSDFDecoder(LATENT, **cfg).eval()
    assert torch_ckpt.load_model(str(tmp_path), 7, tdec) == 7
    latent, xyz = inputs(seed=4)
    with torch.no_grad():
        out = decode_sdf(tdec, torch.tensor(latent), torch.tensor(xyz)).numpy()
    np.testing.assert_allclose(out, jax_forward(jdec, params, latent, xyz), atol=1e-5, rtol=1e-5)


def test_port_checkpoint_loads_in_jax(tmp_path):
    cfg = CONFIGS[1]
    tdec = DeepSDFDecoder(LATENT, generator=torch.Generator().manual_seed(5), **cfg).eval()
    torch_ckpt.save_model(str(tmp_path), "3.pth", tdec, 3)
    jdec = JaxDecoder(LATENT, **cfg)
    params, epoch = jax_ckpt.load_model(str(tmp_path), 3, jdec)
    assert epoch == 3
    latent, xyz = inputs(seed=6)
    with torch.no_grad():
        out = decode_sdf(tdec, torch.tensor(latent), torch.tensor(xyz)).numpy()
    np.testing.assert_allclose(out, jax_forward(jdec, params, latent, xyz), atol=1e-5, rtol=1e-5)


def test_reference_state_dict_names_load():
    """DataParallel 'module.' prefixes and torch>=2 parametrizations names."""
    cfg = CONFIGS[1]
    src = DeepSDFDecoder(LATENT, generator=torch.Generator().manual_seed(8), **cfg)
    sd = {}
    for k, v in src.state_dict().items():
        k = k.replace(".weight_g", ".parametrizations.weight.original0")
        k = k.replace(".weight_v", ".parametrizations.weight.original1")
        sd["module." + k] = v.clone()
    dst = DeepSDFDecoder(LATENT, **cfg)
    dst.load_state_dict(sd)
    for (ka, a), (kb, b) in zip(src.state_dict().items(), dst.state_dict().items()):
        assert ka == kb
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_init_is_seeded_and_bounded():
    a = DeepSDFDecoder(LATENT, dims=[32, 32], generator=torch.Generator().manual_seed(1))
    b = DeepSDFDecoder(LATENT, dims=[32, 32], generator=torch.Generator().manual_seed(1))
    for (_, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
    bound = 1.0 / np.sqrt(LATENT + 3)
    assert float(a.lin0.weight.detach().abs().max()) <= bound
    assert float(a.lin0.bias.detach().abs().max()) <= bound


def test_registry_builds_deepsdf_and_rejects_others():
    """The DeepSDF decoder builds; a NetworkArch the registry does not know raises."""
    dec = build_decoder("deep_sdf_decoder", 8, {"dims": [16, 16], "latent_in": [1]})
    assert isinstance(dec, DeepSDFDecoder)
    with pytest.raises(KeyError, match="unknown NetworkArch"):
        build_decoder("pointnet_decoder", 8, {})


@pytest.mark.parametrize("arch,specs", [
    ("deep_sdf_decoder", {"dims": [16, 16], "latent_in": [1]}),
    ("siren_decoder", {"dims": [32, 32], "latent_in": [1], "xyz_in": [1], "nonlinearity": "sine"}),
    ("local_decoder", {"dims": [32, 32], "grid_size": 4, "global_latent_size": 8}),
])
def test_registry_builds_every_architecture(arch, specs):
    """All three architectures of msd_tpu's registry build from a seed, the
    same weights from the same seed."""
    a = build_decoder(arch, 8, specs, generator=torch.Generator().manual_seed(3))
    b = build_decoder(arch, 8, specs, generator=torch.Generator().manual_seed(3))
    assert type(a).__name__ == {"deep_sdf_decoder": "DeepSDFDecoder", "siren_decoder": "SirenDecoder",
                                "local_decoder": "LocalShapesDecoder"}[arch]
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))


def test_give_surface_cuts_the_box():
    _, params, tdec = make_pair(CONFIGS[0], seed=9, surface=True)
    latent, xyz = inputs(n=4000, seed=10)
    with torch.no_grad():
        sdf = decode_sdf(tdec, torch.zeros(LATENT), torch.tensor(xyz))[:, 0]
    frac_neg = float((sdf < 0).float().mean())
    assert 0.2 < frac_neg < 0.8, frac_neg
    assert float(sdf.std()) > 0.05  # not flat
