"""msd_tpu_torch's CUDA kernels against their plain PyTorch versions, on an
NVIDIA GPU. Every test here is marked ``cuda`` and skips without a GPU.
This file imports neither JAX nor msd_tpu, so it runs on a machine that has
only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import json
import os

import numpy as np
import pytest
import torch

from msd_tpu_torch import mesh
from msd_tpu_torch.models import build_decoder
from msd_tpu_torch.models.deepsdf import DeepSDFDecoder, give_surface_
from msd_tpu_torch.ops import fused_mlp
from msd_tpu_torch.ops.fused_mlp import FusedDecoderSpec, fused_eval, fused_eval_plain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LATENT = 16
# the fused configs of tests/test_torch_decoder.py, and two wider than a
# tile's activations in shared memory hold (the kernel's scratch variant)
CONFIGS = {
    "flagship_shape": dict(dims=[64] * 8, latent_in=[4], weight_norm=True, norm_layers=[]),
    "weight_norm": dict(dims=[32, 32, 32], latent_in=[2], weight_norm=True, norm_layers=[0, 1, 2]),
    "layer_norm": dict(dims=[32, 200], latent_in=[], weight_norm=False, norm_layers=[0, 1]),
    "use_tanh": dict(dims=[32, 32], latent_in=[1], weight_norm=False, norm_layers=[], use_tanh=True),
    "wide": dict(dims=[1024, 1024, 512], latent_in=[1], weight_norm=False, norm_layers=[]),
    "wide_layer_norm": dict(dims=[1000, 700], latent_in=[], weight_norm=False, norm_layers=[0, 1]),
}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from msd_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _decoder(cfg, dev, seed=4):
    dec = DeepSDFDecoder(LATENT, generator=torch.Generator().manual_seed(seed), **cfg).to(dev).eval()
    with torch.no_grad():
        for name, p in dec.named_parameters():
            if name.startswith("bn"):  # non-trivial LayerNorm affine
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(seed)).to(dev))
    if not dec.use_tanh:
        give_surface_(dec, torch.zeros(LATENT))
    return dec


def _inputs(n, dev, seed=8):
    rng = np.random.default_rng(seed)
    latent = torch.tensor(0.1 * rng.standard_normal(LATENT), dtype=torch.float32, device=dev)
    xyz = torch.tensor(rng.uniform(-1, 1, (n, 3)), dtype=torch.float32, device=dev)
    return latent, xyz


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_kernel_matches_plain(name, dtype, dev):
    spec = FusedDecoderSpec(_decoder(CONFIGS[name], dev), dtype)
    latent, xyz = _inputs(1000, dev)  # ragged: not a multiple of either tile
    launches = fused_mlp.LAUNCHES
    out = fused_eval(spec, latent, xyz)
    torch.cuda.synchronize()
    assert fused_mlp.LAUNCHES == launches + 1
    ref = fused_eval_plain(spec, latent, xyz)
    assert torch.isfinite(out).all()
    assert float((out - ref).abs().max()) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_matches_plain_flagship_width(dtype, dev):
    with open(os.path.join(ROOT, "examples", "ADNI", "minimal_eikonal", "specs.json")) as f:
        specs = json.load(f)
    dec = build_decoder(specs["NetworkArch"], specs["CodeLength"], specs["NetworkSpecs"],
                        generator=torch.Generator().manual_seed(0)).to(dev).eval()
    give_surface_(dec, torch.zeros(specs["CodeLength"]))
    spec = FusedDecoderSpec(dec, dtype)
    assert spec.out_true[3] == 253 and spec.out_pad[3] == 256
    g = torch.Generator(device=dev).manual_seed(1)
    xyz = torch.rand(5000, 3, generator=g, device=dev) * 2 - 1
    latent = 0.01 * torch.randn(specs["CodeLength"], generator=g, device=dev)
    out = fused_eval(spec, latent, xyz)
    ref = fused_eval_plain(spec, latent, xyz)
    assert float((out - ref).abs().max()) <= TOL[dtype]


def test_scratch_only_past_shared_memory(dev):
    from msd_tpu_torch.ops._build import load_library

    lib = load_library("fused_mlp")
    for code in (0, 1):  # bf16, float32
        assert lib.msd_fused_mlp_scratch_bytes(code, 512, 2**20) == 0  # flagship width
        assert lib.msd_fused_mlp_scratch_bytes(code, 768, 2**20) == 2 * 2**20 * 768 * (2 if code == 0 else 4)
    assert lib.msd_fused_mlp_scratch_bytes(2, 512, 10) == -1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_wide_launches_split_by_scratch(dtype, dev, monkeypatch):
    spec = FusedDecoderSpec(_decoder(CONFIGS["wide"], dev), dtype)
    latent, xyz = _inputs(3001, dev, seed=9)
    whole = fused_eval(spec, latent, xyz)
    # 1 MiB of scratch: 255 points a launch at bf16, 127 at float32 (kmax 1024)
    monkeypatch.setattr(fused_mlp, "SCRATCH_CAP_BYTES", 2**20)
    launches = fused_mlp.LAUNCHES
    split = fused_eval(spec, latent, xyz)
    torch.cuda.synchronize()
    assert fused_mlp.LAUNCHES - launches == (12 if dtype == torch.bfloat16 else 24)
    assert torch.equal(split, whole)  # points are independent: same bits


def test_cuda_tensor_never_falls_back(dev, monkeypatch):
    from msd_tpu_torch.ops import _build

    spec = FusedDecoderSpec(_decoder(CONFIGS["flagship_shape"], dev), torch.bfloat16)
    latent, xyz = _inputs(10, dev)

    def broken(name):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(_build, "load_library", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fused_eval(spec, latent, xyz)
    with pytest.raises(ValueError, match="float32"):
        fused_eval(spec, latent, xyz.double())


def test_create_mesh_on_gpu_launches_kernel(dev):
    dec = _decoder(CONFIGS["flagship_shape"], dev)
    ev = mesh.PointEvaluator(dec)
    assert ev.fused and ev.dtype == torch.bfloat16
    launches = fused_mlp.LAUNCHES
    res = mesh.create_mesh(dec, torch.zeros(LATENT), N=129, return_mesh=True, evaluator=ev)
    assert res is not False and res[1].shape[0] > 0
    assert fused_mlp.LAUNCHES > launches
    # the float32 kernel meshes like the CPU does
    cpu = mesh.create_mesh(dec.cpu(), torch.zeros(LATENT), N=129, return_mesh=True)
    gpu = mesh.create_mesh(dec.to(dev), torch.zeros(LATENT), N=129, return_mesh=True, eval_dtype=torch.float32)
    assert abs(gpu[0].shape[0] - cpu[0].shape[0]) <= 0.001 * cpu[0].shape[0]
