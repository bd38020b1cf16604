"""msd_tpu_torch's CUDA kernels (K1, K2) against their plain PyTorch versions,
on an NVIDIA GPU. Every test here is marked ``cuda`` and skips without a GPU.
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


# K2: the Stage-1 fused loss and gradients. Small decoders of
# tests/test_torch_fused_train.py and the flagship width. Tolerances of the
# bf16 kernel against its bf16 plain version (two summation orders, which
# can flip an activation's last bit): loss sums 1e-3 relative, every
# gradient 2e-2 relative Frobenius.
K2_CONFIGS = {
    "b_latent_in": (True, dict(dims=[64] * 5, latent_in=[2])),
    "a_latent_in": (False, dict(dims=[64] * 5, latent_in=[2])),
    "b_weight_norm": (True, dict(dims=[64] * 5, latent_in=[2], weight_norm=True, norm_layers=[0, 1, 2, 3, 4])),
    "b_no_latent_in": (True, dict(dims=[64] * 5, latent_in=[])),
    "b_odd_width": (True, dict(dims=[200, 200, 200], latent_in=[2])),
}


def _k2_inputs(dec, B, P, dev, seed=3):
    rng = np.random.default_rng(seed)
    L = dec.latent_size
    lat = torch.tensor(0.3 * rng.standard_normal((B, L)), dtype=torch.float32, device=dev)
    xyz = torch.tensor(rng.uniform(-1, 1, (B, P, 3)), dtype=torch.float32, device=dev)
    gt = torch.tensor(0.25 * rng.standard_normal((B, P)), dtype=torch.float32, device=dev)
    n = dec.num_layers - 1
    weights = [dec.layer_weight(layer).detach() for layer in range(n)]
    biases = [getattr(dec, f"lin{layer}").bias.detach() for layer in range(n)]
    return weights, biases, lat, xyz, gt


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def _k2_check(dec, B, P, use_eikonal, dev):
    from msd_tpu_torch.ops import fused_train as ft

    args = (dec, *_k2_inputs(dec, B, P, dev), 0.1, use_eikonal, B * P)
    launches = ft.LAUNCHES
    out = ft.fused_point_grads(*args)
    torch.cuda.synchronize()
    assert ft.LAUNCHES == launches + 1
    ref = ft.point_grads(ft.fused_train_plain, *args)
    assert ft.LAUNCHES == launches + 1
    for i in (3, 4):  # sdf, eikonal losses
        assert abs(float(out[i]) - float(ref[i])) <= 1e-3 * abs(float(ref[i])) + 1e-12
    for grads, grads_ref in zip(out[:2], ref[:2]):  # dW, db per layer
        for layer, (g, r) in enumerate(zip(grads, grads_ref)):
            assert torch.isfinite(g).all()
            assert _rel(g, r) <= 2e-2, (layer, _rel(g, r))
    assert _rel(out[2], ref[2]) <= 2e-2  # dlat


@pytest.mark.parametrize("name", list(K2_CONFIGS))
def test_k2_matches_plain(name, dev):
    use_eikonal, cfg = K2_CONFIGS[name]
    dec = _decoder(cfg, dev)
    _k2_check(dec, 4, 256, use_eikonal, dev)


@pytest.mark.parametrize("use_eikonal", [True, False], ids=["b", "a"])
def test_k2_matches_plain_flagship_width(use_eikonal, dev, monkeypatch):
    from msd_tpu_torch.ops import fused_train as ft

    with open(os.path.join(ROOT, "examples", "ADNI", "minimal_eikonal", "specs.json")) as f:
        specs = json.load(f)
    dec = build_decoder(specs["NetworkArch"], specs["CodeLength"], specs["NetworkSpecs"],
                        generator=torch.Generator().manual_seed(0)).to(dev)
    give_surface_(dec, torch.zeros(specs["CodeLength"]))
    monkeypatch.setattr(ft, "CHUNK_POINTS", 2 * 4096)  # two chunks
    _k2_check(dec, 4, 4096, use_eikonal, dev)


def _k2_d_check(dec, B, P, dev):
    """Variant d (want_wgrad=False) against its plain version: loss sum
    1e-5 relative (float32 sums of the same per-point values in two orders)
    and dlat 1e-2 relative Frobenius (two bf16 summation orders); no weight
    gradients."""
    from msd_tpu_torch.ops import fused_train as ft

    args = (dec, *_k2_inputs(dec, B, P, dev), 0.1, False, B * P)
    launches = ft.LAUNCHES
    out = ft.fused_point_grads(*args, want_wgrad=False)
    torch.cuda.synchronize()
    assert ft.LAUNCHES == launches + 1
    ref = ft.point_grads(ft.fused_train_plain, *args, want_wgrad=False)
    assert out[0] is None and out[1] is None
    assert abs(float(out[3]) - float(ref[3])) <= 1e-5 * abs(float(ref[3]))
    assert torch.isfinite(out[2]).all() and _rel(out[2], ref[2]) <= 1e-2
    # the same dlat as variant a's kernel
    a = ft.fused_point_grads(*args)
    assert _rel(out[2], a[2]) <= 1e-2


@pytest.mark.parametrize("name", list(K2_CONFIGS))
def test_k2_d_matches_plain(name, dev):
    dec = _decoder(K2_CONFIGS[name][1], dev)
    _k2_d_check(dec, 4, 256, dev)


def test_k2_d_matches_plain_flagship_width(dev, monkeypatch):
    from msd_tpu_torch.ops import fused_train as ft

    with open(os.path.join(ROOT, "examples", "ADNI", "minimal_eikonal", "specs.json")) as f:
        specs = json.load(f)
    dec = build_decoder(specs["NetworkArch"], specs["CodeLength"], specs["NetworkSpecs"],
                        generator=torch.Generator().manual_seed(0)).to(dev)
    give_surface_(dec, torch.zeros(specs["CodeLength"]))
    monkeypatch.setattr(ft, "CHUNK_POINTS", 2 * 4096)  # two chunks
    _k2_d_check(dec, 4, 4096, dev)


def test_fused_sdf_l1_on_card(dev):
    """The Stage-2 term on the card: bf16 K2 d and a against float32
    autograd of the same term; the latent gradient points the same way
    (cosine over 0.95, as the Stage-1 trainer test allows for bf16: 0.984
    measured on an H100 at this width)."""
    from msd_tpu_torch.ops import fused_train as ft

    dec = _decoder(K2_CONFIGS["a_latent_in"][1], dev)
    _, _, lat, xyz, gt = _k2_inputs(dec, 4, 256, dev)
    z = lat.clone().requires_grad_(True)
    pred = dec(torch.cat([z.repeat_interleave(256, 0), xyz.reshape(-1, 3)], 1)).clamp(-0.1, 0.1)
    ref = (pred[:, 0] - gt.reshape(-1).clamp(-0.1, 0.1)).abs().mean()
    (g_ref,) = torch.autograd.grad(ref, z)
    for train_net in (False, True):
        z = lat.clone().requires_grad_(True)
        dec.zero_grad()
        v = ft.fused_sdf_l1(dec, z, xyz, gt, 0.1, train_net=train_net)
        v.backward()
        assert abs(float(v.detach()) - float(ref)) <= 1e-2 * float(ref)
        assert float(torch.nn.functional.cosine_similarity(z.grad.reshape(-1), g_ref.reshape(-1), 0)) > 0.95
        assert all((p.grad is not None) == train_net for p in dec.parameters())


def test_k2_cuda_tensor_never_falls_back(dev, monkeypatch):
    from msd_tpu_torch.ops import _build
    from msd_tpu_torch.ops import fused_train as ft

    dec = _decoder(K2_CONFIGS["b_latent_in"][1], dev)
    args = (dec, *_k2_inputs(dec, 2, 128, dev), 0.1, True, 256)
    with pytest.raises(ValueError, match="bfloat16"):
        ft.fused_point_grads(*args, dtype=torch.float32)
    d_args = (dec, *_k2_inputs(dec, 2, 128, dev), 0.1, False, 256)
    with pytest.raises(ValueError, match="bfloat16"):
        ft.fused_point_grads(*d_args, dtype=torch.float32, want_wgrad=False)

    def broken(name):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(_build, "load_library", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ft.fused_point_grads(*args)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ft.fused_point_grads(*d_args, want_wgrad=False)
    ln = _decoder(CONFIGS["layer_norm"], dev)
    with pytest.raises(ft.UnsupportedConfig):
        ft.fused_point_grads(ln, *_k2_inputs(ln, 2, 128, dev), 0.1, True, 256)


# The Stage-1 trainer on the card: a supported config takes K2 once per
# step; a config that needs a K2 variant not ported yet raises.
TRAIN_SPECS = {
    "NetworkArch": "deep_sdf_decoder",
    "NetworkSpecs": {"dims": [64] * 5, "dropout": [], "dropout_prob": 0.0, "norm_layers": [],
                     "latent_in": [2], "xyz_in_all": False, "use_tanh": False, "latent_dropout": False,
                     "weight_norm": False},
    "CodeLength": 16, "NumEpochs": 2, "SnapshotFrequency": 2, "SamplesPerScene": 256, "ScenesPerBatch": 2,
    "LearningRateSchedule": [{"Type": "Constant", "Value": 5e-4}, {"Type": "Constant", "Value": 1e-3}],
    "UseEikonal": True, "ClampingDistance": 0.1, "CodeBound": 1.0, "GradientClipNorm": 1.0,
}


@pytest.fixture
def train_data(tmp_path):
    from chip_smoke import write_dataset

    split = write_dataset(str(tmp_path / "data"), 4, 5000, seed=2)
    path = str(tmp_path / "split.json")
    with open(path, "w") as f:
        json.dump(split, f)
    return dict(TRAIN_SPECS, DataSource=str(tmp_path / "data" / "SdfSamples"), TrainSplit=path)


def test_trainer_takes_k2_once_per_step(dev, train_data, tmp_path):
    from msd_tpu_torch.ops import fused_train as ft
    from msd_tpu_torch.train.stage1 import Stage1Trainer

    k2 = Stage1Trainer(str(tmp_path / "k2"), specs=train_data, device="cuda")
    ag = Stage1Trainer(str(tmp_path / "ag"), specs=dict(train_data, UseFusedTrainKernel=False), device="cuda")
    assert k2.use_fused and k2.k2_dtype == torch.bfloat16 and not ag.use_fused
    def flat(t):
        return torch.cat([p.detach().reshape(-1) for p in t.decoder.parameters()] + [t.latents.detach().reshape(-1)])

    init = flat(k2)
    assert torch.equal(init, flat(ag))
    launches = ft.LAUNCHES
    m = k2.train_epoch(1)
    assert ft.LAUNCHES == launches + 2  # 4 scenes, 2 per batch
    assert all(np.isfinite(v) for v in m.values())
    ag.train_epoch(1)  # autograd (float32) from the same seed and batches
    assert ft.LAUNCHES == launches + 2
    # bf16 K2 against float32 autograd: the epoch's updates point the same way
    a, b = flat(k2) - init, flat(ag) - init
    assert float(torch.dot(a, b) / (a.norm() * b.norm())) > 0.95


def test_trainer_k2_variant_c_raises_on_card(dev, train_data, tmp_path):
    from msd_tpu_torch.train.stage1 import Stage1Trainer

    with pytest.raises(NotImplementedError, match="variant c"):
        Stage1Trainer(str(tmp_path / "c"), specs=dict(train_data, EikonalNumPoints=128), device="cuda")


def test_stage2_trainer_takes_k2d_once_per_step(dev, train_data, tmp_path):
    """The Stage-2 trainer with the flagship switches (frozen decoder) takes
    K2 variant d once per step, in bf16, and its metrics are finite."""
    from chip_smoke import write_labels
    from msd_tpu_torch.ops import fused_train as ft
    from msd_tpu_torch.train.stage2 import Stage2Trainer

    with open(os.path.join(ROOT, "examples", "ADNI", "MLP_VAE_SDF_disentangle_all_true_label_age", "specs.json")) as f:
        specs = json.load(f)
    for key in ("DataSourceMesh", "TestSplit", "PretrainedLatentPath", "PretrainedSDFDecoderPath", "EvalGTMeshDir"):
        specs.pop(key)
    with open(train_data["TrainSplit"]) as f:
        write_labels(train_data["DataSource"], json.load(f), seed=1)
    specs.update(DataSource=train_data["DataSource"], TrainSplit=train_data["TrainSplit"],
                 NetworkSpecs=TRAIN_SPECS["NetworkSpecs"], CodeLength=16, VAEInputDim=16, SamplesPerScene=256,
                 ScenesPerBatch=2, TrainLatentHoldoutFraction=0.0, EvalTrainFrequency=0, EvalTestFrequency=0)
    teacher = (0.1 * np.random.default_rng(0).standard_normal((4, 16))).astype(np.float32)
    tr = Stage2Trainer(str(tmp_path / "s2"), specs=specs, teacher_latents=teacher, device="cuda")
    assert tr.fused_ok and tr.k2_dtype == torch.bfloat16 and not tr.train_sdf_decoder
    launches = ft.LAUNCHES
    m = tr.train_epoch(1)
    assert ft.LAUNCHES == launches + 2  # 4 scenes, 2 per batch
    assert all(np.isfinite(v) for v in m.values())
    assert not any(p.grad is not None for p in tr.sdf_decoder.parameters())
