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


# K1's routes: bf16 without LayerNorm up to width 512 takes "wgmma", every
# other config "mma_sync"
ROUTE_BF16 = {"flagship_shape": "wgmma", "weight_norm": "wgmma", "layer_norm": "mma_sync", "use_tanh": "wgmma",
              "wide": "mma_sync", "wide_layer_norm": "mma_sync"}
WGMMA_NS = [0, 1, 37, 127, 128, 129, 1000, 2**16 + 37]


def _flagship(dev):
    with open(os.path.join(ROOT, "examples", "ADNI", "minimal_eikonal", "specs.json")) as f:
        specs = json.load(f)
    dec = build_decoder(specs["NetworkArch"], specs["CodeLength"], specs["NetworkSpecs"],
                        generator=torch.Generator().manual_seed(0)).to(dev).eval()
    give_surface_(dec, torch.zeros(specs["CodeLength"]))
    g = torch.Generator(device=dev).manual_seed(1)
    return dec, 0.01 * torch.randn(specs["CodeLength"], generator=g, device=dev)


def _routes():
    return dict(fused_mlp.ROUTE_LAUNCHES)


@pytest.mark.parametrize("n", WGMMA_NS)
@pytest.mark.parametrize("width", [64, 128, 256, 512])
def test_wgmma_route_matches_plain(width, n, dev):
    dec = _decoder(dict(dims=[width] * 4, latent_in=[2], weight_norm=False, norm_layers=[]), dev)
    spec = FusedDecoderSpec(dec, torch.bfloat16)
    assert spec.route == "wgmma"
    latent, xyz = _inputs(n, dev)
    before = _routes()
    out = fused_eval(spec, latent, xyz)
    again = fused_eval(spec, latent, xyz)
    torch.cuda.synchronize()
    assert _routes() == {"wgmma": before["wgmma"] + (2 if n else 0), "mma_sync": before["mma_sync"]}
    assert out.shape == (n,) and torch.equal(out, again)
    if n:
        assert torch.isfinite(out).all()
        assert float((out - fused_eval_plain(spec, latent, xyz).to(out.device)).abs().max()) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_route_by_config(name, dtype, dev):
    spec = FusedDecoderSpec(_decoder(CONFIGS[name], dev), dtype)
    route = ROUTE_BF16[name] if dtype == torch.bfloat16 else "mma_sync"
    assert spec.route == route
    latent, xyz = _inputs(777, dev, seed=11)
    before = _routes()
    out = fused_eval(spec, latent, xyz)
    again = fused_eval(spec, latent, xyz)
    torch.cuda.synchronize()
    other = "mma_sync" if route == "wgmma" else "wgmma"
    assert _routes()[route] == before[route] + 2 and _routes()[other] == before[other]
    if route == "wgmma":  # mma_sync's LayerNorm layers sum row statistics with atomics
        assert torch.equal(out, again)
    assert float((out - fused_eval_plain(spec, latent, xyz)).abs().max()) <= TOL[dtype]


def test_wgmma_flagship_spec(dev):
    dec, latent = _flagship(dev)
    spec = FusedDecoderSpec(dec, torch.bfloat16)
    assert spec.route == "wgmma" and spec.n_wtiles == 96
    g = torch.Generator(device=dev).manual_seed(2)
    xyz = torch.rand(2**16 + 37, 3, generator=g, device=dev) * 2 - 1
    before = _routes()
    out = fused_eval(spec, latent, xyz)
    again = fused_eval(spec, latent, xyz)
    torch.cuda.synchronize()
    assert _routes()["wgmma"] == before["wgmma"] + 2 and _routes()["mma_sync"] == before["mma_sync"]
    assert torch.equal(out, again)
    ref = fused_eval_plain(spec, latent, xyz)
    assert float((out - ref).abs().max()) <= TOL[torch.bfloat16]
    # the mma_sync kernel on the same spec (the measurement hook) agrees too
    old = fused_mlp._eval_mma_sync(spec, latent, xyz)
    assert float((old - ref).abs().max()) <= TOL[torch.bfloat16]


def test_wgmma_failure_raises_and_never_switches_route(dev, monkeypatch):
    from msd_tpu_torch.ops import _build

    spec = FusedDecoderSpec(_decoder(CONFIGS["flagship_shape"], dev), torch.bfloat16)
    assert spec.route == "wgmma"
    latent, xyz = _inputs(300, dev)
    before = _routes()
    monkeypatch.setattr(spec, "n_wtiles", spec.n_wtiles + 1)  # refused by the launcher
    with pytest.raises(RuntimeError, match="wgmma kernel launch failed"):
        fused_eval(spec, latent, xyz)
    monkeypatch.undo()
    monkeypatch.setattr(_build, "load_library", lambda name: (_ for _ in ()).throw(RuntimeError("nvcc failed")))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fused_eval(spec, latent, xyz)
    assert _routes() == before
    with pytest.raises(ValueError, match="no wgmma weight tiles"):
        fused_mlp._eval_wgmma(FusedDecoderSpec(_decoder(CONFIGS["layer_norm"], dev), torch.bfloat16), latent, xyz)


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


def _ellipsoid_decoder(dev, steps=300):
    """The flagship-shape decoder fitted to an ellipsoid's distance field
    (as tests/test_torch_streaming_mesh.py's fixture), so its surface is
    closed; returns (decoder, latent)."""
    from msd_tpu_torch.models.deepsdf import decode_sdf

    dec = DeepSDFDecoder(LATENT, generator=torch.Generator().manual_seed(21), **CONFIGS["flagship_shape"]).to(dev)
    latent = torch.tensor(0.05 * np.random.default_rng(22).standard_normal(LATENT), dtype=torch.float32, device=dev)
    axes = torch.tensor([0.55, 0.4, 0.45], device=dev)
    g = torch.Generator().manual_seed(0)
    opt = torch.optim.Adam(dec.parameters(), lr=2e-3)
    for _ in range(steps):
        x = (torch.rand(4096, 3, generator=g) * 2 - 1).to(dev)
        target = (torch.linalg.norm(x / axes, dim=1) - 1) * axes.min()
        loss = (decode_sdf(dec, latent, x)[:, 0] - target).abs().mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
    return dec.eval(), latent


@pytest.mark.parametrize("codec", ["f16", "int8", "packed"])
def test_stream_encoder_on_card_equals_cpu(codec, dev):
    """The slab encoder (crossing filter, compaction, value codec) on the
    card gives the CPU encoder's bytes."""
    rng = np.random.default_rng(3)
    n = 3000
    vals = rng.uniform(0.001, 0.2, (n, 125)) * rng.choice([-1.0, 1.0], (n, 1))
    cross = rng.random(n) < 0.4
    grid = np.stack(np.meshgrid(*[np.arange(5) - 2.0] * 3, indexing="ij"), -1).reshape(125, 3)
    vals[cross] = (grid @ rng.normal(size=(3, int(cross.sum())))).T * 0.02
    vals[rng.random((n, 125)) < 0.02] = 0.0
    vals[rng.random((n, 125)) < 0.01] *= 40.0
    vals = torch.tensor(vals.astype(np.float16))
    q = mesh.PointEvaluator._codec_q(codec, 2.0 / 256)
    ev = mesh.PointEvaluator(_decoder(CONFIGS["flagship_shape"], dev))
    for cap, use_u16 in ((4096, True), (700, True), (4096, False)):
        ref = ev._encode_compact_body(vals, 2600, cap, codec, q, use_u16)
        out = ev._encode_compact_body(vals.to(dev), 2600, cap, codec, q, use_u16)
        for a, b in zip(out, ref):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a.cpu(), b), (codec, cap, use_u16)


@pytest.mark.parametrize("codec", ["f16", "int8", "packed"])
def test_streamed_mesh_on_card_against_float32_mesh(codec, dev):
    """create_mesh streams on the card (K1 launched, the device refinement
    at N=129) and gives the faces of the float32 sparse route on the same
    evaluator, within msd_tpu's codec bounds
    (tests/test_torch_streaming_mesh.py); both watertight."""
    from scipy.spatial import cKDTree

    from msd_tpu_torch.models.deepsdf import decode_sdf

    dec, latent = _ellipsoid_decoder(dev)
    ev = mesh.PointEvaluator(dec)
    h = 2.0 / 128
    # the float32 sparse route (create_mesh's off the card)
    pv, pf = mesh._create_mesh_sparse(latent, 129, 4, 1.3, ev)
    launches = fused_mlp.LAUNCHES
    mesh.LAST_STREAMING_STATS.clear()
    v, f = mesh.create_mesh(dec, latent, N=129, return_mesh=True, evaluator=ev, value_codec=codec)
    stats = mesh.LAST_STREAMING_STATS
    assert fused_mlp.LAUNCHES > launches and stats["value_codec"] == codec and stats["crossing_blocks"] > 0
    assert stats["exact_slabs"] == 0 and stats["refine"] == "device"
    edges = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1)
    assert (np.unique(edges, axis=0, return_counts=True)[1] == 2).all()
    np.testing.assert_array_equal(f, pf)
    if codec == "f16":
        assert cKDTree(pv).query(v)[0].max() < 0.05 * h
        return
    with torch.no_grad():
        at = lambda x: decode_sdf(dec, latent, torch.from_numpy(x).to(dev))[:, 0].cpu().numpy()  # noqa: E731
        resid = np.abs(at(v) - at(pv)).max()
    assert resid < {"int8": 0.08, "packed": 0.06}[codec] * h, resid / h


@pytest.mark.parametrize("field,N", [("seeded", 129), ("ellipsoid", 257)])
def test_dedup_rows_on_card_equal_plain_rows(field, N, dev):
    """The corner dedup's [n, 125] float16 rows through the wgmma K1 equal
    the plain slab's bit for bit, at flagship width on the device active
    set of the seeded flagship decoder and of the ellipsoid fit, slabs of
    2048 blocks (the last one padded), orphan caps that hold every orphan."""
    dec, latent = _flagship(dev) if field == "seeded" else _ellipsoid_decoder(dev)
    ev = mesh.PointEvaluator(dec)
    ev.A_CHUNK = 2048
    assert ev.spec.route == "wgmma"
    _, A, _, abi_dev = ev.refine_active4_device(latent, N, 1.3, 0.1, async_fetch=True)
    map_dev = ev._block_map(abi_dev, A)
    h = 2.0 / (N - 1)
    launches = _routes()["wgmma"]
    for lo in range(0, A, ev.A_CHUNK):
        n = min(ev.A_CHUNK, A - lo)
        vals, flag = ev._dedup_values(latent, abi_dev, map_dev, lo, n, h, 1000)
        plain = ev._blocks_f16(latent, abi_dev[lo:lo + vals.shape[0]], h)
        assert int(flag) == 0 and torch.equal(vals[:n], plain[:n]), (N, lo)
    assert A > 2048 and _routes()["wgmma"] >= launches + 2 * -(-A // ev.A_CHUNK)


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
    # one hidden layer: last_kernel writes its u rows (b) or delta rows (a),
    # or in variant d only their column sums
    "b_one_hidden": (True, dict(dims=[64], latent_in=[])),
    "a_one_hidden": (False, dict(dims=[64], latent_in=[])),
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


# K2 variants c (EikonalNumPoints: the eikonal on the first E points of each
# scene) and e (per-scene 0/1 weights of a padded batch) against the plain
# version on the card, with K2 b's tolerances; a pad scene's latent row gets
# exactly zero. name: (use_eikonal, EikonalNumPoints, scene weights)
K2_CE_CASES = {
    "c": (True, 256, None),
    "e_eikonal": (True, None, [1, 1, 1, 0]),
    "e_no_eikonal": (False, None, [1, 0, 1, 1]),
    "c_and_e": (True, 200, [1, 1, 0, 1]),
}


def _k2_ce_check(dec, B, P, use_eikonal, eik_points, w, dev, check_gate=True):
    from msd_tpu_torch.ops import fused_train as ft

    kw = dict(eik_points=eik_points)
    if w is not None:
        kw.update(scene_weights=torch.tensor(w, dtype=torch.float32, device=dev), n_real=sum(w))
    args = (dec, *_k2_inputs(dec, B, P, dev), 0.1, use_eikonal, (B if w is None else sum(w)) * P)
    before = dict(ft.VARIANT_LAUNCHES)
    out = ft.fused_point_grads(*args, **kw)
    torch.cuda.synchronize()
    gated = use_eikonal and ft.eikonal_rows(P, eik_points) < P
    assert ft.VARIANT_LAUNCHES["c"] - before["c"] == int(gated)
    assert ft.VARIANT_LAUNCHES["e"] - before["e"] == int(w is not None)
    ref = ft.point_grads(ft.fused_train_plain, *args, **kw)
    for i in (3, 4):
        assert abs(float(out[i]) - float(ref[i])) <= 1e-3 * abs(float(ref[i])) + 1e-12
    for grads, grads_ref in zip(out[:2], ref[:2]):
        for layer, (g, r) in enumerate(zip(grads, grads_ref)):
            assert torch.isfinite(g).all()
            assert _rel(g, r) <= 2e-2, (layer, _rel(g, r))
    assert _rel(out[2], ref[2]) <= 2e-2
    if w is not None:
        assert bool((out[2][torch.tensor(w, device=dev) == 0] == 0).all())
    if gated and check_gate:  # the gate does something
        full = ft.fused_point_grads(*args, **dict(kw, eik_points=None))
        assert float(full[4]) != float(out[4])


@pytest.mark.parametrize("name", list(K2_CE_CASES))
def test_k2_c_e_match_plain(name, dev):
    use_eikonal, eik_points, w = K2_CE_CASES[name]
    dec = _decoder(K2_CONFIGS["b_latent_in"][1], dev)
    _k2_ce_check(dec, 4, 512, use_eikonal, eik_points, w, dev)


def test_k2_c_e_tile_step_down(dev):
    """P = 384, E = 100: the kernel's tiling gates on 128 points."""
    dec = _decoder(K2_CONFIGS["b_no_latent_in"][1], dev)
    _k2_ce_check(dec, 4, 384, True, 100, [1, 1, 1, 0], dev)


def test_k2_c_e_match_plain_flagship_width(dev, monkeypatch):
    from msd_tpu_torch.ops import fused_train as ft

    with open(os.path.join(ROOT, "examples", "ADNI", "minimal_eikonal", "specs.json")) as f:
        specs = json.load(f)
    dec = build_decoder(specs["NetworkArch"], specs["CodeLength"], specs["NetworkSpecs"],
                        generator=torch.Generator().manual_seed(0)).to(dev)
    give_surface_(dec, torch.zeros(specs["CodeLength"]))
    monkeypatch.setattr(ft, "CHUNK_POINTS", 2 * 4096)  # two chunks
    # latents far from the surface's: the field is flat and clamped, so every
    # eikonal lane is 1 with or without the gate
    _k2_ce_check(dec, 4, 4096, True, 1024, [1, 1, 1, 0], dev, check_gate=False)


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


def test_trainer_k2_variant_c_on_card(dev, train_data, tmp_path):
    """EikonalNumPoints 128 of 512 points: the trainer takes K2 variant c
    (gated on 256 points) once per step."""
    from msd_tpu_torch.ops import fused_train as ft
    from msd_tpu_torch.train.stage1 import Stage1Trainer

    tr = Stage1Trainer(str(tmp_path / "c"), specs=dict(train_data, EikonalNumPoints=128, SamplesPerScene=512),
                       device="cuda")
    assert tr.use_fused and tr.eikonal_num_points == 128 and ft.eikonal_rows(512, 128) == 256
    before = dict(ft.VARIANT_LAUNCHES)
    m = tr.train_epoch(1)
    assert ft.VARIANT_LAUNCHES["c"] == before["c"] + 2 and ft.VARIANT_LAUNCHES["b"] == before["b"]
    assert all(np.isfinite(v) for v in m.values())


def test_trainer_gmm_step_k2_b_against_autograd(dev, train_data, tmp_path):
    """A step in the manner of the minimal_eikonal_gmm configs (eikonal, GMM
    prior, covariance) on K2 b against the same trainer's float32 autograd
    path from the same state: K2 b once; the losses and GMM gradients to
    1e-5 relative (both see the same latent rows); the decoder and latent
    gradients within the smoke's K2-versus-autograd limits."""
    from msd_tpu_torch.data.sdf_samples import sample_sdf_batch
    from msd_tpu_torch.ops import fused_train as ft
    from msd_tpu_torch.train.stage1 import Stage1Trainer

    specs = dict(train_data, UseGMMPriorLoss=True, UseCovarianceLoss=True, GMMLambda=1e-2, GMMInitSigma=0.6,
                 GMMMinSigma=0.5, CovarianceLossLambda=0.1)
    k2 = Stage1Trainer(str(tmp_path / "k2"), specs=specs, device="cuda")
    ag = Stage1Trainer(str(tmp_path / "ag"), specs=dict(specs, UseFusedTrainKernel=False), device="cuda")
    assert k2.use_fused and not ag.use_fused and set(k2.optimizer.groups) == {"net", "lat", "gmm"}
    idx = torch.tensor([3, 0], device=dev)
    pos, pc, neg, nc = k2.dataset.device_arrays(dev)
    batch = sample_sdf_batch(pos, pc, neg, nc, idx, 256, torch.Generator(device=dev).manual_seed(5))
    before = dict(ft.VARIANT_LAUNCHES)
    a = k2.step(idx, batch, 3, 5e-4, 1e-3)
    b = ag.step(idx, batch, 3, 5e-4, 1e-3)
    assert ft.VARIANT_LAUNCHES["b"] == before["b"] + 1
    assert sum(ft.VARIANT_LAUNCHES.values()) == sum(before.values()) + 1
    for k in ("covariance", "gmm", "gmm_nll", "gmm_entropy"):
        assert torch.isfinite(a[k]) and abs(float(a[k]) - float(b[k])) <= 1e-5 * abs(float(b[k])), k
    for k in ("mu", "log_sigma"):
        assert _rel(k2.gmm[k].grad, ag.gmm[k].grad) < 1e-5, k
    assert k2.gmm["logits"].grad is None and ag.gmm["logits"].grad is None  # GMMLearnPi false
    grads = [(p.grad, q.grad) for p, q in zip(k2.decoder.parameters(), ag.decoder.parameters())]
    for got, ref in grads + [(k2.latents.grad, ag.latents.grad)]:
        cos = float((got.double() * ref.double()).sum() / (got.double().norm() * ref.double().norm()))
        assert _rel(got, ref) < 0.15 and cos > 0.99


def _dp_rank(group, specs, exp, idx, batch):
    from msd_tpu_torch.ops import fused_train as ft
    from msd_tpu_torch.train.stage1 import Stage1Trainer

    tr = Stage1Trainer(exp, specs=specs, group=group)
    ft.reset_launches()
    aux = tr.step(torch.as_tensor(idx, device=tr.device), batch.to(tr.device), 3.0, 1e-3, 5e-3)
    grads = torch.cat([p.grad.reshape(-1) for p in tr.decoder.parameters()] + [tr.latents.grad.reshape(-1)])
    return {k: float(v) for k, v in aux.items()}, grads.cpu(), dict(ft.VARIANT_LAUNCHES)


def test_trainer_data_parallel_on_card(dev, train_data, tmp_path):
    """3 scenes on 2 ranks (gloo, both on this card) pad to 4: each rank
    runs K2 e once, and the step's losses (1e-5 relative) and summed
    gradients (1e-3 relative Frobenius: float32 sums in another order)
    equal the one-process step's."""
    from msd_tpu_torch.data.sdf_samples import sample_sdf_batch
    from msd_tpu_torch.parallel import run_ranks
    from msd_tpu_torch.train.stage1 import Stage1Trainer

    specs = dict(train_data, ScenesPerBatch=3)
    exp = str(tmp_path / "dp")
    one = Stage1Trainer(exp, specs=specs, device="cuda")
    idx = np.array([2, 0, 3])
    pos, pc, neg, nc = one.dataset.device_arrays(one.device)
    batch = sample_sdf_batch(pos, pc, neg, nc, torch.as_tensor(idx, device=dev), 256,
                             torch.Generator(device=dev).manual_seed(1))
    ref = one.step(torch.as_tensor(idx, device=dev), batch, 3.0, 1e-3, 5e-3)
    ref_grads = torch.cat([p.grad.reshape(-1) for p in one.decoder.parameters()] + [one.latents.grad.reshape(-1)])
    ranks = run_ranks(_dp_rank, 2, (specs, exp, idx, batch.cpu()), devices=[str(dev)] * 2, timeout=300)
    for aux, grads, launches in ranks:
        assert launches["e"] == 1 and launches["b"] == 1
        for k in ("sdf", "eikonal", "reg", "total"):
            assert abs(aux[k] - float(ref[k])) <= 1e-5 * abs(float(ref[k])), k
        assert _rel(grads, ref_grads.cpu()) <= 1e-3


def _stage2_specs(train_data, **extra):
    """The flagship Stage-2 switches on ``train_data``'s 4 ellipsoids, with
    their labels, at the card tests' width; no eval epoch."""
    from chip_smoke import write_labels

    with open(os.path.join(ROOT, "examples", "ADNI", "MLP_VAE_SDF_disentangle_all_true_label_age", "specs.json")) as f:
        specs = json.load(f)
    for key in ("DataSourceMesh", "TestSplit", "PretrainedLatentPath", "PretrainedSDFDecoderPath", "EvalGTMeshDir"):
        specs.pop(key)
    with open(train_data["TrainSplit"]) as f:
        write_labels(train_data["DataSource"], json.load(f), seed=1)
    specs.update(DataSource=train_data["DataSource"], TrainSplit=train_data["TrainSplit"],
                 NetworkSpecs=TRAIN_SPECS["NetworkSpecs"], CodeLength=16, VAEInputDim=16, SamplesPerScene=256,
                 ScenesPerBatch=2, TrainLatentHoldoutFraction=0.0, EvalTrainFrequency=0, EvalTestFrequency=0)
    return dict(specs, **extra)


def _teacher(n=4):
    return (0.1 * np.random.default_rng(0).standard_normal((n, 16))).astype(np.float32)


def test_stage2_trainer_takes_k2d_once_per_step(dev, train_data, tmp_path):
    """The Stage-2 trainer with the flagship switches (frozen decoder) takes
    K2 variant d once per step, in bf16, and its metrics are finite."""
    from msd_tpu_torch.ops import fused_train as ft
    from msd_tpu_torch.train.stage2 import Stage2Trainer

    specs = _stage2_specs(train_data)
    tr = Stage2Trainer(str(tmp_path / "s2"), specs=specs, teacher_latents=_teacher(), device="cuda")
    assert tr.fused_ok and tr.k2_dtype == torch.bfloat16 and not tr.train_sdf_decoder
    launches = ft.LAUNCHES
    m = tr.train_epoch(1)
    assert ft.LAUNCHES == launches + 2  # 4 scenes, 2 per batch
    assert all(np.isfinite(v) for v in m.values())
    assert not any(p.grad is not None for p in tr.sdf_decoder.parameters())


def test_hpo_trial_takes_k2d_once_per_step(dev, train_data, tmp_path):
    """A search trial on the card on 8 ellipsoids, half held out (SAP needs
    4 holdout scenes), 2 epochs of 2 steps: K2 d launched once per step, a
    finite objective."""
    from chip_smoke import write_dataset
    from msd_tpu_torch import hparams_optuna_vae_sdf as hpo
    from msd_tpu_torch.ops import fused_train as ft

    split = write_dataset(str(tmp_path / "data8"), 8, 5000, seed=3)
    with open(tmp_path / "split8.json", "w") as f:
        json.dump(split, f)
    teacher = str(tmp_path / "teacher.pth")
    torch.save({"epoch": 1, "latent_codes": {"weight": torch.from_numpy(_teacher(8))}}, teacher)
    data = dict(train_data, DataSource=str(tmp_path / "data8" / "SdfSamples"), TrainSplit=str(tmp_path / "split8.json"))
    specs = _stage2_specs(data, TrainLatentHoldoutFraction=0.5, PretrainedLatentPath=teacher)
    ft.reset_launches()
    value, detail = hpo.run_trial(str(tmp_path / "trial"), specs, train_epochs=2)
    assert ft.VARIANT_LAUNCHES == dict.fromkeys("abcde", 0) | {"d": 4} and ft.LAUNCHES == 4
    assert np.isfinite(value) and all(np.isfinite(v) for v in detail.values())


def test_profiled_epoch_traces_k2_kernels(dev, train_data, tmp_path):
    """``ProfileEpochs`` on a K2 b epoch: one trace whose kernel events
    name K2's five CUDA kernels as often as ``KERNEL_LAUNCHES`` counted
    them in the epoch."""
    import glob

    from msd_tpu_torch.ops import fused_train as ft
    from msd_tpu_torch.train.stage1 import Stage1Trainer

    exp = str(tmp_path / "profiled")
    tr = Stage1Trainer(exp, specs=dict(train_data, NumEpochs=1, ProfileEpochs=[1]), device="cuda")
    ft.reset_launches()
    tr.train(num_epochs=1, eval_hooks=False)
    counted = dict(ft.KERNEL_LAUNCHES)
    (path,) = glob.glob(os.path.join(exp, "TensorBoard", "profile", "rank0.*.pt.trace.json"))
    with open(path) as f:
        kernels = [e["name"] for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    traced = {k: sum(k in name for name in kernels) for k in counted}
    assert traced == counted and counted["chain_kernel"] > 0 and counted["wgrad_kernel"] > 0


def test_stage2_points_mode_takes_k2d_once_per_step(dev, train_data, tmp_path):
    """Stage 2 with PointNet++ on the ellipsoids' surface clouds (their
    meshes from write_dataset): K2 d once per step in bf16, finite metrics,
    the BatchNorm statistics moved by training and fixed by the latent
    export, which gives equal bits twice."""
    from chip_smoke import write_labels
    from msd_tpu_torch.ops import fused_train as ft
    from msd_tpu_torch.train.stage2 import Stage2Trainer

    with open(os.path.join(ROOT, "examples", "ADNI", "MLP_VAE_SDF_disentangle_all_true_label_age", "specs.json")) as f:
        specs = json.load(f)
    for key in ("TestSplit", "PretrainedLatentPath", "PretrainedSDFDecoderPath", "EvalGTMeshDir"):
        specs.pop(key)
    with open(train_data["TrainSplit"]) as f:
        write_labels(train_data["DataSource"], json.load(f), seed=1)
    specs.update(DataSource=train_data["DataSource"], TrainSplit=train_data["TrainSplit"],
                 DataSourceMesh=os.path.join(os.path.dirname(train_data["DataSource"]), "Meshes"),
                 EncoderType="pointnet2", SurfacePointCount=1024, NetworkSpecs=TRAIN_SPECS["NetworkSpecs"],
                 CodeLength=16, VAEInputDim=16, SamplesPerScene=256, ScenesPerBatch=2,
                 TrainLatentHoldoutFraction=0.0, EvalTrainFrequency=0, EvalTestFrequency=0)
    teacher = (0.1 * np.random.default_rng(0).standard_normal((4, 16))).astype(np.float32)
    tr = Stage2Trainer(str(tmp_path / "s2p"), specs=specs, teacher_latents=teacher, device="cuda")
    assert tr.vae_input_mode == "points" and tr.fused_ok and tr.k2_dtype == torch.bfloat16
    stats = {k: v.clone() for k, v in tr.vae.state_dict().items() if "running_mean" in k and "fc_z" not in k}
    launches = ft.LAUNCHES
    m = tr.train_epoch(1)
    assert ft.LAUNCHES == launches + 2  # 4 scenes, 2 per batch
    assert all(np.isfinite(v) for v in m.values())
    moved = {k: v.clone() for k, v in tr.vae.state_dict().items() if k in stats}
    assert all(not torch.equal(stats[k], v) for k, v in moved.items())
    a, b = tr.compute_vae_latents(), tr.compute_vae_latents()
    assert np.array_equal(a, b) and np.isfinite(a).all()
    assert all(torch.equal(v, tr.vae.state_dict()[k]) for k, v in moved.items())


def _point_cloud(b, n, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((b, n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.tensor(d * rng.uniform(0.35, 0.7, (b, 1, 3)), dtype=torch.float32)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("enc", ["resnet_pointnet", "pointnet_encoder", "pointnet2"])
def test_point_encoder_on_card_matches_cpu(enc, train, dev):
    """The same encoder on the card and on the CPU, 4 clouds of 1024
    points: (mu, logvar) and, in training mode, the BatchNorm statistics,
    to 1e-4 of the largest entry (PointNet++ in training mode 1e-3: its
    float32 outputs sit 2.7e-5 from a float64 run on the CPU,
    tests/test_torch_pointnet.py). FPS picks the same points on both."""
    import copy

    from msd_tpu_torch.models import pointnet2
    from msd_tpu_torch.models.pointnet_vae import ENCODERS

    cpu = ENCODERS[enc][0](latent_size=16, kl_div_loss=True, generator=torch.Generator().manual_seed(3)).train(train)
    card = copy.deepcopy(cpu).to(dev)
    x = _point_cloud(4, 1024)
    kw = {}
    if enc == "pointnet2":
        starts = (torch.tensor([5, 900, 17, 333]), torch.tensor([0, 511, 100, 7]))
        kw = {"fps_start": starts}
        np.testing.assert_array_equal(pointnet2.farthest_point_sample(x.to(dev), 512, starts[0].to(dev)).cpu(),
                                      pointnet2.farthest_point_sample(x, 512, starts[0]))
    with torch.no_grad():
        ref = cpu(x, **kw)
        out = card(x.to(dev), **{k: tuple(t.to(dev) for t in v) for k, v in kw.items()})
    rtol = 1e-3 if enc == "pointnet2" and train else 1e-4
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.cpu().numpy(), r.numpy(), rtol=rtol, atol=rtol * float(r.abs().max()))
    for (k, a), (_, b) in zip(card.state_dict().items(), cpu.state_dict().items()):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=rtol, atol=rtol * float(b.abs().max()),
                                   err_msg=k)


# K2's two GEMM kernels on their own, each against a float32 torch product
# of the same bf16 operands on the card (TF32 off), at the main path's
# shapes: the flagship's padded widths 512 and 256 over a 65536-point chunk
# (K = 0 for the layer-0 and "last" launches), the toy protocol's 1536
# points at width 128, the gated rows of variant c (R = 4096 of P = 16384),
# ReLU and D masks, and column sums with no stored output. Every run is
# repeated and must give the same bits. name: (n, N, K, P, R, relu, xv,
# cvec, store, colsum)
CHAIN_CASES = {
    "primal_512x512": (65536, 512, 512, 16384, 0, True, False, True, True, False),
    "primal_latent_256_to_512": (65536, 512, 256, 16384, 0, True, True, True, True, False),
    "primal_first_K0": (65536, 512, 0, 16384, 0, True, True, True, True, False),
    "delta_512x512": (65536, 512, 512, 16384, 0, False, False, False, True, True),
    "delta_512_to_256": (65536, 256, 512, 16384, 0, False, False, False, True, True),
    "delta_last_K0": (65536, 512, 0, 16384, 0, False, True, False, True, True),
    "delta_0_colsum_only": (65536, 512, 512, 16384, 0, False, False, False, False, True),
    "u_gated": (16384, 512, 512, 16384, 4096, False, False, False, True, False),
    "u_last_gated_K0": (16384, 512, 0, 16384, 4096, False, True, False, True, False),
    "toy_primal": (1536, 128, 128, 384, 0, True, True, True, True, False),
    "toy_delta_gated": (512, 128, 128, 384, 128, False, False, False, True, True),
}
# name: (rows of the delta pair, rows of the gated pair, M, N)
WGRAD_CASES = {
    "b_512x512": (65536, 65536, 512, 512),
    "b_256x512": (65536, 65536, 256, 512),
    "b_512x256": (65536, 65536, 512, 256),
    "a_512x512": (65536, 0, 512, 512),
    "c_512x512": (65536, 16384, 512, 512),
    "toy_b": (1536, 1536, 128, 128),
}


def _ft_lib():
    from msd_tpu_torch.ops._build import load_library

    return load_library("fused_train")


def _ptr(t):
    return None if t is None else t.data_ptr()


def chain_case(name, dev, seed=11):
    """Inputs of CHAIN_CASES[name], the kernel's run (out, colsum) and the
    float32 reference (v before rounding, its 64-row column sums)."""
    n, N, K, P, R, relu, has_xv, has_cvec, store, want_cs = CHAIN_CASES[name]
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    A = torch.relu(torch.randn(n, K, generator=g, device=dev)).to(bf) if K else None
    B = (torch.randn(N, K, generator=g, device=dev) / max(K, 1) ** 0.5).to(bf) if K else None
    xv = wx = cvec = mask = None
    if has_xv:
        xv = torch.zeros(n, 4, device=dev)
        xv[:, :3] = torch.randn(n, 3, generator=g, device=dev).to(bf).float()
        wx = torch.zeros(N, 4, device=dev)
        wx[:, :3] = torch.randn(N, 3, generator=g, device=dev).to(bf).float()
    if has_cvec:
        cvec = 0.1 * torch.randn(n // P, N, generator=g, device=dev)
    rows = torch.arange(n, device=dev)
    if R:
        rows = rows // R * P + rows % R
    if not relu:
        mask = torch.randn((n // R * P if R else n), N, generator=g, device=dev).to(bf)

    v = A.float() @ B.float().t() if K else torch.zeros(n, N, device=dev)
    if has_xv:
        v = v + xv[:, :3] @ wx[:, :3].t()
    if has_cvec:
        v = v + cvec[torch.arange(n, device=dev) // P]
    v = torch.relu(v) if relu else v * (mask[rows].float() > 0)

    def run():
        out = torch.full((n, N), float("nan"), dtype=bf, device=dev) if store else None
        cs = torch.full((n // 64, N), float("nan"), device=dev) if want_cs else None
        lib = _ft_lib()
        rc = lib.msd_ft_chain(_ptr(A), _ptr(B), n, N, K, _ptr(xv), _ptr(wx), _ptr(cvec), P, R, int(relu),
                              _ptr(mask), _ptr(out), _ptr(cs), torch.cuda.current_stream(dev).cuda_stream)
        assert rc == 0, lib.msd_ft_error_string(rc).decode()
        torch.cuda.synchronize()
        return out, cs

    return run, v, (v.reshape(n // 64, 64, N).sum(1) if want_cs else None)


def chain_errors(out, cs, v, cs_ref):
    """Worst |out - v| over (2^-8 |v| + 1e-5 max |v|), the bf16 rounding's
    share of the error (at most 1/2 where only the rounding differs), and
    the column sums' worst error relative to their largest."""
    r = {}
    if out is not None:
        r["out"] = float(((out.float() - v).abs() / (2**-8 * v.abs() + 1e-5 * v.abs().max())).max())
    if cs is not None:
        r["colsum"] = float((cs - cs_ref).abs().max() / cs_ref.abs().max())
    return r


def wgrad_case(name, dev, seed=12, sms=None):
    """Inputs of WGRAD_CASES[name], the kernel's run (summed partials) and
    the float32 reference."""
    from msd_tpu_torch.ops.fused_train import wgrad_split

    n0, n1, M, N = WGRAD_CASES[name]
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    A0 = (torch.randn(n0, M, generator=g, device=dev) * 1e-3).to(bf)
    B0 = torch.relu(torch.randn(n0, N, generator=g, device=dev)).to(bf)
    A1 = (torch.randn(n1, M, generator=g, device=dev) * 1e-3).to(bf) if n1 else None
    B1 = torch.randn(n1, N, generator=g, device=dev).to(bf) if n1 else None
    ref = A0.float().t() @ B0.float()
    if n1:
        ref = ref + A1.float().t() @ B1.float()
    nsplit = wgrad_split(M, N, (n0 + n1) // 64, sms or torch.cuda.get_device_properties(dev).multi_processor_count)

    def run():
        part = torch.full((nsplit, M, N), float("nan"), device=dev)
        lib = _ft_lib()
        rc = lib.msd_ft_wgrad(_ptr(A0), _ptr(B0), n0, _ptr(A1), _ptr(B1), n1, M, N, nsplit, _ptr(part),
                              torch.cuda.current_stream(dev).cuda_stream)
        assert rc == 0, lib.msd_ft_error_string(rc).decode()
        torch.cuda.synchronize()
        return part

    return run, ref, nsplit


@pytest.mark.parametrize("name", list(CHAIN_CASES))
def test_chain_kernel_matches_float32(name, dev, monkeypatch):
    """chain_kernel against the float32 product: within the bf16 rounding
    of its output (half an ulp, plus summation order), column sums within
    1e-5 of the largest, and the same bits on a second run."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    run, v, cs_ref = chain_case(name, dev)
    out, cs = run()
    err = chain_errors(out, cs, v, cs_ref)
    assert err.get("out", 0.0) <= 1.0 and err.get("colsum", 0.0) <= 1e-5, err
    out2, cs2 = run()
    for a, b in ((out, out2), (cs, cs2)):
        assert a is None or torch.equal(a, b)


@pytest.mark.parametrize("name", list(WGRAD_CASES))
def test_wgrad_kernel_matches_float32(name, dev, monkeypatch):
    """wgrad_kernel's summed partials against the float32 product: 1e-5
    relative Frobenius and 1e-4 of the largest entry (float32 sums of
    131072 products in another order), the same bits on a second run."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    run, ref, nsplit = wgrad_case(name, dev)
    part = run()
    got = part.sum(0)
    assert torch.isfinite(part).all()
    assert float((got - ref).norm() / ref.norm()) <= 1e-5
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-4
    assert torch.equal(part, run())


# K2's two row streamers on their own, each against its plain version on the
# card, at the flagship chunk's shapes (65536 points, scenes of P = 16384):
# b's gated rows are every point, c's the first E = 4096 of each scene
# (stored compactly), a has no second pair. Every run is repeated and must
# give the same bits. skinny: name -> (W, rows of the gated pair)
SKINNY_KERNEL_CASES = {f"{v}_{w}": (w, ne) for w in (128, 512) for v, ne in (("b", 65536), ("c", 16384), ("a", 0))}
SK_N, SK_P = 65536, 16384


def skinny_case(name, dev, seed=13):
    """Inputs of SKINNY_KERNEL_CASES[name], the kernel's run (the
    accumulator after one launch from ``acc0``) and the plain version."""
    from msd_tpu_torch.ops.fused_train import skinny_plain

    W, ne = SKINNY_KERNEL_CASES[name]
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    A0 = torch.relu(torch.randn(SK_N, W, generator=g, device=dev)).to(bf)
    V0 = torch.zeros(SK_N, 4, device=dev)
    V0[:, :3] = torch.randn(SK_N, 3, generator=g, device=dev).to(bf).float()
    A1 = V1 = None
    if ne:
        A1 = (torch.randn(ne, W, generator=g, device=dev) * 1e-2).to(bf)
        V1 = torch.zeros(ne, 4, device=dev)
        V1[:, :3] = torch.randn(ne, 3, generator=g, device=dev).to(bf).float()
    acc0 = torch.randn(W, 4, generator=g, device=dev)
    acc0[:, 3] = 0.0
    ref = skinny_plain(A0, V0[:, :3], A1, None if V1 is None else V1[:, :3])

    def run(ticket):
        from msd_tpu_torch.ops.fused_train import skinny_cuda

        acc = acc0.clone()
        skinny_cuda(A0, V0, A1, V1, acc, ticket, torch.cuda.get_device_properties(dev).multi_processor_count,
                    _ft_lib(), torch.cuda.current_stream(dev).cuda_stream)
        torch.cuda.synchronize()
        return acc

    return run, acc0, ref


@pytest.mark.parametrize("name", list(SKINNY_KERNEL_CASES))
def test_skinny_kernel_matches_plain(name, dev, monkeypatch):
    """skinny_kernel adds skinny_plain into its accumulator in place: 1e-5
    relative Frobenius (float32 sums in two orders), column 3 untouched,
    the ticket left at zero for the next launch, and the same bits on a
    second run."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    run, acc0, ref = skinny_case(name, dev)
    ticket = torch.zeros(4, dtype=torch.int32, device=dev)
    acc = run(ticket)
    got = acc[:, :3] - acc0[:, :3]
    assert torch.isfinite(acc).all() and torch.equal(acc[:, 3], acc0[:, 3])
    assert float((got - ref).norm() / ref.norm()) <= 1e-5
    assert int(ticket.abs().sum()) == 0
    assert torch.equal(acc, run(ticket))


# eik: name -> (gated rows per scene E, with the latent_in layer's u, scene weights)
EIK_KERNEL_CASES = {
    f"{v}_{lat}_{wt}": (E, lat == "latent", wt == "weighted")
    for v, E in (("b", 16384), ("c", 4096)) for lat in ("latent", "no_latent") for wt in ("unweighted", "weighted")
}


def eik_case(name, dev, seed=14, W=512):
    """Inputs of EIK_KERNEL_CASES[name] over 4 scenes of P = 16384 points,
    the kernel's run (gb, sb, loss) and the plain version's (gbar, sbar,
    lane) of the gated rows, with those rows' points."""
    from msd_tpu_torch.ops.fused_train import eik_plain

    E, with_latent, weighted = EIK_KERNEL_CASES[name]
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    S, P = SK_N // SK_P, SK_P
    ne = S * E
    u0 = (0.05 * torch.randn(ne, W, generator=g, device=dev)).to(bf)
    mx0 = torch.zeros(W, 4, device=dev)
    mx0[:, :3] = (0.6 * torch.randn(W, 3, generator=g, device=dev)).to(bf).float()
    uL = mxL = None
    if with_latent:
        uL = (0.05 * torch.randn(ne, W, generator=g, device=dev)).to(bf)
        mxL = torch.zeros(W, 4, device=dev)
        mxL[:, :3] = (0.6 * torch.randn(W, 3, generator=g, device=dev)).to(bf).float()
    pt = torch.zeros(SK_N, 4, device=dev)  # (y, m tau, l1 seed, 0) of every point
    pt[:, 0] = 0.1 * torch.rand(SK_N, generator=g, device=dev) - 0.05
    pt[:, 2] = 1e-4 * torch.randn(SK_N, generator=g, device=dev)
    w = torch.tensor([1.0, 1.0, 0.0, 1.0], device=dev) if weighted else None
    eik_coef = 1e-3  # the eikonal term of sbar as large as the L1 seed
    rows = torch.arange(ne, device=dev)
    points = rows // E * P + rows % E
    ref = eik_plain(u0, mx0, uL, mxL, pt[points, 0], pt[points, 2], eik_coef, None if w is None else w[rows // E])

    def run():
        gb = torch.full((ne, 4), float("nan"), device=dev)
        sb = torch.full((SK_N, 4), float("nan"), device=dev)
        loss = torch.zeros(SK_N // 128, 4, device=dev)
        lib = _ft_lib()
        rc = lib.msd_ft_eik(_ptr(u0), _ptr(mx0), W, _ptr(uL), _ptr(mxL), W if with_latent else 0, _ptr(pt), _ptr(w),
                            ne, P, E, eik_coef, _ptr(gb), _ptr(sb), _ptr(loss), torch.cuda.current_stream(dev).cuda_stream)
        assert rc == 0, lib.msd_ft_error_string(rc).decode()
        torch.cuda.synchronize()
        return gb, sb, loss

    return run, ref, points


def _bf16_units(got, v):
    """Worst |got - v| over (2^-8 |v| + 1e-5 max |v|): half a bf16 ulp is at
    most 2^-8 |v|, so at most 1 where only the rounding of v differs; the
    1e-5 term covers the summation order of v's float32 sums."""
    return float(((got - v).abs() / (2**-8 * v.abs() + 1e-5 * v.abs().max())).max())


@pytest.mark.parametrize("name", list(EIK_KERNEL_CASES))
def test_eik_kernel_matches_plain(name, dev, monkeypatch):
    """eik_kernel against eik_plain: gb and sb within half a bf16 ulp plus
    the summation order of g, the per-128-point-tile eikonal and seed sums
    within 1e-5 relative (of their largest), written only on the gated
    points' tiles, and the same bits on a second run."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    run, (gbar, sbar, lane), points = eik_case(name, dev)
    gb, sb, loss = run()
    assert _bf16_units(gb[:, :3], gbar) <= 1.0 and bool((gb[:, 3] == 0).all())
    assert _bf16_units(sb[points, 0], sbar) <= 1.0 and bool((sb[points, 1:] == 0).all())
    tiles = points[::128] // 128
    for col, v in ((1, lane), (2, sbar)):
        ref = v.reshape(-1, 128).sum(1)
        assert float((loss[tiles, col] - ref).abs().max() / ref.abs().max()) <= 1e-5, col
    others = torch.ones(loss.shape[0], dtype=torch.bool, device=dev)
    others[tiles] = False
    assert bool((loss[others] == 0).all()) and bool((loss[:, [0, 3]] == 0).all())
    for a, b in zip((gb, sb, loss), run()):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())


# last_kernel on its own, against last_plain and last_rank1_plain on the
# card and against the K = 0 chain launch it replaces, at the flagship chunk
# (65536 points, scenes of P = 16384) with h 512 wide (one pass of a lane's
# vectors) and at width 128: b (every point gated), c (the first E = 4096
# of each scene), e (b with scene 2 weighted 0) and d (no gated rows: the
# delta rows and their column sums); and wider rows, which take several
# passes (1024) or a last pass part full (640). name -> (K, E, weighted)
LAST_KERNEL_CASES = {f"{v}_{K}": (K, E, v == "e") for K in (512, 128)
                     for v, E in (("b", 16384), ("c", 4096), ("e", 16384), ("d", 0))}
LAST_KERNEL_CASES.update({"b_1024": (1024, 16384, False), "d_1024": (1024, 0, False), "c_640": (640, 4096, False),
                          "d_640": (640, 0, False)})
# as chip_smoke.K2PT_TOL: float32 values within 1e-5 of their largest (two
# summation orders), bf16 values within 1 (_bf16_units: half an ulp)
LAST_TOL = {"rel_max": 1e-5, "bf16_units": 1.0}


def last_case(name, dev, seed=15):
    """Inputs of LAST_KERNEL_CASES[name] and the kernel's run: (pt, mtc,
    sb, loss, out, colsum), NaN where the launch writes nothing; ``run(rows=
    False)`` passes no rank-one rows, ``run(colsum=False)`` no column sums
    (None in the result)."""
    K, E, weighted = LAST_KERNEL_CASES[name]
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    n, P = SK_N, SK_P
    S, ne = n // P, n // P * E
    inp = {
        "h": torch.relu(torch.randn(n, K, generator=g, device=dev)).to(bf),
        "wl": (0.04 * torch.randn(K, generator=g, device=dev) / (K / 512) ** 0.5).to(bf),
        "clast": 0.05 * torch.randn(S, generator=g, device=dev),
        "gt": (0.25 * torch.randn(n, generator=g, device=dev)).clamp(-0.1, 0.1),
        "w": torch.tensor([1.0, 1.0, 0.0, 1.0], device=dev) if weighted else None,
    }

    def run(rows=True, colsum=True):
        nan = float("nan")
        pt, sb = torch.full((n, 4), nan, device=dev), torch.full((n, 4), nan, device=dev)
        mtc = torch.full((ne, 4), nan, device=dev) if E else None
        loss = torch.full((n // 128, 4), nan, device=dev)
        out = torch.full((ne if E else n, K), nan, dtype=bf, device=dev) if rows else None
        colsum = None if E or not colsum else torch.full((n // 64, K), nan, device=dev)
        lib = _ft_lib()
        rc = lib.msd_ft_last(_ptr(inp["h"]), _ptr(inp["wl"]), K, _ptr(inp["clast"]), _ptr(inp["gt"]), _ptr(inp["w"]),
                             n, P, E, 0.1, 1.0 / n, _ptr(pt), _ptr(mtc), _ptr(sb), _ptr(loss), _ptr(out), _ptr(colsum),
                             torch.cuda.current_stream(dev).cuda_stream)
        assert rc == 0, lib.msd_ft_error_string(rc).decode()
        torch.cuda.synchronize()
        return pt, mtc, sb, loss, out, colsum

    return inp, run


def _rel_max(got, ref):
    return float((got - ref).abs().max() / ref.abs().max().clamp(min=1e-30))


@pytest.mark.parametrize("name", list(LAST_KERNEL_CASES))
def test_last_kernel_matches_plain(name, dev, monkeypatch):
    """last_kernel against last_plain: y, m tau and the L1 seed within 1e-5
    of their largest, the per-128-point-tile L1 sums and (outside the gated
    rows) seed sums too, mtc of the gated rows and sb of the others within
    half a bf16 ulp; the rank-one rows equal last_rank1_plain's on the
    kernel's own xv, bit for bit, and their column sums within 1e-5; and
    the same bits on a second launch."""
    from msd_tpu_torch.ops.fused_train import last_plain, last_rank1_plain

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    K, E, _ = LAST_KERNEL_CASES[name]
    inp, run = last_case(name, dev)
    first = run()
    pt, mtc, sb, loss, out, colsum = first
    P = SK_P
    w_pt = None if inp["w"] is None else inp["w"].repeat_interleave(P)
    y, mt, seed, l1 = last_plain(inp["h"], inp["wl"], inp["clast"].repeat_interleave(P), inp["gt"], 0.1, 1.0 / SK_N,
                                 w_pt)
    for col, ref in ((0, y), (1, mt), (2, seed)):
        assert _rel_max(pt[:, col], ref) <= LAST_TOL["rel_max"], col
    assert bool((pt[:, 3] == 0).all())
    assert _rel_max(loss[:, 0], l1.reshape(-1, 128).sum(1)) <= LAST_TOL["rel_max"]
    gated = (torch.arange(SK_N, device=dev) % P) < E
    tiles = gated[::128]
    if E:
        assert _bf16_units(mtc[:, 0], mt[gated]) <= LAST_TOL["bf16_units"]
    if not bool(tiles.all()):
        assert _bf16_units(sb[~gated, 0], seed[~gated]) <= LAST_TOL["bf16_units"]
        assert _rel_max(loss[~tiles, 2], seed.reshape(-1, 128)[~tiles].sum(1)) <= LAST_TOL["rel_max"]
    # the rank-one rows: u of the gated rows from mtc, or delta of every row from sb
    ref_out, ref_cs = last_rank1_plain(inp["h"][gated], inp["wl"], mtc[:, 0]) if E else \
        last_rank1_plain(inp["h"], inp["wl"], sb[:, 0])
    assert torch.equal(out.float(), ref_out)
    if colsum is not None:
        assert _rel_max(colsum, ref_cs) <= LAST_TOL["rel_max"]
    for a, b in zip(first, run()):
        assert a is None or torch.equal(a.nan_to_num().view(torch.int8), b.nan_to_num().view(torch.int8))


@pytest.mark.parametrize("name", list(LAST_KERNEL_CASES))
def test_last_rank1_matches_chain(name, dev):
    """last_kernel's rank-one rows against the K = 0 chain_kernel launch
    they replace ("u last" over the gated rows, "delta last" without
    gated rows), on the kernel's own xv: the bf16 rows bit for bit (both
    compute one exact float32 product and round it; a masked or zero entry
    is +0 in both) and the delta rows' 64-row column sums within 1e-5
    relative (float32 sums in another order)."""
    K, E, _ = LAST_KERNEL_CASES[name]
    inp, run = last_case(name, dev)
    pt, mtc, sb, loss, out, colsum = run()
    P = SK_P
    rows = out.shape[0]
    wx = torch.zeros(K, 4, device=dev)
    wx[:, 0] = inp["wl"].float()
    xv = mtc if E else sb
    chain_out = torch.full_like(out, float("nan"))
    chain_cs = None if E else torch.full_like(colsum, float("nan"))
    lib = _ft_lib()
    rc = lib.msd_ft_chain(None, None, rows, K, 0, _ptr(xv), _ptr(wx), None, P, E if 0 < E < P else 0, 0,
                          _ptr(inp["h"]), _ptr(chain_out), _ptr(chain_cs), torch.cuda.current_stream(dev).cuda_stream)
    assert rc == 0, lib.msd_ft_error_string(rc).decode()
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int16), chain_out.view(torch.int16))
    if not E:
        assert float((colsum - chain_cs).norm() / chain_cs.norm()) <= 1e-5
        assert _rel_max(colsum, chain_cs) <= 1e-5


# name -> (LAST_KERNEL_CASES entry, column sums kept): d without the delta
# rows but with their sums is K2 d on a decoder of one hidden layer
LAST_NO_ROWS_CASES = {"b_512": ("b_512", False), "c_512": ("c_512", False), "d_512": ("d_512", False),
                      "d_512_colsum": ("d_512", True), "d_640_colsum": ("d_640", True)}


@pytest.mark.parametrize("name", list(LAST_NO_ROWS_CASES))
def test_last_kernel_without_rank1_rows(name, dev):
    """last_kernel launched without its rank-one rows (and, at d, with or
    without their column sums) writes every other output bit for bit as the
    launch with them."""
    case, keep_colsum = LAST_NO_ROWS_CASES[name]
    _, run = last_case(case, dev)
    full = run()
    part = run(rows=False, colsum=keep_colsum)
    assert part[4] is None and (part[5] is not None) == keep_colsum
    for a, b in zip(full, part):
        if a is not None and b is not None:
            assert torch.equal(a.nan_to_num().view(torch.int8), b.nan_to_num().view(torch.int8))


def _ellipsoid_mesh(n=48, axes=(0.45, 0.7, 0.35)):
    """A watertight ellipsoid from the port's marching tetrahedra."""
    from msd_tpu_torch.ops.marching_cubes import marching_tetrahedra

    x, y, z = np.meshgrid(*[np.linspace(-1, 1, n)] * 3, indexing="ij")
    field = np.sqrt((x / axes[0]) ** 2 + (y / axes[1]) ** 2 + (z / axes[2]) ** 2) - 1.0
    return marching_tetrahedra(field.astype(np.float32), spacing=(2 / (n - 1),) * 3)


def test_knn_tiled_route_on_card_matches_host(dev):
    """The vote's tiled route on the card against the host cKDTree route at
    65536 queries x 20000 surface points, within VOTE_AGREEMENT."""
    from msd_tpu_torch.preprocess import mesh_to_sdf as tm

    v, f = _ellipsoid_mesh()
    q, s, n, stdv, _, _ = tm.draw_queries(v, f, num_samples=65536, surface_vote_points=20000, seed=3)
    sdf_c, keep_c, st = tm._vote(q, s, n, 11, stdv, 8192, "cuda", None)
    sdf_h, keep_h, st_h = tm._vote(q, s, n, 11, stdv, 8192, "cpu", None)
    assert (st["route"], st_h["route"]) == ("tiled", "host")
    assert st["chunks"] == 8 and st["device_ms"] > 0 and 0 <= st["idle_share"] < 1 and st["peak_bytes"] > 0
    agree = tm.vote_agreement(sdf_c, keep_c, sdf_h, keep_h)
    assert agree["ok"], agree
    assert keep_c.mean() > 0.9


def test_preprocess_mesh_on_card_matches_cpu(dev):
    """preprocess_mesh with the vote on the card against device="cpu": the
    same queries (host draws), so the same rows where both keep, within
    VOTE_AGREEMENT."""
    from msd_tpu_torch.preprocess import mesh_to_sdf as tm

    v, f = _ellipsoid_mesh()
    kw = dict(num_samples=65536, surface_vote_points=20000, seed=5)
    pos_c, neg_c, info_c = tm.preprocess_mesh(v, f, knn_device="cuda", **kw)
    pos_h, neg_h, info_h = tm.preprocess_mesh(v, f, knn_device="cpu", **kw)
    assert info_c["vote"]["route"] == "tiled" and info_h["vote"]["route"] == "host"
    assert info_c["quality"] == info_h["quality"]
    rows_c, rows_h = np.concatenate([pos_c, neg_c]), np.concatenate([pos_h, neg_h])
    n = info_c["num_queries"]
    assert abs(len(rows_c) - len(rows_h)) <= (1 - tm.VOTE_AGREEMENT["keep"]) * n

    def keyed(rows):
        return {r[:3].tobytes(): r[3] for r in rows}

    kc, kh = keyed(rows_c), keyed(rows_h)
    both = kc.keys() & kh.keys()
    assert len(both) >= tm.VOTE_AGREEMENT["keep"] * min(len(kc), len(kh))
    a = np.array([kc[k] for k in both])
    b = np.array([kh[k] for k in both])
    assert np.mean(np.signbit(a) == np.signbit(b)) >= tm.VOTE_AGREEMENT["sign"]
    assert np.mean(np.abs(np.abs(a) - np.abs(b)) <= tm.VOTE_AGREEMENT["abs_sdf_tol"]) >= tm.VOTE_AGREEMENT["abs_sdf"]
