#!/usr/bin/env python3
"""On-card smoke test of msd_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py [--seed S]

Needs one NVIDIA GPU and the repository around it; without either it exits
non-zero and prints no result. Phases, one JSON line each:

1. device: the card's name and power limit (nvidia-smi).
2. build: nvcc builds every kernel source of the port, in parallel.
3. k1: the fused SDF-query kernel (csrc/fused_mlp.cu) against its plain
   PyTorch version at the flagship decoder's full width
   (examples/ADNI/minimal_eikonal/specs.json), in bf16 and float32, on two
   inputs whose last 64-point tile is ragged: 2^20 + 37 seeded points in
   [-1, 1]^3 (errors, sign agreement, times by CUDA events, FLOP bound) and
   the 65^3 corner lattice that create_mesh evaluates first at N=257.
4. serving: the port's main path as a user runs it. A seeded flagship
   checkpoint and two seeded ellipsoids (250k + 250k SdfSamples each, plus
   SurfaceSamples) are written to a temporary experiment; then
   ``python -m msd_tpu_torch.reconstruct`` (800 iterations x 8000 samples,
   mesh resolution 256, snapped to 257) and ``msd_tpu_torch.evaluate`` run
   in process. The weights are seeded, not trained, so the Chamfer is not a
   quality figure.

Then the ``kernels`` line, the card's ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failed phase raises and exits
non-zero.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(ROOT, "examples", "ADNI", "minimal_eikonal", "specs.json")
CSV_HEADER = "shape;chamfer_dist;90th_percentile;95th_percentile;normal_consistency"
# H100 SXM dense peaks (NVIDIA data sheet) and HBM rate
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
# K1 tolerances against the plain version: float32 differs by summation
# order only; two bf16 summation orders can flip an activation's last bit
# and the flip propagates. Measured on an H100 (see PERF.md): float32 max
# 4.2e-7; bf16 max 2.2e-3, mean 1.7e-5, sign agreement 0.999997. The limits
# keep a margin of at least 4x over those.
TOL = {"float32": {"max": 1e-5}, "bfloat16": {"max": 1e-2, "mean": 1e-4, "sign": 0.9999}}


def phase(tag, /, **kw):
    print(json.dumps({"phase": tag, **kw}), flush=True)


def ellipsoid_samples(axes, n, rng):
    """(pos [n, 4], neg [n, 4], surface [30000, 3]) of an ellipsoid with
    semi-axes ``axes``; SDF approximated by (|p / axes| - 1) * min(axes)."""
    axes = np.asarray(axes, np.float64)

    def sdf(p):
        return (np.linalg.norm(p / axes, axis=1) - 1.0) * axes.min()

    def surface(m):
        d = rng.standard_normal((m, 3))
        return d / np.linalg.norm(d, axis=1, keepdims=True) * axes

    s = surface(3 * n)
    near = np.concatenate([
        s[: 3 * n // 2] + rng.normal(0, math.sqrt(0.005), (3 * n // 2, 3)),
        s[3 * n // 2:] + rng.normal(0, math.sqrt(0.0005), (3 * n - 3 * n // 2, 3)),
        rng.uniform(-1, 1, (n // 5, 3)),
    ])
    rows = np.concatenate([near, sdf(near)[:, None]], axis=1).astype(np.float32)
    pos, neg = rows[rows[:, 3] > 0], rows[rows[:, 3] <= 0]
    if len(pos) < n or len(neg) < n:
        raise RuntimeError(f"ellipsoid {axes}: {len(pos)} pos / {len(neg)} neg < {n}")
    return pos[:n], neg[:n], surface(30000).astype(np.float32)


def write_dataset(data_dir, n_shapes, n_samples, seed):
    """SdfSamples/SurfaceSamples of ``n_shapes`` seeded ellipsoids under
    ``data_dir`` (dataset "smoke", class "ellipsoid"); returns the nested
    split."""
    from msd_tpu_torch.data.mesh_io import save_ply

    rng = np.random.default_rng(seed)
    names = [f"ellipsoid{i}" for i in range(n_shapes)]
    for name in names:
        pos, neg, surf = ellipsoid_samples(rng.uniform(0.35, 0.7, 3), n_samples, rng)
        for sub in ("SdfSamples", "SurfaceSamples"):
            os.makedirs(os.path.join(data_dir, sub, "smoke", "ellipsoid"), exist_ok=True)
        np.savez(os.path.join(data_dir, "SdfSamples", "smoke", "ellipsoid", name + ".npz"), pos=pos, neg=neg)
        save_ply(os.path.join(data_dir, "SurfaceSamples", "smoke", "ellipsoid", name + ".ply"), surf)
    return {"smoke": {"ellipsoid": names}}


def kernel_weights(decoder):
    """Weights K1 multiplies per point (the latent part is folded into
    per-layer constants outside the kernel)."""
    total = 0
    for layer, (in_dim, out_dim, _, _) in enumerate(decoder.layer_shapes):
        if layer == 0 or layer in decoder.latent_in:
            in_dim -= decoder.latent_size
        total += in_dim * out_dim
    return total


def time_ms(fn, reps=10, warmup=2):
    """Median milliseconds of ``fn`` on the current stream (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def k1_errors(spec, latent, xyz, tol, label):
    """Kernel against plain version on ``xyz``; raises past ``tol``."""
    import torch

    from msd_tpu_torch.ops.fused_mlp import fused_eval, fused_eval_plain

    out = fused_eval(spec, latent, xyz)
    torch.cuda.synchronize()
    ref = fused_eval_plain(spec, latent, xyz)
    err = (out - ref).abs()
    big = ref.abs() > 1e-3
    r = {
        "points": xyz.shape[0], "finite": bool(torch.isfinite(out).all()),
        "max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
        "sign_agreement": float(((out > 0) == (ref > 0))[big].float().mean()),
    }
    if not r["finite"] or r["max_abs_err"] > tol["max"]:
        raise AssertionError(f"K1 {label}: max abs err {r['max_abs_err']} > {tol['max']}")
    if "mean" in tol and (r["mean_abs_err"] > tol["mean"] or r["sign_agreement"] < tol["sign"]):
        raise AssertionError(f"K1 {label}: mean abs err {r['mean_abs_err']} or sign agreement {r['sign_agreement']}")
    return r


def check_k1(decoder, latent, n_points, seed, dev):
    """K1 against its plain version at the decoder's width, on ``n_points``
    uniform points (timed) and on the serving path's first corner lattice;
    returns the per-dtype results."""
    import torch

    from msd_tpu_torch import mesh
    from msd_tpu_torch.ops.fused_mlp import FusedDecoderSpec, fused_eval, fused_eval_plain

    g = torch.Generator(device=dev).manual_seed(seed)
    xyz = torch.rand(n_points, 3, generator=g, device=dev) * 2 - 1
    n_mesh = mesh._snap_n(256)
    corners = torch.as_tensor(mesh.corner_lattice(n_mesh, mesh.SPARSE_BLOCK), device=dev)
    flops = 2.0 * kernel_weights(decoder) * n_points
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        spec = FusedDecoderSpec(decoder, dtype)
        r = {"dtype": name, **k1_errors(spec, latent, xyz, TOL[name], f"{name} uniform")}
        r[f"corner_lattice_{n_mesh}"] = k1_errors(spec, latent, corners, TOL[name], f"{name} corner lattice")
        w_bytes = sum(t.numel() * t.element_size() for t in spec.wp + spec.wx if t is not None)
        bytes_moved = n_points * 16 + w_bytes
        t_flops = flops / PEAK_FLOPS[name] * 1e3
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        r.update({
            "ms": time_ms(lambda: fused_eval(spec, latent, xyz)),
            "plain_ms": time_ms(lambda: fused_eval_plain(spec, latent, xyz)),
            "bound_ms": max(t_flops, t_bytes), "bound_by": "operations" if t_flops >= t_bytes else "bytes",
            "flop": flops,
        })
        r["tflops"] = flops / (r["ms"] * 1e-3) / 1e12
        phase("k1", **r)
        results[name] = r
    return results


def serve(root, specs, decoder, seed):
    """The port's serving path on a temporary experiment; returns
    (per-shape summaries, evaluate results, seconds of evaluate, K1
    launches)."""
    from msd_tpu_torch import evaluate as evaluate_cli
    from msd_tpu_torch import reconstruct as reconstruct_cli
    from msd_tpu_torch.ops import fused_mlp
    from msd_tpu_torch.utils.checkpoint import save_model

    exp_dir, data_dir = os.path.join(root, "experiment"), os.path.join(root, "data")
    os.makedirs(exp_dir)
    with open(os.path.join(exp_dir, "specs.json"), "w") as f:
        json.dump(specs, f, indent=2)
    save_model(exp_dir, "latest.pth", decoder, 1)
    split = write_dataset(data_dir, 2, 250_000, seed)
    split_path = os.path.join(root, "smoke_test_split.json")
    with open(split_path, "w") as f:
        json.dump(split, f)
    common = ["-e", exp_dir, "-s", split_path, "--quiet"]

    fused_mlp.LAUNCHES = 0
    summary = reconstruct_cli.main(common + [
        "-c", "latest", "-d", os.path.join(data_dir, "SdfSamples"),
        "--iters", "800", "--mesh_resolution", "256", "--device", "cuda",
    ])
    t0 = time.time()
    results = evaluate_cli.main(common + ["-c", "1", "-d", data_dir])
    t_eval = time.time() - t0
    launches = fused_mlp.LAUNCHES

    for s in summary:
        base = os.path.join(exp_dir, "Reconstructions", "1")
        for path in (os.path.join(base, "Meshes", s["shape"] + ".ply"),
                     os.path.join(base, "Codes", s["shape"] + ".pth")):
            if not os.path.isfile(path):
                raise AssertionError(f"missing output {path}")
        if not s["loss_last_tenth"] < s["loss_first_tenth"]:
            raise AssertionError(f"{s['shape']}: reconstruction loss did not fall: {s}")
        if s["k1_launches"] <= 0 or s["faces"] <= 0:
            raise AssertionError(f"{s['shape']}: no K1 launch or empty mesh: {s}")
    csv = os.path.join(exp_dir, "Evaluation", "1", "chamfer.csv")
    with open(csv) as f:
        lines = f.read().splitlines()
    if lines[0] != CSV_HEADER or len(lines) != 1 + len(summary):
        raise AssertionError(f"bad CSV {csv}: {lines[:3]}")
    if not all(math.isfinite(r[1][0]) for r in results):
        raise AssertionError(f"non-finite Chamfer: {results}")
    return summary, results, t_eval, launches


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU")
    from msd_tpu_torch.device import resolve_device
    from msd_tpu_torch.models import build_decoder
    from msd_tpu_torch.models.deepsdf import give_surface_
    from msd_tpu_torch.ops import _build

    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    phase("device", name=kind, nvidia_smi=smi, count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.time()
    _build.build(_build.KERNEL_SOURCES)
    ptxas = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
             for n, log in _build.BUILD_LOGS.items()}
    phase("build", seconds=time.time() - t0, sources=list(_build.KERNEL_SOURCES), ptxas=ptxas)

    with open(FLAGSHIP) as f:
        specs = json.load(f)
    g = torch.Generator().manual_seed(args.seed)
    decoder = build_decoder(specs["NetworkArch"], specs["CodeLength"], specs["NetworkSpecs"], generator=g)
    decoder = decoder.to(dev).eval()
    shift = give_surface_(decoder, torch.zeros(specs["CodeLength"]))
    phase("decoder", source=os.path.relpath(FLAGSHIP, ROOT), weights="seeded, not trained",
          seed=args.seed, parameters=sum(t.numel() for t in decoder.parameters()),
          kernel_weights=kernel_weights(decoder), bias_shift=shift)
    latent = 0.01 * torch.randn(specs["CodeLength"], generator=g).to(dev)
    k1 = check_k1(decoder, latent, 2**20 + 37, args.seed, dev)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=ROOT) as root:
        t0 = time.time()
        summary, results, t_eval, launches = serve(root, specs, decoder, args.seed)
        t_total = time.time() - t0
    for s in summary:
        phase("serving_shape", **s)
    phase("serving", seconds=t_total, evaluate_seconds=t_eval, k1_launches=launches,
          chamfer={r[0]: r[1][0] for r in results},
          note="seeded weights, not trained: the Chamfer is no quality figure")

    bf16 = k1["bfloat16"]

    def worst(r):  # max abs error over both K1 inputs
        return max(r["max_abs_err"], r["corner_lattice_257"]["max_abs_err"])

    print(json.dumps({"kernels": [{
        "name": "fused_mlp", "route": "cuda", "source": "msd_tpu_torch/csrc/fused_mlp.cu",
        "replaces": "msd_tpu/ops/fused_mlp.py:211", "launches": launches,
        "max_abs_err": worst(bf16), "ms": bf16["ms"], "plain_ms": bf16["plain_ms"],
        "bound_ms": bf16["bound_ms"], "bound_by": bf16["bound_by"], "library_ms": None,
        "library_note": "no single PyTorch call computes the whole decoder",
        "dtype": "bfloat16", "points": bf16["points"],
        "float32": {"max_abs_err": worst(k1["float32"]),
                    **{k: k1["float32"][k] for k in ("ms", "plain_ms", "bound_ms")}},
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
