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
5. k2: the Stage-1 fused loss-and-gradient kernels (csrc/fused_train.cu),
   variants b (eikonal) and a, at the flagship width in bf16: against float32
   autograd and their plain PyTorch version on 4 seeded scenes x 16384
   points, then against the plain version at the full step shape, 32 x
   16384 points (8 chunks of the kernels' scratch), where both are timed
   (CUDA events) beside the operation bound and the design's byte bound.
   Errors: loss sums, and per layer dMp, dMx, db and dlat, relative
   Frobenius error and cosine similarity.
6. training: the port's Stage-1 path as a user runs it. The flagship
   specs.json with its DataSource, splits, NumEpochs (6), SnapshotFrequency
   (3) and AdditionalSnapshots ([]) changed, on 64 seeded ellipsoids
   (100k + 100k SdfSamples each); ``python -m msd_tpu_torch.train_deep_sdf
   --device cuda`` runs in process for 12 steps, then ``-c latest`` with
   NumEpochs 8 for 4 more. Then step times, K2's share of the step, a
   torch.profiler split of the step's device time by kernel with the
   device's idle share, the point sampler's time at chunk 128 and 1, and
   the trainer's step on K2 a and on its float32 autograd path.
7. k2d: K2's frozen-decoder variant d (loss and latent gradient only, the
   Stage-2 step's kernel) against its plain version and float32 autograd on
   4 seeded scenes x 16384 points, and against its plain version at the
   Stage-2 step shape, 32 x 16384 points, where both are timed beside the
   operation bound and the design's byte bound. Errors: loss sum relative,
   dlat relative Frobenius and cosine.
8. stage2: the port's Stage-2 path as a user runs it, on top of the
   training phase's Stage-1 experiment (64 ellipsoids, flagship width).
   ``labels.pt`` gets a 0/1 diagnosis from each ellipsoid's axis ratio and
   a seeded age; the flagship Stage-2 specs.json
   (examples/ADNI/MLP_VAE_SDF_disentangle_all_true_label_age) with its
   paths, NumEpochs (40), SnapshotFrequency (20), EvalTrainFrequency (40)
   and GT mesh dir changed; ``python -m msd_tpu_torch.train_MLP_VAE_deep_sdf
   --device cuda`` runs in process for 40 steps (58 training scenes, one
   batch of 32 per epoch) with one eval epoch (run_eval, SAP, Locatello SAP,
   correlation, the tables, 2 meshes at N=257 through K1 and their Chamfer
   where a mesh has a surface: the 16-step Stage-1 decoder of phase 6 may
   give a field with none), then ``-c latest`` with NumEpochs 42. Then
   the step's time, K2 d's share and launches per step, a torch.profiler
   split, and the trainer's step on K2 d against its float32 autograd path
   (loss and VAE gradient).

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


def write_labels(data_source, split, seed):
    """``labels.pt`` under ``data_source`` for the shapes of ``split``:
    (diagnosis, age) per shape. The diagnosis is 1 where the ellipsoid's
    axis ratio (estimated from its inside samples) is above the median; the
    age is 55-90, rising with the volume, plus seeded noise. Returns the
    label map."""
    import torch

    from msd_tpu_torch.data.splits import get_instance_filenames, split_instance_ids

    ratios, volumes = [], []
    for path in get_instance_filenames(data_source, split):
        inside = np.load(path)["neg"][:, :3]
        axes = np.abs(inside).max(axis=0)
        ratios.append(axes.max() / axes.min())
        volumes.append(np.prod(axes))
    ratios, volumes = np.asarray(ratios), np.asarray(volumes)
    rng = np.random.default_rng(seed)
    age = 55 + 35 * (volumes - volumes.min()) / max(np.ptp(volumes), 1e-12) + rng.normal(0, 2, len(volumes))
    diagnosis = (ratios > np.median(ratios)).astype(np.float32)
    labels = {iid: torch.tensor([d, a], dtype=torch.float32)
              for iid, d, a in zip(split_instance_ids(split), diagnosis, age)}
    torch.save(labels, os.path.join(data_source, "labels.pt"))
    return labels


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


# K2 tolerances against its plain version (bf16, two summation orders that
# can flip a bf16 rounding): loss sums relative, every gradient relative
# Frobenius. Against float32 autograd on the same inputs (the rounding of
# h, u, t and delta to bf16 at every layer): loss sums relative, the worst
# gradient's relative Frobenius error and its cosine similarity. Measured
# at the flagship width on an H100 (PERF.md): 3.5e-5 and 5.6e-3 against
# plain on 4 scenes, 3.3e-7 and 5.2e-3 on 32; 5.4e-4, 4.1e-2 and 0.99917
# against autograd. The limits keep a margin of at least 3x over those
# (1 - cos: 10x).
K2_TOL = {"loss": 1e-3, "grad": 2e-2, "autograd_loss": 5e-3, "autograd_grad": 0.15, "autograd_cos": 0.99}


def k2_inputs(decoder, B, P, seed, dev):
    """(weights, biases, latents [B, L], xyz [B, P, 3], gt [B, P]), seeded."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    n = decoder.num_layers - 1
    weights = [decoder.layer_weight(layer).detach() for layer in range(n)]
    biases = [getattr(decoder, f"lin{layer}").bias.detach() for layer in range(n)]
    lat = 0.01 * torch.randn(B, decoder.latent_size, generator=g, device=dev)
    xyz = torch.rand(B, P, 3, generator=g, device=dev) * 2 - 1
    gt = 0.25 * torch.randn(B, P, generator=g, device=dev)
    return weights, biases, lat, xyz, gt


def autograd_grads(decoder, weights, biases, lat, xyz, gt, clamp, use_eikonal, num_total):
    """(dweights, dbiases, dlat, sdf, eikonal) of the Stage-1 point losses
    by float32 autograd, written out as the trainer's autograd path computes
    them: the float32 oracle K2 is held against."""
    import torch

    from msd_tpu_torch.losses.sdf import eikonal_loss

    decoder.zero_grad()
    z = lat.clone().requires_grad_(True)
    P = xyz.shape[1]
    x = xyz.reshape(-1, 3).clone().requires_grad_(use_eikonal)
    pred = decoder(torch.cat([z.repeat_interleave(P, 0), x], 1)).clamp(-clamp, clamp)
    sdf = (pred[:, 0] - gt.reshape(-1).clamp(-clamp, clamp)).abs().sum() / num_total
    eik = torch.zeros((), device=xyz.device)
    if use_eikonal:
        (gx,) = torch.autograd.grad(pred.sum(), x, create_graph=True)
        eik = eikonal_loss(gx)
    (sdf + eik).backward()
    lins = [getattr(decoder, f"lin{layer}") for layer in range(decoder.num_layers - 1)]
    # plain Linear layers (the flagship has no active weight norm)
    return [lin.weight.grad for lin in lins], [lin.bias.grad for lin in lins], z.grad, sdf.detach(), eik.detach()


def _cmp(a, b):
    """Relative Frobenius error, cosine similarity and max abs error of ``a``
    against ``b``."""
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    return {"rel": float((a - b).norm() / b.norm().clamp(min=1e-300)),
            "cos": float(a @ b / (a.norm() * b.norm()).clamp(min=1e-300)),
            "max_abs_err": float((a - b).abs().max())}


def k2_errors(decoder, out, ref):
    """Relative errors of K2's outputs ``out`` against ``ref`` (both as
    fused_point_grads returns them): loss sums, and per layer dMp, dMx, db,
    plus dlat, as relative Frobenius error and cosine similarity."""
    from msd_tpu_torch.ops.fused_train import layer_plan

    plan = layer_plan(decoder)
    layers = []
    for layer in range(plan.nl):
        w, r = out[0][layer], ref[0][layer]
        prev, L = plan.prev[layer], plan.L
        e = {"layer": layer, "db": _cmp(out[1][layer], ref[1][layer])}
        if plan.kinds[layer] != "first":
            e["dMp"] = _cmp(w[:, :prev], r[:, :prev])
        if plan.kinds[layer] == "first":
            e["dMx"] = _cmp(w[:, L:L + 3], r[:, L:L + 3])
        elif plan.kinds[layer] == "latent":
            e["dMx"] = _cmp(w[:, prev + L:], r[:, prev + L:])
        layers.append(e)
    worst = max(v["rel"] for e in layers for k, v in e.items() if k != "layer")
    min_cos = min(v["cos"] for e in layers for k, v in e.items() if k != "layer")
    dlat = _cmp(out[2], ref[2])
    loss = {k: abs(float(out[i]) - float(ref[i])) / max(abs(float(ref[i])), 1e-30)
            for i, k in ((3, "sdf"), (4, "eikonal"))}
    max_abs = max(float((a - b).abs().max()) for a, b in zip(out[0] + out[1], ref[0] + ref[1]))
    return {"loss_rel": loss, "dlat": dlat, "worst_grad_rel": max(worst, dlat["rel"]),
            "min_grad_cos": min(min_cos, dlat["cos"]),
            "max_abs_err": max(max_abs, float((out[2] - ref[2]).abs().max())), "layers": layers}


# Sweeps over the decoder's per-point weights of each K2 variant: b runs the
# primal, u-chain, ubar/t chain, delta chain and two weight-gradient sums;
# a the primal, delta chain and weight gradients; d the primal and delta
# chain only.
K2_SWEEPS = {"b": 6, "a": 3, "d": 2}


def step_flops(decoder, n_points, variant):
    """Floating-point operations of K2 ``variant`` ("b", "a" or "d") on
    ``n_points``: 2 per multiply-add of the per-point products (the
    latent's share is per scene and not counted): 18.9, 9.44 and 6.29
    MFLOP per point at the flagship width."""
    from msd_tpu_torch.ops.fused_train import layer_plan

    plan = layer_plan(decoder)
    per_point = 0
    for layer in range(plan.nl):
        k = (plan.prev[layer] or 0) + (3 if plan.kinds[layer] != "plain" else 0)
        per_point += k * plan.out[layer]
    return 2.0 * per_point * n_points * K2_SWEEPS[variant]


def design_bytes(decoder, n_points, variant):
    """Bytes K2's design moves through device memory for ``n_points``
    (activations only; weights and per-scene terms are small): each bf16
    chain activation, its width padded to WIDTH_PAD, is written once and
    read by the next product, the masks and the weight gradients."""
    from msd_tpu_torch.ops.fused_train import WIDTH_PAD, layer_plan

    plan = layer_plan(decoder)
    widths = [-(-o // WIDTH_PAD) * WIDTH_PAD * 2 for o in plan.out[:-1]]
    hidden = sum(widths)
    if variant == "b":
        # h: 1 write + 5 reads (next product, u mask, t mask, delta mask,
        # wgrad); u, t, delta: 1 write + 2 reads each
        per_point = hidden * (6 + 3 * 3)
    elif variant == "a":
        # h: 1 write + 3 reads; delta: 1 write + 2 reads
        per_point = hidden * (4 + 3)
    else:
        # h: 1 write + 2 reads (next product, delta mask); delta: 1 write +
        # 1 read, except the layer-0 delta, which is not stored
        per_point = hidden * 3 + (hidden - widths[0]) * 2
    return float(per_point + 64) * n_points


def k2_check_plain(decoder, out, ref, name, shape):
    """K2's outputs against its plain version's; raises past K2_TOL."""
    import torch

    r = k2_errors(decoder, out, ref)
    if (max(r["loss_rel"].values()) > K2_TOL["loss"] or r["worst_grad_rel"] > K2_TOL["grad"]
            or not all(torch.isfinite(t).all() for t in out[0] + out[1])):
        raise AssertionError(f"K2 {name} vs plain at {shape}: {json.dumps(r)}")
    return r


def check_k2(decoder, seed, dev):
    """K2 against float32 autograd (and its plain version) on 4 scenes, and
    against its plain version at the full step shape, 32 x 16384 points,
    where it is also timed; returns per-variant results."""
    import torch

    from msd_tpu_torch.ops.fused_train import fused_point_grads, fused_train_plain, point_grads

    results = {}
    P = 16384
    for use_eik in (True, False):
        name = "b" if use_eik else "a"
        B = 4
        args = (decoder, *k2_inputs(decoder, B, P, seed, dev), 0.1, use_eik, B * P)
        out = fused_point_grads(*args)
        torch.cuda.synchronize()
        vs_plain_4 = k2_check_plain(decoder, out, point_grads(fused_train_plain, *args), name, "4 x 16384")
        vs_autograd = k2_errors(decoder, out, autograd_grads(*args))
        if (max(vs_autograd["loss_rel"].values()) > K2_TOL["autograd_loss"]
                or vs_autograd["worst_grad_rel"] > K2_TOL["autograd_grad"]
                or vs_autograd["min_grad_cos"] < K2_TOL["autograd_cos"]):
            raise AssertionError(f"K2 {name} vs float32 autograd: {json.dumps(vs_autograd)}")
        del out

        B = 32
        full = (decoder, *k2_inputs(decoder, B, P, seed + 1, dev), 0.1, use_eik, B * P)
        out = fused_point_grads(*full)
        torch.cuda.synchronize()
        vs_plain = k2_check_plain(decoder, out, point_grads(fused_train_plain, *full), name, "32 x 16384")
        del out
        flops = step_flops(decoder, B * P, name)
        r = {"variant": name, "points": B * P, "vs_plain": vs_plain,
             "vs_plain_4_scenes": {k: vs_plain_4[k] for k in ("loss_rel", "worst_grad_rel", "max_abs_err")},
             "vs_autograd_4_scenes": {k: vs_autograd[k]
                                      for k in ("loss_rel", "dlat", "worst_grad_rel", "min_grad_cos")},
             "ms": time_ms(lambda: fused_point_grads(*full)),
             "plain_ms": time_ms(lambda: point_grads(fused_train_plain, *full)),
             "flop": flops, "bound_ms": flops / PEAK_FLOPS["bfloat16"] * 1e3, "bound_by": "operations",
             "design_bytes": design_bytes(decoder, B * P, name),
             "design_bytes_ms": design_bytes(decoder, B * P, name) / HBM_BYTES_PER_S * 1e3,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        r["tflops"] = flops / (r["ms"] * 1e-3) / 1e12
        phase("k2", **r)
        results[name] = r
    return results


# K2 d against its plain version at the step shape (acceptance limits: loss
# sum 1e-5 relative, one float32 sum of the same per-point values in two
# orders; dlat 1e-2 relative Frobenius, two bf16 summation orders) and against
# float32 autograd on 4 scenes (bf16 rounding at every layer).
K2D_TOL = {"loss": 1e-5, "dlat": 1e-2, "autograd_loss": 5e-3, "autograd_dlat": 0.15, "autograd_cos": 0.99}


def check_k2d(decoder, seed, dev):
    """K2 variant d (want_wgrad=False) against float32 autograd and its
    plain version on 4 scenes, and against its plain version at the Stage-2
    step shape, 32 x 16384 points, where both are timed."""
    import torch

    from msd_tpu_torch.ops.fused_train import fused_point_grads, fused_train_plain, point_grads

    def errors(out, ref):
        return {"loss_rel": abs(float(out[3]) - float(ref[3])) / abs(float(ref[3])), "dlat": _cmp(out[2], ref[2])}

    P = 16384
    args = (decoder, *k2_inputs(decoder, 4, P, seed + 2, dev), 0.1, False, 4 * P)
    out = fused_point_grads(*args, want_wgrad=False)
    torch.cuda.synchronize()
    if out[0] is not None or out[1] is not None:
        raise AssertionError("K2 d returned weight gradients")
    vs_plain_4 = errors(out, point_grads(fused_train_plain, *args, want_wgrad=False))
    vs_autograd = errors(out, autograd_grads(*args))
    if (vs_plain_4["loss_rel"] > K2D_TOL["loss"] or vs_plain_4["dlat"]["rel"] > K2D_TOL["dlat"]
            or vs_autograd["loss_rel"] > K2D_TOL["autograd_loss"] or vs_autograd["dlat"]["rel"] > K2D_TOL["autograd_dlat"]
            or vs_autograd["dlat"]["cos"] < K2D_TOL["autograd_cos"]):
        raise AssertionError(f"K2 d at 4 x 16384: {json.dumps({'plain': vs_plain_4, 'autograd': vs_autograd})}")

    B = 32
    full = (decoder, *k2_inputs(decoder, B, P, seed + 3, dev), 0.1, False, B * P)
    out = fused_point_grads(*full, want_wgrad=False)
    torch.cuda.synchronize()
    vs_plain = errors(out, point_grads(fused_train_plain, *full, want_wgrad=False))
    if (vs_plain["loss_rel"] > K2D_TOL["loss"] or vs_plain["dlat"]["rel"] > K2D_TOL["dlat"]
            or not torch.isfinite(out[2]).all()):
        raise AssertionError(f"K2 d at 32 x 16384: {json.dumps(vs_plain)}")
    flops = step_flops(decoder, B * P, "d")
    # xyz and gt read once, the per-point weights once (bf16); the per-scene
    # outputs are small
    io_bytes = B * P * 16.0 + 2.0 * kernel_weights(decoder)
    t_flops, t_bytes = flops / PEAK_FLOPS["bfloat16"] * 1e3, io_bytes / HBM_BYTES_PER_S * 1e3
    r = {"variant": "d", "points": B * P, "vs_plain": vs_plain, "vs_plain_4_scenes": vs_plain_4,
         "vs_autograd_4_scenes": vs_autograd,
         "ms": time_ms(lambda: fused_point_grads(*full, want_wgrad=False)),
         "plain_ms": time_ms(lambda: point_grads(fused_train_plain, *full, want_wgrad=False)),
         "flop": flops, "bound_ms": max(t_flops, t_bytes), "bound_by": "operations" if t_flops >= t_bytes else "bytes",
         "design_bytes": design_bytes(decoder, B * P, "d"),
         "design_bytes_ms": design_bytes(decoder, B * P, "d") / HBM_BYTES_PER_S * 1e3,
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    r["tflops"] = flops / (r["ms"] * 1e-3) / 1e12
    phase("k2d", **r)
    return r


def profile_steps(step, n):
    """Device time by kernel over ``n`` steps (torch.profiler, CUPTI) and
    the device's idle share of their wall time; K2's five CUDA kernels by
    name, everything else summed."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_name = {}
    kernels = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        kernels += e.count
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        name = next((k for k in ("chain_kernel", "wgrad_kernel", "last_kernel", "eik_kernel", "skinny_kernel")
                     if k in e.key), "other")
        by_name[name] = by_name.get(name, 0.0) + us / 1e3 / n
    device_ms = sum(by_name.values())
    if device_ms == 0:
        return {"note": "the profiler recorded no device time: not measured"}
    return {"ms_per_step_by_kernel": by_name, "device_ms_per_step": device_ms, "device_ops_per_step": kernels / n,
            "wall_ms_per_step": wall_ms / n, "device_idle_share": 1 - device_ms / (wall_ms / n)}


def train(root, specs, seed):
    """The port's Stage-1 path on a temporary experiment; returns the phase
    summary and K2's launches in the two runs."""
    import torch

    import msd_tpu_torch.workspace as ws
    from msd_tpu_torch import train_deep_sdf
    from msd_tpu_torch.data.sdf_samples import sample_sdf_batch
    from msd_tpu_torch.models import build_decoder
    from msd_tpu_torch.ops import fused_train
    from msd_tpu_torch.ops.fused_train import fused_sdf_loss
    from msd_tpu_torch.utils.checkpoint import load_model

    t0 = time.time()
    data_dir, exp = os.path.join(root, "train_data"), os.path.join(root, "train_experiment")
    split = write_dataset(data_dir, 64, 100_000, seed + 1)
    split_path = os.path.join(root, "train_split.json")
    with open(split_path, "w") as f:
        json.dump(split, f)
    changes = {"DataSource": os.path.join(data_dir, "SdfSamples"), "TrainSplit": split_path,
               "TestSplit": split_path, "NumEpochs": 6, "SnapshotFrequency": 3, "AdditionalSnapshots": []}
    ws.save_experiment_specifications(exp, dict(specs, **changes))
    t_data = time.time() - t0

    fused_train.LAUNCHES = 0
    t0 = time.time()
    trainer = train_deep_sdf.main(["-e", exp, "--device", "cuda", "--quiet"])
    torch.cuda.synchronize()
    t_first = time.time() - t0
    launches_first = fused_train.LAUNCHES
    ws.save_experiment_specifications(exp, dict(specs, **dict(changes, NumEpochs=8)))
    fused_train.LAUNCHES = 0
    resumed = train_deep_sdf.main(["-e", exp, "-c", "latest", "--device", "cuda", "--quiet"])
    torch.cuda.synchronize()
    launches_resumed = fused_train.LAUNCHES

    if not trainer.use_fused or launches_first != 12 or launches_resumed != 4:
        raise AssertionError(f"K2 launches {launches_first} + {launches_resumed}, want 12 + 4 (one per step)")
    losses = resumed.loss_log
    if len(losses) != 16 or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"bad loss log: {losses}")
    epoch_means = resumed.loss_log_epoch
    if not epoch_means[-1] < epoch_means[0]:
        raise AssertionError(f"loss did not fall: {epoch_means}")
    if resumed.start_epoch != 7 or resumed.epoch != 8 or resumed.global_batch_idx != 16:
        raise AssertionError(f"resumed run went from epoch {resumed.start_epoch} to {resumed.epoch}, "
                             f"step {resumed.global_batch_idx}; want 7 to 8, step 16")
    for sub in (ws.model_params_subdir, ws.optimizer_params_subdir, ws.latent_codes_subdir):
        for name in ("3.pth", "6.pth", "latest.pth"):
            if not os.path.isfile(os.path.join(exp, sub, name)):
                raise AssertionError(f"missing checkpoint {sub}/{name}")
    if not os.path.isfile(ws.get_logs_filename(exp)):
        raise AssertionError("missing Logs.pth")
    dec = build_decoder(specs["NetworkArch"], specs["CodeLength"], specs["NetworkSpecs"])
    if load_model(exp, "latest", dec) != 8:
        raise AssertionError("load_model read the wrong epoch")
    for (n, a), (_, b) in zip(dec.state_dict().items(), resumed.decoder.state_dict().items()):
        if not torch.equal(a, b.cpu()):
            raise AssertionError(f"load_model: {n} differs from the trained decoder")

    # step times on the trained state (host clock around synchronised steps)
    dev = resumed.device
    B, P = resumed.scene_per_batch, resumed.num_samp_per_scene
    pos, pc, neg, nc = resumed.dataset.device_arrays(dev)
    idx = torch.arange(B, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch = sample_sdf_batch(pos, pc, neg, nc, idx, P, gen)
    step_ms = []
    for _ in range(11):
        torch.cuda.synchronize()
        t = time.perf_counter()
        resumed.step(idx, batch, 9, 5e-4, 1e-3)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    step_med = float(np.median(step_ms[1:]))

    def k2_call():
        with torch.no_grad():
            fused_sdf_loss(resumed.decoder, resumed.latents[idx], batch[:3].permute(1, 2, 0).contiguous(),
                           batch[3], resumed.clamp_dist, resumed.use_eikonal, B * P)

    k2_ms = time_ms(k2_call)
    profile = profile_steps(lambda: resumed.step(idx, batch, 9, 5e-4, 1e-3), 3)
    sampler = {f"chunk_{c}_ms": time_ms(lambda c=c: sample_sdf_batch(pos, pc, neg, nc, idx, P, gen, chunk=c))
               for c in (128, 1)}

    def step_time(fused, eikonal, batch_split):  # CUDA events; the trainer's path switched as its specs would
        resumed.use_fused, resumed.use_eikonal = fused, eikonal
        return time_ms(lambda: resumed.step(idx, batch, 9, 5e-4, 1e-3, batch_split), reps=5, warmup=1)

    # K2 a, and the trainer's float32 autograd path (UseFusedTrainKernel
    # false) for b and a; the latter in 4 chunks of 8 scenes (batch_split 4)
    # to bound its graph's memory
    steps_by_path = {"k2_a": step_time(True, False, 1), "autograd_b": step_time(False, True, 4),
                     "autograd_a": step_time(False, False, 4)}
    resumed.use_fused, resumed.use_eikonal = True, True
    return {
        "changed": changes | {"NumEpochs (resume)": 8}, "scenes": resumed.num_scenes, "steps": len(losses),
        "data_seconds": t_data, "first_run_seconds": t_first, "epoch_seconds": resumed.timing_log,
        "epoch_losses": epoch_means,
        "resumed_from_epoch": resumed.start_epoch,
        "step_ms_median": step_med, "step_ms": step_ms, "step_ms_by_path": steps_by_path,
        "scenes_per_s": B / (step_med * 1e-3), "points_per_s": B * P / (step_med * 1e-3),
        "k2_ms_in_step": k2_ms, "k2_share_of_step": k2_ms / step_med, "sampler": sampler,
        "profile": profile,
    }, launches_first + launches_resumed


FLAGSHIP_STAGE2 = os.path.join(ROOT, "examples", "ADNI", "MLP_VAE_SDF_disentangle_all_true_label_age", "specs.json")


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def stage2(root, seed, device="cuda", changes=None):
    """The port's Stage-2 path on the Stage-1 experiment the training phase
    left under ``root``; returns (phase summary, K2 launches, K1 launches)
    of the two runs. ``changes`` updates the flagship spec further (a CPU
    rehearsal shrinks it with them)."""
    import copy

    import torch

    import msd_tpu_torch.workspace as ws
    from msd_tpu_torch import train_MLP_VAE_deep_sdf
    from msd_tpu_torch.data.sdf_samples import sample_sdf_batch
    from msd_tpu_torch.ops import fused_mlp, fused_train
    from msd_tpu_torch.ops.fused_train import fused_sdf_l1

    t0 = time.time()
    stage1_exp, data_dir = os.path.join(root, "train_experiment"), os.path.join(root, "train_data")
    split_path = os.path.join(root, "train_split.json")
    with open(split_path) as f:
        split = json.load(f)
    source = os.path.join(data_dir, "SdfSamples")
    write_labels(source, split, seed + 2)
    with open(FLAGSHIP_STAGE2) as f:
        specs = json.load(f)
    specs.pop("DataSourceMesh")
    changed = {
        "DataSource": source, "TrainSplit": split_path, "TestSplit": split_path,
        "PretrainedLatentPath": os.path.join(stage1_exp, ws.latent_codes_subdir, "latest.pth"),
        "PretrainedSDFDecoderPath": os.path.join(stage1_exp, ws.model_params_subdir, "latest.pth"),
        "NumEpochs": 40, "SnapshotFrequency": 20, "EvalTrainFrequency": 40,
        "EvalGTMeshDir": os.path.join(data_dir, "SurfaceSamples", "smoke", "ellipsoid"), "EvalGTMeshExt": ".ply",
        **(changes or {}),
    }
    exp = os.path.join(root, "stage2_experiment")
    ws.save_experiment_specifications(exp, dict(specs, **changed))
    t_setup = time.time() - t0

    cli = ["-e", exp, "--device", device, "--quiet"]
    fused_train.LAUNCHES = fused_mlp.LAUNCHES = 0
    t0 = time.time()
    trainer = train_MLP_VAE_deep_sdf.main(cli)
    dev = trainer.device
    _sync(dev)
    t_first = time.time() - t0
    k2_first, k1_first = fused_train.LAUNCHES, fused_mlp.LAUNCHES
    n_first = changed["NumEpochs"]
    ws.save_experiment_specifications(exp, dict(specs, **dict(changed, NumEpochs=n_first + 2)))
    fused_train.LAUNCHES = fused_mlp.LAUNCHES = 0
    resumed = train_MLP_VAE_deep_sdf.main(cli + ["-c", "latest"])
    _sync(dev)
    k2_resumed, k1_resumed = fused_train.LAUNCHES, fused_mlp.LAUNCHES

    nb = len(trainer.train_indices) // trainer.scene_per_batch
    card = dev.type == "cuda"  # the counters count CUDA launches; a CPU rehearsal runs the plain versions
    if not trainer.fused_ok or trainer.train_sdf_decoder or (k2_first, k2_resumed) != (n_first * nb * card, 2 * nb * card):
        raise AssertionError(f"K2 d launches {k2_first} + {k2_resumed}, want one per step ({nb} per epoch)")
    if card and k1_first <= 0:
        raise AssertionError("the eval epoch's meshes launched no K1")
    losses = resumed.loss_log
    if len(losses) != (n_first + 2) * nb or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"bad loss log: {losses}")
    if resumed.start_epoch != n_first + 1 or resumed.epoch != n_first + 2:
        raise AssertionError(f"resumed from {resumed.start_epoch} to {resumed.epoch}")
    for sub in (ws.model_params_subdir, ws.optimizer_params_subdir, ws.latent_codes_subdir):
        for name in (f"{changed['SnapshotFrequency']}.pth", f"{n_first}.pth", "latest.pth"):
            if not os.path.isfile(os.path.join(exp, sub, name)):
                raise AssertionError(f"missing checkpoint {sub}/{name}")
    tables = os.path.join(exp, ws.tb_logs_dir, "AgeTables", f"age_table_train_epoch_{n_first}.csv")
    if not os.path.isfile(tables):
        raise AssertionError(f"eval epoch wrote no age table: {tables}")
    if trainer.last_train_sap is None or not math.isfinite(trainer.last_eval_metrics["eval_sdf_loss"]):
        raise AssertionError("eval epoch gave no SAP or eval loss")
    # meshes of the VAE's z_hat; a briefly trained model may give a field
    # with no zero crossing, which create_mesh reports as an empty surface
    meshes = [n for _, _, names in os.walk(os.path.join(exp, ws.tb_logs_dir)) for n in names
              if n == f"epoch={n_first}.ply"]

    # the step on the trained state: time, K2 d's share, launches per step
    B, P = resumed.scene_per_batch, resumed.num_samp_per_scene
    pos, pc, neg, nc = resumed.dataset.device_arrays(dev)
    idx = torch.as_tensor(resumed.train_indices[:B], device=dev)
    labels = resumed._batch_labels(resumed.train_indices[:B], np.random.default_rng(seed))
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch = sample_sdf_batch(pos, pc, neg, nc, idx, P, gen)
    weights = resumed.epoch_weights(n_first + 3)

    def step(**kw):
        return resumed.step(idx, labels, *[weights[i] for i in (2, 3, 0, 1)], batch=batch, generator=gen, **kw)

    fused_train.LAUNCHES = 0
    step_ms = []
    for _ in range(11):
        _sync(dev)
        t = time.perf_counter()
        step()
        _sync(dev)
        step_ms.append((time.perf_counter() - t) * 1e3)
    launches_per_step = fused_train.LAUNCHES / len(step_ms)
    step_med = float(np.median(step_ms[1:]))
    with torch.no_grad():
        z_hat = resumed.vae(resumed._teacher_dev[idx], generator=gen)["z_hat"]
    xyz, gt = batch[:3].permute(1, 2, 0).contiguous(), batch[3]

    def k2d_call():
        with torch.no_grad():
            fused_sdf_l1(resumed.sdf_decoder, z_hat, xyz, gt, resumed.clamp_dist, train_net=False)

    k2d_ms = time_ms(k2d_call)
    profile = profile_steps(step, 3)

    # the step on K2 d against the trainer's float32 autograd path (batch
    # split 4 bounds its graph's memory), same batch and noise
    noise = torch.randn(B, resumed.vae_latent_dim, generator=gen, device=dev)
    cov = torch.randn(B, resumed.vae_latent_dim, generator=gen, device=dev)
    saved = copy.deepcopy((resumed.vae.state_dict(), resumed.optimizer.count, resumed.optimizer.mu,
                           resumed.optimizer.nu))

    def run(fused):
        resumed.vae.load_state_dict(saved[0])
        resumed.optimizer.count, resumed.optimizer.mu, resumed.optimizer.nu = copy.deepcopy(saved[1:])
        resumed.fused_ok = fused
        aux = step(batch_split=1 if fused else 4, noise=noise, cov_noise=cov)
        grad = torch.cat([p.grad.reshape(-1) for p in resumed.vae.parameters()])
        return aux, grad

    (aux_k2, g_k2), (aux_ag, g_ag) = run(True), run(False)
    autograd_step_ms = time_ms(lambda: step(batch_split=4, noise=noise, cov_noise=cov), reps=3, warmup=1)
    resumed.fused_ok = True
    vs_autograd = {"sdf_rel": abs(float(aux_k2["sdf"]) - float(aux_ag["sdf"])) / float(aux_ag["sdf"]),
                   "total_rel": abs(float(aux_k2["total"]) - float(aux_ag["total"])) / abs(float(aux_ag["total"])),
                   "vae_grad": _cmp(g_k2, g_ag)}
    if (vs_autograd["sdf_rel"] > K2D_TOL["autograd_loss"]
            or vs_autograd["vae_grad"]["cos"] < K2D_TOL["autograd_cos"]):
        raise AssertionError(f"Stage-2 step on K2 d vs float32 autograd: {json.dumps(vs_autograd)}")
    return {
        "changed": changed | {"NumEpochs (resume)": n_first + 2}, "scenes": resumed.num_scenes,
        "train_scenes": len(resumed.train_indices), "steps": len(losses),
        "setup_seconds": t_setup, "first_run_seconds": t_first, "epoch_seconds": resumed.logs_history["timing"],
        "epoch_losses": resumed.loss_log_epoch, "train_sap": trainer.last_train_sap,
        "eval_meshes_with_surface": f"{len(meshes)} of {specs['EvalMeshTrainSceneNumber']}",
        "holdout_sap": trainer.last_holdout_sap, "eval_metrics": trainer.last_eval_metrics,
        "k2d_launches": k2_first + k2_resumed, "k1_launches": k1_first + k1_resumed,
        "step_ms_median": step_med, "step_ms": step_ms, "k2d_launches_per_step": launches_per_step,
        "k2d_ms_in_step": k2d_ms, "k2d_share_of_step": k2d_ms / step_med,
        "scenes_per_s": B / (step_med * 1e-3), "profile": profile,
        "autograd_step_ms": autograd_step_ms, "step_vs_autograd": vs_autograd,
    }, k2_first + k2_resumed, k1_first + k1_resumed


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

    k2 = check_k2(decoder, args.seed, dev)
    k2d = check_k2d(decoder, args.seed, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=ROOT) as root:
        training, k2_launches = train(root, specs, args.seed)
        phase("training", **training)
        stage2_summary, k2d_launches, k1_stage2 = stage2(root, args.seed)
    phase("stage2", **stage2_summary)

    bf16 = k1["bfloat16"]

    def worst(r):  # max abs error over both K1 inputs
        return max(r["max_abs_err"], r["corner_lattice_257"]["max_abs_err"])

    b, a = k2["b"], k2["a"]
    autograd_step = {"autograd_step_ms": training["step_ms_by_path"]["autograd_b"],
                     "autograd_step_note": "the trainer's float32 autograd step, batch_split 4, same batch"}
    print(json.dumps({"kernels": [{
        "name": "fused_mlp", "route": "cuda", "source": "msd_tpu_torch/csrc/fused_mlp.cu",
        "replaces": "msd_tpu/ops/fused_mlp.py:211", "launches": launches, "launches_stage2": k1_stage2,
        "max_abs_err": worst(bf16), "ms": bf16["ms"], "plain_ms": bf16["plain_ms"],
        "bound_ms": bf16["bound_ms"], "bound_by": bf16["bound_by"], "library_ms": None,
        "library_note": "no single PyTorch call computes the whole decoder",
        "dtype": "bfloat16", "points": bf16["points"],
        "float32": {"max_abs_err": worst(k1["float32"]),
                    **{k: k1["float32"][k] for k in ("ms", "plain_ms", "bound_ms")}},
    }, {
        "name": "fused_train", "route": "cuda", "source": "msd_tpu_torch/csrc/fused_train.cu",
        "replaces": "msd_tpu/ops/fused_train.py:423", "launches": k2_launches,
        "max_abs_err": b["vs_plain"]["max_abs_err"], "max_rel_frobenius": b["vs_plain"]["worst_grad_rel"],
        "ms": b["ms"], "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
        "library_ms": None, "library_note": "no single PyTorch call computes the loss and every gradient",
        "variant": "b (eikonal)", "points": b["points"], "design_bytes_ms": b["design_bytes_ms"],
        "step_ms": training["step_ms_median"], **autograd_step,
        "variant_a": {k: a[k] for k in ("ms", "plain_ms", "bound_ms", "design_bytes_ms")}
                     | {"max_abs_err": a["vs_plain"]["max_abs_err"],
                        "max_rel_frobenius": a["vs_plain"]["worst_grad_rel"],
                        "step_ms": training["step_ms_by_path"]["k2_a"],
                        "autograd_step_ms": training["step_ms_by_path"]["autograd_a"]},
        "variant_d": {k: k2d[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "design_bytes_ms")}
                     | {"max_abs_err": k2d["vs_plain"]["dlat"]["max_abs_err"],
                        "max_rel_frobenius": k2d["vs_plain"]["dlat"]["rel"], "loss_rel": k2d["vs_plain"]["loss_rel"],
                        "launches": k2d_launches, "step_ms": stage2_summary["step_ms_median"],
                        "autograd_step_ms": stage2_summary["autograd_step_ms"], "library_ms": None},
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
