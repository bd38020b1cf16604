"""The toy Chamfer-parity protocol of ``chamfer_parity.json`` through the port.

``python -m msd_tpu_torch.chamfer_parity [--device cuda] [--out result.json]``

The protocol of ``benchmarks/chamfer_parity.py`` (its ``msd_tpu`` row):
train a 4x64 decoder (latent 16, ``latent_in=[2]``, clamp 0.1, CodeBound
1, code regularization 1e-4, gradient clip 1, Adam 5e-4 / 1e-3) for 300
epochs on 8 synthetic scenes (sphere / torus / union, 8 x 4096 points per
step), fit a latent to each of 4 held-out scenes (300 iterations x 4000
samples, lr 5e-3), evaluate the decoder on a dense 129^3 grid in float32,
mesh it by marching tetrahedra and score the Chamfer-L2 against 30000
analytic surface points. The dataset is regenerated from the same seed and
recipe and its content hash is checked against ``chamfer_parity.json``'s
(``bc674411285de887``), so both packages saw the same bytes. Training runs
through ``Stage1Trainer``: on a GPU its loss and gradients go through K2
(variant a: the protocol has no eikonal term). The JAX package's row is
0.00306 and the reference PyTorch stack's 0.00499.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import tempfile
import time

import numpy as np
import torch

from msd_tpu_torch.data.sdf_samples import SdfDataset, pad_stack
from msd_tpu_torch.device import resolve_device
from msd_tpu_torch.metrics.chamfer import compute_mesh_chamfer
from msd_tpu_torch.models.deepsdf import decode_sdf
from msd_tpu_torch.ops import fused_train
from msd_tpu_torch.ops.marching_cubes import marching_tetrahedra
from msd_tpu_torch.train.reconstruct import reconstruct_batch
from msd_tpu_torch.train.stage1 import Stage1Trainer

LATENT, DIMS, LATENT_IN, CLAMP = 16, [64] * 4, [2], 0.1
EPOCHS, SCENES_TRAIN, SCENES_TEST, SAMPLES_PER_SCENE = 300, 8, 4, 4096
RECON_ITERS, RECON_SAMPLES, RECON_LR = 300, 4000, 5e-3
GRID_N, GT_POINTS, SEED = 129, 30000, 7
DATASET_SHA = "bc674411285de887"


def torus_sdf(pts, R, r):
    q = np.sqrt(pts[:, 0] ** 2 + pts[:, 1] ** 2) - R
    return np.sqrt(q**2 + pts[:, 2] ** 2) - r


def union_sdf(pts, c, r):
    a = np.linalg.norm(pts - np.array([c, 0, 0]), axis=1) - r
    b = np.linalg.norm(pts + np.array([c, 0, 0]), axis=1) - r
    return np.minimum(a, b)


def scene_specs(num_scenes, rng):
    """Per-scene (family, params), balanced over sphere / torus / union."""
    out = []
    for i in range(num_scenes):
        fam = i % 3
        if fam == 0:
            out.append(("sphere", {"r": float(rng.uniform(0.35, 0.75))}))
        elif fam == 1:
            out.append(("torus", {"R": float(rng.uniform(0.35, 0.55)), "r": float(rng.uniform(0.12, 0.25))}))
        else:
            out.append(("union", {"c": float(rng.uniform(0.18, 0.35)), "r": float(rng.uniform(0.22, 0.38))}))
    return out


def scene_sdf(spec, pts):
    fam, p = spec
    if fam == "sphere":
        return np.linalg.norm(pts, axis=1) - p["r"]
    if fam == "torus":
        return torus_sdf(pts, p["R"], p["r"])
    return union_sdf(pts, p["c"], p["r"])


def scene_surface(spec, n, rng):
    fam, p = spec
    if fam == "torus":
        u = rng.uniform(0, 2 * np.pi, n)
        v = rng.uniform(0, 2 * np.pi, n)
        return np.stack([(p["R"] + p["r"] * np.cos(v)) * np.cos(u),
                         (p["R"] + p["r"] * np.cos(v)) * np.sin(u),
                         p["r"] * np.sin(v)], axis=1).astype(np.float32)
    d = rng.normal(size=(n, 3))
    pts = (p["r"] * d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    if fam == "sphere":
        return pts
    side = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    pts[:, 0] += side * p["c"]
    # drop points of one sphere that fall inside the other (not on the surface)
    return pts[np.abs(scene_sdf(spec, pts)) < 1e-4]


def make_dataset():
    """(scenes [(pos, neg)], GT surface points, sha256[:16]) of the protocol:
    two near-surface jitter scales plus a uniform fill per scene
    (ref: PreprocessMesh.cpp:291-319)."""
    rng = np.random.default_rng(SEED)
    specs = scene_specs(SCENES_TRAIN + SCENES_TEST, rng)
    scenes, gt_points = [], []
    n_half = 20000
    for spec in specs:
        base = scene_surface(spec, int(1.6 * n_half), rng)
        s1 = base + rng.normal(0, np.sqrt(0.005), base.shape)
        s2 = base + rng.normal(0, np.sqrt(0.0005), base.shape)
        uni = rng.uniform(-1, 1, size=(int(0.13 * len(base)), 3))
        pts = np.concatenate([s1, s2, uni]).astype(np.float32)
        sdf = scene_sdf(spec, pts).astype(np.float32)
        pos = np.concatenate([pts[sdf >= 0][:n_half], sdf[sdf >= 0][:n_half, None]], axis=1)
        neg = np.concatenate([pts[sdf < 0][:n_half], sdf[sdf < 0][:n_half, None]], axis=1)
        scenes.append((pos.astype(np.float32), neg.astype(np.float32)))
        gt_points.append(scene_surface(spec, GT_POINTS, rng)[:GT_POINTS])
    h = hashlib.sha256()
    for pos, neg in scenes:
        h.update(pos.tobytes())
        h.update(neg.tobytes())
    return scenes, gt_points, h.hexdigest()[:16]


SPECS = {
    "Description": "chamfer parity (toy protocol)",
    "DataSource": "<memory>", "TrainSplit": "<memory>",
    "NetworkArch": "deep_sdf_decoder",
    "NetworkSpecs": {"dims": DIMS, "dropout": [], "dropout_prob": 0.0, "norm_layers": [],
                     "latent_in": LATENT_IN, "xyz_in_all": False, "use_tanh": False,
                     "latent_dropout": False, "weight_norm": True},
    "CodeLength": LATENT, "NumEpochs": EPOCHS, "SnapshotFrequency": 10000, "AdditionalSnapshots": [],
    "LearningRateSchedule": [{"Type": "Step", "Initial": 5e-4, "Interval": 500, "Factor": 0.5},
                             {"Type": "Step", "Initial": 1e-3, "Interval": 500, "Factor": 0.5}],
    "SamplesPerScene": SAMPLES_PER_SCENE, "ScenesPerBatch": SCENES_TRAIN, "ClampingDistance": CLAMP,
    "CodeRegularization": True, "CodeRegularizationLambda": 1e-4, "CodeBound": 1.0,
    "GradientClipNorm": 1.0, "Seed": SEED,
}


def run(device="cuda"):
    dev = resolve_device(device)
    scenes, gt_points, sha = make_dataset()
    if sha != DATASET_SHA:
        raise RuntimeError(f"dataset hash {sha} != {DATASET_SHA}: not the protocol's data")
    pos, pc = pad_stack([p for p, _ in scenes[:SCENES_TRAIN]])
    neg, nc = pad_stack([n for _, n in scenes[:SCENES_TRAIN]])
    names = [f"s{i}" for i in range(SCENES_TRAIN)]
    ds = SdfDataset(names, names, pos, pc, neg, nc, SAMPLES_PER_SCENE)
    fused_train.LAUNCHES = 0
    with tempfile.TemporaryDirectory(prefix="msd_parity_") as exp:
        trainer = Stage1Trainer(exp, specs=SPECS, dataset=ds, device=dev)
        t0 = time.time()
        for e in range(1, EPOCHS + 1):
            trainer.train_epoch(e)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        train_s = time.time() - t0
    launches = fused_train.LAUNCHES

    t0 = time.time()
    decoder = trainer.decoder.eval()
    _, latents = reconstruct_batch(decoder, RECON_ITERS, LATENT, scenes[SCENES_TRAIN:], 0.01, CLAMP,
                                   num_samples=RECON_SAMPLES, lr=RECON_LR, l2reg=True)
    axis = torch.linspace(-1, 1, GRID_N, device=dev)
    grid = torch.stack(torch.meshgrid(axis, axis, axis, indexing="ij"), dim=-1).reshape(-1, 3)
    chamfers = []
    for ti, latent in enumerate(latents):
        with torch.no_grad():
            sdf = torch.cat([decode_sdf(decoder, latent, c)[:, 0] for c in grid.split(2**18)])
        mesh = marching_tetrahedra(sdf.cpu().numpy().reshape((GRID_N,) * 3), level=0.0,
                                   spacing=(2.0 / (GRID_N - 1),) * 3, origin=(-1.0, -1.0, -1.0))
        chamfers.append(float(compute_mesh_chamfer(gt_points[SCENES_TRAIN + ti], mesh,
                                                   num_mesh_samples=GT_POINTS)[0]))
    return {
        "dataset_sha256_16": sha, "epochs": EPOCHS, "device": str(dev),
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "path": "K2 (variant a)" if trainer.use_fused else "autograd", "k2_launches": launches,
        "final_loss": trainer.loss_log_epoch[-1],
        "chamfer_per_scene": chamfers, "chamfer_mean": float(np.mean(chamfers)),
        "train_seconds": train_s, "recon_eval_seconds": time.time() - t0,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description="Toy Chamfer-parity protocol through msd_tpu_torch")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--out", default=None, help="also write the result JSON here")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)
    result = run(args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
