#!/usr/bin/env python3
"""On-card smoke test of msd_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py [--seed S]

Needs one NVIDIA GPU and the repository around it; without either it exits
non-zero and prints no result. Phases, one JSON line each:

1. device: the card's name and power limit (nvidia-smi).
2. build: nvcc builds every kernel source of the port, in parallel, and g++
   the host library (the render pass's rasterizer and the mesher) beside them.
3. k1: the fused SDF-query kernel (csrc/fused_mlp.cu) against its plain
   PyTorch version at the flagship decoder's full width
   (examples/ADNI/minimal_eikonal/specs.json), in bf16 (the wgmma route)
   and float32 (the f32 route), on two inputs whose last point tile is
   ragged: 2^20 + 37 seeded points in [-1, 1]^3 (errors, sign agreement,
   times by CUDA events, FLOP bound) and the 65^3 corner lattice that
   create_mesh evaluates first at N=257. The same on the flagship-width
   LayerNorm decoder (``ln_decoder``: norm_layers 0-7, no weight norm,
   seeded LayerNorm affine), which takes the wgmma kernel's LayerNorm
   instantiation in bf16 and the f32 kernel in float32. On each of those
   four specs also torch.matmul of the decoder's products alone at the same
   points and operand type (TF32 off), at the kernel's padded shapes and at
   the true widths: a reference, no epilogue. Then the
   wide kernels (k1_wide): decoders with hidden widths over 512
   (``WIDE_NET`` and the LayerNorm ``WIDE_LN_NET``) in both types, each
   against its plain version, timed beside its bound and its products by
   torch.matmul, with its launches by route (wgmma_wide, f32_wide); the
   widest shapes the 10 MB weight cap admits at latent 256 (dims 2048 x 2
   in bf16, 1408 x 2 in float32, one hidden layer of 16384 in bf16) against
   their plain versions on fewer points; and ``create_mesh`` at N=129 of both wide decoders (bf16
   and float32), the launches of the kernels line. Then every K1 kernel's
   registers, spills and shared memory (k1_kernels).
3a. fit: the serving fit's fused float32 kernels (csrc/fused_fit.cu,
   ops/fused_fit.py) against the fit's autograd route, the plain version
   and a float64 autograd reference at 8 x 8000, 1 x 8000 and 8 x 4000
   seeded ellipsoid rows on the flagship (``check_fit``): per-shape loss
   and latent gradient errors (``fused_fit.FIT_TOL``), each shape's gradient alone
   and among 8 bit for bit, launches per call by kernel; ms per loss and
   gradient on both routes and on the plain version, ms per reconstruct
   iteration, device ms by kernel (torch.profiler), the products alone on
   one stream (``products_ms``) and their TFLOP/s on the real count against
   their FP32 bound and torch.matmul of the same products (``library_ms``);
   100 iterations of ``reconstruct_batch``, all on the kernel route
   (``reconstruct.FIT_ITERATIONS``).
4. serving: the port's main path as a user runs it. A seeded flagship
   checkpoint and two seeded ellipsoids (250k + 250k SdfSamples each, plus
   SurfaceSamples) are written to a temporary experiment; then
   ``python -m msd_tpu_torch.reconstruct`` (800 iterations x 8000 samples,
   mesh resolution 256, snapped to 257) and ``msd_tpu_torch.evaluate`` run
   in process; every fit iteration takes the kernel route. The weights are seeded, not trained, so the Chamfer is not a
   quality figure. Every K1 launch there must take the wgmma route. Then
   one reconstructed latent is meshed twice more at N=257, through the
   kernel and through the plain version on the card: active blocks of each
   and the symmetric Chamfer between the two meshes (``MESH_TOL``).
4a. serving_variants: the serving path on the decoders the other two K1
   kernels serve (``serving_variants``): the flagship-width LayerNorm
   decoder through the reconstruct CLI on the first shape (its mesh
   streamed at N=257, every K1 launch on the wgmma route), and
   ``create_mesh(eval_dtype=torch.float32)`` of the flagship on the first
   latent at N=257 (every K1 launch on the f32 route, beside the bf16
   mesh); K1 counted from 0 before each.
4b. mesher_ab: the same latent's sparse block values at N=257 meshed
   through the C++ host mesher (msd_tpu_torch/native/marching_tets.cpp,
   create_mesh's route) and the numpy route: equal vertex and face counts,
   vertex sets within ``MESHER_TOL``, each timed; then create_mesh's
   seconds per shape (median of 3, PLY written) split into K1 (CUDA
   events), the device-to-host copy of the SDF values (bytes, ms), the
   host's block selection, the mesher and the PLY write.
4c. streaming: the streaming create_mesh, the route on the card since this
   port's create_mesh streams where its evaluator sits on the card, on the
   same latent at N=257 (single-level refinement on the card) and N=513
   (two-level refinement), each with the packed, int8 and f16 value
   codecs: seconds per shape (median of 3 after a warm-up, writing the
   PLY), every LAST_STREAMING_STATS key (refine route, active and crossing
   blocks, points evaluated, bytes copied, exact slabs, the host's waits
   and the mesher's), K1's launches per call (the kernels line's
   launches_streaming counts these calls only); beside it the
   non-streaming route's seconds, K1 launches and mesh: every codec's vertex count against it, the int8 and
   packed meshes with the f16 mesh's faces, no open edge inside the
   volume; msd_tpu's codec bounds (``STREAM_TOL``: the f16 mesh against
   the float32 one, int8 and packed against f16) measured, and held on a
   flagship-width decoder fitted for 400 Adam steps to an ellipsoid's
   distance field (one run per codec), since they assume a field close to
   1-Lipschitz. Then the corner dedup's A/B on the serving latent
   (``dedup_ab``): MSD_STREAM_DEDUP off against on, interleaved, at N=513
   (the default dedups there, and only there) and N=257 (forced): seconds
   per shape, dedup slabs and retries, points evaluated and K1 launches per
   arm, every dedup mesh equal to the plain mesh bit for bit.
5. k2: the Stage-1 fused loss-and-gradient kernels (csrc/fused_train.cu),
   variants b (eikonal) and a, at the flagship width in bf16: against float32
   autograd and their plain PyTorch version on 4 seeded scenes x 16384
   points, then against the plain version at the full step shape, 32 x
   16384 points (8 chunks of the kernels' scratch), where both are timed
   (CUDA events) beside the operation bound and the design's byte bound.
   Errors: loss sums, and per layer dMp, dMx, db and dlat, relative
   Frobenius error and cosine similarity. The GEMM kernels' and the row
   streamers' (eik_kernel, skinny_kernel) registers, spills and shared
   memory (ptxas).
6. k2gemm: K2's two GEMM kernels alone at the step's shapes, one launch
   each (a masked 512 x 512 chain product with column sums over 65536
   points, a primal product, the product with a plain-store epilogue, a
   variant-b weight-gradient launch), against float32 torch products,
   timed on the device beside their operations and bytes bounds and
   torch.matmul of the same bf16 product; and the two K = 0 chain launches
   (rank-one, 65536 x 512) that last_kernel's rank-one rows replace.
7. k2pt: K2's three per-point kernels alone at the flagship chunk's b and c
   shapes (65536 points; every point, or the first 4096 of each scene's
   16384, gated) and last_kernel also at d (none gated): last_kernel with
   its rank-one rows, eik_kernel (both u operands 512 wide) and
   skinny_kernel (delta^T x + u0^T gbar), each against its plain version
   (last_plain with last_rank1_plain, eik_plain, skinny_plain) and twice
   for equal bits, timed on the device beside its bytes bound, its plain
   version and, for skinny_kernel, torch.matmul of its two pairs
   concatenated; registers, spills and shared memory (ptxas). last_kernel
   is also launched without its rank-one rows (d: with and without their
   column sums), which must leave its other outputs bit for bit as they
   were, and timed so as the row streamer alone; the rank1_ab line sets
   that time plus the K = 0 chain launch of phase 6 against the launch
   with the rank-one rows, at b and d.
8. training: the port's Stage-1 path as a user runs it. The flagship
   specs.json with its DataSource, splits, NumEpochs (6), SnapshotFrequency
   (3) and AdditionalSnapshots ([]) changed, on 64 seeded ellipsoids
   (100k + 100k SdfSamples each); ``python -m msd_tpu_torch.train_deep_sdf
   --device cuda`` runs in process for 12 steps, then ``-c latest`` with
   NumEpochs 8 for 4 more. Then step times, K2's share of the step, its
   CUDA kernels' launches per step (chain_kernel's held to the launcher's
   count), a torch.profiler split of the step's device time by kernel with the
   device's idle share, the point sampler's time at chunk 128 and 1, and
   the trainer's step on K2 a and on its float32 autograd path.
9. k2d: K2's frozen-decoder variant d (loss and latent gradient only, the
   Stage-2 step's kernel) against its plain version and float32 autograd on
   4 seeded scenes x 16384 points, and against its plain version at the
   Stage-2 step shape, 32 x 16384 points, where both are timed beside the
   operation bound and the design's byte bound. Errors: loss sum relative,
   dlat relative Frobenius and cosine.
10. stage2: the port's Stage-2 path as a user runs it, on top of the
   training phase's Stage-1 experiment (64 ellipsoids, flagship width).
   ``labels.pt`` gets a 0/1 diagnosis from each ellipsoid's axis ratio and
   a seeded age; the flagship Stage-2 specs.json
   (examples/ADNI/MLP_VAE_SDF_disentangle_all_true_label_age) with its
   paths, NumEpochs (40), SnapshotFrequency (20), EvalTrainFrequency (40)
   and GT mesh dir changed; ``python -m msd_tpu_torch.train_MLP_VAE_deep_sdf
   --device cuda`` runs in process for 40 steps (58 training scenes, one
   batch of 32 per epoch) with one eval epoch (run_eval, SAP, Locatello SAP,
   correlation, the tables, 2 meshes at N=257 through K1 and their Chamfer
   where a mesh has a surface: the 16-step Stage-1 decoder of phase 8 may
   give a field with none; each mesh's seconds, K1 launches and streaming
   statistics beside the non-streaming route on the same latent), then
   ``-c latest`` with NumEpochs 42. Then
   the step's time, K2 d's share and launches per step (and its CUDA
   kernels', chain_kernel's held to the launcher's count), a torch.profiler
   split, and the trainer's step on K2 d against its float32 autograd path
   (loss and VAE gradient).

10b. hpo: the port's Stage-2 hyper-parameter search as a user runs it,
   ``python -m msd_tpu_torch.hparams_optuna_vae_sdf`` in process on the
   stage2 phase's spec (its absolute paths; TrainLatentHoldoutFraction
   0.25: 0.1 holds out 6 of the 64 scenes, whose classification SAP is 0,
   as its 5-fold cross-validation needs 5 holdout scenes of each class):
   3 trials of 2 epochs (48 training scenes, one batch of 32 per epoch,
   K2 d), then 1 more resumed from trials.json. Every trial has a finite
   objective, SAP, correlation and recon; best.json is written; the resumed
   trial's parameters are the sampler's, replayed on the host from the
   seed and the first 3 trials; K2 d launches once per step; each trial's
   seconds and the device memory held after it, which may not grow over
   the 4 trials by more than one trial's dataset on the card.
10c. profile: ``ProfileEpochs`` on a copy of the training phase's
   flagship Stage-1 spec with NumEpochs 2 and ProfileEpochs [2], through
   ``python -m msd_tpu_torch.train_deep_sdf`` in process: exactly one trace
   file under TensorBoard/profile, a JSON document whose kernel events name
   K2's five CUDA kernels as often as ``fused_train.KERNEL_LAUNCHES``
   counted them in epoch 2; the trace's size and the profiled epoch's
   seconds against epoch 1's.

10d. stage2_points: Stage 2 in points mode on the same Stage-1 experiment:
   the flagship Stage-2 spec with EncoderType pointnet2 (PointNet++, the
   point VAE's default; no shipped config sets a point encoder),
   SurfacePointCount 2048 from DataSourceMesh, the ellipsoids' .obj meshes
   that write_dataset writes with the port's save_obj, every flagship loss
   on, ScenesPerBatch 32, K2 d. Driven through the trainer API, as
   msd_tpu's points-mode tests drive it (tests/test_stage2_points_mode.py),
   since a CLI run stops at its first snapshot: 4 epochs of train_epoch (K2
   d once per step), run_eval on the train split and 2 meshes of z_hat at
   N=257 (K1; each beside the non-streaming route, as in stage2),
   compute_vae_latents twice (equal bits, BatchNorm statistics
   fixed), save_checkpoint refused. Then the step's median ms, peak device
   memory, K2 d's launches per step, a torch.profiler split (device ms,
   operations, idle share, the largest other kernels), and FPS, the ball
   query and K2 d alone at the step's shapes (CUDA events and profiler) as
   shares of the step, with FPS also replayed as one CUDA graph. Then
   resnet_pointnet and pointnet_encoder 2 epochs each: finite losses, K2 d
   once per step, pointnet_encoder's BatchNorm means moved by training and
   fixed by compute_vae_latents.

10e. stage2_points_ranks: the stage2_points experiment (PointNet++, 32
   scenes x 2048 surface points, K2 d) on 2 gloo ranks on the card, each
   encoding its 16 scenes with BatchNorm over both ranks' rows and running
   K2 d on them, for 4 steps on given scene ids, labels, weights and
   generator seeds, against one process taking the same steps: the first
   step's losses, VAE gradients, parameters and BatchNorm statistics
   within ``POINTS_RANKS_TOL``, both ranks' parameters and statistics
   equal bit for bit after the last, K2 d once per step on each rank, the
   device operations of the first step's FPS on each rank's scenes and on
   one process's (profiler), the step's ms on each rank and in one
   process.

11. k2ce: K2 variants c (EikonalNumPoints 4096 of 16384 points per scene)
   and e (per-scene 0/1 weights; eikonal on, one pad scene) against float32
   autograd and their plain version on 4 seeded scenes x 16384 points, then
   against the plain version at 32 x 16384 points (e: scene 31 weighted
   0), where both are timed beside the operation bound; a pad scene's dlat
   must be exactly 0.
12. training_eik4096: ``python -m msd_tpu_torch.train_deep_sdf --device
   cuda`` on the training phase's data with EikonalNumPoints 4096 (the
   flagship's configuration of ``bench.py``'s "bench-eik4096") for 8 steps,
   K2 c once per step; then its step time, K2's share of the step and
   launches per step.
13. training_gmm: ``examples/ADNI/minimal_eikonal_gmm/specs.json`` at its
   own width and batch (16 scenes x 16384 points, eikonal, GMM prior; K2
   b over 4 chunks per step) on the training phase's data, warm-started
   from that phase's decoder (PretrainedSDFDecoderDir, absolute), with
   ``UseCovarianceLoss`` added, a msd_tpu key the shipped config leaves
   off, so both latent-batch losses run. The warm-started decoder must
   equal phase 8's latest.pth, and the trainer's first step on K2 must
   match the same trainer's float32 autograd path from the same state (the
   GMM gradient and both latent-batch losses to 1e-5 relative, the decoder
   and latent gradients within K2_TOL's autograd limits). Then the CLI for
   2 epochs (8 steps) and ``-c latest`` for 1 more: K2 b once per step, its
   CUDA kernels' launches at the training phase's per-chunk counts, the
   GMM prior's Adam moments bit for bit through the checkpoint, the GMM and
   covariance TensorBoard scalars finite. Then the step's median ms (host
   clock), K2's share of it, a torch.profiler split, and the step timed
   with the two latent-batch losses on and off in turns.
14. training_iso: the flagship Stage 1 with isometry and grad-metric
   isotropy (mixup with probability 0.5, 256 near-surface points on a
   random 8 of each batch's 16 scenes) through the CLI for 4 steps: the
   trainer logs why it takes the autograd path, K2 launches no time, the
   four isometry scalars are finite; then the step's median ms.
15. dp: the flagship Stage-1 at ScenesPerBatch 32 on 3 ranks, so the batch
   pads to 33 and every rank runs K2 e, for 3 steps, against one process
   on the same batches (step-1 losses and summed pre-Adam gradients); then
   2 epochs of the Stage-2 experiment on 2 ranks (K2 d split by scenes)
   against one process. NCCL with one GPU per rank where there are enough
   GPUs, else gloo with every rank on cuda:0: a correctness drive of the
   multi-rank path, not a scaling figure.
16. preprocess: the port's data preparation as a user runs it, no kernel
   of its own. Four seeded ellipsoid masks (NIfTI, 64 x 96 x 64 voxels at
   1 mm, long along y as a hippocampus is) go through
   ``python -m msd_tpu_torch.utils.batch_process_to_ply``, ``ply_to_obj``
   and ``create_split_json_files`` (2/1/1); one mesh loses a cap, so
   "auto" renders it. ``python -m msd_tpu_torch.run_all_preprocessing``
   runs at its defaults (500000 samples, 200000 vote points; SDF, --test,
   --surface; the vote's tiled route on the card), then
   ``preprocess_data --test`` into a second data directory (run_all's test
   pass skips files that exist). One ``preprocess_mesh`` line per mesh and
   mode: seconds by part (quality and repair, render, host sampling, the
   vote), pos/neg counts, rejected fraction, the vote's device ms (CUDA
   events), idle share between its chunks and peak device memory. Then
   every output checked, the tiled route against the host route on one
   full-size mesh (``VOTE_AGREEMENT``: keep, sign and |sdf| within 1e-5,
   each on 99.9% of the queries), the tiled vote under torch.profiler
   beside the materialized design's bytes bound, and the port's
   SdfSamples loader drawing 4 x 16384 points from the written files.
17. serving_ranks: serving over 2 gloo ranks, both on the one card (NCCL,
   one card per rank, is not measured), at the flagship width with the
   serving phase's seeded decoder, on 4 seeded ellipsoids (250k + 250k
   SdfSamples each). ``reconstruct_batch(group=)`` at the CLI's 800 x 8000
   (2 shapes per rank): each rank's latents bit for bit one process's fit
   of its 2 shapes, all 4 within 1e-5 of one process's fit of 4; seconds
   per shape on the ranks and in one process. Through
   ``PointEvaluator(group=)`` (K1 counted from 0 on each rank): the sparse
   evaluation at N=257, its corner and block SDF values bit for bit one
   process's and K1 launched on every rank; then ``create_mesh``, which
   streams over the group (the main rank refines, streams and meshes, the
   others join the host route's lattice), at N=257, at N=513 (corner dedup
   by default) and at N=257 with the host route forced: every rank's mesh
   bit for bit the one-process stream's with the same codec, the main
   rank's stream statistics one process's, the other ranks' K1 launches
   on the host route only; per rank the seconds, K1 launches, points,
   route and broadcast bytes, beside the one-process call's seconds. The
   reconstruct CLI's ``--batch 4`` through ``main(argv, group=)``: the
   codes and meshes of a one-process run, written by the main rank alone.
   ``knn_sign_vote`` over devices ["cuda", "cuda"] on one of the
   preprocess phase's meshes at its defaults: the bytes of the one-device
   vote; both timed.
18. tooling: ``python -m msd_tpu_torch.generate_training_meshes`` (in
   process) on an experiment of the serving decoder and the 4 latents the
   ranks fitted, two instances with NormalizationParameters: K1 launched,
   every mesh bit for bit ``create_mesh`` of its latent called directly,
   then taken to the instance's frame; the workspace loaders' round trip;
   ``check_experiment_inputs`` on the Stage-2 phase's experiment with no
   input missing; Hausdorff and EMD of a mesh the serving_ranks CLI
   reconstructed against its ellipsoid.
19. figures: the latent explorer and the figure tools, on the tooling
   phase's experiment and the training phase's. Whether matplotlib imports
   (it is the port's optional dependency for figures). Always, needing no
   matplotlib: ``python -m msd_tpu_torch.latent_explorer --mode html``
   (in process, 4 dims x 9 steps, 33 decoded frames) at ``-N 129`` (capped
   at 97, streamed on the card) and ``-N 64`` (65, the dense route), each
   with K1 counted from 0 just before and read just after (the kernels
   line's launches_figures), every frame of the HTML equal to
   ``_pack_mesh`` of ``create_mesh`` called directly on its latent, the
   CLI's seconds split into loading, the evaluator's set-up, the frames'
   decoding and meshing (also per frame) and the export, and the file's
   MB; ``manifold.tsne`` of the training phase's 64 latents on the card
   against the same call on the CPU (``FIGURE_TSNE_TOL``), both timed; the
   Stage-1 trainer's ``_eval_train`` and ``_eval_test`` (K1 launched;
   ``EvalGridResolution`` 256, cut to 128 where matplotlib imports) writing
   their three figures to ``ScalarRecorder`` where matplotlib imports, and
   otherwise skipping them with msd_tpu's warning. Where
   matplotlib imports, and otherwise listed as not run: ``latent_explorer``
   in interp and sweep mode (K1 launched), ``plot_log`` for its five types,
   ``analyze_sdf_npz`` on a training SdfSamples file and
   ``latent_manifold`` with pca, ica, hlle and tsne. No sub-step's
   exception is caught.

Each phase's line carries the wall seconds since the previous line
(``since_last_s``). Then the ``kernels`` line, the
card's ``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``. Any
failed phase raises and exits non-zero. There is no phase filter: every run
drives every phase.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import copy
import functools
import json
import logging
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
# The flagship-width LayerNorm decoder (``ln_decoder``) in bf16: LayerNorm
# divides each row by its standard deviation, so a bf16 rounding that two
# summation orders round apart moves the later layers further than on the
# flagship. Measured on an H100 (PERF.md) against the plain version at
# 2^20 + 37 points: the wgmma kernel max 1.87e-2, mean 1.56e-4, sign
# 0.99987; the first (mma.sync) kernel on the same spec, since retired, max
# 2.19e-2, mean 1.98e-4, sign 0.99983, both over TOL["bfloat16"]. The
# limits keep a margin of about 2x (1 - sign: 3.8x); besides, a bf16
# LayerNorm decoder's max and mean error may be no more than 1.5 times the
# retired kernel's measured ones (LN_REF).
TOL_LN = {"max": 4e-2, "mean": 3e-4, "sign": 0.9995}
LN_REF = {"max": 1.5 * 2.19e-2, "mean": 1.5 * 1.98e-4}


_LAST_PHASE = [time.time()]


def phase(tag, /, **kw):
    """Print a phase's JSON line with the wall seconds since the previous
    phase's line (``since_last_s``)."""
    now = time.time()
    print(json.dumps({"phase": tag, "since_last_s": now - _LAST_PHASE[0], **kw}), flush=True)
    _LAST_PHASE[0] = now


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


def ellipsoid_mesh(axes, n_theta=24, n_phi=48):
    """(verts [V, 3], faces [F, 3]) of a UV-triangulated ellipsoid with
    semi-axes ``axes``, centred at the origin; faces wind outwards."""
    theta = np.linspace(0, np.pi, n_theta)[1:-1]
    phi = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    t, p = np.meshgrid(theta, phi, indexing="ij")
    ring = np.stack([np.sin(t) * np.cos(p), np.sin(t) * np.sin(p), np.cos(t)], -1).reshape(-1, 3)
    verts = np.concatenate([[[0, 0, 1]], ring, [[0, 0, -1]]]) * np.asarray(axes)
    n_ring, bottom = n_theta - 2, len(verts) - 1
    j, jn = np.arange(n_phi), (np.arange(n_phi) + 1) % n_phi
    faces = [np.stack([np.zeros(n_phi, int), 1 + j, 1 + jn], 1),
             np.stack([np.full(n_phi, bottom), 1 + (n_ring - 1) * n_phi + jn, 1 + (n_ring - 1) * n_phi + j], 1)]
    for r in range(n_ring - 1):
        a, b = 1 + r * n_phi, 1 + (r + 1) * n_phi
        faces += [np.stack([a + j, b + j, b + jn], 1), np.stack([a + j, b + jn, a + jn], 1)]
    return verts.astype(np.float32), np.concatenate(faces).astype(np.int32)


def write_dataset(data_dir, n_shapes, n_samples, seed):
    """SdfSamples/SurfaceSamples of ``n_shapes`` seeded ellipsoids under
    ``data_dir`` (dataset "smoke", class "ellipsoid") and each one's mesh
    as ``Meshes/<id>.obj`` (the point encoders' DataSourceMesh); returns
    the nested split."""
    from msd_tpu_torch.data.mesh_io import save_obj, save_ply

    rng = np.random.default_rng(seed)
    names = [f"ellipsoid{i}" for i in range(n_shapes)]
    os.makedirs(os.path.join(data_dir, "Meshes"), exist_ok=True)
    for name in names:
        axes = rng.uniform(0.35, 0.7, 3)
        pos, neg, surf = ellipsoid_samples(axes, n_samples, rng)
        for sub in ("SdfSamples", "SurfaceSamples"):
            os.makedirs(os.path.join(data_dir, sub, "smoke", "ellipsoid"), exist_ok=True)
        np.savez(os.path.join(data_dir, "SdfSamples", "smoke", "ellipsoid", name + ".npz"), pos=pos, neg=neg)
        save_ply(os.path.join(data_dir, "SurfaceSamples", "smoke", "ellipsoid", name + ".ply"), surf)
        save_obj(os.path.join(data_dir, "Meshes", name + ".obj"), *ellipsoid_mesh(axes))
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


def time_ms(fn, reps=10, warmup=2, device_only=False):
    """Median milliseconds of ``fn`` on the current stream (CUDA events).
    ``device_only``: a millisecond of device sleep is queued before each
    start event, so the host's time to launch ``fn`` is not counted (for
    one kernel launch, not for a host-bound step)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def k1_errors(spec, latent, xyz, tol, label):
    """The kernel (fused_eval) against the plain version on ``xyz``; raises
    past ``tol``."""
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


# K1's kernels in nvcc's -Xptxas -v log (mangled-name fragments), and the
# route number msd_fused_mlp_smem_bytes takes for each
K1_KERNELS = {
    "fused_mlp_wgmma_kernelILb0E": ("wgmma", 1), "fused_mlp_wgmma_kernelILb1E": ("wgmma_ln", 1),
    "fused_mlp_f32_kernel": ("f32", 2), "fused_mlp_wgmma_wide_kernelILb0E": ("wgmma_wide", 3),
    "fused_mlp_wgmma_wide_kernelILb1E": ("wgmma_wide_ln", 3), "fused_mlp_f32_wide_kernel": ("f32_wide", 4),
}


def k1_ptxas(log):
    """Registers, spills and stack of K1's kernels (both instantiations of
    each wgmma kernel, both f32 kernels), from nvcc's ``-Xptxas -v`` log,
    with their dynamic shared memory. An empty log (the library was built
    by an earlier run) reports nothing."""
    from msd_tpu_torch.ops._build import load_library

    lib = load_library("fused_mlp")
    if not log:
        return {"ptxas": "not reported: the library was built before this run"}
    out, cur = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = next((v for k, v in K1_KERNELS.items() if k in ln), None)
            if cur:
                name, route = cur
                out[name] = {"ptxas": [], "dynamic_smem_bytes": lib.msd_fused_mlp_smem_bytes(route)}
                cur = name
        elif cur and ("registers" in ln or "spill" in ln or "arning" in ln):
            out[cur]["ptxas"].append(ln.strip())
    missing = {v[0] for v in K1_KERNELS.values()} - set(out)
    if missing:
        raise AssertionError(f"K1: no ptxas report for {sorted(missing)}")
    return out


def ln_decoder(specs, seed, dev):
    """The flagship's NetworkSpecs with every hidden layer LayerNorm and no
    weight norm (norm_layers 0-7: 8 x 512, latent 256, latent_in [4]),
    seeded; LayerNorm scale drawn in [0.5, 1.5] and bias in +-0.1 so it is
    not the identity, then give_surface_ as for the flagship."""
    import torch

    from msd_tpu_torch.models import build_decoder
    from msd_tpu_torch.models.deepsdf import give_surface_

    net = dict(specs["NetworkSpecs"], norm_layers=list(range(len(specs["NetworkSpecs"]["dims"]))),
               weight_norm=False)
    g = torch.Generator().manual_seed(seed + 20)
    dec = build_decoder(specs["NetworkArch"], specs["CodeLength"], net, generator=g)
    with torch.no_grad():
        for layer in net["norm_layers"]:
            bn = getattr(dec, f"bn{layer}")
            bn.weight.copy_(0.5 + torch.rand(bn.weight.shape, generator=g))
            bn.bias.copy_(0.2 * torch.rand(bn.bias.shape, generator=g) - 0.1)
    dec = dec.to(dev).eval()
    give_surface_(dec, torch.zeros(specs["CodeLength"]))
    return dec, net


def check_k1(decoder, latent, n_points, seed, dev, label="flagship"):
    """K1 against its plain version at the decoder's width, in bf16 (the
    wgmma route) and float32 (the f32 route), on ``n_points`` uniform points
    (timed) and on the serving path's first corner lattice; a bf16
    LayerNorm decoder also within ``LN_REF``. On each spec the decoder's
    products alone by torch.matmul (``k1_products``). Returns the
    per-dtype results."""
    import torch

    from msd_tpu_torch import mesh
    from msd_tpu_torch.ops.fused_mlp import FusedDecoderSpec, fused_eval

    g = torch.Generator(device=dev).manual_seed(seed)
    xyz = torch.rand(n_points, 3, generator=g, device=dev) * 2 - 1
    n_mesh = mesh._snap_n(256)
    corners = torch.as_tensor(mesh.corner_lattice(n_mesh, mesh.SPARSE_BLOCK), device=dev)
    flops = 2.0 * kernel_weights(decoder) * n_points
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        spec = FusedDecoderSpec(decoder, dtype)
        ln = any(spec.ln) and dtype == torch.bfloat16
        tol = TOL_LN if ln else TOL[name]
        r = {"decoder": label, "dtype": name, "route": spec.route, "tol": tol,
             **k1_errors(spec, latent, xyz, tol, f"{label} {name} uniform")}
        r[f"corner_lattice_{n_mesh}"] = k1_errors(spec, latent, corners, tol, f"{label} {name} corner lattice")
        if ln:
            k1_ln_ref(r, f"{label} {name}")
        r.update(k1_timing(spec, decoder, latent, xyz, flops, reps=10, plain_reps=5))
        r["ms_again"] = time_ms(lambda: fused_eval(spec, latent, xyz))
        phase("k1", **r)
        results[name] = r
    return results


def k1_ln_ref(r, label):
    """A bf16 LayerNorm decoder's errors against ``LN_REF``."""
    if r["max_abs_err"] > LN_REF["max"] or r["mean_abs_err"] > LN_REF["mean"]:
        raise AssertionError(f"K1 {label}: max {r['max_abs_err']} or mean {r['mean_abs_err']} abs err past "
                             f"1.5 times the first kernel's ({LN_REF})")
    r["ln_ref"] = LN_REF


def k1_timing(spec, decoder, latent, xyz, flops, reps, plain_reps):
    """The kernel's and the plain version's ms, the bound (operations or
    bytes), achieved TFLOP/s and the products alone by torch.matmul."""
    from msd_tpu_torch.ops.fused_mlp import fused_eval, fused_eval_plain

    name = str(spec.dtype).split(".")[-1]
    w_bytes = sum(t.numel() * t.element_size() for t in spec.wp + spec.wx if t is not None)
    t_flops = flops / PEAK_FLOPS[name] * 1e3
    t_bytes = (xyz.shape[0] * 16 + w_bytes) / HBM_BYTES_PER_S * 1e3
    r = {
        "ms": time_ms(lambda: fused_eval(spec, latent, xyz), reps=reps, warmup=1),
        "plain_ms": time_ms(lambda: fused_eval_plain(spec, latent, xyz), reps=plain_reps, warmup=1),
        "bound_ms": max(t_flops, t_bytes), "bound_by": "operations" if t_flops >= t_bytes else "bytes",
        "flop": flops,
    }
    r["tflops"] = flops / (r["ms"] * 1e-3) / 1e12
    r.update(k1_products(decoder, spec, xyz.shape[0], xyz.device))
    return r


def k1_products(decoder, spec, n_points, dev):
    """torch.matmul of each of the kernel's products alone (layers 1 to the
    one before the last: the previous layer's output by this one's) over
    ``n_points`` rows in the spec's operand type, float32 with TF32 off,
    summed over the layers: a reference for the products, with no epilogue
    and no layer chain. ``matmul_ref_ms`` times each product at the depth
    and width the kernel computes (the spec's padded ``in_pad`` by
    ``out_pad``: multiples of 256 in bf16, of 64 in float32), where cuBLAS
    takes its aligned paths; ``matmul_true_ms`` at the true widths, where an
    odd depth (the flagship's 253, ``WIDE_NET``'s 765) can put cuBLAS on a
    slow path."""
    def shapes_of(pairs):
        out = {}
        for k, n in pairs:
            out[(k, n)] = out.get((k, n), 0) + 1
        return out

    padded = shapes_of(w.shape[::-1] for w in spec.wp[1:-1])
    true = shapes_of(
        (in_dim - (decoder.latent_size + 3 if layer in decoder.latent_in else 0), out_dim)
        for layer, (in_dim, out_dim, _, _) in enumerate(decoder.layer_shapes[:-1]) if layer)
    ref, ref_shapes = _matmul_ms(padded, spec.dtype, n_points, dev)
    true_ms, true_shapes = _matmul_ms(true, spec.dtype, n_points, dev)
    return {"matmul_ref_ms": ref, "matmul_shapes": ref_shapes, "matmul_true_ms": true_ms,
            "matmul_true_shapes": true_shapes,
            "matmul_note": "torch.matmul of each kernel product alone over the same points and operand type "
                           "(TF32 off), summed; no epilogue, no layer chain; ref at the kernel's padded depth "
                           "and width, true at the decoder's widths"}


def _matmul_ms(shapes, dtype, n_points, dev):
    """(summed ms, per shape) of [n_points, k] @ [k, n] for each (k, n)
    of ``shapes``, times its count of layers, TF32 off."""
    import torch

    g = torch.Generator(device=dev).manual_seed(7)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    total, per_shape = 0.0, {}
    try:
        for (k, n), count in shapes.items():
            a = torch.randn(n_points, k, generator=g, device=dev).to(dtype)
            b = torch.randn(k, n, generator=g, device=dev).to(dtype)
            ms = time_ms(lambda: a @ b, reps=5, warmup=1)
            per_shape[f"{k}x{n}"] = {"ms": ms, "layers": count}
            total += ms * count
            del a, b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return total, per_shape


# Decoders wider than 512, which no shipped config is: WIDE_NET
# (tests/test_torch_cuda.py's "wide"), WIDE_LN_NET ("wide_layer_norm", its
# LayerNorm scale and bias seeded as ln_decoder's), and the widest shapes
# the 10 MB weight cap admits at latent 256, each in the operand type that
# admits it
WIDE_NET = dict(dims=[1024, 1024, 512], latent_in=[1], weight_norm=False, norm_layers=[])
WIDE_LN_NET = dict(dims=[1000, 700], latent_in=[], weight_norm=False, norm_layers=[0, 1])
WIDE_CAP_NETS = {
    "dims_2048x2_bf16": (dict(dims=[2048, 2048], latent_in=[], weight_norm=False, norm_layers=[]), "bfloat16"),
    "dims_1408x2_f32": (dict(dims=[1408, 1408], latent_in=[], weight_norm=False, norm_layers=[]), "float32"),
    "dims_16384_bf16": (dict(dims=[16384], latent_in=[], weight_norm=False, norm_layers=[]), "bfloat16"),
}


def wide_decoder(latent_size, net, seed, dev):
    """A seeded decoder of ``net``, LayerNorm scale in [0.5, 1.5] and bias
    in +-0.1 where it has LayerNorm, then give_surface_."""
    import torch

    from msd_tpu_torch.models.deepsdf import DeepSDFDecoder, give_surface_

    g = torch.Generator().manual_seed(seed)
    dec = DeepSDFDecoder(latent_size, generator=g, **net)
    with torch.no_grad():
        for layer in net["norm_layers"]:
            bn = getattr(dec, f"bn{layer}")
            bn.weight.copy_(0.5 + torch.rand(bn.weight.shape, generator=g))
            bn.bias.copy_(0.2 * torch.rand(bn.bias.shape, generator=g) - 0.1)
    dec = dec.to(dev).eval()
    give_surface_(dec, torch.zeros(latent_size))
    return dec


def routed(fn, route):
    """``fn()`` with K1's launches counted by route around it; raises
    unless every launch took ``route``. Returns (result, launches)."""
    from msd_tpu_torch.ops import fused_mlp

    fused_mlp.ROUTE_LAUNCHES = dict.fromkeys(fused_mlp.ROUTES, 0)
    out = fn()
    routes = dict(fused_mlp.ROUTE_LAUNCHES)
    if routes[route] == 0 or any(v for k, v in routes.items() if k != route):
        raise AssertionError(f"K1 launches by route {routes}: not all on {route}")
    return out, routes[route]


def check_k1_wide(latent_size, n_points, seed, dev):
    """The wide kernels (hidden widths over 512): ``WIDE_NET`` and
    ``WIDE_LN_NET`` in bf16 (wgmma route) and float32 (f32 route) against
    their plain versions on ``n_points`` uniform points (TOL; a bf16
    LayerNorm decoder TOL_LN and LN_REF), timed beside their bounds and
    their products by torch.matmul; the ``WIDE_CAP_NETS`` on 2^16 + 37
    points; then ``create_mesh`` at N=129 of each wide decoder in each type
    with K1's launches by route (the kernels line's launches)."""
    import torch

    from msd_tpu_torch import mesh
    from msd_tpu_torch.ops.fused_mlp import FusedDecoderSpec, fused_eval

    g = torch.Generator(device=dev).manual_seed(seed)
    xyz = torch.rand(n_points, 3, generator=g, device=dev) * 2 - 1
    latent = 0.01 * torch.randn(latent_size, generator=g, device=dev)
    out = {"nets": {"wide": WIDE_NET, "wide_ln": WIDE_LN_NET}}
    decs = {"wide": wide_decoder(latent_size, WIDE_NET, seed + 30, dev),
            "wide_ln": wide_decoder(latent_size, WIDE_LN_NET, seed + 31, dev)}
    for label, dec in decs.items():
        flops = 2.0 * kernel_weights(dec) * n_points
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            spec = FusedDecoderSpec(dec, dtype)
            route = "wgmma_wide" if dtype == torch.bfloat16 else "f32_wide"
            if spec.route != route:
                raise AssertionError(f"K1 {label} {name}: route {spec.route}, not {route}")
            ln = any(spec.ln) and dtype == torch.bfloat16
            tol = TOL_LN if ln else TOL[name]
            r, launches = routed(lambda: k1_errors(spec, latent, xyz, tol, f"{label} {name} uniform"), route)
            r.update(route=route, launches=launches, tol=tol)
            if ln:
                k1_ln_ref(r, f"{label} {name}")
            r.update(k1_timing(spec, dec, latent, xyz, flops, reps=5, plain_reps=3))
            out[f"{label}_{name}"] = r
    small = xyz[:2**16 + 37]
    for label, (net, name) in WIDE_CAP_NETS.items():
        dtype = getattr(torch, name)
        dec = wide_decoder(latent_size, net, seed + 32, dev)
        spec = FusedDecoderSpec(dec, dtype)
        route = "wgmma_wide" if dtype == torch.bfloat16 else "f32_wide"
        r, launches = routed(lambda: k1_errors(spec, latent, small, TOL[name], f"{label} uniform"), route)
        r.update(net=net, route=route, launches=launches,
                 ms=time_ms(lambda: fused_eval(spec, latent, small), reps=3, warmup=1))
        out[label] = r
        del dec, spec
    meshes = {}
    for label, dec in decs.items():
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            route = "wgmma_wide" if dtype == torch.bfloat16 else "f32_wide"
            t0 = time.perf_counter()
            res, launches = routed(lambda: mesh.create_mesh(dec, latent, N=129, return_mesh=True,
                                                             eval_dtype=dtype), route)
            if res is False or not np.isfinite(np.asarray(res[0])).all():
                raise AssertionError(f"K1 {label} {name}: create_mesh gave no finite surface")
            verts, faces = res[:2]
            meshes[f"{label}_{name}"] = {"N": 129, "seconds": time.perf_counter() - t0, "launches": launches,
                                         "verts": int(verts.shape[0]), "faces": int(faces.shape[0])}
    out["create_mesh"] = meshes
    return out


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


def autograd_grads(decoder, weights, biases, lat, xyz, gt, clamp, use_eikonal, num_total, eik_points=None):
    """(dweights, dbiases, dlat, sdf, eikonal) of the Stage-1 point losses
    by float32 autograd, written out as the trainer's autograd path computes
    them: the float32 oracle K2 is held against. ``eik_points`` E: the
    eikonal over the first E points of each scene only."""
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
        if eik_points is not None:  # a point's prediction depends on its own xyz only
            gx = gx.reshape(xyz.shape)[:, :eik_points].reshape(-1, 3)
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


def step_flops(decoder, n_points, variant, eik_share=1.0):
    """Floating-point operations of K2 ``variant`` ("b", "a", "c" or "d")
    on ``n_points``: 2 per multiply-add of the per-point products (the
    latent's share is per scene and not counted): 18.9, 9.44 and 6.29
    MFLOP per point at the flagship width. Variant c runs a's sweeps over
    every point and the eikonal's three (u-chain, t-chain, their weight
    gradients) over the gated share ``eik_share`` of them."""
    from msd_tpu_torch.ops.fused_train import layer_plan

    plan = layer_plan(decoder)
    per_point = 0
    for layer in range(plan.nl):
        k = (plan.prev[layer] or 0) + (3 if plan.kinds[layer] != "plain" else 0)
        per_point += k * plan.out[layer]
    sweeps = K2_SWEEPS["a"] * (1 + eik_share) if variant == "c" else K2_SWEEPS[variant]
    return 2.0 * per_point * n_points * sweeps


def design_bytes(decoder, n_points, variant, eik_share=1.0):
    """Bytes K2's design moves through device memory for ``n_points``
    (activations only; weights and per-scene terms are small): each bf16
    chain activation, its width padded to WIDTH_PAD, is written once and
    read by the next product, the masks and the weight gradients. The last
    hidden layer's rank-one seed rows (u with an eikonal, over the gated
    share; delta without) come from last_kernel, which reads that layer's h
    anyway: their mask read is not counted."""
    from msd_tpu_torch.ops.fused_train import WIDTH_PAD, layer_plan

    plan = layer_plan(decoder)
    widths = [-(-o // WIDTH_PAD) * WIDTH_PAD * 2 for o in plan.out[:-1]]
    hidden = sum(widths)
    fused = widths[-1] * (eik_share if variant == "c" else 1.0)
    if variant == "b":
        # h: 1 write + 5 reads (next product, u mask, t mask, delta mask,
        # wgrad); u, t, delta: 1 write + 2 reads each
        per_point = hidden * (6 + 3 * 3)
    elif variant == "a":
        # h: 1 write + 3 reads; delta: 1 write + 2 reads
        per_point = hidden * (4 + 3)
    elif variant == "c":
        # a's, and over the gated share: h read twice more (u and t masks),
        # u and t 1 write + 2 reads each
        per_point = hidden * (7 + 8 * eik_share)
    else:
        # h: 1 write + 2 reads (next product, delta mask); delta: 1 write +
        # 1 read, except the layer-0 delta, which is not stored
        per_point = hidden * 3 + (hidden - widths[0]) * 2
    return float(per_point - fused + 64) * n_points


def check_chain_launches(per_step, decoder, B, P, variant):
    """Raise unless ``per_step["chain_kernel"]`` (KERNEL_LAUNCHES per step)
    is one K2 call's chain_kernel launches for ``variant`` over B scenes of
    P points: per chunk of whole scenes the primal's H (hidden layers),
    with an eikonal (b, c) the u-chain's H - 1, the t-chain's H and the
    delta chain's H, without (a, d) the delta chain's H - 1: last_kernel
    writes the last hidden layer's u, or without an eikonal its delta."""
    from msd_tpu_torch.ops.fused_train import CHUNK_POINTS, layer_plan

    H = layer_plan(decoder).nl - 1
    chunks = -(-B // max(1, CHUNK_POINTS // P))
    want = (4 * H - 1 if variant in "bc" else 2 * H - 1) * chunks
    if per_step["chain_kernel"] != want:
        raise AssertionError(f"chain_kernel launches per K2 {variant} step {per_step['chain_kernel']}, want {want}")


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
        if name == "b":
            from msd_tpu_torch.ops import _build

            r["gemm_kernels"] = gemm_report(_build.BUILD_LOGS.get("fused_train", ""))
        phase("k2", **r)
        results[name] = r
    return results


# msd_ft_dynamic_smem's kernel ids
SMEM_IDS = {"chain_kernel": 0, "wgrad_kernel": 1, "eik_kernel": 2, "skinny_kernel": 3, "last_kernel": 4}


def gemm_report(log, kernels=("chain_kernel", "wgrad_kernel", "eik_kernel", "skinny_kernel")):
    """Registers, spills and ptxas warnings of each named kernel, from
    nvcc's ``-Xptxas -v`` log, with its dynamic shared memory (eik_kernel's
    at the flagship's two 512-wide u operands, last_kernel's at the
    flagship's 512-wide h without an eikonal)."""
    from msd_tpu_torch.ops._build import load_library

    lib = load_library("fused_train")
    out, cur = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = next((k for k in kernels if k in ln), None)
            if cur:
                width = 512 if cur == "last_kernel" else 1024
                out[cur] = {"ptxas": [], "dynamic_smem_bytes": lib.msd_ft_dynamic_smem(SMEM_IDS.get(cur, -1), width)}
        elif cur and ("registers" in ln or "spill" in ln or "arning" in ln):
            out[cur]["ptxas"].append(ln.strip())
    return out


# The GEMM kernels on their own against float32 products of the same bf16
# operands: the chain's bf16 output within its rounding (half an ulp, plus
# the summation order), column sums and weight gradients within 1e-5
# relative (float32 sums in two orders).
K2GEMM_TOL = {"out": 1.0, "colsum": 1e-5, "wgrad": 1e-5}


def check_k2gemm(seed, dev, n=65536, W=512, P=16384):
    """K2's two GEMM kernels at the flagship step's shapes, one launch each:
    a masked 512 x 512 chain product over a 65536-point chunk with column
    sums (the delta chain's), a primal product (ReLU, per-scene constants),
    the same product with its epilogue cut to a plain store (ReLU only: the
    TMA-fed wgmma ceiling of this design), and a variant-b weight-gradient
    launch (two 65536-point pairs). Each is held against a float32 torch
    product on the card (TF32 off), timed on the device (device_only) beside
    its operations and bytes bounds and, as ``library_ms``, torch.matmul of
    the same bf16 product (a yardstick timed only here). Then the two K = 0
    launches that last_kernel's rank-one rows replace on the main path (the
    u-chain's first at b, the delta chain's first at d), timed beside their
    bytes bound, for the record (no PyTorch call computes them)."""
    import torch

    from msd_tpu_torch.ops._build import load_library
    from msd_tpu_torch.ops.fused_train import wgrad_split

    lib = load_library("fused_train")
    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16

    def ptr(t):
        return None if t is None else t.data_ptr()

    def bounds(flop, nbytes):
        t_ops, t_bytes = flop / PEAK_FLOPS["bfloat16"] * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        return {"flop": flop, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes"}

    A = torch.relu(torch.randn(n, W, generator=g, device=dev)).to(bf)
    B = (torch.randn(W, W, generator=g, device=dev) / W**0.5).to(bf)
    mask = torch.randn(n, W, generator=g, device=dev).to(bf)
    cvec = 0.1 * torch.randn(n // P, W, generator=g, device=dev)
    out = torch.empty(n, W, dtype=bf, device=dev)
    colsum = torch.empty(n // 64, W, device=dev)
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    results = {}
    try:
        product = A.float() @ B.float().t()
        # name: (per-scene constants, D mask, column sums); no mask means ReLU
        for name, (cv, mk, cs) in {"chain_masked": (None, mask, colsum), "chain_primal": (cvec, None, None),
                                   "chain_store": (None, None, None)}.items():

            def launch(cv=cv, mk=mk, cs=cs):
                rc = lib.msd_ft_chain(ptr(A), ptr(B), n, W, W, None, None, ptr(cv), P, 0, int(mk is None), ptr(mk),
                                      ptr(out), ptr(cs), stream)
                if rc:
                    raise RuntimeError(f"chain_kernel: {lib.msd_ft_error_string(rc).decode()}")

            launch()
            torch.cuda.synchronize()
            v = product + cv.repeat_interleave(P, 0) if cv is not None else product
            v = torch.relu(v) if mk is None else v * (mk.float() > 0)
            err = {"out": float(((out.float() - v).abs() / (2**-8 * v.abs() + 1e-5 * v.abs().max())).max())}
            if cs is not None:
                ref_cs = v.reshape(n // 64, 64, W).sum(1)
                err["colsum"] = float((cs - ref_cs).abs().max() / ref_cs.abs().max())
            if any(err[k] > K2GEMM_TOL[k] for k in err):
                raise AssertionError(f"K2 {name} vs float32: {err}")
            nbytes = 2.0 * (n * W + W * W + n * W) + sum(4.0 * t.numel() for t in (cv, cs) if t is not None) \
                + (2.0 * mk.numel() if mk is not None else 0)
            results[name] = {"n": n, "N": W, "K": W, "errors": err, "ms": time_ms(launch, device_only=True),
                             "library_ms": time_ms(lambda: torch.matmul(A, B.t()), device_only=True),
                             **bounds(2.0 * n * W * W, nbytes)}
        del product, v
        # the K = 0 launches that last_kernel's rank-one rows replace, for the
        # record: "u last" at b (every point gated) and "delta last" at d,
        # with its column sums; one exact float32 product per entry
        xv, wx = torch.zeros(n, 4, device=dev), torch.zeros(W, 4, device=dev)
        xv[:, 0] = (1e-3 * torch.randn(n, generator=g, device=dev)).to(bf).float()
        wx[:, 0] = (0.02 * torch.randn(W, generator=g, device=dev)).to(bf).float()
        v = torch.where(mask.float() > 0, xv[:, :1] * wx[None, :, 0] + 0.0, 0.0)
        for name, cs in (("chain_u_last_K0", None), ("chain_delta_last_K0", colsum)):

            def launch(cs=cs):
                rc = lib.msd_ft_chain(None, None, n, W, 0, ptr(xv), ptr(wx), None, P, 0, 0, ptr(mask), ptr(out),
                                      ptr(cs), stream)
                if rc:
                    raise RuntimeError(f"chain_kernel: {lib.msd_ft_error_string(rc).decode()}")

            launch()
            torch.cuda.synchronize()
            err = {"out_equal": torch.equal(out.float(), v.to(bf).float())}
            if cs is not None:
                ref_cs = v.reshape(n // 64, 64, W).sum(1)
                err["colsum"] = float((cs - ref_cs).abs().max() / ref_cs.abs().max())
            if not err["out_equal"] or err.get("colsum", 0.0) > K2GEMM_TOL["colsum"]:
                raise AssertionError(f"K2 {name} vs float32: {err}")
            nbytes = 2.0 * n * W + 16.0 * n + 16.0 * W + 2.0 * n * W + (4.0 * n // 64 * W if cs is not None else 0)
            results[name] = {"n": n, "N": W, "K": 0, "errors": err, "ms": time_ms(launch, device_only=True),
                             "library_ms": None, **bounds(1.0 * n * W, nbytes)}
        del xv, wx, v
        del mask, out, colsum
        pairs = [(A, torch.randn(n, W, generator=g, device=dev).to(bf)),
                 ((torch.randn(n, W, generator=g, device=dev) * 1e-2).to(bf),
                  torch.randn(n, W, generator=g, device=dev).to(bf))]
        nsplit = wgrad_split(W, W, 2 * n // 64, torch.cuda.get_device_properties(dev).multi_processor_count)
        part = torch.empty(nsplit, W, W, device=dev)

        def wgrad():
            rc = lib.msd_ft_wgrad(ptr(pairs[0][0]), ptr(pairs[0][1]), n, ptr(pairs[1][0]), ptr(pairs[1][1]), n,
                                  W, W, nsplit, ptr(part), stream)
            if rc:
                raise RuntimeError(f"wgrad_kernel: {lib.msd_ft_error_string(rc).decode()}")

        wgrad()
        torch.cuda.synchronize()
        ref = sum(a.float().t() @ b.float() for a, b in pairs)
        rel = float((part.sum(0) - ref).norm() / ref.norm())
        if not rel <= K2GEMM_TOL["wgrad"]:
            raise AssertionError(f"K2 wgrad vs float32: {rel}")
        Acat, Bcat = torch.cat([a for a, _ in pairs]), torch.cat([b for _, b in pairs])
        results["wgrad_b"] = {"n": [n, n], "M": W, "N": W, "nsplit": nsplit, "errors": {"rel_frobenius": rel},
                              "ms": time_ms(wgrad, device_only=True),
                              "library_ms": time_ms(lambda: torch.matmul(Acat.t(), Bcat), device_only=True),
                              **bounds(2.0 * 2 * n * W * W, 2.0 * 4 * n * W + 4.0 * W * W)}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    for r in results.values():
        r["tflops"] = r["flop"] / (r["ms"] * 1e-3) / 1e12
    phase("k2gemm", **results,
          library_note="torch.matmul of the same bf16 operands (bf16 out; for wgrad over the two pairs "
                       "concatenated, without the mask, constants or column sums): a yardstick, not called by the port")
    return results


# K2's per-point kernels on their own against their plain versions (float32
# of the same operands on the card): last_kernel's (y, m tau, seed) and its
# L1 tile sums within 1e-5 of their largest (float32 in two orders), its
# rank-one rows equal to last_rank1_plain's on the kernel's own xv (one
# exact float32 product each) and their column sums within 1e-5;
# eik_kernel's gb and sb within half a bf16 ulp plus the order of g's sum
# (bf16 units, as the chain's output) and its tile sums within 1e-5 of their
# largest; skinny_kernel's sums within 1e-5 relative Frobenius.
K2PT_TOL = {"rel_max": 1e-5, "bf16_units": 1.0, "skinny": 1e-5}


def check_k2pt(seed, dev, n=65536, W=512, P=16384):
    """K2's three per-point kernels alone at the flagship chunk's shapes, b
    (every point gated), c (the first 4096 of each scene's 16384) and, for
    last_kernel, d (none gated): one launch of last_kernel over the chunk's
    65536 points (h 512 wide) with its rank-one rows (u of the gated rows,
    or at d delta of every row and its column sums), eik_kernel over the
    gated rows (u0 and uL 512 wide, the latent_in layer's) on last_kernel's
    outputs, and skinny_kernel's dMx_0 sums (delta^T x over the points plus
    u0^T gbar over the gated rows). Each is held against its plain version
    on the card, timed on the device (device_only) beside its bytes and
    operations bounds and its plain version; skinny_kernel also beside
    torch.matmul of the two pairs concatenated with V in bf16
    (``library_ms``, a yardstick not called by the port). Each kernel runs
    twice for equal bits."""
    import torch

    from msd_tpu_torch.ops import _build
    from msd_tpu_torch.ops import fused_train as ft

    lib = _build.load_library("fused_train")
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16

    def ptr(t):
        return None if t is None else t.data_ptr()

    def ok(rc, what):
        if rc:
            raise RuntimeError(f"{what}: {lib.msd_ft_error_string(rc).decode()}")

    def rel_max(got, ref):
        return float((got - ref).abs().max() / ref.abs().max().clamp(min=1e-30))

    def units(got, v):  # as tests/test_torch_cuda.py:_bf16_units: half a bf16 ulp is at most 1
        return float(((got - v).abs() / (2**-8 * v.abs() + 1e-5 * v.abs().max())).max())

    def bounds(flop, nbytes):
        t_ops, t_bytes = flop / PEAK_FLOPS["float32"] * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        return {"flop": flop, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes"}

    def vec4(rows, scale):
        v = torch.zeros(rows, 4, device=dev)
        v[:, :3] = (scale * torch.randn(rows, 3, generator=g, device=dev)).to(bf).float()
        return v

    S = n // P
    h = torch.relu(torch.randn(n, W, generator=g, device=dev)).to(bf)
    wl = (0.02 * torch.randn(W, generator=g, device=dev)).to(bf)
    clast = 0.05 * torch.randn(S, generator=g, device=dev)
    gt = (0.25 * torch.randn(n, generator=g, device=dev)).clamp(-0.1, 0.1)
    d = (1e-3 * torch.randn(n, W, generator=g, device=dev)).to(bf)
    X = vec4(n, 0.5)
    mx0, mxL = vec4(W, 0.6), vec4(W, 0.6)
    ticket = torch.zeros(W // ft.SKINNY_COLS, dtype=torch.int32, device=dev)
    results = {"last_kernel": {}, "eik_kernel": {}, "skinny_kernel": {}}
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for shape, E in (("b", P), ("c", 4096), ("d", 0)):
            ne = S * E
            rows = torch.arange(ne, device=dev)
            points = rows // E * P + rows % E if E else rows
            gated_tiles = points[::128] // 128
            others = torch.ones(n // 128, dtype=torch.bool, device=dev)
            others[gated_tiles] = False
            pt, sb = torch.empty(n, 4, device=dev), torch.empty(n, 4, device=dev)
            mtc, gb = (torch.empty(ne, 4, device=dev), torch.empty(ne, 4, device=dev)) if E else (None, None)
            loss = torch.zeros(n // 128, 4, device=dev)
            # the rank-one rows: u of the gated rows, or (d) delta of every row and its column sums
            out = torch.empty(ne or n, W, dtype=bf, device=dev)
            colsum = None if E else torch.empty(n // 64, W, device=dev)

            def last(out=out, colsum=colsum):
                ok(lib.msd_ft_last(ptr(h), ptr(wl), W, ptr(clast), ptr(gt), None, n, P, E, 0.1, 1.0 / n, ptr(pt),
                                   ptr(mtc), ptr(sb), ptr(loss), ptr(out), ptr(colsum), stream), "last_kernel")

            last()
            torch.cuda.synchronize()
            first = [t.clone() for t in (pt, mtc, sb, loss, out, colsum) if t is not None]
            y, mt, l1_seed, l1 = ft.last_plain(h, wl, clast.repeat_interleave(P), gt, 0.1, 1.0 / n)
            err = {"y": rel_max(pt[:, 0], y), "m_tau": rel_max(pt[:, 1], mt), "seed": rel_max(pt[:, 2], l1_seed),
                   "l1_tiles": rel_max(loss[:, 0], l1.reshape(-1, 128).sum(1))}
            h_out, xv = (h[points], mtc[:, 0]) if E else (h, sb[:, 0])
            ref_out, ref_cs = ft.last_rank1_plain(h_out, wl, xv)
            if E:
                err["mtc_bf16_units"] = units(mtc[:, 0], mt[points])
            else:
                err["sb_bf16_units"] = units(sb[:, 0], l1_seed)
                err["colsum"] = rel_max(colsum, ref_cs)
            if bool(others.any()):
                err["seed_tiles"] = rel_max(loss[others, 2], l1_seed.reshape(-1, 128)[others].sum(1))
            err["rank1_equal"] = torch.equal(out.float(), ref_out)
            last()
            torch.cuda.synchronize()
            err["same_bits"] = all(torch.equal(a.view(torch.uint8), b.view(torch.uint8)) for a, b in
                                   zip(first, [t for t in (pt, mtc, sb, loss, out, colsum) if t is not None]))
            if max(v for k, v in err.items() if not k.endswith(("units", "equal", "bits"))) > K2PT_TOL["rel_max"] \
                    or max(v for k, v in err.items() if k.endswith("units")) > K2PT_TOL["bf16_units"] \
                    or not (err["rank1_equal"] and err["same_bits"]):
                raise AssertionError(f"last_kernel vs plain at {shape}: {err}")
            # without the rank-one rows (d: with and without their column
            # sums, as for a decoder of one hidden layer): the same other
            # outputs, bit for bit
            saved = [t.clone() for t in (pt, mtc, sb, loss, colsum) if t is not None]
            for cs in (None, colsum) if colsum is not None else (None,):
                if cs is not None:
                    cs.fill_(float("nan"))
                last(out=None, colsum=cs)
                torch.cuda.synchronize()
                err["without_rows_same_bits"] = err.get("without_rows_same_bits", True) and all(
                    torch.equal(a.view(torch.uint8), b.view(torch.uint8)) for a, b in
                    zip(saved, [t for t in (pt, mtc, sb, loss, cs) if t is not None]))
            if not err["without_rows_same_bits"]:
                raise AssertionError(f"last_kernel without its rank-one rows at {shape}: {err}")
            c_pt = clast.repeat_interleave(P)
            results["last_kernel"][shape] = {
                "rows": n, "rank1_rows": ne or n, "errors": err, "ms": time_ms(last, device_only=True),
                # the row streamer alone (no rank-one rows, no column sums): the
                # design before the rank-one rows were fused
                "rows_only_ms": time_ms(lambda: last(out=None, colsum=None), device_only=True),
                "plain_ms": time_ms(lambda: (ft.last_plain(h, wl, c_pt, gt, 0.1, 1.0 / n),
                                             ft.last_rank1_plain(h_out, wl, xv)), device_only=True),
                "library_ms": None,
                # h, w_last, the per-scene constants and gt read; pt, mtc or sb, the tile sums, the
                # rank-one rows and (d) their column sums written
                **bounds(2.0 * n * W + 2.0 * (ne or n) * W,
                         2.0 * n * W + 2.0 * W + 4.0 * S + 4.0 * n + 16.0 * (2 * n) + 8.0 * n / 128
                         + 2.0 * (ne or n) * W + (0 if E else 4.0 * n // 64 * W))}
            del out, colsum, ref_out, ref_cs, h_out, xv, first, saved
            if not E:
                continue  # no gated rows: no eikonal lane, no u^T gbar pair
            eik_coef = 2.0 * 0.002 / (32 * E)  # the flagship step's normaliser

            u0 = (0.05 * torch.randn(ne, W, generator=g, device=dev)).to(bf)
            uL = (0.05 * torch.randn(ne, W, generator=g, device=dev)).to(bf)

            def eik():
                ok(lib.msd_ft_eik(ptr(u0), ptr(mx0), W, ptr(uL), ptr(mxL), W, ptr(pt), None, ne, P, E, eik_coef,
                                  ptr(gb), ptr(sb), ptr(loss), stream), "eik_kernel")

            eik()
            torch.cuda.synchronize()
            first = (gb.clone(), sb.clone(), loss.clone())
            gbar, sbar, lane = ft.eik_plain(u0, mx0, uL, mxL, pt[points, 0], pt[points, 2], eik_coef)
            err = {"gb_bf16_units": units(gb[:, :3], gbar), "sb_bf16_units": units(sb[points, 0], sbar),
                   "eik_tiles": rel_max(loss[gated_tiles, 1], lane.reshape(-1, 128).sum(1)),
                   "sbar_tiles": rel_max(loss[gated_tiles, 2], sbar.reshape(-1, 128).sum(1))}
            eik()
            torch.cuda.synchronize()
            err["same_bits"] = all(torch.equal(a, b) for a, b in zip(first, (gb, sb, loss)))
            if (max(err["gb_bf16_units"], err["sb_bf16_units"]) > K2PT_TOL["bf16_units"]
                    or max(err["eik_tiles"], err["sbar_tiles"]) > K2PT_TOL["rel_max"] or not err["same_bits"]):
                raise AssertionError(f"eik_kernel vs plain at {shape}: {err}")
            y_g, s_g = pt[points, 0].contiguous(), pt[points, 2].contiguous()
            results["eik_kernel"][shape] = {
                "rows": ne, "errors": err, "ms": time_ms(eik, device_only=True),
                "plain_ms": time_ms(lambda: ft.eik_plain(u0, mx0, uL, mxL, y_g, s_g, eik_coef), device_only=True),
                "library_ms": None,
                **bounds(2.0 * ne * 2 * W * 3, 2.0 * ne * 2 * W + 2 * 16.0 * W + 3 * 16.0 * ne + 8.0 * ne / 128)}

            acc = torch.zeros(W, 4, device=dev)

            def skinny():
                ft.skinny_cuda(d, X, u0, gb, acc, ticket, sms, lib, stream)

            skinny()
            torch.cuda.synchronize()
            got = acc.clone()
            acc.zero_()
            skinny()
            torch.cuda.synchronize()
            ref = ft.skinny_plain(d, X[:, :3], u0, gb[:, :3])
            err = {"rel_frobenius": float((got[:, :3] - ref).norm() / ref.norm()), "same_bits": torch.equal(got, acc),
                   "ticket_zero": int(ticket.abs().sum()) == 0}
            if not (err["rel_frobenius"] <= K2PT_TOL["skinny"] and err["same_bits"] and err["ticket_zero"]):
                raise AssertionError(f"skinny_kernel vs plain at {shape}: {err}")
            A_cat, V_cat = torch.cat([d, u0]), torch.cat([X, gb]).to(bf)
            X3, gb3 = X[:, :3].contiguous(), gb[:, :3].contiguous()
            rows_all = n + ne
            results["skinny_kernel"][shape] = {
                "rows": [n, ne], "splits": ft.skinny_split(rows_all, W, sms), "errors": err,
                "ms": time_ms(skinny, device_only=True),
                "plain_ms": time_ms(lambda: ft.skinny_plain(d, X3, u0, gb3), device_only=True),
                "library_ms": time_ms(lambda: torch.matmul(A_cat.t(), V_cat), device_only=True),
                **bounds(2.0 * rows_all * W * 3, rows_all * (2.0 * W + 16.0) + 2 * 16.0 * W)}
            del u0, uL, A_cat, V_cat
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    for per_shape in results.values():
        for r in per_shape.values():
            r["share_of_bound"] = r["bound_ms"] / r["ms"]
    phase("k2pt", **results, kernels=gemm_report(_build.BUILD_LOGS.get("fused_train", ""),
                                                 ("last_kernel", "eik_kernel", "skinny_kernel")),
          bytes_note="each input read once, each output written once (skinny: its [W][4] accumulator read and "
                     "written; its per-block partials are scratch and not counted)",
          library_note="skinny_kernel: torch.matmul of the two pairs concatenated, V cast to bf16 (a yardstick, "
                       "not called by the port); no single PyTorch call computes last_kernel's or eik_kernel's "
                       "outputs")
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


def fit_inputs(latent_size, S, n, seed, dev):
    """(latent [S, 1, L], batch [S, n, 4]): seeded latents near 0 and n
    rows of each of S seeded ellipsoids, half positive, half negative."""
    import torch

    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(S):
        pos, neg, _ = ellipsoid_samples(rng.uniform(0.35, 0.75, 3), n, rng)
        rows.append(np.concatenate([pos[: n // 2], neg[: n - n // 2]]))
    latent = torch.tensor(0.01 * rng.standard_normal((S, 1, latent_size)), dtype=torch.float32, device=dev)
    return latent, torch.tensor(np.stack(rows), device=dev)


def fit_product_flops(decoder, points):
    """Operations of the fit's per-point products (forward and backward of
    every hidden layer past the first, at the true widths) over ``points``."""
    outs = [o for _, o, _, _ in decoder.layer_shapes]
    return 4.0 * points * sum(outs[l - 1] * outs[l] for l in range(1, len(outs) - 1))


def autograd_fit_grads(decoder, latent, batch, clamp):
    """(per-shape loss, latent gradient) of the fit's autograd route."""
    import torch

    from msd_tpu_torch.train import reconstruct

    lat = latent.detach().requires_grad_(True)
    loss = reconstruct.autograd_l1(decoder, lat, batch, clamp)
    return loss.detach(), torch.autograd.grad(loss.sum(), lat)[0]


def check_fit(decoder, seed, dev, n=8000, reps=20):
    """The fused fit (ops/fused_fit.py) against the autograd route at the
    serving fit's shapes: per-shape loss and latent gradient at 8 x n and
    1 x n, and at 8 x n / 2 (the half batch: rows padded past a tile), each
    shape's gradient alone and among 8 bit for bit; then both routes' ms per
    loss-and-gradient and per reconstruct iteration, the kernels' device
    time by name (torch.profiler), the products' TFLOP/s on the real count
    and torch.matmul of the same products (the yardstick)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from msd_tpu_torch.ops import fused_fit
    from msd_tpu_torch.train import reconstruct

    clamp = 0.1
    if fused_fit.route(decoder, torch.zeros(1, device=dev)) != "kernel":
        raise AssertionError("fused fit: the flagship decoder does not take the kernel route")
    plan = fused_fit.plan_for(decoder)

    def kernel(lat, batch):
        lat = lat.detach().requires_grad_(True)
        loss = fused_fit.fit_loss(plan, lat, batch, clamp)
        (g,) = torch.autograd.grad(loss.sum(), lat)
        return loss.detach(), g

    def autograd(lat, batch):
        return autograd_fit_grads(decoder, lat, batch, clamp)

    def plain(lat, batch):  # the plain version's arithmetic on the card
        loss, state = fused_fit.forward_plain(plan, lat.reshape(len(lat), -1), batch, clamp)
        return loss, fused_fit.backward_plain(plan, state, torch.ones_like(loss)).reshape(lat.shape)

    def errors(lat, batch):
        lk, gk = kernel(lat, batch)
        la, ga = autograd(lat, batch)
        torch.cuda.synchronize()
        return {"loss_rel": float(((lk - la).abs() / la.abs()).max()),
                "grad_rel": float(max((gk[s] - ga[s]).norm() / ga[s].norm() for s in range(len(lat)))),
                "loss": lk.tolist()}

    latent, batch = fit_inputs(decoder.latent_size, 8, n, seed + 5, dev)
    dec64 = copy.deepcopy(decoder).double()
    l64, g64 = (t.float() for t in autograd_fit_grads(dec64, latent.double(), batch.double(), clamp))
    del dec64
    fused_fit.reset_launches()
    lk, gk = kernel(latent, batch)
    la, ga = autograd(latent, batch)
    vs64 = {name: {"loss_rel": float(((l - l64).abs() / l64.abs()).max()),
                   "grad_rel": float(max((g[s] - g64[s]).norm() / g64[s].norm() for s in range(8)))}
            for name, (l, g) in (("kernel", (lk, gk)), ("autograd", (la, ga)))}
    fused_fit.reset_launches()
    r = {"points_per_shape": n, "padded_rows": fused_fit.padded_rows(n), "vs_float64": vs64,
         "errors": {"8": errors(latent, batch), "1": errors(latent[:1], batch[:1]),
                    "8_half": errors(latent, batch[:, : n // 2].contiguous())},
         "launches_per_call": {k: v / 3 for k, v in fused_fit.LAUNCHES.items()}}
    lp, gp = plain(latent, batch)
    r["vs_plain"] = {"loss_rel": float(((lk - lp).abs() / lp.abs()).max()),
                     "grad_rel": float(max((gk[s] - gp[s]).norm() / gp[s].norm() for s in range(8)))}
    # the three calls' tiles (8 x n, 1 x n, 8 x n / 2) all run as two chains
    if r["launches_per_call"] != fused_fit.iteration_launches(len(plan.wpad), 8 * r["padded_rows"] // fused_fit.TILE):
        raise AssertionError(f"fused fit: launches per call {r['launches_per_call']}")
    tol = fused_fit.FIT_TOL
    for key, e in r["errors"].items():
        if e["loss_rel"] > tol["loss_rel"] or e["grad_rel"] > tol["grad_rel"]:
            raise AssertionError(f"fused fit at {key}: {json.dumps(e)}")
    _, g8 = kernel(latent, batch)
    r["same_bits_alone_and_among_8"] = all(torch.equal(kernel(latent[s:s + 1], batch[s:s + 1])[1][0], g8[s])
                                           for s in range(8))
    if not r["same_bits_alone_and_among_8"]:
        raise AssertionError("fused fit: a shape's gradient differs alone and among 8")

    r["ms"] = time_ms(lambda: kernel(latent, batch), reps=reps)
    r["autograd_ms"] = time_ms(lambda: autograd(latent, batch), reps=reps)
    r["plain_ms"] = time_ms(lambda: plain(latent, batch), reps=5)
    cfg = reconstruct.ReconstructConfig(800, decoder.latent_size, clamp, n, 5e-3, True)
    zero = torch.zeros_like(latent)
    r["iteration_ms"] = time_ms(lambda: reconstruct.reconstruct_step(decoder, cfg, latent, zero, zero, 0, batch,
                                                                      0.0, 1.0), reps=reps)

    kernel(latent, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            kernel(latent, batch)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        name = next((k for k in fused_fit.KERNELS if k in e.key), "other")
        by_name[name] = by_name.get(name, 0.0) + us / 1e3 / 5
    r["device_ms_by_kernel"] = by_name or "not measured: the profiler recorded no device time"
    r["device_ms_note"] = "summed over both streams: the two chains' launches overlap"

    # the products alone: every fit_gemm_kernel launch of an iteration over
    # all point tiles on one stream (the kernel's own rate, no overlap)
    flops = fit_product_flops(decoder, 8 * n)
    M = 8 * fused_fit.padded_rows(n)
    H = len(plan.wpad)
    lib, stream = fused_fit._lib(), torch.cuda.current_stream(dev).cuda_stream
    acts = [torch.rand(w, M, device=dev) for w in plan.wpad]
    T = fused_fit.padded_rows(n) // fused_fit.TILE

    def products():
        rcs = [lib.msd_fit_gemm(plan.fwd[l].data_ptr(), acts[l - 1].data_ptr(), acts[l].data_ptr(), plan.wpad[l],
                                plan.wpad[l - 1], M, 0, M // fused_fit.TILE, 0, plan.bias[l].data_ptr(), 0, T, None,
                                None, None, None, stream) for l in range(1, H)]
        rcs += [lib.msd_fit_gemm(plan.bwd[l].data_ptr(), acts[l].data_ptr(), acts[l - 1].data_ptr() if l > 1 else None,
                                 plan.wpad[l - 1], plan.wpad[l], M, 0, M // fused_fit.TILE, 1, None, 0, T, None, None,
                                 acts[l - 1].data_ptr(), None, stream) for l in range(H - 1, 0, -1)]
        if any(rcs):
            raise AssertionError(f"fit_gemm_kernel launches failed: {rcs}")

    r["products_ms"] = time_ms(products, reps=reps)
    del acts
    r["product_gflop"] = flops / 1e9
    r["products_tflops"] = flops / (r["products_ms"] * 1e-3) / 1e12
    r["bound_ms"] = flops / PEAK_FLOPS["float32"] * 1e3

    shapes = [(plan.wpad[l], plan.wpad[l - 1]) for l in range(1, H)] + [(plan.wpad[l - 1], plan.wpad[l])
                                                                        for l in range(1, H)]
    ops = [(torch.randn(i, k, device=dev), torch.randn(k, M, device=dev)) for i, k in shapes]
    r["library_ms"] = time_ms(lambda: [torch.matmul(a, b) for a, b in ops], reps=reps)
    r["library_note"] = "torch.matmul of the same products at the padded widths, float32, TF32 off: the yardstick"
    del ops

    before = dict(reconstruct.FIT_ITERATIONS)
    shapes_np = [(b[: n // 2].cpu().numpy(), b[n // 2:].cpu().numpy()) for b in batch]
    t = time.perf_counter()
    reconstruct.reconstruct_batch(decoder, 100, decoder.latent_size, shapes_np, 0.01, clamp, num_samples=n,
                                  lr=5e-3, l2reg=True, seed=seed)
    torch.cuda.synchronize()
    r["fit_iteration_ms"] = (time.perf_counter() - t) * 1e3 / 100
    r["fit_iterations"] = {k: reconstruct.FIT_ITERATIONS[k] - before[k] for k in before}
    if r["fit_iterations"] != {"kernel": 100, "autograd": 0}:
        raise AssertionError(f"fused fit: iterations by route {r['fit_iterations']}")
    r["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    phase("fit", **r)
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
    by_name, other = {}, {}
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
        if name == "other":
            other[e.key[:80]] = (us / 1e3 / n, e.count / n)
    device_ms = sum(by_name.values())
    if device_ms == 0:
        return {"note": "the profiler recorded no device time: not measured"}
    top = sorted(other.items(), key=lambda kv: -kv[1][0])[:8]
    return {"ms_per_step_by_kernel": by_name, "device_ms_per_step": device_ms, "device_ops_per_step": kernels / n,
            "wall_ms_per_step": wall_ms / n, "device_idle_share": 1 - device_ms / (wall_ms / n),
            "top_other": {k: {"ms_per_step": ms, "launches_per_step": c} for k, (ms, c) in top}}


def step_times(trainer, seed, n=11):
    """Milliseconds of ``n`` Stage-1 steps of ``trainer`` on one seeded
    batch of its first B scenes (host clock around synchronised steps),
    and that batch."""
    import torch

    from msd_tpu_torch.data.sdf_samples import sample_sdf_batch

    dev = trainer.device
    B, P = trainer.scene_per_batch, trainer.num_samp_per_scene
    pos, pc, neg, nc = trainer.dataset.device_arrays(dev)
    idx = torch.arange(B, device=dev)
    batch = sample_sdf_batch(pos, pc, neg, nc, idx, P, torch.Generator(device=dev).manual_seed(seed))
    ms = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainer.step(idx, batch, 9, 5e-4, 1e-3)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    return ms, idx, batch


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

    # step times on the trained state, K2's kernel launches per step
    fused_train.reset_launches()
    step_ms, idx, batch = step_times(resumed, seed)
    kernel_launches = {k: v / len(step_ms) for k, v in fused_train.KERNEL_LAUNCHES.items()}
    step_med = float(np.median(step_ms[1:]))
    dev = resumed.device
    B, P = resumed.scene_per_batch, resumed.num_samp_per_scene
    check_chain_launches(kernel_launches, resumed.decoder, B, P, "b")
    pos, pc, neg, nc = resumed.dataset.device_arrays(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)

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
        "k2_kernel_launches_per_step": kernel_launches, "profile": profile,
    }, launches_first + launches_resumed


FLAGSHIP_STAGE2 = os.path.join(ROOT, "examples", "ADNI", "MLP_VAE_SDF_disentangle_all_true_label_age", "specs.json")


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


STREAM_STAT_KEYS = ("refine", "active_blocks", "crossing_blocks", "exact_slabs", "evaluated", "t_refine",
                    "t_stream", "t_mesher")


@contextlib.contextmanager
def record_meshes():
    """Within it, every ``mesh.create_mesh`` call (an eval epoch's meshes)
    is recorded: its latent, N, seconds, K1 launches (the counter's
    increase, which stays counted where it was) and the
    ``LAST_STREAMING_STATS`` keys of ``STREAM_STAT_KEYS``. Yields the list;
    ``compare_meshes`` then runs the non-streaming route on each."""
    from msd_tpu_torch import mesh
    from msd_tpu_torch.ops import fused_mlp

    calls, inner = [], mesh.create_mesh

    def create_mesh(decoder, latent_vec, *args, **kw):
        mesh.LAST_STREAMING_STATS.clear()
        dev = next(decoder.parameters()).device
        launches = fused_mlp.LAUNCHES
        _sync(dev)
        t0 = time.perf_counter()
        out = inner(decoder, latent_vec, *args, **kw)
        _sync(dev)
        calls.append({"decoder": decoder, "latent": latent_vec.detach().clone(), "N": kw.get("N", 512),
                      "seconds": time.perf_counter() - t0, "k1_launches": fused_mlp.LAUNCHES - launches,
                      "surface": out is not False,
                      "stats": {k: mesh.LAST_STREAMING_STATS.get(k) for k in STREAM_STAT_KEYS}})
        return out

    mesh.create_mesh = create_mesh
    try:
        yield calls
    finally:
        mesh.create_mesh = inner


def compare_meshes(calls):
    """Each recorded ``create_mesh`` call beside the non-streaming route
    (``float32_mesh``, a new evaluator, the decoder in eval mode) on the
    same latent and N: seconds, K1 launches, surface found."""
    from msd_tpu_torch import mesh
    from msd_tpu_torch.ops import fused_mlp

    out = []
    for c in calls:
        decoder = c.pop("decoder")
        dev = next(decoder.parameters()).device
        was = decoder.training
        decoder.eval()
        launches = fused_mlp.LAUNCHES
        _sync(dev)
        t0 = time.perf_counter()
        try:
            float32_mesh(c.pop("latent"), mesh._snap_n(c["N"]), mesh.PointEvaluator(decoder))
            surface = True
        except ValueError:  # no zero crossing, as create_mesh reports it
            surface = False
        _sync(dev)
        decoder.train(was)
        out.append(dict(c, float32={"seconds": time.perf_counter() - t0, "surface": surface,
                                    "k1_launches": fused_mlp.LAUNCHES - launches}))
    return out


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
        # the test split is the training split, so its latents are Stage 1's
        # (read only at EvalTestFrequency, 100 epochs: never in this run)
        "TestLatentPath": os.path.join(stage1_exp, ws.latent_codes_subdir, "latest.pth"),
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
    with record_meshes() as eval_meshes:
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

    fused_train.reset_launches()
    step_ms = []
    for _ in range(11):
        _sync(dev)
        t = time.perf_counter()
        step()
        _sync(dev)
        step_ms.append((time.perf_counter() - t) * 1e3)
    launches_per_step = fused_train.LAUNCHES / len(step_ms)
    kernel_launches = {k: v / len(step_ms) for k, v in fused_train.KERNEL_LAUNCHES.items()}
    if card:
        check_chain_launches(kernel_launches, resumed.sdf_decoder, B, P, "d")
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
        "eval_meshes": compare_meshes(eval_meshes),
        "holdout_sap": trainer.last_holdout_sap, "eval_metrics": trainer.last_eval_metrics,
        "k2d_launches": k2_first + k2_resumed, "k1_launches": k1_first + k1_resumed,
        "step_ms_median": step_med, "step_ms": step_ms, "k2d_launches_per_step": launches_per_step,
        "k2d_ms_in_step": k2d_ms, "k2d_share_of_step": k2d_ms / step_med,
        "scenes_per_s": B / (step_med * 1e-3), "k2_kernel_launches_per_step": kernel_launches, "profile": profile,
        "autograd_step_ms": autograd_step_ms, "step_vs_autograd": vs_autograd,
    }, k2_first + k2_resumed, k1_first + k1_resumed


HPO_HOLDOUT = 0.25


def hpo(root, seed, device="cuda", trials=3, epochs=2):
    """The port's hyper-parameter search (``python -m
    msd_tpu_torch.hparams_optuna_vae_sdf``, in process) on the stage2
    phase's experiment: its flagship spec with the smoke's absolute paths
    and ``TrainLatentHoldoutFraction`` ``HPO_HOLDOUT``, ``trials`` trials of
    ``epochs`` epochs, then one more resumed from trials.json. Returns
    (phase summary, K2 d launches)."""
    import torch

    from msd_tpu_torch import hparams_optuna_vae_sdf as search
    from msd_tpu_torch.ops import fused_train

    with open(os.path.join(root, "stage2_experiment", "specs.json")) as f:
        specs = json.load(f)
    base, out = os.path.join(root, "hpo_base_specs.json"), os.path.join(root, "hpo")
    with open(base, "w") as f:
        json.dump(dict(specs, TrainLatentHoldoutFraction=HPO_HOLDOUT), f)
    card = device == "cuda"

    def held():  # read once main has dropped the trial's trainer
        return torch.cuda.memory_allocated() if card else None

    records, sizes = [], []

    class Measured(search.Stage2Trainer):
        """The trial's trainer, noting its dataset's bytes on the device and
        its steps per epoch; nothing kept."""

        def train(self, *args, **kw):
            super().train(*args, **kw)
            sizes.append({"dataset_bytes": sum(t.numel() * t.element_size()
                                               for t in self.dataset.device_arrays(self.device)),
                          "steps_per_epoch": len(self.train_indices) // self.scene_per_batch,
                          "holdout_scenes": len(self.holdout_indices)})

    inner, trainer_class = search.run_trial, search.Stage2Trainer

    def timed(trial_dir, *args, **kw):
        if records:
            records[-1]["memory_allocated_after"] = held()
        _sync(torch.device(device))
        t0 = time.perf_counter()
        try:
            return inner(trial_dir, *args, **kw)
        finally:
            _sync(torch.device(device))
            records.append({"trial": os.path.basename(trial_dir), "seconds": time.perf_counter() - t0})

    cli = ["-b", base, "-o", out, "--epochs", str(epochs), "--device", device, "--seed", str(seed), "--quiet"]
    search.run_trial, search.Stage2Trainer = timed, Measured
    fused_train.reset_launches()
    try:
        t0 = time.time()
        search.main(cli + ["-n", str(trials)])
        t_first = time.time() - t0
        records[-1]["memory_allocated_after"] = held()
        history = search.main(cli + ["-n", "1"])
        records[-1]["memory_allocated_after"] = held()
    finally:
        search.run_trial, search.Stage2Trainer = inner, trainer_class
    launches = fused_train.LAUNCHES

    with open(os.path.join(out, "trials.json")) as f:
        saved = json.load(f)
    n = trials + 1
    if saved != history or [t["trial"] for t in saved] != list(range(n)):
        raise AssertionError(f"trials.json holds trials {[t.get('trial') for t in saved]}, want 0-{n - 1}")
    for t in saved:
        parts = [t.get("value")] + [t.get("detail", {}).get(k) for k in ("sap", "corr", "recon")]
        if not all(isinstance(v, float) and math.isfinite(v) for v in parts):
            raise AssertionError(f"trial {t['trial']} has no finite value and parts: {json.dumps(t)}")
    if not os.path.isfile(os.path.join(out, "best.json")):
        raise AssertionError("no best.json")
    replay = search.sample_params(np.random.default_rng(seed + trials), saved[:trials])
    if replay != saved[trials]["params"]:
        raise AssertionError(f"the resumed trial's parameters {saved[trials]['params']} are not the sampler's {replay}")
    steps = sizes[0]["steps_per_epoch"]
    if launches != card * n * epochs * steps:
        raise AssertionError(f"K2 d launches {launches}, want {n} trials x {epochs} epochs x {steps} steps")
    grown = None
    if card:
        grown = records[-1]["memory_allocated_after"] - records[0]["memory_allocated_after"]
        if grown > sizes[0]["dataset_bytes"]:
            raise AssertionError(f"device memory grew by {grown} B over {n} trials, more than one trial's "
                                 f"dataset ({sizes[0]['dataset_bytes']} B)")
    return {
        "base": {"from": "stage2 phase's specs.json", "TrainLatentHoldoutFraction": HPO_HOLDOUT,
                 "holdout_note": "0.1 holds out 6 of 64 scenes, whose classification SAP is 0: its 5-fold "
                                 "cross-validation needs 5 holdout scenes of each class"},
        "trials": n, "epochs": epochs, "steps_per_epoch": steps, "holdout_scenes": sizes[0]["holdout_scenes"],
        "first_run_seconds": t_first, "per_trial": records, "dataset_bytes": sizes[0]["dataset_bytes"],
        "memory_grown_bytes": grown, "k2d_launches": launches,
        "values": [t["value"] for t in saved], "detail": [t["detail"] for t in saved],
        "best_trial": max(saved, key=lambda t: t["value"])["trial"],
    }, launches


def profile_epochs(root, device="cuda"):
    """``ProfileEpochs`` on the training phase's flagship Stage-1 spec: a
    copy with NumEpochs 2 and ProfileEpochs [2] through ``python -m
    msd_tpu_torch.train_deep_sdf`` in process. Returns (phase summary, K2
    launches)."""
    import glob

    import msd_tpu_torch.workspace as ws
    from msd_tpu_torch import train_deep_sdf
    from msd_tpu_torch.ops import fused_train
    from msd_tpu_torch.train.stage1 import Stage1Trainer

    with open(os.path.join(root, "train_experiment", "specs.json")) as f:
        specs = json.load(f)
    exp = os.path.join(root, "profile_experiment")
    ws.save_experiment_specifications(exp, dict(specs, NumEpochs=2, ProfileEpochs=[2]))

    per_epoch, inner = {}, Stage1Trainer.train_epoch

    def counted(self, epoch, *args, **kw):  # K2's kernel counts over the epoch, inside its trace
        before = dict(fused_train.KERNEL_LAUNCHES)
        out = inner(self, epoch, *args, **kw)
        per_epoch[epoch] = {k: n - before[k] for k, n in fused_train.KERNEL_LAUNCHES.items()}
        return out

    Stage1Trainer.train_epoch = counted
    fused_train.reset_launches()
    try:
        trainer = train_deep_sdf.main(["-e", exp, "--device", device, "--quiet"])
    finally:
        Stage1Trainer.train_epoch = inner
    launches = fused_train.LAUNCHES

    paths = glob.glob(os.path.join(exp, ws.tb_logs_dir, "profile", "*"))
    if len(paths) != 1 or not paths[0].endswith(".pt.trace.json"):
        raise AssertionError(f"want one trace file, found {paths}")
    with open(paths[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    traced = {k: sum(k in name for name in kernels) for k in fused_train.KERNEL_LAUNCHES}
    if traced != per_epoch[2] or (device == "cuda" and not all(per_epoch[2].values())):
        raise AssertionError(f"the trace's K2 kernels {traced} against the counters in epoch 2: {per_epoch[2]}")
    steps = len(trainer.loss_log) // 2
    if launches != (device == "cuda") * 2 * steps:
        raise AssertionError(f"K2 launches {launches}, want one per step ({2 * steps})")
    seconds = trainer.timing_log
    return {
        "changed": {"NumEpochs": 2, "ProfileEpochs": [2]}, "trace": os.path.relpath(paths[0], exp),
        "trace_bytes": os.path.getsize(paths[0]), "trace_events": len(events), "kernel_events": len(kernels),
        "k2_kernels_traced": traced, "k2_kernels_counted": per_epoch[2], "k2_kernels_epoch_1": per_epoch[1],
        "epoch_seconds": seconds, "profiled_over_epoch_1": seconds[1] / seconds[0],
        "k2_launches": launches,
    }, launches


def stage2_points(root, seed, device="cuda", changes=None):
    """Stage 2 in points mode on the Stage-1 experiment and data the
    training phase left under ``root`` (and the stage2 phase's labels.pt):
    the flagship Stage-2 spec with EncoderType pointnet2 and 2048 surface
    points per shape from the ellipsoids' meshes, driven through the trainer
    API as msd_tpu's points-mode tests drive it (a CLI run stops at its
    first snapshot: no point-encoder VAE can be checkpointed). Returns
    (phase summary, K2 d launches, K1 launches). ``changes`` updates the
    spec further (a CPU rehearsal shrinks it with them)."""
    import torch

    import msd_tpu_torch.workspace as ws
    from msd_tpu_torch.data.sdf_samples import sample_sdf_batch
    from msd_tpu_torch.models import pointnet2
    from msd_tpu_torch.ops import fused_mlp, fused_train
    from msd_tpu_torch.ops.fused_train import fused_sdf_l1
    from msd_tpu_torch.train import stage2_eval as ev
    from msd_tpu_torch.train.stage2 import Stage2Trainer

    t0 = time.time()
    stage1_exp, data_dir = os.path.join(root, "train_experiment"), os.path.join(root, "train_data")
    split_path = os.path.join(root, "train_split.json")
    with open(FLAGSHIP_STAGE2) as f:
        specs = json.load(f)
    changed = {
        "DataSource": os.path.join(data_dir, "SdfSamples"), "TrainSplit": split_path, "TestSplit": split_path,
        "PretrainedLatentPath": os.path.join(stage1_exp, ws.latent_codes_subdir, "latest.pth"),
        "PretrainedSDFDecoderPath": os.path.join(stage1_exp, ws.model_params_subdir, "latest.pth"),
        "DataSourceMesh": os.path.join(data_dir, "Meshes"), "EncoderType": "pointnet2", "SurfacePointCount": 2048,
        "EvalGTMeshDir": os.path.join(data_dir, "SurfaceSamples", "smoke", "ellipsoid"), "EvalGTMeshExt": ".ply",
        **(changes or {}),
    }
    base = dict(specs, **changed)
    exp = os.path.join(root, "stage2_points_experiment")
    ws.save_experiment_specifications(exp, base)
    trainer = Stage2Trainer(exp, device=device)
    dev = trainer.device
    card = dev.type == "cuda"  # the counters count CUDA launches; a CPU rehearsal runs the plain versions
    S, B, P = trainer.num_scenes, trainer.scene_per_batch, trainer.num_samp_per_scene
    cloud = trainer.dataset.surface_points.shape[1]
    if (trainer.vae_input_mode != "points" or not trainer.fused_ok or trainer.train_sdf_decoder
            or trainer.dataset.surface_points.shape != (S, changed["SurfacePointCount"], 3)):
        raise AssertionError("the points-mode trainer did not take K2 d on surface clouds")
    t_setup = time.time() - t0

    # a few epochs of train_epoch, the counters set to 0 just before
    epochs, nb = 4, len(trainer.train_indices) // B
    fused_train.LAUNCHES = fused_mlp.LAUNCHES = 0
    t0 = time.time()
    metrics = []
    for e in range(1, epochs + 1):
        trainer.epoch = e
        metrics.append(trainer.train_epoch(e))
    _sync(dev)
    t_train = time.time() - t0
    k2_train = fused_train.LAUNCHES
    if k2_train != epochs * nb * card:
        raise AssertionError(f"K2 d launches {k2_train}, want one per step ({epochs * nb})")
    if not all(math.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError(f"non-finite training metrics: {metrics}")

    # the eval epoch's pieces: run_eval and two meshes of z_hat through K1
    fused_mlp.LAUNCHES = 0
    recorder = ScalarRecorder()
    kl_w, crw = trainer.epoch_weights(epochs)[2:]
    em = ev.run_eval(trainer, epochs, "eval_train", scene_indices=trainer.train_indices, kl_weight=kl_w,
                     code_reg_weight=crw, writer=recorder)
    with record_meshes() as eval_meshes:
        written, _ = ev.generate_eval_meshes(trainer, epochs, "train", trainer.train_indices[:2], writer=recorder,
                                             return_meshes=True)
    _sync(dev)
    k1_eval = fused_mlp.LAUNCHES
    eval_meshes = compare_meshes(eval_meshes)
    if card and k1_eval <= 0:
        raise AssertionError("the eval meshes launched no K1")
    if not all(math.isfinite(v) for v in em.values()):
        raise AssertionError(f"non-finite eval metrics: {em}")

    # the latent export, twice, in eval mode: equal bits, statistics fixed
    stats = {k: v.clone() for k, v in trainer.vae.state_dict().items() if "running_" in k}
    mu_a, mu_b = trainer.compute_vae_latents(), trainer.compute_vae_latents()
    if not (np.array_equal(mu_a, mu_b) and np.isfinite(mu_a).all() and mu_a.shape == (S, trainer.vae_latent_dim)):
        raise AssertionError("compute_vae_latents: two calls differ or are not finite")
    if not all(torch.equal(v, trainer.vae.state_dict()[k]) for k, v in stats.items()):
        raise AssertionError("compute_vae_latents moved the BatchNorm statistics")
    try:
        trainer.save_checkpoint("latest")
    except NotImplementedError as exc:
        refused = str(exc)
    else:
        raise AssertionError("save_checkpoint of a point-encoder VAE did not raise")

    # the step on one batch: time, peak memory, K2 d's launches and share
    pos, pc, neg, nc = trainer.dataset.device_arrays(dev)
    idx = torch.as_tensor(trainer.train_indices[:B], device=dev)
    labels = trainer._batch_labels(trainer.train_indices[:B], np.random.default_rng(seed))
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch = sample_sdf_batch(pos, pc, neg, nc, idx, P, gen)
    weights = trainer.epoch_weights(epochs + 1)

    def step():
        return trainer.step(idx, labels, *[weights[i] for i in (2, 3, 0, 1)], batch=batch, generator=gen)

    fused_train.reset_launches()
    if card:
        torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(11):
        _sync(dev)
        t = time.perf_counter()
        step()
        _sync(dev)
        step_ms.append((time.perf_counter() - t) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if card else None
    if fused_train.LAUNCHES != len(step_ms) * card:
        raise AssertionError(f"K2 d launches {fused_train.LAUNCHES} in {len(step_ms)} steps")
    kernel_launches = {k: v / len(step_ms) for k, v in fused_train.KERNEL_LAUNCHES.items()}
    if card:
        check_chain_launches(kernel_launches, trainer.sdf_decoder, B, P, "d")
    step_med = float(np.median(step_ms[1:]))
    profile = profile_steps(step, 3)
    with torch.no_grad():
        z_hat = trainer.vae(trainer._surface_dev[idx], generator=gen)["z_hat"]
    xyz, gt = batch[:3].permute(1, 2, 0).contiguous(), batch[3]

    def k2d_call():
        with torch.no_grad():
            fused_sdf_l1(trainer.sdf_decoder, z_hat, xyz, gt, trainer.clamp_dist, train_net=False)

    # FPS and the ball query alone at the step's shapes (both abstractions)
    clouds = trainer._surface_dev[idx]
    s1, s2 = trainer.vae.encoder.draw_starts(clouds, gen)
    sa1, sa2 = pointnet2.PointNet2Encoder.SA_CONFIG[:2]
    with torch.no_grad():
        xyz1 = pointnet2.index_points(clouds, pointnet2.farthest_point_sample(clouds, sa1["npoint"], s1))
        xyz2 = pointnet2.index_points(xyz1, pointnet2.farthest_point_sample(xyz1, sa2["npoint"], s2))

    def fps():
        pointnet2.farthest_point_sample(clouds, sa1["npoint"], s1)
        pointnet2.farthest_point_sample(xyz1, sa2["npoint"], s2)

    def ball_query():
        pointnet2.query_ball_point(sa1["radius"], sa1["nsample"], clouds, xyz1)
        pointnet2.query_ball_point(sa2["radius"], sa2["nsample"], xyz1, xyz2)

    pieces = {}
    for name, fn in (("k2d", k2d_call), ("fps", fps), ("ball_query", ball_query)):
        ms = time_ms(fn) if card else None
        prof = profile_steps(fn, 3)
        pieces[name] = {"ms": ms, "share_of_step": ms / step_med if card else None, "profile": prof}
        if card and "device_ms_per_step" in prof and "device_ms_per_step" in profile:
            pieces[name]["device_share_of_step"] = prof["device_ms_per_step"] / profile["device_ms_per_step"]
    if card:  # the same FPS work replayed as one CUDA graph: its launches off the host
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fps()
        pieces["fps"]["cuda_graph_ms"] = time_ms(graph.replay)

    # the other two encoders, 2 epochs each
    others, k2_others = {}, 0
    for enc in ("resnet_pointnet", "pointnet_encoder"):
        e_exp = os.path.join(root, f"stage2_{enc}_experiment")
        ws.save_experiment_specifications(e_exp, dict(base, EncoderType=enc))
        tr = Stage2Trainer(e_exp, device=device)
        # the per-point layers' BatchNorms (the z head's stays put with KL on)
        bns = list(getattr(tr.vae.encoder, "bns", []))
        before = [m.running_mean.clone() for m in bns]
        fused_train.LAUNCHES = 0
        ms = []
        for e in (1, 2):
            tr.epoch = e
            ms.append(tr.train_epoch(e))
        _sync(dev)
        k2_others += fused_train.LAUNCHES
        if fused_train.LAUNCHES != 2 * nb * card or not all(math.isfinite(v) for m in ms for v in m.values()):
            raise AssertionError(f"{enc}: K2 d launches {fused_train.LAUNCHES} or non-finite losses {ms}")
        r = {"epoch_losses": [m["total"] for m in ms], "k2d_launches": fused_train.LAUNCHES}
        if enc == "pointnet_encoder":
            after = [m.running_mean.clone() for m in bns]
            tr.compute_vae_latents()
            r["bn_means_moved"] = all(not torch.equal(a, b) for a, b in zip(before, after))
            r["bn_means_fixed_in_eval"] = all(torch.equal(a, m.running_mean) for a, m in zip(after, bns))
            if not (r["bn_means_moved"] and r["bn_means_fixed_in_eval"]):
                raise AssertionError(f"pointnet_encoder BatchNorm means: {r}")
        others[enc] = r
    return {
        "changed": changed, "scenes": S, "train_scenes": len(trainer.train_indices), "surface_points": cloud,
        "setup_seconds": t_setup, "train_seconds": t_train, "steps": epochs * nb,
        "epoch_losses": [m["total"] for m in metrics], "eval_metrics": em,
        "eval_meshes_with_surface": f"{len(written)} of 2", "eval_meshes": eval_meshes,
        "k2d_launches": k2_train, "k1_launches_eval": k1_eval,
        "latents_bit_equal": True, "save_checkpoint_refused": refused,
        "step_ms_median": step_med, "step_ms": step_ms, "scenes_per_s": B / (step_med * 1e-3),
        "peak_memory_gb": peak_gb, "k2_kernel_launches_per_step": kernel_launches, "profile": profile,
        "pieces": pieces, "other_encoders": others,
    }, k2_train + k2_others, k1_eval


POINTS_RANKS = 2
POINTS_RANKS_STEPS = 4
# Points-mode Stage 2 on the ranks against one process on the card, after
# the first step: loss terms, BatchNorm statistics and parameters to 1e-3
# (parameters where their gradient is above 1e-2 of the largest, the rest
# moved by at most lr in both), as tests/test_torch_stage2_points_ranks.py
# holds PointNet++ on the CPU; gradients to 2e-2 of the largest: each
# float32 run sits within 1e-2 of a float64 run (PN2_TRAIN_RTOL
# "grad_float64", tests/test_torch_pointnet.py), so two float32 runs that
# sum SA1's BatchNorm rows in other orders may sit 2e-2 apart (9.7e-3
# measured on the H100, 4.5e-3 on the CPU test's 4 scenes). The later
# steps' losses are printed, not held: from the second step the two runs'
# float32 roundings have moved parameters of near-zero gradient by up to lr
# in opposite directions, and the batch-statistic losses (SNNL's median
# temperature, its saturation at -log 1e-6) carry that far; one process at
# 1 and at 8 CPU threads differs by 5-8% in the total by the fifth step of
# a 4-scene rehearsal.
POINTS_RANKS_TOL = {"values": 1e-3, "grads": 2e-2, "big": 1e-2}


def points_ranks_steps(trainer, inputs):
    """``inputs``' steps (each scene ids, labels, weights and a generator
    seed; the step draws its point batch, noise and FPS starts from that
    generator) on a points-mode trainer. Returns each step's metrics and
    milliseconds (host clock around synchronised steps), the first step's
    VAE gradients, the parameters before and after it, its BatchNorm
    statistics, the final parameters and statistics (on the CPU), and the
    device operations of the first step's two FPS calls on this rank's
    scenes (profiler; None off the card) and their count."""
    import torch

    from msd_tpu_torch.models import pointnet2

    dev = trainer.device

    def state():
        return ({n: p.detach().cpu().clone() for n, p in trainer.vae.named_parameters()},
                {n: b.detach().cpu().clone() for n, b in trainer.vae.named_buffers() if "running_" in n})

    before = state()[0]
    out = {"aux": [], "step_ms": []}
    for s, (idx, labels, weights, seed) in enumerate(inputs):
        gen = torch.Generator(device=dev).manual_seed(seed)
        _sync(dev)
        t = time.perf_counter()
        aux = trainer.step(torch.as_tensor(idx, device=dev), labels, *weights, generator=gen)
        _sync(dev)
        out["step_ms"].append((time.perf_counter() - t) * 1e3)
        out["aux"].append({k: float(v) for k, v in aux.items()})
        if s == 0:
            out["grads"] = {n: p.grad.detach().cpu().clone() for n, p in trainer.vae.named_parameters()
                            if p.grad is not None}
            out["params_1"], out["stats_1"] = state()
    out["before"] = before
    out["params"], out["stats"] = state()

    # the first step's FPS on this rank's scenes (its launches do not depend on the starts)
    idx, _, _, seed = inputs[0]
    clouds = trainer._surface_dev[torch.as_tensor(idx, device=dev)]
    s1, s2 = trainer.vae.encoder.draw_starts(clouds, torch.Generator(device=dev).manual_seed(seed))
    rows = trainer.group.scene_slice(len(idx)) if trainer.group is not None else slice(None)
    clouds, s1, s2 = clouds[rows], s1[rows], s2[rows]
    sa1, sa2 = pointnet2.PointNet2Encoder.SA_CONFIG[:2]

    def fps():
        with torch.no_grad():
            xyz1 = pointnet2.index_points(clouds, pointnet2.farthest_point_sample(clouds, sa1["npoint"], s1))
            pointnet2.farthest_point_sample(xyz1, sa2["npoint"], s2)

    out["scenes"] = clouds.shape[0]
    out["fps_device_ops"] = profile_steps(fps, 1).get("device_ops_per_step") if dev.type == "cuda" else None
    return out


def stage2_points_ranks_rank(group, exp, inputs):
    """A rank of the points-mode Stage-2 run (spawned by ``stage2_points_ranks``)."""
    from msd_tpu_torch.ops import fused_train
    from msd_tpu_torch.train.stage2 import Stage2Trainer

    trainer = Stage2Trainer(exp, group=group)
    fused_train.reset_launches()
    out = points_ranks_steps(trainer, inputs)
    out["k2d_launches"] = fused_train.VARIANT_LAUNCHES["d"]
    return out


def stage2_points_ranks(root, seed, device="cuda"):
    """Points-mode Stage 2 over ``POINTS_RANKS`` gloo ranks on the card (or
    the CPU, a rehearsal), on the stage2_points phase's experiment
    (PointNet++, 2048 surface points, ScenesPerBatch 32, K2 d): each rank
    encodes its 16 scenes with BatchNorm over both ranks' rows, and K2 d
    splits 16 + 16. ``POINTS_RANKS_STEPS`` steps on given scene ids, labels,
    weights and generator seeds, against one process taking the same steps.
    Returns the phase summary and the K2 d launches per rank."""
    import torch

    from msd_tpu_torch.parallel import run_ranks
    from msd_tpu_torch.train.stage1 import step_seed
    from msd_tpu_torch.train.stage2 import Stage2Trainer

    t_start = time.time()
    exp = os.path.join(root, "stage2_points_experiment")
    one = Stage2Trainer(exp, device=device)
    B = one.scene_per_batch
    if one.encoder_type != "pointnet2" or B % POINTS_RANKS:
        raise AssertionError(f"stage2_points_ranks: {one.encoder_type}, {B} scenes per batch")
    rng = np.random.default_rng(seed)
    lr_vae, lr_sdf, kl_w, crw = one.epoch_weights(1)
    inputs = []
    for s in range(POINTS_RANKS_STEPS):
        idx = rng.permutation(one.train_indices)[:B]
        inputs.append((idx, one._batch_labels(idx, rng), (kl_w, crw, lr_vae, lr_sdf), step_seed(seed, s)))
    devices = ["cuda:0" if device == "cuda" else device] * POINTS_RANKS
    ranks = run_ranks(stage2_points_ranks_rank, POINTS_RANKS, (exp, inputs), devices=devices, timeout=600,
                      workdir=root)
    t_ranks = time.time() - t_start
    ref = points_ranks_steps(one, inputs)

    tol = POINTS_RANKS_TOL
    g_max = max(float(g.abs().max()) for g in ref["grads"].values())
    errs = []
    for r, out in enumerate(ranks):
        e = {"rank": r}
        e["step1_aux_rel"] = max(abs(out["aux"][0][k] - v) / max(abs(v), 1e-12) for k, v in ref["aux"][0].items())
        e["later_total_rel"] = [abs(a["total"] - b["total"]) / abs(b["total"])
                                for a, b in zip(out["aux"][1:], ref["aux"][1:])]
        e["step1_grad_share"] = max(float((out["grads"][n] - g).abs().max()) / g_max for n, g in ref["grads"].items())
        e["step1_stats_rel"] = max(float((out["stats_1"][n] - v).abs().max() / v.abs().max().clamp(min=1e-12))
                                   for n, v in ref["stats_1"].items())
        big_rel, small_moved = 0.0, 0.0
        for n, v in ref["params_1"].items():
            g = ref["grads"].get(n, torch.zeros_like(v))
            big = g.abs() > tol["big"] * g_max
            if big.any():
                big_rel = max(big_rel, float((out["params_1"][n][big] - v[big]).abs().max() / v.abs().max()))
            ulps = 2 * np.spacing(ref["before"][n].abs().numpy())  # Adam moves a parameter by at most lr
            for moved in (out["params_1"][n] - ref["before"][n], v - ref["before"][n]):
                small_moved = max(small_moved, float((moved.abs().numpy() - ulps).max()))
        e["step1_params_rel_big_grad"], e["step1_params_most_moved"] = big_rel, small_moved
        e["sorted_aux_keys_equal"] = sorted(out["aux"][0]) == sorted(ref["aux"][0])
        errs.append(e)
        if not (e["sorted_aux_keys_equal"] and e["step1_aux_rel"] <= tol["values"]
                and all(math.isfinite(a["total"]) for a in out["aux"]) and e["step1_grad_share"] <= tol["grads"]
                and e["step1_stats_rel"] <= tol["values"] and big_rel <= tol["values"]
                and small_moved <= lr_vae):
            raise AssertionError(f"stage2_points_ranks: rank {r} against one process: {e}")
    same = all(torch.equal(v, ranks[0][k][n]) for out in ranks[1:] for k in ("params", "stats")
               for n, v in out[k].items())
    if not same:
        raise AssertionError("stage2_points_ranks: the ranks' parameters or statistics differ")
    card = device == "cuda"
    launches = [out["k2d_launches"] for out in ranks]
    if launches != [POINTS_RANKS_STEPS * card] * POINTS_RANKS:
        raise AssertionError(f"stage2_points_ranks: K2 d launches per rank {launches}")
    med = lambda ms: float(np.median(ms[1:]))  # noqa: E731
    return {
        "ranks": POINTS_RANKS, "backend": "gloo", "devices": devices, "steps": POINTS_RANKS_STEPS,
        "scenes_per_batch": B, "scenes_per_rank": [out["scenes"] for out in ranks],
        "k2d_launches_per_rank": launches, "tol": tol, "errors": errs, "ranks_params_and_stats_bit_equal": True,
        "losses": {"one_process": [a["total"] for a in ref["aux"]],
                   "ranks": [[a["total"] for a in out["aux"]] for out in ranks]},
        "step_ms": {"one_process": ref["step_ms"], "ranks": [out["step_ms"] for out in ranks]},
        "step_ms_median": {"one_process": med(ref["step_ms"]), "ranks": [med(out["step_ms"]) for out in ranks]},
        "fps_device_ops": {"one_process": ref["fps_device_ops"], "ranks": [out["fps_device_ops"] for out in ranks]},
        "fps_scenes": {"one_process": ref["scenes"], "ranks": [out["scenes"] for out in ranks]},
        "ranks_seconds": t_ranks, "seconds": time.time() - t_start,
        "note": "two ranks share one card: a correctness drive of BatchNorm over ranks and the split batch, "
                "not a scaling figure; NCCL (one card per rank) not measured"}, launches


# K2 c and e: K2 b's limits against the plain version, with the loss sums at
# the step shape held closer: the clamped L1 to 1e-5 relative (one float32
# sum of the same per-point values in two orders; 3.3e-7 measured for b),
# the eikonal to 1e-4 (its per-point values come through the bf16 u-chain,
# which the kernel and the plain version round apart: 1.7e-5 measured for
# c, 1.4e-6 for e, 3.5e-5 for b on 4 scenes).
K2CE_LOSS_STEP = {"sdf": 1e-5, "eikonal": 1e-4}


def check_k2ce(decoder, seed, dev):
    """K2 variants c (EikonalNumPoints 4096 of 16384) and e (a pad scene of
    weight 0, eikonal on) against float32 autograd and their plain version
    on 4 scenes x 16384 points, and against their plain version at the step
    shape, 32 x 16384 points (e: scene 31 weighted 0), where both are timed
    beside the operation bound. e is also held against its plain version on
    the share the dp phase gives its last rank: 11 scenes, the last a pad
    scene, with the 32-scene batch's normalizers. A pad scene's dlat must be
    exactly 0."""
    import torch

    from msd_tpu_torch.ops.fused_train import eikonal_rows, fused_point_grads, fused_train_plain, point_grads

    P, E = 16384, 4096
    L = decoder.latent_size
    results = {}

    def check_step(out, ref, n_real, shape):
        r = k2_check_plain(decoder, out, ref, name, shape)
        if any(r["loss_rel"][k] > lim for k, lim in K2CE_LOSS_STEP.items()):
            raise AssertionError(f"K2 {name} loss sums vs plain at {shape}: {r['loss_rel']}")
        if name == "e" and not bool((out[2][n_real:] == 0).all()):
            raise AssertionError(f"K2 e at {shape}: the pad scene's dlat is not exactly 0")
        return r

    for name in ("c", "e"):
        def case(B, s):
            weights, biases, lat, xyz, gt = k2_inputs(decoder, B, P, s, dev)
            if name == "c":
                kw, n_real = dict(eik_points=E), B
            else:
                n_real = B - 1
                kw = dict(scene_weights=(torch.arange(B, device=dev) < n_real).float(), n_real=n_real)
            return (decoder, weights, biases, lat, xyz, gt, 0.1, True, n_real * P), kw, n_real

        args, kw, n_real = case(4, seed + 4)
        out = fused_point_grads(*args, **kw)
        torch.cuda.synchronize()
        vs_plain_4 = k2_check_plain(decoder, out, point_grads(fused_train_plain, *args, **kw), name, "4 x 16384")
        _, weights, biases, lat, xyz, gt = args[:6]
        if name == "c":
            ref = autograd_grads(decoder, weights, biases, lat, xyz, gt, 0.1, True, 4 * P, eik_points=E)
        else:  # the real scenes alone; the pad scene's dlat is 0
            ref = autograd_grads(decoder, weights, biases, lat[:n_real], xyz[:n_real], gt[:n_real], 0.1, True,
                                 n_real * P)
            ref = ref[:2] + (torch.cat([ref[2], torch.zeros(1, L, device=dev)]),) + ref[3:]
            if not bool((out[2][n_real:] == 0).all()):
                raise AssertionError("K2 e: the pad scene's dlat is not exactly 0")
        vs_autograd = k2_errors(decoder, out, ref)
        if (max(vs_autograd["loss_rel"].values()) > K2_TOL["autograd_loss"]
                or vs_autograd["worst_grad_rel"] > K2_TOL["autograd_grad"]
                or vs_autograd["min_grad_cos"] < K2_TOL["autograd_cos"]):
            raise AssertionError(f"K2 {name} vs float32 autograd: {json.dumps(vs_autograd)}")
        del out, ref

        B = 32
        full, kw, n_real = case(B, seed + 5)
        out = fused_point_grads(*full, **kw)
        torch.cuda.synchronize()
        vs_plain = check_step(out, point_grads(fused_train_plain, *full, **kw), n_real, "32 x 16384")
        del out
        vs_plain_rank = None
        if name == "e":
            # the dp phase's last rank: 32 scenes pad to 33 over 3 ranks, so
            # it runs scenes 22-32 (K2 chunks of 4 + 4 + 3, the pad scene in
            # the tail chunk) with the batch's normalizers
            weights, biases, lat, xyz, gt = k2_inputs(decoder, 11, P, seed + 6, dev)
            rank_args = (decoder, weights, biases, lat, xyz, gt, 0.1, True, 32 * P)
            rank_kw = dict(scene_weights=(torch.arange(11, device=dev) < 10).float(), n_real=32, eik_scenes=32)
            out = fused_point_grads(*rank_args, **rank_kw)
            torch.cuda.synchronize()
            vs_plain_rank = check_step(out, point_grads(fused_train_plain, *rank_args, **rank_kw), 10,
                                       "11 x 16384 (the dp phase's last rank)")
            del out
        share = eikonal_rows(P, E) / P if name == "c" else 1.0
        variant = "c" if name == "c" else "b"  # e weights b: the same work
        flops = step_flops(decoder, B * P, variant, share)
        r = {"variant": name, "points": B * P, "eik_points": E if name == "c" else None,
             "eik_rows": eikonal_rows(P, E) if name == "c" else P, "real_scenes": n_real,
             "vs_plain": vs_plain,
             "vs_plain_4_scenes": {k: vs_plain_4[k] for k in ("loss_rel", "worst_grad_rel", "max_abs_err")},
             "vs_autograd_4_scenes": {k: vs_autograd[k]
                                      for k in ("loss_rel", "dlat", "worst_grad_rel", "min_grad_cos")},
             "vs_plain_dp_last_rank": vs_plain_rank and {k: vs_plain_rank[k]
                                                         for k in ("loss_rel", "worst_grad_rel", "max_abs_err")},
             "ms": time_ms(lambda: fused_point_grads(*full, **kw)),
             "plain_ms": time_ms(lambda: point_grads(fused_train_plain, *full, **kw)),
             "flop": flops, "bound_ms": flops / PEAK_FLOPS["bfloat16"] * 1e3, "bound_by": "operations",
             "design_bytes_ms": design_bytes(decoder, B * P, variant, share) / HBM_BYTES_PER_S * 1e3,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        r["tflops"] = flops / (r["ms"] * 1e-3) / 1e12
        phase("k2ce", **r)
        results[name] = r
    return results


def train_eik(root, specs, seed):
    """The Stage-1 CLI with EikonalNumPoints 4096 (K2 c) on the training
    phase's data; returns the phase summary and K2 c's launches."""
    import torch

    import msd_tpu_torch.workspace as ws
    from msd_tpu_torch import train_deep_sdf
    from msd_tpu_torch.ops import fused_train
    from msd_tpu_torch.ops.fused_train import eikonal_rows, fused_sdf_loss

    exp = os.path.join(root, "train_eik4096_experiment")
    split_path = os.path.join(root, "train_split.json")
    changes = {"DataSource": os.path.join(root, "train_data", "SdfSamples"), "TrainSplit": split_path,
               "TestSplit": split_path, "NumEpochs": 4, "SnapshotFrequency": 2, "AdditionalSnapshots": [],
               "EikonalNumPoints": 4096}
    ws.save_experiment_specifications(exp, dict(specs, **changes))
    fused_train.reset_launches()
    t0 = time.time()
    trainer = train_deep_sdf.main(["-e", exp, "--device", "cuda", "--quiet"])
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = dict(fused_train.VARIANT_LAUNCHES)
    steps = len(trainer.loss_log)
    if not trainer.use_fused or launches["c"] != steps or fused_train.LAUNCHES != steps or steps != 8:
        raise AssertionError(f"K2 c launches {launches} in {steps} steps, want one per step (8)")
    if not all(math.isfinite(v) for v in trainer.loss_log):
        raise AssertionError(f"bad loss log: {trainer.loss_log}")

    fused_train.reset_launches()
    step_ms, idx, batch = step_times(trainer, seed)
    per_step = fused_train.VARIANT_LAUNCHES["c"] / len(step_ms)
    kernel_launches = {k: v / len(step_ms) for k, v in fused_train.KERNEL_LAUNCHES.items()}
    step_med = float(np.median(step_ms[1:]))
    B, P = trainer.scene_per_batch, trainer.num_samp_per_scene
    check_chain_launches(kernel_launches, trainer.decoder, B, P, "c")

    def k2_call():
        with torch.no_grad():
            fused_sdf_loss(trainer.decoder, trainer.latents[idx], batch[:3].permute(1, 2, 0).contiguous(), batch[3],
                           trainer.clamp_dist, True, B * P, eik_points=4096)

    k2_ms = time_ms(k2_call)
    profile = profile_steps(lambda: trainer.step(idx, batch, 9, 5e-4, 1e-3), 3)
    return {"changed": changes, "steps": steps, "seconds": seconds, "epoch_losses": trainer.loss_log_epoch,
            "eik_rows": eikonal_rows(P, 4096), "step_ms_median": step_med, "step_ms": step_ms,
            "k2c_launches_per_step": per_step, "k2_ms_in_step": k2_ms, "k2_share_of_step": k2_ms / step_med,
            "k2_kernel_launches_per_step": kernel_launches, "profile": profile}, launches["c"]


GMM_SPECS = os.path.join(ROOT, "examples", "ADNI", "minimal_eikonal_gmm", "specs.json")
GMM_SCALARS = ("Loss/train_covariance", "Loss/train_gmm", "Loss/train_gmm_nll", "Loss/train_gmm_entropy")
ISO_SCALARS = ("Loss/train_isometry", "Loss/train_isometry_G1", "Loss/train_isometry_G2",
               "Loss/train_grad_metric_iso")
# The GMM prior's gradient of K2's trainer against its float32 autograd
# path: both see the same latent rows, so they differ by summation order.
GMM_GRAD_TOL = 1e-5


class ScalarRecorder:
    """Stands in for the Stage-1 trainer's TensorBoard writer and keeps
    every scalar it is given, {tag: [values]}, and every figure's tag with
    its step, its pixel size and the seconds matplotlib took to draw it
    (as a writer renders a figure to an image), {tag: [records]}."""

    def __init__(self):
        self.scalars = {}
        self.figures = {}

    def add_scalar(self, tag, value, step=None):
        self.scalars.setdefault(tag, []).append(float(value))

    def add_figure(self, tag, figure, global_step=None):
        import matplotlib.pyplot as plt

        t0 = time.time()
        figure.canvas.draw()
        width, height = figure.canvas.get_width_height()
        self.figures.setdefault(tag, []).append({"step": global_step, "pixels": [width, height],
                                                 "draw_s": time.time() - t0})
        plt.close(figure)

    def add_hparams(self, *args, **kwargs):
        pass

    def flush(self):
        pass

    def close(self):
        pass


class WarningRecorder(logging.Handler):
    """A logging handler that keeps the messages of warnings and above."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def run_cli(argv, recorder):
    """``python -m msd_tpu_torch.train_deep_sdf`` in process with its
    TensorBoard writer replaced by ``recorder``; returns the trainer. The
    root logger's level and handlers, which the CLI sets, are restored."""
    import logging

    import torch

    from msd_tpu_torch import train_deep_sdf
    from msd_tpu_torch.train import stage1 as stage1_mod

    root_logger = logging.getLogger()
    level, handlers, opened = root_logger.level, list(root_logger.handlers), stage1_mod.open_summary_writer
    stage1_mod.open_summary_writer = lambda log_dir: recorder
    try:
        trainer = train_deep_sdf.main(argv)
        torch.cuda.synchronize()
    finally:
        stage1_mod.open_summary_writer = opened
        for h in list(root_logger.handlers):
            root_logger.removeHandler(h)
            if h not in handlers:
                h.close()
        for h in handlers:
            root_logger.addHandler(h)
        root_logger.setLevel(level)
    return trainer


def finite_scalars(recorder, tags, n):
    """Raise unless each of ``tags`` was logged ``n`` times, every value
    finite; returns {tag: values}."""
    got = {t: recorder.scalars.get(t, []) for t in tags}
    if any(len(v) != n or not all(math.isfinite(x) for x in v) for v in got.values()):
        raise AssertionError(f"scalars {json.dumps(got)}, want {n} finite values each")
    return got


def first_step_grads(trainer, idx, batch, lrs):
    """One step of ``trainer`` (epoch 1) from its state; the step's metrics
    and its pre-clip gradients (decoder by name, latent rows of ``idx``,
    GMM parameters), in float64 on the card."""
    aux = trainer.step(idx, batch, 1, *lrs)
    grads = {"net." + n: p.grad.double() for n, p in trainer.decoder.named_parameters()}
    grads["latents"] = trainer.latents.grad[idx].double()
    grads.update({"gmm." + k: p.grad.double() for k, p in trainer.gmm.items() if p.grad is not None})
    return {k: float(v) for k, v in aux.items()}, grads


def train_gmm(root, seed, training_launches):
    """Stage 1 of ``examples/ADNI/minimal_eikonal_gmm/specs.json`` at its own
    width and batch (16 scenes, K2 b over 4 chunks per step) on the training
    phase's 64 ellipsoids, warm-started from that phase's decoder
    (PretrainedSDFDecoderDir, absolute), with ``UseCovarianceLoss`` added
    (the shipped config leaves it off) so both latent-batch losses run:
    first the trainer's first step on K2 against the same trainer's float32
    autograd path from the same state, then the CLI for 2 epochs (8 steps)
    and ``-c latest`` for 1 more. ``training_launches`` is the training
    phase's K2 kernel launches per 8-chunk step. Returns the phase summary
    and K2's launches in the two runs."""
    import torch

    import msd_tpu_torch.workspace as ws
    from msd_tpu_torch.data.sdf_samples import sample_sdf_batch
    from msd_tpu_torch.models import build_decoder
    from msd_tpu_torch.ops import fused_train
    from msd_tpu_torch.ops.fused_train import fused_sdf_loss
    from msd_tpu_torch.train.stage1 import Stage1Trainer, step_seed
    from msd_tpu_torch.utils.checkpoint import load_model

    with open(GMM_SPECS) as f:
        specs = json.load(f)
    exp = os.path.join(root, "train_gmm_experiment")
    split_path = os.path.join(root, "train_split.json")
    pretrained = os.path.join(root, "train_experiment")
    changes = {"DataSource": os.path.join(root, "train_data", "SdfSamples"), "TrainSplit": split_path,
               "TestSplit": split_path, "NumEpochs": 2, "SnapshotFrequency": 2, "AdditionalSnapshots": [],
               "PretrainedSDFDecoderDir": pretrained, "UseCovarianceLoss": True}
    ws.save_experiment_specifications(exp, dict(specs, **changes))
    t0 = time.time()

    # step 0: the warm start, and the first step on K2 against autograd
    k2 = Stage1Trainer(exp, device="cuda")
    ref = build_decoder(specs["NetworkArch"], specs["CodeLength"], specs["NetworkSpecs"])
    load_model(pretrained, "latest", ref)
    for (n, a), (_, b) in zip(ref.state_dict().items(), k2.decoder.state_dict().items()):
        if not torch.equal(a, b.cpu()):
            raise AssertionError(f"warm start: {n} differs from the training phase's latest.pth")
    ag = Stage1Trainer(exp, specs=dict(k2.specs, UseFusedTrainKernel=False), device="cuda")
    if not k2.use_fused or ag.use_fused or k2.gmm is None:
        raise AssertionError("want K2 with the GMM prior, and its autograd path")
    dev = k2.device
    B, P = k2.scene_per_batch, k2.num_samp_per_scene
    rng = np.random.default_rng(k2.seed + 1)  # the CLI run's first batch
    idx = torch.as_tensor(rng.permutation(k2.num_scenes)[:B], device=dev)
    pos, pc, neg, nc = k2.dataset.device_arrays(dev)
    gen = torch.Generator(device=dev).manual_seed(step_seed(k2.seed, 1))
    batch = sample_sdf_batch(pos, pc, neg, nc, idx, P, gen)
    lrs = [s.get_learning_rate(1, []) for s in k2.lr_schedules]
    fused_train.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    aux_k2, g_k2 = first_step_grads(k2, idx, batch, lrs)
    if fused_train.VARIANT_LAUNCHES["b"] != 1 or fused_train.LAUNCHES != 1:
        raise AssertionError(f"K2 launches in the first step: {fused_train.VARIANT_LAUNCHES}, want b once")
    aux_ag, g_ag = first_step_grads(ag, idx, batch, lrs)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del k2, ag
    torch.cuda.empty_cache()
    vs_autograd = {k: _cmp(g_k2[k], g_ag[k]) for k in g_ag}
    loss_rel = {k: abs(aux_k2[k] - aux_ag[k]) / max(abs(aux_ag[k]), 1e-30)
                for k in ("sdf", "eikonal", "covariance", "gmm")}
    bad = [k for k, r in vs_autograd.items()
           if (r["rel"] > GMM_GRAD_TOL if k.startswith("gmm.")
               else r["rel"] > K2_TOL["autograd_grad"] or r["cos"] < K2_TOL["autograd_cos"])]
    bad += [k for k, r in loss_rel.items()
            if r > (GMM_GRAD_TOL if k in ("covariance", "gmm") else K2_TOL["autograd_loss"])]
    if bad or not any(k.startswith("gmm.") for k in g_ag):
        raise AssertionError(f"first step, K2 vs float32 autograd: {bad}: "
                             f"{json.dumps({'grads': vs_autograd, 'loss_rel': loss_rel})}")
    t_check = time.time() - t0

    recorder = ScalarRecorder()
    fused_train.reset_launches()
    t0 = time.time()
    trainer = run_cli(["-e", exp, "--device", "cuda", "--quiet"], recorder)
    t_first = time.time() - t0
    launches = {"first": {"calls": fused_train.LAUNCHES, "variants": dict(fused_train.VARIANT_LAUNCHES),
                          "kernels": dict(fused_train.KERNEL_LAUNCHES)}}
    steps_first = len(trainer.loss_log)
    chunks = -(-B // max(1, fused_train.CHUNK_POINTS // P))
    want = {k: v * chunks / 8 * steps_first for k, v in training_launches.items()}
    if (steps_first != 8 or fused_train.VARIANT_LAUNCHES["b"] != 8 or fused_train.LAUNCHES != 8
            or dict(fused_train.KERNEL_LAUNCHES) != want):
        raise AssertionError(f"{steps_first} steps, K2 launches {json.dumps(launches)}; want b once per step, "
                             f"kernels {want}")
    mu = {k: v.clone() for k, v in trainer.optimizer.mu["gmm"].items()}
    nu = {k: v.clone() for k, v in trainer.optimizer.nu["gmm"].items()}
    del trainer
    resumed_check = Stage1Trainer(exp, device="cuda")
    fresh = {k: v.detach().clone() for k, v in resumed_check.gmm.items()}
    resumed_check.resume("latest")
    if not all(torch.equal(resumed_check.optimizer.mu["gmm"][k], mu[k])
               and torch.equal(resumed_check.optimizer.nu["gmm"][k], nu[k]) for k in mu):
        raise AssertionError("the GMM prior's Adam moments changed through the checkpoint")
    if not all(torch.equal(resumed_check.gmm[k], fresh[k]) for k in fresh):
        raise AssertionError("resume changed the GMM parameters (msd_tpu starts them afresh from the seed)")
    del resumed_check

    ws.save_experiment_specifications(exp, dict(specs, **dict(changes, NumEpochs=3)))
    fused_train.reset_launches()
    resumed = run_cli(["-e", exp, "-c", "latest", "--device", "cuda", "--quiet"], recorder)
    launches["resumed"] = {"calls": fused_train.LAUNCHES, "variants": dict(fused_train.VARIANT_LAUNCHES)}
    if fused_train.VARIANT_LAUNCHES["b"] != 4 or fused_train.LAUNCHES != 4 or len(resumed.loss_log) != 12:
        raise AssertionError(f"resumed run: K2 {json.dumps(launches['resumed'])}, {len(resumed.loss_log)} "
                             "losses; want b once per step, 12 losses")
    scalars = finite_scalars(recorder, GMM_SCALARS, 3)

    step_ms, idx, batch = step_times(resumed, seed)
    step_med = float(np.median(step_ms[1:]))

    def k2_call():
        with torch.no_grad():
            fused_sdf_loss(resumed.decoder, resumed.latents[idx], batch[:3].permute(1, 2, 0).contiguous(), batch[3],
                           resumed.clamp_dist, True, B * P)

    k2_ms = time_ms(k2_call)
    profile = profile_steps(lambda: resumed.step(idx, batch, 9, 5e-4, 1e-3), 3)

    def step_ms_with(latent_losses):  # CUDA events; GMM prior and covariance switched as the specs would
        resumed.use_gmm_prior = resumed.use_covariance = latent_losses
        return time_ms(lambda: resumed.step(idx, batch, 9, 5e-4, 1e-3), reps=5, warmup=1)

    # in turns on, off, off, on (off: the GMM group's Adam update still runs, on zero gradients)
    latent_losses_ab = {f"{i}_{'on' if on else 'off'}": step_ms_with(on) for i, on in enumerate((1, 0, 0, 1))}
    resumed.use_gmm_prior = resumed.use_covariance = True
    return {"source": os.path.relpath(GMM_SPECS, ROOT), "changed": changes | {"NumEpochs (resume)": 3},
            "scenes_per_batch": B, "chunks_per_step": chunks, "check_seconds": t_check,
            "check_peak_mem_gb": peak_gb,
            "first_run_seconds": t_first, "epoch_losses": resumed.loss_log_epoch, "scalars": scalars,
            "first_step_vs_autograd": {"loss_rel": loss_rel, "grads": vs_autograd},
            "k2_launches": launches, "step_ms_median": step_med, "step_ms": step_ms, "k2_ms_in_step": k2_ms,
            "k2_share_of_step": k2_ms / step_med, "profile": profile,
            "step_ms_latent_losses_ab": latent_losses_ab}, launches["first"]["calls"] + launches["resumed"]["calls"]


def train_iso(root, specs, seed):
    """The flagship Stage 1 with isometry and grad-metric isotropy (mixup
    with probability 0.5; 256 near-surface points on a random 8 of the
    batch's 16 scenes) through the CLI for 4 steps on the training phase's
    data: the trainer must take the autograd path and say why, and K2 must
    not launch. Returns the phase summary."""
    import torch

    import msd_tpu_torch.workspace as ws
    from msd_tpu_torch.ops import fused_train

    exp = os.path.join(root, "train_iso_experiment")
    split_path = os.path.join(root, "train_split.json")
    changes = {"DataSource": os.path.join(root, "train_data", "SdfSamples"), "TrainSplit": split_path,
               "TestSplit": split_path, "NumEpochs": 1, "SnapshotFrequency": 1, "AdditionalSnapshots": [],
               "ScenesPerBatch": 16, "UseIsometryLoss": True, "UseGradMetricIsotropyLoss": True,
               "UseIsometryMixup": True, "IsometryMixupProb": 0.5, "IsometryNumPoints": 256,
               "IsometryScenesPerBatch": 8}
    ws.save_experiment_specifications(exp, dict(specs, **changes))
    recorder = ScalarRecorder()
    fused_train.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    log = os.path.join(root, "train_iso.log")
    trainer = run_cli(["-e", exp, "--device", "cuda", "--log", log], recorder)
    seconds = time.time() - t0
    with open(log) as f:
        reason = next((ln.strip() for ln in f if "Stage-1 step takes the autograd path" in ln), "")
    if (trainer.use_fused or fused_train.LAUNCHES or "UseIsometryLoss is on" not in reason
            or "UseGradMetricIsotropyLoss is on" not in reason or len(trainer.loss_log) != 4):
        raise AssertionError(f"isometry run: fused {trainer.use_fused}, K2 launches {fused_train.LAUNCHES}, "
                             f"reason {reason!r}, {len(trainer.loss_log)} steps; want the autograd path, 4 steps")
    scalars = finite_scalars(recorder, ISO_SCALARS, 1)
    step_ms, _, _ = step_times(trainer, seed, n=5)
    return {"changed": changes, "steps": len(trainer.loss_log), "seconds": seconds, "reason": reason,
            "k2_launches": fused_train.LAUNCHES, "scalars": scalars, "step_ms_median": float(np.median(step_ms[1:])),
            "step_ms": step_ms, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


# The data-parallel phase: step-1 losses against the one-process run's to
# 1e-5 relative, the summed pre-Adam gradients to 1e-3 relative Frobenius
# (the same bf16 per-point values, float32 sums in another order).
DP_TOL = {"loss": 1e-5, "grad": 1e-3}


def dp_steps(trainer, seed, steps):
    """``steps`` Stage-1 steps on seeded batches; returns (per-step
    metrics, the first step's pre-Adam gradients of the decoder and the
    latent table, on the CPU, step milliseconds)."""
    import torch

    from msd_tpu_torch.data.sdf_samples import sample_sdf_batch
    from msd_tpu_torch.train.stage1 import step_seed

    dev = trainer.device
    B, P = trainer.scene_per_batch, trainer.num_samp_per_scene
    pos, pc, neg, nc = trainer.dataset.device_arrays(dev)
    rng = np.random.default_rng(seed)
    auxs, grads, ms = [], None, []
    for s in range(steps):
        idx = torch.as_tensor(rng.permutation(trainer.num_scenes)[:B], device=dev)
        batch = sample_sdf_batch(pos, pc, neg, nc, idx, P, torch.Generator(device=dev).manual_seed(step_seed(seed, s)))
        torch.cuda.synchronize()
        t = time.perf_counter()
        aux = trainer.step(idx, batch, 1, 5e-4, 1e-3)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        auxs.append({k: float(v) for k, v in aux.items()})
        if s == 0:
            grads = torch.cat([p.grad.reshape(-1) for p in trainer.decoder.parameters()]
                              + [trainer.latents.grad.reshape(-1)]).cpu()
    return auxs, grads, ms


def dp_stage1_rank(group, exp, seed, steps):
    """A rank of the data-parallel Stage-1 run (spawned by ``dp``)."""
    from msd_tpu_torch.ops import fused_train
    from msd_tpu_torch.train.stage1 import Stage1Trainer

    trainer = Stage1Trainer(exp, group=group)
    fused_train.reset_launches()
    auxs, grads, ms = dp_steps(trainer, seed, steps)
    return auxs, grads, ms, dict(fused_train.VARIANT_LAUNCHES), fused_train.LAUNCHES


def dp_stage2_rank(group, exp, epochs):
    """A rank of the data-parallel Stage-2 run (spawned by ``dp``)."""
    from msd_tpu_torch.ops import fused_train
    from msd_tpu_torch.train.stage2 import Stage2Trainer

    trainer = Stage2Trainer(exp, group=group)
    fused_train.reset_launches()
    trainer.train(num_epochs=epochs)
    return trainer.loss_log, dict(fused_train.VARIANT_LAUNCHES)


def dp(root, specs, seed, steps=3, ranks=3):
    """Data-parallel training on ``ranks`` ranks: the flagship Stage-1 at
    ScenesPerBatch 32, which pads to 33 so that every rank runs K2 e, for
    ``steps`` steps, against the one-process run on the same batches; then
    two epochs of the Stage-2 phase's experiment on 2 ranks (K2 d split by
    scenes) against one process. NCCL with one GPU per rank where there are
    enough GPUs, else gloo with every rank on cuda:0. Returns the phase
    summary and K2 e's launches."""
    import torch

    import msd_tpu_torch.workspace as ws
    from msd_tpu_torch.parallel import run_ranks
    from msd_tpu_torch.train.stage1 import Stage1Trainer
    from msd_tpu_torch.train.stage2 import Stage2Trainer

    def placement(n):
        if torch.cuda.device_count() >= n:
            return "nccl", [f"cuda:{r}" for r in range(n)]
        return "gloo", ["cuda:0"] * n

    split_path = os.path.join(root, "train_split.json")
    exp = os.path.join(root, "dp_experiment")
    ws.save_experiment_specifications(exp, dict(
        specs, DataSource=os.path.join(root, "train_data", "SdfSamples"), TrainSplit=split_path,
        TestSplit=split_path, ScenesPerBatch=32))
    backend, devices = placement(ranks)
    t0 = time.time()
    out = run_ranks(dp_stage1_rank, ranks, (exp, seed, steps), backend=backend, devices=devices, timeout=600,
                    workdir=root)
    dp_seconds = time.time() - t0
    one = Stage1Trainer(exp, device="cuda")
    ref_auxs, ref_grads, ref_ms = dp_steps(one, seed, steps)
    per_rank = []
    for r, (auxs, grads, ms, launches, total) in enumerate(out):
        loss_rel = {k: abs(auxs[0][k] - ref_auxs[0][k]) / max(abs(ref_auxs[0][k]), 1e-30)
                    for k in ("sdf", "eikonal", "reg", "total")}
        g = _cmp(grads, ref_grads)
        if max(loss_rel.values()) > DP_TOL["loss"] or g["rel"] > DP_TOL["grad"]:
            raise AssertionError(f"rank {r} step 1 vs one process: {json.dumps({'loss': loss_rel, 'grad': g})}")
        if launches["e"] != steps or total != steps:
            raise AssertionError(f"rank {r}: K2 launches {launches} ({total}), want K2 e once per step")
        per_rank.append({"rank": r, "step1_loss_rel": loss_rel, "step1_grad": g, "step_ms": ms,
                         "losses": [a["total"] for a in auxs], "k2_launches": launches})
    stage1 = {"backend": backend, "devices": devices, "ranks": ranks, "scenes_per_batch": 32,
              "padded_to": 33, "steps": steps, "seconds": dp_seconds, "per_rank": per_rank,
              "one_process": {"losses": [a["total"] for a in ref_auxs], "step_ms": ref_ms}}
    del one

    s2_specs = ws.load_experiment_specifications(os.path.join(root, "stage2_experiment"))
    s2 = {}
    for name in ("stage2_dp_experiment", "stage2_one_experiment"):
        s2[name] = os.path.join(root, name)
        ws.save_experiment_specifications(s2[name], dict(s2_specs, NumEpochs=2))
    backend2, devices2 = placement(2)
    out2 = run_ranks(dp_stage2_rank, 2, (s2["stage2_dp_experiment"], 2), backend=backend2, devices=devices2,
                     timeout=600, workdir=root)
    one2 = Stage2Trainer(s2["stage2_one_experiment"], device="cuda")
    one2.train(num_epochs=2)
    ref = np.asarray(one2.loss_log)
    for r, (losses, launches) in enumerate(out2):
        rel = float(np.max(np.abs(np.asarray(losses) - ref) / np.abs(ref)))
        if len(losses) != len(ref) or rel > 1e-4 or launches["d"] != len(ref):
            raise AssertionError(f"Stage-2 rank {r}: losses {losses} vs {ref.tolist()}, K2 {launches}")
    stage2 = {"backend": backend2, "devices": devices2, "ranks": 2, "steps": len(ref),
              "losses": [lo for lo, _ in out2], "one_process_losses": ref.tolist(),
              "k2_launches": [la for _, la in out2]}
    return {"stage1": stage1, "stage2": stage2,
            "note": "a correctness drive of the multi-rank code and kernels; several ranks on one card "
                    "share it, so the times are no scaling figure"}, sum(o[3]["e"] for o in out)


def serve(root, specs, decoder, seed):
    """The port's serving path on a temporary experiment; returns
    (per-shape summaries, evaluate results, seconds of evaluate, K1
    launches, K1 launches by route, the kernel-against-plain mesh check,
    the host mesher's A/B, the streaming phase and its K1 launches, the
    fit's iterations by route, the fit kernels' launches)."""
    import torch

    from msd_tpu_torch import evaluate as evaluate_cli
    from msd_tpu_torch import mesh
    from msd_tpu_torch import reconstruct as reconstruct_cli
    from msd_tpu_torch.ops import fused_fit, fused_mlp
    from msd_tpu_torch.train import reconstruct
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

    # every K1 call of create_mesh between CUDA events, for K1's seconds per shape
    events, untimed = [], mesh.fused_eval

    def timed(*args):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = untimed(*args)
        b.record()
        events.append((a, b))
        return out

    fused_mlp.LAUNCHES = 0
    fused_mlp.ROUTE_LAUNCHES = dict.fromkeys(fused_mlp.ROUTES, 0)
    fused_fit.reset_launches()
    mesh.fused_eval = timed
    fit_before = dict(reconstruct.FIT_ITERATIONS)
    try:
        summary = reconstruct_cli.main(common + [
            "-c", "latest", "-d", os.path.join(data_dir, "SdfSamples"),
            "--iters", "800", "--mesh_resolution", "256", "--device", "cuda",
        ])
    finally:
        mesh.fused_eval = untimed
    torch.cuda.synchronize()
    fit_launches = dict(fused_fit.LAUNCHES)
    fit_iterations = {k: reconstruct.FIT_ITERATIONS[k] - fit_before[k] for k in fit_before}
    if fit_iterations["autograd"] or not fit_iterations["kernel"]:
        raise AssertionError(f"serving: fit iterations by route {fit_iterations}: not all on the kernels")
    # the CLI fits one shape at a time
    per_iteration = fused_fit.iteration_launches(
        len(decoder.layer_shapes) - 1, fused_fit.padded_rows(reconstruct_cli.NUM_SAMPLES) // fused_fit.TILE)
    if fit_launches != {k: v * fit_iterations["kernel"] for k, v in per_iteration.items()}:
        raise AssertionError(f"serving: fit launches {fit_launches} are not {per_iteration} times "
                             f"{fit_iterations['kernel']} iterations")
    for s in summary:  # each shape's K1 calls, in order
        s["k1_seconds"] = sum(a.elapsed_time(b) for a, b in events[:s["k1_launches"]]) / 1e3
        events = events[s["k1_launches"]:]
    t0 = time.time()
    results = evaluate_cli.main(common + ["-c", "1", "-d", data_dir])
    t_eval = time.time() - t0
    launches = fused_mlp.LAUNCHES
    routes = dict(fused_mlp.ROUTE_LAUNCHES)
    if routes != dict(dict.fromkeys(fused_mlp.ROUTES, 0), wgmma=launches):
        raise AssertionError(f"serving: K1 launches {launches} by route {routes}: not all on wgmma")

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
    code = torch_load(os.path.join(exp_dir, "Reconstructions", "1", "Codes", summary[0]["shape"] + ".pth"))
    return (summary, results, t_eval, launches, routes, mesh_pair(decoder, code), mesher_ab(decoder, code, root),
            streaming(decoder, code, root, specs, seed), fit_iterations, fit_launches)


def serving_variants(root, specs, decoder, seed):
    """The serving path on the decoders the other two K1 kernels serve, as
    a user runs it, after ``serve`` (its data, split and first latent under
    ``root``), K1's counters set to 0 just before each run and read just
    after:

    * ln: the flagship-width LayerNorm decoder (``ln_decoder``) saved as an
      experiment and reconstructed by ``python -m msd_tpu_torch.reconstruct``
      on the first shape (800 x 8000: the fit on float32 autograd, no K1),
      then meshed by create_mesh, streamed at N=257 through PointEvaluator:
      every K1 launch on the wgmma route (its LayerNorm instantiation);
    * f32: ``create_mesh(eval_dtype=torch.float32)`` of the flagship on the
      serving phase's first latent at N=257 (streamed): every K1 launch on
      the f32 route; its vertex count beside the bf16 mesh's.

    Returns (summary, K1 launches of the ln run, of the f32 run)."""
    import torch

    from msd_tpu_torch import mesh
    from msd_tpu_torch import reconstruct as reconstruct_cli
    from msd_tpu_torch.ops import fused_mlp
    from msd_tpu_torch.utils.checkpoint import save_model

    dev = next(decoder.parameters()).device
    ln_dec, ln_net = ln_decoder(specs, seed, dev)
    exp_dir, data_dir = os.path.join(root, "experiment_ln"), os.path.join(root, "data")
    os.makedirs(exp_dir)
    with open(os.path.join(exp_dir, "specs.json"), "w") as f:
        json.dump(dict(specs, NetworkSpecs=ln_net), f, indent=2)
    save_model(exp_dir, "latest.pth", ln_dec, 1)
    with open(os.path.join(root, "smoke_test_split.json")) as f:
        split = json.load(f)
    first = split["smoke"]["ellipsoid"][0]
    split_path = os.path.join(root, "smoke_test_split_ln.json")
    with open(split_path, "w") as f:
        json.dump({"smoke": {"ellipsoid": [first]}}, f)

    def counted(fn):
        fused_mlp.LAUNCHES = 0
        fused_mlp.ROUTE_LAUNCHES = dict.fromkeys(fused_mlp.ROUTES, 0)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, fused_mlp.LAUNCHES, dict(fused_mlp.ROUTE_LAUNCHES)

    summary, seconds, ln_launches, ln_routes = counted(lambda: reconstruct_cli.main([
        "-e", exp_dir, "-s", split_path, "--quiet", "-c", "latest", "-d", os.path.join(data_dir, "SdfSamples"),
        "--iters", "800", "--mesh_resolution", "256", "--device", "cuda"]))
    shape = summary[0]
    if ln_launches <= 0 or ln_routes != dict(dict.fromkeys(fused_mlp.ROUTES, 0), wgmma=ln_launches):
        raise AssertionError(f"serving_variants ln: K1 launches {ln_launches} by route {ln_routes}")
    if not os.path.isfile(os.path.join(exp_dir, "Reconstructions", "1", "Meshes", first + ".ply")):
        raise AssertionError(f"serving_variants ln: no mesh for {first}: {shape}")
    if shape["faces"] <= 0 or not shape["loss_last_tenth"] < shape["loss_first_tenth"]:
        raise AssertionError(f"serving_variants ln: empty mesh or the loss did not fall: {shape}")

    code = torch_load(os.path.join(root, "experiment", "Reconstructions", "1", "Codes", first + ".pth"))
    code = code.reshape(-1).to(dev)
    N = mesh._snap_n(257)
    (v32, f32), s32, f32_launches, f32_routes = counted(
        lambda: mesh.create_mesh(decoder, code, N=N, return_mesh=True, eval_dtype=torch.float32))
    stream32 = dict(mesh.LAST_STREAMING_STATS)
    (v16, f16), s16, bf16_launches, _ = counted(lambda: mesh.create_mesh(decoder, code, N=N, return_mesh=True))
    if not stream32:
        raise AssertionError("serving_variants f32: create_mesh did not stream")
    if f32_launches <= 0 or f32_routes != dict(dict.fromkeys(fused_mlp.ROUTES, 0), f32=f32_launches):
        raise AssertionError(f"serving_variants f32: K1 launches {f32_launches} by route {f32_routes}")
    if f32.shape[0] <= 0 or abs(v32.shape[0] - v16.shape[0]) > 0.01 * v16.shape[0]:
        raise AssertionError(f"serving_variants f32: {v32.shape[0]} vertices against {v16.shape[0]} in bf16")
    return {
        "ln": {"net": ln_net, "shape": first, "seconds": seconds, "k1_launches": ln_launches,
               "k1_route_launches": ln_routes, **{k: shape[k] for k in shape if k != "shape"}},
        "f32": {"N": N, "seconds": s32, "k1_launches": f32_launches, "k1_route_launches": f32_routes,
                "verts": int(v32.shape[0]), "faces": int(f32.shape[0]),
                "stream": {k: stream32.get(k) for k in STREAM_STAT_KEYS},
                "bf16_seconds": s16, "bf16_k1_launches": bf16_launches, "bf16_verts": int(v16.shape[0])},
    }, ln_launches, f32_launches


def torch_load(path):
    import torch

    return torch.load(path, map_location="cpu")


# The kernel's mesh against the plain version's, one reconstructed latent at
# N=257 (bf16: summation orders differ, so a vertex near a flipped rounding
# moves): symmetric Chamfer between the two vertex sets, relative difference
# of active blocks and of vertex counts. Measured on an H100 (PERF.md):
# 6.6e-8, 1.8e-4 (11385 against 11383 blocks) and 6.1e-5; the limits keep
# a margin of at least 10x.
MESH_TOL = {"chamfer": 1e-6, "blocks": 2e-3, "verts": 1e-3}


def mesh_pair(decoder, latent):
    """Mesh ``latent`` at N=257 through K1 and through fused_eval_plain on
    the card; raises past ``MESH_TOL``."""
    import torch

    from msd_tpu_torch import mesh
    from msd_tpu_torch.metrics.chamfer import compute_chamfer
    from msd_tpu_torch.ops.fused_mlp import fused_eval_plain

    class PlainEvaluator(mesh.PointEvaluator):
        @torch.no_grad()
        def eval_points(self, latent, pts):
            pts = torch.as_tensor(pts, dtype=torch.float32, device=self.device).reshape(-1, 3)
            latent = torch.as_tensor(latent, dtype=torch.float32, device=self.device).reshape(-1)
            self.n_evaluated += pts.shape[0]
            outs = [fused_eval_plain(self.spec, latent, pts[i:i + 2**20]) for i in range(0, pts.shape[0], 2**20)]
            return torch.cat(outs) if outs else pts.new_zeros(0)

    latent = latent.reshape(-1).to(next(decoder.parameters()).device)
    N = mesh._snap_n(257)
    b = mesh._pick_block(N, 0.1, 1.3)
    r = {"N": N}
    meshes = {}
    for name, ev in (("kernel", mesh.PointEvaluator(decoder)), ("plain", PlainEvaluator(decoder))):
        _, _, _, stats = mesh._sparse_blocks(latent, N, b, 1.3, ev)
        verts, faces = mesh.create_mesh(decoder, latent, N=N, return_mesh=True, evaluator=ev)
        meshes[name] = verts
        r[name] = {"active_blocks": stats["active_blocks"], "verts": int(verts.shape[0]), "faces": int(faces.shape[0])}
    r["chamfer"] = compute_chamfer(meshes["kernel"], meshes["plain"])[0]
    r["blocks_rel"] = abs(r["kernel"]["active_blocks"] - r["plain"]["active_blocks"]) / max(r["plain"]["active_blocks"], 1)
    r["verts_rel"] = abs(r["kernel"]["verts"] - r["plain"]["verts"]) / max(r["plain"]["verts"], 1)
    r["tol"] = MESH_TOL
    if not (r["chamfer"] <= MESH_TOL["chamfer"] and r["blocks_rel"] <= MESH_TOL["blocks"]
            and r["verts_rel"] <= MESH_TOL["verts"]):
        raise AssertionError(f"serving: kernel mesh against plain mesh {r}")
    return r


MESHER_TOL = {"verts": 1e-5}


def float32_mesh(latent, N, ev, filename=None):
    """``create_mesh``'s non-streaming route (the route of an evaluator off
    the card): ``mesh._create_mesh_sparse``, then the PLY write."""
    from msd_tpu_torch import mesh
    from msd_tpu_torch.data.mesh_io import save_ply

    verts, faces = mesh._create_mesh_sparse(latent, N, mesh._pick_block(N, 0.1, 1.3), 1.3, ev)
    if filename:
        save_ply(filename + ".ply", verts, faces)
    return verts, faces


def mesher_ab(decoder, latent, out_dir, reps=3):
    """The host mesher's A/B on one latent at N=257: the sparse path's
    block values meshed through the C++ mesher (the non-streaming
    ``create_mesh``'s route) and through the numpy route, equal counts and
    vertex sets within ``MESHER_TOL``, each timed; then ``create_mesh``
    seconds per shape on that route (``float32_mesh``, a new evaluator each
    time as ``create_mesh`` makes one; median of ``reps``, writing the PLY)
    split into K1 (CUDA events, the
    corner lattice's host-to-device copy included), the device-to-host
    copy of the SDF values (bytes, ms), the host's block selection, the
    mesher (median of ``reps`` each, in turns) and the PLY write. Returns
    the summary (with K1's launches)."""
    import torch
    from scipy.spatial import cKDTree

    from msd_tpu_torch import mesh
    from msd_tpu_torch.data.mesh_io import save_ply
    from msd_tpu_torch.native import load_native
    from msd_tpu_torch.ops import fused_mlp
    from msd_tpu_torch.ops.marching_cubes import marching_tetrahedra_blocks

    class SplitEvaluator(mesh.PointEvaluator):
        """K1 between CUDA events, then the values copied to the host."""

        k1_ms = d2h_ms = 0.0
        d2h_bytes = 0

        @torch.no_grad()
        def eval_points(self, latent, pts):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            vals = super().eval_points(latent, pts)
            b.record()
            torch.cuda.synchronize()
            self.k1_ms += a.elapsed_time(b)
            t = time.perf_counter()
            host = vals.cpu()
            self.d2h_ms += (time.perf_counter() - t) * 1e3
            self.d2h_bytes += host.numel() * host.element_size()
            return host

    latent = latent.reshape(-1).to(next(decoder.parameters()).device)
    N = mesh._snap_n(257)
    b = mesh._pick_block(N, 0.1, 1.3)
    kw = dict(level=0.0, spacing=(2.0 / (N - 1),) * 3, origin=(-1.0, -1.0, -1.0))
    fused_mlp.LAUNCHES = 0
    ev = SplitEvaluator(decoder)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, abi, block_vals, stats = mesh._sparse_blocks(latent, N, b, 1.3, ev)
    sampling_s = time.perf_counter() - t0
    load_native()  # built in the build phase; a rehearsal builds it here, untimed
    routes = {"native": {"seconds": []}, "numpy": {"seconds": []}}
    for _ in range(reps):  # in turns
        for name, native in (("native", True), ("numpy", False)):
            t0 = time.perf_counter()
            verts, faces = marching_tetrahedra_blocks(block_vals, abi * b, N, use_native=native, **kw)
            routes[name]["seconds"].append(time.perf_counter() - t0)
            routes[name].update(verts=int(verts.shape[0]), faces=int(faces.shape[0]), mesh=(verts, faces))
    for r in routes.values():
        r["seconds_median"] = float(np.median(r["seconds"]))
    (v, f), (rv, rf) = routes["native"].pop("mesh"), routes["numpy"].pop("mesh")
    dist = float(cKDTree(rv).query(v)[0].max()) if len(v) == len(rv) else float("inf")
    if v.shape != rv.shape or f.shape != rf.shape or dist > MESHER_TOL["verts"]:
        raise AssertionError(f"mesher A/B: native {v.shape}/{f.shape} against numpy {rv.shape}/{rf.shape}, "
                             f"vertex sets {dist} apart")
    t0 = time.perf_counter()
    save_ply(os.path.join(out_dir, "mesher_ab.ply"), v, f)
    ply_s = time.perf_counter() - t0
    create_s = []
    for i in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float32_mesh(latent, N, mesh.PointEvaluator(decoder), os.path.join(out_dir, f"create_mesh_{i}"))
        create_s.append(time.perf_counter() - t0)
    k1_s, d2h_s = ev.k1_ms / 1e3, ev.d2h_ms / 1e3
    split = {"k1_s": k1_s, "d2h_s": d2h_s, "d2h_bytes": ev.d2h_bytes,
             "d2h_gb_per_s": ev.d2h_bytes / d2h_s / 1e9 if d2h_s > 0 else None,
             "host_block_selection_s": sampling_s - k1_s - d2h_s, "mesher_s": routes["native"]["seconds_median"],
             "ply_write_s": ply_s}
    create_med = float(np.median(create_s))
    split["sum_s"] = sum(split[k] for k in ("k1_s", "d2h_s", "host_block_selection_s", "mesher_s", "ply_write_s"))
    split["create_mesh_minus_sum_s"] = create_med - split["sum_s"]
    return {"N": N, "active_blocks": stats["active_blocks"], "points_evaluated": stats["evaluated"],
            "routes": routes, "verts_max_dist": dist, "tol": MESHER_TOL,
            "native_speedup": routes["numpy"]["seconds_median"] / routes["native"]["seconds_median"],
            "create_mesh_seconds": create_s, "create_mesh_seconds_median": create_med,
            "create_mesh_split": split, "k1_launches": fused_mlp.LAUNCHES}


# msd_tpu's bounds of a streamed mesh, in voxels h
# (tests/test_streaming_mesh.py:35-38, :58-62, :86-131): the f16 mesh
# against the float32 (non-streaming) mesh, the nearest float32 vertex and
# the vertex count (max(3, 0.1%)); the int8 and packed meshes against the
# f16 mesh, whose faces they share (the codecs keep every float16 sign),
# the float32 decoder's value at each vertex against its value at the f16 vertex.
STREAM_TOL = {"f16": 0.05, "int8": 0.08, "packed": 0.06, "verts_rel": 1e-3, "verts_abs": 3}
STREAM_CODECS = ("packed", "int8", "f16")


def open_edges(verts, faces):
    """(edges without two faces that have an end inside the volume, edges
    without two faces on the volume's faces)."""
    edges = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]), axis=1).astype(np.int64)
    keys, counts = np.unique(edges[:, 0] * len(verts) + edges[:, 1], return_counts=True)
    inside = (np.abs(verts) < 1 - 1e-6).all(axis=1)
    inner = inside[keys // len(verts)] | inside[keys % len(verts)]
    return int(((counts != 2) & inner).sum()), int(((counts != 2) & ~inner).sum())


ELLIPSOID_AXES = (0.55, 0.4, 0.45)


def ellipsoid_decoder(specs, seed, dev, steps=400, lr=5e-4):
    """A decoder of ``specs`` (seeded) fitted for ``steps`` Adam steps of
    4096 uniform points to an ellipsoid's distance field, for a field close
    to 1-Lipschitz; returns (decoder, latent)."""
    import torch

    from msd_tpu_torch.models import build_decoder
    from msd_tpu_torch.models.deepsdf import decode_sdf

    g = torch.Generator().manual_seed(seed + 15)
    decoder = build_decoder(specs["NetworkArch"], specs["CodeLength"], specs["NetworkSpecs"], generator=g).to(dev)
    latent = (0.01 * torch.randn(specs["CodeLength"], generator=g)).to(dev)
    axes = torch.tensor(ELLIPSOID_AXES, device=dev)
    opt = torch.optim.Adam(decoder.parameters(), lr=lr)
    decoder.train()
    for _ in range(steps):
        x = (torch.rand(4096, 3, generator=g) * 2 - 1).to(dev)
        target = (torch.linalg.norm(x / axes, dim=1) - 1) * axes.min()
        loss = (decode_sdf(decoder, latent, x)[:, 0] - target).abs().mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
    return decoder.eval(), latent, loss.item()


def sdf_float32(decoder, latent, pts, chunk=2**20):
    """The decoder's float32 values at ``pts`` (numpy [n, 3]), by its plain
    forward (no kernel: K1's bfloat16 rounding would hide a codec's share)."""
    import torch

    from msd_tpu_torch.models.deepsdf import decode_sdf

    dev = next(decoder.parameters()).device
    with torch.no_grad():
        return np.concatenate([decode_sdf(decoder, latent, torch.from_numpy(pts[i:i + chunk]).to(dev))[:, 0].cpu().numpy()
                               for i in range(0, len(pts), chunk)])


def stream_field(decoder, latent, out_dir, reps, hold_bounds):
    """``streaming``'s runs on one field; returns (summary, K1 launches of
    every streamed ``create_mesh`` call, warm-ups included; the float32
    route's are in the summary only)."""
    from scipy.spatial import cKDTree

    from msd_tpu_torch import mesh
    from msd_tpu_torch.ops import fused_mlp

    dev = next(decoder.parameters()).device
    latent = latent.reshape(-1).to(dev)
    ev = mesh.PointEvaluator(decoder)
    out, stream_launches = {}, 0

    def timed(name, run):
        seconds, launches = [], []
        for i in range(reps + 1):  # a warm-up run first
            fused_mlp.LAUNCHES = 0
            _sync(dev)
            t0 = time.perf_counter()
            run(os.path.join(out_dir, f"{name}_{i}"))
            seconds.append(time.perf_counter() - t0)
            launches.append(fused_mlp.LAUNCHES)
        if dev.type == "cuda" and min(launches) <= 0:
            raise AssertionError(f"streaming: {name} launched K1 no time: {launches}")
        r = {"seconds_warmup": seconds[0], "k1_launches": launches}
        if reps:
            r.update(seconds=seconds[1:], seconds_median=float(np.median(seconds[1:])))
        return r

    def streamed(N, codec):
        def run(filename):
            if mesh.create_mesh(decoder, latent, filename, N=N, evaluator=ev, value_codec=codec) is not True:
                raise AssertionError(f"streaming: N={N} {codec} found no surface")
        return run

    for N in (257, 513):
        h = 2.0 / (N - 1)
        r = {"float32": timed(f"float32_{N}", lambda filename: float32_mesh(latent, N, ev, filename))}
        pv, pf = float32_mesh(latent, N, ev)
        r["float32"].update(verts=int(pv.shape[0]), faces=int(pf.shape[0]), open_edges=open_edges(pv, pf))
        tree = cKDTree(pv)
        f16_mesh = None
        for codec in ("f16", "packed", "int8"):
            mesh.LAST_STREAMING_STATS.clear()
            c = timed(f"stream_{N}_{codec}", streamed(N, codec))
            c["stats"] = dict(mesh.LAST_STREAMING_STATS)
            if c["stats"].get("value_codec") != codec:
                raise AssertionError(f"streaming: N={N} {codec} did not stream: {c['stats']}")
            fused_mlp.LAUNCHES = 0
            v, f = mesh.create_mesh(decoder, latent, N=N, return_mesh=True, evaluator=ev, value_codec=codec)
            c["k1_launches"].append(fused_mlp.LAUNCHES)
            stream_launches += sum(c["k1_launches"])
            c.update(verts=int(v.shape[0]), faces=int(f.shape[0]), faces_equal_float32=bool(np.array_equal(f, pf)),
                     open_edges=open_edges(v, f), nearest_float32_vertex_h=float(tree.query(v)[0].max() / h))
            ok = c["open_edges"][0] <= r["float32"]["open_edges"][0]
            ok &= abs(len(v) - len(pv)) <= max(STREAM_TOL["verts_abs"], STREAM_TOL["verts_rel"] * len(pv))
            if codec == "f16":
                ok &= c["nearest_float32_vertex_h"] < STREAM_TOL["f16"] or not hold_bounds
                f16_mesh = v, f, sdf_float32(decoder, latent, v)
            else:
                c["faces_equal_f16"] = bool(np.array_equal(f, f16_mesh[1]))
                c["residual_change_h"] = float(np.abs(sdf_float32(decoder, latent, v) - f16_mesh[2]).max() / h)
                ok &= c["faces_equal_f16"] and (c["residual_change_h"] < STREAM_TOL[codec] or not hold_bounds)
            if not ok:
                raise AssertionError(f"streaming: N={N} {codec} against the float32 mesh: {c}")
            r[codec] = c
        if reps:
            r["speedup_packed"] = r["float32"]["seconds_median"] / r["packed"]["seconds_median"]
        out[f"N{N}"] = r
    return out, stream_launches


DEDUP_STATS = ("active_blocks", "dedup", "dedup_slabs", "dedup_retries", "exact_slabs", "evaluated", "t_stream",
               "t_mesher", "t_crossing", "t_refine", "crossing_blocks")


def dedup_ab(decoder, latent, out_dir, reps=3, sizes=(513, 257)):
    """The corner dedup against the plain stream on one field, in one run:
    MSD_STREAM_DEDUP off and on, interleaved, at N=513 (two levels, where
    "auto" dedups from 16384 blocks) and N=257 (one level, "on" forced),
    packed codec, the PLY written. Per arm: seconds per shape (median of
    ``reps`` after a warm-up), the last run's ``LAST_STREAMING_STATS`` and
    K1's launches of every call (the count set to 0 just before each call
    and read just after). Every dedup mesh must equal the plain mesh bit
    for bit, vertices and faces, and each arm must take its route. Returns
    (summary, K1 launches of every call)."""
    from msd_tpu_torch import mesh
    from msd_tpu_torch.ops import fused_mlp

    dev = next(decoder.parameters()).device
    latent = latent.reshape(-1).to(dev)
    ev = mesh.PointEvaluator(decoder)
    out, launches_all = {}, 0
    saved = os.environ.get("MSD_STREAM_DEDUP")
    try:
        for N in sizes:
            arms = {arm: {"seconds": [], "k1_launches": []} for arm in ("off", "on")}
            ref = None
            for i in range(reps + 1):  # a warm-up round first
                for arm, r in arms.items():
                    os.environ["MSD_STREAM_DEDUP"] = arm
                    fused_mlp.LAUNCHES = 0
                    _sync(dev)
                    t0 = time.perf_counter()
                    got = mesh.create_mesh(decoder, latent, os.path.join(out_dir, f"dedup_{N}_{arm}_{i}"), N=N,
                                           evaluator=ev, value_codec="packed", return_mesh=True)
                    _sync(dev)
                    r["seconds"].append(time.perf_counter() - t0)
                    r["k1_launches"].append(fused_mlp.LAUNCHES)
                    r["stats"] = {k: mesh.LAST_STREAMING_STATS.get(k) for k in DEDUP_STATS}
                    launched = dev.type != "cuda" or min(r["k1_launches"]) > 0
                    if got is False or r["stats"]["dedup"] != (arm == "on") or not launched:
                        raise AssertionError(f"dedup_ab: N={N} {arm} did not take its route: {r}")
                    if ref is None:
                        ref = got
                    elif not (np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])):
                        raise AssertionError(f"dedup_ab: N={N} {arm} run {i}: the mesh differs from the plain mesh "
                                             f"({got[0].shape} {got[1].shape} against {ref[0].shape} {ref[1].shape})")
            for r in arms.values():
                launches_all += sum(r["k1_launches"])
                r["seconds_warmup"] = r["seconds"].pop(0)
                r["seconds_median"] = float(np.median(r["seconds"]))
            out[f"N{N}"] = {**arms, "meshes_equal": True, "verts": int(ref[0].shape[0]), "faces": int(ref[1].shape[0]),
                            "on_over_off": arms["on"]["seconds_median"] / arms["off"]["seconds_median"],
                            "evaluated_on_over_off": arms["on"]["stats"]["evaluated"] / arms["off"]["stats"]["evaluated"]}
    finally:
        if saved is None:
            os.environ.pop("MSD_STREAM_DEDUP", None)
        else:
            os.environ["MSD_STREAM_DEDUP"] = saved
    return out, launches_all


def streaming(decoder, latent, out_dir, specs, seed, reps=3):
    """The streaming ``create_mesh`` (the route on the card) at N=257 (one
    refinement level) and N=513 (two levels), each with the packed, int8
    and f16 codecs, on the serving phase's first fitted latent: seconds per
    shape (median of ``reps`` after a warm-up, writing the PLY),
    ``LAST_STREAMING_STATS`` of the last timed run and K1's launches of
    every call (warm-up, timed runs, then one returning the mesh; the count
    set to 0 just before each call and read just after; none fails).
    Beside it, in the same run, the non-streaming route's seconds per shape
    (``float32_mesh``) and its mesh: the streamed meshes within
    ``STREAM_TOL``: every codec's vertex count against that mesh's, the int8
    and packed meshes with the f16 mesh's faces, and no open edge inside
    the volume that the float32 mesh does not have too; the f16 mesh's
    nearest float32 vertex and the int8 and packed residuals against the
    f16 mesh are measured here and held on a flagship-width decoder fitted
    to an ellipsoid's distance field (``ellipsoid_decoder``, one run per
    codec). msd_tpu's bounds assume a field close to 1-Lipschitz (codes
    saturate at 3 h and 2.5 h); the seeded decoder's field is far from
    one, and values that underflow float16 flip a sign now and then.
    Then ``dedup_ab`` on the serving latent. Returns the summary and K1's
    launches in the streamed calls."""
    dev = next(decoder.parameters()).device
    out = {"tol": STREAM_TOL}
    t0 = time.time()
    out["serving_latent"], launches = stream_field(decoder, latent, out_dir, reps, hold_bounds=False)
    out["serving_latent"]["seconds"] = time.time() - t0
    # the default environment dedups the two-level class (N=513) only
    default_dedup = {N: out["serving_latent"][f"N{N}"]["packed"]["stats"]["dedup"] for N in (257, 513)}
    if default_dedup != {257: False, 513: True}:
        raise AssertionError(f"streaming: default corner dedup {default_dedup}, expected at N=513 only")
    t0 = time.time()
    out["dedup_ab"], dedup_launches = dedup_ab(decoder, latent, out_dir, reps)
    out["dedup_ab"]["seconds"] = time.time() - t0
    launches += dedup_launches
    t0 = time.time()
    fitted, fitted_latent, loss = ellipsoid_decoder(specs, seed, dev)
    fit_s = time.time() - t0
    out["ellipsoid"], more = stream_field(fitted, fitted_latent, out_dir, 0, hold_bounds=True)
    out["ellipsoid"].update(fit_seconds=fit_s, fit_l1=loss, axes=ELLIPSOID_AXES, seconds=time.time() - t0)
    return out, launches + more


# Preprocessing (data preparation): four seeded hippocampus-like masks on a
# grid of 64 x 96 x 64 voxels at 1 mm, the CLIs at their defaults.
MASK_GRID = (64, 96, 64)
PREPROCESS_SHAPES = 4


def write_masks(mask_dir, n, seed):
    """``n`` seeded ellipsoid masks (uint8 NIfTI, 1 mm voxels) on
    ``MASK_GRID``, long along y as a hippocampus is."""
    from msd_tpu_torch.data.nifti import save_nifti

    os.makedirs(mask_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    x, y, z = np.meshgrid(*(np.arange(s) - (s - 1) / 2 for s in MASK_GRID), indexing="ij")
    for i in range(n):
        axes = rng.uniform([12.0, 30.0, 10.0], [18.0, 40.0, 16.0])
        c = rng.uniform(-3.0, 3.0, 3)
        mask = ((x - c[0]) / axes[0]) ** 2 + ((y - c[1]) / axes[1]) ** 2 + ((z - c[2]) / axes[2]) ** 2 < 1
        save_nifti(os.path.join(mask_dir, f"hippo_{i:03d}.nii.gz"), mask.astype(np.uint8), zooms=(1.0, 1.0, 1.0))


def cut_cap(path, share=0.12):
    """Remove the faces of an OBJ mesh whose centroid lies in the top
    ``share`` of its y extent, so the mesh is open; returns faces removed."""
    from msd_tpu_torch.data.mesh_io import load_mesh, save_obj

    v, f = load_mesh(path)
    cy = v[f].mean(axis=1)[:, 1]
    top = v[:, 1].max() - share * np.ptp(v[:, 1])
    save_obj(path, v, f[cy <= top])
    return int((cy > top).sum())


def run_module(argv, timeout):
    """``python -m <argv>`` from the checkout; returns its stderr (raises
    with its output when it fails)."""
    import sys

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    r = subprocess.run([sys.executable, "-m", *argv], cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=timeout)
    if r.returncode != 0:
        raise AssertionError(f"{argv[0]} exited {r.returncode}:\n{r.stdout[-3000:]}\n{r.stderr[-6000:]}")
    return r.stderr


def preprocess_stats(stderr):
    """The ``preprocess_stats`` records a preprocess_data run logged."""
    return [json.loads(ln.split("preprocess_stats ", 1)[1]) for ln in stderr.splitlines()
            if "preprocess_stats " in ln]


def preprocess(root, seed, device="cuda"):
    """The port's data-preparation path as a user runs it: NIfTI masks ->
    PLY (batch_process_to_ply) -> OBJ (ply_to_obj) -> splits
    (create_split_json_files) -> run_all_preprocessing at its defaults
    (500000 samples, 200000 vote points; SDF, --test and --surface passes,
    the vote's tiled route on the card), one mesh with a cap cut off so
    "auto" renders it. Then preprocess_data --test into a second data
    directory (run_all's --test pass finds the SdfSamples written and
    skips, as the reference's does), the outputs checked, the tiled route
    against the host route on one full-size mesh (VOTE_AGREEMENT; CUDA
    events, torch.profiler), and the SdfSamples loader drawing one batch
    over the four shapes. Returns the phase summary and every mesh's
    record. ``device="cpu"`` rehearses it on the CPU (the host route; patch
    ``profile_steps`` and shrink ``draw_queries`` for the full-size check)."""
    import torch

    from msd_tpu_torch.data.mesh_io import load_mesh
    from msd_tpu_torch.data.sdf_samples import SdfDataset, sample_sdf_batch
    from msd_tpu_torch.preprocess import mesh_to_sdf as tm

    t0 = time.time()
    masks, ply, meshes, splits = (os.path.join(root, d) for d in ("masks", "ply", "meshes", "splits"))
    write_masks(masks, PREPROCESS_SHAPES, seed)
    run_module(["msd_tpu_torch.utils.batch_process_to_ply", "-i", masks, "-o", ply, "-g", "hippo"], 600)
    run_module(["msd_tpu_torch.utils.ply_to_obj", "-i", os.path.join(ply, "hippo_ply", "minimal"),
                "-o", meshes], 300)
    names = sorted(os.path.splitext(n)[0] for n in os.listdir(meshes))
    if len(names) != PREPROCESS_SHAPES:
        raise AssertionError(f"preprocess: {len(names)} meshes from {PREPROCESS_SHAPES} masks")
    cut = cut_cap(os.path.join(meshes, names[-1] + ".obj"))
    run_module(["msd_tpu_torch.utils.create_split_json_files", "-m", meshes, "-o", splits, "-p", "hippo",
                "--fractions", "0.5", "0.25", "0.25", "--seed", str(seed)], 300)
    t_tools = time.time() - t0
    data, data_test = os.path.join(root, "data"), os.path.join(root, "data_test")
    t1 = time.time()
    records = preprocess_stats(run_module(
        ["msd_tpu_torch.run_all_preprocessing", "-d", data, "-s", meshes, "--splits_dir", splits, "--debug",
         "--device", device], 1500))
    t_run_all = time.time() - t1
    all_split = os.path.join(root, "all_split.json")
    with open(all_split, "w") as f:
        json.dump([n + ".obj" for n in names], f)
    records += preprocess_stats(run_module(
        ["msd_tpu_torch.preprocess_data", "-d", data_test, "-s", meshes, "--split", all_split, "--test",
         "--device", device], 900))

    # every expected output (a mesh that fails is logged and skipped)
    expected = [os.path.join(data, ".datasources.json"), os.path.join(data_test, ".datasources.json")]
    for n in names:
        expected += [os.path.join(data, "SdfSamples", "meshes", n + ".npz"),
                     os.path.join(data, "SurfaceSamples", "meshes", n + ".ply"),
                     os.path.join(data, "NormalizationParameters", "meshes", n + ".npz"),
                     os.path.join(data_test, "SdfSamples", "meshes", n + ".npz")]
    missing = [os.path.relpath(p, root) for p in expected if not os.path.isfile(p)]
    if missing:
        raise AssertionError(f"preprocess: missing outputs {missing}")
    modes = sorted((r["mesh"], r["mode"]) for r in records)
    if modes != sorted((n, m) for n in names for m in ("sdf", "surface", "test")):
        raise AssertionError(f"preprocess: records {modes}")
    route = "tiled" if device == "cuda" else "host"
    for r in records:
        if r["mode"] != "surface" and r["vote"]["route"] != route:
            raise AssertionError(f"preprocess: {r['mesh']} {r['mode']} voted on the {r['vote']['route']} route")
        want = "render" if r["mesh"] == names[-1] else "watertight"
        if r["mode"] != "surface" and r["visibility"] != want:
            raise AssertionError(f"preprocess: {r['mesh']} took {r['visibility']}, not {want}")

    # the tiled route against the host route on one full-size mesh
    dev = torch.device(device)
    v, f = load_mesh(os.path.join(meshes, names[0] + ".obj"))
    q, s, n, stdv, _, _ = tm.draw_queries(v, f, seed=0)
    sdf_c, keep_c, st_c = tm._vote(q, s, n, 11, stdv, 8192, dev, True)
    sdf_h, keep_h, st_h = tm._vote(q, s, n, 11, stdv, 8192, "cpu", None)
    agree = tm.vote_agreement(sdf_c, keep_c, sdf_h, keep_h)
    if not agree["ok"]:
        raise AssertionError(f"preprocess: tiled and host votes disagree: {agree} (limits {tm.VOTE_AGREEMENT})")
    prof = profile_steps(lambda: tm._vote(q, s, n, 11, stdv, 8192, dev, True), 1)
    # the materialized design writes and reads every float32 squared distance once
    nbytes = 2 * 4 * len(q) * len(s)
    vote = {"mesh": names[0], "queries": len(q), "surface_points": len(s),
            "tiled": {k: st_c.get(k) for k in ("seconds", "device_ms", "chunk_ms", "idle_share", "peak_bytes",
                                               "chunks")},
            "host_seconds": st_h["seconds"], "agreement": agree, "limits": tm.VOTE_AGREEMENT,
            "distance_bytes": nbytes, "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "profiler": {k: prof.get(k) for k in ("device_ms_per_step", "device_ops_per_step", "wall_ms_per_step",
                                                  "device_idle_share", "top_other")}}

    # the port's SdfSamples loader: one batch over the four shapes at the flagship's 16384 points per scene
    ds = SdfDataset.from_split(os.path.join(data, "SdfSamples", "meshes"), [n + ".obj" for n in names], 16384)
    pos, pc, neg, nc = ds.device_arrays(dev)
    batch = sample_sdf_batch(pos, pc, neg, nc, torch.arange(len(names), device=dev), 16384,
                             torch.Generator(device=dev).manual_seed(seed))
    if tuple(batch.shape) != (4, len(names), 16384) or not bool(torch.isfinite(batch).all()):
        raise AssertionError(f"preprocess: bad SdfSamples batch {tuple(batch.shape)}")
    summary = {"meshes": names, "faces": {r["mesh"]: r["faces"] for r in records if r["mode"] == "sdf"},
               "cap_cut_from": names[-1], "cap_faces_removed": cut, "tools_seconds": t_tools,
               "run_all_seconds": t_run_all, "seconds": time.time() - t0, "vote_check": vote,
               "outputs_checked": len(expected), "sdf_batch": list(batch.shape),
               "batch_neg_share": float((batch[3] < 0).float().mean())}
    return summary, records


# Serving over ranks: 2 gloo ranks on the one card (NCCL refuses two ranks
# on one device), so NCCL serving, one card per rank, is not measured here.
SERVE_RANKS = 2
SERVE_RANK_SHAPES = 4
# one process against the ranks: all 4 latents and the CLI's codes (1e-5),
# the CLI's mesh vertices (1e-6, as the kernel's own mesh check)
SERVE_RANK_TOL = {"latents": 1e-5, "verts": 1e-6}


def serving_ranks_fit(decoder, specs, shapes, iters, **kw):
    """``reconstruct_batch`` as the reconstruct CLI fits (8000 samples; 800
    iterations at its defaults)."""
    from msd_tpu_torch.train.reconstruct import reconstruct_batch

    return reconstruct_batch(decoder, iters, specs["CodeLength"], shapes, 0.01, 0.1, num_samples=8000, lr=5e-3,
                             l2reg=True, **kw)


# the streamed create_mesh calls over the ranks and in one process: (name,
# N, the host refinement route forced by a device cap of 2 blocks); the
# statistics the main rank must share with one process, and its times
STREAM_RANK_CALLS = (("n257", 257, False), ("n513", 513, False), ("n257_host", 257, True))
STREAM_RANK_COUNTS = ("refine", "value_codec", "active_blocks", "crossing_blocks", "evaluated", "exact_slabs", "dedup",
                      "dedup_slabs", "dedup_retries", "num_verts", "num_faces")
STREAM_RANK_TIMES = ("t_refine", "t_crossing", "t_mesher", "t_stream")


def streamed_calls(ev, latent):
    """``create_mesh`` of ``latent`` through ``ev`` (over its group, if it has
    one, or in one process) for each of ``STREAM_RANK_CALLS``, after
    ``warm_stream`` on the main rank: per call the seconds, K1 launches and
    points of this process, its route and broadcast bytes, the mesh's
    sizes and a digest of its bytes, and the main rank's stream statistics."""
    from msd_tpu_torch import mesh

    # on the card create_mesh streams by default; a CPU rehearsal is made to
    streams, mesh._streams = mesh._streams, lambda evaluator: True
    try:
        return {name: _streamed_call(ev, latent, N, host) for name, N, host in STREAM_RANK_CALLS}
    finally:
        mesh._streams = streams


def _streamed_call(ev, latent, N, host):
    import hashlib

    from msd_tpu_torch import mesh
    from msd_tpu_torch.ops import fused_mlp

    main = ev.group is None or ev.group.is_main
    if main:
        ev.warm_stream(N)
    if ev.group is not None:
        ev.group.any_true(False)  # every rank starts its clock after the main rank's warm-up
    refine = ev.refine_active4_device
    if host:
        ev.refine_active4_device = lambda *a, **kw: refine(*a, **kw, cap4=2)
    launches, points = fused_mlp.LAUNCHES, ev.n_evaluated
    _sync(ev.device)
    t0 = time.perf_counter()
    try:
        verts, faces = mesh.create_mesh(ev.decoder, latent, None, N=N, return_mesh=True, evaluator=ev)
    finally:
        ev.refine_active4_device = refine
    _sync(ev.device)
    stats = dict(mesh.LAST_STREAMING_STATS)
    return {"seconds": time.perf_counter() - t0, "k1_launches": fused_mlp.LAUNCHES - launches,
            "points": ev.n_evaluated - points, "route": stats.get("refine"),
            "broadcast_bytes": stats.get("broadcast_bytes", 0), "verts": int(verts.shape[0]),
            "faces": int(faces.shape[0]), "digest": hashlib.sha256(verts.tobytes() + faces.tobytes()).hexdigest(),
            "stats": {k: stats.get(k) for k in STREAM_RANK_COUNTS} if main else None,
            "times": {k: stats.get(k) for k in STREAM_RANK_TIMES} if main else None}


def serving_ranks_rank(group, specs, state, paths, iters, N, argv, shuffle_seed):
    """A rank of the serving_ranks phase (spawned by ``serving_ranks``):
    ``reconstruct_batch(group=)`` of the shapes at ``paths``, the sparse
    evaluation of the first latent through ``PointEvaluator(group=)`` and
    the streamed ``create_mesh`` calls (``streamed_calls``; K1 counted
    from 0 just before the evaluation, read just after the calls), then the
    reconstruct CLI's ``main(argv, group=)``. Returns numpy results,
    seconds and K1 launches."""
    import random

    import torch

    from msd_tpu_torch import mesh
    from msd_tpu_torch import reconstruct as reconstruct_cli
    from msd_tpu_torch.data.sdf_samples import read_sdf_samples, remove_nans
    from msd_tpu_torch.models import build_decoder
    from msd_tpu_torch.ops import fused_mlp

    dev = group.device
    decoder = build_decoder(specs["NetworkArch"], specs["CodeLength"], specs["NetworkSpecs"])
    decoder.load_state_dict(state)
    decoder = decoder.to(dev).eval()
    shapes = [tuple(remove_nans(a) for a in read_sdf_samples(p)) for p in paths]
    # warm up the card, the allocator and the gather before the timed fit
    serving_ranks_fit(decoder, specs, shapes, 2, group=group)
    _sync(dev)
    t0 = time.perf_counter()
    losses, latents = serving_ranks_fit(decoder, specs, shapes, iters, group=group)
    _sync(dev)
    t_fit = time.perf_counter() - t0
    latent = latents[0]
    fused_mlp.LAUNCHES = 0
    ev = mesh.PointEvaluator(decoder, group=group)
    t0 = time.perf_counter()
    corner, abi, block_vals, stats = mesh._sparse_blocks(latent, N, mesh._pick_block(N, 0.1, 1.3), 1.3, ev)
    _sync(dev)
    t_sparse = time.perf_counter() - t0
    sparse_launches, sparse_points = fused_mlp.LAUNCHES, ev.n_evaluated
    streamed = streamed_calls(ev, latent)
    launches, evaluated = fused_mlp.LAUNCHES, ev.n_evaluated
    random.seed(shuffle_seed + group.rank)  # the main rank's order is every rank's
    t0 = time.perf_counter()
    summary = reconstruct_cli.main(argv, group=group)
    t_cli = time.perf_counter() - t0
    return {"losses": losses, "latents": latents.cpu().numpy(), "part": group.row_slice(len(paths)),
            "fit_seconds": t_fit, "corner": corner, "abi": abi, "block_vals": block_vals, "sparse_seconds": t_sparse,
            "sparse_k1_launches": sparse_launches, "sparse_points": sparse_points, "streamed": streamed,
            "k1_launches": launches, "points_evaluated": evaluated, "cli_summary": summary, "cli_seconds": t_cli}


def serving_ranks(root, specs, decoder, seed, vote_mesh, device="cuda", iters=800):
    """Serving over ranks at the flagship width: ``SERVE_RANKS`` gloo ranks
    on the card fit ``SERVE_RANK_SHAPES`` seeded ellipsoids with
    ``reconstruct_batch(group=)`` (each rank's latents bit for bit one
    process's fit of its shapes, all within ``SERVE_RANK_TOL`` of one
    process fitting all), mesh the first latent at N=257 through
    ``PointEvaluator(group=)`` (SDF values bit for bit one process's, K1 on
    every rank, the same mesh) and run the reconstruct CLI's ``--batch 4``
    through ``main(argv, group=)`` (codes and meshes as a one-process run's,
    only the main rank writing). Then ``knn_sign_vote`` over two devices
    (both the card) against one on the mesh ``vote_mesh``, byte for byte.
    Returns the phase summary and the K1 launches per rank. ``device="cpu"``
    rehearses it on the CPU (gloo ranks on the CPU, K1's plain version; cut
    ``iters`` and shrink ``draw_queries`` as for the preprocess phase)."""
    import random

    import torch

    from msd_tpu_torch import mesh
    from msd_tpu_torch import reconstruct as reconstruct_cli
    from msd_tpu_torch.data.mesh_io import load_mesh, load_ply
    from msd_tpu_torch.data.sdf_samples import read_sdf_samples, remove_nans
    from msd_tpu_torch.ops import fused_mlp
    from msd_tpu_torch.parallel import run_ranks
    from msd_tpu_torch.preprocess import mesh_to_sdf as tm
    from msd_tpu_torch.utils.checkpoint import save_model

    t_start = time.time()
    dev = torch.device(device)
    data = os.path.join(root, "serve_ranks_data")
    split = write_dataset(data, SERVE_RANK_SHAPES, 250_000, seed + 1)
    split_path = os.path.join(root, "serve_ranks_split.json")
    with open(split_path, "w") as f:
        json.dump(split, f)
    exps = {}
    for name in ("ranks", "one"):
        exps[name] = os.path.join(root, f"serve_ranks_{name}")
        os.makedirs(exps[name])
        with open(os.path.join(exps[name], "specs.json"), "w") as f:
            json.dump(specs, f)
        save_model(exps[name], "latest.pth", decoder, 1)
    paths = [os.path.join(data, "SdfSamples", "smoke", "ellipsoid", n + ".npz") for n in split["smoke"]["ellipsoid"]]

    def argv(exp):
        return ["-e", exp, "-c", "latest", "-d", os.path.join(data, "SdfSamples"), "-s", split_path,
                "--batch", str(SERVE_RANK_SHAPES), "--iters", str(iters), "--device", device, "--quiet"]

    N = mesh._snap_n(256)
    state = {k: v.detach().cpu() for k, v in decoder.state_dict().items()}
    out = run_ranks(serving_ranks_rank, SERVE_RANKS, (specs, state, paths, iters, N, argv(exps["ranks"]), seed),
                    devices=[f"{device}:0" if device == "cuda" else device] * SERVE_RANKS, timeout=600,
                    workdir=root)
    t_ranks = time.time() - t_start

    # one process: all shapes at once, then each rank's shapes alone
    shapes = [tuple(remove_nans(a) for a in read_sdf_samples(p)) for p in paths]
    _sync(dev)
    t0 = time.perf_counter()
    losses, latents = serving_ranks_fit(decoder, specs, shapes, iters)
    _sync(dev)
    t_fit_one = time.perf_counter() - t0
    latents = latents.cpu().numpy()
    fit = {"latents_max_abs_diff": float(np.abs(out[0]["latents"] - latents).max()),
           "losses": losses.tolist(), "rank_losses": out[0]["losses"].tolist()}
    if not np.allclose(out[0]["latents"], latents, rtol=SERVE_RANK_TOL["latents"], atol=SERVE_RANK_TOL["latents"]):
        raise AssertionError(f"serving_ranks: ranks' latents against one process {fit}")
    fit["rank_slices_bit_equal"] = []
    for r in out:
        if not np.array_equal(r["latents"], out[0]["latents"]) or not np.array_equal(r["losses"], out[0]["losses"]):
            raise AssertionError(f"serving_ranks: rank {r['part']} returned other latents than rank 0")
        part = r["part"]
        if part.stop == part.start:
            continue
        _, own = serving_ranks_fit(decoder, specs, shapes[part], iters, seed=part.start)
        if not np.array_equal(r["latents"][part], own.cpu().numpy()):
            raise AssertionError(f"serving_ranks: rank shapes {part} differ from one process fitting them: max "
                                 f"{float(np.abs(r['latents'][part] - own.cpu().numpy()).max())}")
        fit["rank_slices_bit_equal"].append([part.start, part.stop])

    # one process evaluating and meshing the same latent
    latent = torch.as_tensor(out[0]["latents"][0], device=dev)
    launches0 = fused_mlp.LAUNCHES
    ev = mesh.PointEvaluator(decoder)
    _sync(dev)
    t0 = time.perf_counter()
    corner, abi, block_vals, _ = mesh._sparse_blocks(latent, N, mesh._pick_block(N, 0.1, 1.3), 1.3, ev)
    _sync(dev)
    meshing = {"N": N, "active_blocks": int(abi.shape[0]), "sparse_seconds_one": time.perf_counter() - t0,
               "sparse_points_one": ev.n_evaluated, "sparse_k1_launches_one": fused_mlp.LAUNCHES - launches0}
    one = streamed_calls(ev, latent)
    # K1 computes every point alone, so a rank's points get one process's
    # bits; on the CPU (a rehearsal) BLAS may block rows otherwise: 1e-6
    same = np.array_equal if device == "cuda" else functools.partial(np.allclose, rtol=0, atol=1e-6)
    for r in out:
        if not (same(r["corner"], corner) and np.array_equal(r["abi"], abi) and same(r["block_vals"], block_vals)):
            raise AssertionError(f"serving_ranks: rank SDF values differ from one process's (rank of {r['part']})")
        if device == "cuda" and r["sparse_k1_launches"] <= 0:
            raise AssertionError(f"serving_ranks: no K1 launch on a rank: {[o['sparse_k1_launches'] for o in out]}")
    # every rank's streamed mesh is the one-process stream's, bit for bit;
    # the main rank streamed it with one process's statistics; the other
    # ranks did device work only on the host route (their lattice share)
    streamed = {}
    for name, _, host in STREAM_RANK_CALLS:
        calls = [r["streamed"][name] for r in out]
        ref = one[name]
        if ref["route"] != ("host" if host else "device") or any(c["route"] != ref["route"] for c in calls):
            raise AssertionError(f"serving_ranks: {name} routes {[c['route'] for c in calls]}, one process "
                                 f"{ref['route']}")
        if any(c["digest"] != ref["digest"] for c in calls) or calls[0]["stats"] != ref["stats"]:
            raise AssertionError(f"serving_ranks: {name} streamed meshes differ from one process's: "
                                 f"{[(c['verts'], c['faces'], c['stats']) for c in calls]} against "
                                 f"{(ref['verts'], ref['faces'], ref['stats'])}")
        if device == "cuda" and (calls[0]["k1_launches"] <= 0
                                 or any((c["k1_launches"] > 0) != host for c in calls[1:])):
            raise AssertionError(f"serving_ranks: {name} K1 launches per rank {[c['k1_launches'] for c in calls]}")
        if sum(c["points"] for c in calls) != ref["points"]:
            raise AssertionError(f"serving_ranks: {name} points per rank {[c['points'] for c in calls]} against "
                                 f"{ref['points']} in one process")
        streamed[name] = {"per_rank": [{k: c[k] for k in ("seconds", "k1_launches", "points", "route",
                                                           "broadcast_bytes")} for c in calls],
                          "one_process": {k: ref[k] for k in ("seconds", "k1_launches", "points", "times")},
                          "main_rank_times": calls[0]["times"],
                          "verts": ref["verts"], "faces": ref["faces"], "bit_equal": True, "stats": ref["stats"]}
    meshing.update(k1_launches_per_rank=[r["k1_launches"] for r in out],
                   points_evaluated_per_rank=[r["points_evaluated"] for r in out],
                   sparse_seconds_per_rank=[r["sparse_seconds"] for r in out], sdf_values_bit_equal=device == "cuda",
                   streamed=streamed)

    # the CLI: one process, the same shuffle as the main rank's
    random.seed(seed)
    t0 = time.perf_counter()
    one = reconstruct_cli.main(argv(exps["one"]))
    t_cli_one = time.perf_counter() - t0
    if out[0]["cli_summary"] == [] or any(r["cli_summary"] for r in out[1:]):
        raise AssertionError("serving_ranks: the CLI's main rank must return the summary, the others nothing")
    if [s["shape"] for s in out[0]["cli_summary"]] != [s["shape"] for s in one]:
        raise AssertionError("serving_ranks: the CLI over ranks took other shapes or another order")
    cli = {"shapes": len(one), "codes_max_abs_diff": 0.0, "verts_max_abs_diff": 0.0, "codes_bit_equal": True,
           "cli_seconds_per_rank": [r["cli_seconds"] for r in out], "cli_seconds_one": t_cli_one,
           "fit_seconds_per_shape_ranks": out[0]["cli_summary"][0]["t_reconstruct"],
           "fit_seconds_per_shape_one": one[0]["t_reconstruct"]}
    base = {k: os.path.join(e, "Reconstructions", "1") for k, e in exps.items()}
    for s in one:
        code, ref_code = (torch_load(os.path.join(base[k], "Codes", s["shape"] + ".pth")).numpy()
                          for k in ("ranks", "one"))
        (v, f), (rv, rf) = (load_ply(os.path.join(base[k], "Meshes", s["shape"] + ".ply")) for k in ("ranks", "one"))
        cli["codes_max_abs_diff"] = max(cli["codes_max_abs_diff"], float(np.abs(code - ref_code).max()))
        cli["codes_bit_equal"] &= bool(np.array_equal(code, ref_code))
        if not np.allclose(code, ref_code, rtol=SERVE_RANK_TOL["latents"], atol=SERVE_RANK_TOL["latents"]) \
                or f.shape != rf.shape or v.shape != rv.shape:
            raise AssertionError(f"serving_ranks: CLI outputs of {s['shape']} differ: {cli}, faces {f.shape} "
                                 f"against {rf.shape}")
        cli["verts_max_abs_diff"] = max(cli["verts_max_abs_diff"], float(np.abs(v - rv).max()))
    if cli["verts_max_abs_diff"] > SERVE_RANK_TOL["verts"]:
        raise AssertionError(f"serving_ranks: CLI meshes differ: {cli}")
    written = sorted(os.listdir(os.path.join(base["ranks"], "Meshes")))
    if written != sorted(s["shape"] + ".ply" for s in one):
        raise AssertionError(f"serving_ranks: the CLI over ranks wrote {written}")

    # the vote over two devices of this process (both the card) against one
    v, f = load_mesh(vote_mesh)
    q, s, n, stdv, _, _ = tm.draw_queries(v, f, seed=0)
    votes = {}
    for name, devs in (("one_device", [device]), ("two_devices", [device, device])):
        _sync(dev)
        t0 = time.perf_counter()
        sdf, keep, st = tm._vote(q, s, n, 11, stdv, 8192, device, True, devs)
        votes[name] = (sdf, keep, {"seconds": time.perf_counter() - t0,
                                   **{k: st.get(k) for k in ("device_ms", "chunk_ms", "idle_share", "chunks")}})
    if not (votes["one_device"][0].tobytes() == votes["two_devices"][0].tobytes()
            and np.array_equal(votes["one_device"][1], votes["two_devices"][1])):
        raise AssertionError("serving_ranks: the vote over two devices differs from one device's")
    summary = {
        "ranks": SERVE_RANKS, "backend": "gloo", "devices": [device] * SERVE_RANKS, "shapes": SERVE_RANK_SHAPES,
        "fit_seconds_per_shape": {"one_process": t_fit_one / SERVE_RANK_SHAPES,
                                  "ranks": max(r["fit_seconds"] for r in out) / SERVE_RANK_SHAPES},
        "fit": fit, "mesh": meshing, "cli": cli,
        "vote": {"mesh": os.path.basename(vote_mesh), "queries": len(q), "surface_points": len(s),
                 "bytes_identical": True, **{k: v[2] for k, v in votes.items()}},
        "ranks_seconds": t_ranks, "seconds": time.time() - t_start,
        "note": "several ranks share one card: a correctness drive of serving over ranks, not a scaling figure; "
                "NCCL (one card per rank) not measured"}
    return summary, [r["k1_launches"] for r in out], out[0]["latents"]


def input_report(exp):
    """``check_experiment_inputs`` on ``exp`` (in process): its report lines,
    and those that say an input is missing or not found (a count of
    missing ids above 0, a missing path or file)."""
    import io
    import re

    from msd_tpu_torch import check_experiment_inputs

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        check_experiment_inputs.main(["-e", exp])
    lines = buf.getvalue().splitlines()
    bad = [ln for ln in lines
           if "not found" in ln or re.search(r"\bmissing\b(?!=)", ln) or re.search(r"missing(_npz|_labels)?=[1-9]", ln)]
    return lines, bad


# the tooling phase's NormalizationParameters: (offset, scale) of the first
# two instances; the others are meshed in the decoder's frame
TOOLING_NORMALIZATION = (((0.1, -0.05, 0.2), 0.8), ((-0.2, 0.1, 0.0), 1.25))


def tooling(root, specs, decoder, latents, stage2_inputs, device="cuda"):
    """The tooling phase, after serving_ranks and on its data: an experiment
    holding the serving decoder and the 4 latents the ranks fitted, the
    first two instances with NormalizationParameters, meshed by
    ``python -m msd_tpu_torch.generate_training_meshes`` (in process, K1
    counted from 0 just before and read just after; N=257): every mesh bit
    for bit ``create_mesh`` of its latent called directly, then taken to
    the instance's frame. The workspace loaders' round trip on that
    experiment; ``check_experiment_inputs``'s report of the Stage-2 phase's
    experiment (``stage2_inputs``, made while it existed) with nothing
    missing; Hausdorff (``compute_metric``) and EMD (2048 seeded surface
    points a side) of a mesh the serving_ranks CLI reconstructed against
    its ellipsoid. Returns the phase summary."""
    import torch

    import msd_tpu_torch.workspace as ws
    from msd_tpu_torch import generate_training_meshes, mesh
    from msd_tpu_torch.data.mesh_io import load_mesh, load_ply
    from msd_tpu_torch.metrics import compute_emd, compute_metric
    from msd_tpu_torch.ops import fused_mlp
    from msd_tpu_torch.ops.sampling import sample_mesh_surface
    from msd_tpu_torch.utils.checkpoint import save_latent_vectors, save_model

    t_start = time.time()
    data = os.path.join(root, "serve_ranks_data")
    source = os.path.join(data, "SdfSamples")
    split_path = os.path.join(root, "serve_ranks_split.json")
    with open(split_path) as f:
        names = json.load(f)["smoke"]["ellipsoid"]
    exp = os.path.join(root, "tooling_experiment")
    ws.save_experiment_specifications(exp, dict(specs, DataSource=source, TrainSplit=split_path))
    save_model(exp, "latest.pth", decoder, 1)
    save_latent_vectors(exp, "latest.pth", torch.from_numpy(np.asarray(latents)), 1)
    norms = dict(zip(names, TOOLING_NORMALIZATION))
    for name, (offset, scale) in norms.items():
        path = ws.get_normalization_params_filename(source, "smoke", "ellipsoid", name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.savez(path, offset=np.asarray(offset), scale=scale)

    fused_mlp.LAUNCHES = 0
    t0 = time.time()
    written = generate_training_meshes.main(["-e", exp, "--device", device, "--quiet"])
    t_generate = time.time() - t0
    launches = fused_mlp.LAUNCHES
    if device == "cuda" and launches <= 0:
        raise AssertionError("tooling: generate_training_meshes launched no K1")
    if [w["instance"] for w in written] != names or [w["normalized_back"] for w in written] != [n in norms for n in names]:
        raise AssertionError(f"tooling: generate_training_meshes wrote {written}")
    ev = mesh.PointEvaluator(decoder)
    for w, latent in zip(written, latents):
        v, f = load_ply(w["path"])
        dv, df = mesh.create_mesh(decoder, torch.as_tensor(latent, device=ev.device), None, N=257, return_mesh=True,
                                  evaluator=ev)
        if w["instance"] in norms:
            offset, scale = norms[w["instance"]]
            dv = (dv.astype(np.float64) / scale - np.asarray(offset)).astype(np.float32)
        if not (np.array_equal(v, dv) and np.array_equal(f, df)):
            raise AssertionError(f"tooling: {w['path']} is not create_mesh's mesh: {v.shape} {f.shape} against "
                                 f"{dv.shape} {df.shape}")
        w["verts"], w["faces"] = int(v.shape[0]), int(f.shape[0])

    dec, epoch = ws.load_decoder(exp, "latest")
    state = decoder.state_dict()
    if epoch != 1 or any(not torch.equal(t, state[k].cpu()) for k, t in dec.state_dict().items()):
        raise AssertionError("tooling: load_decoder did not give the saved decoder back")
    if not np.array_equal(ws.load_latent_vectors(exp, "latest"), np.asarray(latents)):
        raise AssertionError("tooling: load_latent_vectors did not give the saved latents back")

    lines, bad = stage2_inputs
    if bad or not lines:
        raise AssertionError(f"tooling: check_experiment_inputs on the Stage-2 experiment: {bad or 'no report'}")

    served = os.path.join(root, "serve_ranks_one", "Reconstructions", "1", "Meshes", names[0] + ".ply")
    gt = os.path.join(data, "Meshes", names[0] + ".obj")
    t0 = time.time()
    hausdorff = compute_metric(gt, served, metric="hausdorff")
    t_hausdorff = time.time() - t0
    (gv, gf), (sv, sf) = load_mesh(gt), load_mesh(served)
    a = sample_mesh_surface(gv, gf, 2048, np.random.default_rng(0))[0]
    b = sample_mesh_surface(sv, sf, 2048, np.random.default_rng(1))[0]
    t0 = time.time()
    emd = compute_emd(a, b)
    t_emd = time.time() - t0
    if not (math.isfinite(hausdorff) and math.isfinite(emd) and hausdorff > 0 and emd > 0):
        raise AssertionError(f"tooling: Hausdorff {hausdorff}, EMD {emd}")
    return {"generate_training_meshes": {"seconds": t_generate, "k1_launches": launches, "meshes": written,
                                         "bit_equal_to_create_mesh": True},
            "loaders_round_trip": True, "check_experiment_inputs": {"lines": len(lines), "missing": 0},
            "metrics": {"mesh": os.path.basename(served), "hausdorff": hausdorff, "hausdorff_seconds": t_hausdorff,
                        "emd_2048": emd, "emd_seconds": t_emd},
            "seconds": time.time() - t_start,
            "note": "seeded weights, not trained: Hausdorff and EMD are no quality figures"}


FIGURE_TSNE_TOL = {"emb_rel": 1e-3, "kl_rel": 1e-6}
FIGURE_EVAL_TAGS = ("CD Percentiles/train dists", "Reconstructions/train comparison", "CD Percentiles/test dists")


def explorer_html(exp, latents, resolution, out_dir, device):
    """``python -m msd_tpu_torch.latent_explorer --mode html`` on ``exp``
    (in process, 4 dims x 9 steps), K1 counted from 0 just before and read
    just after; then every frame of the HTML's payload against
    ``_pack_mesh`` of ``create_mesh`` called directly on its latent (K1's
    launches there are not counted). The CLI's wall time is split by
    wrapping, for that call only, ``export_interactive_html``,
    ``sweep_frames`` and ``mesh_evaluator``: loading (the CLI less the
    export), the evaluator's set-up (with ``warm_stream`` where it
    streams), decoding and meshing the frames (``sweep_frames`` less the
    set-up, also per decoded frame) and the export (packing, JSON, writing
    the file). Returns the sub-step's summary and its K1 launches."""
    import re

    import torch

    from msd_tpu_torch import explorer, latent_explorer, mesh
    from msd_tpu_torch.ops import fused_mlp

    out = os.path.join(out_dir, f"explorer_{resolution}.html")
    argv = ["-e", exp, "--mode", "html", "--dims", "0", "1", "2", "3", "--steps", "9", "-N", str(resolution),
            "--out", out, "--device", device, "--quiet"]
    timed = {}

    def timing(name, fn):
        def wrapped(*args, **kwargs):
            t = time.time()
            try:
                return fn(*args, **kwargs)
            finally:
                timed[name] = timed.get(name, 0.0) + time.time() - t
        return wrapped

    saved = explorer.export_interactive_html, explorer.sweep_frames, mesh.mesh_evaluator
    explorer.export_interactive_html = timing("export", saved[0])
    explorer.sweep_frames = timing("sweep", saved[1])
    mesh.mesh_evaluator = timing("evaluator", saved[2])
    try:
        fused_mlp.LAUNCHES = 0
        t0 = time.time()
        latent_explorer.main(argv)
        seconds = time.time() - t0
        launches = fused_mlp.LAUNCHES
    finally:
        explorer.export_interactive_html, explorer.sweep_frames, mesh.mesh_evaluator = saved
    if device == "cuda" and launches <= 0:
        raise AssertionError(f"figures: latent_explorer --mode html -N {resolution} launched no K1")
    stats = dict(mesh.LAST_STREAMING_STATS)
    with open(out, encoding="utf-8") as f:
        data = json.loads(re.search(r"const DATA = (\{.*\});\n", f.read()).group(1))
    N = min(resolution, 97)
    decoder = ws_load_decoder(exp, device)
    ev = mesh.PointEvaluator(decoder)
    base = np.asarray(latents[0], np.float32)
    frames = 0
    for d in data["dims"]:
        for s, packed in zip(data["steps"], data["frames"][str(d)]):
            z = base.copy()
            z[d] += np.float64(s)  # as sweep_frames: linspace's float64 offsets
            want = explorer._pack_mesh(mesh.create_mesh(decoder, torch.as_tensor(z, device=ev.device), N=N,
                                                        return_mesh=True, evaluator=ev) or None)
            if packed != want:
                raise AssertionError(f"figures: html -N {resolution}: frame dim {d} step {s} is not create_mesh's mesh")
            frames += 1
    decoded = 1 + len(data["dims"]) * (len(data["steps"]) - 1)  # the centre step reuses the base mesh
    N_mesh = mesh._snap_n(N)
    route = mesh.mesh_route(N_mesh, ev)[1]
    frames_seconds = timed["sweep"] - timed["evaluator"]
    return {"N": N_mesh, "route": route, "cli_seconds": seconds, "load_seconds": seconds - timed["export"],
            "evaluator_seconds": timed["evaluator"], "frames_seconds": frames_seconds,
            "export_seconds": timed["export"] - timed["sweep"], "frames_decoded": decoded,
            "frames_seconds_per_frame": frames_seconds / decoded, "frames_checked": frames,
            "frames_equal_create_mesh": True,
            "html_mb": os.path.getsize(out) / 1e6, "k1_launches": launches,
            "last_frame_refine": stats.get("refine") if route == "streamed" else None}, launches


def ws_load_decoder(exp, device):
    import msd_tpu_torch.workspace as ws

    return ws.load_decoder(exp, "latest")[0].to(device).eval()


def figures(tool_exp, train_exp, out_dir, device="cuda"):
    """The figures phase, after tooling: the latent explorer and the figure
    CLIs on the tooling phase's experiment (``tool_exp``: the serving
    decoder, flagship width, with the 4 latents the ranks fitted) and the
    training phase's (``train_exp``: its Logs.pth, 64 latents, SdfSamples).
    No sub-step's exception is caught. Always (K1 and the card, no
    matplotlib): ``latent_explorer --mode html`` at ``-N 129`` (capped at 97,
    streamed) and ``-N 64`` (65, dense), each frame held against
    ``create_mesh``; ``manifold.tsne`` of the 64 training latents on the card
    against the same call on the CPU (``FIGURE_TSNE_TOL``); the Stage-1
    trainer's ``_eval_train`` and ``_eval_test`` on the tooling experiment
    with ``TorusPath`` its data's ``Meshes/`` and ``EvalTrainSceneNumber`` 3
    (``_eval_test`` fits one shape for 800 steps), at the spec's
    ``EvalGridResolution`` (256, snapped to 257) where matplotlib does not
    import and at 128 where it does (matplotlib's plot_trisurf of three
    257^3 meshes would take minutes to draw): both Chamfer scalars, and where matplotlib
    imports the three ``FIGURE_EVAL_TAGS``, else none and two "eval figures
    skipped" warnings, as ``msd_tpu``'s hooks behave. Where matplotlib
    imports, and otherwise listed as not run: ``latent_explorer`` in interp
    and sweep mode (3 steps at N=33: plot_trisurf drew 3 frames of N=97 in
    60 s in a CPU rehearsal), ``plot_log`` for its five types,
    ``analyze_sdf_npz`` on one training file, ``latent_manifold`` with pca,
    ica, hlle and tsne. Returns the phase summary and K1's launches by
    sub-step."""
    import importlib.util
    import io

    import torch

    import msd_tpu_torch.workspace as ws
    from msd_tpu_torch import manifold
    from msd_tpu_torch.ops import fused_mlp
    from msd_tpu_torch.train.stage1 import Stage1Trainer

    t_start = time.time()
    os.makedirs(out_dir, exist_ok=True)
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    summary = {"matplotlib": has_mpl}
    launches = {}
    latents = ws.load_latent_vectors(tool_exp, "latest")
    for resolution, key in ((129, "html_97"), (64, "html_65")):
        summary[key], launches[key] = explorer_html(tool_exp, latents, resolution, out_dir, device)

    train_latents = ws.load_latent_vectors(train_exp, "latest")
    perplexity = min(30.0, max(2.0, train_latents.shape[0] / 4))
    runs = {}
    for dev in (device, "cpu"):
        t0 = time.time()
        emb, info = manifold.tsne(train_latents.astype(np.float64), perplexity=perplexity, device=dev,
                                  return_info=True)
        _sync(torch.device(dev))
        runs[dev] = (emb, info, time.time() - t0)
    (emb, info, t_dev), (ref, ref_info, t_cpu) = runs[device], runs["cpu"]
    emb_rel = float(np.abs(emb - ref).max() / np.abs(ref).max())
    kl_rel = abs(info["kl_divergence"] - ref_info["kl_divergence"]) / ref_info["kl_divergence"]
    if not (np.isfinite(emb).all() and emb_rel <= FIGURE_TSNE_TOL["emb_rel"] and kl_rel <= FIGURE_TSNE_TOL["kl_rel"]):
        raise AssertionError(f"figures: t-SNE on {device} against the CPU: embedding {emb_rel}, KL {kl_rel}")
    summary["tsne"] = {"latents": list(train_latents.shape), "perplexity": perplexity, "device": device,
                       "seconds": t_dev, "cpu_seconds": t_cpu, "emb_max_rel_diff": emb_rel, "kl_rel_diff": kl_rel,
                       "kl": info["kl_divergence"], "n_iter": info["n_iter"], "tol": FIGURE_TSNE_TOL}

    tool_specs = ws.load_experiment_specifications(tool_exp)
    data_dir = os.path.dirname(tool_specs["DataSource"])
    eval_specs = dict(tool_specs, TorusPath=os.path.join(data_dir, "Meshes"), TestSplit=tool_specs["TrainSplit"],
                      EvalTrainSceneNumber=3, EvalTestSceneNumber=1, EvalTestOptimizationSteps=800)
    if has_mpl:
        eval_specs["EvalGridResolution"] = 128
    trainer = Stage1Trainer(tool_exp, specs=eval_specs, device=device)
    decoder = ws_load_decoder(tool_exp, device)
    trainer.decoder.load_state_dict(decoder.state_dict())
    with torch.no_grad():
        trainer.latents.copy_(torch.as_tensor(latents, device=trainer.latents.device))
    recorder = ScalarRecorder()
    trainer._writer = recorder
    warnings = WarningRecorder()
    logging.getLogger().addHandler(warnings)
    fused_mlp.LAUNCHES = 0
    t0 = time.time()
    try:
        trainer._eval_train(1)
        t_train = time.time() - t0
        trainer._eval_test(1)
    finally:
        logging.getLogger().removeHandler(warnings)
    launches["stage1_eval"] = fused_mlp.LAUNCHES
    want = sorted(FIGURE_EVAL_TAGS) if has_mpl else []
    skipped = [m for m in warnings.messages if "eval figures skipped" in m]
    if (sorted(recorder.figures) != want or (not has_mpl and len(skipped) != 2)
            or not {"Mean Chamfer Dist/train", "Mean Chamfer Dist/test"} <= set(recorder.scalars)
            or (device == "cuda" and launches["stage1_eval"] <= 0)):
        raise AssertionError(f"figures: the Stage-1 eval hooks wrote figures {sorted(recorder.figures)} and scalars "
                             f"{sorted(recorder.scalars)}, warned {skipped}, K1 launched {launches['stage1_eval']}")
    summary["stage1_eval"] = {"figures": recorder.figures, "skipped_warnings": skipped, "scalars": recorder.scalars,
                              "eval_train_seconds": t_train, "seconds": time.time() - t0,
                              "k1_launches": launches["stage1_eval"],
                              "EvalGridResolution": eval_specs.get("EvalGridResolution", 256),
                              "cut": ("EvalGridResolution 128 (snapped to 129), not 256: plot_trisurf of three 257^3 "
                                      "meshes would take minutes to draw") if has_mpl else None}

    needs_mpl = ("latent_explorer_interp", "latent_explorer_sweep", "plot_log", "analyze_sdf_npz",
                 "latent_manifold")
    if not has_mpl:
        summary["not_run"] = {"steps": list(needs_mpl), "reason": "matplotlib does not import here"}
        summary["seconds"] = time.time() - t_start
        return summary, launches

    from msd_tpu_torch import analyze_sdf_npz, latent_explorer, latent_manifold, plot_log

    for mode in ("interp", "sweep"):
        out = os.path.join(out_dir, f"explorer_{mode}.png")
        fused_mlp.LAUNCHES = 0
        t0 = time.time()
        latent_explorer.main(["-e", tool_exp, "--mode", mode, "--steps", "3", "-N", "33", "--out", out,
                              "--device", device, "--quiet"])
        key = f"latent_explorer_{mode}"
        launches[key] = fused_mlp.LAUNCHES
        if device == "cuda" and launches[key] <= 0:
            raise AssertionError(f"figures: latent_explorer --mode {mode} launched no K1")
        summary[key] = {"seconds": time.time() - t0, "png_kb": os.path.getsize(out) / 1e3,
                        "k1_launches": launches[key]}

    t0 = time.time()
    pngs = [plot_log.main(["-e", train_exp, "-t", t, "--quiet"])
            for t in ("loss", "learning_rate", "time", "lat_mag", "param_mag")]
    summary["plot_log"] = {"seconds": time.time() - t0, "pngs": [os.path.basename(p) for p in pngs]}

    specs = ws.load_experiment_specifications(train_exp)
    npz = sorted(os.path.join(d, n) for d, _, names in os.walk(specs["DataSource"]) for n in names
                 if n.endswith(".npz"))[0]
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        analyze_sdf_npz.main([npz])
    summary["analyze_sdf_npz"] = {"seconds": time.time() - t0, "lines": buf.getvalue().splitlines()[1:]}

    t0 = time.time()
    written = latent_manifold.main(["-e", train_exp, "--methods", "pca", "ica", "hlle", "tsne",
                                    "--out_dir", os.path.join(out_dir, "manifold"), "--device", device, "--quiet"])
    if sorted(written) != ["hlle", "ica", "pca", "tsne"]:
        raise AssertionError(f"figures: latent_manifold wrote {sorted(written)}")
    for method, path in written.items():
        emb_m = np.load(path)
        if emb_m.shape != (train_latents.shape[0], 2) or not np.isfinite(emb_m).all():
            raise AssertionError(f"figures: latent_manifold {method}: {emb_m.shape}")
    summary["latent_manifold"] = {"seconds": time.time() - t0, "methods": sorted(written)}
    summary["seconds"] = time.time() - t_start
    return summary, launches


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU")
    from msd_tpu_torch import native
    from msd_tpu_torch.device import resolve_device
    from msd_tpu_torch.models import build_decoder
    from msd_tpu_torch.native import load_native
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
    with concurrent.futures.ThreadPoolExecutor(1) as pool:  # g++ beside the nvcc builds
        host_build = pool.submit(load_native)
        _build.build(_build.KERNEL_SOURCES)
        host_build.result()
    ptxas = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
             for n, log in _build.BUILD_LOGS.items()}
    phase("build", seconds=time.time() - t0, sources=list(_build.KERNEL_SOURCES), ptxas=ptxas,
          host_sources=list(native.SOURCES))

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
    ln_dec, _ = ln_decoder(specs, args.seed, dev)
    k1_ln = check_k1(ln_dec, latent, 2**20 + 37, args.seed, dev, label="flagship_ln")
    del ln_dec
    k1_wide = check_k1_wide(specs["CodeLength"], 2**20 + 37, args.seed, dev)
    phase("k1_wide", **k1_wide)
    phase("k1_kernels", **k1_ptxas(_build.BUILD_LOGS.get("fused_mlp", "")))
    fit = check_fit(decoder, args.seed, dev)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=ROOT) as root:
        t0 = time.time()
        (summary, results, t_eval, launches, routes, pair, mesher, (stream, k1_stream), fit_iterations,
         fit_launches) = serve(root, specs, decoder, args.seed)
        t_total = time.time() - t0
        variants, k1_ln_launches, k1_f32_launches = serving_variants(root, specs, decoder, args.seed)
    for s in summary:
        phase("serving_shape", **s)
    phase("serving", seconds=t_total, evaluate_seconds=t_eval, k1_launches=launches, k1_route_launches=routes,
          chamfer={r[0]: r[1][0] for r in results}, kernel_vs_plain_mesh=pair, fit_iterations=fit_iterations,
          fit_launches=fit_launches,
          note="seeded weights, not trained: the Chamfer is no quality figure")
    phase("serving_variants", **variants)
    phase("mesher_ab", **mesher)
    phase("streaming", **stream)

    k2 = check_k2(decoder, args.seed, dev)
    k2gemm = check_k2gemm(args.seed, dev)
    k2pt = check_k2pt(args.seed, dev)
    # last_kernel with its rank-one rows against the row streamer alone plus
    # the K = 0 chain launch those rows replace, per 65536-point chunk
    phase("rank1_ab", **{shape: {"rows_only_ms": k2pt["last_kernel"][shape]["rows_only_ms"],
                                 "chain_K0_ms": k2gemm[k0]["ms"], "fused_ms": k2pt["last_kernel"][shape]["ms"],
                                 "saved_ms": k2pt["last_kernel"][shape]["rows_only_ms"] + k2gemm[k0]["ms"]
                                 - k2pt["last_kernel"][shape]["ms"]}
                         for shape, k0 in (("b", "chain_u_last_K0"), ("d", "chain_delta_last_K0"))})
    k2d = check_k2d(decoder, args.seed, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=ROOT) as root:
        training, k2_launches = train(root, specs, args.seed)
        phase("training", **training)
        stage2_summary, k2d_launches, k1_stage2 = stage2(root, args.seed)
        phase("stage2", **stage2_summary)
        hpo_summary, k2d_hpo = hpo(root, args.seed)
        phase("hpo", **hpo_summary)
        profile_summary, k2_profile = profile_epochs(root)
        phase("profile", **profile_summary)
        points_summary, k2d_points, k1_points = stage2_points(root, args.seed)
        phase("stage2_points", **points_summary)
        stage2_inputs = input_report(os.path.join(root, "stage2_experiment"))
        points_ranks_summary, k2d_points_ranks = stage2_points_ranks(root, args.seed)
        phase("stage2_points_ranks", **points_ranks_summary)
        k2ce = check_k2ce(decoder, args.seed, dev)
        training_eik, k2c_launches = train_eik(root, specs, args.seed)
        phase("training_eik4096", **training_eik)
        training_gmm, k2_gmm_launches = train_gmm(root, args.seed, training["k2_kernel_launches_per_step"])
        phase("training_gmm", **training_gmm)
        training_iso = train_iso(root, specs, args.seed)
        phase("training_iso", **training_iso)
        dp_summary, k2e_launches = dp(root, specs, args.seed)
        phase("dp", **dp_summary)
        train_exp = os.path.join(root, "train_experiment")  # kept for the figures phase
        with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=ROOT) as root2:
            prep_summary, prep_records = preprocess(root2, args.seed)
            for r in prep_records:
                phase("preprocess_mesh", **r)
            phase("preprocess", **prep_summary)
            ranks_summary, k1_ranks, rank_latents = serving_ranks(
                root2, specs, decoder, args.seed, os.path.join(root2, "meshes", prep_summary["meshes"][0] + ".obj"))
            phase("serving_ranks", **ranks_summary)
            phase("tooling", **tooling(root2, specs, decoder, rank_latents, stage2_inputs))
            figures_summary, k1_figures = figures(os.path.join(root2, "tooling_experiment"), train_exp,
                                                  os.path.join(root2, "figures"))
            phase("figures", **figures_summary)

    bf16, f32, ln = k1["bfloat16"], k1["float32"], k1_ln["bfloat16"]

    def worst(r):  # max abs error over both K1 inputs
        return max(r["max_abs_err"], r["corner_lattice_257"]["max_abs_err"])

    def k1_entry(r):
        return {"max_abs_err": worst(r), **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
                "library_ms": None, "library_note": "no single PyTorch call computes the whole decoder",
                "dtype": r["dtype"], "decoder": r["decoder"], "points": r["points"], "kernel_route": r["route"],
                "ms_again": r["ms_again"], "matmul_ref_ms": r["matmul_ref_ms"],
                "matmul_true_ms": r["matmul_true_ms"]}

    def wide_entry(key):  # a wide kernel: its launches in create_mesh of its decoder
        r = k1_wide[key]
        return {"launches": k1_wide["create_mesh"][key]["launches"], "max_abs_err": r["max_abs_err"],
                **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "matmul_ref_ms", "matmul_true_ms")},
                "library_ms": None, "library_note": "no single PyTorch call computes the whole decoder",
                "decoder": key, "points": r["points"], "kernel_route": r["route"]}

    b, a = k2["b"], k2["a"]
    autograd_step = {"autograd_step_ms": training["step_ms_by_path"]["autograd_b"],
                     "autograd_step_note": "the trainer's float32 autograd step, batch_split 4, same batch"}
    k1_source = {"route": "cuda", "source": "msd_tpu_torch/csrc/fused_mlp.cu",
                 "replaces": "msd_tpu/ops/fused_mlp.py:211"}
    print(json.dumps({"kernels": [{
        "name": "fused_mlp", **k1_source, "launches": launches, "launches_stage2": k1_stage2,
        "launches_stage2_points": k1_points, "launches_serving_ranks": k1_ranks,
        "launches_streaming": k1_stream, "launches_figures": k1_figures, **k1_entry(bf16),
        "route_launches": routes,
    }, {
        "name": "fused_mlp_wgmma_ln", **k1_source, "launches": k1_ln_launches, **k1_entry(ln),
    }, {
        "name": "fused_mlp_f32", **k1_source, "launches": k1_f32_launches, **k1_entry(f32),
        "layer_norm": k1_entry(k1_ln["float32"]),
    }, {
        "name": "fused_mlp_wgmma_wide", **k1_source, **wide_entry("wide_bfloat16"),
    }, {
        "name": "fused_mlp_wgmma_wide_ln", **k1_source, **wide_entry("wide_ln_bfloat16"),
    }, {
        "name": "fused_mlp_f32_wide", **k1_source, **wide_entry("wide_float32"),
        "layer_norm": wide_entry("wide_ln_float32"),
    }, {
        "name": "fused_fit", "route": "cuda", "source": "msd_tpu_torch/csrc/fused_fit.cu",
        "replaces": "none: the fit's autograd route (msd_tpu/train/reconstruct.py is a lax.scan of XLA operations)",
        "launches": fit_launches, "fit_iterations_serving": fit_iterations,
        "launches_per_iteration": fit["launches_per_call"],
        **{k: fit[k] for k in ("ms", "plain_ms", "autograd_ms", "library_ms", "library_note", "bound_ms",
                               "products_ms", "products_tflops", "iteration_ms", "vs_float64", "vs_plain")},
        "bound_by": "operations", "max_rel_frobenius": max(e["grad_rel"] for e in fit["errors"].values()),
        "points": 8 * fit["points_per_shape"],
    }, {
        "name": "fused_train", "route": "cuda", "source": "msd_tpu_torch/csrc/fused_train.cu",
        "replaces": "msd_tpu/ops/fused_train.py:423", "launches": k2_launches + k2_gmm_launches,
        "launches_training": k2_launches, "launches_training_gmm": k2_gmm_launches,
        "launches_profile": k2_profile,
        "max_abs_err": b["vs_plain"]["max_abs_err"], "max_rel_frobenius": b["vs_plain"]["worst_grad_rel"],
        "ms": b["ms"], "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
        "library_ms": None, "library_note": "no single PyTorch call computes the loss and every gradient",
        "variant": "b (eikonal)", "points": b["points"], "design_bytes_ms": b["design_bytes_ms"],
        "step_ms": training["step_ms_median"], **autograd_step, "gmm_step_ms": training_gmm["step_ms_median"],
        "gemm": {k: {f: r[f] for f in ("ms", "library_ms", "bound_ms", "bound_by", "tflops")}
                 for k, r in k2gemm.items()},
        "pointwise": {k: {shape: {f: r[f] for f in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
                          for shape, r in per_shape.items()} for k, per_shape in k2pt.items()},
        "variant_a": {k: a[k] for k in ("ms", "plain_ms", "bound_ms", "design_bytes_ms")}
                     | {"max_abs_err": a["vs_plain"]["max_abs_err"],
                        "max_rel_frobenius": a["vs_plain"]["worst_grad_rel"],
                        "step_ms": training["step_ms_by_path"]["k2_a"],
                        "autograd_step_ms": training["step_ms_by_path"]["autograd_a"]},
        "variant_d": {k: k2d[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "design_bytes_ms")}
                     | {"max_abs_err": k2d["vs_plain"]["dlat"]["max_abs_err"],
                        "max_rel_frobenius": k2d["vs_plain"]["dlat"]["rel"], "loss_rel": k2d["vs_plain"]["loss_rel"],
                        "launches": k2d_launches, "step_ms": stage2_summary["step_ms_median"],
                        "launches_stage2_points": k2d_points, "points_step_ms": points_summary["step_ms_median"],
                        "launches_stage2_points_ranks": k2d_points_ranks, "launches_hpo": k2d_hpo,
                        "autograd_step_ms": stage2_summary["autograd_step_ms"], "library_ms": None},
        **{f"variant_{v}": {k: k2ce[v][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "design_bytes_ms")}
           | {"max_abs_err": k2ce[v]["vs_plain"]["max_abs_err"],
              "max_rel_frobenius": k2ce[v]["vs_plain"]["worst_grad_rel"], "loss_rel": k2ce[v]["vs_plain"]["loss_rel"],
              "launches": n, "library_ms": None, "step_ms": step}
           for v, n, step in (("c", k2c_launches, training_eik["step_ms_median"]),
                              ("e", k2e_launches, float(np.median(dp_summary["stage1"]["per_rank"][0]["step_ms"]))))},
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
