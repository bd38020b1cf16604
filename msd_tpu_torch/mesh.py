"""Grid SDF evaluation + mesh extraction (create_mesh).

Counterpart of ``msd_tpu/mesh.py`` (ref: deep_sdf/mesh.py:21-165), its
non-streaming paths:

* ``PointEvaluator`` answers SDF queries for one latent through K1
  (``ops/fused_mlp.py``: the CUDA kernel on a GPU, its plain version on
  the CPU). Only the configs the TPU kernel refuses too (``xyz_in_all``,
  weights over 10 MB) take the plain decoder, with a warning.
* ``eval_grid_dense`` evaluates all N^3 grid points (coordinates made on
  the device from linear indices, x slowest, z fastest).
* ``eval_grid_sparse`` / the sparse ``create_mesh`` evaluate a stride-4
  corner lattice and refine only blocks that may hold the zero level set
  (|sdf| at a corner below the scaled half block diagonal, or a corner
  sign change), then mesh the active blocks directly.
* Marching tetrahedra + PLY write on the host.

The streaming extraction of ``msd_tpu`` (wire codecs, fetch pools,
optimistic refinement) is not part of the port yet.
"""

from __future__ import annotations

import logging
import math
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from msd_tpu_torch.data.mesh_io import save_ply
from msd_tpu_torch.models.deepsdf import decode_sdf
from msd_tpu_torch.ops.fused_mlp import FusedDecoderSpec, UnsupportedConfig, fused_eval
from msd_tpu_torch.ops.marching_cubes import marching_tetrahedra, marching_tetrahedra_blocks

# Fixed sparse-refinement block size (msd_tpu/mesh.py SPARSE_BLOCK).
SPARSE_BLOCK = 4
# Points per K1 call on the GPU: the flagship-width kernel needs no
# scratch, so chunks are large (``fused_eval`` splits a wide decoder's
# launches by the scratch they need).
KERNEL_CHUNK = 2**24


def _linear_to_coords(linear_idx: torch.Tensor, N: int) -> torch.Tensor:
    """Linear index -> xyz coordinate in [-1, 1], x slowest and z fastest
    (ref: deep_sdf/mesh.py:38-51)."""
    voxel_size = 2.0 / (N - 1)
    z = linear_idx % N
    y = (linear_idx // N) % N
    x = (linear_idx // (N * N)) % N
    return torch.stack([x, y, z], dim=-1).float() * voxel_size - 1.0


class PointEvaluator:
    """Latent-conditioned SDF point evaluator on the decoder's device.

    ``dtype`` is the kernel's operand type: bfloat16 by default on a GPU,
    float32 on the CPU (where ``msd_tpu`` evaluates in float32 too).
    ``n_evaluated`` counts the points this process evaluated so far.

    ``group`` (a ``DataParallelGroup``; counterpart of ``msd_tpu``'s
    ``mesh=``): ``eval_points`` splits the points into one contiguous slice
    per rank (``group.row_slice``), each rank evaluates its slice (K1 on
    the card, the plain version on the CPU) and every rank gathers every
    value, so ``eval_blocks`` and ``eval_grid_dense`` / ``eval_grid_sparse``
    / ``create_mesh`` handed this evaluator run over the group. Every rank
    must call them in lockstep, with the same latent and points.
    ``create_mesh`` writes its ``.ply`` on the main rank only."""

    def __init__(self, decoder, dtype: Optional[torch.dtype] = None, max_batch: int = 2**18, group=None):
        self.decoder = decoder
        self.group = group
        self.device = next(decoder.parameters()).device
        if dtype is None:
            dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.dtype = dtype
        self.max_batch = int(max_batch)
        self.n_evaluated = 0
        # Only the configs the TPU kernel refuses too take the plain decoder;
        # any other refusal (an operand type that is not ported) raises.
        try:
            self.spec = FusedDecoderSpec(decoder, dtype)
        except UnsupportedConfig as e:
            logging.warning("fused kernel unavailable, using the plain decoder: %s", e)
            self.spec = None

    @property
    def fused(self) -> bool:
        return self.spec is not None

    @torch.no_grad()
    def eval_points(self, latent, pts) -> torch.Tensor:
        """pts [n, 3] (array or tensor) -> sdf [n] float32 on the device."""
        pts = torch.as_tensor(pts, dtype=torch.float32, device=self.device).reshape(-1, 3)
        latent = torch.as_tensor(latent, dtype=torch.float32, device=self.device).reshape(-1)
        if self.group is not None:
            pts = pts[self.group.row_slice(pts.shape[0])]
        kernel = self.spec is not None and self.device.type == "cuda"
        chunk = KERNEL_CHUNK if kernel else self.max_batch
        outs = []
        for start in range(0, pts.shape[0], chunk):
            part = pts[start : start + chunk]
            if self.spec is not None:
                outs.append(fused_eval(self.spec, latent, part))
            else:
                outs.append(decode_sdf(self.decoder, latent, part)[:, 0])
        self.n_evaluated += pts.shape[0]
        vals = torch.cat(outs) if outs else pts.new_zeros(0)
        return vals if self.group is None else self.group.all_gather_rows(vals)

    def eval_blocks(self, latent, abi: np.ndarray, b: int, N: int, scale: int = 1) -> np.ndarray:
        """SDF at every stride-``scale`` lattice point of the given blocks
        (block indices ``abi`` [A, 3]). Returns [A, b+1, b+1, b+1]."""
        local = torch.arange(b + 1, device=self.device)
        offs = torch.stack(torch.meshgrid(local, local, local, indexing="ij"), dim=-1).reshape(-1, 3)
        abi_t = torch.as_tensor(np.asarray(abi), dtype=torch.int64, device=self.device)
        fine = (abi_t * (b * scale))[:, None, :] + offs[None, :, :] * scale
        pts = fine.reshape(-1, 3).float() * (2.0 / (N - 1)) - 1.0
        vals = self.eval_points(latent, pts)
        return vals.reshape(abi_t.shape[0], b + 1, b + 1, b + 1).cpu().numpy()


def eval_grid_dense(decoder, latent, N: int, max_batch: int = 2**18,
                    evaluator: Optional[PointEvaluator] = None) -> np.ndarray:
    """[N, N, N] SDF grid over [-1, 1]^3 (dense, every point evaluated)."""
    evaluator = evaluator or PointEvaluator(decoder, max_batch=max_batch)
    total = N**3
    chunk = KERNEL_CHUNK if evaluator.fused and evaluator.device.type == "cuda" else max_batch
    out = np.empty(total, np.float32)
    for start in range(0, total, chunk):
        size = min(chunk, total - start)
        idx = torch.arange(start, start + size, device=evaluator.device)
        out[start : start + size] = evaluator.eval_points(latent, _linear_to_coords(idx, N)).cpu().numpy()
    return out.reshape(N, N, N)


def _snap_n(N: int) -> int:
    """Smallest N' >= N with (N'-1) divisible by SPARSE_BLOCK."""
    r = (N - 1) % SPARSE_BLOCK
    return N if r == 0 else N + (SPARSE_BLOCK - r)


def _pick_block(N: int, clamp_dist: float, safety: float) -> int:
    """SPARSE_BLOCK when the Lipschitz bound can exclude blocks at this
    resolution (half block diagonal below the clamp band), else 1 (dense).

    Soundness: any point inside a block is within half the block diagonal
    of its nearest corner, so a crossing inside implies some corner has
    |sdf| <= b*h*sqrt(3)/2 (for a 1-Lipschitz clamped field)."""
    h = 2.0 / (N - 1)
    b = SPARSE_BLOCK
    if (N - 1) % b == 0 and b * h * math.sqrt(3.0) / 2.0 * safety < clamp_dist:
        return b
    return 1


def corner_lattice(N: int, b: int) -> np.ndarray:
    """[((N-1)/b + 1)^3, 3] float32 block corners of the sparse path's first
    stage, x slowest."""
    ci = np.arange((N - 1) // b + 1) * b
    cx, cy, cz = np.meshgrid(ci, ci, ci, indexing="ij")
    return np.stack([cx, cy, cz], axis=-1).reshape(-1, 3).astype(np.float32) * (2.0 / (N - 1)) - 1.0


def _sparse_blocks(latent, N, b, safety, evaluator: PointEvaluator):
    """Two-stage sparse evaluation. Returns (corner_sdf [(nb+1)^3 lattice],
    abi [A, 3] active block indices, block_vals [A, b+1, b+1, b+1], stats)."""
    nb = (N - 1) // b
    h = 2.0 / (N - 1)
    diag = b * h * math.sqrt(3.0) / 2.0 * safety
    n_corner = (nb + 1) ** 3

    # stage 1: corner lattice [(nb+1)^3]
    corner_sdf = evaluator.eval_points(latent, corner_lattice(N, b)).cpu().numpy().reshape(nb + 1, nb + 1, nb + 1)

    # stage 2: active blocks (Lipschitz bound or corner sign change)
    cmin = np.full((nb, nb, nb), np.inf)
    sign_any = np.zeros((nb, nb, nb), dtype=bool)
    sign_all = np.ones((nb, nb, nb), dtype=bool)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                sub = corner_sdf[dx : nb + dx, dy : nb + dy, dz : nb + dz]
                cmin = np.minimum(cmin, np.abs(sub))
                neg = sub < 0
                sign_any |= neg
                sign_all &= neg
    active = (cmin < diag) | (sign_any & ~sign_all)
    abi = np.stack(np.nonzero(active), axis=1)  # [A, 3]

    # stage 3: evaluate active block interiors
    if abi.shape[0] > 0:
        block_vals = evaluator.eval_blocks(latent, abi, b, N)
    else:
        block_vals = np.zeros((0, b + 1, b + 1, b + 1), np.float32)
    stats = {
        "block": b,
        "active_blocks": int(abi.shape[0]),
        "total_blocks": int(nb**3),
        "evaluated": int(n_corner + abi.shape[0] * (b + 1) ** 3),
        "total": int(N**3),
    }
    return corner_sdf, abi, block_vals, stats


def eval_grid_sparse(decoder, latent, N: int, max_batch: int = 2**18, clamp_dist: float = 0.1,
                     safety: float = 1.3, evaluator: Optional[PointEvaluator] = None) -> Tuple[np.ndarray, dict]:
    """Sparse block-refined SDF grid. Returns (grid [N,N,N], stats).

    Inactive blocks are filled with their corner value (sign-correct by the
    Lipschitz argument), which cannot introduce spurious zero crossings."""
    evaluator = evaluator or PointEvaluator(decoder, max_batch=max_batch)
    b = _pick_block(N, clamp_dist, safety)
    if b <= 2:
        grid = eval_grid_dense(decoder, latent, N, max_batch, evaluator)
        return grid, {"block": 1, "evaluated": N**3, "total": N**3}
    corner_sdf, abi, block_vals, stats = _sparse_blocks(latent, N, b, safety, evaluator)
    nb = (N - 1) // b
    grid = np.repeat(np.repeat(np.repeat(corner_sdf[:nb, :nb, :nb], b, 0), b, 1), b, 2)
    grid = np.pad(grid, ((0, 1), (0, 1), (0, 1)), mode="edge")
    if abi.shape[0] > 0:
        local = np.arange(b + 1)
        lx, ly, lz = np.meshgrid(local, local, local, indexing="ij")
        local_offsets = np.stack([lx, ly, lz], axis=-1).reshape(-1, 3)
        fine_idx = ((abi * b)[:, None, :] + local_offsets[None, :, :]).reshape(-1, 3)
        grid[fine_idx[:, 0], fine_idx[:, 1], fine_idx[:, 2]] = block_vals.reshape(-1)
    return grid, stats


def convert_sdf_samples_to_ply(sdf_tensor, voxel_grid_origin, voxel_size, ply_filename_out,
                               offset=None, scale=None) -> bool:
    """[n, n, n] SDF grid -> marching tetrahedra -> .ply (ref:
    deep_sdf/mesh.py:96-165). Returns False on an empty surface like the
    reference, True on success."""
    if isinstance(sdf_tensor, torch.Tensor):
        sdf_tensor = sdf_tensor.detach().cpu().numpy()
    sdf = np.asarray(sdf_tensor, np.float32)
    try:
        verts, faces = marching_tetrahedra(
            sdf, level=0.0, spacing=(float(voxel_size),) * 3,
            origin=tuple(float(o) for o in voxel_grid_origin),
        )
    except ValueError as e:
        logging.error("[create_mesh] Caught marching cubes error: %s.", e)
        return False
    if scale is not None:
        verts = verts / scale
    if offset is not None:
        verts = verts - offset
    save_ply(ply_filename_out, verts, faces)
    return True


def create_mesh(
    decoder,
    latent_vec,
    filename: Optional[str] = None,
    N: int = 512,
    max_batch: int = 2**18,
    offset=None,
    scale=None,
    return_mesh: bool = False,
    sparse: bool = True,
    clamp_dist: float = 0.1,
    sparse_safety: float = 1.3,
    evaluator: Optional[PointEvaluator] = None,
    eval_dtype: Optional[torch.dtype] = None,
):
    """Latent -> SDF grid -> marching tetrahedra -> .ply
    (ref: deep_sdf/mesh.py:21-93). Returns (verts, faces) when
    ``return_mesh`` and extraction succeeded, True when it succeeded
    otherwise, and False on an empty surface like the reference (:118-124).

    ``sparse`` snaps N up to the next 4k+1 (equal or finer sampling than
    asked). ``eval_dtype`` is the kernel operand type when no ``evaluator``
    is given (default: bfloat16 on a GPU, float32 on the CPU)."""
    start = time.time()
    if evaluator is None:
        evaluator = PointEvaluator(decoder, dtype=eval_dtype, max_batch=max_batch)
    if sparse:
        N = _snap_n(N)
    voxel_size = 2.0 / (N - 1)
    b = _pick_block(N, clamp_dist, sparse_safety) if sparse else 1
    try:
        if b > 2:
            # sparse: mesh directly from the active blocks, never
            # materialising the N^3 grid
            _, abi, block_vals, stats = _sparse_blocks(latent_vec, N, b, sparse_safety, evaluator)
            logging.debug("[create_mesh] sparse eval stats: %s", stats)
            logging.debug("[create_mesh] sampling takes: %f", time.time() - start)
            verts, faces = marching_tetrahedra_blocks(
                block_vals, abi * b, N,
                level=0.0, spacing=(voxel_size,) * 3, origin=(-1.0, -1.0, -1.0),
            )
        else:
            sdf_grid = eval_grid_dense(decoder, latent_vec, N, max_batch, evaluator)
            logging.debug("[create_mesh] sampling takes: %f", time.time() - start)
            verts, faces = marching_tetrahedra(
                sdf_grid, level=0.0, spacing=(voxel_size,) * 3, origin=(-1.0, -1.0, -1.0)
            )
    except ValueError as e:
        logging.error("[create_mesh] Caught marching cubes error: %s.", e)
        return False

    # apply additional offset and scale (ref: deep_sdf/mesh.py:132-136)
    if scale is not None or offset is not None:
        pts = verts.astype(np.float64)
        if scale is not None:
            pts = pts / scale
        if offset is not None:
            pts = pts - offset
        verts = pts.astype(np.float32)

    if filename and (evaluator.group is None or evaluator.group.is_main):
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        save_ply(filename + ".ply", verts, faces)
    if return_mesh:
        return verts, faces
    return True
