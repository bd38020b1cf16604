"""Grid SDF evaluation + mesh extraction (create_mesh).

Counterpart of ``msd_tpu/mesh.py`` (ref: deep_sdf/mesh.py:21-165):

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
* The streaming ``create_mesh`` (``_create_mesh_streaming_impl``), the
  route on the card: the active blocks are refined on the device
  (``refine_active4_device``; on the host where a cap overflows),
  evaluated in slabs whose crossing rows are compacted on the device and
  encoded with a value codec ("packed", "int8" or "f16";
  ``_encode_compact_body``), copied to pinned host memory on a side stream
  and decoded on a host thread, while one worker thread feeds the C++
  mesher, which writes the PLY as it meshes. With ``msd_tpu``'s corner
  dedup (``MSD_STREAM_DEDUP``; by default on the card for two-level active
  sets of 16384 blocks or more, so at N=513) a slab evaluates each block's
  64 low corners and only the face corners its neighbours in the slab do
  not hold (``_slab_dedup``), which gives the plain slab's values bit for
  bit. Over a group the main rank streams on its own card and the other
  ranks join only the host refinement's lattice (``create_mesh``). Not
  ported:
  ``msd_tpu``'s optimistic single-level refinement (``refine1_optimistic``,
  ``MSD_STREAM_OPT``), which was slower on the card than the device route
  (PERF.md), and its hybrid two-level dispatch
  (``MSD_STREAM_HYBRID``).
* Marching tetrahedra + PLY write on the host.
"""

from __future__ import annotations

import ctypes
import itertools
import logging
import math
import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from msd_tpu_torch import stream_knobs
from msd_tpu_torch.data.mesh_io import save_ply
from msd_tpu_torch.models.deepsdf import decode_sdf
from msd_tpu_torch.native import load_native
from msd_tpu_torch.ops.fused_mlp import FusedDecoderSpec, UnsupportedConfig, fused_eval
from msd_tpu_torch.ops.marching_cubes import _FLIP_TABLE, marching_tetrahedra, marching_tetrahedra_blocks

# Fixed sparse-refinement block size (msd_tpu/mesh.py SPARSE_BLOCK).
SPARSE_BLOCK = 4
# ``create_mesh``'s defaults for the refinement's clamp band and the safety
# factor of its Lipschitz bound (``_pick_block``, ``mesh_route``)
CLAMP_DIST = 0.1
SPARSE_SAFETY = 1.3
# Points per K1 call on the GPU: the flagship-width kernel needs no
# scratch, so chunks are large (``fused_eval`` splits a wide decoder's
# launches by the scratch they need).
KERNEL_CHUNK = 2**24
# CPU batches are padded to whole multiples of this many rows: the CPU's
# GEMMs and vectorised loops take a batch's leftover rows (past its last
# whole vector or tile, also per thread) down other code paths that can
# round them differently, so without the padding a point's float32 value
# depends on its place in the batch (the corner dedup needs it not to)
CPU_ROW_ALIGN = 64


def _dedup_tables():
    """Static index tables of the corner dedup (msd_tpu/mesh.py:710-736):
    the 7 positive neighbour shifts; per shift, the owner-local low
    offsets that cover a block's top corners of that class (16 for a face,
    4 for an edge, 1 for the corner), their places in the owner's 64 low
    corners and in this block's 125 corners; and the 64 low offsets with
    their places among the 125."""
    b, n1 = SPARSE_BLOCK, SPARSE_BLOCK + 1
    shifts = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (1, 0, 1), (0, 1, 1), (1, 1, 1)]
    lowrange = np.arange(b)
    own_offs, own_pos, pos125 = [], [], []
    for sh in shifts:
        axes = [np.array([0]) if d else lowrange for d in sh]
        offs = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
        own_offs.append(offs.astype(np.int32))
        own_pos.append(offs[:, 0] * b * b + offs[:, 1] * b + offs[:, 2])
        top = offs + np.asarray(sh) * b
        pos125.append(top[:, 0] * n1 * n1 + top[:, 1] * n1 + top[:, 2])
    low_offs = np.stack(np.meshgrid(lowrange, lowrange, lowrange, indexing="ij"), axis=-1).reshape(-1, 3)
    lowpos125 = low_offs[:, 0] * n1 * n1 + low_offs[:, 1] * n1 + low_offs[:, 2]
    return dict(shifts=np.asarray(shifts, np.int32), own_offs=own_offs, own_pos=own_pos, pos125=pos125,
                low_offs=low_offs.astype(np.int32), lowpos125=lowpos125)


def _packed_needed_mask(sign: np.ndarray) -> np.ndarray:
    """[K, 125] bool: corners incident to a sign change within their
    clipped 3^3 lattice window, needed = dilate(neg) & dilate(pos)
    (msd_tpu/mesh.py:37). The numpy mirror of the encoder's window test
    (``_window_needed``) and of the native decoder's dilation (codec.cpp)."""
    K = sign.shape[0]
    s = sign.reshape(K, 5, 5, 5)

    def dil3(x):
        for ax in (1, 2, 3):
            y = x.copy()
            sl_lo = [slice(None)] * 4
            sl_hi = [slice(None)] * 4
            sl_lo[ax] = slice(1, None)
            sl_hi[ax] = slice(None, -1)
            y[tuple(sl_lo)] |= x[tuple(sl_hi)]
            y[tuple(sl_hi)] |= x[tuple(sl_lo)]
            x = y
        return x

    return (dil3(s) & dil3(~s)).reshape(K, 125)


def _decode_packed_host(bitmaps: np.ndarray, mags: np.ndarray, K: int, q: float,
                        pts: int = 125, use_native: bool = True) -> np.ndarray:
    """Expand the "packed" value codec (a 16-byte sign bitmap per row and
    dense u8 magnitudes over the row's needed corners; see
    ``PointEvaluator._encode_compact_body``) to the [K, pts] float32 corner
    values (msd_tpu/mesh.py:61). The needed set is derived again from the
    sign bitmap; corners outside it decode to the codec cap q*255.
    ``use_native``: the C++ decoder (``msd_decode_packed``, codec.cpp), else
    numpy. A magnitude stream that does not match the needed sets raises
    ``RuntimeError``."""
    if bitmaps.shape[0] < K:
        raise ValueError(f"packed codec: {bitmaps.shape[0]} bitmap rows for K={K} blocks")
    if pts != 125:
        raise ValueError(f"packed codec requires 125-corner blocks, got {pts}")
    bitmaps = np.ascontiguousarray(bitmaps[:K], np.uint8)
    mags = np.ascontiguousarray(mags, np.uint8)
    if use_native:
        lib = load_native()
        out = np.empty((K, pts), np.float32)
        used = lib.msd_decode_packed(
            bitmaps.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            mags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            K, mags.size, pts, float(q), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if used != mags.size:
            raise RuntimeError(f"packed codec stream mismatch: {used} magnitudes consumed, {mags.size} shipped")
        return out
    sign = np.unpackbits(bitmaps, axis=1, bitorder="little")[:, :pts].astype(bool)
    present = _packed_needed_mask(sign)
    if int(present.sum()) != mags.size:
        raise RuntimeError(f"packed codec stream mismatch: {int(present.sum())} magnitudes consumed, "
                           f"{mags.size} shipped")
    vals = np.full((K, pts), q * np.float32(255.0), np.float32)
    vals[present] = mags.astype(np.float32) * q
    return np.where(sign, -vals, vals)


def _linear_to_coords(linear_idx: torch.Tensor, N: int) -> torch.Tensor:
    """Linear index -> xyz coordinate in [-1, 1], x slowest and z fastest
    (ref: deep_sdf/mesh.py:38-51)."""
    voxel_size = 2.0 / (N - 1)
    z = linear_idx % N
    y = (linear_idx // N) % N
    x = (linear_idx // (N * N)) % N
    return torch.stack([x, y, z], dim=-1).float() * voxel_size - 1.0


def _refine_class(N: int, safety: float, clamp_dist: float):
    """Resolution class of the block refinement (msd_tpu/mesh.py:158):
    (h, nb4, two_level), or None where it does not apply (a lattice that
    does not divide, or a block diagonal beyond the Lipschitz bound)."""
    b = SPARSE_BLOCK
    h = 2.0 / (N - 1)
    s3 = math.sqrt(3.0) / 2.0
    if (N - 1) % b != 0 or b * h * s3 * safety >= clamp_dist:
        return None
    nb4 = (N - 1) // b
    two_level = (N - 1) % (4 * b) == 0 and (4 * b) * h * s3 * safety < clamp_dist and nb4 % 4 == 0
    return h, nb4, two_level


def _lattice_points(fine: torch.Tensor, h: float) -> torch.Tensor:
    """int32 lattice indices [..., 3] -> [n, 3] float32 points in [-1, 1].
    Every block program makes its points through this one expression, so
    equal indices give bit-equal points."""
    return fine.reshape(-1, 3).float() * h - 1.0


def _grid(n: int, device) -> torch.Tensor:
    """[n^3, 3] int32 lattice indices, x slowest (np.nonzero's row order)."""
    r = torch.arange(n, dtype=torch.int32, device=device)
    return torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1).reshape(-1, 3)


def _corner_active(v: torch.Tensor, diag) -> torch.Tensor:
    """v [..., n+1, n+1, n+1] -> [..., n, n, n] bool: the cells whose 8
    corners hold a value below ``diag`` in magnitude or both signs."""
    n = v.shape[-1] - 1
    cmin = s_any = s_all = None
    for dx, dy, dz in itertools.product((0, 1), repeat=3):
        sub = v[..., dx:n + dx, dy:n + dy, dz:n + dz]
        neg = sub < 0
        if cmin is None:
            cmin, s_any, s_all = sub.abs(), neg, neg
        else:
            cmin, s_any, s_all = torch.minimum(cmin, sub.abs()), s_any | neg, s_all & neg
    return (cmin < diag) | (s_any & ~s_all)


def _compact_dest(flags: torch.Tensor, cap: int):
    """(count, dest): the flagged rows' slots in a [cap + 1] buffer, in row
    order; every other row, and every row past ``cap``, goes to slot
    ``cap``. No host sync (no ``nonzero``)."""
    f = flags.to(torch.int32)
    count = f.sum(dtype=torch.int64)
    dest = torch.where(flags, torch.cumsum(f, 0, dtype=torch.int64) - 1, cap).clamp_(max=cap)
    return count, dest


def _scatter_rows(rows: torch.Tensor, dest: torch.Tensor, cap: int) -> torch.Tensor:
    """rows scattered to ``dest`` of a zeroed [cap + 1, ...] buffer; the
    slop slot ``cap`` dropped."""
    out = rows.new_zeros((cap + 1,) + tuple(rows.shape[1:]))
    out[dest] = rows
    return out[:cap]


def _crossing(vals: torch.Tensor) -> torch.Tensor:
    """[n, 125] -> [n] bool: blocks whose corner values hold both signs."""
    neg = vals < 0
    return neg.any(1) & ~neg.all(1)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[n, m] bool -> [n, ceil(m / 8)] uint8, little-endian bit order."""
    n, m = bits.shape
    padded = F.pad(bits.to(torch.uint8), (0, -m % 8))
    w = (2 ** torch.arange(8, device=bits.device)).to(torch.uint8)
    return (padded.reshape(n, -1, 8) * w).sum(-1).to(torch.uint8)


def _scalar(value, device) -> torch.Tensor:
    """A float32 scalar made on ``device`` by a fill: a host-to-device copy
    of pageable memory would wait for the work already enqueued."""
    return torch.full((), float(value), dtype=torch.float32, device=device)


def _window_needed(sign_neg: torch.Tensor) -> torch.Tensor:
    """[n, 125] bool -> [n, 125] bool: corners whose clipped 3^3 window on
    the 5^3 lattice holds both signs (msd_tpu's window-adjacency product,
    as two max pools: dilate(neg) & dilate(pos))."""
    x = sign_neg.reshape(-1, 1, 5, 5, 5).to(torch.float32)
    dn = F.max_pool3d(x, 3, 1, 1) > 0
    dp = F.max_pool3d(1.0 - x, 3, 1, 1) > 0
    return (dn & dp).reshape(sign_neg.shape)


class PointEvaluator:
    """Latent-conditioned SDF point evaluator on the decoder's device.

    ``dtype`` is the kernel's operand type: bfloat16 by default on a GPU,
    float32 on the CPU (where ``msd_tpu`` evaluates in float32 too).
    ``n_evaluated`` counts the points this process evaluated so far.

    ``group`` (a ``DataParallelGroup``; counterpart of ``msd_tpu``'s
    ``mesh=``): ``eval_points`` splits the points into one contiguous slice
    per rank (``group.row_slice``), each rank evaluates its slice (K1 on
    the card, the plain version on the CPU) and every rank gathers every
    value, as ``msd_tpu``'s ``mesh=`` shards ``eval_points`` alone. Every
    rank must call ``eval_points`` (so ``eval_grid_dense``,
    ``eval_grid_sparse`` and ``create_mesh`` handed this evaluator) in
    lockstep, with the same latent and points. The block, slab and
    refinement programs (``eval_blocks``, ``crossing_blocks``,
    ``subblock_active``, the streaming methods) run on the calling rank
    alone (``_eval_local``). ``create_mesh`` streams over a group on the
    card, with the main rank streaming, and writes its ``.ply`` on the main
    rank only.

    The streaming methods (``refine_active4_device``,
    ``stream_crossing_values``) keep ``msd_tpu``'s names and caps. Past the
    refinement's count, their device work is enqueued without a host sync,
    and every copy to the host goes to pinned memory on a side stream
    (``_fetch_async``)."""

    # blocks per slab granule: 8192 * 125 = 1,024,000 points
    A_CHUNK = 8192
    # on-device compaction cap: slabs under the minimum stream uncapped;
    # larger slabs cap at ratio * slab, and an overflow re-runs the slab
    # exactly (instance attributes, so tests can force the overflow)
    compact_cap_min_blocks = 24576
    compact_cap_ratio = 0.55
    # "packed" codec magnitude budget per crossing block
    packed_mag_bytes_per_block = 80

    def __init__(self, decoder, dtype: Optional[torch.dtype] = None, max_batch: int = 2**18, group=None):
        self.decoder = decoder
        self.group = group
        self.device = next(decoder.parameters()).device
        if dtype is None:
            dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.dtype = dtype
        self.max_batch = int(max_batch)
        self.n_evaluated = 0
        self._copy_stream = None
        self._decode_pool_obj = None
        self._dedup_consts_obj = None
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
        """pts [n, 3] (array or tensor) -> sdf [n] float32 on the device.
        Under a group each rank evaluates its slice (``_eval_local``) and
        every rank gathers every value; a rank whose slice raised makes
        every rank raise before the gather (``DataParallelGroup.any_true``)."""
        if self.group is None:
            return self._eval_local(latent, pts)
        pts = torch.as_tensor(pts, dtype=torch.float32, device=self.device).reshape(-1, 3)
        vals = err = None
        try:
            vals = self._eval_local(latent, pts[self.group.row_slice(pts.shape[0])])
        except Exception as e:  # raised below, on every rank
            err = e
        if self.group.any_true(err is not None):
            raise err or RuntimeError("eval_points: another rank of the group failed")
        return self.group.all_gather_rows(vals)

    @torch.no_grad()
    def _eval_local(self, latent, pts) -> torch.Tensor:
        """``eval_points`` on this process alone, with no group's slice and
        gather (``msd_tpu``'s ``_eval_t``): the block, slab, dedup and
        refinement programs call it, so under a group they run on the
        calling rank, as ``msd_tpu``'s run on one device."""
        pts = torch.as_tensor(pts, dtype=torch.float32, device=self.device).reshape(-1, 3)
        latent = torch.as_tensor(latent, dtype=torch.float32, device=self.device).reshape(-1)
        kernel = self.spec is not None and self.device.type == "cuda"
        chunk = KERNEL_CHUNK if kernel else self.max_batch
        outs = []
        for start in range(0, pts.shape[0], chunk):
            part = pts[start : start + chunk]
            n = part.shape[0]
            if not kernel and n % CPU_ROW_ALIGN:
                part = torch.cat([part, part.new_zeros(-n % CPU_ROW_ALIGN, 3)])
            if self.spec is not None:
                outs.append(fused_eval(self.spec, latent, part)[:n])
            else:
                outs.append(decode_sdf(self.decoder, latent, part)[:n, 0])
        self.n_evaluated += pts.shape[0]
        return torch.cat(outs) if outs else pts.new_zeros(0)

    def _block_points(self, abi: torch.Tensor, h: float, scale: int = 1, b: int = SPARSE_BLOCK) -> torch.Tensor:
        """[A * (b+1)^3, 3] coordinates of the stride-``scale`` lattices of
        blocks ``abi`` [A, 3], made on the device."""
        fine = (abi.to(torch.int32) * (b * scale))[:, None, :] + _grid(b + 1, abi.device)[None] * scale
        return _lattice_points(fine, h)

    def _blocks_f16(self, latent, abi: torch.Tensor, h: float, scale: int = 1) -> torch.Tensor:
        """[A, 125] values of blocks ``abi`` rounded to float16, as
        ``msd_tpu``'s block programs return them."""
        vals = self._eval_local(latent, self._block_points(abi, h, scale))
        return vals.reshape(abi.shape[0], (SPARSE_BLOCK + 1) ** 3).half()

    def _abi_tensor(self, abi) -> torch.Tensor:
        return torch.as_tensor(np.asarray(abi), dtype=torch.int32, device=self.device).reshape(-1, 3)

    def eval_blocks(self, latent, abi: np.ndarray, b: int, N: int, scale: int = 1) -> np.ndarray:
        """SDF at every stride-``scale`` lattice point of the given blocks
        (block indices ``abi`` [A, 3]), rounded to float16 as ``msd_tpu``'s
        ``eval_blocks`` rounds them (msd_tpu/mesh.py:1768). Returns
        [A, b+1, b+1, b+1] float32."""
        vals = self._eval_local(latent, self._block_points(self._abi_tensor(abi), 2.0 / (N - 1), scale, b))
        return vals.half().float().reshape(-1, b + 1, b + 1, b + 1).cpu().numpy()

    def crossing_blocks(self, latent, abi: np.ndarray, N: int) -> np.ndarray:
        """Subset of ``abi`` whose blocks contain a sign change
        (msd_tpu/mesh.py:1306): only those emit geometry."""
        if abi.shape[0] == 0:
            return abi[:0]
        mask = _crossing(self._blocks_f16(latent, self._abi_tensor(abi), 2.0 / (N - 1)))
        return abi[mask.cpu().numpy()]

    def subblock_active(self, latent, abi: np.ndarray, N: int, scale: int, diag: float) -> np.ndarray:
        """[A, b, b, b] bool: active flags of the stride-``scale``/b
        sub-blocks of each superblock (msd_tpu/mesh.py:1722), computed on the
        device; the flags cross to the host bit-packed, 8 bytes a block."""
        b = SPARSE_BLOCK
        A = abi.shape[0]
        if A == 0:
            return np.zeros((0, b, b, b), bool)
        v = self._blocks_f16(latent, self._abi_tensor(abi), 2.0 / (N - 1), scale).float()
        act = _corner_active(v.reshape(A, b + 1, b + 1, b + 1), diag)
        packed = _pack_bits(act.reshape(A, b**3)).cpu().numpy()
        flags = np.unpackbits(packed, axis=1, bitorder="little")[:, : b**3]
        return flags.astype(bool).reshape(A, b, b, b)

    # ------------------------------------------------------------------
    # Streaming: refinement, slab encode and the crossing-value stream.

    @staticmethod
    def _codec_q(codec: str, h: float) -> np.float32:
        """Value quantum per codec (msd_tpu/mesh.py:330)."""
        if codec == "packed":
            return np.float32(2.5 * h / 255.0)
        return np.float32(3.0 * h / 127.0)

    def _slab_cap(self, n_pad: int) -> int:
        """Compaction cap for a slab of ``n_pad`` blocks (msd_tpu/mesh.py:338)."""
        if n_pad < self.compact_cap_min_blocks:
            return n_pad
        return -(-int(n_pad * self.compact_cap_ratio) // 2048) * 2048

    def _encode_compact_body(self, vals: torch.Tensor, valid_n, cap: int, codec: str, q, use_u16: bool,
                             extra: Optional[torch.Tensor] = None):
        """Crossing filter, on-device compaction and value codec of one slab
        (msd_tpu/mesh.py:488-622). ``vals`` [n, 125] float16; rows at and
        past ``valid_n`` are padding. Returns
        (header, *value buffers):

        * header: u16 ``[count, Km_lo, Km_hi, extra, idx...]`` while
          ``use_u16``, else int32 ``[count(, Km), idx...]``; ``count`` is
          the crossing count (above ``cap``: overflow), ``Km`` the
          magnitude count ("packed"), ``extra`` a device scalar or 0 (the
          dedup slab's orphan overflow flag), ``idx`` the crossing rows'
          slab positions.
        * "packed": sign bitmaps [cap, 16] u8 and the magnitudes
          [cap * packed_mag_bytes_per_block] u8 of every needed corner (a
          corner whose 3^3 window holds both signs), row-major;
          "int8": [cap, 125] int8 codes round(v / q) clipped to +-127 with
          the sign kept; "f16": [cap, 250] int8, the float16 bytes."""
        n_blocks, pts_per = vals.shape
        dev = vals.device
        rows = torch.arange(n_blocks, device=dev)
        count, dest = _compact_dest(_crossing(vals) & (rows < valid_n), cap)
        idx = _scatter_rows(rows.to(torch.int32), dest, cap)
        slot3 = torch.zeros_like(count) if extra is None else extra.to(count.dtype)
        # a device operand, so the card divides (a host scalar may become a
        # product with its reciprocal)
        q_t = _scalar(q, dev)
        rowsf = vals.float()
        if codec == "packed":
            sign_neg = rowsf < 0
            # nonzero values never round to 0, so decoded signs match the f16 signs
            magc = torch.where(rowsf == 0, 0.0, torch.clamp(torch.round(rowsf.abs() / q_t), 1, 255)).to(torch.uint8)
            bitmaps = _scatter_rows(_pack_bits(sign_neg), dest, cap)
            mag_rows = _scatter_rows(magc, dest, cap)
            need_rows = _scatter_rows(_window_needed(sign_neg), dest, cap)
            capM = cap * self.packed_mag_bytes_per_block
            small = need_rows & (torch.arange(cap, device=dev) < count)[:, None]
            within = torch.cumsum(small.to(torch.int32), 1, dtype=torch.int64)
            row_counts = within[:, -1] if cap else within.new_zeros(0)
            row_off = torch.cumsum(row_counts, 0) - row_counts
            mag_count = row_counts.sum()
            mdest = torch.where(small, row_off[:, None] + within - 1, capM).clamp_(max=capM).reshape(-1)
            mags = _scatter_rows(mag_rows.reshape(-1), mdest, capM)
            if use_u16:
                head = torch.stack([count, mag_count & 0xFFFF, mag_count >> 16, slot3])
                header = torch.cat([head.to(torch.int32), idx]).to(torch.uint16)
            else:
                header = torch.cat([torch.stack([count, mag_count]).to(torch.int32), idx])
            return header, bitmaps, mags
        if codec == "int8":
            mag = torch.clamp(torch.round(rowsf.abs() / q_t), 1, 127)
            code = torch.where(rowsf == 0, 0.0, torch.sign(rowsf) * mag).to(torch.int8)
        elif codec == "f16":
            code = vals.contiguous().view(torch.int8)
        else:
            raise ValueError(f"unknown value codec {codec!r}")
        if use_u16:
            header = torch.cat([torch.stack([count, torch.zeros_like(count), torch.zeros_like(count), slot3])
                                .to(torch.int32), idx])
            header = header.to(torch.uint16)
        else:
            header = torch.cat([count.reshape(1).to(torch.int32), idx])
        return header, _scatter_rows(code, dest, cap)

    def _slab(self, latent, abi_slab: torch.Tensor, valid_n, h: float, q, cap: int, codec: str):
        """One slab: the 5^3 lattices of ``abi_slab`` through K1, rounded to
        float16, filtered, compacted and encoded (``_encode_compact_body``)."""
        vals = self._blocks_f16(latent, abi_slab, h)
        return self._encode_compact_body(vals, valid_n, cap, codec, q, use_u16=abi_slab.shape[0] <= 60000)

    # ------------------------------------------------------------------
    # Corner dedup (msd_tpu/mesh.py:643-803): a slab evaluates each block's
    # 64 low corners, and of the 61 on its +x/+y/+z faces only those whose
    # owner (the neighbour block holding them as low corners) is not in the
    # slab.

    # owner map edge: block coordinates in [0, MAP_N) per axis, so every N
    # up to 513 (msd_tpu/mesh.py:643)
    MAP_N = 128

    def _dedup_consts(self):
        """``_dedup_tables`` on the evaluator's device, made once."""
        if self._dedup_consts_obj is None:
            def dev(a):
                return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

            self._dedup_consts_obj = {k: [dev(a) for a in v] if isinstance(v, list) else dev(v)
                                      for k, v in _dedup_tables().items()}
        return self._dedup_consts_obj

    def _block_map(self, abi_dev: torch.Tensor, count: int) -> torch.Tensor:
        """Dense owner-row map (msd_tpu/mesh.py:648): [MAP_N^3 + 1] int32,
        entry x*MAP_N^2 + y*MAP_N + z the row of block (x, y, z) in the
        active set ``abi_dev``, -1 elsewhere; the last entry, -1, answers
        every lookup outside the map. Rows at and past ``count`` and
        coordinates outside the map are dropped."""
        M = self.MAP_N
        rows = torch.arange(abi_dev.shape[0], device=abi_dev.device)
        keep = (rows < count) & ((abi_dev >= 0) & (abi_dev < M)).all(1)
        lin = torch.where(keep, self._map_index(abi_dev), M**3)
        m = torch.full((M**3 + 1,), -1, dtype=torch.int32, device=abi_dev.device)
        m[lin] = rows.to(torch.int32)  # every dropped row writes the last entry
        m[M**3] = -1
        return m

    def _map_index(self, blocks: torch.Tensor) -> torch.Tensor:
        M = self.MAP_N
        b = blocks.to(torch.int64)
        return (b[:, 0] * M + b[:, 1]) * M + b[:, 2]

    @staticmethod
    def _dedup_shift_caps(n_pad: int, rho: float) -> int:
        """Orphan rows per neighbour shift (msd_tpu/mesh.py:666):
        ceil(rho * n_pad) rounded up to 1024."""
        return -(-int(n_pad * rho) // 1024) * 1024

    def _dedup_plan(self, abi_slab: torch.Tensor, map_dev: torch.Tensor, start: int, valid_n: int, capS: int):
        """Per neighbour shift: each row's owner row within the slab
        (``n_pad``, the zero row, where the owner is absent), the compacted
        orphan rows (valid rows whose owner is absent, in row order, the
        first ``capS``; unused slots hold 0) and the orphan count, which
        may exceed ``capS``. Owners outside the slab's valid rows count as
        absent. Returns (locals [7][n_pad], orphans [7][capS], counts [7])."""
        M = self.MAP_N
        n_pad = abi_slab.shape[0]
        rows = torch.arange(n_pad, device=abi_slab.device)
        valid = rows < valid_n
        locals_, orphans, counts = [], [], []
        for sh in self._dedup_consts()["shifts"]:
            owner = abi_slab + sh[None, :]
            inb = ((owner >= 0) & (owner < M)).all(1)
            orow = map_dev[torch.where(inb, self._map_index(owner), M**3)]
            in_slab = (orow >= start) & (orow < start + valid_n)
            locals_.append(torch.where(in_slab, orow.to(torch.int64) - start, n_pad))
            count, dest = _compact_dest(~in_slab & valid, capS)
            orphans.append(_scatter_rows(rows, dest, capS))
            counts.append(count)
        return locals_, orphans, torch.stack(counts)

    def _dedup_values(self, latent, abi_dev: torch.Tensor, map_dev: torch.Tensor, start: int, valid_n: int,
                      h: float, rho_m: int):
        """The corner-deduplicated values of rows [start, start + n_pad) of
        the device active set (msd_tpu/mesh.py:673-803), n_pad the valid
        rows rounded up to ``A_CHUNK``. One batch through K1: the 64 low
        corners of every block, then each shift's orphan corner groups
        (``capS`` rows of 16, 4 or 1 corners). The [n_pad, 125] rows are
        put back together from the low corners, 7 row gathers from the
        owners' low corners and 7 orphan scatters (real orphan slots only).
        A corner's lattice indices equal the plain slab's (owner * 4 + low
        offset == base * 4 + top offset) and become points through the same
        expression (``_lattice_points``), so each valid row is the plain
        slab's bit for bit. Returns (values float16 [n_pad, 125], flag int32
        scalar: 1 where a shift's orphans overflowed ``capS``, and the rows
        missing them must be evaluated again)."""
        n_pad = self.A_CHUNK * -(-valid_n // self.A_CHUNK)
        b = SPARSE_BLOCK
        t = self._dedup_consts()
        capS = self._dedup_shift_caps(n_pad, rho_m / 1000.0)
        abi_slab = abi_dev[start:start + n_pad].to(torch.int32)
        locals_, orphans, counts = self._dedup_plan(abi_slab, map_dev, start, valid_n, capS)
        parts = [(abi_slab * b)[:, None, :] + t["low_offs"][None]]
        for sh, orows, offs in zip(t["shifts"], orphans, t["own_offs"]):
            parts.append(((abi_slab[orows] + sh[None, :]) * b)[:, None, :] + offs[None])
        vals_flat = self._eval_local(latent, _lattice_points(torch.cat([p.reshape(-1, 3) for p in parts]), h))
        low_n = n_pad * b**3
        low = vals_flat[:low_n].reshape(n_pad, b**3)
        low_ext = torch.cat([low, low.new_zeros(1, b**3)])
        # row n_pad takes the unused orphan slots' writes
        vals125 = vals_flat.new_zeros(n_pad + 1, (b + 1) ** 3)
        vals125[:n_pad, t["lowpos125"]] = low
        slot = torch.arange(capS, device=vals_flat.device)
        off = low_n
        for si, (loc, orows, pos) in enumerate(zip(locals_, orphans, t["pos125"])):
            sz = pos.shape[0]
            vals125[:n_pad, pos] = low_ext[loc[:, None], t["own_pos"][si][None, :]]
            dest = torch.where(slot < counts[si], orows, n_pad)
            vals125[dest[:, None], pos[None, :]] = vals_flat[off:off + capS * sz].reshape(capS, sz)
            off += capS * sz
        return vals125[:n_pad].half(), (counts > capS).any().to(torch.int32)

    def _slab_dedup(self, latent, abi_dev: torch.Tensor, map_dev: torch.Tensor, start: int, valid_n: int,
                    h: float, q, cap: int, codec: str, rho_m: int):
        """One dedup slab: ``_dedup_values``, then ``_encode_compact_body``
        with a u16 header whose slot 3 holds the orphan overflow flag."""
        vals, flag = self._dedup_values(latent, abi_dev, map_dev, start, valid_n, h, rho_m)
        return self._encode_compact_body(vals, valid_n, cap, codec, q, use_u16=True, extra=flag)

    def _fetch_async(self, t: torch.Tensor):
        """Start copying ``t`` to the host; returns a resolver giving the numpy
        array. On the card: pinned memory on a side stream, after the work
        enqueued so far, then an event; the resolver waits on the event. On
        the CPU the copy is the array itself."""
        if t.device.type != "cuda":
            arr = t.numpy()
            return lambda: arr
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(t.device)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(t.device))
        t.record_stream(self._copy_stream)  # not reused before the copy ends
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        done = torch.cuda.Event()
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(ready)
            host.copy_(t, non_blocking=True)
            done.record(self._copy_stream)

        def resolve(_t=t):  # the closure keeps t alive until the copy is read
            done.synchronize()
            return host.numpy()

        return resolve

    def _decode_pool(self) -> ThreadPoolExecutor:
        """Host threads for decoding value rows (msd_tpu/mesh.py:284)."""
        if self._decode_pool_obj is None:
            self._decode_pool_obj = ThreadPoolExecutor(max_workers=2)
        return self._decode_pool_obj

    def warm_stream(self, N: int, codec: str = "auto") -> None:
        """The stream's device operations once, on zeros and without K1:
        the refinement's criterion and compaction, one slab's encode and
        its copy to pinned memory. On the card the first launch of each
        PyTorch operation loads its CUDA module; in the first streamed mesh
        of a process that cost about 0.3 s on the H100 (PERF.md, PR 15).
        The reconstruct CLI calls this before its first shape."""
        codec = _resolve_value_codec(codec)
        h = 2.0 / (N - 1)
        nb4 = (N - 1) // SPARSE_BLOCK
        v = torch.zeros((nb4 + 1,) * 3, device=self.device)
        count, dest = _compact_dest(_corner_active(v, h).reshape(-1), self.A_CHUNK)
        _scatter_rows(_grid(nb4, self.device), dest, self.A_CHUNK)
        pts = self._block_points(torch.zeros((self.A_CHUNK, 3), dtype=torch.int32, device=self.device), h)
        vals = pts[:, 0].reshape(self.A_CHUNK, -1).half()
        out = self._encode_compact_body(vals, self.A_CHUNK, self.A_CHUNK, codec, self._codec_q(codec, h), True)
        for t in (count.reshape(1), *out):
            self._fetch_async(t)()

    def _refine1(self, latent, nb4: int, cap4: int, h: float, diag4: float):
        """Single-level refinement on the device (msd_tpu/mesh.py:1463): the
        full stride-4 corner lattice through K1, the active blocks compacted
        into [cap4, 3] int32 in row order. Returns (count [1] int64, abi4)."""
        n1 = nb4 + 1
        lat = _grid(n1, self.device).float() * float(SPARSE_BLOCK) * h - 1.0
        v = self._eval_local(latent, lat).reshape(n1, n1, n1)
        count, dest = _compact_dest(_corner_active(v, diag4).reshape(-1), cap4)
        return count.reshape(1), _scatter_rows(_grid(nb4, self.device), dest, cap4)

    def _refine2(self, latent, nb16: int, cap16: int, cap4: int, h: float, diag16: float, diag4: float):
        """Two-level refinement on the device (msd_tpu/mesh.py:1367): the
        stride-16 lattice, its active superblocks compacted into [cap16, 3],
        their stride-4 sub-lattices (every slot evaluated, padding masked by
        the count) rounded to float16, the active stride-4 blocks compacted
        into [cap4, 3]. Returns ([count16, count4] int64, abi4)."""
        b = SPARSE_BLOCK
        n1 = nb16 + 1
        lat = _grid(n1, self.device).float() * (4.0 * b) * h - 1.0
        v16 = self._eval_local(latent, lat).reshape(n1, n1, n1)
        count16, dest16 = _compact_dest(_corner_active(v16, diag16).reshape(-1), cap16)
        abi16 = _scatter_rows(_grid(nb16, self.device), dest16, cap16)
        v4 = self._blocks_f16(latent, abi16, h, scale=b).float().reshape(cap16, b + 1, b + 1, b + 1)
        act4 = _corner_active(v4, diag4).reshape(cap16, b**3)
        act4 = act4 & (torch.arange(cap16, device=self.device) < count16)[:, None]
        abi4_all = (abi16 * 4)[:, None, :] + _grid(b, self.device)[None]
        count4, dest4 = _compact_dest(act4.reshape(-1), cap4)
        return torch.stack([count16, count4]), _scatter_rows(abi4_all.reshape(-1, 3), dest4, cap4)

    def refine_active4_device(self, latent, N: int, safety: float, clamp_dist: float,
                              cap16: int = 8192, cap4: int = 131072, async_fetch: bool = False):
        """Device refinement (msd_tpu/mesh.py:1658). Returns (abi4 [A, 3]
        int64 host array, evaluated), row for row ``_sparse_active4``'s
        output, or None where the refinement class does not apply or a cap
        overflows. One small count copy syncs the host.

        With ``async_fetch``: (abi4_resolver, count4, evaluated, abi4_dev),
        the host copy of the active set still in flight."""
        cls = _refine_class(N, safety, clamp_dist)
        if cls is None:
            return None
        b = SPARSE_BLOCK
        h, nb4, two_level = cls
        s3 = math.sqrt(3.0) / 2.0
        if two_level:
            nb16 = nb4 // 4
            counts, abi4_dev = self._refine2(latent, nb16, cap16, cap4, h, (4 * b) * h * s3 * safety,
                                             b * h * s3 * safety)
            count16, count4 = counts.tolist()
            if count16 > cap16 or count4 > cap4:
                logging.debug("device refine overflow (%d/%d, %d/%d)", count16, cap16, count4, cap4)
                return None
            evaluated = (nb16 + 1) ** 3 + count16 * (b + 1) ** 3
        else:
            cap4 = min(nb4**3, cap4 // 2)
            counts, abi4_dev = self._refine1(latent, nb4, cap4, h, b * h * s3 * safety)
            count4 = int(counts[0])
            if count4 > cap4:
                logging.debug("device refine1 overflow (%d/%d)", count4, cap4)
                return None
            evaluated = (nb4 + 1) ** 3
        resolver = self._fetch_async(abi4_dev[:count4])
        if async_fetch:
            return (lambda: resolver().astype(np.int64)), count4, evaluated, abi4_dev
        return resolver().astype(np.int64), evaluated

    def stream_crossing_values(self, latent, abi, N: int, codec: str = "int8", stats: Optional[dict] = None,
                               abi_dev=None, abi_resolver=None, num_blocks: Optional[int] = None,
                               two_level: bool = False):
        """Slab-pipelined evaluation of the active set
        (msd_tpu/mesh.py:878-1304, without its hybrid and optimistic
        branches).

        Every slab is enqueued before any header is read: its blocks
        through K1, the crossing rows compacted and encoded on the device
        (``_slab``, or ``_slab_dedup`` where the corner dedup is on; see
        ``_dedup_on``). Headers, then value rows, are copied to pinned host
        memory on a side stream and decoded on host threads. With
        ``abi_dev`` (and ``num_blocks``) the slab coordinates are sliced
        from the device active set and its host copy (``abi_resolver``) is
        read only for the mesher's bases. A dedup slab whose orphans
        overflowed runs again at once through ``_slab``, before any later
        header is read (``dedup_retries``); a slab whose crossing or
        magnitude count exceeds its cap re-runs exactly (``exact_slabs``).
        ``two_level``: the active set is the two-level refinement's.

        Yields decoded (values float32 [n, 125], abi rows [n, 3]); returns
        (max_blocks upper bound, iterator). ``stats`` gathers
        ``crossing_blocks``, ``t_mask`` (seconds waiting for headers),
        ``t_fetch`` (for value rows), ``bytes_fetched``,
        ``evaluated_stream``, ``exact_slabs``, ``dedup``, ``dedup_slabs``
        and ``dedup_retries``."""
        A = abi.shape[0] if abi is not None else int(num_blocks)
        latent = torch.as_tensor(latent, dtype=torch.float32, device=self.device).reshape(-1)
        h = 2.0 / (N - 1)
        q = self._codec_q(codec, h)
        C = self.A_CHUNK
        n_chunks = -(-A // C) if A else 0
        if n_chunks == 0:
            return 0, iter(())
        n_slabs = min(stream_knobs.stream_slab_count(), n_chunks)
        if n_slabs > 1 and A > 3 * C:
            # ramped: a small first slab starts the host work sooner
            bounds = np.concatenate([[0], np.linspace(C, A, n_slabs).astype(int)])
        else:
            bounds = np.linspace(0, A, n_slabs + 1).astype(int)
        slabs = [(int(bounds[s]), int(bounds[s + 1])) for s in range(len(bounds) - 1) if bounds[s] < bounds[s + 1]]
        pts_per = (SPARSE_BLOCK + 1) ** 3
        stats = {} if stats is None else stats
        abi_box = {"abi": abi}

        def add(key, value):
            stats[key] = stats.get(key, 0) + value

        def get_abi():
            if abi_box["abi"] is None:
                abi_box["abi"] = abi_resolver()
            return abi_box["abi"]

        def exact_slab(lo, hi):
            """An overflowing slab again, exactly: its values, a host mask
            and the crossing rows (f16 rows for "packed")."""
            abi_h = get_abi()[lo:hi]
            n_pad = -(-(hi - lo) // C) * C
            buf = np.zeros((n_pad, 3), np.int32)
            buf[:hi - lo] = abi_h
            vals = self._blocks_f16(latent, torch.from_numpy(buf).to(self.device), h)
            mask = _crossing(vals).cpu().numpy()[:hi - lo]
            rows = vals[torch.from_numpy(np.nonzero(mask)[0]).to(self.device)].float()
            if codec == "int8":
                code = torch.where(rows == 0, 0.0,
                                   torch.sign(rows) * torch.clamp(torch.round(rows.abs() / _scalar(q, self.device)), 1, 127))
                return code.to(torch.int8).cpu().numpy().astype(np.float32) * q, abi_h[mask]
            return rows.cpu().numpy(), abi_h[mask]

        rho_m = stream_knobs.orphan_shift_cap_milli()
        dedup = self._dedup_on(abi_dev, N, A, two_level)
        stats.update(dedup=dedup, dedup_slabs=0, dedup_retries=0)
        # the owner map, once per call
        map_dev = self._block_map(abi_dev, A) if dedup else None

        def dispatch_slab(lo, hi, use_dedup):
            n = hi - lo
            n_pad = -(-n // C) * C
            cap = self._slab_cap(n_pad)
            dev_ok = abi_dev is not None and lo + n_pad <= abi_dev.shape[0]
            if dev_ok and use_dedup and n_pad <= 60000:
                out = self._slab_dedup(latent, abi_dev, map_dev, lo, n, h, q, cap, codec, rho_m)
                # 64 low corners, and 3 x 16 + 3 x 4 + 1 = 61 per orphan slot
                add("evaluated_stream", n_pad * SPARSE_BLOCK**3 + self._dedup_shift_caps(n_pad, rho_m / 1000.0) * 61)
                add("dedup_slabs", 1)
            else:
                if dev_ok:
                    abi_slab = abi_dev[lo:lo + n_pad]
                else:
                    buf = torch.zeros((n_pad, 3), dtype=torch.int32, pin_memory=self.device.type == "cuda")
                    buf[:n] = torch.from_numpy(get_abi()[lo:hi])
                    abi_slab = buf.to(self.device, non_blocking=True)
                out = self._slab(latent, abi_slab, n, h, q, cap, codec)
                add("evaluated_stream", n_pad * pts_per)
            return cap, self._fetch_async(out[0]), out[1:]

        def parse_header(icn):
            """-> (K, Km, flag, idx0); the flag is header slot 3 of a u16
            header (a dedup slab's orphan overflow)."""
            K = int(icn[0])
            if icn.dtype == np.uint16:
                Km = int(icn[1]) | (int(icn[2]) << 16) if codec == "packed" else 0
                return K, Km, int(icn[3]), 4
            Km = int(icn[1]) if codec == "packed" else 0
            return K, Km, 0, 2 if codec == "packed" else 1

        def read_header(header_res):
            t0 = time.time()
            icn = header_res()
            add("t_mask", time.time() - t0)
            return icn

        def it():
            stats.setdefault("exact_slabs", 0)
            pend = [(lo, hi, *dispatch_slab(lo, hi, dedup)) for lo, hi in slabs]
            # first pass (msd_tpu/mesh.py:1232-1250): read each header and
            # run every orphan-flagged slab again at once without dedup, so
            # the retries queue on the card behind each other
            resolved = []
            for lo, hi, cap, header_res, devs in pend:
                icn = read_header(header_res)
                if parse_header(icn)[2]:
                    logging.debug("dedup orphan overflow in slab [%d, %d); plain slab again", lo, hi)
                    add("dedup_retries", 1)
                    cap, header_res, devs = dispatch_slab(lo, hi, False)
                    icn = None
                resolved.append((lo, hi, cap, icn, header_res, devs))
            # then every value copy starts before any rows are consumed
            jobs = []
            for lo, hi, cap, icn, header_res, devs in resolved:
                if icn is None:
                    icn = read_header(header_res)
                K, Km, _, idx0 = parse_header(icn)
                overflow = K > cap or (codec == "packed" and Km > cap * self.packed_mag_bytes_per_block)
                if overflow:
                    logging.debug("slab compaction overflow (K=%d cap=%d); exact fallback", K, cap)
                    add("exact_slabs", 1)
                    add("evaluated_stream", -(-(hi - lo) // C) * C * pts_per)
                    rows, abi_x = exact_slab(lo, hi)
                    jobs.append((rows.shape[0], (lambda r=rows: r), abi_x))
                    continue
                sel = icn[idx0:idx0 + K].astype(np.int64)
                if codec == "packed":
                    bitmaps_res, mags_res = self._fetch_async(devs[0][:K]), self._fetch_async(devs[1][:Km])
                    add("bytes_fetched", K * 16 + Km)

                    def decode(_b=bitmaps_res, _m=mags_res, _K=K):
                        return _decode_packed_host(_b(), _m(), _K, q)
                else:
                    rows_res = self._fetch_async(devs[0][:K])
                    add("bytes_fetched", K * pts_per * (1 if codec == "int8" else 2))
                    if codec == "int8":
                        def decode(_r=rows_res):
                            return _r().astype(np.float32) * q
                    else:
                        def decode(_r=rows_res):
                            return _r().view(np.float16).astype(np.float32)
                jobs.append((K, self._decode_pool().submit(decode).result, get_abi()[lo:hi][sel]))
            for K, resolve, abi_x in jobs:
                add("crossing_blocks", int(K))
                if not K:
                    continue
                t0 = time.time()
                vals = resolve()
                add("t_fetch", time.time() - t0)
                yield vals, abi_x

        return A, it()

    def _dedup_on(self, abi_dev, N: int, A: int, two_level: bool) -> bool:
        """Whether a stream dedups its slabs (msd_tpu/mesh.py:1040-1060):
        the active set lies on the device, its block coordinates fit the
        owner map, and ``stream_knobs.dedup_streaming`` says so. Under
        "auto" also only for the two-level refinement class: ``msd_tpu``
        dedups only where ``counts_dev is None or hybrid``
        (msd_tpu/mesh.py:1053-1056), and by default it refines the
        single-level class (N=257) on its optimistic route, which sets
        ``counts_dev``, because single-level shells overflow the orphan caps
        (:1046-1052). The port has no optimistic route, so the condition is
        the refinement class. "on" dedups either class, as ``msd_tpu`` does
        with ``MSD_STREAM_OPT=off``."""
        return (abi_dev is not None
                and (two_level or stream_knobs.dedup_forced())
                and (N - 1) // SPARSE_BLOCK <= self.MAP_N
                and stream_knobs.dedup_streaming(stream_knobs.host_facts(), A))


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


def _active_from_lattice(lattice: np.ndarray, diag: float) -> np.ndarray:
    """Blocks of a corner lattice that may contain the zero level (min
    |corner| below ``diag`` or a corner sign change; msd_tpu/mesh.py:2186)."""
    nb = lattice.shape[0] - 1
    cmin = np.full((nb, nb, nb), np.inf)
    sign_any = np.zeros((nb, nb, nb), dtype=bool)
    sign_all = np.ones((nb, nb, nb), dtype=bool)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                sub = lattice[dx : nb + dx, dy : nb + dy, dz : nb + dz]
                cmin = np.minimum(cmin, np.abs(sub))
                neg = sub < 0
                sign_any |= neg
                sign_all &= neg
    return (cmin < diag) | (sign_any & ~sign_all)


def _host_lattice(N, safety, clamp_dist):
    """(corner lattice points, two_level): the one ``eval_points`` call of
    ``_sparse_active4``, stride 16 where two levels apply, else stride 4.
    Under a group every rank joins that call (``_follow_stream``)."""
    b = SPARSE_BLOCK
    h = 2.0 / (N - 1)
    nb4 = (N - 1) // b
    two_level = (N - 1) % (4 * b) == 0 and (4 * b) * h * math.sqrt(3.0) / 2.0 * safety < clamp_dist and nb4 % 4 == 0
    return corner_lattice(N, 4 * b if two_level else b), two_level


def _sparse_active4(latent, N, evaluator: PointEvaluator, safety, clamp_dist):
    """Active stride-4 block indices by hierarchical refinement on the host
    (msd_tpu/mesh.py:2204): a stride-16 prefilter where the resolution
    allows it, with the sub-block criterion on the device
    (``subblock_active``, on the calling rank alone under a group). Returns
    (abi4 [A, 3] int64, evaluated)."""
    b = SPARSE_BLOCK
    h = 2.0 / (N - 1)
    s3 = math.sqrt(3.0) / 2.0
    nb4 = (N - 1) // b
    pts, two_level = _host_lattice(N, safety, clamp_dist)
    if two_level:
        nb16 = nb4 // 4
        lat16 = evaluator.eval_points(latent, pts).cpu().numpy().reshape(nb16 + 1, nb16 + 1, nb16 + 1)
        evaluated = pts.shape[0]
        abi16 = np.stack(np.nonzero(_active_from_lattice(lat16, (4 * b) * h * s3 * safety)), axis=1).astype(np.int32)
        if abi16.shape[0] == 0:
            return np.zeros((0, 3), np.int64), evaluated
        sub_active = evaluator.subblock_active(latent, abi16, N, scale=b, diag=b * h * s3 * safety)
        evaluated += abi16.shape[0] * (b + 1) ** 3
        aa, ai, aj, ak = np.nonzero(sub_active)
        return abi16[aa].astype(np.int64) * 4 + np.stack([ai, aj, ak], axis=1), evaluated
    lattice = evaluator.eval_points(latent, pts).cpu().numpy().reshape(nb4 + 1, nb4 + 1, nb4 + 1)
    active = _active_from_lattice(lattice, b * h * s3 * safety)
    return np.stack(np.nonzero(active), axis=1).astype(np.int64), pts.shape[0]


def _sparse_blocks(latent, N, b, safety, evaluator: PointEvaluator, f16: bool = False):
    """Two-stage sparse evaluation (msd_tpu/mesh.py:2250). The corner
    lattice is float32; the block values are float32 too (the route
    ``msd_tpu`` runs without an evaluator, msd_tpu/mesh.py:2286-2292), or,
    with ``f16``, rounded to float16 by ``eval_blocks`` (its route with an
    evaluator, :2284-2285). Returns (corner_sdf [(nb+1)^3 lattice], abi
    [A, 3] active block indices, block_vals [A, b+1, b+1, b+1], stats)."""
    nb = (N - 1) // b
    h = 2.0 / (N - 1)
    diag = b * h * math.sqrt(3.0) / 2.0 * safety
    n_corner = (nb + 1) ** 3

    # stage 1: corner lattice [(nb+1)^3]
    corner_sdf = evaluator.eval_points(latent, corner_lattice(N, b)).cpu().numpy().reshape(nb + 1, nb + 1, nb + 1)

    # stage 2: active blocks (Lipschitz bound or corner sign change)
    abi = np.stack(np.nonzero(_active_from_lattice(corner_sdf, diag)), axis=1)  # [A, 3]

    # stage 3: evaluate active block interiors
    if abi.shape[0] == 0:
        block_vals = np.zeros((0, b + 1, b + 1, b + 1), np.float32)
    elif f16:
        block_vals = evaluator.eval_blocks(latent, abi, b, N)
    else:
        pts = evaluator._block_points(evaluator._abi_tensor(abi), h, b=b)
        block_vals = evaluator.eval_points(latent, pts).reshape(-1, b + 1, b + 1, b + 1).cpu().numpy()
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

    As in ``msd_tpu``, the block values are rounded to float16 when the
    caller passes an ``evaluator`` and stay float32 otherwise. Inactive
    blocks are filled with their corner value (sign-correct by the
    Lipschitz argument), which cannot introduce spurious zero crossings."""
    f16 = evaluator is not None
    evaluator = evaluator or PointEvaluator(decoder, max_batch=max_batch)
    b = _pick_block(N, clamp_dist, safety)
    if b <= 2:
        grid = eval_grid_dense(decoder, latent, N, max_batch, evaluator)
        return grid, {"block": 1, "evaluated": N**3, "total": N**3}
    corner_sdf, abi, block_vals, stats = _sparse_blocks(latent, N, b, safety, evaluator, f16=f16)
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


# stats of the most recent streaming create_mesh (msd_tpu/mesh.py:1804)
LAST_STREAMING_STATS: dict = {}


def _spill_tmp_base(ply_path: str) -> str:
    """Base path of the PLY spill temps, unique per process: in
    ``MSD_SPILL_TMP`` when set, else in the temporary directory
    (``tempfile.gettempdir()``, which honours ``TMPDIR``). msd_tpu/mesh.py:1813
    uses ``/dev/shm``; the port writes nothing outside its caller's
    temporary directory unless told to."""
    scratch = os.environ.get("MSD_SPILL_TMP") or tempfile.gettempdir()
    return os.path.join(scratch, f"msd_spill_{os.getpid()}_{os.path.basename(ply_path)}")


def _resolve_value_codec(value_codec: str) -> str:
    """The streaming value codec after ``MSD_VALUE_CODEC`` and the
    host-aware "auto" default (``stream_knobs.resolve_value_codec``)."""
    return stream_knobs.resolve_value_codec(value_codec, stream_knobs.host_facts())


def _create_mesh_streaming(latent, N, evaluator, safety, clamp_dist, voxel_size, value_codec="auto",
                           ply_path=None, want_mesh=True):
    """Refuses ``MSD_STREAM_HYBRID=on``, resolves the codec, then
    ``_create_mesh_streaming_impl``. ``msd_tpu``'s retry wrapper
    (msd_tpu/mesh.py:1835) exists only for its hybrid dispatch, which is not
    ported: no failure here gives way to another route."""
    if os.environ.get("MSD_STREAM_HYBRID") == "on":
        raise NotImplementedError("MSD_STREAM_HYBRID=on: msd_tpu's hybrid two-level dispatch is not ported")
    value_codec = _resolve_value_codec(value_codec)
    return _create_mesh_streaming_impl(latent, N, evaluator, safety, clamp_dist, voxel_size,
                                       value_codec=value_codec, ply_path=ply_path, want_mesh=want_mesh)


def _create_mesh_streaming_impl(latent, N, evaluator: PointEvaluator, safety, clamp_dist, voxel_size,
                                value_codec="packed", ply_path=None, want_mesh=True):
    """Device refinement + streamed C++ marching tetrahedra
    (msd_tpu/mesh.py:1866-2095). The active set is evaluated once on the
    device, only crossing rows cross to the host, encoded by
    ``value_codec``, and one worker thread feeds them to the mesher
    (``mt_add_blocks``; ctypes releases the interpreter lock) while the
    card works. With ``ply_path`` the mesher spills the PLY payload as it
    meshes (``mt_ply_stream_*``). Returns (verts, faces, ply_written);
    verts and faces are None when not ``want_mesh``.

    Under a group this runs on the main rank (``create_mesh``): after its
    refinement on its own card it broadcasts the route, device or host, and
    on the host route every rank joins ``_sparse_active4``'s lattice call
    (``_follow_stream``); everything else runs here alone."""
    lib = load_native()
    latent = torch.as_tensor(latent, dtype=torch.float32, device=evaluator.device).reshape(-1)
    LAST_STREAMING_STATS.clear()
    t0 = time.time()
    abi4 = abi4_dev = abi4_resolver = None
    refined = evaluator.refine_active4_device(latent, N, safety, clamp_dist, async_fetch=True)
    refine = "device" if refined is not None else "host"
    if evaluator.group is not None:
        LAST_STREAMING_STATS["broadcast_bytes"] = evaluator.group.broadcast_pickled(("route", refine))[1]
    if refined is not None:
        abi4_resolver, A4, evaluated, abi4_dev = refined
    else:
        abi4, evaluated = _sparse_active4(latent, N, evaluator, safety, clamp_dist)
        A4 = abi4.shape[0]
    t_refine = time.time() - t0
    stream_stats: dict = {}
    cls = _refine_class(N, safety, clamp_dist)
    max_blocks, value_iter = evaluator.stream_crossing_values(
        latent, abi4, N, codec=value_codec, stats=stream_stats,
        abi_dev=abi4_dev, abi_resolver=abi4_resolver, num_blocks=A4,
        two_level=cls is not None and cls[2],
    )
    pts_per = (SPARSE_BLOCK + 1) ** 3
    LAST_STREAMING_STATS.update(
        active_blocks=int(A4),
        evaluated=int(evaluated + A4 * pts_per),
        total=int(N**3),
        t_refine=round(t_refine, 3),
        hybrid=False,
        value_codec=value_codec,
        refine=refine,  # device, or host where a device cap overflowed
    )
    if A4 == 0:
        raise ValueError("Surface level must be within volume data range.")
    flips = np.ascontiguousarray(_FLIP_TABLE.astype(np.uint8))
    # reserve for the active-set bound: the crossing count is known only
    # after the last slab
    handle = lib.mt_create(N, flips.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), max_blocks)
    spill_base = None
    spill_ply = False
    # one try/finally owns the builder and its spill temps
    try:
        if ply_path is not None:
            spill_base = _spill_tmp_base(ply_path)
            rc = lib.mt_ply_stream_begin(handle, (spill_base + ".verts.tmp").encode(),
                                         (spill_base + ".faces.tmp").encode(), voxel_size, -1.0)
            spill_ply = rc == 0
            if not spill_ply:
                logging.warning("PLY spill unavailable; writing the PLY after meshing")

        def mesh_chunk(vals, bases):
            lib.mt_add_blocks(handle, vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                              bases.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), vals.shape[0], SPARSE_BLOCK)

        # one worker: mt_add_blocks calls stay sequential on one builder
        t0 = time.time()
        t_mesher = t_prep = 0.0
        with ThreadPoolExecutor(max_workers=1) as pool:
            fut = None
            for vals, chunk in value_iter:
                tp = time.time()
                vals = np.ascontiguousarray(vals, np.float32)
                bases = np.ascontiguousarray(chunk.astype(np.int32) * SPARSE_BLOCK)
                t_prep += time.time() - tp
                if fut is not None:
                    tm = time.time()
                    fut.result()
                    t_mesher += time.time() - tm
                fut = pool.submit(mesh_chunk, vals, bases)
            if fut is not None:
                tm = time.time()
                fut.result()
                t_mesher += time.time() - tm
        crossing = int(stream_stats.get("crossing_blocks", 0))
        LAST_STREAMING_STATS.update(
            t_mesher=round(t_mesher, 3), t_prep=round(t_prep, 3), t_stream=round(time.time() - t0, 3),
            crossing_blocks=crossing,
            evaluated=int(evaluated + stream_stats.get("evaluated_stream", A4 * pts_per)),
            t_crossing=round(stream_stats.get("t_mask", 0.0), 3),
            t_fetch=round(stream_stats.get("t_fetch", 0.0), 3),
            bytes_fetched=int(stream_stats.get("bytes_fetched", 0)),
            exact_slabs=int(stream_stats.get("exact_slabs", 0)),
            dedup=bool(stream_stats.get("dedup", False)),
            dedup_slabs=int(stream_stats.get("dedup_slabs", 0)),
            dedup_retries=int(stream_stats.get("dedup_retries", 0)),
        )
        logging.debug("[create_mesh] streaming: %d active blocks, %d crossing, %d prefilter evals",
                      A4, crossing, evaluated)
        if crossing == 0:
            raise ValueError("Surface level must be within volume data range.")

        t0 = time.time()
        out_verts = ctypes.POINTER(ctypes.c_float)()
        out_faces = ctypes.POINTER(ctypes.c_int32)()
        nv, nf = ctypes.c_int64(), ctypes.c_int64()
        # zero-copy views of the builder's buffers, valid until mt_destroy
        lib.mt_finish_view(handle, ctypes.byref(out_verts), ctypes.byref(nv), ctypes.byref(out_faces),
                           ctypes.byref(nf))
        LAST_STREAMING_STATS["t_fin_view"] = round(time.time() - t0, 3)
        if nv.value == 0:
            raise ValueError("Surface level must be within volume data range.")
        verts = faces = None
        if want_mesh:
            t1 = time.time()
            verts = np.ctypeslib.as_array(out_verts, shape=(nv.value, 3)) * np.float32(voxel_size) - np.float32(1.0)
            LAST_STREAMING_STATS["t_fin_verts"] = round(time.time() - t1, 3)
            t1 = time.time()
            faces = np.ctypeslib.as_array(out_faces, shape=(nf.value, 3)).copy()
            LAST_STREAMING_STATS["t_fin_faces"] = round(time.time() - t1, 3)
        ply_written = False
        if spill_ply:
            t1 = time.time()
            ply_written = lib.mt_ply_stream_finish(handle, ply_path.encode()) == 0
            LAST_STREAMING_STATS["t_ply"] = round(time.time() - t1, 3)
        LAST_STREAMING_STATS.update(t_finish=round(time.time() - t0, 3), num_verts=int(nv.value),
                                    num_faces=int(nf.value))
        if verts is None:
            return None, None, ply_written
        return verts.astype(np.float32, copy=False), faces, ply_written
    finally:
        lib.mt_destroy(handle)
        if spill_base is not None:
            for tmp in (spill_base + ".verts.tmp", spill_base + ".faces.tmp"):
                try:
                    os.remove(tmp)
                except FileNotFoundError:
                    pass


def _create_mesh_sparse(latent, N: int, b: int, safety: float, evaluator: PointEvaluator):
    """``create_mesh``'s non-streaming sparse route: ``_sparse_blocks`` in
    float32, then the mesher on the active blocks directly, never
    materialising the N^3 grid. Returns (verts, faces); raises
    ``ValueError`` on an empty surface.

    Float32, as a CPU ``msd_tpu`` meshes: it builds no evaluator there
    (msd_tpu/mesh.py:2376-2377), and a CPU evaluator of the port stands in
    its place (``_streams``)."""
    _, abi, block_vals, stats = _sparse_blocks(latent, N, b, safety, evaluator)
    logging.debug("[create_mesh] sparse eval stats: %s", stats)
    h = 2.0 / (N - 1)
    return marching_tetrahedra_blocks(block_vals, abi * b, N, level=0.0, spacing=(h,) * 3, origin=(-1.0, -1.0, -1.0))


def _streams(evaluator: PointEvaluator) -> bool:
    """Whether ``create_mesh`` streams through ``evaluator``: on the card,
    with or without a group. (``msd_tpu`` streams whenever it is handed an
    evaluator; here a CPU evaluator, such as the reconstruct CLI's with
    --device cpu, keeps the float32 sparse route.)"""
    return evaluator.device.type == "cuda"


def _lead_stream(group, run):
    """The main rank's side of a streamed ``create_mesh`` over a group:
    ``run()`` (the whole call, which broadcasts each stream's route), then
    one broadcast of its outcome, also when it raised: ("ok", what it
    returns) or ("raise", the exception's type name and message). Every
    other rank returns or raises it (``_follow_stream``), so none is left
    waiting in a collective."""
    try:
        result = run()
    except BaseException as e:
        _broadcast_outcome(group, ("raise", type(e).__name__, str(e)))
        raise
    _broadcast_outcome(group, ("ok", result))
    return result


def _broadcast_outcome(group, outcome):
    nbytes = group.broadcast_pickled(("outcome", outcome))[1]
    LAST_STREAMING_STATS["broadcast_bytes"] = LAST_STREAMING_STATS.get("broadcast_bytes", 0) + nbytes


def _follow_stream(latent, N, evaluator: PointEvaluator, safety, clamp_dist):
    """A rank other than the main one in a streamed ``create_mesh`` over a
    group. It takes the main rank's messages in order: for each stream a
    route, on whose host route it evaluates its share of
    ``_sparse_active4``'s lattice (the one ``eval_points`` call every rank
    joins), then the outcome, which it returns, or raises as a
    ``RuntimeError``. It does no other device work.
    ``LAST_STREAMING_STATS`` holds the route, this rank's points and the
    bytes it received."""
    group = evaluator.group
    LAST_STREAMING_STATS.clear()
    start, nbytes, err = evaluator.n_evaluated, 0, None
    while True:
        (kind, msg), nb = group.broadcast_pickled(None)
        nbytes += nb
        if kind == "outcome":
            break
        LAST_STREAMING_STATS["refine"] = msg
        if msg == "host":
            try:
                evaluator.eval_points(latent, _host_lattice(N, safety, clamp_dist)[0])
            except Exception as e:  # every rank raised in eval_points; the outcome follows
                err = e
    LAST_STREAMING_STATS.update(evaluated=evaluator.n_evaluated - start, broadcast_bytes=nbytes)
    if msg[0] == "raise":
        raise RuntimeError(f"create_mesh raised on the main rank: {msg[1]}: {msg[2]}") from err
    return msg[1]


def mesh_route(N: int, evaluator: PointEvaluator, sparse: bool = True, clamp_dist: float = CLAMP_DIST,
               safety: float = SPARSE_SAFETY):
    """(b, route) of ``create_mesh`` at ``N`` (already snapped where
    ``sparse``) through ``evaluator``: the refinement block ``b`` (1 when
    not sparse) and the route, "streamed" (``b > 2`` and ``_streams``),
    "sparse" (``b > 2`` elsewhere) or "dense"."""
    b = _pick_block(N, clamp_dist, safety) if sparse else 1
    if b <= 2:
        return b, "dense"
    return b, "streamed" if _streams(evaluator) else "sparse"


def mesh_evaluator(decoder, N: int) -> PointEvaluator:
    """One ``PointEvaluator`` for a run of ``create_mesh`` calls at ``N`` (K1's
    weights prepared once, not per mesh), its stream warmed
    (``warm_stream``) where those calls stream."""
    evaluator = PointEvaluator(decoder)
    n = _snap_n(N)
    if mesh_route(n, evaluator)[1] == "streamed":
        evaluator.warm_stream(n)
    return evaluator


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
    clamp_dist: float = CLAMP_DIST,
    sparse_safety: float = SPARSE_SAFETY,
    evaluator: Optional[PointEvaluator] = None,
    eval_dtype: Optional[torch.dtype] = None,
    value_codec: str = "auto",
):
    """Latent -> SDF grid -> marching tetrahedra -> .ply
    (ref: deep_sdf/mesh.py:21-93). Returns (verts, faces) when
    ``return_mesh`` and extraction succeeded, True when it succeeded
    otherwise, and False on an empty surface like the reference (:118-124).

    ``sparse`` snaps N up to the next 4k+1 (equal or finer sampling than
    asked). ``eval_dtype`` is the kernel operand type when no ``evaluator``
    is given (default: bfloat16 on a GPU, float32 on the CPU).

    With block refinement (``b > 2``) it streams (``_create_mesh_streaming``),
    as ``msd_tpu`` does with its evaluator on its chip, where ``_streams``
    says so (``mesh_route``): the evaluator, given or made here, sits on the
    card.
    ``value_codec`` ("auto", "packed", "int8" or "f16", ``MSD_VALUE_CODEC``
    overrides) is the streamed rows' codec. Elsewhere it takes the float32
    sparse route, or the dense one.

    Over a group (the evaluator's) every rank calls this in lockstep with
    the same latent and N. Where it streams, the main rank refines, streams,
    meshes and writes the PLY on its own card, as ``msd_tpu``'s programs
    other than ``eval_points`` run on one device; one broadcast tells the
    other ranks the route, and on the host route every rank evaluates its
    share of the refinement lattice. (Rather than every rank refining
    again on its own card: a route message costs one small broadcast and
    leaves the other cards free.) A second broadcast hands every rank the
    main rank's outcome, which each returns, or raises where the main rank
    raised (``_lead_stream``, ``_follow_stream``). Unstreamed, every rank
    runs every ``eval_points`` call and only the main rank writes."""
    start = time.time()
    if evaluator is None:
        evaluator = PointEvaluator(decoder, dtype=eval_dtype, max_batch=max_batch)
    if sparse:
        N = _snap_n(N)
    b, route = mesh_route(N, evaluator, sparse, clamp_dist, sparse_safety)
    stream = route == "streamed"
    group = evaluator.group if stream else None
    if group is not None and not group.is_main:
        return _follow_stream(latent_vec, N, evaluator, sparse_safety, clamp_dist)

    def run():  # the whole call in this process (the main rank's, over a group)
        voxel_size = 2.0 / (N - 1)
        ply_done = False
        try:
            if stream:
                # the mesher spills the PLY as it meshes when no offset/scale
                # transform follows; verts/faces are made only when wanted
                spill_path = None
                if filename and scale is None and offset is None:
                    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
                    spill_path = filename + ".ply"
                want_mesh = bool(return_mesh) or spill_path is None
                verts, faces, ply_done = _create_mesh_streaming(
                    latent_vec, N, evaluator, sparse_safety, clamp_dist, voxel_size,
                    value_codec=value_codec, ply_path=spill_path, want_mesh=want_mesh,
                )
                if not want_mesh and not ply_done:
                    # the spill failed (e.g. tmpfs full): mesh again into memory
                    verts, faces, ply_done = _create_mesh_streaming(
                        latent_vec, N, evaluator, sparse_safety, clamp_dist, voxel_size,
                        value_codec=value_codec, ply_path=None, want_mesh=True,
                    )
                logging.debug("[create_mesh] streaming mesh takes: %f", time.time() - start)
            elif route == "sparse":
                verts, faces = _create_mesh_sparse(latent_vec, N, b, sparse_safety, evaluator)
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

        if filename and not ply_done and (evaluator.group is None or evaluator.group.is_main):
            t0 = time.time()
            os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
            save_ply(filename + ".ply", verts, faces)
            if stream:
                LAST_STREAMING_STATS["t_ply"] = round(time.time() - t0, 3)
        if return_mesh:
            return verts, faces
        return True

    return run() if group is None else _lead_stream(group, run)
