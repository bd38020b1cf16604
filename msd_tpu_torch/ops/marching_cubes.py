"""Iso-surface extraction from SDF grids (host side: vectorized numpy and
the C++ host mesher).

A copy of ``msd_tpu/ops/marching_cubes.py``. ``marching_tetrahedra_blocks``
meshes through the C++ mesher (``msd_tpu_torch/native/marching_tets.cpp``,
a copy of ``msd_tpu``'s, built by ``msd_tpu_torch.native``) by default, so
``create_mesh`` (``msd_tpu_torch/mesh.py``) and every caller of it (the
reconstruct CLI, ``PointEvaluator(group=)``'s ranks, the Stage-1 and
Stage-2 eval meshes) take that route; ``use_native=False`` and blocks
wider than 63 cells (the mesher's uint64 row masks, as in ``msd_tpu``)
take the numpy route. Unlike ``msd_tpu``, a failed build or a nonzero
return code of ``mt_blocks`` raises rather than re-meshing in numpy.

Replaces the reference's skimage.measure.marching_cubes (lewiner) call
(ref: deep_sdf/mesh.py:119-121) with a native **marching-tetrahedra**
implementation: each active grid cell is split into 6 tetrahedra; every
tetrahedron crossing the iso-level emits 1-2 triangles with vertices
linearly interpolated along its edges. Marching tetrahedra is table-free
and unambiguous (no MC case ambiguities), produces a watertight surface on
watertight input fields, and is Chamfer-equivalent to MC at equal
resolution (validated against analytic SDFs in tests).

Two entry points:
* `marching_tetrahedra(grid, ...)` — full dense grid.
* `marching_tetrahedra_blocks(block_vals, block_bases, ...)` — operate
  directly on the active blocks produced by sparse grid evaluation
  (msd_tpu_torch/mesh.py), never materializing the N^3 grid. Vertex ids are
  global fine-grid edge ids, so the surface is seamless across blocks.
"""

from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np

from msd_tpu_torch.native import load_native

# Cube corner offsets, index = 4x + 2y + z
_CORNERS = np.array(
    [
        [0, 0, 0],
        [0, 0, 1],
        [0, 1, 0],
        [0, 1, 1],
        [1, 0, 0],
        [1, 0, 1],
        [1, 1, 0],
        [1, 1, 1],
    ],
    dtype=np.int64,
)

# 6-tetrahedra decomposition of the cube around the 0-7 diagonal.
_TETS = np.array(
    [
        [0, 4, 5, 7],
        [0, 5, 1, 7],
        [0, 1, 3, 7],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
    ],
    dtype=np.int64,
)


def _build_flip_table():
    """Precompute, per (tet index, inside-subset bitmask, triangle slot),
    whether the emitted triangle must be flipped so its normal points toward
    positive SDF. Orientation is a combinatorial invariant of the tet's
    geometry and the inside-subset (crossing points stay on the same edges),
    so one numeric probe per configuration settles it for all runtime cells.
    """
    flip = np.zeros((6, 16, 2), dtype=bool)
    corners = _CORNERS.astype(np.float64)
    for t in range(6):
        tet = _TETS[t]
        pts = corners[tet]  # [4, 3]
        for subset in range(1, 15):
            inside = [v for v in range(4) if subset & (1 << v)]
            s = np.array([-1.0 if v in inside else 1.0 for v in range(4)])
            # midpoints of crossing edges, triangles in the SAME order as
            # the runtime emission code
            def mid(a, b):
                return 0.5 * (pts[a] + pts[b])

            tris = []  # list of (p0, p1, p2, inside_centroid, outside_centroid)
            if len(inside) == 1:
                v = inside[0]
                others = [o for o in range(4) if o != v]
                tri = [mid(v, o) for o in others]
                tris.append((tri, pts[v], np.mean([pts[o] for o in others], axis=0)))
            elif len(inside) == 3:
                v = [o for o in range(4) if o not in inside][0]
                others = [o for o in range(4) if o != v]
                tri = [mid(o, v) for o in others]
                tris.append((tri, np.mean([pts[o] for o in others], axis=0), pts[v]))
            else:  # 2-2
                v0, v1 = inside
                o0, o1 = [o for o in range(4) if o not in inside]
                quad = [mid(v0, o0), mid(v0, o1), mid(v1, o1), mid(v1, o0)]
                inc = 0.5 * (pts[v0] + pts[v1])
                outc = 0.5 * (pts[o0] + pts[o1])
                tris.append(([quad[0], quad[1], quad[2]], inc, outc))
                tris.append(([quad[0], quad[2], quad[3]], inc, outc))
            for slot, (tri, inc, outc) in enumerate(tris):
                n = np.cross(tri[1] - tri[0], tri[2] - tri[0])
                flip[t, subset, slot] = float(np.dot(n, outc - inc)) < 0
    return flip


_FLIP_TABLE = _build_flip_table()


def _collect_triangles(sdf_batch, bases, level, global_dims):
    """Emit triangle edge-endpoint id pairs for active cells of a BATCH of
    equally-shaped grids (one vectorized pass over all blocks).

    sdf_batch: [A, nx, ny, nz] local values; bases: [A, 3] global index of
    each grid's local (0,0,0); global_dims: (Nx, Ny, Nz) for global ids.

    Returns (ea [T,3] inside-endpoint global ids, eb [T,3] outside ids,
    ids [K] global point ids, vals [K] their sdf values), or None when no
    cell is active.
    """
    A, nx, ny, nz = sdf_batch.shape
    c = sdf_batch < level
    cell_any = np.zeros((A, nx - 1, ny - 1, nz - 1), dtype=bool)
    cell_all = np.ones((A, nx - 1, ny - 1, nz - 1), dtype=bool)
    for dx, dy, dz in _CORNERS:
        sub = c[:, dx : nx - 1 + dx, dy : ny - 1 + dy, dz : nz - 1 + dz]
        cell_any |= sub
        cell_all &= sub
    aa, ai, aj, ak = np.nonzero(cell_any & ~cell_all)
    if aa.size == 0:
        return None
    Ny, Nz = global_dims[1], global_dims[2]
    b0 = bases[aa, 0]
    b1 = bases[aa, 1]
    b2 = bases[aa, 2]

    corner_ids = np.empty((aa.size, 8), dtype=np.int64)
    corner_sdf = np.empty((aa.size, 8), dtype=np.float32)
    for ci, (dx, dy, dz) in enumerate(_CORNERS):
        ii, jj, kk = ai + dx, aj + dy, ak + dz
        corner_ids[:, ci] = ((b0 + ii) * Ny + (b1 + jj)) * Nz + (b2 + kk)
        corner_sdf[:, ci] = sdf_batch[aa, ii, jj, kk]

    n_cells = corner_ids.shape[0]
    tet_ids = corner_ids[:, _TETS].reshape(-1, 4)
    tet_sdf = corner_sdf[:, _TETS].reshape(-1, 4)
    tet_in = tet_sdf < level
    n_in = tet_in.sum(axis=1)
    tet_idx = np.tile(np.arange(6), n_cells)
    subset = (
        tet_in[:, 0] * 1 + tet_in[:, 1] * 2 + tet_in[:, 2] * 4 + tet_in[:, 3] * 8
    )

    tri_edge_a, tri_edge_b = [], []

    def emit(a, b, mask, slot):
        """Append one triangle batch, applying the precomputed orientation."""
        flip = _FLIP_TABLE[tet_idx[mask], subset[mask], slot]
        if flip.any():
            a = a.copy()
            b = b.copy()
            a[flip] = a[flip][:, [0, 2, 1]]
            b[flip] = b[flip][:, [0, 2, 1]]
        tri_edge_a.append(a)
        tri_edge_b.append(b)

    # 1 inside / 3 inside cases
    for v in range(4):
        others = [o for o in range(4) if o != v]
        mask1 = (n_in == 1) & tet_in[:, v]
        if mask1.any():
            ids = tet_ids[mask1]
            emit(
                np.stack([ids[:, v]] * 3, axis=1),
                np.stack([ids[:, o] for o in others], axis=1),
                mask1, 0,
            )
        mask3 = (n_in == 3) & ~tet_in[:, v]
        if mask3.any():
            ids = tet_ids[mask3]
            emit(
                np.stack([ids[:, o] for o in others], axis=1),
                np.stack([ids[:, v]] * 3, axis=1),
                mask3, 0,
            )

    # 2-2 case: quad -> 2 triangles
    for v0, v1 in itertools.combinations(range(4), 2):
        others = [o for o in range(4) if o not in (v0, v1)]
        o0, o1 = others
        mask2 = (n_in == 2) & tet_in[:, v0] & tet_in[:, v1]
        if mask2.any():
            ids = tet_ids[mask2]
            qa = [ids[:, v0], ids[:, v0], ids[:, v1], ids[:, v1]]
            qb = [ids[:, o0], ids[:, o1], ids[:, o1], ids[:, o0]]
            emit(np.stack([qa[0], qa[1], qa[2]], axis=1), np.stack([qb[0], qb[1], qb[2]], axis=1), mask2, 0)
            emit(np.stack([qa[0], qa[2], qa[3]], axis=1), np.stack([qb[0], qb[2], qb[3]], axis=1), mask2, 1)

    if not tri_edge_a:
        return None
    ea = np.concatenate(tri_edge_a, axis=0)
    eb = np.concatenate(tri_edge_b, axis=0)

    # point id -> sdf value pairs (corner ids + their values; may contain
    # duplicates across cells/blocks — deduped in _finalize's lookup build)
    return ea, eb, corner_ids.ravel(), corner_sdf.ravel()


def _finalize(ea, eb, point_ids, point_vals, level, spacing, origin, global_dims):
    """Dedupe iso-vertices by undirected grid edge, interpolate positions,
    orient faces toward positive SDF."""
    Ny, Nz = global_dims[1], global_dims[2]
    big = int(global_dims[0]) * Ny * Nz

    lo = np.minimum(ea, eb)
    hi = np.maximum(ea, eb)
    edge_key = lo.astype(np.int64) * big + hi
    uniq_keys, faces_flat = np.unique(edge_key, return_inverse=True)
    faces = faces_flat.reshape(-1, 3).astype(np.int32)

    u_lo = (uniq_keys // big).astype(np.int64)
    u_hi = (uniq_keys % big).astype(np.int64)

    # id -> value lookup via sorted unique ids (input may contain duplicates)
    sorted_ids, first = np.unique(point_ids, return_index=True)
    sorted_vals = point_vals[first]

    def lookup(ids):
        pos = np.searchsorted(sorted_ids, ids)
        return sorted_vals[pos]

    def id_to_xyz(vid):
        k = vid % Nz
        j = (vid // Nz) % Ny
        i = vid // (Nz * Ny)
        return np.stack([i, j, k], axis=1).astype(np.float32)

    s_lo = lookup(u_lo)
    s_hi = lookup(u_hi)
    denom = s_hi - s_lo
    denom = np.where(np.abs(denom) < 1e-12, 1e-12, denom)
    t = np.clip((level - s_lo) / denom, 0.0, 1.0)
    p = id_to_xyz(u_lo) + t[:, None] * (id_to_xyz(u_hi) - id_to_xyz(u_lo))
    spacing = np.asarray(spacing, np.float32)
    verts = p * spacing[None, :] + np.asarray(origin, np.float32)[None, :]

    # face orientation was fixed at emission time via _FLIP_TABLE

    good = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return verts.astype(np.float32), faces[good]


def marching_tetrahedra(
    sdf_grid: np.ndarray,
    level: float = 0.0,
    spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0),
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the iso-surface of a dense [Nx, Ny, Nz] grid. Raises
    ValueError when the surface does not intersect the grid (mirrors
    skimage behavior relied on by the reference, deep_sdf/mesh.py:118-124)."""
    sdf = np.asarray(sdf_grid, np.float32)
    if min(sdf.shape) < 2:
        raise ValueError("grid too small")
    out = _collect_triangles(sdf[None], np.zeros((1, 3), np.int64), level, sdf.shape)
    if out is None:
        raise ValueError("Surface level must be within volume data range.")
    ea, eb, ids, vals = out
    return _finalize(ea, eb, ids, vals, level, spacing, origin, sdf.shape)


def marching_tetrahedra_blocks(
    block_vals: np.ndarray,  # [A, b+1, b+1, b+1]
    block_bases: np.ndarray,  # [A, 3] fine-grid index of each block origin
    N: int,
    level: float = 0.0,
    spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    use_native: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Iso-surface directly from sparse-eval active blocks.

    Each block covers cells [base, base+b) so cells are processed exactly
    once; vertex ids are global fine-grid ids, making the mesh seamless.
    ``use_native``: the C++ mesher (msd_tpu_torch/native/marching_tets.cpp)
    for blocks of b + 1 <= 64 samples a side; else vectorized numpy. The two
    give the same surface, with vertices in another order.
    """
    if use_native and np.shape(block_vals)[1] <= 64:
        return _native_blocks(block_vals, block_bases, N, level, spacing, origin)
    dims = (N, N, N)
    out = _collect_triangles(
        np.asarray(block_vals, np.float32), np.asarray(block_bases, np.int64), level, dims
    )
    if out is None:
        raise ValueError("Surface level must be within volume data range.")
    ea, eb, ids, vals = out
    return _finalize(ea, eb, ids, vals, level, spacing, origin, dims)


def _native_blocks(block_vals, block_bases, N, level, spacing, origin):
    """``mt_blocks`` of the C++ mesher (``msd_tpu/ops/marching_cubes.py
    :299-345``); its row masks are uint64, so b + 1 <= 64 (the caller
    checks). Raises ``RuntimeError`` when the library cannot be built or
    ``mt_blocks`` fails."""
    import ctypes

    lib = load_native()
    vals = np.ascontiguousarray(np.asarray(block_vals, np.float32) - np.float32(level))
    bases = np.ascontiguousarray(np.asarray(block_bases, np.int32))
    flips = np.ascontiguousarray(_FLIP_TABLE.astype(np.uint8))
    out_verts = ctypes.POINTER(ctypes.c_float)()
    out_faces = ctypes.POINTER(ctypes.c_int32)()
    nv, nf = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.mt_blocks(
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        bases.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        vals.shape[0], vals.shape[1] - 1, N,
        flips.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.byref(out_verts), ctypes.byref(nv), ctypes.byref(out_faces), ctypes.byref(nf),
    )
    try:
        if rc != 0:
            raise RuntimeError(f"native mesher failed: mt_blocks returned {rc}")
        if nv.value == 0:
            raise ValueError("Surface level must be within volume data range.")
        verts = np.ctypeslib.as_array(out_verts, shape=(nv.value, 3)).copy()
        faces = np.ctypeslib.as_array(out_faces, shape=(nf.value, 3)).copy()
    finally:
        lib.mt_free(out_verts)
        lib.mt_free(out_faces)
    verts = verts * np.asarray(spacing, np.float32)[None, :] + np.asarray(origin, np.float32)[None, :]
    return verts.astype(np.float32), faces
