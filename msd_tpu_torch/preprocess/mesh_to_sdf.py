"""Mesh -> SDF training samples (counterpart of
``msd_tpu/preprocess/mesh_to_sdf.py``).

Replaces the reference's C++/OpenGL PreprocessMesh binary
(ref: src/PreprocessMesh.cpp). Faithful sampling semantics:

* mesh centered at its bounding-box center (scale untouched —
  BoundingCubeNormalization centers only, ref: src/Utils.cpp:170-244).
* near-surface base points: area-weighted CDF triangle sampling
  (ref: PreprocessMesh.cpp:23-85), each emitted twice with Gaussian jitter
  at variance and variance/10 (test mode: variance=0.05, /100)
  (ref: :113-126, :310-319).
* the rest uniform in the [-1, 1] bounding cube (ref: :127-132).
* per-sample sign by an 11-nearest-neighbor normal vote with all-or-nothing
  rejection; magnitude = distance to nearest surface point, or
  |normal . ray| point-plane distance when closer than sqrt(variance)
  (ref: SampleSDFNearSurface :87-174).

Every draw is made on the host with numpy from ``np.random.default_rng(seed)``,
as in ``msd_tpu``, so both packages draw the same samples. The kNN vote has
two routes (``knn_sign_vote``): tiled on the device (query chunks against
every surface point: a K = 3 distance product, exact ``torch.topk``, the
gathers and the vote, in PyTorch on the card) and on the host (scipy
``cKDTree``). ``msd_tpu``'s TPU route uses ``approx_min_k``; its other
backends, and the port everywhere, take the exact k nearest.

Visibility: "render" draws surface points from the faces a multi-view
rasterizer sees (``msd_tpu_torch/render.py``); "watertight" from all
faces; "auto" renders meshes with boundary edges. A failed build of the
rasterizer raises; the port never falls back to "watertight".
"""

from __future__ import annotations

import logging
import math
import time
from typing import Tuple

import numpy as np
import torch

from msd_tpu_torch.device import resolve_device
from msd_tpu_torch.ops.sampling import bounding_cube_normalization, sample_mesh_surface


def signed_volume(verts, faces) -> float:
    """Signed volume via the divergence theorem — positive for outward-wound
    closed meshes."""
    a = verts[faces[:, 0]]
    b = verts[faces[:, 1]]
    c = verts[faces[:, 2]]
    return float(np.sum(np.einsum("ij,ij->i", a, np.cross(b, c))) / 6.0)


def mesh_quality(verts, faces) -> dict:
    """Per-mesh quality ratios — the render-free analog of the reference's
    observation-ratio rejection test (ref: src/PreprocessMesh.cpp:496-512,
    thresholds 0.02 wrong-normal obs / 0.03 double-sided triangles):

    * ``inconsistent_winding_ratio``: interior edges whose two adjacent
      faces traverse them in the SAME direction (the geometric cause of the
      reference's wrong-normal observations).
    * ``boundary_edge_ratio``: edges with exactly one face (holes —
      non-watertight, the reference's unobservable/double-sided source).
    * ``nonmanifold_edge_ratio``: edges with >2 faces.
    * ``rejected``: reference-like thresholds applied to the analogous
      defect classes.
    """
    f = np.asarray(faces, np.int64)
    de = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])  # directed
    ue = np.sort(de, axis=1)
    uniq, inv, counts = np.unique(ue, axis=0, return_inverse=True, return_counts=True)
    n_edges = uniq.shape[0]
    boundary_ratio = float(np.mean(counts == 1)) if n_edges else 1.0
    nonmanifold_ratio = float(np.mean(counts > 2)) if n_edges else 0.0
    # direction bit of each directed occurrence; a consistently wound
    # interior edge is traversed once in each direction -> bit sum == 1
    bit = (de[:, 0] < de[:, 1]).astype(np.int64)
    bit_sum = np.bincount(inv, weights=bit, minlength=n_edges)
    interior = counts == 2
    inconsistent = interior & (bit_sum != 1)
    inconsistent_ratio = (
        float(inconsistent.sum() / max(1, interior.sum())) if n_edges else 0.0
    )
    rejected = inconsistent_ratio > 0.02 or (boundary_ratio + nonmanifold_ratio) > 0.03
    return {
        "inconsistent_winding_ratio": inconsistent_ratio,
        "boundary_edge_ratio": boundary_ratio,
        "nonmanifold_edge_ratio": nonmanifold_ratio,
        "rejected": bool(rejected),
    }


def repair_mesh_winding(verts, faces):
    """Consistently orient faces (BFS over edge adjacency, flipping faces
    that traverse a shared edge in the same direction as their neighbor),
    then flip whole components to outward via per-component signed volume.

    The reference never needs this — its multi-view render pass observes
    outward normals directly regardless of winding (ref:
    src/PreprocessMesh.cpp:443-494); this is the geometric equivalent for
    the render-free pipeline. Returns (faces, num_flipped)."""
    f = np.asarray(faces, np.int64).copy()
    nf = f.shape[0]
    # undirected edge id per face slot
    de = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    ue = np.sort(de, axis=1)
    uniq, inv = np.unique(ue, axis=0, return_inverse=True)
    # adjacency: faces sharing each undirected edge
    edge_faces = {}
    for slot in range(3 * nf):
        edge_faces.setdefault(inv[slot], []).append(slot % nf)

    flipped = np.zeros(nf, bool)
    visited = np.zeros(nf, bool)
    total_flipped = 0

    def edge_dir(face_idx, eid):
        """+1 / -1 direction of edge eid in face face_idx (with its current
        flip state applied); 0 if absent."""
        tri = f[face_idx]
        if flipped[face_idx]:
            tri = tri[::-1]
        a, b = uniq[eid]
        for i in range(3):
            u, v = tri[i], tri[(i + 1) % 3]
            if u == a and v == b:
                return 1
            if u == b and v == a:
                return -1
        return 0

    comp_label = np.full(nf, -1, np.int64)
    n_comp = 0
    for seed_face in range(nf):
        if visited[seed_face]:
            continue
        stack = [seed_face]
        visited[seed_face] = True
        comp_label[seed_face] = n_comp
        while stack:
            cur = stack.pop()
            for slot_eid in inv[[cur, cur + nf, cur + 2 * nf]]:
                for nb in edge_faces[slot_eid]:
                    if nb == cur or visited[nb]:
                        continue
                    # consistent orientation = opposite traversal directions
                    if edge_dir(cur, slot_eid) == edge_dir(nb, slot_eid):
                        flipped[nb] = True
                        total_flipped += 1
                    visited[nb] = True
                    comp_label[nb] = n_comp
                    stack.append(nb)
        n_comp += 1

    f[flipped] = f[flipped][:, ::-1]
    # outward orientation per component
    v = np.asarray(verts, np.float64)
    for c in range(n_comp):
        sel = comp_label == c
        if signed_volume(v, f[sel]) < 0:
            f[sel] = f[sel][:, ::-1]
            total_flipped += int(sel.sum())
    return f.astype(faces.dtype, copy=False), total_flipped


def sample_surface_points(verts, faces, num_points, rng=None, orient_outward=True):
    """Area-weighted surface samples with face normals (host).

    The reference gets orientation-free outward normals from its multi-view
    render pass (view-corrected, ref: src/ShaderProgram.cpp); for watertight
    meshes the signed-volume test recovers global outward orientation for
    either winding convention.
    """
    pts, normals, _ = sample_mesh_surface(verts, faces, num_points, rng, return_normals=True)
    if orient_outward and signed_volume(verts, faces) < 0:
        normals = -normals
    return pts, normals


# ---------------------------------------------------------------------------
# kNN + normal vote


def _knn_chunk(q, s, n, s_sq, k):
    """One query chunk [Qc, 3] against every surface point (counterpart of
    ``msd_tpu``'s ``_knn_chunk``): the [Qc, S] squared distances
    |q|^2 + |s|^2 - 2 q.s^T, the exact k nearest by ``torch.topk``, and
    the vote statistics (ref: PreprocessMesh.cpp:146-160).
    Returns (num_pos [Qc], nearest_dist [Qc], plane_dist [Qc])."""
    d2 = (q * q).sum(1)[:, None] + s_sq[None, :]
    d2.addmm_(q, s.T, alpha=-2.0)
    idx = torch.topk(d2, k, dim=1, largest=False).indices  # ascending distance
    del d2
    nn_pts = s[idx]  # [Qc, k, 3]
    nn_norms = n[idx]
    ray = q[:, None, :] - nn_pts
    ray_len2 = (ray * ray).sum(2)
    ray_len = torch.sqrt(torch.clamp(ray_len2, min=1e-24))
    d = (nn_norms * ray).sum(2) / ray_len
    num_pos = (d > 0).sum(1)
    # the true nearest is the min over the k (exact within the set)
    order = torch.argmin(ray_len2, dim=1)
    rows = torch.arange(q.shape[0], device=q.device)
    nearest = ray_len[rows, order]
    plane = (nn_norms[rows, order] * ray[rows, order]).sum(1).abs()
    return num_pos, nearest, plane


def _knn_tiled(queries, surf_pts, surf_norms, k, q_chunk, dev):
    """Tiled vote on ``dev``: every query chunk of ``q_chunk`` rows is sent
    to the device and voted against all surface points there. One chunk
    holds a [q_chunk, S] float32 distance matrix (8192 x 200000: 6.55 GB).

    Returns (num_pos, nearest, plane, stats). On a CUDA device ``stats``
    holds the route's device milliseconds (CUDA events from the surface
    upload to the last chunk), the chunks' summed compute milliseconds,
    the idle share between them, and the peak device memory (the CUDA
    allocator's peak statistic is reset at the start)."""
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        spans = []
    s = torch.from_numpy(np.ascontiguousarray(surf_pts, np.float32)).to(dev)
    n = torch.from_numpy(np.ascontiguousarray(surf_norms, np.float32)).to(dev)
    s_sq = (s * s).sum(1)
    q_host = torch.from_numpy(np.ascontiguousarray(queries, np.float32))
    q = q_host.shape[0]
    num_pos = np.empty(q, np.int32)
    nearest = np.empty(q, np.float32)
    plane = np.empty(q, np.float32)
    for lo in range(0, q, q_chunk):
        hi = min(lo + q_chunk, q)
        qc = q_host[lo:hi].to(dev)
        if cuda:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
        npos, nd, pd = _knn_chunk(qc, s, n, s_sq, k)
        if cuda:
            b.record()
            spans.append((a, b))
        num_pos[lo:hi] = npos.cpu().numpy()
        nearest[lo:hi] = nd.cpu().numpy()
        plane[lo:hi] = pd.cpu().numpy()
    stats = {"route": "tiled", "device": str(dev), "chunks": len(range(0, q, q_chunk))}
    if cuda:
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        end.synchronize()
        device_ms = start.elapsed_time(end)
        busy_ms = sum(a.elapsed_time(b) for a, b in spans)
        stats.update(device_ms=device_ms, chunk_ms=busy_ms,
                     idle_share=1.0 - busy_ms / device_ms if device_ms > 0 else 0.0,
                     peak_bytes=torch.cuda.max_memory_allocated(dev))
    return num_pos, nearest, plane, stats


def _knn_host(queries, surf_pts, surf_norms, k, q_chunk=65536):
    """Exact k-NN normal vote on the host via scipy cKDTree (a copy of
    ``msd_tpu``'s ``_knn_host``; the same vote and magnitude math as
    ``_knn_chunk``, ref: PreprocessMesh.cpp:146-160).
    Returns (num_pos [Q] int32, nearest_dist [Q] f32, plane_dist [Q] f32).
    """
    from scipy.spatial import cKDTree

    tree = cKDTree(np.asarray(surf_pts, np.float64))
    q = queries.shape[0]
    num_pos = np.empty(q, np.int32)
    nearest = np.empty(q, np.float32)
    plane = np.empty(q, np.float32)
    for start in range(0, q, q_chunk):
        qs = queries[start : start + q_chunk]
        dist, idx = tree.query(qs, k=k)
        # cKDTree.query drops the k axis for k=1; the tiled route keeps it
        dist = dist.reshape(-1, k)
        idx = idx.reshape(-1, k)
        nn_pts = surf_pts[idx]  # [Qc, k, 3]
        nn_norms = surf_norms[idx]
        ray = qs[:, None, :] - nn_pts
        ray_len = np.sqrt(np.maximum(np.sum(ray**2, axis=2), 1e-24))
        d = np.sum(nn_norms * ray, axis=2) / ray_len
        num_pos[start : start + q_chunk] = np.sum(d > 0, axis=1)
        nearest[start : start + q_chunk] = dist[:, 0]
        plane[start : start + q_chunk] = np.abs(
            np.sum(nn_norms[:, 0, :] * ray[:, 0, :], axis=1)
        )
    return num_pos, nearest, plane


def _vote(queries, surf_pts, surf_norms, num_votes, stdv, q_chunk, device, force_device):
    """``knn_sign_vote`` with the route's statistics: (sdf, keep, stats).
    ``stats["seconds"]`` is the host clock around the route; the tiled
    route on a CUDA device adds its CUDA-event figures (``_knn_tiled``)."""
    dev = torch.device(device)
    tiled = dev.type == "cuda" if force_device is None else bool(force_device)
    t0 = time.perf_counter()
    if tiled:
        if dev.type == "cuda":
            dev = resolve_device(dev)  # raises without a GPU; TF32 off
        num_pos, nearest, plane, stats = _knn_tiled(
            queries, surf_pts, surf_norms, num_votes, q_chunk, dev
        )
    else:
        # Host KD-tree route (the reference's own design: nanoflann,
        # ref PreprocessMesh.cpp:523-525).
        num_pos, nearest, plane = _knn_host(queries, surf_pts, surf_norms, num_votes)
        stats = {"route": "host", "device": "cpu"}
    stats["seconds"] = time.perf_counter() - t0
    # magnitude: point-plane when close to the surface (ref: :151-156)
    mag = np.where(nearest < stdv, plane, nearest)
    keep = (num_pos == 0) | (num_pos == num_votes)
    sign = np.where(num_pos <= num_votes // 2, -1.0, 1.0)
    return (sign * mag).astype(np.float32), keep, stats


def knn_sign_vote(
    queries: np.ndarray,
    surf_pts: np.ndarray,
    surf_norms: np.ndarray,
    num_votes: int = 11,
    stdv: float = math.sqrt(0.005),
    q_chunk: int = 8192,
    s_tile: int = 8192,
    device="cuda",
    force_device: bool | None = None,
):
    """Signed distances with all-or-nothing vote rejection.

    Returns (sdf [Q] float32, keep [Q] bool): ``keep`` is False where the
    vote was split (sample rejected, ref: PreprocessMesh.cpp:162-170).

    Routes: ``force_device=None`` takes the tiled route on ``device`` when
    it is a CUDA device and the host cKDTree route when it is the CPU (as
    ``msd_tpu`` does on a backend that is not a TPU); ``True`` forces the
    tiled route on ``device`` (on CPU tensors too: the tests do so) and
    ``False`` the host route. The tiled route on a CUDA device raises
    without a GPU, and no error there moves the vote to the host.
    ``s_tile`` is accepted for ``msd_tpu``'s signature; the tiled route
    votes each query chunk against every surface point at once.
    """
    sdf, keep, _ = _vote(queries, surf_pts, surf_norms, num_votes, stdv, q_chunk, device, force_device)
    return sdf, keep


# Least agreement between two routes of the vote on one input (the tiled
# route on the card against the host route): the share of queries with the
# same keep and the same sign, and the share of the queries both keep whose
# |sdf| agrees within ``abs_sdf_tol``. Exact top-k on both routes differs
# only where float32 distances tie at the k-th neighbour.
VOTE_AGREEMENT = {"keep": 0.999, "sign": 0.999, "abs_sdf": 0.999, "abs_sdf_tol": 1e-5}


def vote_agreement(sdf_a, keep_a, sdf_b, keep_b) -> dict:
    """Shares of queries on which two votes agree (see ``VOTE_AGREEMENT``)
    and whether each share meets its limit."""
    both = keep_a & keep_b
    close = np.abs(np.abs(sdf_a[both]) - np.abs(sdf_b[both])) <= VOTE_AGREEMENT["abs_sdf_tol"]
    out = {
        "keep": float(np.mean(keep_a == keep_b)),
        "sign": float(np.mean(np.signbit(sdf_a) == np.signbit(sdf_b))),
        "abs_sdf": float(np.mean(close)) if both.any() else 1.0,
        "max_abs_sdf_diff": float(np.max(np.abs(np.abs(sdf_a[both]) - np.abs(sdf_b[both])))) if both.any() else 0.0,
    }
    out["ok"] = all(out[k] >= VOTE_AGREEMENT[k] for k in ("keep", "sign", "abs_sdf"))
    return out


# ---------------------------------------------------------------------------


def draw_queries(verts, faces, num_samples=500000, variance=0.005, test=False,
                 surface_vote_points=200000, seed=0, center=True, repair=True, visibility="auto"):
    """Everything ``preprocess_mesh`` does before the vote: center, quality
    gate and repair, visibility, and the seeded host draws. Returns
    (queries [Q, 3], vote_pts [S, 3], vote_norms [S, 3], stdv, quality,
    host seconds of each part)."""
    t_start = time.perf_counter()
    if test:
        variance = 0.05
        second_variance = variance / 100.0
        near_ratio = 45.0 / 50.0
        num_samples = min(num_samples, 250000)
    else:
        second_variance = variance / 10.0
        near_ratio = 47.0 / 50.0
    stdv = math.sqrt(variance)

    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    if center:
        vmin = verts.min(axis=0)
        vmax = verts.max(axis=0)
        verts = verts - (vmin + vmax) / 2.0

    quality = mesh_quality(verts, faces)
    if quality["rejected"]:
        # ref logs "mesh rejected" but proceeds (PreprocessMesh.cpp:509-512,
        # early return commented out); callers read info["rejected"]
        logging.warning(
            "mesh rejected (winding=%.4f boundary=%.4f nonmanifold=%.4f)",
            quality["inconsistent_winding_ratio"], quality["boundary_edge_ratio"],
            quality["nonmanifold_edge_ratio"],
        )
    if repair and quality["inconsistent_winding_ratio"] > 0:
        faces, n_flipped = repair_mesh_winding(verts, faces)
        logging.info("repaired mesh winding: flipped %d faces", n_flipped)
        quality = dict(quality, repaired_faces=n_flipped)
    elif repair and signed_volume(verts, faces) < 0:
        # consistently wound but inward (negative enclosed volume): flip
        # globally so the orientation-sensitive render pass sees front
        # faces (see msd_tpu's preprocess_mesh)
        faces = np.ascontiguousarray(faces[:, ::-1])
        quality = dict(quality, global_flip=True)
    t_quality = time.perf_counter()

    sample_faces, render_stats = _visibility_faces(verts, faces, visibility, quality)
    if render_stats is not None:
        quality = dict(quality, **render_stats)
        # reference observation-ratio rejection (PreprocessMesh.cpp:496-512):
        # >2-3% of covered pixels seeing a back-facing triangle flags a
        # badly-wound/doubled surface; logged-and-proceed like the reference
        if render_stats["wrong_normal_fraction"] > 0.02:
            logging.warning(
                "mesh rejected (render pass: %.2f%% wrong-normal observations)",
                100 * render_stats["wrong_normal_fraction"],
            )
            quality = dict(quality, rejected=True)
    t_render = time.perf_counter()

    rng = np.random.default_rng(seed)
    num_near = int(near_ratio * num_samples)
    base_n = num_near // 2

    # base surface points for jittered samples
    base_pts, _ = sample_surface_points(verts, sample_faces, base_n, rng)
    samp1 = base_pts + rng.normal(0.0, stdv, size=base_pts.shape).astype(np.float32)
    samp2 = base_pts + rng.normal(0.0, math.sqrt(second_variance), size=base_pts.shape).astype(np.float32)
    n_uniform = num_samples - 2 * base_n
    uniform = rng.uniform(-1.0, 1.0, size=(n_uniform, 3)).astype(np.float32)
    queries = np.concatenate([samp1, samp2, uniform], axis=0).astype(np.float32)

    # vote set: dense surface sampling with normals
    vote_pts, vote_norms = sample_surface_points(verts, sample_faces, surface_vote_points, rng)
    t_sampled = time.perf_counter()
    seconds = {"quality_repair": t_quality - t_start, "render": t_render - t_quality,
               "sampling": t_sampled - t_render, "total": t_sampled - t_start}
    return queries, vote_pts, vote_norms, stdv, quality, seconds


def preprocess_mesh(
    verts: np.ndarray,
    faces: np.ndarray,
    num_samples: int = 500000,
    variance: float = 0.005,
    test: bool = False,
    num_votes: int = 11,
    surface_vote_points: int = 200000,
    seed: int = 0,
    center: bool = True,
    repair: bool = True,
    visibility: str = "auto",
    knn_device="cuda",
    knn_force_device: bool | None = None,
) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Full mesh -> {pos, neg} sample generation
    (ref: src/PreprocessMesh.cpp:282-565).

    Returns (pos [N,4], neg [M,4], info) with float32 (x, y, z, sdf) rows.
    info carries the per-mesh ``quality`` ratios and ``rejected`` flag,
    the vote's route statistics (``vote``, see ``_knn_tiled``) and the
    host seconds of each part (``seconds``: quality and repair, render,
    sampling, vote, total). ``repair=True`` additionally re-winds
    inconsistently oriented faces before sampling so the normal vote sees
    coherent outward normals.

    ``visibility`` selects how surface points are drawn:
      * "watertight" — area-weighted sampling over ALL faces (valid for the
        watertight volume-corrected medical meshes this pipeline targets);
      * "render" — the reference's multi-view visibility pass
        (ref: PreprocessMesh.cpp:443-494): 100 Fibonacci-sphere cameras
        rasterize face-id buffers (native C++ rasterizer standing in for
        the GL ShaderProgram, src/ShaderProgram.cpp:5-141) and base/vote
        points are sampled from VISIBLE faces only; the per-view
        wrong-normal observation ratio feeds the reference's
        mesh-rejection diagnostic (ref: :496-512, thresholds 0.02/0.03 —
        logged-and-proceed, like the reference);
      * "auto" — "render" when the mesh has boundary edges (non-watertight,
        where all-face sampling would place surface points on interior
        shells), else "watertight". The rasterizer's build raises if it
        fails.

    ``knn_device`` and ``knn_force_device`` pick the vote's route
    (``knn_sign_vote``'s ``device`` and ``force_device``).
    """
    queries, vote_pts, vote_norms, stdv, quality, seconds = draw_queries(
        verts, faces, num_samples, variance, test, surface_vote_points, seed, center, repair, visibility,
    )
    t_sampled = time.perf_counter()
    sdf, keep, vote = _vote(
        queries, vote_pts, vote_norms, num_votes, stdv, 8192, knn_device, knn_force_device,
    )
    t_vote = time.perf_counter()
    xyz = queries[keep]
    sdf = sdf[keep]

    pos = np.concatenate([xyz[sdf >= 0], sdf[sdf >= 0][:, None]], axis=1).astype(np.float32)
    neg = np.concatenate([xyz[sdf < 0], sdf[sdf < 0][:, None]], axis=1).astype(np.float32)
    t_end = time.perf_counter()
    info = {
        "num_queries": int(queries.shape[0]),
        "num_kept": int(xyz.shape[0]),
        "rejected_fraction": float(1.0 - xyz.shape[0] / queries.shape[0]),
        "quality": quality,
        "rejected": quality["rejected"],
        "vote": vote,
        "seconds": {
            **seconds,
            "sampling": seconds["sampling"] + (t_end - t_vote),
            "vote": t_vote - t_sampled,
            "total": seconds["total"] + (t_end - t_sampled),
        },
    }
    if info["rejected_fraction"] > 0.5:
        logging.warning(
            "mesh quality: %.1f%% of samples rejected by the sign vote "
            "(non-watertight or inconsistent winding?)", 100 * info["rejected_fraction"],
        )
    return pos, neg, info


def _visibility_faces(verts, faces, visibility: str, quality: dict):
    """Resolve the face set surface samples are drawn from.

    Returns (faces_to_sample, render_stats-or-None). "render" restricts to
    the multi-view visible shell (ref: PreprocessMesh.cpp:443-494); "auto"
    uses the render pass for non-watertight meshes."""
    if visibility not in ("auto", "render", "watertight"):
        raise ValueError(f"unknown visibility mode: {visibility!r}")
    use_render = visibility == "render" or (
        visibility == "auto" and quality.get("boundary_edge_ratio", 0.0) > 0.0
    )
    if not use_render:
        return faces, None
    from msd_tpu_torch.render import visibility_scan

    # scale a render copy to the camera rig's unit-sphere frame (the mesh
    # is centered but not scaled at this point, like the reference's
    # BoundingCubeNormalization center-only pass, Utils.cpp:170)
    vscale = float(np.linalg.norm(verts, axis=1).max()) or 1.0
    vis, stats = visibility_scan((verts / vscale, faces))
    stats = {f"render_{k}" if k == "visible_fraction" else k: v for k, v in stats.items()}
    if not vis.any():  # degenerate render (e.g. all-degenerate faces)
        return faces, stats
    return faces[vis], stats


def _sample_visible_surface(verts, faces, num_points, seed, visibility):
    """``sample_visible_surface`` with the host seconds of its parts
    (quality, render, sampling, total) as a fourth value."""
    t0 = time.perf_counter()
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    offset, scale = bounding_cube_normalization(verts, buffer=1.03)
    quality = mesh_quality(verts - verts.mean(axis=0), faces)
    t1 = time.perf_counter()
    faces_to_sample, _ = _visibility_faces(
        verts - (verts.min(axis=0) + verts.max(axis=0)) / 2.0, faces, visibility, quality
    )
    t2 = time.perf_counter()
    pts = sample_mesh_surface(verts, faces_to_sample, num_points, np.random.default_rng(seed))[0]
    t3 = time.perf_counter()
    seconds = {"quality_repair": t1 - t0, "render": t2 - t1, "sampling": t3 - t2, "total": t3 - t0}
    return pts.astype(np.float32), offset, scale, seconds


def sample_visible_surface(
    verts: np.ndarray, faces: np.ndarray, num_points: int = 30000, seed: int = 0,
    visibility: str = "auto",
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Evaluation surface samples + normalization parameters
    (ref: src/SampleVisibleMeshSurface.cpp:144-324): (points [N,3],
    offset [3], scale) with offset = -bbox_center and
    scale = 1/(max_dist_from_center * 1.03). Points stay in the ORIGINAL
    mesh frame (the reference's normalization call is commented out,
    SampleVisibleMeshSurface.cpp:219); the params map them to the
    normalized frame used during training.

    ``visibility``: like preprocess_mesh — "render" keeps only samples on
    the multi-view visible shell (ref SampleFromSurfaceInside,
    SampleVisibleMeshSurface.cpp:59-142); "auto" renders only for
    non-watertight meshes."""
    return _sample_visible_surface(verts, faces, num_points, seed, visibility)[:3]
