"""Serving in plain PyTorch: the latent fit of held-out shapes, and the
values a mesh of the fitted field must interpolate.

The fit (DeepSDF's reconstruction, Park et al. 2019, with the repository's
``reconstruct.py`` settings): each shape's latent starts at
``stat * N(0, 1)`` from a generator of its own; each
iteration draws ``samples // 2`` positive and the rest negative rows with
replacement from that generator, takes the mean clamped L1 of the decoder
plus ``1e-4 * mean(z^2)`` (``l2reg``), and steps Adam on the latent (torch's
rule, eps after the square root) at ``lr``, divided by 10 every
``iterations // 2`` iterations.

The mesh: marching tetrahedra puts a vertex on each lattice edge whose
ends differ in sign (negative inside), at the linear interpolation of the
two values. A vertex on an axis edge is therefore fixed by two lattice
values, which the reference computes again; and the axis edges with a
sign change in a lattice plane can be counted from the plane's values.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import decoder as ref_decoder

# a coordinate within this many grid units of an integer lies on the lattice
ON_LATTICE = 2e-4


def fit(config: dict, params: dict, shapes: list, seeds: list, iterations: int, samples: int, lr: float,
        l2reg: bool, clamp: float, stat: float = 0.01, mode: str = "float32", half_batch: bool = False):
    """Fit one latent per shape of ``shapes`` [(pos [P, 4], neg [N, 4])]
    (tensors on the decoder's device); shape i draws from a generator
    seeded ``seeds[i]``. Returns (loss of the first iteration [S], latents
    [S, L]). ``half_batch`` plants a fault: the loss takes its mean over
    the first half of each iteration's rows."""
    dev = params["lin0.weight"].device
    L = int(config["CodeLength"])
    gens = [torch.Generator(device=dev).manual_seed(int(s)) for s in seeds]
    z = torch.stack([stat * torch.randn(1, L, generator=g, device=dev) for g in gens])
    m, v = torch.zeros_like(z), torch.zeros_like(z)
    half = samples // 2
    first = None
    with ref_decoder.precision(mode):
        for it in range(iterations):
            rows = []
            for (pos, neg), g in zip(shapes, gens):
                ip = torch.randint(0, pos.shape[0], (half,), generator=g, device=dev)
                ineg = torch.randint(0, neg.shape[0], (samples - half,), generator=g, device=dev)
                rows.append(torch.cat([pos[ip], neg[ineg]], dim=0))
            batch = torch.stack(rows)
            if half_batch:
                batch = batch[:, : samples // 2]
            zz = z.detach().requires_grad_(True)
            loss = shape_loss(config, params, zz, batch, clamp, l2reg, mode)
            (g,) = torch.autograd.grad(loss.sum(), zz)
            if first is None:
                first = loss.detach()
            with torch.no_grad():
                step_lr = lr * 0.1 ** (it // max(1, iterations // 2))
                t = it + 1
                m = 0.9 * m + 0.1 * g
                v = 0.999 * v + 0.001 * g * g
                z = zz - step_lr * (m / (1 - 0.9**t)) / (torch.sqrt(v / (1 - 0.999**t)) + 1e-8)
    return first, z[:, 0, :].detach()


def initial_latents(config: dict, seeds: list, stat: float, device) -> torch.Tensor:
    """[S, L]: the latents each fit starts from (the first draw of its
    generator)."""
    L = int(config["CodeLength"])
    return torch.cat([stat * torch.randn(1, L, generator=torch.Generator(device=device).manual_seed(int(s)),
                                         device=device) for s in seeds])


def shape_loss(config: dict, params: dict, z: torch.Tensor, rows: torch.Tensor, clamp: float, l2reg: bool,
               mode: str = "float32") -> torch.Tensor:
    """[S] mean clamped L1 of the decoder at latents ``z`` [S, 1, L] on
    ``rows`` [S, n, 4], plus the l2reg term."""
    pred = ref_decoder.forward(config, params, z, rows[..., :3], mode).clamp(-clamp, clamp)
    loss = (pred - rows[..., 3].clamp(-clamp, clamp)).abs().mean(dim=1)
    if l2reg:
        loss = loss + 1e-4 * (z**2).mean(dim=(1, 2))
    return loss


@torch.no_grad()
def values(config: dict, params: dict, latent: torch.Tensor, pts: torch.Tensor, mode: str = "float32",
           block: int = 2**20) -> torch.Tensor:
    """SDF [n] at ``pts`` [n, 3] (the final tanh's output), in blocks."""
    out = []
    with ref_decoder.precision(mode):
        for i in range(0, pts.shape[0], block):
            out.append(ref_decoder.forward(config, params, latent.reshape(-1), pts[i:i + block], mode))
    return torch.cat(out) if out else pts.new_zeros(0)


def axis_edge_vertices(verts: np.ndarray, N: int):
    """The vertices of a mesh on the lattice [-1, 1]^3 with N points a side
    that lie on an axis edge: (lower lattice point [k, 3] int64, axis [k],
    t [k] from the lower point). A vertex near a lattice point is left out
    (its edge is ambiguous)."""
    h = 2.0 / (N - 1)
    g = (verts.astype(np.float64) + 1.0) / h
    near = np.abs(g - np.rint(g)) < ON_LATTICE
    keep = near.sum(1) == 2
    g = g[keep]
    axis = np.argmin(near[keep], axis=1)
    lo = np.rint(g).astype(np.int64)
    rows = np.arange(len(g))
    lo[rows, axis] = np.floor(g[rows, axis]).astype(np.int64)
    t = g[rows, axis] - lo[rows, axis]
    return lo, axis, t


def lattice_points(idx: torch.Tensor, N: int) -> torch.Tensor:
    """Coordinates of lattice points ``idx`` [..., 3] (int)."""
    return (idx.double() * (2.0 / (N - 1)) - 1.0).float()


def crossing_t(s_lo: torch.Tensor, s_hi: torch.Tensor) -> torch.Tensor:
    """Where the linear interpolation of two values crosses 0, from the
    first, clipped to [0, 1]."""
    d = s_lo - s_hi
    d = torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
    return (s_lo / d).clamp(0.0, 1.0)


def edge_t(config: dict, params: dict, latent: torch.Tensor, lo: np.ndarray, axis: np.ndarray, N: int,
           mode: str = "float32") -> torch.Tensor:
    """The crossing t of each axis edge (lower point ``lo``, ``axis``)."""
    dev = latent.device
    lo_t = torch.as_tensor(lo, device=dev)
    hi_t = lo_t.clone()
    hi_t[torch.arange(len(lo), device=dev), torch.as_tensor(axis, device=dev)] += 1
    pts = lattice_points(torch.cat([lo_t, hi_t]), N)
    s = values(config, params, latent, pts, mode)
    return crossing_t(s[: len(lo)], s[len(lo):])


def plane_crossings(config: dict, params: dict, latent: torch.Tensor, N: int, planes, mode: str = "float32") -> int:
    """Edges along x and y with a sign change in the lattice planes z =
    ``planes`` (indices)."""
    dev = latent.device
    ij = torch.stack(torch.meshgrid(torch.arange(N, device=dev), torch.arange(N, device=dev), indexing="ij"), -1)
    total = 0
    for k in planes:
        idx = torch.cat([ij, torch.full((N, N, 1), int(k), device=dev)], dim=-1).reshape(-1, 3)
        inside = (values(config, params, latent, lattice_points(idx, N), mode) < 0).reshape(N, N)
        total += int((inside[1:] != inside[:-1]).sum()) + int((inside[:, 1:] != inside[:, :-1]).sum())
    return total


def mesh_plane_crossings(lo: np.ndarray, axis: np.ndarray, planes) -> int:
    """The mesh's vertices on x and y edges in the planes z = ``planes``."""
    sel = np.isin(lo[:, 2], np.asarray(list(planes))) & (axis < 2)
    keys = np.unique(lo[sel] * 3 + axis[sel, None], axis=0)
    return int(len(keys))
