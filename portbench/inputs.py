"""Inputs made from a run's seed, on the device, by the benchmark alone.

The scene family: ellipsoids with semi-axes drawn from U(0.35, 0.7), each
stored as signed-distance samples the way the preprocessing stores a mask:
points near the surface at two noise widths and uniform points in the box,
split by sign into a positive and a negative set, each in random order and
padded cyclically to a whole number of 128-row chunks. The distance is the
ellipsoid's scaled radial one, (|p / axes| - 1) min(axes).

The weights: a decoder of the configuration's widths with the default
initialisation U(+-1/sqrt(fan_in)), made in one draw per kind of tensor.
``fit_family_decoder`` then takes Adam steps against a family of such
ellipsoids, each with a latent of its own, so that the field has a closed
surface near every small latent, as a trained decoder has.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import decoder as ref_decoder

PAD_ROWS = 128
# shares of the near-surface (two widths) and uniform rows: 15 : 15 : 2
NOISE_VARIANCES = (0.005, 0.0005)


def ellipsoid_sdf(p: torch.Tensor, axes: torch.Tensor) -> torch.Tensor:
    """Scaled radial distance of ``p`` [..., n, 3] to ellipsoids ``axes``
    [..., 3]."""
    a = axes[..., None, :]
    return (torch.linalg.vector_norm(p / a, dim=-1) - 1.0) * axes.min(dim=-1).values[..., None]


def draw_axes(n: int, gen: torch.Generator, device) -> torch.Tensor:
    return torch.rand(n, 3, generator=gen, device=device) * 0.35 + 0.35


def ellipsoid_rows(axes: torch.Tensor, rows: int, gen: torch.Generator) -> torch.Tensor:
    """[S, rows, 4] (x, y, z, sdf) samples of the ellipsoids ``axes`` [S, 3]."""
    S, dev = axes.shape[0], axes.device
    d = torch.randn(S, rows, 3, generator=gen, device=dev)
    p = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True) * axes[:, None, :]
    n_wide = rows * 15 // 32
    n_near = rows * 30 // 32
    sigma = torch.full((rows, 1), math.sqrt(NOISE_VARIANCES[0]), device=dev)
    sigma[n_wide:n_near] = math.sqrt(NOISE_VARIANCES[1])
    p = p + torch.randn(S, rows, 3, generator=gen, device=dev) * sigma
    p[:, n_near:] = torch.rand(S, rows - n_near, 3, generator=gen, device=dev) * 2.0 - 1.0
    return torch.cat([p, ellipsoid_sdf(p, axes)[..., None]], dim=-1)


def split_by_sign(rows: torch.Tensor, gen: torch.Generator):
    """(pos [S, Pmax, 4], pos counts [S], neg [S, Nmax, 4], neg counts [S])
    of ``rows`` [S, n, 4]: each set in random order, padded by repeating
    its own rows to a multiple of ``PAD_ROWS``."""
    S, n, _ = rows.shape
    neg = rows[..., 3] <= 0
    key = neg.float() * 2.0 + torch.rand(S, n, generator=gen, device=rows.device)
    order = torch.argsort(key, dim=1)
    rows = torch.gather(rows, 1, order[..., None].expand(S, n, 4))
    n_neg = neg.sum(1)
    n_pos = n - n_neg
    if int(n_pos.min()) == 0 or int(n_neg.min()) == 0:
        raise RuntimeError("a scene has no sample of one sign")

    def padded(start, count):
        width = -(-int(count.max()) // PAD_ROWS) * PAD_ROWS
        j = torch.arange(width, device=rows.device)[None, :]
        src = start[:, None] + j % count[:, None]
        return torch.gather(rows, 1, src[..., None].expand(S, width, 4))

    return padded(torch.zeros_like(n_pos), n_pos), n_pos, padded(n_pos, n_neg), n_neg


def scene_samples(n_scenes: int, rows: int, gen: torch.Generator, device, axes=None, block: int = 50):
    """The sign-split samples of ``n_scenes`` ellipsoids of ``rows`` rows
    each, made ``block`` scenes at a time; ``axes`` [S, 3] or drawn from
    ``gen``. Returns (pos, pos counts, neg, neg counts, axes) with pos and
    neg as [S, Pmax, 4] float32 on ``device``."""
    if axes is None:
        axes = draw_axes(n_scenes, gen, device)
    parts = [split_by_sign(ellipsoid_rows(axes[i:i + block], rows, gen), gen) for i in range(0, n_scenes, block)]

    def cat(k):
        width = max(p[k].shape[1] for p in parts)
        out = torch.empty(n_scenes, width, 4, device=device)
        at = 0
        for p in parts:
            t, c = p[k], p[k + 1]
            j = torch.arange(width, device=device)[None, :]
            out[at:at + t.shape[0]] = torch.gather(t, 1, (j % c[:, None])[..., None].expand(t.shape[0], width, 4))
            at += t.shape[0]
        return out

    pos, neg = cat(0), cat(2)
    pc = torch.cat([p[1] for p in parts])
    nc = torch.cat([p[3] for p in parts])
    return pos, pc, neg, nc, axes


def soa(a: torch.Tensor) -> torch.Tensor:
    """[S, n, 4] -> the trainer's [4, S, n] layout."""
    return a.permute(2, 0, 1).contiguous()


def init_weights(config: dict, gen: torch.Generator, device) -> dict:
    """{``lin{i}.weight`` [out, in], ``lin{i}.bias`` [out]}: U(+-1/sqrt(in))
    for every layer, one uniform draw for all weights and one for all
    biases."""
    shapes = ref_decoder.linear_shapes(config)
    n_w = sum(i * o for i, o in shapes)
    n_b = sum(o for _, o in shapes)
    w = torch.rand(n_w, generator=gen, device=device) * 2.0 - 1.0
    b = torch.rand(n_b, generator=gen, device=device) * 2.0 - 1.0
    params, at_w, at_b = {}, 0, 0
    for layer, (i, o) in enumerate(shapes):
        bound = 1.0 / math.sqrt(i)
        params[f"lin{layer}.weight"] = (w[at_w:at_w + i * o].reshape(o, i) * bound).contiguous()
        params[f"lin{layer}.bias"] = (b[at_b:at_b + o] * bound).contiguous()
        at_w += i * o
        at_b += o
    return params


def init_latents(n: int, size: int, std: float, gen: torch.Generator, device) -> torch.Tensor:
    """[n, size] latents N(0, std^2 / size), the trainer's CodeInitStdDev
    rule."""
    return torch.randn(n, size, generator=gen, device=device) * (std / math.sqrt(size))


def fit_family_decoder(config: dict, params: dict, gen: torch.Generator, family: int, steps: int,
                       points: int, lr: float) -> dict:
    """Adam steps (float32) on ``params`` and one latent per ellipsoid of a
    ``family`` drawn from ``gen``: each step ``points`` uniform points of
    [-1, 1]^3 split over the family, the L1 gap of the decoder's output to
    the ellipsoid's distance. Returns the fitted parameters (detached)."""
    dev = params["lin0.weight"].device
    latent_size = int(config["CodeLength"])
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    lat = (0.01 * torch.randn(family, latent_size, generator=gen, device=dev)).requires_grad_(True)
    axes = draw_axes(family, gen, dev)
    opt = torch.optim.Adam(list(p.values()) + [lat], lr=lr)
    per = points // family
    with ref_decoder.precision("float32"):
        for _ in range(steps):
            x = torch.rand(family, per, 3, generator=gen, device=dev) * 2.0 - 1.0
            target = ellipsoid_sdf(x, axes)
            pred = ref_decoder.forward(config, p, lat[:, None, :].expand(family, per, latent_size), x)
            loss = (pred - target).abs().mean()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
    return {k: v.detach() for k, v in p.items()}


def fixed_axes(n: int, seed: int) -> np.ndarray:
    """[n, 3] semi-axes of a fixed set of ellipsoids (the same for every
    run seed): U(0.35, 0.7) from ``seed``."""
    return np.random.default_rng(seed).uniform(0.35, 0.7, (n, 3)).astype(np.float32)
