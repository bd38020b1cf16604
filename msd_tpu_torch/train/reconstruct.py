"""Per-shape latent-code optimisation ("reconstruction").

Counterpart of ``msd_tpu/train/reconstruct.py`` (ref: reconstruct.py:16-151)
with the semantics of its ``_reconstruct_scan_impl``: each iteration draws a
balanced half-positive / half-negative batch with replacement, runs the
frozen decoder, takes the clamped L1 of the clipped prediction plus the
latent regularisers, and steps Adam (torch semantics, t = it+1, eps after
the square root) on the latent only; the learning rate drops by 10 every
``iters // 2`` steps and ``code_bound`` projects the latent after each step.

The JAX package runs this as one ``lax.scan`` with no Pallas kernel;
here it is a Python loop, the batch of shapes written out as a leading
axis. Each iteration's clamped L1 and its latent gradient take one of two
routes (``ops/fused_fit.route``, from the device and the decoder's form):
on the card, for decoders of the flagship form, the float32 kernels of
``ops/fused_fit.py``; else autograd through the decoder
(``autograd_l1``). ``FIT_ITERATIONS`` counts the iterations of each.
Products run in float32 on every device: ``resolve_device`` turns TF32
off on the card.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from msd_tpu_torch.ops import fused_fit
from msd_tpu_torch.utils.optim import project_code_bound
from msd_tpu_torch.utils.spans import span

# Fit iterations (``reconstruct_loss`` calls) by route: "kernel" (the fused
# float32 kernels on the card) or "autograd"; callers reset them to count a run's.
FIT_ITERATIONS = {"kernel": 0, "autograd": 0}


class ReconstructConfig(NamedTuple):
    num_iterations: int
    latent_size: int
    clamp_dist: float
    num_samples: int
    lr: float
    l2reg: bool
    code_reg_lambda: Optional[float] = None
    code_reg_type: str = "l2_sq"
    code_bound: Optional[float] = None
    dist_weight: float = 0.0
    dist_type: str = "zscore_l2"


class _ShapeRows(torch.autograd.Function):
    """(latent [S, 1, L], xyz [S, n, 3]) -> decoder inputs [S, n, L + 3].
    The backward sums each shape's n row gradients by a reduction of its
    own, so a shape's latent gradient has the same bits whatever other
    shapes share the batch: one reduction over [S, n, L] splits its rows
    by S's size on the card, and Adam's normalised steps carry a one-ulp
    difference through the fit (0.06 apart after 800 iterations on the
    H100). Serving over ranks relies on it (``reconstruct_batch(group=)``
    gives one process's latents)."""

    @staticmethod
    def forward(ctx, latent, xyz):
        S, n, _ = xyz.shape
        ctx.latent_size = latent.shape[2]
        return torch.cat([latent.expand(S, n, latent.shape[2]), xyz], dim=2)

    @staticmethod
    def backward(ctx, grad):
        rows = grad[..., : ctx.latent_size]
        return torch.stack([rows[i].sum(0, keepdim=True) for i in range(rows.shape[0])]), None


def autograd_l1(decoder, latent, batch, clamp_dist: float):
    """The autograd route: latent [S, 1, L], batch [S, n, 4] -> per-shape
    mean of |clamp(decoder) - clamp(sdf)| [S], through the decoder's
    modules on ``[latent || xyz]`` rows."""
    S, n = batch.shape[:2]
    c = clamp_dist
    sdf_gt = batch[..., 3:4].clamp(-c, c)
    inputs = _ShapeRows.apply(latent, batch[..., :3])
    pred = decoder(inputs.reshape(S * n, -1)).reshape(S, n, 1).clamp(-c, c)
    return (pred - sdf_gt).abs().mean(dim=(1, 2))


def reconstruct_loss(decoder, cfg: ReconstructConfig, latent, batch, dist_mean, dist_std):
    """latent [S, 1, L], batch [S, n, 4] -> per-shape loss [S]."""
    if fused_fit.route(decoder, latent) == "kernel":
        FIT_ITERATIONS["kernel"] += 1
        loss = fused_fit.fit_loss(fused_fit.plan_for(decoder), latent, batch, cfg.clamp_dist)
    else:
        FIT_ITERATIONS["autograd"] += 1
        loss = autograd_l1(decoder, latent, batch, cfg.clamp_dist)
    # latent regularisation (ref: reconstruct.py:106-116)
    if cfg.code_reg_lambda is not None and cfg.code_reg_lambda > 0.0:
        if cfg.code_reg_type.lower() in ("l2_norm", "l2norm", "norm"):
            norms = torch.sqrt(torch.clamp((latent**2).sum(dim=2), min=1e-24))
            loss = loss + cfg.code_reg_lambda * norms.mean(dim=1)
        else:
            loss = loss + cfg.code_reg_lambda * (latent**2).mean(dim=(1, 2))
    elif cfg.l2reg:
        loss = loss + 1e-4 * (latent**2).mean(dim=(1, 2))
    if cfg.dist_weight > 0.0:
        diff = (latent - dist_mean) / dist_std
        if cfg.dist_type.lower() in ("l1", "abs"):
            loss = loss + cfg.dist_weight * diff.abs().mean(dim=(1, 2))
        else:
            loss = loss + cfg.dist_weight * (diff**2).mean(dim=(1, 2))
    return loss


def reconstruct_step(decoder, cfg: ReconstructConfig, latent, m, v, it: int, batch, dist_mean, dist_std):
    """One Adam step on the latents [S, 1, L] given the batch [S, n, 4];
    returns (latent, m, v, loss [S] before the step)."""
    latent = latent.detach().requires_grad_(True)
    loss = reconstruct_loss(decoder, cfg, latent, batch, dist_mean, dist_std)
    (g,) = torch.autograd.grad(loss.sum(), latent)
    with torch.no_grad():
        lr = cfg.lr * 0.1 ** (it // max(1, cfg.num_iterations // 2))
        t = it + 1
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * (g * g)
        mhat = m / (1 - 0.9**t)
        vhat = v / (1 - 0.999**t)
        latent = latent - lr * mhat / (torch.sqrt(vhat) + 1e-8)
        if cfg.code_bound is not None and cfg.code_bound > 0:
            latent = project_code_bound(latent, cfg.code_bound)
    return latent.detach(), m, v, loss.detach()


@contextlib.contextmanager
def _frozen(decoder):
    """Eval mode and no weight gradients for the duration of a fit."""
    was_training = decoder.training
    flags = [p.requires_grad for p in decoder.parameters()]
    decoder.eval()
    for p in decoder.parameters():
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, f in zip(decoder.parameters(), flags):
            p.requires_grad_(f)
        decoder.train(was_training)


def reconstruct_batch(
    decoder,
    num_iterations,
    latent_size,
    test_sdfs,
    stat,
    clamp_dist,
    num_samples=30000,
    lr=5e-4,
    l2reg=False,
    code_reg_lambda=None,
    code_reg_type="l2_sq",
    code_bound=None,
    dist_mean=None,
    dist_std=None,
    dist_weight=0.0,
    dist_type="zscore_l2",
    seed=0,
    return_loss_hist=False,
    group=None,
):
    """Fit latents for ``len(test_sdfs)`` shapes at once.

    test_sdfs: list of (pos [Pi, 4], neg [Ni, 4]) arrays. Shape i draws its
    initial latent and every batch from its own generator seeded
    ``seed + i``, so it fits exactly as ``reconstruct(..., seed=seed+i)``
    would. Returns (final losses [S] or loss history [S, iters] as numpy,
    latents [S, L] on the decoder's device).

    ``group`` (a ``DataParallelGroup``; counterpart of ``msd_tpu``'s
    ``mesh=``): each rank fits its contiguous slice of the shapes
    (``group.row_slice``), shape i still from the generator seeded
    ``seed + i``, so its latents are bit for bit what one process gives
    fitting that slice with ``seed + start``. No collective runs during the
    fit; at the end every rank gathers every shape's losses and latents and
    returns what one process returns, in shape order. Every rank calls it
    with the same arguments.

    Spans (``utils/spans.py``): ``fit`` around the call, ``fit.upload``
    (the shapes to the device), ``fit.iterations`` (the loop; no span per
    iteration: the loop runs behind a full launch queue, where a host span
    would read the device's pace) and ``fit.fetch`` (the losses to the
    host)."""
    cfg = ReconstructConfig(
        num_iterations=int(num_iterations),
        latent_size=int(latent_size),
        clamp_dist=float(clamp_dist),
        num_samples=int(num_samples),
        lr=float(lr),
        l2reg=bool(l2reg),
        code_reg_lambda=None if code_reg_lambda is None else float(code_reg_lambda),
        code_reg_type=str(code_reg_type),
        code_bound=None if code_bound is None else float(code_bound),
        dist_weight=float(dist_weight) if dist_weight else 0.0,
        dist_type=str(dist_type),
    )
    with span("fit"):
        dev = next(decoder.parameters()).device
        part = slice(0, len(test_sdfs)) if group is None else group.row_slice(len(test_sdfs))
        if part.stop > part.start:
            hist, latents = _fit_batch(decoder, cfg, test_sdfs, part, stat, dist_mean, dist_std, int(seed), dev)
        else:
            hist = torch.zeros(0, cfg.num_iterations, device=dev)
            latents = torch.zeros(0, cfg.latent_size, device=dev)
        if group is not None:
            hist, latents = group.all_gather_rows(hist), group.all_gather_rows(latents)
        with span("fit.fetch"):
            hist = hist.cpu().numpy()
    return (hist if return_loss_hist else hist[:, -1]), latents


def _fit_batch(decoder, cfg: ReconstructConfig, test_sdfs, part: slice, stat, dist_mean, dist_std, seed, dev):
    """``reconstruct_batch``'s fit of the shapes ``test_sdfs[part]`` on one
    device: (loss history [S, iters], latents [S, L]) on ``dev``."""
    latent_size = cfg.latent_size
    pos, neg = [], []
    with span("fit.upload"):
        for si in range(part.start, part.stop):
            p, n = test_sdfs[si]
            if p.shape[0] == 0 or n.shape[0] == 0:
                raise ValueError(
                    f"reconstruct shape {si} needs both sample signs: "
                    f"got {p.shape[0]} pos / {n.shape[0]} neg"
                )
            pos.append(torch.as_tensor(np.asarray(p, np.float32), device=dev))
            neg.append(torch.as_tensor(np.asarray(n, np.float32), device=dev))
    gens = [torch.Generator(device=dev).manual_seed(seed + i) for i in range(part.start, part.stop)]
    S = len(gens)

    def normal(g):
        return torch.randn(1, latent_size, generator=g, device=dev)

    if isinstance(stat, float):
        init = torch.stack([stat * normal(g) for g in gens])
    else:
        mean, std = (torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(1, -1) for x in stat)
        init = torch.stack([mean + std * normal(g) for g in gens])
    dm = torch.zeros(1, 1, latent_size, device=dev) if dist_mean is None else (
        torch.as_tensor(dist_mean, dtype=torch.float32, device=dev).reshape(1, 1, -1))
    ds = torch.ones(1, 1, latent_size, device=dev) if dist_std is None else (
        torch.as_tensor(dist_std, dtype=torch.float32, device=dev).reshape(1, 1, -1).clamp(min=1e-8))

    half = cfg.num_samples // 2
    other = cfg.num_samples - half

    def draw(i):
        g = gens[i]
        ip = torch.randint(0, pos[i].shape[0], (half,), generator=g, device=dev)
        ineg = torch.randint(0, neg[i].shape[0], (other,), generator=g, device=dev)
        return torch.cat([pos[i][ip], neg[i][ineg]], dim=0)

    latent = init
    m = torch.zeros_like(latent)
    v = torch.zeros_like(latent)
    hist = torch.empty(cfg.num_iterations, S, device=dev)
    with _frozen(decoder), span("fit.iterations"):
        for it in range(cfg.num_iterations):
            batch = torch.stack([draw(i) for i in range(S)])
            latent, m, v, hist[it] = reconstruct_step(decoder, cfg, latent, m, v, it, batch, dm, ds)
    return hist.t().contiguous(), latent[:, 0, :]


def reconstruct(
    decoder,
    num_iterations,
    latent_size,
    test_sdf,
    stat,
    clamp_dist,
    num_samples=30000,
    lr=5e-4,
    l2reg=False,
    code_reg_lambda=None,
    code_reg_type="l2_sq",
    code_bound=None,
    return_loss_hist=False,
    dist_mean=None,
    dist_std=None,
    dist_weight=0.0,
    dist_type="zscore_l2",
    seed=0,
):
    """Reference-compatible signature (ref: reconstruct.py:16-151).
    test_sdf: (pos [P, 4], neg [N, 4]). Returns (final loss or loss
    history list, latent [1, L])."""
    losses, latents = reconstruct_batch(
        decoder, num_iterations, latent_size, [tuple(test_sdf)], stat, clamp_dist,
        num_samples=num_samples, lr=lr, l2reg=l2reg, code_reg_lambda=code_reg_lambda,
        code_reg_type=code_reg_type, code_bound=code_bound, dist_mean=dist_mean,
        dist_std=dist_std, dist_weight=dist_weight, dist_type=dist_type, seed=seed,
        return_loss_hist=True,
    )
    hist = losses[0]
    return (hist.tolist() if return_loss_hist else float(hist[-1])), latents[:1]
