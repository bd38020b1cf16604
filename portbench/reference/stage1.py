"""Stage-1 training steps of a DeepSDF auto-decoder in plain PyTorch.

What one step of the trainer does, written again from its description
(Park et al., CVPR 2019, and the examples' ``specs.json``): the CodeBound
renorm of the batch's latent rows, a balanced positive / negative point
draw in chunklets of the pre-shuffled sample sets, the clamped L1 over all
points plus 0.002 times the eikonal mean (1 - |d clamp(f) / dx|)^2 over all
points, the code regulariser lambda min(1, epoch / 100) sum |z| / B, the
decoder's gradient clipped to ``GradientClipNorm``, and one Adam step (b1
0.9, b2 0.999, eps 1e-8 after the square root, bias corrections in
float32) of two groups: the decoder at the first learning-rate schedule,
the whole latent table at the second. The decoder runs in ``mode`` (``decoder.MODES``), in blocks of
``SCENE_BLOCK`` scenes so that its double backward fits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import decoder as ref_decoder

B1, B2, EPS = 0.9, 0.999, 1e-8
EIK_WEIGHT = 0.002
# scenes of a batch that go through the decoder's double backward at once
SCENE_BLOCK = 8


def step_seed(seed: int, step: int) -> int:
    """Seed of the point draw of global step ``step`` (1-based)."""
    return (int(seed) * 1_000_003 + int(step)) % (2**63)


def sample_batch(pos, pos_counts, neg, neg_counts, scene_indices, subsample: int, gen: torch.Generator,
                 chunk: int = 128) -> torch.Tensor:
    """[4, B, subsample]: per scene ``subsample // 2`` positive then the
    rest negative rows, drawn as chunklets of gcd(rows, ``chunk``)
    consecutive rows of the scene's set ([4, S, Pmax]); a chunklet index is
    floor(u * chunklets), u uniform, capped at the last."""
    half = subsample // 2
    b = scene_indices.shape[0]

    def draw(arr, counts, n_rows):
        r = max(math.gcd(n_rows, chunk), 1)
        n_chunklets = arr.shape[2] // r
        cc = ((counts[scene_indices] + r - 1) // r).clamp(1, n_chunklets)
        u = torch.rand(b, n_rows // r, generator=gen, device=arr.device)
        ic = torch.minimum((u * cc[:, None]).long(), cc[:, None] - 1)
        ids = (scene_indices[:, None] * n_chunklets + ic).reshape(-1)
        return arr[:, :, : n_chunklets * r].reshape(4, -1, r)[:, ids].reshape(4, b, n_rows)

    return torch.cat([draw(pos, pos_counts, half), draw(neg, neg_counts, subsample - half)], dim=2)


def code_bound(rows: torch.Tensor, bound) -> torch.Tensor:
    if bound is None:
        return rows
    norms = torch.linalg.vector_norm(rows, dim=-1, keepdim=True)
    return rows * torch.clamp(bound / (norms + 1e-12), max=1.0)


def safe_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.sqrt(torch.clamp((x * x).sum(dim=dim), min=1e-24))


def learning_rates(config: dict, epoch: int) -> tuple[float, float]:
    """(decoder, latent) learning rates of ``epoch`` under Step schedules."""
    out = []
    for s in config["LearningRateSchedule"]:
        if s["Type"] != "Step":
            raise NotImplementedError(f"schedule {s['Type']!r}")
        out.append(s["Initial"] * s["Factor"] ** (epoch // s["Interval"]))
    return out[0], out[1]


class Stage1Reference:
    """The trainer's state as plain tensors: ``params`` (decoder),
    ``latents`` [S, L] and Adam's moments; ``step`` advances it by one
    training step."""

    def __init__(self, config: dict, params: dict, latents: torch.Tensor, mode: str = "float32",
                 half_batch: bool = False, moments=None):
        """``moments`` is Adam's (first moments, second moments, step count)
        by group and leaf to start from; None starts at zero. ``half_batch``
        plants a fault: the loss leaves out the second half of each batch's
        scenes and takes its means over the rest."""
        self.config = config
        self.mode = mode
        self.half_batch = half_batch
        self.groups = {"net": {k: v.detach().clone().float() for k, v in params.items()},
                       "lat": {"weight": latents.detach().clone().float()}}
        if moments is None:
            self.mu = {g: {k: torch.zeros_like(v) for k, v in ps.items()} for g, ps in self.groups.items()}
            self.nu = {g: {k: torch.zeros_like(v) for k, v in ps.items()} for g, ps in self.groups.items()}
            self.count = 0
        else:
            mu, nu, self.count = moments
            self.mu, self.nu = ({g: {k: v.detach().clone().float() for k, v in xs[g].items()} for g in self.groups}
                                for xs in (mu, nu))

    def losses_and_grads(self, scene_idx, batch, epoch: int):
        """(total loss, {group: {leaf: gradient}}) of one step on ``batch``
        [4, B, P] of the scenes ``scene_idx``, after the CodeBound renorm
        of their rows (which it applies to the table)."""
        cfg = self.config
        c = float(cfg["ClampingDistance"])
        B, P = batch.shape[1], batch.shape[2]
        n_total = B * P
        B_loss = B // 2 if self.half_batch else B
        if self.half_batch:
            n_total //= 2
        table = self.groups["lat"]["weight"]
        table[scene_idx] = code_bound(table[scene_idx], cfg.get("CodeBound"))
        params = {k: v.detach().requires_grad_(True) for k, v in self.groups["net"].items()}
        rows = table[scene_idx].detach().requires_grad_(True)
        xyz_all = batch[:3].permute(1, 2, 0)
        gt_all = batch[3].clamp(-c, c)
        total = torch.zeros((), device=table.device, dtype=torch.float64)
        with ref_decoder.precision(self.mode):
            for s0 in range(0, B_loss, SCENE_BLOCK):
                s1 = min(B_loss, s0 + SCENE_BLOCK)
                x = xyz_all[s0:s1].detach().requires_grad_(True)
                pred = ref_decoder.forward(cfg, params, rows[s0:s1, None, :], x, self.mode).clamp(-c, c)
                loss = (pred - gt_all[s0:s1]).abs().sum() / n_total
                if cfg.get("UseEikonal", False):
                    (g,) = torch.autograd.grad(pred.sum(), x, create_graph=True)
                    loss = loss + EIK_WEIGHT * ((1.0 - safe_norm(g)) ** 2).sum() / n_total
                loss.backward()
                total += loss.detach().double()
        extra = torch.zeros((), device=table.device)
        if cfg.get("CodeRegularization", True):
            lam = float(cfg.get("CodeRegularizationLambda", 1e-4)) * min(1.0, epoch / 100.0)
            extra = extra + lam * safe_norm(rows, dim=1).sum() / B
        if extra.requires_grad:
            extra.backward()
        total += extra.detach().double()
        lat_grad = torch.zeros_like(table)
        lat_grad[scene_idx] = rows.grad
        grads = {"net": {k: v.grad for k, v in params.items()}, "lat": {"weight": lat_grad}}
        return float(total), grads

    @torch.no_grad()
    def adam(self, grads: dict, lrs: dict, max_norm) -> dict:
        """Clip the decoder group, then one Adam step; returns the
        gradients as the optimizer took them (after the clip)."""
        self.count += 1
        t = np.float32(self.count)
        bc1 = float(np.float32(1.0) - np.float32(B1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(B2) ** t)
        taken = {}
        for g, params in self.groups.items():
            gs = grads[g]
            if g == "net" and max_norm is not None:
                norm = torch.sqrt(sum((x.float() ** 2).sum() for x in gs.values()))
                scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
                gs = {k: x * scale for k, x in gs.items()}
            taken[g] = gs
            for k, p in params.items():
                m, v, x = self.mu[g][k], self.nu[g][k], gs[k]
                m.mul_(B1).add_((1.0 - B1) * x)
                v.mul_(B2).add_((1.0 - B2) * (x * x))
                p.sub_(lrs[g] * (m / bc1) / (torch.sqrt(v / bc2) + EPS))
        return taken

    def step(self, scene_idx, batch, epoch: int):
        """One training step; returns (the step's loss, the gradients the
        optimizer took)."""
        lr_net, lr_lat = learning_rates(self.config, epoch)
        loss, grads = self.losses_and_grads(scene_idx, batch, epoch)
        taken = self.adam(grads, {"net": lr_net, "lat": lr_lat}, self.config.get("GradientClipNorm"))
        return loss, taken

    def leaves(self) -> dict:
        """{``group/leaf``: tensor} of the current parameters."""
        return {f"{g}/{k}": v for g, ps in self.groups.items() for k, v in ps.items()}
