"""PointNet++ set-abstraction encoder (counterpart of
``msd_tpu/models/pointnet2.py``; ref: networks/pointnet2_encoder.py:6-173):
farthest-point sampling, a radius ball query, grouped per-point MLPs with
BatchNorm and a max pool over each group, then a group-all abstraction and
the mu/logvar/z heads.

Randomness: ``msd_tpu`` draws each FPS's start index from a JAX key
(``farthest_point_sample``, :30-33). Here the start indices are an
argument, a ``LongTensor`` [B] per abstraction, or are drawn from a
``torch.Generator``, so a test can hand the port ``msd_tpu``'s draws.

FPS is sequential, as in the reference: one iteration per sampled point,
each a handful of tensor operations on the tensors' device. Its squared
distances are summed x, then y, then z, in separate operations, so the
CPU and the card pick the same points.
"""

from __future__ import annotations

import torch
from torch import nn

from msd_tpu_torch.models.common import BatchNorm, Linear, linear_from_jax
from msd_tpu_torch.models.pointnet import BNHead, bn_from_jax, heads_from_jax


def square_distance(src, dst):
    """[B, S, 3] x [B, N, 3] -> [B, S, N], in the expanded form
    |s|^2 + |d|^2 - 2 s.d (ref: :6-11)."""
    return (src**2).sum(dim=-1, keepdim=True) + (dst**2).sum(dim=-1)[:, None, :] - 2.0 * src @ dst.transpose(1, 2)


def index_points(points, idx):
    """points [B, N, C], idx [B, ...] -> [B, ..., C] (ref: :14-22)."""
    b = points.shape[0]
    batch = torch.arange(b, device=points.device).reshape((b,) + (1,) * (idx.dim() - 1))
    return points[batch, idx]


def farthest_point_sample(xyz, npoint: int, start):
    """[B, N, 3] -> [B, npoint] indices (ref: :25-39), starting at
    ``start`` [B] (long). With npoint > N the distances fall to zero and
    argmax's first maximum repeats index 0, as in ``msd_tpu``."""
    b, n, _ = xyz.shape
    centroids = torch.empty(b, npoint, dtype=torch.long, device=xyz.device)
    distance = torch.full((b, n), 1e10, dtype=xyz.dtype, device=xyz.device)
    batch = torch.arange(b, device=xyz.device)
    farthest = start.to(device=xyz.device, dtype=torch.long)
    for i in range(npoint):
        centroids[:, i] = farthest
        d = xyz - xyz[batch, farthest][:, None, :]
        d = d * d
        distance = torch.minimum(distance, d[..., 0] + d[..., 1] + d[..., 2])
        farthest = distance.argmax(dim=-1)
    return centroids


def query_ball_point(radius: float, nsample: int, xyz, new_xyz):
    """[B, S] centres -> [B, S, nsample] neighbour indices (ref: :42-53):
    the first ``nsample`` indices within ``radius`` in index order, short
    rows padded with their first, a centre with none at index 0. The sort
    puts the sentinel n last; every other index is unique, so stability
    does not matter."""
    b, n, _ = xyz.shape
    s = new_xyz.shape[1]
    sqrdists = square_distance(new_xyz, xyz)
    group_idx = torch.arange(n, device=xyz.device).expand(b, s, n)
    group_idx = torch.where(sqrdists > radius * radius, n, group_idx)
    group_idx = torch.sort(group_idx, dim=-1).values[:, :, :nsample]
    group_idx = torch.where(group_idx == n, group_idx[:, :, :1], group_idx)
    return torch.clamp(group_idx, max=n - 1)


def sample_and_group(npoint, radius, nsample, xyz, points, start):
    """(new_xyz [B, S, 3], new_points [B, S, K, 3 + C]) (ref: :56-67)."""
    new_xyz = index_points(xyz, farthest_point_sample(xyz, npoint, start))
    idx = query_ball_point(radius, nsample, xyz, new_xyz)
    grouped = index_points(xyz, idx) - new_xyz[:, :, None, :]
    if points is not None:
        grouped = torch.cat([grouped, index_points(points, idx)], dim=-1)
    return new_xyz, grouped


class SetAbstraction(nn.Module):
    """Per-point Linear-BatchNorm-ReLU layers over [B, S, K, C], then a max
    over the group axis K."""

    def __init__(self, in_ch, widths, generator=None):
        super().__init__()
        dims = (in_ch,) + tuple(widths)
        self.convs = nn.ModuleList(Linear(dims[i], dims[i + 1], generator) for i in range(len(widths)))
        self.bns = nn.ModuleList(BatchNorm(w, update_stats=True) for w in widths)

    def forward(self, h, group=None):
        for conv, bn in zip(self.convs, self.bns):
            h = torch.relu(bn(conv(h), group))
        return h.max(dim=2).values


class PointNet2Encoder(nn.Module):
    """ref: networks/pointnet2_encoder.py:119-173. Input [B, N, >= 3]."""

    SA_CONFIG = [
        dict(npoint=512, radius=0.2, nsample=32, mlp=[64, 64, 128]),
        dict(npoint=128, radius=0.4, nsample=64, mlp=[128, 128, 256]),
        dict(npoint=None, radius=None, nsample=None, mlp=[256, 512, 1024]),
    ]

    def __init__(self, latent_size, input_channels=3, kl_div_loss=False, generator=None):
        super().__init__()
        self.latent_size = latent_size
        self.kl_div_loss = bool(kl_div_loss)
        layers, in_ch = [], input_channels
        for cfg in self.SA_CONFIG:
            layers.append(SetAbstraction(in_ch, cfg["mlp"], generator))
            in_ch = cfg["mlp"][-1] + 3
        self.sa = nn.ModuleList(layers)
        for head in ("mu", "logvar", "z"):
            setattr(self, f"fc_{head}", BNHead(1024, 512, latent_size, generator))

    def draw_starts(self, x, generator=None):
        """FPS start indices of both sampled abstractions: [B] in [0, N) and
        [B] in [0, 512), drawn from ``generator`` on the input's device."""
        b, n = x.shape[:2]
        kw = dict(generator=generator, device=x.device)
        return (torch.randint(0, n, (b,), **kw), torch.randint(0, self.SA_CONFIG[0]["npoint"], (b,), **kw))

    def forward(self, x, fps_start=None, generator=None, group=None):
        """``fps_start``: (start1 [B], start2 [B]), drawn from ``generator``
        when not given. ``group``: the BatchNorms' ranks
        (``models.common.BatchNorm``); FPS and the ball query run per
        scene on this rank's clouds."""
        x = x.to(self.sa[0].convs[0].weight.dtype)
        start1, start2 = fps_start if fps_start is not None else self.draw_starts(x, generator)
        xyz = x[:, :, :3]
        points = x[:, :, 3:] if x.shape[2] > 3 else None
        cfg1, cfg2 = self.SA_CONFIG[0], self.SA_CONFIG[1]
        xyz1, grouped = sample_and_group(cfg1["npoint"], cfg1["radius"], cfg1["nsample"], xyz, points, start1)
        feat1 = self.sa[0](grouped, group)
        xyz2, grouped = sample_and_group(cfg2["npoint"], cfg2["radius"], cfg2["nsample"], xyz1, feat1, start2)
        feat2 = self.sa[1](grouped, group)
        # group all (ref: :70-80): [B, 1, S, 3 + C] -> [B, 1, 1024]
        global_feat = self.sa[2](torch.cat([xyz2, feat2], dim=-1)[:, None], group)[:, 0]
        if self.kl_div_loss:
            return self.fc_mu(global_feat, group), self.fc_logvar(global_feat, group)
        return self.fc_z(global_feat, group)


def pointnet2_from_jax(params) -> dict:
    """A ``state_dict`` for ``PointNet2Encoder`` from ``msd_tpu``'s params,
    running statistics included."""
    sd = {}
    for si, layer in enumerate(params["sa"]):
        for ci, (conv, bn) in enumerate(zip(layer["convs"], layer["bns"])):
            linear_from_jax(sd, f"sa.{si}.convs.{ci}", conv)
            bn_from_jax(sd, f"sa.{si}.bns.{ci}", bn)
    heads_from_jax(sd, params)
    return sd
