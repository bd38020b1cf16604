"""PointNet-family point-cloud encoders as ``nn.Module``s (counterpart of
``msd_tpu/models/pointnet.py``; ref: networks/pointnet_encoder.py):

* ``PointNetEncoder`` (:58-116): the per-point 64-128-256-512 MLP, each
  layer Linear-BatchNorm-ReLU, a mean pool over the points (the
  reference's ``max_pool`` attribute is an AdaptiveAvgPool1d), and three
  heads ``fc_mu``, ``fc_logvar``, ``fc_z``, each Linear-BatchNorm-ReLU-Linear.
  With KL on only mu and logvar run, so ``fc_z``'s statistics stay put.
* ``ResnetPointnet`` (:119-186): the Occupancy-Networks encoder, five
  ResNet blocks with a max-pooled feature concatenated back after each of
  the first four, no BatchNorm; ``fc_1`` starts at zero, the heads at a
  plain normal (``fc_logvar`` at 0.01 times one) with zero biases.

Input [B, N, C]. ``forward`` returns (mu, logvar) with KL on, else z. The
BatchNorms keep running statistics (``models.common.BatchNorm`` with
``update_stats``): a training-mode forward folds its batch into them, as
``msd_tpu``'s ``bn_updates`` do once ``update_bn_stats`` applies them.
Submodule names follow ``msd_tpu``'s parameter tree, which
``params_from_jax`` maps.
"""

from __future__ import annotations

import torch
from torch import nn

from msd_tpu_torch.models.common import BatchNorm, Linear, linear_from_jax


def bn_from_jax(sd: dict, name: str, p: dict):
    """A BatchNorm's scale, bias and running statistics from ``msd_tpu``'s
    ``batch_norm_init`` dict."""
    sd[name + ".weight"] = torch.tensor(p["scale"])
    sd[name + ".bias"] = torch.tensor(p["bias"])
    sd[name + ".running_mean"] = torch.tensor(p["mean"])
    sd[name + ".running_var"] = torch.tensor(p["var"])


class BNHead(nn.Module):
    """Linear-BatchNorm-ReLU-Linear (``msd_tpu``'s ``fc_{mu,logvar,z}``)."""

    def __init__(self, in_dim, hidden, out_dim, generator=None):
        super().__init__()
        self.l1 = Linear(in_dim, hidden, generator)
        self.bn = BatchNorm(hidden, update_stats=True)
        self.l2 = Linear(hidden, out_dim, generator)

    def forward(self, x):
        return self.l2(torch.relu(self.bn(self.l1(x))))


def heads_from_jax(sd: dict, params: dict):
    for head in ("mu", "logvar", "z"):
        p = params[f"fc_{head}"]
        linear_from_jax(sd, f"fc_{head}.l1", p["l1"])
        bn_from_jax(sd, f"fc_{head}.bn", p["bn"])
        linear_from_jax(sd, f"fc_{head}.l2", p["l2"])


class PointNetEncoder(nn.Module):
    """ref: networks/pointnet_encoder.py:10-68. Input [B, N, C]."""

    WIDTHS = (64, 128, 256, 512)

    def __init__(self, latent_size, input_channels=3, kl_div_loss=False, generator=None):
        super().__init__()
        self.latent_size = latent_size
        self.kl_div_loss = bool(kl_div_loss)
        dims = (input_channels,) + self.WIDTHS
        self.convs = nn.ModuleList(Linear(dims[i], dims[i + 1], generator) for i in range(len(self.WIDTHS)))
        self.bns = nn.ModuleList(BatchNorm(w, update_stats=True) for w in self.WIDTHS)
        for head in ("mu", "logvar", "z"):
            setattr(self, f"fc_{head}", BNHead(512, 256, latent_size, generator))

    def forward(self, x):
        h = x.to(self.convs[0].weight.dtype)
        for conv, bn in zip(self.convs, self.bns):
            h = torch.relu(bn(conv(h)))
        pooled = h.mean(dim=1)  # AdaptiveAvgPool1d(1) (ref: :33, :61)
        if self.kl_div_loss:
            return self.fc_mu(pooled), self.fc_logvar(pooled)
        return self.fc_z(pooled)


def pointnet_encoder_from_jax(params) -> dict:
    """A ``state_dict`` for ``PointNetEncoder`` from ``msd_tpu``'s params
    (nested dicts of numpy arrays), running statistics included."""
    sd = {}
    for i, (conv, bn) in enumerate(zip(params["convs"], params["bns"])):
        linear_from_jax(sd, f"convs.{i}", conv)
        bn_from_jax(sd, f"bns.{i}", bn)
    heads_from_jax(sd, params)
    return sd


class ResnetBlockFC(nn.Module):
    """fc_0(relu(x)), fc_1(relu(.)) plus a bias-free linear shortcut when
    the width changes (ref: networks/pointnet_encoder.py:71-99)."""

    def __init__(self, size_in, size_out, generator=None):
        super().__init__()
        size_h = min(size_in, size_out)
        self.fc_0 = Linear(size_in, size_h, generator)
        self.fc_1 = Linear(size_h, size_out, generator)
        with torch.no_grad():
            self.fc_1.weight.zero_()  # nn.init.zeros_ (ref: :90)
        self.shortcut = None
        if size_in != size_out:
            self.shortcut = nn.Linear(size_in, size_out, bias=False)
            with torch.no_grad():
                self.shortcut.weight.copy_(Linear(size_in, size_out, generator).weight)

    def forward(self, x):
        dx = self.fc_1(torch.relu(self.fc_0(torch.relu(x))))
        return (self.shortcut(x) if self.shortcut is not None else x) + dx


class ResnetPointnet(nn.Module):
    """ref: networks/pointnet_encoder.py:102-157. Input [B, N, 3]."""

    def __init__(self, latent_size=16, kl_div_loss=False, dim=3, hidden_dim=128, generator=None):
        super().__init__()
        h = hidden_dim
        self.latent_size = latent_size
        self.kl_div_loss = bool(kl_div_loss)
        self.fc_pos = Linear(dim, 2 * h, generator)
        self.blocks = nn.ModuleList(ResnetBlockFC(2 * h, h, generator) for _ in range(5))
        # the heads' explicit inits (ref: :122-127)
        for name, scale in (("fc_c", 1.0), ("fc_mu", 1.0), ("fc_logvar", 0.01)):
            head = nn.Linear(h, latent_size)
            with torch.no_grad():
                head.weight.copy_(scale * torch.randn(latent_size, h, generator=generator))
                head.bias.zero_()
            setattr(self, name, head)

    def forward(self, p):
        net = self.fc_pos(p.to(self.fc_pos.weight.dtype))  # [B, N, 2h]
        for i, block in enumerate(self.blocks):
            net = block(net)
            if i < 4:
                pooled = net.max(dim=1, keepdim=True).values
                net = torch.cat([net, pooled.expand_as(net)], dim=2)
        act = torch.relu(net.max(dim=1).values)  # [B, h]
        if self.kl_div_loss:
            return self.fc_mu(act), self.fc_logvar(act)
        return self.fc_c(act)


def resnet_pointnet_from_jax(params) -> dict:
    """A ``state_dict`` for ``ResnetPointnet`` from ``msd_tpu``'s params."""
    sd = {}
    linear_from_jax(sd, "fc_pos", params["fc_pos"])
    for i in range(5):
        block = params[f"block_{i}"]
        for name in ("fc_0", "fc_1", "shortcut"):
            if name in block:
                linear_from_jax(sd, f"blocks.{i}.{name}", block[name])
    for name in ("fc_c", "fc_mu", "fc_logvar"):
        linear_from_jax(sd, name, params[name])
    return sd
