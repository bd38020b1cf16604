"""Operation counts of the port's kernels, computed from a configuration's
widths, and the published peaks they are held against.

Frozen here so that a change to the program cannot move the yardstick: the
counts read only ``NetworkSpecs`` and ``CodeLength``, never the program's
own layer plan. A count is the work the algorithm needs, 2 operations per
multiply-add; products with the latent, which are the same for every point
of a scene or shape, are left out, as the kernels fold them into one
per-layer constant.

Peaks: one NVIDIA H100 SXM, dense rates without sparsity, at its 700 W
limit (NVIDIA's data sheet).
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12

# K2 b's sweeps of every per-point product: the primal, the u-chain, the
# t-chain, the delta chain and the two weight-gradient sums.
K2_SWEEPS = {"b": 6, "a": 3, "d": 2}


def layer_shapes(config: dict) -> list[tuple[int, int, int]]:
    """(input width, output width, latent columns of the input) of each
    linear layer of the DeepSDF decoder that ``config`` describes: hidden
    ``dims``, a last layer of width 1, and the latent and xyz concatenated
    again before each layer of ``latent_in`` (the layer before it shrinks
    by the latent's and xyz's width)."""
    net = config["NetworkSpecs"]
    if net.get("xyz_in_all") or net.get("norm_layers"):
        raise ValueError("counts: xyz_in_all and norm layers are not counted")
    latent = int(config["CodeLength"])
    dims = [latent + 3] + [int(d) for d in net["dims"]] + [1]
    latent_in = set(net.get("latent_in") or ())
    shapes = []
    for layer in range(len(dims) - 1):
        out = dims[layer + 1] - (dims[0] if layer + 1 in latent_in else 0)
        lat_cols = latent if layer == 0 or layer in latent_in else 0
        shapes.append((dims[layer], out, lat_cols))
    return shapes


def point_macs(config: dict) -> int:
    """Multiply-adds of one point through the decoder, the latent's
    columns left out: 1,573,376 at the flagship width (the xyz columns of
    layer 0 and of the ``latent_in`` layer, 3 x 512 each, included)."""
    return sum((i - lat) * o for i, o, lat in layer_shapes(config))


def input_grad_macs(config: dict) -> int:
    """Multiply-adds of one point's backward to the latent: the gradient
    through every hidden input column of layers 1 and up. The latent's
    gradient is the sum over points of the latent columns' share, one
    product per shape and iteration, so it is not counted per point."""
    total = 0
    for layer, (i, o, lat) in enumerate(layer_shapes(config)):
        if layer == 0:
            continue
        total += (i - lat - (3 if lat else 0)) * o
    return total


def k2_flops(config: dict, n_points: int, variant: str = "b") -> float:
    """Operations of K2 ``variant`` over ``n_points``: 18.9 MFLOP a point
    in variant b at the flagship width."""
    return 2.0 * point_macs(config) * K2_SWEEPS[variant] * n_points


def k1_flops(config: dict, n_points: int) -> float:
    """Operations of K1 (the decoder's forward) over ``n_points``."""
    return 2.0 * point_macs(config) * n_points


def fit_flops(config: dict, n_points: int) -> float:
    """Operations of one latent fit iteration over ``n_points``: the
    forward and the backward to the latent, about 6.3 MFLOP a point at the
    flagship width."""
    return 2.0 * (point_macs(config) + input_grad_macs(config)) * n_points


def decoder_params(config: dict) -> int:
    """Weights and biases of the decoder."""
    return sum(i * o + o for i, o, _ in layer_shapes(config))


def k2_io_bytes(config: dict, scenes: int, points_per_scene: int) -> float:
    """Bytes K2 must read and write once per step: xyz and the SDF target
    (float32), the bf16 weights, the scenes' latent rows, and the float32
    weight, bias and latent gradients with the two loss sums."""
    n = scenes * points_per_scene
    latent = int(config["CodeLength"])
    params = decoder_params(config)
    return 16.0 * n + 2.0 * params + 4.0 * scenes * latent + 4.0 * params + 4.0 * scenes * latent + 8.0


def least_seconds(flops: float, io_bytes: float, dtype: str) -> float:
    """The least time the chip could take: the larger of the operations at
    the peak of ``dtype`` and the bytes at the HBM bandwidth."""
    return max(flops / PEAK_FLOPS[dtype], io_bytes / HBM_BYTES_PER_S)
