"""The latent fit's per-shape loss and latent gradient, on Hopper in float32.

Replaces no TPU kernel: the JAX package runs the reconstruct loop as a
``lax.scan`` of XLA operations (``msd_tpu/train/reconstruct.py``). On the
card this takes the place of the fit iteration's autograd route (float32
library products over ``[latent || xyz]`` rows and about 20 elementwise,
copy and reduction kernels) with the mathematics of K2 variant d, the
frozen decoder, in exact float32: the latent enters only through per-shape
constants ``c_l = W_l[:, latent] z + b_l`` (layer 0 and each ``latent_in``
layer), so no point multiplies the latent's columns, and its gradient is
``sum_l W_l[:, latent]^T colsum_l`` of the delta chain's per-shape column
sums, so no input gradient is formed. The kernels are
``msd_tpu_torch/csrc/fused_fit.cu``, which says what bounds them.

``fold`` lays the decoder out once per set of weights (``plan_for`` caches
it until a parameter changes): hidden-input weights transposed for the
forward and as they are for the backward, zero-padded to multiples of
``WIDTH_PAD``; xyz weights; the latent's columns both ways; biases.
Activations are feature-major ``[width, S x P]``, each shape's rows padded
to ``P``, a multiple of ``TILE``, so no tile spans two shapes and a shape's
loss and gradient have the same bits whatever shapes share the batch.

``FitLoss`` is the autograd function: forward gives the per-shape clamped
L1 [S], backward the latent's gradient. On a CUDA tensor it launches the
kernels or raises; on a CPU tensor it runs ``forward_plain`` and
``backward_plain``, the same arithmetic on the same folded operands in
PyTorch. ``route`` says which decoders and tensors the reconstruct loop
sends here.
"""

from __future__ import annotations

import contextlib
import ctypes
import weakref
from typing import NamedTuple

import torch

from msd_tpu_torch.models.deepsdf import DeepSDFDecoder
from msd_tpu_torch.ops._build import KernelError

# Points per tile; each shape's rows are padded to a multiple of it.
TILE = 128
# Hidden widths are zero-padded to a multiple of this (a GEMM block's outputs).
WIDTH_PAD = 128
# Widest hidden layer the route takes (fit_last_kernel and the GEMMs take
# any multiple of WIDTH_PAD; wider decoders keep the autograd route).
MAX_WIDTH = 512
# Groups of latent columns (layer 0 and the latent_in layers) a launch takes.
MAX_GROUPS = 8
# TILE, WIDTH_PAD and MAX_GROUPS are the .cu's TILE, BI and MAX_GROUPS;
# ``_lib`` checks them against the built library's once.

# The kernels against the fit's autograd route, both float32 with TF32 off:
# summation orders differ only. Measured on an H100 at 8 x 8000 flagship
# rows (PERF.md): loss 2.7e-7 relative, latent gradient 8.7e-5 relative
# Frobenius, where the autograd route is itself 1.0e-4 from float64 and the
# kernels 4.5e-5. The limits keep a margin of 10 or more.
FIT_TOL = {"loss_rel": 3e-6, "grad_rel": 1e-3}

KERNELS = ("fit_consts_kernel", "fit_first_kernel", "fit_gemm_kernel", "fit_last_kernel", "fit_loss_kernel",
           "fit_grad_kernel")
# Launches of each CUDA kernel; callers reset them to 0 to count a run's.
LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launches():
    """Set every launch count to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def supports_fused_fit(decoder) -> bool:
    """Whether ``decoder`` has the form the kernels compute: a DeepSDF
    decoder with at least two hidden layers, each at most ``MAX_WIDTH``
    wide, no LayerNorm, no ``xyz_in_all``, no inner ``use_tanh``, and
    ``latent_in`` layers that are neither the first nor the last hidden
    layer nor the output layer."""
    if not isinstance(decoder, DeepSDFDecoder):
        return False
    shapes = decoder.layer_shapes
    H = len(shapes) - 1
    return (
        H >= 2
        and len(decoder.latent_in) < MAX_GROUPS
        and not decoder.xyz_in_all
        and not decoder.use_tanh
        and not any(has_ln for _, _, _, has_ln in shapes)
        and all(out <= MAX_WIDTH for _, out, _, _ in shapes[:H])
        and all(0 < layer <= H - 2 for layer in decoder.latent_in)
    )


def route(decoder, latent) -> str:
    """``"kernel"`` for a float32 latent on the card and a float32 decoder
    of the kernels' form (``supports_fused_fit``) on the same device with no
    dropout active; else ``"autograd"``."""
    if not (latent.is_cuda and latent.dtype == torch.float32 and supports_fused_fit(decoder)):
        return "autograd"
    if decoder.training and (decoder.latent_dropout or (decoder.dropout and decoder.dropout_prob > 0)):
        return "autograd"
    if any(p.dtype != torch.float32 or p.device != latent.device for p in decoder.parameters()):
        return "autograd"
    return "kernel"


class FitPlan(NamedTuple):
    """A decoder laid out for the kernels. H hidden layers 0..H-1 of padded
    widths ``wpad``; ``groups`` the layers whose input holds the latent
    (0 and each ``latent_in``); per hidden layer l >= 1 ``fwd[l]``
    [wpad[l-1], wpad[l]] (its hidden-input weight transposed) and ``bwd[l]``
    [wpad[l], wpad[l-1]] (as it is); ``bias[l]`` [wpad[l]]; per group layer
    ``wx`` [wpad, 4] (xyz columns, the fourth 0), ``wzt`` [L, wpad] and
    ``wz`` [wpad, L] (the latent's columns); the output layer's ``w_last``
    [wpad[H-1]] and ``b_last`` [1]."""

    L: int
    wpad: tuple
    groups: tuple
    fwd: tuple
    bwd: tuple
    bias: tuple
    wx: dict
    wzt: dict
    wz: dict
    w_last: torch.Tensor
    b_last: torch.Tensor


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _padded(t, *shape):
    out = torch.zeros(*shape, dtype=t.dtype, device=t.device)
    out[tuple(slice(0, s) for s in t.shape)] = t
    return out


@torch.no_grad()
def fold(decoder) -> FitPlan:
    """The decoder's effective weights (weight norm folded) laid out for
    the kernels, in the decoder's dtype and on its device."""
    L = decoder.latent_size
    shapes = decoder.layer_shapes
    H = len(shapes) - 1
    outs = [out for _, out, _, _ in shapes]
    wpad = tuple(_round_up(o, WIDTH_PAD) for o in outs[:H])
    groups = (0, *sorted(decoder.latent_in))
    fwd, bwd, bias, wx, wzt, wz = [None], [None], [], {}, {}, {}
    for layer in range(H + 1):
        w = decoder.layer_weight(layer).detach()
        b = getattr(decoder, f"lin{layer}").bias.detach()
        prev = 0 if layer == 0 else outs[layer - 1]  # the hidden input's width
        if layer == H:
            w_last = _padded(w[0, :prev], wpad[H - 1]).contiguous()
            b_last = b.reshape(1).clone()
            break
        if layer in groups:
            wzl, wxl = w[:, prev:prev + L], w[:, prev + L:prev + L + 3]
            wx[layer] = _padded(wxl, wpad[layer], 4).contiguous()
            wzt[layer] = _padded(wzl.t(), L, wpad[layer]).contiguous()
            wz[layer] = _padded(wzl, wpad[layer], L).contiguous()
        if layer > 0:
            wh = w[:, :prev]
            fwd.append(_padded(wh.t(), wpad[layer - 1], wpad[layer]).contiguous())
            bwd.append(_padded(wh, wpad[layer], wpad[layer - 1]).contiguous())
        bias.append(_padded(b, wpad[layer]).contiguous())
    return FitPlan(L, wpad, groups, tuple(fwd), tuple(bwd), tuple(bias), wx, wzt, wz, w_last, b_last)


# the latest plan of each decoder, with the parameters' storage and versions it was made from
_PLANS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def plan_for(decoder) -> FitPlan:
    """``fold(decoder)``, made again only when a parameter has changed (a
    new tensor, or an in-place write) since the last call."""
    key = tuple((p.data_ptr(), p._version, p.dtype, p.device) for p in decoder.parameters())
    hit = _PLANS.get(decoder)
    if hit is not None and hit[0] == key:
        return hit[1]
    plan = fold(decoder)
    _PLANS[decoder] = (key, plan)
    return plan


def padded_rows(n: int) -> int:
    """Rows a shape of ``n`` points takes: ``n`` rounded up to ``TILE``."""
    return _round_up(n, TILE)


def _n_chains(tiles: int) -> int:
    """Chains the point tiles run as (``_chains``)."""
    return 1 if tiles < 2 else 2


def iteration_launches(hidden_layers: int, tiles: int) -> dict:
    """Launches by kernel of one loss and gradient on the card over ``tiles``
    point tiles of a decoder with ``hidden_layers`` hidden layers: the
    per-point kernels once per chain, the GEMMs forward and backward for
    every hidden layer past the first."""
    chains = _n_chains(tiles)
    return {"fit_consts_kernel": 1, "fit_first_kernel": chains, "fit_gemm_kernel": 2 * (hidden_layers - 1) * chains,
            "fit_last_kernel": chains, "fit_loss_kernel": 1, "fit_grad_kernel": 1}


# --- the plain version ----------------------------------------------------


def _per_row(v, S: int, P: int):
    """[S, W] per-shape vectors -> [W, S x P], each shape's column repeated."""
    return v.t().repeat_interleave(P, dim=1)


def forward_plain(plan: FitPlan, z, batch, clamp: float):
    """The kernels' forward in PyTorch: z [S, L], batch [S, n, 4] ->
    (per-shape loss [S], state for ``backward_plain``)."""
    S, n = batch.shape[:2]
    P = padded_rows(n)
    H = len(plan.wpad)
    xt = torch.zeros(4, S, P, dtype=batch.dtype, device=batch.device)
    xt[:, :, :n] = batch.permute(2, 0, 1)
    xt = xt.reshape(4, S * P)
    consts = {g: z @ plan.wzt[g] + plan.bias[g] for g in plan.groups}
    h = [torch.relu(_per_row(consts[0], S, P) + plan.wx[0][:, :3] @ xt[:3])]
    for layer in range(1, H):
        a = plan.fwd[layer].t() @ h[-1]
        if layer in plan.wx:
            a = a + _per_row(consts[layer], S, P) + plan.wx[layer][:, :3] @ xt[:3]
        else:
            a = a + plan.bias[layer][:, None]
        h.append(torch.relu(a))
    y = torch.tanh(plan.w_last @ h[-1] + plan.b_last)
    d = y.clamp(-clamp, clamp) - xt[3].clamp(-clamp, clamp)
    valid = (torch.arange(S * P, device=batch.device) % P) < n
    l1 = torch.where(valid, d.abs(), torch.zeros_like(d))
    tile_sums = l1.reshape(-1, TILE).sum(1)
    loss = tile_sums.reshape(S, P // TILE).sum(1) / n
    inside = (y >= -clamp) & (y <= clamp)
    seed = torch.where(valid & inside, torch.sign(d) * (1 - y * y) / n, torch.zeros_like(d))
    return loss, {"h": h, "seed": seed, "S": S, "P": P}


def backward_plain(plan: FitPlan, state, go):
    """The kernels' backward in PyTorch: the latent's gradient [S, L] for
    the loss's cotangent ``go`` [S]."""
    h, S, P = state["h"], state["S"], state["P"]
    H = len(plan.wpad)
    delta = (h[H - 1] > 0) * (plan.w_last[:, None] * state["seed"][None, :])
    tile_sums = {}
    for layer in range(H - 1, 0, -1):
        delta = (h[layer - 1] > 0) * (plan.bwd[layer].t() @ delta)
        if layer - 1 in plan.wz:
            tile_sums[layer - 1] = delta.reshape(delta.shape[0], -1, TILE).sum(2).t()  # [tiles, wpad]
    dz = sum(tile_sums[g].reshape(S, P // TILE, -1).sum(1) @ plan.wz[g] for g in plan.groups)
    return dz * go[:, None]


# --- the CUDA path ----------------------------------------------------------


def _check(lib, rc, kernel):
    if rc != 0:
        raise KernelError(f"fused_fit kernel {kernel} failed: {lib.msd_fit_error_string(rc).decode()} ({rc})")
    LAUNCHES[kernel] += 1


def _ptr(t):
    return None if t is None else t.data_ptr()


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _ints(xs):
    return (ctypes.c_int * len(xs))(*xs)


# whether the built library's layout constants have been checked
_LAYOUT_CHECKED = []


def _lib():
    from msd_tpu_torch.ops._build import load_library

    lib = load_library("fused_fit")
    if not _LAYOUT_CHECKED:
        built = (lib.msd_fit_tile(), lib.msd_fit_width_pad(), lib.msd_fit_max_groups())
        if built != (TILE, WIDTH_PAD, MAX_GROUPS):
            raise KernelError(f"fused_fit: the library's (TILE, BI, MAX_GROUPS) {built} are not the wrapper's "
                              f"{(TILE, WIDTH_PAD, MAX_GROUPS)}")
        _LAYOUT_CHECKED.append(True)
    return lib


# a side stream per device, for the second chain of point tiles
_SIDE_STREAMS: dict = {}


@contextlib.contextmanager
def _chains(dev, tiles: int):
    """The point tiles as two chains, (first tile, tiles, stream handle):
    the first half on the current stream, the second on a side stream that
    waits for the current stream's work before it and is waited for at the
    exit, so each launch's last partial wave of blocks overlaps the other
    chain's work. Every point is independent up to the per-tile sums, so
    the split changes no result. One chain for a single tile."""
    main = torch.cuda.current_stream(dev)
    if _n_chains(tiles) == 1:
        yield [(0, tiles, main.cuda_stream)]
        return
    side = _SIDE_STREAMS.get(dev)
    if side is None:
        side = _SIDE_STREAMS[dev] = torch.cuda.Stream(dev)
    side.wait_stream(main)
    half = tiles // 2
    try:
        yield [(0, half, main.cuda_stream), (half, tiles - half, side.cuda_stream)]
    finally:
        main.wait_stream(side)


def forward_cuda(plan: FitPlan, z, batch, clamp: float):
    """The kernels' forward; same contract as ``forward_plain``. The state
    holds the activations, the last one already overwritten by the delta
    chain's seed rows."""
    if z.dtype != torch.float32 or batch.dtype != torch.float32 or plan.w_last.dtype != torch.float32:
        raise ValueError("fused_fit kernel: float32 only")
    S, n = batch.shape[:2]
    if batch.shape[2] != 4 or n == 0:
        raise ValueError(f"fused_fit kernel: batch must be [S, n > 0, 4], got {tuple(batch.shape)}")
    batch = batch.contiguous()
    z = z.contiguous()
    if batch.data_ptr() % 16:
        batch = batch.clone()
    dev = z.device
    lib, stream = _lib(), torch.cuda.current_stream(dev).cuda_stream
    P = padded_rows(n)
    M, T, H = S * P, P // TILE, len(plan.wpad)
    f32 = dict(dtype=torch.float32, device=dev)
    widths = [plan.wpad[g] for g in plan.groups]
    consts = [torch.empty(S, w, **f32) for w in widths]
    _check(lib, lib.msd_fit_consts(len(widths), _ptr(z), S, plan.L, _ptrs([plan.wzt[g] for g in plan.groups]),
                                   _ptrs([plan.bias[g] for g in plan.groups]), _ptrs(consts), _ints(widths), stream),
           "fit_consts_kernel")
    const = dict(zip(plan.groups, consts))
    h = [torch.empty(w, M, **f32) for w in plan.wpad]
    xt = torch.empty(4, M, **f32)
    tile_sums = torch.empty(M // TILE, **f32)
    with _chains(dev, M // TILE) as chains:
        for jt0, tiles, st in chains:
            _check(lib, lib.msd_fit_first(_ptr(batch), S, n, P, _ptr(const[0]), _ptr(plan.wx[0]), plan.wpad[0], jt0,
                                          tiles, _ptr(h[0]), _ptr(xt), st), "fit_first_kernel")
        for layer in range(1, H):
            lat = layer in plan.wx
            cvec, cstride = (const[layer], plan.wpad[layer]) if lat else (plan.bias[layer], 0)
            for jt0, tiles, st in chains:
                _check(lib, lib.msd_fit_gemm(_ptr(plan.fwd[layer]), _ptr(h[layer - 1]), _ptr(h[layer]),
                                             plan.wpad[layer], plan.wpad[layer - 1], M, jt0, tiles, 0, _ptr(cvec),
                                             cstride, T, _ptr(plan.wx[layer]) if lat else None,
                                             _ptr(xt) if lat else None, None, None, st), "fit_gemm_kernel")
        for jt0, tiles, st in chains:
            _check(lib, lib.msd_fit_last(_ptr(h[H - 1]), plan.wpad[H - 1], _ptr(plan.w_last), _ptr(plan.b_last),
                                         _ptr(xt), M, jt0, tiles, n, P, float(clamp), 1.0 / n, _ptr(tile_sums), st),
                   "fit_last_kernel")
    loss = torch.empty(S, **f32)
    _check(lib, lib.msd_fit_loss(_ptr(tile_sums), S, T, n, _ptr(loss), stream), "fit_loss_kernel")
    return loss, {"h": h, "S": S, "P": P}


def backward_cuda(plan: FitPlan, state, go):
    """The kernels' backward; same contract as ``backward_plain``. Each
    layer's delta is written over its activations."""
    h, S, P = state["h"], state["S"], state["P"]
    M, T, H = S * P, P // TILE, len(plan.wpad)
    dev = h[0].device
    lib = _lib()
    f32 = dict(dtype=torch.float32, device=dev)
    tile_sums = {g: torch.empty(M // TILE, plan.wpad[g], **f32) for g in plan.groups}
    with _chains(dev, M // TILE) as chains:
        for layer in range(H - 1, 0, -1):
            out = None if layer == 1 else h[layer - 1]  # layer 0's delta: its column sums only
            for jt0, tiles, st in chains:
                _check(lib, lib.msd_fit_gemm(_ptr(plan.bwd[layer]), _ptr(h[layer]), _ptr(out), plan.wpad[layer - 1],
                                             plan.wpad[layer], M, jt0, tiles, 1, None, 0, T, None, None,
                                             _ptr(h[layer - 1]), _ptr(tile_sums.get(layer - 1)), st),
                       "fit_gemm_kernel")
    dz = torch.empty(S, plan.L, **f32)
    go = go.to(torch.float32).contiguous()
    _check(lib, lib.msd_fit_grad(len(plan.groups), _ptrs([tile_sums[g] for g in plan.groups]),
                                 _ptrs([plan.wz[g] for g in plan.groups]), _ints([plan.wpad[g] for g in plan.groups]),
                                 S, T, plan.L, _ptr(go), _ptr(dz), torch.cuda.current_stream(dev).cuda_stream),
           "fit_grad_kernel")
    return dz


class FitLoss(torch.autograd.Function):
    """(latent [S, 1, L], batch [S, n, 4], plan, clamp) -> the per-shape
    mean of |clamp(decoder(latent, xyz)) - clamp(sdf)| over each shape's n
    rows, [S]; backward gives the latent's gradient. Kernels on the card,
    the plain version on the CPU."""

    @staticmethod
    def forward(ctx, latent, batch, plan, clamp):
        S, L = latent.shape[0], latent.shape[-1]
        fwd = forward_cuda if latent.is_cuda else forward_plain
        loss, state = fwd(plan, latent.reshape(S, L), batch.detach(), clamp)
        ctx.plan, ctx.state, ctx.latent_shape = plan, state, latent.shape
        return loss

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, go):
        state = ctx.state
        if state is None:
            raise RuntimeError("fused_fit: backward runs once (the activations hold the delta chain)")
        ctx.state = None
        bwd = backward_cuda if go.is_cuda else backward_plain
        return bwd(ctx.plan, state, go).reshape(ctx.latent_shape), None, None, None


def fit_loss(plan: FitPlan, latent, batch, clamp: float):
    """Per-shape clamped L1 [S] of ``latent`` [S, 1, L] on ``batch``
    [S, n, 4] through ``plan``'s decoder, differentiable in the latent."""
    return FitLoss.apply(latent, batch, plan, float(clamp))
