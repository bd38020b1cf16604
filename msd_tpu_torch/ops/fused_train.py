"""Fused SDF loss and gradients (K2, variants a to e), on Hopper.

Replaces ``msd_tpu/ops/fused_train.py:_make_kernel``, the Pallas TPU kernel
called at ``build_fused_train`` (``pl.pallas_call`` at ``:423``), and its
glue ``_fused_point_grads_core``: for one (micro)batch of scenes it returns
the clamped-L1 loss, the eikonal loss (variant b; variants a and d have
none) and every gradient of their sum, from one forward and hand-derived
backward pass over the points (the derivation is in ``csrc/fused_train.cu``
and ``msd_tpu/ops/fused_train.py:11-24``). Variant d (``want_wgrad=False``,
the frozen decoder of the Stage-2 step) returns the loss and the latent
gradient only: no weight-gradient products run. Variant c
(``EikonalNumPoints``) runs the eikonal chains on the first
``eikonal_rows(P, E)`` points of each scene only; variant e scales every
loss lane and gradient seed by a per-scene 0/1 weight, for the padded
batches of data-parallel training, which ``fused_point_grads_sharded``
splits over the ranks. The rounding points are the TPU kernel's: xyz, h,
u, t, gbar and delta are rounded to the operand type before their
products; products accumulate in float32 and every epilogue runs in
float32.

The CUDA kernels are ``msd_tpu_torch/csrc/fused_train.cu``. What bounds
them on an H100: operations. Variant b costs 18.9 MFLOP per point at the
flagship width (9.44 for a, 6.29 for d), so the flagship step of 32 x 16384
points needs at least 10.0 ms (5.0 ms, 3.3 ms) at the 989 TFLOP/s dense
bf16 peak; variant c costs a's 9.44 plus 9.44 x E / P (11.8 MFLOP per
point, 6.3 ms, at E = 4096 of 16384), variant e the cost of the variant
it weights. The bytes the design moves are its second bound: the chains
keep h, u, t and delta of a chunk of whole scenes in device memory as bf16
(32 KB per point at width 512 for b, 16 KB for a and d); h is written once
and read five times (three for a, two for d), u, t and delta twice (once
for d, whose layer-0 delta is not stored): 115 KB per point for b, 54 KB
for a, 36 KB for d, so 18.0, 8.4 and 5.7 ms per flagship step at
3.35 TB/s, above the operation bound. The TPU kernel kept all of that, and
an f32 accumulator per weight gradient, in 100 MB of VMEM; a Hopper block
has 227 KB of shared memory and blocks run in no order, so the work is
split into GEMM launches per layer (``chain_kernel``), weight-gradient
launches that sum over the chunk's points in float32 with no atomics
(``wgrad_kernel``, split-K partials summed here), and three row streamers,
bound by bytes: the last layer with the rank-one last hidden layer
(``last_kernel``: y, the seeds, the L1 tile sums, and the seed rows of the
u-chain, or without an eikonal of the delta chain with their column sums),
the eikonal lane (``eik_kernel``) and the three-column dMx and one-row
last-layer gradients (``skinny_kernel``, which folds its per-block
partials in a fixed order inside the launch). Variant d launches only the
chains and the last layer. Chunks of ``CHUNK_POINTS`` points bound the
scratch (2.1 GB at the flagship width). ``last_plain`` with
``last_rank1_plain``, ``eik_plain`` and ``skinny_plain`` are the plain
versions of the three per-point kernels; ``fused_train_plain`` computes
those quantities through them.

The latent enters only through per-scene constants c_l = z @ W_z^T + b,
computed here; d latent, dW_z and db come back from the kernels' per-scene
dc sums by small products here, as the JAX package leaves them to XLA.

On a CPU tensor ``fused_point_grads`` runs the plain PyTorch version
(``fused_train_plain``), which writes the chains out with the same rounding
points. On a CUDA tensor it launches the kernels or raises; it never falls
back.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

# Points per scene must be a multiple of this (the TPU kernel's lane tile;
# also the per-point kernels' tile, so a tile never spans two scenes).
TILE = 128
# Hidden widths are zero-padded to a multiple of this (the chain kernel's
# output tile).
WIDTH_PAD = 128
# Most points one chunk of the CUDA path holds in scratch (whole scenes).
CHUNK_POINTS = 2**16
# wgrad_kernel's output tile (rows x columns), the GEMM kernels' depth per
# pipeline stage, and the SMs of an H100 SXM, one persistent GEMM block each.
WGRAD_TILE = (128, 256)
GEMM_DEPTH = 64
H100_SMS = 132
# skinny_kernel: columns per block, rows one pass of a block loads (16 row
# lanes x 8 rows deep), resident blocks per SM (256 threads at most 128
# registers each: 64 KB of loads in flight per SM)
SKINNY_COLS = 128
SKINNY_PASS_ROWS = 128
SKINNY_BLOCKS_PER_SM = 2

# Calls of the CUDA path (each runs the kernels once over the batch);
# callers reset it to 0 to count the calls of a run. VARIANT_LAUNCHES counts
# them by variant: "b" (eikonal), "a" (none), "c" (gated eikonal), "d"
# (frozen decoder); "e" counts the weighted calls, also counted as a, b or c.
# KERNEL_LAUNCHES counts the launches of each CUDA kernel of those calls.
LAUNCHES = 0
VARIANT_LAUNCHES = dict.fromkeys("abcde", 0)
KERNEL_LAUNCHES = dict.fromkeys(("chain_kernel", "wgrad_kernel", "last_kernel", "eik_kernel", "skinny_kernel"), 0)


def reset_launches():
    """Set every K2 launch count to 0."""
    global LAUNCHES
    LAUNCHES = 0
    for counts in (VARIANT_LAUNCHES, KERNEL_LAUNCHES):
        for k in counts:
            counts[k] = 0


class UnsupportedConfig(ValueError):
    """A decoder or batch that K2 does not take (``supports_fused_train``)."""


def supports_fused_train(decoder, points_per_scene: int) -> bool:
    """The rule of ``msd_tpu/ops/fused_train.py:51-62``."""
    return (
        type(decoder).__name__ == "DeepSDFDecoder"
        and not decoder.xyz_in_all
        and not any(has_ln for _, _, _, has_ln in decoder.layer_shapes)
        and not decoder.use_tanh
        and len(decoder.latent_in) <= 1
        and (not decoder.latent_in or 0 < decoder.latent_in[0] < decoder.num_layers - 2)
        and points_per_scene % TILE == 0
    )


class Plan(NamedTuple):
    """Static per-layer plan: ``kinds`` "first" | "latent" | "plain",
    hidden input width ``prev`` (None for the first layer), ``out``
    widths, the ``latent_in`` layer index (or None), latent size ``L``,
    and ``nl`` linear layers."""

    kinds: tuple
    prev: tuple
    out: tuple
    latent_li: Optional[int]
    L: int
    nl: int


def layer_plan(decoder) -> Plan:
    L = decoder.latent_size
    latent_li = decoder.latent_in[0] if decoder.latent_in else None
    kinds, prev, out = [], [], []
    for layer, (in_dim, out_dim, _, _) in enumerate(decoder.layer_shapes):
        if layer == 0:
            kinds.append("first")
            prev.append(None)
        elif layer == latent_li:
            kinds.append("latent")
            prev.append(in_dim - (L + 3))
        else:
            kinds.append("plain")
            prev.append(in_dim)
        out.append(out_dim)
    return Plan(tuple(kinds), tuple(prev), tuple(out), latent_li, L, len(kinds))


def split_weights(plan: Plan, weights):
    """Effective [out, in] weights -> per-layer (Mp [out, prev] | None,
    Mx [out, 3] | None, Wz [out, L] | None)."""
    L = plan.L
    parts = []
    for layer, w in enumerate(weights):
        kind, prev = plan.kinds[layer], plan.prev[layer]
        if kind == "first":
            parts.append((None, w[:, L:L + 3], w[:, :L]))
        elif kind == "latent":
            parts.append((w[:, :prev], w[:, prev + L:prev + L + 3], w[:, prev:prev + L]))
        else:
            parts.append((w, None, None))
    return parts


def _chunks(S: int, P: int):
    """Scene ranges of at most CHUNK_POINTS points (at least one scene)."""
    step = max(1, CHUNK_POINTS // P)
    return [(s, min(S, s + step)) for s in range(0, S, step)]


def eikonal_rows(P: int, eik_points, use_eikonal: bool = True) -> int:
    """Points per scene that run the eikonal chains under
    ``EikonalNumPoints`` = ``eik_points`` (variant c): the TPU kernel's
    tiled count, not E itself. ``_fused_point_grads_core``
    (msd_tpu/ops/fused_train.py:657-663) asks for a 512-point tile when E
    rounded up to 256 is a multiple of 512, else 256; ``build_fused_train``
    (:350-358) halves the tile until it divides P and keeps
    ``ceil(E / tile)`` tiles of each scene (at least one, at most all).
    P = 384, E = 100 gives 128. P when nothing is gated."""
    if not use_eikonal or eik_points is None or not 0 < int(eik_points) < P:
        return P
    e = int(eik_points)
    tile = 512 if (-(-e // 256) * 256) % 512 == 0 else 256
    while tile > TILE and P % tile:
        tile //= 2
    return min(P // tile, max(1, -(-e // tile))) * tile


def last_plain(h, wl, c, gt, clamp: float, inv_ntot: float, w=None):
    """Plain version of ``last_kernel`` (msd_tpu/ops/fused_train.py:216-227,
    :294-296): the one-output last layer over rows of ``h`` [n, K] with
    weights ``wl`` [K] and per-row constant ``c`` [n], against the clipped
    ``gt`` [n]. Returns float32 (y, m tau, the L1 delta seed, the L1
    lane), the last two times the per-row weight ``w`` (variant e)."""
    y = torch.tanh(h.float() @ wl.float() + c)
    tau = 1.0 - y * y
    m = (y.abs() < clamp).float()
    yc = y.clamp(-clamp, clamp)
    mt = m * tau
    seed = mt * torch.sign(yc - gt) * inv_ntot
    l1 = (yc - gt).abs()
    if w is not None:
        l1, seed = l1 * w, seed * w
    return y, mt, seed, l1


def last_rank1_plain(h, wl, xv, dtype=torch.bfloat16):
    """Plain version of ``last_kernel``'s rank-one last hidden layer: v =
    D(h) xv wl^T, D = 1[h > 0], for rows of ``h`` [n, K] (n a multiple of
    64), weights ``wl`` [K] and a per-row ``xv`` [n], both already rounded:
    the seed of the u-chain (xv = m tau, msd_tpu/ops/fused_train.py:235-240)
    or of the delta chain (xv = the delta seed, :298, :305-308), one float32
    product per entry as the K = 0 chain launch computes it. Returns (v
    rounded to ``dtype``, float32 [n / 64, K] column sums of v over each 64
    rows)."""
    v = torch.where(h.float() > 0, xv.float()[:, None] * wl.float()[None, :] + 0.0, 0.0)
    return v.to(dtype).float(), v.reshape(-1, 64, v.shape[1]).sum(1)


def eik_plain(u0, mx0, uL, mxL, y, seed, eik_coef: float, w=None):
    """Plain version of ``eik_kernel`` (msd_tpu/ops/fused_train.py:242-259,
    :275, :297) over gated rows: g = u0 Mx0 (+ uL MxL) with ``mx0`` [W0,
    >= 3] (columns 0-2 used), the eikonal lane (1 - |g|)^2, gbar =
    eik_coef (|g| - 1) / |g| g, and the delta seed ``seed`` - 2 y (gbar .
    g); the lane and gbar times the per-row weight ``w`` (variant e).
    Returns float32 (gbar [rows, 3], the seed [rows], the lane [rows])."""
    g = u0.float() @ mx0.float()[:, :3]
    if uL is not None:
        g = g + uL.float() @ mxL.float()[:, :3]
    gn = torch.sqrt(torch.clamp((g * g).sum(1), min=1e-24))
    lane = (1.0 - gn) ** 2
    gbar = (eik_coef * (gn - 1.0) / gn)[:, None] * g
    if w is not None:
        lane = lane * w
        gbar = gbar * w[:, None]
    return gbar, seed + (-2.0 * y) * (gbar * g).sum(1), lane


def skinny_plain(A0, V0, A1=None, V1=None):
    """Plain version of ``skinny_kernel``: A0^T V0 (+ A1^T V1), float32
    [W, k] for A [rows, W] and V [rows, k]: the three-column gradients
    dMx = delta^T x + u^T gbar (msd_tpu/ops/fused_train.py:263, :269-270,
    :303-304) and the last layer's one-row dMp^T = h^T delta + t^T m tau
    (:267-268, :301-302). The second pair runs over the gated rows."""
    out = A0.float().t() @ V0.float()
    if A1 is not None:
        out = out + A1.float().t() @ V1.float()
    return out


def skinny_split(rows: int, W: int, sms: int = H100_SMS) -> int:
    """Row splits of one ``skinny_kernel`` launch over ``rows`` rows (both
    pairs) and W / SKINNY_COLS column groups: SKINNY_BLOCKS_PER_SM blocks
    per SM in all, and no more splits than passes of SKINNY_PASS_ROWS rows.
    Split i takes the rows [i c, (i + 1) c), c = ceil(rows / splits), of
    the pairs laid end to end, and writes one [W, 4] float32 partial."""
    s = -(-SKINNY_BLOCKS_PER_SM * sms // (W // SKINNY_COLS))
    return max(1, min(s, -(-rows // SKINNY_PASS_ROWS)))


def skinny_cuda(A0, V0, A1, V1, acc, ticket, sms: int, lib, stream):
    """acc[:, :3] += skinny_plain(A0, V0[:, :3], A1, V1[:, :3]) on the card,
    by one ``skinny_kernel`` launch: A bf16 [rows, W], V float32 [rows, 4],
    acc float32 [W, 4], ``ticket`` int32 [>= W / SKINNY_COLS], zero before
    (the kernel leaves it zero). Raises if the launch fails."""
    if any(t is not None and t.device.type != "cuda" for t in (A0, V0, A1, V1, acc, ticket)):
        raise ValueError("skinny_cuda: every tensor must lie on the card")
    n0, W = A0.shape
    n1 = 0 if A1 is None else A1.shape[0]
    splits = skinny_split(n0 + n1, W, sms)
    part = torch.empty(splits, W, 4, dtype=torch.float32, device=A0.device)
    _check(lib, lib.msd_ft_skinny(_ptr(A0), _ptr(V0), n0, _ptr(A1), _ptr(V1), n1, W, splits, _ptr(part),
                                  _ptr(ticket), _ptr(acc), stream), "skinny_kernel")


def _check(lib, rc, what, kernel=None):
    """Raise if a launch's return code is not 0; else count ``kernel``'s
    launch (what: the kernel's name when not given)."""
    if rc != 0:
        raise RuntimeError(f"fused_train kernel {what} failed: {lib.msd_ft_error_string(rc).decode()} ({rc})")
    KERNEL_LAUNCHES[kernel or what] += 1


def fused_train_plain(plan: Plan, Mp, Mx, consts, xyz, gt, P: int, clamp: float, inv_ntot: float,
                      eik_coef: float, use_eikonal: bool, dtype: torch.dtype, want_wgrad: bool = True,
                      scene_weights=None, eik_rows=None):
    """Plain PyTorch version of K2 over scene chunks.

    Mp, Mx: per-layer float32 lists (None where absent); consts: per-layer
    [S, out] float32; xyz [S*P, 3] float32; gt [S*P] clipped float32.
    Returns (l1_sum, eik_sum, dMp, dMx, dc) with dMp/dMx float32 lists
    shaped like Mp/Mx and dc per-layer [S, out]. ``want_wgrad=False``
    (variant d, no eikonal) skips every weight-gradient product; dMp and
    dMx are then None.

    ``scene_weights`` [S] float32 (variant e): per-scene 0/1 weights that
    scale the L1 and eikonal loss lanes, the L1 seed and gbar where the
    TPU kernel scales them (msd_tpu/ops/fused_train.py:225-226, :248-258,
    :295-296), so a weight-0 scene adds exactly zero to every sum.
    ``eik_rows`` (variant c): only the first ``eik_rows`` points of each
    scene run the u-chain, the eikonal lane and the second-order chain;
    the others add nothing to the eikonal seed (:277-289)."""
    if use_eikonal and not want_wgrad:
        raise ValueError("fused_train: the eikonal chain needs want_wgrad")
    nl, latent_li = plan.nl, plan.latent_li
    dev = xyz.device
    S = consts[0].shape[0]
    E = P if eik_rows is None else int(eik_rows)
    if not 0 < E <= P or E % TILE:
        raise ValueError(f"fused_train: eikonal rows {E} not a multiple of {TILE} in (0, {P}]")

    def rnd(t):
        return t.to(dtype).float()

    W = [None if m is None else rnd(m) for m in Mp]
    WX = [None if m is None else rnd(m) for m in Mx]
    dMp = [None if m is None or not want_wgrad else torch.zeros_like(m, dtype=torch.float32) for m in Mp]
    dMx = [None if m is None or not want_wgrad else torch.zeros_like(m, dtype=torch.float32) for m in Mx]
    dc = [torch.zeros(S, o, dtype=torch.float32, device=dev) for o in plan.out]
    l1_sum = torch.zeros((), dtype=torch.float32, device=dev)
    eik_sum = torch.zeros((), dtype=torch.float32, device=dev)
    for s0, s1 in _chunks(S, P):
        rows = slice(s0 * P, s1 * P)
        xc = rnd(xyz[rows])
        g_t = gt[rows]
        scene = torch.arange(s1 - s0, device=dev).repeat_interleave(P)

        def layer_in(layer, act, vec):  # Mp act + Mx vec (f32 sums of rounded products)
            acc = None
            if W[layer] is not None:
                acc = act @ W[layer].t()
            if WX[layer] is not None and vec is not None:
                part = vec @ WX[layer].t()
                acc = part if acc is None else acc + part
            return acc

        # primal
        h = []
        for layer in range(nl - 1):
            a = layer_in(layer, h[-1] if h else None, xc) + consts[layer][s0:s1][scene]
            h.append(rnd(torch.relu(a)))
        # the last layer is plain (latent_in < nl - 1): h W_last^T + c
        w_pt = None if scene_weights is None else scene_weights[s0:s1][scene]
        y, mt, sbar, l1_lane = last_plain(h[-1], W[nl - 1][0], consts[nl - 1][s0:s1][scene][:, 0], g_t, clamp,
                                          inv_ntot, w_pt)
        l1_sum = l1_sum + l1_lane.sum()
        # the eikonal halves of the skinny sums (over the gated rows), or none
        pair = {layer: (None, None) for layer in range(nl)}
        if use_eikonal:
            # the gated rows: every point, or the first E of each scene
            sel = slice(None) if E == P else torch.arange((s1 - s0) * P, device=dev) % P < E
            he = [t[sel] for t in h]

            def mask(layer):
                return (he[layer] > 0).float()

            mte_c = rnd(mt[sel])[:, None]
            u = [None] * (nl - 1)
            u[nl - 2] = last_rank1_plain(he[nl - 2], W[nl - 1][0], mte_c[:, 0], dtype)[0]
            for layer in range(nl - 2, 0, -1):
                u[layer - 1] = rnd((u[layer] @ W[layer]) * mask(layer - 1))
            gbar, sbar[sel], eik_lane = eik_plain(
                u[0], WX[0], None if latent_li is None else u[latent_li],
                None if latent_li is None else WX[latent_li], y[sel], sbar[sel], eik_coef,
                None if w_pt is None else w_pt[sel])
            eik_sum = eik_sum + eik_lane.sum()
            gbar_c = rnd(gbar)
            pair[0] = (u[0], gbar_c)
            if latent_li is not None:
                pair[latent_li] = (u[latent_li], gbar_c)
            # second-order chain
            ubar = gbar_c @ WX[0].t()
            for layer in range(1, nl):
                t_prev = rnd(mask(layer - 1) * ubar)
                if layer < nl - 1:
                    dMp[layer] += u[layer].t() @ t_prev
                    ubar = layer_in(layer, t_prev, gbar_c)
                else:
                    pair[layer] = (t_prev, mte_c)

        def mask(layer):
            return (h[layer] > 0).float()

        # delta chain; the last hidden layer's rows and 64-row column sums
        # come from the rank-one product
        delta, colsum = sbar[:, None], None
        for layer in range(nl - 1, -1, -1):
            d_c = rnd(delta)
            if dMp[layer] is not None:
                if layer == nl - 1:  # one row: h^T delta + t^T m tau
                    dMp[layer] += skinny_plain(h[layer - 1], d_c, *pair[layer]).t()
                else:
                    dMp[layer] += d_c.t() @ h[layer - 1]
            if dMx[layer] is not None:  # three columns: delta^T x + u^T gbar
                dMx[layer] += skinny_plain(d_c, xc, *pair[layer])
            if colsum is None:
                dc[layer][s0:s1] += delta.reshape(s1 - s0, P, -1).sum(1)
            else:
                dc[layer][s0:s1] += colsum.reshape(s1 - s0, P // 64, -1).sum(1)
                colsum = None
            if layer == nl - 1:
                delta, colsum = last_rank1_plain(h[layer - 1], W[layer][0], d_c[:, 0], dtype)
            elif layer > 0:
                delta = (d_c @ W[layer]) * mask(layer - 1)
    return l1_sum, eik_sum, dMp, dMx, dc


def wgrad_split(M: int, N: int, k_tiles: int, sms: int = H100_SMS) -> int:
    """Splits of the points of one weight-gradient launch (``k_tiles``
    tiles of GEMM_DEPTH points) over its (M / 128) ceil(N / 256) output
    tiles: the fewest splits that give at least ``sms`` units of work
    (tile, split) and fill the waves of ``sms`` persistent blocks to at
    least 10/11, and no more splits than K tiles. ``wgrad_kernel`` gives
    split i the K tiles [i c, (i + 1) c), c = ceil(k_tiles / splits); each
    split adds an [M, N] float32 partial, summed here in a fixed order."""
    tiles = -(-M // WGRAD_TILE[0]) * -(-N // WGRAD_TILE[1])
    s = -(-sms // tiles)
    while -(-tiles * s // sms) * sms * 10 > tiles * s * 11:
        s += 1
    return max(1, min(s, k_tiles))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pad(t, rows, cols, dtype):
    out = torch.zeros(rows, cols, dtype=dtype, device=t.device)
    out[: t.shape[0], : t.shape[1]] = t
    return out


def _vec4(t):
    """[n, k <= 4] float32 -> contiguous [n, 4]."""
    return _pad(t.float(), t.shape[0], 4, torch.float32)


def _ptr(t):
    return None if t is None else t.data_ptr()


def fused_train_cuda(plan: Plan, Mp, Mx, consts, xyz, gt, P: int, clamp: float, inv_ntot: float,
                     eik_coef: float, use_eikonal: bool, dtype: torch.dtype, want_wgrad: bool = True,
                     scene_weights=None, eik_rows=None):
    """K2 on the card; same contract as ``fused_train_plain``. bf16 only.
    ``last_kernel`` writes the last hidden layer's u (with an eikonal) or
    delta (without) itself, so those chains' launches start one layer down.
    Variant d (``want_wgrad=False``) launches the primal and delta chains
    and the last layer only, and stores no layer-0 delta. Variant c
    (``eik_rows`` E < P) launches the u and t chains, the eikonal lane and
    their weight-gradient halves over the first E points of each scene
    only; variant e passes ``scene_weights`` to the last-layer and eikonal
    kernels."""
    if use_eikonal and not want_wgrad:
        raise ValueError("fused_train: the eikonal chain needs want_wgrad")
    if dtype != torch.bfloat16:
        raise ValueError(f"fused_train kernel: operand dtype {dtype} is not ported (bfloat16 only)")
    if xyz.dtype != torch.float32 or gt.dtype != torch.float32:
        raise ValueError("fused_train kernel: xyz and gt must be float32")
    if P % TILE:
        raise UnsupportedConfig(f"fused_train kernel: points per scene {P} not a multiple of {TILE}")
    E = P if eik_rows is None else int(eik_rows)
    if not 0 < E <= P or E % TILE:
        raise ValueError(f"fused_train kernel: eikonal rows {E} not a multiple of {TILE} in (0, {P}]")
    if not use_eikonal:
        E = 0
    from msd_tpu_torch.ops._build import load_library

    lib = load_library("fused_train")
    dev = xyz.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nl, Li = plan.nl, plan.latent_li
    H = nl - 1  # hidden layers
    S = consts[0].shape[0]
    bf = torch.bfloat16
    wts = None if scene_weights is None else scene_weights.float().contiguous()

    # padded operands
    wpad = [_round_up(o, WIDTH_PAD) for o in plan.out[:H]]
    fwd = [None] + [_pad(Mp[l], wpad[l], wpad[l - 1], bf) for l in range(1, H)]
    bwd = [None] + [t.t().contiguous() for t in fwd[1:]]
    wx = [None if Mx[l] is None else _pad(Mx[l].to(bf).float(), wpad[l], 4, torch.float32) for l in range(H)]
    w_last = _pad(Mp[H].to(bf), 1, wpad[H - 1], bf)[0].contiguous()
    wx_last = _pad(Mp[H].to(bf).float().t(), wpad[H - 1], 4, torch.float32)
    cpad = [_pad(consts[l], S, wpad[l], torch.float32) for l in range(H)]
    c_last = consts[H][:, 0].contiguous()

    if want_wgrad:
        dmp = [None] + [torch.zeros(wpad[l], wpad[l - 1], dtype=torch.float32, device=dev) for l in range(1, H)]
        dmx = {l: torch.zeros(wpad[l], 4, dtype=torch.float32, device=dev) for l in range(H) if Mx[l] is not None}
        dmp_last = torch.zeros(wpad[H - 1], 4, dtype=torch.float32, device=dev)
        ticket = torch.zeros(max(wpad) // SKINNY_COLS, dtype=torch.int32, device=dev)  # skinny_kernel's
    dc = [torch.zeros(S, wpad[l], dtype=torch.float32, device=dev) for l in range(H)]
    dc_last = torch.zeros(S, dtype=torch.float32, device=dev)
    l1_sum = torch.zeros((), dtype=torch.float32, device=dev)
    eik_sum = torch.zeros((), dtype=torch.float32, device=dev)

    for s0, s1 in _chunks(S, P):
        n = (s1 - s0) * P
        ne = (s1 - s0) * E  # gated rows: the eikonal chains' operands, stored compactly
        rows = slice(s0 * P, s1 * P)
        X = _vec4(xyz[rows].to(bf).float())
        G = gt[rows].contiguous()
        cs = [c[s0:s1].contiguous() for c in cpad]
        wc = None if wts is None else wts[s0:s1]

        def act(rows_):
            return [torch.empty(rows_, w, dtype=bf, device=dev) for w in wpad]

        h, d = act(n), act(n)
        if not want_wgrad:
            d[0] = None  # only its column sums are read
        u, t = (act(ne), act(ne)) if use_eikonal else (None, None)
        pt = torch.empty(n, 4, dtype=torch.float32, device=dev)
        mtc = torch.empty(ne, 4, dtype=torch.float32, device=dev) if use_eikonal else None
        sb = torch.empty(n, 4, dtype=torch.float32, device=dev)
        gb = torch.empty(ne, 4, dtype=torch.float32, device=dev) if use_eikonal else None
        loss = torch.zeros(n // TILE, 4, dtype=torch.float32, device=dev)
        colsum = [torch.empty(n // 64, w, dtype=torch.float32, device=dev) for w in wpad]

        def chain(A, B, N, K, xv, wxl, cvec, relu, mask, out, csum, what, gated=False):
            # gated: the launch runs over the ne gated rows; its D mask is
            # read from the chunk's points (row i -> (i / E) P + i % E)
            _check(lib, lib.msd_ft_chain(_ptr(A), _ptr(B), ne if gated else n, N, K, _ptr(xv), _ptr(wxl), _ptr(cvec),
                                         P, E if gated and E < P else 0, int(relu), _ptr(mask), _ptr(out), _ptr(csum),
                                         stream), what, "chain_kernel")

        # primal
        for l in range(H):
            K = 0 if l == 0 else wpad[l - 1]
            chain(None if l == 0 else h[l - 1], fwd[l], wpad[l], K,
                  X if wx[l] is not None else None, wx[l], cs[l], True, None, h[l], None, f"primal {l}")
        # the last layer, with the rank-one last hidden layer: the u-chain's
        # seed rows, or with no eikonal the delta chain's and their column sums
        _check(lib, lib.msd_ft_last(_ptr(h[H - 1]), _ptr(w_last), wpad[H - 1], _ptr(c_last[s0:s1].contiguous()),
                                    _ptr(G), _ptr(wc), n, P, E, clamp, inv_ntot, _ptr(pt), _ptr(mtc),
                                    _ptr(sb), _ptr(loss), _ptr(u[H - 1] if use_eikonal else d[H - 1]),
                                    None if use_eikonal else _ptr(colsum[H - 1]), stream), "last_kernel")
        if use_eikonal:
            # u-chain
            for l in range(H - 1, 0, -1):
                chain(u[l], bwd[l], wpad[l - 1], wpad[l], None, None, None, False, h[l - 1], u[l - 1], None,
                      f"u {l - 1}", gated=True)
            _check(lib, lib.msd_ft_eik(_ptr(u[0]), _ptr(wx[0]), wpad[0],
                                       _ptr(u[Li]) if Li is not None else None,
                                       _ptr(wx[Li]) if Li is not None else None,
                                       wpad[Li] if Li is not None else 0,
                                       _ptr(pt), _ptr(wc), ne, P, E, eik_coef, _ptr(gb), _ptr(sb), _ptr(loss),
                                       stream), "eik_kernel")
            # second-order chain
            for l in range(H):
                K = 0 if l == 0 else wpad[l - 1]
                chain(None if l == 0 else t[l - 1], fwd[l], wpad[l], K,
                      gb if wx[l] is not None else None, wx[l], None, False, h[l], t[l], None, f"t {l}",
                      gated=True)
        # delta chain (its seed rows need eik_kernel's sbar when there is an eikonal)
        if use_eikonal:
            chain(None, None, wpad[H - 1], 0, sb, wx_last, None, False, h[H - 1], d[H - 1], colsum[H - 1],
                  "delta last")
        for l in range(H - 1, 0, -1):
            chain(d[l], bwd[l], wpad[l - 1], wpad[l], None, None, None, False, h[l - 1], d[l - 1], colsum[l - 1],
                  f"delta {l - 1}")
        for l in range(H):
            dc[l][s0:s1] = colsum[l].reshape(s1 - s0, P // 64, -1).sum(1)
        lsum = loss.reshape(s1 - s0, P // TILE, 4).sum(1)
        dc_last[s0:s1] = lsum[:, 2]
        l1_sum += lsum[:, 0].sum()
        eik_sum += lsum[:, 1].sum()
        if not want_wgrad:
            continue
        # weight gradients: the delta products over the chunk's n points,
        # the eikonal ones over its ne gated rows
        for l in range(1, H):
            nsplit = wgrad_split(wpad[l], wpad[l - 1], (n + ne) // GEMM_DEPTH, sms)
            part = torch.empty(nsplit, wpad[l], wpad[l - 1], dtype=torch.float32, device=dev)
            _check(lib, lib.msd_ft_wgrad(_ptr(d[l]), _ptr(h[l - 1]), n,
                                         _ptr(u[l]) if use_eikonal else None,
                                         _ptr(t[l - 1]) if use_eikonal else None, ne,
                                         wpad[l], wpad[l - 1], nsplit, _ptr(part), stream),
                   f"wgrad {l}", "wgrad_kernel")
            dmp[l] += part.sum(0)
        # the three-column sums delta^T x + u^T gbar and the last layer's
        # h^T delta + t^T m tau, added into dmx and dmp_last by the kernel
        for l in dmx:
            skinny_cuda(d[l], X, u[l] if use_eikonal else None, gb if use_eikonal else None, dmx[l], ticket, sms,
                        lib, stream)
        skinny_cuda(h[H - 1], sb, t[H - 1] if use_eikonal else None, mtc, dmp_last, ticket, sms, lib, stream)

    global LAUNCHES
    LAUNCHES += 1
    VARIANT_LAUNCHES["d" if not want_wgrad else "a" if not use_eikonal else "c" if E < P else "b"] += 1
    if wts is not None:
        VARIANT_LAUNCHES["e"] += 1
    out_dc = [dc[l][:, : plan.out[l]] for l in range(H)] + [dc_last[:, None]]
    if not want_wgrad:
        return l1_sum, eik_sum, [None] * plan.nl, [None] * plan.nl, out_dc
    out_dMp = [None] + [dmp[l][: plan.out[l], : plan.prev[l]] for l in range(1, H)]
    out_dMp.append(dmp_last[: plan.prev[H], :1].t().contiguous())
    out_dMx = [None if Mx[l] is None else dmx[l][: plan.out[l], :3] for l in range(H)] + [None]
    return l1_sum, eik_sum, out_dMp, out_dMx, out_dc


def fused_point_grads(decoder, weights, biases, lat_rows, xyz, gt, clamp_dist: float, use_eikonal: bool,
                      num_total: int, eik_weight: float = 0.002, dtype: torch.dtype = torch.bfloat16,
                      want_wgrad: bool = True, eik_points=None, scene_weights=None, n_real=None, eik_scenes=None):
    """Fused loss and gradients for one (micro)batch; the counterpart of
    ``msd_tpu.ops.fused_train.fused_point_grads_t``.

    weights/biases: the decoder's effective [out, in] weights and biases;
    lat_rows [B, L]; xyz [B, P, 3]; gt [B, P] (unclipped); ``num_total`` is
    the clamped-L1 normalizer (the full batch's real points, also under
    batch_split). ``eik_points`` (EikonalNumPoints, variant c): the eikonal
    runs on the first ``eikonal_rows(P, eik_points)`` points of each scene
    only. ``scene_weights`` [B] (variant e): per-scene 0/1 weights of a
    padded batch; ``n_real`` (its real scenes) is then required. The
    eikonal mean runs over ``eik_scenes`` (default: ``n_real`` when
    weighted, else B) times the eikonal rows per scene.
    Returns (dweights, dbiases, dlat, sdf_loss, eikonal_loss);
    ``want_wgrad=False`` (variant d) returns None for dweights and dbiases.

    A CPU tensor runs the plain version; a CUDA tensor the kernels, or an
    exception."""
    if xyz.device.type == "cpu":
        impl = fused_train_plain
    elif xyz.device.type == "cuda":
        others = (lat_rows, gt, *weights, *biases) + (() if scene_weights is None else (scene_weights,))
        if any(t.device != xyz.device for t in others):
            raise ValueError(f"fused_point_grads: every input must be on {xyz.device}")
        impl = fused_train_cuda
    else:
        raise ValueError(f"fused_point_grads: unsupported device {xyz.device}")
    return point_grads(impl, decoder, weights, biases, lat_rows, xyz, gt, clamp_dist, use_eikonal,
                       num_total, eik_weight, dtype, want_wgrad, eik_points, scene_weights, n_real, eik_scenes)


def point_grads(impl, decoder, weights, biases, lat_rows, xyz, gt, clamp_dist: float, use_eikonal: bool,
                num_total: int, eik_weight: float = 0.002, dtype: torch.dtype = torch.bfloat16,
                want_wgrad: bool = True, eik_points=None, scene_weights=None, n_real=None, eik_scenes=None):
    """``fused_point_grads`` through ``impl`` (``fused_train_plain`` or
    ``fused_train_cuda``) on any device; comparisons of the kernels with
    their plain version call it directly."""
    plan = layer_plan(decoder)
    B, P = xyz.shape[0], xyz.shape[1]
    if not supports_fused_train(decoder, P):
        raise UnsupportedConfig("fused_train: decoder or points per scene not supported (supports_fused_train)")
    if scene_weights is not None:
        if n_real is None:
            raise ValueError("fused_train: scene_weights needs n_real (the real scenes of the batch)")
        if eik_scenes is None:
            eik_scenes = int(n_real)
        scene_weights = scene_weights.float().contiguous()
    parts = split_weights(plan, [w.float() for w in weights])
    consts = []
    for (_, _, wz), b in zip(parts, biases):
        c = b.float()[None, :].expand(B, -1)
        if wz is not None:
            c = c + lat_rows.float() @ wz.t()
        consts.append(c.contiguous())
    # the eikonal normalizer counts the rows the kernel gates on
    # (msd_tpu/ops/fused_train.py:361-368)
    E = eikonal_rows(P, eik_points, use_eikonal)
    n_eik = (B if eik_scenes is None else int(eik_scenes)) * E
    args = (plan, [p[0] for p in parts], [p[1] for p in parts], consts,
            xyz.reshape(-1, 3).float().contiguous(),
            gt.reshape(-1).float().clamp(-clamp_dist, clamp_dist).contiguous(),
            P, float(clamp_dist), 1.0 / num_total, 2.0 * eik_weight / n_eik, bool(use_eikonal), dtype,
            bool(want_wgrad), scene_weights, E)
    l1_sum, eik_sum, dMp, dMx, dc = impl(*args)
    sdf_l = l1_sum / num_total
    eik_l = eik_weight * eik_sum / n_eik if use_eikonal else torch.zeros_like(sdf_l)
    if not want_wgrad:
        # frozen decoder: only the latent cotangents (msd_tpu/ops/fused_train.py:673-680)
        dlat = torch.zeros_like(lat_rows, dtype=torch.float32)
        for layer, (_, _, wz) in enumerate(parts):
            if wz is not None:
                dlat = dlat + dc[layer] @ wz
        return None, None, dlat, sdf_l, eik_l

    L = plan.L
    dweights, dbiases = [], []
    dlat = torch.zeros_like(lat_rows, dtype=torch.float32)
    for layer, (in_dim, out_dim, _, _) in enumerate(decoder.layer_shapes):
        kind, prev = plan.kinds[layer], plan.prev[layer]
        dW = torch.zeros(out_dim, in_dim, dtype=torch.float32, device=xyz.device)
        if kind == "first":
            dW[:, :L] = dc[layer].t() @ lat_rows.float()
            dW[:, L:L + 3] = dMx[layer]
        elif kind == "latent":
            dW[:, :prev] = dMp[layer]
            dW[:, prev:prev + L] = dc[layer].t() @ lat_rows.float()
            dW[:, prev + L:] = dMx[layer]
        else:
            dW = dMp[layer]
        if parts[layer][2] is not None:
            dlat = dlat + dc[layer] @ parts[layer][2]
        dweights.append(dW)
        dbiases.append(dc[layer].sum(0))
    return dweights, dbiases, dlat, sdf_l, eik_l


def fused_point_grads_sharded(decoder, weights, biases, lat_rows, xyz, gt, clamp_dist: float, use_eikonal: bool,
                              num_total: int, group, eik_weight: float = 0.002,
                              dtype: torch.dtype = torch.bfloat16, want_wgrad: bool = True, eik_points=None,
                              scene_weights=None, n_real=None):
    """K2 over the scene axis of a data-parallel group, the counterpart of
    ``msd_tpu.ops.fused_train.fused_point_grads_sharded`` (:708-785).

    ``lat_rows`` [B, L], ``xyz`` [B, P, 3], ``gt`` [B, P] and
    ``scene_weights`` [B] are the whole batch, the same on every rank, with
    B a multiple of the world size. Each rank runs K2 on its own scenes
    (``group.scene_slice(B)``) with the global normalizers: ``num_total``
    counts the batch's real points, and the eikonal mean runs over
    ``n_real`` scenes when weighted, else B. The decoder gradients and the
    loss sums are then summed over the ranks (``all_reduce``), so every
    rank holds what the single-device call returns; the latent gradient
    stays local: dlat [B / world, L] of this rank's scenes. A group of one
    rank is the single-device call."""
    B = xyz.shape[0]
    rows = group.scene_slice(B)
    eik_scenes = int(n_real) if scene_weights is not None else B
    dW, db, dlat, sdf_l, eik_l = fused_point_grads(
        decoder, weights, biases, lat_rows[rows], xyz[rows], gt[rows], clamp_dist, use_eikonal, num_total,
        eik_weight, dtype, want_wgrad, eik_points,
        None if scene_weights is None else scene_weights[rows], n_real, eik_scenes,
    )
    group.all_reduce_((dW or []) + (db or []) + [sdf_l, eik_l])
    return dW, db, dlat, sdf_l, eik_l


class FusedSdfLoss(torch.autograd.Function):
    """Counterpart of the ``custom_vjp`` in ``make_fused_sdf_l1``
    (``msd_tpu/ops/fused_train.py:558-617``), for the Stage-1 loss and the
    Stage-2 SDF-consistency term.

    ``FusedSdfLoss.apply(grads, lat_rows, *weights, *biases)``, where
    ``grads(weights, biases, lat_rows)`` returns what ``fused_point_grads``
    returns, gives (sdf + eikonal, sdf, eikonal); the last two are for
    logging and carry no gradient. The forward computes every gradient; the
    backward scales them by the cotangent, and autograd carries them on
    into weight norm and the latent-table gather. Where ``grads`` returns no
    weight gradients (variant d) the weights and biases get none."""

    @staticmethod
    def forward(ctx, grads, lat_rows, *wb):
        k = len(wb) // 2
        dW, db, dlat, sdf_l, eik_l = grads(wb[:k], wb[k:], lat_rows.detach())
        ctx.n_wb = len(wb)
        ctx.save_for_backward(dlat, *(dW + db if dW is not None else ()))
        ctx.mark_non_differentiable(sdf_l, eik_l)
        return sdf_l + eik_l, sdf_l, eik_l

    @staticmethod
    def backward(ctx, ct, _ct_sdf, _ct_eik):
        dlat, *rest = ctx.saved_tensors
        wb = [g * ct for g in rest] if rest else [None] * ctx.n_wb
        return (None, dlat * ct, *wb)


def _decoder_weights(decoder):
    n = decoder.num_layers - 1
    return ([decoder.layer_weight(layer) for layer in range(n)],
            [getattr(decoder, f"lin{layer}").bias for layer in range(n)])


def _grads_fn(decoder, xyz, gt, clamp_dist, use_eikonal, num_total, eik_weight, dtype, want_wgrad,
              eik_points=None, scene_weights=None, n_real=None, group=None):
    """``grads(weights, biases, lat_rows)`` for ``FusedSdfLoss``: K2 on one
    device, or over ``group``'s ranks with the latent gradient of every
    scene summed over the ranks (each rank's is zero outside its scenes),
    so that what follows the loss runs the same on every rank."""
    if group is None or group.world_size == 1:
        def grads(w, b, z):
            return fused_point_grads(decoder, w, b, z, xyz, gt, clamp_dist, use_eikonal, num_total, eik_weight,
                                     dtype, want_wgrad, eik_points, scene_weights, n_real)
        return grads

    def grads_sharded(w, b, z):
        dW, db, dlat_local, sdf_l, eik_l = fused_point_grads_sharded(
            decoder, w, b, z, xyz, gt, clamp_dist, use_eikonal, num_total, group, eik_weight, dtype,
            want_wgrad, eik_points, scene_weights, n_real)
        dlat = torch.zeros_like(z, dtype=torch.float32)
        dlat[group.scene_slice(z.shape[0])] = dlat_local
        group.all_reduce_([dlat])
        return dW, db, dlat, sdf_l, eik_l
    return grads_sharded


def fused_sdf_loss(decoder, lat_rows, xyz, gt, clamp_dist, use_eikonal, num_total,
                   eik_weight: float = 0.002, dtype: torch.dtype = torch.bfloat16, eik_points=None,
                   scene_weights=None, n_real=None, group=None):
    """(sdf + eikonal, sdf, eikonal) of one (micro)batch through K2,
    differentiable with respect to ``lat_rows`` and the decoder's
    parameters. ``gt`` [B, P] unclipped; ``eik_points``, ``scene_weights``
    and ``n_real`` as ``fused_point_grads``. With a ``group`` of several
    ranks, every rank passes the whole batch and runs K2 on its share of
    the scenes (``fused_point_grads_sharded``); the losses and every
    gradient come back summed over the ranks."""
    weights, biases = _decoder_weights(decoder)
    grads = _grads_fn(decoder, xyz, gt, clamp_dist, use_eikonal, num_total, eik_weight, dtype, True, eik_points,
                      scene_weights, n_real, group)
    return FusedSdfLoss.apply(grads, lat_rows, *weights, *biases)


def fused_sdf_l1(decoder, lat_rows, xyz, gt, clamp_dist, train_net: bool = True,
                 dtype: torch.dtype = torch.bfloat16, group=None):
    """The Stage-2 SDF-consistency term through K2, the counterpart of
    ``make_fused_sdf_l1`` (``msd_tpu/ops/fused_train.py:558-617``):
    ``sum |clip(pred) - clip(gt)| / (B * P)`` of the decoder at ``lat_rows``
    [B, L] on ``xyz`` [B, P, 3] against ``gt`` [B, P] (unclipped),
    differentiable with respect to ``lat_rows`` and, with ``train_net``
    (variant a), the decoder's parameters. ``train_net=False`` runs variant
    d: no weight-gradient products, and the decoder gets no gradient. A
    ``group`` of several ranks splits the scenes over them (B a multiple
    of the world size), as ``fused_sdf_loss``."""
    B, P = xyz.shape[:2]
    weights, biases = _decoder_weights(decoder)
    if not train_net:
        weights, biases = [w.detach() for w in weights], [b.detach() for b in biases]
    grads = _grads_fn(decoder, xyz, gt, clamp_dist, False, B * P, 0.0, dtype, bool(train_net), group=group)
    return FusedSdfLoss.apply(grads, lat_rows, *weights, *biases)[0]
