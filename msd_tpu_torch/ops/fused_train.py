"""Fused SDF loss and gradients (K2, variants b, a and d), on Hopper.

Replaces ``msd_tpu/ops/fused_train.py:_make_kernel``, the Pallas TPU kernel
called at ``build_fused_train`` (``pl.pallas_call`` at ``:423``), and its
glue ``_fused_point_grads_core``: for one (micro)batch of scenes it returns
the clamped-L1 loss, the eikonal loss (variant b; variants a and d have
none) and every gradient of their sum, from one forward and hand-derived
backward pass over the points (the derivation is in ``csrc/fused_train.cu``
and ``msd_tpu/ops/fused_train.py:11-24``). Variant d (``want_wgrad=False``,
the frozen decoder of the Stage-2 step) returns the loss and the latent
gradient only: no weight-gradient products run. The rounding points are the
TPU kernel's: xyz, h, u, t, gbar and delta are rounded to the operand type
before their products; products accumulate in float32 and every epilogue
runs in float32.

The CUDA kernels are ``msd_tpu_torch/csrc/fused_train.cu``. What bounds
them on an H100: operations. Variant b costs 18.9 MFLOP per point at the
flagship width (9.44 for a, 6.29 for d), so the flagship step of 32 x 16384
points needs at least 10.0 ms (5.0 ms, 3.3 ms) at the 989 TFLOP/s dense
bf16 peak. The bytes the design moves are its second bound: the chains
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
(``wgrad_kernel``, split-K partials summed here), per-point kernels for
the last layer and the eikonal lane, and segmented sums for the
three-column dMx and one-row last-layer gradients. Variant d launches only
the chains and the last layer. Chunks of ``CHUNK_POINTS`` points bound the
scratch (2.1 GB at the flagship width).

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
# Split-K factor of the weight-gradient launches and segments of the
# three-column sums.
WGRAD_SPLIT = 8
SKINNY_SEGMENTS = 256

# Calls of the CUDA path (each runs the kernels once over the batch);
# callers reset it to 0 to count the calls of a run.
LAUNCHES = 0


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


def fused_train_plain(plan: Plan, Mp, Mx, consts, xyz, gt, P: int, clamp: float, inv_ntot: float,
                      eik_coef: float, use_eikonal: bool, dtype: torch.dtype, want_wgrad: bool = True):
    """Plain PyTorch version of K2 over scene chunks.

    Mp, Mx: per-layer float32 lists (None where absent); consts: per-layer
    [S, out] float32; xyz [S*P, 3] float32; gt [S*P] clipped float32.
    Returns (l1_sum, eik_sum, dMp, dMx, dc) with dMp/dMx float32 lists
    shaped like Mp/Mx and dc per-layer [S, out]. ``want_wgrad=False``
    (variant d, no eikonal) skips every weight-gradient product; dMp and
    dMx are then None."""
    if use_eikonal and not want_wgrad:
        raise ValueError("fused_train: the eikonal chain needs want_wgrad")
    nl, latent_li = plan.nl, plan.latent_li
    dev = xyz.device
    S = consts[0].shape[0]

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
        a_last = (layer_in(nl - 1, h[-1], xc) + consts[nl - 1][s0:s1][scene])[:, 0]
        y = torch.tanh(a_last)
        tau = 1.0 - y * y
        m = (y.abs() < clamp).float()
        yc = y.clamp(-clamp, clamp)
        l1_sum = l1_sum + (yc - g_t).abs().sum()
        sgn = torch.sign(yc - g_t)
        mt = m * tau

        def mask(layer):
            return (h[layer] > 0).float()

        sbar = mt * sgn * inv_ntot
        if use_eikonal:
            u = [None] * (nl - 1)
            u_next = rnd(mt)[:, None]
            for layer in range(nl - 1, 0, -1):
                u[layer - 1] = rnd((u_next @ W[layer]) * mask(layer - 1))
                u_next = u[layer - 1]
            g = u[0] @ WX[0]
            if latent_li is not None:
                g = g + u[latent_li] @ WX[latent_li]
            gn = torch.sqrt(torch.clamp((g * g).sum(1), min=1e-24))
            eik_sum = eik_sum + ((1.0 - gn) ** 2).sum()
            gbar = (eik_coef * (gn - 1.0) / gn)[:, None] * g
            gdot = (gbar * g).sum(1)
            gbar_c = rnd(gbar)
            # second-order chain
            dMx[0] += u[0].t() @ gbar_c
            ubar = gbar_c @ WX[0].t()
            for layer in range(1, nl):
                t_prev = rnd(mask(layer - 1) * ubar)
                u_l = u[layer] if layer < nl - 1 else rnd(mt)[:, None]
                dMp[layer] += u_l.t() @ t_prev
                if layer == latent_li:
                    dMx[layer] += u_l.t() @ gbar_c
                if layer < nl - 1:
                    ubar = layer_in(layer, t_prev, gbar_c)
            sbar = sbar + (-2.0 * y) * gdot

        # delta chain
        delta = sbar[:, None]
        for layer in range(nl - 1, -1, -1):
            d_c = rnd(delta)
            if dMp[layer] is not None:
                dMp[layer] += d_c.t() @ h[layer - 1]
            if dMx[layer] is not None:
                dMx[layer] += d_c.t() @ xc
            dc[layer][s0:s1] += delta.reshape(s1 - s0, P, -1).sum(1)
            if layer > 0:
                delta = (d_c @ W[layer]) * mask(layer - 1)
    return l1_sum, eik_sum, dMp, dMx, dc


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
                     eik_coef: float, use_eikonal: bool, dtype: torch.dtype, want_wgrad: bool = True):
    """K2 on the card; same contract as ``fused_train_plain``. bf16 only.
    Variant d (``want_wgrad=False``) launches the primal and delta chains
    and the last layer only, and stores no layer-0 delta."""
    if use_eikonal and not want_wgrad:
        raise ValueError("fused_train: the eikonal chain needs want_wgrad")
    if dtype != torch.bfloat16:
        raise ValueError(f"fused_train kernel: operand dtype {dtype} is not ported (bfloat16 only)")
    if xyz.dtype != torch.float32 or gt.dtype != torch.float32:
        raise ValueError("fused_train kernel: xyz and gt must be float32")
    if P % TILE:
        raise UnsupportedConfig(f"fused_train kernel: points per scene {P} not a multiple of {TILE}")
    from msd_tpu_torch.ops._build import load_library

    lib = load_library("fused_train")
    dev = xyz.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    nl, Li = plan.nl, plan.latent_li
    H = nl - 1  # hidden layers
    S = consts[0].shape[0]
    bf = torch.bfloat16

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"fused_train kernel {what} failed: {lib.msd_ft_error_string(rc).decode()} ({rc})")

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
    dc = [torch.zeros(S, wpad[l], dtype=torch.float32, device=dev) for l in range(H)]
    dc_last = torch.zeros(S, dtype=torch.float32, device=dev)
    l1_sum = torch.zeros((), dtype=torch.float32, device=dev)
    eik_sum = torch.zeros((), dtype=torch.float32, device=dev)

    for s0, s1 in _chunks(S, P):
        n = (s1 - s0) * P
        rows = slice(s0 * P, s1 * P)
        X = _vec4(xyz[rows].to(bf).float())
        G = gt[rows].contiguous()
        cs = [c[s0:s1].contiguous() for c in cpad]

        def act():
            return [torch.empty(n, w, dtype=bf, device=dev) for w in wpad]

        h, d = act(), act()
        if not want_wgrad:
            d[0] = None  # only its column sums are read
        u, t = (act(), act()) if use_eikonal else (None, None)
        pt = torch.empty(n, 4, dtype=torch.float32, device=dev)
        mtc = torch.empty(n, 4, dtype=torch.float32, device=dev)
        sb = torch.empty(n, 4, dtype=torch.float32, device=dev)
        gb = torch.empty(n, 4, dtype=torch.float32, device=dev) if use_eikonal else None
        loss = torch.zeros(n // TILE, 4, dtype=torch.float32, device=dev)
        colsum = [torch.empty(n // 64, w, dtype=torch.float32, device=dev) for w in wpad]

        def chain(A, B, N, K, xv, wxl, cvec, relu, mask, out, csum, what):
            check(lib.msd_ft_chain(_ptr(A), _ptr(B), n, N, K, _ptr(xv), _ptr(wxl), _ptr(cvec), P,
                                   int(relu), _ptr(mask), _ptr(out), _ptr(csum), stream), what)

        # primal
        for l in range(H):
            K = 0 if l == 0 else wpad[l - 1]
            chain(None if l == 0 else h[l - 1], fwd[l], wpad[l], K,
                  X if wx[l] is not None else None, wx[l], cs[l], True, None, h[l], None, f"primal {l}")
        check(lib.msd_ft_last(_ptr(h[H - 1]), _ptr(w_last), wpad[H - 1], _ptr(c_last[s0:s1].contiguous()),
                              _ptr(G), n, P, clamp, inv_ntot, int(use_eikonal), _ptr(pt), _ptr(mtc),
                              _ptr(sb), _ptr(loss), stream), "last layer")
        if use_eikonal:
            # u-chain
            chain(None, None, wpad[H - 1], 0, mtc, wx_last, None, False, h[H - 1], u[H - 1], None, "u last")
            for l in range(H - 1, 0, -1):
                chain(u[l], bwd[l], wpad[l - 1], wpad[l], None, None, None, False, h[l - 1], u[l - 1], None,
                      f"u {l - 1}")
            check(lib.msd_ft_eik(_ptr(u[0]), _ptr(wx[0]), wpad[0],
                                 _ptr(u[Li]) if Li is not None else None,
                                 _ptr(wx[Li]) if Li is not None else None,
                                 wpad[Li] if Li is not None else 0,
                                 _ptr(pt), n, eik_coef, _ptr(gb), _ptr(sb), _ptr(loss), stream), "eikonal")
            # second-order chain
            for l in range(H):
                K = 0 if l == 0 else wpad[l - 1]
                chain(None if l == 0 else t[l - 1], fwd[l], wpad[l], K,
                      gb if wx[l] is not None else None, wx[l], None, False, h[l], t[l], None, f"t {l}")
        # delta chain
        chain(None, None, wpad[H - 1], 0, sb, wx_last, None, False, h[H - 1], d[H - 1], colsum[H - 1], "delta last")
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
        # weight gradients
        for l in range(1, H):
            part = torch.empty(WGRAD_SPLIT, wpad[l], wpad[l - 1], dtype=torch.float32, device=dev)
            check(lib.msd_ft_wgrad(_ptr(d[l]), _ptr(h[l - 1]),
                                   _ptr(u[l]) if use_eikonal else None, _ptr(t[l - 1]) if use_eikonal else None,
                                   n, wpad[l], wpad[l - 1], WGRAD_SPLIT, _ptr(part), stream), f"wgrad {l}")
            dmp[l] += part.sum(0)

        def skinny(A0, V0, A1, V1, W, acc, what):
            part = torch.empty(SKINNY_SEGMENTS, W, 4, dtype=torch.float32, device=dev)
            check(lib.msd_ft_skinny(_ptr(A0), _ptr(V0), _ptr(A1), _ptr(V1), n, W, SKINNY_SEGMENTS,
                                    _ptr(part), stream), what)
            acc += part.sum(0)

        for l in dmx:
            skinny(d[l], X, u[l] if use_eikonal else None, gb, wpad[l], dmx[l], f"dMx {l}")
        skinny(h[H - 1], sb, t[H - 1] if use_eikonal else None, mtc if use_eikonal else None,
               wpad[H - 1], dmp_last, "dMp last")

    global LAUNCHES
    LAUNCHES += 1
    out_dc = [dc[l][:, : plan.out[l]] for l in range(H)] + [dc_last[:, None]]
    if not want_wgrad:
        return l1_sum, eik_sum, [None] * plan.nl, [None] * plan.nl, out_dc
    out_dMp = [None] + [dmp[l][: plan.out[l], : plan.prev[l]] for l in range(1, H)]
    out_dMp.append(dmp_last[: plan.prev[H], :1].t().contiguous())
    out_dMx = [None if Mx[l] is None else dmx[l][: plan.out[l], :3] for l in range(H)] + [None]
    return l1_sum, eik_sum, out_dMp, out_dMx, out_dc


def fused_point_grads(decoder, weights, biases, lat_rows, xyz, gt, clamp_dist: float, use_eikonal: bool,
                      num_total: int, eik_weight: float = 0.002, dtype: torch.dtype = torch.bfloat16,
                      want_wgrad: bool = True):
    """Fused loss and gradients for one (micro)batch; the unweighted
    counterpart of ``msd_tpu.ops.fused_train.fused_point_grads_t``.

    weights/biases: the decoder's effective [out, in] weights and biases;
    lat_rows [B, L]; xyz [B, P, 3]; gt [B, P] (unclipped); ``num_total`` is
    the clamped-L1 normalizer (the full batch's points, also under
    batch_split); the eikonal mean runs over this call's B*P points.
    Returns (dweights, dbiases, dlat, sdf_loss, eikonal_loss);
    ``want_wgrad=False`` (variant d) returns None for dweights and dbiases.

    A CPU tensor runs the plain version; a CUDA tensor the kernels, or an
    exception."""
    if xyz.device.type == "cpu":
        impl = fused_train_plain
    elif xyz.device.type == "cuda":
        if any(t.device != xyz.device for t in (lat_rows, gt, *weights, *biases)):
            raise ValueError(f"fused_point_grads: every input must be on {xyz.device}")
        impl = fused_train_cuda
    else:
        raise ValueError(f"fused_point_grads: unsupported device {xyz.device}")
    return point_grads(impl, decoder, weights, biases, lat_rows, xyz, gt, clamp_dist, use_eikonal,
                       num_total, eik_weight, dtype, want_wgrad)


def point_grads(impl, decoder, weights, biases, lat_rows, xyz, gt, clamp_dist: float, use_eikonal: bool,
                num_total: int, eik_weight: float = 0.002, dtype: torch.dtype = torch.bfloat16,
                want_wgrad: bool = True):
    """``fused_point_grads`` through ``impl`` (``fused_train_plain`` or
    ``fused_train_cuda``) on any device; comparisons of the kernels with
    their plain version call it directly."""
    plan = layer_plan(decoder)
    B, P = xyz.shape[0], xyz.shape[1]
    if not supports_fused_train(decoder, P):
        raise UnsupportedConfig("fused_train: decoder or points per scene not supported (supports_fused_train)")
    parts = split_weights(plan, [w.float() for w in weights])
    consts = []
    for (_, _, wz), b in zip(parts, biases):
        c = b.float()[None, :].expand(B, -1)
        if wz is not None:
            c = c + lat_rows.float() @ wz.t()
        consts.append(c.contiguous())
    n_eik = B * P
    args = (plan, [p[0] for p in parts], [p[1] for p in parts], consts,
            xyz.reshape(-1, 3).float().contiguous(),
            gt.reshape(-1).float().clamp(-clamp_dist, clamp_dist).contiguous(),
            P, float(clamp_dist), 1.0 / num_total, 2.0 * eik_weight / n_eik, bool(use_eikonal), dtype,
            bool(want_wgrad))
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


class FusedSdfLoss(torch.autograd.Function):
    """Counterpart of the ``custom_vjp`` in ``make_fused_sdf_l1``
    (``msd_tpu/ops/fused_train.py:558-617``), for the Stage-1 loss and the
    Stage-2 SDF-consistency term.

    ``FusedSdfLoss.apply(cfg, lat_rows, xyz, gt, *weights, *biases)`` with
    ``cfg = (decoder, clamp_dist, use_eikonal, num_total, eik_weight,
    dtype, want_wgrad)`` returns (sdf + eikonal, sdf, eikonal); the last two
    are for logging and carry no gradient. The forward computes every
    gradient; the backward scales them by the cotangent, and autograd
    carries them on into weight norm and the latent-table gather. With
    ``want_wgrad`` false (variant d) the weights and biases get no gradient."""

    @staticmethod
    def forward(ctx, cfg, lat_rows, xyz, gt, *wb):
        decoder, clamp_dist, use_eikonal, num_total, eik_weight, dtype, want_wgrad = cfg
        k = len(wb) // 2
        dW, db, dlat, sdf_l, eik_l = fused_point_grads(
            decoder, wb[:k], wb[k:], lat_rows.detach(), xyz, gt, clamp_dist, use_eikonal,
            num_total, eik_weight, dtype, want_wgrad,
        )
        ctx.n_wb = len(wb)
        ctx.save_for_backward(dlat, *(dW + db if want_wgrad else ()))
        ctx.mark_non_differentiable(sdf_l, eik_l)
        return sdf_l + eik_l, sdf_l, eik_l

    @staticmethod
    def backward(ctx, ct, _ct_sdf, _ct_eik):
        dlat, *rest = ctx.saved_tensors
        wb = [g * ct for g in rest] if rest else [None] * ctx.n_wb
        return (None, dlat * ct, None, None, *wb)


def _decoder_weights(decoder):
    n = decoder.num_layers - 1
    return ([decoder.layer_weight(layer) for layer in range(n)],
            [getattr(decoder, f"lin{layer}").bias for layer in range(n)])


def fused_sdf_loss(decoder, lat_rows, xyz, gt, clamp_dist, use_eikonal, num_total,
                   eik_weight: float = 0.002, dtype: torch.dtype = torch.bfloat16):
    """(sdf + eikonal, sdf, eikonal) of one (micro)batch through K2,
    differentiable with respect to ``lat_rows`` and the decoder's
    parameters. ``gt`` [B, P] unclipped."""
    weights, biases = _decoder_weights(decoder)
    cfg = (decoder, clamp_dist, use_eikonal, num_total, eik_weight, dtype, True)
    return FusedSdfLoss.apply(cfg, lat_rows, xyz, gt, *weights, *biases)


def fused_sdf_l1(decoder, lat_rows, xyz, gt, clamp_dist, train_net: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
    """The Stage-2 SDF-consistency term through K2, the counterpart of
    ``make_fused_sdf_l1`` (``msd_tpu/ops/fused_train.py:558-617``):
    ``sum |clip(pred) - clip(gt)| / (B * P)`` of the decoder at ``lat_rows``
    [B, L] on ``xyz`` [B, P, 3] against ``gt`` [B, P] (unclipped),
    differentiable with respect to ``lat_rows`` and, with ``train_net``
    (variant a), the decoder's parameters. ``train_net=False`` runs variant
    d: no weight-gradient products, and the decoder gets no gradient."""
    B, P = xyz.shape[:2]
    weights, biases = _decoder_weights(decoder)
    if not train_net:
        weights, biases = [w.detach() for w in weights], [b.detach() for b in biases]
    cfg = (decoder, clamp_dist, False, B * P, 0.0, dtype, bool(train_net))
    return FusedSdfLoss.apply(cfg, lat_rows, xyz, gt, *weights, *biases)[0]
