"""The plain versions of K2's per-point kernels (``last_plain``,
``last_rank1_plain``, ``eik_plain``, ``skinny_plain`` in
msd_tpu_torch/ops/fused_train.py) against a float64 numpy evaluation of the
formulas of msd_tpu's Pallas kernel (msd_tpu/ops/fused_train.py:216-227,
:235-259, :263, :267-270, :294-308), on seeded bf16 operands at widths 64
and 128; ``skinny_kernel``'s split arithmetic; and ``fused_train_plain``
computing those quantities through them, in all five variants.
"""

import numpy as np
import pytest
import torch

from msd_tpu_torch.ops import fused_train as ft

CLAMP = 0.1
W = 64


def bf16(rng, *shape, scale=1.0):
    """A seeded bf16 tensor and its float64 numpy copy."""
    t = torch.tensor(scale * rng.standard_normal(shape), dtype=torch.float32).to(torch.bfloat16)
    return t, t.double().numpy()


def close(got, ref, rtol=1e-5):
    """float32 against float64: within rtol of the reference's largest entry."""
    got = got.double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * max(np.abs(ref).max(), 1e-30))


def np_last(h, wl, c, gt, inv_ntot, w):
    """:216-227, :294-296 for rows of h [n, K]: (y, m tau, seed, l1)."""
    y = np.tanh(h @ wl + c)
    tau = 1.0 - y * y
    m = (np.abs(y) < CLAMP).astype(np.float64)
    yc = np.clip(y, -CLAMP, CLAMP)
    l1 = np.abs(yc - gt)
    seed = m * tau * np.sign(yc - gt) * inv_ntot
    if w is not None:
        l1, seed = l1 * w, seed * w
    return y, m * tau, seed, l1


def np_eik(u0, mx0, uL, mxL, y, seed, eik_coef, w):
    """:242-259, :275, :297 for gated rows: (gbar, l1 seed + sbar_e, eikonal lane)."""
    g = u0 @ mx0
    if uL is not None:
        g = g + uL @ mxL
    gn = np.sqrt(np.maximum((g * g).sum(1), 1e-24))
    lane = (1.0 - gn) ** 2
    gbar = (eik_coef * (gn - 1.0) / gn)[:, None] * g
    if w is not None:
        lane = lane * w
        gbar = gbar * w[:, None]
    return gbar, seed + (-2.0 * y) * (gbar * g).sum(1), lane


# name: (rows of the delta pair, rows of the gated pair (0: none), V columns)
SKINNY_CASES = {
    "dMx_b": (512, 512, 3),        # delta^T x + u^T gbar, every row gated
    "dMx_c": (512, 128, 3),        # the gated pair compact: E = 128 of P = 512
    "dMx_a": (512, 0, 3),          # no eikonal
    "dMp_last_c": (512, 256, 1),   # h^T delta + t^T m tau
}


@pytest.mark.parametrize("name", list(SKINNY_CASES))
def test_skinny_plain_matches_kernel_formulas(name):
    """:263, :269-270 (u^T gbar), :267-268 (t^T m tau) and :301-304 (the
    delta chain's d^T x, h^T delta): one float32 product per pair against
    float64, within 1e-5 of the largest entry."""
    n, ne, k = SKINNY_CASES[name]
    rng = np.random.default_rng(len(name))
    A0, a0 = bf16(rng, n, W)
    V0 = torch.tensor(rng.uniform(-1, 1, (n, k)), dtype=torch.float32)
    ref = a0.T @ V0.double().numpy()
    pair = (None, None)
    if ne:
        A1, a1 = bf16(rng, ne, W, scale=0.1)
        V1 = torch.tensor(rng.standard_normal((ne, k)), dtype=torch.float32)
        ref = ref + a1.T @ V1.double().numpy()
        pair = (A1, V1)
    got = ft.skinny_plain(A0, V0, *pair)
    assert got.dtype == torch.float32 and got.shape == (W, k)
    close(got, ref)


# name: (latent_in pair, weighted (variant e))
EIK_CASES = {"b": (True, False), "b_no_latent_in": (False, False), "e": (True, True), "e_no_latent_in": (False, True)}


@pytest.mark.parametrize("name", list(EIK_CASES))
def test_eik_plain_matches_kernel_formulas(name):
    """g, the eikonal lane, gbar and the delta seed of 256 gated rows
    against float64, a pad scene's rows weighted 0 under e."""
    with_latent, weighted = EIK_CASES[name]
    rng = np.random.default_rng(7 + len(name))
    n = 256
    u0, u0n = bf16(rng, n, W, scale=0.3)
    mx0, mx0n = bf16(rng, W, 3, scale=0.3)
    uL = mxL = uLn = mxLn = None
    if with_latent:
        uL, uLn = bf16(rng, n, 2 * W, scale=0.3)
        mxL, mxLn = bf16(rng, 2 * W, 3, scale=0.3)
    y = torch.tensor(rng.uniform(-0.2, 0.2, n), dtype=torch.float32)
    seed = torch.tensor(1e-4 * rng.standard_normal(n), dtype=torch.float32)
    w = torch.tensor(np.repeat([1.0, 0.0], n // 2), dtype=torch.float32) if weighted else None
    eik_coef = 2.0 * 0.002 / n
    mx0_4 = torch.cat([mx0.float(), torch.zeros(W, 1)], 1)  # the kernel's [W][4] layout: column 3 unread
    gbar, sbar, lane = ft.eik_plain(u0, mx0_4, uL, mxL, y, seed, eik_coef, w)
    ref = np_eik(u0n, mx0n, uLn, mxLn, y.double().numpy(), seed.double().numpy(), eik_coef,
                 None if w is None else w.double().numpy())
    for got, r in zip((gbar, sbar, lane), ref):
        assert got.dtype == torch.float32
        close(got, r)
    if weighted:  # a weight-0 row adds nothing but its L1 seed
        assert bool((lane[n // 2:] == 0).all()) and bool((gbar[n // 2:] == 0).all())
        assert torch.equal(sbar[n // 2:], seed[n // 2:])


@pytest.mark.parametrize("weighted", [False, True], ids=["b", "e"])
def test_last_plain_matches_kernel_formulas(weighted):
    rng = np.random.default_rng(3)
    n = 512
    h, hn = bf16(rng, n, W)
    h = torch.relu(h.float()).to(torch.bfloat16)
    hn = np.maximum(hn, 0.0)
    wl, wln = bf16(rng, W, scale=0.05)
    c = torch.tensor(0.05 * rng.standard_normal(n), dtype=torch.float32)
    gt = torch.tensor(np.clip(0.25 * rng.standard_normal(n), -CLAMP, CLAMP), dtype=torch.float32)
    w = torch.tensor(np.repeat([1.0, 0.0], n // 2), dtype=torch.float32) if weighted else None
    got = ft.last_plain(h, wl, c, gt, CLAMP, 1.0 / n, w)
    ref = np_last(hn, wln, c.double().numpy(), gt.double().numpy(), 1.0 / n, None if w is None else w.double().numpy())
    # a row within float32 rounding of the clamp would flip m; none is
    assert np.abs(np.abs(ref[0]) - CLAMP).min() > 1e-5
    for g, r in zip(got, ref):
        close(g, r)


# rows of one launch (both pairs), padded width: the flagship's chunk
# (65536 points, E = 16384 (b), 4096 (c) or none (a)) at its padded widths
# 512 and 256, and the toy protocol's (1536 points, width 128); one split's
# worth and fewer rows than one pass
SKINNY_PLANS = {
    "b_512": (2 * 65536, 512), "c_512": (65536 + 16384, 512), "a_512": (65536, 512), "b_256": (2 * 65536, 256),
    "toy_b_128": (2 * 1536, 128), "toy_a_128": (1536, 128), "one_pass": (128, 512), "short": (37, 128),
}


@pytest.mark.parametrize("name", list(SKINNY_PLANS))
def test_skinny_split_covers_rows_and_fills_sms(name):
    """skinny_kernel's rule: split i takes the rows [i c, (i + 1) c), c =
    ceil(rows / splits). Every row falls in exactly one split, no split
    runs less than a pass, and where the rows allow, the grid (splits x
    column groups) has SKINNY_BLOCKS_PER_SM blocks per SM."""
    rows, w = SKINNY_PLANS[name]
    s = ft.skinny_split(rows, w)
    groups = w // ft.SKINNY_COLS
    passes = -(-rows // ft.SKINNY_PASS_ROWS)
    c = -(-rows // s)
    assert 1 <= s <= passes
    assert (rows - 1) // c < s  # the last row, hence every row, falls in one of the splits
    full = ft.SKINNY_BLOCKS_PER_SM * ft.H100_SMS
    if passes * groups >= full:
        assert full <= s * groups < full + groups  # one wave of resident blocks
    else:
        assert s == passes


def test_fused_train_plain_goes_through_the_per_point_plain_versions(monkeypatch):
    """K2 b's plain version on a 5-layer decoder (latent_in 2), two
    chunks: each chunk calls last_plain and eik_plain once and skinny_plain
    three times (dMx of layers 0 and 2, the last layer's row)."""
    from msd_tpu_torch.models.deepsdf import DeepSDFDecoder

    calls = {"last_plain": 0, "eik_plain": 0, "skinny_plain": 0}
    for name in calls:
        fn = getattr(ft, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(ft, name, counted)
    monkeypatch.setattr(ft, "CHUNK_POINTS", 2 * 128)
    dec = DeepSDFDecoder(16, dims=[32] * 4, latent_in=[2], weight_norm=False, norm_layers=[],
                         generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    B, P = 4, 128
    weights = [dec.layer_weight(i).detach() for i in range(dec.num_layers - 1)]
    biases = [getattr(dec, f"lin{i}").bias.detach() for i in range(dec.num_layers - 1)]
    lat = torch.tensor(0.3 * rng.standard_normal((B, 16)), dtype=torch.float32)
    xyz = torch.tensor(rng.uniform(-1, 1, (B, P, 3)), dtype=torch.float32)
    gt = torch.tensor(0.25 * rng.standard_normal((B, P)), dtype=torch.float32)
    out = ft.fused_point_grads(dec, weights, biases, lat, xyz, gt, CLAMP, True, B * P, dtype=torch.float32)
    assert all(torch.isfinite(t).all() for t in out[0] + out[1])
    assert calls == {"last_plain": 2, "eik_plain": 2, "skinny_plain": 6}


# name: (rows, width, xv: "m_tau" (u-chain seeds, >= 0) or "seed" (signed
# delta seeds, some zero), rounding dtype)
RANK1_CASES = {
    "u_seed_bf16": (256, 64, "m_tau", torch.bfloat16),
    "delta_seed_bf16": (256, 128, "seed", torch.bfloat16),
    "delta_seed_f32": (128, 64, "seed", torch.float32),
}


@pytest.mark.parametrize("name", list(RANK1_CASES))
def test_last_rank1_plain_matches_numpy(name):
    """The rank-one last hidden layer D(h) xv w_last (:235-240 for the
    u-chain, :298, :305-308 for the delta chain) against float64 numpy:
    every product of two bf16 values is exact in float32, so the rounded
    rows equal numpy's rounded to the same type, masked and zero entries
    are +0, and the 64-row column sums are within 1e-6 of their largest."""
    n, k, kind, dtype = RANK1_CASES[name]
    rng = np.random.default_rng(11 + len(name))
    h, hn = bf16(rng, n, k)
    h = torch.relu(h.float()).to(torch.bfloat16)
    hn = np.maximum(hn, 0.0)
    wl, wln = bf16(rng, k, scale=0.05)
    if kind == "m_tau":
        xv, xvn = bf16(rng, n)
        xv, xvn = xv.abs(), np.abs(xvn)
    else:
        xv, xvn = bf16(rng, n, scale=1e-4)
        xv[::7], xvn[::7] = 0.0, 0.0
    out, colsum = ft.last_rank1_plain(h, wl, xv.float(), dtype)
    v = (hn > 0) * (xvn[:, None] * wln[None, :])
    assert out.dtype == torch.float32 and out.shape == (n, k) and colsum.shape == (n // 64, k)
    assert torch.equal(out, torch.tensor(v, dtype=torch.float32).to(dtype).float())
    assert not bool(torch.signbit(out[out == 0]).any())
    close(colsum, v.reshape(n // 64, 64, k).sum(1), rtol=1e-6)


# K2's five variants on a small decoder: name -> (P, eik_points, scene
# weights, use_eikonal, want_wgrad); c gates 256 of 512 points per scene
ROUTING_CASES = {
    "b": (256, None, None, True, True),
    "a": (256, None, None, False, True),
    "c": (512, 256, None, True, True),
    "d": (256, None, None, False, False),
    "e": (256, None, [1.0, 1.0, 1.0, 0.0], True, True),
}


@pytest.mark.parametrize("name", list(ROUTING_CASES))
def test_fused_train_plain_routes_the_rank_one_layer(name, monkeypatch):
    """fused_train_plain takes the last hidden layer's u (with an eikonal)
    and delta rows from last_rank1_plain, as the kernels take them from
    last_kernel, and gives what it gave with the product written inline
    (u_next @ W_last) * D and dc summed over each scene's rows: the same
    rank-one rows, every output within float32 summation order (1e-6 of
    the largest entry) in bf16, two chunks of two scenes."""
    from msd_tpu_torch.models.deepsdf import DeepSDFDecoder

    P, E, w, use_eik, want_wgrad = ROUTING_CASES[name]
    dec = DeepSDFDecoder(16, dims=[32] * 4, latent_in=[2], weight_norm=False, norm_layers=[],
                         generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(5)
    B = 4
    weights = [dec.layer_weight(i).detach() for i in range(dec.num_layers - 1)]
    biases = [getattr(dec, f"lin{i}").bias.detach() for i in range(dec.num_layers - 1)]
    lat = torch.tensor(0.3 * rng.standard_normal((B, 16)), dtype=torch.float32)
    xyz = torch.tensor(rng.uniform(-1, 1, (B, P, 3)), dtype=torch.float32)
    gt = torch.tensor(0.25 * rng.standard_normal((B, P)), dtype=torch.float32)
    kw = dict(dtype=torch.bfloat16, want_wgrad=want_wgrad, eik_points=E)
    if w is not None:
        kw.update(scene_weights=torch.tensor(w), n_real=int(sum(w)))
    monkeypatch.setattr(ft, "CHUNK_POINTS", 2 * P)
    calls = []
    rank1 = ft.last_rank1_plain

    def counted(h, wl, xv, dtype):
        calls.append(h.shape[0])
        return rank1(h, wl, xv, dtype)

    def inline(h, wl, xv, dtype):  # the product as written before; a scene's dc in one sum
        v = (xv[:, None] @ wl[None, :]) * (h > 0).float()
        cs = torch.zeros(v.shape[0] // 64, v.shape[1])
        cs[:: P // 64] = v.reshape(-1, P, v.shape[1]).sum(1)  # read for the delta rows only
        return v.to(dtype).float(), cs

    monkeypatch.setattr(ft, "last_rank1_plain", counted)
    got = ft.fused_point_grads(dec, weights, biases, lat, xyz, gt, CLAMP, use_eik, B * P, **kw)
    gated = ft.eikonal_rows(P, E, use_eik)
    assert calls == ([2 * gated, 2 * P] if use_eik else [2 * P]) * 2
    monkeypatch.setattr(ft, "last_rank1_plain", inline)
    ref = ft.fused_point_grads(dec, weights, biases, lat, xyz, gt, CLAMP, use_eik, B * P, **kw)

    def tensors(out):  # (dweights, dbiases, dlat, sdf, eikonal), flat; None where d has none
        return [t for part in out for t in (part if isinstance(part, list) else [part])]

    for x, y in zip(tensors(got), tensors(ref), strict=True):
        assert (x is None) == (y is None)
        if x is not None:
            close(x, y.double().numpy(), rtol=1e-6)

