"""Fused DeepSDF decoder forward for SDF queries (K1), on Hopper.

Replaces ``msd_tpu/ops/fused_mlp.py:_fused_kernel_body`` (the Pallas TPU
kernel called at ``build_fused_eval``): one latent over N query points.
Per layer ``a = Mp·h (+ Mx·xyz) + c_l`` with ``c_l = z@W_z + b`` computed
once per latent outside the kernel, then optional LayerNorm (eps 1e-5)
and ReLU on all layers but the last, ``use_tanh`` on the last, and the
final tanh always. h is rounded to the operand type before each product;
products accumulate in float32 and the epilogue runs in float32.

The CUDA kernels are in ``msd_tpu_torch/csrc/fused_mlp.cu``. What bounds
them on an H100: they are compute-bound. The flagship decoder
(``examples/ADNI/minimal_eikonal/specs.json``) keeps 1,573,376 weights in
the kernel, 3.147 MFLOP per point against 16 bytes of point I/O, so 2^20
points need at least 3.34 ms at the dense bf16 tensor-core peak of
989 TFLOP/s. The TPU kernel kept every weight resident on chip; 3.15 MB of
bf16 weights do not fit a block's 227 KB of shared memory, so the Hopper
kernels keep a tile of points' activations in shared memory instead and
stream weight tiles from the (L2-resident) weights; activations never
touch device memory. The decoder picks one of two routes, once, when its
``FusedDecoderSpec`` is built (``spec.route``):

* ``"wgmma"``: bf16 operands, no LayerNorm, hidden widths up to 512 (every
  shipped config). 128-point blocks on ``wgmma``, the weights laid out
  here once (``wtiles``) and copied in 32 KB tiles through an mbarrier
  ring.
* ``"mma_sync"``: every other config (LayerNorm, float32 operands, wider
  layers). 64-point (bf16) or 32-point (float32) blocks on
  ``mma.sync.m16n8k16`` or FMAs with ``cp.async`` weight tiles; decoders
  with hidden widths over 640 keep the activations in a device scratch,
  which ``fused_eval`` allocates at the size the kernel asks for.

A failed build or launch raises on either route; nothing retries on the
other one.

On a CPU tensor ``fused_eval`` computes the plain PyTorch version
(``fused_eval_plain``) with the same rounding points. On a CUDA tensor it
launches the kernel or raises; it never falls back. The kernel takes at
most 32 layers; a CUDA launch for a deeper decoder raises.
"""

from __future__ import annotations

import ctypes

import torch

from msd_tpu_torch.models.common import LAYER_NORM_EPS
from msd_tpu_torch.models.deepsdf import DeepSDFDecoder
from msd_tpu_torch.ops._build import KernelError

# Output tile of the mma_sync kernel per operand type: every hidden width
# is zero-padded to a multiple of it.
TILE_N = {torch.bfloat16: 128, torch.float32: 64}
# The wgmma route: hidden widths padded to multiples of its 256-wide N tile,
# at most WGMMA_MAX_WIDTH; weight tiles of [WGMMA_TILE_N][WGMMA_TILE_K].
WGMMA_TILE_N, WGMMA_TILE_K, WGMMA_MAX_WIDTH = 256, 64, 512
ROUTES = ("wgmma", "mma_sync")
# Weight bytes above which the config is refused, as the TPU kernel does
# (``msd_tpu/ops/fused_mlp.py:98``).
MAX_WEIGHT_BYTES = 10 * 1024 * 1024
# Most device scratch one launch takes (wide decoders only); larger point
# sets are split over several launches.
SCRATCH_CAP_BYTES = 2**28

# Kernel launches on CUDA tensors (comparisons with the plain version
# included); callers reset it to 0 to count the launches of a run.
LAUNCHES = 0
# The same launches by route; callers reset it with ``dict.fromkeys(ROUTES, 0)``.
ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}


class UnsupportedConfig(ValueError):
    """A decoder the TPU kernel refuses too (``xyz_in_all``, weights over
    ``MAX_WEIGHT_BYTES``): callers take the plain decoder instead."""


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def route_for(decoder, dtype: torch.dtype) -> str:
    """The kernel route of a decoder at an operand type: "wgmma" for bf16
    operands, no LayerNorm and hidden widths up to ``WGMMA_MAX_WIDTH``
    (padded to ``WGMMA_TILE_N``), else "mma_sync"."""
    hidden = [out_dim for (_, out_dim, _, _) in decoder.layer_shapes][:-1]
    if (dtype != torch.bfloat16 or not hidden
            or any(getattr(decoder, f"bn{layer}", None) is not None for layer in range(len(hidden)))
            or any(_round_up(w, WGMMA_TILE_N) > WGMMA_MAX_WIDTH for w in hidden)):
        return "mma_sync"
    return "wgmma"


def swizzle128(tiles: torch.Tensor) -> torch.Tensor:
    """[..., rows, 64] 2-byte tiles in the 128-byte swizzle of a wgmma
    descriptor (and of TMA's SWIZZLE_128B): row r's 16-byte chunk c moves to
    chunk c ^ (r % 8). The map is its own inverse."""
    rows = tiles.shape[-2]
    r = torch.arange(rows, device=tiles.device)
    idx = torch.arange(8, device=tiles.device)[None, :] ^ (r % 8)[:, None]  # [rows, 8]
    chunks = tiles.reshape(*tiles.shape[:-1], 8, 8)
    return chunks[..., r[:, None], idx, :].reshape(tiles.shape)


def wgmma_tiles(wp: torch.Tensor) -> torch.Tensor:
    """A layer's [out_pad, in_pad] weights as the wgmma kernel reads them:
    [out_pad / 256 * in_pad / 64, 256, 64] tiles, N tile major, each
    swizzled (``swizzle128``)."""
    out_pad, in_pad = wp.shape
    t = wp.reshape(out_pad // WGMMA_TILE_N, WGMMA_TILE_N, in_pad // WGMMA_TILE_K, WGMMA_TILE_K)
    t = t.permute(0, 2, 1, 3).reshape(-1, WGMMA_TILE_N, WGMMA_TILE_K)
    return swizzle128(t)


class FusedDecoderSpec:
    """Per-layer weight splits for the fused kernel, zero-padded to the
    route's output tile (``WGMMA_TILE_N`` on the wgmma route, else
    ``TILE_N``; both multiples of the 64-deep K tile).

    Layer l holds ``wp`` [out_pad, in_pad] (None for layer 0), ``wx``
    [out_pad, 3] (layer 0 and ``latent_in`` layers, else None), ``wz``
    [L, out_pad] float32 (applied to the latent outside the kernel),
    ``bias`` [out_pad] float32 and ``ln`` (scale, bias) [out_pad] float32
    or None. Padded rows and columns are zero, which is exact for ReLU
    layers; LayerNorm uses the true width ``out_true``. The last layer has
    out_pad 1. ``route`` names the kernel (``route_for``); on the wgmma
    route ``wtiles`` holds the hidden layers' ``wgmma_tiles`` of ``wp``
    (layers 1 to n_layers - 2) in one bf16 buffer, ``n_wtiles`` of them, and
    ``wx4`` each layer's ``wx`` as float32 [out_pad, 4] (or None). Raises
    UnsupportedConfig for the configs the TPU kernel refuses too (another
    decoder than ``DeepSDFDecoder``, ``xyz_in_all``, weights over
    ``MAX_WEIGHT_BYTES``), and ValueError for an operand type other than bfloat16 or float32."""

    def __init__(self, decoder, dtype: torch.dtype = torch.bfloat16):
        if dtype not in _DTYPE_CODE:
            raise ValueError(f"fused kernel: operand dtype {dtype} is not ported (bfloat16 or float32)")
        if not isinstance(decoder, DeepSDFDecoder):  # msd_tpu/ops/fused_mlp.py:21 serves DeepSDFDecoder only
            raise UnsupportedConfig(f"fused kernel: {type(decoder).__name__} is not a DeepSDFDecoder")
        if decoder.xyz_in_all:
            raise UnsupportedConfig("fused kernel: xyz_in_all not supported")
        self.dtype = dtype
        self.route = route_for(decoder, dtype)
        tile_n = WGMMA_TILE_N if self.route == "wgmma" else TILE_N[dtype]
        self.use_tanh = decoder.use_tanh
        self.n_layers = decoder.num_layers - 1
        L = decoder.latent_size
        self.wp, self.wx, self.wz, self.bias, self.ln = [], [], [], [], []
        self.in_pad, self.out_pad, self.out_true = [], [], []
        weight_bytes = 0
        prev_pad = 0
        with torch.no_grad():
            for layer, (in_dim, out_dim, _, _) in enumerate(decoder.layer_shapes):
                w = decoder.layer_weight(layer).detach().float()  # [out, in]
                b = getattr(decoder, f"lin{layer}").bias.detach().float()
                dev = w.device
                if layer == 0:
                    w_prev, w_z, w_xyz = None, w[:, :L], w[:, L:]
                elif layer in decoder.latent_in:
                    in_prev = in_dim - (L + 3)
                    w_prev = w[:, :in_prev]
                    w_z = w[:, in_prev:in_prev + L]
                    w_xyz = w[:, in_prev + L:]
                else:
                    w_prev, w_z, w_xyz = w, None, None
                last = layer == self.n_layers - 1
                out_pad = 1 if last else _round_up(out_dim, tile_n)

                def pad_rows(t, cols):
                    z = torch.zeros(out_pad, cols, dtype=torch.float32, device=dev)
                    z[: t.shape[0], : t.shape[1]] = t
                    return z

                self.wp.append(None if w_prev is None else pad_rows(w_prev, prev_pad).to(dtype).contiguous())
                self.wx.append(None if w_xyz is None else pad_rows(w_xyz, 3).to(dtype).contiguous())
                self.wz.append(None if w_z is None else pad_rows(w_z, L).t().contiguous())
                self.bias.append(pad_rows(b[:, None], 1)[:, 0].contiguous())
                bn = getattr(decoder, f"bn{layer}", None)
                if bn is None:
                    self.ln.append(None)
                else:
                    self.ln.append((
                        pad_rows(bn.weight.detach().float()[:, None], 1)[:, 0].contiguous(),
                        pad_rows(bn.bias.detach().float()[:, None], 1)[:, 0].contiguous(),
                    ))
                self.in_pad.append(prev_pad)
                self.out_pad.append(out_pad)
                self.out_true.append(out_dim)
                weight_bytes += (w.numel() + b.numel()) * (2 if dtype == torch.bfloat16 else 4)
                prev_pad = out_pad
        if weight_bytes > MAX_WEIGHT_BYTES:
            raise UnsupportedConfig(f"fused kernel: weights too large ({weight_bytes} B)")
        self.kmax = max([tile_n] + self.out_pad[:-1])
        self.wtiles, self.n_wtiles, self.wx4 = None, 0, None
        if self.route == "wgmma":
            tiles = [wgmma_tiles(w) for w in self.wp[1:-1]]
            self.n_wtiles = sum(t.shape[0] for t in tiles)
            self.wtiles = torch.cat([t.reshape(-1) for t in tiles]) if tiles else None
            self.wx4 = [None if w is None else torch.nn.functional.pad(w.float(), (0, 1)).contiguous()
                        for w in self.wx]

    def latent_consts(self, latent: torch.Tensor):
        """Per-layer [out_pad] float32: z @ W_z + b (bias folded in)."""
        latent = latent.reshape(-1).float()
        return [
            b if wz is None else b + latent @ wz
            for b, wz in zip(self.bias, self.wz)
        ]


def _mm(a: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """a [n, k] @ w[out, k].T with both rounded to ``dtype`` and a float32
    product and sum (exact products of bf16 values, float32 accumulation)."""
    return a.to(dtype).float() @ w.float().t()


def fused_eval_plain(spec: FusedDecoderSpec, latent: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: xyz [n, 3] float32 -> sdf [n]."""
    consts = spec.latent_consts(latent.to(xyz.device))
    h = None
    for layer in range(spec.n_layers):
        acc = None
        if spec.wp[layer] is not None:
            acc = _mm(h, spec.wp[layer], spec.dtype)
        if spec.wx[layer] is not None:
            part = _mm(xyz, spec.wx[layer], spec.dtype)
            acc = part if acc is None else acc + part
        h = acc + consts[layer]
        if layer == spec.n_layers - 1:
            if spec.use_tanh:
                h = torch.tanh(h)
            break
        if spec.ln[layer] is not None:
            scale, bias = spec.ln[layer]
            true = h[:, : spec.out_true[layer]]
            mean = true.mean(dim=1, keepdim=True)
            var = ((true - mean) ** 2).mean(dim=1, keepdim=True)
            h = (h - mean) * torch.rsqrt(var + LAYER_NORM_EPS) * scale + bias
        h = torch.relu(h)
    return torch.tanh(h)[:, 0]


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[None if t is None else t.data_ptr() for t in tensors])


def _ints(values):
    return (ctypes.c_int * len(values))(*values)


def fused_eval(spec: FusedDecoderSpec, latent: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """xyz [n, 3] float32 -> sdf [n] float32 through K1.

    On a CPU tensor: the plain version. On a CUDA tensor: the kernel of
    ``spec.route``, or an exception (bad input, failed build, refused
    launch)."""
    if xyz.device.type == "cpu":
        return fused_eval_plain(spec, latent, xyz)
    if xyz.device.type != "cuda":
        raise ValueError(f"fused_eval: unsupported device {xyz.device}")
    if spec.route == "wgmma":
        return _eval_wgmma(spec, latent, xyz)
    return _eval_mma_sync(spec, latent, xyz)


def _check(spec: FusedDecoderSpec, xyz: torch.Tensor) -> torch.Tensor:
    if xyz.dtype != torch.float32 or xyz.dim() != 2 or xyz.shape[1] != 3:
        raise ValueError(f"fused_eval: xyz must be float32 [n, 3], got {xyz.dtype} {tuple(xyz.shape)}")
    if spec.bias[0].device != xyz.device:
        raise ValueError(f"fused_eval: spec on {spec.bias[0].device}, xyz on {xyz.device}")
    return xyz.contiguous()


def _count(route: str) -> None:
    global LAUNCHES
    LAUNCHES += 1
    ROUTE_LAUNCHES[route] += 1


def _raise(lib, rc: int, route: str):
    raise KernelError(f"fused_mlp {route} kernel launch failed: {lib.msd_cuda_error_string(rc).decode()} ({rc})")


def _eval_wgmma(spec: FusedDecoderSpec, latent: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """The wgmma route on a CUDA tensor."""
    xyz = _check(spec, xyz)
    if spec.route != "wgmma":
        raise ValueError(f"fused_eval: a {spec.route} spec has no wgmma weight tiles")
    from msd_tpu_torch.ops._build import load_library

    lib = load_library("fused_mlp")
    n = xyz.shape[0]
    consts = spec.latent_consts(latent.to(xyz.device))
    out = torch.empty(n, dtype=torch.float32, device=xyz.device)
    if n == 0:
        return out
    wx, cl = _ptrs(spec.wx4), _ptrs(consts)  # alive until the call returns
    rc = lib.msd_fused_mlp_wgmma(
        spec.n_layers, xyz.data_ptr(), out.data_ptr(), n,
        None if spec.wtiles is None else spec.wtiles.data_ptr(), spec.n_wtiles, spec.wp[-1].data_ptr(),
        wx, cl, _ints(spec.in_pad), _ints(spec.out_pad), int(spec.use_tanh),
        torch.cuda.current_stream(xyz.device).cuda_stream,
    )
    if rc != 0:
        _raise(lib, rc, "wgmma")
    _count("wgmma")
    return out


def _eval_mma_sync(spec: FusedDecoderSpec, latent: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """The mma_sync route on a CUDA tensor (any spec: the flagship's too,
    for measurements)."""
    xyz = _check(spec, xyz)
    from msd_tpu_torch.ops._build import load_library

    lib = load_library("fused_mlp")
    code = _DTYPE_CODE[spec.dtype]
    n = xyz.shape[0]
    consts = spec.latent_consts(latent.to(xyz.device))
    out = torch.empty(n, dtype=torch.float32, device=xyz.device)
    ln_s = [None if ln is None else ln[0] for ln in spec.ln]
    ln_b = [None if ln is None else ln[1] for ln in spec.ln]
    # keep every array alive until the launch calls return
    arrays = (
        _ptrs(spec.wp), _ptrs(spec.wx), _ptrs(consts), _ptrs(ln_s), _ptrs(ln_b),
        _ints(spec.in_pad), _ints(spec.out_pad), _ints(spec.out_true),
    )
    chunk = max(n, 1)
    need = lib.msd_fused_mlp_scratch_bytes(code, spec.kmax, chunk)
    if need > SCRATCH_CAP_BYTES:
        chunk = max(1, chunk * SCRATCH_CAP_BYTES // need)
        need = lib.msd_fused_mlp_scratch_bytes(code, spec.kmax, chunk)
    scratch = torch.empty(need, dtype=torch.uint8, device=xyz.device) if need else None
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    for start in range(0, n, chunk):
        size = min(chunk, n - start)
        rc = lib.msd_fused_mlp_forward(
            code, spec.n_layers, xyz[start].data_ptr(), out[start].data_ptr(), size, *arrays,
            spec.kmax, int(spec.use_tanh), None if scratch is None else scratch.data_ptr(), need, stream,
        )
        if rc != 0:
            _raise(lib, rc, "mma_sync")
        _count("mma_sync")
    return out
