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
989 TFLOP/s, and 49.25 ms at the 67 TFLOP/s float32 FMA peak. The TPU
kernel kept every weight resident on chip; 3.15 MB of bf16 weights do not
fit a block's 227 KB of shared memory, so the Hopper kernels stream weight
tiles from the (L2-resident) weights past a tile of points' activations.
The decoder picks one of four routes, each one kernel, once, when its
``FusedDecoderSpec`` is built (``spec.route``, ``route_for``), by operand
type and by width:

* ``"wgmma"``: bf16 operands, with or without LayerNorm, hidden widths up
  to 512 (every shipped config): 128-point blocks on ``wgmma``, the
  activations in shared memory, the weights laid out here once
  (``wtiles``) and copied in 32 KB tiles through an mbarrier ring. A
  LayerNorm layer 512 wide keeps its first N tile's float32 values in a
  device scratch (``wgmma_scratch_bytes``) until the row statistics exist.
* ``"wgmma_wide"``: bf16 operands, a hidden layer wider than 512 or none:
  the same blocks and weight tiles, each beside the K tile of the
  activations it multiplies, which live in a per-block device scratch
  (``wide_scratch_per_block``).
* ``"f32"``: float32 operands, with or without LayerNorm, hidden widths up
  to 512: 64-point blocks on exact float32 FMAs, each warp 8 rows by the
  whole layer width, the activations in shared memory, the weights laid
  out here once K-major (``wk``) and copied in 16-deep K tiles through an
  mbarrier ring.
* ``"f32_wide"``: float32 operands, wider decoders: 512 outputs per pass,
  the weights pass-major (``f32_pass_weights``), the activations in a
  per-block device scratch.

A failed build or launch raises on every route; nothing retries on another
kernel or route.

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

# The wgmma route: hidden widths padded to multiples of its 256-wide N tile;
# weight tiles of [WGMMA_TILE_N][WGMMA_TILE_K]; the wide kernel's blocks
# hold WGMMA_WIDE_BM points.
WGMMA_TILE_N, WGMMA_TILE_K, WGMMA_WIDE_BM = 256, 64, 128
# The f32 route: hidden widths padded to multiples of 64; the wide kernel
# computes F32_PASS outputs per pass; 64-point blocks.
F32_TILE_N, F32_PASS, F32_BM = 64, 512, 64
# Widest hidden layer of the kernels that keep the activations in shared
# memory; a wider decoder, or one with no hidden layer, takes a "_wide" route.
NARROW_MAX_WIDTH = 512
ROUTES = ("wgmma", "wgmma_wide", "f32", "f32_wide")
WGMMA_ROUTES = ("wgmma", "wgmma_wide")
# Weight bytes above which the config is refused, as the TPU kernel does
# (``msd_tpu/ops/fused_mlp.py:98``).
MAX_WEIGHT_BYTES = 10 * 1024 * 1024
# Most device scratch one launch of a wide kernel takes. That scratch is
# per persistent block, so past the cap a launch runs fewer blocks (at least
# one) over all its points.
SCRATCH_CAP_BYTES = 2**28

# Kernel launches on CUDA tensors (comparisons with the plain version
# included); callers reset it to 0 to count the launches of a run.
LAUNCHES = 0
# The same launches by route, that is by kernel; callers reset it with
# ``dict.fromkeys(ROUTES, 0)``.
ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}


class UnsupportedConfig(ValueError):
    """A decoder the TPU kernel refuses too (``xyz_in_all``, weights over
    ``MAX_WEIGHT_BYTES``): callers take the plain decoder instead."""


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def route_for(decoder, dtype: torch.dtype) -> str:
    """The route, that is the kernel, of a decoder at an operand type,
    LayerNorm or not: "wgmma" for bf16 operands and "f32" for float32, with
    "_wide" where a hidden layer is wider than ``NARROW_MAX_WIDTH`` or
    there is none."""
    hidden = [out_dim for (_, out_dim, _, _) in decoder.layer_shapes][:-1]
    wide = not hidden or max(hidden) > NARROW_MAX_WIDTH
    return ("wgmma" if dtype == torch.bfloat16 else "f32") + ("_wide" if wide else "")


def swizzle128(tiles: torch.Tensor) -> torch.Tensor:
    """[..., rows, 64] 2-byte tiles in the 128-byte swizzle of a wgmma
    descriptor (and of TMA's SWIZZLE_128B): row r's 16-byte chunk c moves to
    chunk c ^ (r % 8). The map is its own inverse."""
    rows = tiles.shape[-2]
    r = torch.arange(rows, device=tiles.device)
    idx = torch.arange(8, device=tiles.device)[None, :] ^ (r % 8)[:, None]  # [rows, 8]
    chunks = tiles.reshape(*tiles.shape[:-1], 8, 8)
    return chunks[..., r[:, None], idx, :].reshape(tiles.shape)


def f32_pass_weights(wp: torch.Tensor) -> torch.Tensor:
    """A layer's [out_pad, in_pad] float32 weights as the wide f32 kernel
    reads them: for each pass of ``F32_PASS`` outputs (the last one
    narrower), those rows transposed K-major, [in_pad][pass width], the
    passes one after another in one flat buffer."""
    return torch.cat([wp[c:c + F32_PASS].t().reshape(-1) for c in range(0, wp.shape[0], F32_PASS)])


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
    route's output tile (``WGMMA_TILE_N`` on the wgmma route,
    ``F32_TILE_N`` on the f32 route; both multiples of the 64-deep K tile).

    Layer l holds ``wp`` [out_pad, in_pad] (None for layer 0), ``wx``
    [out_pad, 3] (layer 0 and ``latent_in`` layers, else None), ``wz``
    [L, out_pad] float32 (applied to the latent outside the kernel),
    ``bias`` [out_pad] float32 and ``ln`` (scale, bias) [out_pad] float32
    or None. Padded rows and columns are zero, which is exact for ReLU
    layers; LayerNorm uses the true width ``out_true`` (its padded scale and
    bias are zero, so padded columns stay zero). The last layer has out_pad
    1. ``route`` names the route (``route_for``); on the two wgmma routes
    ``wtiles`` holds the hidden layers' ``wgmma_tiles`` of ``wp`` (layers 1
    to n_layers - 2) in one bf16 buffer, ``n_wtiles`` of them; on route
    f32 ``wk`` holds each hidden layer's ``wp`` transposed, K-major
    [in_pad, out_pad], on f32_wide its ``f32_pass_weights`` (None for layer
    0 and the last layer); on all ``wx4`` holds each layer's ``wx`` as float32 [out_pad, 4] (or
    None). ``kmax`` is the widest padded hidden width. Raises
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
        tile_n = WGMMA_TILE_N if self.route in WGMMA_ROUTES else F32_TILE_N
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
        self.wtiles, self.n_wtiles, self.wk = None, 0, None
        if self.route in WGMMA_ROUTES:
            tiles = [wgmma_tiles(w) for w in self.wp[1:-1]]
            self.n_wtiles = sum(t.shape[0] for t in tiles)
            self.wtiles = torch.cat([t.reshape(-1) for t in tiles]) if tiles else None
        else:
            lay = f32_pass_weights if self.route == "f32_wide" else (lambda w: w.t().contiguous())
            self.wk = [None if w is None else lay(w) for w in self.wp[:-1]] + [None]
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


def _ptr(t):
    return None if t is None else t.data_ptr()


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def fused_eval(spec: FusedDecoderSpec, latent: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """xyz [n, 3] float32 -> sdf [n] float32 through K1.

    On a CPU tensor: the plain version. On a CUDA tensor: the kernel of
    ``spec.route``, or an exception (bad input, failed build, refused
    launch)."""
    if xyz.device.type == "cpu":
        return fused_eval_plain(spec, latent, xyz)
    if xyz.device.type != "cuda":
        raise ValueError(f"fused_eval: unsupported device {xyz.device}")
    if spec.route in WGMMA_ROUTES:
        return _eval_wgmma(spec, latent, xyz)
    return _eval_f32(spec, latent, xyz)


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


def _ln_ptrs(spec: FusedDecoderSpec):
    """Per-layer LayerNorm scale and bias pointer arrays (null where none)."""
    return (_ptrs([None if ln is None else ln[0] for ln in spec.ln]),
            _ptrs([None if ln is None else ln[1] for ln in spec.ln]))


def wgmma_scratch_bytes(spec: FusedDecoderSpec, n: int) -> int:
    """Device scratch the wgmma kernel needs for ``n`` points on the current
    device: one block's share per SM the launch uses when a LayerNorm layer
    is 512 wide (its first N tile's float32 values wait there for the row
    statistics), else 0."""
    if n == 0 or not any(ln is not None and o == 2 * WGMMA_TILE_N for ln, o in zip(spec.ln, spec.out_pad)):
        return 0
    from msd_tpu_torch.ops._build import load_library

    need = load_library("fused_mlp").msd_fused_mlp_wgmma_scratch_bytes(n)
    if need < 0:
        raise KernelError("fused_mlp wgmma kernel: could not read the device's SM count")
    return need


def wide_scratch_per_block(spec: FusedDecoderSpec) -> int:
    """Device scratch one persistent block of a wide kernel needs
    (``msd_fused_mlp_wide_scratch_per_block``): two activation buffers of
    its point tile, as wide as the widest hidden layer whose output a later
    layer's products read (on the f32 route also the layer before the last
    when it has LayerNorm and products: its values wait there for the row
    statistics), and on the wgmma route the float32 values of the widest
    LayerNorm layer with products."""
    from msd_tpu_torch.ops._build import load_library

    return load_library("fused_mlp").msd_fused_mlp_wide_scratch_per_block(
        _DTYPE_CODE[spec.dtype], spec.n_layers, _ints(spec.in_pad), _ints(spec.out_pad), _ln_ptrs(spec)[0])


def wide_grid(tiles: int, per_block: int, sms: int) -> int:
    """Persistent blocks of a wide kernel's launch over ``tiles`` point
    tiles on a card with ``sms`` SMs: one per SM, or fewer when there are
    fewer tiles, or when their scratch (``per_block`` bytes each) would pass
    ``SCRATCH_CAP_BYTES`` (at least one)."""
    blocks = min(sms, tiles)
    return max(1, min(blocks, SCRATCH_CAP_BYTES // per_block)) if per_block else blocks


def _wide_launch(spec: FusedDecoderSpec, n: int, device):
    """(blocks, scratch tensor or None, its bytes) of a wide launch."""
    per_block = wide_scratch_per_block(spec)
    bm = WGMMA_WIDE_BM if spec.route == "wgmma_wide" else F32_BM
    grid = wide_grid(-(-n // bm), per_block, _sms(device))
    need = grid * per_block
    return grid, torch.empty(need, dtype=torch.uint8, device=device) if need else None, need


def _eval_wgmma(spec: FusedDecoderSpec, latent: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """The wgmma and wgmma_wide routes on a CUDA tensor."""
    xyz = _check(spec, xyz)
    if spec.route not in WGMMA_ROUTES:
        raise ValueError(f"fused_eval: a {spec.route} spec has no wgmma weight tiles")
    from msd_tpu_torch.ops._build import load_library

    lib = load_library("fused_mlp")
    n = xyz.shape[0]
    consts = spec.latent_consts(latent.to(xyz.device))
    out = torch.empty(n, dtype=torch.float32, device=xyz.device)
    if n == 0:
        return out
    wx, cl, (lns, lnb) = _ptrs(spec.wx4), _ptrs(consts), _ln_ptrs(spec)  # alive until the call returns
    layers = (wx, cl, lns, lnb, _ints(spec.in_pad), _ints(spec.out_pad), _ints(spec.out_true), int(spec.use_tanh))
    head = (spec.n_layers, xyz.data_ptr(), out.data_ptr(), n, _ptr(spec.wtiles), spec.n_wtiles, _ptr(spec.wp[-1]))
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    if spec.route == "wgmma_wide":
        grid, scratch, need = _wide_launch(spec, n, xyz.device)
        rc = lib.msd_fused_mlp_wgmma_wide(*head, *layers, grid, _ptr(scratch), need, stream)
    else:
        need = wgmma_scratch_bytes(spec, n)
        scratch = torch.empty(need, dtype=torch.uint8, device=xyz.device) if need else None
        rc = lib.msd_fused_mlp_wgmma(*head, *layers, _ptr(scratch), need, stream)
    if rc != 0:
        _raise(lib, rc, spec.route)
    _count(spec.route)
    return out


def _eval_f32(spec: FusedDecoderSpec, latent: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """The f32 and f32_wide routes on a CUDA tensor."""
    xyz = _check(spec, xyz)
    if spec.route in WGMMA_ROUTES:
        raise ValueError(f"fused_eval: a {spec.route} spec has no K-major float32 weights")
    from msd_tpu_torch.ops._build import load_library

    lib = load_library("fused_mlp")
    n = xyz.shape[0]
    consts = spec.latent_consts(latent.to(xyz.device))
    out = torch.empty(n, dtype=torch.float32, device=xyz.device)
    if n == 0:
        return out
    wk, wx, cl, (lns, lnb) = _ptrs(spec.wk), _ptrs(spec.wx4), _ptrs(consts), _ln_ptrs(spec)
    args = (spec.n_layers, xyz.data_ptr(), out.data_ptr(), n, wk, _ptr(spec.wp[-1]), wx, cl, lns, lnb,
            _ints(spec.in_pad), _ints(spec.out_pad), _ints(spec.out_true), int(spec.use_tanh))
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    if spec.route == "f32_wide":
        grid, scratch, need = _wide_launch(spec, n, xyz.device)
        rc = lib.msd_fused_mlp_f32_wide(*args, grid, _ptr(scratch), need, stream)
    else:
        rc = lib.msd_fused_mlp_f32(*args, stream)
    if rc != 0:
        _raise(lib, rc, spec.route)
    _count(spec.route)
    return out
