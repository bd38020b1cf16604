"""Fused DeepSDF decoder forward for SDF queries (K1), on Hopper.

Replaces ``msd_tpu/ops/fused_mlp.py:_fused_kernel_body`` (the Pallas TPU
kernel called at ``build_fused_eval``): one latent over N query points.
Per layer ``a = Mp·h (+ Mx·xyz) + c_l`` with ``c_l = z@W_z + b`` computed
once per latent outside the kernel, then optional LayerNorm (eps 1e-5)
and ReLU on all layers but the last, ``use_tanh`` on the last, and the
final tanh always. h is rounded to the operand type before each product;
products accumulate in float32 and the epilogue runs in float32.

The CUDA kernel is ``msd_tpu_torch/csrc/fused_mlp.cu``. What bounds it on
an H100: it is compute-bound. The flagship decoder
(``examples/ADNI/minimal_eikonal/specs.json``) keeps 1,573,376 weights in
the kernel, 3.147 MFLOP per point against 16 bytes of point I/O, so 2^20
points need at least 3.34 ms at the dense bf16 tensor-core peak of
989 TFLOP/s. The TPU kernel kept every weight resident on chip; 3.15 MB of
bf16 weights do not fit a block's 227 KB of shared memory, so the Hopper
kernel keeps a 64-point tile's activations in shared memory instead and
streams weight tiles from the (L2-resident) weights with ``cp.async``;
activations never touch device memory. Only decoders too wide for that
(hidden widths over 640) keep them in a device scratch, which
``fused_eval`` allocates at the size the kernel asks for. bf16 products
run on ``mma.sync.m16n8k16`` (fragments by ``ldmatrix``); float32
operands run on plain FMAs.

On a CPU tensor ``fused_eval`` computes the plain PyTorch version
(``fused_eval_plain``) with the same rounding points. On a CUDA tensor it
launches the kernel or raises; it never falls back. The kernel takes at
most 32 layers; a CUDA launch for a deeper decoder raises.
"""

from __future__ import annotations

import ctypes

import torch

from msd_tpu_torch.models.common import LAYER_NORM_EPS

# Output tile of the kernel per operand type: every hidden width is
# zero-padded to a multiple of it.
TILE_N = {torch.bfloat16: 128, torch.float32: 64}
# Weight bytes above which the config is refused, as the TPU kernel does
# (``msd_tpu/ops/fused_mlp.py:98``).
MAX_WEIGHT_BYTES = 10 * 1024 * 1024
# Most device scratch one launch takes (wide decoders only); larger point
# sets are split over several launches.
SCRATCH_CAP_BYTES = 2**28

# Kernel launches on CUDA tensors (comparisons with the plain version
# included); callers reset it to 0 to count the launches of a run.
LAUNCHES = 0

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}


class UnsupportedConfig(ValueError):
    """A decoder the TPU kernel refuses too (``xyz_in_all``, weights over
    ``MAX_WEIGHT_BYTES``): callers take the plain decoder instead."""


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class FusedDecoderSpec:
    """Per-layer weight splits for the fused kernel, zero-padded to the
    kernel's output tile (``TILE_N``, a multiple of its 64-deep K tile).

    Layer l holds ``wp`` [out_pad, in_pad] (None for layer 0), ``wx``
    [out_pad, 3] (layer 0 and ``latent_in`` layers, else None), ``wz``
    [L, out_pad] float32 (applied to the latent outside the kernel),
    ``bias`` [out_pad] float32 and ``ln`` (scale, bias) [out_pad] float32
    or None. Padded rows and columns are zero, which is exact for ReLU
    layers; LayerNorm uses the true width ``out_true``. The last layer has
    out_pad 1. Raises UnsupportedConfig for the configs the TPU kernel
    refuses too, and ValueError for an operand type other than bfloat16 or
    float32."""

    def __init__(self, decoder, dtype: torch.dtype = torch.bfloat16):
        if dtype not in _DTYPE_CODE:
            raise ValueError(f"fused kernel: operand dtype {dtype} is not ported (bfloat16 or float32)")
        if decoder.xyz_in_all:
            raise UnsupportedConfig("fused kernel: xyz_in_all not supported")
        self.dtype = dtype
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
                out_pad = 1 if last else _round_up(out_dim, TILE_N[dtype])

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
        self.kmax = max([TILE_N[dtype]] + self.out_pad[:-1])

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

    On a CPU tensor: the plain version. On a CUDA tensor: the CUDA kernel,
    or an exception (bad input, failed build, refused launch)."""
    if xyz.device.type == "cpu":
        return fused_eval_plain(spec, latent, xyz)
    if xyz.device.type != "cuda":
        raise ValueError(f"fused_eval: unsupported device {xyz.device}")
    if xyz.dtype != torch.float32 or xyz.dim() != 2 or xyz.shape[1] != 3:
        raise ValueError(f"fused_eval: xyz must be float32 [n, 3], got {xyz.dtype} {tuple(xyz.shape)}")
    if spec.bias[0].device != xyz.device:
        raise ValueError(f"fused_eval: spec on {spec.bias[0].device}, xyz on {xyz.device}")
    from msd_tpu_torch.ops._build import load_library

    lib = load_library("fused_mlp")
    code = _DTYPE_CODE[spec.dtype]
    xyz = xyz.contiguous()
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
    global LAUNCHES
    for start in range(0, n, chunk):
        size = min(chunk, n - start)
        rc = lib.msd_fused_mlp_forward(
            code, spec.n_layers, xyz[start].data_ptr(), out[start].data_ptr(), size, *arrays,
            spec.kmax, int(spec.use_tanh), None if scratch is None else scratch.data_ptr(), need, stream,
        )
        if rc != 0:
            raise RuntimeError(
                f"fused_mlp kernel launch failed: {lib.msd_cuda_error_string(rc).decode()} ({rc})"
            )
        LAUNCHES += 1
    return out
