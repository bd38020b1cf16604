"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled by ``nvcc`` for ``sm_90a`` into ``msd_tpu_torch/_build/`` (listed
in ``.gitignore``) under a name keyed on a hash of the source and the
flags, so an edit rebuilds, and is loaded with ``ctypes``. Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# ctypes signatures of each library's exported functions
_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_PI = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "fused_mlp": {
        "msd_fused_mlp_wgmma": (
            ctypes.c_int,
            [ctypes.c_int, _P, _P, ctypes.c_longlong, _P, ctypes.c_int, _P, _PP, _PP, _PP, _PP, _PI, _PI, _PI,
             ctypes.c_int, _P, ctypes.c_longlong, _P],
        ),
        "msd_fused_mlp_wgmma_scratch_bytes": (ctypes.c_longlong, [ctypes.c_longlong]),
        "msd_fused_mlp_f32": (
            ctypes.c_int,
            [ctypes.c_int, _P, _P, ctypes.c_longlong, _PP, _P, _PP, _PP, _PP, _PP, _PI, _PI, _PI, ctypes.c_int, _P],
        ),
        "msd_fused_mlp_wgmma_wide": (
            ctypes.c_int,
            [ctypes.c_int, _P, _P, ctypes.c_longlong, _P, ctypes.c_int, _P, _PP, _PP, _PP, _PP, _PI, _PI, _PI,
             ctypes.c_int, ctypes.c_longlong, _P, ctypes.c_longlong, _P],
        ),
        "msd_fused_mlp_f32_wide": (
            ctypes.c_int,
            [ctypes.c_int, _P, _P, ctypes.c_longlong, _PP, _P, _PP, _PP, _PP, _PP, _PI, _PI, _PI, ctypes.c_int,
             ctypes.c_longlong, _P, ctypes.c_longlong, _P],
        ),
        "msd_fused_mlp_wide_scratch_per_block": (ctypes.c_longlong, [ctypes.c_int, ctypes.c_int, _PI, _PI, _PP]),
        "msd_fused_mlp_smem_bytes": (ctypes.c_longlong, [ctypes.c_int]),
        "msd_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    },
    "fused_fit": {
        "msd_fit_consts": (ctypes.c_int, [ctypes.c_int, _P, ctypes.c_int, ctypes.c_int, _PP, _PP, _PP, _PI, _P]),
        "msd_fit_first": (
            ctypes.c_int,
            [_P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
             _P, _P, _P],
        ),
        "msd_fit_gemm": (
            ctypes.c_int,
            [_P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_int, _P, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P],
        ),
        "msd_fit_last": (
            ctypes.c_int,
            [_P, ctypes.c_int, _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_float, _P, _P],
        ),
        "msd_fit_loss": (ctypes.c_int, [_P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P]),
        "msd_fit_grad": (
            ctypes.c_int,
            [ctypes.c_int, _PP, _PP, _PI, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P],
        ),
        "msd_fit_error_string": (ctypes.c_char_p, [ctypes.c_int]),
        "msd_fit_tile": (ctypes.c_int, []),
        "msd_fit_width_pad": (ctypes.c_int, []),
        "msd_fit_max_groups": (ctypes.c_int, []),
    },
    "fused_train": {
        "msd_ft_chain": (
            ctypes.c_int,
            [_P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P, _P, _P, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, _P, _P, _P, _P],
        ),
        "msd_ft_wgrad": (
            ctypes.c_int,
            [_P, _P, ctypes.c_longlong, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             _P, _P],
        ),
        "msd_ft_last": (
            ctypes.c_int,
            [_P, _P, ctypes.c_int, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_float, _P, _P, _P, _P, _P, _P, _P],
        ),
        "msd_ft_eik": (
            ctypes.c_int,
            [_P, _P, ctypes.c_int, _P, _P, ctypes.c_int, _P, _P, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, _P, _P, _P, _P],
        ),
        "msd_ft_skinny": (
            ctypes.c_int,
            [_P, _P, ctypes.c_longlong, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P],
        ),
        "msd_ft_dynamic_smem": (ctypes.c_int, [ctypes.c_int, ctypes.c_int]),
        "msd_ft_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    },
}


class KernelError(RuntimeError):
    """A kernel of the port did not build or did not launch: a fault of the
    card or its toolchain, never of the data it was given."""


_LOCK = threading.Lock()
_LIBS: dict = {}
# nvcc's report (registers, shared memory, spills) of the latest build
BUILD_LOGS: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise KernelError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return path


def library_path(name: str) -> str:
    """Path of the built library for ``csrc/<name>.cu`` at its current hash."""
    h = hashlib.sha256()
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def _start_build(name: str):
    """Start nvcc for ``name`` (None when already built): (Popen, tmp, out)."""
    out = library_path(name)
    if os.path.isfile(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    BUILD_LOGS[name] = log
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise KernelError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)


def build(names) -> None:
    """Compile every named kernel source, one nvcc process each, all
    started together; raises if any fails."""
    with _LOCK:
        jobs = {n: _start_build(n) for n in names}
        errors = []
        for n, job in jobs.items():
            if job is None:
                continue
            try:
                _finish_build(n, job)
            except KernelError as e:
                errors.append(str(e))
        if errors:
            raise KernelError("\n".join(errors))


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build([name])
    with _LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(library_path(name))
            for fn, (restype, argtypes) in _SIGNATURES[name].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _LIBS[name] = lib
        return _LIBS[name]


KERNEL_SOURCES = tuple(sorted(_SIGNATURES))
