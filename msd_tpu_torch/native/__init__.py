"""The port's C++ host code, built with ``g++`` and loaded with ctypes.

``SOURCES`` are compiled into one library with ``msd_tpu``'s flags
(``-O3 -march=native -std=c++17 -shared -fPIC``), so on one host both
packages run the same machine code and give the same bits:
``raster.cpp``, the software rasterizer of the render visibility pass
(``msd_tpu_torch/render.py``), ``marching_tets.cpp``, the host mesher of
``ops/marching_cubes.marching_tetrahedra_blocks`` and, through its
streaming entry points (``mt_create``, ``mt_add_blocks``,
``mt_ply_stream_*``, ``mt_finish*``, ``mt_destroy``), of the streaming
``create_mesh`` (``mesh._create_mesh_streaming_impl``), and ``codec.cpp``,
the decoder of the "packed" value codec (``msd_decode_packed``, used by
``mesh._decode_packed_host``); all three are copies of
``msd_tpu/native/``'s.

The library is built at first use into ``msd_tpu_torch/_build/`` (listed
in ``.gitignore``) under a name keyed on the sources, the flags and the
host's CPU features: ``-march=native`` code is specific to the CPU that
compiled it. A failed build raises ``RuntimeError``. Unlike ``msd_tpu``,
which then returns ``None`` and lets ``preprocess_mesh`` fall back to
all-face sampling, the port never continues without the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "_build")
SOURCES = ("raster.cpp", "marching_tets.cpp", "codec.cpp")
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIB = None

_F = ctypes.POINTER(ctypes.c_float)
_I32 = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.POINTER(ctypes.c_int64)
_U8 = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {
    "rast_render": (None, [
        _F, ctypes.c_int64, _I32, ctypes.c_int64, _F, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, _U8, _F, _I32,
    ]),
    "rast_visibility": (None, [
        _F, ctypes.c_int64, _I32, ctypes.c_int64, _F, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, _U8, _I64, _I64,
    ]),
    # as msd_tpu/native/__init__.py:72-129 declares them
    "mt_blocks": (ctypes.c_int, [
        _F, _I32, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64, _U8,
        ctypes.POINTER(_F), _I64, ctypes.POINTER(_I32), _I64,
    ]),
    "mt_free": (None, [ctypes.c_void_p]),
    "mt_create": (ctypes.c_void_p, [ctypes.c_int64, _U8, ctypes.c_int64]),
    "mt_add_blocks": (None, [ctypes.c_void_p, _F, _I32, ctypes.c_int64, ctypes.c_int32]),
    "mt_finish": (ctypes.c_int, [ctypes.c_void_p, ctypes.POINTER(_F), _I64, ctypes.POINTER(_I32), _I64]),
    "mt_finish_view": (ctypes.c_int, [ctypes.c_void_p, ctypes.POINTER(_F), _I64, ctypes.POINTER(_I32), _I64]),
    "mt_destroy": (None, [ctypes.c_void_p]),
    "mt_ply_stream_begin": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_float, ctypes.c_float,
    ]),
    "mt_ply_stream_finish": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_char_p]),
    # bitmaps [K, 16], mags [n_mags], K, n_mags, pts, q, out [K, pts]
    "msd_decode_packed": (ctypes.c_int64, [
        _U8, _U8, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_float, _F,
    ]),
    "msd_codec_simd": (ctypes.c_int32, []),
}


def host_fingerprint() -> str:
    """Hash of the host CPU's feature flags (a copy of ``msd_tpu``'s
    ``utils/compile_cache._host_fingerprint``)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    feats = " ".join(sorted(line.split(":", 1)[1].split()))
                    return hashlib.sha256(feats.encode()).hexdigest()[:12]
    except OSError:
        pass
    return hashlib.sha256(platform.processor().encode()).hexdigest()[:12]


def library_path() -> str:
    """Path of the library for the current sources, flags and host."""
    h = hashlib.sha256()
    for src in SOURCES:
        with open(os.path.join(_PKG_DIR, src), "rb") as f:
            h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(host_fingerprint().encode())
    return os.path.join(BUILD_DIR, f"libmsd_native_{h.hexdigest()[:16]}.so")


def build(out_path: str) -> None:
    """Compile ``SOURCES`` into ``out_path``; raises ``RuntimeError`` when
    the compiler is missing or fails."""
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    tmp = f"{out_path}.{os.getpid()}.tmp"
    cmd = [CXX, *CXX_FLAGS, *(os.path.join(_PKG_DIR, s) for s in SOURCES), "-o", tmp]
    logging.info("building native library: %s", " ".join(cmd))
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native build failed: cannot run {CXX!r}: {e}") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"native build failed ({' '.join(cmd)}):\n{proc.stderr}")
    os.replace(tmp, out_path)


def load_native() -> ctypes.CDLL:
    """The ctypes library, built on first use; raises if it cannot be built."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = library_path()
            if not os.path.isfile(path):
                build(path)
            lib = ctypes.CDLL(path)
            for fn, (restype, argtypes) in _SIGNATURES.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _LIB = lib
        return _LIB
