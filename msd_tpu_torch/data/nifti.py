"""Minimal native NIfTI-1 reader (replaces nibabel for segmentation masks);
a copy of ``msd_tpu/data/nifti.py``.

Supports .nii / .nii.gz single-file NIfTI-1 with the common datatypes used
by segmentation masks. Returns the raw data array and voxel dimensions
(zooms), which is all the grooming pipeline needs
(ref: utils/batch_process_to_ply.py uses nib.load(...).get_fdata() and
header.get_zooms()).
"""

from __future__ import annotations

import gzip
import struct
from typing import Tuple

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}


def load_nifti(path: str) -> Tuple[np.ndarray, Tuple[float, float, float]]:
    """Returns (data [X, Y, Z(, ...)], zooms (dx, dy, dz) in mm)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()

    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    endian = "<"
    if sizeof_hdr != 348:
        endian = ">"
        sizeof_hdr = struct.unpack_from(">i", raw, 0)[0]
        if sizeof_hdr != 348:
            raise ValueError(f"not a NIfTI-1 file: {path}")
    magic = raw[344:348]
    if magic[:2] not in (b"n+", b"ni"):
        raise ValueError(f"bad NIfTI magic in {path}: {magic!r}")

    dim = struct.unpack_from(endian + "8h", raw, 40)
    ndim = dim[0]
    if not 1 <= ndim <= 7:
        raise ValueError(f"bad ndim {ndim} in {path}")
    shape = tuple(int(d) for d in dim[1 : 1 + ndim])
    datatype = struct.unpack_from(endian + "h", raw, 70)[0]
    if datatype not in _DTYPES:
        raise ValueError(f"unsupported NIfTI datatype {datatype} in {path}")
    pixdim = struct.unpack_from(endian + "8f", raw, 76)
    zooms = tuple(float(abs(p)) for p in pixdim[1:4])
    vox_offset = int(struct.unpack_from(endian + "f", raw, 108)[0])
    scl_slope = struct.unpack_from(endian + "f", raw, 112)[0]
    scl_inter = struct.unpack_from(endian + "f", raw, 116)[0]

    dt = np.dtype(_DTYPES[datatype]).newbyteorder(endian)
    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=dt, count=count, offset=vox_offset)
    data = data.reshape(shape, order="F").astype(np.float64)
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0 else 1.0
        data = data * slope + scl_inter
    return data, zooms


def save_nifti(path: str, data: np.ndarray, zooms=(1.0, 1.0, 1.0)):
    """Write a minimal float32/uint8 NIfTI-1 file (for tests/tooling)."""
    data = np.asarray(data)
    if data.dtype == np.uint8:
        datatype, bitpix = 2, 8
    else:
        data = data.astype(np.float32)
        datatype, bitpix = 16, 32
    header = bytearray(352)
    struct.pack_into("<i", header, 0, 348)
    dim = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", header, 40, *dim)
    struct.pack_into("<h", header, 70, datatype)
    struct.pack_into("<h", header, 72, bitpix)
    pixdim = [1.0] + list(zooms) + [1.0] * (7 - 3)
    struct.pack_into("<8f", header, 76, *pixdim[:8])
    struct.pack_into("<f", header, 108, 352.0)
    header[344:348] = b"n+1\x00"
    payload = bytes(header) + np.asfortranarray(data).tobytes(order="F")
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(payload)
