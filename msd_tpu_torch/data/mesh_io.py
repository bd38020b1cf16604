"""Mesh and point-cloud IO (PLY, OBJ) without third-party mesh libraries.

Counterpart of ``msd_tpu/data/mesh_io.py``: the same PLY layout (vertex
x/y/z float32, face ``vertex_indices`` as uchar count + int32 indices, the
layout the reference writes, deep_sdf/mesh.py:143-158), byte for byte.
Binary triangle faces are read in one vectorised pass.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Return (vertices [V,3] f32, faces [F,3] i32)."""
    verts, faces = [], []
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif line.startswith("f "):
                idx = []
                for token in line.split()[1:]:
                    i = int(token.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append((idx[0], idx[k], idx[k + 1]))
    return (
        np.asarray(verts, np.float32),
        np.asarray(faces, np.int32).reshape(-1, 3),
    )


def save_ply(
    path: str,
    vertices: np.ndarray,
    faces: Optional[np.ndarray] = None,
    binary: bool = True,
):
    """Write a PLY mesh or point cloud (vertex x/y/z f4, face vertex_indices
    i4 — the layout the reference writes, deep_sdf/mesh.py:143-158)."""
    vertices = np.ascontiguousarray(np.asarray(vertices, np.float32).reshape(-1, 3))
    nv = vertices.shape[0]
    nf = 0 if faces is None else int(np.asarray(faces).shape[0])
    fmt = "binary_little_endian" if binary else "ascii"
    header = [
        "ply",
        f"format {fmt} 1.0",
        f"element vertex {nv}",
        "property float x",
        "property float y",
        "property float z",
    ]
    if faces is not None:
        header += [
            f"element face {nf}",
            "property list uchar int vertex_indices",
        ]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            if vertices.dtype == np.dtype("<f4"):
                f.write(memoryview(vertices).cast("B"))  # no copy
            else:
                f.write(vertices.astype("<f4").tobytes())
            if faces is not None:
                faces = np.asarray(faces, np.int32)
                rec = np.empty(nf, dtype=[("n", "u1"), ("idx", "<i4", (3,))])
                rec["n"] = 3
                rec["idx"] = faces
                f.write(rec.tobytes())
        else:
            for v in vertices:
                f.write(f"{v[0]} {v[1]} {v[2]}\n".encode("ascii"))
            if faces is not None:
                for face in np.asarray(faces, np.int64):
                    f.write(f"3 {face[0]} {face[1]} {face[2]}\n".encode("ascii"))


def load_ply(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Return (vertices [V,3] f32, faces [F,3] i32 or None).

    Handles ascii and binary_little_endian PLY with arbitrary extra vertex
    properties (only x/y/z are kept).
    """
    with open(path, "rb") as f:
        data = f.read()
    # --- parse header ---
    end = data.find(b"end_header")
    if end < 0:
        raise ValueError(f"not a PLY file: {path}")
    header_end = data.find(b"\n", end) + 1
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    fmt = None
    elements = []  # (name, count, [(prop_name, dtype_or_list)])
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append((parts[4], ("list", _PLY_DTYPES[parts[2]], _PLY_DTYPES[parts[3]])))
            else:
                elements[-1][2].append((parts[2], _PLY_DTYPES[parts[1]]))
    body = data[header_end:]

    verts, faces = None, None
    if fmt == "ascii":
        tokens = body.decode("ascii", errors="replace").split()
        pos = 0
        for name, count, props in elements:
            if name == "vertex":
                width = len(props)
                arr = np.array(tokens[pos : pos + count * width], dtype=np.float64).reshape(count, width)
                cols = [i for i, (p, _) in enumerate(props) if p in ("x", "y", "z")]
                verts = arr[:, cols].astype(np.float32)
                pos += count * width
            elif name == "face":
                rows = []
                for _ in range(count):
                    n = int(tokens[pos]); pos += 1
                    rows.append([int(t) for t in tokens[pos : pos + n]])
                    pos += n
                faces = _fan(rows)
            else:
                # skip unknown ascii element conservatively (fixed width only)
                pos += count * len(props)
    elif fmt == "binary_little_endian":
        offset = 0
        for name, count, props in elements:
            if all(not isinstance(d, tuple) for _, d in props):
                dtype = np.dtype([(p, "<" + d) for p, d in props])
                arr = np.frombuffer(body, dtype=dtype, count=count, offset=offset)
                offset += dtype.itemsize * count
                if name == "vertex":
                    verts = np.stack(
                        [arr["x"], arr["y"], arr["z"]], axis=1
                    ).astype(np.float32)
            elif name == "face" and (tri := _triangles(body, offset, count, props)) is not None:
                faces = tri["idx"].astype(np.int32)
                offset += tri.dtype.itemsize * count
            else:
                rows = []
                for _ in range(count):
                    _, cdt, idt = props[0][1]
                    csize = np.dtype(cdt).itemsize
                    n = int(np.frombuffer(body, dtype="<" + cdt, count=1, offset=offset)[0])
                    offset += csize
                    isize = np.dtype(idt).itemsize
                    rows.append(
                        np.frombuffer(body, dtype="<" + idt, count=n, offset=offset).tolist()
                    )
                    offset += isize * n
                if name == "face":
                    faces = _fan(rows)
    else:
        raise ValueError(f"unsupported PLY format {fmt!r} in {path}")
    if verts is None:
        raise ValueError(f"no vertex element in {path}")
    return verts, faces


def _triangles(body, offset, count, props):
    """Structured view of a binary face element whose rows all hold 3
    indices (one list property), else None."""
    if len(props) != 1 or not isinstance(props[0][1], tuple):
        return None
    _, cdt, idt = props[0][1]
    dtype = np.dtype([("n", "<" + cdt), ("idx", "<" + idt, (3,))])
    if len(body) - offset < dtype.itemsize * count:
        return None
    arr = np.frombuffer(body, dtype=dtype, count=count, offset=offset)
    return arr if np.all(arr["n"] == 3) else None


def _fan(rows) -> np.ndarray:
    tris = []
    for r in rows:
        for k in range(1, len(r) - 1):
            tris.append((r[0], r[k], r[k + 1]))
    return np.asarray(tris, np.int32).reshape(-1, 3)


def load_mesh(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Dispatch on extension."""
    ext = path.rsplit(".", 1)[-1].lower()
    if ext == "obj":
        return load_obj(path)
    if ext == "ply":
        return load_ply(path)
    raise ValueError(f"unsupported mesh format: {path}")

