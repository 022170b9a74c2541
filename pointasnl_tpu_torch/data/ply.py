"""PLY point-cloud / mesh IO (binary + ascii read, binary little-endian write),
the port's numpy copy of ``pointasnl_tpu/data/ply.py``: the same files read
to the same arrays, and the same arrays written to the same bytes.

Same API surface as the reference's utils/ply_helper.py (read_ply:116,
write_ply:217) — used by the ScanNet grid pipeline for subsampled-cloud caches
and mesh vertices — on top of numpy structured arrays.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

# PLY scalar type <-> numpy dtype letter
_PLY_TO_NP = {
    "int8": "i1",
    "char": "i1",
    "uint8": "u1",
    "uchar": "u1",
    "int16": "i2",
    "short": "i2",
    "uint16": "u2",
    "ushort": "u2",
    "int32": "i4",
    "int": "i4",
    "uint32": "u4",
    "uint": "u4",
    "float32": "f4",
    "float": "f4",
    "float64": "f8",
    "double": "f8",
}

_NP_TO_PLY = {
    "int8": "char",
    "uint8": "uchar",
    "int16": "short",
    "uint16": "ushort",
    "int32": "int",
    "uint32": "uint",
    "float32": "float",
    "float64": "double",
    "int64": "int",  # downcast on write, like the reference
    "uint64": "uint",
}

_FORMAT_BYTEORDER = {"ascii": "", "binary_little_endian": "<", "binary_big_endian": ">"}


class _Header:
    def __init__(self):
        self.fmt = None
        self.elements: List[Tuple[str, int, List[Tuple[str, str]]]] = []


def _parse_header(f) -> _Header:
    h = _Header()
    first = f.readline().strip()
    if first != b"ply":
        raise ValueError("not a PLY file")
    current = None
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        line = line.strip()
        if line.startswith(b"comment"):
            continue
        if line.startswith(b"format"):
            parts = line.split()
            h.fmt = parts[1].decode()
            continue
        if line.startswith(b"element"):
            parts = line.split()
            current = (parts[1].decode(), int(parts[2]), [])
            h.elements.append(current)
            continue
        if line.startswith(b"property"):
            parts = line.split()
            if parts[1] == b"list":
                # (list, count_type, item_type, name)
                current[2].append(
                    ("__list__" + parts[4].decode(), parts[2].decode() + ":" + parts[3].decode())
                )
            else:
                current[2].append((parts[2].decode(), _PLY_TO_NP[parts[1].decode()]))
            continue
        if line == b"end_header":
            break
    return h


def read_ply(filename: str, triangular_mesh: bool = False):
    """Read a .ply file into a structured numpy array.

    Returns the vertex data as a structured array; with triangular_mesh=True
    also returns the (F, 3) int32 face array — matching the reference's
    read_ply(:116) contract.
    """
    with open(filename, "rb") as f:
        h = _parse_header(f)
        bo = _FORMAT_BYTEORDER[h.fmt]

        out_vertex = None
        out_faces = None
        for name, count, props in h.elements:
            if name == "vertex":
                dtype = np.dtype([(p[0], bo + p[1]) for p in props])
                if h.fmt == "ascii":
                    out_vertex = np.loadtxt(f, dtype=dtype, max_rows=count)
                else:
                    out_vertex = np.fromfile(f, dtype=dtype, count=count)
            elif name == "face":
                cnt_t, item_t = props[0][1].split(":")
                if h.fmt == "ascii":
                    rows = [f.readline().split() for _ in range(count)]
                    out_faces = np.array([r[1:4] for r in rows], dtype=np.int32)
                else:
                    face_dtype = np.dtype(
                        [("k", bo + _PLY_TO_NP[cnt_t]), ("v", bo + _PLY_TO_NP[item_t], (3,))]
                    )
                    data = np.fromfile(f, dtype=face_dtype, count=count)
                    out_faces = data["v"].astype(np.int32)
            else:
                # skip unknown element payload (binary only; rare)
                dtype = np.dtype([(p[0], bo + p[1]) for p in props if not p[0].startswith("__list__")])
                np.fromfile(f, dtype=dtype, count=count)

    if triangular_mesh:
        return out_vertex, out_faces
    return out_vertex


def _normalize_field_list(field_list):
    field_list = (
        list(field_list) if isinstance(field_list, (list, tuple)) else [field_list]
    )
    fields = []
    for f in field_list:
        arr = np.asarray(f)
        if arr.ndim == 1:
            arr = arr[:, None]
        if arr.ndim != 2:
            raise ValueError("write_ply fields must be 1D or 2D arrays")
        fields.append(arr)
    n = fields[0].shape[0]
    if any(f.shape[0] != n for f in fields):
        raise ValueError("write_ply fields must share the leading dimension")
    return fields


def write_ply(
    filename: str,
    field_list,
    field_names: Sequence[str],
    triangular_faces: Optional[np.ndarray] = None,
) -> bool:
    """Write a binary little-endian .ply (reference write_ply:217 contract).

    field_list: array or list of arrays (columns are flattened in order);
    field_names: one name per total column; triangular_faces: (F, 3) ints.
    """
    if not filename.endswith(".ply"):
        filename += ".ply"
    fields = _normalize_field_list(field_list)
    ncols = sum(f.shape[1] for f in fields)
    if ncols != len(field_names):
        raise ValueError(f"{ncols} columns but {len(field_names)} field names")

    n = fields[0].shape[0]
    cols = []
    for f in fields:
        for j in range(f.shape[1]):
            cols.append(f[:, j])

    with open(filename, "wb") as fh:
        lines = ["ply", "format binary_little_endian 1.0"]
        lines.append(f"element vertex {n}")
        dtypes = []
        for name, col in zip(field_names, cols):
            npname = col.dtype.name
            if npname not in _NP_TO_PLY:
                raise ValueError(f"unsupported dtype {npname} for field {name}")
            lines.append(f"property {_NP_TO_PLY[npname]} {name}")
            letter = _PLY_TO_NP[_NP_TO_PLY[npname]]
            dtypes.append((name, "<" + letter))
        if triangular_faces is not None:
            lines.append(f"element face {triangular_faces.shape[0]}")
            lines.append("property list uchar int vertex_indices")
        lines.append("end_header")
        fh.write(("\n".join(lines) + "\n").encode("ascii"))

        rec = np.empty(n, dtype=np.dtype(dtypes))
        for (name, _), col in zip(dtypes, cols):
            rec[name] = col
        rec.tofile(fh)

        if triangular_faces is not None:
            F = triangular_faces.shape[0]
            face_rec = np.empty(F, dtype=np.dtype([("k", "u1"), ("v", "<i4", (3,))]))
            face_rec["k"] = 3
            face_rec["v"] = triangular_faces.astype(np.int32)
            face_rec.tofile(fh)
    return True

