"""PLY point-cloud reader, numpy only (counterpart of the reader in
rap_tpu/utils/ply.py:38-162).

Reads the x, y, z of the vertex element of ASCII and binary little/big-endian
PLY files; other properties and elements (faces) are skipped. Writing and
the other formats of the JAX module are not needed by the port's data path.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def _header(f, path):
    """(format, vertex count, [(name, numpy type)]) of the vertex element."""
    if f.readline().strip() != b"ply":
        raise ValueError(f"{path}: not a PLY file")
    fmt, n_vertex, props, in_vertex = None, 0, [], False
    while True:
        line = f.readline()
        if not line:
            raise ValueError(f"{path}: unexpected EOF in header")
        tok = line.strip().split()
        if not tok:
            continue
        key = tok[0]
        if key == b"format":
            fmt = tok[1].decode()
        elif key == b"element":
            in_vertex = tok[1] == b"vertex"
            if in_vertex:
                n_vertex = int(tok[2])
        elif key == b"property" and in_vertex:
            if tok[1] == b"list":
                raise ValueError(f"{path}: list property on vertex")
            props.append((tok[2].decode(), _PLY_TYPES[tok[1].decode()]))
        elif key == b"end_header":
            return fmt, n_vertex, props


def read_ply_points(path, dtype=np.float32) -> np.ndarray:
    """The vertices' coordinates, (N, 3) in ``dtype``."""
    path = Path(path)
    with open(path, "rb") as f:
        fmt, n_vertex, props = _header(f, path)
        names = [p[0] for p in props]
        if fmt == "ascii":
            rows = [f.readline().split() for _ in range(n_vertex)]
            arr = (np.array(rows, dtype=np.float64) if rows
                   else np.zeros((0, len(names))))
            data = {n: arr[:, i] for i, n in enumerate(names)}
        else:
            endian = "<" if fmt == "binary_little_endian" else ">"
            dt = np.dtype([(n, endian + t) for n, t in props])
            rec = np.frombuffer(f.read(dt.itemsize * n_vertex), dtype=dt, count=n_vertex)
            data = {n: rec[n] for n in names}
    return np.stack([data["x"], data["y"], data["z"]], axis=-1).astype(dtype)
