"""Point-cloud files, numpy only (counterpart of rap_tpu/utils/ply.py).

- ``read_ply_points`` (the reader :38-162): the x, y, z of the vertex element
  of ASCII and binary little/big-endian PLY files; other properties and
  elements (faces) are skipped.
- ``write_ply`` (:165): binary little-endian x, y, z as float32, the files the
  evaluator's artifacts hold.
- ``write_pcd`` (:215) and ``read_pcd`` (:272): binary PCD v0.7, x, y, z and
  an optional uint32-packed rgb, for the part-coloured trajectory steps.
The other formats of the JAX module are not needed by the port.
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


def write_ply(path, points: np.ndarray) -> None:
    """Write (N, 3) points as a binary little-endian PLY (float32 x, y, z)."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {len(points)}",
              "property float x", "property float y", "property float z", "end_header"]
    with open(Path(path), "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        f.write(np.ascontiguousarray(points).astype("<f4").tobytes())


def write_pcd(path, points: np.ndarray, colors: np.ndarray | None = None) -> None:
    """Write a binary PCD v0.7: x, y, z and, with ``colors`` ((N, 3) float in
    [0, 1] or uint8), the PCL rgb packed as a uint32 (TYPE U)."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    n = points.shape[0]
    names = ["x", "y", "z"]
    if colors is not None:
        c = np.asarray(colors)
        if c.dtype != np.uint8:
            c = (np.clip(c, 0.0, 1.0) * 255).astype(np.uint8)
        c = c.reshape(-1, 3).astype(np.uint32)
        names.append("rgb")
    rec = np.empty(n, dtype=np.dtype([(k, "<u4" if k == "rgb" else "<f4") for k in names]))
    rec["x"], rec["y"], rec["z"] = points[:, 0], points[:, 1], points[:, 2]
    if colors is not None:
        rec["rgb"] = (c[:, 0] << 16) | (c[:, 1] << 8) | c[:, 2]
    k = len(names)
    header = ("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
              f"FIELDS {' '.join(names)}\nSIZE {' '.join(['4'] * k)}\n"
              f"TYPE {' '.join(['F'] * 3 + ['U'] * (k - 3))}\nCOUNT {' '.join(['1'] * k)}\n"
              f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA binary\n")
    with open(Path(path), "wb") as f:
        f.write(header.encode())
        f.write(rec.tobytes())


def read_pcd(path, dtype=np.float32) -> dict[str, np.ndarray]:
    """Read a binary PCD of ``write_pcd``: {"points" (N, 3)[, "colors" (N, 3)
    uint8]}."""
    with open(Path(path), "rb") as f:
        header = {}
        while "DATA" not in header:
            line = f.readline().decode().strip()
            if not line.startswith("#"):
                key, _, val = line.partition(" ")
                header[key] = val
        if header["DATA"] != "binary":
            raise ValueError(f"{path}: only binary PCD is read, got DATA {header['DATA']}")
        fields = header["FIELDS"].split()
        types = {"F": "<f4", "U": "<u4", "I": "<i4"}
        dt = np.dtype([(k, types[t]) for k, t in zip(fields, header["TYPE"].split())])
        n = int(header["POINTS"])
        rec = np.frombuffer(f.read(dt.itemsize * n), dtype=dt, count=n)
    out = {"points": np.stack([rec["x"], rec["y"], rec["z"]], axis=-1).astype(dtype)}
    if "rgb" in fields:
        u = rec["rgb"]
        out["colors"] = np.stack([(u >> 16) & 255, (u >> 8) & 255, u & 255],
                                 axis=-1).astype(np.uint8)
    return out
