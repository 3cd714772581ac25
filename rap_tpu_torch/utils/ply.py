"""Point-cloud files, numpy only (a copy of rap_tpu/utils/ply.py; the port
imports nothing of rap_tpu).

- PLY (``read_ply``, ``read_ply_points``, ``write_ply``): ASCII and binary
  little/big-endian; vertex x, y, z [, nx, ny, nz] [, red, green, blue]; the
  faces of mesh PLYs (polygons fan-triangulated).
- PCD v0.7 (``write_pcd``, ``read_pcd``): x, y, z and an optional
  uint32-packed rgb, binary or ASCII.
- LAS (``read_las``, ``write_las``): uncompressed, x, y, z only.

rap_tpu reads PLY vertices through its C++ core when that is built; the port
keeps the numpy reader only (same values).
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


def read_ply_points(path, dtype=np.float32) -> np.ndarray:
    """The vertices' coordinates, (N, 3) in ``dtype``."""
    return read_ply(path, read_faces=False, dtype=dtype)["points"]


def read_ply(path, read_faces: bool = True, dtype=np.float32) -> dict[str, np.ndarray]:
    """Read vertex data. Returns dict with 'points' (N,3), optionally
    'normals' (N,3), 'colors' (N,3) u8, and — for mesh PLYs — 'faces'
    (F,3) i64 (polygons fan-triangulated).

    ``dtype``: output coordinate dtype. Pass np.float64 for georeferenced
    clouds whose large-coordinate content must survive until a global shift
    (float32 quantizes UTM-scale coordinates to several cm)."""
    path = Path(path)
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n_vertex = 0
        props: list[tuple[str, str]] = []
        in_vertex = False
        n_face = 0
        in_face = False
        face_list_types: tuple[str, str] | None = None  # (count_t, index_t)
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
            elif key == b"comment" or key == b"obj_info":
                continue
            elif key == b"element":
                name = tok[1].decode()
                count = int(tok[2])
                in_vertex = name == "vertex"
                in_face = name == "face"
                if in_vertex:
                    n_vertex = count
                elif in_face:
                    n_face = count
            elif key == b"property":
                if tok[1] == b"list":
                    if in_vertex:
                        raise ValueError(f"{path}: list property on vertex")
                    if in_face and tok[4] in (b"vertex_indices", b"vertex_index"):
                        face_list_types = (
                            _PLY_TYPES[tok[2].decode()],
                            _PLY_TYPES[tok[3].decode()],
                        )
                    continue
                if in_vertex:
                    props.append((tok[2].decode(), _PLY_TYPES[tok[1].decode()]))
            elif key == b"end_header":
                break

        names = [p[0] for p in props]
        faces: list | None = None
        if fmt == "ascii":
            rows = []
            for _ in range(n_vertex):
                rows.append(f.readline().split())
            arr = (
                np.array(rows, dtype=np.float64)
                if rows
                else np.zeros((0, len(names)))  # 'element vertex 0' files
            )
            data = {n: arr[:, i] for i, n in enumerate(names)}
            if read_faces and n_face and face_list_types:
                faces = []
                for _ in range(n_face):
                    tok = f.readline().split()
                    k = int(tok[0])
                    ids = [int(t) for t in tok[1 : 1 + k]]
                    for j in range(1, k - 1):
                        faces.append([ids[0], ids[j], ids[j + 1]])
        else:
            endian = "<" if fmt == "binary_little_endian" else ">"
            dt = np.dtype([(n, endian + t) for n, t in props])
            raw = f.read(dt.itemsize * n_vertex)
            rec = np.frombuffer(raw, dtype=dt, count=n_vertex)
            data = {n: rec[n] for n in names}
            if read_faces and n_face and face_list_types:
                cnt_t = np.dtype(endian + face_list_types[0])
                idx_t = np.dtype(endian + face_list_types[1])
                buf = f.read()
                # fast path: all-triangle meshes (the overwhelmingly common
                # case) parse as one strided record view
                tri_stride = cnt_t.itemsize + 3 * idx_t.itemsize
                all_tris = False
                if len(buf) == n_face * tri_stride:
                    tri_dt = np.dtype(
                        [("k", cnt_t), ("ids", idx_t, (3,))]
                    )
                    tri = np.frombuffer(buf, tri_dt, n_face)
                    all_tris = bool((tri["k"] == 3).all())
                    if all_tris:
                        faces = tri["ids"].astype(np.int64).tolist()
                if not all_tris:
                    faces = []
                    off = 0
                    for _ in range(n_face):
                        k = int(np.frombuffer(buf, cnt_t, 1, off)[0])
                        off += cnt_t.itemsize
                        ids = np.frombuffer(buf, idx_t, k, off).astype(np.int64)
                        off += k * idx_t.itemsize
                        for j in range(1, k - 1):
                            faces.append([ids[0], ids[j], ids[j + 1]])

    out: dict[str, np.ndarray] = {
        "points": np.stack(
            [data["x"], data["y"], data["z"]], axis=-1
        ).astype(dtype)
    }
    if all(k in data for k in ("nx", "ny", "nz")):
        out["normals"] = np.stack(
            [data["nx"], data["ny"], data["nz"]], axis=-1
        ).astype(np.float32)
    if all(k in data for k in ("red", "green", "blue")):
        out["colors"] = np.stack(
            [data["red"], data["green"], data["blue"]], axis=-1
        ).astype(np.uint8)
    if faces:
        out["faces"] = np.asarray(faces, np.int64)
    return out


def write_ply(
    path,
    points: np.ndarray,
    normals: np.ndarray | None = None,
    colors: np.ndarray | None = None,
    binary: bool = True,
) -> None:
    """Write a point cloud (N,3) with optional normals (N,3) / colors (N,3 u8)."""
    path = Path(path)
    points = np.asarray(points, np.float32).reshape(-1, 3)
    n = points.shape[0]
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    header = [
        "ply",
        "format binary_little_endian 1.0" if binary else "format ascii 1.0",
        f"element vertex {n}",
        "property float x",
        "property float y",
        "property float z",
    ]
    if normals is not None:
        normals = np.asarray(normals, np.float32).reshape(-1, 3)
        fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
        header += ["property float nx", "property float ny", "property float nz"]
    if colors is not None:
        colors = np.asarray(colors, np.uint8).reshape(-1, 3)
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        header += [
            "property uchar red",
            "property uchar green",
            "property uchar blue",
        ]
    header.append("end_header")

    rec = np.empty(n, dtype=np.dtype(fields))
    rec["x"], rec["y"], rec["z"] = points[:, 0], points[:, 1], points[:, 2]
    if normals is not None:
        rec["nx"], rec["ny"], rec["nz"] = normals[:, 0], normals[:, 1], normals[:, 2]
    if colors is not None:
        rec["red"], rec["green"], rec["blue"] = colors[:, 0], colors[:, 1], colors[:, 2]

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if binary:
            f.write(rec.tobytes())
        else:
            cols = [rec[name] for name, _ in fields]
            np.savetxt(f, np.column_stack(cols), fmt="%.6g")


def write_pcd(
    path,
    points: np.ndarray,
    colors: np.ndarray | None = None,
    binary: bool = True,
) -> None:
    """Minimal PCD v0.7 writer: xyz [+ PCL-packed rgb].

    Replaces the reference's Open3D ``write_point_cloud`` for the per-ODE-step
    ``step_k.pcd`` artifacts (ref evaluator.py:744-825). Colors are (N,3)
    float in [0,1] or uint8, packed into the standard PCL float-rgb field.
    """
    path = Path(path)
    points = np.asarray(points, np.float32).reshape(-1, 3)
    n = points.shape[0]
    if colors is not None:
        c = np.asarray(colors)
        if c.dtype != np.uint8:
            c = (np.clip(c, 0.0, 1.0) * 255).astype(np.uint8)
        c = c.reshape(-1, 3)
        rgb_u32 = (
            (c[:, 0].astype(np.uint32) << 16)
            | (c[:, 1].astype(np.uint32) << 8)
            | c[:, 2].astype(np.uint32)
        )
        # TYPE U (uint32) rgb: exact in ascii too (the PCL packed-float rgb
        # does not survive decimal printing)
        fields, sizes, types, counts = "x y z rgb", "4 4 4 4", "F F F U", "1 1 1 1"
        rec = np.empty(n, dtype=np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("rgb", "<u4")]))
        rec["rgb"] = rgb_u32
    else:
        fields, sizes, types, counts = "x y z", "4 4 4", "F F F", "1 1 1"
        rec = np.empty(n, dtype=np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4")]))
    rec["x"], rec["y"], rec["z"] = points[:, 0], points[:, 1], points[:, 2]
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {fields}\n"
        f"SIZE {sizes}\n"
        f"TYPE {types}\n"
        f"COUNT {counts}\n"
        f"WIDTH {n}\n"
        "HEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            f.write(rec.tobytes())
        else:
            cols = [rec[name] for name in rec.dtype.names]
            # %.9g: uint32 rgb needs 8 digits to survive the float detour
            np.savetxt(f, np.column_stack(cols), fmt="%.9g")


def read_pcd(path, dtype=np.float32) -> dict[str, np.ndarray]:
    """Minimal PCD reader for round-trip tests: returns {'points', 'colors'?}."""
    path = Path(path)
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode().strip()
            if line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key] = val
            if key == "DATA":
                break
        fields = header["FIELDS"].split()
        typecodes = header["TYPE"].split()
        n = int(header["POINTS"])
        np_types = {"F": "<f4", "U": "<u4", "I": "<i4"}
        dt = np.dtype(
            [(name, np_types[t]) for name, t in zip(fields, typecodes)]
        )
        if header["DATA"] == "binary":
            rec = np.frombuffer(f.read(dt.itemsize * n), dtype=dt)
        else:
            arr = np.loadtxt(f, dtype=np.float64).reshape(n, len(fields))
            rec = {name: arr[:, i].astype(dt[name]) for i, name in enumerate(fields)}
    out = {"points": np.stack([rec["x"], rec["y"], rec["z"]], axis=-1).astype(dtype)}
    if "rgb" in fields:
        u = np.ascontiguousarray(rec["rgb"])
        u = u.view(np.uint32) if u.dtype != np.uint32 else u
        out["colors"] = np.stack(
            [(u >> 16) & 255, (u >> 8) & 255, u & 255], axis=-1
        ).astype(np.uint8)
    return out


def read_las(path) -> dict[str, np.ndarray]:
    """Minimal uncompressed-LAS reader (versions 1.0-1.4, any point format).

    Every LAS point record begins with x, y, z as int32 to be scaled by the
    header's scale/offset doubles (LAS spec §2) — that is all the runtime
    needs, so no laspy dependency for plain .las (compressed .laz still
    requires an external decoder and stays gated in the webapp).
    """
    import struct

    with open(path, "rb") as f:
        head = f.read(375)
        if head[:4] != b"LASF":
            raise ValueError(f"{path}: not a LAS file")
        ver_minor = head[25]
        offset_to_points = struct.unpack_from("<I", head, 96)[0]
        record_len = struct.unpack_from("<H", head, 105)[0]
        n = struct.unpack_from("<I", head, 107)[0]  # legacy count
        if ver_minor >= 4:
            n64 = struct.unpack_from("<Q", head, 247)[0]
            n = n64 or n
        sx, sy, sz = struct.unpack_from("<3d", head, 131)
        ox, oy, oz = struct.unpack_from("<3d", head, 155)
        f.seek(offset_to_points)
        raw = f.read(record_len * n)
    rec = np.frombuffer(raw, dtype=np.uint8, count=record_len * n)
    rec = rec.reshape(n, record_len)
    xyz = rec[:, :12].copy().view("<i4").reshape(n, 3).astype(np.float64)
    pts = xyz * np.array([sx, sy, sz]) + np.array([ox, oy, oz])
    return {"points": pts}


def write_las(path, points: np.ndarray, scale: float = 1e-3) -> None:
    """Minimal LAS 1.2 point-format-0 writer (testing + interchange)."""
    import struct

    pts = np.asarray(points, np.float64)
    n = len(pts)
    off = pts.min(axis=0) if n else np.zeros(3)
    header_size = 227
    record_len = 20
    head = bytearray(header_size)
    head[0:4] = b"LASF"
    head[24] = 1
    head[25] = 2
    struct.pack_into("<H", head, 94, header_size)
    struct.pack_into("<I", head, 96, header_size)
    head[104] = 0
    struct.pack_into("<H", head, 105, record_len)
    struct.pack_into("<I", head, 107, n)
    struct.pack_into("<3d", head, 131, scale, scale, scale)
    struct.pack_into("<3d", head, 155, *off)
    mins = pts.min(axis=0) if n else np.zeros(3)
    maxs = pts.max(axis=0) if n else np.zeros(3)
    # header order: max_x, min_x, max_y, min_y, max_z, min_z
    struct.pack_into(
        "<6d", head, 179,
        maxs[0], mins[0], maxs[1], mins[1], maxs[2], mins[2],
    )
    ixyz = np.round((pts - off) / scale).astype("<i4")
    rec = np.zeros((n, record_len), np.uint8)
    rec[:, :12] = ixyz.view(np.uint8).reshape(n, 12)
    with open(path, "wb") as f:
        f.write(bytes(head))
        f.write(rec.tobytes())
