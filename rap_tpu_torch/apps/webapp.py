"""Web demo: format conversion, global shift, in-process registration, GLB
(counterpart of rap_tpu/apps/webapp.py; the conversions are host numpy
copies of rap_tpu's, the port imports nothing of rap_tpu).

  - mesh -> sampled point cloud: area-weighted triangle sampling with face
    normals, for PLY meshes and OBJ files.
  - PCD / PTS / XYZ / TXT / LAS -> PLY; LAZ and E57 convert when ``laspy`` /
    ``pye57`` are installed, otherwise raise a clear error.
  - large-coordinate detection + global shift: if any |coord| exceeds
    1000 m, all clouds shift by the global minimum corner, recorded in
    ``global_shift.txt``.
  - ``run_rap_demo`` registers in-process through ``apps.demo.main`` on
    ``device`` (the card by default). ``checkpoint="auto"`` resolves the
    released weights by model name from a local path or the cache only
    (``train.weights.resolve_checkpoint``; the port downloads nothing) and
    logs a visible warning when nothing resolves.
  - the registered parts merge into a part-coloured binary GLB (glTF 2.0,
    POINTS primitive) and a zip of all outputs.
  - the Gradio UI (``build_ui`` / ``main``) needs ``gradio``; without it
    they raise, and everything else runs headless.
"""

from __future__ import annotations

import json
import logging
import struct
import zipfile
from pathlib import Path

import numpy as np

from ..utils import ply as plyio
from ..utils.render import part_ids_to_colors

logger = logging.getLogger("rap_tpu_torch.app")

LARGE_COORD_THRESHOLD = 1000.0  # meters (ref app.py:482)
GLB_MAX_POINTS = 400_000
POINT_CLOUD_EXTS = {".ply", ".pcd", ".pts", ".xyz", ".txt", ".las", ".laz", ".e57"}
MESH_EXTS = {".obj"}


# ---------------------------------------------------------------------------
# mesh surface sampling (pure numpy; ref app.py:74-178 trimesh.sample)
# ---------------------------------------------------------------------------

def sample_mesh_surface(
    vertices: np.ndarray, faces: np.ndarray, n: int, rng=None
) -> tuple[np.ndarray, np.ndarray]:
    """Area-weighted uniform surface sampling. Returns (points, normals)."""
    rng = rng or np.random.default_rng(0)
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    cross = np.cross(b - a, c - a)
    area = 0.5 * np.linalg.norm(cross, axis=1)
    total = area.sum()
    if total <= 0:
        return v, np.zeros_like(v, dtype=np.float32)
    probs = area / total
    idx = rng.choice(len(f), size=n, p=probs)
    # uniform barycentric coordinates
    r1 = np.sqrt(rng.random(n))
    r2 = rng.random(n)
    w0, w1, w2 = 1.0 - r1, r1 * (1.0 - r2), r1 * r2
    pts = (
        a[idx] * w0[:, None] + b[idx] * w1[:, None] + c[idx] * w2[:, None]
    )
    nrm = cross[idx] / np.maximum(
        np.linalg.norm(cross[idx], axis=1, keepdims=True), 1e-12
    )
    # float64 out: large-coordinate meshes must survive until the global
    # shift (the PLY writer downcasts at write time)
    return pts, nrm.astype(np.float32)


def read_obj(path) -> tuple[np.ndarray, np.ndarray]:
    """Minimal OBJ parser: v / f lines (polygons fan-triangulated)."""
    verts, faces = [], []
    with open(path) as fh:
        for line in fh:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "v" and len(tok) >= 4:
                verts.append([float(tok[1]), float(tok[2]), float(tok[3])])
            elif tok[0] == "f" and len(tok) >= 4:
                ids = [int(t.split("/")[0]) for t in tok[1:]]
                ids = [i - 1 if i > 0 else len(verts) + i for i in ids]
                for k in range(1, len(ids) - 1):
                    faces.append([ids[0], ids[k], ids[k + 1]])
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def read_ascii_points(path) -> np.ndarray:
    """PTS/XYZ/TXT: whitespace rows of x y z [extras]; optional count header.
    Returns float64 — georeferenced coordinates must keep full precision
    until the global shift is applied."""
    with open(path) as fh:
        first = fh.readline().split()
        rows = []
        if len(first) == 1:  # PTS count header
            pass
        elif len(first) >= 3:
            rows.append(first[:3])
        for line in fh:
            tok = line.split()
            if len(tok) >= 3:
                rows.append(tok[:3])
    if not rows:
        raise ValueError(f"{path}: no points parsed")
    return np.asarray(rows, np.float64)


def convert_to_points(
    src, mesh_sample_points: int = 100_000, rng=None
) -> dict:
    """Convert any supported upload to in-memory arrays: {'points' (N,3)
    float64 [, 'normals', 'colors']}.

    float64 matters: large (UTM-style) coordinates quantize to ~6 cm at
    float32, so precision must survive until AFTER the global shift.
    """
    src = Path(src)
    ext = src.suffix.lower()
    if ext not in POINT_CLOUD_EXTS | MESH_EXTS:
        raise ValueError(f"unsupported input format: {src.name}")
    if ext == ".ply":
        data = plyio.read_ply(src, dtype=np.float64)
        faces = data.get("faces")
        if faces is not None and len(faces) and len(data["points"]):
            pts, nrm = sample_mesh_surface(
                data["points"], faces, mesh_sample_points, rng
            )
            return {"points": pts.astype(np.float64), "normals": nrm}
        return {
            "points": data["points"].astype(np.float64),
            "normals": data.get("normals"),
            "colors": data.get("colors"),
        }
    if ext == ".obj":
        v, f = read_obj(src)
        if len(f):
            pts, nrm = sample_mesh_surface(v, f, mesh_sample_points, rng)
            return {"points": pts.astype(np.float64), "normals": nrm}
        return {"points": v}
    if ext == ".pcd":
        data = plyio.read_pcd(src, dtype=np.float64)
        return {
            "points": data["points"].astype(np.float64),
            "colors": data.get("colors"),
        }
    if ext in (".pts", ".xyz", ".txt"):
        return {"points": read_ascii_points(src)}
    if ext == ".las":
        # uncompressed LAS reads natively (utils/ply.read_las, no deps)
        return {"points": plyio.read_las(src)["points"]}
    if ext == ".laz":
        try:
            import laspy
        except ImportError as e:
            raise RuntimeError(
                f"converting {src.name} (compressed LAZ) requires 'laspy'"
            ) from e
        las = laspy.read(str(src))
        return {"points": np.stack([las.x, las.y, las.z], axis=-1).astype(np.float64)}
    if ext == ".e57":
        try:
            import pye57
        except ImportError as e:
            raise RuntimeError(
                f"converting {src.name} requires the 'pye57' package"
            ) from e
        e57 = pye57.E57(str(src))
        scan = e57.read_scan(0, ignore_missing_fields=True)
        return {
            "points": np.stack(
                [scan["cartesianX"], scan["cartesianY"], scan["cartesianZ"]], -1
            ).astype(np.float64)
        }
    raise ValueError(f"unsupported input format: {src.name}")


def convert_to_ply(
    src, dst, mesh_sample_points: int = 100_000, rng=None
) -> Path:
    """Convert any supported upload to a point-cloud PLY at ``dst``."""
    src, dst = Path(src), Path(dst)
    if src.suffix.lower() == ".ply" and src.resolve() == Path(dst).resolve():
        return dst
    data = convert_to_points(src, mesh_sample_points, rng)
    plyio.write_ply(
        dst, data["points"].astype(np.float32),
        normals=data.get("normals"), colors=data.get("colors"),
    )
    return dst


# ---------------------------------------------------------------------------
# large-coordinate global shift (ref app.py:482-576)
# ---------------------------------------------------------------------------

def detect_large_coordinates(ply_dir, threshold: float = LARGE_COORD_THRESHOLD) -> bool:
    for f in sorted(Path(ply_dir).glob("*.ply")):
        pts = plyio.read_ply(f)["points"]
        if len(pts) and np.any(np.abs(pts) > threshold):
            return True
    return False


def calculate_global_shift(ply_dir) -> np.ndarray | None:
    mins = []
    for f in sorted(Path(ply_dir).glob("*.ply")):
        pts = plyio.read_ply(f)["points"]
        if len(pts):
            mins.append(pts.min(axis=0))
    return np.minimum.reduce(mins) if mins else None


def apply_global_shift(ply_dir, shift: np.ndarray, output_dir=None) -> int:
    """Shift all PLYs by -shift (in place unless output_dir given)."""
    out_dir = Path(output_dir) if output_dir else Path(ply_dir)
    n = 0
    for f in sorted(Path(ply_dir).glob("*.ply")):
        data = plyio.read_ply(f)
        if not len(data["points"]):
            continue
        plyio.write_ply(
            out_dir / f.name,
            data["points"] - shift.astype(np.float32),
            normals=data.get("normals"),
            colors=data.get("colors"),
        )
        n += 1
    return n


def save_global_shift(shift: np.ndarray, output_dir) -> Path:
    p = Path(output_dir) / "global_shift.txt"
    p.write_text(
        "# Global shift applied to input point clouds\n"
        "# Format: shift_x shift_y shift_z\n"
        "# To recover original coordinates, add this shift back\n"
        f"{shift[0]:.6f} {shift[1]:.6f} {shift[2]:.6f}\n"
    )
    return p


# ---------------------------------------------------------------------------
# minimal GLB (glTF 2.0 binary) point-cloud writer (ref app.py:436-480)
# ---------------------------------------------------------------------------

def write_glb_pointcloud(path, points: np.ndarray, colors: np.ndarray) -> Path:
    """Write a binary glTF with one POINTS-mode primitive (POSITION+COLOR_0).

    Pure-numpy replacement for trimesh's GLB export — the only part of glTF
    needed for a point-cloud viewer.
    """
    path = Path(path)
    pts = np.ascontiguousarray(np.asarray(points, np.float32).reshape(-1, 3))
    col = np.asarray(colors)
    if col.dtype != np.uint8:
        col = (np.clip(col, 0.0, 1.0) * 255).astype(np.uint8)
    # RGBA ubyte normalized (4-byte aligned per element)
    rgba = np.concatenate(
        [col.reshape(-1, 3), np.full((len(pts), 1), 255, np.uint8)], axis=1
    )
    pos_bytes = pts.tobytes()
    col_bytes = np.ascontiguousarray(rgba).tobytes()
    pad1 = (-len(pos_bytes)) % 4
    bin_chunk = pos_bytes + b"\x00" * pad1 + col_bytes
    bin_pad = (-len(bin_chunk)) % 4
    bin_chunk += b"\x00" * bin_pad

    gltf = {
        "asset": {"version": "2.0", "generator": "rap_tpu"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [
            {
                "primitives": [
                    {
                        "attributes": {"POSITION": 0, "COLOR_0": 1},
                        "mode": 0,  # POINTS
                    }
                ]
            }
        ],
        "accessors": [
            {
                "bufferView": 0,
                "componentType": 5126,  # FLOAT
                "count": len(pts),
                "type": "VEC3",
                "min": [float(x) for x in pts.min(0)] if len(pts) else [0, 0, 0],
                "max": [float(x) for x in pts.max(0)] if len(pts) else [0, 0, 0],
            },
            {
                "bufferView": 1,
                "componentType": 5121,  # UNSIGNED_BYTE
                "normalized": True,
                "count": len(pts),
                "type": "VEC4",
            },
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": len(pos_bytes)},
            {
                "buffer": 0,
                "byteOffset": len(pos_bytes) + pad1,
                "byteLength": len(col_bytes),
            },
        ],
        "buffers": [{"byteLength": len(bin_chunk)}],
    }
    js = json.dumps(gltf).encode()
    js += b" " * ((-len(js)) % 4)
    total = 12 + 8 + len(js) + 8 + len(bin_chunk)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))      # glTF magic
        f.write(struct.pack("<II", len(js), 0x4E4F534A))        # JSON chunk
        f.write(js)
        f.write(struct.pack("<II", len(bin_chunk), 0x004E4942))  # BIN chunk
        f.write(bin_chunk)
    return path


def read_glb_pointcloud(path) -> dict:
    """Round-trip reader for tests: returns {'points', 'colors'}."""
    raw = Path(path).read_bytes()
    magic, version, _ = struct.unpack_from("<III", raw, 0)
    assert magic == 0x46546C67 and version == 2
    jlen, jtype = struct.unpack_from("<II", raw, 12)
    assert jtype == 0x4E4F534A
    gltf = json.loads(raw[20 : 20 + jlen])
    blen, btype = struct.unpack_from("<II", raw, 20 + jlen)
    assert btype == 0x004E4942
    bin_chunk = raw[28 + jlen : 28 + jlen + blen]
    acc_pos = gltf["accessors"][0]
    acc_col = gltf["accessors"][1]
    bv = gltf["bufferViews"]
    pos = np.frombuffer(
        bin_chunk, np.float32,
        count=acc_pos["count"] * 3,
        offset=bv[0].get("byteOffset", 0),
    ).reshape(-1, 3)
    col = np.frombuffer(
        bin_chunk, np.uint8,
        count=acc_col["count"] * 4,
        offset=bv[1].get("byteOffset", 0),
    ).reshape(-1, 4)
    return {"points": pos, "colors": col[:, :3]}


def combine_registered_to_glb(
    registered_dir, out_glb, max_points: int = GLB_MAX_POINTS, rng=None
) -> Path | None:
    """Merge registered/*.ply into one part-colored GLB (ref :998-1013)."""
    rng = rng or np.random.default_rng(0)
    files = sorted(Path(registered_dir).glob("*.ply"))
    if not files:
        return None
    pts_all, ids = [], []
    for i, f in enumerate(files):
        pts = plyio.read_ply(f)["points"]
        pts_all.append(pts)
        ids.append(np.full(len(pts), i))
    pts = np.concatenate(pts_all)
    ids = np.concatenate(ids)
    if len(pts) > max_points:
        sel = rng.choice(len(pts), max_points, replace=False)
        pts, ids = pts[sel], ids[sel]
    return write_glb_pointcloud(out_glb, pts, part_ids_to_colors(ids))


# ---------------------------------------------------------------------------
# end to end (ref run_rap_demo, app.py:731)
# ---------------------------------------------------------------------------

def run_rap_demo(
    input_files: list,
    workdir,
    model: str = "rap_12",
    checkpoint: str = "auto",
    num_steps: int = 10,
    n_generations: int = 1,
    voxel_size: float | None = None,
    max_points_per_part: int = 20_000,
    seed: int = 0,
    device="cuda",
    demo_args: list[str] | None = None,
    noise=None,
    record: dict | None = None,
) -> dict:
    """Convert uploads -> (optional) global shift -> register -> GLB + zip.

    Returns {'glb', 'zip', 'registered_dir', 'global_shift', 'log'}.
    Headless: no gradio required. ``device`` is the demo's; ``demo_args``
    are further ``apps.demo`` flags, ``noise`` and ``record`` go to its
    ``main``.
    """
    workdir = Path(workdir)
    in_dir = workdir / "input"
    out_dir = workdir / "output"
    in_dir.mkdir(parents=True, exist_ok=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    log: list[str] = []

    if len(input_files) < 2:
        raise ValueError("need at least two point clouds to register")
    # single pass: convert to float64 arrays, decide on the global shift over
    # ALL clouds, then write float32 PLYs once — large (georeferenced)
    # coordinates must be shifted BEFORE the float32 quantization
    clouds = []
    for i, src in enumerate(input_files):
        src = Path(src)
        data = convert_to_points(src, rng=np.random.default_rng(seed + i))
        clouds.append(data)
        log.append(f"converted {src.name} ({len(data['points'])} points)")
    shift = None
    if any(
        len(d["points"]) and np.any(np.abs(d["points"]) > LARGE_COORD_THRESHOLD)
        for d in clouds
    ):
        shift = np.minimum.reduce(
            [d["points"].min(axis=0) for d in clouds if len(d["points"])]
        )
        save_global_shift(shift, out_dir)
        log.append(f"large coordinates detected; shifting all clouds by {-shift}")
    for i, data in enumerate(clouds):
        pts = data["points"] - shift if shift is not None else data["points"]
        plyio.write_ply(
            in_dir / f"part{i}.ply", pts.astype(np.float32),
            normals=data.get("normals"), colors=data.get("colors"),
        )

    from .demo import main as demo_main

    args = [
        "-i", str(in_dir),
        "-out", str(out_dir),
        "--model", model,
        "--num-steps", str(num_steps),
        "--n-generations", str(n_generations),
        "--max-points-per-part", str(max_points_per_part),
        "--seed", str(seed),
        "--device", str(device),
    ]
    if checkpoint == "auto":
        # resolve the released weights by model name (a local path or the
        # cache; the port downloads nothing); warn VISIBLY when nothing
        # resolves: random weights produce garbage registrations that would
        # otherwise be reported as success
        from ..train.weights import resolve_checkpoint

        try:
            checkpoint = str(resolve_checkpoint(f"{model.replace('rap_', 'rap_model_')}.ckpt"))
            log.append(f"checkpoint: {checkpoint}")
        except FileNotFoundError:
            checkpoint = ""
            logger.warning("no checkpoint resolved: registering with RANDOM weights")
            log.append(
                "WARNING: no checkpoint resolved — registering with RANDOM "
                "weights (pass checkpoint= explicitly or place weights in "
                "the cache)"
            )
    if checkpoint:
        args += ["--checkpoint", checkpoint]
    if voxel_size:
        args += ["--voxel-size", str(voxel_size), "--no-adaptive-parameters"]
    args += demo_args or []
    log.append("running registration (in-process demo): " + " ".join(args))
    rc = demo_main(args, noise=noise, record=record)
    if rc:
        raise RuntimeError(
            f"registration failed (demo exit status {rc}); log:\n" + "\n".join(log)
        )

    reg_dir = out_dir / "registered"
    glb = combine_registered_to_glb(reg_dir, out_dir / "registered.glb")
    log.append(f"viewer GLB: {glb}")

    zip_path = workdir / "rap_results.zip"
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as z:
        for f in sorted(out_dir.rglob("*")):
            if f.is_file():
                z.write(f, f.relative_to(out_dir))
    log.append(f"zip: {zip_path}")

    return {
        "glb": str(glb) if glb else None,
        "zip": str(zip_path),
        "registered_dir": str(reg_dir),
        "global_shift": None if shift is None else [float(x) for x in shift],
        "log": "\n".join(log),
    }


# ---------------------------------------------------------------------------
# Gradio UI (optional; ref app.py:1089-1111)
# ---------------------------------------------------------------------------

def build_ui():
    try:
        import gradio as gr
    except ImportError as e:
        raise RuntimeError(
            "the web UI requires the 'gradio' package; the headless API "
            "(rap_tpu_torch.apps.webapp.run_rap_demo) works without it"
        ) from e

    import tempfile

    def _run(files, model, steps, generations, voxel):
        if not files:
            raise gr.Error("upload at least two point clouds")
        workdir = Path(tempfile.mkdtemp(prefix="rap_app_"))
        try:
            res = run_rap_demo(
                [f.name if hasattr(f, "name") else f for f in files],
                workdir,
                model=model,
                num_steps=int(steps),
                n_generations=int(generations),
                voxel_size=float(voxel) if voxel and voxel > 0 else None,
            )
        except Exception as e:  # surface errors into the UI
            raise gr.Error(str(e))
        return res["glb"], res["zip"], res["log"]

    with gr.Blocks(title="RAP — Register Any Point") as demo:
        gr.Markdown("# RAP — multi-view point cloud registration")
        with gr.Row():
            with gr.Column():
                files = gr.File(
                    file_count="multiple",
                    label="Point clouds (PLY/OBJ/PCD/PTS/XYZ/LAS/E57)",
                )
                model = gr.Radio(
                    ["rap_12", "rap_10"], value="rap_12", label="Model"
                )
                steps = gr.Slider(1, 50, value=10, step=1, label="ODE steps")
                gens = gr.Slider(1, 5, value=1, step=1, label="Generations")
                voxel = gr.Number(value=0, label="Voxel size (0 = adaptive)")
                btn = gr.Button("Register", variant="primary")
            with gr.Column():
                viewer = gr.Model3D(label="Registered scene")
                zip_out = gr.File(label="Results zip")
                logbox = gr.Textbox(label="Log", lines=12)
        btn.click(_run, [files, model, steps, gens, voxel], [viewer, zip_out, logbox])
    return demo


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    build_ui().launch()


if __name__ == "__main__":
    main()
