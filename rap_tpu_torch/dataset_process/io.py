"""Sample persistence + HDF5 conversion for the offline pipeline.
(A copy of rap_tpu/dataset_process/io.py: the port imports nothing of
rap_tpu.)

Parity with the reference's dataset_process/utils/io_utils.py: training
samples are folders of registered (world-frame) part PLYs with optional
per-part `features_<part>.npy` sidecars and pose txts (:191-260, :513-599);
`convert_to_hdf5` packs a folder dataset into one HDF5 with
data_split/<dataset>/<split> name lists, per-part vertices/normals/features
groups, and num_points/<dataset>/<split> (:601-919) — the exact layout the
runtime dataset reader consumes.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np

from ..utils import ply as plyio

logger = logging.getLogger("rap_tpu_torch.dataset_process")


def save_training_sample(
    root: str | Path,
    sample_name: str,
    parts_world: list[np.ndarray],
    normals: list[np.ndarray] | None = None,
    poses: list[np.ndarray] | None = None,
    global_transform: np.ndarray | None = None,
) -> Path:
    """Write one multi-part sample: `<root>/<sample_name>/part_<i>.ply`.

    Parts are stored REGISTERED (world frame, optionally re-expressed through
    `global_transform`); the runtime augmentation generates the unposed
    condition clouds. Per-part sensor poses are exported alongside for
    relocalization-style evaluation.
    """
    d = Path(root) / sample_name
    d.mkdir(parents=True, exist_ok=True)
    for i, pts in enumerate(parts_world):
        p = np.asarray(pts, np.float32)
        if global_transform is not None:
            p = p @ global_transform[:3, :3].T + global_transform[:3, 3]
        nrm = None
        if normals is not None and normals[i] is not None:
            nrm = np.asarray(normals[i], np.float32)
            if global_transform is not None:
                nrm = nrm @ global_transform[:3, :3].T
        # zero-padded: plain lexicographic listings keep part order at >=10 parts
        plyio.write_ply(d / f"part_{i:02d}.ply", p, normals=nrm)
        if poses is not None and poses[i] is not None:
            np.savetxt(d / f"pose_{i:02d}.txt", np.asarray(poses[i]), fmt="%.8f")
    return d


def save_processed_sample(
    root: str | Path,
    sample_name: str,
    keypoints: list[np.ndarray],
    features: list[np.ndarray] | None = None,
    normals: list[np.ndarray] | None = None,
) -> tuple[Path, int]:
    """Write FPS keypoints + feature sidecars; returns (dir, total points)."""
    d = Path(root) / sample_name
    d.mkdir(parents=True, exist_ok=True)
    total = 0
    for i, kp in enumerate(keypoints):
        # zero-padded like save_training_sample: plain lexicographic listings
        # (h5 keys, sorted globs) keep part order at >= 10 parts
        name = f"part_{i:02d}"
        plyio.write_ply(
            d / f"{name}.ply",
            np.asarray(kp, np.float32),
            normals=None if normals is None else normals[i],
        )
        if features is not None and features[i] is not None:
            np.save(d / f"features_{name}.npy", np.asarray(features[i], np.float32))
        total += len(kp)
    return d, total


def convert_to_hdf5(
    dataset_root: str | Path,
    out_path: str | Path,
    dataset_name: str,
    compress: bool = True,
) -> Path:
    """Folder dataset -> single HDF5 in the runtime reader's layout."""
    import h5py

    root = Path(dataset_root)
    out_path = Path(out_path)
    kw = {"compression": "gzip", "compression_opts": 1} if compress else {}
    with h5py.File(out_path, "w") as h5:
        split_grp = h5.create_group("data_split").create_group(dataset_name)
        np_grp = h5.create_group("num_points").create_group(dataset_name)
        for sf in sorted((root / "data_split").glob("*.txt")):
            split = sf.stem
            names = [l.strip() for l in sf.read_text().splitlines() if l.strip()]
            split_grp[split] = np.array([n.encode() for n in names])
            num_points = []
            for name in names:
                d = root / name
                if name not in h5:
                    g = h5.create_group(name)
                    total = 0
                    for ply_path in sorted(d.glob("*.ply")):
                        if ply_path.name.startswith("features"):
                            continue
                        data = plyio.read_ply(ply_path)
                        part = ply_path.stem
                        pg = g.create_group(part)
                        pg.create_dataset("vertices", data=data["points"], **kw)
                        if "normals" in data:
                            pg.create_dataset("normals", data=data["normals"], **kw)
                        feat = d / f"features_{part}.npy"
                        if feat.exists():
                            pg.create_dataset(
                                "features", data=np.load(feat), **kw
                            )
                        total += len(data["points"])
                else:
                    total = sum(
                        h5[name][p]["vertices"].shape[0] for p in h5[name]
                    )
                num_points.append(total)
            np_grp[split] = np.asarray(num_points, np.int64)
    logger.info("wrote %s", out_path)
    return out_path


def write_metadata(
    root: str | Path, metadata: dict, filename: str = "metadata.json"
) -> None:
    (Path(root) / filename).write_text(json.dumps(metadata, indent=2))
