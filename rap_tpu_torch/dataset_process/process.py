"""Sequence -> multi-view training samples.
(A copy of rap_tpu/dataset_process/process.py: the port imports nothing of
rap_tpu.)

Parity with the generic path of the reference's dataset_process/utils/
processing_utils.py (`process_sequence_with_loader` :1850): load posed frames
through a user-supplied loader, optionally deskew, filter keyframes, sample
submap boundaries, select spatially-close overlap-connected submaps, voxel
downsample and save. Dataset-specific processors (KITTI/NSS/Waymo/3DMatch/
MIT/TIERS/TLS) in the reference differ only in their frame loaders and
selection thresholds — here the loader is an explicit interface (the
reference's own `..data_loaders` package was never released;
processing_utils.py:324).
"""

from __future__ import annotations

import dataclasses
import logging
import zlib
from pathlib import Path
from typing import Iterable

import numpy as np

from ..ops.points import voxel_downsample
from . import geometry as G
from . import submaps
from .io import save_training_sample

logger = logging.getLogger("rap_tpu_torch.dataset_process")

# A frame loader yields dicts: {"points" (N,3), "pose" (4,4),
#  "normals" (N,3)|None, "timestamps" (N,)|None, "frame_id": any}
FrameLoader = Iterable[dict]


@dataclasses.dataclass(frozen=True)
class SequenceProcessingConfig:
    min_frames_per_submap: int = 5
    max_frames_per_submap: int = 50
    submaps_per_sample: int = 4
    samples_per_sequence: int = 10
    voxel_size: float = 0.1
    deskew: bool = False
    keyframe_min_translation: float = 0.0   # 0 = keep all frames
    keyframe_min_rotation_deg: float = 0.0
    random_drop_to_single_frame: bool = False
    selection: submaps.SelectionConfig = dataclasses.field(
        default_factory=submaps.SelectionConfig
    )
    seed: int = 0


def process_sequence(
    loader: FrameLoader,
    sequence_name: str,
    output_root: str | Path,
    cfg: SequenceProcessingConfig = SequenceProcessingConfig(),
    global_transform: np.ndarray | None = None,
) -> list[str]:
    """Generate multi-view samples from one sequence; returns sample names."""
    # zlib.crc32, not hash(): python's str hash is salted per process, which
    # would make "deterministic" generation differ between runs
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, zlib.crc32(sequence_name.encode())])
    )
    points_list, poses, normals_list, frame_ids = [], [], [], []
    prev_pose = None
    for frame in loader:
        pts = np.asarray(frame["points"], np.float64)
        pose = np.asarray(frame["pose"], np.float64)
        if cfg.deskew and frame.get("timestamps") is not None:
            rel = (
                np.linalg.inv(prev_pose) @ pose if prev_pose is not None
                else np.eye(4)
            )
            pts = G.deskew(pts, frame["timestamps"], rel)
        prev_pose = pose
        points_list.append(pts)
        poses.append(pose)
        normals_list.append(frame.get("normals"))
        frame_ids.append(frame.get("frame_id", len(frame_ids)))

    if cfg.keyframe_min_translation > 0 or cfg.keyframe_min_rotation_deg > 0:
        keep = G.filter_keyframes(
            poses, cfg.keyframe_min_translation, cfg.keyframe_min_rotation_deg
        )
        points_list = [points_list[i] for i in keep]
        poses = [poses[i] for i in keep]
        normals_list = [normals_list[i] for i in keep]
        frame_ids = [frame_ids[i] for i in keep]
    if len(points_list) < cfg.min_frames_per_submap * 2:
        logger.warning("%s: too few frames (%d)", sequence_name, len(points_list))
        return []

    gt = global_transform
    if gt is None:
        fix = G.global_frame_fix(sequence_name)
        if fix is not None:
            gt = np.eye(4)
            gt[:3, :3] = fix

    names: list[str] = []
    for s in range(cfg.samples_per_sequence):
        bounds = submaps.generate_submap_boundaries(
            frame_ids, cfg.min_frames_per_submap, cfg.max_frames_per_submap,
            rng, cfg.random_drop_to_single_frame,
        )
        # build all candidate submaps (downsampled for selection speed)
        sub_pts, sub_nrm = [], []
        for s_id, e_id in bounds:
            si, ei = frame_ids.index(s_id), frame_ids.index(e_id)
            pts, nrm = submaps.create_submap(
                points_list, poses, si, ei - si + 1, normals_list
            )
            if cfg.voxel_size > 0 and len(pts):
                if nrm is not None and len(nrm) == len(pts):
                    pts, nrm = voxel_downsample(
                        pts.astype(np.float32), cfg.voxel_size, attrs=nrm
                    )
                else:
                    pts = voxel_downsample(
                        pts.astype(np.float32), cfg.voxel_size
                    )
            sub_pts.append(pts)
            sub_nrm.append(nrm)
        sel = submaps.select_connected_submaps(
            bounds, sub_pts, cfg.submaps_per_sample, cfg.selection, rng
        )
        if sel is None or not submaps.validate_no_frame_overlap(bounds, sel, frame_ids):
            continue
        name = f"{sequence_name}/sample_{s:04d}"
        sel_nrm = [sub_nrm[i] for i in sel]
        save_training_sample(
            output_root, name,
            parts_world=[sub_pts[i] for i in sel],
            normals=sel_nrm if all(n is not None for n in sel_nrm) else None,
            poses=[poses[frame_ids.index(bounds[i][0])] for i in sel],
            global_transform=gt,
        )
        names.append(name)
    logger.info("%s: %d samples", sequence_name, len(names))
    return names


def array_sequence_loader(
    points: list[np.ndarray],
    poses: list[np.ndarray],
    normals: list[np.ndarray] | None = None,
    timestamps: list[np.ndarray] | None = None,
) -> FrameLoader:
    """In-memory frame loader (tests; also the template for dataset loaders)."""
    for i in range(len(points)):
        yield {
            "points": points[i],
            "pose": poses[i],
            "normals": normals[i] if normals else None,
            "timestamps": timestamps[i] if timestamps else None,
            "frame_id": i,
        }
