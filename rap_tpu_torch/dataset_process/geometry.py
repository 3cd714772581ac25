"""Geometric utilities for the offline pipeline.
(A copy of rap_tpu/dataset_process/geometry.py: the port imports nothing of
rap_tpu.)

Parity with the reference's dataset_process/utils/dataset_utils.py:
SE3 point/normal transforms (:361-407), motion-threshold keyframe filtering
(:461-600), fast voxel-IoU overlap (:603-650), truncated-Gaussian sampling
(:652-679), LiDAR deskewing via SLERP (:682-747; scipy Slerp instead of
roma), per-dataset global frame fixes (:750-770).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation, Slerp


def transform_points(points: np.ndarray, pose: np.ndarray) -> np.ndarray:
    """Apply 4x4 pose to (N,3) points."""
    return points @ pose[:3, :3].T + pose[:3, 3]


def transform_normals(normals: np.ndarray, pose: np.ndarray) -> np.ndarray:
    return normals @ pose[:3, :3].T


def pose_distance(pose_a: np.ndarray, pose_b: np.ndarray) -> tuple[float, float]:
    """(translation [m], rotation [deg]) between two 4x4 poses."""
    dt = float(np.linalg.norm(pose_a[:3, 3] - pose_b[:3, 3]))
    dR = pose_a[:3, :3].T @ pose_b[:3, :3]
    cos = np.clip((np.trace(dR) - 1) / 2, -1, 1)
    return dt, float(np.degrees(np.arccos(cos)))


def filter_keyframes(
    poses: list[np.ndarray],
    min_translation: float = 0.1,
    min_rotation_deg: float = 5.0,
) -> list[int]:
    """Keep frames that moved enough since the last kept frame
    (ref dataset_utils.py:461-600)."""
    if not poses:
        return []
    kept = [0]
    for i in range(1, len(poses)):
        dt, dr = pose_distance(poses[kept[-1]], poses[i])
        if dt >= min_translation or dr >= min_rotation_deg:
            kept.append(i)
    return kept


def voxel_iou_overlap(
    points1: np.ndarray,
    points2: np.ndarray,
    voxel_size: float = 2.0,
    max_points: int = 20_000,
    rng: np.random.Generator | None = None,
) -> float:
    """Fast approximate overlap: IoU of occupied voxel sets
    (ref calculate_point_cloud_overlap_ratio_fast)."""
    if len(points1) == 0 or len(points2) == 0:
        return 0.0
    rng = rng or np.random.default_rng(0)
    if len(points1) > max_points:
        points1 = points1[rng.choice(len(points1), max_points, replace=False)]
    if len(points2) > max_points:
        points2 = points2[rng.choice(len(points2), max_points, replace=False)]

    def vox(p):
        return set(map(tuple, np.floor(p / voxel_size).astype(np.int64)))

    v1, v2 = vox(points1), vox(points2)
    union = len(v1 | v2)
    return len(v1 & v2) / union if union else 0.0


def sample_truncated_gaussian(
    min_val: int, max_val: int, mean: float, std: float,
    rng: np.random.Generator, max_attempts: int = 100,
) -> int:
    """Rejection-sample an integer from N(mean, std) within [min, max]."""
    for _ in range(max_attempts):
        s = int(round(rng.normal(mean, std)))
        if min_val <= s <= max_val:
            return s
    return int(rng.integers(min_val, max_val + 1))


def deskew(
    points: np.ndarray,
    timestamps: np.ndarray | None,
    relative_pose: np.ndarray,
    ts_mid_pose: float = 0.5,
) -> np.ndarray:
    """Motion-compensate a LiDAR sweep: per-point SLERP of the relative pose.

    timestamps normalize to [0,1], recentered at ts_mid_pose (the kiss-icp
    convention the reference follows, dataset_utils.py:682-747).
    """
    if timestamps is None:
        return points
    ts = np.asarray(timestamps, np.float64).reshape(-1)
    lo, hi = ts.min(), ts.max()
    ts = (ts - lo) / (hi - lo) if hi - lo > 1e-8 else np.full_like(ts, 0.5)
    ts = ts - ts_mid_pose

    key_rots = Rotation.from_matrix(
        np.stack([np.eye(3), relative_pose[:3, :3]])
    )
    # Slerp domain [0, 1]; our ts in [-0.5, 0.5] -> shift into domain and
    # extrapolate by splitting sign (slerp(|t|) with inverse for t<0)
    out = points.copy()
    abs_t = np.abs(ts)
    slerp = Slerp([0.0, 1.0], key_rots)
    R_pos = slerp(np.clip(abs_t, 0, 1))
    rot = R_pos.as_matrix()
    neg = ts < 0
    rot[neg] = np.transpose(rot[neg], (0, 2, 1))  # inverse rotation for t<0
    trans = ts[:, None] * relative_pose[:3, 3]
    out[:, :3] = np.einsum("nij,nj->ni", rot, points[:, :3]) + trans
    return out


# camera-frame permutation z->x, -x->y, -y->z, shared with apps/demo.py
# --camera-frame (ref demo.py:60-63 COORDINATE_TRANSFORM)
CAMERA_FRAME_ROTATION = np.array(
    [[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]], np.float32
)


def global_frame_fix(sequence_name: str) -> np.ndarray | None:
    """Per-dataset global rotation fix (ref dataset_utils.py:750-770)."""
    if sequence_name.startswith(
        ("7-scenes", "bundlefusion", "rgbd-scenes", "sun3d")
    ):
        return CAMERA_FRAME_ROTATION
    return None
