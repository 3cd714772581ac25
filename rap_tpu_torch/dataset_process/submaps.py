"""Submap generation and selection for multi-view training samples.
(A copy of rap_tpu/dataset_process/submaps.py: the port imports nothing of
rap_tpu.)

Parity with the reference's dataset_process/utils/submap_utils.py:
  - a submap is the union of consecutive posed frames (:26-50),
  - per-sample boundaries sampled with truncated-Gaussian lengths biased
    toward the minimum (mean = min + 0.2*range, std = 0.35*range; :166-228),
    with optional drop-one-submap-to-single-frame,
  - candidate K-subsets pass fast frame-interval/spatial checks first
    (:52-100), then the expensive pairwise voxel-IoU overlap + Union-Find
    connectivity check (:102-164),
  - a retry loop decreases K when no valid subset is found (:230-278),
  - selected submaps must not share frames (:280-303).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np

from . import geometry as G

logger = logging.getLogger("rap_tpu_torch.dataset_process")


def create_submap(
    points_list: list[np.ndarray],
    poses_list: list[np.ndarray],
    start_idx: int,
    num_frames: int,
    normals_list: list[np.ndarray] | None = None,
):
    """Union of consecutive frames transformed into world coordinates."""
    pts, nrm = [], []
    for i in range(start_idx, min(start_idx + num_frames, len(points_list))):
        pts.append(G.transform_points(points_list[i], poses_list[i]))
        if normals_list and normals_list[i] is not None:
            nrm.append(G.transform_normals(normals_list[i], poses_list[i]))
    if not pts:
        return np.zeros((0, 3)), None
    return np.vstack(pts), (np.vstack(nrm) if nrm else None)


def generate_submap_boundaries(
    frame_ids: list,
    min_frames: int,
    max_frames: int,
    rng: np.random.Generator,
    random_drop_to_single_frame: bool = False,
) -> list[tuple]:
    """Non-overlapping (start_frame_id, end_frame_id) runs covering the
    sequence, lengths ~ truncated Gaussian biased toward min."""
    mean = min_frames + (max_frames - min_frames) * 0.2
    std = max((max_frames - min_frames) * 0.35, 1e-6)
    bounds = []
    start = 0
    while start < len(frame_ids):
        n = G.sample_truncated_gaussian(min_frames, max_frames, mean, std, rng)
        end = min(start + n, len(frame_ids))
        bounds.append((frame_ids[start], frame_ids[end - 1]))
        start = end
    if random_drop_to_single_frame and bounds:
        k = int(rng.integers(len(bounds)))
        s_id, e_id = bounds[k]
        si, ei = frame_ids.index(s_id), frame_ids.index(e_id)
        f = int(rng.integers(si, ei + 1))
        bounds[k] = (frame_ids[f], frame_ids[f])
    return bounds


def _fast_checks(
    selected: list[int],
    boundaries: list[tuple],
    centers: list[np.ndarray],
    min_spatial: float,
    max_spatial: float,
    min_frame_interval: int = 0,
    max_frame_interval: int | None = None,
) -> bool:
    n = len(selected)
    for i in range(n):
        for j in range(i + 1, n):
            s1, _ = boundaries[selected[i]]
            s2, _ = boundaries[selected[j]]
            try:
                interval = abs(int(s1) - int(s2))
            except (ValueError, TypeError):
                interval = float("inf")
            if min_frame_interval > 0 and interval < min_frame_interval:
                return False
            if max_frame_interval is not None and interval > max_frame_interval:
                return False
            d = float(np.linalg.norm(centers[selected[i]] - centers[selected[j]]))
            if not (min_spatial <= d <= max_spatial):
                return False
    return True


def _overlap_connected(
    selected: list[int],
    submap_points: list[np.ndarray],
    min_overlap: float,
    max_overlap: float,
    voxel_size: float,
    rng: np.random.Generator,
) -> bool:
    """Union-Find connectivity over pairs whose overlap falls in range."""
    n = len(selected)
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i in range(n):
        for j in range(i + 1, n):
            r = G.voxel_iou_overlap(
                submap_points[selected[i]], submap_points[selected[j]],
                voxel_size=voxel_size, rng=rng,
            )
            if min_overlap <= r <= max_overlap:
                pi, pj = find(i), find(j)
                if pi != pj:
                    parent[pi] = pj
    root = find(0)
    return all(find(i) == root for i in range(n))


@dataclasses.dataclass(frozen=True)
class SelectionConfig:
    min_spatial: float = 0.0
    max_spatial: float = 50.0
    min_overlap: float = 0.05
    max_overlap: float = 0.9
    overlap_voxel_size: float = 2.0
    min_frame_interval: int = 0
    max_frame_interval: int | None = None
    max_attempts: int = 50


def select_connected_submaps(
    boundaries: list[tuple],
    submap_points: list[np.ndarray],
    k: int,
    cfg: SelectionConfig,
    rng: np.random.Generator,
) -> list[int] | None:
    """Pick K submaps that are spatially close and overlap-connected; retry
    with decreasing K on failure (ref :230-278). Returns indices or None."""
    centers = [
        p.mean(0) if len(p) else np.zeros(3) for p in submap_points
    ]
    n = len(boundaries)
    for kk in range(min(k, n), 1, -1):
        attempts = 0
        # fast rejections don't count as attempts, but bound total draws so a
        # spatially-impossible configuration can't spin forever
        for _draw in range(cfg.max_attempts * 50):
            if attempts >= cfg.max_attempts:
                break
            sel = sorted(rng.choice(n, kk, replace=False).tolist())
            if not _fast_checks(
                sel, boundaries, centers, cfg.min_spatial, cfg.max_spatial,
                cfg.min_frame_interval, cfg.max_frame_interval,
            ):
                continue  # fast rejections don't count as attempts
            attempts += 1
            if _overlap_connected(
                sel, submap_points, cfg.min_overlap, cfg.max_overlap,
                cfg.overlap_voxel_size, rng,
            ):
                return sel
        logger.debug("no valid %d-subset; retrying with k=%d", kk, kk - 1)
    return None


def validate_no_frame_overlap(
    boundaries: list[tuple], selected: list[int], frame_ids: list
) -> bool:
    """Selected submaps must not share any frame (ref :280-303)."""
    used: set = set()
    for s in selected:
        s_id, e_id = boundaries[s]
        si, ei = frame_ids.index(s_id), frame_ids.index(e_id)
        rng_ids = set(range(si, ei + 1))
        if used & rng_ids:
            return False
        used |= rng_ids
    return True
