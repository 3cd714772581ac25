"""Point-cloud preprocessing: voxel ops, FPS, kNN, ball query, outlier
removal and the per-part sample allocation (counterpart of
rap_tpu/ops/points.py).

Host ops are numpy, as rap_tpu's: voxel hashing and downsampling, host FPS
and the allocators. rap_tpu backs ``voxel_downsample`` and ``fps_numpy``
with a C++ core when it is built (rap_tpu/native/loader.cpp); the port keeps
the numpy versions only. They differ in one way: the C++ core emits voxels
in first-seen order, numpy in sorted-key order, which the port follows.

Device ops (``farthest_point_sampling``, ``knn``, ``ball_query``) are plain
PyTorch on the tensors' device: rap_tpu computes them in XLA outside any
Pallas kernel. Distances use the expansion |q|² - 2 q·p + |p|² in fp32, as
rap_tpu's do, with full-fp32 products on the card (``fp32_exact``).
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import fp32_exact, resolve_device

# --------------------------------------------------------------------------
# Host-side voxel ops (input pipeline)
# --------------------------------------------------------------------------


def voxel_keys(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """Integer voxel id per point (collision-free lexicographic encoding)."""
    ijk = np.floor(points / voxel_size).astype(np.int64)
    ijk -= ijk.min(axis=0)
    dims = ijk.max(axis=0) + 1
    return (ijk[:, 0] * dims[1] + ijk[:, 1]) * dims[2] + ijk[:, 2]


def voxel_coverage(points: np.ndarray, voxel_size: float) -> int:
    """Number of occupied voxels."""
    if len(points) == 0:
        return 0
    return int(np.unique(voxel_keys(points, voxel_size)).size)


def voxel_downsample(
    points: np.ndarray,
    voxel_size: float,
    attrs: np.ndarray | None = None,
) -> np.ndarray | tuple[np.ndarray, np.ndarray]:
    """Average points (and optional per-point attrs) per voxel, voxels in
    sorted-key order."""
    if len(points) == 0:
        return points if attrs is None else (points, attrs)
    keys = voxel_keys(points, voxel_size)
    uniq, inv, counts = np.unique(keys, return_inverse=True, return_counts=True)
    sums = np.zeros((uniq.size, 3), np.float64)
    np.add.at(sums, inv, points)
    out = (sums / counts[:, None]).astype(points.dtype)
    if attrs is None:
        return out
    asum = np.zeros((uniq.size, attrs.shape[1]), np.float64)
    np.add.at(asum, inv, attrs)
    return out, (asum / counts[:, None]).astype(attrs.dtype)


def random_downsample(points: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    """Indices of k points drawn without replacement (all when there are fewer)."""
    if len(points) <= k:
        return np.arange(len(points))
    return rng.choice(len(points), k, replace=False)


def fps_numpy(points: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    """Host farthest point sampling (exact, random start): (k,) indices."""
    n = len(points)
    if n <= k:
        return np.arange(n)
    idxs = np.empty(k, np.int64)
    idxs[0] = int(rng.integers(n))
    d2 = np.sum((points - points[idxs[0]]) ** 2, axis=1)
    for i in range(1, k):
        idxs[i] = int(np.argmax(d2))
        nd = np.sum((points - points[idxs[i]]) ** 2, axis=1)
        np.minimum(d2, nd, out=d2)
    return idxs


def shape_bucket(n: int, minimum: int = 256) -> int:
    """Next power of two >= n (at least ``minimum``): the padded sizes of
    SpinNet's context clouds and keypoint sets."""
    b = minimum
    while b < n:
        b *= 2
    return b


# --------------------------------------------------------------------------
# Device ops
# --------------------------------------------------------------------------


@torch.no_grad()
def farthest_point_sampling(
    points: torch.Tensor,        # (B, N, 3)
    mask: torch.Tensor,          # (B, N) bool
    k: int,
    start_idx: torch.Tensor | None = None,  # (B,) optional start indices
) -> torch.Tensor:
    """Exact FPS: (B, k) indices into N. Parts with fewer than k valid points
    repeat their farthest points (callers mask by count). The start is the
    first valid point unless ``start_idx`` is given."""
    B, N, _ = points.shape
    pts = points.float()
    rows = torch.arange(B, device=pts.device)
    if start_idx is None:
        start_idx = mask.to(torch.uint8).argmax(1)
    start_idx = start_idx.long()

    def dist2_to(idx):
        d = pts - pts[rows, idx][:, None, :]
        return (d * d).sum(-1)

    idxs = torch.zeros((B, k), dtype=torch.long, device=pts.device)
    idxs[:, 0] = start_idx
    min_d2 = torch.where(mask, dist2_to(start_idx), -1e30)
    for i in range(1, k):
        nxt = min_d2.argmax(1)
        idxs[:, i] = nxt
        min_d2 = torch.where(mask, torch.minimum(min_d2, dist2_to(nxt)), -1e30)
    return idxs


def _dist2(qi: torch.Tensor, points: torch.Tensor, y2: torch.Tensor) -> torch.Tensor:
    return (qi * qi).sum(-1)[:, None] - 2.0 * (qi @ points.T) + y2[None, :]


@torch.no_grad()
def knn(
    queries: torch.Tensor,  # (Q, 3)
    points: torch.Tensor,   # (N, 3)
    mask: torch.Tensor,     # (N,) bool
    k: int,
    chunk: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest valid points per query, nearest first: (Q, k) squared
    distances (clamped at 0) and (Q, k) indices."""
    queries, points = queries.float(), points.float()
    y2 = (points * points).sum(-1)
    d2s, idxs = [], []
    with fp32_exact():
        for c in range(0, queries.shape[0], chunk):
            d2 = torch.where(mask[None, :], _dist2(queries[c:c + chunk], points, y2), torch.inf)
            d, i = torch.topk(d2, k, dim=1, largest=False, sorted=True)
            d2s.append(d)
            idxs.append(i)
    return torch.cat(d2s).clamp_min(0.0), torch.cat(idxs)


@torch.no_grad()
def ball_query(
    queries: torch.Tensor,  # (Q, 3)
    points: torch.Tensor,   # (N, 3)
    mask: torch.Tensor,     # (N,) bool
    radius: float,
    k: int,
    chunk: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Up to k valid points within ``radius`` per query, the FIRST k in index
    order (pytorch3d's ball_query rule, not the nearest): (idx (Q, k), count
    (Q,), within (Q, k) bool). Slots past the count repeat the first hit
    (index 0 where there is none), so gathers stay valid."""
    queries, points = queries.float(), points.float()
    N = points.shape[0]
    y2 = (points * points).sum(-1)
    r2 = radius * radius
    cols = torch.arange(N, device=points.device)
    out_idx, out_cnt = [], []
    with fp32_exact():
        for c in range(0, queries.shape[0], chunk):
            ok = (_dist2(queries[c:c + chunk], points, y2) <= r2) & mask[None, :]
            order = torch.where(ok, cols, N)
            if N < k:
                order = torch.nn.functional.pad(order, (0, k - N), value=N)
            first_k = torch.topk(order, k, dim=1, largest=False, sorted=True).values
            cnt = ok.sum(1).clamp_max(k)
            within = torch.arange(k, device=points.device)[None, :] < cnt[:, None]
            first = torch.where(cnt[:, None] > 0, first_k[:, :1], 0)
            out_idx.append(torch.where(within, first_k, first))
            out_cnt.append(cnt)
    cnt = torch.cat(out_cnt)
    return (torch.cat(out_idx), cnt,
            torch.arange(k, device=points.device)[None, :] < cnt[:, None])


def statistical_outlier_removal(
    points: np.ndarray, nb_neighbors: int = 20, std_ratio: float = 2.0, device="cuda",
) -> np.ndarray:
    """Indices of inliers (Open3D's remove_statistical_outlier rule): a
    point's mean distance to its ``nb_neighbors`` nearest others, in fp32,
    at most the mean over points plus ``std_ratio`` standard deviations.
    The neighbours are found on ``device``."""
    n = len(points)
    if n <= nb_neighbors:
        return np.arange(n)
    device = resolve_device(device)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=device)
    d2, _ = knn(pts, pts, torch.ones(n, dtype=torch.bool, device=device), nb_neighbors + 1)
    # drop self (distance 0, the first column)
    mean_d = d2[:, 1:].sqrt().mean(1).cpu().numpy()
    mu, sd = mean_d.mean(), mean_d.std()
    return np.where(mean_d <= mu + std_ratio * sd)[0]


# --------------------------------------------------------------------------
# Allocation (host)
# --------------------------------------------------------------------------


def adaptive_sample_counts(
    parts: list[np.ndarray],
    voxel_size: float,
    voxel_ratio: float,
    min_points_per_part: int,
    max_sample_points: int,
) -> list[int]:
    """Per part: occupied voxels × ratio, at least ``min_points_per_part``, at
    most the part's size and ``max_sample_points``."""
    out = []
    for pts in parts:
        if len(pts) == 0:
            out.append(0)
            continue
        c = int(voxel_coverage(pts, voxel_size) * voxel_ratio)
        c = max(min_points_per_part, c)
        out.append(min(len(pts), c, max_sample_points))
    return out


def allocate_by_point_count(
    pts_per_part: np.ndarray,
    num_points: int,
    min_points_per_part: int,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Allocation proportional to point counts with per-part minimums and a
    stochastic remainder balance. When even the scaled-down minimums exceed
    the budget, the 1-point floor wins and the total can exceed
    ``num_points``."""
    rng = rng or np.random.default_rng(0)
    pts_per_part = np.asarray(pts_per_part)
    min_per = np.minimum(min_points_per_part, pts_per_part)
    if min_per.sum() > num_points:
        scale = num_points / min_per.sum()
        min_per = np.maximum(1, np.round(min_per * scale).astype(int))
    target = min_per.copy()
    remaining = num_points - target.sum()
    if remaining > 0:
        cap = pts_per_part - target
        if cap.sum() > 0:
            extra = np.round(cap * remaining / cap.sum()).astype(int)
            target = np.minimum(target + extra, pts_per_part)
            diff = num_points - target.sum()
            while diff != 0:
                valid = target < pts_per_part if diff > 0 else target > min_per
                if not valid.any():
                    break
                i = rng.choice(np.where(valid)[0])
                target[i] += 1 if diff > 0 else -1
                diff += -1 if diff > 0 else 1
    return target


def allocate_by_spatial_coverage(
    parts: list[np.ndarray],
    num_points: int,
    min_points_per_part: int,
    voxel_size: float,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Allocation proportional to each part's occupied voxels: extras by
    coverage share, the remainder balanced one point at a time with
    coverage-weighted (deficit) or inverse-coverage-weighted (surplus)
    draws."""
    rng = rng or np.random.default_rng(0)
    pts_per_part = np.array([len(p) for p in parts])
    coverage = np.array([voxel_coverage(p, voxel_size) if len(p) else 0 for p in parts],
                        np.float64)
    min_per = np.minimum(min_points_per_part, pts_per_part)
    if min_per.sum() > num_points:
        scale = num_points / min_per.sum()
        min_per = np.maximum(1, np.round(min_per * scale).astype(int))
    target = min_per.copy()
    remaining = num_points - target.sum()
    if remaining > 0 and coverage.sum() > 0:
        cap = pts_per_part - target
        extra = np.round(coverage / coverage.sum() * remaining).astype(int)
        target = target + np.minimum(extra, cap)
        diff = num_points - target.sum()
        for _ in range(abs(int(diff)) + len(parts)):
            if diff == 0:
                break
            valid = target < pts_per_part if diff > 0 else target > min_per
            if not valid.any():
                break
            idx = np.where(valid)[0]
            w = coverage[idx]
            if w.sum() > 0:
                w = w if diff > 0 else 1.0 / (w + 1e-8)
                i = idx[rng.choice(len(idx), p=w / w.sum())]
            else:
                i = rng.choice(idx)
            target[i] += 1 if diff > 0 else -1
            diff += -1 if diff > 0 else 1
    return target
