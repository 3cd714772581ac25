"""Procedural multi-view registration scenes and their local descriptors
(counterpart of rap_tpu/data/synthetic_scenes.py; host numpy and scipy, as
rap_tpu's).

``make_scene`` builds an indoor-style scene (a floor, two walls of
different heights, a long landmark box and random boxes and spheres),
``split_into_views`` crops overlapping partial views of it (random scan
footprints, subsampled, with sensor noise), and ``generate_dataset`` writes
a whole training dataset: one folder of registered (world-frame) part PLYs
per scene, ``compute_geometric_features`` sidecars, split files and the
num_points files the packer reads. The same seed writes the same files as
rap_tpu's generator.
"""

from __future__ import annotations

import numpy as np

from ..dataset_process.io import save_training_sample
from ..dataset_process.splits import make_splits, write_num_points_files, write_split_files


def _sample_box(rng, center, size, n):
    """Surface-sample an axis-aligned box: pick faces by area."""
    sx, sy, sz = size
    areas = np.array([sy * sz, sy * sz, sx * sz, sx * sz, sx * sy, sx * sy])
    face = rng.choice(6, size=n, p=areas / areas.sum())
    u = rng.uniform(-0.5, 0.5, (n, 2))
    pts = np.empty((n, 3))
    half = np.asarray(size) / 2
    for f in range(6):
        m = face == f
        axis = f // 2
        sign = 1.0 if f % 2 == 0 else -1.0
        others = [a for a in range(3) if a != axis]
        pts[m, axis] = sign * half[axis]
        pts[m, others[0]] = u[m, 0] * size[others[0]]
        pts[m, others[1]] = u[m, 1] * size[others[1]]
    return pts + np.asarray(center)


def _sample_sphere(rng, center, radius, n):
    v = rng.standard_normal((n, 3))
    v /= np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-9)
    return v * radius + np.asarray(center)


def make_scene(rng: np.random.Generator, extent: float = 6.0,
               n_objects: int = 8, points: int = 20_000) -> np.ndarray:
    """One structured scene (N,3): floor + walls + random boxes/spheres."""
    chunks = []
    n_floor = points // 4
    floor = np.stack([
        rng.uniform(-extent, extent, n_floor),
        rng.uniform(-extent, extent, n_floor),
        np.zeros(n_floor),
    ], axis=1)
    chunks.append(floor)
    # two walls of DIFFERENT heights: identical walls make the scene
    # invariant under a 90-degree rotation, which turns the pose posterior
    # multimodal and mode-averages the learned flow into garbage poses
    n_wall = points // 8
    for axis, height in ((0, extent / 2), (1, extent / 5)):
        w = np.stack([
            rng.uniform(-extent, extent, n_wall),
            rng.uniform(-extent, extent, n_wall),
            rng.uniform(0, height, n_wall),
        ], axis=1)
        w[:, axis] = -extent
        chunks.append(w)
    # a distinctive landmark: one long thin box with a per-scene pose
    n_land = points // 10
    yaw = rng.uniform(0, 2 * np.pi)
    Rz = np.array([
        [np.cos(yaw), -np.sin(yaw), 0],
        [np.sin(yaw), np.cos(yaw), 0],
        [0, 0, 1],
    ])
    land = _sample_box(rng, (0, 0, 0), (extent * 0.9, 0.3, 0.6), n_land)
    land = land @ Rz.T + [rng.uniform(-2, 2), rng.uniform(-2, 2), 0.3]
    chunks.append(land)
    n_obj = (points - n_floor - 2 * n_wall - n_land) // max(n_objects, 1)
    for _ in range(n_objects):
        c = [rng.uniform(-extent * 0.8, extent * 0.8),
             rng.uniform(-extent * 0.8, extent * 0.8),
             rng.uniform(0.2, 1.5)]
        if rng.random() < 0.5:
            chunks.append(
                _sample_box(rng, c, rng.uniform(0.3, 1.5, 3), n_obj)
            )
        else:
            chunks.append(_sample_sphere(rng, c, rng.uniform(0.2, 0.8), n_obj))
    return np.concatenate(chunks).astype(np.float64)


def split_into_views(
    scene: np.ndarray,
    rng: np.random.Generator,
    n_views: int = 2,
    keep_radius_frac: tuple[float, float] = (0.55, 0.8),
    max_points_per_view: int = 2048,
    noise: float = 0.01,
    min_overlap_points: int = 200,
    max_tries: int = 20,
) -> list[np.ndarray] | None:
    """Partial views: each keeps points within a random radius of a random
    center (a crude scan footprint), subsampled + sensor noise. Returns None
    if no overlapping configuration is found."""
    extent = np.abs(scene[:, :2]).max()
    for _ in range(max_tries):
        views = []
        masks = []
        for _v in range(n_views):
            c = np.array([
                rng.uniform(-extent * 0.4, extent * 0.4),
                rng.uniform(-extent * 0.4, extent * 0.4),
                0.0,
            ])
            r = extent * rng.uniform(*keep_radius_frac)
            m = np.linalg.norm(scene[:, :2] - c[:2], axis=1) < r
            masks.append(m)
            if m.sum() < min_overlap_points:
                break
        else:
            # every pair of consecutive views must share geometry
            ok = all(
                (masks[i] & masks[i + 1]).sum() >= min_overlap_points
                for i in range(n_views - 1)
            )
            if not ok:
                continue
            for m in masks:
                pts = scene[m]
                if len(pts) > max_points_per_view:
                    pts = pts[rng.choice(len(pts), max_points_per_view, replace=False)]
                pts = pts + rng.standard_normal(pts.shape) * noise
                views.append(pts)
            return views
    return None


def compute_geometric_features(points: np.ndarray, k: int = 16, feat_dim: int = 32) -> np.ndarray:
    """(n, feat_dim) float32 rotation-invariant descriptors from each point's
    k nearest neighbours (itself included): the covariance eigenvalue shape
    factors (linearity, planarity, sphericity), curvature, log neighbourhood
    radius and the three log eigenvalue scales, zero-padded to feat_dim."""
    from scipy.spatial import cKDTree

    n = len(points)
    k = min(k, n)
    dist, idx = cKDTree(points).query(points, k=k)
    nb = points[idx]                                  # (n, k, 3)
    centered = nb - nb.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", centered, centered) / max(k - 1, 1)
    evals = np.linalg.eigvalsh(cov)                   # ascending (n, 3)
    e1, e2, e3 = evals[:, 2], evals[:, 1], evals[:, 0]
    s = np.maximum(e1, 1e-12)
    feats = np.stack([
        (e1 - e2) / s, (e2 - e3) / s, e3 / s,         # linearity, planarity, sphericity
        e3 / np.maximum(e1 + e2 + e3, 1e-12),         # curvature
        np.log1p(dist[:, -1]),
        np.log1p(np.sqrt(e1)), np.log1p(np.sqrt(e2)), np.log1p(np.sqrt(e3)),
    ], axis=1).astype(np.float32)
    out = np.zeros((n, feat_dim), np.float32)
    out[:, : feats.shape[1]] = feats
    return out


def generate_dataset(
    root,
    n_scenes: int = 200,
    n_views: int = 2,
    max_points_per_view: int = 2048,
    val_fraction: float = 0.1,
    seed: int = 0,
    features: bool = True,
    keep_radius_frac: tuple[float, float] = (0.55, 0.8),
) -> list[str]:
    """Write a complete on-disk training dataset (samples + split files)."""
    from pathlib import Path

    rng = np.random.default_rng(seed)
    root = Path(root)
    names = []
    totals: dict[str, int] = {}
    for i in range(n_scenes):
        scene = make_scene(rng)
        views = split_into_views(
            scene, rng, n_views=n_views,
            max_points_per_view=max_points_per_view,
            keep_radius_frac=keep_radius_frac,
        )
        if views is None:
            continue
        name = f"scene_{i:05d}"
        d = save_training_sample(root, name, views)
        if features:
            for p, v in enumerate(views):
                np.save(
                    d / f"features_part_{p:02d}.npy",
                    compute_geometric_features(v),
                )
        names.append(name)
        totals[name] = sum(len(v) for v in views)
    # every scene is its own "sequence": split per sample, not per sequence
    train, val = make_splits(
        names, val_fraction=val_fraction,
        rng=np.random.default_rng(seed + 1), keep_sequences_together=False,
    )
    write_split_files(root, train, val)
    # num_points sidecars: without them the loader's packer falls back to a
    # 5000-points/part estimate and under-fills every batch ~8x (measured:
    # S=2 where 16 scenes fit the budget)
    for split_name, split in (("train", train), ("val", val)):
        write_num_points_files(root, split_name, [totals[n] for n in split])
    return names
