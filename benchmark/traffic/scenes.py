"""The benchmark's scene generator: a frozen copy of the port's procedural
scene and view code (``rap_tpu_torch/data/synthetic_scenes.py``:
``make_scene``, ``split_into_views``, ``compute_geometric_features``) and
of its dataset augmentation (``data/dataset.py`` ``augment_sample`` in its
training mode), so that a later change to the program cannot change the
traffic it is measured on.

A scene is an indoor-style cloud (a floor, two walls of different heights,
a long landmark box, boxes and spheres); a view is the part of it within a
random scan radius, subsampled, with sensor noise. ``posed_sample`` turns a
scene's views into one registration problem as the program's data path
does: centred on the largest view, scaled by 1.5 max|coord| of it, every
other view re-centred and rotated at random (its pose is the answer), the
points shuffled. Host numpy and scipy, seeded by the caller's generator.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree
from scipy.spatial.transform import Rotation


def _sample_box(rng, center, size, n):
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


def make_scene(rng: np.random.Generator, extent: float = 6.0, n_objects: int = 8,
               points: int = 20_000) -> np.ndarray:
    """One structured scene (n, 3): floor, walls, a landmark, boxes, spheres."""
    chunks = []
    n_floor = points // 4
    chunks.append(np.stack([rng.uniform(-extent, extent, n_floor),
                            rng.uniform(-extent, extent, n_floor),
                            np.zeros(n_floor)], axis=1))
    n_wall = points // 8
    for axis, height in ((0, extent / 2), (1, extent / 5)):
        w = np.stack([rng.uniform(-extent, extent, n_wall),
                      rng.uniform(-extent, extent, n_wall),
                      rng.uniform(0, height, n_wall)], axis=1)
        w[:, axis] = -extent
        chunks.append(w)
    n_land = points // 10
    yaw = rng.uniform(0, 2 * np.pi)
    Rz = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
    land = _sample_box(rng, (0, 0, 0), (extent * 0.9, 0.3, 0.6), n_land)
    chunks.append(land @ Rz.T + [rng.uniform(-2, 2), rng.uniform(-2, 2), 0.3])
    n_obj = (points - n_floor - 2 * n_wall - n_land) // max(n_objects, 1)
    for _ in range(n_objects):
        c = [rng.uniform(-extent * 0.8, extent * 0.8), rng.uniform(-extent * 0.8, extent * 0.8),
             rng.uniform(0.2, 1.5)]
        if rng.random() < 0.5:
            chunks.append(_sample_box(rng, c, rng.uniform(0.3, 1.5, 3), n_obj))
        else:
            chunks.append(_sample_sphere(rng, c, rng.uniform(0.2, 0.8), n_obj))
    return np.concatenate(chunks).astype(np.float64)


def split_into_views(scene: np.ndarray, rng: np.random.Generator, n_views: int,
                     keep_radius_frac=(0.55, 0.8), max_points_per_view: int = 2048,
                     noise: float = 0.01, min_overlap_points: int = 200,
                     max_tries: int = 20) -> list[np.ndarray] | None:
    """Overlapping partial views, or None where none is found."""
    extent = np.abs(scene[:, :2]).max()
    for _ in range(max_tries):
        masks = []
        for _v in range(n_views):
            c = np.array([rng.uniform(-extent * 0.4, extent * 0.4),
                          rng.uniform(-extent * 0.4, extent * 0.4), 0.0])
            r = extent * rng.uniform(*keep_radius_frac)
            m = np.linalg.norm(scene[:, :2] - c[:2], axis=1) < r
            masks.append(m)
            if m.sum() < min_overlap_points:
                break
        else:
            if not all((masks[i] & masks[i + 1]).sum() >= min_overlap_points
                       for i in range(n_views - 1)):
                continue
            views = []
            for m in masks:
                pts = scene[m]
                if len(pts) > max_points_per_view:
                    pts = pts[rng.choice(len(pts), max_points_per_view, replace=False)]
                views.append(pts + rng.standard_normal(pts.shape) * noise)
            return views
    return None


def compute_geometric_features(points: np.ndarray, k: int = 16, feat_dim: int = 32) -> np.ndarray:
    """(n, feat_dim) float32 covariance shape descriptors of each point's
    k nearest neighbours, zero-padded to ``feat_dim``."""
    n = len(points)
    k = min(k, n)
    dist, idx = cKDTree(points).query(points, k=k)
    nb = points[idx]
    centered = nb - nb.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", centered, centered) / max(k - 1, 1)
    evals = np.linalg.eigvalsh(cov)
    e1, e2, e3 = evals[:, 2], evals[:, 1], evals[:, 0]
    s = np.maximum(e1, 1e-12)
    feats = np.stack([(e1 - e2) / s, (e2 - e3) / s, e3 / s, e3 / np.maximum(e1 + e2 + e3, 1e-12),
                      np.log1p(dist[:, -1]), np.log1p(np.sqrt(e1)), np.log1p(np.sqrt(e2)),
                      np.log1p(np.sqrt(e3))], axis=1).astype(np.float32)
    out = np.zeros((n, feat_dim), np.float32)
    out[:, :feats.shape[1]] = feats
    return out


def scene_views(rng: np.random.Generator, n_views: int, points_per_view, scene_points: int,
                exact: bool) -> list[np.ndarray]:
    """Views of one scene: ``points_per_view`` is an int (every view) or a
    (lo, hi) range drawn per view. With ``exact`` every view holds exactly
    its count (scenes whose views come out smaller are drawn again)."""
    while True:
        counts = ([int(points_per_view)] * n_views if np.isscalar(points_per_view)
                  else [int(rng.integers(points_per_view[0], points_per_view[1], endpoint=True))
                        for _ in range(n_views)])
        views = split_into_views(make_scene(rng, points=scene_points), rng, n_views,
                                 max_points_per_view=max(counts))
        if views is None:
            continue
        views = [v[rng.permutation(len(v))[:c]] for v, c in zip(views, counts)]
        if not exact or all(len(v) == c for v, c in zip(views, counts)):
            return views


def posed_sample(views: list[np.ndarray], feats: list[np.ndarray], rng: np.random.Generator):
    """One registration problem from world-frame views, as the program's
    training augmentation poses it: condition points (each view in a frame
    of its own), ground-truth points, features, per-view (R, t) with
    points @ R^T + t == points_gt, the anchor (largest view, identity) and
    the scale."""
    counts = [len(v) for v in views]
    primary = int(np.argmax(counts))
    R_fwd = Rotation.random(random_state=rng).as_matrix()
    center = views[primary].mean(0)
    scale = max(float(np.max(np.abs((views[primary] - center) @ R_fwd.T))) * 1.5, 1e-12)
    gt = [((v - center) @ R_fwd.T) / scale for v in views]
    shift = np.concatenate(gt).mean(0)
    gt = [g - shift for g in gt]
    cond, gts, fs, rots, trans = [], [], [], [], []
    for i, g in enumerate(gt):
        if i == primary:
            c, R, t = g + shift, np.eye(3), -shift
        else:
            R_part = Rotation.random(random_state=rng).as_matrix()
            ctr = g.mean(0)
            c, R, t = (g - ctr) @ R_part.T, R_part.T, ctr
        order = rng.permutation(len(g))
        cond.append(c[order].astype(np.float32))
        gts.append(g[order].astype(np.float32))
        fs.append(feats[i][order].astype(np.float32))
        rots.append(np.asarray(R, np.float32))
        trans.append(np.asarray(t, np.float32))
    return {"points": cond, "points_gt": gts, "features": fs, "rotations": rots,
            "translations": trans, "anchor": primary, "scale": scale}


def write_ply(path, points: np.ndarray) -> None:
    """A binary little-endian PLY of float32 x, y, z."""
    pts = np.ascontiguousarray(points, dtype="<f4").reshape(-1, 3)
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(pts)}\nproperty float x\nproperty float y\n"
              "property float z\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(pts.tobytes())


def read_ply(path) -> np.ndarray:
    """(n, 3) float32 points of a PLY ``write_ply`` wrote."""
    data = open(path, "rb").read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    n = next(int(line.split()[-1]) for line in data[:end].decode("ascii").splitlines()
             if line.startswith("element vertex"))
    return np.frombuffer(data, dtype="<f4", count=3 * n, offset=end).reshape(n, 3)


def write_split(root, rng: np.random.Generator, samples: int, views, points_per_view,
                scene_points: int, feat_dim: int) -> list[int]:
    """A training split in the layout the program's dataset reads: one folder
    of registered (world-frame) part PLYs per sample with their
    ``features_<part>.npy``, ``data_split/{train,val}.txt`` (every sample in
    train, the first also in val) and ``num_points/train.txt``. ``views`` is
    a (lo, hi) range of views a sample, drawn per sample. Returns each
    sample's point count."""
    from pathlib import Path

    root = Path(root)
    names, totals = [], []
    for i in range(samples):
        n_views = int(rng.integers(views[0], views[1], endpoint=True))
        parts = scene_views(rng, n_views, points_per_view, scene_points, exact=False)
        name = f"sample_{i:04d}"
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        for p, v in enumerate(parts):
            write_ply(d / f"part_{p:02d}.ply", v)
            np.save(d / f"features_part_{p:02d}.npy",
                    compute_geometric_features(v.astype(np.float32).astype(np.float64),
                                               feat_dim=feat_dim))
        names.append(name)
        totals.append(sum(len(v) for v in parts))
    (root / "data_split").mkdir(parents=True, exist_ok=True)
    (root / "data_split" / "train.txt").write_text("\n".join(names) + "\n")
    (root / "data_split" / "val.txt").write_text(names[0] + "\n")
    (root / "num_points").mkdir(parents=True, exist_ok=True)
    (root / "num_points" / "train.txt").write_text("\n".join(map(str, totals)) + "\n")
    return totals
