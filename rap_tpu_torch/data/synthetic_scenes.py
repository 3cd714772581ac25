"""Local geometric descriptors of a point cloud (counterpart of
rap_tpu/data/synthetic_scenes.py:145-184, ``compute_geometric_features``:
the conditioning the committed synthetic-trained checkpoints were trained
on). Host numpy and scipy, as rap_tpu's. The scene generator of that module
waits for ROADMAP A9.
"""

from __future__ import annotations

import numpy as np


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
