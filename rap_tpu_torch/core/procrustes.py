"""Batched masked Kabsch/Procrustes pose recovery (counterpart of
rap_tpu/core/procrustes.py:19-125).

Every part is solved at once: masked centroids, one batched 3x3 SVD, the
branchless det-reflection fix, and the pre-SVD identity for degenerate parts
(fewer than 3 effective points or a vanishing cross-covariance). Everything
is fp32. The JAX code forces HIGHEST matmul precision (procrustes.py:47,
:66); here the small products are written as elementwise multiply-and-sum,
which never goes through TF32 whatever the global matmul setting.
"""

from __future__ import annotations

import torch


def _matmul33(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3) in full fp32."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _det33(m: torch.Tensor) -> torch.Tensor:
    return (
        m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
        - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
        + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0])
    )


def kabsch_masked(source, target, mask, weights=None):
    """Solve min_{R,t} ||source @ R^T + t - target||^2 per leading batch entry.

    source, target: (..., N, 3); mask: (..., N) bool. Returns (R, t) with
    det(R) = +1; degenerate parts give R = I (t = centroid difference) and
    empty parts t = 0.
    """
    source = source.float()
    target = target.float()
    w = mask.float()
    if weights is not None:
        w = w * weights.float()
    wsum = w.sum(-1, keepdim=True).clamp_min(1e-12)
    src_mean = (source * w[..., None]).sum(-2) / wsum
    tgt_mean = (target * w[..., None]).sum(-2) / wsum
    src_c = (source - src_mean[..., None, :]) * w[..., None]
    tgt_c = target - tgt_mean[..., None, :]
    H = (src_c[..., :, :, None] * tgt_c[..., :, None, :]).sum(-3)  # (..., 3, 3)

    n_eff = w.sum(-1)
    degen = (n_eff < 2.5) | ((H * H).sum((-2, -1)) < 1e-24)
    eye = torch.eye(3, dtype=H.dtype, device=H.device).expand(H.shape)
    H = torch.where(degen[..., None, None], eye, H)

    U, _, Vh = torch.linalg.svd(H)
    V = Vh.transpose(-1, -2)
    Ut = U.transpose(-1, -2)
    d = _det33(_matmul33(V, Ut))
    Dg = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    R = _matmul33(V * Dg[..., None, :], Ut)
    R = torch.where(degen[..., None, None], eye, R)

    t = tgt_mean - (R * src_mean[..., None, :]).sum(-1)
    t = torch.where((n_eff < 1e-9)[..., None], 0.0, t)
    return R, t


def transform_points(R, t, pts):
    """pts @ R^T + t (R: (..., 3, 3), t: (..., 3), pts: (..., N, 3))."""
    return (pts[..., :, None, :] * R[..., None, :, :]).sum(-1) + t[..., None, :]


def fit_transformations(source, target, mask):
    """Per-part rigid poses, all parts at once (procrustes.py:87-93)."""
    return kabsch_masked(source, target, mask)


def rigidify_prediction(prediction, condition, mask):
    """Replace each predicted part by the rigidly transformed condition part
    (procrustes.py:96-110)."""
    R, t = kabsch_masked(condition, prediction, mask)
    rigid = transform_points(R, t, condition)
    return torch.where(mask[..., None], rigid, prediction)


def rotation_angle_deg(R_a, R_b):
    """Geodesic angle in degrees between rotation matrices (..., 3, 3)
    (procrustes.py:118-125)."""
    tr = _matmul33(R_a.transpose(-1, -2), R_b).diagonal(dim1=-2, dim2=-1).sum(-1)
    return torch.rad2deg(torch.arccos(((tr - 1.0) / 2.0).clamp(-1.0, 1.0)))
