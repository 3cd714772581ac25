"""Batched masked Kabsch/Procrustes pose recovery (counterpart of
rap_tpu/core/procrustes.py:19-125).

Every part is solved at once: masked centroids, one batched 3x3 SVD, the
branchless det-reflection fix, and the pre-SVD identity for degenerate parts
(fewer than 3 effective points or a vanishing cross-covariance). Everything
is fp32. The JAX code forces HIGHEST matmul precision (procrustes.py:47,
:66); here the small products are written as elementwise multiply-and-sum,
which never goes through TF32 whatever the global matmul setting.

The SVD: where no gradient is taken (sampling, pose fits, metrics),
``torch.linalg.svd``. On the card that is cuSOLVER, which checks its
convergence on the host: each call synchronises the device with the host
(counted as ``sync.svd``, ``telemetry``).
A training step must not (its non-finite guard is sync-free on purpose), so
where the cross-covariance needs a gradient (the pose loss) ``svd3`` runs
instead: cyclic one-sided Jacobi with a fixed number of sweeps, elementwise
on the device, and the analytic SVD backward (the formula JAX and torch
use). For the degenerate parts' identity its backward divides by zero like
theirs, and ``torch.where`` selects that entry away.
"""

from __future__ import annotations

import torch

from .. import telemetry


def _matmul33(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3) in full fp32."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _det33(m: torch.Tensor) -> torch.Tensor:
    return (
        m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
        - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
        + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0])
    )


_JACOBI_SWEEPS = 6  # fp32 converges in 3-4 on 3x3 matrices


def _jacobi_svd3(H: torch.Tensor):
    """(U, S, V) of (..., 3, 3) matrices by cyclic one-sided Jacobi: columns
    of H rotated pairwise until orthogonal (H V = U S), sorted by descending
    norm; U's third column is u1 x u2 (S3 carries the sign), so U is a
    rotation and a rank-deficient H still gets one."""
    a = [H[..., :, i] for i in range(3)]
    one, zero = torch.ones_like(H[..., 0, 0]), torch.zeros_like(H[..., 0, 0])
    v = [torch.stack([one if r == i else zero for r in range(3)], -1) for i in range(3)]
    for _ in range(_JACOBI_SWEEPS):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            alpha, beta = (a[p] * a[p]).sum(-1), (a[q] * a[q]).sum(-1)
            gamma = (a[p] * a[q]).sum(-1)
            off = gamma != 0
            zeta = (beta - alpha) / (2.0 * torch.where(off, gamma, 1.0))
            t = torch.where(zeta >= 0, 1.0, -1.0) / (zeta.abs() + torch.sqrt(1.0 + zeta * zeta))
            t = torch.where(off, t, 0.0)
            c = torch.rsqrt(1.0 + t * t)
            c, s = c[..., None], (c * t)[..., None]
            a[p], a[q] = c * a[p] - s * a[q], s * a[p] + c * a[q]
            v[p], v[q] = c * v[p] - s * v[q], s * v[p] + c * v[q]
    A, V = torch.stack(a, -1), torch.stack(v, -1)
    order = A.norm(dim=-2).argsort(-1, descending=True)[..., None, :].expand(A.shape)
    A, V = A.gather(-1, order), V.gather(-1, order)
    s1 = A[..., 0].norm(dim=-1, keepdim=True)
    u1 = A[..., 0] / s1.clamp_min(1e-30)
    s2 = A[..., 1].norm(dim=-1, keepdim=True)
    # rank 1: any unit vector orthogonal to u1 (from the axis least along it)
    # (a comparison, not one_hot: one_hot checks its indices on the host)
    axis = (torch.arange(3, device=H.device) == u1.abs().argmin(-1, keepdim=True)).to(u1.dtype)
    alt = torch.linalg.cross(u1, axis)
    alt = alt / alt.norm(dim=-1, keepdim=True).clamp_min(1e-30)
    u2 = torch.where(s2 > 1e-12 * s1, A[..., 1] / s2.clamp_min(1e-30), alt)
    u3 = torch.linalg.cross(u1, u2)
    U = torch.stack([u1, u2, u3], -1)
    S = torch.cat([s1, (A[..., 1] * u2).sum(-1, keepdim=True),
                   (A[..., 2] * u3).sum(-1, keepdim=True)], -1)
    return U, S, V


class _SVD3(torch.autograd.Function):
    """``_jacobi_svd3`` forward; the analytic backward of H = U S V^T with
    U, V orthogonal (torch's ``svd_backward`` for square inputs):
    gH = U [(skew(U^T gU) / E) S + S (skew(V^T gV) / E) + diag(gS)] V^T,
    skew(X) = X - X^T, E_jk = S_k^2 - S_j^2 off the diagonal."""

    @staticmethod
    def forward(ctx, H):
        U, S, V = _jacobi_svd3(H)
        ctx.save_for_backward(U, S, V)
        return U, S, V.transpose(-1, -2)

    @staticmethod
    def backward(ctx, gU, gS, gVh):
        U, S, V = ctx.saved_tensors
        Ut, Vt = U.transpose(-1, -2), V.transpose(-1, -2)
        gV = gVh.transpose(-1, -2)
        s2 = S * S
        E = s2[..., None, :] - s2[..., :, None]
        eye = torch.eye(3, dtype=S.dtype, device=S.device)
        E = torch.where(eye.bool(), 1.0, E)
        ju, jv = _matmul33(Ut, gU), _matmul33(Vt, gV)
        inner = ((ju - ju.transpose(-1, -2)) / E * S[..., None, :]
                 + S[..., :, None] * ((jv - jv.transpose(-1, -2)) / E)
                 + torch.diag_embed(gS))
        return _matmul33(_matmul33(U, inner), Vt)


def svd3(H: torch.Tensor):
    """(U, S, Vh) of (..., 3, 3) fp32 matrices without a host sync,
    differentiable (see the module docstring); S3 may be negative (U is a
    rotation)."""
    return _SVD3.apply(H)


@telemetry.spanned("rap.kabsch")
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

    if H.requires_grad:
        U, _, Vh = svd3(H)
    else:
        telemetry.bump("sync.svd")
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
