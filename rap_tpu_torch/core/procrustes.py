"""Batched masked Kabsch/Procrustes pose recovery (counterpart of
rap_tpu/core/procrustes.py:19-125).

Every part is solved at once: masked centroids, one batched 3x3 SVD, the
branchless det-reflection fix, and the pre-SVD identity for degenerate parts
(fewer than 3 effective points or a vanishing cross-covariance). Everything
is fp32. The JAX code forces HIGHEST matmul precision (procrustes.py:47,
:66); here the small products are written as elementwise multiply-and-sum,
which never goes through TF32 whatever the global matmul setting.

Three routes, chosen by what the inputs show:

- on the card, where no gradient is taken (sampling, pose fits, metrics,
  ICP): one launch of csrc/kabsch.cu (``ops.kabsch``), which solves the SVD
  in registers by ``svd3``'s Jacobi and never waits on the host. Rigidity
  forcing's whole update (``forced_state``) is that one launch too;
- where the cross-covariance needs a gradient (the pose loss): ``svd3``,
  cyclic one-sided Jacobi with a fixed number of sweeps, elementwise on the
  device, and the analytic SVD backward (the formula JAX and torch use). For
  the degenerate parts' identity its backward divides by zero like theirs,
  and ``torch.where`` selects that entry away. No host sync: a training step
  has none on purpose (its non-finite guard is sync-free);
- on the CPU: ``torch.linalg.svd``, counted as ``sync.svd`` (``telemetry``).
  Its CUDA form, cuSOLVER, checks its convergence on the host, so no route
  takes it.
"""

from __future__ import annotations

import math

import torch

from .. import telemetry
from ..ops import kabsch as kabsch_op


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
    # stable: equal norms (a rank-deficient H) keep their order on every device
    order = A.norm(dim=-2).argsort(dim=-1, descending=True, stable=True)
    order = order[..., None, :].expand(A.shape)
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


def _fit(source, target, mask, weights, svd):
    """(R, t) of the masked fit in plain PyTorch, ``svd``: (..., 3, 3) ->
    (U, S, Vh)."""
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

    U, _, Vh = svd(H)
    V = Vh.transpose(-1, -2)
    Ut = U.transpose(-1, -2)
    d = _det33(_matmul33(V, Ut))
    Dg = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    R = _matmul33(V * Dg[..., None, :], Ut)
    R = torch.where(degen[..., None, None], eye, R)

    t = tgt_mean - (R * src_mean[..., None, :]).sum(-1)
    t = torch.where((n_eff < 1e-9)[..., None], 0.0, t)
    return R, t


def _host_svd(H):
    telemetry.bump("sync.svd")
    return torch.linalg.svd(H)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in tensors)


def _card_fit(source, target, mask, weights=None, velocity=None, t=0.0, x_1=None,
              t_next=0.0):
    """``ops.kabsch`` on what ``_fit`` takes: (..., N, 3) points whose
    leading shapes broadcast, and a mask of any dtype, which weighs each
    point by its value as in ``_fit`` (folded into the weights, the points
    it zeroes masked out). The parts go flat to (B, N, 3) fp32 and back."""
    if mask.dtype != torch.bool:
        weights = mask.float() if weights is None else mask.float() * weights.float()
        mask = mask != 0
    shapes = [x.shape[:-2] for x in (source, target, velocity, x_1) if x is not None]
    shapes += [x.shape[:-1] for x in (mask, weights) if x is not None]
    # on meta tensors: torch.broadcast_shapes imports sympy on its first call
    # (seconds on a serving host's first request)
    lead = torch.broadcast_tensors(*(torch.empty(s, device="meta") for s in shapes))[0].shape
    B, N = math.prod(lead), source.shape[-2]

    def flat(x, *tail):
        if x is None:
            return None
        x = x if x.dtype == torch.bool else x.float()
        return x.expand(*lead, N, *tail).reshape(B, N, *tail).contiguous()

    out = kabsch_op.kabsch(flat(source, 3), flat(target, 3), flat(mask), flat(weights),
                           flat(velocity, 3), t, flat(x_1, 3), t_next)
    R, tr = out[0].reshape(*lead, 3, 3), out[1].reshape(*lead, 3)
    return (R, tr) + tuple(x.reshape(*lead, N, 3) for x in out[2:])


@telemetry.spanned("rap.kabsch")
def kabsch_masked(source, target, mask, weights=None):
    """Solve min_{R,t} ||source @ R^T + t - target||^2 per leading batch entry.

    source, target: (..., N, 3), mask: (..., N), weights: (..., N) or None,
    leading shapes broadcasting; a mask that is not bool weighs each point
    by its value. Every route takes these inputs alike. Returns (R, t) with
    det(R) = +1; degenerate parts give R = I (t = centroid difference) and
    empty parts t = 0. The route (module docstring) follows the inputs'
    device and whether a gradient is taken.
    """
    if _needs_grad(source, target, weights):
        return _fit(source, target, mask, weights, svd3)
    if source.is_cuda:
        return _card_fit(source, target, mask, weights)
    return _fit(source, target, mask, weights, _host_svd)


def transform_points(R, t, pts):
    """pts @ R^T + t (R: (..., 3, 3), t: (..., 3), pts: (..., N, 3))."""
    return (pts[..., :, None, :] * R[..., None, :, :]).sum(-1) + t[..., None, :]


def fit_transformations(source, target, mask):
    """Per-part rigid poses, all parts at once (procrustes.py:87-93); the
    inputs and routes of ``kabsch_masked``."""
    return kabsch_masked(source, target, mask)


def rigidify_prediction(prediction, condition, mask):
    """Replace each predicted part by the rigidly transformed condition part
    (procrustes.py:96-110)."""
    R, t = kabsch_masked(condition, prediction, mask)
    rigid = transform_points(R, t, condition)
    return torch.where(mask[..., None], rigid, prediction)


def forced_state(condition, mask, x_1, t_next: float, x_t, v, t: float):
    """Rigidity forcing's next ODE state (sampler.py:134-139): the
    end-point estimate x_0_hat = x_t - v * t made rigid per part
    (``rigidify_prediction``), then ``* (1 - t_next) + x_1 * t_next``. On
    the card with no gradient taken, fit and update are one launch of
    csrc/kabsch.cu, which forms x_0_hat on the fly."""
    if condition.is_cuda and not _needs_grad(condition, x_t, v, x_1):
        with telemetry.span("rap.kabsch"):
            return _card_fit(condition, x_t, mask, velocity=v, t=t, x_1=x_1,
                             t_next=t_next)[2]
    return rigidify_prediction(x_t - v * t, condition, mask) * (1.0 - t_next) + x_1 * t_next


def rotation_angle_deg(R_a, R_b):
    """Geodesic angle in degrees between rotation matrices (..., 3, 3)
    (procrustes.py:118-125)."""
    tr = _matmul33(R_a.transpose(-1, -2), R_b).diagonal(dim1=-2, dim2=-1).sum(-1)
    return torch.rad2deg(torch.arccos(((tr - 1.0) / 2.0).clamp(-1.0, 1.0)))
