"""Plain reference of the registration sampler and pose fit
(rap_tpu/core/sampler.py:34-159, core/procrustes.py:19-110,
registration.py:282-287): Euler steps from the noise at t = 1 to t = 0 on
the uniform grid, each end-point estimate made rigid per part (Kabsch) and
re-blended with the noise, then each part's pose from its condition to
the result. Kabsch runs in float64. Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from . import dit


def schedule(steps: int) -> list[float]:
    """The uniform grid from 1 to 0 as float32 values."""
    ts = np.linspace(1.0, 0.0, steps + 1).astype(np.float32)
    return [float(t) for t in ts]


def kabsch(source, target, mask):
    """(R, t) per part with source @ R^T + t ~ target over the valid points:
    float64, det(R) = +1, the identity for a part with fewer than 3 points."""
    w = mask.double()[..., None]
    src, tgt = source.double(), target.double()
    n = w.sum(-2).clamp_min(1e-12)
    cs, ct = (src * w).sum(-2) / n, (tgt * w).sum(-2) / n
    Hm = ((src - cs[..., None, :]) * w).transpose(-1, -2) @ (tgt - ct[..., None, :])
    degenerate = (w.sum((-2, -1)) < 2.5) | ((Hm * Hm).sum((-2, -1)) < 1e-24)
    eye = torch.eye(3, dtype=Hm.dtype, device=Hm.device).expand_as(Hm)
    Hm = torch.where(degenerate[..., None, None], eye, Hm)
    U, _, Vh = torch.linalg.svd(Hm)
    V = Vh.transpose(-1, -2)
    d = torch.linalg.det(V @ U.transpose(-1, -2))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1))
    R = torch.where(degenerate[..., None, None], eye, V @ D @ U.transpose(-1, -2))
    t = ct - (R @ cs[..., None])[..., 0]
    return R, t


def transform(R, t, pts):
    return (pts.double() @ R.transpose(-1, -2) + t[..., None, :])


@torch.no_grad()
def sample(params: dict, model: dict, batch: dict, x_1: torch.Tensor, steps: int,
           prec: dit.Precision = dit.FP32):
    """(points (G, N, 3) float32, R (G, 3, 3), t (G, 3)) of one generation
    with rigidity forcing from the noise ``x_1``."""
    cond, mask = batch["points"], batch["point_mask"]
    S = cond.shape[0] // batch["parts_per_sample"]
    ts = schedule(steps)
    x = x_1.float()
    with dit.exact_fp32():
        for t, t_next in zip(ts[:-1], ts[1:]):
            v = dit.forward(params, model, x, torch.full((S,), t, device=x.device), batch, prec)
            x0_hat = x - v * t
            R, tr = kabsch(cond, x0_hat, mask)
            rigid = transform(R, tr, cond).float()
            x0 = torch.where(mask[..., None], rigid, x0_hat)
            x = x0 * (1.0 - t_next) + x_1.float() * t_next
        R, tr = kabsch(cond, x, mask)
    return x, R.float(), tr.float()
