"""Rectified-flow algebra: timestep sampling, interpolation, velocity losses
(counterpart of rap_tpu/core/flow.py).

  - timestep schemes u_shaped / logit_normal / mode / uniform / late_heavy /
    euler<k>, clamped to [eps, 1] (flow.py:19-67);
  - flow target x_t = (1-t)·x_0 + t·x_1, v = x_1 - x_0 (:70);
  - masked velocity losses mse / l1 / huber (:82) and velocity norms (:106).

Each scheme's transform is a private function of given draws, so a test can
feed it the draws that ``jax.random`` made; ``sample_timesteps`` draws them
with a ``torch.Generator`` (which gives other numbers than jax.random).
"""

from __future__ import annotations

import math

import torch


def _u_shaped(u: torch.Tensor, a: float = 4.0) -> torch.Tensor:
    """u ~ U(0, 1) -> U-shaped density on [0, 1]."""
    z = u * 2.0 - 1.0
    return (torch.asinh(z * math.sinh(a)) / a + 1.0) / 2.0


def _logit_normal(z: torch.Tensor, mean: float = 0.0, std: float = 1.0) -> torch.Tensor:
    """z ~ N(0, 1) -> sigmoid(z*std + mean)."""
    return torch.sigmoid(z * std + mean)


def _mode(u: torch.Tensor, mode_scale: float = 2.0) -> torch.Tensor:
    return 1.0 - u - mode_scale * (torch.cos(math.pi * u / 2.0) ** 2 - 1.0 + u)


def _late_heavy(u_base: torch.Tensor, u_late: torch.Tensor, pick: torch.Tensor,
                a: float = 4.0) -> torch.Tensor:
    """50% u_shaped, 50% U(0.7, 1): u_late ~ U(0.7, 1), pick bool."""
    return torch.where(pick, u_late, _u_shaped(u_base, a))


def _euler_grid(idx: torch.Tensor, k: int) -> torch.Tensor:
    """idx ~ U{0..k-1} -> the k-step Euler query grid {1, (k-1)/k, ..., 1/k}."""
    return 1.0 - idx.float() / k


def sample_timesteps(
    generator: torch.Generator,
    batch_size: int,
    scheme: str = "u_shaped",
    logit_mean: float = 0.0,
    logit_std: float = 1.0,
    mode_scale: float = 2.0,
    a: float = 4.0,
    eps: float = 0.01,
) -> torch.Tensor:
    """(batch_size,) fp32 timesteps in [eps, 1] on the generator's device."""
    dev = generator.device
    uniform = lambda: torch.rand(batch_size, generator=generator, device=dev)  # noqa: E731
    if scheme == "u_shaped":
        u = _u_shaped(uniform(), a)
    elif scheme == "logit_normal":
        z = torch.randn(batch_size, generator=generator, device=dev)
        u = _logit_normal(z, logit_mean, logit_std)
    elif scheme == "mode":
        u = _mode(uniform(), mode_scale)
    elif scheme == "uniform":
        u = uniform()
    elif scheme == "late_heavy":
        base, late = uniform(), 0.7 + 0.3 * uniform()
        u = _late_heavy(base, late, uniform() < 0.5, a)
    elif scheme.startswith("euler"):
        k = int(scheme[len("euler"):])
        if k < 1:
            raise ValueError(f"euler scheme needs k >= 1, got {scheme!r}")
        idx = torch.randint(0, k, (batch_size,), generator=generator, device=dev)
        u = _euler_grid(idx, k)
    else:
        raise ValueError(f"Invalid timestep sampling scheme: {scheme}")
    return u.clamp(eps, 1.0)


def flow_interpolate(x_0: torch.Tensor, x_1: torch.Tensor, t: torch.Tensor):
    """x_t = (1-t)·x_0 + t·x_1 and v_t = x_1 - x_0 (t broadcasts)."""
    return (1.0 - t) * x_0 + t * x_1, x_1 - x_0


def velocity_loss(v_pred, v_t, mask, loss_type: str = "mse",
                  huber_delta: float = 1.0, count: torch.Tensor | None = None) -> torch.Tensor:
    """Masked velocity-matching loss; mean over valid scalar entries.
    ``count``: the valid points the mean divides by (default the mask's;
    data parallelism passes the global count)."""
    m = mask.to(v_pred.dtype)[..., None]
    diff = v_pred - v_t
    if loss_type == "mse":
        per = diff**2
    elif loss_type == "l1":
        per = diff.abs()
    elif loss_type == "huber":
        ad = diff.abs()
        per = torch.where(ad <= huber_delta, 0.5 * ad**2,
                          huber_delta * (ad - 0.5 * huber_delta))
    else:
        raise ValueError(f"Invalid loss type: {loss_type}")
    denom = torch.clamp_min((m.sum() if count is None else count) * v_pred.shape[-1], 1.0)
    return (per * m).sum() / denom


def velocity_norms(v_pred, v_t, mask, count: torch.Tensor | None = None):
    """Mean L2 norms of predicted and target velocities over valid points
    (``count`` of them, default the mask's)."""
    m = mask.to(v_pred.dtype)
    denom = torch.clamp_min(m.sum() if count is None else count, 1.0)
    n_pred = (torch.linalg.vector_norm(v_pred, dim=-1) * m).sum() / denom
    n_t = (torch.linalg.vector_norm(v_t, dim=-1) * m).sum() / denom
    return n_pred, n_t
