"""ODE samplers for rectified point flow (counterpart of
rap_tpu/core/sampler.py:34-159).

t runs 1 -> 0 over a timestep grid; each step evaluates the velocity field,
forms the end-point estimate x0_hat = x_t - v*t and steps x_t. With rigidity
forcing, x0_hat is made rigid per part (Kabsch) and x_t is re-interpolated
from it and the noise: x_next = x0_rigid * (1 - t_next) + x_1 * t_next. The
JAX ``lax.scan`` is a Python loop here.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import telemetry
from .procrustes import rigidify_prediction


class SampleResult(NamedTuple):
    x_final: torch.Tensor                         # (G, N, 3) x_t at t=0
    end_point_trajectory: torch.Tensor | None     # (steps, G, N, 3)
    trajectory: torch.Tensor | None               # (steps, G, N, 3)


def make_schedule(num_steps: int, schedule: str = "uniform") -> np.ndarray:
    """Timestep grid (num_steps+1,) from 1 to 0: uniform, cosine, power:<k>."""
    u = np.linspace(1.0, 0.0, num_steps + 1)
    if schedule == "uniform":
        ts = u
    elif schedule == "cosine":
        ts = np.cos(np.pi / 2 * (1.0 - u))
    elif schedule.startswith("power:"):
        k = float(schedule.split(":", 1)[1])
        if k <= 0:
            raise ValueError(f"power schedule needs k > 0, got {k}")
        ts = u**k
    else:
        raise ValueError(
            f"Unknown schedule: {schedule!r}. Available: uniform, cosine, power:<k>"
        )
    ts[0], ts[-1] = 1.0, 0.0
    return ts.astype(np.float32)


def flow_sampler(
    velocity_fn: Callable[[torch.Tensor, float], torch.Tensor],
    x_1: torch.Tensor,
    condition: torch.Tensor,
    point_mask: torch.Tensor,
    num_steps: int = 20,
    rigidity_forcing: bool = False,
    return_trajectory: bool = True,
    method: str = "euler",
    schedule: str = "uniform",
    x_start: torch.Tensor | None = None,
    ts=None,
) -> SampleResult:
    """Integrate the learned flow from noise ``x_1`` (t=1) to the scene (t=0).

    velocity_fn: (x_t (G,N,3), t float) -> v (G,N,3). method: 'euler' |
    'rk2' | 'rk4'. ts: optional explicit timestep grid (fp32 values from
    ts[0] down to ts[-1]) that overrides num_steps and schedule, so that one
    ODE can be split into segments on the same query points. x_start:
    optional start state at t = ts[0] (default x_1); under rigidity forcing
    x_1 stays the noise the re-interpolation blends with.
    """
    if method not in ("euler", "rk2", "rk4"):
        raise ValueError(f"Unknown sampler: {method}. Available: ['euler', 'rk2', 'rk4']")
    if ts is None:
        ts = make_schedule(num_steps, schedule)
    ts = [float(t) for t in np.asarray(ts, np.float32)]
    x_t = x_1 if x_start is None else x_start
    ends, xs = [], []
    for t, t_next in zip(ts[:-1], ts[1:]):
        with telemetry.span("rap.step"):
            dt = t - t_next
            v1 = velocity_fn(x_t, t)
            if method == "euler":
                v_eff = v1
            elif method == "rk2":
                v2 = velocity_fn(x_t - 0.5 * dt * v1, 0.5 * (t + t_next))
                v_eff = 0.5 * (v1 + v2)
            else:
                t_half = 0.5 * (t + t_next)
                v2 = velocity_fn(x_t - 0.5 * dt * v1, t_half)
                v3 = velocity_fn(x_t - 0.5 * dt * v2, t_half)
                v4 = velocity_fn(x_t - dt * v3, t_next)
                v_eff = (v1 + 2.0 * v2 + 2.0 * v3 + v4) / 6.0
            x_0_hat = x_t - v_eff * t
            x_next = x_t - dt * v_eff
            if rigidity_forcing:
                x_0_rigid = rigidify_prediction(x_0_hat, condition, point_mask)
                x_next = x_0_rigid * (1.0 - t_next) + x_1 * t_next
            if return_trajectory:
                ends.append(x_0_hat)
                xs.append(x_next)
            x_t = x_next
    if return_trajectory:
        return SampleResult(x_t, torch.stack(ends), torch.stack(xs))
    return SampleResult(x_t, None, None)


def compute_linearity(trajectory: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Ratio of straight-line to path length per point (sampler.py:150):
    trajectory (steps, G, N, 3) -> (G, N); masked points get 0."""
    straight = torch.linalg.vector_norm(trajectory[0] - trajectory[-1], dim=-1)
    path = torch.linalg.vector_norm(torch.diff(trajectory, dim=0), dim=-1).sum(0)
    return torch.where(mask, straight / path.clamp_min(1e-12), 0.0)
