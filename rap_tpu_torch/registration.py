"""Rectified Point Flow sampling and pose fitting (counterpart of
rap_tpu/registration.py:34-91, :167-287).

Ported: ``RPFConfig``, ``velocity_fn``, ``sample`` (euler/rk2/rk4, any
schedule, rigidity forcing, trajectories) and ``predict_poses``. The caller
may pass the noise ``x_1``, so the same noise can drive both packages.
Not ported yet: the pruned coarse-then-fine sampler (registration.py:193-245;
``sample`` raises when ``prune_coarse_steps > 0``), transformer features and
ring attention.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .core import procrustes
from .core.batch import PartBatch
from .core.sampler import flow_sampler
from .models.config import DiTConfig
from .models.dit import dit_forward


@dataclasses.dataclass(frozen=True)
class RPFConfig:
    """Pipeline configuration (the inference fields of rap_tpu's RPFConfig)."""

    model: DiTConfig = dataclasses.field(default_factory=DiTConfig)
    inference_sampling_steps: int = 10
    inference_sampler: str = "euler"
    inference_schedule: str = "uniform"
    rigidity_forcing: bool = True
    return_end_point_trajectory: bool = True
    prune_coarse_steps: int = 0  # the pruned sampler is not ported: > 0 raises


def parts_per_sample(batch: PartBatch) -> int:
    """Static P of the regular layout (G == S * P)."""
    if batch.G % batch.S:
        raise ValueError("batch is not in regular layout")
    return batch.G // batch.S


def velocity_fn(params, cfg: RPFConfig, batch: PartBatch):
    """The (x_t, t) -> v closure used by the ODE sampler."""
    P = parts_per_sample(batch)

    def fn(x_t: torch.Tensor, t: float) -> torch.Tensor:
        ts = torch.full((batch.S,), t, dtype=torch.float32, device=x_t.device)
        return dit_forward(params, cfg.model, x_t, ts, batch, parts_per_sample=P)

    return fn


@torch.no_grad()
def sample(
    params,
    cfg: RPFConfig,
    batch: PartBatch,
    generator: torch.Generator | None = None,
    x_1: torch.Tensor | None = None,
    return_trajectory: bool = True,
    num_steps: int | None = None,
    schedule: str | None = None,
) -> dict[str, Any]:
    """Generate a registered scene by integrating the learned flow.

    ``x_1`` (G, N, 3) fp32 is the noise; without it, noise is drawn with
    ``generator`` on the batch's device. Returns a dict with 'points' and,
    with trajectories, 'end_point_trajectory' and 'trajectory'.
    """
    if cfg.prune_coarse_steps > 0:
        raise NotImplementedError(
            "the pruned coarse-then-fine sampler (rap_tpu/registration.py:"
            "193-245) is not ported yet; set prune_coarse_steps=0"
        )
    if x_1 is None:
        x_1 = torch.randn(batch.points.shape, generator=generator,
                          dtype=torch.float32, device=batch.device)
    steps = num_steps or cfg.inference_sampling_steps
    return_trajectory = return_trajectory and cfg.return_end_point_trajectory
    res = flow_sampler(
        velocity_fn(params, cfg, batch),
        x_1=x_1,
        condition=batch.points,
        point_mask=batch.point_mask,
        num_steps=steps,
        rigidity_forcing=cfg.rigidity_forcing,
        return_trajectory=return_trajectory,
        method=cfg.inference_sampler,
        schedule=schedule or cfg.inference_schedule,
    )
    out: dict[str, Any] = {"points": res.x_final}
    if return_trajectory:
        out["end_point_trajectory"] = res.end_point_trajectory
        out["trajectory"] = res.trajectory
    return out


def predict_poses(batch: PartBatch, predicted_points: torch.Tensor):
    """Per-part rigid poses condition -> prediction (registration.py:282-287)."""
    return procrustes.fit_transformations(
        batch.points, predicted_points, batch.point_mask
    )
