"""Rectified Point Flow training forward, sampling and pose fitting
(counterpart of rap_tpu/registration.py:34-287).

Ported: ``RPFConfig``, ``training_forward`` (velocity loss, norms and the
t-binned losses), ``velocity_fn``, ``sample`` (euler/rk2/rk4, any schedule,
rigidity forcing, trajectories) and ``predict_poses``. The caller may pass
the noise ``x_1`` (and, to training, the timesteps ``t``), so the same draws
can drive both packages.
Dense and padded batches both run (the DiT takes its masked branch for the
latter). Not ported yet: the pose loss (``pose_loss_weight > 0`` raises: it
needs the gradient of the batched 3x3 SVD), FF dropout in training, the
pruned coarse-then-fine sampler (registration.py:193-245: ``sample`` raises
only where rap_tpu would prune, and otherwise runs the plain sampler as
rap_tpu does), transformer features and ring attention.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .core import flow, procrustes
from .core.batch import PartBatch
from .core.sampler import flow_sampler
from .models.config import DiTConfig
from .models.dit import attention_bounds, dit_forward


@dataclasses.dataclass(frozen=True)
class RPFConfig:
    """Pipeline configuration (rap_tpu's RPFConfig, registration.py:34-70)."""

    model: DiTConfig = dataclasses.field(default_factory=DiTConfig)
    loss_type: str = "mse"
    timestep_sampling: str = "u_shaped"
    pose_loss_weight: float = 0.0  # the pose loss is not ported: > 0 raises
    inference_sampling_steps: int = 10
    inference_sampler: str = "euler"
    inference_schedule: str = "uniform"
    n_generations: int = 1  # generations per batch in apps.sample
    rigidity_forcing: bool = True
    return_end_point_trajectory: bool = True
    prune_coarse_steps: int = 0  # the pruned sampler is not ported: raises where it would run


def parts_per_sample(batch: PartBatch) -> int:
    """Static P of the regular layout (G == S * P)."""
    if batch.G % batch.S:
        raise ValueError("batch is not in regular layout")
    return batch.G // batch.S


def training_forward(
    params,
    cfg: RPFConfig,
    batch: PartBatch,
    generator: torch.Generator,
    remat: bool = True,
    x_1: torch.Tensor | None = None,
    t: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One training forward (registration.py:92-164): sample t, build the
    flow target, predict v, loss. Returns (loss with its graph, metrics
    detached): loss, norm_v_pred, norm_v_t and the t-binned losses.

    ``t`` (S,) and ``x_1`` (G, N, 3) override the draws from ``generator``
    (t first, then the noise, as rap_tpu splits its key). For a dense batch
    the attention guard bounds are computed here from the current gains,
    once per call; a padded batch needs none.
    """
    if cfg.model.dropout_rate > 0.0:
        raise NotImplementedError(
            "FF dropout in training takes the unfused FF (rap_tpu/models/dit.py:"
            "281), which is not ported yet (ROADMAP A5.3)")
    if cfg.pose_loss_weight > 0.0:
        raise NotImplementedError(
            "the pose loss needs the gradient of the batched 3x3 SVD, which is "
            "not ported yet (ROADMAP section A, training)")
    if t is None:
        t = flow.sample_timesteps(generator, batch.S, cfg.timestep_sampling)
    x_0 = batch.points_gt
    if x_1 is None:
        x_1 = torch.randn(x_0.shape, generator=generator, dtype=x_0.dtype,
                          device=x_0.device)
    P = parts_per_sample(batch)
    t_point = batch.per_sample_to_point(t)[..., None]  # (G, N, 1)
    x_t, v_t = flow.flow_interpolate(x_0, x_1, t_point)
    bounds = attention_bounds(params) if batch.no_padding else None
    v_pred = dit_forward(params, cfg.model, x_t, t, batch, parts_per_sample=P,
                         remat=remat, bounds=bounds)
    loss = flow.velocity_loss(v_pred, v_t, batch.point_mask, cfg.loss_type)
    with torch.no_grad():
        v_pred = v_pred.detach()
        n_pred, n_t = flow.velocity_norms(v_pred, v_t, batch.point_mask)
        metrics = {"loss": loss.detach(), "norm_v_pred": n_pred, "norm_v_t": n_t}
        mask = batch.point_mask.float()
        se = ((v_pred - v_t) ** 2 * mask[..., None]).sum((1, 2))        # (G,)
        cnt = 3.0 * mask.sum(1)
        se_s = se.reshape(batch.S, P).sum(1)                            # (S,)
        cnt_s = cnt.reshape(batch.S, P).sum(1).clamp_min(1.0)
        loss_s = se_s / cnt_s
        valid = batch.sample_valid.float()
        for lo, hi, name in ((0.0, 0.5, "loss_t<0.5"), (0.5, 0.9, "loss_t0.5-0.9"),
                             (0.9, 1.01, "loss_t>0.9")):
            w = ((t >= lo) & (t < hi)).float() * valid
            metrics[name] = (loss_s * w).sum() / w.sum().clamp_min(1.0)
    return loss, metrics


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
    if x_1 is None:
        x_1 = torch.randn(batch.points.shape, generator=generator,
                          dtype=torch.float32, device=batch.device)
    steps = num_steps or cfg.inference_sampling_steps
    return_trajectory = return_trajectory and cfg.return_end_point_trajectory
    if (min(cfg.prune_coarse_steps, steps - 1) > 0 and cfg.rigidity_forcing
            and not return_trajectory):
        raise NotImplementedError(
            "the pruned coarse-then-fine sampler (rap_tpu/registration.py:"
            "193-245) is not ported yet; set prune_coarse_steps=0"
        )
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
