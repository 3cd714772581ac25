"""Train and eval steps (counterpart of rap_tpu/train/step.py).

``make_train_step(cfg, opt_cfg)`` returns ``step(state, batch) -> (state,
metrics)`` (its gradient half is ``train_gradients``): training_forward with remat, gradients by autograd through the
port's kernels, the optimizer chain of train/optim.py, and the non-finite
guard of step.py:66-83: when the global gradient norm is not finite, the
parameters and the optimizer state keep their old values (``torch.where`` on
the device, no host sync) and ``metrics["skipped_nonfinite"]`` is 1. Metrics
are 0-d tensors on the device; reading them is the caller's sync.

``make_scanned_train_steps`` (:118) runs ``num_steps`` such steps over a
list of batches, or a batch stacked along a leading step axis, and returns
the per-step losses, as rap_tpu's ``lax.scan`` does; here it is a Python
loop of the same step. Train states are saved and restored by
``train/checkpoint.py``.

Data parallelism (``mesh``, a ``parallel.mesh.Mesh``): each rank holds the
same state and steps on its contiguous sample shard of the global batch.
rap_tpu's jit computes the loss over the global batch (per-sample losses,
a weighted mean over the valid samples), so the port does too:
``training_forward(mesh=...)`` sums the denominators over the ranks before
the forward and returns the rank's numerator over them; after the
backward one all-reduce (SUM) over a flat buffer of every gradient and
every metric gives each rank the gradient of the global loss (not a mean
of per-rank means, which differs whenever the ranks hold different numbers
of valid points, as packed multi-view batches do) and the global metrics.
The optimizer then steps identically on every rank. The draws are global
(every rank's generator is the same and moves the same), so a world of n
steps as a world of 1; FF dropout's masks differ per rank. Overlapping the
all-reduce with the backward (DDP's buckets) is left to later work.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .. import telemetry
from .._device import resolve_device
from ..core.batch import TENSOR_FIELDS, PartBatch
from ..models.dit import master_params
from ..parallel.mesh import Mesh, all_reduce_sum
from ..registration import RPFConfig, training_forward
from .optim import (Optimizer, OptimizerConfig, apply_updates, global_norm, tree_paths,
                    tree_replace)


@dataclasses.dataclass
class TrainState:
    step: torch.Tensor          # 0-d int64 on the device
    params: Any                 # fp32 masters, no guard bounds
    opt_state: dict[str, Any]
    generator: torch.Generator  # draws t and the noise; advances every step

    @classmethod
    def create(cls, params, opt_cfg: OptimizerConfig, seed: int,
               device="cuda") -> "TrainState":
        """State at step 0 from parameters (serving or master form, any
        device): fp32 masters on ``device``, zero optimizer state."""
        device = resolve_device(device)
        params = master_params(params, device)
        return cls(
            step=torch.zeros((), dtype=torch.int64, device=device),
            params=params,
            opt_state=Optimizer(opt_cfg).init(params),
            generator=torch.Generator(device=device).manual_seed(seed),
        )


def _keep(finite: torch.Tensor, new, old):
    """new where the step is finite, else old (nested dicts of tensors)."""
    if isinstance(new, dict):
        return {k: _keep(finite, v, old[k]) for k, v in new.items()}
    return torch.where(finite, new, old)


def _sum_over_ranks(grads: dict, metrics: dict, mesh: Mesh) -> tuple[dict, dict]:
    """Every gradient and metric summed over the ranks in one all-reduce of
    a flat fp32 buffer."""
    parts = [g.reshape(-1) for g in grads.values()]
    parts.append(torch.stack([m.float() for m in metrics.values()]))
    flat = all_reduce_sum(torch.cat(parts), mesh)
    out = dict(zip(grads, flat[:-len(metrics)].split([g.numel() for g in grads.values()])))
    grads = {k: v.view_as(grads[k]) for k, v in out.items()}
    return grads, dict(zip(metrics, flat[-len(metrics):].unbind()))


@telemetry.spanned("rap.train.grad")
def train_gradients(state: TrainState, cfg: RPFConfig, batch: PartBatch, remat: bool = True,
                    x_1=None, t=None, dropout_keep=None, mesh: Mesh | None = None):
    """The gradient of one training step's loss at the state's parameters,
    {leaf path: tensor}, and its metrics: the draws from the state's
    generator (it moves on), or ``x_1`` / ``t`` / ``dropout_keep`` as in
    ``make_train_step``; with ``mesh`` the global gradient and metrics,
    summed over the ranks."""
    flat = dict(tree_paths(state.params))
    leaves = {k: p.detach().requires_grad_(True) for k, p in flat.items()}
    loss, metrics = training_forward(tree_replace(state.params, leaves), cfg, batch,
                                     state.generator, remat=remat, x_1=x_1, t=t,
                                     dropout_keep=dropout_keep, mesh=mesh)
    # a leaf the forward does not read (the qk gains with qk_norm=False)
    # gets a zero gradient, as jax.grad gives it
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()),
                                                 materialize_grads=True)))
    if mesh is not None:
        grads, metrics = _sum_over_ranks(grads, metrics, mesh)
    return grads, metrics


def make_train_step(cfg: RPFConfig, opt_cfg: OptimizerConfig, remat: bool = True,
                    device="cuda", steps_per_epoch: int = 1, mesh: Mesh | None = None):
    """``step(state, batch, x_1=None, t=None, dropout_keep=None) -> (state,
    metrics)``.

    ``x_1`` and ``t`` override the noise and the timesteps drawn from the
    state's generator (the reflow hook of rap_tpu's ``with_noise``, and the
    way a test feeds both packages the same draws), ``dropout_keep`` the FF
    dropout masks. The learning-rate milestones count epochs of
    ``steps_per_epoch`` steps. The step runs where the state lives;
    ``device`` (default the card) must match it. With ``mesh`` the step is
    data-parallel (the module docstring): ``batch`` is the rank's sample
    shard, ``x_1`` and ``t`` the global draws, ``dropout_keep`` the rank's
    masks, and the metrics are the global ones on every rank.
    """
    device = resolve_device(device)
    opt = Optimizer(opt_cfg, steps_per_epoch)

    @telemetry.spanned("rap.train.step")
    def step(state: TrainState, batch: PartBatch, x_1=None, t=None, dropout_keep=None):
        if state.step.device.type != device.type:
            raise ValueError(f"state on {state.step.device}, step built for {device}")
        grads, metrics = train_gradients(state, cfg, batch, remat, x_1, t, dropout_keep, mesh)
        flat = dict(tree_paths(state.params))
        with torch.no_grad():
            gnorm = global_norm(grads.values())
            finite = torch.isfinite(gnorm)
            with telemetry.span("rap.optim"):
                updates, opt_state = opt.update(grads, state.opt_state, flat)
            params = _keep(finite, apply_updates(flat, updates), flat)
            opt_state = _keep(finite, opt_state, state.opt_state)
        metrics.update(grad_norm=gnorm, skipped_nonfinite=(~finite).float())
        return TrainState(state.step + 1, tree_replace(state.params, params), opt_state,
                          state.generator), metrics

    return step


def make_scanned_train_steps(cfg: RPFConfig, opt_cfg: OptimizerConfig, num_steps: int,
                             remat: bool = True, device="cuda", steps_per_epoch: int = 1,
                             mesh: Mesh | None = None):
    """``scanned(state, batches) -> (state, losses)``: ``num_steps`` train
    steps (step.py:118-147), ``batches`` a list of ``num_steps`` PartBatches
    or one PartBatch whose fields carry a leading (num_steps, ...) axis (the
    rank's shards with a ``mesh``); ``losses`` (num_steps,) on the device."""
    step = make_train_step(cfg, opt_cfg, remat=remat, device=device,
                           steps_per_epoch=steps_per_epoch, mesh=mesh)

    def scanned(state: TrainState, batches):
        if isinstance(batches, PartBatch):  # stacked: one step's fields each
            batches = [dataclasses.replace(batches, **{
                f: getattr(batches, f)[i] for f in TENSOR_FIELDS
                if getattr(batches, f) is not None}) for i in range(num_steps)]
        if len(batches) != num_steps:
            raise ValueError(f"{len(batches)} batches for {num_steps} steps")
        losses = []
        for batch in batches:
            state, metrics = step(state, batch)
            losses.append(metrics["loss"])
        return state, torch.stack(losses)

    return scanned


def make_eval_step(cfg: RPFConfig):
    """``eval(params, batch, generator, x_1=None, t=None) -> metrics``: the
    validation loss (no ODE sampling), no gradients, no remat."""

    @torch.no_grad()
    def eval_step(params, batch: PartBatch, generator, x_1=None, t=None):
        return training_forward(params, cfg, batch, generator, remat=False,
                                x_1=x_1, t=t)[1]

    return eval_step
