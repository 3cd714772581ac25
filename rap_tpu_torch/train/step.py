"""Train and eval steps (counterpart of rap_tpu/train/step.py, without a mesh).

``make_train_step(cfg, opt_cfg)`` returns ``step(state, batch) -> (state,
metrics)``: training_forward with remat, gradients by autograd through the
port's kernels, the optimizer chain of train/optim.py, and the non-finite
guard of step.py:66-83: when the global gradient norm is not finite, the
parameters and the optimizer state keep their old values (``torch.where`` on
the device, no host sync) and ``metrics["skipped_nonfinite"]`` is 1. Metrics
are 0-d tensors on the device; reading them is the caller's sync.

Not ported yet: ``make_scanned_train_steps``, the mesh, checkpoints.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .._device import resolve_device
from ..core.batch import PartBatch
from ..models.dit import master_params
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


def make_train_step(cfg: RPFConfig, opt_cfg: OptimizerConfig, remat: bool = True,
                    device="cuda"):
    """``step(state, batch, x_1=None, t=None) -> (state, metrics)``.

    ``x_1`` and ``t`` override the noise and the timesteps drawn from the
    state's generator (the reflow hook of rap_tpu's ``with_noise``, and the
    way a test feeds both packages the same draws). The step runs where the
    state lives; ``device`` (default the card) must match it.
    """
    device = resolve_device(device)
    opt = Optimizer(opt_cfg)

    def step(state: TrainState, batch: PartBatch, x_1=None, t=None):
        if state.step.device.type != device.type:
            raise ValueError(f"state on {state.step.device}, step built for {device}")
        flat = dict(tree_paths(state.params))
        leaves = {k: p.detach().requires_grad_(True) for k, p in flat.items()}
        loss, metrics = training_forward(tree_replace(state.params, leaves), cfg, batch,
                                         state.generator, remat=remat, x_1=x_1, t=t)
        # a leaf the forward does not read (the qk gains with qk_norm=False)
        # gets a zero gradient, as jax.grad gives it
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()),
                                                     materialize_grads=True)))
        with torch.no_grad():
            gnorm = global_norm(grads.values())
            finite = torch.isfinite(gnorm)
            updates, opt_state = opt.update(grads, state.opt_state, flat)
            params = _keep(finite, apply_updates(flat, updates), flat)
            opt_state = _keep(finite, opt_state, state.opt_state)
        metrics.update(grad_norm=gnorm, skipped_nonfinite=(~finite).float())
        return TrainState(state.step + 1, tree_replace(state.params, params), opt_state,
                          state.generator), metrics

    return step


def make_eval_step(cfg: RPFConfig):
    """``eval(params, batch, generator, x_1=None, t=None) -> metrics``: the
    validation loss (no ODE sampling), no gradients, no remat."""

    @torch.no_grad()
    def eval_step(params, batch: PartBatch, generator, x_1=None, t=None):
        return training_forward(params, cfg, batch, generator, remat=False,
                                x_1=x_1, t=t)[1]

    return eval_step
