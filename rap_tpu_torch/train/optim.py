"""Optimizers: AdamW and Muon (counterpart of rap_tpu/train/optim.py).

``Optimizer`` repeats the optax chain that ``build_optimizer`` (:153-187)
builds, in the same order and with the same step count:

  clip_by_global_norm(grad_clip)
  -> muon group (2-D leaves but ``anchor_emb``): Nesterov momentum, 5-step
     quintic Newton-Schulz per matrix (:65), x sqrt(max(1, cols/rows)),
     + decoupled weight decay, x -lr_muon(count)
  -> adamw group (vectors and ``anchor_emb``): optax's scale_by_adam (bias
     correction with count+1, eps outside the sqrt), + weight decay,
     x -lr(count)

with lr the MultiStepLR schedule (:146-150: x gamma from each milestone
on), milestones counted in epochs of ``steps_per_epoch`` steps (milestone m
takes effect at step m * steps_per_epoch; the default 1 counts them in
steps, as rap_tpu's default does). ``name="adamw"`` puts every leaf in
one AdamW group. One int32 step count stands for optax's per-transform
counts, which always move together.

The matrix mask follows the port's layout: ``layers`` is a list of
per-layer dicts, so a per-layer matrix is 2-D here (3-D in the stacked JAX
tree, :126-143); per-layer biases, LayerNorm gains and the anchor table go
to AdamW, the qk-norm gains (H, dh) to Muon, as in rap_tpu.

Newton-Schulz runs in bf16 on CUDA, as rap_tpu does on its accelerator, and
in fp32 on the CPU, as rap_tpu does on the CPU (:77-79); matrices of one
shape are orthogonalised together as one batch. Updates are functional:
``update`` returns new tensors, so a caller can keep the old state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

_NS_COEFFS = (3.4445, -4.7750, 2.0315)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "muon"             # "adamw" | "muon"
    lr: float = 2e-4               # AdamW lr (muon group uses 10x)
    weight_decay: float = 1e-6     # pure-AdamW recipe
    betas: tuple[float, float] = (0.95, 0.999)
    eps: float = 1e-8
    muon_weight_decay: float = 0.01          # aux-AdamW group wd
    muon_betas: tuple[float, float] = (0.9, 0.95)
    muon_lr_mult: float = 10.0
    muon_wd_mult: float = 0.1                # muon group wd = 0.01 * 0.1
    muon_momentum: float = 0.95
    grad_clip: float = 0.5
    lr_milestones: tuple[int, ...] = (400, 550, 700, 850, 1000)  # epochs
    lr_gamma: float = 0.5


def newton_schulz_orthogonalize(m: torch.Tensor, steps: int = 5) -> torch.Tensor:
    """Approximate U V^T of the (batched) matrix m (..., rows, cols) by the
    quintic Newton-Schulz iteration; bf16 on CUDA, fp32 on the CPU; fp32 out."""
    a, b, c = _NS_COEFFS
    transpose = m.shape[-2] > m.shape[-1]
    x = m.transpose(-1, -2) if transpose else m
    low = torch.bfloat16 if x.is_cuda else torch.float32
    x = x.to(low)
    norm = torch.sqrt((x.float() ** 2).sum(dim=(-2, -1), keepdim=True))
    x = x / norm.clamp_min(1e-7).to(low)
    for _ in range(steps):
        xxt = x @ x.transpose(-1, -2)
        bx = xxt @ x
        cxx = xxt @ bx
        x = a * x + b * bx + c * cxx
    x = x.float()
    return x.transpose(-1, -2) if transpose else x


def tree_paths(tree, prefix: str = ""):
    """[(path, tensor)] of a nested dict/list of tensors, in a fixed order."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in tree_paths(v, f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree) for kv in tree_paths(v, f"{prefix}{i}/")]
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"{prefix[:-1]}: a training parameter must be a tensor, "
                        f"got {type(tree).__name__}")
    return [(prefix[:-1], tree)]


def tree_replace(tree, values: dict[str, torch.Tensor], prefix: str = ""):
    """The same nested structure with each leaf taken from ``values`` by path."""
    if isinstance(tree, dict):
        return {k: tree_replace(v, values, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_replace(v, values, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return values[prefix[:-1]]


def is_matrix(path: str, leaf: torch.Tensor) -> bool:
    """Muon takes the 2-D leaves except the anchor embedding table."""
    return leaf.ndim >= 2 and "anchor_emb" not in path


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    return torch.stack([(t.float() ** 2).sum() for t in tensors]).sum().sqrt()


class Optimizer:
    """The optax chain of ``build_optimizer`` on the port's parameter dicts.

    ``init(params)`` gives the state; ``update(grads, state, params)`` gives
    (updates, new state) with updates to add to the parameters, as optax's
    ``tx.update`` and ``apply_updates`` do. Gradients and parameters are
    nested dicts of the same structure; the state holds flat dicts by path.
    """

    def __init__(self, cfg: OptimizerConfig, steps_per_epoch: int = 1):
        if cfg.name not in ("adamw", "muon"):
            raise ValueError(f"Unknown optimizer: {cfg.name}")
        self.cfg = cfg
        self.steps_per_epoch = steps_per_epoch

    def _muon(self, path, leaf) -> bool:
        return self.cfg.name == "muon" and is_matrix(path, leaf)

    def _lr(self, base: float, count: torch.Tensor) -> torch.Tensor:
        """MultiStepLR as optax.piecewise_constant_schedule, on the device."""
        v = torch.full((), base, dtype=torch.float32, device=count.device)
        for m in sorted(self.cfg.lr_milestones):
            v = torch.where(count >= int(m) * self.steps_per_epoch, v * self.cfg.lr_gamma, v)
        return v

    def init(self, params) -> dict[str, Any]:
        leaves = tree_paths(params)
        device = leaves[0][1].device
        state: dict[str, Any] = {"count": torch.zeros((), dtype=torch.int32, device=device),
                                 "momentum": {}, "mu": {}, "nu": {}}
        for path, p in leaves:
            if self._muon(path, p):
                state["momentum"][path] = torch.zeros_like(p)
            else:
                state["mu"][path] = torch.zeros_like(p)
                state["nu"][path] = torch.zeros_like(p)
        return state

    @torch.no_grad()
    def update(self, grads, state, params):
        cfg = self.cfg
        grads = dict(tree_paths(grads))
        params = dict(tree_paths(params))
        if cfg.grad_clip and cfg.grad_clip > 0:
            gnorm = global_norm(grads.values())
            clip = gnorm < cfg.grad_clip
            grads = {k: torch.where(clip, g, g / gnorm * cfg.grad_clip)
                     for k, g in grads.items()}
        count = state["count"]
        count_inc = count + 1
        updates: dict[str, torch.Tensor] = {}
        new = {"count": count_inc, "momentum": {}, "mu": {}, "nu": {}}

        if cfg.name == "muon":
            b1, b2 = cfg.muon_betas
            wd, lr = cfg.muon_weight_decay, self._lr(cfg.lr, count)
            mu_lr = self._lr(cfg.lr * cfg.muon_lr_mult, count)
            mu_wd = cfg.muon_weight_decay * cfg.muon_wd_mult
            eff = {}
            for k, m in state["momentum"].items():
                m_new = cfg.muon_momentum * m + grads[k]
                new["momentum"][k] = m_new
                eff[k] = grads[k] + cfg.muon_momentum * m_new  # Nesterov
            for k, o in self._orthogonalize(eff).items():
                rows, cols = o.shape[-2], o.shape[-1]
                u = o * math.sqrt(max(1.0, cols / rows)) + mu_wd * params[k]
                updates[k] = -mu_lr * u
        else:
            b1, b2 = cfg.betas
            wd, lr = cfg.weight_decay, self._lr(cfg.lr, count)

        bc1 = 1 - torch.pow(torch.tensor(b1, device=count.device), count_inc.float())
        bc2 = 1 - torch.pow(torch.tensor(b2, device=count.device), count_inc.float())
        for k in state["mu"]:
            g = grads[k]
            mu = (1 - b1) * g + b1 * state["mu"][k]
            nu = (1 - b2) * g**2 + b2 * state["nu"][k]
            new["mu"][k], new["nu"][k] = mu, nu
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps) + wd * params[k]
            updates[k] = -lr * u
        return updates, new

    @staticmethod
    def _orthogonalize(mats: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Newton-Schulz of every matrix, one batched call per shape."""
        by_shape: dict[tuple, list[str]] = {}
        for k, m in mats.items():
            by_shape.setdefault(tuple(m.shape), []).append(k)
        out = {}
        for keys in by_shape.values():
            o = newton_schulz_orthogonalize(torch.stack([mats[k] for k in keys]))
            out.update(zip(keys, o.unbind(0)))
        return out


def apply_updates(params, updates: dict[str, torch.Tensor]):
    """params + updates (by path), in each parameter's dtype."""
    return tree_replace(params, {k: (p + updates[k]).to(p.dtype)
                                 for k, p in tree_paths(params)})
