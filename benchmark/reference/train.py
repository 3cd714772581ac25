"""Plain reference of the training step (rap_tpu/registration.py:92-164,
train/step.py, train/optim.py): the flow-matching loss on a padded batch,
its gradient by autograd through the float32 reference model, clipping by
the global norm, then Muon for the matrices (Nesterov momentum, 5
Newton-Schulz steps, in bf16 on the card as Muon states them,
x sqrt(max(1, cols/rows)), decoupled weight decay) and AdamW for the rest, at the learning rates of the first
epochs. Timesteps (u-shaped) and noise are drawn as the program draws them:
from a generator on the device seeded as its train state's, S uniforms then
the (G, N, 3) normals, step after step. Imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from . import dit

NS_COEFFS = (3.4445, -4.7750, 2.0315)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float
    muon_lr_mult: float
    muon_weight_decay: float
    muon_wd_mult: float
    muon_momentum: float
    muon_betas: tuple[float, float]
    eps: float
    grad_clip: float


def paths(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """[(path, leaf)] with "/"-joined keys and list indices, in tree order."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in paths(v, f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree) for kv in paths(v, f"{prefix}{i}/")]
    if not isinstance(tree, torch.Tensor):
        return []
    return [(prefix[:-1], tree)]


def rebuild(tree, values: dict, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: rebuild(v, values, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, list):
        return [rebuild(v, values, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return values.get(prefix[:-1], tree)


def u_shaped(u: torch.Tensor, a: float = 4.0, eps: float = 0.01) -> torch.Tensor:
    z = u * 2.0 - 1.0
    return ((torch.asinh(z * math.sinh(a)) / a + 1.0) / 2.0).clamp(eps, 1.0)


def loss(params: dict, model: dict, batch: dict, t: torch.Tensor, x_1: torch.Tensor,
         prec: dit.Precision = dit.FP32, keep_samples: int | None = None) -> torch.Tensor:
    """(mean squared velocity error, mean norm of the predicted velocity)
    over the valid points. ``keep_samples`` (a fault): only the first
    samples' points count."""
    P = batch["parts_per_sample"]
    x_0 = batch["points_gt"].float()
    tp = t.repeat_interleave(P)[:, None, None]
    x_t = (1.0 - tp) * x_0 + tp * x_1
    v_pred = dit.forward(params, model, x_t, t, batch, prec)
    mask = batch["point_mask"].float()
    if keep_samples is not None:
        mask = mask * (torch.arange(mask.shape[0], device=mask.device) < keep_samples * P
                       ).float()[:, None]
    se = ((v_pred - (x_1 - x_0)) ** 2).sum(-1) * mask
    count = mask.sum().clamp_min(1.0)
    vnorm = (v_pred.detach().norm(dim=-1) * mask).sum() / count
    return se.sum() / (3.0 * count), vnorm


def newton_schulz(m: torch.Tensor, steps: int = 5) -> torch.Tensor:
    """U V^T of m by the quintic iteration, run in bf16 on the card and in
    float32 on the CPU, as Muon states it (rap_tpu/train/optim.py:65-79:
    bf16 on an accelerator). In bf16 the rounding of a low-rank momentum
    (the AdaLN MLPs' gradients have rank <= the parts of the batch) is
    lifted to singular values near 1, so the update's norm depends on it."""
    a, b, c = NS_COEFFS
    low = torch.bfloat16 if m.is_cuda else torch.float32
    transpose = m.shape[-2] > m.shape[-1]
    x = (m.transpose(-1, -2) if transpose else m).to(low)
    x = x / x.float().square().sum().sqrt().clamp_min(1e-7).to(low)
    for _ in range(steps):
        xxt = x @ x.transpose(-1, -2)
        bx = xxt @ x
        x = a * x + b * bx + c * (xxt @ bx)
    x = x.float()
    return x.transpose(-1, -2) if transpose else x


def is_matrix(path: str, leaf: torch.Tensor) -> bool:
    return leaf.ndim >= 2 and "anchor_emb" not in path


def clip(grads: dict, limit: float) -> dict:
    gnorm = torch.stack([g.square().sum() for g in grads.values()]).sum().sqrt()
    if float(gnorm) < limit:
        return grads
    return {k: g / gnorm * limit for k, g in grads.items()}


def optimizer_step(params: dict, grads: dict, state: dict, cfg: OptimizerConfig) -> dict:
    """New parameters (flat, by path) after one step; ``state`` is updated."""
    count = state.setdefault("count", 0)
    b1, b2 = cfg.muon_betas
    mu_lr, mu_wd = cfg.lr * cfg.muon_lr_mult, cfg.muon_weight_decay * cfg.muon_wd_mult
    bc1, bc2 = 1 - b1 ** (count + 1), 1 - b2 ** (count + 1)
    new = {}
    for k, p in params.items():
        g = grads[k]
        if is_matrix(k, p):
            m = cfg.muon_momentum * state.get(("m", k), torch.zeros_like(p)) + g
            state[("m", k)] = m
            o = newton_schulz(g + cfg.muon_momentum * m)
            u = o * math.sqrt(max(1.0, o.shape[-1] / o.shape[-2])) + mu_wd * p
            new[k] = p - mu_lr * u
        else:
            mu = (1 - b1) * g + b1 * state.get(("mu", k), torch.zeros_like(p))
            nu = (1 - b2) * g * g + b2 * state.get(("nu", k), torch.zeros_like(p))
            state[("mu", k)], state[("nu", k)] = mu, nu
            u = (mu / bc1) / ((nu / bc2).sqrt() + cfg.eps) + cfg.muon_weight_decay * p
            new[k] = p - cfg.lr * u
    state["count"] = count + 1
    return new


def run_steps(params: dict, model: dict, batches: list[dict], seed: int, cfg: OptimizerConfig,
              prec: dit.Precision = dit.FP32, keep_samples: int | None = None) -> dict:
    """The first ``len(batches)`` steps from ``params`` (float32 masters):
    each step's loss and mean predicted-velocity norm, the first gradient by
    path as the optimizer takes it (clipped) and the parameters after the
    last step by path."""
    device = batches[0]["points"].device
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = {k: v.detach().float().clone() for k, v in paths(params)}
    state: dict = {}
    losses, vnorms, first_grad = [], [], None
    with dit.exact_fp32():
        for batch in batches:
            S = batch["scale"].shape[0]
            t = u_shaped(torch.rand(S, generator=gen, device=device))
            x_1 = torch.randn(batch["points_gt"].shape, generator=gen, device=device)
            leaves = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
            value, vnorm = loss(rebuild(params, leaves), model, batch, t, x_1, prec, keep_samples)
            vnorms.append(float(vnorm))
            grads = clip(dict(zip(leaves, torch.autograd.grad(value, list(leaves.values())))),
                         cfg.grad_clip)
            if first_grad is None:
                first_grad = {k: g.detach() for k, g in grads.items()}
            with torch.no_grad():
                flat = optimizer_step(flat, grads, state, cfg)
            losses.append(float(value.detach()))
    return {"losses": losses, "vnorms": vnorms, "first_grad": first_grad, "params": flat}
