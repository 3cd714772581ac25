"""Masked and per-sample reductions for the part-major batch layout
(counterpart of rap_tpu/core/segments.py).

Per-part masked means and sums over the point axis, and sums of per-part
values into their sample slots (``index_add_`` over ``sample_of_part`` in
place of ``jax.ops.segment_sum``).
"""

from __future__ import annotations

import torch


def masked_mean(x: torch.Tensor, mask: torch.Tensor, axis: int = -2, eps: float = 0.0):
    """Mean of ``x`` over ``axis`` counting only ``mask`` entries.
    x: (..., N, D), mask: (..., N) -> (..., D). Empty groups return 0."""
    m = mask.to(x.dtype)[..., None]
    return (x * m).sum(axis) / (m.sum(axis)).clamp_min(1.0 + eps)


def masked_sum(x: torch.Tensor, mask: torch.Tensor, axis: int = -2):
    return (x * mask.to(x.dtype)[..., None]).sum(axis)


def per_sample_sum(x_part: torch.Tensor, sample_of_part: torch.Tensor, num_samples: int):
    """Sum per-part values (G, ...) into per-sample slots (S, ...)."""
    out = x_part.new_zeros((num_samples,) + tuple(x_part.shape[1:]))
    return out.index_add_(0, sample_of_part.long(), x_part)


def per_sample_mean(x_part: torch.Tensor, weight_part: torch.Tensor,
                    sample_of_part: torch.Tensor, num_samples: int):
    """Weighted per-sample mean of per-part values; x_part (G, ...),
    weight_part (G,), e.g. part_valid or point counts."""
    shape = (-1,) + (1,) * (x_part.dim() - 1)
    w = weight_part.to(x_part.dtype)
    num = per_sample_sum(x_part * w.reshape(shape), sample_of_part, num_samples)
    den = per_sample_sum(w, sample_of_part, num_samples)
    return num / den.clamp_min(1.0).reshape(shape)


def masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor):
    """MSE over valid entries only; mask broadcasts against leading dims."""
    m = mask.to(pred.dtype)
    while m.dim() < pred.dim():
        m = m[..., None]
    se = (pred - target) ** 2 * m
    count = m.sum() if m.shape[-1] == pred.shape[-1] else m.sum() * pred.shape[-1]
    return se.sum() / count.clamp_min(1.0)
