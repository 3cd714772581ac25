"""The masked Kabsch fit of every part in one launch, with no host sync.

The kernel is csrc/kabsch.cu (no Pallas counterpart: rap_tpu's
``kabsch_masked``, core/procrustes.py:19, takes XLA's SVD). Per part b of
(B, N, 3) it fits the rigid pose source -> target with weights
w = mask * weights, where the target is ``target`` or, with ``velocity``
given, the sampler's end-point estimate ``target - velocity * t``, formed
on the fly; with ``x_1`` given it also writes rigidity forcing's next ODE
state x_next = where(mask, R source + t, target) * (1 - t_next) + x_1 *
t_next. Its arithmetic is ``core.procrustes._fit`` with the SVD by
``_jacobi_svd3``; ``core.procrustes`` decides which fits come here (CUDA
tensors, no gradient) and fits every other one in plain PyTorch.
"""

from __future__ import annotations

import torch

from ._common import check_input, launch, on_cpu, require


def check(source, target, mask, weights=None, velocity=None, x_1=None) -> None:
    """Raise unless the kernel takes these dtypes, shapes and layouts."""
    if mask.dim() != 2:
        raise ValueError(f"mask: shape {tuple(mask.shape)}, the kernel takes (B, N)")
    B, N = mask.shape
    check_input("mask", mask, torch.bool, (B, N))
    for name, x in (("source", source), ("target", target), ("velocity", velocity),
                    ("x_1", x_1)):
        if x is not None:
            check_input(name, x, torch.float32, (B, N, 3))
    if weights is not None:
        check_input("weights", weights, torch.float32, (B, N))


def kabsch(source, target, mask, weights=None, velocity=None, t=0.0, x_1=None, t_next=0.0):
    """Per part of B parts: (R (B, 3, 3), t (B, 3)) of the masked, weighted
    rigid fit of ``source`` to ``target`` (less ``velocity * t`` where given),
    and with ``x_1`` the forced state (B, N, 3) as third output.

    Points and velocity fp32 (B, N, 3), mask bool (B, N), weights fp32
    (B, N), all contiguous and on one CUDA device; anything else raises
    (``core.procrustes`` fits CPU tensors itself). One launch; nothing
    differentiates through it.
    """
    check(source, target, mask, weights, velocity, x_1)
    tensors = [x for x in (source, target, mask, weights, velocity, x_1) if x is not None]
    require(not on_cpu(*tensors), "kabsch: the kernel takes CUDA tensors")
    B, N = mask.shape
    R = torch.empty((B, 3, 3), dtype=torch.float32, device=source.device)
    tr = torch.empty((B, 3), dtype=torch.float32, device=source.device)
    out = None if x_1 is None else torch.empty_like(x_1)

    def ptr(x):
        return None if x is None else x.data_ptr()

    launch("kabsch", source, source.data_ptr(), target.data_ptr(), ptr(velocity),
           mask.data_ptr(), ptr(weights), ptr(x_1), ptr(out), R.data_ptr(), tr.data_ptr(),
           float(t), 1.0 - float(t_next), float(t_next), B, N)
    return (R, tr) if x_1 is None else (R, tr, out)
