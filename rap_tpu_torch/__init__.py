"""rap_tpu_torch: the PyTorch/CUDA port of rap_tpu for one NVIDIA H100.

A package of its own beside ``rap_tpu``, which stays the reference. It
imports torch and numpy and never jax, flax or ``rap_tpu``. Its entry points
run on the card (``device="cuda"``) unless the caller asks for the CPU, where
every kernel wrapper takes its plain PyTorch version.
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
