"""Kernel wrappers of the port (counterparts of rap_tpu/ops)."""

from ._common import KERNELS, launch_counts, reset_launches

__all__ = ["KERNELS", "launch_counts", "reset_launches"]
