"""Batch, pose fitting and ODE sampling (counterpart of rap_tpu/core)."""
