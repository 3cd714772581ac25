"""Entry points of the port (counterpart of rap_tpu/apps)."""
