"""Training of the port (counterpart of rap_tpu/train): optimizers and steps."""
