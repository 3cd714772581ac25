"""The DiT of the port (counterpart of rap_tpu/models)."""

from .config import MODEL_ZOO, DiTConfig

__all__ = ["MODEL_ZOO", "DiTConfig"]
