"""Model configurations (counterpart of rap_tpu/models/config.py:16-80).

The reference model zoo rap_10/12/16 (embed_dim 512, 8 heads) and the 6-layer
variant of the committed checkpoints, with torch dtypes. ``attn_impl`` and
``ff_impl`` select routes as rap_tpu's do on its accelerator (auto, or a
forced dense | chunked | pallas attention and xla | pallas feed-forward).
``use_kernels`` selects the hand-written CUDA kernels (True) or their plain
PyTorch versions (False) on the kernel routes; on CPU tensors both run the
plain versions.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    embed_dim: int = 512
    num_layers: int = 12
    num_heads: int = 8
    out_dim: int = 3
    in_dim: int = 0                # latent (encoder) feature dim; 0 = off
    local_feat_dim: int = 32       # MiniSpinNet descriptors
    multires: int = 10             # NeRF PE frequencies (include_input => 63 dims)
    scale_emb_on: bool = True
    local_feat_concat_on: bool = True
    qk_norm: bool = True
    softcap: float = 0.0
    dropout_rate: float = 0.0      # FF dropout in training; not ported (> 0 raises there)
    time_embed_channels: int = 256  # sinusoidal timestep channels
    compute_dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "auto"        # dense | chunked | pallas | auto
    ff_impl: str = "auto"          # xla | pallas | auto (fused GEGLU kernel)
    use_kernels: bool = True

    def __post_init__(self):
        if not 0.0 <= self.dropout_rate < 1.0:
            raise ValueError(f"dropout_rate must be in [0, 1): {self.dropout_rate}")
        if self.embed_dim % self.num_heads:
            raise ValueError(
                f"embed_dim {self.embed_dim} is not a multiple of num_heads "
                f"{self.num_heads}"
            )

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def pe_coord_dim(self) -> int:
        return 3 * (2 * self.multires + 1)  # include_input + sin/cos per freq

    @property
    def pe_scale_dim(self) -> int:
        return 1 * (2 * self.multires + 1)

    @property
    def embed_input_dim(self) -> int:
        d = self.in_dim + 2 * self.pe_coord_dim
        if self.scale_emb_on:
            d += self.pe_scale_dim
        if self.local_feat_concat_on:
            d += self.local_feat_dim
        return d


def _zoo(layers: int) -> DiTConfig:
    return DiTConfig(num_layers=layers)


MODEL_ZOO = {
    "rap_10": _zoo(10),
    "rap_12": _zoo(12),
    "rap_16": _zoo(16),
    # feature-free variant (demo "rap_12_po" path runs with zero features)
    "rap_12_po": _zoo(12),
    # 6-layer variant of the committed checkpoints (teacher3_last, ...)
    "rap_6_synth": _zoo(6),
}
