"""Positional / timestep encodings (counterpart of rap_tpu/models/embedding.py).

NeRF-style sin/cos PE with include_input and frequency bands 2^0..2^(m-1)
(embedding.py:19), and the diffusers-compatible cos-first sinusoidal
timestep embedding with max_period 10000 (embedding.py:36). All in fp32.
"""

from __future__ import annotations

import math

import torch


def nerf_positional_encoding(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^{m-1} x), cos(2^{m-1} x)].

    x: (..., D) -> (..., D*(2*num_freqs+1)).
    """
    x = x.float()
    freqs = 2.0 ** torch.arange(num_freqs, dtype=torch.float32, device=x.device)
    ang = x[..., None, :] * freqs[:, None]                    # (..., m, D)
    sc = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-2)  # (..., m, 2, D)
    sc = sc.reshape(x.shape[:-1] + (2 * num_freqs * x.shape[-1],))
    return torch.cat([x, sc], dim=-1)


def sinusoidal_timestep_embedding(
    t: torch.Tensor, num_channels: int, max_period: float = 10000.0
) -> torch.Tensor:
    """Cos-first sinusoidal embedding: t (B,) -> (B, num_channels)."""
    half = num_channels // 2
    exponent = (-math.log(max_period)
                * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    freqs = torch.exp(exponent)
    ang = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
