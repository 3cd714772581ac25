"""Helpers shared by the parity tests of rap_tpu_torch against rap_tpu.

Inputs are made with numpy from a seed and handed to both packages as
numpy arrays; both run on the CPU (JAX's Pallas kernels in interpret mode,
the port's wrappers through their plain versions).
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from rap_tpu_torch.core.batch import TENSOR_FIELDS, PartBatch
from rap_tpu_torch.weights import params_from_jax


def batch_to_torch(jb) -> PartBatch:
    """numpy copy of a rap_tpu PartBatch -> the port's batch on the CPU."""
    arrays = {f: np.asarray(getattr(jb, f)) for f in TENSOR_FIELDS
              if getattr(jb, f) is not None}
    return PartBatch.from_numpy(arrays, jb.no_padding, device="cpu")


def params_to_torch(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams))


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def max_err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())
