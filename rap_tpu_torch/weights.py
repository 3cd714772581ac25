"""Carry rap_tpu DiT parameters into the port.

``params_from_jax`` takes the JAX parameter pytree held as numpy arrays (a
nested dict whose ``layers/*`` leaves are stacked along a leading axis L)
and returns the port's parameters: the same nested dict with ``layers``
split into a list of L per-layer dicts, plus the per-layer attention guard
bounds (models/dit.py ``attention_bound2``), computed once here on the host.

``load_params_npz`` reads the committed ``.npz`` exports of
rap_tpu/train/checkpoint.py:save_params_npz (:111-128): flat "a/b/c" keys,
with bf16 arrays stored as uint16 bits under a "BF16:" prefix, decoded here
with numpy alone.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from ._device import resolve_device
from .models.dit import attach_bounds, to_device


def bf16_bits_to_float32(bits: np.ndarray) -> np.ndarray:
    """bf16 stored as uint16 bits -> the exactly equal float32 values."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def read_npz(path: str | Path) -> dict[str, np.ndarray]:
    """Flat {"a/b/c": float32 array} of a save_params_npz export."""
    out = {}
    with np.load(Path(path)) as data:
        for key in data.files:
            arr = data[key]
            if key.startswith("BF16:"):
                out[key[5:]] = bf16_bits_to_float32(arr)
            else:
                out[key] = arr.astype(np.float32)
    return out


def unflatten(flat: Mapping[str, np.ndarray]) -> dict[str, Any]:
    tree: dict[str, Any] = {}
    for key, arr in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def _tensors(tree):
    if isinstance(tree, Mapping):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def params_from_jax(tree: Mapping[str, Any]) -> dict[str, Any]:
    """JAX DiT params (numpy leaves, stacked layers) -> the port's params on
    the CPU in fp32, layers split, guard bounds attached."""
    params = _tensors({k: v for k, v in tree.items() if k != "layers"})
    stacked = _tensors(tree["layers"])

    def layer(tree_, i):
        if isinstance(tree_, dict):
            return {k: layer(v, i) for k, v in tree_.items()}
        return tree_[i].clone()

    L = {v.shape[0] for v in _leaves(stacked)}
    if len(L) != 1:
        raise ValueError(f"stacked layer arrays disagree on the layer count: {sorted(L)}")
    params["layers"] = [layer(stacked, i) for i in range(L.pop())]
    return attach_bounds(params)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def load_params_npz(path: str | Path, device="cuda",
                    compute_dtype: torch.dtype = torch.bfloat16) -> dict[str, Any]:
    """Read a committed .npz checkpoint into the port's parameters on
    ``device`` (the kernels' matrices in ``compute_dtype``, the rest fp32)."""
    device = resolve_device(device)
    params = params_from_jax(unflatten(read_npz(path)))
    return to_device(params, device, compute_dtype)
