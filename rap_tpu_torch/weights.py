"""Carry rap_tpu DiT parameters into the port.

``params_from_jax`` takes the JAX parameter pytree held as numpy arrays (a
nested dict whose ``layers/*`` leaves are stacked along a leading axis L)
and returns the port's parameters: the same nested dict with ``layers``
split into a list of L per-layer dicts, plus the per-layer attention guard
bounds (models/dit.py ``attention_bounds``), computed once here on the host.
The same fp32 parameters serve training: ``models.dit.master_params`` moves
them to the device as uncast fp32 masters and drops the bounds, which
training recomputes from the current gains every step.

``load_params_npz`` reads the committed ``.npz`` exports of
rap_tpu/train/checkpoint.py:save_params_npz (:111-128): flat "a/b/c" keys,
with bf16 arrays stored as uint16 bits under a "BF16:" prefix, decoded here
with numpy alone.

``stacked_flat`` goes the other way, the port's parameters as rap_tpu's
flat "a/b/c" keys with the layers stacked (what ``train.checkpoint.
save_params_npz`` writes), and ``unflatten_params`` rebuilds the port's
parameters from its own flat paths ("layers/<i>/...", as
``train.optim.tree_paths`` gives them; what a saved train state holds).

``spinnet_params_from_jax`` carries rap_tpu's MiniSpinNet parameters
(rap_tpu/spinnet/model.py ``init_spinnet_params``) into a state dict of the
port's ``MiniSpinNet``, in the reference checkpoints' names.
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


def stacked_flat(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The port's parameters (any form, any device) as rap_tpu's flat
    {"a/b/c": fp32 CPU tensor}, ``layers/*`` stacked along a leading L
    axis; the host-side guard bounds are left out."""

    def flat(tree, prefix):
        out = {}
        for k, v in tree.items():
            if isinstance(v, Mapping):
                out.update(flat(v, f"{prefix}{k}/"))
            elif isinstance(v, torch.Tensor):
                out[f"{prefix}{k}"] = v.detach().float().cpu()
        return out

    out = flat({k: v for k, v in params.items() if k != "layers"}, "")
    layers = [flat(lp, "layers/") for lp in params["layers"]]
    out.update({k: torch.stack([lp[k] for lp in layers]) for k in layers[0]})
    return out


def unflatten_params(flat: Mapping[str, torch.Tensor]) -> dict[str, Any]:
    """{"a/b/c": tensor} with per-layer paths "layers/<i>/..." -> the port's
    nested parameters (``layers`` a list ordered by i)."""
    tree: dict[str, Any] = {}
    layers: dict[int, dict[str, torch.Tensor]] = {}
    for key, v in flat.items():
        if key.startswith("layers/"):
            i, rest = key[len("layers/"):].split("/", 1)
            layers.setdefault(int(i), {})[rest] = v
        else:
            tree[key] = v
    out = unflatten(tree)
    if layers:
        if sorted(layers) != list(range(len(layers))):
            raise ValueError(f"layer indices are not 0..{len(layers) - 1}: {sorted(layers)}")
        out["layers"] = [unflatten(layers[i]) for i in range(len(layers))]
    return out


def load_params_npz(path: str | Path, device="cuda",
                    compute_dtype: torch.dtype = torch.bfloat16) -> dict[str, Any]:
    """Read a committed .npz checkpoint into the port's parameters on
    ``device`` (the kernels' matrices in ``compute_dtype``, the rest fp32)."""
    device = resolve_device(device)
    params = params_from_jax(unflatten(read_npz(path)))
    return to_device(params, device, compute_dtype)


# rap_tpu's MiniSpinNet parameter names -> the reference's module names
_SPINNET_CONVS = {"pnt_conv": "pnt_layer.0", "conv3d": "conv_net.ops.0",
                  "pool_conv1": "pool_layer.0", "pool_conv2": "pool_layer.3",
                  **{f"conv2d_{i}": f"conv_net.ops.{3 + 3 * i}" for i in range(7)}}
_SPINNET_BNS = {"pnt_bn": "pnt_layer.1", "conv3d_bn": "conv_net.ops.1",
                "pool_bn1": "pool_layer.1", "pool_bn2": "pool_layer.4",
                **{f"conv2d_{i}_bn": f"conv_net.ops.{4 + 3 * i}" for i in range(6)}}


def spinnet_params_from_jax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """rap_tpu MiniSpinNet params (numpy leaves; conv kernels (*k, in, out))
    -> a state dict for ``spinnet.MiniSpinNet`` (kernels (out, in, *k),
    BatchNorm running statistics, affines and batch counters)."""
    sd: dict[str, torch.Tensor] = {}
    for jname, tname in _SPINNET_CONVS.items():
        k = np.asarray(tree[jname]["kernel"], np.float32)
        perm = (k.ndim - 1, k.ndim - 2) + tuple(range(k.ndim - 2))
        sd[f"{tname}.weight"] = torch.from_numpy(k.transpose(perm).copy())
        sd[f"{tname}.bias"] = torch.from_numpy(np.array(tree[jname]["bias"], np.float32))
    for jname, tname in _SPINNET_BNS.items():
        p = tree[jname]
        sd[f"{tname}.running_mean"] = torch.from_numpy(np.array(p["mean"], np.float32))
        sd[f"{tname}.running_var"] = torch.from_numpy(np.array(p["var"], np.float32))
        sd[f"{tname}.num_batches_tracked"] = torch.tensor(0)
        if "scale" in p:
            sd[f"{tname}.weight"] = torch.from_numpy(np.array(p["scale"], np.float32))
            sd[f"{tname}.bias"] = torch.from_numpy(np.array(p["bias"], np.float32))
    return sd
