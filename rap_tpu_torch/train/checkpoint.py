"""Checkpoints: train states in the port's own format, parameter exports,
and the reference's torch checkpoints (counterpart of
rap_tpu/train/checkpoint.py).

Train states. rap_tpu saves its ``TrainState`` with orbax, which needs jax;
the port saves its own: a directory holding ``train_state.pt``, one flat
dict of CPU tensors (``step``, ``params/<path>`` fp32 masters,
``opt_state/<path>``, ``generator``: the generator's ``get_state()``, for a
card generator its Philox seed and offset), which ``torch.load(...,
weights_only=True)`` reads; the ``rap_metadata.json`` sidecar; and the
commit marker ``commit_success.txt``, written last. The save is rap_tpu's
kill-safe protocol (:39-108): write ``<path>.new``, then swap by renames
through ``<path>.old``, so at every instant one complete checkpoint exists,
and ``resolve_checkpoint_dir`` picks the newest complete one (a complete
``.new``, then ``path``, then ``.old``). ``restore_checkpoint`` rebuilds a
state of the target's structure on the target's device.

Parameter exports. ``save_params_npz`` writes rap_tpu's compact format
(:111-128): flat "a/b/c" keys with the layers stacked along a leading axis,
cast to ``dtype``, bf16 stored as uint16 bits under "BF16:" keys, so
rap_tpu's ``load_params_npz`` reads a port export (and
``rap_tpu_torch.weights.load_params_npz`` reads rap_tpu's).

Torch checkpoints (:180-312). ``convert_torch_state_dict`` maps the
reference flow model's state dict (torch Linear weights (out, in),
transposed to (in, out) kernels) onto the port's parameters, where
``layers`` is a list of per-layer dicts; ``load_torch_checkpoint`` reads a
Lightning ``.ckpt`` or a ``.pth``/``.pt`` and strips the ``flow_model.``
prefix; ``export_torch_state_dict`` is the inverse mapping and
``save_torch_checkpoint`` writes it as a ``.pth`` that
``load_torch_checkpoint`` reads back. Name mapping (torch -> params), layer
i being ``layers[i]``:

  anchor_part_emb.weight                          -> anchor_emb
  encoding_manager.emb_proj.{weight,bias}         -> emb_proj
  transformer_layers.{i}.{self,global}_prenorm.timestep_embedder.linear_{1,2}
                                                  -> {self,global}_prenorm.time_mlp{1,2}
  transformer_layers.{i}.{self,global}_prenorm.linear -> {self,global}_prenorm.ada_linear
  transformer_layers.{i}.{self,global}_qkv_proj.weight -> {self,global}_qkv
  transformer_layers.{i}.{self,global}_out_proj   -> {self,global}_out
  transformer_layers.{i}.{self,global}_{q,k}_norm.gamma -> {self,global}_{q,k}_gamma
  transformer_layers.{i}.ff_norm.{weight,bias}    -> ff_norm.{scale,bias}
  transformer_layers.{i}.ff.net.0.proj, ff.net.2  -> ff_in, ff_out
  final_mlp.{0,2,4}                               -> final_mlp.fc{1,2,3}
"""

from __future__ import annotations

import json
import logging
import pickle
import shutil
from pathlib import Path
from typing import Any

import numpy as np
import torch

from .optim import tree_paths, tree_replace
from .step import TrainState

logger = logging.getLogger("rap_tpu_torch.checkpoint")

STATE_FILE = "train_state.pt"
METADATA_FILE = "rap_metadata.json"
COMMIT_FILE = "commit_success.txt"


# --------------------------------------------------------------------------
# Train states
# --------------------------------------------------------------------------

def train_state_tensors(state: TrainState) -> dict[str, torch.Tensor]:
    """The train state as one flat dict of CPU tensors."""
    out = {"step": state.step.detach().cpu()}
    out.update({f"params/{k}": v.detach().cpu() for k, v in tree_paths(state.params)})
    out.update({f"opt_state/{k}": v.detach().cpu()
                for k, v in tree_paths(state.opt_state)})
    out["generator"] = state.generator.get_state()
    return out


def save_checkpoint(path: str | Path, state: TrainState, metadata: dict | None = None) -> int:
    """Save ``state`` kill-safely at ``path`` (see the module docstring);
    returns the bytes of the state file."""
    path = Path(path).absolute()
    tmp = path.with_name(path.name + ".new")
    old = path.with_name(path.name + ".old")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    torch.save(train_state_tensors(state), tmp / STATE_FILE)
    if metadata:
        (tmp / METADATA_FILE).write_text(json.dumps(metadata, indent=2))
    (tmp / COMMIT_FILE).write_text("")
    nbytes = (tmp / STATE_FILE).stat().st_size
    shutil.rmtree(old, ignore_errors=True)
    if path.exists():
        path.rename(old)
    tmp.rename(path)
    shutil.rmtree(old, ignore_errors=True)
    return nbytes


def _complete(p: Path) -> bool:
    return p.is_dir() and ((p / COMMIT_FILE).exists() or (p / METADATA_FILE).exists())


def resolve_checkpoint_dir(path: str | Path) -> Path:
    """The newest complete checkpoint among ``path.new``, ``path`` and
    ``path.old`` (a complete ``.new`` is newer than ``path``: the save
    finishes it before the swap), else ``path``."""
    path = Path(path).absolute()
    for cand in (path.with_name(path.name + ".new"), path,
                 path.with_name(path.name + ".old")):
        if _complete(cand):
            return cand
    return path


def is_train_state_dir(path: str | Path) -> bool:
    """Whether ``path`` resolves to a train state saved by ``save_checkpoint``."""
    return (resolve_checkpoint_dir(path) / STATE_FILE).is_file()


def _load_tensors(path: str | Path) -> dict[str, torch.Tensor]:
    d = resolve_checkpoint_dir(path)
    f = d / STATE_FILE
    if not f.is_file():
        raise FileNotFoundError(f"no {STATE_FILE} in {d} (not a train state of the port)")
    return torch.load(f, map_location="cpu", weights_only=True)


def _take(flat: dict[str, torch.Tensor], prefix: str, target, device):
    """``target``'s structure with every leaf from ``flat[prefix + path]``,
    on ``device`` in the target leaf's dtype."""
    values = {}
    for k, leaf in tree_paths(target):
        key = prefix + k
        if key not in flat:
            raise KeyError(f"missing in checkpoint: {key}")
        v = flat[key]
        if tuple(v.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {tuple(v.shape)} != {tuple(leaf.shape)}")
        values[k] = v.to(device=device, dtype=leaf.dtype)
    return tree_replace(target, values)


def restore_checkpoint(path: str | Path, target: TrainState) -> TrainState:
    """The train state saved at ``path`` (resolved to the newest complete
    save), in ``target``'s structure on ``target``'s device."""
    flat = _load_tensors(path)
    device = target.step.device
    gen_state = flat["generator"]
    ref_state = target.generator.get_state()
    if gen_state.numel() != ref_state.numel():
        raise ValueError(f"the checkpoint's generator state has {gen_state.numel()} bytes, "
                         f"a {target.generator.device.type} generator {ref_state.numel()}: "
                         "restore onto the device type it was saved from")
    generator = torch.Generator(device=target.generator.device)
    generator.set_state(gen_state)
    return TrainState(
        step=flat["step"].to(device=device, dtype=target.step.dtype),
        params=_take(flat, "params/", target.params, device),
        opt_state=_take(flat, "opt_state/", target.opt_state, device),
        generator=generator,
    )


def load_train_state_params(path: str | Path) -> dict[str, Any]:
    """The fp32 parameters of a saved train state, on the CPU, in the port's
    layout (``layers`` a list of per-layer dicts)."""
    from ..weights import unflatten_params

    flat = _load_tensors(path)
    return unflatten_params({k[len("params/"):]: v for k, v in flat.items()
                             if k.startswith("params/")})


def load_metadata(path: str | Path) -> dict:
    f = resolve_checkpoint_dir(path) / METADATA_FILE
    return json.loads(f.read_text()) if f.exists() else {}


# --------------------------------------------------------------------------
# rap_tpu's npz parameter export
# --------------------------------------------------------------------------

def save_params_npz(path: str | Path, params, dtype: torch.dtype = torch.bfloat16) -> None:
    """Export parameters as one compressed .npz in rap_tpu's format (params
    only, cast to ``dtype``; bf16 as uint16 bits under "BF16:" keys)."""
    from ..weights import stacked_flat

    out: dict[str, np.ndarray] = {}
    for key, arr in stacked_flat(params).items():
        v = arr.to(dtype)
        if v.dtype == torch.bfloat16:
            out["BF16:" + key] = v.view(torch.int16).numpy().view(np.uint16)
        else:
            out[key] = v.numpy()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **out)


# --------------------------------------------------------------------------
# Torch checkpoints of the reference
# --------------------------------------------------------------------------

def strip_prefix(state_dict: dict, prefix: str) -> dict:
    """Keep only keys under ``prefix``, with it removed; all keys when none
    has it (:180-186)."""
    out = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
    return out or dict(state_dict)


def convert_torch_state_dict(sd: dict[str, Any], num_layers: int) -> dict[str, Any]:
    """A reference flow-model state dict (torch tensors or numpy arrays) as
    the port's fp32 parameters on the CPU. Raises KeyError on a missing
    weight."""

    def arr(key):
        v = sd[key]
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().float().numpy()
        return torch.from_numpy(np.array(v, np.float32))

    def linear(key, bias=True):
        p = {"kernel": arr(f"{key}.weight").T.contiguous()}
        if bias:
            p["bias"] = arr(f"{key}.bias")
        return p

    T = "transformer_layers"

    def layer(i):
        p: dict[str, Any] = {"ff_norm": {"scale": arr(f"{T}.{i}.ff_norm.weight"),
                                         "bias": arr(f"{T}.{i}.ff_norm.bias")},
                             "ff_in": linear(f"{T}.{i}.ff.net.0.proj"),
                             "ff_out": linear(f"{T}.{i}.ff.net.2")}
        for which in ("self", "global"):
            base = f"{T}.{i}.{which}_prenorm"
            p[f"{which}_prenorm"] = {
                "time_mlp1": linear(f"{base}.timestep_embedder.linear_1"),
                "time_mlp2": linear(f"{base}.timestep_embedder.linear_2"),
                "ada_linear": linear(f"{base}.linear"),
            }
            p[f"{which}_qkv"] = linear(f"{T}.{i}.{which}_qkv_proj", bias=False)
            p[f"{which}_out"] = linear(f"{T}.{i}.{which}_out_proj")
            if f"{T}.{i}.{which}_q_norm.gamma" in sd:
                p[f"{which}_q_gamma"] = arr(f"{T}.{i}.{which}_q_norm.gamma")
                p[f"{which}_k_gamma"] = arr(f"{T}.{i}.{which}_k_norm.gamma")
        return p

    return {
        "anchor_emb": arr("anchor_part_emb.weight"),
        "emb_proj": linear("encoding_manager.emb_proj"),
        "layers": [layer(i) for i in range(num_layers)],
        "final_mlp": {"fc1": linear("final_mlp.0"), "fc2": linear("final_mlp.2"),
                      "fc3": linear("final_mlp.4", bias=False)},
    }


def torch_checkpoint_layers(sd: dict[str, Any]) -> int:
    """The transformer layer count of a (prefix-stripped) state dict."""
    ids = {int(k.split(".")[1]) for k in sd if k.startswith("transformer_layers.")}
    return max(ids) + 1 if ids else 0


def read_torch_checkpoint(path: str | Path) -> dict[str, Any]:
    """The flow model's state dict of a Lightning ``.ckpt`` or a
    ``.pth``/``.pt``, ``flow_model.`` stripped. A file that holds more than
    tensors (a Lightning checkpoint's hyper-parameters) is unpickled whole:
    load only checkpoints you trust."""
    try:
        raw = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        logger.warning("%s holds objects besides tensors; unpickling it whole", path)
        raw = torch.load(path, map_location="cpu", weights_only=False)
    sd = raw.get("state_dict", raw)
    return strip_prefix(sd, "flow_model.")


def load_torch_checkpoint(path: str | Path, num_layers: int) -> dict[str, Any]:
    """Read a ``.ckpt``/``.pth`` and convert the flow model's weights."""
    return convert_torch_state_dict(read_torch_checkpoint(path), num_layers)


def export_torch_state_dict(params: dict[str, Any], num_layers: int) -> dict[str, np.ndarray]:
    """The inverse mapping: parameters (serving or master form, any device)
    -> a reference-named state dict of fp32 numpy arrays."""
    sd: dict[str, np.ndarray] = {}

    def np32(v):
        return v.detach().float().cpu().numpy()

    def put_linear(key, p, bias=True):
        sd[f"{key}.weight"] = np.ascontiguousarray(np32(p["kernel"]).T)
        if bias:
            sd[f"{key}.bias"] = np32(p["bias"])

    sd["anchor_part_emb.weight"] = np32(params["anchor_emb"])
    put_linear("encoding_manager.emb_proj", params["emb_proj"])
    for i in range(num_layers):
        lp, T = params["layers"][i], f"transformer_layers.{i}"
        for which in ("self", "global"):
            pn = lp[f"{which}_prenorm"]
            put_linear(f"{T}.{which}_prenorm.timestep_embedder.linear_1", pn["time_mlp1"])
            put_linear(f"{T}.{which}_prenorm.timestep_embedder.linear_2", pn["time_mlp2"])
            put_linear(f"{T}.{which}_prenorm.linear", pn["ada_linear"])
            put_linear(f"{T}.{which}_qkv_proj", lp[f"{which}_qkv"], bias=False)
            put_linear(f"{T}.{which}_out_proj", lp[f"{which}_out"])
            if f"{which}_q_gamma" in lp:
                sd[f"{T}.{which}_q_norm.gamma"] = np32(lp[f"{which}_q_gamma"])
                sd[f"{T}.{which}_k_norm.gamma"] = np32(lp[f"{which}_k_gamma"])
        sd[f"{T}.ff_norm.weight"] = np32(lp["ff_norm"]["scale"])
        sd[f"{T}.ff_norm.bias"] = np32(lp["ff_norm"]["bias"])
        put_linear(f"{T}.ff.net.0.proj", lp["ff_in"])
        put_linear(f"{T}.ff.net.2", lp["ff_out"])
    put_linear("final_mlp.0", params["final_mlp"]["fc1"])
    put_linear("final_mlp.2", params["final_mlp"]["fc2"])
    put_linear("final_mlp.4", params["final_mlp"]["fc3"], bias=False)
    return sd


def save_torch_checkpoint(path: str | Path, params: dict[str, Any]) -> None:
    """Write ``export_torch_state_dict(params)`` as a ``.pth``
    (``{"state_dict": {"flow_model.<name>": tensor}}``, tensors only)."""
    sd = export_torch_state_dict(params, len(params["layers"]))
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"state_dict": {f"flow_model.{k}": torch.from_numpy(v) for k, v in sd.items()}},
               path)
