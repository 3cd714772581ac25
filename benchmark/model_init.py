"""Random DiT weights made by the benchmark, on the device, from the seed.

The benchmark hands the same tensors to the program and to the reference.
They are in the port's parameter layout (a dict, ``layers`` a list of
per-layer dicts) with the shapes of rap_tpu's ``init_dit_params`` and its
torch-Linear uniform bounds: every uniform leaf comes from one draw of a
generator on the device, the anchor table from one normal draw. ``served``
casts the matrices the kernels read to the compute dtype (the type they are
served in); everything else stays float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# the matrices the program serves in its compute dtype
KERNEL_WEIGHTS = (("self_qkv", "kernel"), ("self_out", "kernel"), ("self_out", "bias"),
                  ("global_qkv", "kernel"), ("global_out", "kernel"), ("global_out", "bias"),
                  ("ff_in", "kernel"), ("ff_in", "bias"), ("ff_out", "kernel"),
                  ("ff_out", "bias"))


def derive_seed(*entropy: int) -> int:
    """A 63-bit seed from integers of any size."""
    return int(np.random.SeedSequence([int(e) for e in entropy]).generate_state(2, np.uint64)[0]
               >> np.uint64(1))


def _linear_shapes(fan_in: int, fan_out: int, bias: bool = True):
    out = {"kernel": ((fan_in, fan_out), 1.0 / math.sqrt(fan_in))}
    if bias:
        out["bias"] = ((fan_out,), 1.0 / math.sqrt(fan_in))
    return out


def layout(model: dict) -> dict:
    """The parameter tree with (shape, bound) at each uniform leaf and a
    string at the others ("ones", "zeros", "normal")."""
    D, H, C, FH = (model["embed_dim"], model["num_heads"], model["time_embed_channels"],
                   model["ff_hidden"])
    dh = D // H
    m = model["multires"]
    d_in = 6 * (2 * m + 1) + model["local_feat_dim"]
    if model.get("scale_emb_on", True):
        d_in += 2 * m + 1

    def adaln():
        return {"time_mlp1": _linear_shapes(C, D), "time_mlp2": _linear_shapes(D, D),
                "ada_linear": _linear_shapes(D, 2 * D)}

    layer = {
        "self_prenorm": adaln(), "self_qkv": _linear_shapes(D, 3 * D, bias=False),
        "self_out": _linear_shapes(D, D), "global_prenorm": adaln(),
        "global_qkv": _linear_shapes(D, 3 * D, bias=False), "global_out": _linear_shapes(D, D),
        "ff_norm": {"scale": ((D,), "ones"), "bias": ((D,), "zeros")},
        "ff_in": _linear_shapes(D, 2 * FH), "ff_out": _linear_shapes(FH, D),
    }
    for name in ("self_q_gamma", "self_k_gamma", "global_q_gamma", "global_k_gamma"):
        layer[name] = ((H, dh), "ones")
    return {
        "anchor_emb": ((2, D), "normal"),
        "emb_proj": _linear_shapes(d_in, D),
        "layers": [layer] * model["num_layers"],
        "final_mlp": {"fc1": _linear_shapes(D, D), "fc2": _linear_shapes(D, D // 2),
                      "fc3": _linear_shapes(D // 2, 3, bias=False)},
    }


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _set(tree: dict, path, value):
    node = tree
    for k in path[:-1]:
        if isinstance(k, int):
            while len(node) <= k:
                node.append({})
            node = node[k]
        else:
            node = node.setdefault(k, [] if k == "layers" else {})
    node[path[-1]] = value


def make_params(model: dict, seed: int, device) -> dict:
    """float32 parameters on ``device`` from ``seed``: two draws in all."""
    leaves = list(_leaves(layout(model)))
    uniform = [(p, s, b) for p, (s, b) in leaves if not isinstance(b, str)]
    total = sum(math.prod(s) for _, s, _ in uniform)
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, 0x57E1))
    flat = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    params: dict = {}
    offset = 0
    for path, shape, bound in uniform:
        n = math.prod(shape)
        _set(params, path, flat[offset:offset + n].view(shape).mul(bound))
        offset += n
    for path, (shape, kind) in leaves:
        if kind == "ones":
            _set(params, path, torch.ones(shape, device=device))
        elif kind == "zeros":
            _set(params, path, torch.zeros(shape, device=device))
        elif kind == "normal":
            _set(params, path, torch.randn(shape, generator=gen, device=device))
    return params


def served(params: dict, compute_dtype: torch.dtype) -> dict:
    """A copy of ``params`` with the kernels' matrices in ``compute_dtype``."""
    out: dict = {}
    for path, leaf in _leaves(params):
        cast = len(path) >= 2 and tuple(path[-2:]) in KERNEL_WEIGHTS
        _set(out, path, leaf.to(compute_dtype) if cast else leaf)
    return out
