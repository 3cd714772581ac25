"""PointCloudDiT forward (counterpart of rap_tpu/models/dit.py:313-409).

Ported: the dense, mask-free fused branch of ``_attention_block``
(dit.py:177-226) and the dropout-free ``_geglu_ff``. Per layer: AdaLN part
attention -> AdaLN global attention -> LayerNorm + GEGLU feed-forward, each
with its residual, through five kernels: proj (AdaLN + QKV + qk-norm),
attention (fixed-bound or online softmax, chosen per layer on the host from
the qk-norm gains at weight load), out_proj (+ residual), ff (+ residual).
The encoding (NeRF PE, anchor embedding) runs in fp32 and is cast to the
compute dtype; the per-part timestep sinusoid and the AdaLN MLPs are fp32;
the head is fp32.

Not ported yet (each raises or is absent): the masked branch for padded
batches (dit.py:228-268), ring attention, ``return_features``, ``latent``.

Parameters are a nested dict like the JAX pytree, except that ``layers`` is
a list of per-layer dicts (the stacked ``layers/*`` arrays split along L)
and each layer carries the host-side guard inputs ``self_bound2`` and
``global_bound2`` (see ``attention_bound2``).
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..core.batch import PartBatch
from ..ops import flash_attention, fused_ff, fused_proj
from .config import DiTConfig
from .embedding import nerf_positional_encoding, sinusoidal_timestep_embedding

Params = dict[str, Any]

# matrices that feed the kernels; they are held in the compute dtype
KERNEL_WEIGHTS = (
    ("self_qkv", "kernel"), ("self_out", "kernel"), ("self_out", "bias"),
    ("global_qkv", "kernel"), ("global_out", "kernel"), ("global_out", "bias"),
    ("ff_in", "kernel"), ("ff_in", "bias"), ("ff_out", "kernel"),
    ("ff_out", "bias"),
)


def attention_bound2(gamma_q: torch.Tensor, gamma_k: torch.Tensor) -> float:
    """Upper bound on the base-2 logits q·k of one attention call, from the
    qk-norm gains (dit.py:214-217): log2(e)*sqrt(dh)*max|gq|*max|gk|. Computed
    on the host once per layer, so the forward never syncs for the guard."""
    dh = gamma_q.shape[-1]
    return (math.log2(math.e) * math.sqrt(dh)
            * float(gamma_q.abs().max()) * float(gamma_k.abs().max()))


def attach_bounds(params: Params) -> Params:
    for lp in params["layers"]:
        for prefix in ("self", "global"):
            lp[f"{prefix}_bound2"] = attention_bound2(
                lp[f"{prefix}_q_gamma"], lp[f"{prefix}_k_gamma"]
            )
    return params


# --------------------------------------------------------------------------
# Initialization (torch-Linear-style uniform bounds, as init_dit_params)
# --------------------------------------------------------------------------

def _uniform(gen, shape, bound):
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2 - 1) * bound


def _linear_init(gen, fan_in, fan_out, bias=True):
    bound = 1.0 / math.sqrt(fan_in)
    p = {"kernel": _uniform(gen, (fan_in, fan_out), bound)}
    if bias:
        p["bias"] = _uniform(gen, (fan_out,), bound)
    return p


def init_dit_params(seed: int, cfg: DiTConfig, device="cuda") -> Params:
    """Random parameters with the shapes of rap_tpu's init_dit_params, made
    on the host from ``seed`` and moved to ``device``."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    D, H, dh, C = cfg.embed_dim, cfg.num_heads, cfg.head_dim, cfg.time_embed_channels

    def adaln():
        return {
            "time_mlp1": _linear_init(gen, C, D),
            "time_mlp2": _linear_init(gen, D, D),
            "ada_linear": _linear_init(gen, D, 2 * D),
        }

    layers = []
    for _ in range(cfg.num_layers):
        lp = {
            "self_prenorm": adaln(),
            "self_qkv": _linear_init(gen, D, 3 * D, bias=False),
            "self_out": _linear_init(gen, D, D),
            "global_prenorm": adaln(),
            "global_qkv": _linear_init(gen, D, 3 * D, bias=False),
            "global_out": _linear_init(gen, D, D),
            "ff_norm": {"scale": torch.ones(D), "bias": torch.zeros(D)},
            "ff_in": _linear_init(gen, D, 8 * D),
            "ff_out": _linear_init(gen, 4 * D, D),
        }
        for name in ("self_q_gamma", "self_k_gamma", "global_q_gamma",
                     "global_k_gamma"):
            lp[name] = torch.ones(H, dh)
        layers.append(lp)
    params = {
        "anchor_emb": torch.randn((2, D), generator=gen),
        "emb_proj": _linear_init(gen, cfg.embed_input_dim, D),
        "layers": layers,
        "final_mlp": {
            "fc1": _linear_init(gen, D, D),
            "fc2": _linear_init(gen, D, D // 2),
            "fc3": _linear_init(gen, D // 2, cfg.out_dim, bias=False),
        },
    }
    return to_device(attach_bounds(params), device, cfg.compute_dtype)


def to_device(params: Params, device, compute_dtype: torch.dtype) -> Params:
    """Move parameters to ``device``: the kernels' matrices in the compute
    dtype, everything else (embedding, AdaLN MLPs, gains, LN, head) fp32."""
    device = torch.device(device)

    def move(tree, path=()):
        if isinstance(tree, dict):
            return {k: move(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [move(v, path) for v in tree]
        if not isinstance(tree, torch.Tensor):
            return tree  # host-side scalars (the guard bounds)
        dt = compute_dtype if path[-2:] in KERNEL_WEIGHTS else torch.float32
        return tree.to(device=device, dtype=dt).contiguous()

    return move(params)


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def _linear(p, x):
    y = x @ p["kernel"].to(x.dtype)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def _adaln_mlp(p, t_emb_sin):
    """Timestep MLP of AdaLN (dit.py:127-135): (G, C) -> (G, 2D), fp32."""
    e = F.silu(_linear(p["time_mlp1"], t_emb_sin.float()))
    e = F.silu(_linear(p["time_mlp2"], e))
    return _linear(p["ada_linear"], e)


def _attention_block(lp, prefix, x, t_emb, cfg: DiTConfig, S: int, P: int,
                     is_global: bool):
    """x + AdaLN-prenorm attention sub-block (the fused branch, dit.py:183-226)."""
    G, N, D = x.shape
    H, dh = cfg.num_heads, cfg.head_dim
    if cfg.use_kernels:
        qkv, attend, out = (fused_proj.adaln_qkv,
                            flash_attention.flash_attention_headmajor,
                            fused_proj.attn_out)
    else:
        qkv, attend, out = (fused_proj.adaln_qkv_plain,
                            flash_attention.flash_attention_headmajor_plain,
                            fused_proj.out_plain)
    ada = _adaln_mlp(lp[f"{prefix}_prenorm"], t_emb)  # (G, 2D)
    qh5, kh5, vah5 = qkv(
        x, ada, lp[f"{prefix}_qkv"]["kernel"], lp[f"{prefix}_q_gamma"],
        lp[f"{prefix}_k_gamma"], P=P, is_global=is_global,
    )
    seq = P * N if is_global else N
    B = S if is_global else G
    out_hm = attend(
        qh5.reshape(B * H, seq, dh), kh5.reshape(B * H, seq, dh),
        vah5.reshape(B * H, seq, dh + 1), lp[f"{prefix}_bound2"],
    )
    return out(
        out_hm.reshape(qh5.shape), x, lp[f"{prefix}_out"]["kernel"],
        lp[f"{prefix}_out"]["bias"], P=P, is_global=is_global,
    )


def _geglu_ff(lp, x, cfg: DiTConfig):
    ff = fused_ff.geglu_ff if cfg.use_kernels else fused_ff.ff_plain
    return ff(
        x, lp["ff_norm"]["scale"], lp["ff_norm"]["bias"], lp["ff_in"]["kernel"],
        lp["ff_in"]["bias"], lp["ff_out"]["kernel"], lp["ff_out"]["bias"],
    )


def dit_forward(
    params: Params,
    cfg: DiTConfig,
    x: torch.Tensor,          # (G, N, 3) noise coords at timestep t
    timesteps: torch.Tensor,  # (S,) per-sample t in [0, 1]
    batch: PartBatch,
    parts_per_sample: int,
) -> torch.Tensor:
    """Predict the velocity field: (G, N, out_dim) fp32.

    Requires the regular layout (G == S * P) and a batch without padding.
    """
    G, N, _ = x.shape
    S, P = timesteps.shape[0], parts_per_sample
    if G != S * P:
        raise ValueError(f"regular layout required: G={G} != S*P={S * P}")
    if not batch.no_padding:
        raise NotImplementedError(
            "padded batches take the masked branch (rap_tpu/models/dit.py:"
            "228-268), which is not ported yet"
        )
    if not cfg.qk_norm or cfg.softcap != 0.0:
        raise NotImplementedError("the port's fused branch needs qk_norm and no softcap")
    if cfg.in_dim > 0:
        raise NotImplementedError("latent encoder features are not ported yet")
    dtype = cfg.compute_dtype

    # ---- encoding (fp32, then cast) --------------------------------------
    feats = [
        nerf_positional_encoding(batch.points, cfg.multires),
        nerf_positional_encoding(x, cfg.multires),
    ]
    if cfg.scale_emb_on:
        scales_pt = batch.per_sample_to_point(batch.scale)[..., None]  # (G,N,1)
        feats.append(nerf_positional_encoding(scales_pt, cfg.multires))
    if cfg.local_feat_concat_on:
        feats.append(batch.local_feats.float())
    h = _linear(params["emb_proj"], torch.cat(feats, dim=-1))        # (G,N,D)
    anchor_vec = params["anchor_emb"][batch.anchor_part.long()]      # (G,D)
    h = (h + anchor_vec[:, None, :]).to(dtype)

    # ---- per-part timestep sinusoid (shared by every AdaLN) --------------
    t_emb = sinusoidal_timestep_embedding(
        batch.per_sample_to_part(timesteps), cfg.time_embed_channels
    )

    for lp in params["layers"]:
        h = _attention_block(lp, "self", h, t_emb, cfg, S, P, False)
        h = _attention_block(lp, "global", h, t_emb, cfg, S, P, True)
        h = _geglu_ff(lp, h, cfg)

    # ---- fp32 head ----------------------------------------------------------
    out = F.silu(_linear(params["final_mlp"]["fc1"], h.float()))
    out = F.silu(_linear(params["final_mlp"]["fc2"], out))
    return _linear(params["final_mlp"]["fc3"], out)
