"""PointCloudDiT forward (counterpart of rap_tpu/models/dit.py:313-409).

Per layer: AdaLN part attention -> AdaLN global attention -> LayerNorm +
GEGLU feed-forward, each with its residual. ``_attention_block`` has rap_tpu's
two branches, chosen by its guard (dit.py:183-195) as on its accelerator,
except that a padded batch takes the fused branch too:
- the fused branch, for a sequence that is a multiple of 128 and at least
  1024 long (or ``attn_impl="pallas"``), with qk-norm, no softcap and no
  ring mesh: five kernels, proj (AdaLN + QKV + qk-norm), attention, out_proj
  (+ residual) and ff (+ residual). A dense batch takes the fixed-bound or
  the online forward, chosen per layer on the host from the qk-norm gains;
  a padded one the masked online forward on the same head-major operands,
  with the int32 key masks built once a forward (``_key_masks``). proj and
  out_proj work token by token, so the mask does not reach them. rap_tpu
  keeps padded batches out of this branch because its fused attention has
  no mask;
- the unfused branch (dit.py:228-268) for unaligned or (under ``auto``)
  short sequences, a softcap, ``qk_norm=False`` and ring global attention:
  AdaLN, plain linears, per-head RMS qk-norm (with ``qk_norm``) and
  ``ops.attention.batched_attention`` with the point mask (flash kernels for
  sequences of 1024 keys or more, dense or chunked attention below; a
  softcap takes their softcap variants). A dense batch with qk-norm passes
  the exact logit bound of its gains; without qk-norm the flash route
  bounds the logits from the row norms.
Each attention sub-block bumps the counter of its branch, ``dit.fused`` or
``dit.unfused``.
The feed-forward takes its kernel where rap_tpu's ``legal`` rule holds. The
encoding (NeRF PE, anchor embedding, optional latent) runs in fp32 and is
cast to the compute dtype; the per-part timestep sinusoid and the AdaLN MLPs
are fp32; the head is fp32.

Training: the same forward is differentiable (every kernel sits in a
``torch.autograd.Function`` whose backward is a kernel too, or the plain
vjp where the JAX package has none). With ``remat=True`` each layer runs
under ``torch.utils.checkpoint`` (non-reentrant), the counterpart of
``jax.checkpoint`` at dit.py:391-392, so its forward kernels run again in
the backward. Trained parameters are fp32 masters (``master_params``), cast
to the compute dtype inside the differentiated graph; the attention guard
bounds move with the trained gains, so for a dense batch the caller passes
``bounds`` computed from the current gains (``attention_bounds``: one stacked
amax and one host read for all layers) before the forward, and the
recompute sees the same fixed/online choice as the first forward. A padded
batch needs no bound.

FF dropout (training only, dit.py:271-297): with ``dropout`` given, each
layer's feed-forward takes the plain composition with inverted dropout
between the GEGLU activation and ``ff_out`` (the fused FF kernel stays
dropout-free, as in rap_tpu, so rows 5 and 10 do not run). ``dropout``
holds one entry a layer: a keep mask (bool, the activation's shape), or an
int seed from which the layer draws its mask with a fresh generator on the
activation's device. A seed is fixed before the layer runs, so the remat
recompute (``torch.utils.checkpoint`` restores only the default generators'
states, never an explicit one) draws the same mask as the first forward.

Sequence sharding (dit.py:160-268): with ``ring_mesh`` (a
``parallel.mesh.Mesh``) the batch is one rank's shard of an S = 1 sample:
its contiguous share of the parts, so of the P·N global sequence. Part
attention and the feed-forward stay local on the rank's parts, through the
same branches as without a mesh; the global attention takes the unfused
branch and runs ``ops.ring_attention`` over the ranks' shards (its block
product is plain PyTorch, as rap_tpu's is plain XLA). Training takes no
mesh here (rap_tpu's ``training_forward`` passes none).

Parameters are a nested dict like the JAX pytree, except that ``layers`` is
a list of per-layer dicts (the stacked ``layers/*`` arrays split along L).
For serving each layer also carries the host-side guard inputs
``self_bound2`` and ``global_bound2`` (see ``attach_bounds``); training
parameters carry none.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import telemetry
from .._device import resolve_device
from ..core.batch import PartBatch
from ..ops import attention, flash_attention, fused_ff, fused_proj, ring_attention
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
    qk-norm gains (dit.py:214-217): log2(e)*sqrt(dh)*max|gq|*max|gk|."""
    dh = gamma_q.shape[-1]
    return (math.log2(math.e) * math.sqrt(dh)
            * float(gamma_q.abs().max()) * float(gamma_k.abs().max()))


def attention_bounds(params: Params) -> list[tuple[float, float]]:
    """(self, global) guard bound of every layer from the current gains: one
    stacked amax on the gains' device and one host read for all layers."""
    layers = params["layers"]
    gains = [lp[f"{prefix}_{qk}_gamma"] for lp in layers
             for prefix in ("self", "global") for qk in ("q", "k")]
    dh = gains[0].shape[-1]
    with torch.no_grad():
        m = torch.stack([g.float() for g in gains]).abs().amax(dim=(1, 2))
        telemetry.bump("sync.bounds")
        b = (m[0::2] * m[1::2]).cpu().double().tolist()
    scale = math.log2(math.e) * math.sqrt(dh)
    return [(scale * b[2 * i], scale * b[2 * i + 1]) for i in range(len(layers))]


def attach_bounds(params: Params) -> Params:
    """Attach each layer's guard bounds for serving (computed once here)."""
    for lp, (b_self, b_global) in zip(params["layers"], attention_bounds(params)):
        lp["self_bound2"], lp["global_bound2"] = b_self, b_global
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


def init_dit_params(seed: int, cfg: DiTConfig, device="cuda",
                    masters: bool = False) -> Params:
    """Random parameters with the shapes of rap_tpu's init_dit_params, made
    on the host from ``seed`` and moved to ``device``: for serving (kernel
    matrices in the compute dtype, bounds attached) or, with ``masters``,
    as fp32 training masters."""
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
    if masters:
        return master_params(params, device)
    return to_device(attach_bounds(params), device, cfg.compute_dtype)


def master_params(params: Params, device) -> Params:
    """fp32 training masters on ``device``: every tensor copied, nothing cast
    to the compute dtype, and no host-side guard bound (training recomputes
    the bounds from the current gains every step)."""
    device = torch.device(device)

    def move(tree):
        if isinstance(tree, dict):
            return {k: move(v) for k, v in tree.items() if not k.endswith("_bound2")}
        if isinstance(tree, list):
            return [move(v) for v in tree]
        return tree.detach().to(device=device, dtype=torch.float32, copy=True).contiguous()

    return move(params)


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


def _layer_norm(x, scale=None, bias=None, eps: float = 1e-5):
    """LayerNorm with fp32 statistics, returned in x's dtype (dit.py:116)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def _adaln_mlp(p, t_emb_sin):
    """Timestep MLP of AdaLN (dit.py:127-135): (G, C) -> (G, 2D), fp32."""
    e = F.silu(_linear(p["time_mlp1"], t_emb_sin.float()))
    e = F.silu(_linear(p["time_mlp2"], e))
    return _linear(p["ada_linear"], e)


def _adaln(p, x, t_emb_sin):
    """Adaptive LayerNorm (dit.py:136): LN(x) in x's dtype, then
    y * (1 + scale) + shift with the modulation cast to that dtype."""
    scale, shift = _adaln_mlp(p, t_emb_sin).chunk(2, dim=-1)
    y = _layer_norm(x)
    return y * (1.0 + scale[:, None, :]).to(y.dtype) + shift[:, None, :].to(y.dtype)


def _rms_qk(x, gamma):
    """Per-head RMS norm in fp32, back to x's dtype (dit.py:151):
    normalize(x) * gamma * sqrt(dh)."""
    xf = x.float()
    n = xf * torch.rsqrt((xf * xf).sum(-1, keepdim=True) + 1e-12)
    return (n * gamma.float() * math.sqrt(x.shape[-1])).to(x.dtype)


def _fused_ok(cfg: DiTConfig, seq_len: int) -> bool:
    """The guard of the fused branch: rap_tpu's (dit.py:183-195) on its
    accelerator without its ``mask is None``: qk-norm, no softcap,
    128-aligned sequences."""
    D, dh = cfg.embed_dim, cfg.head_dim
    return (cfg.qk_norm and cfg.softcap == 0.0
            and cfg.attn_impl in ("auto", "pallas")
            and (seq_len >= 1024 or cfg.attn_impl == "pallas")
            and seq_len % 128 == 0 and D % 128 == 0 and dh % 8 == 0 and dh < 128)


def _key_masks(cfg: DiTConfig, mask, S: int, P: int, ring: bool):
    """The fused branch's int32 key masks of a padded batch, built once a
    forward (``flash_attention.key_mask``): part attention's (G, N) and
    global attention's (S, P·N), each None where that attention takes the
    unfused branch (the guard refuses its sequence, or ``ring``)."""
    N = mask.shape[1]
    part = flash_attention.key_mask(mask) if _fused_ok(cfg, N) else None
    glob = (flash_attention.key_mask(mask.reshape(S, P * N))
            if not ring and _fused_ok(cfg, P * N) else None)
    return part, glob


def _attention_block(lp, prefix, x, t_emb, mask, key_mask, cfg: DiTConfig, S: int, P: int,
                     is_global: bool, bound2, ring_mesh=None):
    """x + AdaLN-prenorm attention sub-block (dit.py:177-268). ``mask``: the
    point mask (G, N) of a padded batch, None for a dense one; ``key_mask``:
    its int32 key mask for the fused branch (``_key_masks``). ``bound2``:
    the host guard bound of a dense batch, None for a padded one.
    ``ring_mesh``: global attention over the ranks' shards (the module
    docstring)."""
    G, N, D = x.shape
    H, dh = cfg.num_heads, cfg.head_dim
    kernels = cfg.use_kernels
    seq = P * N if is_global else N
    if ring_mesh is None and _fused_ok(cfg, seq):
        telemetry.bump("dit.fused")
        ada = _adaln_mlp(lp[f"{prefix}_prenorm"], t_emb)  # (G, 2D)
        qh5, kh5, vh5 = fused_proj.adaln_qkv(
            x, ada, lp[f"{prefix}_qkv"]["kernel"], lp[f"{prefix}_q_gamma"],
            lp[f"{prefix}_k_gamma"], P=P, is_global=is_global, kernels=kernels,
        )
        B = S if is_global else G
        qh, kh, vh = (a.reshape(B * H, seq, -1) for a in (qh5, kh5, vh5))
        if mask is None:
            out_hm = flash_attention.flash_attention_headmajor(qh, kh, vh, bound2,
                                                               kernels=kernels)
        else:  # the key mask is shared by the H heads of a batch row
            out_hm = flash_attention.masked_attention_headmajor(qh, kh, vh, key_mask, H,
                                                                kernels=kernels)
        return fused_proj.attn_out(
            out_hm.reshape(qh5.shape), x, lp[f"{prefix}_out"]["kernel"],
            lp[f"{prefix}_out"]["bias"], P=P, is_global=is_global, kernels=kernels,
        )

    # the unfused branch (dit.py:228-268): XLA linears and batched_attention
    telemetry.bump("dit.unfused")
    h = _adaln(lp[f"{prefix}_prenorm"], x, t_emb)
    q, k, v = _linear(lp[f"{prefix}_qkv"], h).reshape(G, N, 3, H, dh).unbind(2)
    logit_bound = None
    if cfg.qk_norm:
        q = _rms_qk(q, lp[f"{prefix}_q_gamma"])
        k = _rms_qk(k, lp[f"{prefix}_k_gamma"])
        if mask is None:
            # a dense batch's exact bound on |q.k|, dh max|gq| max|gk| (:236-244)
            logit_bound = bound2 * math.sqrt(dh) / math.log2(math.e)
    kv_mask = mask
    if is_global:  # (S, P*N, H, dh): all parts of a sample form one sequence
        q, k, v = (a.reshape(S, P * N, H, dh) for a in (q, k, v))
        kv_mask = None if mask is None else mask.reshape(S, P * N)
        if ring_mesh is not None:
            if S != 1:
                raise ValueError(f"sequence-sharded global attention needs S == 1, got S={S}")
            if kv_mask is None:
                kv_mask = torch.ones((S, P * N), dtype=torch.bool, device=x.device)
            out = ring_attention.ring_attention(q, k, v, kv_mask, ring_mesh,
                                                softcap=cfg.softcap)
            return x + _linear(lp[f"{prefix}_out"], out.reshape(G, N, D))
    out = attention.batched_attention(
        q, k, v, kv_mask, impl=cfg.attn_impl, softcap=cfg.softcap,
        logit_bound=logit_bound, kernels=kernels,
    )
    return x + _linear(lp[f"{prefix}_out"], out.reshape(G, N, D))


def _geglu_ff(lp, x, cfg: DiTConfig, dropout=None):
    if dropout is not None:
        return dropout_ff(lp, x, cfg.dropout_rate, dropout)
    return fused_ff.geglu_ff(
        x, lp["ff_norm"]["scale"], lp["ff_norm"]["bias"], lp["ff_in"]["kernel"],
        lp["ff_in"]["bias"], lp["ff_out"]["kernel"], lp["ff_out"]["bias"],
        impl=cfg.ff_impl, kernels=cfg.use_kernels,
    )


def keep_mask(shape, rate: float, seed: int, device) -> torch.Tensor:
    """The keep mask of one layer: u < 1 - rate, u uniform from a fresh
    generator on ``device`` seeded with ``seed`` (Philox on the card)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(shape, generator=gen, device=device) < 1.0 - rate


def dropout_ff(lp, x, rate: float, keep):
    """x + FF(LN(x)) with inverted dropout on the GEGLU activation
    (dit.py:281-297): the plain composition, h, proj and act in x's dtype,
    GELU in fp32, act / (1 - rate) where ``keep`` (a bool mask, or an int
    seed for ``keep_mask``) holds, else 0."""
    dt = x.dtype
    fh = lp["ff_out"]["kernel"].shape[0]
    h = _layer_norm(x, lp["ff_norm"]["scale"], lp["ff_norm"]["bias"])
    proj = _linear(lp["ff_in"], h)
    act = proj[..., :fh] * F.gelu(proj[..., fh:].float(), approximate="none").to(dt)
    if isinstance(keep, int):
        keep = keep_mask(act.shape, rate, keep, act.device)
    act = torch.where(keep, act / (1.0 - rate), 0.0).to(dt)
    return x + _linear(lp["ff_out"], act)


@telemetry.spanned("rap.dit.layer")
def _layer(h, lp, t_emb, mask, key_masks, cfg: DiTConfig, S: int, P: int, bounds,
           dropout=None, ring_mesh=None):
    h = _attention_block(lp, "self", h, t_emb, mask, key_masks[0], cfg, S, P, False,
                         bounds[0])
    h = _attention_block(lp, "global", h, t_emb, mask, key_masks[1], cfg, S, P, True,
                         bounds[1], ring_mesh)
    return _geglu_ff(lp, h, cfg, dropout)


@telemetry.spanned("rap.dit")
def dit_forward(
    params: Params,
    cfg: DiTConfig,
    x: torch.Tensor,          # (G, N, 3) noise coords at timestep t
    timesteps: torch.Tensor,  # (S,) per-sample t in [0, 1]
    batch: PartBatch,
    parts_per_sample: int,
    remat: bool = False,
    bounds: list[tuple[float, float]] | None = None,
    return_features: bool = False,
    latent: torch.Tensor | None = None,
    dropout: list | None = None,
    ring_mesh=None,
):
    """Predict the velocity field: (G, N, out_dim) fp32 [, features (G, N, D)
    fp32 with ``return_features``].

    Requires the regular layout (G == S * P). A batch with padding runs with
    its point mask (the fused branch's masked attention where the guard
    admits the sequence, else the unfused branch); a dense one without.
    ``bounds``: (self, global) guard bound per layer of a dense batch; None
    takes the ones attached at load (serving); a padded batch needs none.
    ``remat``: recompute each layer's forward in the backward instead of
    keeping its activations. ``latent``: (G, N, in_dim) encoder features
    when ``cfg.in_dim > 0``; None gives zeros (dit.py:359-365).
    ``dropout``: one keep mask or int seed a layer, at ``cfg.dropout_rate``
    (training; see the module docstring); None runs without dropout.
    ``ring_mesh``: a ``parallel.mesh.Mesh`` over whose ranks the global
    attention of this S = 1 shard runs as ring attention; None: local.
    """
    G, N, _ = x.shape
    S, P = timesteps.shape[0], parts_per_sample
    if G != S * P:
        raise ValueError(f"regular layout required: G={G} != S*P={S * P}")
    dtype = cfg.compute_dtype
    mask = None if batch.no_padding else batch.point_mask

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
    if cfg.in_dim > 0:
        lat = latent if latent is not None else x.new_zeros((G, N, cfg.in_dim))
        feats.append(lat.float())
    h = _linear(params["emb_proj"], torch.cat(feats, dim=-1))        # (G,N,D)
    anchor_vec = params["anchor_emb"][batch.anchor_part.long()]      # (G,D)
    h = (h + anchor_vec[:, None, :]).to(dtype)

    # ---- per-part timestep sinusoid (shared by every AdaLN) --------------
    t_emb = sinusoidal_timestep_embedding(
        batch.per_sample_to_part(timesteps), cfg.time_embed_channels
    )

    key_masks = (None, None)
    if mask is not None:
        key_masks = _key_masks(cfg, mask, S, P, ring_mesh is not None)
        bounds = [(None, None)] * len(params["layers"])
    elif bounds is None:
        bounds = [(lp["self_bound2"], lp["global_bound2"]) for lp in params["layers"]]
    drops = [None] * len(params["layers"]) if dropout is None else dropout
    for lp, b, d in zip(params["layers"], bounds, drops, strict=True):
        if remat and torch.is_grad_enabled():
            h = checkpoint(_layer, h, lp, t_emb, mask, key_masks, cfg, S, P, b, d, ring_mesh,
                           use_reentrant=False)
        else:
            h = _layer(h, lp, t_emb, mask, key_masks, cfg, S, P, b, d, ring_mesh)

    # ---- fp32 head ----------------------------------------------------------
    hf = h.float()
    out = F.silu(_linear(params["final_mlp"]["fc1"], hf))
    out = F.silu(_linear(params["final_mlp"]["fc2"], out))
    out = _linear(params["final_mlp"]["fc3"], out)
    if return_features:
        return out, hf
    return out
