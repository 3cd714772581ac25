"""Plain PyTorch reference of the registration DiT (PointCloudDiT,
rap_tpu/models/dit.py:313-409 and its embeddings), written apart from the
program: it imports nothing of ``rap_tpu_torch``, ``rap_tpu`` or JAX.

Per layer: AdaLN part attention, AdaLN global attention, LayerNorm + GEGLU
feed-forward, each with its residual; qk RMS-norm with gains x sqrt(dh);
softmax over the valid keys at scale 1/sqrt(dh). Everything is float32 with
TF32 off, attention in blocks of queries so that it fits (under autograd
each block is recomputed in the backward), a padded batch's attention over
each sequence's valid tokens alone.

``Precision`` says where values are rounded. ``FP32`` rounds nowhere. The
control path ``FP8`` is float8 computation as it is done, the step below
bf16 that a faster path would take: the residual stream and its gradient
kept in bf16 (as the program's bf16 configuration keeps them), every
product's operands (the linear layers' inputs and weights, attention's q,
k, v and probabilities) in float8 e4m3 and, under autograd, the gradient
entering each product in float8 e5m2, one scale per tensor. ``BF16``
rounds all of them to bf16, the program's own precision, for tests.

Parameters are the benchmark's tensors in the port's layout: a dict with
``layers`` a list of per-layer dicts (``self_qkv``/``global_qkv`` kernels
(D, 3D), ``*_out`` (D, D) + bias, ``*_prenorm`` AdaLN MLPs, ``ff_in`` (D,
2FH) = (hidden | gate), ``ff_out`` (FH, D), ``ff_norm``, the four gains (H,
dh)), ``emb_proj``, ``anchor_emb`` (2, D) and ``final_mlp``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

ATTN_BLOCK = 2048  # query rows per block of the attention


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to ``dtype`` and back to float32; float8 with one scale per
    tensor (its largest magnitude to the format's largest value)."""
    if dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        s = torch.finfo(dtype).max / x.detach().abs().amax().clamp_min(1e-30)
        return (x.detach() * s).to(dtype).float() / s
    return x.detach().to(dtype).float()


class _Stored(torch.autograd.Function):
    """The stream stored in a lower type: rounded forward, its gradient
    rounded to the same type backward."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return _round(x, dtype)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.dtype), None


class _Product(torch.autograd.Function):
    """a @ b of rounded operands whose backward rounds the incoming gradient
    before its two products; b may be broadcast over a's leading axes."""

    @staticmethod
    def forward(ctx, a, b, dtype):
        ctx.save_for_backward(a, b)
        ctx.dtype = dtype
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _round(g, ctx.dtype)
        gb = a.transpose(-1, -2) @ g
        while gb.dim() > b.dim():
            gb = gb.sum(0)
        return g @ b.transpose(-1, -2), gb, None


@dataclasses.dataclass(frozen=True)
class Precision:
    stream: torch.dtype | None    # the residual stream's storage type
    operand: torch.dtype | None   # what product operands are rounded to
    gradient: torch.dtype | None = None  # what a product's incoming gradient is rounded to

    def store(self, x: torch.Tensor) -> torch.Tensor:
        if self.stream is None:
            return x
        return _Stored.apply(x, self.stream) if x.requires_grad else _round(x, self.stream)

    def op(self, x: torch.Tensor) -> torch.Tensor:
        if self.operand is None:
            return x
        r = _round(x, self.operand)
        # the rounded value forward, the gradient passed straight through
        return r if not x.requires_grad else x + (r - x).detach()

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.gradient is None or not (a.requires_grad or b.requires_grad):
            return a @ b
        return _Product.apply(a, b, self.gradient)


FP32 = Precision(None, None)
BF16 = Precision(torch.bfloat16, torch.bfloat16, torch.bfloat16)
# float8 training as it is done: e4m3 forward operands, e5m2 gradients
FP8 = Precision(torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2)


@contextlib.contextmanager
def exact_fp32():
    """Full float32 products on the card (no TF32) inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def nerf_pe(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(m-1) x), cos(2^(m-1) x)]."""
    x = x.float()
    out = [x]
    for i in range(num_freqs):
        out += [torch.sin(x * 2.0 ** i), torch.cos(x * 2.0 ** i)]
    return torch.cat(out, -1)


def timestep_embedding(t: torch.Tensor, channels: int, max_period: float = 10000.0):
    """Cos-first sinusoid of t (B,) -> (B, channels)."""
    half = channels // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    ang = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], -1)


def _lin(p: dict, x: torch.Tensor, prec: Precision = FP32) -> torch.Tensor:
    y = prec.mm(prec.op(x), prec.op(p["kernel"].float()))
    return y + p["bias"].float() if "bias" in p else y


def _layer_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(((x - mu) ** 2).mean(-1, keepdim=True) + eps)


def _rms(x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-12) * gain.float() \
        * math.sqrt(x.shape[-1])


def _blocks(qh, kh, vh, prec: Precision) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v of (B, H, T, d) tensors in blocks of query
    rows; under autograd each block is recomputed in the backward instead of
    keeping its probabilities."""
    scale = 1.0 / math.sqrt(qh.shape[-1])
    kt = kh.transpose(-1, -2)

    def block(qb, kt, vh):
        return prec.mm(prec.op(torch.softmax(prec.mm(qb * scale, kt), -1)), vh)

    outs = []
    for lo in range(0, qh.shape[2], ATTN_BLOCK):
        qb = qh[:, :, lo:lo + ATTN_BLOCK]
        outs.append(checkpoint(block, qb, kt, vh, use_reentrant=False)
                    if torch.is_grad_enabled() else block(qb, kt, vh))
    return torch.cat(outs, 2)


def attention(q, k, v, mask, prec: Precision = FP32) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over the valid keys: q, k, v (B, T, H, d),
    mask (B, T) bool or None. With a mask each sequence's valid tokens are
    gathered and attend among themselves; the other rows are 0."""
    q, k, v = (prec.op(a) for a in (q, k, v))
    if mask is None:
        qh, kh, vh = (a.permute(0, 2, 1, 3).contiguous() for a in (q, k, v))
        return _blocks(qh, kh, vh, prec).permute(0, 2, 1, 3)
    out = torch.zeros_like(q)
    for b in range(q.shape[0]):
        idx = mask[b].nonzero().squeeze(1)
        if idx.numel():
            qh, kh, vh = (a[b, idx].permute(1, 0, 2)[None].contiguous() for a in (q, k, v))
            out = out.index_put((torch.full_like(idx, b), idx),
                                _blocks(qh, kh, vh, prec)[0].permute(1, 0, 2))
    return out


def _attention_block(lp: dict, prefix: str, h, t_emb, mask, S: int, P: int, is_global: bool,
                     prec: Precision):
    G, N, D = h.shape
    H, dh = lp[f"{prefix}_q_gamma"].shape
    ada = lp[f"{prefix}_prenorm"]
    e = F.silu(_lin(ada["time_mlp1"], t_emb))
    e = F.silu(_lin(ada["time_mlp2"], e))
    scale, shift = _lin(ada["ada_linear"], e).chunk(2, -1)
    x = _layer_norm(h) * (1.0 + scale[:, None]) + shift[:, None]
    q, k, v = _lin(lp[f"{prefix}_qkv"], x, prec).reshape(G, N, 3, H, dh).unbind(2)
    q, k = _rms(q, lp[f"{prefix}_q_gamma"]), _rms(k, lp[f"{prefix}_k_gamma"])
    m = mask
    if is_global:
        q, k, v = (a.reshape(S, P * N, H, dh) for a in (q, k, v))
        m = None if mask is None else mask.reshape(S, P * N)
    o = attention(q, k, v, m, prec).reshape(G, N, D)
    return prec.store(h + _lin(lp[f"{prefix}_out"], o, prec))


def _feed_forward(lp: dict, h, prec: Precision):
    fh = lp["ff_out"]["kernel"].shape[0]
    x = _layer_norm(h) * lp["ff_norm"]["scale"].float() + lp["ff_norm"]["bias"].float()
    proj = _lin(lp["ff_in"], x, prec)
    act = proj[..., :fh] * F.gelu(proj[..., fh:], approximate="none")
    return prec.store(h + _lin(lp["ff_out"], act, prec))


def forward(params: dict, model: dict, x: torch.Tensor, t: torch.Tensor, batch: dict,
            prec: Precision = FP32) -> torch.Tensor:
    """Velocity (G, N, 3) float32 at noisy coordinates ``x`` (G, N, 3) and
    per-sample times ``t`` (S,). ``batch``: points (G, N, 3), local_feats
    (G, N, F), point_mask (G, N) bool, anchor_part (G,) bool, scale (S,),
    parts_per_sample P; a batch whose mask is all true attends without one."""
    points, mask = batch["points"].float(), batch["point_mask"]
    G, N, _ = points.shape
    P = batch["parts_per_sample"]
    S = G // P
    dense = bool(mask.all())
    m = model["multires"]
    feats = [nerf_pe(points, m), nerf_pe(x, m)]
    if model.get("scale_emb_on", True):
        feats.append(nerf_pe(batch["scale"].float().repeat_interleave(P)[:, None, None]
                             .expand(G, N, 1), m))
    feats.append(batch["local_feats"].float())
    h = _lin(params["emb_proj"], torch.cat(feats, -1))
    h = prec.store(h + params["anchor_emb"].float()[batch["anchor_part"].long()][:, None])
    t_emb = timestep_embedding(t.float().repeat_interleave(P), model["time_embed_channels"])
    key_mask = None if dense else mask
    for lp in params["layers"]:
        h = _attention_block(lp, "self", h, t_emb, key_mask, S, P, False, prec)
        h = _attention_block(lp, "global", h, t_emb, key_mask, S, P, True, prec)
        h = _feed_forward(lp, h, prec)
    fm = params["final_mlp"]
    out = F.silu(_lin(fm["fc1"], h))
    out = F.silu(_lin(fm["fc2"], out))
    return _lin(fm["fc3"], out)
