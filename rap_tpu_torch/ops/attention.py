"""Batched masked multi-head attention (counterpart of rap_tpu/ops/attention.py).

One primitive for the DiT's unfused branch, ``batched_attention(q, k, v,
kv_mask)`` on (B, T, H, d) tensors with an optional (B, Tk) key mask: part
attention is B = S·P sequences of N points, global attention B = S sequences
of P·N. It dispatches as rap_tpu does on its accelerator (:122-142): with
``impl="auto"``, Tk >= 1024 takes the flash kernels (ops/flash_attention.py:
CUDA kernels on the card, their plain twins on CPU tensors); any shorter
call takes dense attention, or chunked attention where the dense logits
would exceed 2**28 entries. rap_tpu computes those two in XLA outside any
Pallas kernel, so here they are plain PyTorch.

Numerics as the reference: logits scaled by 1/sqrt(d), optional tanh softcap
(on the flash route, the kernels' softcap variants), fp32 softmax, p rounded to v's dtype before the PV product. Fully masked
query rows return zeros.
"""

from __future__ import annotations

import math

import torch

from .flash_attention import NEG_INF, flash_attention

_DENSE_LOGITS = 2**28


def _logits(q, k, scale, softcap):
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    return s


def _dense_attention(q, k, v, kv_mask, scale, softcap):
    """(B, Tq, H, d) in v's dtype; kv_mask (B, Tk) bool (:38)."""
    valid = kv_mask[:, None, None, :]
    s = torch.where(valid, _logits(q, k, scale, softcap), NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m) * valid
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def _chunked_attention(q, k, v, kv_mask, scale, softcap, chunk: int):
    """Online softmax over key chunks of ``chunk`` (:58): O(B·Tq·chunk) live
    logits; keys padded to a chunk multiple and masked."""
    B, Tq, H, d = q.shape
    Tk = k.shape[1]
    pad = (-Tk) % chunk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_mask = torch.nn.functional.pad(kv_mask, (0, pad))
    m_run = torch.full((B, H, Tq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l_run = torch.zeros((B, H, Tq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Tq, H, d), dtype=torch.float32, device=q.device)
    for c in range(0, k.shape[1], chunk):
        valid = kv_mask[:, None, None, c:c + chunk]
        s = torch.where(valid, _logits(q, k[:, c:c + chunk], scale, softcap), NEG_INF)
        m_new = torch.maximum(m_run, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new) * valid
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + p.sum(-1, keepdim=True)
        pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                          v[:, c:c + chunk].float())
        acc = acc * corr.transpose(1, 2) + pv
        m_run = m_new
    return (acc / l_run.transpose(1, 2).clamp_min(1e-30)).to(v.dtype)


def batched_attention(q, k, v, kv_mask=None, impl: str = "auto", softcap: float = 0.0,
                      scale: float | None = None, chunk: int = 1024,
                      logit_bound: float | None = None, kernels: bool = True):
    """Masked MHA (:103): (B, Tq, H, d) in v's dtype. ``kv_mask`` None
    declares that every key is valid (the flash route's no-padding path,
    which takes ``logit_bound``, a host bound on max|q·k|). ``impl``: auto,
    dense, chunked or pallas (the flash kernels). ``kernels=False`` runs the
    flash route through its plain twins on any device."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    B, Tq, H, _ = q.shape
    Tk = k.shape[1]
    if impl == "auto":
        if Tk >= 1024:
            impl = "pallas"
        else:
            impl = "dense" if B * H * Tq * Tk <= _DENSE_LOGITS else "chunked"
    if impl == "pallas":
        return flash_attention(q, k, v, kv_mask, scale=scale, softcap=softcap,
                               logit_bound=logit_bound, kernels=kernels)
    if kv_mask is None:
        kv_mask = torch.ones((B, Tk), dtype=torch.bool, device=q.device)
    kv_mask = kv_mask.bool()
    if impl == "dense":
        return _dense_attention(q, k, v, kv_mask, scale, softcap)
    if impl == "chunked":
        return _chunked_attention(q, k, v, kv_mask, scale, softcap, chunk)
    raise ValueError(f"Unknown attention impl: {impl}")
