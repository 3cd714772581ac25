"""Flash attention forward on head-major, pre-scaled tensors.

Counterpart of rap_tpu/ops/pallas_attention.py's no-padding entry point
``flash_attention_headmajor`` (:338) and its guard ``_fwd_full_or_online``
(:272): q arrives pre-scaled into base 2 (q·k is the base-2 logit), va is v
with a ones column. The fixed-bound variant computes p = exp2(s - bound)
with no running max; it is exact while every logit lies within the fp32
exp2 range of the bound, which the guard proves from the qk-norm gains:
bound2 <= SAFE_BOUND2 (:269). Above it the online-softmax variant runs.

Both variants are csrc/attention.cu (TPU ``_flash_fwd_full_kernel`` :188 and
``_flash_fwd_kernel`` :91). The plain versions compute the same softmax on
the whole row at once, chunked over (batch*head) rows to bound memory.
"""

from __future__ import annotations

import torch

from . import _build
from ._common import LAUNCHES, check_input, on_cpu, require, stream_of

SAFE_BOUND2 = 60.0
NEG_INF = -1e30
LSE_EMPTY = 1e30
_KEY_BLOCK = 64    # csrc/attention.cu BK: keys are never padded
_QUERY_BLOCK = 64  # csrc/attention.cu BQ
_PLAIN_LOGITS = 2**28  # fp32 logits per chunk of the plain versions (1 GiB)


def _chunks(BH: int, Tq: int, Tk: int):
    step = max(1, _PLAIN_LOGITS // (Tq * Tk))
    for i in range(0, BH, step):
        yield slice(i, min(BH, i + step))


def flash_fixed_plain(qh, kh, vah, bound: float):
    """Plain fixed-bound attention: (out (BH,Tq,d), lse2 (BH,Tq) fp32)."""
    BH, Tq, d = qh.shape
    out = torch.empty_like(qh)
    lse = torch.empty((BH, Tq), dtype=torch.float32, device=qh.device)
    for sl in _chunks(BH, Tq, kh.shape[1]):
        s = qh[sl].float() @ kh[sl].float().transpose(-1, -2)
        p = torch.exp2(s - bound).to(qh.dtype).float()
        pv = p @ vah[sl].float()  # the ones column gives the row sum l
        l = pv[..., d:].clamp_min(1e-30)
        out[sl] = (pv[..., :d] / l).to(qh.dtype)
        lse[sl] = bound + torch.log2(l[..., 0])
    return out, lse


def flash_online_plain(qh, kh, vah, mask=None, heads: int = 1):
    """Plain masked softmax attention: (out, lse2). mask: (BH/heads, Tk)
    bool or None (every key valid); fully masked rows give 0 and LSE_EMPTY."""
    BH, Tq, d = qh.shape
    out = torch.empty_like(qh)
    lse = torch.empty((BH, Tq), dtype=torch.float32, device=qh.device)
    for sl in _chunks(BH, Tq, kh.shape[1]):
        s = qh[sl].float() @ kh[sl].float().transpose(-1, -2)
        if mask is not None:
            valid = mask.bool().repeat_interleave(heads, dim=0)[sl][:, None, :]
            s = torch.where(valid, s, NEG_INF)
        m = s.amax(-1, keepdim=True)
        p = torch.exp2(s - m)
        if mask is not None:
            p = p * valid
        p = p.to(qh.dtype).float()
        l = p.sum(-1, keepdim=True)
        o = (p @ vah[sl, :, :d].float()) / l.clamp_min(1e-30)
        out[sl] = torch.where(l > 0, o, 0.0).to(qh.dtype)
        lse[sl] = torch.where(
            l > 0, m + torch.log2(l.clamp_min(1e-30)), LSE_EMPTY
        )[..., 0]
    return out, lse


def _check_attention_inputs(qh, kh, vah):
    BH, Tq, d = qh.shape
    Tk = kh.shape[1]
    require(d == 64, f"attention kernel takes head width 64, got {d}")
    require(Tq % _QUERY_BLOCK == 0 and Tk % _KEY_BLOCK == 0,
            f"attention kernel takes Tq, Tk multiples of 64 (keys are never "
            f"padded); got Tq={Tq}, Tk={Tk}")
    check_input("qh", qh, torch.bfloat16, (BH, Tq, d))
    check_input("kh", kh, torch.bfloat16, (BH, Tk, d))
    check_input("vah", vah, torch.bfloat16, (BH, Tk, d + 1))


def flash_fixed_kernel(qh, kh, vah, bound: float):
    """Launch the fixed-bound variant of csrc/attention.cu."""
    _check_attention_inputs(qh, kh, vah)
    BH, Tq, d = qh.shape
    out = torch.empty_like(qh)
    lse = torch.empty((BH, Tq), dtype=torch.float32, device=qh.device)
    err = _build.load().lib.rtt_flash_fixed(
        qh.data_ptr(), kh.data_ptr(), vah.data_ptr(), float(bound),
        out.data_ptr(), lse.data_ptr(), BH, Tq, kh.shape[1], stream_of(qh),
    )
    _build.check(err, "flash_fixed kernel")
    LAUNCHES["flash_fixed"] += 1
    return out, lse


def flash_online_kernel(qh, kh, vah, mask=None, heads: int = 1):
    """Launch the online-softmax variant of csrc/attention.cu."""
    _check_attention_inputs(qh, kh, vah)
    BH, Tq, d = qh.shape
    Tk = kh.shape[1]
    mask_ptr = None
    if mask is not None:
        require(BH % heads == 0, f"BH={BH} is not a multiple of heads={heads}")
        check_input("mask", mask, torch.int32, (BH // heads, Tk))
        require(mask.device == qh.device, "mask on another device")
        mask_ptr = mask.data_ptr()
    out = torch.empty_like(qh)
    lse = torch.empty((BH, Tq), dtype=torch.float32, device=qh.device)
    err = _build.load().lib.rtt_flash_online(
        qh.data_ptr(), kh.data_ptr(), vah.data_ptr(), mask_ptr,
        out.data_ptr(), lse.data_ptr(), BH, Tq, Tk, heads, stream_of(qh),
    )
    _build.check(err, "flash_online kernel")
    LAUNCHES["flash_online"] += 1
    return out, lse


def flash_fixed(qh, kh, vah, bound: float):
    if on_cpu(qh, kh, vah):
        return flash_fixed_plain(qh, kh, vah, bound)
    return flash_fixed_kernel(qh, kh, vah, bound)


def flash_online(qh, kh, vah, mask=None, heads: int = 1):
    """mask: (BH/heads, Tk), nonzero = valid key; None = every key valid."""
    if on_cpu(qh, kh, vah):
        return flash_online_plain(qh, kh, vah, mask, heads)
    if mask is not None:
        mask = mask.to(torch.int32).contiguous()
    return flash_online_kernel(qh, kh, vah, mask, heads)


def flash_attention_headmajor(qh, kh, vah, bound2: float):
    """No-padding attention on (BH, T, d) pre-scaled q, k and ones-augmented
    va (BH, T, d+1). ``bound2`` bounds |q·k| (base 2); the caller computes it
    once on the host from the qk-norm gains. Returns out (BH, T, d)."""
    if float(bound2) <= SAFE_BOUND2:
        return flash_fixed(qh, kh, vah, float(bound2))[0]
    return flash_online(qh, kh, vah)[0]


def flash_attention_headmajor_plain(qh, kh, vah, bound2: float):
    """``flash_attention_headmajor`` through the plain versions on any device."""
    if float(bound2) <= SAFE_BOUND2:
        return flash_fixed_plain(qh, kh, vah, float(bound2))[0]
    return flash_online_plain(qh, kh, vah)[0]
