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

The backward is csrc/attention_bwd.cu (TPU ``_flash_bwd_fused_kernel`` :506,
the single-pass backward that ``_bwd_impl`` :639 takes while its fp32 dQ
partials slab stays within 2 GiB); ``flash_bwd_plain`` is its twin. It reads
lse2 from either forward variant. ``flash_attention_headmajor`` is a
``torch.autograd.Function``: the gradient of the bound is 0 and the ones
column of va gets a zero cotangent (:321-323). Where the JAX dispatch would
take the split backward (``_flash_bwd_dkv_kernel`` :426 and
``_flash_bwd_dq_kernel`` :471, not ported) the backward raises.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import _build
from ._common import LAUNCHES, check_input, on_cpu, require, stream_of

SAFE_BOUND2 = 60.0
NEG_INF = -1e30
LSE_EMPTY = 1e30
_KEY_BLOCK = 64    # csrc/attention.cu BK: keys are never padded
_QUERY_BLOCK = 64  # csrc/attention.cu BQ
_PLAIN_LOGITS = 2**28  # fp32 logits per chunk of the plain versions (1 GiB)
LN2 = math.log(2.0)
_BWD_KEY_BLOCK = 128  # csrc/attention_bwd.cu BK
_FUSED_DQ_PARTIALS_CAP = 2 * 2**30  # pallas_attention.py:636


def _chunks(BH: int, Tq: int, Tk: int, budget: int = _PLAIN_LOGITS):
    step = max(1, budget // (Tq * Tk))
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


# --------------------------------------------------------------------------
# backward
# --------------------------------------------------------------------------

def fused_backward_slab_bytes(BH: int, Tq: int, Tk: int, d: int) -> int:
    """Bytes of the fp32 dQ partials slab (BH, nk, Tq, d) that the JAX
    backward would write (pallas_attention.py:639-652): its kv block is the
    largest of 1024/512/256/128 that divides Tk (``_full_block_sizes``)."""
    bk = next((c for c in (1024, 512, 256, 128) if Tk % c == 0), Tk)
    return BH * (Tk // bk) * Tq * d * 4


def check_fused_backward(BH: int, Tq: int, Tk: int, d: int) -> None:
    """Raise where the JAX dispatch leaves the fused backward for the split
    one, which the port does not have yet."""
    slab = fused_backward_slab_bytes(BH, Tq, Tk, d)
    if slab > _FUSED_DQ_PARTIALS_CAP:
        raise NotImplementedError(
            f"attention backward at BH={BH}, T={Tq}: the dQ partials slab "
            f"({slab / 2**30:.1f} GiB) exceeds 2 GiB, where rap_tpu takes the "
            "split backward (_flash_bwd_dkv_kernel, _flash_bwd_dq_kernel): "
            "ROADMAP section B rows 7-8, not ported yet"
        )


def augment_do(dout, out):
    """[dO | -delta] in dO's dtype, delta = rowsum(dO·O) in fp32
    (``_augment_do``, pallas_attention.py:566)."""
    delta = (dout.float() * out.float()).sum(-1, keepdim=True)
    return torch.cat([dout, (-delta).to(dout.dtype)], dim=-1)


def flash_bwd_plain(qh, kh, vah, out, lse2, dout):
    """Plain version of the backward kernel: (dq, dk, dv), each (BH, T, d) in
    q's dtype. Recomputes p from lse2; the -delta column, p and ds are
    rounded to the storage dtype where ``_recompute_p_ds`` (:369) rounds
    them; ln2 is applied per output element."""
    BH, Tq, d = qh.shape
    dt = qh.dtype
    doa = augment_do(dout.to(dt), out)
    dq, dk, dv = (torch.empty_like(a) for a in (qh, kh, kh))
    for sl in _chunks(BH, Tq, kh.shape[1], _PLAIN_LOGITS // 4):
        q, k = qh[sl].float(), kh[sl].float()
        p = torch.exp2(q @ k.transpose(-1, -2) - lse2[sl, :, None])
        dpd = doa[sl].float() @ vah[sl].to(dt).float().transpose(-1, -2)
        ds = (p * dpd).to(dt).float()
        p = p.to(dt).float()
        dv[sl] = (p.transpose(-1, -2) @ doa[sl, :, :d].float()).to(dt)
        dk[sl] = ((ds.transpose(-1, -2) @ q) * LN2).to(dt)
        dq[sl] = ((ds @ k) * LN2).to(dt)
    return dq, dk, dv


def flash_bwd_kernel(qh, kh, vah, out, lse2, dout):
    """Launch csrc/attention_bwd.cu on CUDA tensors: (dq, dk, dv)."""
    _check_attention_inputs(qh, kh, vah)
    BH, Tq, d = qh.shape
    Tk = kh.shape[1]
    require(Tk % _BWD_KEY_BLOCK == 0,
            f"attention backward kernel takes Tk % {_BWD_KEY_BLOCK} == 0, got {Tk}")
    check_input("out", out, torch.bfloat16, (BH, Tq, d))
    check_input("lse2", lse2, torch.float32, (BH, Tq))
    doa = augment_do(dout.to(qh.dtype), out).contiguous()
    dq_acc = torch.zeros((BH, Tq, d), dtype=torch.float32, device=qh.device)
    dk = torch.empty_like(kh)
    dv = torch.empty_like(kh)
    err = _build.load().lib.rtt_flash_bwd(
        qh.data_ptr(), kh.data_ptr(), vah.data_ptr(), doa.data_ptr(),
        lse2.data_ptr(), dq_acc.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        BH, Tq, Tk, stream_of(qh),
    )
    _build.check(err, "flash_bwd kernel")
    LAUNCHES["flash_bwd"] += 1
    return (dq_acc * LN2).to(qh.dtype), dk, dv


def flash_bwd(qh, kh, vah, out, lse2, dout):
    if on_cpu(qh, kh, vah, out, lse2, dout):
        return flash_bwd_plain(qh, kh, vah, out, lse2, dout)
    return flash_bwd_kernel(qh, kh, vah, out, lse2, dout)


class _FlashAttention(torch.autograd.Function):
    """Counterpart of ``_flash_hm_full_va`` (pallas_attention.py:296-326)."""

    @staticmethod
    def forward(ctx, qh, kh, vah, bound2: float, kernels: bool):
        if bound2 <= SAFE_BOUND2:
            fwd = flash_fixed if kernels else flash_fixed_plain
            out, lse = fwd(qh, kh, vah, bound2)
        else:
            fwd = flash_online if kernels else flash_online_plain
            out, lse = fwd(qh, kh, vah)
        ctx.save_for_backward(qh, kh, vah, out, lse)
        ctx.kernels = kernels
        return out

    @staticmethod
    def backward(ctx, dout):
        qh, kh, vah, out, lse = ctx.saved_tensors
        check_fused_backward(qh.shape[0], qh.shape[1], kh.shape[1], qh.shape[2])
        bwd = flash_bwd if ctx.kernels else flash_bwd_plain
        dq, dk, dv = bwd(qh, kh, vah, out, lse, dout.contiguous())
        return dq, dk, F.pad(dv, (0, 1)), None, None


def flash_attention_headmajor(qh, kh, vah, bound2: float, kernels: bool = True):
    """No-padding attention on (BH, T, d) pre-scaled q, k and ones-augmented
    va (BH, T, d+1). ``bound2`` bounds |q·k| (base 2); the caller computes it
    on the host from the qk-norm gains. Returns out (BH, T, d).

    Differentiable. ``kernels=False`` takes the plain versions forward and
    backward on any device; CPU tensors take them either way."""
    return _FlashAttention.apply(qh, kh, vah, float(bound2), kernels)
