"""Flash attention on pre-scaled tensors, forward and backward.

Counterpart of rap_tpu/ops/pallas_attention.py. Three entry points:

- ``flash_attention_headmajor`` (:338), the no-padding path of the fused DiT
  branch, and its guard ``_fwd_full_or_online`` (:272): q arrives pre-scaled
  into base 2 (q·k is the base-2 logit). The fixed-bound variant computes
  p = exp2(s - bound) with no running max; it is exact while every logit
  lies within the fp32 exp2 range of the bound, which the guard proves from
  the qk-norm gains: bound2 <= SAFE_BOUND2 (:269). Above it the
  online-softmax variant runs.
- ``flash_attention`` (:785), the (B, T, H, d) entry of ``batched_attention``
  with an optional (B, Tk) key mask. Without a mask, and with block-aligned
  lengths, it takes the no-padding path above; otherwise it pre-scales q,
  pads queries and keys to rap_tpu's blocks (padded keys masked) and runs
  the online variant with the key mask (``_flash_hm``, :722-768).
- ``masked_attention_headmajor``, that masked path on head-major operands:
  the fused DiT branch of a padded batch, whose q, k and v arrive
  pre-scaled and head-major from the proj kernel, with the int32 key mask
  (``key_mask``) that the forward builds once for all layers.

Forward kernels: csrc/attention.cu (TPU ``_flash_fwd_full_kernel`` :188 and
``_flash_fwd_kernel`` :91). Backward kernels, dispatched as ``_bwd_impl``
(:639) dispatches: csrc/attention_bwd.cu (TPU ``_flash_bwd_fused_kernel``
:506, with or without a key mask) while the fused kernel's fp32 dQ partials
slab stays within 2 GiB, else csrc/attention_bwd_split.cu (TPU
``_flash_bwd_dkv_kernel`` :426 and ``_flash_bwd_dq_kernel`` :471). The fused
kernel and the dKV pass are one key-block kernel (csrc/attention_bwd_dkv.cuh),
the dQ pass its mirror (csrc/attention_bwd_dq.cuh), all TMA + wgmma, each
with a 128-wide counterpart (csrc/attention_bwd_dkv128.cuh,
csrc/attention_bwd_dq128.cuh). They read V and dO with rows of the
kernel's width and -delta as an fp32 vector (``_neg_delta``), computed once
for both split passes. Each has a plain twin here with the same arithmetic
and cast points (``*_plain``), chunked over (batch*head, query) tiles to
bound memory. The gradient of the bound is 0 (:321-323).
Every kernel is 64 or 128 wide in its heads: the launchers take heads of
8 <= d <= 128, multiples of 8 (the fixed-bound forward d < 128, as
rap_tpu's no-padding path does: a d = 128 head takes the masked path),
zero-padding q, k, V and dO to the kernel's width before a kernel and
dropping the padded columns of out, dq, dk and dv after it
(``kernel_width``, ``head_columns``).

Layout: v, dO and every gradient are (BH, T, d) in the compute dtype, as q
and k are. rap_tpu's kernels take va = [V | 1] with a ones column (its
forward's row sums l come from P·va) and [dO | -delta] (``_augment_do``,
:566); the kernels here make l with the tensor cores from the bf16-rounded
p (csrc/attention.cu) and add -delta to dO·V^T per logit, which gives the
same values.

Softcap c > 0 (the TPU kernels' static ``softcap``): q is pre-scaled by
scale/c instead of scale·log2(e) (:829-832), each logit becomes
s2 = c·log2(e)·tanh(q·k), and the no-padding path's bound is c·log2(e)
(:841-843), so SAFE_BOUND2 chooses fixed or online from c alone. The
backward's ds gains c·(1 - tanh²) per logit and drops the deferred ln2
(``_recompute_p_ds`` :402-405; :466, :502, :561, :618). Every kernel has a
softcap variant (a ``*_softcap`` C entry point and launch counter) and every
plain twin a ``softcap`` argument; ``softcap=0`` is the path above.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import telemetry
from ._common import check_input, launch, on_cpu, require

SAFE_BOUND2 = 60.0
NEG_INF = -1e30
LSE_EMPTY = 1e30
LOG2E = math.log2(math.e)
LN2 = math.log(2.0)
_FWD_BLOCK = 128  # csrc/attention.cu BQ and BK: query rows per block, keys per tile
_BWD_BLOCK = 64   # csrc/attention_bwd_dkv.cuh (rows 6 and 7): queries per step
_PLAIN_LOGITS = 2**28  # fp32 logits per chunk of the plain versions (1 GiB)
_BWD_KEY_BLOCK = 128  # csrc/attention_bwd_dkv.cuh (rows 6 and 7): keys per block
_NARROW_DH = 64  # the kernels' narrower head width
_WIDE_DH = 128  # their wider one, also the widest head they take
# csrc/attention_bwd_dq.cuh (row 8) owns _FWD_BLOCK queries a block and walks
# key tiles of _FWD_BLOCK
_FUSED_DQ_PARTIALS_CAP = 2 * 2**30  # pallas_attention.py:636


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _divisor_cap(block: int, cap: int) -> int:
    """Largest multiple-of-128 divisor of ``block`` that is <= cap
    (pallas_attention.py:733)."""
    if block <= cap:
        return block
    for cand in range(cap - cap % 128, 127, -128):
        if block % cand == 0:
            return cand
    raise ValueError(f"no 128-multiple divisor of block={block} within {cap}")


def _chunks(BH: int, Tq: int, Tk: int, budget: int = _PLAIN_LOGITS):
    step = max(1, budget // (Tq * Tk))
    for i in range(0, BH, step):
        yield slice(i, min(BH, i + step))


def _cap2(softcap: float) -> float:
    """c·log2(e) as the kernels take it: one fp32 constant."""
    return float(torch.tensor(softcap * LOG2E, dtype=torch.float32))


def _dk_scale(softcap: float) -> float:
    """The finalize scale of dK and dQ: the deferred ln2, or 1 under softcap."""
    return 1.0 if softcap > 0.0 else LN2


def _logits(qh, kh, softcap: float):
    """fp32 base-2 logits of pre-scaled q (rows, Tq, Tk), capped under softcap."""
    s = qh.float() @ kh.float().transpose(-1, -2)
    if softcap > 0.0:
        s = torch.tanh(s) * _cap2(softcap)
    return s


def _valid_keys(mask, heads: int, sl: slice):
    """(rows, 1, Tk) bool of the (batch*head) rows ``sl``, or None."""
    if mask is None:
        return None
    return mask.bool().repeat_interleave(heads, dim=0)[sl][:, None, :]


def flash_fixed_plain(qh, kh, vh, bound: float, softcap: float = 0.0):
    """Plain fixed-bound attention: (out (BH,Tq,d), lse2 (BH,Tq) fp32)."""
    BH, Tq, d = qh.shape
    out = torch.empty_like(qh)
    lse = torch.empty((BH, Tq), dtype=torch.float32, device=qh.device)
    for sl in _chunks(BH, Tq, kh.shape[1]):
        s = _logits(qh[sl], kh[sl], softcap)
        p = torch.exp2(s - bound).to(qh.dtype).float()
        l = p.sum(-1, keepdim=True).clamp_min(1e-30)  # the fp32 sum of the bf16-rounded p
        out[sl] = ((p @ vh[sl].float()) / l).to(qh.dtype)
        lse[sl] = bound + torch.log2(l[..., 0])
    return out, lse


def flash_online_plain(qh, kh, vh, mask=None, heads: int = 1, softcap: float = 0.0):
    """Plain masked softmax attention: (out, lse2). mask: (BH/heads, Tk)
    bool or None (every key valid); fully masked rows give 0 and LSE_EMPTY."""
    BH, Tq, d = qh.shape
    out = torch.empty_like(qh)
    lse = torch.empty((BH, Tq), dtype=torch.float32, device=qh.device)
    for sl in _chunks(BH, Tq, kh.shape[1]):
        s = _logits(qh[sl], kh[sl], softcap)
        valid = _valid_keys(mask, heads, sl)
        if valid is not None:
            s = torch.where(valid, s, NEG_INF)
        m = s.amax(-1, keepdim=True)
        p = torch.exp2(s - m)
        if valid is not None:
            p = p * valid
        p = p.to(qh.dtype).float()
        l = p.sum(-1, keepdim=True)
        o = (p @ vh[sl].float()) / l.clamp_min(1e-30)
        out[sl] = torch.where(l > 0, o, 0.0).to(qh.dtype)
        lse[sl] = torch.where(
            l > 0, m + torch.log2(l.clamp_min(1e-30)), LSE_EMPTY
        )[..., 0]
    return out, lse


def padded_width(d: int) -> int:
    """The head width a kernel runs a head of width d at: 64 for d <= 64,
    128 for 64 < d <= 128."""
    return _NARROW_DH if d <= _NARROW_DH else _WIDE_DH


def kernel_width(*tensors):
    """The tensors zero-padded in their last dimension to the kernels' head
    width (``padded_width``; unchanged where it is 64 or 128): the attention
    kernels take heads of 8 <= d <= 64, d % 8 == 0, as 64 wide, and 64 < d
    <= 128 as 128 wide. Exact: q·k, the row sums l, lse and
    -delta = rowsum(dO·O) gain only zero terms, and out, dq, dk and dv are
    the first d columns of the padded results (``head_columns``)."""
    return tuple(F.pad(t, (0, padded_width(t.shape[-1]) - t.shape[-1]))
                 if t.shape[-1] != padded_width(t.shape[-1]) else t for t in tensors)


def head_columns(t, d: int):
    """The first d columns of a kernel's padded result, contiguous."""
    return t if t.shape[-1] == d else t[..., :d].contiguous()


def _check_attention_inputs(qh, kh, vh, block: int, fixed: bool = False):
    """Check q, k, v's shapes and dtypes: heads of 8 <= d <= 128, multiples
    of 8 (the fixed-bound forward ``fixed``: d < 128); Tq, Tk multiples of
    ``block``."""
    BH, Tq, d = qh.shape
    Tk = kh.shape[1]
    if fixed:
        require(d % 8 == 0 and 8 <= d < _WIDE_DH,
                f"attention forward kernels take a head width below 128 that is a multiple "
                f"of 8 (zero-padded to 64 or 128), got {d}")
    else:
        require(d % 8 == 0 and 8 <= d <= _WIDE_DH,
                f"attention kernels take a head width of at most 128 that is a multiple of 8 "
                f"(zero-padded to 64 or 128), got {d}")
    require(Tq % block == 0 and Tk % block == 0,
            f"attention kernel takes Tq, Tk multiples of {block} (keys are never "
            f"padded); got Tq={Tq}, Tk={Tk}")
    check_input("qh", qh, torch.bfloat16, (BH, Tq, d))
    check_input("kh", kh, torch.bfloat16, (BH, Tk, d))
    check_input("vh", vh, torch.bfloat16, (BH, Tk, d))


def _mask_arg(mask, qh, Tk: int, heads: int):
    """The key mask as the kernels take it: a pointer to (BH/heads, Tk)
    int32, or None (every key valid)."""
    if mask is None:
        return None
    BH = qh.shape[0]
    require(BH % heads == 0, f"BH={BH} is not a multiple of heads={heads}")
    check_input("mask", mask, torch.int32, (BH // heads, Tk))
    require(mask.device == qh.device, "mask on another device")
    return mask.data_ptr()


def _as_kernel_mask(mask):
    return None if mask is None else mask.to(torch.int32).contiguous()


def _check_aligned(kernel: str, **tensors) -> None:
    """TMA and the bulk copies need 16-byte-aligned base addresses."""
    for name, t in tensors.items():
        require(t.data_ptr() % 16 == 0,
                f"{name}: the attention {kernel} kernel takes 16-byte-aligned inputs "
                f"(TMA), got data_ptr % 16 = {t.data_ptr() % 16}")


def _forward_operands(qh, kh, vh, fixed: bool):
    """Check the forward kernel's inputs (``fixed``: the fixed-bound
    variant's); return q, k and v at the kernels' width (``kernel_width``):
    the caller's own tensors at d = 64 or 128, whose rows of 128 or 256
    bytes TMA reads, and 16-byte-aligned base addresses."""
    _check_attention_inputs(qh, kh, vh, _FWD_BLOCK, fixed)
    _check_aligned("forward", qh=qh, kh=kh, vh=vh)
    return kernel_width(qh, kh, vh)


def flash_fixed_kernel(qh, kh, vh, bound: float, softcap: float = 0.0):
    """Launch the fixed-bound variant of csrc/attention.cu (its softcap
    variant for ``softcap`` > 0)."""
    q, k, v = _forward_operands(qh, kh, vh, fixed=True)
    BH, Tq, d = qh.shape
    out = torch.empty_like(q)
    lse = torch.empty((BH, Tq), dtype=torch.float32, device=qh.device)
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), float(bound))
    tail = (out.data_ptr(), lse.data_ptr(), BH, Tq, kh.shape[1], q.shape[-1])
    if softcap > 0.0:
        launch("flash_fixed_softcap", qh, *head, _cap2(softcap), *tail)
    else:
        launch("flash_fixed", qh, *head, *tail)
    return head_columns(out, d), lse


def flash_online_kernel(qh, kh, vh, mask=None, heads: int = 1, softcap: float = 0.0):
    """Launch the online-softmax variant of csrc/attention.cu (its softcap
    variant for ``softcap`` > 0)."""
    q, k, v = _forward_operands(qh, kh, vh, fixed=False)
    BH, Tq, d = qh.shape
    Tk = kh.shape[1]
    mask_ptr = _mask_arg(mask, qh, Tk, heads)
    out = torch.empty_like(q)
    lse = torch.empty((BH, Tq), dtype=torch.float32, device=qh.device)
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr)
    tail = (out.data_ptr(), lse.data_ptr(), BH, Tq, Tk, heads, q.shape[-1])
    if softcap > 0.0:
        launch("flash_online_softcap", qh, *head, _cap2(softcap), *tail)
    else:
        launch("flash_online", qh, *head, *tail)
    return head_columns(out, d), lse


def flash_fixed(qh, kh, vh, bound: float, softcap: float = 0.0):
    if on_cpu(qh, kh, vh):
        return flash_fixed_plain(qh, kh, vh, bound, softcap)
    return flash_fixed_kernel(qh, kh, vh, bound, softcap)


def flash_online(qh, kh, vh, mask=None, heads: int = 1, softcap: float = 0.0):
    """mask: (BH/heads, Tk), nonzero = valid key; None = every key valid."""
    if on_cpu(qh, kh, vh):
        return flash_online_plain(qh, kh, vh, mask, heads, softcap)
    return flash_online_kernel(qh, kh, vh, _as_kernel_mask(mask), heads, softcap)


# --------------------------------------------------------------------------
# backward
# --------------------------------------------------------------------------

def fused_backward_slab_bytes(BH: int, Tq: int, Tk: int, d: int) -> int:
    """Bytes of the fp32 dQ partials slab (BH, nk, Tq, d) that the JAX
    no-padding backward would write (``_flash_hm_full_va_bwd`` :312 ->
    ``_bwd_impl`` :639): its kv block is the largest of 1024/512/256/128
    that divides Tk (``_full_block_sizes``)."""
    bk = next((c for c in (1024, 512, 256, 128) if Tk % c == 0), Tk)
    return BH * (Tk // bk) * Tq * d * 4


def masked_backward_slab_bytes(BH: int, Tq: int, Tk: int, d: int) -> int:
    """The same slab for the masked path (``flash_attention`` :855-876 ->
    ``_flash_hm_bwd`` :747): blocks min(1024, Tq) and min(2048, Tk) rounded up
    to 128, the sequences padded to them, and a kv block of the largest
    128-multiple divisor of the key block within 1024. The padded lengths
    give the same blocks, so Tq, Tk may be either."""
    block_q, block_k = _query_block(Tq), _key_block(Tk)
    bk = _divisor_cap(block_k, 1024)
    Tqp, Tkp = _round_up(Tq, block_q), _round_up(Tk, block_k)
    return BH * (Tkp // bk) * Tqp * d * 4


def _neg_delta(dout, out):
    """-delta (BH, T) as the backward kernels and twins read it: fp32 holding
    the value in dO's dtype of the -delta column of rap_tpu's [dO | -delta]
    (``_augment_do``, pallas_attention.py:566), delta = rowsum(dO·O) in fp32.
    The products are taken in place in an fp32 copy of dO (out widened
    element by element: the same values as ``out.float()``, one temporary
    fewer)."""
    prod = dout.to(torch.float32, copy=True).mul_(out)
    return (-prod.sum(-1)).to(dout.dtype).float()


def _p_ds_tiles(qh, kh, vh, dout, nd, lse2, mask, heads, softcap: float = 0.0):
    """The recomputed tiles of the plain backward twins, over (batch*head
    rows, query rows) chunks: (rows, queries, p, ds), with p and ds rounded
    to the storage dtype where ``_recompute_p_ds`` (:369) rounds them, and
    -delta ``nd`` added after the dO·V^T product, as the kernels add it;
    under softcap ds carries c·(1 - tanh²) (:402-405)."""
    BH, Tq, d = qh.shape
    Tk = kh.shape[1]
    dt = qh.dtype
    budget = _PLAIN_LOGITS // 4
    qstep = max(1, min(Tq, budget // Tk))
    for sl in _chunks(BH, min(Tq, qstep), Tk, budget):
        valid = _valid_keys(mask, heads, sl)
        for i in range(0, Tq, qstep):
            qs = slice(i, min(Tq, i + qstep))
            s = qh[sl, qs].float() @ kh[sl].float().transpose(-1, -2)
            dsdz = None
            if softcap > 0.0:
                th = torch.tanh(s)
                s = th * _cap2(softcap)
                dsdz = softcap * (1.0 - th * th)
            if valid is not None:
                s = torch.where(valid, s, NEG_INF)
            p = torch.exp2(s - lse2[sl, qs, None])
            dpd = dout[sl, qs].to(dt).float() @ vh[sl].to(dt).float().transpose(-1, -2)
            ds = p * (dpd + nd[sl, qs, None].float())
            if dsdz is not None:
                ds = ds * dsdz
            ds = ds.to(dt).float()
            yield sl, qs, p.to(dt).float(), ds


def flash_bwd_dkv_plain(qh, kh, vh, dout, nd, lse2, mask=None, heads: int = 1,
                        softcap: float = 0.0):
    """Plain version of the dKV pass: (dk, dv), each (BH, Tk, d) in q's
    dtype; dk carries the ln2 of the base-2 domain (none under softcap).
    nd = -delta (``_neg_delta``)."""
    dk = torch.zeros(kh.shape, dtype=torch.float32, device=qh.device)
    dv = torch.zeros_like(dk)
    for sl, qs, p, ds in _p_ds_tiles(qh, kh, vh, dout, nd, lse2, mask, heads, softcap):
        dv[sl] += p.transpose(-1, -2) @ dout[sl, qs].to(qh.dtype).float()
        dk[sl] += ds.transpose(-1, -2) @ qh[sl, qs].float()
    return (dk * _dk_scale(softcap)).to(qh.dtype), dv.to(qh.dtype)


def flash_bwd_dq_plain(qh, kh, vh, dout, nd, lse2, mask=None, heads: int = 1,
                       softcap: float = 0.0):
    """Plain version of the dQ pass: dq (BH, Tq, d) in q's dtype, x ln2
    (x 1 under softcap)."""
    dq = torch.empty_like(qh)
    for sl, qs, _, ds in _p_ds_tiles(qh, kh, vh, dout, nd, lse2, mask, heads, softcap):
        dq[sl, qs] = ((ds @ kh[sl].float()) * _dk_scale(softcap)).to(qh.dtype)
    return dq


def flash_bwd_plain(qh, kh, vh, out, lse2, dout, mask=None, heads: int = 1,
                    softcap: float = 0.0):
    """Plain version of the fused backward kernel: (dq, dk, dv), each
    (BH, T, d) in q's dtype, from one recompute per tile."""
    scale = _dk_scale(softcap)
    dout = dout.to(qh.dtype)
    nd = _neg_delta(dout, out)
    dq = torch.empty_like(qh)
    dk = torch.zeros(kh.shape, dtype=torch.float32, device=qh.device)
    dv = torch.zeros_like(dk)
    for sl, qs, p, ds in _p_ds_tiles(qh, kh, vh, dout, nd, lse2, mask, heads, softcap):
        dv[sl] += p.transpose(-1, -2) @ dout[sl, qs].float()
        dk[sl] += ds.transpose(-1, -2) @ qh[sl, qs].float()
        dq[sl, qs] = ((ds @ kh[sl].float()) * scale).to(qh.dtype)
    return dq, (dk * scale).to(qh.dtype), dv.to(qh.dtype)


def _check_bwd_inputs(qh, kh, vh, dout, nd, lse2, mask, heads: int, block: int):
    """Check what a backward kernel reads: q, k, v, dO (``block``: its query
    rows a step), -delta and lse2, every one 16-byte aligned for TMA and the
    bulk copies, and the key tiles of 128; return the mask pointer."""
    _check_attention_inputs(qh, kh, vh, block)
    BH, Tq, d = qh.shape
    Tk = kh.shape[1]
    require(Tk % _BWD_KEY_BLOCK == 0,
            f"attention backward kernel takes Tk % {_BWD_KEY_BLOCK} == 0, got {Tk}")
    check_input("dout", dout, torch.bfloat16, (BH, Tq, d))
    check_input("-delta", nd, torch.float32, (BH, Tq))
    check_input("lse2", lse2, torch.float32, (BH, Tq))
    _check_aligned("backward", qh=qh, kh=kh, vh=vh, dout=dout, **{"-delta": nd}, lse2=lse2)
    return _mask_arg(mask, qh, Tk, heads)


def _launch_bwd(kernel: str, like, args: tuple, softcap: float) -> None:
    """Launch a backward entry point, or its softcap variant (which takes
    c and c·log2(e) after the integer arguments)."""
    if softcap > 0.0:
        launch(f"{kernel}_softcap", like, *args, float(softcap), _cap2(softcap))
    else:
        launch(kernel, like, *args)


def flash_bwd_kernel(qh, kh, vh, out, lse2, dout, mask=None, heads: int = 1,
                     softcap: float = 0.0):
    """Launch csrc/attention_bwd.cu on CUDA tensors: (dq, dk, dv)."""
    check_input("out", out, torch.bfloat16, qh.shape)
    dout = dout.to(qh.dtype).contiguous()
    nd = _neg_delta(dout, out)
    mask_ptr = _check_bwd_inputs(qh, kh, vh, dout, nd, lse2, mask, heads, _BWD_BLOCK)
    BH, Tq, d = qh.shape
    q, k, v, do = kernel_width(qh, kh, vh, dout)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=qh.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(k)
    _launch_bwd("flash_bwd", qh,
                (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, do.data_ptr(),
                 nd.data_ptr(), lse2.data_ptr(), dq_acc.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), BH, Tq, kh.shape[1], heads, q.shape[-1]),
                softcap)
    scale = _dk_scale(softcap)
    if scale != 1.0:
        dq_acc.mul_(scale)
    return (head_columns(dq_acc, d).to(qh.dtype), head_columns(dk, d),
            head_columns(dv, d))


def flash_bwd_dkv_kernel(qh, kh, vh, dout, nd, lse2, mask=None, heads: int = 1,
                         softcap: float = 0.0):
    """Launch the dKV pass of csrc/attention_bwd_split.cu on dO and
    -delta = ``_neg_delta(dout, out)`` (row 7: Tq % 64, Tk % 128): (dk, dv)."""
    mask_ptr = _check_bwd_inputs(qh, kh, vh, dout, nd, lse2, mask, heads, _BWD_BLOCK)
    BH, Tq, d = qh.shape
    q, k, v, do = kernel_width(qh, kh, vh, dout)
    dk = torch.empty_like(k)
    dv = torch.empty_like(k)
    _launch_bwd("flash_bwd_dkv", qh,
                (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, do.data_ptr(),
                 nd.data_ptr(), lse2.data_ptr(), dk.data_ptr(), dv.data_ptr(), BH, Tq,
                 kh.shape[1], heads, q.shape[-1]), softcap)
    return head_columns(dk, d), head_columns(dv, d)


def flash_bwd_dq_kernel(qh, kh, vh, dout, nd, lse2, mask=None, heads: int = 1,
                        softcap: float = 0.0):
    """Launch the dQ pass of csrc/attention_bwd_split.cu on dO and -delta
    (row 8: blocks of 128 queries, key tiles of 128): dq."""
    mask_ptr = _check_bwd_inputs(qh, kh, vh, dout, nd, lse2, mask, heads, _FWD_BLOCK)
    BH, Tq, d = qh.shape
    q, k, v, do = kernel_width(qh, kh, vh, dout)
    dq = torch.empty_like(q)
    _launch_bwd("flash_bwd_dq", qh,
                (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, do.data_ptr(),
                 nd.data_ptr(), lse2.data_ptr(), dq.data_ptr(), BH, Tq, kh.shape[1], heads,
                 q.shape[-1]), softcap)
    return head_columns(dq, d)


def flash_bwd(qh, kh, vh, out, lse2, dout, mask=None, heads: int = 1,
              softcap: float = 0.0):
    if on_cpu(qh, kh, vh, out, lse2, dout):
        return flash_bwd_plain(qh, kh, vh, out, lse2, dout, mask, heads, softcap)
    return flash_bwd_kernel(qh, kh, vh, out, lse2, dout, _as_kernel_mask(mask), heads,
                            softcap)


def flash_bwd_dkv(qh, kh, vh, dout, nd, lse2, mask=None, heads: int = 1,
                  softcap: float = 0.0):
    if on_cpu(qh, kh, vh, dout, nd, lse2):
        return flash_bwd_dkv_plain(qh, kh, vh, dout, nd, lse2, mask, heads, softcap)
    return flash_bwd_dkv_kernel(qh, kh, vh, dout, nd, lse2, _as_kernel_mask(mask), heads,
                                softcap)


def flash_bwd_dq(qh, kh, vh, dout, nd, lse2, mask=None, heads: int = 1,
                 softcap: float = 0.0):
    if on_cpu(qh, kh, vh, dout, nd, lse2):
        return flash_bwd_dq_plain(qh, kh, vh, dout, nd, lse2, mask, heads, softcap)
    return flash_bwd_dq_kernel(qh, kh, vh, dout, nd, lse2, _as_kernel_mask(mask), heads,
                               softcap)


def attention_backward(qh, kh, vh, out, lse2, dout, mask, heads: int, split: bool,
                       kernels: bool, softcap: float = 0.0):
    """(dq, dk, dv) as ``_bwd_impl`` (:639) computes them: the fused pass, or
    with ``split`` the dKV and dQ passes on one -delta (``_neg_delta``),
    computed once for both."""
    dout = dout.to(qh.dtype).contiguous()
    if not split:
        bwd = flash_bwd if kernels else flash_bwd_plain
        return bwd(qh, kh, vh, out, lse2, dout, mask, heads, softcap)
    nd = _neg_delta(dout, out)
    if kernels and not on_cpu(qh, kh, vh, out, lse2, dout):
        mask, dkv, dq = _as_kernel_mask(mask), flash_bwd_dkv_kernel, flash_bwd_dq_kernel
    else:
        dkv, dq = flash_bwd_dkv_plain, flash_bwd_dq_plain
    dk, dv = dkv(qh, kh, vh, dout, nd, lse2, mask, heads, softcap)
    return dq(qh, kh, vh, dout, nd, lse2, mask, heads, softcap), dk, dv


class _FlashAttention(torch.autograd.Function):
    """Counterpart of ``_flash_hm_full_va`` (pallas_attention.py:296-326)."""

    @staticmethod
    def forward(ctx, qh, kh, vh, bound2: float, kernels: bool, softcap: float):
        if bound2 <= SAFE_BOUND2:
            telemetry.bump("attn.fixed")
            fwd = flash_fixed if kernels else flash_fixed_plain
            out, lse = fwd(qh, kh, vh, bound2, softcap)
        else:
            telemetry.bump("attn.online")
            fwd = flash_online if kernels else flash_online_plain
            out, lse = fwd(qh, kh, vh, None, 1, softcap)
        ctx.save_for_backward(qh, kh, vh, out, lse)
        ctx.kernels, ctx.softcap = kernels, softcap
        return out

    @staticmethod
    def backward(ctx, dout):
        qh, kh, vh, out, lse = ctx.saved_tensors
        BH, Tq, d = qh.shape
        split = fused_backward_slab_bytes(BH, Tq, kh.shape[1], d) > _FUSED_DQ_PARTIALS_CAP
        return (*attention_backward(qh, kh, vh, out, lse, dout, None, 1, split, ctx.kernels,
                                    ctx.softcap), None, None, None)


def flash_attention_headmajor(qh, kh, vh, bound2: float, kernels: bool = True,
                              softcap: float = 0.0):
    """No-padding attention on (BH, T, d) pre-scaled q, k and v. ``bound2``
    bounds the base-2 logits: from the qk-norm gains (the caller computes it
    on the host), or c·log2(e) under a softcap c. Returns out (BH, T, d).

    Differentiable. ``kernels=False`` takes the plain versions forward and
    backward on any device; CPU tensors take them either way."""
    return _FlashAttention.apply(qh, kh, vh, float(bound2), kernels, float(softcap))


class _MaskedFlashAttention(torch.autograd.Function):
    """Counterpart of ``_flash_hm`` (pallas_attention.py:722-768): the online
    forward with a (B, Tk) key mask shared by ``heads`` heads, and its
    backward."""

    @staticmethod
    def forward(ctx, qh, kh, vh, mask, heads: int, kernels: bool, softcap: float):
        telemetry.bump("attn.masked")
        fwd = flash_online if kernels else flash_online_plain
        out, lse = fwd(qh, kh, vh, mask, heads, softcap)
        ctx.save_for_backward(qh, kh, vh, mask, out, lse)
        ctx.heads, ctx.kernels, ctx.softcap = heads, kernels, softcap
        return out

    @staticmethod
    def backward(ctx, dout):
        qh, kh, vh, mask, out, lse = ctx.saved_tensors
        BH, Tq, d = qh.shape
        split = masked_backward_slab_bytes(BH, Tq, kh.shape[1], d) > _FUSED_DQ_PARTIALS_CAP
        return (*attention_backward(qh, kh, vh, out, lse, dout, mask, ctx.heads, split,
                                    ctx.kernels, ctx.softcap), None, None, None, None)


def _query_block(Tq: int) -> int:
    """The masked path's query block (:855-876): min(1024, Tq) rounded up to 128."""
    return min(1024, _round_up(Tq, 128))


def _key_block(Tk: int) -> int:
    """Its key block: min(2048, Tk) rounded up to 128."""
    return min(2048, _round_up(Tk, 128))


def key_mask(kv_mask):
    """(B, Tk) bool key mask -> the masked path's int32 mask (B, Tk + pk),
    the keys padded to its key block invalid."""
    Tk = kv_mask.shape[1]
    return F.pad(kv_mask.to(torch.int32), (0, (-Tk) % _key_block(Tk)))


def masked_attention_headmajor(qh, kh, vh, mask, heads: int, kernels: bool = True,
                               softcap: float = 0.0):
    """Masked attention on (BH, Tq, d) pre-scaled q, k and v (BH, Tk, d);
    ``mask`` the int32 key mask of ``key_mask`` (BH/heads, Tk + pk), shared
    by ``heads`` heads. Pads q to the query block and k, v to the key block
    with zeros (padded keys masked), runs the online forward with the mask
    and returns out (BH, Tq, d). Differentiable."""
    Tq, Tk = qh.shape[1], kh.shape[1]
    pq, pk = (-Tq) % _query_block(Tq), (-Tk) % _key_block(Tk)
    if pq:
        qh = F.pad(qh, (0, 0, 0, pq))
    if pk:
        kh = F.pad(kh, (0, 0, 0, pk))
        vh = F.pad(vh, (0, 0, 0, pk))
    out = _MaskedFlashAttention.apply(qh, kh, vh, mask, heads, kernels, float(softcap))
    return out[:, :Tq] if pq else out


def _head_major(a, B: int, H: int, T: int, d: int):
    return a.transpose(1, 2).reshape(B * H, T, d).contiguous()


def flash_attention(q, k, v, kv_mask=None, scale: float | None = None,
                    softcap: float = 0.0, logit_bound: float | None = None,
                    kernels: bool = True):
    """Masked flash attention on (B, T, H, d) q, k, v; returns (B, Tq, H, d)
    in q's dtype. ``kv_mask`` (B, Tk) bool, or None: every key valid, which
    takes the no-padding path where Tq and Tk are multiples of 128.
    ``logit_bound``: a host bound on the unscaled logits max|q·k| for that
    path (from the qk-norm gains); without one it is computed from the row
    norms (one host read). ``softcap`` c > 0 caps every logit at c with
    tanh; that path's bound is then c·log2(e). Differentiable."""
    B, Tq, H, d = q.shape
    Tk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    # q * jnp.asarray(scale * LOG2E, q.dtype) or scale / softcap (:829-832):
    # the constant itself is rounded to q's dtype; bf16 x bf16 is exact in
    # fp32, then rounded
    pre = scale / softcap if softcap > 0.0 else scale * LOG2E
    q = q * float(torch.tensor(pre, dtype=q.dtype))
    qh = _head_major(q, B, H, Tq, d)
    kh = _head_major(k, B, H, Tk, d)
    vh = _head_major(v, B, H, Tk, d)

    if kv_mask is None and Tq % 128 == 0 and Tk % 128 == 0 and d < 128:
        if softcap > 0.0:
            bound2 = _cap2(softcap)  # tanh caps the base-2 logits (:841-843)
        elif logit_bound is not None:
            bound2 = float(logit_bound) * scale * LOG2E
        else:
            with torch.no_grad():
                qn = qh.float().square().sum(-1).sqrt().max()
                kn = kh.float().square().sum(-1).sqrt().max()
                telemetry.bump("sync.bounds")
                bound2 = float(qn * kn)
        out = flash_attention_headmajor(qh, kh, vh, bound2, kernels, softcap)
        return out.reshape(B, H, Tq, d).transpose(1, 2)

    if kv_mask is None:
        kv_mask = torch.ones((B, Tk), dtype=torch.bool, device=q.device)
    out = masked_attention_headmajor(qh, kh, vh, key_mask(kv_mask), H, kernels, softcap)
    return out.reshape(B, H, Tq, d).transpose(1, 2)
