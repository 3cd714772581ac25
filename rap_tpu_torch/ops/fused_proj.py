"""Fused AdaLN + QKV projection + qk-norm, and the attention output projection.

Counterpart of rap_tpu/ops/fused_proj.py. ``adaln_qkv`` emits the
head-major tensors the attention kernel reads, in the JAX package's public
layout: q, k (G,H,N,dh) and va (G,H,N,dh+1) for part attention, (S,H,P,N,dh)
and (S,H,P,N,dh+1) for global attention. q is pre-scaled by gamma_q*log2(e)
(base-2 softmax), k by gamma_k*sqrt(dh), and va carries the ones column.
``attn_out`` folds those rows back into tokens: res + rows @ W_out + b.

Kernels: csrc/proj.cu (TPU ``_proj_kernel``, fused_proj.py:46) and
csrc/out_proj.cu (TPU ``_out_kernel``, fused_proj.py:458). ``proj_plain`` and
``out_plain`` repeat the kernels' arithmetic and cast points in plain PyTorch
(the role of ``xla_reference`` :152 and ``out_xla_reference`` :501): the
product sums bf16 inputs in fp32, as the kernels do.
"""

from __future__ import annotations

import math

import torch

from . import _build
from ._common import LAUNCHES, check_input, on_cpu, require, stream_of


def _ln(xf: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps)


def _to_head_major(a: torch.Tensor, P: int, is_global: bool) -> torch.Tensor:
    """(G, N, H, e) -> (G, H, N, e) or (S, H, P, N, e)."""
    G, N, H, e = a.shape
    if is_global:
        return a.reshape(G // P, P, N, H, e).permute(0, 3, 1, 2, 4).contiguous()
    return a.permute(0, 2, 1, 3).contiguous()


def _to_tokens(a5: torch.Tensor, G: int, P: int, is_global: bool) -> torch.Tensor:
    """Inverse of _to_head_major: -> (G, N, H*dh)."""
    if is_global:
        S, H, _, N, dh = a5.shape
        return a5.permute(0, 2, 3, 1, 4).reshape(G, N, H * dh)
    _, H, N, dh = a5.shape
    return a5.permute(0, 2, 1, 3).reshape(G, N, H * dh)


def proj_plain(x, ada, w, gq_eff, gk_eff, P: int, is_global: bool):
    """Plain version of the proj kernel (gains already folded)."""
    G, N, D = x.shape
    H, dh = gq_eff.shape
    scale, shift = ada.float().chunk(2, dim=-1)
    h = _ln(x.float())
    h = (h * (1.0 + scale[:, None, :]) + shift[:, None, :]).to(x.dtype)
    y = (h.float() @ w.float()).reshape(G, N, 3, H, dh)

    def rms(c, gain):
        r = torch.rsqrt((c * c).sum(-1, keepdim=True) + 1e-12)
        return (c * r * gain.float()).to(x.dtype)

    q = rms(y[:, :, 0], gq_eff)
    k = rms(y[:, :, 1], gk_eff)
    v = y[:, :, 2].to(x.dtype)
    va = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    return tuple(_to_head_major(a, P, is_global) for a in (q, k, va))


def proj_kernel(x, ada, w, gq_eff, gk_eff, P: int, is_global: bool):
    """Launch csrc/proj.cu on CUDA tensors."""
    G, N, D = x.shape
    H, dh = gq_eff.shape
    require(dh == 64 and D == H * dh, f"proj kernel takes dh=64, D=H*dh; got D={D}, H={H}")
    require(N % 64 == 0, f"proj kernel takes N % 64 == 0; got N={N}")
    require(G % P == 0, f"G={G} is not a multiple of P={P}")
    check_input("x", x, torch.bfloat16, (G, N, D))
    check_input("ada", ada, torch.float32, (G, 2 * D))
    check_input("w", w, torch.bfloat16, (D, 3 * D))
    check_input("gq_eff", gq_eff, torch.float32, (H, dh))
    check_input("gk_eff", gk_eff, torch.float32, (H, dh))
    S = G // P
    lead = (S, H, P, N) if is_global else (G, H, N)
    q = torch.empty(lead + (dh,), dtype=x.dtype, device=x.device)
    k = torch.empty_like(q)
    va = torch.empty(lead + (dh + 1,), dtype=x.dtype, device=x.device)
    err = _build.load().lib.rtt_proj(
        x.data_ptr(), ada.data_ptr(), w.data_ptr(), gq_eff.data_ptr(),
        gk_eff.data_ptr(), q.data_ptr(), k.data_ptr(), va.data_ptr(),
        G, N, D, H, P if is_global else 1, stream_of(x),
    )
    _build.check(err, "proj kernel")
    LAUNCHES["proj"] += 1
    return q, k, va


def fold_gains(gamma_q, gamma_k):
    """qk-norm gains folded with the softmax scale (fused_proj.py:436-437)."""
    dh = gamma_q.shape[-1]
    return (gamma_q.float() * math.log2(math.e),
            gamma_k.float() * math.sqrt(dh))


def adaln_qkv(x, ada, w, gamma_q, gamma_k, P: int, is_global: bool):
    """Head-major (q, k, va) from tokens x (G, N, D), AdaLN (G, 2D) = (scale |
    shift), fused QKV weight w (D, 3D) and unfolded qk-norm gains (H, dh).

    CPU tensors take ``proj_plain``; CUDA tensors launch the kernel.
    """
    gq_eff, gk_eff = fold_gains(gamma_q, gamma_k)
    if on_cpu(x, ada, w, gq_eff, gk_eff):
        return proj_plain(x, ada, w, gq_eff, gk_eff, P, is_global)
    return proj_kernel(x, ada.float().contiguous(), w.to(x.dtype).contiguous(),
                       gq_eff.contiguous(), gk_eff.contiguous(), P, is_global)


def adaln_qkv_plain(x, ada, w, gamma_q, gamma_k, P: int, is_global: bool):
    """``adaln_qkv`` through the plain version on any device."""
    gq_eff, gk_eff = fold_gains(gamma_q, gamma_k)
    return proj_plain(x, ada, w, gq_eff, gk_eff, P, is_global)


def out_plain(a5, res, w, b, P: int, is_global: bool):
    """Plain version of the out_proj kernel."""
    G = res.shape[0]
    xt = _to_tokens(a5, G, P, is_global)
    y = xt.float() @ w.float() + b.to(res.dtype).float()
    return res + y.to(res.dtype)


def out_kernel(a5, res, w, b, P: int, is_global: bool):
    """Launch csrc/out_proj.cu on CUDA tensors."""
    G, N, D = res.shape
    H, dh = a5.shape[1], a5.shape[-1]
    require(dh == 64 and D == H * dh, f"out kernel takes dh=64, D=H*dh; got D={D}, H={H}")
    require(N % 64 == 0, f"out kernel takes N % 64 == 0; got N={N}")
    require(G % P == 0, f"G={G} is not a multiple of P={P}")
    lead = (G // P, H, P, N) if is_global else (G, H, N)
    check_input("a5", a5, torch.bfloat16, lead + (dh,))
    check_input("res", res, torch.bfloat16, (G, N, D))
    check_input("w", w, torch.bfloat16, (D, D))
    check_input("b", b, torch.bfloat16, (D,))
    out = torch.empty_like(res)
    err = _build.load().lib.rtt_out_proj(
        a5.data_ptr(), res.data_ptr(), w.data_ptr(), b.data_ptr(),
        out.data_ptr(), G, N, D, H, P if is_global else 1, stream_of(res),
    )
    _build.check(err, "out_proj kernel")
    LAUNCHES["out_proj"] += 1
    return out


def attn_out(a5, res, w, b, P: int, is_global: bool):
    """res + tokens(a5) @ w + b, with a5 head-major: part (G,H,N,dh), global
    (S,H,P,N,dh); res (G, N, D); w (H*dh, D); b (D,).

    CPU tensors take ``out_plain``; CUDA tensors launch the kernel.
    """
    if on_cpu(a5, res, w, b):
        return out_plain(a5, res, w, b, P, is_global)
    dt = res.dtype
    return out_kernel(a5, res, w.to(dt).contiguous(), b.to(dt).contiguous(),
                      P, is_global)
