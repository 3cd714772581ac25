"""Fused AdaLN + QKV projection + qk-norm, and the attention output projection.

Counterpart of rap_tpu/ops/fused_proj.py. ``adaln_qkv`` emits the
head-major tensors the attention kernel reads: q, k, v (G,H,N,dh) for part
attention, (S,H,P,N,dh) for global attention. q is pre-scaled by
gamma_q*log2(e) (base-2 softmax), k by gamma_k*sqrt(dh). rap_tpu's kernel
emits va = [v | 1], v with a ones column, for its attention kernel's row
sums; the port's attention kernels need none, so v is v alone, and its
cotangent dv.
``attn_out`` folds those rows back into tokens: res + rows @ W_out + b.

Kernels: csrc/proj.cu (TPU ``_proj_kernel``, fused_proj.py:46) and
csrc/out_proj.cu (TPU ``_out_kernel``, fused_proj.py:458), both on the TMA +
wgmma GEMM of csrc/gemm_sm90.cuh. ``proj_plain`` and ``out_plain`` repeat the
kernels' arithmetic and cast points in plain PyTorch (the role of
``xla_reference`` :152 and ``out_xla_reference`` :501): the product sums bf16
inputs in fp32, as the kernels do. Both kernels take every shape whose
attention sequences (N tokens for part attention, P*N for global) are a
multiple of 128 and that rap_tpu's fused guard admits (dit.py:183-195;
``proj_shape_error``, ``out_shape_error``): all that rap_tpu's ``legal``
rules (:440-442, :556-557) admit, and the global layouts with N % 128 != 0
that the guard admits too. ``adaln_qkv`` and ``attn_out`` dispatch on that
rule from the shape: a refused shape takes the plain versions.

Both are ``torch.autograd.Function``s. The backward of ``adaln_qkv`` is
csrc/proj_bwd.cu (TPU ``_proj_bwd_kernel``, fused_proj.py:184), on the same
GEMM, launched wherever the forward launched csrc/proj.cu (it takes the same
shapes), twin ``proj_bwd_plain``; its dW comes back in the caller's weight
dtype straight from the fp32 sums (fp32 masters in training, :375-381). The backward of
``attn_out`` is the plain vjp of the reference composition in the
residual's dtype (``_fused_out_bwd`` :525 has no kernel either), so its dW is
rounded to that dtype before it reaches an fp32 master.
"""

from __future__ import annotations

import math

import torch

from ._common import check_input, launch, on_cpu, require, require_aligned
from .fused_ff import _BLOCKS_PER_SM, _sm_count, wgrad_splits

_TILE = 128  # rows and columns of an output tile of csrc/gemm_sm90.cuh


def _ln_stats(xf: torch.Tensor, eps: float = 1e-5):
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return (xf - mu) * rstd, rstd


def _ln(xf: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return _ln_stats(xf, eps)[0]


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
    return tuple(_to_head_major(a, P, is_global) for a in (q, k, v))


def _shape_error(kernel: str, G: int, N: int, D: int, H: int, dh: int, P: int,
                 is_global: bool) -> str | None:
    L = N * P if is_global else N
    if D != H * dh:
        return f"{kernel} kernel takes D = H*dh, got D={D}, H={H}, dh={dh}"
    if D % _TILE != 0:
        return f"{kernel} kernel takes a width D that is a multiple of 128, got {D}"
    if dh % 8 != 0 or dh >= 128:
        return f"{kernel} kernel takes a head width below 128 that is a multiple of 8, got {dh}"
    if G % P != 0:
        return f"{kernel} kernel takes G parts that are a multiple of P, got G={G}, P={P}"
    if L % _TILE != 0:
        return (f"{kernel} kernel takes attention sequences of a multiple of 128 tokens "
                f"(N, or P*N for global attention), got {L}")
    return None


def proj_shape_error(G: int, N: int, D: int, H: int, dh: int, P: int,
                     is_global: bool) -> str | None:
    """Why csrc/proj.cu refuses G parts of N tokens of width D, H heads of
    width dh, P parts a sample in the part or global layout, or None where
    it takes them: D % 128 == 0, dh % 8 == 0, dh < 128 and an attention
    sequence L (N, or P*N for global attention) that is a multiple of 128,
    as rap_tpu's fused guard has them (dit.py:193-194), and G % P == 0 from
    its ``legal`` rule (fused_proj.py:440-442). Then a tile of 128 tokens
    lies in one sequence, and the head-major rows of one head for it are
    contiguous. rap_tpu's rule asks a block of 128-1024 tokens to divide N
    in both layouts: in the global layout the kernel needs only P*N."""
    return _shape_error("proj", G, N, D, H, dh, P, is_global)


def out_shape_error(G: int, N: int, D: int, H: int, dh: int, P: int,
                    is_global: bool) -> str | None:
    """Why csrc/out_proj.cu refuses a shape, or None: the rule of
    ``proj_shape_error`` (rap_tpu's ``legal`` for it, :556-557, has no dh
    term; the fused guard's dh % 8 == 0, dh < 128 holds for both)."""
    return _shape_error("out_proj", G, N, D, H, dh, P, is_global)


def proj_kernel(x, ada, w, gq_eff, gk_eff, P: int, is_global: bool):
    """Launch csrc/proj.cu on CUDA tensors."""
    G, N, D = x.shape
    H, dh = gq_eff.shape
    err = proj_shape_error(G, N, D, H, dh, P, is_global)
    require(err is None, err or "")
    check_input("x", x, torch.bfloat16, (G, N, D))
    check_input("ada", ada, torch.float32, (G, 2 * D))
    check_input("w", w, torch.bfloat16, (D, 3 * D))
    check_input("gq_eff", gq_eff, torch.float32, (H, dh))
    check_input("gk_eff", gk_eff, torch.float32, (H, dh))
    require_aligned("proj kernels", x=x, w=w)
    S = G // P
    lead = (S, H, P, N) if is_global else (G, H, N)
    hln = torch.empty((G * N, D), dtype=x.dtype, device=x.device)
    q, k, v = (torch.empty(lead + (dh,), dtype=x.dtype, device=x.device) for _ in range(3))
    launch(
        "proj", x,
        x.data_ptr(), ada.data_ptr(), w.data_ptr(), gq_eff.data_ptr(),
        gk_eff.data_ptr(), hln.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        G, N, D, H, P if is_global else 1,
    )
    return q, k, v


def proj_bwd_plain(x, ada, w, gq_eff, gk_eff, dq, dk, dv, P: int, is_global: bool):
    """Plain version of the proj backward kernel: (dx, d(ada) (G, 2D),
    dW (D, 3D), d(gq_eff), d(gk_eff)); dx in x's dtype, the rest fp32."""
    G, N, D = x.shape
    H, dh = gq_eff.shape
    dt = x.dtype
    scale, shift = ada.float().chunk(2, dim=-1)
    xhat, rstd = _ln_stats(x.float())
    h = (xhat * (1.0 + scale[:, None, :]) + shift[:, None, :]).to(dt)
    y = (h.float() @ w.to(dt).float()).reshape(G, N, 3, H, dh)

    def rms_vjp(sec, d, gain):
        r = torch.rsqrt((sec * sec).sum(-1, keepdim=True) + 1e-12)
        dg = d * gain.float()
        c = (dg * sec).sum(-1, keepdim=True) * r**3
        return r * dg - sec * c, (d * sec * r).sum((0, 1))

    def tokens(a5):
        return _to_tokens(a5, G, P, is_global).float().reshape(G, N, H, dh)

    dsec_q, dgq = rms_vjp(y[:, :, 0], tokens(dq), gq_eff)
    dsec_k, dgk = rms_vjp(y[:, :, 1], tokens(dk), gk_eff)
    dy = torch.stack([dsec_q, dsec_k, tokens(dv)], dim=2)
    dy = dy.reshape(G, N, 3 * D).to(dt).float()
    dw = h.float().reshape(-1, D).transpose(0, 1) @ dy.reshape(-1, 3 * D)
    dhid = dy @ w.to(dt).float().transpose(0, 1)
    dxhat = dhid * (1.0 + scale[:, None, :])
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = (rstd * (dxhat - m1 - xhat * m2)).to(dt)
    dada = torch.cat([(dhid * xhat).sum(1), dhid.sum(1)], dim=-1)
    return dx, dada, dw, dgq, dgk


def ln_block_rows(N: int) -> int:
    """Rows of a block of csrc/proj_bwd.cu's LayerNorm vjp: the largest power
    of two up to 64 that divides N, so a block lies in one part and its
    column sums are one part's."""
    return math.gcd(N, 64)


def _carve(nbytes: list[int], device) -> tuple[torch.Tensor, list[int]]:
    """One workspace for the scratch buffers of ``nbytes`` bytes each, every
    buffer 256-byte aligned: (the workspace, each buffer's address)."""
    offsets, at = [], 0
    for n in nbytes:
        offsets.append(at)
        at += -(-n // 256) * 256
    ws = torch.empty((max(at, 1) + 256,), dtype=torch.uint8, device=device)
    base = -(-ws.data_ptr() // 256) * 256
    return ws, [base + o for o in offsets]


def proj_bwd_kernel(x, ada, w, gq_eff, gk_eff, dq, dk, dv, P: int, is_global: bool):
    """Launch csrc/proj_bwd.cu on CUDA tensors; returns what
    ``proj_bwd_plain`` returns. Takes the shapes of ``proj_shape_error``."""
    G, N, D = x.shape
    H, dh = gq_eff.shape
    err = proj_shape_error(G, N, D, H, dh, P, is_global)
    require(err is None, err or "")
    check_input("x", x, torch.bfloat16, (G, N, D))
    check_input("ada", ada, torch.float32, (G, 2 * D))
    check_input("w", w, torch.bfloat16, (D, 3 * D))
    check_input("gq_eff", gq_eff, torch.float32, (H, dh))
    check_input("gk_eff", gk_eff, torch.float32, (H, dh))
    lead = (G // P, H, P, N) if is_global else (G, H, N)
    for name, t in (("dq", dq), ("dk", dk), ("dv", dv)):
        check_input(name, t, torch.bfloat16, lead + (dh,))
    require_aligned("proj backward kernels", x=x, w=w, dq=dq, dk=dk, dv=dv)
    T, R = G * N, ln_block_rows(N)
    slots = _BLOCKS_PER_SM * _sm_count(x.device)
    splits = wgrad_splits((D // _TILE) * (3 * D // _TILE), T // 64, slots)
    # hln, dy (bf16); dhid, the gain, LN and dW partials (fp32)
    ws, (hln, dy, dhid, gpart, lnpart, wpart) = _carve(
        [T * D * 2, T * 3 * D * 2, T * D * 4, T // 64 * 2 * D * 4, T // R * 2 * D * 4,
         (splits * D * 3 * D if splits > 1 else 0) * 4], x.device)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dada, dw, dgain = (torch.empty((G, 2 * D), **f32), torch.empty((D, 3 * D), **f32),
                       torch.empty((2 * D,), **f32))
    launch(
        "proj_bwd", x,
        x.data_ptr(), ada.data_ptr(), w.data_ptr(), gq_eff.data_ptr(),
        gk_eff.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), hln, dy, dhid,
        gpart, lnpart, wpart, dx.data_ptr(), dada.data_ptr(), dw.data_ptr(),
        dgain.data_ptr(), G, N, D, H, P if is_global else 1, R, splits,
    )
    return dx, dada, dw, dgain[:D].reshape(H, dh), dgain[D:].reshape(H, dh)


def fold_gains(gamma_q, gamma_k):
    """qk-norm gains folded with the softmax scale (fused_proj.py:436-437)."""
    dh = gamma_q.shape[-1]
    return (gamma_q.float() * math.log2(math.e),
            gamma_k.float() * math.sqrt(dh))


class _AdalnQKV(torch.autograd.Function):
    """Counterpart of ``_fused`` (fused_proj.py:386-419)."""

    @staticmethod
    def forward(ctx, x, ada, w, gq_eff, gk_eff, P: int, is_global: bool,
                kernels: bool):
        ctx.save_for_backward(x, ada, w, gq_eff, gk_eff)
        ctx.args = (P, is_global)
        ctx.use_kernel = kernels and not on_cpu(x, ada, w, gq_eff, gk_eff)
        if ctx.use_kernel:
            return proj_kernel(x, ada.float().contiguous(), w.to(x.dtype).contiguous(),
                               gq_eff.contiguous(), gk_eff.contiguous(), P, is_global)
        return proj_plain(x, ada, w, gq_eff, gk_eff, P, is_global)

    @staticmethod
    def backward(ctx, dq, dk, dv):
        x, ada, w, gq_eff, gk_eff = ctx.saved_tensors
        if ctx.use_kernel:
            grads = proj_bwd_kernel(
                x, ada.float().contiguous(), w.to(x.dtype).contiguous(),
                gq_eff.float().contiguous(), gk_eff.float().contiguous(),
                dq.contiguous(), dk.contiguous(), dv.contiguous(), *ctx.args)
        else:
            grads = proj_bwd_plain(x, ada, w, gq_eff, gk_eff, dq, dk, dv, *ctx.args)
        dx, dada, dw, dgq, dgk = grads
        return (dx, dada.to(ada.dtype), dw.to(w.dtype), dgq.to(gq_eff.dtype),
                dgk.to(gk_eff.dtype), None, None, None)


def adaln_qkv(x, ada, w, gamma_q, gamma_k, P: int, is_global: bool,
              kernels: bool = True):
    """Head-major (q, k, v) from tokens x (G, N, D), AdaLN (G, 2D) = (scale |
    shift), fused QKV weight w (D, 3D) and unfolded qk-norm gains (H, dh).

    Differentiable. CUDA tensors of a shape ``proj_shape_error`` admits
    launch the kernels forward and backward; CPU tensors, a shape it
    refuses, or ``kernels=False`` take the plain versions.
    """
    G, N, D = x.shape
    H, dh = gamma_q.shape
    gq_eff, gk_eff = fold_gains(gamma_q, gamma_k)
    kernels = kernels and proj_shape_error(G, N, D, H, dh, P, is_global) is None
    return _AdalnQKV.apply(x, ada, w, gq_eff, gk_eff, P, is_global, kernels)


def adaln_qkv_plain(x, ada, w, gamma_q, gamma_k, P: int, is_global: bool):
    """``adaln_qkv`` through the plain versions on any device."""
    return adaln_qkv(x, ada, w, gamma_q, gamma_k, P, is_global, kernels=False)


def out_plain(a5, res, w, b, P: int, is_global: bool):
    """Plain version of the out_proj kernel."""
    G = res.shape[0]
    xt = _to_tokens(a5, G, P, is_global)
    y = xt.float() @ w.float() + b.to(res.dtype).float()
    return res + y.to(res.dtype)


def out_bwd_plain(a5, w, g, P: int, is_global: bool):
    """vjp of res + tokens(a5) @ w + b in the residual's dtype (that of g),
    as ``out_xla_reference`` (:501) is differentiated: (d a5, d res, dW, db),
    dW and db in g's dtype."""
    G, N, D = g.shape
    H, dh = a5.shape[1], a5.shape[-1]
    dt = g.dtype
    g2 = g.reshape(-1, D)
    xt = _to_tokens(a5, G, P, is_global).to(dt).reshape(-1, H * dh)
    da = (g2 @ w.to(dt).transpose(0, 1)).reshape(G, N, H, dh)
    return (_to_head_major(da, P, is_global), g, xt.transpose(0, 1) @ g2,
            g2.sum(0))


def out_kernel(a5, res, w, b, P: int, is_global: bool):
    """Launch csrc/out_proj.cu on CUDA tensors."""
    G, N, D = res.shape
    H, dh = a5.shape[1], a5.shape[-1]
    err = out_shape_error(G, N, D, H, dh, P, is_global)
    require(err is None, err or "")
    lead = (G // P, H, P, N) if is_global else (G, H, N)
    check_input("a5", a5, torch.bfloat16, lead + (dh,))
    check_input("res", res, torch.bfloat16, (G, N, D))
    check_input("w", w, torch.bfloat16, (D, D))
    check_input("b", b, torch.bfloat16, (D,))
    require_aligned("out_proj kernels", a5=a5, res=res, w=w)
    # the gathered tokens, where a k slab is not one head
    xt = None if dh == 64 else torch.empty((G * N, D), dtype=res.dtype, device=res.device)
    out = torch.empty_like(res)
    launch(
        "out_proj", res,
        a5.data_ptr(), res.data_ptr(), w.data_ptr(), b.data_ptr(),
        None if xt is None else xt.data_ptr(), out.data_ptr(), G, N, D, H,
        P if is_global else 1,
    )
    return out


class _AttnOut(torch.autograd.Function):
    """Counterpart of ``_fused_out`` (fused_proj.py:514-531)."""

    @staticmethod
    def forward(ctx, a5, res, w, b, P: int, is_global: bool, kernels: bool):
        ctx.save_for_backward(a5, w, b)
        ctx.args = (P, is_global)
        if kernels and not on_cpu(a5, res, w, b):
            dt = res.dtype
            return out_kernel(a5, res, w.to(dt).contiguous(), b.to(dt).contiguous(),
                              P, is_global)
        return out_plain(a5, res, w, b, P, is_global)

    @staticmethod
    def backward(ctx, g):
        a5, w, b = ctx.saved_tensors
        da5, dres, dw, db = out_bwd_plain(a5, w, g.contiguous(), *ctx.args)
        return da5.to(a5.dtype), dres, dw.to(w.dtype), db.to(b.dtype), None, None, None


def attn_out(a5, res, w, b, P: int, is_global: bool, kernels: bool = True):
    """res + tokens(a5) @ w + b, with a5 head-major: part (G,H,N,dh), global
    (S,H,P,N,dh); res (G, N, D); w (H*dh, D); b (D,).

    Differentiable. CUDA tensors of a shape ``out_shape_error`` admits
    launch the kernel; CPU tensors, a shape it refuses, or ``kernels=False``
    take ``out_plain``.
    """
    G, N, D = res.shape
    kernels = kernels and out_shape_error(G, N, D, a5.shape[1], a5.shape[-1], P,
                                          is_global) is None
    return _AttnOut.apply(a5, res, w, b, P, is_global, kernels)
