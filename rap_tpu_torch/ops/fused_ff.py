"""Fused LayerNorm + GEGLU feed-forward with the residual: one C entry point each way.

Counterpart of rap_tpu/ops/fused_ff.py ``geglu_ff`` (:288): x + FF(LN(x))
with LN(scale, bias), proj = h @ wi + bi split into (hidden | gate), act =
hidden * gelu(gate) with the exact erf, y = act @ wo + bo. The kernels are
csrc/ff.cu (TPU ``_ff_kernel``, fused_ff.py:55: a LayerNorm row pass and two
TMA + wgmma products, csrc/gemm_sm90.cuh); ``ff_plain`` repeats their
arithmetic and cast points in plain PyTorch (exact GELU): products sum bf16
inputs in fp32, act is rounded to the compute dtype before the second
product, the output is x + y in that dtype.

``geglu_ff`` dispatches as rap_tpu does between the kernel and the plain
composition ``ff_reference`` (``_xla_reference``). The kernel route is a
``torch.autograd.Function``; its backward is csrc/ff_bwd.cu
(TPU ``_ff_bwd_kernel``, fused_ff.py:121), twin ``ff_bwd_plain``: it
recomputes the forward with the exact-erf GELU and its derivative
(``_gelu_grad_terms`` :114), with the in-projection bias in fp32 as the TPU
backward takes it (:251), and returns every weight gradient in fp32.

Both kernels take exactly the shapes rap_tpu's ``legal`` rule admits
(``ff_shape_error``), and refuse any other before a launch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ._common import check_input, launch, on_cpu, require, require_aligned

_TILE = 128  # rows and columns of an output tile of csrc/gemm_sm90.cuh
_SLAB = 64   # k slab of csrc/gemm_sm90.cuh; ln_grad_kernel's rows per block
_BLOCKS_PER_SM = 2  # csrc/gemm_sm90.cuh BLOCKS_PER_SM: the GEMM's blocks on one SM
_MAX_SPLITS = 8


def _ln_stats(xf):
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + 1e-5)
    return (xf - mu) * rstd, rstd


def ff_plain(x, ln_scale, ln_bias, wi, bi, wo, bo):
    dt = x.dtype
    fh = wo.shape[0]
    h = (_ln_stats(x.float())[0] * ln_scale.float() + ln_bias.float()).to(dt)
    proj = h.float() @ wi.float() + bi.to(dt).float()
    act = proj[..., :fh] * F.gelu(proj[..., fh:], approximate="none")
    y = act.to(dt).float() @ wo.float() + bo.to(dt).float()
    return x + y.to(dt)


def ff_shape_error(T: int, D: int, fh: int) -> str | None:
    """Why csrc/ff.cu and csrc/ff_bwd.cu refuse T tokens of width D with
    hidden width fh, or None where they take them. They take exactly what
    rap_tpu's ``legal`` rule (fused_ff.py:312) admits: D and 2*fh multiples of
    128, and a token count that a block of 512, 1024, 256 or 128 divides, i.e.
    T % 128 == 0. That is 128-token tiles, 128-column tiles of D and of
    [hidden | gate], 64-deep k slabs, and 64-token blocks of the reductions."""
    if D % 128 != 0:
        return f"ff kernels take a width D that is a multiple of 128, got {D}"
    if (2 * fh) % 128 != 0:
        return f"ff kernels take a hidden width that is a multiple of 64, got {fh}"
    if T % _TILE != 0:
        return f"ff kernels take a token count that is a multiple of 128, got {T}"
    return None


def _require_shape(T: int, D: int, fh: int) -> None:
    err = ff_shape_error(T, D, fh)
    require(err is None, err or "")


def wgrad_splits(tiles: int, nslab: int, slots: int) -> int:
    """Token splits of a weight gradient's product (csrc/ff_bwd.cu): the
    fewest splits, at most 8 and each of at least 4 slabs of 64 tokens, whose
    units (tiles x splits, all of one size) fill at least 85% of the waves
    of ``slots`` resident blocks; else the split count that fills the most."""
    best, best_fill = 1, 0.0
    for s in range(1, _MAX_SPLITS + 1):
        if s > 1 and nslab // s < 4:
            break
        units = tiles * s
        fill = units / (math.ceil(units / slots) * slots)
        if fill >= 0.85:
            return s
        if fill > best_fill:
            best, best_fill = s, fill
    return best


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def ff_kernel(x2, ln_scale, ln_bias, wi, bi, wo, bo):
    """Launch csrc/ff.cu on CUDA tensors; x2 is (T, D) tokens."""
    T, D = x2.shape
    fh = wo.shape[0]
    _require_shape(T, D, fh)
    check_input("x", x2, torch.bfloat16, (T, D))
    check_input("ln_scale", ln_scale, torch.float32, (D,))
    check_input("ln_bias", ln_bias, torch.float32, (D,))
    check_input("wi", wi, torch.bfloat16, (D, 2 * fh))
    check_input("bi", bi, torch.bfloat16, (2 * fh,))
    check_input("wo", wo, torch.bfloat16, (fh, D))
    check_input("bo", bo, torch.bfloat16, (D,))
    require_aligned("ff kernels", x=x2, wi=wi, wo=wo)
    yln = torch.empty((T, D), dtype=torch.bfloat16, device=x2.device)
    act = torch.empty((T, fh), dtype=torch.bfloat16, device=x2.device)
    out = torch.empty_like(x2)
    launch(
        "ff", x2,
        x2.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), wi.data_ptr(),
        bi.data_ptr(), wo.data_ptr(), bo.data_ptr(), yln.data_ptr(), act.data_ptr(),
        out.data_ptr(), T, D, fh,
    )
    return out


def ff_bwd_plain(x, g, ln_scale, ln_bias, wi, bi, wo):
    """Plain version of the ff backward kernel on x, g (..., D): (dx in x's
    dtype, dws, dwb, dwi, dbi, dwo, dbo in fp32)."""
    dt = x.dtype
    D, fh = x.shape[-1], wo.shape[0]
    gf = g.reshape(-1, D).to(dt).float()
    xhat, rstd = _ln_stats(x.reshape(-1, D).float())
    yln = (xhat * ln_scale.float() + ln_bias.float()).to(dt).float()
    proj = yln @ wi.to(dt).float() + bi.float()
    hidden, gate = proj[:, :fh], proj[:, fh:]
    Phi = 0.5 * (1.0 + torch.erf(gate * 0.7071067811865476))
    gelu = gate * Phi
    dgelu = Phi + gate * torch.exp(-0.5 * gate * gate) * 0.3989422804014327
    dact = gf @ wo.to(dt).float().transpose(0, 1)
    dwo = (hidden * gelu).to(dt).float().transpose(0, 1) @ gf
    dproj = torch.cat([dact * gelu, dact * hidden * dgelu], dim=-1)
    dproj_dt = dproj.to(dt).float()
    dwi = yln.transpose(0, 1) @ dproj_dt
    dyln = dproj_dt @ wi.to(dt).float().transpose(0, 1)
    dxhat = dyln * ln_scale.float()
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = (gf + rstd * (dxhat - m1 - xhat * m2)).to(dt).reshape(x.shape)
    return (dx, (dyln * xhat).sum(0), dyln.sum(0), dwi, dproj.sum(0), dwo,
            gf.sum(0))


def ff_bwd_kernel(x2, g2, ln_scale, ln_bias, wi, bi, wo):
    """Launch csrc/ff_bwd.cu on CUDA tensors; x2, g2 are (T, D) tokens.
    Returns what ``ff_bwd_plain`` returns."""
    T, D = x2.shape
    fh = wo.shape[0]
    _require_shape(T, D, fh)
    check_input("x", x2, torch.bfloat16, (T, D))
    check_input("g", g2, torch.bfloat16, (T, D))
    check_input("ln_scale", ln_scale, torch.float32, (D,))
    check_input("ln_bias", ln_bias, torch.float32, (D,))
    check_input("wi", wi, torch.bfloat16, (D, 2 * fh))
    check_input("bi", bi, torch.float32, (2 * fh,))
    check_input("wo", wo, torch.bfloat16, (fh, D))
    require_aligned("ff kernels", x=x2, g=g2, wi=wi, wo=wo)
    bf = dict(dtype=torch.bfloat16, device=x2.device)
    f32 = dict(dtype=torch.float32, device=x2.device)
    slots = _BLOCKS_PER_SM * _sm_count(x2.device)
    nslab = T // _SLAB
    splits_wo = wgrad_splits(math.ceil(fh / _TILE) * (D // _TILE), nslab, slots)
    splits_wi = wgrad_splits((D // _TILE) * (2 * fh // _TILE), nslab, slots)
    wpart = max((s * n for s, n in ((splits_wo, fh * D), (splits_wi, D * 2 * fh)) if s > 1),
                default=4)
    yln, act = torch.empty((T, D), **bf), torch.empty((T, fh), **bf)
    dproj, dyln = torch.empty((T, 2 * fh), **bf), torch.empty((T, D), **f32)
    dbi_part = torch.empty((nslab, 2 * fh), **f32)
    ln_part = torch.empty((nslab, 3 * D), **f32)
    wpart = torch.empty((wpart,), **f32)
    dx = torch.empty_like(x2)
    dwi, dbi = torch.empty((D, 2 * fh), **f32), torch.empty((2 * fh,), **f32)
    dwo, sums = torch.empty((fh, D), **f32), torch.empty((3, D), **f32)
    launch(
        "ff_bwd", x2,
        x2.data_ptr(), g2.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
        wi.data_ptr(), bi.data_ptr(), wo.data_ptr(), yln.data_ptr(), act.data_ptr(),
        dproj.data_ptr(), dyln.data_ptr(), dbi_part.data_ptr(), ln_part.data_ptr(),
        wpart.data_ptr(), dx.data_ptr(), dwi.data_ptr(), dbi.data_ptr(), dwo.data_ptr(),
        sums.data_ptr(), T, D, fh, splits_wo, splits_wi,
    )
    dws, dwb, dbo = sums.unbind(0)
    return dx, dws, dwb, dwi, dbi, dwo, dbo


class _GegluFF(torch.autograd.Function):
    """Counterpart of ``_fused`` (fused_ff.py:258-285)."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, wi, bi, wo, bo, kernels: bool):
        args = (x, ln_scale, ln_bias, wi, bi, wo, bo)
        ctx.save_for_backward(*args)
        ctx.use_kernel = kernels and not on_cpu(*args)
        if not ctx.use_kernel:
            return ff_plain(*args)
        dt = x.dtype
        D = x.shape[-1]
        out = ff_kernel(
            x.reshape(-1, D), ln_scale.float().contiguous(),
            ln_bias.float().contiguous(), wi.to(dt).contiguous(),
            bi.to(dt).contiguous(), wo.to(dt).contiguous(), bo.to(dt).contiguous(),
        )
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        x, ln_scale, ln_bias, wi, bi, wo, bo = ctx.saved_tensors
        if ctx.use_kernel:
            dt = x.dtype
            D = x.shape[-1]
            grads = ff_bwd_kernel(
                x.reshape(-1, D), g.to(dt).reshape(-1, D).contiguous(),
                ln_scale.float().contiguous(), ln_bias.float().contiguous(),
                wi.to(dt).contiguous(), bi.float().contiguous(),
                wo.to(dt).contiguous(),
            )
        else:
            grads = ff_bwd_plain(x, g, ln_scale, ln_bias, wi, bi, wo)
        dx, dws, dwb, dwi, dbi, dwo, dbo = grads
        return (dx.reshape(x.shape), dws.to(ln_scale.dtype), dwb.to(ln_bias.dtype),
                dwi.to(wi.dtype), dbi.to(bi.dtype), dwo.to(wo.dtype), dbo.to(bo.dtype),
                None)


def ff_reference(x, ln_scale, ln_bias, wi, bi, wo, bo):
    """x + FF(LN(x)) as the composition rap_tpu runs where its fused kernel
    does not apply (``_xla_reference``, fused_ff.py:71), cast points
    included: h, proj and act in x's dtype, GELU in fp32. Differentiated by
    autograd."""
    dt = x.dtype
    fh = wo.shape[0]
    h = (_ln_stats(x.float())[0] * ln_scale.float() + ln_bias.float()).to(dt)
    proj = h @ wi.to(dt) + bi.to(dt)
    act = proj[..., :fh] * F.gelu(proj[..., fh:].float(), approximate="none").to(dt)
    return x + (act @ wo.to(dt) + bo.to(dt))


def geglu_ff(x, ln_scale, ln_bias, wi, bi, wo, bo, impl: str = "auto",
             kernels: bool = True):
    """x (..., D) + FF(LN(x)); wi (D, 2*FH) = (hidden | gate), wo (FH, D).

    Dispatch as rap_tpu's ``geglu_ff`` (:305-320) on its accelerator: the
    fused kernel where its ``legal`` rule holds (D and 2*FH multiples of 128,
    the token count a multiple of a block of 128-1024) or ``impl="pallas"``,
    else ``ff_reference``. Differentiable. On the kernel route CUDA tensors
    launch the kernels forward and backward; CPU tensors, or
    ``kernels=False``, take the plain versions.
    """
    D, fh = x.shape[-1], wo.shape[0]
    T = x.numel() // D
    legal = ff_shape_error(T, D, fh) is None
    if not (impl == "pallas" or (impl == "auto" and legal)):
        return ff_reference(x, ln_scale, ln_bias, wi, bi, wo, bo)
    return _GegluFF.apply(x, ln_scale, ln_bias, wi, bi, wo, bo, kernels)
