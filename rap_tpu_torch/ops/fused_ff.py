"""Fused LayerNorm + GEGLU feed-forward with the residual, one kernel.

Counterpart of rap_tpu/ops/fused_ff.py ``geglu_ff`` (:288): x + FF(LN(x))
with LN(scale, bias), proj = h @ wi + bi split into (hidden | gate), act =
hidden * gelu(gate) with the exact erf, y = act @ wo + bo. The kernel is
csrc/ff.cu (TPU ``_ff_kernel``, fused_ff.py:55); ``ff_plain`` repeats its
arithmetic and cast points in plain PyTorch (the role of ``_xla_reference``
:71, exact GELU): products sum bf16 inputs in fp32, act is rounded to the
compute dtype before the second product, the output is x + y in that dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from ._common import LAUNCHES, check_input, on_cpu, require, stream_of

_FF_TOKENS = 32  # csrc/ff.cu BM


def ff_plain(x, ln_scale, ln_bias, wi, bi, wo, bo):
    dt = x.dtype
    fh = wo.shape[0]
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    h = ((xf - mu) * torch.rsqrt(var + 1e-5) * ln_scale.float()
         + ln_bias.float()).to(dt)
    proj = h.float() @ wi.float() + bi.to(dt).float()
    act = proj[..., :fh] * F.gelu(proj[..., fh:], approximate="none")
    y = act.to(dt).float() @ wo.float() + bo.to(dt).float()
    return x + y.to(dt)


def ff_kernel(x2, ln_scale, ln_bias, wi, bi, wo, bo):
    """Launch csrc/ff.cu on CUDA tensors; x2 is (T, D) tokens."""
    T, D = x2.shape
    fh = wo.shape[0]
    require(D == 512, f"ff kernel is built for D=512, got {D}")
    require(fh % 64 == 0, f"ff kernel takes a hidden width that is a multiple of 64, got {fh}")
    require(T % _FF_TOKENS == 0, f"ff kernel takes a token count that is a multiple of 32, got {T}")
    check_input("x", x2, torch.bfloat16, (T, D))
    check_input("ln_scale", ln_scale, torch.float32, (D,))
    check_input("ln_bias", ln_bias, torch.float32, (D,))
    check_input("wi", wi, torch.bfloat16, (D, 2 * fh))
    check_input("bi", bi, torch.bfloat16, (2 * fh,))
    check_input("wo", wo, torch.bfloat16, (fh, D))
    check_input("bo", bo, torch.bfloat16, (D,))
    out = torch.empty_like(x2)
    err = _build.load().lib.rtt_ff(
        x2.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), wi.data_ptr(),
        bi.data_ptr(), wo.data_ptr(), bo.data_ptr(), out.data_ptr(),
        T, D, fh, stream_of(x2),
    )
    _build.check(err, "ff kernel")
    LAUNCHES["ff"] += 1
    return out


def geglu_ff(x, ln_scale, ln_bias, wi, bi, wo, bo):
    """x (..., D) + FF(LN(x)); wi (D, 2*FH) = (hidden | gate), wo (FH, D).

    CPU tensors take ``ff_plain``; CUDA tensors launch the kernel.
    """
    if on_cpu(x, ln_scale, ln_bias, wi, bi, wo, bo):
        return ff_plain(x, ln_scale, ln_bias, wi, bi, wo, bo)
    dt = x.dtype
    D = x.shape[-1]
    out = ff_kernel(
        x.reshape(-1, D), ln_scale.float().contiguous(),
        ln_bias.float().contiguous(), wi.to(dt).contiguous(),
        bi.to(dt).contiguous(), wo.to(dt).contiguous(), bo.to(dt).contiguous(),
    )
    return out.reshape(x.shape)
