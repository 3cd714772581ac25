"""Attention at head widths other than 64, through the kernels' zero-padding.

The attention kernels of rap_tpu_torch are 64 or 128 wide in their heads;
the launchers take heads of 8 <= d <= 128, d % 8 == 0 (the fixed-bound
forward d < 128), by padding q, k, V and dO with zero columns to the
kernel's width (``flash_attention.kernel_width``: 64 for d <= 64, 128
above) and keeping the first d columns of out, dq, dk and dv
(``head_columns``). On the CPU the plain twins stand in for the kernels
(they repeat the kernels' arithmetic): each twin through the padding must
equal the twin on the unpadded heads, forward (fixed-bound, online with a
key mask) and backward (fused, and the split dKV and dQ passes).
Tolerance: 1e-5 of the largest output; the padded columns add exact zeros,
and only the order of the fp32 sums may differ. The launchers pass every
such width on to a launch at the kernel's width and refuse others before
any launch.
"""

import numpy as np
import pytest
import torch

from rap_tpu_torch.ops import flash_attention as fa

BH, HEADS, T = 4, 2, 256
RTOL = 1e-5


def _close(got, ref):
    scale = max(float(ref.abs().max()), 1e-30)
    err = float((got - ref).abs().max())
    assert err <= RTOL * scale, f"max err {err:.3e} > {RTOL:.1e} * {scale:.3e}"


def _operands(d, seed=0):
    """Pre-scaled q, k (rows of norm ~3, so the logits span ~9 in base 2), v,
    dO, and a key mask that leaves one sequence empty."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    q, k = f(BH, T, d) * (3 / d ** 0.5), f(BH, T, d) * (3 / d ** 0.5)
    v = f(BH, T, d)
    mask = torch.from_numpy(rng.random((BH // HEADS, T)) > 0.3)
    mask[1] = False
    return q, k, v, f(BH, T, d), mask


@pytest.mark.parametrize("d", [8, 32, 56, 72, 96, 120])
def test_forward_twins_through_the_padding(d):
    q, k, v, _, mask = _operands(d)
    qp, kp, vp = fa.kernel_width(q, k, v)
    assert qp.shape[-1] == kp.shape[-1] == vp.shape[-1] == (64 if d <= 64 else 128)
    for run in (lambda q_, k_, v_: fa.flash_fixed_plain(q_, k_, v_, 12.0),
                lambda q_, k_, v_: fa.flash_online_plain(q_, k_, v_, mask, HEADS)):
        out, lse = run(q, k, v)
        out_p, lse_p = run(qp, kp, vp)
        assert not out_p[..., d:].any()  # the padded columns of out are zero
        _close(fa.head_columns(out_p, d), out)
        live = lse < fa.LSE_EMPTY
        _close(lse_p[live], lse[live])
        assert torch.equal(lse_p[~live], lse[~live])


@pytest.mark.parametrize("d", [8, 32, 56, 72, 96, 120, 128])
def test_backward_twins_through_the_padding(d):
    q, k, v, dout, mask = _operands(d, seed=1)
    qp, kp, vp, dop = fa.kernel_width(q, k, v, dout)
    out, lse = fa.flash_online_plain(q, k, v, mask, HEADS)
    (out_p,) = fa.kernel_width(out)
    # the fused backward
    got = fa.flash_bwd_plain(qp, kp, vp, out_p, lse, dop, mask, HEADS)
    ref = fa.flash_bwd_plain(q, k, v, out, lse, dout, mask, HEADS)
    for g_, r_ in zip(got, ref):
        assert g_.shape[-1] == fa.padded_width(d)
        _close(fa.head_columns(g_, d), r_)
    # the split passes, on dO padded and one -delta
    nd = fa._neg_delta(dout, out)
    dk, dv = fa.flash_bwd_dkv_plain(q, k, v, dout, nd, lse, mask, HEADS)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(qp, kp, vp, dop, nd, lse, mask, HEADS)
    _close(fa.head_columns(dk_p, d), dk)
    _close(fa.head_columns(dv_p, d), dv)
    dq = fa.flash_bwd_dq_plain(q, k, v, dout, nd, lse, mask, HEADS)
    _close(fa.head_columns(fa.flash_bwd_dq_plain(qp, kp, vp, dop, nd, lse, mask, HEADS), d), dq)


def test_kernels_take_narrow_heads_and_refuse_others(monkeypatch):
    """The forward launchers pass heads of d = 32 and d = 96 on to a launch,
    padded to 64 and 128 (the kernel's width is the launch's last integer);
    d = 60 (not a multiple of 8) and d = 128 (wider than the kernels) are
    refused before any launch."""
    launched = []
    monkeypatch.setattr(fa, "launch", lambda kernel, *a: launched.append((kernel, a[-1])))
    bf = dict(dtype=torch.bfloat16)
    for d in (32, 60, 96, 128):
        q = torch.zeros(BH, 128, d, **bf)
        if d in (32, 96):
            out, lse = fa.flash_fixed_kernel(q, q, q, 1.0)
            assert out.shape == q.shape and out.is_contiguous()
        else:
            with pytest.raises(ValueError, match="head width below 128 that is a multiple of 8"):
                fa.flash_fixed_kernel(q, q, q, 1.0)
    assert launched == [("flash_fixed", 64), ("flash_fixed", 128)]


@pytest.mark.parametrize("d", [72, 96, 120])
def test_backward_launchers_refuse_wide_heads(monkeypatch, d):
    """Every backward launcher (the fused pass, the split dKV and dQ passes,
    and attention_backward's split branch, which computes -delta once)
    passes heads of 64 < d <= 128 on to a launch at the kernels' 128-wide
    instantiation (the launch's last integer), d = 128 as well; it refuses
    d = 136 (wider than the kernels) and d + 4 (not a multiple of 8) before
    any launch. The online forward takes the same heads."""
    launched = []
    monkeypatch.setattr(fa, "launch", lambda kernel, *a: launched.append((kernel, a[-1])))
    monkeypatch.setattr(fa, "on_cpu", lambda *a: False)  # as CUDA tensors are
    bf = dict(dtype=torch.bfloat16)

    def calls(w):
        q = torch.zeros(BH, 128, w, **bf)
        nd, lse = torch.zeros(BH, 128), torch.zeros(BH, 128)
        return (lambda: fa.flash_bwd_kernel(q, q, q, q, lse, q),
                lambda: fa.flash_bwd_dkv_kernel(q, q, q, q, nd, lse),
                lambda: fa.flash_bwd_dq_kernel(q, q, q, q, nd, lse),
                lambda: fa.attention_backward(q, q, q, q, lse, q, None, 1, True, True),
                lambda: fa.flash_online_kernel(q, q, q))

    for w in (d, 128):
        for call in calls(w):
            call()
    one = [("flash_bwd", 128), ("flash_bwd_dkv", 128), ("flash_bwd_dq", 128),
           ("flash_bwd_dkv", 128), ("flash_bwd_dq", 128), ("flash_online", 128)]
    assert launched == one * 2
    for w in (136, d + 4):
        for call in calls(w):
            with pytest.raises(ValueError, match="head width of at most 128 that is a "
                                                 "multiple of 8"):
                call()
    assert launched == one * 2
