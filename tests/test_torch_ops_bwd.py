"""The port's backward twins against rap_tpu's Pallas backward kernels (CPU).

Each rap_tpu op is differentiated with ``jax.vjp`` through its custom_vjp,
whose backward runs the Pallas kernel in interpret mode (impl="pallas",
interpret=True); the port's op is differentiated with torch.autograd
through its autograd.Function, whose backward takes the plain twin for CPU
tensors. Same inputs and cotangents, made with numpy from a seed. Tiny
shapes (D=128, H=2, dh=64, N=128), fp32: tolerance 2e-5 of the largest
gradient element, fp32 sums in another order.

rap_tpu's attention takes va = [v | 1] and gives its ones column a zero
cotangent; the port's takes v: its dv is compared with rap_tpu's dva
without that column, and the projection's dv reaches rap_tpu as dva with a
zero column.

Each twin is also held against torch.autograd of the port's own plain
forward: at fp32 within 2e-5, and once in bf16 within 3e-2 of the largest
element (the twins round p, ds, dy and dproj to bf16 where the TPU kernels
do; autograd of the plain forward rounds elsewhere).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rap_tpu.ops import fused_ff as jff
from rap_tpu.ops import fused_proj as jfp
from rap_tpu.ops import pallas_attention as jpa
from rap_tpu_torch.ops import flash_attention as fa
from rap_tpu_torch.ops import fused_ff, fused_proj
from torch_parity import max_err, t

D, H, DH, N, S, P = 128, 2, 64, 128, 2, 2
G = S * P
RTOL = 2e-5
RTOL_BF16 = 3e-2


def _close(got, ref, rtol=RTOL, what=""):
    ref = np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = max_err(np.asarray(got.detach().float() if torch.is_tensor(got) else got), ref)
    assert err <= rtol * scale, f"{what}: max err {err:.3e} > {rtol:.0e} * {scale:.3e}"


def _rng_f32(seed):
    rng = np.random.default_rng(seed)
    return lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731


def _grads(fn, inputs, cot):
    """torch.autograd of fn(*inputs) against the cotangent(s) ``cot``."""
    leaves = [t(a).requires_grad_(True) for a in inputs]
    out = fn(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    cots = cot if isinstance(cot, tuple) else (cot,)
    return torch.autograd.grad(outs, leaves, [t(c) for c in cots])


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def _attention_inputs(gain, seed=0, BH=4, T=256):
    f = _rng_f32(seed)
    q, k = f(BH, T, DH), f(BH, T, DH)
    # rows of norm gain*log2(e) and gain*sqrt(dh), as the proj kernel emits
    q = q / np.linalg.norm(q, axis=-1, keepdims=True) * gain * math.log2(math.e)
    k = k / np.linalg.norm(k, axis=-1, keepdims=True) * gain * math.sqrt(DH)
    bound2 = math.log2(math.e) * math.sqrt(DH) * gain * gain
    return q, k, f(BH, T, DH), bound2, f(BH, T, DH)


def _with_column(a, value):
    """a with one more column of ``value``: rap_tpu's va = [v | 1], or its
    cotangent [dv | 0]."""
    return np.concatenate([a, np.full(a.shape[:-1] + (1,), value, np.float32)], -1)


def _attention_vjp_pair(q, k, v, bound2, dout):
    """(rap_tpu's grads, the port's) of no-padding attention: rap_tpu's
    dva = [dv | 0] checked and cut to dv."""
    _, vjp = jax.vjp(lambda a, b, c: jpa.flash_attention_headmajor(
        a, b, c, jnp.float32(bound2), interpret=True),
        *map(jnp.asarray, (q, k, _with_column(v, 1.0))))
    dq, dk, dva = vjp(jnp.asarray(dout))
    assert float(np.abs(np.asarray(dva)[..., DH]).max()) == 0.0  # ones column: zero cotangent
    got = _grads(lambda a, b, c: fa.flash_attention_headmajor(a, b, c, bound2),
                 (q, k, v), dout)
    return (dq, dk, np.asarray(dva)[..., :DH]), got


@pytest.mark.parametrize("gain", [1.0, 3.0], ids=["fixed_bound", "online"])
def test_attention_backward_matches_pallas(gain):
    """Behind the fixed-bound forward (bound2 ~ 11.5) and the online one
    (bound2 ~ 104 > SAFE_BOUND2): the shared backward reads either lse2."""
    q, k, v, bound2, dout = _attention_inputs(gain)
    assert (bound2 > fa.SAFE_BOUND2) == (gain > 1.0)
    ref, got = _attention_vjp_pair(q, k, v, bound2, dout)
    for name, g_, r_ in zip(("dq", "dk", "dv"), got, ref):
        _close(g_, r_, what=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("gain", [1.0, 3.0], ids=["fixed_bound", "online"])
def test_attention_twin_matches_autograd(gain, dtype):
    """flash_bwd_plain against autograd of the plain softmax attention (the
    base-2 logits q.k times ln2 in natural units)."""
    q, k, v, bound2, dout = _attention_inputs(gain, seed=1)
    fwd = fa.flash_fixed_plain if bound2 <= fa.SAFE_BOUND2 else fa.flash_online_plain
    tq, tk, tv, tdo = (t(a).to(dtype) for a in (q, k, v, dout))
    out, lse = fwd(tq, tk, tv, bound2) if fwd is fa.flash_fixed_plain else fwd(tq, tk, tv)
    got = fa.flash_bwd_plain(tq, tk, tv, out, lse, tdo)
    ref = _grads(lambda a, b, c: torch.softmax(a @ b.transpose(-1, -2) * math.log(2.0), -1) @ c,
                 (tq.float().numpy(), tk.float().numpy(), tv.float().numpy()),
                 tdo.float().numpy())
    rtol = RTOL if dtype == torch.float32 else RTOL_BF16
    for name, g_, r_ in zip(("dq", "dk", "dv"), got, ref):
        assert g_.dtype == dtype
        _close(g_, r_.numpy(), rtol, name)


def test_attention_backward_raises_beyond_the_dq_slab(monkeypatch):
    """The port used to raise where rap_tpu's dispatch takes the split
    backward (dQ partials slab over 2 GiB); now it takes the split passes
    there, rows 7-8, and they agree with rap_tpu's split backward (cap
    lowered on both sides so that the tiny shape is past it)."""
    assert fa.fused_backward_slab_bytes(32, 8192, 8192, 64) == 512 * 2**20
    assert fa.fused_backward_slab_bytes(64, 4096, 4096, 64) == 256 * 2**20
    assert fa.fused_backward_slab_bytes(16, 32768, 32768, 64) == 4 * 2**30  # S=2 x 8 x 4096
    calls = []
    for name in ("flash_bwd_plain", "flash_bwd_dkv_plain", "flash_bwd_dq_plain"):
        real = getattr(fa, name)
        monkeypatch.setattr(fa, name, lambda *a, _r=real, _n=name: calls.append(_n) or _r(*a))
    monkeypatch.setattr(fa, "_FUSED_DQ_PARTIALS_CAP", 0)
    monkeypatch.setattr(jpa, "_FUSED_DQ_PARTIALS_CAP", 0)
    jax.clear_caches()
    q, k, v, bound2, dout = _attention_inputs(3.0, seed=3)
    ref, got = _attention_vjp_pair(q, k, v, bound2, dout)
    jax.clear_caches()
    assert calls == ["flash_bwd_dkv_plain", "flash_bwd_dq_plain"]
    for name, g_, r_ in zip(("dq", "dk", "dv"), got, ref):
        _close(g_, r_, what=name)


# --------------------------------------------------------------------------
# AdaLN + QKV projection, attention out-projection
# --------------------------------------------------------------------------

def _proj_inputs(seed=0, width=D, heads=H):
    f = _rng_f32(seed)
    dh = width // heads
    return (f(G, N, width), f(G, 2 * width, sc=0.2), f(width, 3 * width, sc=width ** -0.5),
            1 + f(heads, dh, sc=0.1), 1 + f(heads, dh, sc=0.1))


def _proj_cotangents(is_global, seed=5, heads=H, dh=DH):
    """(dq, dk, dv) of the port's (q, k, v)."""
    f = _rng_f32(seed)
    lead = (S, heads, P, N) if is_global else (G, heads, N)
    return f(*lead, dh), f(*lead, dh), f(*lead, dh)


# (D, H): the model's width and heads (dh = 64), two heads a GEMM tile of
# csrc/proj_bwd.cu (dh = 32) and one head over a tile (dh = 96)
_PROJ_BWD_WIDTHS = [(512, 8), (256, 8), (384, 4)]


@pytest.mark.parametrize("width,heads", _PROJ_BWD_WIDTHS, ids=["dh64", "dh32", "dh96"])
@pytest.mark.parametrize("is_global", [False, True], ids=["part", "global"])
def test_proj_backward_matches_pallas(is_global, width, heads):
    """rap_tpu's backward here is its Pallas kernel ``_proj_bwd_kernel`` in
    interpret mode in every case: N = 128 gives its ``bblock`` rule
    (fused_proj.py:402-403) a block of 128 and D % 128 == 0, so it never
    takes its XLA vjp."""
    inputs = _proj_inputs(width=width, heads=heads)
    cots = _proj_cotangents(is_global, heads=heads, dh=width // heads)
    _, vjp = jax.vjp(lambda *a: jfp.adaln_qkv(*a, P=P, is_global=is_global, impl="pallas",
                                              interpret=True), *map(jnp.asarray, inputs))
    # rap_tpu's va = [v | 1]: its ones column gets a zero cotangent from attention
    ref = vjp(tuple(map(jnp.asarray, (*cots[:2], _with_column(cots[2], 0.0)))))
    got = _grads(lambda *a: fused_proj.adaln_qkv(*a, P=P, is_global=is_global), inputs,
                 cots)
    for name, g_, r_ in zip(("dx", "dada", "dw", "dgamma_q", "dgamma_k"), got, ref):
        assert tuple(g_.shape) == r_.shape, name
        _close(g_, r_, what=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("is_global", [False, True], ids=["part", "global"])
def test_proj_twin_matches_autograd(is_global, dtype):
    x, ada, w, gq, gk = _proj_inputs(1)
    gq_eff, gk_eff = (a.numpy() for a in fused_proj.fold_gains(t(gq), t(gk)))
    cots = _proj_cotangents(is_global, seed=6)
    got = fused_proj.proj_bwd_plain(t(x).to(dtype), t(ada), t(w), t(gq_eff), t(gk_eff),
                                    *(t(c).to(dtype) for c in cots), P, is_global)
    ref = _grads(lambda *a: fused_proj.proj_plain(*a, P, is_global),
                 (t(x).to(dtype).float().numpy(), ada, t(w).to(dtype).float().numpy(),
                  gq_eff, gk_eff),
                 tuple(t(c).to(dtype).float().numpy() for c in cots))
    rtol = RTOL if dtype == torch.float32 else RTOL_BF16
    for name, g_, r_ in zip(("dx", "dada", "dw", "dgq", "dgk"), got, ref):
        _close(g_, r_.numpy(), rtol, name)


@pytest.mark.parametrize("is_global", [False, True], ids=["part", "global"])
def test_attn_out_backward_matches_jax(is_global):
    f = _rng_f32(2)
    shape = (S, H, P, N, DH) if is_global else (G, H, N, DH)
    inputs = (f(*shape), f(G, N, D), f(D, D, sc=D ** -0.5), f(D, sc=0.1))
    cot = f(G, N, D)
    _, vjp = jax.vjp(lambda *a: jfp.attn_out(*a, P=P, is_global=is_global, impl="pallas",
                                             interpret=True), *map(jnp.asarray, inputs))
    ref = vjp(jnp.asarray(cot))
    got = _grads(lambda *a: fused_proj.attn_out(*a, P=P, is_global=is_global), inputs, cot)
    for name, g_, r_ in zip(("da5", "dres", "dw", "db"), got, ref):
        _close(g_, r_, what=name)


# --------------------------------------------------------------------------
# GEGLU feed-forward
# --------------------------------------------------------------------------

def _ff_inputs(seed=0, lead=(G, N), width=D):
    f = _rng_f32(seed)
    return (f(*lead, width), 1 + f(width, sc=0.1), f(width, sc=0.1),
            f(width, 8 * width, sc=width ** -0.5), f(8 * width, sc=0.1),
            f(4 * width, width, sc=(4 * width) ** -0.5), f(width, sc=0.1))


def _ff_backward_case(inputs, cot):
    _, vjp = jax.vjp(lambda *a: jff.geglu_ff(*a, impl="pallas", interpret=True),
                     *map(jnp.asarray, inputs))
    ref = vjp(jnp.asarray(cot))
    got = _grads(fused_ff.geglu_ff, inputs, cot)
    for name, g_, r_ in zip(("dx", "dws", "dwb", "dwi", "dbi", "dwo", "dbo"), got, ref):
        assert tuple(g_.shape) == r_.shape, name
        _close(g_, r_, what=name)


def test_ff_backward_matches_pallas():
    _ff_backward_case(_ff_inputs(), _rng_f32(7)(G, N, D))


@pytest.mark.parametrize("width", [256, 512, 768])
def test_ff_backward_widths_match_pallas(width):
    """The FF backward at the widths of models the kernels take beside D =
    512 (hidden 4 D), 2e-5 as above."""
    _ff_backward_case(_ff_inputs(3, width=width), _rng_f32(9)(G, N, width))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_ff_twin_matches_autograd(dtype):
    x, ws, wb, wi, bi, wo, bo = _ff_inputs(1, lead=(256,))
    g = _rng_f32(8)(256, D)
    xd, gd, wid, wod = (t(a).to(dtype) for a in (x, g, wi, wo))
    # the twin's in-projection bias is fp32 (as the TPU backward takes it)
    got = fused_ff.ff_bwd_plain(xd, gd, t(ws), t(wb), wid, t(bi), wod)
    ref = _grads(fused_ff.ff_plain,
                 (xd.float().numpy(), ws, wb, wid.float().numpy(), bi,
                  wod.float().numpy(), bo), gd.float().numpy())
    rtol = RTOL if dtype == torch.float32 else RTOL_BF16
    for name, g_, r_ in zip(("dx", "dws", "dwb", "dwi", "dbi", "dwo", "dbo"), got, ref):
        assert g_.dtype == (dtype if name == "dx" else torch.float32), name
        _close(g_, r_.numpy(), rtol, name)
