"""The port's kernel modules against rap_tpu's Pallas kernels on the CPU.

Each rap_tpu op runs its Pallas kernel in interpret mode (impl="pallas",
interpret=True), as tests/test_model.py runs the kernels on the CPU; each
port op runs its plain version, which is what its wrapper takes for CPU
tensors. Tiny shapes: D=128, H=2, dh=64, N=128, fp32. Tolerance: 2e-5
relative to the largest output, fp32 sums taken in another order.
"""

import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rap_tpu.ops import fused_ff as jff
from rap_tpu.ops import fused_proj as jfp
from rap_tpu.ops import pallas_attention as jpa
from rap_tpu_torch.ops import flash_attention as fa
from rap_tpu_torch.ops import fused_ff, fused_proj
from rap_tpu_torch.ops import launch_counts, reset_launches
from torch_parity import max_err, t

D, H, DH, N, S, P = 128, 2, 64, 128, 2, 2
G = S * P
RTOL = 2e-5


def _close(got, ref, rtol=RTOL):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = max_err(got, ref)
    assert err <= rtol * scale, f"max err {err:.3e} > {rtol:.1e} * {scale:.3e}"


def _inputs(seed=0, gain=1.0):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    return {
        "x": f(G, N, D),
        "ada": f(G, 2 * D, sc=0.2),
        "w": f(D, 3 * D, sc=D ** -0.5),
        "gq": gain * (1 + f(H, DH, sc=0.1)),
        "gk": gain * (1 + f(H, DH, sc=0.1)),
        "w_out": f(D, D, sc=D ** -0.5),
        "b_out": f(D, sc=0.1),
    }


def _qkv_both(inp, is_global):
    jq = jfp.adaln_qkv(
        jnp.asarray(inp["x"]), jnp.asarray(inp["ada"]), jnp.asarray(inp["w"]),
        jnp.asarray(inp["gq"]), jnp.asarray(inp["gk"]), P=P, is_global=is_global,
        impl="pallas", interpret=True,
    )
    tq = fused_proj.adaln_qkv(
        t(inp["x"]), t(inp["ada"]), t(inp["w"]), t(inp["gq"]), t(inp["gk"]),
        P=P, is_global=is_global,
    )
    return jq, tq


def _check_qkv(jq, tq, lead, dh):
    """The port's (q, k, v) against rap_tpu's (q, k, va): va = [v | 1] carries
    a ones column that the port's v does not (the documented difference of
    layout), so v is compared with va's first dh columns."""
    jva = np.asarray(jq[2])
    np.testing.assert_array_equal(jva[..., dh], 1.0)
    for name, a, b in zip(("q", "k", "v"), (jq[0], jq[1], jva[..., :dh]), tq):
        assert tuple(b.shape) == tuple(a.shape) == lead + (dh,), name
        _close(b.numpy(), a)


@pytest.mark.parametrize("is_global", [False, True], ids=["part", "global"])
def test_adaln_qkv_matches_pallas(is_global):
    jq, tq = _qkv_both(_inputs(), is_global)
    _check_qkv(jq, tq, (S, H, P, N) if is_global else (G, H, N), DH)


@pytest.mark.parametrize("is_global", [False, True], ids=["part", "global"])
def test_attn_out_matches_pallas(is_global):
    inp = _inputs(1)
    rng = np.random.default_rng(2)
    shape = (S, H, P, N, DH) if is_global else (G, H, N, DH)
    a5 = rng.standard_normal(shape).astype(np.float32)
    ref = jfp.attn_out(
        jnp.asarray(a5), jnp.asarray(inp["x"]), jnp.asarray(inp["w_out"]),
        jnp.asarray(inp["b_out"]), P=P, is_global=is_global, impl="pallas",
        interpret=True,
    )
    got = fused_proj.attn_out(t(a5), t(inp["x"]), t(inp["w_out"]),
                              t(inp["b_out"]), P=P, is_global=is_global)
    _close(got.numpy(), ref)


def _inputs_at(width, heads, seed):
    """``_inputs``' draws at another width and head count (dh = width/heads)."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    dh = width // heads
    return {
        "x": f(G, N, width),
        "ada": f(G, 2 * width, sc=0.2),
        "w": f(width, 3 * width, sc=width ** -0.5),
        "gq": 1 + f(heads, dh, sc=0.1),
        "gk": 1 + f(heads, dh, sc=0.1),
        "w_out": f(width, width, sc=width ** -0.5),
        "b_out": f(width, sc=0.1),
    }


# (D, H): head widths 32 (two heads in a tile's head slots) and 96 (one
# head over both halves of a tile; out_proj gathers the tokens first)
_OTHER_HEADS = [(256, 8), (384, 4)]


@pytest.mark.parametrize("width,heads", _OTHER_HEADS, ids=["dh32", "dh96"])
@pytest.mark.parametrize("is_global", [False, True], ids=["part", "global"])
def test_adaln_qkv_matches_pallas_other_head_widths(is_global, width, heads):
    """As ``test_adaln_qkv_matches_pallas`` at head widths 32 and 96, which
    csrc/proj.cu takes since every width rap_tpu admits is its shape rule."""
    inp = _inputs_at(width, heads, 3)
    jq, tq = _qkv_both(inp, is_global)
    _check_qkv(jq, tq, (S, heads, P, N) if is_global else (G, heads, N), width // heads)


@pytest.mark.parametrize("width,heads", _OTHER_HEADS, ids=["dh32", "dh96"])
@pytest.mark.parametrize("is_global", [False, True], ids=["part", "global"])
def test_attn_out_matches_pallas_other_head_widths(is_global, width, heads):
    """As ``test_attn_out_matches_pallas`` at head widths 32 and 96."""
    inp = _inputs_at(width, heads, 4)
    dh = width // heads
    rng = np.random.default_rng(5)
    shape = (S, heads, P, N, dh) if is_global else (G, heads, N, dh)
    a5 = rng.standard_normal(shape).astype(np.float32)
    ref = jfp.attn_out(
        jnp.asarray(a5), jnp.asarray(inp["x"]), jnp.asarray(inp["w_out"]),
        jnp.asarray(inp["b_out"]), P=P, is_global=is_global, impl="pallas",
        interpret=True,
    )
    got = fused_proj.attn_out(t(a5), t(inp["x"]), t(inp["w_out"]),
                              t(inp["b_out"]), P=P, is_global=is_global)
    _close(got.numpy(), ref)


@pytest.mark.parametrize("gain", [1.0, 3.0], ids=["fixed_bound", "online"])
@pytest.mark.parametrize("is_global", [False, True], ids=["part", "global"])
def test_flash_attention_headmajor_matches_pallas(gain, is_global):
    """Both sides of SAFE_BOUND2: gains 1 give bound2 ~ 13, gains 3 ~ 120."""
    inp = _inputs(3, gain=gain)
    jq, tq = _qkv_both(inp, is_global)
    bound2 = (math.log2(math.e) * math.sqrt(DH)
              * float(np.abs(inp["gq"]).max()) * float(np.abs(inp["gk"]).max()))
    assert (bound2 > fa.SAFE_BOUND2) == (gain > 1.0)
    B = S if is_global else G
    T = P * N if is_global else N
    jh = [a.reshape(B * H, T, -1) for a in jq]
    th = [a.reshape(B * H, T, -1) for a in tq]
    ref = jpa.flash_attention_headmajor(*jh, jnp.float32(bound2), interpret=True)
    got = fa.flash_attention_headmajor(*th, bound2)
    _close(got.numpy(), ref)


def test_fixed_bound_lse_matches_pallas():
    rng = np.random.default_rng(4)
    BH, T = 4, 256
    q = (rng.standard_normal((BH, T, DH)) * 0.2).astype(np.float32)
    k = (rng.standard_normal((BH, T, DH)) * 0.2).astype(np.float32)
    v = rng.standard_normal((BH, T, DH)).astype(np.float32)
    va = np.concatenate([v, np.ones((BH, T, 1), np.float32)], -1)
    bound = float(np.linalg.norm(q, axis=-1).max() * np.linalg.norm(k, axis=-1).max())
    ref_o, ref_l = jpa._fwd_full_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(va),
        jnp.full((1,), bound, jnp.float32), 0.0, 128, 128, True,
    )
    got_o, got_l = fa.flash_fixed(t(q), t(k), t(v), bound)
    _close(got_o.numpy(), ref_o)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(ref_l)[:, 0], atol=1e-4)


def test_online_masked_matches_pallas():
    """Key mask shared by the heads of a batch row; one row fully masked
    (0 output, LSE_EMPTY), one key block fully masked (skipped)."""
    rng = np.random.default_rng(5)
    B, heads, T = 3, 2, 256
    BH = B * heads
    q = (rng.standard_normal((BH, T, DH)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((BH, T, DH)) * 0.5).astype(np.float32)
    v = rng.standard_normal((BH, T, DH)).astype(np.float32)
    mask = rng.random((B, T)) > 0.4
    mask[1] = False
    mask[2, :128] = False
    ref_o, ref_l = jpa._fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(mask.astype(np.int32))[:, None, :], 0.0, 128, 128, True,
    )
    got_o, got_l = fa.flash_online(t(q), t(k), t(v), t(mask), heads=heads)
    _close(got_o.numpy(), ref_o)
    ref_l = np.asarray(ref_l)[:, 0]
    np.testing.assert_allclose(got_l.numpy(), ref_l, rtol=1e-5, atol=1e-4)
    assert (got_o[heads:2 * heads] == 0).all()
    assert (got_l[heads:2 * heads] == fa.LSE_EMPTY).all()


def _geglu_ff_case(seed, width):
    """geglu_ff at width D = ``width``, hidden 4 D, G x N tokens, fp32: the
    port's (its plain version on the CPU) against rap_tpu's Pallas kernel."""
    rng = np.random.default_rng(seed)
    FH = 4 * width
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    args = (f(G, N, width), 1 + f(width, sc=0.1), f(width, sc=0.1),
            f(width, 2 * FH, sc=width ** -0.5), f(2 * FH, sc=0.1), f(FH, width, sc=FH ** -0.5),
            f(width, sc=0.1))
    ref = jff.geglu_ff(*map(jnp.asarray, args), impl="pallas", interpret=True)
    got = fused_ff.geglu_ff(*map(t, args))
    _close(got.numpy(), ref)


def test_geglu_ff_matches_pallas():
    _geglu_ff_case(6, D)


@pytest.mark.parametrize("width", [256, 512, 768])
def test_geglu_ff_widths_match_pallas(width):
    """The widths of models the FF kernels take beside D = 512 (a D = 256, H
    = 4 and a D = 768, H = 12 model run the same FF), 2e-5 as above."""
    _geglu_ff_case(16, width)


def test_geglu_ff_bf16_matches_pallas():
    """One bf16 case: the plain version rounds where the TPU kernel does."""
    rng = np.random.default_rng(7)
    FH = 4 * D
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    args = (f(G, N, D), 1 + f(D, sc=0.1), f(D, sc=0.1), f(D, 2 * FH, sc=D ** -0.5),
            f(2 * FH, sc=0.1), f(FH, D, sc=FH ** -0.5), f(D, sc=0.1))
    jargs = [jnp.asarray(a).astype(jnp.bfloat16) if i in (0, 3, 4, 5, 6) else jnp.asarray(a)
             for i, a in enumerate(args)]
    ref = jff.geglu_ff(*jargs, impl="pallas", interpret=True).astype(jnp.float32)
    targs = [t(a).to(torch.bfloat16) if i in (0, 3, 4, 5, 6) else t(a)
             for i, a in enumerate(args)]
    got = fused_ff.geglu_ff(*targs).float()
    # bf16 output: one rounding step (2^-7 relative at worst) apart, plus the
    # erf polynomial (|err| <= 1.5e-7) against the exact erf
    _close(got.numpy(), ref, rtol=2.0 ** -6)


def test_cpu_wrappers_launch_nothing():
    """On CPU tensors the wrappers take the plain versions: no kernel count."""
    reset_launches()
    inp = _inputs()
    q, k, v = fused_proj.adaln_qkv(t(inp["x"]), t(inp["ada"]), t(inp["w"]),
                                   t(inp["gq"]), t(inp["gk"]), P=P, is_global=False)
    o = fa.flash_attention_headmajor(*(a.reshape(G * H, N, DH) for a in (q, k, v)), 13.0)
    fused_proj.attn_out(o.reshape(q.shape), t(inp["x"]), t(inp["w_out"]),
                        t(inp["b_out"]), P=P, is_global=False)
    assert launch_counts() == dict.fromkeys(launch_counts(), 0)


def test_wrappers_refuse_mixed_devices():
    meta = torch.zeros(2, 2, device="meta")
    with pytest.raises(ValueError):
        fa.flash_fixed(torch.zeros(2, 2), meta, meta, 1.0)


def test_kernel_inputs_are_checked():
    """The kernel entry points validate shapes and dtypes before any launch."""
    x = torch.zeros(G, N, D)  # fp32: the kernel takes bf16
    gq = torch.ones(H, DH)
    with pytest.raises(ValueError, match="dtype"):
        fused_proj.proj_kernel(x, torch.zeros(G, 2 * D), torch.zeros(D, 3 * D),
                               gq, gq, P, False)
    qh = torch.zeros(4, 100, DH, dtype=torch.bfloat16)  # 100 keys: not a block multiple
    with pytest.raises(ValueError, match="multiples of 128"):
        fa.flash_fixed_kernel(qh, qh, qh, 1.0)
    bf = dict(dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="token count that is a multiple of 128"):
        fused_ff.ff_kernel(torch.zeros(64, D, **bf), torch.ones(D), torch.zeros(D),
                           torch.zeros(D, 8 * D, **bf), torch.zeros(8 * D, **bf),
                           torch.zeros(4 * D, D, **bf), torch.zeros(D, **bf))


class _Shaped:
    """Stands in for an array where only its shape is read."""

    def __init__(self, *shape):
        self.shape = shape

    def reshape(self, *shape):
        return _Shaped(*shape)


def _rap_tpu_takes_ff_kernel(monkeypatch, T, D, fh):
    """Whether rap_tpu's geglu_ff (impl="auto", as on its accelerator) takes
    its fused kernel for T tokens of width D and hidden width fh: its own
    ``legal`` rule, read by recording the call instead of running it."""
    taken = []
    monkeypatch.setattr(jff.jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jff, "_fused", lambda x, *a: taken.append(True) or x)
    monkeypatch.setattr(jff, "_xla_reference", lambda x, *a: x)
    jff.geglu_ff(_Shaped(T, D), None, None, None, None, _Shaped(fh, D), None, impl="auto")
    return bool(taken)


@pytest.mark.parametrize("width", [64, 128, 192, 256, 384, 512, 640, 768, 1024, 2048])
def test_ff_shape_contract_is_rap_tpus_legal_rule(monkeypatch, width):
    """csrc/ff.cu and csrc/ff_bwd.cu take (``ff_shape_error`` is None, the
    rule ``geglu_ff`` dispatches on) exactly the shapes on which rap_tpu
    takes its fused FF kernel, over a grid of token counts and hidden widths
    (positive sizes)."""
    for T in (64, 128, 192, 256, 384, 512, 640, 1000, 1024, 4096, 32768, 65536):
        for fh in (32, 64, 96, 128, 192, 320, 512, 1024, 2048, 3072, 4096):
            legal = _rap_tpu_takes_ff_kernel(monkeypatch, T, width, fh)
            assert (fused_ff.ff_shape_error(T, width, fh) is None) == legal, (T, width, fh)


class _Gains(_Shaped):
    """A gain array where only its shape is read and it is scaled."""

    def __mul__(self, other):
        return self


def _rap_tpu_takes_proj_kernels(monkeypatch, G, N, D, H, dh, P):
    """Whether rap_tpu's adaln_qkv and attn_out (impl="auto", as on its
    accelerator) take their fused kernels: their own ``legal`` rules, read by
    recording the calls instead of running them."""
    taken = []
    monkeypatch.setattr(jfp.jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jfp, "_fused", lambda *a: taken.append("proj"))
    monkeypatch.setattr(jfp, "xla_reference", lambda *a: None)
    monkeypatch.setattr(jfp, "_fused_out", lambda *a: taken.append("out"))
    monkeypatch.setattr(jfp, "out_xla_reference", lambda *a: None)
    jfp.adaln_qkv(_Shaped(G, N, D), None, None, _Gains(H, dh), _Gains(H, dh), P, False)
    jfp.attn_out(_Shaped(G, H, N, dh), _Shaped(G, N, D), None, None, P, False)
    return "proj" in taken, "out" in taken


def _fused_guard_heads(dh):
    """The head-width terms of rap_tpu's fused guard (dit.py:193-194)."""
    return dh % 8 == 0 and dh < 128


@pytest.mark.parametrize("width", [64, 128, 256, 384, 512, 768, 1024, 1920, 2048])
def test_proj_shape_contract_is_rap_tpus_legal_rule(monkeypatch, width):
    """csrc/proj.cu and csrc/out_proj.cu take (``proj_shape_error`` /
    ``out_shape_error`` is None, the rules ``adaln_qkv`` and ``attn_out``
    dispatch on) exactly the shapes on which rap_tpu takes its fused kernels
    inside its fused DiT branch, its ``legal`` rules and the guard's head
    width, read at the attention sequence's length: N for part attention
    (rap_tpu's rule itself) and P*N for global attention (the kernels need
    only that there; rap_tpu asks N % 128 as well, so every shape it takes
    the port takes). Over a grid of head counts, part lengths and parts a
    sample, both layouts."""
    for H in (1, 2, 4, 6, 8, 12, 16, 32, 64, 128):
        if width % H:
            continue
        dh = width // H
        guard = _fused_guard_heads(dh)
        for N in (64, 100, 128, 192, 256, 1000, 1024, 2048, 4096):
            for G, P in ((2, 1), (4, 2), (6, 2), (6, 3), (6, 4), (8, 2), (3, 2)):
                at_n = _rap_tpu_takes_proj_kernels(monkeypatch, G, N, width, H, dh, P)
                for is_global in (False, True):
                    L = N * P if is_global else N
                    legal_proj, legal_out = _rap_tpu_takes_proj_kernels(monkeypatch, G, L, width,
                                                                        H, dh, P)
                    shape = (G, N, width, H, dh, P, is_global)
                    takes = (fused_proj.proj_shape_error(*shape) is None,
                             fused_proj.out_shape_error(*shape) is None)
                    assert takes == (legal_proj and guard, legal_out and guard), shape
                    assert all(tk or not (a and guard) for tk, a in zip(takes, at_n)), shape


@pytest.mark.parametrize("width", [64, 128, 256, 384, 512, 768, 1024, 1920, 2048])
def test_proj_backward_shape_rule_is_the_forwards(monkeypatch, width):
    """csrc/proj_bwd.cu (row 9) takes exactly the shapes csrc/proj.cu takes:
    over the grid of ``test_proj_shape_contract_is_rap_tpus_legal_rule``,
    proj_bwd_kernel launches once where ``proj_shape_error`` is None and
    otherwise raises its reason before any launch (the launch recorded
    instead of made; the tensors are uninitialised, only their shapes are
    read)."""
    launched = []
    monkeypatch.setattr(fused_proj, "launch", lambda name, like, *a: launched.append(a[-7:]))
    monkeypatch.setattr(fused_proj, "_sm_count", lambda device: 132)
    bf = dict(dtype=torch.bfloat16)
    for H in (1, 2, 4, 6, 8, 12, 16, 32, 64, 128):
        if width % H:
            continue
        dh = width // H
        for N in (64, 100, 128, 192, 256, 1000, 1024, 2048, 4096):
            for G, P in ((2, 1), (4, 2), (6, 2), (6, 3), (6, 4), (8, 2), (3, 2)):
                for is_global in (False, True):
                    lead = (G // P, H, P, N) if is_global and G % P == 0 else (G, H, N)
                    args = (torch.empty(G, N, width, **bf), torch.empty(G, 2 * width),
                            torch.empty(width, 3 * width, **bf), torch.empty(H, dh),
                            torch.empty(H, dh), torch.empty(lead + (dh,), **bf),
                            torch.empty(lead + (dh,), **bf), torch.empty(lead + (dh,), **bf))
                    reason = fused_proj.proj_shape_error(G, N, width, H, dh, P, is_global)
                    launched.clear()
                    if reason is None:
                        fused_proj.proj_bwd_kernel(*args, P, is_global)
                        assert launched[0][:5] == (G, N, width, H, P if is_global else 1)
                        assert N % launched[0][5] == 0 and launched[0][5] <= 64
                    else:
                        with pytest.raises(ValueError, match=re.escape(reason)):
                            fused_proj.proj_bwd_kernel(*args, P, is_global)
                        assert launched == []


@pytest.mark.parametrize("is_global,n,kernel", [(False, 192, False), (True, 96, False),
                                                (False, 128, True), (True, 192, True)],
                         ids=["part-192", "global-96", "part-128", "global-192"])
def test_dispatch_follows_the_shape_rule(monkeypatch, is_global, n, kernel):
    """adaln_qkv and attn_out choose from the shape, before any launch: a
    refused shape (a sequence of 192 tokens, part N = 192 or global P*N =
    192, N % 128 != 0) takes the plain versions and enters no kernel wrapper
    even on CUDA tensors; an admitted one (part N = 128, or global N = 192
    with P*N = 384, which rap_tpu's rule refuses and its fused guard
    admits) takes the kernels. Either way the results are rap_tpu's at
    fp32."""
    taken = []
    monkeypatch.setattr(fused_proj, "on_cpu", lambda *a: False)  # as CUDA tensors are
    monkeypatch.setattr(fused_proj, "proj_kernel",
                        lambda *a: taken.append("proj") or fused_proj.proj_plain(*a))
    monkeypatch.setattr(fused_proj, "out_kernel",
                        lambda *a: taken.append("out_proj") or fused_proj.out_plain(*a))
    rng = np.random.default_rng(6)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    x, ada, w = f(G, n, D), f(G, 2 * D, sc=0.2), f(D, 3 * D, sc=D ** -0.5)
    gq, gk = 1 + f(H, DH, sc=0.1), 1 + f(H, DH, sc=0.1)
    w_out, b_out = f(D, D, sc=D ** -0.5), f(D, sc=0.1)
    jq = jfp.adaln_qkv(jnp.asarray(x), jnp.asarray(ada), jnp.asarray(w), jnp.asarray(gq),
                       jnp.asarray(gk), P=P, is_global=is_global)  # CPU: xla_reference
    tq = fused_proj.adaln_qkv(t(x), t(ada), t(w), t(gq), t(gk), P=P, is_global=is_global)
    _check_qkv(jq, tq, (S, H, P, n) if is_global else (G, H, n), DH)
    a5 = np.asarray(jq[0])
    ref = jfp.attn_out(jnp.asarray(a5), jnp.asarray(x), jnp.asarray(w_out),
                       jnp.asarray(b_out), P=P, is_global=is_global)
    got = fused_proj.attn_out(t(a5), t(x), t(w_out), t(b_out), P=P, is_global=is_global)
    _close(got.numpy(), ref)
    assert taken == (["proj", "out_proj"] if kernel else [])


def _proj_kernel_args(G, N, D, H, dh):
    bf = dict(dtype=torch.bfloat16)
    fwd = (torch.zeros(G, N, D, **bf), torch.zeros(G, 2 * D), torch.zeros(D, 3 * D, **bf),
           torch.ones(H, dh), torch.ones(H, dh))
    out = (torch.zeros(G, H, N, dh, **bf), torch.zeros(G, N, D, **bf),
           torch.zeros(D, D, **bf), torch.zeros(D, **bf))
    return fwd, out


@pytest.mark.parametrize("G,N,D,H", [(4, 192, 256, 4), (4, 128, 320, 5), (4, 128, 256, 2),
                                     (3, 128, 256, 4)],
                         ids=["length", "width", "head_width", "parts"])
def test_proj_wrappers_refuse_what_the_rule_refuses(monkeypatch, G, N, D, H):
    """proj_kernel and out_kernel refuse a shape the rule refuses (N % 128,
    D % 128, dh = 128 past the guard, G % P), with the rule's reason, before
    any launch."""
    launched = []
    monkeypatch.setattr(fused_proj, "launch", lambda *a: launched.append(a))
    dh = D // H
    reason = fused_proj.proj_shape_error(G, N, D, H, dh, P, False)
    assert reason is not None
    fwd, out = _proj_kernel_args(G, N, D, H, dh)
    with pytest.raises(ValueError, match=re.escape(reason)):
        fused_proj.proj_kernel(*fwd, P, False)
    with pytest.raises(ValueError,
                       match=re.escape(fused_proj.out_shape_error(G, N, D, H, dh, P, False))):
        fused_proj.out_kernel(*out, P, False)
    assert launched == []


@pytest.mark.parametrize("D_,H_", [(512, 8), (512, 16), (384, 4)], ids=["dh64", "dh32", "dh96"])
def test_proj_wrappers_launch_what_the_rule_admits(monkeypatch, D_, H_):
    """An admitted shape goes to one launch each, with the gathered tokens'
    scratch only where a k slab is not one head (dh != 64)."""
    launched = []
    monkeypatch.setattr(fused_proj, "launch", lambda name, like, *a: launched.append((name, a)))
    dh = D_ // H_
    fwd, out = _proj_kernel_args(G, N, D_, H_, dh)
    fused_proj.proj_kernel(*fwd, P, False)
    fused_proj.out_kernel(*out, P, False)
    (p_name, p_args), (o_name, o_args) = launched
    assert (p_name, p_args[-5:]) == ("proj", (G, N, D_, H_, 1))
    assert (o_name, o_args[-5:]) == ("out_proj", (G, N, D_, H_, 1))
    assert (o_args[4] is None) == (dh == 64)


def _ff_kernel_args(T, D, fh):
    bf = dict(dtype=torch.bfloat16)
    x = torch.zeros(T, D, **bf)
    fwd = (x, torch.ones(D), torch.zeros(D), torch.zeros(D, 2 * fh, **bf),
           torch.zeros(2 * fh, **bf), torch.zeros(fh, D, **bf), torch.zeros(D, **bf))
    bwd = (x, x, torch.ones(D), torch.zeros(D), fwd[3], torch.zeros(2 * fh), fwd[5])
    return fwd, bwd


@pytest.mark.parametrize("T,D,fh", [(192, 256, 512), (256, 320, 512), (256, 256, 96)],
                         ids=["tokens", "width", "hidden"])
def test_ff_wrappers_refuse_what_legal_refuses(monkeypatch, T, D, fh):
    """A shape that impl="pallas" forces past the rule is refused, with the
    rule's reason, before any launch (rap_tpu crashes there)."""
    launched = []
    monkeypatch.setattr(fused_ff, "launch", lambda *a: launched.append(a))
    reason = fused_ff.ff_shape_error(T, D, fh)
    assert reason is not None
    fwd, bwd = _ff_kernel_args(T, D, fh)
    with pytest.raises(ValueError, match=reason):
        fused_ff.ff_kernel(*fwd)
    with pytest.raises(ValueError, match=reason):
        fused_ff.ff_bwd_kernel(*bwd)
    assert launched == []


@pytest.mark.parametrize("T,D,fh", [(128, 256, 1024), (256, 768, 3072), (256, 256, 192)])
def test_ff_wrappers_launch_what_legal_admits(monkeypatch, T, D, fh):
    """The wrappers pass an admitted shape on to one launch each, with the
    token splits of the weight gradients (132 SMs)."""
    launched = []
    monkeypatch.setattr(fused_ff, "launch", lambda name, like, *a: launched.append((name, a)))
    monkeypatch.setattr(fused_ff, "_sm_count", lambda device: 132)
    fwd, bwd = _ff_kernel_args(T, D, fh)
    fused_ff.ff_kernel(*fwd)
    fused_ff.ff_bwd_kernel(*bwd)
    (f_name, f_args), (b_name, b_args) = launched
    assert (f_name, f_args[-3:]) == ("ff", (T, D, fh))
    slots = 2 * 132  # two GEMM blocks on each SM
    splits = (fused_ff.wgrad_splits(-(-fh // 128) * (D // 128), T // 64, slots),
              fused_ff.wgrad_splits((D // 128) * (2 * fh // 128), T // 64, slots))
    assert (b_name, b_args[-5:]) == ("ff_bwd", (T, D, fh) + splits)


@pytest.mark.parametrize("tiles,nslab", [(128, 512), (64, 512), (288, 1024), (8, 2), (4, 64)])
def test_wgrad_splits_fill_the_card(tiles, nslab):
    """Each split keeps at least 4 slabs; the splits chosen fill at least 85%
    of the waves where any count up to 8 does, else the most any does."""
    slots = 264

    def fill(s):
        units = tiles * s
        return units / (math.ceil(units / slots) * slots)

    s = fused_ff.wgrad_splits(tiles, nslab, slots)
    allowed = [k for k in range(1, 9) if k == 1 or nslab // k >= 4]
    assert s in allowed
    if any(fill(k) >= 0.85 for k in allowed):
        assert fill(s) >= 0.85 and all(fill(k) < 0.85 for k in allowed if k < s)
    else:
        assert fill(s) == max(fill(k) for k in allowed)


def _bf16_attention_inputs(BH, Tq, Tk):
    bf = dict(dtype=torch.bfloat16)
    return (torch.zeros(BH, Tq, DH, **bf), torch.zeros(BH, Tk, DH, **bf),
            torch.zeros(BH, Tk, DH, **bf))


@pytest.mark.parametrize("variant", ["fixed", "online", "online_masked", "fixed_softcap",
                                     "online_softcap"])
@pytest.mark.parametrize("Tq,Tk", [(192, 128), (128, 192), (64, 64)])
def test_forward_kernels_refuse_non_128_lengths(monkeypatch, variant, Tq, Tk):
    """csrc/attention.cu owns 128 query rows per block and walks keys in tiles
    of 128: each forward entry refuses other lengths before any launch."""
    launched = []
    monkeypatch.setattr(fa, "launch", lambda *a: launched.append(a))
    qh, kh, vh = _bf16_attention_inputs(2, Tq, Tk)
    softcap = 5.0 if variant.endswith("softcap") else 0.0
    with pytest.raises(ValueError, match="multiples of 128"):
        if variant.startswith("fixed"):
            fa.flash_fixed_kernel(qh, kh, vh, 1.0, softcap)
        else:
            mask = torch.ones(2, Tk, dtype=torch.int32) if variant == "online_masked" else None
            fa.flash_online_kernel(qh, kh, vh, mask, 1, softcap)
    assert launched == []


@pytest.mark.parametrize("variant", ["fixed", "online"])
def test_forward_kernels_refuse_unaligned_inputs(monkeypatch, variant):
    """TMA reads q and k at their base addresses: a view 2 bytes into its
    storage is refused before any launch."""
    launched = []
    monkeypatch.setattr(fa, "launch", lambda *a: launched.append(a))
    qh, kh, vh = _bf16_attention_inputs(2, 128, 128)
    shifted = torch.zeros(qh.numel() + 1, dtype=torch.bfloat16)[1:].view(qh.shape)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        if variant == "fixed":
            fa.flash_fixed_kernel(shifted, kh, vh, 1.0)
        else:
            fa.flash_online_kernel(qh, shifted, vh)
    assert launched == []


@pytest.mark.parametrize("T", [128, 384])
def test_dq_pass_keeps_its_own_block(monkeypatch, T):
    """The dQ pass (csrc/attention_bwd_dq.cuh) owns 128 queries a block and
    walks key tiles of 128: lengths that are multiples of 128 launch it (and
    its softcap variant); queries or keys 64 short of that, and a q 2 bytes
    into its storage (TMA reads it at its base address), are refused before
    any launch."""
    launched = []
    monkeypatch.setattr(fa, "launch", lambda kernel, *a: launched.append(kernel))
    qh, kh, vh = _bf16_attention_inputs(2, T, T)
    dout = torch.zeros(2, T, DH, dtype=torch.bfloat16)
    nd, lse2 = torch.zeros(2, T), torch.zeros(2, T)
    fa.flash_bwd_dq_kernel(qh, kh, vh, dout, nd, lse2)
    fa.flash_bwd_dq_kernel(qh, kh, vh, dout, nd, lse2, torch.ones(1, T, dtype=torch.int32), 2,
                           5.0)
    assert launched == ["flash_bwd_dq", "flash_bwd_dq_softcap"]
    S = T - 64
    with pytest.raises(ValueError, match="multiples of 128"):
        fa.flash_bwd_dq_kernel(qh[:, :S].contiguous(), kh, vh, dout[:, :S].contiguous(),
                               nd[:, :S].contiguous(), lse2[:, :S].contiguous())
    with pytest.raises(ValueError, match="multiples of 128"):
        fa.flash_bwd_dq_kernel(qh, kh[:, :S].contiguous(), vh[:, :S].contiguous(), dout, nd,
                               lse2)
    shifted = torch.zeros(qh.numel() + 1, dtype=torch.bfloat16)[1:].view(qh.shape)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        fa.flash_bwd_dq_kernel(shifted, kh, vh, dout, nd, lse2)
    assert launched == ["flash_bwd_dq", "flash_bwd_dq_softcap"]
