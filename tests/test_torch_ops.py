"""The port's kernel modules against rap_tpu's Pallas kernels on the CPU.

Each rap_tpu op runs its Pallas kernel in interpret mode (impl="pallas",
interpret=True), as tests/test_model.py runs the kernels on the CPU; each
port op runs its plain version, which is what its wrapper takes for CPU
tensors. Tiny shapes: D=128, H=2, dh=64, N=128, fp32. Tolerance: 2e-5
relative to the largest output, fp32 sums taken in another order.
"""

import math

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


@pytest.mark.parametrize("is_global", [False, True], ids=["part", "global"])
def test_adaln_qkv_matches_pallas(is_global):
    jq, tq = _qkv_both(_inputs(), is_global)
    lead = (S, H, P, N) if is_global else (G, H, N)
    for name, a, b in zip(("q", "k", "va"), jq, tq):
        assert tuple(b.shape) == tuple(a.shape), name
        assert tuple(b.shape[:-1]) == lead, name
        _close(b.numpy(), a)
    np.testing.assert_array_equal(tq[2][..., DH].numpy(), 1.0)


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
    got_o, got_l = fa.flash_fixed(t(q), t(k), t(va), bound)
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
    va = np.concatenate([v, np.ones((BH, T, 1), np.float32)], -1)
    mask = rng.random((B, T)) > 0.4
    mask[1] = False
    mask[2, :128] = False
    ref_o, ref_l = jpa._fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(mask.astype(np.int32))[:, None, :], 0.0, 128, 128, True,
    )
    got_o, got_l = fa.flash_online(t(q), t(k), t(va), t(mask), heads=heads)
    _close(got_o.numpy(), ref_o)
    ref_l = np.asarray(ref_l)[:, 0]
    np.testing.assert_allclose(got_l.numpy(), ref_l, rtol=1e-5, atol=1e-4)
    assert (got_o[heads:2 * heads] == 0).all()
    assert (got_l[heads:2 * heads] == fa.LSE_EMPTY).all()


def test_geglu_ff_matches_pallas():
    rng = np.random.default_rng(6)
    FH = 4 * D
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    args = (f(G, N, D), 1 + f(D, sc=0.1), f(D, sc=0.1), f(D, 2 * FH, sc=D ** -0.5),
            f(2 * FH, sc=0.1), f(FH, D, sc=FH ** -0.5), f(D, sc=0.1))
    ref = jff.geglu_ff(*map(jnp.asarray, args), impl="pallas", interpret=True)
    got = fused_ff.geglu_ff(*map(t, args))
    _close(got.numpy(), ref)


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
    q, k, va = fused_proj.adaln_qkv(t(inp["x"]), t(inp["ada"]), t(inp["w"]),
                                    t(inp["gq"]), t(inp["gk"]), P=P, is_global=False)
    o = fa.flash_attention_headmajor(q.reshape(G * H, N, DH), k.reshape(G * H, N, DH),
                                     va.reshape(G * H, N, DH + 1), 13.0)
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
    with pytest.raises(ValueError, match="multiples of 64"):
        fa.flash_fixed_kernel(qh, qh, torch.zeros(4, 100, DH + 1, dtype=torch.bfloat16), 1.0)
    bf = dict(dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="D=512"):
        fused_ff.ff_kernel(torch.zeros(64, D, **bf), torch.ones(D), torch.zeros(D),
                           torch.zeros(D, 8 * D, **bf), torch.zeros(8 * D, **bf),
                           torch.zeros(4 * D, D, **bf), torch.zeros(D, **bf))
