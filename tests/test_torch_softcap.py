"""The softcap variants of the port's attention against rap_tpu (CPU).

A softcap c caps every logit with tanh (flash-attn's ``softcap``): q is
pre-scaled by scale/c, the base-2 logit is c·log2(e)·tanh(q·k), and the
backward's ds gains c·(1 - tanh²) with no deferred ln2. rap_tpu's Pallas
kernels run in interpret mode; the port's wrappers take their plain twins
for CPU tensors. Inputs and cotangents are made with numpy from a seed; fp32
unless stated, tolerance 2e-5 of the largest element (fp32 sums in another
order; XLA's and PyTorch's tanh differ by a few ulp):

- the forward twins: fixed-bound (no mask, bound c·log2(e)) against
  ``_fwd_full_impl``, online with a key mask against ``_fwd_impl``;
- the fused backward twin against ``_bwd_fused_impl`` and the split twins
  against ``_bwd_split_impl`` at c = 4, masked and not, on the forward's
  residuals (the shapes of tests/test_model.py:321-354);
- ``flash_attention(softcap=c)`` forward and torch.autograd against
  ``jax.vjp``, with and without a mask, at c = 5 (fixed-bound kernel) and
  c = 50 (past SAFE_BOUND2: the online kernel), with the dispatch checked;
- ``dit_forward`` and ``training_forward`` (loss and every gradient leaf,
  1e-5 and 1e-4; remat off on both sides, which changes no value) at c = 5,
  2 layers, on a dense and a padded batch; and the
  ``qk_norm=False`` model, which runs the unfused branch with no gain bound;
- bf16: the pre-scale constant scale/c is rounded to bf16 as rap_tpu rounds
  it; with the unrounded constant the outputs move past the tolerance.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rap_tpu.core import flow as jflow
from rap_tpu.core.batch import make_regular_synthetic_batch as jax_batch
from rap_tpu.models.dit import dit_forward as jax_dit_forward
from rap_tpu.ops import pallas_attention as jpa
from rap_tpu.registration import RPFConfig as JaxRPFConfig
from rap_tpu.registration import training_forward as jax_training_forward
from rap_tpu_torch.models.dit import dit_forward, master_params
from rap_tpu_torch.ops import flash_attention as fa
from rap_tpu_torch.registration import RPFConfig, training_forward
from rap_tpu_torch.train.optim import tree_paths, tree_replace
from torch_parity import batch_to_torch, jax_flat, max_err, t, tiny_pallas_models

B, H, DH = 2, 2, 64
RTOL = 2e-5
CAP = 4.0


def _close(got, ref, rtol=RTOL, what=""):
    ref = np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got)
    err = max_err(got, ref)
    assert err <= rtol * scale, f"{what}: max err {err:.3e} > {rtol:.0e} * {scale:.3e}"


@pytest.fixture(autouse=True)
def fresh_jax():
    jax.clear_caches()
    yield
    jax.clear_caches()


def _key_mask(T, seed=0):
    """(B, T): row 0 random with the 128-key tile [0, 128) masked, row 1
    fully masked."""
    mask = np.random.default_rng(seed).random((B, T)) > 0.3
    mask[0, :128] = False
    mask[1] = False
    return mask


def _headmajor_inputs(T, seed, softcap=CAP):
    """q pre-scaled by scale/c (logits z = q·k of order 1, so the tanh is
    neither linear nor saturated), k, v, dO; fp32 (B*H, T, 64)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q = f(B * H, T, DH) * np.float32(2.0 / math.sqrt(DH) / softcap * 2.0)
    return q, f(B * H, T, DH), f(B * H, T, DH), f(B * H, T, DH)


def test_fixed_twin_matches_pallas():
    T = 256
    q, k, v, _ = _headmajor_inputs(T, seed=1)
    vha = np.pad(v, ((0, 0), (0, 0), (0, 1)), constant_values=1.0)  # rap_tpu's va = [v | 1]
    bound = np.full((1,), CAP * fa.LOG2E, np.float32)
    out, lse = jpa._fwd_full_impl(*map(jnp.asarray, (q, k, vha, bound)), CAP, 128, 128, True)
    got_o, got_l = fa.flash_fixed_plain(t(q), t(k), t(v), float(bound[0]), CAP)
    _close(got_o, out, what="out")
    _close(got_l, np.asarray(lse)[:, 0], what="lse2")


def test_online_twin_with_mask_matches_pallas():
    T = 256
    q, k, v, _ = _headmajor_inputs(T, seed=2)
    mask = _key_mask(T)
    maski = jnp.asarray(mask.astype(np.int32))[:, None, :]
    out, lse = jpa._fwd_impl(*map(jnp.asarray, (q, k, v)), maski, CAP, 128, 128, True)
    got_o, got_l = fa.flash_online_plain(t(q), t(k), t(v), t(mask), H, CAP)
    _close(got_o, out, what="out")
    lse = np.asarray(lse)[:, 0]
    live = slice(0, H)
    _close(got_l[live], lse[live], what="lse2")
    assert not got_o[H:].any() and bool((got_l[H:] == fa.LSE_EMPTY).all())


def _bwd_case(masked, seed):
    T = 256
    q, k, v, dout = _headmajor_inputs(T, seed)
    mask = _key_mask(T, seed) if masked else np.ones((B, T), bool)
    maski = jnp.asarray(mask.astype(np.int32))[:, None, :]
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    out, lse = jpa._fwd_impl(jq, jk, jv, maski, CAP, 128, 128, True)
    vha = jnp.pad(jv, ((0, 0), (0, 0), (0, 1)), constant_values=1.0)
    jargs = (jq, jk, vha, maski, out, lse, jnp.asarray(dout), CAP, 128, 128, True)
    targs = (t(q), t(k), t(v), t(out), t(lse[:, 0]), t(dout), t(mask) if masked else None)
    return jargs, targs


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_fused_backward_twin_matches_pallas(masked):
    jargs, targs = _bwd_case(masked, seed=3)
    ref = jpa._bwd_fused_impl(*jargs, masked=masked)
    got = fa.flash_bwd_plain(*targs, H, CAP)
    for name, g_, r_ in zip(("dq", "dk", "dv"), got, ref):
        _close(g_, r_, what=name)
        if masked:
            assert not g_[H:].any(), name


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_split_backward_twins_match_pallas(masked):
    jargs, targs = _bwd_case(masked, seed=4)
    ref = jpa._bwd_split_impl(*jargs, masked=masked)
    q, k, v, out, lse, dout, mask = targs
    args = (q, k, v, dout, fa._neg_delta(dout, out), lse, mask, H)
    dk, dv = fa.flash_bwd_dkv_plain(*args, CAP)
    dq = fa.flash_bwd_dq_plain(*args, CAP)
    for name, g_, r_ in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        _close(g_, r_, what=name)
    # without the softcap argument the twins compute something else
    assert max_err(fa.flash_bwd_dq_plain(*args), ref[0]) > 1e-2 * float(np.abs(ref[0]).max())


@pytest.mark.parametrize("softcap", [5.0, 50.0], ids=["fixed", "online"])
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_flash_attention_softcap_matches_jax(masked, softcap, monkeypatch):
    """T = 256 without a mask: the no-padding path, whose bound c·log2(e)
    sends c = 5 to the fixed kernel and c = 50 past SAFE_BOUND2 to the online
    one; T = 200 with a mask: the masked route (online)."""
    T = 256 if not masked else 200
    rng = np.random.default_rng(6)
    q, k, v, dout = (rng.standard_normal((B, T, H, DH)).astype(np.float32) for _ in range(4))
    q *= 3.0  # logits |q·k|/8 of order c, so the cap bites
    mask = None
    if masked:
        mask = np.ones((B, T), bool)
        mask[0, 50:180] = False
        mask[1, 120:] = False
    seen = []
    for name in ("flash_fixed_plain", "flash_online_plain"):
        real = getattr(fa, name)
        monkeypatch.setattr(fa, name, lambda *a, _r=real, _n=name: seen.append(_n) or _r(*a))
    jm = None if mask is None else jnp.asarray(mask)
    out_j, vjp = jax.vjp(lambda a, b, c: jpa.flash_attention(a, b, c, jm, softcap=softcap,
                                                             interpret=True),
                         *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(dout))
    leaves = [t(a).requires_grad_(True) for a in (q, k, v)]
    out = fa.flash_attention(*leaves, None if mask is None else t(mask), softcap=softcap)
    got = torch.autograd.grad(out, leaves, t(dout))
    _close(out, out_j, what="out")
    for name, g_, r_ in zip(("dq", "dk", "dv"), got, ref):
        _close(g_, r_, what=name)
    online = masked or softcap * fa.LOG2E > fa.SAFE_BOUND2
    assert seen == ["flash_online_plain" if online else "flash_fixed_plain"]


# ---- the DiT with softcap, and without qk-norm -----------------------------

S, P = 2, 3


def _models(softcap=5.0, qk_norm=True):
    jcfg, tcfg, jp, tp = tiny_pallas_models()
    kw = dict(softcap=softcap, qk_norm=qk_norm, ff_impl="auto")
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw), jp, tp


def _batch(padded, feat_dim):
    parts = [[160, 120, 90], [150, 100]] if padded else [[128] * P] * S
    jb = jax_batch(jax.random.key(7), parts, N=160 if padded else 128, P=P, S=S,
                   feat_dim=feat_dim)
    tb = batch_to_torch(jb)
    assert tb.no_padding != padded
    return jb, tb


def _noise(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("padded", [False, True], ids=["dense", "padded"])
def test_softcap_dit_forward_matches_jax(padded):
    jcfg, tcfg, jp, tp = _models()
    jb, tb = _batch(padded, jcfg.local_feat_dim)
    x, ts = _noise((S * P, tb.N, 3), 1), np.array([0.25, 0.8], np.float32)
    ref = np.asarray(jax_dit_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(ts), jb,
                                     parts_per_sample=P))
    got = dit_forward(tp, tcfg, t(x), t(ts), tb, P)
    _close(got, ref, 1e-5, "velocity")
    nocap = dit_forward(tp, dataclasses.replace(tcfg, softcap=0.0), t(x), t(ts), tb, P)
    assert max_err(nocap, ref) > 1e-3 * float(np.abs(ref).max())  # the cap bites


def _grads_match(jcfg, tcfg, jp, tp, jb, tb):
    jr, tr = JaxRPFConfig(model=jcfg), RPFConfig(model=tcfg)
    rng = jax.random.key(9)
    k_t, k_noise, _ = jax.random.split(rng, 3)
    ts = np.asarray(jflow.sample_timesteps(k_t, S, jr.timestep_sampling))
    x_1 = np.asarray(jax.random.normal(k_noise, (S * P, tb.N, 3), jnp.float32))
    (jloss, _), jg = jax.value_and_grad(
        lambda p: jax_training_forward(p, jr, jb, rng, remat=False), has_aux=True)(jp)
    tparams = master_params(tp, "cpu")
    leaves = {k: v.detach().requires_grad_(True) for k, v in tree_paths(tparams)}
    loss, _ = training_forward(tree_replace(tparams, leaves), tr, tb, None, remat=False,
                               x_1=t(x_1), t=t(ts))
    # qk_norm=False leaves the gains unread: zero gradients, as jax.grad's
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()),
                                                 materialize_grads=True)))
    _close(loss, jloss, 2e-5, "loss")
    ref = jax_flat(jg)
    assert set(ref) == set(grads)
    for k, g in grads.items():
        _close(g, ref[k], 1e-4, k)


@pytest.mark.parametrize("padded", [False, True], ids=["dense", "padded"])
def test_softcap_training_forward_matches_jax(padded):
    jcfg, tcfg, jp, tp = _models()
    jb, tb = _batch(padded, jcfg.local_feat_dim)
    _grads_match(jcfg, tcfg, jp, tp, jb, tb)


def test_no_qk_norm_runs_unfused_and_matches_jax(monkeypatch):
    """qk_norm=False: rap_tpu's unfused branch with no gain bound; the
    no-padding flash path bounds the logits from the row norms. Training:
    the unread gains get zero gradients, as jax.grad gives them."""
    jcfg, tcfg, jp, tp = _models(softcap=0.0, qk_norm=False)
    jb, tb = _batch(False, jcfg.local_feat_dim)
    fused = []
    real = fa.flash_attention_headmajor
    monkeypatch.setattr(fa, "flash_attention_headmajor",
                        lambda *a, **k: fused.append(1) or real(*a, **k))
    x, ts = _noise((S * P, tb.N, 3), 2), np.array([0.4, 0.7], np.float32)
    ref = np.asarray(jax_dit_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(ts), jb,
                                     parts_per_sample=P))
    got = dit_forward(tp, tcfg, t(x), t(ts), tb, P)
    _close(got, ref, 1e-5, "velocity")
    assert len(fused) == 2 * 2  # the flash no-padding path, not the fused branch
    # the gradients (the gains, unread, get zeros on both sides) through
    # dense attention, which rap_tpu's CPU dispatch and the port's take alike
    _grads_match(*(dataclasses.replace(c, attn_impl="dense") for c in (jcfg, tcfg)),
                 jp, tp, jb, tb)


def test_softcap_prescale_is_rounded_to_bf16(monkeypatch):
    """bf16 on both sides, masked route: q × bf16(scale/c) as rap_tpu rounds
    it (0.125/50 = 0.0025 -> 0.00250244): 5e-4 of the largest output. With
    the constant left unrounded the outputs move by 1e-2, past the 4e-3
    tolerance."""
    T, c, tol = 200, 50.0, 4e-3
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((B, T, H, DH)).astype(np.float32) for _ in range(3))
    q *= 6.0  # z = q·k·scale/c of order 1, where the cap is steep
    mask = rng.random((B, T)) > 0.2
    to_bf16 = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    ref = np.asarray(jpa.flash_attention(*map(to_bf16, (q, k, v)), jnp.asarray(mask),
                                         softcap=c, interpret=True), np.float32)
    args = [t(a).to(torch.bfloat16) for a in (q, k, v)] + [t(mask)]
    got = fa.flash_attention(*args, softcap=c)
    assert got.dtype == torch.bfloat16
    _close(got.float(), ref, tol, "out bf16")
    # the same call with the pre-scale constant kept in double precision
    real = torch.tensor
    monkeypatch.setattr(torch, "tensor", lambda x, dtype=None, **kw: real(
        x, dtype=torch.float64 if dtype == torch.bfloat16 else dtype, **kw))
    unrounded = fa.flash_attention(*args, softcap=c)
    assert max_err(unrounded.float(), ref) > tol * float(np.abs(ref).max())
