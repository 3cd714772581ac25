"""The port's masked flash attention and its split backward against rap_tpu (CPU).

rap_tpu's Pallas kernels run in interpret mode; the port's wrappers take
their plain twins for CPU tensors. Same inputs and cotangents, made with
numpy from a seed, fp32 unless stated:

- the split backward twins (rows 7-8: ``flash_bwd_dkv_plain``,
  ``flash_bwd_dq_plain``) against ``_bwd_split_impl``, masked and unmasked
  at T = 256, and at T = 384 (an odd number of key tiles of 128) masked at
  random or with only the first or only the last key tile live; and the
  masked fused twin (row 6) against ``_bwd_fused_impl``, on the same
  forward residuals. The masks hold a fully masked 128-key tile (or every
  tile but one) and a fully masked sequence. Tolerance 2e-5 of the largest element (fp32 sums in
  another order); the fully masked sequence's gradients are exactly 0.
- ``flash_attention`` with a key mask, forward and ``jax.vjp`` against
  torch.autograd, with rap_tpu's fused and split backward (BWD_IMPL and the
  port's cap), at a length that is not a multiple of 128; and without a
  mask, through the no-padding path: 2e-5.
- the slab rule that picks fused or split, against the blocks rap_tpu's own
  dispatch computes (recorded from an abstract trace) over a grid of shapes.
- ``batched_attention``'s dense and chunked routes with a mask and softcap.
- one bf16 check of the masked route, where the pre-scale constant is
  rounded to bf16 as rap_tpu rounds it: 4e-3 of the largest output.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rap_tpu.ops import attention as jatt
from rap_tpu.ops import pallas_attention as jpa
from rap_tpu_torch.ops import attention as att
from rap_tpu_torch.ops import flash_attention as fa
from torch_parity import max_err, t

B, H, DH = 2, 2, 64
RTOL = 2e-5


def _close(got, ref, rtol=RTOL, what=""):
    ref = np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got)
    err = max_err(got, ref)
    assert err <= rtol * scale, f"{what}: max err {err:.3e} > {rtol:.0e} * {scale:.3e}"


def _key_mask(T, seed=0):
    """(B, T): row 0 random with keys [0, 128) all masked (a whole key tile
    of the kernels), row 1 fully masked."""
    rng = np.random.default_rng(seed)
    mask = rng.random((B, T)) > 0.3
    mask[0, :128] = False
    mask[1] = False
    return mask


@pytest.fixture
def fresh_jax():
    jax.clear_caches()
    yield
    jax.clear_caches()


def _headmajor_inputs(T, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q = f(B * H, T, DH) * (0.3 * math.log2(math.e))
    return q, f(B * H, T, DH), f(B * H, T, DH), f(B * H, T, DH)


def _tile_mask(T, live, seed=0):
    """(B, T): row 0 with valid keys only in the first or only in the last
    tile of 128 (random, the tile's first key valid), row 1 fully masked."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((B, T), bool)
    keys = slice(0, 128) if live == "first" else slice(T - 128, T)
    mask[0, keys] = rng.random(128) > 0.5
    mask[0, keys.start] = True
    return mask


# id: (T, key mask) -- 384 is an odd number of the dQ pass's key tiles of 128
_SPLIT_CASES = {"masked": (256, "random"), "unmasked": (256, None),
                "odd_tiles": (384, "random"), "first_tile_live": (384, "first"),
                "last_tile_live": (384, "last")}


@pytest.mark.parametrize("case", list(_SPLIT_CASES))
def test_split_twins_match_pallas(case):
    T, kind = _SPLIT_CASES[case]
    masked = kind is not None
    q, k, v, dout = _headmajor_inputs(T, seed=1)
    if kind == "random":
        mask = _key_mask(T)
    elif masked:
        mask = _tile_mask(T, kind)
    else:
        mask = np.ones((B, T), bool)
    maski = jnp.asarray(mask.astype(np.int32))[:, None, :]
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    out, lse = jpa._fwd_impl(jq, jk, jv, maski, 0.0, 128, 128, True)
    vha = jnp.pad(jv, ((0, 0), (0, 0), (0, 1)), constant_values=1.0)
    ref = jpa._bwd_split_impl(jq, jk, vha, maski, out, lse, jnp.asarray(dout), 0.0, 128,
                              128, True, masked=masked)
    tmask = t(mask) if masked else None
    args = (t(q), t(k), t(v), t(dout), fa._neg_delta(t(dout), t(out)), t(lse[:, 0]), tmask, H)
    dk, dv = fa.flash_bwd_dkv_plain(*args)
    dq = fa.flash_bwd_dq_plain(*args)
    for name, g_, r_ in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        _close(g_, r_, what=name)
        if masked:  # the fully masked sequence (heads of batch row 1)
            assert not g_[H:].any(), name


def test_masked_fused_twin_matches_pallas():
    T = 256
    q, k, v, dout = _headmajor_inputs(T, seed=2)
    mask = _key_mask(T, seed=1)
    maski = jnp.asarray(mask.astype(np.int32))[:, None, :]
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    out, lse = jpa._fwd_impl(jq, jk, jv, maski, 0.0, 128, 128, True)
    vha = jnp.pad(jv, ((0, 0), (0, 0), (0, 1)), constant_values=1.0)
    ref = jpa._bwd_fused_impl(jq, jk, vha, maski, out, lse, jnp.asarray(dout), 0.0, 128,
                              128, True, masked=True)
    got = fa.flash_bwd_plain(t(q), t(k), t(v), t(out), t(lse[:, 0]), t(dout), t(mask), H)
    for name, g_, r_ in zip(("dq", "dk", "dv"), got, ref):
        _close(g_, r_, what=name)
        assert not g_[H:].any(), name
    # the same residuals through the split twins: one computation, two passes
    args = (t(q), t(k), t(v), t(dout), fa._neg_delta(t(dout), t(out)), t(lse[:, 0]), t(mask), H)
    _close(fa.flash_bwd_dq_plain(*args), ref[0], what="dq split")
    for name, g_, r_ in zip(("dk", "dv"), fa.flash_bwd_dkv_plain(*args), ref[1:]):
        _close(g_, r_, what=f"{name} split")


@pytest.mark.parametrize("bwd", ["fused", "split"])
def test_flash_attention_with_mask_matches_jax(bwd, monkeypatch, fresh_jax):
    """T = 200: queries and keys padded to 256, the padded keys masked."""
    T = 200
    rng = np.random.default_rng(3)
    q, k, v, dout = (rng.standard_normal((B, T, H, DH)).astype(np.float32) for _ in range(4))
    mask = np.ones((B, T), bool)
    mask[0, 50:180] = False  # covers the keys of a whole 128-key tile
    mask[1] = False
    if bwd == "split":
        monkeypatch.setattr(jpa, "BWD_IMPL", "split")
        monkeypatch.setattr(fa, "_FUSED_DQ_PARTIALS_CAP", 0)
    jm = jnp.asarray(mask)
    out_j, vjp = jax.vjp(lambda a, b, c: jpa.flash_attention(a, b, c, jm, interpret=True),
                         *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(dout))
    leaves = [t(a).requires_grad_(True) for a in (q, k, v)]
    out = fa.flash_attention(*leaves, t(mask))
    got = torch.autograd.grad(out, leaves, t(dout))
    _close(out, out_j, what="out")
    assert not out[1].any()
    for name, g_, r_ in zip(("dq", "dk", "dv"), got, ref):
        _close(g_, r_, what=name)


@pytest.mark.parametrize("bound", ["row_norms", "given"])
def test_flash_attention_without_mask_matches_jax(bound, fresh_jax):
    """No mask and 128-aligned lengths: the no-padding path, its bound from
    the caller (the unscaled max|q.k|) or from the row norms."""
    T = 256
    rng = np.random.default_rng(6)
    q, k, v, dout = (rng.standard_normal((B, T, H, DH)).astype(np.float32) for _ in range(4))
    given = float(np.linalg.norm(q, axis=-1).max() * np.linalg.norm(k, axis=-1).max())
    lb = given if bound == "given" else None
    out_j, vjp = jax.vjp(lambda a, b, c: jpa.flash_attention(a, b, c, None, interpret=True,
                                                             logit_bound=lb),
                         *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(dout))
    leaves = [t(a).requires_grad_(True) for a in (q, k, v)]
    out = fa.flash_attention(*leaves, None, logit_bound=lb)
    _close(out, out_j, what="out")
    for name, g_, r_ in zip(("dq", "dk", "dv"), torch.autograd.grad(out, leaves, t(dout)), ref):
        _close(g_, r_, what=name)


def _jax_slabs(monkeypatch, BH_, Tq, Tk, masked):
    """The dQ partials slab bytes of every backward rap_tpu's dispatch
    computes for flash_attention at this shape (abstract trace, no compute)."""
    seen = []
    real = jpa._bwd_impl

    def spy(qh, kh, vha, maski, out, lse, doh, softcap, block_q, block_k, *a, **kw):
        seen.append(qh.shape[0] * (kh.shape[1] // block_k) * qh.shape[1] * qh.shape[2] * 4)
        return real(qh, kh, vha, maski, out, lse, doh, softcap, block_q, block_k, *a, **kw)

    monkeypatch.setattr(jpa, "_bwd_impl", spy)
    jax.clear_caches()
    H_ = 8
    shapes = [jax.ShapeDtypeStruct((BH_ // H_, T, H_, DH), jnp.float32) for T in (Tq, Tk, Tk)]
    mask = jax.ShapeDtypeStruct((BH_ // H_, Tk), jnp.bool_) if masked else None

    def grads(q, k, v, m):
        out, vjp = jax.vjp(lambda a, b, c: jpa.flash_attention(a, b, c, m, interpret=True),
                           q, k, v)
        return vjp(out)

    jax.eval_shape(grads, *shapes, mask)
    jax.clear_caches()
    return seen


@pytest.mark.parametrize("Tq,Tk", [(100, 100), (200, 1000), (1000, 1000), (1024, 1024),
                                   (1500, 3000), (3000, 1500), (4096, 4096), (32768, 32768),
                                   (40000, 40000)])
def test_masked_slab_rule_matches_rap_tpu_blocks(Tq, Tk, monkeypatch):
    BH_ = 16
    assert _jax_slabs(monkeypatch, BH_, Tq, Tk, True) == [
        fa.masked_backward_slab_bytes(BH_, Tq, Tk, DH)]


@pytest.mark.parametrize("T", [128, 1024, 4096, 8192, 32768])
def test_dense_slab_rule_matches_rap_tpu_blocks(T, monkeypatch):
    BH_ = 16
    assert _jax_slabs(monkeypatch, BH_, T, T, False) == [
        fa.fused_backward_slab_bytes(BH_, T, T, DH)]


def test_multiview_shapes_take_the_split_backward():
    """rap_12 under rap_train.yaml: 2 samples x 8 parts x 4096 points. The part
    attention's slab is 512 MiB (row 6, masked), the global one's 4 GiB
    (rows 7-8); the dense 4 x 2 x 4096 training batch stays fused."""
    cap = fa._FUSED_DQ_PARTIALS_CAP
    assert fa.masked_backward_slab_bytes(16 * 8, 4096, 4096, 64) == 512 * 2**20
    assert fa.masked_backward_slab_bytes(2 * 8, 32768, 32768, 64) == 4 * 2**30 > cap
    assert fa.fused_backward_slab_bytes(4 * 8, 8192, 8192, 64) <= cap


@pytest.mark.parametrize("softcap", [0.0, 5.0], ids=["plain", "softcap"])
@pytest.mark.parametrize("impl", ["dense", "chunked"])
def test_batched_attention_dense_and_chunked_match_jax(impl, softcap):
    rng = np.random.default_rng(4)
    Tq, Tk = 70, 300
    q = rng.standard_normal((B, Tq, H, DH)).astype(np.float32)
    k, v = (rng.standard_normal((B, Tk, H, DH)).astype(np.float32) for _ in range(2))
    mask = rng.random((B, Tk)) > 0.4
    mask[1] = False
    ref = jatt.batched_attention(*map(jnp.asarray, (q, k, v, mask)), impl=impl,
                                 softcap=softcap, chunk=128)
    got = att.batched_attention(t(q), t(k), t(v), t(mask), impl=impl, softcap=softcap,
                                chunk=128)
    _close(got, ref, what=impl)
    assert not got[1].any()


def test_batched_attention_dispatch(monkeypatch):
    """auto: Tk >= 1024 takes the flash route; shorter calls dense, or
    chunked beyond 2**28 logits."""
    seen = []
    monkeypatch.setattr(att, "flash_attention", lambda *a, **k: seen.append("flash"))
    monkeypatch.setattr(att, "_dense_attention", lambda *a: seen.append("dense"))
    monkeypatch.setattr(att, "_chunked_attention", lambda *a: seen.append("chunked"))
    x = torch.zeros(1, 1, 1, 64)
    for Tq, Tk, B_, expect in ((1, 1024, 1, "flash"), (8, 1023, 1, "dense"),
                               (1000, 1000, 269, "chunked")):
        q = x.expand(B_, Tq, 1, 64)
        k = x.expand(B_, Tk, 1, 64)
        att.batched_attention(q, k, k)
        assert seen[-1] == expect, (Tq, Tk, B_)


def test_masked_route_bf16_matches_jax(fresh_jax):
    """bf16 on both sides: q is pre-scaled by scale*log2(e) rounded to bf16
    (0.18034 -> 0.18066); with the unrounded constant the outputs move by
    ~1e-2 of their largest element, well past this tolerance."""
    T = 200
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((B, T, H, DH)).astype(np.float32) * 2 for _ in range(3))
    mask = rng.random((B, T)) > 0.2
    to_bf16 = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    ref = jpa.flash_attention(*map(to_bf16, (q, k, v)), jnp.asarray(mask), interpret=True)
    got = fa.flash_attention(*(t(a).to(torch.bfloat16) for a in (q, k, v)), t(mask))
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(ref, np.float32), 4e-3, "out bf16")
