"""Attention at head widths 64 < d <= 128 against rap_tpu (CPU).

The port's attention kernels run such heads at their 128-wide
instantiations (csrc/attention.cu, csrc/attention_bwd_dkv128.cuh,
csrc/attention_bwd_dq128.cuh), on q, k, V and dO zero-padded to 128 by the
launchers (``kernel_width``, ``head_columns``). On
the CPU the plain twins stand in for the kernels. Same numpy-seeded inputs
through both packages, fp32, rap_tpu's Pallas kernels in interpret mode:

- ``flash_attention`` forward and ``jax.vjp`` against torch.autograd at d =
  72, 96, 120 and 128, with a key mask (one batch row fully masked) and
  without one (the no-padding path below d = 128, the masked path at 128,
  as rap_tpu dispatches), at softcap 0 and 5: 2e-5 of the largest element;
- the launchers' operand preparation: q, k, V and dO padded to the kernels'
  width and -delta (``_neg_delta``), through the fused and the split
  backward twins, the first d columns against rap_tpu's ``_bwd_fused_impl``
  and ``_bwd_split_impl`` on the unpadded heads (masked, softcap 0 and 5):
  2e-5;
- ``training_forward``'s loss and every gradient leaf against
  ``jax.value_and_grad`` at D = 384, H = 4 (dh = 96, the fused branch) and
  D = 256, H = 2 (dh = 128, the unfused branch), 2 layers: loss 2e-5,
  leaves 1e-4 of their largest element.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rap_tpu.core.batch import make_regular_synthetic_batch as jax_batch
from rap_tpu.ops import pallas_attention as jpa
from rap_tpu.registration import RPFConfig as JaxRPFConfig
from rap_tpu.registration import training_forward as jax_training_forward
from rap_tpu_torch.models.dit import master_params
from rap_tpu_torch.ops import flash_attention as fa
from rap_tpu_torch.registration import RPFConfig, training_forward
from rap_tpu_torch.train.optim import tree_paths, tree_replace
from torch_parity import batch_to_torch, jax_flat, max_err, t, tiny_pallas_models

B, H, T = 2, 2, 256
RTOL = 2e-5
WIDTHS = [72, 96, 120, 128]


def _close(got, ref, rtol=RTOL, what=""):
    ref = np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got)
    err = max_err(got, ref)
    assert err <= rtol * scale, f"{what}: max err {err:.3e} > {rtol:.0e} * {scale:.3e}"


@pytest.fixture
def fresh_jax():
    jax.clear_caches()
    yield
    jax.clear_caches()


def _key_mask(seed):
    """(B, T): row 0 random with its first 128 keys masked, row 1 fully masked."""
    mask = np.random.default_rng(seed).random((B, T)) > 0.3
    mask[0, :128] = False
    mask[1] = False
    return mask


@pytest.mark.parametrize("softcap", [0.0, 5.0])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("d", WIDTHS)
def test_flash_attention_at_wide_heads_matches_jax(d, masked, softcap, fresh_jax):
    rng = np.random.default_rng(d)
    q, k, v, dout = (rng.standard_normal((B, T, H, d)).astype(np.float32) for _ in range(4))
    mask = _key_mask(d) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    out_j, vjp = jax.vjp(lambda a, b, c: jpa.flash_attention(a, b, c, jm, softcap=softcap,
                                                             interpret=True),
                         *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(dout))
    leaves = [t(a).requires_grad_(True) for a in (q, k, v)]
    out = fa.flash_attention(*leaves, None if mask is None else t(mask), softcap=softcap)
    _close(out, out_j, what="out")
    for name, g_, r_ in zip(("dq", "dk", "dv"), torch.autograd.grad(out, leaves, t(dout)), ref):
        _close(g_, r_, what=name)
        if masked:
            assert not g_[1].any(), name  # the fully masked batch row


@pytest.mark.parametrize("softcap", [0.0, 5.0])
@pytest.mark.parametrize("d", WIDTHS)
def test_padded_backward_twins_match_pallas(d, softcap):
    rng = np.random.default_rng(10 + d)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    scale = 1.0 / softcap if softcap else math.log2(math.e)
    q, k, v, dout = f(B * H, T, d) * (0.3 * scale), f(B * H, T, d), f(B * H, T, d), f(
        B * H, T, d)
    mask = _key_mask(d)
    maski = jnp.asarray(mask.astype(np.int32))[:, None, :]
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    out, lse = jpa._fwd_impl(jq, jk, jv, maski, softcap, 128, 128, True)
    vha = jnp.pad(jv, ((0, 0), (0, 0), (0, 1)), constant_values=1.0)
    bwd_args = (jq, jk, vha, maski, out, lse, jnp.asarray(dout), softcap, 128, 128, True)
    fused = jpa._bwd_fused_impl(*bwd_args, masked=True)
    split = jpa._bwd_split_impl(*bwd_args, masked=True)
    # what the backward launchers hand their kernels: q, k, V and dO padded
    # to the kernels' width, and -delta
    nd = fa._neg_delta(t(dout), t(out))
    qp, kp, vp, dop = fa.kernel_width(t(q), t(k), t(v), t(dout))
    assert qp.shape[-1] == vp.shape[-1] == fa.padded_width(d) == 128
    lse2, tm = t(lse[:, 0]), t(mask)
    (outp,) = fa.kernel_width(t(out))
    got_fused = fa.flash_bwd_plain(qp, kp, vp, outp, lse2, dop, tm, H, softcap)
    dk, dv = fa.flash_bwd_dkv_plain(qp, kp, vp, dop, nd, lse2, tm, H, softcap)
    dq = fa.flash_bwd_dq_plain(qp, kp, vp, dop, nd, lse2, tm, H, softcap)
    for name, g_, rf, rs in zip(("dq", "dk", "dv"), (dq, dk, dv), fused, split):
        assert not g_[..., d:].any(), name  # the padded columns stay zero
        _close(fa.head_columns(g_, d), rs, what=f"split {name}")
    for name, g_, r_ in zip(("dq", "dk", "dv"), got_fused, fused):
        _close(fa.head_columns(g_, d), r_, what=f"fused {name}")


S, P, N = 2, 2, 128


@pytest.mark.parametrize("width,heads", [(384, 4), (256, 2)], ids=["dh96", "dh128"])
def test_training_forward_at_wide_heads_matches_jax(width, heads):
    """dh = 96 takes the fused branch on both sides (rap_tpu's guard admits
    dh < 128), dh = 128 the unfused one with the masked attention path."""
    jcfg, tcfg, jp, tp = tiny_pallas_models(embed_dim=width, num_heads=heads)
    jb = jax_batch(jax.random.key(0), [[N] * P] * S, N=N, P=P, S=S,
                   feat_dim=jcfg.local_feat_dim)
    jr, tr, tb = JaxRPFConfig(model=jcfg), RPFConfig(model=tcfg), batch_to_torch(jb)
    rng = jax.random.key(5)
    from rap_tpu.core import flow as jflow

    k_t, k_noise, _ = jax.random.split(rng, 3)
    ts = np.asarray(jflow.sample_timesteps(k_t, S, jr.timestep_sampling))
    x_1 = np.asarray(jax.random.normal(k_noise, (S * P, N, 3), jnp.float32))
    (jloss, _), jg = jax.value_and_grad(
        lambda p: jax_training_forward(p, jr, jb, rng, remat=True), has_aux=True)(jp)
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in tree_paths(master_params(tp, "cpu"))}
    loss, _ = training_forward(tree_replace(master_params(tp, "cpu"), leaves), tr, tb, None,
                               remat=True, x_1=t(x_1), t=t(ts))
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    _close(loss, jloss, what="loss")
    ref = jax_flat(jg)
    assert set(ref) == set(grads)
    for k, g in grads.items():
        _close(g, ref[k], 1e-4, k)
