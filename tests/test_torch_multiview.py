"""The port on padded multi-part batches against rap_tpu on the CPU.

A tiny model (D=128, H=2, dh=64, 2 layers) with the tiny Pallas config's
gains, fp32 on both sides. The batch is padded the way the packer pads
multi-view scans: S=2 samples of P=3 part slots, N=160 points per slot (not
a multiple of 128), parts of 160, 120 and 90 points in sample 0 and of 150
and 100 in sample 1, whose third slot is empty. ``attn_impl="pallas"`` on
both sides sends every attention call of the masked branch to the flash
route (rap_tpu's Pallas kernels in interpret mode, the port's plain twins);
``auto`` sends these short sequences to dense attention on both sides. The
token counts fail the fused feed-forward's legal rule, so both sides run
its reference composition.

- masked ``dit_forward`` (1e-5 of the largest velocity), and the unfused
  branch of a dense batch with N=100, which the fused guard turns away;
- ``return_features`` and ``latent`` (1e-5);
- ``training_forward``: loss and every gradient leaf, remat on, with the
  fused backward and with the split backward forced on both sides
  (rap_tpu's BWD_IMPL, the port's cap): loss 2e-5, each leaf 1e-4 of its
  largest element;
- ``sample`` (2 Euler steps, rigidity forcing) + ``predict_poses`` (1e-4 abs);
- ``params_from_jax`` carries every leaf the masked branch reads.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rap_tpu.core.batch import make_regular_synthetic_batch as jax_batch
from rap_tpu.models.dit import dit_forward as jax_dit_forward
from rap_tpu.models.dit import init_dit_params as jax_init
from rap_tpu.ops import pallas_attention as jpa
from rap_tpu.registration import RPFConfig as JaxRPFConfig
from rap_tpu.registration import predict_poses as jax_predict_poses
from rap_tpu.registration import sample as jax_sample
from rap_tpu.registration import training_forward as jax_training_forward
from rap_tpu_torch.models.dit import dit_forward, master_params
from rap_tpu_torch.ops import flash_attention as fa
from rap_tpu_torch.registration import RPFConfig, predict_poses, sample, training_forward
from rap_tpu_torch.train.optim import tree_paths, tree_replace
from torch_parity import (batch_to_torch, jax_flat, max_err, params_to_torch, t,
                          tiny_pallas_models)

S, P, N = 2, 3, 160
PARTS = [[160, 120, 90], [150, 100]]


def _rel_close(got, ref, rtol, what=""):
    ref = np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = max_err(got, ref)
    assert err <= rtol * scale, f"{what}: max err {err:.3e} > {rtol:.0e} * {scale:.3e}"


def _models(impl):
    """The tiny models with ``impl`` attention and the feed-forward's auto
    dispatch (these token counts fail the fused kernel's legal rule)."""
    jcfg, tcfg, jp, tp = tiny_pallas_models()
    return (dataclasses.replace(jcfg, attn_impl=impl, ff_impl="auto"),
            dataclasses.replace(tcfg, attn_impl=impl, ff_impl="auto"), jp, tp)


@pytest.fixture(autouse=True)
def fresh_jax():
    jax.clear_caches()
    yield
    jax.clear_caches()


def _padded_batch(feat_dim, parts=PARTS, n=N):
    jb = jax_batch(jax.random.key(7), parts, N=n, P=P, S=S, feat_dim=feat_dim)
    tb = batch_to_torch(jb)
    assert not tb.no_padding and not bool(tb.part_valid.all())
    return jb, tb


def _noise(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("impl", ["pallas", "auto"])
def test_masked_dit_forward_matches_jax(impl):
    jcfg, tcfg, jp, tp = _models(impl)
    jb, tb = _padded_batch(jcfg.local_feat_dim)
    x, ts = _noise((S * P, N, 3), 1), np.array([0.25, 0.8], np.float32)
    ref = np.asarray(jax_dit_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(ts), jb,
                                     parts_per_sample=P))
    got = dit_forward(tp, tcfg, t(x), t(ts), tb, P)
    assert tuple(got.shape) == ref.shape
    _rel_close(got.numpy(), ref, 1e-5, "velocity")


@pytest.mark.parametrize("impl", ["pallas", "auto"])
def test_dense_unfused_dit_forward_matches_jax(impl, monkeypatch):
    """N=100: the fused guard needs sequences that are multiples of 128, so
    this dense batch takes the unfused branch with the gains' logit bound."""
    jcfg, tcfg, jp, tp = _models(impl)
    n = 100
    jb = jax_batch(jax.random.key(8), [[n] * P] * S, N=n, P=P, S=S,
                   feat_dim=jcfg.local_feat_dim)
    tb = batch_to_torch(jb)
    assert tb.no_padding
    fused = []
    monkeypatch.setattr(fa._FlashAttention, "apply", lambda *a: fused.append(a))
    x, ts = _noise((S * P, n, 3), 2), np.array([0.5, 0.9], np.float32)
    ref = np.asarray(jax_dit_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(ts), jb,
                                     parts_per_sample=P))
    got = dit_forward(tp, tcfg, t(x), t(ts), tb, P)
    assert not fused
    _rel_close(got.numpy(), ref, 1e-5, "velocity")


@pytest.mark.parametrize("latent", ["given", "zeros"])
def test_features_and_latent_match_jax(latent):
    jcfg, tcfg, _, _ = _models("pallas")
    jcfg = dataclasses.replace(jcfg, in_dim=8)
    tcfg = dataclasses.replace(tcfg, in_dim=8)
    jp = jax_init(jax.random.key(3), jcfg)
    tp = params_to_torch(jp)
    jb, tb = _padded_batch(jcfg.local_feat_dim)
    x, ts = _noise((S * P, N, 3), 3), np.array([0.3, 0.6], np.float32)
    lat = _noise((S * P, N, 8), 4) if latent == "given" else None
    ref, ref_f = jax_dit_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(ts), jb,
                                 parts_per_sample=P, return_features=True,
                                 latent=None if lat is None else jnp.asarray(lat))
    got, feats = dit_forward(tp, tcfg, t(x), t(ts), tb, P, return_features=True,
                             latent=None if lat is None else t(lat))
    assert feats.dtype == torch.float32 and tuple(feats.shape) == (S * P, N, 128)
    _rel_close(got.numpy(), ref, 1e-5, "velocity")
    _rel_close(feats.numpy(), ref_f, 1e-5, "features")


@pytest.mark.parametrize("bwd", ["fused", "split"])
def test_training_forward_padded_matches_jax(bwd, monkeypatch):
    if bwd == "split":
        monkeypatch.setattr(jpa, "BWD_IMPL", "split")
        monkeypatch.setattr(fa, "_FUSED_DQ_PARTIALS_CAP", 0)
    jcfg, tcfg, jp, tp = _models("pallas")
    jb, tb = _padded_batch(jcfg.local_feat_dim)
    jr, tr = JaxRPFConfig(model=jcfg), RPFConfig(model=tcfg)
    rng = jax.random.key(9)
    k_t, k_noise, _ = jax.random.split(rng, 3)
    from rap_tpu.core import flow as jflow

    ts = np.asarray(jflow.sample_timesteps(k_t, S, jr.timestep_sampling))
    x_1 = np.asarray(jax.random.normal(k_noise, (S * P, N, 3), jnp.float32))
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: jax_training_forward(p, jr, jb, rng, remat=True), has_aux=True)(jp)
    tparams = master_params(tp, "cpu")
    leaves = {k: v.detach().requires_grad_(True) for k, v in tree_paths(tparams)}
    loss, m = training_forward(tree_replace(tparams, leaves), tr, tb, None, remat=True,
                               x_1=t(x_1), t=t(ts))
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    _rel_close(loss.detach().numpy(), jloss, 2e-5, "loss")
    for name, v in jm.items():
        _rel_close(m[name].numpy(), v, 2e-5, name)
    ref = jax_flat(jg)
    assert set(ref) == set(grads)
    for k, g in grads.items():
        _rel_close(g.numpy(), ref[k], 1e-4, k)


def test_sample_and_poses_padded_match_jax():
    jcfg, tcfg, jp, tp = _models("pallas")
    jb, tb = _padded_batch(jcfg.local_feat_dim)
    x_1 = _noise((S * P, N, 3), 5)
    jr = JaxRPFConfig(model=jcfg, inference_sampling_steps=2, rigidity_forcing=True)
    tr = RPFConfig(model=tcfg, inference_sampling_steps=2, rigidity_forcing=True)
    jo = jax_sample(jp, jr, jb, jax.random.key(3), x_1=jnp.asarray(x_1),
                    return_trajectory=False)
    to = sample(tp, tr, tb, x_1=t(x_1), return_trajectory=False)
    valid = np.asarray(jb.point_mask)[..., None]
    assert max_err(to["points"].numpy() * valid, np.asarray(jo["points"]) * valid) <= 1e-4
    jR, jt = jax_predict_poses(jb, jo["points"])
    tR, tt = predict_poses(tb, to["points"])
    assert max_err(tR.numpy(), jR) <= 1e-4
    assert max_err(tt.numpy(), jt) <= 1e-4


def test_params_from_jax_carries_every_leaf_of_the_masked_branch():
    """No new leaves: the port's parameters are rap_tpu's, split per layer,
    plus the host guard bounds; the masked branch reads nothing else."""
    _, tcfg, jp, tp = _models("pallas")
    ported = {k for k, _ in tree_paths(master_params(tp, "cpu"))}
    assert ported == set(jax_flat(jp))
    read = []
    jb, tb = _padded_batch(tcfg.local_feat_dim)

    class Spy(dict):
        def __getitem__(self, key):
            read.append(key)
            return super().__getitem__(key)

    spy = dict(tp, layers=[Spy(lp) for lp in tp["layers"]])
    dit_forward(spy, tcfg, torch.zeros(S * P, N, 3), torch.zeros(S), tb, P)
    assert "self_bound2" not in read and "global_bound2" not in read
    assert set(read) == set(tp["layers"][0]) - {"self_bound2", "global_bound2"}
