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

The ``aligned`` cases take N=128 (parts of 128, 100 and 70 and of 120 and
90): under ``attn_impl="pallas"`` the guard admits these sequences, so the
padded batch takes the fused branch (proj, the masked online forward on its
head-major operands, out_proj) where rap_tpu, whose fused attention has no
mask, takes its unfused one; the ``dit.fused`` / ``dit.unfused`` counters
show the route.

- masked ``dit_forward`` (1e-5 of the largest velocity), and the unfused
  branch of a dense batch with N=100, which the fused guard turns away;
- ``return_features`` and ``latent`` (1e-5);
- ``training_forward``: loss and every gradient leaf, remat on, with the
  fused backward and with the split backward forced on both sides
  (rap_tpu's BWD_IMPL, the port's cap): loss 2e-5, each leaf 1e-4 of its
  largest element;
- ``sample`` (2 Euler steps, rigidity forcing) + ``predict_poses`` (1e-4 abs);
- ``params_from_jax`` carries every leaf the masked branch reads;
- each attention sub-block's branch, from the route counters: padded and
  dense batches alike take the fused branch where the sequence passes the
  guard; unaligned or (under ``auto``) short sequences, a softcap,
  ``qk_norm=False`` and ring global attention take the unfused one.
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
from rap_tpu_torch import telemetry
from rap_tpu_torch.core.batch import make_regular_synthetic_batch
from rap_tpu_torch.models.config import DiTConfig
from rap_tpu_torch.models.dit import dit_forward, init_dit_params, master_params
from rap_tpu_torch.ops import flash_attention as fa
from rap_tpu_torch.parallel.mesh import make_mesh
from rap_tpu_torch.registration import RPFConfig, predict_poses, sample, training_forward
from rap_tpu_torch.train.optim import tree_paths, tree_replace
from torch_parity import (batch_to_torch, jax_flat, max_err, params_to_torch, t,
                          tiny_pallas_models)

S, P, N = 2, 3, 160
PARTS = [[160, 120, 90], [150, 100]]
# N a multiple of 128: the guard admits the padded batch to the fused branch
ALIGNED_N = 128
ALIGNED_PARTS = [[128, 100, 70], [120, 90]]


def _rel_close(got, ref, rtol, what=""):
    ref = np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = max_err(got, ref)
    assert err <= rtol * scale, f"{what}: max err {err:.3e} > {rtol:.0e} * {scale:.3e}"


def _models(impl, n=N):
    """The tiny models with ``impl`` attention and the feed-forward's auto
    dispatch (these token counts fail the fused kernel's legal rule). At
    the aligned N, rap_tpu takes its unfused branch with the mask whatever
    its ``attn_impl``: its ``auto`` (dense attention under 1024 keys, an
    exact softmax like the flash route's at fp32) spares its Pallas
    interpreter."""
    jcfg, tcfg, jp, tp = tiny_pallas_models()
    return (dataclasses.replace(jcfg, attn_impl="auto" if n == ALIGNED_N else impl,
                                ff_impl="auto"),
            dataclasses.replace(tcfg, attn_impl=impl, ff_impl="auto"), jp, tp)


@pytest.fixture
def fresh_jax():
    """rap_tpu's flash_attention is jitted: a test that flips its BWD_IMPL
    drops the traces before and after it, so no stale trace keeps the old
    dispatch; the other tests share the compiled operations."""
    jax.clear_caches()
    yield
    jax.clear_caches()


def _padded_batch(feat_dim, parts=PARTS, n=N):
    jb = jax_batch(jax.random.key(7), parts, N=n, P=P, S=S, feat_dim=feat_dim)
    tb = batch_to_torch(jb)
    assert not tb.no_padding and not bool(tb.part_valid.all())
    return jb, tb


def _layout(n):
    return n, PARTS if n == N else ALIGNED_PARTS


def _noise(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _check_routes(routes, fused: bool):
    """Every attention sub-block took the fused branch, or every one the
    unfused branch."""
    took, other = ("fused", "unfused") if fused else ("unfused", "fused")
    assert routes[took] > 0 and routes[other] == 0, routes


@pytest.mark.parametrize("impl, n", [("pallas", N), ("auto", N), ("pallas", ALIGNED_N)],
                         ids=["pallas", "auto", "aligned"])
def test_masked_dit_forward_matches_jax(impl, n):
    """Every row, padded rows too."""
    jcfg, tcfg, jp, tp = _models(impl, n)
    n, parts = _layout(n)
    jb, tb = _padded_batch(jcfg.local_feat_dim, parts, n)
    x, ts = _noise((S * P, n, 3), 1), np.array([0.25, 0.8], np.float32)
    ref = np.asarray(jax_dit_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(ts), jb,
                                     parts_per_sample=P))
    with telemetry.counted("dit.") as routes:
        got = dit_forward(tp, tcfg, t(x), t(ts), tb, P)
    assert tuple(got.shape) == ref.shape
    _rel_close(got.numpy(), ref, 1e-5, "velocity")
    _check_routes(routes, fused=n == ALIGNED_N)


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
    with telemetry.counted("dit.") as routes:
        got = dit_forward(tp, tcfg, t(x), t(ts), tb, P)
    assert not fused
    _check_routes(routes, fused=False)
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


@pytest.mark.parametrize("bwd, n", [("fused", N), ("fused", ALIGNED_N), ("split", N)],
                         ids=["fused", "aligned", "split"])
def test_training_forward_padded_matches_jax(bwd, n, monkeypatch, request):
    if bwd == "split":
        request.getfixturevalue("fresh_jax")
        monkeypatch.setattr(jpa, "BWD_IMPL", "split")
        monkeypatch.setattr(fa, "_FUSED_DQ_PARTIALS_CAP", 0)
    jcfg, tcfg, jp, tp = _models("pallas", n)
    n, parts = _layout(n)
    jb, tb = _padded_batch(jcfg.local_feat_dim, parts, n)
    jr, tr = JaxRPFConfig(model=jcfg), RPFConfig(model=tcfg)
    rng = jax.random.key(9)
    k_t, k_noise, _ = jax.random.split(rng, 3)
    from rap_tpu.core import flow as jflow

    ts = np.asarray(jflow.sample_timesteps(k_t, S, jr.timestep_sampling))
    x_1 = np.asarray(jax.random.normal(k_noise, (S * P, n, 3), jnp.float32))
    # rap_tpu's remat recomputes the same operations (the aligned case spares
    # its trace): the port's gradients through its own remat either way
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: jax_training_forward(p, jr, jb, rng, remat=n != ALIGNED_N),
        has_aux=True)(jp)
    tparams = master_params(tp, "cpu")
    leaves = {k: v.detach().requires_grad_(True) for k, v in tree_paths(tparams)}
    with telemetry.counted("dit.") as routes:
        loss, m = training_forward(tree_replace(tparams, leaves), tr, tb, None, remat=True,
                                   x_1=t(x_1), t=t(ts))
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    _check_routes(routes, fused=n == ALIGNED_N)
    _rel_close(loss.detach().numpy(), jloss, 2e-5, "loss")
    for name, v in jm.items():
        _rel_close(m[name].numpy(), v, 2e-5, name)
    ref = jax_flat(jg)
    assert set(ref) == set(grads)
    for k, g in grads.items():
        _rel_close(g.numpy(), ref[k], 1e-4, k)


@pytest.mark.parametrize("n", [N, ALIGNED_N], ids=["unaligned", "aligned"])
def test_sample_and_poses_padded_match_jax(n):
    """The valid rows."""
    jcfg, tcfg, jp, tp = _models("pallas", n)
    n, parts = _layout(n)
    jb, tb = _padded_batch(jcfg.local_feat_dim, parts, n)
    x_1 = _noise((S * P, n, 3), 5)
    jr = JaxRPFConfig(model=jcfg, inference_sampling_steps=2, rigidity_forcing=True)
    tr = RPFConfig(model=tcfg, inference_sampling_steps=2, rigidity_forcing=True)
    jo = jax_sample(jp, jr, jb, jax.random.key(3), x_1=jnp.asarray(x_1),
                    return_trajectory=False)
    with telemetry.counted("dit.") as routes:
        to = sample(tp, tr, tb, x_1=t(x_1), return_trajectory=False)
    _check_routes(routes, fused=n == ALIGNED_N)
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


# (config changes, N, parts, ring global attention) -> (fused, unfused)
# sub-blocks of one forward of the 2-layer model
ROUTES = {
    "dense": (dict(), 128, [[128] * P] * S, False, (4, 0)),
    "padded": (dict(), 128, ALIGNED_PARTS, False, (4, 0)),
    "unaligned": (dict(), 160, PARTS, False, (0, 4)),
    "auto_short_parts": (dict(attn_impl="auto"), 512, [[512, 300, 200], [400, 100]],
                         False, (2, 2)),
    "softcap": (dict(softcap=5.0), 128, ALIGNED_PARTS, False, (0, 4)),
    "no_qk_norm": (dict(qk_norm=False), 128, ALIGNED_PARTS, False, (0, 4)),
    "ring_global": (dict(), 128, [[128, 100, 70]], True, (2, 2)),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_attention_branch_routes(case):
    """Which branch each attention sub-block takes, from what the guard sees
    alone: the sequence's length and alignment, softcap, qk-norm and a ring
    mesh, never the mask. Under a ring of one rank the forward equals the
    local one, whose global attention takes the fused branch."""
    changes, n, parts, ring, (fused, unfused) = ROUTES[case]
    cfg = DiTConfig(embed_dim=128, num_layers=2, num_heads=2, local_feat_dim=8,
                    compute_dtype=torch.float32, attn_impl="pallas", ff_impl="auto")
    cfg = dataclasses.replace(cfg, **changes)
    params = init_dit_params(0, cfg, device="cpu")
    batch = make_regular_synthetic_batch(0, parts, N=n, P=P, S=len(parts), feat_dim=8,
                                         device="cpu")
    x = torch.randn(batch.points.shape, generator=torch.Generator().manual_seed(1))
    ts = torch.full((batch.S,), 0.5)
    mesh = make_mesh(device="cpu") if ring else None
    with telemetry.counted("dit.") as routes:
        got = dit_forward(params, cfg, x, ts, batch, P, ring_mesh=mesh)
    assert routes == dict(fused=fused, unfused=unfused)
    if ring:
        _rel_close(got.numpy(), dit_forward(params, cfg, x, ts, batch, P).numpy(), 1e-5,
                   "ring of one rank vs local")
