"""The port's training slice against rap_tpu on the CPU, same inputs and draws.

- ``core/flow``: each timestep scheme's transform on the draws jax.random
  made, the interpolation and the three losses (fp32, 1e-6).
- ``training_forward``: loss and every gradient leaf against
  ``jax.value_and_grad`` of rap_tpu's training_forward, with t and x_1 fixed
  on both sides, through the tiny fused Pallas config (interpret mode) at
  fp32, remat on. Tolerance 2e-5 relative for the loss and 1e-4 of the
  largest element per gradient leaf: fp32 sums in other orders through two
  layers of attention.
- the optimizer: three updates of AdamW and of Muon from the same
  parameters and gradients as optax's ``build_optimizer`` (a learning-rate
  milestone and the clip on both sides of its threshold inside the three),
  then a fourth with a non-finite gradient; 1e-4 of the largest update per
  leaf (Newton-Schulz runs fp32 on the CPU on both sides).
- one whole ``make_train_step`` step against rap_tpu's, and the non-finite
  guard: a NaN noise skips the update on both sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rap_tpu.core import flow as jflow
from rap_tpu.core.batch import make_regular_synthetic_batch as jax_batch
from rap_tpu.registration import RPFConfig as JaxRPFConfig
from rap_tpu.registration import training_forward as jax_training_forward
from rap_tpu.train.optim import OptimizerConfig as JaxOptimizerConfig
from rap_tpu.train.optim import build_optimizer
from rap_tpu.train.step import TrainState as JaxTrainState
from rap_tpu.train.step import make_train_step as jax_make_train_step
from rap_tpu_torch.core import flow
from rap_tpu_torch.models.dit import master_params
from rap_tpu_torch.registration import RPFConfig, training_forward
from rap_tpu_torch.train.optim import (Optimizer, OptimizerConfig, apply_updates,
                                       newton_schulz_orthogonalize, tree_paths,
                                       tree_replace)
from rap_tpu_torch.train.step import TrainState, make_train_step
from torch_parity import batch_to_torch, jax_flat, max_err, t, tiny_pallas_models

S, P, N = 2, 2, 128


def _rel_close(got, ref, rtol, what=""):
    ref = np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = max_err(got, ref)
    assert err <= rtol * scale, f"{what}: max err {err:.3e} > {rtol:.0e} * {scale:.3e}"


# --------------------------------------------------------------------------
# core/flow
# --------------------------------------------------------------------------

def _jax_draws(scheme, key, n):
    """The draws rap_tpu's sample_timesteps makes, and the port transform
    that turns them into timesteps."""
    if scheme in ("u_shaped", "mode", "uniform"):
        u = np.asarray(jax.random.uniform(key, (n,)))
        fn = {"u_shaped": flow._u_shaped, "mode": flow._mode,
              "uniform": lambda x: x}[scheme]
        return lambda: fn(t(u))
    if scheme == "logit_normal":
        z = np.asarray(jax.random.normal(key, (n,)))
        return lambda: flow._logit_normal(t(z))
    if scheme == "late_heavy":
        k_base, k_late, k_pick = jax.random.split(key, 3)
        base = np.asarray(jax.random.uniform(k_base, (n,)))
        late = np.asarray(jax.random.uniform(k_late, (n,), minval=0.7, maxval=1.0))
        pick = np.asarray(jax.random.bernoulli(k_pick, 0.5, (n,)))
        return lambda: flow._late_heavy(t(base), t(late), t(pick))
    idx = np.asarray(jax.random.randint(key, (n,), 0, 4))
    return lambda: flow._euler_grid(t(idx), 4)


@pytest.mark.parametrize("scheme", ["u_shaped", "logit_normal", "mode", "uniform",
                                    "late_heavy", "euler4"])
def test_timestep_transforms_match_jax(scheme):
    key = jax.random.key(7)
    ref = np.asarray(jflow.sample_timesteps(key, 64, scheme))
    got = _jax_draws(scheme, key, 64)().clamp(0.01, 1.0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("scheme", ["u_shaped", "logit_normal", "mode", "uniform",
                                    "late_heavy", "euler4"])
def test_sample_timesteps_range(scheme):
    ts = flow.sample_timesteps(torch.Generator().manual_seed(0), 256, scheme)
    assert ts.shape == (256,) and ts.dtype == torch.float32
    assert float(ts.min()) >= np.float32(0.01) and float(ts.max()) <= 1.0


@pytest.mark.parametrize("loss_type", ["mse", "l1", "huber"])
def test_flow_losses_match_jax(loss_type):
    rng = np.random.default_rng(3)
    x0, x1, vp = (rng.standard_normal((4, 16, 3)).astype(np.float32) * 2 for _ in range(3))
    tt = rng.uniform(size=(4, 16, 1)).astype(np.float32)
    mask = rng.uniform(size=(4, 16)) > 0.3
    jx, jv = jflow.flow_interpolate(x0, x1, tt)
    px, pv = flow.flow_interpolate(t(x0), t(x1), t(tt))
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-6)
    ref = jflow.velocity_loss(jnp.asarray(vp), jv, jnp.asarray(mask), loss_type)
    got = flow.velocity_loss(t(vp), pv, t(mask), loss_type)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    for a, b in zip(flow.velocity_norms(t(vp), pv, t(mask)),
                    jflow.velocity_norms(jnp.asarray(vp), jv, jnp.asarray(mask))):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


# --------------------------------------------------------------------------
# training_forward
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg, jp, tp = tiny_pallas_models()
    jb = jax_batch(jax.random.key(0), [[N] * P] * S, N=N, P=P, S=S,
                   feat_dim=jcfg.local_feat_dim)
    return dict(jr=JaxRPFConfig(model=jcfg), tr=RPFConfig(model=tcfg), jp=jp,
                tp=master_params(tp, "cpu"), jb=jb, tb=batch_to_torch(jb))


def _jax_draws_of(jr, rng, shape):
    """The t and x_1 that rap_tpu's training_forward draws from ``rng``."""
    k_t, k_noise, _ = jax.random.split(rng, 3)
    ts = jflow.sample_timesteps(k_t, S, jr.timestep_sampling)
    return np.asarray(ts), np.asarray(jax.random.normal(k_noise, shape, jnp.float32))


def test_training_forward_loss_and_gradients_match_jax(tiny):
    rng = jax.random.key(5)
    ts, x_1 = _jax_draws_of(tiny["jr"], rng, (S * P, N, 3))
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: jax_training_forward(p, tiny["jr"], tiny["jb"], rng, remat=True),
        has_aux=True)(tiny["jp"])
    leaves = {k: v.detach().requires_grad_(True) for k, v in tree_paths(tiny["tp"])}
    loss, m = training_forward(tree_replace(tiny["tp"], leaves), tiny["tr"], tiny["tb"],
                               None, remat=True, x_1=t(x_1), t=t(ts))
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    _rel_close(loss.detach().numpy(), jloss, 2e-5, "loss")
    for name, v in jm.items():
        _rel_close(m[name].numpy(), v, 2e-5, name)
    ref = jax_flat(jg)
    assert set(ref) == set(grads)
    for k, g in grads.items():
        _rel_close(g.numpy(), ref[k], 1e-4, k)


def test_training_forward_refuses_what_is_not_ported(tiny):
    """The pose loss and FF dropout, refused before they were ported, now
    run (their parity: test_torch_trainer.py); what is still refused is FF
    dropout with neither a generator nor keep masks to draw from."""
    tb, tp = tiny["tb"], tiny["tp"]
    cfg = dataclasses.replace(tiny["tr"], pose_loss_weight=0.1)
    loss, m = training_forward(tp, cfg, tb, torch.Generator().manual_seed(0))
    assert np.isfinite(float(loss)) and float(m["pose_loss"]) >= 0.0
    assert float(loss) == pytest.approx(float(m["loss"]) + 0.1 * float(m["pose_loss"]), rel=1e-6)
    cfg = dataclasses.replace(tiny["tr"], model=dataclasses.replace(tiny["tr"].model,
                                                                    dropout_rate=0.1))
    loss, _ = training_forward(tp, cfg, tb, torch.Generator().manual_seed(0))
    assert np.isfinite(float(loss))
    with pytest.raises(ValueError, match="generator"):
        training_forward(tp, cfg, tb, None, x_1=torch.zeros(S * P, N, 3), t=torch.ones(S))


def test_training_bounds_follow_the_gains(tiny, monkeypatch):
    """The guard bound of every attention call is computed from the gains
    the forward sees, never a bound attached earlier."""
    from rap_tpu_torch.ops import flash_attention as fa

    seen = []
    real = fa._FlashAttention.apply
    monkeypatch.setattr(fa._FlashAttention, "apply",
                        lambda *a: seen.append(a[3]) or real(*a))
    tp = master_params(tiny["tp"], "cpu")
    for lp in tp["layers"]:
        lp["self_bound2"] = lp["global_bound2"] = 1e9  # stale: must be ignored
        lp["self_q_gamma"] = lp["self_q_gamma"] * 2
    training_forward(tp, tiny["tr"], tiny["tb"], torch.Generator().manual_seed(0),
                     remat=False)
    expect = []
    for lp in tp["layers"]:
        for prefix in ("self", "global"):
            expect.append(np.log2(np.e) * 8.0 * float(lp[f"{prefix}_q_gamma"].abs().max())
                          * float(lp[f"{prefix}_k_gamma"].abs().max()))
    np.testing.assert_allclose(seen, expect, rtol=1e-6)


# --------------------------------------------------------------------------
# optimizer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["adamw", "muon"])
def test_optimizer_matches_optax(tiny, name):
    kw = dict(name=name, lr_milestones=(1, 2))  # lr halves after updates 1 and 2
    jtx = build_optimizer(JaxOptimizerConfig(**kw))
    opt = Optimizer(OptimizerConfig(**kw))
    jp, tp = tiny["jp"], tiny["tp"]
    jstate, tstate = jtx.init(jp), opt.init(tp)
    rng = np.random.default_rng(9)
    j0 = jax_flat(jp)
    for i, scale in enumerate((0.001, 0.3, 0.01, np.nan)):  # global norm < 0.5 first
        gtree = jax.tree.map(
            lambda a: jnp.asarray(rng.standard_normal(a.shape) * scale, jnp.float32), jp)
        gflat = jax_flat(gtree)
        jup, jstate = jtx.update(gtree, jstate, jp)
        tup, tstate = opt.update(tree_replace(tp, {k: t(v) for k, v in gflat.items()}),
                                 tstate, tp)
        jup = jax_flat(jup)
        if np.isnan(scale):
            assert all(np.isnan(v).all() for v in jup.values())
            assert all(bool(torch.isnan(v).all()) for v in tup.values())
            break
        for k, u in tup.items():
            _rel_close(u.numpy(), jup[k], 1e-4, f"update {i} {k}")
        jp = _apply_flat(jp, jup)
        tp = apply_updates(tp, tup)
        for k, v in tree_paths(tp):
            np.testing.assert_allclose(v.numpy(), jax_flat(jp)[k], rtol=1e-5, atol=1e-6)
    assert int(tstate["count"]) == 4  # optax counts the NaN update too (the step guards)


def _apply_flat(jtree, flat_updates):
    """Add port-path updates to a rap_tpu parameter tree."""
    flat = jax_flat(jtree)

    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in node.items()}
        path = prefix[:-1]
        if path.startswith("layers/"):
            sub = path[len("layers/"):]
            L = node.shape[0]
            return jnp.stack([flat[f"layers/{i}/{sub}"] + flat_updates[f"layers/{i}/{sub}"]
                              for i in range(L)])
        return jnp.asarray(flat[path] + flat_updates[path])

    return walk(jtree, "")


@pytest.mark.parametrize("shape", [(128, 384), (384, 128), (2, 64)])
def test_newton_schulz_matches_jax(shape):
    from rap_tpu.train.optim import newton_schulz_orthogonalize as jax_ns

    m = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    _rel_close(newton_schulz_orthogonalize(t(m)).numpy(), jax_ns(jnp.asarray(m)), 1e-5)


# --------------------------------------------------------------------------
# the whole step
# --------------------------------------------------------------------------

def _steps(tiny, x_1_override=None):
    jtx = build_optimizer(JaxOptimizerConfig())
    rng = jax.random.key(11)
    # the jitted step donates its state: hand it copies
    jstate = JaxTrainState.create(jax.tree.map(jnp.copy, tiny["jp"]), jtx, rng)
    _, sub = jax.random.split(rng)
    ts, x_1 = _jax_draws_of(tiny["jr"], sub, (S * P, N, 3))
    if x_1_override is not None:
        x_1 = x_1_override
        jstep = jax_make_train_step(tiny["jr"], jtx, with_noise=True)
        jstate2, jm = jstep(jstate, tiny["jb"], jnp.asarray(x_1))
    else:
        jstate2, jm = jax_make_train_step(tiny["jr"], jtx)(jstate, tiny["jb"])
    tstate = TrainState.create(tiny["tp"], OptimizerConfig(), seed=0, device="cpu")
    tstep = make_train_step(tiny["tr"], OptimizerConfig(), device="cpu")
    tstate2, tm = tstep(tstate, tiny["tb"], x_1=t(x_1), t=t(ts))
    return jstate2, jm, tstate, tstate2, tm


def test_train_step_matches_jax(tiny):
    jstate, jm, _, tstate, tm = _steps(tiny)
    for name in ("loss", "grad_norm", "norm_v_pred", "skipped_nonfinite"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=2e-5, atol=1e-7)
    assert int(tstate.step) == int(jstate.step) == 1
    ref = jax_flat(jstate.params)
    for k, v in tree_paths(tstate.params):
        np.testing.assert_allclose(v.numpy(), ref[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_train_step_skips_a_nonfinite_update(tiny):
    nan_noise = np.full((S * P, N, 3), np.nan, np.float32)
    jstate, jm, t0, tstate, tm = _steps(tiny, nan_noise)
    assert float(jm["skipped_nonfinite"]) == float(tm["skipped_nonfinite"]) == 1.0
    assert not np.isfinite(float(tm["grad_norm"]))
    assert int(tstate.step) == 1 and int(tstate.opt_state["count"]) == 0
    before = dict(tree_paths(t0.params))
    for k, v in tree_paths(tstate.params):
        assert torch.equal(v, before[k]), k
    for k, v in tstate.opt_state["momentum"].items():
        assert not bool(v.any()), k
