"""The rest of the port's sampler against rap_tpu on the CPU, same inputs:
the explicit timestep grid, the path linearity, the pruned coarse-then-fine
sampler, the transformer features and the trimmed-ICP pose refinement.

The models are tiny fp32 DiTs (D=128, H=2, 2 layers) whose attention takes
the dense route on both sides (sequences under 1024, ``attn_impl="auto"``).
The pruned sampler draws its index set from a JAX key in rap_tpu; the port
takes that set as ``prune_index``, so both integrate the same points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rap_tpu.core.batch import make_regular_synthetic_batch as jax_batch
from rap_tpu.core.sampler import compute_linearity as jax_linearity
from rap_tpu.core.sampler import flow_sampler as jax_flow_sampler
from rap_tpu.core.sampler import make_schedule as jax_make_schedule
from rap_tpu.models import DiTConfig as JaxDiTConfig
from rap_tpu.models.dit import init_dit_params
from rap_tpu.registration import RPFConfig as JaxRPFConfig
from rap_tpu.registration import refine_poses_icp as jax_refine
from rap_tpu.registration import sample as jax_sample
from rap_tpu_torch.config import load_config
from rap_tpu_torch.core.sampler import compute_linearity, flow_sampler, make_schedule
from rap_tpu_torch.models.config import DiTConfig
from rap_tpu_torch.models.dit import dit_forward
from rap_tpu_torch.registration import RPFConfig, prune_size, refine_poses_icp, sample
from torch_parity import batch_to_torch, max_err, params_to_torch, t


def _field(x, ts):
    """A velocity field both packages evaluate alike."""
    return 0.5 * x + ts


@pytest.mark.parametrize("forcing", [False, True])
def test_flow_sampler_explicit_grid_matches_jax(forcing):
    """``ts`` overrides num_steps/schedule and ``x_start`` starts the
    integration there: a cosine grid split into two segments, the second
    from the first's end, equals rap_tpu's on the same split (1e-5)."""
    rng = np.random.default_rng(0)
    x_1 = rng.standard_normal((4, 64, 3)).astype(np.float32)
    cond = rng.standard_normal((4, 64, 3)).astype(np.float32)
    mask = np.ones((4, 64), bool)
    mask[1, 50:] = False
    ts = np.asarray(jax_make_schedule(5, "cosine"))
    assert np.array_equal(ts, make_schedule(5, "cosine"))
    j0 = jax_flow_sampler(_field, jnp.asarray(x_1), jnp.asarray(cond), jnp.asarray(mask),
                          rigidity_forcing=forcing, return_trajectory=False, ts=jnp.asarray(ts[:3]))
    j1 = jax_flow_sampler(_field, jnp.asarray(x_1), jnp.asarray(cond), jnp.asarray(mask),
                          rigidity_forcing=forcing, return_trajectory=True, ts=jnp.asarray(ts[2:]),
                          x_start=j0.x_final)
    t0 = flow_sampler(_field, t(x_1), t(cond), t(mask), rigidity_forcing=forcing,
                      return_trajectory=False, ts=ts[:3])
    t1 = flow_sampler(_field, t(x_1), t(cond), t(mask), rigidity_forcing=forcing,
                      return_trajectory=True, ts=ts[2:], x_start=t0.x_final)
    assert t1.trajectory.shape[0] == 3
    assert max_err(t1.x_final.numpy(), j1.x_final) <= 1e-5
    assert max_err(t1.end_point_trajectory.numpy(), j1.end_point_trajectory) <= 1e-5


def test_compute_linearity_matches_jax():
    rng = np.random.default_rng(1)
    traj = rng.standard_normal((5, 3, 40, 3)).astype(np.float32)
    traj[:, 0, 5] = traj[0, 0, 5]  # a point that never moves: path 0
    mask = rng.random((3, 40)) < 0.8
    ref = np.asarray(jax_linearity(jnp.asarray(traj), jnp.asarray(mask)))
    got = compute_linearity(t(traj), t(mask)).numpy()
    assert max_err(got, ref) <= 1e-5
    assert (got[~mask] == 0).all()


def _models(seed: int = 1):
    jcfg = JaxDiTConfig(embed_dim=128, num_layers=2, num_heads=2, compute_dtype=jnp.float32)
    tcfg = DiTConfig(embed_dim=128, num_layers=2, num_heads=2, compute_dtype=torch.float32)
    jp = init_dit_params(jax.random.key(seed), jcfg)
    return jcfg, tcfg, jp, params_to_torch(jp)


@pytest.fixture(scope="module")
def models():
    return _models()


def _jax_index(key, N: int, n_sub: int) -> np.ndarray:
    """rap_tpu's index set (registration.py:204-206)."""
    return np.asarray(jnp.sort(jax.random.permutation(jax.random.fold_in(key, 0x5B5), N)[:n_sub]))


@pytest.mark.parametrize("N", [100, 128, 300, 512, 700, 4096])
@pytest.mark.parametrize("factor", [1, 3, 4, 8])
def test_prune_size_is_rap_tpus_rule(N, factor):
    assert prune_size(N, factor) == min(max(-(-N // factor) // 128 * 128, 128), N)


@pytest.mark.parametrize("factor,coarse,padded", [(1, 1, False), (4, 1, False), (4, 2, True)])
def test_pruned_sample_matches_jax(models, factor, coarse, padded):
    """The pruned coarse-then-fine sampler on rap_tpu's index set and noise:
    dense and padded batches, one and two coarse steps (points 1e-4)."""
    jcfg, tcfg, jp, tp = models
    N, steps = 512, 3
    parts = [[400, 512], [512, 300]] if padded else [[N, N], [N, N]]
    jb = jax_batch(jax.random.key(0), parts, N=N, P=2, S=2, feat_dim=jcfg.local_feat_dim)
    tb = batch_to_torch(jb)
    assert tb.no_padding != padded
    x_1 = np.random.default_rng(7).standard_normal((4, N, 3)).astype(np.float32)
    key = jax.random.key(5)
    jr = JaxRPFConfig(model=jcfg, inference_sampling_steps=steps, prune_coarse_steps=coarse,
                      prune_factor=factor)
    tr = RPFConfig(model=tcfg, inference_sampling_steps=steps, prune_coarse_steps=coarse,
                   prune_factor=factor)
    jo = jax_sample(jp, jr, jb, key, x_1=jnp.asarray(x_1), return_trajectory=False)
    idx = _jax_index(key, N, prune_size(N, factor))
    to = sample(tp, tr, tb, x_1=t(x_1), return_trajectory=False, prune_index=t(idx))
    assert max_err(to["points"].numpy(), jo["points"]) <= 1e-4
    if factor > 1:  # the coarse segment's subsample matters: another set moves the output
        other = np.sort(np.random.default_rng(3).permutation(N)[:len(idx)])
        moved = sample(tp, tr, tb, x_1=t(x_1), return_trajectory=False, prune_index=t(other))
        assert max_err(moved["points"].numpy(), jo["points"]) > 1e-3


def test_pruned_sample_draws_its_index_from_the_generator(models):
    """Without ``prune_index`` the sorted set is drawn after the noise from
    the generator: the same seed gives the same output as passing that set."""
    _, tcfg, _, tp = models
    from rap_tpu_torch.core.batch import make_regular_synthetic_batch

    tb = make_regular_synthetic_batch(0, [[512, 512]], N=512, P=2,
                                      feat_dim=tcfg.local_feat_dim, device="cpu")
    tr = RPFConfig(model=tcfg, inference_sampling_steps=2, prune_coarse_steps=1)
    out = sample(tp, tr, tb, generator=torch.Generator().manual_seed(9), return_trajectory=False)
    gen = torch.Generator().manual_seed(9)
    x_1 = torch.randn(tb.points.shape, generator=gen)
    idx = torch.randperm(512, generator=gen)[:128].sort().values
    ref = sample(tp, tr, tb, x_1=x_1, return_trajectory=False, prune_index=idx)
    assert torch.equal(out["points"], ref["points"])
    with pytest.raises(ValueError, match="prune_index"):
        sample(tp, tr, tb, x_1=x_1, return_trajectory=False, prune_index=idx[:64])


def test_prune_factor_is_a_config_key():
    cfg = load_config("configs/rap_inference.yaml",
                      ["pipeline.prune_coarse_steps=1", "pipeline.prune_factor=2"])
    assert (cfg.pipeline.prune_coarse_steps, cfg.pipeline.prune_factor) == (1, 2)


@pytest.mark.parametrize("prune", [0, 1])
def test_transformer_features_match_jax(models, prune):
    """One more forward at the final state and t = 1/steps, plain and
    pruned: the port's features are its forward's at its own final state,
    and that forward at rap_tpu's final state gives rap_tpu's features
    within 1e-5 of the largest. (The states themselves agree to ~3e-6; this
    random DiT's features move ~80x that, so the features are compared from
    one state.)"""
    jcfg, tcfg, jp, tp = models
    N, steps = 256, 2
    jb = jax_batch(jax.random.key(1), [[N, 200], [N, N]], N=N, P=2, S=2,
                   feat_dim=jcfg.local_feat_dim)
    tb = batch_to_torch(jb)
    x_1 = np.random.default_rng(8).standard_normal((4, N, 3)).astype(np.float32)
    key = jax.random.key(2)
    jr = JaxRPFConfig(model=jcfg, inference_sampling_steps=steps, prune_coarse_steps=prune)
    tr = RPFConfig(model=tcfg, inference_sampling_steps=steps, prune_coarse_steps=prune)
    jo = jax_sample(jp, jr, jb, key, x_1=jnp.asarray(x_1), return_trajectory=False,
                    return_transformer_features=True)
    to = sample(tp, tr, tb, x_1=t(x_1), return_trajectory=False,
                return_transformer_features=True,
                prune_index=t(_jax_index(key, N, prune_size(N, 4))))
    assert max_err(to["points"].numpy(), jo["points"]) <= 1e-4
    ts = torch.full((2,), 1.0 / steps)
    got = to["transformer_features"]
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, N, 128)
    assert torch.equal(got, dit_forward(tp, tcfg, to["points"], ts, tb, 2, return_features=True)[1])
    ref = np.asarray(jo["transformer_features"])
    from_ref = dit_forward(tp, tcfg, t(np.asarray(jo["points"])), ts, tb, 2, return_features=True)[1]
    assert max_err(from_ref.numpy(), ref) <= 1e-5 * np.abs(ref).max()


def _icp_batch():
    """Two samples, three part slots (the second sample with two parts and
    one invalid slot); the anchor of sample 1 is its second part."""
    jb = jax_batch(jax.random.key(4), [[120, 96, 80], [64, 120]], N=128, P=3, S=2, feat_dim=8)
    jb = jb.replace(anchor_part=jnp.asarray([True, False, False, False, True, False]))
    return jb


@pytest.mark.parametrize("yaw_restarts", [1, 4])
def test_refine_poses_icp_matches_jax(yaw_restarts):
    """Trimmed ICP of each non-anchor part onto its anchor from perturbed
    ground-truth poses, with K yaw starts (1e-4); anchor and invalid parts
    come back unchanged."""
    jb = _icp_batch()
    tb = batch_to_torch(jb)
    rng = np.random.default_rng(6)
    from scipy.spatial.transform import Rotation

    noise = Rotation.from_rotvec(rng.normal(0, 0.15, (6, 3))).as_matrix().astype(np.float32)
    R = np.einsum("gij,gjk->gik", noise, np.asarray(jb.rotations_gt)).astype(np.float32)
    tr = (np.asarray(jb.translations_gt) + rng.normal(0, 0.05, (6, 3))).astype(np.float32)
    jR, jt = jax_refine(jb, jnp.asarray(R), jnp.asarray(tr), iters=10,
                        yaw_restarts=yaw_restarts)
    tR, tt = refine_poses_icp(tb, t(R), t(tr), iters=10, yaw_restarts=yaw_restarts)
    assert max_err(tR.numpy(), jR) <= 1e-4
    assert max_err(tt.numpy(), jt) <= 1e-4
    keep = np.asarray(jb.anchor_part) | ~np.asarray(jb.part_valid)
    assert np.array_equal(tR.numpy()[keep], R[keep]) and np.array_equal(tt.numpy()[keep], tr[keep])
    assert max_err(tR.numpy()[~keep], R[~keep]) > 1e-3  # the other parts moved
