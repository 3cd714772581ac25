"""The port's pose fitting and ODE sampler against rap_tpu's, on the CPU.

Degenerate Kabsch cases (a 1-point part, an empty part, a reflection) and a
random rigid recovery go through both ``kabsch_masked``; the samplers run an
analytic velocity field with every method and schedule. fp32 throughout;
tolerances 1e-5 absolute (3x3 SVDs of different libraries).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rap_tpu.core import procrustes as jproc
from rap_tpu.core import sampler as jsampler
from rap_tpu_torch.core import procrustes, sampler
from torch_parity import max_err, t

ATOL = 1e-5


def _rot(rng):
    q, r = np.linalg.qr(rng.standard_normal((3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q.astype(np.float32)


def _both(src, tgt, mask):
    jR, jt = jproc.kabsch_masked(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask))
    tR, tt = procrustes.kabsch_masked(t(src), t(tgt), t(mask))
    return (np.asarray(jR), np.asarray(jt)), (tR.numpy(), tt.numpy())


def test_random_rigid_recovery_matches_jax():
    rng = np.random.default_rng(0)
    G, N = 4, 64
    src = rng.standard_normal((G, N, 3)).astype(np.float32)
    R = np.stack([_rot(rng) for _ in range(G)])
    tr = rng.standard_normal((G, 3)).astype(np.float32)
    tgt = np.einsum("gij,gnj->gni", R, src) + tr[:, None]
    mask = np.ones((G, N), bool)
    (jR, jt), (tR, tt) = _both(src, tgt, mask)
    assert max_err(tR, R) < 1e-4 and max_err(tt, tr) < 1e-4
    assert max_err(tR, jR) < ATOL and max_err(tt, jt) < ATOL


@pytest.mark.parametrize("case", ["one_point", "empty", "reflection"])
def test_degenerate_parts_match_jax(case):
    rng = np.random.default_rng(1)
    G, N = 3, 32
    src = rng.standard_normal((G, N, 3)).astype(np.float32)
    tgt = src + rng.standard_normal((G, 1, 3)).astype(np.float32)
    mask = np.ones((G, N), bool)
    if case == "one_point":
        mask[1] = False
        mask[1, 5] = True
    elif case == "empty":
        mask[2] = False
    else:  # target is the mirror image: the det fix must still give det +1
        tgt = src * np.array([1.0, 1.0, -1.0], np.float32)
    (jR, jt), (tR, tt) = _both(src, tgt, mask)
    assert np.isfinite(tR).all() and np.isfinite(tt).all()
    np.testing.assert_allclose(np.linalg.det(tR), 1.0, atol=1e-5)
    assert max_err(tR, jR) < ATOL
    assert max_err(tt, jt) < ATOL
    if case == "one_point":
        np.testing.assert_allclose(tR[1], np.eye(3), atol=1e-6)
        np.testing.assert_allclose(tt[1], tgt[1, 5] - src[1, 5], atol=1e-5)
    if case == "empty":
        np.testing.assert_allclose(tR[2], np.eye(3), atol=1e-6)
        np.testing.assert_allclose(tt[2], 0.0)


def test_rigidify_prediction_matches_jax():
    rng = np.random.default_rng(2)
    G, N = 3, 48
    cond = rng.standard_normal((G, N, 3)).astype(np.float32)
    pred = rng.standard_normal((G, N, 3)).astype(np.float32)
    mask = rng.random((G, N)) > 0.2
    ref = jproc.rigidify_prediction(jnp.asarray(pred), jnp.asarray(cond), jnp.asarray(mask))
    got = procrustes.rigidify_prediction(t(pred), t(cond), t(mask))
    assert max_err(got.numpy(), ref) < ATOL


@pytest.mark.parametrize("schedule", ["uniform", "cosine", "power:2"])
def test_make_schedule_matches_jax(schedule):
    np.testing.assert_array_equal(sampler.make_schedule(5, schedule),
                                  np.asarray(jsampler.make_schedule(5, schedule)))


@pytest.mark.parametrize("method", ["euler", "rk2", "rk4"])
@pytest.mark.parametrize("forcing", [False, True], ids=["free", "rigid"])
def test_flow_sampler_matches_jax(method, forcing):
    """Analytic field v(x, t) = (x - x0) / t pulls every point to a rigid x0."""
    rng = np.random.default_rng(3)
    G, N = 2, 40
    cond = rng.standard_normal((G, N, 3)).astype(np.float32)
    R = np.stack([_rot(rng) for _ in range(G)])
    x0 = np.einsum("gij,gnj->gni", R, cond).astype(np.float32)
    x1 = rng.standard_normal((G, N, 3)).astype(np.float32)
    mask = np.ones((G, N), bool)
    mask[1, -3:] = False

    def jfield(x, tt):
        return (x - jnp.asarray(x0)) / jnp.maximum(tt, 1e-3)

    def tfield(x, tt):
        return (x - t(x0)) / max(tt, 1e-3)

    kw = dict(num_steps=3, rigidity_forcing=forcing, method=method, schedule="cosine")
    ref = jsampler.flow_sampler(jfield, jnp.asarray(x1), jnp.asarray(cond),
                                jnp.asarray(mask), **kw)
    got = sampler.flow_sampler(tfield, t(x1), t(cond), t(mask), **kw)
    assert max_err(got.x_final.numpy(), ref.x_final) < 1e-4
    assert max_err(got.trajectory.numpy(), ref.trajectory) < 1e-4
    assert max_err(got.end_point_trajectory.numpy(), ref.end_point_trajectory) < 1e-4


def test_unknown_sampler_raises():
    with pytest.raises(ValueError, match="Unknown sampler"):
        sampler.flow_sampler(lambda x, tt: x, torch.zeros(1, 2, 3), torch.zeros(1, 2, 3),
                             torch.ones(1, 2, dtype=torch.bool), method="heun")
