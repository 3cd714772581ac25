"""The port's batch builders, segment reductions, FF dispatch and config
checks against rap_tpu on the CPU (fp32; exact where no sum is reordered,
1e-6 of the largest element where one is)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rap_tpu.core import segments as jseg
from rap_tpu.core.batch import make_synthetic_batch as jax_make_synthetic_batch
from rap_tpu.models.config import DiTConfig as JaxDiTConfig
from rap_tpu.ops import fused_ff as jff
from rap_tpu_torch.core import segments
from rap_tpu_torch.core.batch import make_synthetic_batch, validate
from rap_tpu_torch.models.config import DiTConfig
from rap_tpu_torch.ops import fused_ff
from torch_parity import batch_to_torch, max_err, t


def test_make_synthetic_batch_is_valid_and_padded():
    b = make_synthetic_batch(3, [2, 1], [[40, 25], [30]], N=48, G=5, S=3, device="cpu")
    validate(b)
    assert not b.no_padding
    assert b.sample_of_part.tolist() == [0, 0, 1, 1, 1]  # padded slots: last sample
    assert b.part_valid.tolist() == [True, True, True, False, False]
    assert b.sample_valid.tolist() == [True, True, False]
    assert b.points_per_part.tolist() == [40, 25, 30, 0, 0]
    posed = torch.einsum("gij,gnj->gni", b.rotations_gt, b.points) + b.translations_gt[:, None]
    err = ((posed - b.points_gt) * b.point_mask[..., None]).abs().max()
    assert float(err) < 1e-5


def test_batch_helpers_match_jax():
    jb = jax_make_synthetic_batch(jax.random.key(1), [2, 2], [[30, 12], [20, 7]], N=32,
                                  G=5, S=3)
    tb = batch_to_torch(jb)
    assert tb.num_tokens == jb.num_tokens
    for name in ("anchor_point_mask", "points_per_part", "part_seg_ids", "sample_seg_ids"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)),
                                      err_msg=name)
    x = np.arange(5 * 3, dtype=np.float32).reshape(5, 3)
    np.testing.assert_array_equal(tb.per_part_to_point(t(x)).numpy(),
                                  np.asarray(jb.per_part_to_point(jnp.asarray(x))))


def test_segment_reductions_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 10, 3)).astype(np.float32)
    mask = rng.random((6, 10)) > 0.4
    mask[2] = False
    sop = np.array([0, 0, 1, 1, 1, 2])
    w = rng.random(6).astype(np.float32)
    xp = rng.standard_normal((6, 4)).astype(np.float32)
    pairs = [
        (segments.masked_mean(t(x), t(mask)), jseg.masked_mean(x, mask)),
        (segments.masked_sum(t(x), t(mask)), jseg.masked_sum(x, mask)),
        (segments.per_sample_sum(t(xp), t(sop), 4), jseg.per_sample_sum(xp, sop, 4)),
        (segments.per_sample_mean(t(xp), t(w), t(sop), 4),
         jseg.per_sample_mean(xp, w, sop, 4)),
        (segments.masked_mse(t(x), t(x[::-1].copy()), t(mask)),
         jseg.masked_mse(x, x[::-1], mask)),
    ]
    for got, ref in pairs:
        ref = np.asarray(ref)
        assert tuple(got.shape) == ref.shape
        assert max_err(got.numpy(), ref) <= 1e-6 * max(np.abs(ref).max(), 1.0)


@pytest.mark.parametrize("rate", [-0.1, 1.0, 1.5])
def test_dropout_rate_outside_unit_interval_raises(rate):
    with pytest.raises(ValueError, match="dropout_rate"):
        JaxDiTConfig(dropout_rate=rate)
    with pytest.raises(ValueError, match="dropout_rate"):
        DiTConfig(dropout_rate=rate)


def test_dropout_rate_inside_unit_interval_builds():
    assert DiTConfig(dropout_rate=0.5).dropout_rate == 0.5
    assert dataclasses.replace(DiTConfig(), dropout_rate=0.0).dropout_rate == 0.0


def _ff_inputs(lead, D, fh, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    return (f(*lead, D), 1 + f(D, sc=0.1), f(D, sc=0.1), f(D, 2 * fh, sc=D ** -0.5),
            f(2 * fh, sc=0.1), f(fh, D, sc=fh ** -0.5), f(D, sc=0.1))


@pytest.mark.parametrize("case", ["d64", "tokens100"])
def test_ff_off_the_legal_rule_takes_the_reference(case, monkeypatch):
    """Where rap_tpu's legal rule fails (D not a multiple of 128, or a token
    count no block divides), the port runs the reference composition, value
    and gradient, as rap_tpu runs its XLA one."""
    lead, D, fh = {"d64": ((2, 64), 64, 256), "tokens100": ((100,), 128, 512)}[case]
    inputs = _ff_inputs(lead, D, fh)
    monkeypatch.setattr(fused_ff._GegluFF, "apply", lambda *a: pytest.fail("kernel route"))
    cot = np.random.default_rng(1).standard_normal(inputs[0].shape).astype(np.float32)
    ref, vjp = jax.vjp(lambda *a: jff.geglu_ff(*a, impl="auto"), *map(jnp.asarray, inputs))
    ref_g = vjp(jnp.asarray(cot))
    leaves = [t(a).requires_grad_(True) for a in inputs]
    got = fused_ff.geglu_ff(*leaves)
    got_g = torch.autograd.grad(got, leaves, t(cot))
    assert max_err(got.detach().numpy(), ref) <= 1e-5 * np.abs(np.asarray(ref)).max()
    for g_, r_ in zip(got_g, ref_g):
        r_ = np.asarray(r_)
        assert max_err(g_.numpy(), r_) <= 1e-5 * max(np.abs(r_).max(), 1e-30)


def test_ff_reference_bf16_matches_jax():
    """bf16 cast points of the composition: h, proj and act rounded to bf16,
    GELU in fp32 (1e-2 of the largest output: bf16 sums in another order)."""
    inputs = _ff_inputs((64,), 64, 256, seed=2)
    ref = jff._xla_reference(jnp.asarray(inputs[0], jnp.bfloat16),
                             *map(jnp.asarray, inputs[1:]))
    got = fused_ff.ff_reference(t(inputs[0]).to(torch.bfloat16), *map(t, inputs[1:]))
    assert got.dtype == torch.bfloat16
    ref = np.asarray(ref, np.float32)
    assert max_err(got.float().numpy(), ref) <= 1e-2 * np.abs(ref).max()
