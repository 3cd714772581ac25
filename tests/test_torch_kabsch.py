"""The Kabsch kernel's wrapper (``ops.kabsch``) and the routes of
``core.procrustes`` on the CPU.

The kernel runs on the card only. Here its plain twin, ``_fit`` with the
SVD by ``svd3``'s Jacobi (the kernel's arithmetic) plus the forcing blend,
stands in for the launch under ``procrustes._card_fit``, so that the card
route's reshaping, broadcasting and mask folding run on the CPU: it is
held to the plain ``kabsch_masked`` path (``torch.linalg.svd``) to 1e-5 on
the cases the card tests run, the wrapper's refusals are checked before
any launch, and the routes are checked by what they count: ``sync.svd`` on
the CPU, none under a gradient.
"""

import numpy as np
import pytest
import torch

from kabsch_cases import CASES, torch_case
from rap_tpu_torch import telemetry
from rap_tpu_torch.core import procrustes, sampler
from rap_tpu_torch.ops import KERNELS, kabsch, launch_counts
from rap_tpu_torch.ops._build import QUERY_KERNELS, SIGNATURES

ATOL = 1e-5


def _twin(source, target, mask, weights=None, velocity=None, t=0.0, x_1=None, t_next=0.0):
    """``ops.kabsch`` in plain PyTorch on the inputs it takes (checked)."""
    kabsch.check(source, target, mask, weights, velocity, x_1)
    if velocity is not None:
        target = target - velocity * t
    R, tr = procrustes._fit(source, target, mask, weights, procrustes.svd3)
    if x_1 is None:
        return R, tr
    x0 = torch.where(mask[..., None], procrustes.transform_points(R, tr, source), target)
    return R, tr, x0 * (1.0 - t_next) + x_1 * t_next


@pytest.fixture
def card_route(monkeypatch):
    """``procrustes._card_fit`` with ``_twin`` in the launch's place."""
    monkeypatch.setattr(procrustes.kabsch_op, "kabsch", _twin)
    return procrustes._card_fit


def _residual(R, t, src, tgt, mask):
    fit = procrustes.transform_points(R, t, src)
    return float(torch.where(mask[..., None], fit - tgt, 0.0).abs().max())


@pytest.mark.parametrize("name", CASES)
def test_plain_twin_matches_kabsch_masked(card_route, name):
    """The card route over any leading shape, with the twin for the launch,
    against ``kabsch_masked``'s CPU path; a rank-1 cross-covariance leaves
    the rotation about the line free, so there both fits are held to their
    residual, and the twin to ``svd3``'s path."""
    src, tgt, mask, w = torch_case(name)
    R, t = card_route(src, tgt, mask, w)
    R_ref, t_ref = procrustes.kabsch_masked(src, tgt, mask, w)
    assert R.shape == R_ref.shape and t.shape == t_ref.shape
    np.testing.assert_allclose(torch.linalg.det(R.double()), 1.0, atol=1e-5)
    if name == "rank1":
        R_j, t_j = procrustes._fit(src, tgt, mask, w, procrustes.svd3)
        assert float((R - R_j).abs().max()) < ATOL and float((t - t_j).abs().max()) < ATOL
        assert _residual(R, t, src, tgt, mask) < 1e-4
        assert _residual(R_ref, t_ref, src, tgt, mask) < 1e-4
        return
    assert float((R - R_ref).abs().max()) < ATOL
    assert float((t - t_ref).abs().max()) < ATOL


@pytest.mark.parametrize("form", ["broadcast", "float_mask"])
def test_card_route_takes_what_the_plain_path_takes(card_route, form):
    """Leading shapes that broadcast (one source for three targets) and a
    mask of weights in [0, 1] with zeros (not bool) fit on the card route
    as on the plain path."""
    src, tgt, mask, _ = torch_case("random")
    if form == "broadcast":
        tgt = torch.stack([tgt, tgt + 1.0, tgt.flip(-2)])
        args = (src, tgt, mask[0])
    else:
        gen = torch.Generator().manual_seed(4)
        m = torch.rand(mask.shape, generator=gen)
        args = (src, tgt, torch.where(m > 0.2, m, 0.0))
    R, t = card_route(*args)
    R_ref, t_ref = procrustes.kabsch_masked(*args)
    assert R.shape == R_ref.shape and t.shape == t_ref.shape
    assert float((R - R_ref).abs().max()) < ATOL
    assert float((t - t_ref).abs().max()) < ATOL


def test_forced_state_twin_matches_rigidify_and_blend(card_route, monkeypatch):
    """``forced_state``'s card route (x_0_hat formed from x_t and v inside
    the launch), with the twin for the launch, against its CPU path:
    ``rigidify_prediction`` of x_t - v t plus the blend."""
    src, tgt, mask, _ = torch_case("padded")
    gen = torch.Generator().manual_seed(0)
    v = torch.randn(tgt.shape, generator=gen)
    x_1 = torch.randn(tgt.shape, generator=gen)
    t, t_next = 0.7, 0.6
    x_t = tgt + v * t
    want = procrustes.forced_state(src, mask, x_1, t_next, x_t, v, t)
    ref = procrustes.rigidify_prediction(x_t - v * t, src, mask) * (1.0 - t_next) + x_1 * t_next
    assert torch.equal(want, ref)
    got = card_route(src, x_t, mask, velocity=v, t=t, x_1=x_1, t_next=t_next)[2]
    assert got.shape == want.shape
    assert float((got - want).abs().max()) < ATOL * 10  # points ~1e3 where padded
    assert float((got - want)[mask].abs().max()) < ATOL


def test_forcing_without_trajectory_matches_with():
    """The sampler's forcing step gives the same final state whether or not
    it keeps the trajectory."""
    src, tgt, mask, _ = torch_case("random")
    x_1 = torch.randn(src.shape, generator=torch.Generator().manual_seed(1))

    def field(x, t):
        return (x - tgt) / max(t, 1e-3)

    kw = dict(num_steps=4, rigidity_forcing=True)
    a = sampler.flow_sampler(field, x_1, src, mask, return_trajectory=False, **kw)
    b = sampler.flow_sampler(field, x_1, src, mask, return_trajectory=True, **kw)
    assert a.trajectory is None
    torch.testing.assert_close(a.x_final, b.x_final, rtol=0, atol=0)


def _inputs(B=2, N=16):
    src = torch.randn(B, N, 3)
    return dict(source=src, target=src + 1.0, mask=torch.ones(B, N, dtype=torch.bool))


@pytest.mark.parametrize("fault", ["float64", "bf16_velocity", "int_mask", "mask_3d",
                                   "target_shape", "weights_shape", "x_1_shape",
                                   "not_contiguous", "device_mix", "cpu"])
def test_wrapper_refuses_what_the_kernel_does_not_take(fault):
    """Each fault raises with its own reason; CPU tensors, which the kernel
    does not take either, raise last."""
    kw = _inputs()
    if fault == "float64":
        kw["source"] = kw["source"].double()
    elif fault == "bf16_velocity":
        kw["velocity"] = kw["target"].bfloat16()
    elif fault == "int_mask":
        kw["mask"] = kw["mask"].int()
    elif fault == "mask_3d":
        kw["mask"] = kw["mask"][None]
    elif fault == "target_shape":
        kw["target"] = torch.randn(2, 17, 3)
    elif fault == "weights_shape":
        kw["weights"] = torch.ones(2, 15)
    elif fault == "x_1_shape":
        kw["x_1"] = torch.randn(2, 16, 4)
    elif fault == "not_contiguous":
        kw["source"] = torch.randn(2, 3, 16).transpose(1, 2)
    elif fault == "device_mix":
        kw["target"] = kw["target"].to("meta")
    reason = {"float64": "dtype", "bf16_velocity": "dtype", "int_mask": "dtype",
              "not_contiguous": "contiguous", "device_mix": "more than one device",
              "cpu": "CUDA tensors"}.get(fault, "shape")
    with pytest.raises(ValueError, match=reason):
        kabsch.kabsch(**kw)


def test_launch_counts_list_kabsch():
    assert "kabsch" in KERNELS and "kabsch" in launch_counts()
    assert "rtt_kabsch" in SIGNATURES
    assert QUERY_KERNELS["rtt_kabsch_attributes"] == ("kabsch_kernel",)


def test_routes_by_device_and_gradient(monkeypatch):
    """The CPU path calls ``torch.linalg.svd`` once a fit (``sync.svd``);
    under a gradient ``svd3`` runs, counts nothing and its gradient matches
    a finite difference of the fitted pose."""
    src, tgt, mask, _ = torch_case("random")
    with telemetry.counted("sync.") as syncs:
        procrustes.kabsch_masked(src, tgt, mask)
    assert syncs["svd"] == 1
    calls = []
    monkeypatch.setattr(procrustes, "svd3", lambda H: calls.append(H) or procrustes._SVD3.apply(H))
    x = tgt.double().requires_grad_()
    with telemetry.counted("sync.") as syncs:
        R, t = procrustes.kabsch_masked(src, x, mask)
        loss = (R * torch.arange(9.0).reshape(3, 3)).sum() + t.square().sum()
        loss.backward()
    assert syncs["svd"] == 0 and len(calls) == 1
    assert torch.isfinite(x.grad).all()
    direction = torch.randn(x.shape, generator=torch.Generator().manual_seed(2), dtype=x.dtype)
    eps = 1e-2

    def value(d):
        with torch.no_grad():
            R_, t_ = procrustes._fit(src, tgt + d * direction, mask, None, procrustes.svd3)
            return float((R_ * torch.arange(9.0).reshape(3, 3)).sum() + t_.square().sum())

    numeric = (value(eps) - value(-eps)) / (2 * eps)
    analytic = float((x.grad * direction).sum())
    assert analytic == pytest.approx(numeric, rel=2e-2, abs=1e-3)
