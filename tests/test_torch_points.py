"""The port's point ops (rap_tpu_torch/ops/points.py) and geometric features
against rap_tpu's on the CPU, same numpy-seeded inputs.

rap_tpu backs ``voxel_downsample`` and ``fps_numpy`` with a C++ core when it
is built, which emits voxels in first-seen order; the port follows rap_tpu's
numpy path (sorted-key order), which these tests force on rap_tpu's side by
setting ``rap_tpu.native._LIB = None`` and ``_TRIED = True``. Indices and
counts are compared for equality, distances to 1e-5, inlier sets exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rap_tpu.native
from rap_tpu.data.synthetic_scenes import compute_geometric_features as jax_geometric
from rap_tpu.ops import points as J
from rap_tpu_torch.data.synthetic_scenes import compute_geometric_features
from rap_tpu_torch.ops import points as T
from torch_parity import max_err, t


@pytest.fixture
def numpy_path(monkeypatch):
    """rap_tpu without its C++ core: the numpy fallbacks."""
    monkeypatch.setattr(rap_tpu.native, "_LIB", None)
    monkeypatch.setattr(rap_tpu.native, "_TRIED", True)


def _cloud(seed: int, n: int = 3000, scale: float = 2.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.uniform(-scale, scale, (n, 3)) * [1.0, 0.7, 0.3]).astype(np.float32)


@pytest.mark.parametrize("voxel", [0.05, 0.2])
def test_voxel_keys_coverage_and_downsample_match(numpy_path, voxel):
    pts = _cloud(0)
    attrs = np.random.default_rng(1).standard_normal((len(pts), 5)).astype(np.float32)
    assert np.array_equal(T.voxel_keys(pts, voxel), J.voxel_keys(pts, voxel))
    assert T.voxel_coverage(pts, voxel) == J.voxel_coverage(pts, voxel)
    assert T.voxel_coverage(pts[:0], voxel) == J.voxel_coverage(pts[:0], voxel) == 0
    assert np.array_equal(T.voxel_downsample(pts, voxel), J.voxel_downsample(pts, voxel))
    got, got_a = T.voxel_downsample(pts, voxel, attrs)
    ref, ref_a = J.voxel_downsample(pts, voxel, attrs)
    assert np.array_equal(got, ref) and np.array_equal(got_a, ref_a)


def test_voxel_downsample_matches_the_native_core_as_a_set():
    """rap_tpu's C++ core emits the same voxel means in first-seen order."""
    if not rap_tpu.native.available():
        pytest.skip("rap_tpu's native core is not built here")
    pts = _cloud(2)
    got = T.voxel_downsample(pts, 0.1)
    ref = rap_tpu.native.voxel_downsample(pts, 0.1)
    assert got.shape == ref.shape
    key = lambda a: a[np.lexsort(a.T[::-1])]  # noqa: E731
    assert max_err(key(got), key(ref)) <= 1e-6


def test_random_downsample_and_fps_numpy_match(numpy_path):
    pts = _cloud(3, 800)
    for k in (10, 800, 1000):
        assert np.array_equal(T.random_downsample(pts, k, np.random.default_rng(4)),
                              J.random_downsample(pts, k, np.random.default_rng(4)))
    for k in (1, 50, 799, 900):
        assert np.array_equal(T.fps_numpy(pts, k, np.random.default_rng(5)),
                              J.fps_numpy(pts, k, np.random.default_rng(5)))


@pytest.mark.parametrize("start", [False, True])
def test_farthest_point_sampling_matches(start):
    rng = np.random.default_rng(6)
    pts = rng.standard_normal((3, 200, 3)).astype(np.float32)
    mask = rng.random((3, 200)) < 0.8
    mask[2, :150] = False  # a part whose first valid point is at 150
    mask[2, 150:160] = True
    start_idx = np.array([5, 17, 151]) if start else None
    ref = np.asarray(J.farthest_point_sampling(
        jnp.asarray(pts), jnp.asarray(mask), 16,
        None if start_idx is None else jnp.asarray(start_idx)))
    got = T.farthest_point_sampling(t(pts), t(mask), 16,
                                    None if start_idx is None else t(start_idx))
    assert got.dtype == torch.long and np.array_equal(got.numpy(), ref)


def test_knn_matches():
    rng = np.random.default_rng(7)
    pts = rng.standard_normal((600, 3)).astype(np.float32)
    queries = rng.standard_normal((300, 3)).astype(np.float32)
    mask = rng.random(600) < 0.9
    d2, idx = J.knn(jnp.asarray(queries), jnp.asarray(pts), jnp.asarray(mask), 8, chunk=128)
    got_d2, got_idx = T.knn(t(queries), t(pts), t(mask), 8, chunk=128)
    assert np.array_equal(got_idx.numpy(), np.asarray(idx))
    assert max_err(got_d2.numpy(), d2) <= 1e-5
    assert mask[got_idx.numpy()].all()


@pytest.mark.parametrize("n,k", [(500, 16), (40, 64)])
def test_ball_query_matches(n, k):
    """First k hits in index order; a query with no hit gets index 0 in
    every slot; a cloud smaller than k."""
    rng = np.random.default_rng(8)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    queries = np.concatenate([pts[:90], [[9.0, 9.0, 9.0]]]).astype(np.float32)
    mask = rng.random(n) < 0.85
    ref = J.ball_query(jnp.asarray(queries), jnp.asarray(pts), jnp.asarray(mask), 0.4, k,
                       chunk=32)
    got = T.ball_query(t(queries), t(pts), t(mask), 0.4, k, chunk=32)
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r))
    assert got[1][-1] == 0 and (got[0][-1] == 0).all()


@pytest.mark.parametrize("n", [10, 256, 300, 1500])
def test_shape_bucket_matches(n):
    assert T.shape_bucket(n) == J.shape_bucket(n)
    assert T.shape_bucket(n, 64) == J.shape_bucket(n, 64)


@pytest.mark.parametrize("n", [15, 700, 2500])
def test_statistical_outlier_removal_matches(n):
    """The inlier sets are compared exactly: the same fp32 expansion of the
    distances, the same mean and threshold."""
    rng = np.random.default_rng(9)
    pts = rng.standard_normal((n, 3)).astype(np.float32)
    pts[: n // 50] *= 6.0  # a few far points
    ref = J.statistical_outlier_removal(pts)
    got = T.statistical_outlier_removal(pts, device="cpu")
    assert np.array_equal(got, ref)
    if n > 20:
        assert len(got) < n


def test_allocators_match():
    parts = [_cloud(s, n) for s, n in ((10, 900), (11, 300), (12, 50), (13, 0))]
    parts[3] = parts[3].reshape(0, 3)
    assert T.adaptive_sample_counts(parts, 0.2, 0.3, 40, 500) == \
        J.adaptive_sample_counts(parts, 0.2, 0.3, 40, 500)
    counts = np.array([len(p) for p in parts])
    for budget, minimum in ((600, 100), (100, 100), (5000, 10)):
        assert np.array_equal(
            T.allocate_by_point_count(counts, budget, minimum, np.random.default_rng(1)),
            J.allocate_by_point_count(counts, budget, minimum, np.random.default_rng(1)))
        assert np.array_equal(
            T.allocate_by_spatial_coverage(parts, budget, minimum, 0.25,
                                           np.random.default_rng(2)),
            J.allocate_by_spatial_coverage(parts, budget, minimum, 0.25,
                                           np.random.default_rng(2)))


@pytest.mark.parametrize("n,k", [(400, 16), (10, 16)])
def test_geometric_features_match(n, k):
    pts = _cloud(14, n).astype(np.float64)
    got = compute_geometric_features(pts, k=k)
    ref = jax_geometric(pts, k=k)
    assert got.dtype == np.float32 and got.shape == ref.shape == (n, 32)
    assert max_err(got, ref) <= 1e-5
