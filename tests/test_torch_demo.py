"""The port's registration demo (rap_tpu_torch/apps/demo.py) against
rap_tpu's on the CPU.

The parts of the pipeline (adaptive parameters, the metric pose,
preprocessing) on the same inputs, then ``run_demo`` of both packages on a
small PLY pair with a tiny fp32 DiT saved by rap_tpu's ``save_params_npz``,
2 steps, ICP refinement, and zero, geometric and SpinNet features (a random
SpinNet saved as a ``.pth`` in the reference's layout, loaded by both). The
port is given rap_tpu's noise, ``jax.random.normal(jax.random.key(seed +
g), ...)``. Two generations run where rigidity forcing is off: with it on,
every generation is rigid to ~1e-7 and the rigidity-RMSE pick between them
is float noise that may fall either way in the two packages. rap_tpu runs
its numpy voxel and FPS path (the port follows it; its C++ core orders
voxels otherwise). The transforms agree to 1e-4 and the same files are
written.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import rap_tpu.native
from rap_tpu.apps import demo as J
from rap_tpu.data.synthetic_scenes import compute_geometric_features as jax_geometric
from rap_tpu.models import DiTConfig as JaxDiTConfig
from rap_tpu.models.dit import init_dit_params
from rap_tpu.train.checkpoint import save_params_npz
from rap_tpu_torch.apps import demo as T
from rap_tpu_torch.data.synthetic_scenes import compute_geometric_features
from rap_tpu_torch.spinnet import init_spinnet
from rap_tpu_torch.utils import ply as plyio
from torch_parity import max_err, run_world

TINY = ["-o", "model.num_layers=2", "-o", "model.embed_dim=64", "-o", "model.num_heads=4",
        "-o", "model.compute_dtype=float32"]


@pytest.fixture
def numpy_path(monkeypatch):
    """rap_tpu without its C++ core: the numpy voxel and FPS fallbacks."""
    monkeypatch.setattr(rap_tpu.native, "_LIB", None)
    monkeypatch.setattr(rap_tpu.native, "_TRIED", True)


def _views(seed: int = 0):
    """Two overlapping views of one scene, the second turned 30 degrees."""
    rng = np.random.default_rng(seed)
    scene = rng.uniform(0, 2, (600, 3)).astype(np.float32)
    Rz = Rotation.from_euler("z", 30, degrees=True).as_matrix().astype(np.float32)
    return [scene[:450], scene[150:] @ Rz.T]


@pytest.mark.parametrize("size", [1.0, 40.0, 900.0])
def test_adaptive_parameters_match(size):
    rng = np.random.default_rng(1)
    clouds = [rng.uniform(0, size, (n, 3)) for n in (500, 800, 300)]
    for args in ((), (0.5, 600), (0.001, 20_000)):
        assert T.adaptive_parameters(clouds, *args) == J.adaptive_parameters(clouds, *args)


def test_pose_to_metric_matches():
    rng = np.random.default_rng(2)
    R = Rotation.random(random_state=rng).as_matrix()
    args = (R, rng.normal(size=3), 2.5, rng.normal(size=3), rng.normal(size=3),
            rng.normal(size=3))
    assert np.array_equal(T._pose_to_metric(*args), J._pose_to_metric(*args))


@pytest.mark.parametrize("features", ["zero", "geometric"])
def test_preprocess_parts_match(numpy_path, features):
    """Keypoints equal (voxels, outlier removal, FPS), features 1e-5."""
    clouds = _views(3)
    clouds[0] = np.concatenate([clouds[0], [[30.0, 30.0, 30.0]]]).astype(np.float32)
    kw = dict(voxel_size=0.05, voxel_ratio=0.4, des_r=1.0, max_points_per_part=256)
    jx = (lambda c, kp, r: jax_geometric(kp)) if features == "geometric" else None
    tx = (lambda c, kp, r: compute_geometric_features(kp)) if features == "geometric" else None
    jk, jf = J.preprocess_parts(clouds, feature_extractor=jx, rng=np.random.default_rng(4), **kw)
    tk, tf = T.preprocess_parts(clouds, feature_extractor=tx, rng=np.random.default_rng(4),
                                device="cpu", **kw)
    assert len(tk) == 2 and all(np.array_equal(a, b) for a, b in zip(tk, jk))
    assert not any((k == 30.0).all(1).any() for k in tk)  # the far point went
    assert all(max_err(a, b) <= 1e-5 for a, b in zip(tf, jf))


@pytest.fixture(scope="module")
def demo_inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("demo")
    views = root / "views"
    views.mkdir()
    for name, v in zip(("a.ply", "b.ply"), _views(5)):
        plyio.write_ply(views / name, v)
    cfg = JaxDiTConfig(num_layers=2, embed_dim=64, num_heads=4, compute_dtype="float32")
    npz = root / "model.npz"
    save_params_npz(npz, init_dit_params(jax.random.key(0), cfg), dtype=jnp.float32)
    pth = root / "mini_spinnet_t.pth"
    sd = init_spinnet(1, device="cpu").state_dict()
    torch.save({"state_dict": {f"Desc.{k}": v for k, v in sd.items()}}, pth)
    return root, views, npz, pth


CASES = {
    # (features, extra flags)
    "zero": ("zero", ["--n-generations", "2", "--no-rigidity-forcing"]),
    "geometric": ("geometric", ["--icp-restarts", "2"]),
    "spinnet": ("spinnet", ["--n-generations", "2", "--no-rigidity-forcing",
                            "--output-generated"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_run_demo_matches_jax(numpy_path, demo_inputs, case):
    root, views, npz, pth = demo_inputs
    features, extra = CASES[case]
    argv = ["-i", str(views), "--num-steps", "2", "--icp-refine", "--max-points-per-part",
            "256", "--checkpoint", str(npz), "--features", features, "--seed", "3",
            "--spinnet-checkpoint", str(pth) if features == "spinnet" else "", *extra, *TINY]
    # the batch's shape first (a port run on its own seeded noise), then
    # rap_tpu's noise for it
    rec = {}
    assert T.main(argv + ["-out", str(root / f"shape_{case}"), "--device", "cpu"],
                  record=rec) == 0
    shape = tuple(rec["batch"].points.shape)
    if features != "zero":  # features that carry something
        assert all(np.linalg.norm(f, axis=1).min() > 0.5 for f in rec["features"])
    gens = len(rec["gen_ms"])
    noise = [torch.from_numpy(np.array(jax.random.normal(jax.random.key(3 + g), shape,
                                                           jnp.float32)))
             for g in range(gens)]
    out_j, out_t = root / f"jax_{case}", root / f"torch_{case}"
    assert J.main(argv + ["-out", str(out_j)]) == 0
    assert T.main(argv + ["-out", str(out_t), "--device", "cpu"], noise=noise) == 0

    files = lambda d: sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())  # noqa: E731
    assert files(out_t) == files(out_j)
    for p in range(2):
        got = np.loadtxt(out_t / f"part{p}_transform.txt")
        ref = np.loadtxt(out_j / f"part{p}_transform.txt")
        assert max_err(got, ref) <= 1e-4, (p, got, ref)
    for name in ("a.ply", "b.ply"):
        got = plyio.read_ply_points(out_t / "registered" / name)
        ref = plyio.read_ply_points(out_j / "registered" / name)
        assert got.shape == ref.shape and max_err(got, ref) <= 1e-3
    np.testing.assert_allclose(np.loadtxt(out_t / "part0_transform.txt"), np.eye(4), atol=1e-6)


def test_sequence_sharded_demo_in_a_world_of_2(demo_inputs, tmp_path):
    """--sequence-sharded on two gloo ranks (tests/torch_parallel_worker.py):
    one part a rank, the global attention a ring; the same generations,
    transforms and files as a world of 1 (the same seeded noise), written by
    rank 0."""
    _, views, npz, _ = demo_inputs
    argv = ["-i", str(views), "--num-steps", "2", "--icp-refine", "--max-points-per-part",
            "256", "--checkpoint", str(npz), "--seed", "3", "--n-generations", "2",
            "--no-rigidity-forcing", "--output-generated", "--device", "cpu", *TINY]
    rec = {}
    assert T.main(argv + ["-out", str(tmp_path / "one")], record=rec) == 0
    outs = run_world({"demo_app": {"argv": argv + ["-out", str(tmp_path / "two"),
                                                   "--sequence-sharded"]}},
                     2, tmp_path / "world")
    for out in (o["demo_app"] for o in outs):
        assert out["rc"] == 0 and out["shard_parts"] == rec["batch"].G // 2
        for got, ref in zip(out["generations"], rec["generations"], strict=True):
            for a, b in zip(got, ref[:3]):
                assert max_err(a, b) <= 1e-4
        for got, ref in zip(out["transforms"], rec["transforms"], strict=True):
            assert max_err(got, ref) <= 1e-4, (got, ref)
    files = lambda d: sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())  # noqa: E731
    assert files(tmp_path / "two") == files(tmp_path / "one")


def test_unported_options_raise(demo_inputs, tmp_path):
    _, views, _, _ = demo_inputs
    base = ["-i", str(views), "-out", str(tmp_path), "--device", "cpu", *TINY]
    # a torch checkpoint is read now (A4), --render-results runs (A9,
    # tests/test_torch_render.py); an orbax directory still raises
    orbax = tmp_path / "orbax_dir"
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(NotImplementedError, match="orbax"):
        T.main(base + ["--checkpoint", str(orbax), "--no-outlier-removal"])


def test_too_few_parts_is_an_error(tmp_path):
    (tmp_path / "in").mkdir()
    plyio.write_ply(tmp_path / "in" / "a.ply", _views()[0])
    assert T.main(["-i", str(tmp_path / "in"), "-out", str(tmp_path / "o"), "--device", "cpu"]) == 1


def test_demo_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.main(["-i", str(tmp_path), "-out", str(tmp_path / "o")])
