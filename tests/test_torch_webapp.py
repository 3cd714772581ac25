"""The port's web demo (rap_tpu_torch/apps/webapp.py) against rap_tpu's on
the CPU.

The conversions are copies: OBJ and PLY meshes sampled, PTS / XYZ / PCD /
LAS read, the global shift detected, applied and saved, GLB written and
read: equal arrays and byte-identical files. ``run_rap_demo`` on a pair of
large-coordinate clouds (so the global shift applies) with an explicit
.npz checkpoint, both packages' demos at a tiny fp32 DiT (2 layers, D =
64; rap_tpu's through a wrapper of its ``demo.main`` adding the same
``-o`` overrides) and rap_tpu's noise handed to the port: the same input
files, shift and zip listing, transforms within 1e-4, and the GLB's points
within 1e-3 with equal colours. ``checkpoint="auto"`` with nothing in the
cache warns in the returned log; ``main`` without gradio raises.
"""

import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rap_tpu.apps.demo
import rap_tpu.native
from rap_tpu.apps import webapp as J
from rap_tpu.models import DiTConfig as JaxDiTConfig
from rap_tpu.models.dit import init_dit_params
from rap_tpu.train.checkpoint import save_params_npz
from rap_tpu.utils import ply as jply
from rap_tpu_torch.apps import webapp as T
from rap_tpu_torch.utils import ply as plyio
from torch_parity import max_err

TINY = ["-o", "model.num_layers=2", "-o", "model.embed_dim=64", "-o", "model.num_heads=4",
        "-o", "model.compute_dtype=float32"]


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def test_conversions_are_equal(tmp_path):
    rng = np.random.default_rng(0)
    (tmp_path / "m.obj").write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 2\n"
                                    "f 1 2 3 4\nf 1/1 2/2 -1/3\n")
    # a PLY mesh: six vertices, a quad and a triangle (fan-triangulated)
    verts = rng.standard_normal((6, 3)).astype("<f4")
    head = (b"ply\nformat binary_little_endian 1.0\nelement vertex 6\nproperty float x\n"
            b"property float y\nproperty float z\nelement face 2\n"
            b"property list uchar int vertex_indices\nend_header\n")
    quad = np.array([(4, (0, 1, 2, 3))], [("k", "u1"), ("i", "<i4", 4)]).tobytes()
    tri = np.array([(3, (3, 4, 5))], [("k", "u1"), ("i", "<i4", 3)]).tobytes()
    (tmp_path / "mesh.ply").write_bytes(head + verts.tobytes() + quad + tri)
    (tmp_path / "c.pts").write_text("3\n1 2 3 255\n4 5 6 255\n500000.001 4000000 7 1\n")
    (tmp_path / "c.xyz").write_text("1.5 2 3\n4 5 6 7 8\n")
    pts = rng.standard_normal((40, 3)) * 10
    jply.write_pcd(tmp_path / "c.pcd", pts.astype(np.float32),
                   colors=rng.integers(0, 255, (40, 3)).astype(np.uint8))
    jply.write_las(tmp_path / "c.las", pts + 4000.0)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    for name in ("m.obj", "mesh.ply", "c.pts", "c.xyz", "c.pcd", "c.las"):
        a = J.convert_to_points(tmp_path / name, mesh_sample_points=64,
                                rng=np.random.default_rng(1))
        b = T.convert_to_points(tmp_path / name, mesh_sample_points=64,
                                rng=np.random.default_rng(1))
        assert a.keys() == b.keys(), name
        assert all(np.array_equal(a[k], b[k]) for k in a), name
        J.convert_to_ply(tmp_path / name, tmp_path / "j" / f"{name}.ply", mesh_sample_points=64)
        T.convert_to_ply(tmp_path / name, tmp_path / "t" / f"{name}.ply", mesh_sample_points=64)
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    (tmp_path / "x.step").write_text("nope")
    with pytest.raises(ValueError, match="unsupported"):
        T.convert_to_points(tmp_path / "x.step")


def test_global_shift_and_glb_are_equal(tmp_path):
    rng = np.random.default_rng(2)
    clouds = {"a.ply": rng.standard_normal((50, 3)) + [5000, 100, 0],
              "b.ply": rng.standard_normal((70, 3)) + [5002, 101, 1]}
    pts = rng.standard_normal((33, 3)).astype(np.float32)
    cols = rng.integers(0, 255, (33, 3)).astype(np.uint8)
    for M, who in ((J, "j"), (T, "t")):
        d = tmp_path / who / "reg"
        d.mkdir(parents=True)
        (tmp_path / who / "shifted").mkdir()
        for name, c in clouds.items():
            plyio.write_ply(d / name, c.astype(np.float32))
        assert M.detect_large_coordinates(d)
        shift = M.calculate_global_shift(d)
        assert M.apply_global_shift(d, shift, tmp_path / who / "shifted") == 2
        assert not M.detect_large_coordinates(tmp_path / who / "shifted")
        M.save_global_shift(shift, tmp_path / who)
        M.combine_registered_to_glb(tmp_path / who / "shifted", tmp_path / who / "all.glb",
                                    max_points=100)
        M.write_glb_pointcloud(tmp_path / who / "x.glb", pts, cols)
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    a, b = (M.read_glb_pointcloud(tmp_path / "t" / "all.glb") for M in (J, T))
    assert np.array_equal(a["points"], b["points"]) and np.array_equal(a["colors"], b["colors"])
    assert len(b["points"]) == 100
    x = T.read_glb_pointcloud(tmp_path / "t" / "x.glb")
    assert np.array_equal(x["points"], pts) and np.array_equal(x["colors"], cols)


@pytest.fixture
def numpy_path(monkeypatch):
    """rap_tpu without its C++ core: the numpy voxel and FPS fallbacks."""
    monkeypatch.setattr(rap_tpu.native, "_LIB", None)
    monkeypatch.setattr(rap_tpu.native, "_TRIED", True)


def test_run_rap_demo_matches_rap_tpu(numpy_path, tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 2, (800, 3))
    a = base[:550] + [5000.0, 0.0, 0.0]   # large coordinates: the global shift
    b = base[250:] + [5000.1, 0.05, 0.0]
    plyio.write_ply(tmp_path / "a.ply", a.astype(np.float32))
    plyio.write_ply(tmp_path / "b.ply", b.astype(np.float32))
    npz = tmp_path / "tiny.npz"
    save_params_npz(npz, init_dit_params(jax.random.key(0), JaxDiTConfig(
        num_layers=2, embed_dim=64, num_heads=4, compute_dtype="float32")), dtype=jnp.float32)
    kw = dict(checkpoint=str(npz), num_steps=2, max_points_per_part=128, seed=3)
    inputs = [tmp_path / "a.ply", tmp_path / "b.ply"]

    # the batch's shape from a port run on its own noise, then rap_tpu's noise
    rec = {}
    T.run_rap_demo(inputs, tmp_path / "shape", device="cpu", demo_args=TINY, record=rec, **kw)
    shape = tuple(rec["batch"].points.shape)
    noise = [torch.from_numpy(np.array(jax.random.normal(jax.random.key(3), shape,
                                                          jnp.float32)))]
    main = rap_tpu.apps.demo.main
    monkeypatch.setattr(rap_tpu.apps.demo, "main", lambda argv: main(argv + TINY))
    ref = J.run_rap_demo(inputs, tmp_path / "j", **kw)
    got = T.run_rap_demo(inputs, tmp_path / "t", device="cpu", demo_args=TINY, noise=noise,
                         **kw)
    assert got["global_shift"] == ref["global_shift"] and got["global_shift"][0] > 4999
    assert _files(tmp_path / "t" / "input") == _files(tmp_path / "j" / "input")
    for p in range(2):
        ta, ja = (np.loadtxt(tmp_path / w / "output" / f"part{p}_transform.txt")
                  for w in ("t", "j"))
        assert max_err(ta, ja) <= 1e-4, (p, ta, ja)
    gt, gj = T.read_glb_pointcloud(got["glb"]), J.read_glb_pointcloud(ref["glb"])
    assert gt["points"].shape == gj["points"].shape
    assert max_err(gt["points"], gj["points"]) <= 1e-3
    assert np.array_equal(gt["colors"], gj["colors"])
    names = [zipfile.ZipFile(r["zip"]).namelist() for r in (got, ref)]
    assert sorted(names[0]) == sorted(names[1]) and "global_shift.txt" in names[0]
    assert "RANDOM" not in got["log"]


def test_auto_checkpoint_warns_and_ui_needs_gradio(tmp_path, monkeypatch):
    monkeypatch.setenv("RAP_TPU_CACHE", str(tmp_path / "cache"))
    base = np.random.default_rng(1).standard_normal((600, 3))
    plyio.write_ply(tmp_path / "a.ply", base.astype(np.float32))
    plyio.write_ply(tmp_path / "b.ply", (base + [0.1, 0, 0]).astype(np.float32))
    out = T.run_rap_demo([tmp_path / "a.ply", tmp_path / "b.ply"], tmp_path / "wk",
                         num_steps=1, max_points_per_part=128, device="cpu", demo_args=TINY)
    assert "WARNING: no checkpoint resolved" in out["log"] and "RANDOM" in out["log"]
    assert zipfile.ZipFile(out["zip"]).namelist()
    with pytest.raises(ValueError, match="at least two"):
        T.run_rap_demo([tmp_path / "a.ply"], tmp_path / "wk2", device="cpu")
    try:
        import gradio  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="gradio"):
            T.main([])
    if not torch.cuda.is_available():  # the demo runs on the card by default
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.run_rap_demo([tmp_path / "a.ply", tmp_path / "b.ply"], tmp_path / "wk3",
                           checkpoint="")
