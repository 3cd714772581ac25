"""The port's synthetic-scene generator (rap_tpu_torch/data/synthetic_scenes)
and synthetic-training entry point (rap_tpu_torch/apps/train_synthetic_demo)
against rap_tpu's on the CPU.

The generator is a copy: the same seed gives equal scenes and views and a
byte-identical dataset (part PLYs, geometric feature sidecars, split and
num_points files). ``train_synthetic_demo.main`` at 1 layer, 2 steps, on 6
scenes of 96-point views (the size tests/test_spinnet.py runs rap_tpu's
script at) writes the summary keys and metric names of
scripts/train_synthetic_demo.py, trains through ``train.step`` (finite
losses, the train state saved and read back by ``--eval-only``), and with
``--features spinnet`` writes unit-norm MiniSpinNet sidecars.
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rap_tpu.data import synthetic_scenes as J
from rap_tpu_torch.apps import train_synthetic_demo as app
from rap_tpu_torch.data import synthetic_scenes as T

REPO = Path(__file__).resolve().parents[1]
ARGS = ["--steps", "2", "--scenes", "6", "--points-per-view", "96", "--layers", "1",
        "--batch-tokens", "2048", "--eval-steps", "2", "--eval-splits", "val"]


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def test_scenes_and_views_are_equal():
    a, b = J.make_scene(np.random.default_rng(3)), T.make_scene(np.random.default_rng(3))
    assert np.array_equal(a, b)
    for kw in ({}, {"n_views": 3, "keep_radius_frac": (0.9, 0.98), "max_points_per_view": 300}):
        va = J.split_into_views(a, np.random.default_rng(4), **kw)
        vb = T.split_into_views(b, np.random.default_rng(4), **kw)
        assert len(va) == len(vb) and all(np.array_equal(x, y) for x, y in zip(va, vb))
    assert T.split_into_views(b[:10], np.random.default_rng(0), max_tries=2) is None
    pts = a[:500]
    assert np.array_equal(T.compute_geometric_features(pts), J.compute_geometric_features(pts))


@pytest.mark.parametrize("features", [True, False])
def test_generated_dataset_is_byte_identical(tmp_path, features):
    kw = dict(n_scenes=5, n_views=2, max_points_per_view=128, val_fraction=0.3, seed=2,
              features=features)
    assert T.generate_dataset(tmp_path / "t", **kw) == J.generate_dataset(tmp_path / "j", **kw)
    got = _files(tmp_path / "t")
    assert got == _files(tmp_path / "j")
    assert any(k.endswith("features_part_00.npy") for k in got) == features
    assert {"data_split/train.txt", "data_split/val.txt"} <= set(got)


def _rap_tpu_script(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def test_main_writes_rap_tpus_summary(tmp_path):
    _rap_tpu_script("train_synthetic_demo").main(ARGS + ["--out", str(tmp_path / "j")])
    rec = {}
    got = app.main(ARGS + ["--out", str(tmp_path / "t"), "--device", "cpu"], record=rec)
    ref = json.loads((tmp_path / "j" / "summary.json").read_text())
    assert json.loads((tmp_path / "t" / "summary.json").read_text()) == got
    assert set(got) == set(ref) == {"steps", "config", "val"}
    assert set(got["config"]) == set(ref["config"]) | {"device"}
    assert set(got["val"]) == set(ref["val"])
    assert all(np.isfinite(v) for v in got["val"].values())
    # the same dataset (the generator is a copy), the losses finite
    assert _files(tmp_path / "t" / "data") == _files(tmp_path / "j" / "data")
    assert len(rec["losses"]) == 2 and np.isfinite(rec["losses"]).all()
    assert rec["step_launches"][0] == dict.fromkeys(rec["step_launches"][0], 0)  # CPU: twins
    assert (tmp_path / "t" / "ckpts" / "metrics.jsonl").exists()
    # --eval-only reads the saved train state back: the same numbers
    again = app.main(ARGS + ["--out", str(tmp_path / "t"), "--device", "cpu", "--eval-only",
                             str(tmp_path / "t" / "ckpts" / "final")])
    assert again["val"] == got["val"] and again["steps"] == "eval-only"


def test_spinnet_features_and_gen_only(tmp_path):
    out = tmp_path / "run"
    assert app.main(["--scenes", "3", "--points-per-view", "96", "--features", "spinnet",
                     "--spinnet-des-r", "1.5", "--gen-only", "--out", str(out),
                     "--device", "cpu"]) is None
    feats = sorted((out / "data").glob("scene_*/features_*.npy"))
    assert feats and all(np.load(f).shape[1] == 32 for f in feats)
    np.testing.assert_allclose(np.linalg.norm(np.load(feats[0]), axis=1), 1.0, atol=1e-4)
    params = json.loads((out / "data" / "generation_params.json").read_text())
    assert params["features"] == "spinnet"


def test_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main(["--out", str(tmp_path)])
