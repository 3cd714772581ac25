"""The port's renderers (rap_tpu_torch/utils/render.py), visualisers
(eval/visualizer.py), ``apps.sample`` with ``visualize: true`` and
``apps.demo --render-results`` against rap_tpu's on the CPU.

The renderers are copies: the same inputs give equal images (arrays equal)
and byte-identical PNG / GIF files. The visualisers take the port's
``PartBatch`` of torch tensors where rap_tpu's take its own, and write the
same files, byte for byte. ``apps.sample`` with ``visualize: true`` writes
the file set rap_tpu's ``run_eval`` writes on the same config (1 layer,
fp32, the raster renderer at 64 px to keep the test small).
"""

import io
from pathlib import Path

import jax
import numpy as np
import pytest
from PIL import Image

from rap_tpu.core.batch import make_regular_synthetic_batch
from rap_tpu.eval import visualizer as JV
from rap_tpu.utils import render as JR
from rap_tpu_torch.eval import visualizer as TV
from rap_tpu_torch.utils import render as TR
from torch_parity import batch_to_torch, t

REPO = Path(__file__).resolve().parents[1]


def _files(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def _cloud(n=300, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (n, 3)), rng.integers(0, 5, n)


def test_palette_and_colourings_are_equal():
    assert np.array_equal(TR.part_colormap(), JR.part_colormap())
    ids = np.arange(130)
    assert np.array_equal(TR.part_ids_to_colors(ids), JR.part_ids_to_colors(ids))
    p = np.linspace(-0.5, 1.5, 17)
    assert np.array_equal(TR.prob_to_colors(p), JR.prob_to_colors(p))
    f = np.random.default_rng(1).standard_normal((200, 16))
    (ct, bt), (cj, bj) = TR.pca_colors(f), JR.pca_colors(f)
    assert np.array_equal(ct, cj) and np.array_equal(bt, bj)
    f2 = np.random.default_rng(2).standard_normal((50, 16))
    assert np.array_equal(TR.pca_colors(f2, bt)[0], JR.pca_colors(f2, bj)[0])


@pytest.mark.parametrize("renderer,kw", [
    ("raster", {"point_size": 3.0, "elev": 30, "azim": 120}),
    ("shaded", {"supersample": 2}),
    ("shaded", {"ground_shadow": False, "supersample": 1}),
    ("matplotlib", {"title": "x"}),
])
def test_renderers_give_equal_images(renderer, kw):
    pts, ids = _cloud()
    got = TR.visualize_point_clouds(pts, part_ids=ids, renderer=renderer, image_size=64, **kw)
    ref = JR.visualize_point_clouds(pts, part_ids=ids, renderer=renderer, image_size=64, **kw)
    assert got.shape == (64, 64, 3) and got.dtype == np.uint8
    assert np.array_equal(got, ref)
    assert got.min() < 255  # something was drawn
    assert TR.visualize_point_clouds(pts, renderer="none") is None


def test_empty_clouds_and_normals_are_equal():
    empty = np.zeros((0, 3))
    assert np.array_equal(TR.render_point_cloud_raster(empty, image_size=16),
                          JR.render_point_cloud_raster(empty, image_size=16))
    assert np.array_equal(TR.render_point_cloud_shaded(empty, image_size=16),
                          JR.render_point_cloud_shaded(empty, image_size=16))
    pts, _ = _cloud(100, 3)
    assert np.array_equal(TR.estimate_normals(pts), JR.estimate_normals(pts))


def test_image_and_gif_files_are_byte_identical(tmp_path):
    pts, ids = _cloud(200, 4)
    frames = [TR.render_point_cloud_raster(pts + i * 0.1, TR.part_ids_to_colors(ids),
                                           image_size=48) for i in range(3)]
    TR.save_image(tmp_path / "t" / "a.png", frames[0])
    JR.save_image(tmp_path / "j" / "a.png", frames[0])
    TR.save_gif(tmp_path / "t" / "a.gif", frames, duration_ms=120)
    JR.save_gif(tmp_path / "j" / "a.gif", frames, duration_ms=120)
    assert _files(tmp_path / "t") == _files(tmp_path / "j")


def _vis_inputs():
    """A 2-sample rap_tpu batch (parts of 30 and 20 points in slots of 32,
    one padded part slot) with generations, trajectories and features."""
    jb = make_regular_synthetic_batch(jax.random.key(0), [[30, 20], [32]], N=32, P=2, S=2,
                                      feat_dim=8)
    rng = np.random.default_rng(0)
    gen = np.asarray(jb.points_gt) + 0.05 * rng.standard_normal((jb.G, jb.N, 3))
    traj = np.stack([np.asarray(jb.points), gen]).astype(np.float32)
    feats = rng.standard_normal((jb.G, jb.N, 8)).astype(np.float32)
    metrics = {"recall": np.array([0.2, 0.9], np.float32)}
    return jb, gen.astype(np.float32), traj, feats, metrics


@pytest.mark.parametrize("failure", [False, True])
def test_flow_visualization_writes_the_same_files(tmp_path, failure):
    jb, gen, traj, feats, metrics = _vis_inputs()
    kw = dict(image_size=48, render_parts=True, renderer="raster",
              failure_metric="recall" if failure else "")
    jv = JV.FlowVisualization(JV.VisualizerConfig(output_dir=str(tmp_path / "j"), **kw))
    tv = TV.FlowVisualization(TV.VisualizerConfig(output_dir=str(tmp_path / "t"), **kw))
    for b_idx in range(2):  # the PCA basis frozen by the first batch
        jw = jv.on_batch_end(jb, [gen], [traj], midpoint_trajectories=[traj],
                             transformer_features=feats, metrics=metrics,
                             sample_names=["a", "b"], dataset_name=f"ds{b_idx}")
        tw = tv.on_batch_end(batch_to_torch(jb), [t(gen)], [t(traj)],
                             midpoint_trajectories=[t(traj)], transformer_features=t(feats),
                             metrics={k: t(v) for k, v in metrics.items()},
                             sample_names=["a", "b"], dataset_name=f"ds{b_idx}")
        assert [p.relative_to(tmp_path / "t") for p in tw] == \
            [p.relative_to(tmp_path / "j") for p in jw]
    got, ref = _files(tmp_path / "t"), _files(tmp_path / "j")
    assert got == ref
    assert ("ds0/b/input.png" in got) != failure and "ds0/a/features_pca.png" in got
    assert np.array_equal(tv._pca_basis, jv._pca_basis)


def test_overlap_visualization_writes_the_same_files(tmp_path):
    jb, *_ = _vis_inputs()
    prob = np.random.default_rng(5).random((jb.G, jb.N)).astype(np.float32)
    jo = JV.OverlapVisualization(str(tmp_path / "j"), max_pair_clouds=1)
    to = TV.OverlapVisualization(str(tmp_path / "t"), max_pair_clouds=1)
    jo.add_batch(jb, prob, ["a", "b"])
    to.add_batch(batch_to_torch(jb), t(prob), ["a", "b"])
    jo.finalize()
    to.finalize()
    got, ref = _files(tmp_path / "t"), _files(tmp_path / "j")
    assert set(got) == set(ref) == {"overlap_summary.csv", "overlap_hist.png",
                                    "overlap_heatmap.png", "a_overlap_cloud.png"}
    assert got == ref


def _visualize_argv(out):
    return ["--config", str(REPO / "configs" / "synth_student.yaml"), "-o", "checkpoint=",
            "-o", f"data.datasets.0.data_path={REPO / 'demo_data' / 'synth'}",
            "-o", "data.datasets.0.limit_val_samples=2", "-o", "model.num_layers=1",
            "-o", "pipeline.inference_sampling_steps=2", "-o", "model.compute_dtype=float32",
            "-o", "visualize=true", "-o", f"visualizer.output_dir={out}",
            "-o", "visualizer.renderer=raster", "-o", "visualizer.image_size=64",
            "-o", "visualizer.render_parts=true"]


def test_sample_app_visualize_writes_rap_tpus_files(tmp_path):
    from rap_tpu import config as jconfig
    from rap_tpu.apps.sample import run_eval as jax_run_eval
    from rap_tpu_torch.apps import sample as app

    argv = _visualize_argv(tmp_path / "j")
    jax_run_eval(jconfig.load_config(argv[1], argv[3::2]))
    app.main(_visualize_argv(tmp_path / "t") + ["--device", "cpu"])
    got, ref = _files(tmp_path / "t"), _files(tmp_path / "j")
    assert sorted(got) == sorted(ref)
    assert {"generation_0.png", "trajectory_0.gif", "trajectory_xt_0.gif", "features_pca.png",
            "part_0.png"} <= {Path(k).name for k in got}
    for k, v in got.items():  # images with something drawn
        if k.endswith(".png"):
            assert np.asarray(Image.open(io.BytesIO(v)).convert("RGB")).min() < 255, k


def test_demo_render_results(tmp_path):
    from rap_tpu_torch.apps import demo
    from rap_tpu_torch.utils import ply as plyio

    rng = np.random.default_rng(7)
    scene = rng.uniform(0, 2, (500, 3)).astype(np.float32)
    (tmp_path / "in").mkdir()
    plyio.write_ply(tmp_path / "in" / "a.ply", scene[:350])
    plyio.write_ply(tmp_path / "in" / "b.ply", scene[150:] + 0.3)
    out = tmp_path / "out"
    assert demo.main(["-i", str(tmp_path / "in"), "-out", str(out), "--device", "cpu",
                      "--num-steps", "1", "--max-points-per-part", "256", "--render-results",
                      "-o", "model.num_layers=1", "-o", "model.embed_dim=64", "-o",
                      "model.num_heads=4", "-o", "model.compute_dtype=float32"]) == 0
    regs = [plyio.read_ply_points(out / "registered" / n) for n in ("a.ply", "b.ply")]
    cols = TR.part_ids_to_colors(np.concatenate([np.full(len(r), i)
                                                 for i, r in enumerate(regs)]))
    for azim in (45, 135):
        img = np.asarray(Image.open(out / f"registered_e25_a{azim}.png").convert("RGB"))
        assert img.shape == (800, 800, 3) and img.min() < 255
        # the registered clouds as written (float32), through rap_tpu's
        # renderer: the port rendered them before the float32 rounding, which
        # may move a splat by a pixel
        ref = JR.render_point_cloud_raster(np.concatenate(regs), cols, image_size=800,
                                           elev=25, azim=azim)
        assert (img != ref).any(axis=-1).mean() < 1e-3
