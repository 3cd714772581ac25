"""The evaluator's options and artifacts against rap_tpu's on the CPU.

Same seeded numpy inputs through both packages, fp32:

- every metric that only an ``eval.*`` option reaches
  (``rap_tpu/eval/metrics.py``): the correspondence RMSE of 2-part samples,
  the overlap ratios, the nearest-neighbour search, ICP (plain, trimmed,
  from a start pose, with its residual), the anchor alignment and the
  ICP-refined errors, the part chamfer matrix, the part accuracy and the
  ECDF. Tolerance 1e-5 of the largest value (the sums differ in order), ICP
  1e-4 (its fixed steps compound that), nearest indices and part accuracy
  exactly equal;
- ``Evaluator.compute_metrics`` with every option on, key for key, and
  ``aggregate_generations`` with its overlap-selected section;
- ``save_sample_results`` of both packages into two directories: the same
  files, the JSON and transform numbers within 1e-6, the PLY and PCD points
  and colours equal;
- ``apps.sample.main`` with every option on against rap_tpu's ``run_eval``
  on ``demo_data/synth`` at one layer and one Euler step: the table's keys,
  finite values where rap_tpu's are, and the artifact tree; the profiler
  trace of ``--profile-dir``.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rap_tpu import config as jconfig
from rap_tpu.core.batch import make_regular_synthetic_batch as jax_batch
from rap_tpu.eval import metrics as JM
from rap_tpu.eval.evaluator import EvalConfig as JaxEvalConfig
from rap_tpu.eval.evaluator import Evaluator as JaxEvaluator
from rap_tpu.utils import ply as jply
from rap_tpu_torch.apps import sample as app
from rap_tpu_torch.eval import EvalConfig, Evaluator
from rap_tpu_torch.eval import metrics as TM
from rap_tpu_torch.utils import ply as tply
from torch_parity import batch_to_torch, max_err, t

REPO = Path(__file__).resolve().parents[1]
SYNTH = str(REPO / "demo_data" / "synth")
S, P, N = 3, 3, 64
ALL_OPTIONS = dict(rmse_eval_on=True, overlap_eval_on=True, ecdf_eval_on=True,
                   part_acc_eval_on=True, use_icp=True)


def _rel(got, ref, what, rtol=1e-5):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert np.array_equal(np.isfinite(got), np.isfinite(ref)), what
    fin = np.isfinite(ref)
    assert np.array_equal(got[~fin], ref[~fin], equal_nan=True), what
    if fin.any():
        scale = max(float(np.abs(ref[fin]).max()), 1e-30)
        assert max_err(got[fin], ref[fin]) <= rtol * scale, what


def _random_rotations(rng, n, angle=np.pi, least=0.0):
    """n rotations about random axes by angles of ``least`` to ``angle``."""
    axis = rng.standard_normal((n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    theta = rng.uniform(least, angle, n) * rng.choice([-1.0, 1.0], n)
    K = np.zeros((n, 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -axis[:, 2], axis[:, 1], -axis[:, 0]
    K -= K.transpose(0, 2, 1)
    s, c = np.sin(theta)[:, None, None], np.cos(theta)[:, None, None]
    return (np.eye(3) + s * K + (1 - c) * K @ K).astype(np.float32)


def _inputs(seed=0):
    """A padded batch (sample 1 a pair whose second part overlaps its first,
    the others 3 parts and a padded slot) with a prediction and poses near
    the truth: (jax batch, port batch, pred, R, t). The prediction is off by
    ~5 cm and each rotation by 9-17 degrees: nearer, the fp32 distances'
    cancellation (|x|² - 2x·y + |y|²) and arccos near 1 would leave fewer
    digits than the tolerances hold."""
    jb = jax_batch(jax.random.key(seed), [[64, 40, 30], [50, 64], [20, 64, 64]], N=N, P=P,
                   S=S, feat_dim=8)
    rng = np.random.default_rng(seed)
    gt = np.array(jb.points_gt)
    # the pair's second part: its first part's points moved by < 2 cm (scale 1:
    # metres), so the 5 cm correspondences of the pairwise RMSE exist
    gt[4, :50] = gt[3, :50] + 0.01 * rng.standard_normal((50, 3))
    gt[4, 50:] = gt[3, :14] + 0.5
    jb = jb.replace(points_gt=jnp.asarray(gt))
    Rg = np.asarray(jb.rotations_gt)
    pred = gt + 0.05 * rng.standard_normal(gt.shape)
    R = np.einsum("gij,gjk->gik", _random_rotations(rng, S * P, 0.3, 0.15),
                  Rg).astype(np.float32)
    t_ = np.asarray(jb.translations_gt) + 0.02 * rng.standard_normal((S * P, 3))
    return jb, batch_to_torch(jb), pred.astype(np.float32), R, t_.astype(np.float32)


def test_correspondence_rmse_pairs_matches_rap_tpu():
    jb, tb, pred, R, t_ = _inputs()
    ref = JM.correspondence_rmse_pairs(jb, jnp.asarray(R), jnp.asarray(t_))
    got = TM.correspondence_rmse_pairs(tb, t(R), t(t_))
    assert np.isfinite(np.asarray(ref[0])).sum() == 1  # the pair alone is scored
    for g_, r_, name in zip(got, ref, ("rmse", "ratio", "terr")):
        _rel(g_.numpy(), r_, name)


def test_overlap_ratio_matches_rap_tpu():
    jb, tb, pred, _, _ = _inputs(1)
    ref = np.asarray(JM.overlap_ratio(jb, jnp.asarray(pred), taus=(0.005, 0.01, 0.02, 0.3)))
    got = TM.overlap_ratio(tb, t(pred), taus=(0.005, 0.01, 0.02, 0.3)).numpy()
    assert ref[-1].max() > 0  # some points do overlap at 30 cm
    _rel(got, ref, "overlap ratio")


def test_masked_nn_matches_rap_tpu():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 300, 3)).astype(np.float32)
    y = rng.standard_normal((2, 200, 3)).astype(np.float32)
    ym = rng.random((2, 200)) > 0.3
    jd, ji = JM._masked_nn(jnp.asarray(x), jnp.asarray(np.ones((2, 300), bool)),
                           jnp.asarray(y), jnp.asarray(ym), chunk=128)
    td, ti = TM._masked_nn(t(x), t(y), t(ym), chunk=128)
    _rel(td.numpy(), jd, "distance")
    assert np.array_equal(ti.numpy(), np.asarray(ji))


def _icp_case(seed=3):
    """A cloud, its copy moved by a small rotation and translation, 40% of
    its points far off (partial overlap, what trimming is for: the trimmed
    share's boundary then falls among well-separated distances), masks."""
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((3, 128, 3)).astype(np.float32)
    R = _random_rotations(rng, 3, 0.15)
    tgt = np.einsum("bij,bnj->bni", R, src) + 0.05 * rng.standard_normal((3, 1, 3))
    noise = np.where(np.arange(128)[None, :, None] < 77, 0.002, 0.3)
    tgt = (tgt + noise * rng.standard_normal(tgt.shape)).astype(np.float32)
    m = rng.random((3, 128)) > 0.1
    m[2] = False  # an empty cloud: (I, 0)
    return src, m, tgt, m


@pytest.mark.parametrize("variant", ["plain", "trimmed", "init", "residual"])
def test_icp_point_to_point_matches_rap_tpu(variant):
    src, sm, tgt, tm = _icp_case()
    kw = {"trimmed": dict(trim_fraction=0.7), "residual": dict(return_residual=True),
          "plain": {}}.get(variant, {})
    rng = np.random.default_rng(4)
    init = (_random_rotations(rng, 3, 0.05), (0.01 * rng.standard_normal((3, 3))).astype(
        np.float32))
    ref = JM.icp_point_to_point(*map(jnp.asarray, (src, sm, tgt, tm)), iters=10,
                                init=tuple(map(jnp.asarray, init)) if variant == "init"
                                else None, **kw)
    got = TM.icp_point_to_point(*map(t, (src, sm, tgt, tm)), iters=10,
                                init=tuple(map(t, init)) if variant == "init" else None, **kw)
    assert len(got) == len(ref) == (3 if variant == "residual" else 2)
    for g_, r_ in zip(got, ref):
        _rel(g_.numpy(), r_, variant, rtol=1e-4)
    assert np.array_equal(got[0][2].numpy(), np.eye(3))


def test_align_anchor_and_icp_errors_match_rap_tpu():
    jb, tb, pred, R, t_ = _inputs(5)
    _rel(TM.align_anchor(tb, t(pred), iters=10).numpy(),
         JM.align_anchor(jb, jnp.asarray(pred), iters=10), "align_anchor", rtol=1e-4)
    got = TM.transform_errors_icp(tb, t(R), t(t_), iters=10)
    ref = JM.transform_errors_icp(jb, jnp.asarray(R), jnp.asarray(t_), iters=10)
    for g_, r_, name in zip(got, ref, ("rotation", "translation")):
        _rel(g_.numpy(), r_, name, rtol=1e-4)


def test_part_chamfer_and_accuracy_match_rap_tpu():
    jb, tb, pred, _, _ = _inputs(6)
    pred[1] = pred[2]  # sample 0: two predicted parts swapped, part 1 then 2
    pred[2] = np.asarray(jb.points_gt)[1] + 0.003
    _rel(TM.part_chamfer_matrix(tb, t(pred)).numpy(),
         JM.part_chamfer_matrix(jb, jnp.asarray(pred)), "part chamfer")
    for thr in (0.01, 2.0):
        got, ref = TM.part_accuracy(tb, t(pred), thr), JM.part_accuracy(jb, jnp.asarray(pred),
                                                                         thr)
        assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])


def test_ecdf_matches_rap_tpu():
    errs = np.random.default_rng(7).exponential(10.0, 50)
    got, ref = TM.ecdf(errs, (3, 5, 10, 30)), JM.ecdf(errs, (3, 5, 10, 30))
    assert np.array_equal(got[0], ref[0]) and got[1:] == ref[1:]


def _generations(seed=8, n=3):
    jb, tb, pred, R, t_ = _inputs(seed)
    rng = np.random.default_rng(seed)
    return jb, tb, [(pred + 0.02 * g * rng.standard_normal(pred.shape).astype(np.float32), R,
                     t_) for g in range(n)]


def test_compute_metrics_with_every_option_matches_rap_tpu():
    jb, tb, gens = _generations()
    jev, tev = JaxEvaluator(JaxEvalConfig(**ALL_OPTIONS)), Evaluator(EvalConfig(**ALL_OPTIONS))
    for p_, R, t_ in gens:
        ref = jev.compute_metrics(jb, *map(jnp.asarray, (p_, R, t_)))
        got = tev.compute_metrics(tb, *map(t, (p_, R, t_)))
        assert list(got) == list(ref)
        assert {"correspondence_rmse (m)", "overlap_ratio_at_1%", "part_accuracy",
                "ecdf_rotation_at_3deg", "ecdf_translation_at_0.05m"} <= set(ref)
        for k in ref:
            _rel(got[k].numpy(), ref[k], k, rtol=1e-4)


def test_aggregate_generations_selects_by_overlap_like_rap_tpu():
    jb, tb, gens = _generations(9)
    cfg = dict(overlap_eval_on=True, use_average_rigidity_rmse=False)
    jev, tev = JaxEvaluator(JaxEvalConfig(**cfg)), Evaluator(EvalConfig(**cfg))
    ref = jev.aggregate_generations(jb, [jev.compute_metrics(jb, *map(jnp.asarray, g))
                                         for g in gens])
    got = tev.aggregate_generations(tb, [tev.compute_metrics(tb, *map(t, g)) for g in gens])
    assert set(got) == set(ref) and "overlap_ratio_selected" in ref
    for key in ("rigidity_selected_gen", "overlap_ratio_selected_gen"):
        assert np.array_equal(got[key], ref[key]), key
    for sec in ("avg", "best_of_3", "rigidity_selected", "overlap_ratio_selected"):
        for k in ref[sec]:
            _rel(got[sec][k], ref[sec][k], f"{sec}/{k}")


def _tree(root: Path) -> dict[str, Path]:
    return {str(p.relative_to(root)): p for p in sorted(root.rglob("*")) if p.is_file()}


def _same_artifacts(got_root: Path, ref_root: Path):
    got, ref = _tree(got_root), _tree(ref_root)
    assert list(got) == list(ref) and ref
    for name, rp in ref.items():
        gp = got[name]
        if name.endswith(".json"):
            g_, r_ = json.loads(gp.read_text()), json.loads(rp.read_text())
            assert list(g_) == list(r_), name
            _rel(np.array(list(g_.values())), np.array(list(r_.values())), name, rtol=1e-6)
        elif name.endswith(".txt"):
            _rel(np.loadtxt(gp), np.loadtxt(rp), name, rtol=1e-6)
        elif name.endswith(".ply"):
            assert np.array_equal(tply.read_ply_points(gp), jply.read_ply_points(rp)), name
        else:
            g_, r_ = tply.read_pcd(gp), jply.read_pcd(rp)
            assert np.array_equal(g_["points"], r_["points"]), name
            assert np.array_equal(g_["colors"], r_["colors"]), name
    return ref


@pytest.mark.parametrize("limit", [0, 1])
def test_save_sample_results_matches_rap_tpu(tmp_path, limit):
    jb, tb, gens = _generations(10, n=1)
    pred, R, t_ = gens[0]
    rng = np.random.default_rng(11)
    traj = (pred[None] + 0.1 * rng.standard_normal((3,) + pred.shape)).astype(np.float32)
    mid = (pred[None] + 0.3 * rng.standard_normal((3,) + pred.shape)).astype(np.float32)
    names = ["scene_a", "scene_b", "scene_c"]
    md = {k: v.numpy() for k, v in Evaluator(EvalConfig(**ALL_OPTIONS)).compute_metrics(
        tb, t(pred), t(R), t(t_)).items()}
    for pkg, (Ev, Cfg, batch) in {"ref": (JaxEvaluator, JaxEvalConfig, jb),
                                  "got": (Evaluator, EvalConfig, tb)}.items():
        ev = Ev(Cfg(save_results=True, save_pointcloud_parts=True,
                    save_merged_pointcloud_steps=True, max_artifact_samples_per_batch=limit,
                    output_dir=str(tmp_path / pkg / "results"), folder_suffix="run1"))
        ev.save_sample_results(batch, pred, R, t_, md, names, dataset_name="synth",
                               generation_idx=0, trajectory=traj, midpoint_trajectory=mid)
    ref = _same_artifacts(tmp_path / "got" / "results_run1", tmp_path / "ref" / "results_run1")
    assert "synth/scene_a/generation_0/generation/midpoint/step_2.pcd" in ref
    assert ("synth/scene_b/generation_0/part01_pred.ply" in ref) == (limit == 0)


def _every_option(out_dir):
    return ["--config", str(REPO / "configs" / "synth_student.yaml"), "-o", "checkpoint=",
            "-o", f"data.datasets.0.data_path={SYNTH}",
            "-o", "data.datasets.0.limit_val_samples=2", "-o", "model.num_layers=1",
            "-o", "pipeline.inference_sampling_steps=2", "-o", "pipeline.n_generations=3",
            "-o", "model.compute_dtype=float32", "-o", f"eval.output_dir={out_dir}",
            *[x for k in (*ALL_OPTIONS, "save_results", "save_pointcloud_parts",
                          "save_merged_pointcloud_steps") for x in ("-o", f"eval.{k}=true")]]


def test_sample_app_with_every_option_matches_rap_tpu(tmp_path):
    from rap_tpu.apps.sample import run_eval as jax_run_eval

    argv = _every_option(tmp_path / "ref")
    ref = jax_run_eval(jconfig.load_config(argv[1], argv[3::2]))
    rec = {}
    got = app.main(_every_option(tmp_path / "got") + ["--device", "cpu", "--profile-dir",
                                                      str(tmp_path / "trace")], record=rec)
    assert set(got) == set(ref) == {"synth", "overall"}
    for ds in ref:
        assert set(got[ds]) == set(ref[ds])
        assert any(k.startswith("overlap_ratio_selected/") for k in ref[ds])
        for k, v in ref[ds].items():
            assert np.isfinite(got[ds][k]) == np.isfinite(v), k
    assert len(rec["post_ms"]) == len(rec["batch_gen_ms"]) == 1
    assert list(_tree(tmp_path / "got")) == list(_tree(tmp_path / "ref"))
    assert json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
