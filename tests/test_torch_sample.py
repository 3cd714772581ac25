"""The port's batch-evaluation path against rap_tpu's on the CPU.

``rap_tpu_torch.apps.sample`` and what it runs on (config, dataset, packer,
loader, metrics, evaluator, meter), each held to its rap_tpu counterpart on
the same inputs:

- ``load_config`` on every ``configs/*.yaml``, with and without overrides,
  field by field (the port's DiTConfig adds only ``use_kernels``; the
  fields the port leaves out are at rap_tpu's defaults in every file);
- the dataset on ``demo_data/synth``, with eval (identity) augmentation and
  with the seeded rotations of ``augment_eval`` (yaw and full SO(3)), every
  array equal, and on a tiny HDF5 file in rap_tpu's layout; the packer's plans and collated batches, padded points
  included, every ``PartBatch`` field equal; the loader's batches, names and
  padding statistics; the loader's thread has ended when an epoch ends or
  is closed early;
- each metric and ``aggregate_generations`` at fp32 (1e-5 of the largest
  value), and ``MetricsMeter`` (the evaluator's options:
  test_torch_eval_options.py);
- one generation with the committed ``reflow_student.npz`` on a scene of
  ``demo_data/synth`` (one scene and one of the config's 4 Euler steps, to
  keep the CPU time down), the same noise on both sides, fp32: points within 1e-4 of
  max|points| and rotations within 1e-4;
- ``run_eval`` gives rap_tpu's table keys; ``-o model.softcap=5.0`` runs.
"""

import dataclasses
import glob
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rap_tpu import config as jconfig
from rap_tpu.core.batch import make_regular_synthetic_batch as jax_batch
from rap_tpu.core.procrustes import rotation_angle_deg as jax_rotation_angle_deg
from rap_tpu.data import BatchLoader as JaxLoader
from rap_tpu.data import LoaderConfig as JaxLoaderConfig
from rap_tpu.data import PointCloudDataset as JaxDataset
from rap_tpu.data.dataset import DatasetConfig as JaxDatasetConfig
from rap_tpu.data.packer import pack_samples as jax_pack_samples
from rap_tpu.data.packer import plan_batches as jax_plan_batches
from rap_tpu.eval import metrics as JM
from rap_tpu.eval.evaluator import Evaluator as JaxEvaluator
from rap_tpu.eval.meter import MetricsMeter as JaxMeter
from rap_tpu_torch import config as tconfig
from rap_tpu_torch.apps import sample as app
from rap_tpu_torch.core.batch import TENSOR_FIELDS
from rap_tpu_torch.core.procrustes import rotation_angle_deg
from rap_tpu_torch.data import BatchLoader, DatasetConfig, LoaderConfig, PointCloudDataset
from rap_tpu_torch.data.packer import collate_to_part_batch, plan_batches
from rap_tpu_torch.eval import Evaluator, MetricsMeter
from rap_tpu_torch.eval import metrics as TM
from torch_parity import batch_to_torch, max_err, t

REPO = Path(__file__).resolve().parents[1]
SYNTH = str(REPO / "demo_data" / "synth")
CKPT = REPO / "demo_data" / "ckpts" / "reflow_student.npz"
CONFIGS = sorted(glob.glob(str(REPO / "configs" / "*.yaml")))
OVERRIDES = ["model.softcap=5.0", "model.num_layers=2", "pipeline.n_generations=3",
             "data.max_points_per_batch=9000", "checkpoint=", "trainer.seed=7",
             "eval.use_average_rigidity_rmse=false", "optimizer.lr_milestones=[3, 5]"]


# rap_tpu's config fields that no shipped config sets and the port leaves out
OMITTED = {"data": ("max_samples_per_epoch",), "pipeline": ("prune_factor",),
           "trainer": ("keep_last", "log_every_n_steps", "remat", "log_file"),
           "": ("n_devices",)}


def _plain(x):
    """A config as nested plain values; dtypes by name."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, (tuple, list)):
        return [_plain(v) for v in x]
    if isinstance(x, torch.dtype):
        return str(x).removeprefix("torch.")
    if not isinstance(x, (str, int, float, bool, type(None))):
        return np.dtype(x).name  # a jnp dtype
    return x


@pytest.mark.parametrize("overrides", [[], OVERRIDES], ids=["plain", "overrides"])
@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: Path(p).name)
def test_load_config_matches_rap_tpu(path, overrides):
    ref = _plain(jconfig.load_config(path, overrides))
    got = _plain(tconfig.load_config(path, overrides))
    defaults = _plain(jconfig.Config())
    for section, names in OMITTED.items():
        r, d = (ref, defaults) if not section else (ref[section], defaults[section])
        for name in names:
            assert r.pop(name) == d[name], f"{section}.{name} is set"
    for section in ("model", "pipeline"):
        model = got[section] if section == "model" else got[section]["model"]
        assert model.pop("use_kernels") is True
    assert got == ref


def test_load_config_names_the_compute_dtype():
    cfg = tconfig.load_config(REPO / "configs" / "synth_student.yaml",
                              ["model.compute_dtype=float32"])
    assert cfg.model.compute_dtype == cfg.pipeline.model.compute_dtype == torch.float32
    with pytest.raises(KeyError, match="unknown config key"):
        tconfig.load_config(None, ["eval.no_such_key=1"])


# ---- data ------------------------------------------------------------------

def _sample_equal(a, b):
    assert (a.name, a.dataset_name, a.index, a.anchor_idx) == (
        b.name, b.dataset_name, b.index, b.anchor_idx)
    assert a.scale == b.scale
    for f in ("points", "points_gt", "features"):
        assert all(np.array_equal(x, y) for x, y in zip(getattr(a, f), getattr(b, f),
                                                        strict=True)), f
    for f in ("rotations", "translations", "global_rotation", "global_translation"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("aug", ["eval", "full", "yaw"])
def test_dataset_matches_rap_tpu(aug):
    kw = {"eval": {}, "full": {"augment_eval": True},
          "yaw": {"augment_eval": True, "yaw_augmentation": True, "seed": 3}}[aug]
    jds = JaxDataset(JaxDatasetConfig(data_path=SYNTH, dataset_name="synth", **kw))
    tds = PointCloudDataset(DatasetConfig(data_path=SYNTH, dataset_name="synth", **kw))
    assert (tds.fragments, tds.part_counts, tds.precomputed_num_points) == (
        jds.fragments, jds.part_counts, jds.precomputed_num_points)
    assert len(tds) == 8
    for i in (0, 5):
        _sample_equal(tds.get(i, epoch=2), jds.get(i, epoch=2))


def _write_h5(path, rng):
    """rap_tpu's HDF5 layout: data_split/<name>/<split> fragment lists (the
    val list names one missing fragment and one with too few parts),
    num_points for train, fragment groups of parts with vertices and
    features for all but one."""
    import h5py

    with h5py.File(path, "w") as f:
        frags = [f"scene_{i}" for i in range(6)]
        for i, frag in enumerate(frags):
            for p in range(1 if i == 5 else 2 + i % 3):
                g = f.create_group(f"{frag}/part_{p}")
                n = int(rng.integers(80, 200))
                g["vertices"] = rng.standard_normal((n, 3)) * (1 + p)
                if i != 3:
                    g["features"] = rng.standard_normal((n, 32)).astype(np.float32)
        split = f.create_group("data_split/synth_h5")
        split["train"] = np.array(frags[:3], dtype="S")
        split["val"] = np.array(frags[2:] + ["missing"], dtype="S")
        f["num_points/synth_h5/train"] = np.array([400, 500, 600])


@pytest.mark.parametrize("aug", ["eval", "full"])
def test_dataset_refuses_hdf5(tmp_path, aug):
    """The HDF5 storage against rap_tpu's on a tiny file: the fragment list
    (a missing fragment and one of too few parts dropped, num_points read
    where present), the split fallback, and every sample's arrays equal."""
    path = str(tmp_path / "data.h5")
    _write_h5(path, np.random.default_rng(5))
    kw = {"eval": {}, "full": {"augment_eval": True, "seed": 4}}[aug]
    for split in ("train", "val"):
        cfgs = [C(data_path=path, dataset_name="synth_h5", split=split, use_random_split=True,
                  **kw) for C in (JaxDatasetConfig, DatasetConfig)]
        jds, tds = JaxDataset(cfgs[0]), PointCloudDataset(cfgs[1])
        assert (tds.fragments, tds.part_counts, tds.precomputed_num_points) == (
            jds.fragments, jds.part_counts, jds.precomputed_num_points)
        assert tds.effective_random == jds.effective_random is False
        assert len(tds) == (3 if split == "train" else 3)
        for i in range(len(tds)):
            _sample_equal(tds.get(i, epoch=1), jds.get(i, epoch=1))
        tds.close()
        jds.close()
        assert tds._h5 is None


def _batches_equal(tb, jb):
    assert tb.no_padding == jb.no_padding
    for f in TENSOR_FIELDS:
        a, b = getattr(tb, f), getattr(jb, f)
        assert np.array_equal(a.numpy(), np.asarray(b)), f


def test_packer_matches_rap_tpu():
    rng = np.random.default_rng(0)
    parts = rng.integers(2, 9, 40).tolist()
    sizes = rng.integers(100, 5000, 40).tolist()
    for budget in (40_000, 9000):
        ref = jax_plan_batches(parts, sizes, budget)
        got = plan_batches(parts, sizes, budget)
        assert [(p.indices, p.N, p.P) for p in got] == [(p.indices, p.N, p.P) for p in ref]
        assert all(p.S == len(p.indices) for p in ref)
    # collated batches with padded points
    ds = PointCloudDataset(DatasetConfig(data_path=SYNTH, dataset_name="synth"))
    samples = [ds.get(i) for i in range(5)]
    samples[1] = dataclasses.replace(
        samples[1], points=[p[:1000] for p in samples[1].points],
        points_gt=[p[:1000] for p in samples[1].points_gt],
        features=[f[:1000] for f in samples[1].features])
    for budget in (32768, 9000):
        plans = plan_batches([s.num_parts for s in samples],
                             [s.max_part_points for s in samples], budget)
        got = [collate_to_part_batch([samples[i] for i in p.indices], p.N, p.P,
                                     device="cpu") for p in plans]
        ref = jax_pack_samples(samples, budget)
        assert len(got) == len(ref) > 1 or budget == 32768
        for (tb, tn), (jb, jn) in zip(got, ref, strict=True):
            assert tn == jn
            _batches_equal(tb, jb)
    assert any(not tb.no_padding for tb, _ in got)


@pytest.mark.parametrize("budget", [32768, 9000])
def test_loader_matches_rap_tpu(budget):
    cfg = dict(max_points_per_batch=budget, prefetch=1)
    jl = JaxLoader([JaxDataset(JaxDatasetConfig(data_path=SYNTH, dataset_name="synth"))],
                   JaxLoaderConfig(**cfg, shuffle=False))
    tl = BatchLoader([PointCloudDataset(DatasetConfig(data_path=SYNTH, dataset_name="synth"))],
                     LoaderConfig(**cfg), device="cpu")
    ref = list(jl.epoch(1))
    got = list(tl.epoch(1))
    assert len(got) == len(ref) == (1 if budget == 32768 else 4)
    for (tb, tn, td), (jb, jn, jd) in zip(got, ref, strict=True):
        assert (tn, td) == (jn, jd)
        _batches_equal(tb, jb)
    assert dataclasses.astuple(tl.padding_stats) == dataclasses.astuple(jl.padding_stats)
    assert not tl.last_thread.is_alive()


def test_loader_thread_ends_when_closed_early():
    tl = BatchLoader([PointCloudDataset(DatasetConfig(data_path=SYNTH))],
                     LoaderConfig(max_points_per_batch=4096, prefetch=1), device="cpu")
    it = tl.epoch(0)
    next(it)
    assert tl.last_thread.is_alive() or tl.last_thread.ident is not None
    it.close()
    assert not tl.last_thread.is_alive()


# ---- metrics, evaluator, meter ------------------------------------------------

S, P, N = 3, 3, 64


def _random_rotations(rng, n):
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ]).transpose(2, 0, 1).astype(np.float32)


def _metric_inputs(seed=0):
    """A padded batch (the last sample slot with one part only) and a
    prediction near the ground truth, with poses near the true ones."""
    jb = jax_batch(jax.random.key(seed), [[64, 40, 30], [50, 64], [20, 64, 64]], N=N, P=P,
                   S=S, feat_dim=8)
    rng = np.random.default_rng(seed)
    pred = np.asarray(jb.points_gt) + 0.05 * rng.standard_normal((S * P, N, 3))
    R = _random_rotations(rng, S * P)
    t_ = np.asarray(jb.translations_gt) + 0.1 * rng.standard_normal((S * P, 3))
    return jb, batch_to_torch(jb), pred.astype(np.float32), R, t_.astype(np.float32)


def _rel(got, ref, what, rtol=1e-5):
    ref = np.asarray(ref, np.float64)
    assert max_err(np.asarray(got), ref) <= rtol * max(float(np.abs(ref).max()), 1e-30), what


def test_metrics_match_rap_tpu():
    jb, tb, pred, R, t_ = _metric_inputs()
    _rel(TM.chamfer_rmse(tb, t(pred)), JM.chamfer_rmse(jb, jnp.asarray(pred)), "chamfer")
    for rel in (True, False):
        got = TM.transform_errors(tb, t(R), t(t_), anchor_relative=rel)
        ref = JM.transform_errors(jb, jnp.asarray(R), jnp.asarray(t_), anchor_relative=rel)
        for g_, r_, name in zip(got, ref, ("rotation", "translation")):
            _rel(g_, r_, f"{name} error (anchor_relative={rel})")
    for per_part in (False, True):
        _rel(TM.rigidity_rmse(tb, t(pred), t(R), t(t_), average_per_part=per_part),
             JM.rigidity_rmse(jb, jnp.asarray(pred), jnp.asarray(R), jnp.asarray(t_),
                              average_per_part=per_part), f"rigidity per_part={per_part}")
    vals = np.array([0.1, 0.25, 0.2, 3.0], np.float32)
    assert np.array_equal(TM.recall_at(t(vals), 0.2).numpy(), JM.recall_at(vals, 0.2))
    assert np.array_equal(TM.combined_recall(t(vals), t(vals[::-1].copy()), 0.2, 0.2).numpy(),
                          JM.combined_recall(vals, vals[::-1], 0.2, 0.2))
    Rb = _random_rotations(np.random.default_rng(9), S * P)
    _rel(rotation_angle_deg(t(R), t(Rb)), jax_rotation_angle_deg(R, Rb), "angle")


def test_evaluator_matches_rap_tpu():
    jb, tb, pred, R, t_ = _metric_inputs(1)
    jev, tev = JaxEvaluator(), Evaluator()
    rng = np.random.default_rng(3)
    gens_t, gens_j, trajs_t, trajs_j = [], [], [], []
    for g in range(3):
        p_g = pred + 0.02 * g * rng.standard_normal(pred.shape).astype(np.float32)
        ref = jev.compute_metrics(jb, jnp.asarray(p_g), jnp.asarray(R), jnp.asarray(t_))
        got = tev.compute_metrics(tb, t(p_g), t(R), t(t_))
        assert list(got) == list(ref)
        for k in ref:
            _rel(got[k], ref[k], k)
        gens_t.append(got)
        gens_j.append(ref)
        traj = np.stack([p_g, p_g + 0.1 * rng.standard_normal(p_g.shape)]).astype(np.float32)
        trajs_t.append(t(traj))
        trajs_j.append(jnp.asarray(traj))
    ref = jev.aggregate_generations(jb, gens_j, trajs_j)
    got = tev.aggregate_generations(tb, gens_t, trajs_t)
    assert set(got) == set(ref) == {"avg", "best_of_3", "rigidity_selected",
                                    "rigidity_selected_gen"}
    assert np.array_equal(got["rigidity_selected_gen"], ref["rigidity_selected_gen"])
    for sec in ("avg", "best_of_3", "rigidity_selected"):
        for k in ref[sec]:
            _rel(got[sec][k], ref[sec][k], f"{sec}/{k}")
    # the options that raised before they were ported now run
    p_g = t(pred)
    for flag in ("use_icp", "overlap_eval_on", "save_results"):
        ev = Evaluator(dataclasses.replace(tev.cfg, **{flag: True}))
        assert set(ev.compute_metrics(tb, p_g, t(R), t(t_))) >= set(
            tev.compute_metrics(tb, p_g, t(R), t(t_)))


def test_meter_matches_rap_tpu():
    rng = np.random.default_rng(2)
    jm, tm = JaxMeter(), MetricsMeter()
    for i in range(3):
        md = {"a": rng.random(4), "b": np.array([np.nan, 1.0, 2.0, np.inf])}
        valid = np.array([True, True, i != 1, False])
        nparts = rng.integers(2, 9, 4)
        for m in (jm, tm):
            m.add_metrics("ds1" if i else ["ds1", "ds2", "ds2", "ds1"], md, valid, nparts)
            m.add_metrics("ds1", {"best/a": md["a"]}, valid)
    assert tm.compute_average() == jm.compute_average()
    assert tm.get_sample_counts() == jm.get_sample_counts()
    assert tm.get_part_count_ranges() == jm.get_part_count_ranges()
    tm.reduce_across_hosts(["ds1", "ds2"])  # one process: unchanged
    assert tm.compute_average() == jm.compute_average()


# ---- the generate step and run_eval --------------------------------------------

def test_generate_with_reflow_student_matches_rap_tpu():
    """One generation of configs/synth_student.yaml (6 layers, rigidity
    forcing; 1 Euler step) with the committed checkpoint on one scene, fp32."""
    from rap_tpu.apps.sample import load_params as jax_load_params
    from rap_tpu.registration import predict_poses as jax_predict_poses
    from rap_tpu.registration import sample as jax_sample

    ov = [f"checkpoint={CKPT}", "model.compute_dtype=float32", "pipeline.inference_sampling_steps=1",
          f"data.datasets.0.data_path={SYNTH}", "data.datasets.0.limit_val_samples=1"]
    jcfg = jconfig.load_config(REPO / "configs" / "synth_student.yaml", ov)
    tcfg = tconfig.load_config(REPO / "configs" / "synth_student.yaml", ov)
    jl = JaxLoader([JaxDataset(jcfg.data.datasets[0])],
                   JaxLoaderConfig(max_points_per_batch=jcfg.data.max_points_per_batch))
    (jb, _, _), = list(jl.epoch(0))
    tb = batch_to_torch(jb)
    assert (tb.S, tb.G, tb.N) == (1, 2, 2048) and tb.no_padding
    x_1 = np.random.default_rng(0).standard_normal((2, 2048, 3)).astype(np.float32)
    jo = jax_sample(jax_load_params(jcfg), jcfg.pipeline, jb, jax.random.key(0),
                    x_1=jnp.asarray(x_1), return_trajectory=False)
    jR, _ = jax_predict_poses(jb, jo["points"])
    out, R, _ = app.make_generate_fn(tcfg, return_trajectory=False)(
        app.load_params(tcfg, "cpu"), tb, x_1=t(x_1))
    ref = np.asarray(jo["points"])
    assert max_err(out["points"].numpy(), ref) <= 1e-4 * float(np.abs(ref).max())
    assert max_err(R.numpy(), jR) <= 1e-4


def _tiny(extra=()):
    return ["--config", str(REPO / "configs" / "synth_student.yaml"), "-o", "checkpoint=",
            "-o", f"data.datasets.0.data_path={SYNTH}", "-o", "data.datasets.0.limit_val_samples=2",
            "-o", "model.num_layers=1", "-o", "pipeline.inference_sampling_steps=1",
            "-o", "pipeline.n_generations=2", "-o", "model.compute_dtype=float32", *extra]


def test_run_eval_gives_rap_tpu_table_keys():
    from rap_tpu.apps.sample import run_eval as jax_run_eval

    argv = _tiny()
    ov = argv[3::2]
    ref = jax_run_eval(jconfig.load_config(argv[1], ov))
    rec = {}
    got = app.run_eval(tconfig.load_config(argv[1], ov), device="cpu", record=rec)
    assert set(got) == set(ref) == {"synth", "overall"}
    for ds in ref:
        assert set(got[ds]) == set(ref[ds])
        assert all(np.isfinite(v) for v in got[ds].values())
    assert rec["pairs"] == 2 and len(rec["gen_ms"]) == 2 and len(rec["load_ms"]) == 1


def test_softcap_override_runs():
    rec = {}
    res = app.main(_tiny(["-o", "model.softcap=5.0", "--device", "cpu"]), record=rec)
    assert all(np.isfinite(v) for v in res["overall"].values())
    assert rec["pairs"] == 2


def test_sample_app_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main(_tiny())
    for bad in ("model.ckpt", "orbax_dir"):
        cfg = tconfig.load_config(None, [f"checkpoint={bad}"])
        with pytest.raises(NotImplementedError, match="A4"):
            app.load_params(cfg, "cpu")
