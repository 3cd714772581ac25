"""The port's training entry point and its options against rap_tpu on the CPU.

- the loader's training plan (shuffle, the per-dataset cap, S padded to a
  multiple) over two datasets for epochs 0-2: plans, names, order and every
  ``PartBatch`` field equal to rap_tpu's; ``plan_batches`` with shuffle and
  ``s_multiple`` alone;
- the learning rate at each step equal to optax's ``multistep_schedule``
  with ``steps_per_epoch`` (milestones in epochs);
- three Muon steps over the loader's batches from rap_tpu's initial
  parameters, with rap_tpu's own t and x_1 draws recomputed from its keys:
  losses within 2e-5 relative, each parameter leaf within 1e-4 of its
  largest element;
- the pose loss (and with it FF dropout under rap_tpu's own keep masks):
  loss, metrics and every gradient leaf against ``jax.value_and_grad``
  (2e-5 / 1e-4) on a batch with degenerate parts (1 and 2 valid points),
  whose gradients stay finite; the dropout FF alone against rap_tpu's
  composition under the same mask (2e-5); a dropout step with remat equal
  to one without (the recompute draws the first forward's masks);
- ``make_scanned_train_steps`` against a loop of steps;
- ``run_train`` end to end (artifacts, best/last, resume, ``n_devices=2``
  in a world of 1 refused); ``run_train`` in a gloo world of 2 (the ranks
  agree on every metric and the final state, rank 0 alone writes, the
  validation of a world of 1, and a resume whose rank 1 reads an empty
  checkpoint directory takes rank 0's best monitor); ``evaluate_split``
  against rap_tpu's with the same noise; the tracker's files.
"""

import dataclasses
import json
import sys
import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rap_tpu.core import flow as jflow
from rap_tpu.core.batch import make_regular_synthetic_batch as jax_batch
from rap_tpu.data import BatchLoader as JaxLoader
from rap_tpu.data import LoaderConfig as JaxLoaderConfig
from rap_tpu.data import PointCloudDataset as JaxDataset
from rap_tpu.data.dataset import DatasetConfig as JaxDatasetConfig
from rap_tpu.data.packer import plan_batches as jax_plan_batches
from rap_tpu.eval.runner import evaluate_split as jax_evaluate_split
from rap_tpu.models import DiTConfig as JaxDiTConfig
from rap_tpu.models.dit import _geglu_ff as jax_geglu_ff
from rap_tpu.models.dit import init_dit_params as jax_init
from rap_tpu.registration import RPFConfig as JaxRPFConfig
from rap_tpu.registration import training_forward as jax_training_forward
from rap_tpu.train.optim import OptimizerConfig as JaxOptimizerConfig
from rap_tpu.train.optim import build_optimizer, multistep_schedule
from rap_tpu.train.step import TrainState as JaxTrainState
from rap_tpu.train.step import make_train_step as jax_make_train_step
from rap_tpu.utils import ply as plyio
from rap_tpu_torch.apps import train as app
from rap_tpu_torch.config import load_config
from rap_tpu_torch.core.batch import TENSOR_FIELDS, make_regular_synthetic_batch
from rap_tpu_torch.data import BatchLoader, DatasetConfig, LoaderConfig, PointCloudDataset
from rap_tpu_torch.data.packer import plan_batches
from rap_tpu_torch.eval.runner import evaluate_split
from rap_tpu_torch.models.config import DiTConfig
from rap_tpu_torch.models.dit import dropout_ff, init_dit_params, master_params
from rap_tpu_torch.registration import RPFConfig, training_forward
from rap_tpu_torch.train.checkpoint import load_metadata
from rap_tpu_torch.train.optim import Optimizer, OptimizerConfig, tree_paths, tree_replace
from rap_tpu_torch.train.step import TrainState, make_scanned_train_steps, make_train_step
from rap_tpu_torch.train.tracking import ExperimentTracker, find_run_id, snapshot_code
from torch_parity import batch_to_torch, jax_flat, params_to_torch, run_world, t

REPO = Path(__file__).resolve().parents[1]


def _rel_close(got, ref, rtol, what=""):
    ref = np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - ref).max())
    assert err <= rtol * scale, f"{what}: max err {err:.3e} > {rtol:.0e} * {scale:.3e}"


def _write_scenes(root: Path, rng, n: int, parts=(2, 5), sizes=(20, 300), splits=None):
    """``n`` scenes of random part counts and sizes, with a train split (all
    scenes, or ``splits``: {split: [scene indices]}) and num_points files."""
    names = [f"scene_{i:03d}" for i in range(n)]
    totals = []
    for name in names:
        d = root / name
        d.mkdir(parents=True)
        total = 0
        for p in range(int(rng.integers(parts[0], parts[1] + 1))):
            m = int(rng.integers(sizes[0], sizes[1] + 1))
            plyio.write_ply(d / f"part_{p:02d}.ply",
                            (rng.standard_normal((m, 3)) * [2.0, 1.0, 0.5]).astype(np.float32))
            total += m
        totals.append(total)
    splits = splits or {"train": list(range(n)), "val": list(range(n))}
    (root / "data_split").mkdir()
    (root / "num_points").mkdir()
    for split, idx in splits.items():
        (root / "data_split" / f"{split}.txt").write_text("".join(f"{names[i]}\n" for i in idx))
        (root / "num_points" / f"{split}.txt").write_text(
            "".join(f"{totals[i]}\n" for i in idx))
    return root


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_data")
    rng = np.random.default_rng(0)
    return {"a": _write_scenes(root / "a", rng, 11), "b": _write_scenes(root / "b", rng, 6),
            "even": _write_scenes(root / "even", rng, 8, parts=(2, 2), sizes=(90, 128))}


# --------------------------------------------------------------------------
# the loader's training options
# --------------------------------------------------------------------------

def test_plan_batches_shuffle_and_s_multiple_match_rap_tpu():
    rng = np.random.default_rng(4)
    parts = rng.integers(2, 9, 40).tolist()
    sizes = rng.integers(100, 5000, 40).tolist()
    for budget, seed, m in ((40_000, 0, 1), (40_000, 3, 2), (9000, 5, 4), (200_000, 7, 3)):
        ref = jax_plan_batches(parts, sizes, budget, shuffle=True, seed=seed, s_multiple=m)
        got = plan_batches(parts, sizes, budget, shuffle=True, seed=seed, s_multiple=m)
        assert [(p.indices, p.N, p.P, p.S) for p in got] == \
            [(p.indices, p.N, p.P, p.S) for p in ref]
        assert all(p.S % m == 0 for p in got)


def test_training_loader_matches_rap_tpu(data):
    kw = dict(max_points_per_batch=2048, shuffle=True, seed=3, prefetch=1,
              max_samples_per_epoch=7, s_multiple=2)
    cfgs = [dict(data_path=str(data[k]), dataset_name=k, split="train") for k in ("a", "b")]
    jl = JaxLoader([JaxDataset(JaxDatasetConfig(**c)) for c in cfgs], JaxLoaderConfig(**kw))
    tl = BatchLoader([PointCloudDataset(DatasetConfig(**c)) for c in cfgs], LoaderConfig(**kw),
                     device="cpu")
    orders = []
    for epoch in range(3):
        jp, tp = jl._epoch_plan(epoch), tl._epoch_plan(epoch)
        assert [(d, p.indices, p.N, p.P, p.S) for d, p in tp] == \
            [(d, p.indices, p.N, p.P, p.S) for d, p in jp]
        assert tl.num_batches(epoch) == jl.num_batches(epoch)
        orders.append([p.indices for _, p in tp])
        ref, got = list(jl.epoch(epoch)), list(tl.epoch(epoch))
        assert len(got) == len(ref) > 1
        for (tb, tn, td), (jb, jn, jd) in zip(got, ref, strict=True):
            assert (tn, td) == (jn, jd)
            assert tb.no_padding == jb.no_padding and tb.S % 2 == 0
            for f in TENSOR_FIELDS:
                assert np.array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f))), f
        assert dataclasses.astuple(tl.padding_stats) == dataclasses.astuple(jl.padding_stats)
    assert orders[0] != orders[1]  # a new shuffle and cap every epoch
    capped = {i for _, p in tl._epoch_plan(0) for i in p.indices}
    assert len(capped) <= 2 * 7


@pytest.mark.parametrize("steps_per_epoch", [1, 3])
def test_lr_schedule_matches_optax(steps_per_epoch):
    kw = dict(lr_milestones=(2, 5, 6), lr_gamma=0.5)
    opt = Optimizer(OptimizerConfig(**kw), steps_per_epoch)
    ref = multistep_schedule(2e-3, JaxOptimizerConfig(**kw), steps_per_epoch)
    for count in range(25):
        got = opt._lr(2e-3, torch.tensor(count, dtype=torch.int32))
        assert np.float32(got) == np.float32(ref(count)), count


# --------------------------------------------------------------------------
# trainer steps, the pose loss and FF dropout
# --------------------------------------------------------------------------

def _tiny(dropout=0.0, pose=0.0):
    jm = JaxDiTConfig(embed_dim=64, num_layers=2, num_heads=4, compute_dtype=jnp.float32,
                      dropout_rate=dropout)
    tm = DiTConfig(embed_dim=64, num_layers=2, num_heads=4, compute_dtype=torch.float32,
                   dropout_rate=dropout)
    return (JaxRPFConfig(model=jm, pose_loss_weight=pose),
            RPFConfig(model=tm, pose_loss_weight=pose))


def _jax_draws(jr, rng, batch):
    k_t, k_noise, k_drop = jax.random.split(rng, 3)
    ts = np.asarray(jflow.sample_timesteps(k_t, batch.S, jr.timestep_sampling))
    x_1 = np.asarray(jax.random.normal(k_noise, batch.points.shape, jnp.float32))
    return ts, x_1, k_drop


def _jax_keep(k_drop, rate, layers, shape):
    return [t(np.asarray(jax.random.bernoulli(k, 1.0 - rate, shape)))
            for k in jax.random.split(k_drop, layers)]


def test_three_muon_steps_over_the_loader_match_rap_tpu(data):
    jr, tr = _tiny()
    kw = dict(max_points_per_batch=512, shuffle=True, seed=1, prefetch=1, s_multiple=2)
    cfg = dict(data_path=str(data["even"]), dataset_name="even", split="train")
    jbatches = [b for b, _, _ in JaxLoader([JaxDataset(JaxDatasetConfig(**cfg))],
                                           JaxLoaderConfig(**kw)).epoch(0)][:3]
    tbatches = [b for b, _, _ in BatchLoader([PointCloudDataset(DatasetConfig(**cfg))],
                                             LoaderConfig(**kw), device="cpu").epoch(0)][:3]
    assert len(tbatches) == 3
    opt_kw = dict(lr_milestones=(1,))  # steps_per_epoch 2: the lr halves at step 2
    tx = build_optimizer(JaxOptimizerConfig(**opt_kw), steps_per_epoch=2)
    jp = jax_init(jax.random.key(5), jr.model)
    rng = jax.random.key(9)
    jstate = JaxTrainState.create(jax.tree.map(jnp.copy, jp), tx, rng)
    jstep = jax_make_train_step(jr, tx)
    tstate = TrainState.create(params_to_torch(jax.tree.map(np.asarray, jp)),
                               OptimizerConfig(**opt_kw), seed=0, device="cpu")
    tstep = make_train_step(tr, OptimizerConfig(**opt_kw), device="cpu", steps_per_epoch=2)
    for i, (jb, tb) in enumerate(zip(jbatches, tbatches)):
        rng, sub = jax.random.split(rng)
        ts, x_1, _ = _jax_draws(jr, sub, jb)
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb, x_1=t(x_1), t=t(ts))
        _rel_close(float(tm["loss"]), float(jm["loss"]), 2e-5, f"step {i} loss")
        ref = jax_flat(jstate.params)
        for k, v in tree_paths(tstate.params):
            _rel_close(v.numpy(), ref[k], 1e-4, f"step {i} {k}")


@pytest.fixture(scope="module")
def degenerate():
    """A padded batch whose parts include 1 and 2 valid points."""
    jb = jax_batch(jax.random.key(2), [[64, 2], [1, 64]], N=64, P=2, S=2, feat_dim=32)
    return jb, batch_to_torch(jb)


@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["pose", "pose+dropout"])
def test_pose_loss_and_gradients_match_jax(degenerate, dropout):
    jb, tb = degenerate
    assert int(np.asarray(tb.point_mask).sum(1).min()) == 1
    jr, tr = _tiny(dropout=dropout, pose=0.5)
    jp = jax_init(jax.random.key(1), jr.model)
    rng = jax.random.key(6)
    ts, x_1, k_drop = _jax_draws(jr, rng, jb)
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: jax_training_forward(p, jr, jb, rng, remat=True), has_aux=True)(jp)
    keep = (_jax_keep(k_drop, dropout, 2, (jb.G, jb.points.shape[1], 4 * 64))
            if dropout else None)
    tp = master_params(params_to_torch(jax.tree.map(np.asarray, jp)), "cpu")
    leaves = {k: v.detach().requires_grad_(True) for k, v in tree_paths(tp)}
    loss, m = training_forward(tree_replace(tp, leaves), tr, tb, None, remat=True,
                               x_1=t(x_1), t=t(ts), dropout_keep=keep)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    _rel_close(loss.detach().numpy(), jloss, 2e-5, "loss")
    assert set(m) == set(jm) and "pose_loss" in m
    for name, v in jm.items():
        _rel_close(m[name].numpy(), v, 2e-5, name)
    ref = jax_flat(jg)
    for k, g in grads.items():
        assert bool(torch.isfinite(g).all()), k
        _rel_close(g.numpy(), ref[k], 1e-4, k)


def test_dropout_ff_matches_rap_tpu_composition():
    rng = np.random.default_rng(3)
    D, FH = 64, 256
    lp = {"ff_norm": {"scale": 1 + 0.1 * rng.standard_normal(D), "bias": rng.standard_normal(D)},
          "ff_in": {"kernel": rng.standard_normal((D, 2 * FH)) / 8, "bias": rng.standard_normal(2 * FH)},
          "ff_out": {"kernel": rng.standard_normal((FH, D)) / 16, "bias": rng.standard_normal(D)}}
    lp = jax.tree.map(lambda a: np.asarray(a, np.float32), lp)
    x = rng.standard_normal((3, 40, D)).astype(np.float32)
    key = jax.random.key(8)
    ref = jax_geglu_ff(jax.tree.map(jnp.asarray, lp), jnp.asarray(x), dropout_rate=0.2,
                       dropout_key=key)
    keep = t(np.asarray(jax.random.bernoulli(key, 0.8, (3, 40, FH))))
    got = dropout_ff(jax.tree.map(t, lp), t(x), 0.2, keep)
    _rel_close(got.numpy(), ref, 2e-5, "dropout ff")
    # a seed draws its mask: the same seed, the same output; another, another
    a, b = (dropout_ff(jax.tree.map(t, lp), t(x), 0.2, s) for s in (11, 11))
    assert torch.equal(a, b)
    assert not torch.equal(a, dropout_ff(jax.tree.map(t, lp), t(x), 0.2, 12))


def test_dropout_step_with_remat_equals_one_without():
    _, tr = _tiny(dropout=0.3)
    batch = make_regular_synthetic_batch(0, [[48, 32], [40, 40]], N=48, P=2, S=2,
                                         device="cpu")
    params = init_dit_params(3, tr.model, device="cpu", masters=True)
    out = []
    for remat in (True, False):
        state = TrainState.create(params, OptimizerConfig(), seed=4, device="cpu")
        step = make_train_step(tr, OptimizerConfig(), remat=remat, device="cpu")
        state, m = step(state, batch)
        state, m2 = step(state, batch)
        out.append((m, m2, dict(tree_paths(state.params))))
    (m_r, m2_r, p_r), (m_n, m2_n, p_n) = out
    for a, b in ((m_r, m_n), (m2_r, m2_n)):
        np.testing.assert_allclose(float(a["loss"]), float(b["loss"]), rtol=1e-6)
        np.testing.assert_allclose(float(a["grad_norm"]), float(b["grad_norm"]), rtol=1e-5)
    for k in p_r:
        np.testing.assert_allclose(p_r[k].numpy(), p_n[k].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert float(m_r["loss"]) != float(m2_r["loss"])


def test_scanned_steps_equal_a_loop_of_steps():
    _, tr = _tiny()
    batches = [make_regular_synthetic_batch(s, [[32, 24], [32, 32]], N=32, P=2, S=2,
                                            device="cpu") for s in (0, 1)]
    params = init_dit_params(3, tr.model, device="cpu", masters=True)
    step = make_train_step(tr, OptimizerConfig(), device="cpu")
    s = TrainState.create(params, OptimizerConfig(), seed=4, device="cpu")
    ref = []
    for b in batches:
        s, m = step(s, b)
        ref.append(float(m["loss"]))
    scanned = make_scanned_train_steps(tr, OptimizerConfig(), 2, device="cpu")
    stacked = dataclasses.replace(batches[0], **{
        f: torch.stack([getattr(b, f) for b in batches]) for f in TENSOR_FIELDS
        if getattr(batches[0], f) is not None})
    for arg in (batches, stacked):
        s2, losses = scanned(TrainState.create(params, OptimizerConfig(), seed=4,
                                               device="cpu"), arg)
        assert losses.tolist() == ref and int(s2.step) == 2
        for k, v in tree_paths(s2.params):
            assert torch.equal(v, dict(tree_paths(s.params))[k]), k
    with pytest.raises(ValueError, match="3 steps"):
        make_scanned_train_steps(tr, OptimizerConfig(), 3, device="cpu")(s, batches)


# --------------------------------------------------------------------------
# run_train, evaluate_split, the tracker
# --------------------------------------------------------------------------

def _train_argv(data_root, ckpt_dir, *extra):
    ov = ["model.num_layers=2", "model.embed_dim=64", "model.num_heads=4",
          "model.compute_dtype=float32", "trainer.max_epochs=2", "trainer.val_every_n_epochs=1",
          "trainer.train_points_per_batch=1024", "trainer.log_every_n_steps=1",
          f"trainer.checkpoint_dir={ckpt_dir}", "data.max_points_per_batch=2048",
          "pipeline.inference_sampling_steps=2", "pipeline.pose_loss_weight=0.1",
          "model.dropout_rate=0.1",
          f"data.datasets=[{{'data_path': '{data_root}', 'dataset_name': 'toy', "
          f"'split': 'train'}}, {{'data_path': '{data_root}', 'dataset_name': 'toy', "
          "'split': 'val'}]", *extra]
    return ["--config", str(REPO / "configs" / "rap_train.yaml"), "--device", "cpu"] + \
        [a for o in ov for a in ("-o", o)]


def test_run_train_end_to_end(tmp_path):
    root = _write_scenes(tmp_path / "data", np.random.default_rng(1), 6, parts=(2, 3),
                         sizes=(40, 90), splits={"train": [0, 1, 2, 3], "val": [4, 5]})
    ck = tmp_path / "ckpts"
    rec = {}
    state = app.main(_train_argv(root, ck), record=rec)
    n1 = int(state.step)
    assert n1 == len(rec["step_ms"]) >= 2 and rec["epochs"] == [0, 1]
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["pose_loss"])
               and m["skipped_nonfinite"] == 0.0 for m in rec["metrics"])
    rows = [json.loads(x) for x in (ck / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows if "train/loss" in r] == list(range(1, n1 + 1))
    assert sum(any(k.startswith("val/") for k in r) for r in rows) == 2
    for f in ("config.json", "code_snapshot.zip", "best", "last"):
        assert (ck / f).exists(), f
    assert json.loads((ck / "config.json").read_text())["model"]["compute_dtype"] == "float32"
    assert load_metadata(ck / "last")["epoch"] == 2
    best = load_metadata(ck / "best")
    vals = [r["overall"]["object_chamfer"] for r in rec["val_results"]]
    assert best["monitor"] == min(vals) and best["epoch"] == 1 + int(np.argmin(vals))

    # resume from last: epoch 2 only, the step count carries on, best kept
    rec2 = {}
    state2 = app.main(_train_argv(root, ck, f"checkpoint={ck / 'last'}",
                                  "trainer.max_epochs=3"), record=rec2)
    assert rec2["epochs"] == [2] and rec2["best_monitor_start"] == best["monitor"]
    assert int(rec2["restored"]["step"]) == n1 and int(state2.step) > n1
    rows = [json.loads(x) for x in (ck / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows if "train/loss" in r][n1] == n1 + 1
    if rec2["val_results"][0]["overall"]["object_chamfer"] >= best["monitor"]:
        assert load_metadata(ck / "best") == best
    # --max-steps stops early; n_devices must be the world's size
    rec4 = {}
    app.main(_train_argv(root, tmp_path / "c4") + ["--max-steps", "1"], record=rec4)
    assert len(rec4["step_ms"]) == 1 and not (tmp_path / "c4" / "last").exists()
    with pytest.raises(ValueError, match="world has 1 process"):
        app.main(_train_argv(root, tmp_path / "c5", "n_devices=2"))


def test_run_train_in_a_world_of_2(tmp_path):
    """apps.train.main on two gloo ranks (tests/torch_parallel_worker.py):
    one epoch, then a resume for a second in which rank 1's checkpoint
    directory is empty. No dropout, whose masks differ per rank."""
    root = _write_scenes(tmp_path / "data", np.random.default_rng(1), 6, parts=(2, 3),
                         sizes=(40, 90), splits={"train": [0, 1, 2, 3], "val": [4, 5]})
    ck, empty = tmp_path / "ckpts", tmp_path / "rank1_ckpts"
    run1 = _train_argv(root, ck, "model.dropout_rate=0.0", "trainer.max_epochs=1")
    run2 = {r: _train_argv(root, ck if r == 0 else empty, "model.dropout_rate=0.0",
                           f"checkpoint={ck / 'last'}", "trainer.max_epochs=2")
            for r in (0, 1)}
    r0, r1 = (out["train_app"] for out in
              run_world({"train_app": {r: [run1, run2[r]] for r in (0, 1)}}, 2,
                        tmp_path / "world"))
    for a, b in zip(r0, r1, strict=True):
        assert a["step"] == b["step"] and a["metrics"] == b["metrics"]  # the global metrics
        assert a["val_results"] == b["val_results"]
        assert all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])
        assert all(np.isfinite(m["loss"]) and m["skipped_nonfinite"] == 0.0
                   for m in a["metrics"])
    n1 = r0[0]["step"]
    cfg = load_config(REPO / "configs" / "rap_train.yaml", run2[0][5::2])
    # each step a slice of a planned batch whose S is a multiple of 2
    loader = BatchLoader([PointCloudDataset(d) for d in cfg.data.datasets
                          if d.split == "train"],
                         LoaderConfig(max_points_per_batch=cfg.trainer.train_points_per_batch,
                                      shuffle=True, seed=cfg.trainer.seed, s_multiple=2,
                                      max_samples_per_epoch=cfg.data.max_samples_per_epoch),
                         device="cpu")
    assert n1 == loader.num_batches(0) == len(r0[0]["metrics"]) > 1
    assert r0[1]["step"] == n1 + loader.num_batches(1)
    assert [s["bytes"] > 0 for s in r0[0]["saves"]] == [True] * len(r0[0]["saves"])
    assert [s["bytes"] for s in r1[0]["saves"]] == [0] * len(r0[0]["saves"])
    assert not empty.exists()  # rank 1 writes nothing
    rows = [json.loads(x) for x in (ck / "metrics.jsonl").read_text().splitlines()]
    assert sum("train/loss" in r for r in rows) == r0[1]["step"]  # rank 0's log only
    best = load_metadata(ck / "best")["monitor"]
    assert r0[1]["best_monitor_start"] == r1[1]["best_monitor_start"] <= best
    # the validation of a world of 1 on the final state's parameters
    val = [PointCloudDataset(d) for d in cfg.data.datasets if d.split.startswith("val")]
    want = app.evaluate_validation(cfg, r0[1]["params_tree"], val, 1, "cpu")
    got = r0[1]["val_results"][-1]
    assert set(got) == set(want)
    for ds, md in want.items():
        for k, v in md.items():
            np.testing.assert_allclose(got[ds][k], v, rtol=1e-5, atol=1e-7, err_msg=k)


def test_evaluate_split_matches_rap_tpu(data):
    # without rigidity forcing: forced generations are rigid to float noise,
    # and the rigidity-selected pick between them would be noise too
    jr, tr = (dataclasses.replace(c, inference_sampling_steps=2, rigidity_forcing=False)
              for c in _tiny())
    jp = jax_init(jax.random.key(4), jr.model)
    tp = params_to_torch(jax.tree.map(np.asarray, jp))
    cfg = dict(data_path=str(data["even"]), dataset_name="even", limit_val_samples=4)
    kw = dict(batch_tokens=1024, seed=100, n_generations=2, dataset_key="even")
    ref = jax_evaluate_split(jp, jr, JaxDataset(JaxDatasetConfig(**cfg)), **kw)

    def noise(b, g, shape):
        key = jax.random.fold_in(jax.random.key(100 + b), g)
        return t(np.asarray(jax.random.normal(key, shape, jnp.float32)))

    got = evaluate_split(tp, tr, PointCloudDataset(DatasetConfig(**cfg)), device="cpu",
                         noise=noise, **kw)
    assert set(got) == set(ref) and any(k.startswith("best_of_2/") for k in got)
    for k, v in ref.items():
        assert abs(got[k] - v) <= 1e-4 * max(1.0, abs(v)), (k, got[k], v)


def test_tracker_files(tmp_path):
    run = tmp_path / "run"
    tr = ExperimentTracker(run, config=DiTConfig(num_layers=1))
    tr.log(3, {"loss": torch.tensor(0.5), "grad_norm": 2.0})
    tr.log_dict(4, {"synth": {"object_chamfer": 0.1}})
    tr.finish()
    rows = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    assert rows == [{"step": 3, "train/loss": 0.5, "train/grad_norm": 2.0},
                    {"step": 4, "val/synth/object_chamfer": 0.1}]
    assert json.loads((run / "config.json").read_text())["compute_dtype"] == "bfloat16"
    with zipfile.ZipFile(run / "code_snapshot.zip") as z:
        names = z.namelist()
    assert "rap_tpu_torch/apps/train.py" in names and all(n.endswith(".py") for n in names)
    assert find_run_id(run) is None
    (run / "wandb_run_id.txt").write_text("abc\n")
    assert find_run_id(run) == "abc"
    side = ExperimentTracker(tmp_path / "r2", jsonl_path=tmp_path / "logs" / "m.jsonl",
                             snapshot=False)
    side.log(1, {"loss": 1.0})
    side.finish()
    assert (tmp_path / "logs" / "m.jsonl").read_text().count("\n") == 1
    assert not (tmp_path / "r2" / "code_snapshot.zip").exists()
    assert snapshot_code(tmp_path / "r3").is_file()
    assert "wandb" not in sys.modules  # the mirror is opt-in: never imported here


def test_svd3_matches_torch_svd_forward_and_backward():
    """The pose loss's sync-free SVD: H = U S V^T with U a rotation, V
    orthogonal (1e-6), the Kabsch rotation it gives within 2e-6 of the one
    from torch.linalg.svd, and its analytic backward equal to torch's SVD
    autograd (float64, 1e-10 of the largest), rank-2 and rank-1 inputs
    included."""
    from rap_tpu_torch.core.procrustes import svd3

    g = torch.Generator().manual_seed(0)
    H = torch.randn(300, 3, 3, generator=g)
    H[::5, :, 2] = 0.0                     # rank 2
    H[1::7, :, 1:] = 0.0                   # rank 1
    H[2::9, :, 2] *= 1e-4                  # nearly rank 2
    U, S, Vh = svd3(H)
    eye = torch.eye(3)
    assert float(((U * S[..., None, :]) @ Vh - H).abs().max()) <= 1e-6 * float(H.abs().max())
    assert float((U.transpose(-1, -2) @ U - eye).abs().max()) <= 1e-6
    assert float((Vh @ Vh.transpose(-1, -2) - eye).abs().max()) <= 1e-6
    assert bool((torch.linalg.det(U) > 0.999).all())

    def rot(h, fn):
        u, _, vh = fn(h)
        v = vh.transpose(-1, -2)
        d = torch.linalg.det(v @ u.transpose(-1, -2))
        return (v * torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1)[..., None, :]) \
            @ u.transpose(-1, -2)

    full = torch.randn(40, 3, 3, generator=g)  # rank 3: the rotation is unique
    assert float((rot(full, svd3) - rot(full, torch.linalg.svd)).abs().max()) <= 2e-6
    h64 = torch.randn(50, 3, 3, generator=g, dtype=torch.float64)
    w = torch.randn(50, 3, 3, generator=g, dtype=torch.float64)
    grads = [torch.autograd.grad((rot(x, fn) * w).sum(), x)[0]
             for fn in (svd3, torch.linalg.svd) for x in (h64.clone().requires_grad_(True),)]
    assert float((grads[0] - grads[1]).abs().max()) <= 1e-10 * float(grads[1].abs().max())
