"""The port's reflow distillation (rap_tpu_torch/apps/reflow_distill)
against rap_tpu's (scripts/reflow_distill.py) on the CPU.

At 2 layers, D = 64, H = 4, fp32, rap_tpu's random weights carried over:
- a couple from a given x_1 (the teacher's rigidity-forced end point, 2
  Euler steps) matches rap_tpu's ``sample(..., x_1=...)`` at 1e-4 of max;
- one retrain step on that couple matches rap_tpu's
  ``make_train_step(with_noise=True)`` at the same timesteps (rap_tpu's
  draws from its state's key): loss 2e-5 relative, parameters 1e-4 of the
  largest element per leaf;
- the teacher's tensors are unchanged after the retrain (the student's
  optimizer works on copies);
- the student exported by ``save_params_npz`` reads back in rap_tpu
  (``load_params_npz``) to the same forward at 1e-5 (fp32 export).
A whole ``main`` at 1 layer on a generated 6-scene dataset (2 steps, 96-point
views) writes the summary keys rap_tpu's script writes with the same
sweep; rap_tpu's is run eval-only (``--student``) to keep it small: its keys
do not depend on the training.
"""

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rap_tpu.core import flow as jflow
from rap_tpu.core.batch import make_regular_synthetic_batch as jax_batch
from rap_tpu.models import DiTConfig as JaxDiTConfig
from rap_tpu.models.dit import dit_forward as jax_dit_forward
from rap_tpu.models.dit import init_dit_params
from rap_tpu.registration import RPFConfig as JaxRPFConfig
from rap_tpu.registration import sample as jax_sample
from rap_tpu.train import OptimizerConfig as JaxOptimizerConfig
from rap_tpu.train import TrainState as JaxTrainState
from rap_tpu.train import build_optimizer
from rap_tpu.train import make_train_step as jax_make_train_step
from rap_tpu_torch.apps import reflow_distill as app
from rap_tpu_torch.models.config import DiTConfig
from rap_tpu_torch.models.dit import master_params
from rap_tpu_torch.registration import RPFConfig
from rap_tpu_torch.train.optim import OptimizerConfig, tree_paths
from torch_parity import batch_to_torch, jax_flat, max_err, params_to_torch, t

REPO = Path(__file__).resolve().parents[1]
S, P, N = 2, 2, 64


@pytest.fixture(scope="module")
def tiny():
    jcfg = JaxDiTConfig(num_layers=2, embed_dim=64, num_heads=4, compute_dtype=jnp.float32)
    tcfg = DiTConfig(num_layers=2, embed_dim=64, num_heads=4, compute_dtype=torch.float32)
    jp = init_dit_params(jax.random.key(3), jcfg)
    jb = jax_batch(jax.random.key(0), [[N, 50], [N, N]], N=N, P=P, S=S, feat_dim=32)
    x_1 = np.asarray(jax.random.normal(jax.random.key(9), (S * P, N, 3), jnp.float32))
    teacher = dict(model=None, inference_sampling_steps=2, rigidity_forcing=True)
    return dict(jcfg=jcfg, jp=jp, jb=jb, tb=batch_to_torch(jb), tp=params_to_torch(jp),
                x_1=x_1, jpipe=JaxRPFConfig(**{**teacher, "model": jcfg}),
                tpipe=RPFConfig(**{**teacher, "model": tcfg}))


def _rel_close(got, ref, rtol, what=""):
    scale = max(float(np.abs(np.asarray(ref, np.float64)).max()), 1e-30)
    assert max_err(got, ref) <= rtol * scale, (what, max_err(got, ref), scale)


def test_couple_matches_rap_tpus_sample(tiny):
    ref = jax_sample(tiny["jp"], tiny["jpipe"], tiny["jb"], jax.random.key(1),
                     x_1=jnp.asarray(tiny["x_1"]), return_trajectory=False)["points"]
    couple = app.make_couple(tiny["tp"], tiny["tpipe"], tiny["tb"], t(tiny["x_1"]))
    _rel_close(couple.points_gt.numpy(), ref, 1e-4, "couple")
    # everything but points_gt is the batch's
    assert torch.equal(couple.points, tiny["tb"].points)


def test_retrain_step_matches_with_noise_and_keeps_the_teacher(tiny, tmp_path):
    couple = app.make_couple(tiny["tp"], tiny["tpipe"], tiny["tb"], t(tiny["x_1"]))
    jcouple = dataclasses.replace(tiny["jb"], points_gt=jnp.asarray(couple.points_gt.numpy()))
    jreflow = dataclasses.replace(tiny["jpipe"], timestep_sampling="uniform")
    jtx = build_optimizer(JaxOptimizerConfig(name="muon", lr=1e-3, grad_clip=0.5))
    # the timesteps rap_tpu draws from its state's key
    k_t = jax.random.split(jax.random.split(jax.random.key(11))[1], 3)[0]
    ts = np.asarray(jflow.sample_timesteps(k_t, S, "uniform"))
    # the jitted step donates its state (the key too): hand it copies
    jstate = JaxTrainState.create(jax.tree.map(jnp.copy, tiny["jp"]), jtx, jax.random.key(11))
    jstate, jm = jax_make_train_step(jreflow, jtx, with_noise=True)(
        jstate, jcouple, jnp.asarray(tiny["x_1"]))

    before = dict(tree_paths(master_params(tiny["tp"], "cpu")))  # copies
    rec = {}
    state = app.retrain(tiny["tp"], [(couple, t(tiny["x_1"]))], 1,
                        dataclasses.replace(tiny["tpipe"], timestep_sampling="uniform"),
                        OptimizerConfig(name="muon", lr=1e-3, grad_clip=0.5), seed=3,
                        device="cpu", t_draws=lambda n: t(ts), record=rec)
    np.testing.assert_allclose(rec["retrain_losses"][0], float(jm["loss"]), rtol=2e-5)
    ref = jax_flat(jstate.params)
    moved = 0
    for k, v in tree_paths(state.params):
        _rel_close(v.numpy(), ref[k], 1e-4, k)
        moved += not torch.equal(v, before[k])
    assert moved > 10  # the step changed the student
    for k, v in tree_paths(master_params(tiny["tp"], "cpu")):  # and not the teacher
        assert torch.equal(v, before[k]), k

    # the exported student reads back in rap_tpu to the same forward
    from rap_tpu.train.checkpoint import load_params_npz as jax_load_npz
    from rap_tpu_torch.apps.train import serving_params
    from rap_tpu_torch.models.dit import dit_forward
    from rap_tpu_torch.train.checkpoint import save_params_npz

    student = serving_params(state.params, tiny["tpipe"].model)
    save_params_npz(tmp_path / "s.npz", student, dtype=torch.float32)
    jstudent = jax_load_npz(tmp_path / "s.npz", tiny["jp"])
    tt = np.full((S,), 0.4, np.float32)
    ref = jax_dit_forward(jstudent, tiny["jcfg"], jnp.asarray(tiny["x_1"]), jnp.asarray(tt),
                          tiny["jb"], parts_per_sample=P)
    got = dit_forward(student, tiny["tpipe"].model, t(tiny["x_1"]), t(tt), tiny["tb"],
                      parts_per_sample=P)
    _rel_close(got.detach().numpy(), ref, 1e-5, "exported student's forward")


def test_retrain_order_and_sweep_tokens():
    """The couples in a new seeded permutation each pass: every couple once
    a pass; a sweep token's schedule suffix."""
    order = app._passes(np.random.default_rng(0), 2)
    seen = [next(order) for _ in range(4)]
    assert sorted(seen[:2]) == sorted(seen[2:]) == [0, 1]
    assert app.parse_token("4:power:0.5") == (4, "power:0.5")
    assert app.parse_token("2") == (2, "uniform")


def _rap_tpu_script(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def test_main_writes_rap_tpus_summary_keys(tmp_path):
    from rap_tpu.data.synthetic_scenes import generate_dataset
    from rap_tpu.train.checkpoint import save_checkpoint, save_params_npz as jax_save_npz

    data = tmp_path / "data"
    generate_dataset(data, n_scenes=6, max_points_per_view=96, seed=0)
    jcfg = JaxDiTConfig(num_layers=1)
    jp = init_dit_params(jax.random.key(0), jcfg)
    jtx = build_optimizer(JaxOptimizerConfig(name="muon"))
    save_checkpoint(tmp_path / "jteacher", JaxTrainState.create(jp, jtx, jax.random.key(1)),
                    {"steps": 0})
    jax_save_npz(tmp_path / "teacher.npz", jp)
    common = ["--data-root", str(data), "--layers", "1", "--batch-tokens", "2048",
              "--teacher-steps", "2", "--steps", "2", "--couple-epochs", "1",
              "--eval-steps-sweep", "2:power:0.5"]
    _rap_tpu_script("reflow_distill").main(common + [
        "--teacher", str(tmp_path / "jteacher"), "--student", str(tmp_path / "jteacher"),
        "--out", str(tmp_path / "j")])
    ref = json.loads((tmp_path / "j" / "summary.json").read_text())
    rec = {}
    got = app.main(common + ["--teacher", str(tmp_path / "teacher.npz"), "--out",
                             str(tmp_path / "t"), "--export-npz", str(tmp_path / "s.npz"),
                             "--device", "cpu"], record=rec)
    assert json.loads((tmp_path / "t" / "summary.json").read_text()) == got
    assert set(got) == set(ref) and "val/student@2steps:power:0.5" in got
    assert set(got["config"]) == set(ref["config"]) | {"device"}
    for k, v in ref.items():
        if k.startswith("val/"):
            assert set(got[k]) == set(v), k
    assert 0 < got["linearity/teacher"] <= 1 + 1e-6
    assert len(rec["retrain_ms"]) == 2 and np.isfinite(rec["retrain_losses"]).all()
    assert (tmp_path / "t" / "ckpts" / "final" / "rap_metadata.json").exists()
    assert (tmp_path / "s.npz").exists()
    # the saved student evaluates again through --student (a train-state dir)
    again = app.main(common + ["--teacher", str(tmp_path / "teacher.npz"), "--student",
                               str(tmp_path / "t" / "ckpts" / "final"), "--out",
                               str(tmp_path / "t2"), "--device", "cpu"])
    key = "val/student@2steps:power:0.5"
    assert again[key] == got[key]
