"""The port's multi-GPU layer against rap_tpu's, on the CPU at fp32.

The port runs in gloo worlds of 2 and 4 CPU processes
(tests/torch_parallel_worker.py, one spawn a world size, every multi-process
check of that world in it); rap_tpu runs single-process on the 8-device
CPU mesh of tests/conftest.py (``make_mesh(2)``, ``make_mesh(4)``). The
same inputs, made with numpy from a seed, go to both.

- ring attention at n = 2 and 4: forward (2e-5 abs / 1e-4 rel), softcap, a
  fully masked shard, every key masked, the gradients of q, k and v (5e-4 /
  1e-3), as tests/test_ring_attention.py holds rap_tpu's; and against the
  port's world of 1;
- the sequence-sharded model: ``dit_forward`` with the ring against
  rap_tpu's ``ring_mesh`` forward, ``sample`` (3 steps, forcing) against
  rap_tpu's on the same noise (points 1e-4 of max), and a world of n
  against a world of 1 (points, trajectories, features, the pruned branch);
- the data-parallel train step at a world of 2, on a batch whose ranks hold
  different numbers of valid points, against rap_tpu's ``make_train_step``
  over ``make_mesh(2)`` (loss 2e-5, parameters 1e-4 of max) and against the
  port's world of 1, with the parameters bitwise equal across the ranks;
  and the check that a mean of per-rank mean losses would fail it;
- the loader's slice and stride modes against rap_tpu's (plans equal to the
  index, batches equal), the meter's reduction (different keys per rank, a
  rank with no batch) against one meter fed every batch, rank-0 checkpoint
  saves restored on every rank, and ``initialize``'s guards.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rap_tpu.core import flow as jflow
from rap_tpu.core.batch import make_regular_synthetic_batch as jax_batch
from rap_tpu.data import BatchLoader as JaxLoader
from rap_tpu.data import DatasetConfig as JaxDatasetConfig
from rap_tpu.data import LoaderConfig as JaxLoaderConfig
from rap_tpu.data import PointCloudDataset as JaxDataset
from rap_tpu.models import DiTConfig as JaxDiTConfig
from rap_tpu.models.dit import dit_forward as jax_dit_forward
from rap_tpu.models.dit import init_dit_params as jax_init
from rap_tpu.ops.ring_attention import ring_attention as jax_ring
from rap_tpu.parallel.distributed import slice_local_batch as jax_slice
from rap_tpu.parallel.mesh import make_mesh as jax_mesh
from rap_tpu.parallel.mesh import shard_batch as jax_shard
from rap_tpu.registration import RPFConfig as JaxRPFConfig
from rap_tpu.registration import sample as jax_sample
from rap_tpu.train import OptimizerConfig as JaxOptimizerConfig
from rap_tpu.train import TrainState as JaxTrainState
from rap_tpu.train import build_optimizer
from rap_tpu.train import make_train_step as jax_make_train_step
from rap_tpu_torch.core.batch import TENSOR_FIELDS
from rap_tpu_torch.data import BatchLoader, DatasetConfig, LoaderConfig, PointCloudDataset
from rap_tpu_torch.eval.meter import MetricsMeter
from rap_tpu_torch.models.config import DiTConfig
from rap_tpu_torch.models.dit import dit_forward, master_params
from rap_tpu_torch.ops.attention import batched_attention
from rap_tpu_torch.ops.ring_attention import ring_attention
from rap_tpu_torch.parallel import distributed, initialize, make_mesh, shard_batch
from rap_tpu_torch.registration import RPFConfig, sample, training_forward
from rap_tpu_torch.train.optim import OptimizerConfig, tree_paths
from rap_tpu_torch.train.step import TrainState, make_train_step
from torch_parity import REPO_ROOT, batch_to_torch, jax_flat, params_to_torch, run_worlds, t

SYNTH = str(REPO_ROOT / "demo_data" / "synth")
WORLDS = (2, 4)
MODEL = dict(num_layers=2, embed_dim=64, num_heads=4, local_feat_dim=8, attn_impl="dense")
PARTS = [[48, 40, 48, 32, 48, 48, 24, 40]]   # one sample, 8 parts of N = 48
DP_PARTS = [[32, 16], [16, 8], [32, 32]]      # S = 4: rank 0 holds 72 valid points, rank 1 64
TRAIN_STEPS = 2  # steps with rap_tpu's draws; two more drawn by the port's generator


def _rel_close(got, ref, rtol, what=""):
    ref = np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - ref).max())
    assert err <= rtol * scale, f"{what}: max err {err:.3e} > {rtol:.0e} * {scale:.3e}"


def _ring_cases(n):
    """name -> (q, k, v, mask, softcap), (B, T, H, d) = (2, T, 4, 32)."""
    def inputs(seed, T, mask_frac=0.25):
        rng = np.random.default_rng(seed)
        q, k, v = (rng.standard_normal((2, T, 4, 32)).astype(np.float32) for _ in range(3))
        return q, k, v, rng.uniform(size=(2, T)) > mask_frac

    cases = {"dense": inputs(0, 256) + (0.0,), "softcap": inputs(1, 256) + (4.0,),
             "grad": inputs(4, 64) + (0.0,)}
    q, k, v, mask = inputs(2, 128)
    mask[:, :128 // n] = False  # the first rank's keys all masked
    cases["masked_shard"] = (q, k, v, mask, 0.0)
    q, k, v, _ = inputs(3, 64)
    cases["all_masked"] = (q, k, v, np.zeros((2, 64), bool), 0.0)
    return cases


@pytest.fixture(scope="module")
def model():
    jcfg = JaxDiTConfig(**MODEL, compute_dtype=jnp.float32)
    tcfg = DiTConfig(**MODEL, compute_dtype=torch.float32)
    jp = jax_init(jax.random.key(1), jcfg)
    jb = jax_batch(jax.random.key(0), PARTS, N=48, P=8, S=1, feat_dim=8)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((8, 48, 3)).astype(np.float32)
    x_1 = rng.standard_normal((8, 48, 3)).astype(np.float32)
    jpipe = JaxRPFConfig(model=jcfg, inference_sampling_steps=3, rigidity_forcing=True)
    tpipe = RPFConfig(model=tcfg, inference_sampling_steps=3, rigidity_forcing=True)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=params_to_torch(jp), jb=jb,
                tb=batch_to_torch(jb), x=x, x_1=x_1, jpipe=jpipe, tpipe=tpipe)


def _sample_runs(tpipe):
    """The sampling runs each world does: name -> (pipeline, sample kwargs)."""
    return {"points": (tpipe, dict(return_trajectory=False)),
            "traj_feats": (tpipe, dict(return_trajectory=True,
                                       return_transformer_features=True)),
            "pruned": (dataclasses.replace(tpipe, prune_coarse_steps=1),
                       dict(return_trajectory=False, prune_index=torch.arange(48)))}


def _dp_inputs():
    """The data-parallel case: rap_tpu's batch, parameters and per-step
    draws (t from rap_tpu's step keys, x_1 from numpy)."""
    jr = JaxRPFConfig(model=JaxDiTConfig(**MODEL, compute_dtype=jnp.float32))
    tr = RPFConfig(model=DiTConfig(**MODEL, compute_dtype=torch.float32))
    jb = jax_batch(jax.random.key(0), DP_PARTS, N=32, P=2, S=4, feat_dim=8)
    jp = jax_init(jax.random.key(2), jr.model)
    rng, noise = jax.random.key(11), np.random.default_rng(6)
    draws = []
    for _ in range(TRAIN_STEPS):
        rng, sub = jax.random.split(rng)
        k_t = jax.random.split(sub, 3)[0]
        draws.append((np.asarray(jflow.sample_timesteps(k_t, 4, jr.timestep_sampling)),
                      noise.standard_normal((8, 32, 3)).astype(np.float32)))
    return jr, tr, jb, jp, draws


METER_ADDS = [
    [("dsA", {"shared": [1.0, 3.0], "only0": [5.0, 5.0]}, [True, True], [2, 3])],
    [("dsB", {"shared": [7.0, np.nan], "only1": [9.0, 2.0]}, [True, False], [4, 6])],
    [("dsA", {"shared": [2.0, 4.0]}, [True, True], [5, 2]),
     (["dsA", "dsB"], {"shared": [0.5, 1.5], "pair": [0.25, 0.75]}, [True, True])],
    [],  # a rank with no batch
]


@pytest.fixture(scope="module")
def worlds(model, tmp_path_factory):
    """Each world's spawn: {n: [rank results]}; world 2 also trains, and
    saves and restores a checkpoint, world 4 also reduces the meter."""
    tr_dp, tb_dp, tp_dp, draws = _dp_port_inputs()
    jobs = []
    for n in WORLDS:
        work = tmp_path_factory.mktemp(f"world{n}")
        spec = {
            "ring": {name: dict(q=q, k=k, v=v, mask=m, softcap=c)
                     for name, (q, k, v, m, c) in _ring_cases(n).items()},
            "dit": dict(params=model["tp"], cfg=model["tcfg"], batch=model["tb"],
                        x=t(model["x"]), t=torch.tensor([0.5])),
            "sample": dict(params=model["tp"], batch=model["tb"], x_1=t(model["x_1"]),
                           runs=_sample_runs(model["tpipe"])),
        }
        if n == 2:
            spec["train"] = dict(cfg=tr_dp, opt=OptimizerConfig(), params=tp_dp, seed=0,
                                 batch=tb_dp, draws=draws)
            spec["checkpoint"] = dict(params=tp_dp, opt=OptimizerConfig(),
                                      path=str(work / "ckpt" / "last"))
        else:
            spec["meter"] = dict(adds=METER_ADDS, registry=["dsA", "dsB"])
        jobs.append((spec, n, work))
    return dict(zip(WORLDS, run_worlds(jobs)))


def _dp_port_inputs():
    _, tr, jb, jp, draws = _dp_inputs()
    steps = [{"t": t(ts), "x_1": t(x_1)} for ts, x_1 in draws] + [{}, {}]
    return tr, batch_to_torch(jb), params_to_torch(jp), steps


def _local(results, key):
    return torch.cat([r[key] for r in results])


# --------------------------------------------------------------------------
# ring attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("case", ["dense", "softcap", "masked_shard", "all_masked"])
def test_ring_attention_matches_rap_tpu(worlds, n, case):
    q, k, v, mask, softcap = _ring_cases(n)[case]
    mesh = jax_mesh(n)
    ref = np.asarray(jax.jit(lambda *a: jax_ring(*a, mesh, softcap=softcap))(
        *map(jnp.asarray, (q, k, v, mask))))
    got = torch.cat([r["ring"][case]["out"] for r in worlds[n]], 1).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-4)
    one = ring_attention(t(q), t(k), t(v), t(mask), make_mesh(device="cpu"), softcap=softcap)
    np.testing.assert_allclose(got, one.numpy(), atol=2e-5, rtol=1e-4)
    dense = batched_attention(t(q), t(k), t(v), t(mask), impl="dense", softcap=softcap)
    np.testing.assert_allclose(one.numpy(), dense.numpy(), atol=2e-5, rtol=1e-4)
    if case == "all_masked":
        assert not got.any()


@pytest.mark.parametrize("n", WORLDS)
def test_ring_attention_gradients_match_rap_tpu(worlds, n):
    q, k, v, mask, _ = _ring_cases(n)["grad"]
    mesh = jax_mesh(n)
    ref = jax.jit(jax.grad(
        lambda a, b, c: jnp.sum(jax_ring(a, b, c, jnp.asarray(mask), mesh) ** 2),
        argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
    for name, r in zip(("dq", "dk", "dv"), ref):
        got = torch.cat([w["ring"]["grad"][name] for w in worlds[n]], 1).numpy()
        np.testing.assert_allclose(got, np.asarray(r), atol=5e-4, rtol=1e-3, err_msg=name)


# --------------------------------------------------------------------------
# the sequence-sharded model
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", WORLDS)
def test_dit_forward_with_the_ring_matches_rap_tpu(worlds, model, n):
    mesh, x, ts = jax_mesh(n), jnp.asarray(model["x"]), jnp.asarray([0.5])
    ref = jax.jit(lambda p, xx, b: jax_dit_forward(p, model["jcfg"], xx, ts, b,
                                                    parts_per_sample=8, ring_mesh=mesh)
                  )(model["jp"], x, jax_shard(model["jb"], mesh))
    got = torch.cat([r["dit"]["v"] for r in worlds[n]]).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=5e-4, rtol=1e-3)
    one = dit_forward(model["tp"], model["tcfg"], t(model["x"]), torch.tensor([0.5]),
                      model["tb"], parts_per_sample=8)
    _rel_close(got, one.numpy(), 1e-5, "world of n vs world of 1")


@pytest.mark.parametrize("n", WORLDS)
def test_ring_backward_under_remat_equals_the_one_without(worlds, n):
    """The hop's autograd.Function recomputed under torch.utils.checkpoint:
    the same velocity and input gradient as without remat."""
    for r in worlds[n]:
        assert torch.equal(r["dit"]["remat"], r["dit"]["v"])
        _rel_close(r["dit"]["dx_True"].numpy(), r["dit"]["dx_False"].numpy(), 1e-6, "dx")


@pytest.mark.parametrize("n", WORLDS)
def test_sample_with_the_ring_matches_rap_tpu(worlds, model, n):
    mesh = jax_mesh(n)
    x_1 = jnp.asarray(model["x_1"])
    ref = jax.jit(lambda p, b: jax_sample(p, model["jpipe"], b, jax.random.key(3), x_1=x_1,
                                          return_trajectory=False, ring_mesh=mesh)["points"]
                  )(model["jp"], jax_shard(model["jb"], mesh))
    pts = [r["sample"]["points"]["points"] for r in worlds[n]]
    assert all(torch.equal(p, pts[0]) for p in pts)  # every rank returns the global points
    _rel_close(pts[0].numpy(), np.asarray(ref), 1e-4, "points")


@pytest.mark.parametrize("n", WORLDS)
def test_sample_world_of_n_matches_world_of_1(worlds, model, n):
    for name, (cfg, kw) in _sample_runs(model["tpipe"]).items():
        one = sample(model["tp"], cfg, model["tb"], x_1=t(model["x_1"]), **kw)
        for r in worlds[n]:
            got = r["sample"][name]
            assert set(got) == set(one), name
            for key, ref in one.items():
                _rel_close(got[key].numpy(), ref.numpy(), 1e-4, f"{name} {key}")


def test_sharded_sampling_refuses_local_noise(model):
    shard = shard_batch(model["tb"], make_mesh(device="cpu"))
    mesh = dataclasses.replace(make_mesh(device="cpu"), size=2)
    with pytest.raises(ValueError, match="global noise"):
        sample(model["tp"], model["tpipe"], shard, x_1=torch.zeros(4, 48, 3), ring_mesh=mesh)


# --------------------------------------------------------------------------
# the data-parallel train step
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dp_rap_tpu():
    jr, _, jb, jp, draws = _dp_inputs()
    tx = build_optimizer(JaxOptimizerConfig())
    state = JaxTrainState.create(jax.tree.map(jnp.copy, jp), tx, jax.random.key(11))
    step = jax_make_train_step(jr, tx, mesh=jax_mesh(2), with_noise=True)
    out = []
    for _, x_1 in draws:
        state, m = step(state, jb, jnp.asarray(x_1))
        out.append((float(m["loss"]), float(m["grad_norm"]), jax_flat(state.params)))
    return out


def test_dp_train_step_matches_rap_tpu(worlds, dp_rap_tpu):
    for i, (loss, gnorm, params) in enumerate(dp_rap_tpu):
        for r in worlds[2]:
            got = r["train"][i]
            _rel_close(got["metrics"]["loss"], loss, 2e-5, f"step {i} loss")
            _rel_close(got["metrics"]["grad_norm"], gnorm, 2e-5, f"step {i} grad norm")
            for k, v in got["params"].items():
                _rel_close(v.numpy(), params[k], 1e-4, f"step {i} {k}")


def test_dp_train_step_matches_a_world_of_1(worlds):
    tr, tb, tp, steps = _dp_port_inputs()
    state = TrainState.create(tp, OptimizerConfig(), seed=0, device="cpu")
    step = make_train_step(tr, OptimizerConfig(), device="cpu")
    for i, draw in enumerate(steps):  # the last two draw from the state's generator
        state, m = step(state, tb, **draw)
        ref = dict(tree_paths(state.params))
        for r in worlds[2]:
            got = r["train"][i]
            assert set(got["metrics"]) == set(m)
            for name, v in m.items():
                _rel_close(got["metrics"][name], float(v), 2e-5, f"step {i} {name}")
            for k, v in got["params"].items():
                _rel_close(v.numpy(), ref[k].numpy(), 1e-4, f"step {i} {k}")


def test_dp_parameters_are_bitwise_equal_across_ranks(worlds):
    r0, r1 = (r["train"] for r in worlds[2])
    for a, b in zip(r0, r1, strict=True):
        assert a["metrics"] == b["metrics"]
        assert all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])


def test_a_mean_of_per_rank_means_would_fail_the_dp_check(dp_rap_tpu):
    """The ranks hold 72 and 64 valid points: the mean of their mean losses
    is not the global loss, by far more than the DP check's tolerance."""
    tr, tb, tp, steps = _dp_port_inputs()
    params = master_params(tp, "cpu")
    halves = []
    for r in range(2):
        shard = distributed.slice_local_batch(tb, r, 2)
        ts, x_1 = steps[0]["t"][2 * r:2 * r + 2], steps[0]["x_1"][4 * r:4 * r + 4]
        halves.append(float(training_forward(params, tr, shard, None, remat=False,
                                             x_1=x_1, t=ts)[0]))
    loss = dp_rap_tpu[0][0]
    assert abs(np.mean(halves) - loss) > 100 * 2e-5 * abs(loss), (halves, loss)


# --------------------------------------------------------------------------
# batches, the loader, the meter, checkpoints, joining
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rank", [0, 1])
def test_slice_local_batch_matches_rap_tpu(rank):
    jb = jax_batch(jax.random.key(0), DP_PARTS, N=32, P=2, S=4, feat_dim=8)
    ref = jax_slice(jax.tree.map(np.asarray, jb), rank, 2)
    got = distributed.slice_local_batch(batch_to_torch(jb), rank, 2)
    assert distributed.process_slice(4, rank, 2) == (2 * rank, 2 * rank + 2)
    for f in TENSOR_FIELDS:
        want = np.asarray(getattr(ref, f))
        if f == "sample_of_part":  # rap_tpu's stays global; the port's counts from 0
            want = want - 2 * rank
        assert np.array_equal(getattr(got, f).numpy(), want), f


def test_shard_batch_splits_parts_and_replicates_per_sample_leaves(model):
    """An S = 1 map-merge batch over 2 ranks: parts split, per-sample
    tensors whole (rap_tpu distributed.py:152-156); 8 parts over 3 ranks
    refused, not replicated."""
    tb = model["tb"]
    for rank in (0, 1):
        mesh = dataclasses.replace(make_mesh(device="cpu"), size=2, rank=rank)
        shard = shard_batch(tb, mesh)
        assert shard.G == 4 and shard.S == 1
        assert torch.equal(shard.points, tb.points[4 * rank:4 * rank + 4])
        assert torch.equal(shard.scale, tb.scale) and not shard.sample_of_part.any()
    with pytest.raises(ValueError, match="do not divide over 3 ranks"):
        shard_batch(tb, dataclasses.replace(make_mesh(device="cpu"), size=3))


@pytest.mark.parametrize("mode", ["slice", "stride"])
def test_loader_shard_modes_match_rap_tpu(mode):
    kw = dict(max_points_per_batch=8192, shuffle=True, seed=3, prefetch=1, s_multiple=2,
              process_count=2, shard_mode=mode)
    for rank in (0, 1):
        jl = JaxLoader([JaxDataset(JaxDatasetConfig(data_path=SYNTH, dataset_name="synth"))],
                       JaxLoaderConfig(**kw, process_index=rank))
        tl = BatchLoader([PointCloudDataset(DatasetConfig(data_path=SYNTH,
                                                          dataset_name="synth"))],
                         LoaderConfig(**kw, process_index=rank), device="cpu")
        jp, tp = jl._epoch_plan(1), tl._epoch_plan(1)
        assert [(d, p.indices, p.N, p.P, p.S) for d, p in tp] == \
            [(d, p.indices, p.N, p.P, p.S) for d, p in jp]
        ref, got = list(jl.epoch(1)), list(tl.epoch(1))
        assert len(got) == len(ref) >= 2
        for (tb, tn, td), (jb, jn, jd) in zip(got, ref, strict=True):
            assert (tn, td) == (jn, jd) and tb.no_padding == jb.no_padding
            lo = rank * tb.S if mode == "slice" else 0
            for f in TENSOR_FIELDS:
                want = np.asarray(getattr(jb, f)) - (lo if f == "sample_of_part" else 0)
                assert np.array_equal(getattr(tb, f).numpy(), want), f


def test_loader_refuses_an_uneven_slice():
    with pytest.raises(ValueError, match="s_multiple"):
        BatchLoader([], LoaderConfig(process_count=2, s_multiple=3), device="cpu")


def test_meter_reduction_matches_one_meter_fed_every_batch(worlds):
    ref = MetricsMeter()
    for adds in METER_ADDS:
        for args in adds:
            ref.add_metrics(*args)
    want = ref.compute_average()
    for r in worlds[4]:
        got = r["meter"]
        assert set(got["average"]) == set(want)
        for ds, md in want.items():
            assert set(got["average"][ds]) == set(md), ds
            for k, v in md.items():
                np.testing.assert_allclose(got["average"][ds][k], v, rtol=1e-12)
        assert got["samples"] == ref.get_sample_counts() == {"dsA": 4, "dsB": 1}
        assert got["part_ranges"] == ref.get_part_count_ranges() == {"dsA": (2, 5),
                                                                     "dsB": (4, 4)}


def test_rank0_checkpoint_save_is_restored_on_every_rank(worlds):
    r0, r1 = (r["checkpoint"] for r in worlds[2])
    assert r0["bytes"] > 0 and r1["bytes"] == 0  # rank 0 writes, every rank restores
    assert r0["equal"] and r1["equal"]


def test_initialize_joins_nothing_for_one_process(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "OMPI_COMM_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("SLURM_NTASKS", "1")  # a one-task allocation: no rendezvous
    monkeypatch.setenv("SLURM_PROCID", "0")
    assert initialize(device="cpu") == (0, 1) and not distributed.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    assert distributed.launcher_world()[:2] == (2, 1)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        initialize(device="cpu")
    assert not distributed.is_initialized()
    with pytest.raises(ValueError, match="world of 1"):
        make_mesh(2, device="cpu")
