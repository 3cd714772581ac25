"""Training entry point (counterpart of rap_tpu/apps/train.py).

    python -m rap_tpu_torch.apps.train --config configs/rap_train.yaml \\
        -o data.datasets='[{"data_path": "...", "dataset_name": "kitti", "split": "train"}]'
    python -m rap_tpu_torch.apps.train --config configs/rap_train.yaml \\
        -o model.num_layers=2 -o trainer.max_epochs=1 ... --device cpu

``run_train`` (:90-209): the datasets whose split starts with "train" feed a
shuffled loader (``trainer.seed``, ``data.max_samples_per_epoch``,
``data.num_prefetch``, ``trainer.train_points_per_batch`` points a batch);
the optimizer counts its learning-rate milestones in epochs of the first
epoch's planned batches; the parameters start from
``init_dit_params(trainer.seed)`` and the generator from ``trainer.seed +
1``, or from the train state at ``checkpoint`` (its epoch and, from
``<checkpoint_dir>/best``, its best monitor value: a resumed run does not
overwrite a better ``best``). Each step is ``train.step.make_train_step``
(Muon or AdamW, remat per ``trainer.remat``); every ``log_every_n_steps``
its metrics go to the tracker (``train/tracking.py``: ``metrics.jsonl``,
``config.json``, ``code_snapshot.zip`` in ``checkpoint_dir``; the wandb
mirror only with ``--wandb``, as it needs the network). Every
``val_every_n_epochs`` epochs the datasets whose split starts with "val"
are sampled and scored (``evaluate_validation``: ``sample`` +
``predict_poses`` + the evaluator + the meter, batch b's noise from a
generator seeded from (1234 + epoch, b)); a better ``trainer.monitor``
saves ``best``, and ``keep_last``
saves ``last`` after every epoch (``train/checkpoint.py``, the port's own
train-state format). ``--max-steps`` stops after that many steps of this
run. The logged step is the state's: it carries on across a resume (rap_tpu
logs the steps of the run).

Runs on the card (``--device cuda``, the default) unless the CPU is asked
for; ``--profile-dir`` writes a torch.profiler Chrome trace of the run,
with the program's ``rap.*`` spans (``rap_tpu_torch.telemetry``).

Several GPUs (train.py:88-210), one process each:

    torchrun --nproc-per-node 4 -m rap_tpu_torch.apps.train \
        --config configs/rap_train.yaml -o data.datasets=...

Each process joins the world (``parallel.distributed``: nccl on the card,
gloo with ``--device cpu``) on ``cuda:LOCAL_RANK``; ``n_devices`` 0 means
the world size, and any other count than the world size raises. Every
rank plans the same batches and loads its slice of each (the loader's
slice mode, S a multiple of the world size), steps data-parallel
(``train.step``: the global loss's gradient, one all-reduce a step) and so
holds the same state; validation splits the batches over the ranks
(stride mode) and reduces the meter. Rank 0 alone tracks and writes
checkpoints (with barriers), and its best monitor is broadcast, so that a
rank that reads another checkpoint directory takes the same save branch.
A world joined by the caller before ``run_train`` (also a world of 1) is
used as it is.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import sys
import time
from pathlib import Path

import torch

from .. import telemetry
from .._device import resolve_device
from ..config import Config, load_config
from ..data import BatchLoader, LoaderConfig, PointCloudDataset
from ..eval import Evaluator, MetricsMeter
from ..eval.meter import print_eval_table
from ..models.config import DiTConfig
from ..models.dit import attach_bounds, init_dit_params, to_device
from ..parallel.distributed import is_initialized, process_group, world
from ..parallel.mesh import broadcast, make_mesh
from ..registration import predict_poses, sample, seeded_generator
from ..train.checkpoint import (load_metadata, restore_checkpoint, save_checkpoint,
                                train_state_tensors)
from ..train.optim import tree_paths
from ..train.step import TrainState, make_train_step
from ..train.tracking import ExperimentTracker, find_run_id

logger = logging.getLogger("rap_tpu_torch.train")


def _get_monitor(results: dict, monitor: str) -> float:
    """``monitor`` is "val/<dataset>/<metric>"."""
    ds, metric = monitor.split("/")[-2:]
    return results.get(ds, {}).get(metric, float("inf"))


def serving_params(params, cfg: DiTConfig):
    """Training masters -> the serving form sampling takes: the kernels'
    matrices in the compute dtype, guard bounds from the current gains."""
    def tree(node):  # a new structure over the same tensors: attach_bounds adds keys
        if isinstance(node, dict):
            return {k: tree(v) for k, v in node.items()}
        return [tree(v) for v in node] if isinstance(node, list) else node

    return to_device(attach_bounds(tree(params)), params["anchor_emb"].device,
                     cfg.compute_dtype)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def evaluate_validation(cfg: Config, params, val_datasets, epoch: int,
                        device="cuda") -> dict:
    """Sampling evaluation of the validation datasets (train.py:57-87):
    {dataset: {metric: mean}} with an 'overall' entry. In a joined world of
    several ranks each takes every world-size-th batch (stride mode) and
    the meter is summed over the ranks; batch b's noise is seeded from b,
    so any world scores what a world of 1 scores."""
    device = resolve_device(device)
    rank, world_size = world()
    serve = serving_params(params, cfg.model)
    evaluator = Evaluator(cfg.eval)
    meter = MetricsMeter()
    for ds in val_datasets:
        loader = BatchLoader([ds], LoaderConfig(
            max_points_per_batch=cfg.data.max_points_per_batch, prefetch=cfg.data.num_prefetch,
            process_index=rank, process_count=world_size, shard_mode="stride"), device=device)
        for i, (batch, _names, ds_name) in enumerate(loader.epoch(0)):
            generator = seeded_generator(device, 1234 + epoch, rank + i * world_size)
            out = sample(serve, cfg.pipeline, batch, generator=generator,
                         return_trajectory=False)
            R, t = predict_poses(batch, out["points"])
            md = evaluator.compute_metrics(batch, out["points"], R, t)
            meter.add_metrics(ds_name, {k: v.detach().cpu().numpy() for k, v in md.items()},
                              batch.sample_valid.cpu().numpy(),
                              batch.part_valid.reshape(batch.S, -1).sum(1).cpu().numpy())
    meter.reduce_across_hosts([ds.cfg.dataset_name for ds in val_datasets])
    return meter.compute_average()


def run_train(cfg: Config, max_steps: int | None = None, device="cuda",
              record: dict | None = None, use_wandb: bool = False) -> TrainState:
    """Train per ``cfg`` (see the module docstring); returns the last state.
    ``use_wandb`` mirrors the metrics to wandb (it reaches the network).
    ``record``, if given, receives per step its wall ms (synchronised),
    loader wait ms, kernel launches and metrics, per validation pass its ms,
    launches and results, each save's ms and bytes, the restore's ms and the
    restored state's tensors (``train_state_tensors``)."""
    device = resolve_device(device)
    with process_group(device) as (rank, world_size):
        return _train(cfg, max_steps, device, record, use_wandb, rank, world_size)


def _train(cfg: Config, max_steps, device, record, use_wandb: bool, rank: int,
           world_size: int) -> TrainState:
    n_dev = cfg.n_devices or world_size
    if n_dev != world_size:
        raise ValueError(f"n_devices={cfg.n_devices} but the world has {world_size} "
                         f"process(es): launch one process per device (torchrun "
                         f"--nproc-per-node {n_dev})")
    mesh = make_mesh(n_dev, device) if is_initialized() else None
    if mesh is not None:
        device = mesh.device
    logger.info("training on %d device(s), rank %d of %d", n_dev, rank, world_size)
    rec = record if record is not None else {}
    rec.update(step_ms=[], load_ms=[], step_launches=[], metrics=[], epochs=[], val_ms=[],
               val_launches=[], val_results=[], saves=[])
    train_datasets = [PointCloudDataset(d) for d in cfg.data.datasets
                      if d.split.startswith("train")]
    val_datasets = [PointCloudDataset(d) for d in cfg.data.datasets if d.split.startswith("val")]
    if not train_datasets:
        raise ValueError("no train datasets configured (a data.datasets entry with a "
                         "split starting with 'train')")
    loader = BatchLoader(train_datasets, LoaderConfig(
        max_points_per_batch=cfg.trainer.train_points_per_batch, shuffle=True,
        seed=cfg.trainer.seed, prefetch=cfg.data.num_prefetch,
        max_samples_per_epoch=cfg.data.max_samples_per_epoch, process_index=rank,
        process_count=world_size, s_multiple=n_dev), device=device)
    steps_per_epoch = max(loader.num_batches(0), 1)

    params = init_dit_params(cfg.trainer.seed, cfg.model, device=device, masters=True)
    state = TrainState.create(params, cfg.optimizer, seed=cfg.trainer.seed + 1, device=device)
    start_epoch = 0
    ckpt_dir = Path(cfg.trainer.checkpoint_dir)
    if cfg.checkpoint:
        t0 = time.perf_counter()
        state = restore_checkpoint(cfg.checkpoint, state)
        _sync(device)
        rec["restore_ms"] = (time.perf_counter() - t0) * 1e3
        if record is not None:
            rec["restored"] = train_state_tensors(state)
        start_epoch = load_metadata(cfg.checkpoint).get("epoch", 0)
        logger.info("resumed from %s at epoch %d", cfg.checkpoint, start_epoch)
    n_params = sum(v.numel() for _, v in tree_paths(state.params))
    logger.info("model %s %.1fM params | %d steps/epoch", cfg.model_name, n_params / 1e6,
                steps_per_epoch)
    step_fn = make_train_step(cfg.pipeline, cfg.optimizer, remat=cfg.trainer.remat,
                              device=device, steps_per_epoch=steps_per_epoch, mesh=mesh)
    mlog = ExperimentTracker(run_dir=ckpt_dir, config=cfg,
                             resume_id=find_run_id(ckpt_dir) if cfg.checkpoint else None,
                             jsonl_path=cfg.trainer.log_file or None, use_wandb=use_wandb,
                             rank_zero=rank == 0)
    # a resumed run starts from the best monitor value saved so far, so its
    # first validation cannot overwrite a better 'best'
    best_monitor = float("inf")
    if cfg.checkpoint:
        best_meta = load_metadata(ckpt_dir / "best")
        if "monitor" in best_meta:
            best_monitor = float(best_meta["monitor"])
            logger.info("resumed best %s=%.4f", cfg.trainer.monitor, best_monitor)
    if mesh is not None:
        # only rank 0 writes rap_metadata.json: a rank reading another
        # checkpoint directory would see no monitor, keep inf, take another
        # branch at the first validation and deadlock the collective save
        best_monitor = float(broadcast(torch.tensor(best_monitor, dtype=torch.float64,
                                                    device=device), mesh))
    rec["best_monitor_start"] = best_monitor
    global_step = int(state.step)
    run_steps = 0
    try:
        for epoch in range(start_epoch, cfg.trainer.max_epochs):
            rec["epochs"].append(epoch)
            t_epoch = time.perf_counter()
            with contextlib.closing(loader.epoch(epoch)) as batches:
                while True:
                    t0 = time.perf_counter()
                    item = next(batches, None)
                    if item is None:
                        break
                    batch = item[0]
                    t1 = time.perf_counter()
                    with telemetry.counted("launch.") as launches:
                        state, metrics = step_fn(state, batch)
                    global_step += 1
                    run_steps += 1
                    if record is not None:
                        _sync(device)
                        rec["load_ms"].append((t1 - t0) * 1e3)
                        rec["step_ms"].append((time.perf_counter() - t1) * 1e3)
                        rec["step_launches"].append(launches)
                        rec["metrics"].append({k: float(v) for k, v in metrics.items()})
                        rec["last_batch"] = batch
                    if global_step % cfg.trainer.log_every_n_steps == 0:
                        mlog.log(global_step, metrics)
                    if max_steps and run_steps >= max_steps:
                        return state
            logger.info("epoch %d done in %.1fs | padding: %s", epoch,
                        time.perf_counter() - t_epoch, loader.padding_stats.summary())

            if (epoch + 1) % cfg.trainer.val_every_n_epochs == 0 and val_datasets:
                t0 = time.perf_counter()
                with telemetry.counted("launch.") as launches:
                    results = evaluate_validation(cfg, state.params, val_datasets, epoch,
                                                  device)
                _sync(device)
                rec["val_ms"].append((time.perf_counter() - t0) * 1e3)
                rec["val_launches"].append(launches)
                rec["val_results"].append(results)
                if rank == 0:
                    print_eval_table({"val": results})
                mlog.log_dict(global_step, results, prefix="val")
                mon = _get_monitor(results, cfg.trainer.monitor)
                if mon < best_monitor:
                    best_monitor = mon
                    _save(rec, "best", epoch, ckpt_dir / "best", state,
                          {"epoch": epoch + 1, "monitor": mon}, device)
                    logger.info("new best %s=%.4f", cfg.trainer.monitor, mon)
            if cfg.trainer.keep_last:
                _save(rec, "last", epoch, ckpt_dir / "last", state, {"epoch": epoch + 1},
                      device)
    finally:
        mlog.finish()
        for ds in train_datasets + val_datasets:
            ds.close()
    return state


def _save(rec, name: str, epoch: int, path: Path, state: TrainState, metadata: dict,
          device) -> None:
    t0 = time.perf_counter()
    nbytes = save_checkpoint(path, state, metadata)
    _sync(device)
    rec["saves"].append({"name": name, "epoch": epoch, "ms": (time.perf_counter() - t0) * 1e3,
                         "bytes": nbytes, "metadata": metadata})


def main(argv=None, record: dict | None = None) -> TrainState:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="configs/rap_train.yaml")
    ap.add_argument("-o", "--override", action="append", default=[], help="key.sub=value")
    ap.add_argument("--max-steps", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    ap.add_argument("--profile-dir", default="",
                    help="write a torch.profiler trace (Chrome format) to this dir")
    ap.add_argument("--wandb", action="store_true",
                    help="mirror the metrics to wandb (needs the network)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args.config, args.override)
    kw = dict(max_steps=args.max_steps or None, device=device, record=record,
              use_wandb=args.wandb)
    if not args.profile_dir:
        return run_train(cfg, **kw)
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if device.type == "cuda" else [])
    with profile(activities=activities) as prof:
        state = run_train(cfg, **kw)
    out = Path(args.profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))
    logger.info("profiler trace written to %s", out / "trace.json")
    return state


if __name__ == "__main__":
    main()
