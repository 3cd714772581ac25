"""Batch evaluation entry point (counterpart of rap_tpu/apps/sample.py).

    python -m rap_tpu_torch.apps.sample --config configs/synth_student.yaml
    python -m rap_tpu_torch.apps.sample --config configs/synth_student.yaml \\
        -o model.softcap=5.0 -o checkpoint= --device cpu
    python -m rap_tpu_torch.apps.sample --config configs/synth_student.yaml \\
        -o pipeline.n_generations=3 -o eval.save_results=true \\
        -o eval.output_dir=/tmp/results --profile-dir /tmp/trace

Per batch of the loader, ``pipeline.n_generations`` generations through
``registration.sample`` (with trajectories when the rigidity selection
averages over them or the per-step artifacts need them) and
``predict_poses``, the evaluator's metrics (every ``eval.*`` option of
rap_tpu), each generation's artifacts with ``eval.save_results``
(sample.py:143-165), their aggregation over generations (average,
best-of-N, rigidity- and overlap-selected), and one table per section at
the end. Timing follows rap_tpu's contract (sample.py:128-135): the
generation only, closed by ``torch.cuda.synchronize()`` on the card;
metrics and artifacts are not timed (``record['post_ms']`` holds their time
per batch). The noise of generation g of batch b comes from a
``torch.Generator`` on the run's device seeded from (``trainer.seed``, b,
g); it is not jax.random's. ``--profile-dir`` writes a torch.profiler
Chrome trace of the whole run there (rap_tpu's writes a jax.profiler one),
with the program's ``rap.*`` spans (``rap_tpu_torch.telemetry``).

Several GPUs (sample.py:110-125, :207), one process each: ``torchrun
--nproc-per-node N -m rap_tpu_torch.apps.sample ...``. Rank i evaluates
the planned batches i, i + N, ... (the loader's stride mode; batch b's
noise still seeded from b, so any world samples what a world of 1
samples), the meter is summed over the ranks, and rank 0 prints the
tables; artifacts are written by the rank that made them.

Runs on the card (``--device cuda``, the default) unless the CPU is asked
for. ``checkpoint`` may be a committed ``.npz`` export, a torch
``.ckpt``/``.pth``/``.pt`` of the reference (a path, or an artifact name
found in the local cache), or a train-state directory of
``rap_tpu_torch.apps.train``. Not ported (raises): rap_tpu's orbax
directories (orbax needs jax).

``visualize: true`` (sample.py:91-105, :166-181) renders each batch
through ``eval.visualizer.FlowVisualization`` with the ``visualizer``
section: the last generation's points, its trajectories and transformer
features (returned only then), moved to the host once per batch; the
renders are not timed.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .._device import resolve_device
from ..config import Config, load_config
from ..data import BatchLoader, LoaderConfig, PointCloudDataset
from ..eval import Evaluator, MetricsMeter
from ..eval.meter import print_eval_table
from ..models.dit import init_dit_params
from ..parallel.distributed import process_group
from ..registration import predict_poses, sample, seeded_generator
from ..weights import load_params_npz

logger = logging.getLogger("rap_tpu_torch.sample")


def load_params(cfg: Config, device="cuda"):
    """The model's parameters on ``device`` (sample.py:38-62): from an
    ``.npz`` export, a torch ``.ckpt``/``.pth``/``.pt`` (resolved through
    ``train.weights.resolve_checkpoint``), or a train-state directory; random
    weights from ``trainer.seed`` when no checkpoint is given."""
    from ..models.dit import attach_bounds, to_device
    from ..train.checkpoint import (convert_torch_state_dict, is_train_state_dir,
                                    load_train_state_params, read_torch_checkpoint,
                                    torch_checkpoint_layers)
    from ..train.weights import resolve_checkpoint

    device = resolve_device(device)
    ckpt = cfg.checkpoint
    L = cfg.model.num_layers
    if not ckpt:
        logger.warning("no checkpoint given — evaluating RANDOM weights")
        return init_dit_params(cfg.trainer.seed, cfg.model, device=device)
    if ckpt.endswith(".npz"):
        logger.info("loading npz params %s", ckpt)
        params = load_params_npz(ckpt, device=device, compute_dtype=cfg.model.compute_dtype)
    elif ckpt.endswith((".ckpt", ".pth", ".pt")):
        path = resolve_checkpoint(ckpt)
        logger.info("converting torch checkpoint %s", path)
        sd = read_torch_checkpoint(path)
        if torch_checkpoint_layers(sd) != L:
            raise ValueError(f"{path} has {torch_checkpoint_layers(sd)} layers, the config {L}")
        params = to_device(attach_bounds(convert_torch_state_dict(sd, L)), device,
                           cfg.model.compute_dtype)
    elif is_train_state_dir(ckpt):
        logger.info("loading the parameters of train state %s", ckpt)
        params = to_device(attach_bounds(load_train_state_params(ckpt)), device,
                           cfg.model.compute_dtype)
    elif Path(ckpt).is_dir():
        raise NotImplementedError(
            f"checkpoint {ckpt!r} is not a train state of the port; rap_tpu's orbax "
            "directories need orbax and jax, which the port does not use: export the "
            "parameters with rap_tpu's save_params_npz and pass the .npz")
    else:
        raise FileNotFoundError(f"checkpoint {ckpt!r} not found")
    if len(params["layers"]) != L:
        raise ValueError(f"{ckpt} has {len(params['layers'])} layers, the config {L}")
    return params


def make_generate_fn(cfg: Config, return_features: bool = False,
                     return_trajectory: bool = True):
    """(params, batch, generator=None, x_1=None) -> (sample output, R, t):
    one generation and its per-part poses."""

    def generate(params, batch, generator=None, x_1=None):
        out = sample(params, cfg.pipeline, batch, generator=generator, x_1=x_1,
                     return_trajectory=return_trajectory,
                     return_transformer_features=return_features)
        R, t = predict_poses(batch, out["points"])
        return out, R, t

    return generate


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_eval(cfg: Config, params=None, device="cuda", record: dict | None = None) -> dict:
    """Evaluate every configured dataset; returns {dataset: {metric: mean}}
    with an 'overall' entry, prints the tables. ``record``, if given,
    receives the timings (generation ms per batch and per generation,
    loader wait ms per batch, pairs) and each batch's generations as
    ``outputs``: [(names, [(points, R, t) per generation])] (this rank's
    batches in a world of several)."""
    device = resolve_device(device)
    with process_group(device) as (rank, world_size):
        return _eval(cfg, params, device, record, rank, world_size)


def _eval(cfg: Config, params, device, record, rank: int, world_size: int) -> dict:
    if params is None:
        params = load_params(cfg, device)
    n_params = sum(v.numel() for v in _leaves(params))
    logger.info("model %s: %.1fM params", cfg.model_name, n_params / 1e6)
    evaluator = Evaluator(cfg.eval)
    meter = MetricsMeter()
    steps_saved = cfg.eval.save_results and cfg.eval.save_merged_pointcloud_steps
    # trajectories only where something consumes them (rap_tpu's rule)
    need_traj = steps_saved or cfg.visualize or cfg.eval.use_average_rigidity_rmse
    generate = make_generate_fn(cfg, return_features=cfg.visualize,
                                return_trajectory=need_traj)
    visualizer = None
    if cfg.visualize:
        from ..eval.visualizer import FlowVisualization

        visualizer = FlowVisualization(cfg.visualizer)
    rec = record if record is not None else {}
    rec.update(batch_gen_ms=[], gen_ms=[], load_ms=[], post_ms=[], pairs=0, outputs=[])

    for ds_cfg in cfg.data.datasets:
        ds = PointCloudDataset(ds_cfg)
        loader = BatchLoader([ds], LoaderConfig(
            max_points_per_batch=cfg.data.max_points_per_batch,
            prefetch=cfg.data.num_prefetch, process_index=rank, process_count=world_size,
            shard_mode="stride"), device=device)
        batches = loader.epoch(0)
        b_idx = rank  # the batch's index in the plan: this rank takes every world_size-th
        while True:
            t_load0 = time.perf_counter()
            item = next(batches, None)
            if item is None:
                break
            batch, names, ds_name = item
            rec["load_ms"].append((time.perf_counter() - t_load0) * 1e3)
            gen_results, trajs, gens = [], [], []
            t_batch = t_post = 0.0
            for g in range(cfg.pipeline.n_generations):
                gen = seeded_generator(device, cfg.trainer.seed, b_idx, g)
                _sync(device)
                t_gen0 = time.perf_counter()
                out, R, t = generate(params, batch, generator=gen)
                _sync(device)
                t_post0 = time.perf_counter()
                dt = t_post0 - t_gen0
                rec["gen_ms"].append(dt * 1e3)
                t_batch += dt
                md = evaluator.compute_metrics(batch, out["points"], R, t)
                gen_results.append(md)
                if "end_point_trajectory" in out:
                    trajs.append(out["end_point_trajectory"])
                gens.append((out["points"], R, t))
                if cfg.eval.save_results:
                    host = lambda x: x.detach().cpu().numpy()  # noqa: E731
                    evaluator.save_sample_results(
                        batch, host(out["points"]), host(R), host(t),
                        {k: host(v) for k, v in md.items()}, sample_names=names,
                        dataset_name=ds_name, generation_idx=g,
                        trajectory=(host(out["end_point_trajectory"])
                                    if steps_saved and "end_point_trajectory" in out else None),
                        midpoint_trajectory=(host(out["trajectory"])
                                             if steps_saved and "trajectory" in out else None))
                _sync(device)
                t_post += time.perf_counter() - t_post0
            rec["batch_gen_ms"].append(t_batch * 1e3)
            rec["pairs"] += int(batch.sample_valid.sum())
            rec["outputs"].append((names, gens))
            t_post0 = time.perf_counter()
            agg = evaluator.aggregate_generations(batch, gen_results, trajs)
            if visualizer is not None:
                visualizer.on_batch_end(
                    batch, [out["points"]],
                    [out["end_point_trajectory"]] if "end_point_trajectory" in out else None,
                    midpoint_trajectories=[out["trajectory"]] if "trajectory" in out else None,
                    transformer_features=out.get("transformer_features"),
                    metrics=agg["avg"], sample_names=names, dataset_name=ds_name,
                    batch_idx=b_idx)
            valid = batch.sample_valid.cpu().numpy()
            nparts = batch.part_valid.reshape(batch.S, -1).sum(1).cpu().numpy()
            meter.add_metrics(ds_name, agg["avg"], valid, nparts)
            for section in (f"best_of_{cfg.pipeline.n_generations}", "rigidity_selected",
                            "overlap_ratio_selected"):
                if section in agg:
                    meter.add_metrics(ds_name, {f"{section}/{k}": v
                                                for k, v in agg[section].items()}, valid)
            rec["post_ms"].append((t_post + time.perf_counter() - t_post0) * 1e3)
            b_idx += world_size
        logger.info("%s padding: %s", ds_cfg.dataset_name, loader.padding_stats.summary())
        ds.close()

    meter.reduce_across_hosts([d.dataset_name for d in cfg.data.datasets])
    results = meter.compute_average()
    sections: dict[str, dict[str, dict[str, float]]] = {"average": {}}
    for ds_name, md in results.items():
        for k, v in md.items():
            sec, _, metric = k.partition("/")
            if not metric:
                sec, metric = "average", k
            sections.setdefault(sec, {}).setdefault(ds_name, {})[metric] = v
    if rank == 0:
        print_eval_table(sections, meter.get_sample_counts(), meter.get_part_count_ranges())
    if rec["gen_ms"]:
        logger.info("inference time/batch: %.3fs ± %.3fs | time/generation: %.3fs ± %.3fs",
                    np.mean(rec["batch_gen_ms"]) / 1e3, np.std(rec["batch_gen_ms"]) / 1e3,
                    np.mean(rec["gen_ms"]) / 1e3, np.std(rec["gen_ms"]) / 1e3)
    rec["sections"] = sections
    return results


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def main(argv=None, record: dict | None = None) -> dict:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="configs/rap_inference.yaml")
    ap.add_argument("-o", "--override", action="append", default=[], help="key.sub=value")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    ap.add_argument("--profile-dir", default="",
                    help="write a torch.profiler trace (Chrome format) to this dir")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args.config, args.override)
    if not cfg.data.datasets:
        ap.error("no datasets configured (set data.datasets)")
    if not args.profile_dir:
        return run_eval(cfg, device=device, record=record)
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if device.type == "cuda" else [])
    with profile(activities=activities) as prof:
        results = run_eval(cfg, device=device, record=record)
    out = Path(args.profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))
    logger.info("profiler trace written to %s", out / "trace.json")
    return results


if __name__ == "__main__":
    main()
