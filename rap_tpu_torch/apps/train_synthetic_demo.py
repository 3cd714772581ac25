"""Train a registration model from scratch on procedural scenes, then
evaluate it (counterpart of scripts/train_synthetic_demo.py).

    python -m rap_tpu_torch.apps.train_synthetic_demo --steps 4000 --scenes 400 --out demo_run
    python -m rap_tpu_torch.apps.train_synthetic_demo --device cpu --layers 2 --steps 2 \\
        --scenes 6 --points-per-view 256 --out /tmp/run

1. data: ``data.synthetic_scenes.generate_dataset`` writes ``--scenes``
   scenes of ``--views`` views under ``<out>/data`` (or ``--data-root``)
   with geometric feature sidecars; ``--features spinnet`` overwrites them
   with MiniSpinNet descriptors computed on ``--device`` (each view its own
   context, every point a keypoint); ``generation_params.json`` is written
   last, and a dataset with splits but without it gets its sidecars
   finished. An existing dataset is reused.
2. training: a DiT of ``--layers`` layers (D = 512, H = 8, bf16) from
   random weights, Muon (grad clip 0.5), ``train.step.make_train_step``
   with remat through the hand-written kernels, the loader shuffling
   ``--batch-tokens`` points a batch; metrics to ``<out>/ckpts/metrics.jsonl``
   every 100 steps; the train state (the port's format,
   ``train/checkpoint.py``) to ``<out>/ckpts/final`` (and ``last`` every
   ``--save-every`` steps; ``--resume`` continues from it).
3. evaluation: ``eval.runner.evaluate_split`` (the ODE sampler, the pose
   fit and the metric suite) on each of ``--eval-splits``, optionally the
   yaw-rotated protocol, into ``<out>/summary.json``.

The options are rap_tpu's, plus ``--device`` (the card by default).
rap_tpu writes orbax checkpoints; the port its own train-state directories
(``--eval-only`` reads one).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import telemetry
from .._device import resolve_device

logger = logging.getLogger("rap_tpu_torch.train_synthetic_demo")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--scenes", type=int, default=400)
    ap.add_argument("--points-per-view", type=int, default=2048)
    ap.add_argument("--views", type=int, default=2)
    ap.add_argument("--overlap", default="medium", choices=["medium", "high"],
                    help="view overlap regime: 'high' crops ~90%% overlapping views")
    ap.add_argument("--out", default="demo_run")
    ap.add_argument("--data-root", default="",
                    help="shared dataset dir (default <out>/data)")
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--lr-decay-steps", default="",
                    help="comma list of step milestones where the lr halves; empty = constant")
    ap.add_argument("--batch-tokens", type=int, default=32_768)
    ap.add_argument("--t-scheme", default="u_shaped",
                    choices=["u_shaped", "logit_normal", "mode", "uniform", "late_heavy"])
    ap.add_argument("--pose-loss-weight", type=float, default=0.0)
    ap.add_argument("--yaw-aug", action="store_true",
                    help="yaw-only rotations with 5 deg roll/pitch")
    ap.add_argument("--features", default="geometric", choices=["geometric", "zero", "spinnet"],
                    help="condition descriptors: geometric local features, or MiniSpinNet's")
    ap.add_argument("--spinnet-checkpoint", default="",
                    help="torch .pth for spinnet features (random weights if empty)")
    ap.add_argument("--spinnet-des-r", type=float, default=1.0,
                    help="descriptor radius in scene meters")
    ap.add_argument("--prefetch", type=int, default=4, help="loader prefetch depth")
    ap.add_argument("--save-every", type=int, default=0,
                    help="checkpoint every N steps (0 = only at the end)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from <out>/ckpts/last if present")
    ap.add_argument("--gen-only", action="store_true",
                    help="stop after the dataset is ready")
    ap.add_argument("--eval-only", default="", help="train-state dir to evaluate")
    ap.add_argument("--eval-splits", default="val",
                    help="comma-separated splits to evaluate (train,val)")
    ap.add_argument("--eval-rotated", action="store_true",
                    help="also evaluate val under train-style yaw rotations")
    ap.add_argument("--eval-rotated-decompose", action="store_true",
                    help="with --eval-rotated: also the global_only / parts_only protocols")
    ap.add_argument("--eval-steps", type=int, default=10, help="ODE steps at eval")
    ap.add_argument("--eval-limit", type=int, default=0,
                    help="cap val-split evals to N strided scenes (0 = all)")
    ap.add_argument("--eval-schedule", default="uniform",
                    help="ODE timestep grid at eval: uniform | cosine | power:<k>")
    ap.add_argument("--eval-generations", type=int, default=1,
                    help=">1: best-of-N and rigidity-selected sections")
    ap.add_argument("--eval-icp", action="store_true",
                    help="measure errors through the ICP protocol (use_icp)")
    ap.add_argument("--eval-icp-refine", action="store_true",
                    help="refine predicted poses by trimmed ICP onto the anchor before scoring")
    ap.add_argument("--eval-icp-trim", type=float, default=0.7)
    ap.add_argument("--eval-icp-restarts", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    return ap


def prepare_data(args, data_root: Path, device) -> None:
    """Generate the dataset (and its feature sidecars) unless it exists."""
    from ..data.synthetic_scenes import generate_dataset

    gen_params = {"scenes": args.scenes, "points_per_view": args.points_per_view,
                  "overlap": args.overlap, "views": args.views, "features": args.features}
    params_file = data_root / "generation_params.json"
    names = None
    if not (data_root / "data_split" / "train.txt").exists():
        logger.info("generating %d scenes ...", args.scenes)
        names = generate_dataset(
            data_root, n_scenes=args.scenes, n_views=args.views,
            max_points_per_view=args.points_per_view,
            keep_radius_frac=(0.9, 0.98) if args.overlap == "high" else (0.55, 0.8),
            features=args.features == "geometric")
    elif not params_file.exists():
        # scenes exist but the sidecar pass was cut: finish it
        names = []
        for split in ("train.txt", "val.txt"):
            f = data_root / "data_split" / split
            if f.exists():
                names += [ln.strip() for ln in f.read_text().splitlines() if ln.strip()]
        logger.warning("dataset at %s has splits but no generation_params.json — finishing "
                       "the %s feature sidecars for %d scenes", data_root, args.features,
                       len(names))
    if names is None:
        existing = json.loads(params_file.read_text()) if params_file.exists() else None
        if existing != gen_params:
            logger.warning("REUSING existing dataset at %s generated with %s — the requested "
                           "parameters %s are IGNORED (delete the dir to regenerate)",
                           data_root, existing, gen_params)
        else:
            logger.info("reusing existing dataset at %s", data_root)
        return
    if args.features == "spinnet":
        from ..spinnet import build_feature_extractor
        from ..utils import ply as plyio

        fx = build_feature_extractor(args.spinnet_checkpoint, device=device)
        t_fx = time.time()
        n_done = n_skip = 0
        for name in names:
            d = data_root / name
            for ply_path in sorted(d.glob("*.ply")):
                sidecar = d / f"features_{ply_path.stem}.npy"
                if sidecar.exists():  # resumable after a cut run
                    n_skip += 1
                    continue
                pts = plyio.read_ply(ply_path, read_faces=False)["points"]
                np.save(sidecar, fx(pts, pts, args.spinnet_des_r))
                n_done += 1
        logger.info("spinnet features: %d views (%d already present), %.0fs",
                    n_done, n_skip, time.time() - t_fx)
    params_file.write_text(json.dumps(gen_params))
    logger.info("wrote %d samples", len(names))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, record: dict | None = None) -> dict | None:
    """The run above; returns the summary (None with ``--gen-only``).
    ``record``, if given, receives per-step ms, losses and launch counts
    (each step then syncs with the host to read its loss), the last batch,
    the evaluation's ms and launches per split, and the final state."""
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    from ..apps.train import serving_params
    from ..data import BatchLoader, DatasetConfig, LoaderConfig, PointCloudDataset
    from ..eval.runner import evaluate_split
    from ..models.config import DiTConfig
    from ..models.dit import init_dit_params
    from ..registration import RPFConfig
    from ..train.checkpoint import resolve_checkpoint_dir, restore_checkpoint, save_checkpoint
    from ..train.optim import OptimizerConfig, tree_paths
    from ..train.step import TrainState, make_train_step
    from ..train.tracking import ExperimentTracker

    rec = record if record is not None else {}
    rec.update(step_ms=[], losses=[], step_launches=[], eval_ms={}, eval_launches={})
    out = Path(args.out)
    data_root = Path(args.data_root) if args.data_root else out / "data"
    t0 = time.perf_counter()
    prepare_data(args, data_root, device)
    rec["data_s"] = time.perf_counter() - t0
    if args.gen_only:
        logger.info("--gen-only: dataset ready, exiting")
        return None

    model = DiTConfig(num_layers=args.layers)   # 512 wide, 8 heads, bf16
    pipe = RPFConfig(model=model, inference_sampling_steps=args.eval_steps,
                     rigidity_forcing=True, timestep_sampling=args.t_scheme,
                     pose_loss_weight=args.pose_loss_weight)
    ds_kw = dict(data_path=str(data_root), dataset_name="synth",
                 load_features=args.features != "zero", yaw_augmentation=args.yaw_aug,
                 limit_val_samples=args.eval_limit)
    train_ds = PointCloudDataset(DatasetConfig(split="train", **ds_kw))
    val_ds = PointCloudDataset(DatasetConfig(split="val", **ds_kw))
    logger.info("train %d samples, val %d", len(train_ds), len(val_ds))
    if len(train_ds) == 0:
        raise RuntimeError(f"empty train split under {data_root} — generation produced too "
                           "few scenes (raise --scenes) or the dataset dir is corrupt")

    opt_cfg = OptimizerConfig(name="muon", lr=args.lr, grad_clip=0.5)
    steps_per_epoch = max(len(train_ds) // 8, 1)
    if args.lr_decay_steps:
        opt_cfg = dataclasses.replace(opt_cfg, lr_milestones=tuple(
            int(s) for s in args.lr_decay_steps.split(",")))
        steps_per_epoch = 1  # milestones are absolute steps
    params = init_dit_params(0, model, device=device, masters=True)
    state = TrainState.create(params, opt_cfg, seed=1, device=device)
    logger.info("model: %.1fM params",
                sum(v.numel() for _, v in tree_paths(state.params)) / 1e6)

    if not args.eval_only:
        total = 0
        last_dir = out / "ckpts" / "last"
        if args.resume and (resolve_checkpoint_dir(last_dir) / "rap_metadata.json").exists():
            state = restore_checkpoint(last_dir, state)
            total = int(state.step)
            logger.info("resumed at step %d", total)
        loader = BatchLoader([train_ds], LoaderConfig(
            max_points_per_batch=args.batch_tokens, shuffle=True, prefetch=args.prefetch),
            device=device)
        step_fn = make_train_step(pipe, opt_cfg, remat=True, device=device,
                                  steps_per_epoch=steps_per_epoch)
        tracker = ExperimentTracker(out / "ckpts", config=None, use_wandb=False,
                                    snapshot=False)
        epoch, done_at_start = 0, total
        t_start = time.time()
        while total < args.steps:
            with contextlib.closing(loader.epoch(epoch)) as batches:
                for batch, _names, _ in batches:
                    t1 = time.perf_counter()
                    with telemetry.counted("launch.") as launches:
                        state, metrics = step_fn(state, batch)
                    if record is not None:  # the loss read is the step's sync
                        rec["losses"].append(float(metrics["loss"]))
                        rec["step_ms"].append((time.perf_counter() - t1) * 1e3)
                        rec["step_launches"].append(launches)
                        rec["last_batch"] = batch
                    total += 1
                    if total % 100 == 0:
                        tracker.log(total, metrics)
                    if args.save_every and total % args.save_every == 0:
                        save_checkpoint(last_dir, state, {"steps": total})
                    if total >= args.steps:
                        break
            epoch += 1
        _sync(device)
        dt = time.time() - t_start
        logger.info("trained %d steps in %.0fs (%.2f steps/s)", total - done_at_start, dt,
                    (total - done_at_start) / max(dt, 1e-9))
        save_checkpoint(out / "ckpts" / "final", state, {"steps": total})
        tracker.finish()
    else:
        state = restore_checkpoint(Path(args.eval_only), state)
    rec["state"] = state
    serve = serving_params(state.params, model)

    def run_eval(ds, tag):
        t1 = time.perf_counter()
        with telemetry.counted("launch.") as launches:
            res = evaluate_split(
                serve, pipe, ds, batch_tokens=args.batch_tokens, num_steps=args.eval_steps,
                tag=tag, schedule=args.eval_schedule, n_generations=args.eval_generations,
                use_icp=args.eval_icp, icp_refine=args.eval_icp_refine,
                icp_refine_trim=args.eval_icp_trim,
                icp_refine_restarts=args.eval_icp_restarts, device=device)
        _sync(device)
        rec["eval_ms"][tag] = (time.perf_counter() - t1) * 1e3
        rec["eval_launches"][tag] = launches
        return res

    summary = {"steps": args.steps if not args.eval_only else "eval-only",
               "config": {k: v for k, v in vars(args).items() if k not in ("out", "eval_only")}}
    for split in args.eval_splits.split(","):
        summary[split] = run_eval(train_ds if split == "train" else val_ds, f"{split} scenes")
    if args.eval_rotated:
        rot_ds = PointCloudDataset(DatasetConfig(split="val", augment_eval=True, **ds_kw))
        summary["val_rotated"] = run_eval(rot_ds, "val scenes (rotated)")
        if args.eval_rotated_decompose:
            for mode in ("global_only", "parts_only"):
                mds = PointCloudDataset(DatasetConfig(split="val", augment_eval=True,
                                                      augment_eval_mode=mode, **ds_kw))
                summary[f"val_rotated_{mode}"] = run_eval(mds, f"val scenes (rotated:{mode})")
    out.mkdir(parents=True, exist_ok=True)
    (out / "summary.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
