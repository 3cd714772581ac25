"""Reflow distillation: straighten a trained flow so 1-4 Euler steps match it
(counterpart of scripts/reflow_distill.py; the rectified-flow "reflow"
recipe of Liu et al. 2022).

    python -m rap_tpu_torch.apps.reflow_distill --teacher demo_data/ckpts/reflow_student.npz \\
        --data-root demo_run/data --out reflow_run --steps 2000 [--export-npz student.npz]

1. couples: the ``--teacher-steps`` rigidity-forced teacher ODE from noise
   x_1 over the train split (``--couple-epochs`` shuffled epochs, at most
   ``--max-couples`` batches); each batch's x_1 is drawn from its own
   ``torch.Generator`` (seeded from the round's seed, the epoch and the
   batch index). A couple is the batch with ``points_gt`` := the teacher's
   end point, and x_1; couples live on the host (pinned memory on the
   card), each copied back while the next batch samples.
2. retrain: the same weights fine-tuned on the straight bridges of the
   couples (uniform t, velocity MSE: ``train.step.make_train_step`` with
   ``x_1=``, rap_tpu's ``with_noise``), Muon at ``--lr``, clip 0.5, remat;
   the next few couples are uploaded ahead of the step on a side stream.
   ``--rounds`` > 1 regenerates the couples from the current student
   (2-rectified, 3-rectified flow); ``--final-t-scheme`` (e.g. ``euler2``)
   fine-tunes ``--final-steps`` more on the last couples with t on the
   few-step query grid. The student is saved as a train state under
   ``<out>/ckpts/final`` and, with ``--export-npz``, in rap_tpu's .npz
   format.
3. evaluation: student and teacher over the step counts of
   ``--eval-steps-sweep`` (a token may carry a schedule, ``4:power:0.5``)
   on ``--eval-splits``, and the trajectory linearity of one val batch at
   10 steps; ``<out>/summary.json`` is rewritten after every evaluation.

``--teacher`` and ``--student`` take a train-state directory of the port,
an ``.npz`` (``weights.load_params_npz``) or a torch ``.ckpt``/``.pth``/``.pt``
(``train.checkpoint``). The student is a copy: its optimizer updates never
touch the teacher's tensors (rap_tpu's donated state once deleted them).
Runs on the card (``--device cuda``, the default) unless the CPU is asked for.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import sys
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch

from .. import telemetry
from .._device import resolve_device
from ..core.batch import TENSOR_FIELDS, PartBatch

logger = logging.getLogger("rap_tpu_torch.reflow_distill")

UPLOAD_AHEAD = 3  # couples on the device ahead of the retrain step


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--teacher", required=True,
                    help="train-state dir, .npz or torch .ckpt/.pth/.pt")
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--out", default="reflow_run")
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--batch-tokens", type=int, default=32_768)
    ap.add_argument("--teacher-steps", type=int, default=10)
    ap.add_argument("--couple-epochs", type=int, default=2,
                    help="augmentation epochs of the train split turned into couples")
    ap.add_argument("--max-couples", type=int, default=2000,
                    help="cap on stored couple batches (host RAM)")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--rounds", type=int, default=1,
                    help="reflow rounds: each regenerates couples from the current student")
    ap.add_argument("--final-t-scheme", default="",
                    help="optional final fine-tune t scheme on the last round's couples, "
                         "e.g. 'euler2' or 'euler1'")
    ap.add_argument("--final-steps", type=int, default=1000,
                    help="steps of the --final-t-scheme stage")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--yaw-aug", action="store_true")
    ap.add_argument("--features", default="geometric", choices=["geometric", "zero", "spinnet"])
    ap.add_argument("--eval-steps-sweep", default="1,2,4,10",
                    help="comma list of step counts; a token may carry a schedule, "
                         "e.g. 4:power:0.5")
    ap.add_argument("--eval-splits", default="val")
    ap.add_argument("--eval-limit", type=int, default=0,
                    help="cap val-split evals to N strided scenes (0 = all)")
    ap.add_argument("--student", default="",
                    help="eval only: an already distilled student (no couples, no training)")
    ap.add_argument("--export-npz", default="",
                    help="also export the student in rap_tpu's .npz format (bf16)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    return ap


def load_model(spec: str, model, device) -> dict:
    """Serving parameters on ``device`` from a train-state directory, an
    .npz or a torch checkpoint (``apps.sample.load_params``)."""
    from ..config import Config
    from .sample import load_params

    return load_params(Config(model=model, checkpoint=str(spec)), device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def make_couple(params, pipe, batch: PartBatch, x_1: torch.Tensor) -> PartBatch:
    """The batch with ``points_gt`` := the teacher's end point from ``x_1``."""
    from ..registration import sample

    o = sample(params, pipe, batch, x_1=x_1, return_trajectory=False)
    return dataclasses.replace(batch, points_gt=o["points"])


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """An asynchronous copy to (pinned, on the card) host memory."""
    if t.device.type != "cuda":
        return t.clone()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


def _batch_map(batch: PartBatch, fn) -> PartBatch:
    return dataclasses.replace(batch, **{f: fn(getattr(batch, f)) for f in TENSOR_FIELDS
                                         if getattr(batch, f) is not None})


def generate_couples(params, pipe, train_ds, *, batch_tokens: int, epochs: int,
                     max_couples: int, seed: int, device, record: dict | None = None):
    """[(couple batch, x_1)] on the host over ``epochs`` shuffled epochs of
    ``train_ds``; each batch's copy to the host overlaps the next batch's
    sampling (it is waited for one batch behind)."""
    from ..data import BatchLoader, LoaderConfig
    from ..registration import seeded_generator

    device = torch.device(device)
    loader = BatchLoader([train_ds], LoaderConfig(max_points_per_batch=batch_tokens,
                                                  shuffle=True, prefetch=2, seed=seed),
                         device=device)
    couples, pending = [], None
    ms = [] if record is None else record.setdefault("couple_ms", [])
    t0 = time.time()
    done = False
    for epoch in range(epochs):
        if done:
            break
        with contextlib.closing(loader.epoch(epoch)) as batches:
            for b_idx, (batch, _names, _) in enumerate(batches):
                t1 = time.perf_counter()
                gen = seeded_generator(device, seed, epoch, b_idx)
                x_1 = torch.randn(tuple(batch.points.shape), generator=gen, device=device)
                couple = make_couple(params, pipe, batch, x_1)
                host = (_batch_map(couple, _to_host), _to_host(x_1))
                done_ev = None
                if device.type == "cuda":
                    done_ev = torch.cuda.Event()
                    done_ev.record()
                if pending is not None:
                    if pending[1] is not None:
                        pending[1].synchronize()
                    couples.append(pending[0])
                pending = (host, done_ev)
                if record is not None:
                    _sync(device)
                    ms.append((time.perf_counter() - t1) * 1e3)
                if len(couples) + 1 >= max_couples:
                    done = True
                    break
    if pending is not None:
        if pending[1] is not None:
            pending[1].synchronize()
        couples.append(pending[0])
    logger.info("generated %d couple batches in %.0fs", len(couples), time.time() - t0)
    if not couples:
        raise RuntimeError("no couples generated — empty train split?")
    return couples


def retrain(params, couples, steps: int, pipe, opt_cfg, *, seed: int, device,
            steps_per_epoch: int = 1, tracker=None, t_draws=None,
            record: dict | None = None):
    """Fine-tune a copy of ``params`` on the straight bridges of
    ``couples`` for ``steps`` steps, the couples in a permutation from
    ``seed`` per pass; returns the final train state. ``t_draws``, if
    given, is a callable of the step index giving its timesteps (a test
    feeds rap_tpu's draws), else the state's generator draws them."""
    from ..train.step import TrainState, make_train_step

    device = torch.device(device)
    # TrainState.create copies every tensor: the caller's params (the
    # teacher) stay untouched by the student's updates
    state = TrainState.create(params, opt_cfg, seed=seed, device=device)
    step_fn = make_train_step(pipe, opt_cfg, remat=True, device=device,
                              steps_per_epoch=steps_per_epoch)
    order = _passes(np.random.default_rng(seed), len(couples))
    side = torch.cuda.Stream(device) if device.type == "cuda" else None

    def upload(i):
        b, x1 = couples[i]
        if side is None:
            return _batch_map(b, lambda t: t.to(device)), x1.to(device), None
        with torch.cuda.stream(side):
            item = (_batch_map(b, lambda t: t.to(device, non_blocking=True)),
                    x1.to(device, non_blocking=True))
            ev = torch.cuda.Event()
            ev.record(side)
        return item[0], item[1], ev

    ahead = deque(upload(next(order)) for _ in range(min(UPLOAD_AHEAD, steps)))
    ms = [] if record is None else record.setdefault("retrain_ms", [])
    t0 = time.time()
    for n in range(steps):
        b, x1, ev = ahead.popleft()
        if ev is not None:  # the step's stream waits for the upload, and owns the tensors
            cur = torch.cuda.current_stream(device)
            cur.wait_event(ev)
            for t in [x1] + [getattr(b, f) for f in TENSOR_FIELDS if getattr(b, f) is not None]:
                t.record_stream(cur)
        if n + len(ahead) + 1 < steps:
            ahead.append(upload(next(order)))
        t1 = time.perf_counter()
        state, metrics = step_fn(state, b, x_1=x1,
                                 t=None if t_draws is None else t_draws(n).to(device))
        if record is not None:
            record.setdefault("retrain_losses", []).append(float(metrics["loss"]))
            ms.append((time.perf_counter() - t1) * 1e3)
        if tracker is not None and (n + 1) % 100 == 0:
            tracker.log(n + 1, metrics)
    _sync(device)
    logger.info("distilled %d steps in %.0fs", steps, time.time() - t0)
    return state


def _passes(rng: np.random.Generator, n: int):
    """Indices 0..n-1, a new permutation each pass, without end."""
    while True:
        yield from (int(i) for i in rng.permutation(n))


def parse_token(tok: str) -> tuple[int, str]:
    parts = tok.split(":", 1)
    return int(parts[0]), (parts[1] if len(parts) > 1 else "uniform")


@torch.no_grad()
def linearity(params, pipe, batch: PartBatch, device) -> float:
    """Mean straightness of the 10-step trajectories of ``batch`` (noise
    from seed 42): straight-line over path length per valid point."""
    from ..core.sampler import compute_linearity
    from ..registration import sample

    gen = torch.Generator(device=device).manual_seed(42)
    o = sample(params, pipe, batch, generator=gen, return_trajectory=True, num_steps=10)
    lin = compute_linearity(o["trajectory"], batch.point_mask)
    return float(lin.sum() / batch.point_mask.sum().clamp_min(1))


def main(argv=None, record: dict | None = None) -> dict:
    """The run above; returns the summary. ``record``, if given, receives
    the couple ms per batch, the retrain ms and losses per step, the launch
    counts of a couple batch and of a retrain step, the evaluations' ms and
    launches, and the student's and teacher's serving parameters."""
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    from ..data import BatchLoader, DatasetConfig, LoaderConfig, PointCloudDataset
    from ..eval.runner import evaluate_split
    from ..models.config import DiTConfig
    from ..registration import RPFConfig
    from ..train.checkpoint import save_checkpoint
    from ..train.optim import OptimizerConfig
    from ..train.step import TrainState
    from ..train.tracking import ExperimentTracker
    from .train import serving_params

    rec = record if record is not None else {}
    out = Path(args.out)
    model = DiTConfig(num_layers=args.layers)
    teacher_pipe = RPFConfig(model=model, inference_sampling_steps=args.teacher_steps,
                             rigidity_forcing=True)
    # uniform t straightens the whole path; the couple encodes the pose, so
    # the pose loss stays off
    reflow_pipe = dataclasses.replace(teacher_pipe, timestep_sampling="uniform")
    ds_kw = dict(data_path=args.data_root, dataset_name="synth",
                 load_features=args.features != "zero", yaw_augmentation=args.yaw_aug,
                 limit_val_samples=args.eval_limit)
    train_ds = PointCloudDataset(DatasetConfig(split="train", **ds_kw))
    val_ds = PointCloudDataset(DatasetConfig(split="val", **ds_kw))
    logger.info("train %d samples, val %d", len(train_ds), len(val_ds))

    opt_cfg = OptimizerConfig(name="muon", lr=args.lr, grad_clip=0.5)
    steps_per_epoch = max(len(train_ds) // 8, 1)
    teacher = load_model(args.teacher, model, device)
    logger.info("teacher loaded from %s", args.teacher)
    summary: dict = {"config": vars(args).copy()}

    def counted(fn, key):
        """fn() with the launches it made recorded under ``key``."""
        with telemetry.counted("launch.") as launches:
            res = fn()
        _sync(device)
        rec.setdefault(key, []).append(launches)
        return res

    if args.student:
        student = load_model(args.student, model, device)
    else:
        student, couples = teacher, None
        for rnd in range(args.rounds):
            couples = counted(lambda: generate_couples(
                student, teacher_pipe, train_ds, batch_tokens=args.batch_tokens,
                epochs=args.couple_epochs, max_couples=args.max_couples, seed=7 + 1000 * rnd,
                device=device, record=record), "couple_launches")
            tracker = ExperimentTracker(out / "ckpts" / f"round{rnd}", config=None,
                                        use_wandb=False, snapshot=False)
            state = counted(lambda: retrain(
                student, couples, args.steps, reflow_pipe, opt_cfg, seed=3 + rnd,
                device=device, steps_per_epoch=steps_per_epoch, tracker=tracker,
                record=record), "retrain_launches")
            tracker.finish()
            student = serving_params(state.params, model)
        if args.final_t_scheme:
            # the same couples, t on the deployed few-step Euler grid
            final_pipe = dataclasses.replace(reflow_pipe, timestep_sampling=args.final_t_scheme)
            tag = f"final_{args.final_t_scheme}"
            tracker = ExperimentTracker(out / "ckpts" / tag, config=None, use_wandb=False,
                                        snapshot=False)
            state = retrain(student, couples, args.final_steps, final_pipe, opt_cfg, seed=31,
                            device=device, steps_per_epoch=steps_per_epoch, tracker=tracker)
            tracker.finish()
            student = serving_params(state.params, model)
        save_checkpoint(out / "ckpts" / "final", TrainState.create(state.params, opt_cfg, seed=5,
                                                                   device=device),
                        {"steps": args.steps, "rounds": args.rounds,
                         "final_t_scheme": args.final_t_scheme})
    rec["student"], rec["teacher"] = student, teacher

    if args.export_npz:
        from ..train.checkpoint import save_params_npz

        save_params_npz(args.export_npz, student)
        logger.info("exported student npz to %s", args.export_npz)

    # student first: a sweep cut short keeps the few-step numbers, and the
    # summary is rewritten after every evaluation
    sweep = [parse_token(s) for s in args.eval_steps_sweep.split(",")]
    eval_pipe = RPFConfig(model=model, rigidity_forcing=True)
    out.mkdir(parents=True, exist_ok=True)
    rec.setdefault("eval_ms", {})
    for split in args.eval_splits.split(","):
        ds = train_ds if split == "train" else val_ds
        for who, params in (("student", student), ("teacher", teacher)):
            # the teacher's 10-step protocol number is the bar: first
            order = sweep if who == "student" else list(reversed(sweep))
            for k, sched in order:
                tag = f"{split}/{who}@{k}steps" + (f":{sched}" if sched != "uniform" else "")
                t1 = time.perf_counter()
                summary[tag] = counted(lambda: evaluate_split(
                    params, eval_pipe, ds, batch_tokens=args.batch_tokens, num_steps=k,
                    tag=tag, schedule=sched, device=device), "eval_launches")
                rec["eval_ms"][tag] = (time.perf_counter() - t1) * 1e3
                (out / "summary.json").write_text(json.dumps(summary, indent=2))

    # linearity probe: how straight did the paths get?
    probe = BatchLoader([val_ds], LoaderConfig(max_points_per_batch=args.batch_tokens),
                        device=device)
    batch = next(iter(probe.epoch(0)))[0]
    for who, params in (("teacher", teacher), ("student", student)):
        summary[f"linearity/{who}"] = linearity(params, eval_pipe, batch, device)
        logger.info("linearity %s: %.4f", who, summary[f"linearity/{who}"])
    (out / "summary.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
