"""The shared evaluation loop: ODE sampling, pose fit and the metric suite
over one dataset (counterpart of rap_tpu/eval/runner.py:20-100).

Per batch of the loader (no shuffle, ``batch_tokens`` points a batch):
``n_generations`` generations through ``registration.sample`` and
``predict_poses``, optionally refined by trimmed ICP onto the anchor part
(``icp_refine``: 50 iterations, ``icp_refine_trim``, ``icp_refine_restarts``
yaw restarts) before any metric, the evaluator's metrics (``use_icp``: the
ICP delta as the error), then, with more than one generation, the average,
best-of-N and rigidity-selected sections. The noise of generation g of
batch b comes from a generator seeded from (``seed`` + b, g) on the
batch's device, or from ``noise(b, g, shape)`` where given (rap_tpu draws
it from ``fold_in(key(seed + b), g)``, which the port cannot reproduce).
"""

from __future__ import annotations

from typing import Callable

import torch

from .._device import resolve_device
from ..data import BatchLoader, LoaderConfig
from ..registration import RPFConfig, predict_poses, refine_poses_icp, sample, seeded_generator
from .evaluator import EvalConfig, Evaluator
from .meter import MetricsMeter, print_eval_table


def evaluate_split(
    params,
    pipe: RPFConfig,
    ds,
    *,
    batch_tokens: int = 32_768,
    num_steps: int | None = None,
    schedule: str | None = None,
    seed: int = 100,
    tag: str = "val",
    dataset_key: str = "synth",
    n_generations: int = 1,
    use_icp: bool = False,
    icp_refine: bool = False,
    icp_refine_trim: float = 0.7,
    icp_refine_restarts: int = 1,
    device="cuda",
    noise: Callable[[int, int, tuple], torch.Tensor] | None = None,
) -> dict[str, float]:
    """The per-dataset averaged metrics ({metric: float}) of ``ds`` under
    the protocol above; with ``n_generations`` > 1 also keyed
    ``best_of_<N>/<metric>`` and ``rigidity_selected/<metric>``."""
    device = resolve_device(device)
    evaluator = Evaluator(EvalConfig(use_icp=use_icp))
    meter = MetricsMeter()
    loader = BatchLoader([ds], LoaderConfig(max_points_per_batch=batch_tokens), device=device)
    for b_idx, (batch, _names, ds_name) in enumerate(loader.epoch(0)):
        gen_results = []
        for g in range(n_generations):
            if noise is not None:
                kw = {"x_1": noise(b_idx, g, tuple(batch.points.shape)).to(batch.device)}
            else:
                kw = {"generator": seeded_generator(batch.device, seed + b_idx, g)}
            o = sample(params, pipe, batch, return_trajectory=False, num_steps=num_steps,
                       schedule=schedule, **kw)
            R, t = predict_poses(batch, o["points"])
            if icp_refine:
                R, t = refine_poses_icp(batch, R, t, iters=50, trim_fraction=icp_refine_trim,
                                        yaw_restarts=icp_refine_restarts)
            gen_results.append(evaluator.compute_metrics(batch, o["points"], R, t))
        valid = batch.sample_valid.cpu().numpy()
        nparts = batch.part_valid.reshape(batch.S, -1).sum(1).cpu().numpy()
        if n_generations == 1:
            meter.add_metrics(ds_name, {k: v.detach().cpu().numpy()
                                        for k, v in gen_results[0].items()}, valid, nparts)
        else:
            agg = evaluator.aggregate_generations(batch, gen_results)
            meter.add_metrics(ds_name, agg["avg"], valid, nparts)
            for section in (f"best_of_{n_generations}", "rigidity_selected"):
                if section in agg:
                    meter.add_metrics(ds_name, {f"{section}/{k}": v
                                                for k, v in agg[section].items()}, valid)
    results = meter.compute_average()
    print_eval_table({tag: results})
    return {k: float(v) for k, v in results.get(dataset_key, {}).items()}
