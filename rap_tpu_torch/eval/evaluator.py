"""Evaluator: the metric dict of one generation and the aggregation over
generations (counterpart of rap_tpu/eval/evaluator.py).

``compute_metrics`` gives rap_tpu's metric names and units at the default
``EvalConfig`` (evaluator.py:63-114): chamfer, anchor-relative rotation and
translation errors, the four pose recalls, the chamfer recall and the
rigidity RMSE, each (S,). ``aggregate_generations`` (:163) averages them
over generations and, for several, takes best-of-N and the generation
selected by the smallest rigidity RMSE, averaged over every trajectory step
with ``use_average_rigidity_rmse`` (``trajectory_rigidity_rmse`` :367).

Not ported (each option raises ``NotImplementedError``, ROADMAP A2): the
correspondence RMSE (``rmse_eval_on``), overlap ratios (``overlap_eval_on``),
part accuracy (``part_acc_eval_on``), the ECDF (``ecdf_eval_on``), ICP
refinement (``use_icp``) and the per-sample artifacts (``save_results``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..core.batch import PartBatch
from ..core.procrustes import fit_transformations
from . import metrics as M

# keys where bigger is better (best-of-N takes the max), evaluator.py:36
_MAX_KEYS = ("acc", "recall", "success", "ecdf", "overlap_ratio", "correspondence_ratio")

_UNPORTED = ("rmse_eval_on", "overlap_eval_on", "ecdf_eval_on", "part_acc_eval_on",
             "use_icp", "save_results")


def _is_max_key(key: str) -> bool:
    return any(k in key for k in _MAX_KEYS)


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """rap_tpu's EvalConfig (evaluator.py:43-60): the fields a shipped config
    sets or that select an unported metric (which raises)."""

    rmse_eval_on: bool = False
    overlap_eval_on: bool = False
    ecdf_eval_on: bool = False
    part_acc_eval_on: bool = False
    use_icp: bool = False
    use_average_rigidity_rmse: bool = True
    save_results: bool = False
    save_json: bool = True
    save_merged_pointcloud_steps: bool = False
    output_dir: str = "results"


class Evaluator:
    def __init__(self, cfg: EvalConfig = EvalConfig()):
        on = [name for name in _UNPORTED if getattr(cfg, name)]
        if on:
            raise NotImplementedError(
                f"eval options {on} are not ported yet (ROADMAP A2: the eval "
                "flags and save_sample_results)")
        self.cfg = cfg

    def compute_metrics(self, batch: PartBatch, pred: torch.Tensor,
                        rotations_pred: torch.Tensor | None = None,
                        translations_pred: torch.Tensor | None = None,
                        ) -> dict[str, torch.Tensor]:
        """The metric dict of one generation, each (S,) on the batch's device."""
        cd = M.chamfer_rmse(batch, pred)
        cd_m = cd * batch.scale
        out = {"chamfer_l2 (m)": cd_m, "object_chamfer": cd}
        if rotations_pred is not None:
            rot_err, trans_err = M.transform_errors(batch, rotations_pred,
                                                    translations_pred, anchor_relative=True)
            out.update({
                "average_rotation_error (deg)": rot_err,
                "average_translation_error (m)": trans_err,
                "recall_at_10deg_0.2m (nss)": M.combined_recall(rot_err, trans_err, 10, 0.2),
                "recall_at_15deg_0.3m (indoor_bufferx)": M.combined_recall(
                    rot_err, trans_err, 15, 0.3),
                "recall_at_5deg_2m (outdoor_bufferx)": M.combined_recall(
                    rot_err, trans_err, 5, 2.0),
                "recall_at_10deg_5m (map)": M.combined_recall(rot_err, trans_err, 10, 5.0),
                "recall_at_chamfer_0.2m": M.recall_at(cd_m, 0.2),
                "rigidity_rmse (m)": M.rigidity_rmse(batch, pred, rotations_pred,
                                                     translations_pred),
            })
        return out

    def aggregate_generations(self, batch: PartBatch,
                              gen_results: list[dict[str, torch.Tensor]],
                              gen_trajectories: list[torch.Tensor] | None = None,
                              ) -> dict[str, Any]:
        """avg, best_of_<n> and rigidity_selected (with its generation index)
        over the generations' (S,) metrics, as numpy (evaluator.py:163-221)."""
        n = len(gen_results)
        keys = list(gen_results[0])
        stacked = {k: np.stack([np.asarray(r[k].detach().cpu()) for r in gen_results])
                   for k in keys}  # (n, S)
        agg: dict[str, Any] = {"avg": {k: stacked[k].mean(0) for k in keys}}
        if n > 1:
            agg[f"best_of_{n}"] = {
                k: stacked[k].max(0) if _is_max_key(k) else stacked[k].min(0) for k in keys}
            if "rigidity_rmse (m)" in stacked:
                if self.cfg.use_average_rigidity_rmse and gen_trajectories:
                    rig = np.stack([
                        trajectory_rigidity_rmse(batch, tr).mean(0).cpu().numpy()
                        for tr in gen_trajectories])
                else:
                    rig = stacked["rigidity_rmse (m)"]
                best = np.argmin(rig, axis=0)
                cols = np.arange(len(best))
                agg["rigidity_selected"] = {k: stacked[k][best, cols] for k in keys}
                agg["rigidity_selected_gen"] = best
        return agg


def trajectory_rigidity_rmse(batch: PartBatch, trajectory: torch.Tensor) -> torch.Tensor:
    """Rigidity RMSE at every trajectory step (steps, G, N, 3) -> (steps, S)."""
    out = []
    for step_pts in trajectory:
        R, t = fit_transformations(batch.points, step_pts, batch.point_mask)
        out.append(M.rigidity_rmse(batch, step_pts, R, t))
    return torch.stack(out)
