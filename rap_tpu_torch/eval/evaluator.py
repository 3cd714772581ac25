"""Evaluator: the metric dict of one generation, the aggregation over
generations and the per-sample artifacts (counterpart of
rap_tpu/eval/evaluator.py).

``compute_metrics`` (:63-156) gives rap_tpu's metric names and units:
chamfer, anchor-relative rotation and translation errors (ICP-refined with
``use_icp``), the four pose recalls, the chamfer recall and the rigidity
RMSE; with ``rmse_eval_on`` the pairwise correspondence RMSE and its
recalls (NaN for samples that are not pairs, so the meter leaves them out),
with ``overlap_eval_on`` the overlap ratios, with ``part_acc_eval_on`` the
part accuracy, with ``ecdf_eval_on`` the batch's ECDF of the errors
broadcast to every sample; each (S,). ``aggregate_generations`` (:163)
averages them over generations and, for several, takes best-of-N, the
generation selected by the smallest rigidity RMSE (averaged over every
trajectory step with ``use_average_rigidity_rmse``,
``trajectory_rigidity_rmse`` :367) and the one with the largest overlap
ratio at 1%. ``save_sample_results`` (:211) writes each sample's metrics
JSON, pose and relative-to-ground-truth transforms, the global transform,
the merged and per-part prediction PLYs and the part-coloured trajectory
PCDs, in rap_tpu's tree and formats.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..core.batch import PartBatch
from ..core.procrustes import fit_transformations
from ..utils import ply as plyio
from ..utils.render import part_ids_to_colors
from . import metrics as M

# keys where bigger is better (best-of-N takes the max), evaluator.py:36
_MAX_KEYS = ("acc", "recall", "success", "ecdf", "overlap_ratio", "correspondence_ratio")


def _is_max_key(key: str) -> bool:
    return any(k in key for k in _MAX_KEYS)


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """rap_tpu's EvalConfig (evaluator.py:43-61)."""

    rmse_eval_on: bool = False            # pairwise correspondence RMSE metrics
    overlap_eval_on: bool = False         # overlap-ratio metrics
    ecdf_eval_on: bool = False            # ECDF of the rotation and translation errors
    part_acc_eval_on: bool = False        # Hungarian part accuracy
    part_acc_threshold: float = 0.01      # its chamfer threshold (scaled space)
    use_icp: bool = False                 # ICP-refined transform errors
    use_average_rigidity_rmse: bool = True
    save_results: bool = False
    save_json: bool = True
    save_pointcloud_parts: bool = False
    save_merged_pointcloud_steps: bool = False
    # point-cloud artifacts only for the first K valid samples of a batch (0:
    # every one); JSON and transforms are written for every sample
    max_artifact_samples_per_batch: int = 0
    output_dir: str = "results"
    folder_suffix: str | None = None


class Evaluator:
    def __init__(self, cfg: EvalConfig = EvalConfig()):
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
            if self.cfg.use_icp:
                rot_err, trans_err = M.transform_errors_icp(batch, rotations_pred,
                                                            translations_pred)
            else:
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
            if self.cfg.rmse_eval_on and batch.G // batch.S >= 2:
                rmse, ratio, terr = M.correspondence_rmse_pairs(batch, rotations_pred,
                                                                translations_pred)
                # samples that are not pairs carry an inf RMSE; their recalls
                # become NaN so the meter leaves them out (:97-99)
                pair = torch.isfinite(rmse)
                nanify = lambda v: torch.where(pair, v, torch.nan)  # noqa: E731
                out.update({
                    "correspondence_rmse (m)": rmse,
                    "correspondence_ratio": nanify(ratio),
                    "recall_at_rmse_0.2m": nanify(M.recall_at(rmse, 0.2)),
                    "transform_error_rmse (m)": terr,
                    "recall_at_transform_error_rmse_0.2m": nanify(M.recall_at(terr, 0.2)),
                })
        if self.cfg.overlap_eval_on:
            ors = M.overlap_ratio(batch, pred)
            out["overlap_ratio_at_0.5%"] = ors[0]
            out["overlap_ratio_at_1%"] = ors[1]
            out["overlap_ratio_at_2%"] = ors[2]
        if self.cfg.part_acc_eval_on:
            acc, _ = M.part_accuracy(batch, pred, threshold=self.cfg.part_acc_threshold)
            out["part_accuracy"] = torch.from_numpy(acc).to(pred.device)
        if self.cfg.ecdf_eval_on and rotations_pred is not None:
            # the batch's ECDF, broadcast to every sample so the meter averages
            # it sample-weighted (:135-155)
            valid = batch.sample_valid.cpu().numpy()
            re_np = out["average_rotation_error (deg)"].cpu().numpy()[valid]
            te_np = out["average_translation_error (m)"].cpu().numpy()[valid]
            for name, errs, thresholds in (("rotation", re_np, (3, 5, 10, 30, 45)),
                                           ("translation", te_np, (0.05, 0.1, 0.25, 0.5,
                                                                   0.75))):
                unit = "deg" if name == "rotation" else "m"
                for thr in thresholds:
                    v = float(np.mean(errs < thr)) if len(errs) else 0.0
                    out[f"ecdf_{name}_at_{thr}{unit}"] = torch.full(
                        (batch.S,), v, device=pred.device)
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
            if "overlap_ratio_at_1%" in stacked:
                best = np.argmax(stacked["overlap_ratio_at_1%"], axis=0)
                cols = np.arange(len(best))
                agg["overlap_ratio_selected"] = {k: stacked[k][best, cols] for k in keys}
                agg["overlap_ratio_selected_gen"] = best
        return agg

    def save_sample_results(self, batch: PartBatch, pred: np.ndarray,
                            rotations_pred: np.ndarray, translations_pred: np.ndarray,
                            metrics_dict: dict[str, np.ndarray], sample_names: list[str],
                            dataset_name: str = "dataset", generation_idx: int | str = 0,
                            trajectory: np.ndarray | None = None,
                            midpoint_trajectory: np.ndarray | None = None) -> None:
        """Write each valid sample's artifacts under
        ``output_dir[_folder_suffix]/dataset_name/name/generation_<idx>/``
        (:211-365), every transform 4x4 row-major in metric scale:
        ``metrics.json`` (with the sample's scale), ``part{p:02d}_pose.txt``
        (the predicted pose), ``part{p:02d}_transform.txt`` (relative to the
        ground truth: R_pred R_gtᵀ, t_pred - R_rel t_gt, composed with the
        inverse global transform where the batch has one),
        ``global_transform.txt``; for the first ``max_artifact_samples_per_batch``
        samples (every one at 0) ``merged_pred.ply``, with
        ``save_pointcloud_parts`` ``part{p:02d}_pred.ply``, and with
        ``save_merged_pointcloud_steps`` ``generation/merged_input.pcd`` and
        one part-coloured ``generation/{endpoint,midpoint}/step_<k>.pcd`` per
        step of ``trajectory`` and ``midpoint_trajectory`` (scaled space)."""
        root = Path(self.cfg.output_dir)
        if self.cfg.folder_suffix:
            root = root.with_name(root.name + f"_{self.cfg.folder_suffix}")
        S, N = batch.S, batch.N
        P = batch.G // S
        host = lambda x: x.detach().cpu().numpy()  # noqa: E731
        mask = host(batch.point_mask).reshape(S, P, N)
        pv = host(batch.part_valid).reshape(S, P)
        scale = host(batch.scale)
        pred_sp = np.asarray(pred).reshape(S, P, N, 3)
        R_sp = np.asarray(rotations_pred).reshape(S, P, 3, 3)
        t_sp = np.asarray(translations_pred).reshape(S, P, 3)
        Rg_sp = host(batch.rotations_gt).reshape(S, P, 3, 3)
        tg_sp = host(batch.translations_gt).reshape(S, P, 3)
        cond_sp = host(batch.points).reshape(S, P, N, 3)
        sv = host(batch.sample_valid)
        g_rot = None if batch.global_rotation is None else host(batch.global_rotation)
        g_trans = None if batch.global_translation is None else host(batch.global_translation)

        def merged(parts_pts, parts_mask, sc):
            pcs = [pp[mm] for pp, mm in zip(parts_pts, parts_mask)]
            ids = (np.concatenate([np.full(len(pc), i) for i, pc in enumerate(pcs)])
                   if pcs else np.zeros(0, int))
            return np.concatenate(pcs, axis=0) * sc, ids

        for s in range(S):
            if not sv[s]:
                continue
            name = sample_names[s] if s < len(sample_names) else f"sample_{s}"
            d = root / dataset_name / name / f"generation_{generation_idx}"
            d.mkdir(parents=True, exist_ok=True)
            if self.cfg.save_json:
                payload = {k: float(np.asarray(v[s])) for k, v in metrics_dict.items()}
                payload["scale"] = float(scale[s])
                (d / "metrics.json").write_text(json.dumps(payload, indent=2))
            T_glob_inv = None
            if g_rot is not None and g_trans is not None:
                T_glob = np.eye(4)
                T_glob[:3, :3] = g_rot[s]
                T_glob[:3, 3] = g_trans[s]
                np.savetxt(d / "global_transform.txt", T_glob, fmt="%.8f")
                T_glob_inv = np.linalg.inv(T_glob)
            for p in range(P):
                if not pv[s, p]:
                    continue
                T = np.eye(4)
                T[:3, :3] = R_sp[s, p]
                T[:3, 3] = t_sp[s, p] * scale[s]
                np.savetxt(d / f"part{p:02d}_pose.txt", T, fmt="%.8f")
                R_rel = R_sp[s, p] @ Rg_sp[s, p].T
                T_rel = np.eye(4)
                T_rel[:3, :3] = R_rel
                T_rel[:3, 3] = t_sp[s, p] * scale[s] - (tg_sp[s, p] * scale[s]) @ R_rel.T
                if T_glob_inv is not None:
                    T_rel = T_rel @ T_glob_inv
                np.savetxt(d / f"part{p:02d}_transform.txt", T_rel, fmt="%.8f")

            if (self.cfg.max_artifact_samples_per_batch
                    and s >= self.cfg.max_artifact_samples_per_batch):
                continue
            plyio.write_ply(d / "merged_pred.ply",
                            merged(pred_sp[s][pv[s]], mask[s][pv[s]], scale[s])[0])
            if self.cfg.save_pointcloud_parts:
                for p in np.flatnonzero(pv[s]):
                    plyio.write_ply(d / f"part{p:02d}_pred.ply",
                                    pred_sp[s, p][mask[s, p]] * scale[s])
            if self.cfg.save_merged_pointcloud_steps:
                gdir = d / "generation"
                gdir.mkdir(parents=True, exist_ok=True)
                inp, ids = merged(cond_sp[s][pv[s]], mask[s][pv[s]], 1.0)
                plyio.write_pcd(gdir / "merged_input.pcd", inp, part_ids_to_colors(ids))
                for traj, sub in ((trajectory, "endpoint"), (midpoint_trajectory, "midpoint")):
                    if traj is None:
                        continue
                    tdir = gdir / sub
                    tdir.mkdir(parents=True, exist_ok=True)
                    traj_sp = np.asarray(traj).reshape(traj.shape[0], S, P, N, 3)
                    for st in range(traj.shape[0]):
                        pts_t, ids_t = merged(traj_sp[st, s][pv[s]], mask[s][pv[s]], 1.0)
                        plyio.write_pcd(tdir / f"step_{st}.pcd", pts_t,
                                        part_ids_to_colors(ids_t))


def trajectory_rigidity_rmse(batch: PartBatch, trajectory: torch.Tensor) -> torch.Tensor:
    """Rigidity RMSE at every trajectory step (steps, G, N, 3) -> (steps, S)."""
    out = []
    for step_pts in trajectory:
        R, t = fit_transformations(batch.points, step_pts, batch.point_mask)
        out.append(M.rigidity_rmse(batch, step_pts, R, t))
    return torch.stack(out)
