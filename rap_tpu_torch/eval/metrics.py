"""Evaluation metrics, batched over the PartBatch layout (counterpart of the
metrics of rap_tpu/eval/metrics.py that ``Evaluator.compute_metrics``
reaches at the default ``EvalConfig``).

- ``chamfer_rmse`` (:76): sqrt(0.5 (mean_x min_y d² + mean_y min_x d²)) per
  sample in scaled space, the nearest-neighbour minima chunked over the
  query points on the batch's device (``_masked_min_dist2``, :45);
- ``transform_errors`` (:101): anchor-relative (or direct) rotation error in
  degrees and translation error in metres, averaged over valid (non-anchor)
  parts;
- ``rigidity_rmse`` (:161): the rigidly transformed input against the
  generation;
- ``recall_at`` and ``combined_recall`` (:568-576).

Every function returns (S,) per-sample fp32 values; invalid sample slots
give 0. The 3x3 products are elementwise sums (full fp32 whatever the TF32
setting); the chamfer cross term is one fp32 matmul per chunk, which runs
in full fp32 under PyTorch's default matmul precision.
"""

from __future__ import annotations

import torch

from ..core.batch import PartBatch
from ..core.procrustes import _matmul33, transform_points


def _sample_tokens(batch: PartBatch, pts: torch.Tensor):
    """(G, N, 3) -> (S, P*N, 3) and the (S, P*N) mask (regular layout)."""
    S = batch.S
    return pts.reshape(S, -1, 3), batch.point_mask.reshape(S, -1)


def _masked_min_dist2(x, xm, y, ym, chunk: int = 2048):
    """Per row of x (S, Tx, 3): min squared distance to the valid rows of y
    (S, Ty, 3); invalid x rows give 0. Chunked over Tx."""
    y2 = (y * y).sum(-1)  # (S, Ty)
    mins = []
    for c in range(0, x.shape[1], chunk):
        xi = x[:, c:c + chunk]
        d2 = (xi * xi).sum(-1)[..., None] - 2.0 * (xi @ y.transpose(1, 2)) + y2[:, None, :]
        d2 = torch.where(ym[:, None, :], d2, torch.inf)
        mins.append(d2.amin(-1))
    return torch.where(xm, torch.cat(mins, dim=1).clamp_min(0.0), 0.0)


def chamfer_rmse(batch: PartBatch, pred: torch.Tensor) -> torch.Tensor:
    """Symmetric chamfer RMSE per sample in scaled space (:76)."""
    x, xm = _sample_tokens(batch, batch.points_gt.float())
    y, ym = _sample_tokens(batch, pred.float())
    d_xy = _masked_min_dist2(x, xm, y, ym)
    d_yx = _masked_min_dist2(y, ym, x, xm)
    cnt_x = xm.sum(1).float().clamp_min(1.0)
    cnt_y = ym.sum(1).float().clamp_min(1.0)
    return torch.sqrt(0.5 * (d_xy.sum(1) / cnt_x + d_yx.sum(1) / cnt_y))


def _per_part_view(batch: PartBatch, x: torch.Tensor) -> torch.Tensor:
    """(G, ...) -> (S, P, ...)."""
    return x.reshape((batch.S, batch.G // batch.S) + tuple(x.shape[1:]))


def _rot_angle_deg(delta_R: torch.Tensor) -> torch.Tensor:
    tr = delta_R.diagonal(dim1=-2, dim2=-1).sum(-1)
    return torch.rad2deg(torch.arccos((0.5 * (tr - 1.0)).clamp(-1.0, 1.0)))


def _mv(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R (..., 3, 3) @ v (..., 3) in full fp32."""
    return (R * v[..., None, :]).sum(-1)


def transform_errors(batch: PartBatch, rotations_pred, translations_pred,
                     anchor_relative: bool = True):
    """Mean per-sample rotation (deg) and translation (m) errors (:101):
    relative to each sample's anchor part over valid non-anchor parts, or
    direct over all valid parts."""
    S = batch.S
    Rg = _per_part_view(batch, batch.rotations_gt.float())
    tg = _per_part_view(batch, batch.translations_gt.float())
    Rp = _per_part_view(batch, rotations_pred.float())
    tp = _per_part_view(batch, translations_pred.float())
    valid = _per_part_view(batch, batch.part_valid)
    anchor = _per_part_view(batch, batch.anchor_part)
    scale = batch.scale.float()[:, None, None]

    if anchor_relative:
        has_anchor = anchor.any(1)
        a_idx = anchor.float().argmax(1)  # the first anchor, 0 if none
        ar = torch.arange(S, device=a_idx.device)
        eye = torch.eye(3, device=Rg.device).expand(S, 3, 3)
        Rg_a = torch.where(has_anchor[:, None, None], Rg[ar, a_idx], eye)
        tg_a = torch.where(has_anchor[:, None], tg[ar, a_idx], 0.0)
        Rp_a = torch.where(has_anchor[:, None, None], Rp[ar, a_idx], eye)
        tp_a = torch.where(has_anchor[:, None], tp[ar, a_idx], 0.0)

        def rel(Ra, ta, R, t):
            # R_rel = R_a^T R ; t_rel = R_a^T (t - t_a)
            RaT = Ra.transpose(-1, -2)[:, None]
            return _matmul33(RaT, R), _mv(RaT, t - ta[:, None, :])

        Rg_rel, tg_rel = rel(Rg_a, tg_a, Rg, tg)
        Rp_rel, tp_rel = rel(Rp_a, tp_a, Rp, tp)
        delta_R = _matmul33(Rg_rel.transpose(-1, -2), Rp_rel)
        delta_t = (tp_rel - tg_rel) * scale
        count_mask = valid & ~anchor
    else:
        delta_R = _matmul33(Rg.transpose(-1, -2), Rp)
        delta_t = (tp - tg) * scale
        count_mask = valid

    rot_err = _rot_angle_deg(delta_R)
    trans_err = torch.linalg.vector_norm(delta_t, dim=-1)
    m = count_mask.float()
    n = m.sum(1).clamp_min(1.0)
    return (rot_err * m).sum(1) / n, (trans_err * m).sum(1) / n


def rigidity_rmse(batch: PartBatch, pred, rotations_pred, translations_pred,
                  in_meters: bool = True, average_per_part: bool = False):
    """RMSE between the rigidly transformed inputs and the generation, per
    sample (:161)."""
    transformed = transform_points(rotations_pred.float(), translations_pred.float(),
                                   batch.points.float())
    se = ((transformed - pred.float()) ** 2).sum(-1)  # (G, N)
    m = batch.point_mask.float()
    S = batch.S
    if average_per_part:
        part_rmse = torch.sqrt((se * m).sum(1) / m.sum(1).clamp_min(1.0))
        pv = _per_part_view(batch, batch.part_valid).float()
        out = (part_rmse.reshape(S, -1) * pv).sum(1) / pv.sum(1).clamp_min(1.0)
    else:
        out = torch.sqrt((se * m).reshape(S, -1).sum(1)
                         / m.reshape(S, -1).sum(1).clamp_min(1.0))
    if in_meters:
        out = out * batch.scale.float()
    return out


def recall_at(values: torch.Tensor, threshold: float) -> torch.Tensor:
    return (values <= threshold).float()


def combined_recall(rot_err, trans_err, rot_thresh, trans_thresh) -> torch.Tensor:
    return ((rot_err <= rot_thresh) & (trans_err <= trans_thresh)).float()
