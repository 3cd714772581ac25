"""Evaluation metrics, batched over the PartBatch layout (counterpart of
rap_tpu/eval/metrics.py).

- ``chamfer_rmse`` (:76): sqrt(0.5 (mean_x min_y d² + mean_y min_x d²)) per
  sample in scaled space, the nearest-neighbour minima chunked over the
  query points on the batch's device (``_masked_min_dist2``, :45);
- ``transform_errors`` (:101): anchor-relative (or direct) rotation error in
  degrees and translation error in metres, averaged over valid (non-anchor)
  parts;
- ``rigidity_rmse`` (:161): the rigidly transformed input against the
  generation;
- ``correspondence_rmse_pairs`` (:190): the pairwise correspondence RMSE at
  ground-truth nearest neighbours within 5 cm, the correspondence ratio and
  the Redwood-style transform-error RMSE of 2-part samples;
- ``overlap_ratio`` (:298): the share of points with a point of another part
  within tau;
- ``icp_point_to_point`` (:374, with ``_masked_nn`` :346): batched
  point-to-point ICP, a fixed number of nearest-neighbour + Kabsch steps
  (optionally trimmed); ``align_anchor`` (:450) and ``transform_errors_icp``
  (:473) on it;
- ``part_chamfer_matrix`` (:502) and ``part_accuracy`` (:534): the
  Hungarian-matched share of parts under a chamfer threshold (scipy's
  ``linear_sum_assignment`` on the host);
- ``recall_at``, ``combined_recall`` and ``ecdf`` (:568-583).

Every per-sample function returns (S,) fp32 values; invalid sample slots
give 0. All run on the batch's device, nearest neighbours chunked over the
query points as rap_tpu chunks them (no Pallas kernel stands behind any of
them). The 3x3 products are elementwise sums (full fp32 whatever the TF32
setting); the nearest-neighbour cross terms are fp32 matmuls, which run in
full fp32 under PyTorch's default matmul precision.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.batch import PartBatch
from ..core.procrustes import _matmul33, kabsch_masked, transform_points


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
        d2 = torch.where(ym[:, None, :], _pair_dist2(xi, y, y2), torch.inf)
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


def _pair_dist2(x, y, y2):
    """Squared distances (B, Tx, Ty) of x rows to y rows, y2 = |y|²."""
    return (x * x).sum(-1)[..., None] - 2.0 * (x @ y.transpose(1, 2)) + y2[:, None, :]


def _masked_nn(x, y, ym, chunk: int = 2048):
    """Nearest valid y row per x row (:346): (dist (B, Tx), idx (B, Tx)),
    chunked over Tx; invalid y rows are never chosen, x rows not masked."""
    y2 = (y * y).sum(-1)
    dists, idxs = [], []
    for c in range(0, x.shape[1], chunk):
        d2 = torch.where(ym[:, None, :], _pair_dist2(x[:, c:c + chunk], y, y2), torch.inf)
        m, i = d2.min(-1)
        dists.append(m)
        idxs.append(i)
    return torch.cat(dists, 1).clamp_min(0.0).sqrt(), torch.cat(idxs, 1)


def _rel_pose(R, t):
    """T_1 ∘ T_0⁻¹ of each sample's first two parts: (R1 R0ᵀ, t1 - R1 R0ᵀ t0)."""
    R10 = _matmul33(R[:, 1], R[:, 0].transpose(-1, -2))
    return R10, t[:, 1] - _mv(R10, t[:, 0])


def correspondence_rmse_pairs(batch: PartBatch, rotations_pred, translations_pred,
                              distance_threshold: float = 0.05):
    """Pairwise correspondence RMSE in metres (:190): (rmse, ratio, terr),
    each (S,). Samples with exactly 2 valid parts: ground-truth
    correspondences are the nearest valid target point of each source point
    of the metric-scaled ground-truth parts within the threshold; the RMSE
    is over the pose-transformed inputs at those pairs, the ratio their
    share of the source points, terr the Redwood-style transform-error
    RMSE. Other samples get inf RMSE and terr and ratio 0."""
    S, P, N = batch.S, batch.G // batch.S, batch.N
    if P < 2:
        raise ValueError("correspondence_rmse_pairs needs at least 2 part slots a sample")
    scale = batch.scale.float()
    scale_pt = batch.per_sample_to_point(scale)[..., None]  # (G, N, 1)
    gt_m = (batch.points_gt.float() * scale_pt).reshape(S, P, N, 3)
    in_m = (batch.points.float() * scale_pt).reshape(S, P, N, 3)
    mask = batch.point_mask.reshape(S, P, N)
    Rp = _per_part_view(batch, rotations_pred.float())
    tp = _per_part_view(batch, translations_pred.float()) * scale[:, None, None]
    pred_m = transform_points(Rp, tp, in_m)  # (S, P, N, 3)

    src_m = mask[:, 0]
    mind, nn_idx = _masked_nn(gt_m[:, 0], gt_m[:, 1], mask[:, 1])
    corr = src_m & (mind <= distance_threshold)
    n_corr = corr.sum(1)
    tgt_pred_at = torch.gather(pred_m[:, 1], 1, nn_idx[..., None].expand(-1, -1, 3))
    se = ((pred_m[:, 0] - tgt_pred_at) ** 2).sum(-1)
    rmse = torch.sqrt((se * corr).sum(1) / n_corr.clamp_min(1))
    ratio = n_corr / src_m.sum(1).clamp_min(1)
    # only 2-part samples are scored (:258-270)
    valid_parts = batch.part_valid.reshape(S, P).sum(1)
    pair_ok = ((valid_parts == 2) & (mask[:, 0].sum(1) > 0) & (mask[:, 1].sum(1) > 0)
               & (n_corr > 0))
    rmse = torch.where(pair_ok, rmse, torch.inf)
    ratio = torch.where(pair_ok, ratio, 0.0)

    Rg = _per_part_view(batch, batch.rotations_gt.float())
    tg = _per_part_view(batch, batch.translations_gt.float()) * scale[:, None, None]
    Rrel_gt, trel_gt = _rel_pose(Rg, tg)
    Rrel_p, trel_p = _rel_pose(Rp, tp)
    dR = _matmul33(Rrel_gt.transpose(-1, -2), Rrel_p)
    dt = trel_p - trel_gt
    tr = dR.diagonal(dim1=-2, dim2=-1).sum(-1)
    qw = torch.sqrt((1.0 + tr).clamp_min(1e-12)) / 2.0
    den = (4 * qw).clamp_min(1e-12)
    q = torch.stack([dR[:, 2, 1] - dR[:, 1, 2], dR[:, 0, 2] - dR[:, 2, 0],
                     dR[:, 1, 0] - dR[:, 0, 1]], -1) / den[:, None]
    er = torch.cat([dt, q], -1)
    terr = torch.where(pair_ok, torch.sqrt((er * er).sum(-1)), torch.inf)
    return rmse, ratio, terr


def overlap_ratio(batch: PartBatch, pred, taus=(0.005, 0.01, 0.02), chunk: int = 1024):
    """Share of each sample's valid points with a valid point of another part
    within tau (:298): (len(taus), S)."""
    S, P, N = batch.S, batch.G // batch.S, batch.N
    pts = pred.float().reshape(S, P * N, 3)
    mask = batch.point_mask.reshape(S, P * N)
    part_id = torch.arange(P, device=pts.device).repeat_interleave(N)  # (P*N,)
    y2 = (pts * pts).sum(-1)
    mins = []
    for c in range(0, P * N, chunk):
        ok = (part_id[c:c + chunk, None] != part_id[None, :])[None] & mask[:, None, :]
        d2 = torch.where(ok, _pair_dist2(pts[:, c:c + chunk], pts, y2), torch.inf)
        mins.append(d2.amin(-1))
    mind = torch.cat(mins, 1).clamp_min(0.0).sqrt()
    cnt = mask.sum(1).clamp_min(1)
    return torch.stack([((mind <= tau) & mask).sum(1) / cnt for tau in taus])


def icp_point_to_point(src, src_mask, tgt, tgt_mask, iters: int = 20,
                       trim_fraction: float = 1.0, init=None,
                       return_residual: bool = False):
    """Batched point-to-point ICP (:374): (R, t) with src @ Rᵀ + t ≈ tgt,
    ``iters`` steps of nearest valid target + masked Kabsch from ``init``
    (R0 (B, 3, 3), t0 (B, 3); identity by default). ``trim_fraction`` < 1
    keeps the closest share of the valid correspondences each step (at least
    3). ``return_residual`` adds the final trimmed mean nearest distance (B,).
    Empty clouds give (I, 0)."""
    src, tgt = src.float(), tgt.float()

    def trim_keep(d):
        if trim_fraction >= 1.0:
            return src_mask
        dv = torch.where(src_mask, d, torch.inf)
        k = (src_mask.sum(-1).float() * trim_fraction).to(torch.int32).clamp_min(3)
        thr = torch.gather(dv.sort(-1).values, 1,
                           (k - 1).clamp_max(dv.shape[-1] - 1).long()[:, None])
        return src_mask & (dv <= thr)

    B = src.shape[0]
    if init is None:
        R = torch.eye(3, device=src.device).expand(B, 3, 3)
        t = torch.zeros((B, 3), device=src.device)
    else:
        R, t = (a.float() for a in init)
    for _ in range(iters):
        d, idx = _masked_nn(transform_points(R, t, src), tgt, tgt_mask)
        corr = torch.gather(tgt, 1, idx[..., None].expand(-1, -1, 3))
        R, t = kabsch_masked(src, corr, trim_keep(d))
    if not return_residual:
        return R, t
    d, _ = _masked_nn(transform_points(R, t, src), tgt, tgt_mask)
    keep = trim_keep(d)
    return R, t, torch.where(keep, d, 0.0).sum(-1) / keep.sum(-1).clamp_min(1)


def _anchor_take(batch: PartBatch, x):
    """Each sample's (first) anchor part of (S, P, ...)."""
    a_idx = _per_part_view(batch, batch.anchor_part).float().argmax(1)
    return x[torch.arange(batch.S, device=x.device), a_idx]


def align_anchor(batch: PartBatch, pred, iters: int = 20):
    """ICP the predicted anchor part of each sample onto its ground-truth
    anchor part and move the whole predicted sample by that transform
    (:450): (G, N, 3)."""
    S, P, N = batch.S, batch.G // batch.S, batch.N
    pred_p = pred.float().reshape(S, P, N, 3)
    gt_p = batch.points_gt.float().reshape(S, P, N, 3)
    m = _anchor_take(batch, batch.point_mask.reshape(S, P, N))
    R, t = icp_point_to_point(_anchor_take(batch, pred_p), m, _anchor_take(batch, gt_p), m,
                              iters=iters)
    return transform_points(R[:, None], t[:, None], pred_p).reshape(batch.G, N, 3)


def transform_errors_icp(batch: PartBatch, rotations_pred, translations_pred,
                         iters: int = 20):
    """ICP-refined per-sample errors (:473): each ground-truth part ICP'd
    onto its pose-transformed condition part; the residual rotation (deg)
    and translation (m), averaged over valid non-anchor parts."""
    transformed = transform_points(rotations_pred.float(), translations_pred.float(),
                                   batch.points.float())
    dR, dt = icp_point_to_point(batch.points_gt, batch.point_mask, transformed,
                                batch.point_mask, iters=iters)
    rot_err = _rot_angle_deg(_per_part_view(batch, dR))
    trans_err = (torch.linalg.vector_norm(_per_part_view(batch, dt), dim=-1)
                 * batch.scale.float()[:, None])
    m = (_per_part_view(batch, batch.part_valid)
         & ~_per_part_view(batch, batch.anchor_part)).float()
    n = m.sum(1).clamp_min(1.0)
    return (rot_err * m).sum(1) / n, (trans_err * m).sum(1) / n


def part_chamfer_matrix(batch: PartBatch, pred):
    """(S, P, P) chamfer of ground-truth part i against predicted part j in
    scaled space, the sum of the two mean squared nearest distances
    (:502); pairs with an empty part get inf."""
    S, P, N = batch.S, batch.G // batch.S, batch.N
    gt = batch.points_gt.float().reshape(S, P, N, 3)
    pr = pred.float().reshape(S, P, N, 3)
    mask = batch.point_mask.reshape(S, P, N)
    cnt = mask.sum(-1).float().clamp_min(1.0)
    out = torch.empty((S, P, P), device=gt.device)
    for i in range(P):
        for j in range(P):
            xm, ym = mask[:, i], mask[:, j]
            d_xy = _masked_min_dist2(gt[:, i], xm, pr[:, j], ym, chunk=1024)
            d_yx = _masked_min_dist2(pr[:, j], ym, gt[:, i], xm, chunk=1024)
            cd = d_xy.sum(1) / cnt[:, i] + d_yx.sum(1) / cnt[:, j]
            empty = (xm.sum(1) == 0) | (ym.sum(1) == 0)
            out[:, i, j] = torch.where(empty, torch.inf, cd)
    return out


def part_accuracy(batch: PartBatch, pred, threshold: float = 0.01):
    """Hungarian-matched part accuracy (:534): (acc (S,), matched (S, P)),
    numpy. The share of valid parts whose assigned chamfer is under
    ``threshold``, the assignment by scipy's ``linear_sum_assignment`` on
    the binary over-threshold cost over valid parts; the chamfer matrix on
    the device, the assignment on the host."""
    from scipy.optimize import linear_sum_assignment

    S, P = batch.S, batch.G // batch.S
    cd = part_chamfer_matrix(batch, pred).cpu().numpy()
    valid = _per_part_view(batch, batch.part_valid).cpu().numpy()
    acc = np.zeros(S, np.float32)
    matched = np.tile(np.arange(P, dtype=np.int64), (S, 1))
    for s in range(S):
        idx = np.flatnonzero(valid[s])
        if len(idx) == 0:
            continue
        sub = cd[s][np.ix_(idx, idx)]
        rows, cols = linear_sum_assignment((sub >= threshold).astype(np.float64))
        acc[s] = float((sub[rows, cols] < threshold).sum()) / len(idx)
        matched[s, idx[rows]] = idx[cols]
    return acc, matched


def recall_at(values: torch.Tensor, threshold: float) -> torch.Tensor:
    return (values <= threshold).float()


def combined_recall(rot_err, trans_err, rot_thresh, trans_thresh) -> torch.Tensor:
    return ((rot_err <= rot_thresh) & (trans_err <= trans_thresh)).float()


def ecdf(errors, splits) -> tuple[np.ndarray, float, float]:
    """ECDF values at ``splits``, mean and median of host-side errors (:578)."""
    errors = np.asarray(errors)
    vals = np.array([np.mean(errors < s) for s in splits], np.float32)
    return vals, float(np.mean(errors)), float(np.median(errors))
