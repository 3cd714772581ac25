"""Plain reference of RAP's published evaluation protocol for one scene
(rap_tpu/apps/sample.py:run_eval, eval/evaluator.py:63-221,
eval/metrics.py): the scene posed from its files as a validation sample is,
``generations`` generations from the given noise through ``reference.dit``
with rigidity forcing on ``reference.sampler``'s grid and fits, each part's
pose, the evaluator's per-sample metrics, and the best-of-N and
rigidity-selected choices. Imports nothing of the program and nothing of
JAX; float32 with TF32 off, as ``reference.dit``.

Departures from the program's evaluator, each exact where the program is
not:

- one scene at a time: S = 1, P its own part count, each part padded to its
  largest part under the mask (the mask keeps every padded slot out of every
  valid number: attention over the valid tokens alone, per-token layers,
  masked fits), where the program packs scenes into the packer's buckets;
- ``generate`` is ``sampler.sample``'s loop (its grid, ``kabsch`` and
  ``transform``), keeping each step's end-point estimate x_t - v t, which the
  rigidity selection averages over (``use_average_rigidity_rmse``);
- metrics in float64 over lists of valid points, nearest neighbours by
  direct differences (the program: float32, |x|^2 - 2 x.y + |y|^2 over the
  padded layout);
- only the protocol's options: no ICP, no artifacts, no correspondence,
  overlap, part-accuracy or ECDF metrics, no visualiser.
"""

from __future__ import annotations

import numpy as np
import torch

from . import data as ref_data
from . import dit, sampler

# the evaluator's per-sample metrics, in its order and with its names
METRICS = ("chamfer_l2 (m)", "object_chamfer", "average_rotation_error (deg)",
           "average_translation_error (m)", "recall_at_10deg_0.2m (nss)",
           "recall_at_15deg_0.3m (indoor_bufferx)", "recall_at_5deg_2m (outdoor_bufferx)",
           "recall_at_10deg_5m (map)", "recall_at_chamfer_0.2m", "rigidity_rmse (m)")
RECALLS = {"recall_at_10deg_0.2m (nss)": (10, 0.2),
           "recall_at_15deg_0.3m (indoor_bufferx)": (15, 0.3),
           "recall_at_5deg_2m (outdoor_bufferx)": (5, 2.0),
           "recall_at_10deg_5m (map)": (10, 5.0)}
# names where best-of-N takes the largest (evaluator.py:36)
MAX_KEYS = ("acc", "recall", "success", "ecdf", "overlap_ratio", "correspondence_ratio")


def load_scene(root, name: str, index: int, seed: int) -> dict:
    """Scene ``name`` (the ``index``-th of the split) as the program's
    dataset poses a validation sample, unaugmented (dataset.py:106-247 with
    no rotation drawn): centred on its largest part and scaled by 1.5
    max|coord| of it, re-centred on the scene, every other part re-centred
    on itself (its pose is that shift), each part's points shuffled by
    ``default_rng(SeedSequence([seed, 0, index]))``. Lists per part of float32
    condition points, ground truth and features; float32 (P, 3, 3) rotations
    and (P, 3) translations with points @ R^T + t == ground truth; the
    anchor (the largest part) and the scale."""
    parts, feats = ref_data.load_sample(root, name)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0, index]))
    primary = int(np.argmax([len(p) for p in parts]))
    center = parts[primary].mean(0)
    scale = max(float(np.max(np.abs(parts[primary] - center))) * 1.5, 1e-12)
    gt = [(p - center) / scale for p in parts]
    shift = np.concatenate(gt).mean(0)
    gt = [g - shift for g in gt]
    out = {"points": [], "points_gt": [], "features": [], "anchor": primary, "scale": scale,
           "rotations": np.tile(np.eye(3, dtype=np.float32), (len(parts), 1, 1)),
           "translations": np.zeros((len(parts), 3), np.float32)}
    for i, g in enumerate(gt):
        t = -shift if i == primary else g.mean(0)
        order = rng.permutation(len(g))
        out["points"].append((g - t)[order].astype(np.float32))
        out["points_gt"].append(g[order].astype(np.float32))
        out["features"].append(feats[i][order].astype(np.float32))
        out["translations"][i] = t
    return out


def scene_batch(scene: dict, device) -> dict:
    """The scene as ``reference.dit``'s batch: (P, N) with N its largest part."""
    P, N = len(scene["points"]), max(len(p) for p in scene["points"])
    F = scene["features"][0].shape[1]
    pts, feats = np.zeros((P, N, 3), np.float32), np.zeros((P, N, F), np.float32)
    mask = np.zeros((P, N), bool)
    for i, (p, f) in enumerate(zip(scene["points"], scene["features"])):
        pts[i, :len(p)], feats[i, :len(p)], mask[i, :len(p)] = p, f, True
    return {"points": torch.from_numpy(pts).to(device),
            "local_feats": torch.from_numpy(feats).to(device),
            "point_mask": torch.from_numpy(mask).to(device),
            "anchor_part": torch.arange(P, device=device) == scene["anchor"],
            "scale": torch.tensor([scene["scale"]], dtype=torch.float32, device=device),
            "parts_per_sample": P}


@torch.no_grad()
def generate(params: dict, model: dict, batch: dict, x_1: torch.Tensor, steps: int,
             prec: dit.Precision = dit.FP32):
    """One generation with rigidity forcing: (points (P, N, 3) float32, R
    (P, 3, 3), t (P, 3), [each step's end-point estimate (P, N, 3)])."""
    cond, mask = batch["points"], batch["point_mask"]
    ts = sampler.schedule(steps)
    x = x_1.float()
    ends = []
    with dit.exact_fp32():
        for t, t_next in zip(ts[:-1], ts[1:]):
            v = dit.forward(params, model, x, torch.full((1,), t, device=x.device), batch, prec)
            x0_hat = x - v * t
            ends.append(x0_hat)
            R, tr = sampler.kabsch(cond, x0_hat, mask)
            rigid = sampler.transform(R, tr, cond).float()
            x = torch.where(mask[..., None], rigid, x0_hat) * (1.0 - t_next) \
                + x_1.float() * t_next
        R, tr = sampler.kabsch(cond, x, mask)
    return x, R.float(), tr.float(), ends


def _valid(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The valid points of (P, N, 3) as one (n, 3) float64 list."""
    return x[mask].double()


def _min_d2(x: torch.Tensor, y: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    return torch.cat([torch.cdist(x[i:i + chunk], y,
                                  compute_mode="donot_use_mm_for_euclid_dist").amin(1) ** 2
                      for i in range(0, len(x), chunk)])


def _angle_deg(R: torch.Tensor) -> torch.Tensor:
    tr = R.diagonal(dim1=-2, dim2=-1).sum(-1)
    return torch.rad2deg(torch.arccos((0.5 * (tr - 1.0)).clamp(-1.0, 1.0)))


def rigidity_rmse(batch: dict, pred: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
                  scale: float) -> float:
    """RMSE in metres of the condition posed by (R, t) against ``pred``."""
    posed = sampler.transform(R.double(), t.double(), batch["points"])
    se = ((posed - pred.double()) ** 2).sum(-1)[batch["point_mask"]]
    return float(torch.sqrt(se.mean())) * scale


def metrics(scene: dict, batch: dict, pred: torch.Tensor, R: torch.Tensor,
            t: torch.Tensor) -> dict[str, float]:
    """The evaluator's per-sample metrics of one generation (evaluator.py:63-156)."""
    mask, dev, scale = batch["point_mask"], pred.device, scene["scale"]
    gt = torch.cat([torch.from_numpy(g) for g in scene["points_gt"]]).to(dev).double()
    y = _valid(pred, mask)
    cd = float(torch.sqrt(0.5 * (_min_d2(gt, y).mean() + _min_d2(y, gt).mean())))
    # anchor-relative errors over the other parts (metrics.py:101)
    a = scene["anchor"]
    Rg = torch.from_numpy(scene["rotations"]).to(dev).double()
    tg = torch.from_numpy(scene["translations"]).to(dev).double()
    Rp, tp = R.double(), t.double()
    Rg_rel, tg_rel = Rg[a].T @ Rg, (tg - tg[a]) @ Rg[a]
    Rp_rel, tp_rel = Rp[a].T @ Rp, (tp - tp[a]) @ Rp[a]
    others = torch.arange(len(Rg), device=dev) != a
    rot = float(_angle_deg(Rg_rel.transpose(-1, -2) @ Rp_rel)[others].mean())
    trans = float(((tp_rel - tg_rel) * scale).norm(dim=-1)[others].mean())
    out = {"chamfer_l2 (m)": cd * scale, "object_chamfer": cd,
           "average_rotation_error (deg)": rot, "average_translation_error (m)": trans}
    for key, (deg, m) in RECALLS.items():
        out[key] = float(rot <= deg and trans <= m)
    out["recall_at_chamfer_0.2m"] = float(cd * scale <= 0.2)
    out["rigidity_rmse (m)"] = rigidity_rmse(batch, pred, R, t, scale)
    return {k: out[k] for k in METRICS}


def trajectory_rigidity(batch: dict, ends: list[torch.Tensor], scale: float) -> float:
    """The rigidity RMSE of each step's end-point estimate against its own
    fit, averaged over the steps (evaluator.py:367)."""
    vals = []
    for e in ends:
        R, t = sampler.kabsch(batch["points"], e, batch["point_mask"])
        vals.append(rigidity_rmse(batch, e, R, t, scale))
    return float(np.mean(vals))


def evaluate_scene(params: dict, model: dict, scene: dict, noises: list[torch.Tensor],
                   steps: int, prec: dit.Precision = dit.FP32, device=None) -> dict:
    """The protocol for one scene: ``noises`` (P, N, 3) per generation, N
    the scene's largest part (values past a part's points are not read).
    Returns ``generations`` [(points (P, N, 3), R, t, metrics)], the
    trajectory rigidity of each, ``best_of`` and ``rigidity_selected`` (the
    metrics of the generation with the least trajectory rigidity, the first
    on a tie) and ``selected`` (its index)."""
    batch = scene_batch(scene, device or noises[0].device)
    gens, rig = [], []
    for x_1 in noises:
        pts, R, t, ends = generate(params, model, batch, x_1.to(batch["points"].device), steps,
                                   prec)
        gens.append((pts, R, t, metrics(scene, batch, pts, R, t)))
        rig.append(trajectory_rigidity(batch, ends, scene["scale"]))
    table = {k: np.array([g[3][k] for g in gens]) for k in METRICS}
    best = {k: float(v.max() if any(m in k for m in MAX_KEYS) else v.min())
            for k, v in table.items()}
    sel = int(np.argmin(rig))
    return {"generations": gens, "rigidity": rig, "best_of": best, "selected": sel,
            "rigidity_selected": dict(gens[sel][3])}
