"""Visualisation of evaluation batches (counterpart of
rap_tpu/eval/visualizer.py, host numpy like it).

- ``FlowVisualization.on_batch_end``: per valid sample (at most
  ``max_samples``; with ``failure_metric`` only those under
  ``failure_threshold``), renders of the input, the ground truth and each
  generation, end-point and x_t trajectory GIFs, the transformer features
  coloured by a PCA basis frozen at the first sample, and with
  ``render_parts`` one render per part.
- ``OverlapVisualization``: per-sample overlap-probability statistics, a CSV,
  a histogram, a sample x part heatmap and overlap-coloured clouds.

Both take the port's ``PartBatch`` and tensors on any device (or numpy
arrays) and move them to the host once per batch.
"""

from __future__ import annotations

import dataclasses
import types
from pathlib import Path

import numpy as np
import torch

from ..core.batch import PartBatch
from ..utils import render as R

_BATCH_FIELDS = ("points", "points_gt", "point_mask", "part_valid", "sample_valid")


def _host(x) -> np.ndarray:
    """A tensor (any device, any float dtype) or array as a numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).cpu().numpy()
    return np.asarray(x)


def _host_batch(batch: PartBatch) -> types.SimpleNamespace:
    """The fields the visualisers read, on the host, with S, G and N."""
    return types.SimpleNamespace(S=batch.S, G=batch.G, N=batch.N,
                                 **{f: _host(getattr(batch, f)) for f in _BATCH_FIELDS})


@dataclasses.dataclass(frozen=True)
class VisualizerConfig:
    """The ``visualizer`` section of a config (``renderer``: matplotlib | raster
    | shaded | none)."""

    output_dir: str = "visualizations"
    image_size: int = 512
    render_trajectory: bool = True
    render_parts: bool = False
    render_features: bool = True
    max_samples: int = 8
    failure_metric: str = ""          # e.g. "recall_at_15deg_0.3m (indoor_bufferx)"
    failure_threshold: float = 0.5    # render only samples with metric < thr
    renderer: str = "matplotlib"


class FlowVisualization:
    """Per-batch renders of inputs, ground truth, generations, trajectories
    and features (the module docstring)."""

    def __init__(self, cfg: VisualizerConfig = VisualizerConfig()):
        self.cfg = cfg
        self._pca_basis = None          # frozen from the first batch
        self._feat_pca_basis = None

    def _unpack(self, batch: PartBatch, arr: np.ndarray):
        """(G,N,...) -> list per sample of (n_pts, ...) concatenated parts."""
        S = batch.S
        P = batch.G // S
        mask = np.asarray(batch.point_mask).reshape(S, P, batch.N)
        pv = np.asarray(batch.part_valid).reshape(S, P)
        arr = np.asarray(arr).reshape((S, P, batch.N) + np.asarray(arr).shape[2:])
        out, pids = [], []
        for s in range(S):
            chunks, ids = [], []
            for p in range(P):
                if pv[s, p]:
                    chunks.append(arr[s, p][mask[s, p]])
                    ids.append(np.full(int(mask[s, p].sum()), p))
            out.append(np.concatenate(chunks) if chunks else np.zeros((0, 3)))
            pids.append(np.concatenate(ids) if ids else np.zeros(0, int))
        return out, pids

    def on_batch_end(
        self,
        batch: PartBatch,
        generations: list,                      # per generation (G,N,3)
        trajectories: list | None = None,       # (steps,G,N,3) x_0_hat
        midpoint_trajectories: list | None = None,  # (steps,G,N,3) x_t
        transformer_features=None,              # (G,N,D)
        metrics: dict | None = None,
        sample_names: list[str] | None = None,
        dataset_name: str = "dataset",
        batch_idx: int = 0,
    ) -> list[Path]:
        """Render everything for this batch; returns written file paths."""
        cfg = self.cfg
        batch = _host_batch(batch)
        generations = [_host(g) for g in generations]
        trajectories = [_host(x) for x in trajectories] if trajectories else None
        midpoint_trajectories = ([_host(x) for x in midpoint_trajectories]
                                 if midpoint_trajectories else None)
        if transformer_features is not None:
            transformer_features = _host(transformer_features)
        if metrics:
            metrics = {k: _host(v) for k, v in metrics.items()}
        root = Path(cfg.output_dir) / dataset_name
        written: list[Path] = []
        sv = np.asarray(batch.sample_valid)
        inputs, pids = self._unpack(batch, batch.points)
        gts, _ = self._unpack(batch, batch.points_gt)

        keep = np.where(sv)[0]
        if cfg.failure_metric and metrics and cfg.failure_metric in metrics:
            # filter BEFORE the max_samples cap — a failure in a late sample
            # slot must still render (the whole point of failure-only mode)
            vals = np.asarray(metrics[cfg.failure_metric])
            keep = [s for s in keep if vals[s] < cfg.failure_threshold]
        keep = list(keep)[: cfg.max_samples]

        # hoist batch-wide unpacks out of the per-sample loop (each _unpack
        # walks all S*P slots; the per-sample loop only indexes the result)
        gens_unpacked = [self._unpack(batch, gen)[0] for gen in generations]
        trajs_unpacked = {}
        if cfg.render_trajectory:
            for trajs, tag in (
                (trajectories, "trajectory"),
                (midpoint_trajectories, "trajectory_xt"),
            ):
                if trajs:
                    traj = trajs[0]
                    trajs_unpacked[tag] = [
                        self._unpack(batch, traj[st])[0]
                        for st in range(traj.shape[0])
                    ]
        feats_unpacked = (
            self._unpack(batch, transformer_features)[0]
            if cfg.render_features and transformer_features is not None
            else None
        )

        for s in keep:
            name = (
                sample_names[s]
                if sample_names and s < len(sample_names)
                else f"b{batch_idx}_s{s}"
            )
            d = root / name
            colors = R.part_ids_to_colors(pids[s])
            img = R.visualize_point_clouds(
                inputs[s], colors=colors, renderer=cfg.renderer,
                image_size=cfg.image_size, title="input",
            )
            if img is not None:
                R.save_image(d / "input.png", img)
                written.append(d / "input.png")
                R.save_image(
                    d / "gt.png",
                    R.visualize_point_clouds(
                        gts[s], colors=colors, renderer=cfg.renderer,
                        image_size=cfg.image_size, title="ground truth",
                    ),
                )
            for g, gen_s in enumerate(gens_unpacked):
                img = R.visualize_point_clouds(
                    gen_s[s], colors=colors, renderer=cfg.renderer,
                    image_size=cfg.image_size, title=f"generation {g}",
                )
                if img is not None:
                    R.save_image(d / f"generation_{g}.png", img)
                    written.append(d / f"generation_{g}.png")
            # endpoint (x_0_hat) and midpoint (x_t) GIFs — the reference
            # renders both trajectory types (visualizer.py:303-353,:586-654)
            for tag, steps_unpacked in trajs_unpacked.items():
                frames = []
                for st, step_s in enumerate(steps_unpacked):
                    img = R.visualize_point_clouds(
                        step_s[s], colors=R.part_ids_to_colors(pids[s]),
                        renderer=cfg.renderer,
                        image_size=cfg.image_size, title=f"{tag} step {st}",
                    )
                    if img is not None:
                        frames.append(img)
                if frames:
                    R.save_gif(d / f"{tag}_0.gif", frames)
                    written.append(d / f"{tag}_0.gif")
            if feats_unpacked is not None:
                cols, self._pca_basis = R.pca_colors(
                    feats_unpacked[s], self._pca_basis
                )
                img = R.visualize_point_clouds(
                    gts[s] if len(gts[s]) == len(cols) else inputs[s],
                    colors=cols, renderer=cfg.renderer,
                    image_size=cfg.image_size, title="features (PCA)",
                )
                if img is not None:
                    R.save_image(d / "features_pca.png", img)
                    written.append(d / "features_pca.png")
            if cfg.render_parts:
                parts = np.unique(pids[s])
                for p in parts:
                    sel = pids[s] == p
                    img = R.visualize_point_clouds(
                        inputs[s][sel],
                        colors=R.part_ids_to_colors(pids[s][sel]),
                        renderer=cfg.renderer,
                        image_size=cfg.image_size, title=f"part {p}",
                    )
                    if img is not None:
                        R.save_image(d / f"part_{p}.png", img)
        return written


class OverlapVisualization:
    """Overlap-probability statistics: histograms + per-sample CSV
    (ref OverlapVisualizationCallback, visualizer.py:759-1301)."""

    def __init__(self, output_dir: str = "visualizations/overlap", max_pair_clouds: int = 8):
        self.output_dir = Path(output_dir)
        self.rows: list[dict] = []
        self.part_means: list[tuple[str, np.ndarray]] = []  # heatmap rows
        self._pair_clouds: list[tuple[str, np.ndarray, np.ndarray]] = []
        self.max_pair_clouds = max_pair_clouds

    def add_batch(
        self,
        batch: PartBatch,
        overlap_prob,  # (G, N) predicted overlap probabilities
        sample_names: list[str] | None = None,
    ) -> None:
        batch = _host_batch(batch)
        S = batch.S
        P = batch.G // S
        mask = batch.point_mask.reshape(S, P, batch.N)
        pv = batch.part_valid.reshape(S, P)
        pts = batch.points.reshape(S, P, batch.N, 3)
        prob = _host(overlap_prob).reshape(S, P, batch.N)
        for s in range(S):
            if not bool(batch.sample_valid[s]):
                continue
            name = sample_names[s] if sample_names else f"s{s}"
            vals = prob[s][mask[s]]
            self.rows.append(
                {
                    "sample": name,
                    "mean": float(vals.mean()) if vals.size else 0.0,
                    "p50": float(np.median(vals)) if vals.size else 0.0,
                    "frac_gt_0.5": float((vals > 0.5).mean()) if vals.size else 0.0,
                }
            )
            # per-part mean probabilities (heatmap row; ref :900-1050)
            row = np.zeros(P, np.float32)
            for p in range(P):
                if pv[s, p] and mask[s, p].any():
                    row[p] = float(prob[s, p][mask[s, p]].mean())
            self.part_means.append((name, row))
            # overlap-colored merged cloud ("pair cloud", ref :1100-1301)
            if len(self._pair_clouds) < self.max_pair_clouds:
                merged = np.concatenate(
                    [pts[s, p][mask[s, p]] for p in range(P) if pv[s, p]]
                ) if pv[s].any() else np.zeros((0, 3))
                probs = np.concatenate(
                    [prob[s, p][mask[s, p]] for p in range(P) if pv[s, p]]
                ) if pv[s].any() else np.zeros(0)
                self._pair_clouds.append((name, merged, probs))

    def finalize(self) -> Path:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        self.output_dir.mkdir(parents=True, exist_ok=True)
        csv = self.output_dir / "overlap_summary.csv"
        with open(csv, "w") as f:
            f.write("sample,mean,p50,frac_gt_0.5\n")
            for r in self.rows:
                f.write(f"{r['sample']},{r['mean']:.4f},{r['p50']:.4f},{r['frac_gt_0.5']:.4f}\n")
        if self.rows:
            fig, ax = plt.subplots(figsize=(6, 4))
            ax.hist([r["mean"] for r in self.rows], bins=30)
            ax.set_xlabel("mean overlap probability")
            ax.set_ylabel("#samples")
            fig.savefig(self.output_dir / "overlap_hist.png", dpi=100)
            plt.close(fig)
        if self.part_means:
            # samples x parts heatmap of mean overlap probability
            mat = np.stack([r for _, r in self.part_means])
            fig, ax = plt.subplots(
                figsize=(max(4, mat.shape[1] * 0.5), max(3, mat.shape[0] * 0.25))
            )
            im = ax.imshow(mat, aspect="auto", cmap="viridis", vmin=0, vmax=1)
            ax.set_xlabel("part")
            ax.set_ylabel("sample")
            fig.colorbar(im, ax=ax, label="mean overlap prob")
            fig.tight_layout()
            fig.savefig(self.output_dir / "overlap_heatmap.png", dpi=100)
            plt.close(fig)
        for name, merged, probs in self._pair_clouds:
            if not len(merged):
                continue
            img = R.render_point_cloud(
                merged, R.prob_to_colors(probs), title=f"{name} overlap"
            )
            R.save_image(self.output_dir / f"{name}_overlap_cloud.png", img)
        return csv
