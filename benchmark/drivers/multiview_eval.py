"""Multi-view evaluation under RAP's published protocol: a closed loop with
one client over the program's batch-evaluation entry point
(``rap_tpu_torch.apps.sample.run_eval``), one unit a whole epoch.

Set-up writes the scenes once, under ``TMPDIR``: one scene a count of
``views``, drawn from the seed (each view 1024-4096 points, ``write_scenes``;
32-d geometric features beside each part), a validation split with its
point counts, in the layout the program's dataset reads. It makes the weights on the card
from the seed and the configuration as a user's ``-o`` overrides make it
(``load_config``): the model, the configuration's ``evaluation`` block (its
steps, generations, rigidity forcing and points a batch; its part range on
the dataset, the published script's dataset keys), results not saved. Then
it warms up one whole epoch, so every batch shape the packer makes is
compiled. An epoch is one ``run_eval``: the loader packs the scenes into
its batches, and every batch gets every generation, the pose fit, the
metrics and their aggregation. Its noise is seeded from the run's seed and
the epoch's number (``trainer.seed``); its printed tables go to standard
error. A unit counts the valid points of the scenes, each scene once.

The check compares every generation of every batch of the first timed
epoch with the plain float32 reference (``reference/evaluate.py``), scene
by scene and unpadded, each scene read back from its files and given the
noise ``run_eval`` drew for its slots (``seeded_generator``, redrawn):
the points, each part's pose and translation, as ``pairs_serve.py``
defines the numbers (its request's medians here a generation's over the
epoch's scenes), over valid points and parts only, each distance over its
scene's extent. The evaluator's per-sample metrics and the
rigidity-selected generation are compared too, for the record.
"""

from __future__ import annotations

import contextlib
import dataclasses
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from benchmark import model_init, work
from benchmark.reference import dit as ref_dit
from benchmark.reference import evaluate as ref_eval
from benchmark.traffic import scenes

WARMUP_EPOCH = 10**9  # an epoch number the window never uses


def write_scenes(root: Path, rng: np.random.Generator, views, points_per_view,
                 scene_points: int, feat_dim: int) -> dict[str, list[int]]:
    """One scene a count of ``views`` under ``root`` as a validation split
    (``data_split/{val,train}.txt`` and ``num_points/val.txt``, the layout of
    ``scenes.write_split``). A scene of n views takes n sizes evenly spaced
    over the ``points_per_view`` range, dealt to its views in an order drawn
    from ``rng``: every seed carries the same points and the same padded
    shapes (a draw per view would move an epoch's points by ~7%, past what
    the runs' spread allows). Returns each scene's part sizes by name."""
    lo, hi = points_per_view
    sizes = {}
    for i, n_views in enumerate(views):
        counts = rng.permutation(np.linspace(lo, hi, n_views).round().astype(int))
        parts = scenes.scene_views(rng, n_views, hi, scene_points, exact=True)
        parts = [v[:c] for v, c in zip(parts, counts)]  # the views' points come shuffled
        name = f"scene_{i:02d}_{n_views:02d}views"
        d = root / name
        d.mkdir(parents=True)
        for p, v in enumerate(parts):
            scenes.write_ply(d / f"part_{p:02d}.ply", v)
            np.save(d / f"features_part_{p:02d}.npy", scenes.compute_geometric_features(
                v.astype(np.float32).astype(np.float64), feat_dim=feat_dim))
        sizes[name] = [len(v) for v in parts]
    (root / "data_split").mkdir()
    (root / "num_points").mkdir()
    listing = "\n".join(sizes) + "\n"
    (root / "data_split" / "val.txt").write_text(listing)
    (root / "data_split" / "train.txt").write_text(listing)
    (root / "num_points" / "val.txt").write_text(
        "\n".join(str(sum(s)) for s in sizes.values()) + "\n")
    return sizes


class Cell:
    def __init__(self, ctx):
        from rap_tpu_torch.config import load_config
        from rap_tpu_torch.models.dit import attach_bounds

        self.ctx = ctx
        m, ev, p = ctx.config["model"], ctx.config["evaluation"], ctx.params
        self.model, self.steps, self.gens = m, ev["steps"], ev["n_generations"]
        dev = self.device = ctx.device
        self.root = Path(tempfile.mkdtemp(prefix="rap_bench_eval_"))
        rng = np.random.default_rng(np.random.SeedSequence([ctx.seed, 0xE7A1]))
        self.sizes = write_scenes(self.root, rng, p["views"], p["points_per_view"],
                                  p["scene_points"], m["local_feat_dim"])
        self.names = list(self.sizes)
        self.points = sum(map(sum, self.sizes.values()))
        self.dataset_seed = model_init.derive_seed(ctx.seed, 0xDA7A) % 2**31
        dataset = {"data_path": str(self.root), "dataset_name": "bench", "split": "val",
                   "use_random_split": True, "min_parts": ev["parts"][0],
                   "max_parts": ev["parts"][1], "feat_dim": m["local_feat_dim"],
                   "seed": self.dataset_seed}
        model_keys = ("embed_dim", "num_layers", "num_heads", "local_feat_dim", "multires",
                      "scale_emb_on", "local_feat_concat_on", "qk_norm", "softcap",
                      "time_embed_channels", "compute_dtype")
        self.cfg = load_config(None, [f"model_name={ctx.config['name']}"]
                               + [f"model.{k}={m[k]}" for k in model_keys] + [
            f"pipeline.inference_sampling_steps={self.steps}",
            f"pipeline.n_generations={self.gens}",
            f"pipeline.rigidity_forcing={str(ev['rigidity_forcing']).lower()}",
            f"data.max_points_per_batch={ev['max_points_per_batch']}",
            f"data.datasets=[{dataset!r}]",
            "eval.save_results=false"])
        self.weights = attach_bounds(model_init.served(model_init.make_params(m, ctx.seed, dev),
                                                       self.cfg.model.compute_dtype))
        self.shape = work.Shape.of(m)
        self.window: list[dict] = []
        self.batch_names: list[list[str]] = []
        self.kept: tuple[int, dict] | None = None  # the first timed epoch's record
        self._ref: dict | None = None

    def epoch_seed(self, i: int) -> int:
        return model_init.derive_seed(self.ctx.seed, 0xE90C, i)

    def _epoch(self, i: int) -> dict:
        from rap_tpu_torch.apps.sample import run_eval

        rec: dict = {}
        cfg = dataclasses.replace(self.cfg, trainer=dataclasses.replace(
            self.cfg.trainer, seed=self.epoch_seed(i)))
        with contextlib.redirect_stdout(sys.stderr):
            run_eval(cfg, params=self.weights, device=self.device, record=rec)
        return rec

    def unit(self, i: int) -> dict:
        """One epoch, synchronous: every batch, generation and metric done."""
        t0 = self.ctx.clock()
        rec = self._epoch(i)
        seconds = self.ctx.clock() - t0
        self.batch_names = [list(names) for names, _ in rec["outputs"]]
        if self.kept is None:
            self.kept = (i, rec)
        out = {"points": self.points, "seconds": seconds, "load_ms": rec["load_ms"],
               "post_ms": sum(rec["post_ms"])}
        self.window.append(out)
        return out

    def warmup(self) -> None:
        self._epoch(WARMUP_EPOCH)

    def work_of(self, i: int) -> dict:
        att = work.Work()
        for names in self.batch_names:
            parts = [self.sizes[n] for n in names if n in self.sizes]
            att += work.dit_forward(self.shape, parts).attention
        return {"attention": att.scaled(self.steps * self.gens)}

    def counters(self) -> dict:
        w = self.window
        if not w:
            return {}
        return {"post_pct": 100.0 * sum(r["post_ms"] for r in w)
                / (1e3 * sum(r["seconds"] for r in w)),
                "load_wait_ms": float(np.mean([ms for r in w for ms in r["load_ms"]]))}

    def end_window(self) -> None:
        pass

    def free_program(self) -> None:
        pass

    def close(self) -> None:
        """Remove the scenes set-up wrote."""
        shutil.rmtree(self.root, ignore_errors=True)

    # ------------------------------------------------------------------ check
    def noise(self, epoch: int, b: int, g: int, shape) -> torch.Tensor:
        """The noise ``run_eval`` drew for generation ``g`` of batch ``b``."""
        from rap_tpu_torch.registration import seeded_generator

        gen = seeded_generator(self.device, self.epoch_seed(epoch), b, g)
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=self.device)

    def scenes_of(self, rec: dict):
        """(name, batch, slot, its parts' rows) of every scene of the epoch."""
        for b, (names, gens) in enumerate(rec["outputs"]):
            P = gens[0][0].shape[0] // len(names)
            for s, name in enumerate(names):
                if name in self.sizes:
                    yield name, b, s, slice(s * P, s * P + len(self.sizes[name]))

    def reference(self, prec=ref_dit.FP32) -> dict:
        """{scene name: the reference's protocol} on the kept epoch's noise."""
        if prec == ref_dit.FP32 and self._ref is not None:
            return self._ref
        epoch, rec = self.kept
        out = {}
        for name, b, _, rows in self.scenes_of(rec):
            scene = ref_eval.load_scene(self.root, name, self.names.index(name),
                                        self.dataset_seed)
            shape = tuple(rec["outputs"][b][1][0][0].shape)
            n = max(self.sizes[name])
            noises = [self.noise(epoch, b, g, shape)[rows, :n] for g in range(self.gens)]
            out[name] = ref_eval.evaluate_scene(self.weights, self.model, scene, noises,
                                                self.steps, prec, self.device)
        if prec == ref_dit.FP32:
            self._ref = out
        return out

    def program(self) -> dict:
        """{scene name: [(points (P, N, 3), R, t) per generation]} of the
        kept epoch, each part's valid points at the front of its row, the
        program's per-sample metrics and its rigidity-selected generation."""
        _, rec = self.kept
        out = {}
        for name, b, s, rows in self.scenes_of(rec):
            n = max(self.sizes[name])
            out[name] = {"generations": [(pts[rows, :n], R[rows], t[rows])
                                         for pts, R, t in rec["outputs"][b][1]]}
            if "metrics" in rec:  # a program whose run_eval records them
                gen_metrics, agg = rec["metrics"][b]
                out[name]["metrics"] = [{k: float(v[s]) for k, v in md.items()}
                                        for md in gen_metrics]
                out[name]["selected"] = int(agg["rigidity_selected_gen"][s])
        return out

    def compare(self, got: dict, ref: dict) -> list[tuple[str, float]]:
        """(name, value) of numbers over the epoch's scenes, each distance
        over its scene's extent (max|points| of the reference's generation):
        the largest point distance; per generation the median distance over
        the epoch's valid points, and the same median for the condition
        points posed by the two poses, each the largest over the
        generations (a request's median in ``pairs_serve.py``; the median of
        one scene alone, ``points_median_scene``, is kept for the record: a
        random network leaves a part's fit ill-conditioned now and then,
        and in a scene of two parts that part is half the points); the
        largest translation gap of a part; the largest and the mean rotation
        angle; for the record, the largest relative gap of a per-sample
        metric and the scenes whose rigidity-selected generation differs.
        The workload file's ``checks`` name those compared."""
        pe, sm, te, ra, mg, sel = [], [], [], [], [], 0
        pooled: dict[int, list] = {}
        for name, r in ref.items():
            batch = ref_eval.scene_batch(ref_eval.load_scene(
                self.root, name, self.names.index(name), self.dataset_seed), self.device)
            mask, cond = batch["point_mask"], batch["points"]
            for g, ((pts, R, t), (pts_r, R_r, t_r, _)) in enumerate(zip(
                    got[name]["generations"], r["generations"])):
                ext = float(pts_r[mask].abs().max())
                d = (pts.to(pts_r.device) - pts_r)[mask]
                R, t = R.to(R_r.device).double(), t.to(t_r.device).double()
                posed = ref_eval.sampler.transform(R, t, cond)[mask]
                posed_r = ref_eval.sampler.transform(R_r.double(), t_r.double(), cond)[mask]
                dist = d.norm(dim=-1) / ext
                pooled.setdefault(g, []).append(
                    (dist, (posed - posed_r).norm(dim=-1).float() / ext))
                pe.append(float(d.abs().max()) / ext)
                sm.append(float(dist.median()))
                te.append(float((t - t_r.double()).abs().max()) / ext)
                ra += rotation_deg(R, R_r).tolist()
            for mine, theirs in zip(got[name].get("metrics", []), r["generations"]):
                mg += [abs(mine[k] - v) / max(abs(v), 1e-6) for k, v in theirs[3].items()
                       if not k.startswith(("recall", "rigidity"))]
            if "selected" in got[name]:
                sel += got[name]["selected"] != r["selected"]
        if not pe:
            return []
        med = [[float(torch.cat(col).median()) for col in zip(*pairs)]
               for pairs in pooled.values()]
        out = [("points", max(pe)), ("points_median", max(m[0] for m in med)),
               ("poses_median", max(m[1] for m in med)), ("points_median_scene", max(sm)),
               ("translation", max(te)), ("rotation_deg", max(ra)),
               ("rotation_mean_deg", float(np.mean(ra)))]
        if mg:
            out += [("metrics_gap", max(mg)), ("selection_differs", float(sel))]
        return out

    def check(self, done: list[int]) -> list[tuple[str, float]]:
        if self.kept is None or self.kept[0] not in done:
            return []
        return self.compare(self.program(), self.reference())

    def control(self, done: list[int]) -> list[tuple[str, float]]:
        """The numbers of the reference at float8 products in the program's place."""
        ref = self.reference()
        low = self.reference(ref_dit.FP8)
        got = {name: {"generations": [g[:3] for g in r["generations"]]}
               for name, r in low.items()}
        return self.compare(got, ref)

    def share_reference(self, other: "Cell") -> None:
        """Take ``other``'s reference results (the same seed and sizes)."""
        self._ref = other._ref


def rotation_deg(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """Geodesic angle in degrees between rotations (..., 3, 3), float64."""
    tr = (Ra.double().transpose(-1, -2) @ Rb.double()).diagonal(dim1=-2, dim2=-1).sum(-1)
    return torch.rad2deg(torch.arccos(((tr - 1.0) / 2.0).clamp(-1.0, 1.0)))


def make(ctx) -> Cell:
    return Cell(ctx)
