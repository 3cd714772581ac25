"""Pair serving: a closed loop with one client over the program's
registration entry (``rap_tpu_torch.registration.sample`` without a
trajectory, then ``predict_poses``).

Set-up makes the weights on the card from the seed and a pool of distinct
batches of ``pairs`` pairs x 2 views x ``points`` points (dense, with
32-d geometric features) from the scene generator, pinned on the host. A
request takes the next batch of the pool, uploads its points and features,
draws new noise on the card from (seed, request), samples, fits each part's
pose and reads the poses back: its latency runs from the upload to the
poses on the host.

The check draws ``check_batches`` of the finished requests from the seed
and runs the plain float32 reference over each one's inputs and noise:
the points, each part's rotation and its translation are compared.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import model_init, work
from benchmark.reference import dit as ref_dit
from benchmark.reference import sampler as ref_sampler
from benchmark.traffic import scenes


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}[name]


def make_pool(seed: int, batches: int, pairs: int, points: int, scene_points: int,
              feat_dim: int):
    """``batches`` host batches: dicts of numpy arrays (G = 2 * pairs parts)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x9A1F]))
    pool = []
    for _ in range(batches):
        pts, feats, anchor, scale = [], [], [], []
        for _ in range(pairs):
            views = scenes.scene_views(rng, 2, points, scene_points, exact=True)
            f = [scenes.compute_geometric_features(v, feat_dim=feat_dim) for v in views]
            smp = scenes.posed_sample(views, f, rng)
            pts += smp["points"]
            feats += smp["features"]
            anchor += [i == smp["anchor"] for i in range(2)]
            scale.append(smp["scale"])
        pool.append({"points": np.stack(pts), "local_feats": np.stack(feats),
                     "anchor_part": np.array(anchor), "scale": np.array(scale, np.float32)})
    return pool


class Cell:
    def __init__(self, ctx):
        from rap_tpu_torch.core.batch import PartBatch
        from rap_tpu_torch.models.config import DiTConfig
        from rap_tpu_torch.models.dit import attach_bounds
        from rap_tpu_torch.registration import RPFConfig

        self.ctx = ctx
        m, p = ctx.config["model"], ctx.params
        self.model = m
        dev = self.device = ctx.device
        self.pairs, self.N = p["pairs"], p["points"]
        self.G, self.S, self.P = 2 * self.pairs, self.pairs, 2
        self.steps = ctx.config["inference"]["steps"]
        cfg = DiTConfig(embed_dim=m["embed_dim"], num_layers=m["num_layers"],
                        num_heads=m["num_heads"], local_feat_dim=m["local_feat_dim"],
                        multires=m["multires"], scale_emb_on=m["scale_emb_on"],
                        local_feat_concat_on=True, qk_norm=m["qk_norm"], softcap=m["softcap"],
                        time_embed_channels=m["time_embed_channels"],
                        compute_dtype=_dtype(m["compute_dtype"]))
        self.rcfg = RPFConfig(model=cfg, inference_sampling_steps=self.steps,
                              inference_sampler="euler", inference_schedule="uniform",
                              rigidity_forcing=ctx.config["inference"]["rigidity_forcing"],
                              return_end_point_trajectory=False)
        # the weights as served (the kernels' matrices in the compute dtype);
        # the reference reads the same tensors, the guard bounds the program
        # attaches to them aside
        self.weights = attach_bounds(model_init.served(model_init.make_params(m, ctx.seed, dev),
                                                       cfg.compute_dtype))
        self.pool = make_pool(ctx.seed, p["pool_batches"], self.pairs, self.N, p["scene_points"],
                              m["local_feat_dim"])
        pin = dev.type == "cuda"
        self.host = [{k: (torch.from_numpy(v).pin_memory() if pin else torch.from_numpy(v))
                      for k, v in b.items()} for b in self.pool]
        G, N = self.G, self.N
        eye = torch.eye(3, device=dev)
        self.fixed = dict(
            points_gt=torch.zeros((G, N, 3), device=dev),
            point_mask=torch.ones((G, N), dtype=torch.bool, device=dev),
            part_valid=torch.ones(G, dtype=torch.bool, device=dev),
            sample_of_part=torch.arange(self.S, device=dev).repeat_interleave(self.P),
            rotations_gt=eye.expand(G, 3, 3).contiguous(),
            translations_gt=torch.zeros((G, 3), device=dev),
            sample_valid=torch.ones(self.S, dtype=torch.bool, device=dev),
            global_rotation=eye.expand(self.S, 3, 3).contiguous(),
            global_translation=torch.zeros((self.S, 3), device=dev))
        self.PartBatch = PartBatch
        self.outputs: dict[int, tuple] = {}
        self._ref: dict[int, tuple] = {}
        self.shape = work.Shape.of(m)

    def noise(self, i: int) -> torch.Tensor:
        gen = torch.Generator(device=self.device).manual_seed(
            model_init.derive_seed(self.ctx.seed, 0x0153, i))
        return torch.randn((self.G, self.N, 3), generator=gen, device=self.device)

    def unit(self, i: int) -> dict:
        """One request, synchronous: the batch in, the poses on the host."""
        from rap_tpu_torch import registration

        t0 = self.ctx.clock()
        h = self.host[i % len(self.host)]
        with record_function("bench.upload"):
            up = {k: v.to(self.device, non_blocking=True) for k, v in h.items()}
            batch = self.PartBatch(**up, **self.fixed, no_padding=True)
            x_1 = self.noise(i)
        with record_function("bench.sample"):
            pts = registration.sample(self.weights, self.rcfg, batch, x_1=x_1,
                                      return_trajectory=False)["points"]
        with record_function("bench.poses"):
            R, t = registration.predict_poses(batch, pts)
        with record_function("bench.read_back"):
            R, t = R.cpu(), t.cpu()
        latency = self.ctx.clock() - t0
        self.outputs[i] = (pts, R, t)
        return {"points": self.G * self.N, "latency_s": latency}

    def warmup(self) -> None:
        for i in range(2):  # request numbers the window never uses
            self.unit(10**9 + i)
        self.outputs.clear()

    def work_of(self, i: int) -> dict:
        fwd = work.dit_forward(self.shape, [[self.N] * self.P] * self.S)
        gemm = work.Work()
        gemm += fwd.linear
        gemm += fwd.small_linear
        return {"attention": fwd.attention.scaled(self.steps), "gemm": gemm.scaled(self.steps),
                "model_flops": fwd.flops * self.steps}

    def counters(self) -> dict:
        return {}

    def end_window(self) -> None:
        pass

    def free_program(self) -> None:
        self.host = None

    def close(self) -> None:
        pass

    def control(self, done: list[int]) -> list[tuple[str, float]]:
        """The numbers of the reference at float8 products in the program's place."""
        for i in self.pick(done):
            self.outputs[i] = self.reference(i, ref_dit.FP8)
        return self.check(done)

    def share_reference(self, other: "Cell") -> None:
        """Take ``other``'s reference results (the same seed and sizes)."""
        self._ref = other._ref

    def pick(self, done: list[int]) -> list[int]:
        """The finished requests the check compares, drawn from the seed."""
        rng = np.random.default_rng(np.random.SeedSequence([self.ctx.seed, 0xC4EC]))
        k = min(self.ctx.params["check_batches"], len(done))
        return sorted(rng.choice(np.asarray(done), k, replace=False).tolist()) if k else []

    def reference(self, i: int, prec=ref_dit.FP32):
        """The reference's (points, R, t) for request ``i``: its batch and
        noise, the benchmark's weights, at ``prec`` (float32 kept)."""
        if prec == ref_dit.FP32 and i in self._ref:
            return self._ref[i]
        b = self.pool[i % len(self.pool)]
        batch = {k: torch.from_numpy(v).to(self.device) for k, v in b.items()}
        batch["point_mask"] = torch.ones((self.G, self.N), dtype=torch.bool, device=self.device)
        batch["parts_per_sample"] = self.P
        out = ref_sampler.sample(self.weights, self.model, batch, self.noise(i), self.steps, prec)
        if prec == ref_dit.FP32:
            self._ref[i] = out
        return out

    def check(self, done: list[int]) -> list[tuple[str, float]]:
        """(name, value) of numbers over the picked requests, each distance
        over the scene's extent (max|points| of its batch): the points'
        largest distance from the reference's and the largest over the
        requests of a request's median distance, the same median for the
        condition points posed by the served (R, t) and by the reference's,
        the translations' largest gap, and the largest and the mean angle
        between a part's rotation and the reference's. The workload file's
        ``checks`` name those compared: the numbers whose control readings
        are three times the program's or more (PERF.md §2)."""
        pe, pm, po, te, ra = [], [], [], [], []
        for i in self.pick(done):
            pts_r, R_r, t_r = self.reference(i)
            pts, R, t = self.outputs[i]
            ext = float(pts_r.abs().max())
            d = pts.float() - pts_r
            R, t = R.to(R_r.device), t.to(t_r.device)
            cond = torch.from_numpy(self.pool[i % len(self.pool)]["points"]).to(R_r.device)
            posed = cond @ R.transpose(-1, -2) + t[:, None]
            posed_r = cond @ R_r.transpose(-1, -2) + t_r[:, None]
            pe.append(float(d.abs().max()) / ext)
            pm.append(float(d.norm(dim=-1).median()) / ext)
            po.append(float((posed - posed_r).norm(dim=-1).median()) / ext)
            te.append(float((t - t_r).abs().max()) / ext)
            ra += rotation_deg(R, R_r).tolist()
        if not pe:
            return []
        return [("points", max(pe)), ("points_median", max(pm)), ("poses_median", max(po)),
                ("translation", max(te)), ("rotation_deg", max(ra)),
                ("rotation_mean_deg", float(np.mean(ra)))]


def rotation_deg(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """Geodesic angle in degrees between rotations (..., 3, 3), float64."""
    tr = (Ra.double().transpose(-1, -2) @ Rb.double()).diagonal(dim1=-2, dim2=-1).sum(-1)
    return torch.rad2deg(torch.arccos(((tr - 1.0) / 2.0).clamp(-1.0, 1.0)))


def make(ctx) -> Cell:
    return Cell(ctx)

