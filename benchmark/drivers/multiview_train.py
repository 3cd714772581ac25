"""Multi-view training: the program's train step
(``rap_tpu_torch.train.step.make_train_step``: the loss, its gradient
through the kernels with remat, Muon) fed by its ``BatchLoader``
(shuffle, the configuration's token budget) over a split that set-up
writes under ``TMPDIR``.

Set-up writes ``samples`` samples of 5-8 views (the scene generator), makes
the weights on the card from the seed, builds the train state, and drives
it through its first ``checked_steps`` steps by the window's own call and
feed (those are the steps the check compares, and the warm-up: every batch
has the packer's one shape). It keeps each step's loss, each leaf's
gradient as the optimizer took it, clipped (its state after the first
step: Muon's momentum, AdamW's first moment over 1 - beta1) and each
leaf's change after the last. The window goes on stepping the same state over the
loader's epochs; a step counts its batch's valid points, the wait on the
loader, and reads the loss back every ``log_every_n_steps`` steps.

The check works the same steps out again with the plain float32
reference from the split on disk, the seed-made weights and the seeds:
the loss and the mean predicted-velocity norm of each step, and by the
worst leaf (and the median leaf) the gap between the program's and the
reference's norms of the first gradient and of the change, over the
reference's norm of that leaf or of the median leaf, whichever is larger.
Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of the gradient and change. ``BENCHMARK.json`` does
not list this cell yet: no number separates the float8 control from the
program by the margin its limits need (PERF.md §6, §7).
"""

from __future__ import annotations

import shutil
import tempfile
from pathlib import Path

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import model_init, work
from benchmark.reference import data as ref_data
from benchmark.reference import dit as ref_dit
from benchmark.reference import train as ref_train
from benchmark.traffic import scenes

TINY_GRAD = 1e-3  # of the median leaf's reference gradient norm


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


class Cell:
    def __init__(self, ctx):
        from rap_tpu_torch.data import BatchLoader, DatasetConfig, LoaderConfig, PointCloudDataset
        from rap_tpu_torch.models.config import DiTConfig
        from rap_tpu_torch.registration import RPFConfig
        from rap_tpu_torch.train.optim import OptimizerConfig
        from rap_tpu_torch.train.step import TrainState, make_train_step

        self.ctx = ctx
        m, tr, p = ctx.config["model"], ctx.config["training"], ctx.params
        self.model, self.training = m, tr
        dev = self.device = ctx.device
        seed = ctx.seed
        self.loader_seed = model_init.derive_seed(seed, 0x10AD) % 2**31
        self.dataset_seed = model_init.derive_seed(seed, 0xDA7A) % 2**31
        self.state_seed = model_init.derive_seed(seed, 0x57A7)
        self.root = Path(tempfile.mkdtemp(prefix="rap_bench_split_"))
        rng = np.random.default_rng(np.random.SeedSequence([seed, 0x5911]))
        scenes.write_split(self.root, rng, p["samples"], p["views"], p["points_per_view"],
                           p["scene_points"], m["local_feat_dim"])
        self.part_sizes = {n: [len(scenes.read_ply(f)) for f in sorted((self.root / n).glob("*.ply"))]
                           for n in ref_data.split_names(self.root)}
        cfg = DiTConfig(embed_dim=m["embed_dim"], num_layers=m["num_layers"],
                        num_heads=m["num_heads"], local_feat_dim=m["local_feat_dim"],
                        multires=m["multires"], scale_emb_on=m["scale_emb_on"],
                        local_feat_concat_on=True, qk_norm=m["qk_norm"], softcap=m["softcap"],
                        time_embed_channels=m["time_embed_channels"],
                        compute_dtype=_dtype(m["compute_dtype"]))
        rcfg = RPFConfig(model=cfg, loss_type=tr["loss_type"],
                         timestep_sampling=tr["timestep_sampling"])
        o = tr["optimizer"]
        self.opt = o
        opt_cfg = OptimizerConfig(name=o["name"], lr=o["lr"], muon_lr_mult=o["muon_lr_mult"],
                                  muon_weight_decay=o["muon_weight_decay"],
                                  muon_wd_mult=o["muon_wd_mult"],
                                  muon_momentum=o["muon_momentum"],
                                  muon_betas=tuple(o["muon_betas"]), eps=o["eps"],
                                  grad_clip=o["grad_clip"],
                                  lr_milestones=tuple(o["lr_milestones"]),
                                  lr_gamma=o["lr_gamma"])
        ds = PointCloudDataset(DatasetConfig(data_path=str(self.root), dataset_name="bench",
                                             split="train", seed=self.dataset_seed,
                                             feat_dim=m["local_feat_dim"]))
        self.loader = BatchLoader([ds], LoaderConfig(
            max_points_per_batch=tr["max_points_per_batch"], shuffle=True,
            seed=self.loader_seed), device=dev)
        self.params = model_init.make_params(m, seed, dev)  # the benchmark's, never stepped
        self.state = TrainState.create(self.params, opt_cfg, seed=self.state_seed, device=dev)
        self.step_fn = make_train_step(rcfg, opt_cfg, remat=tr["remat"], device=dev,
                                       steps_per_epoch=max(self.loader.num_batches(0), 1))
        self.epoch, self.steps = 0, 0
        self.batches = self.loader.epoch(0)
        self.shape = work.Shape.of(m)
        self.matrices = [tuple(v.shape) for _, v in ref_train.paths(self.params)
                         if ref_train.is_matrix(_, v)]
        self.unit_parts: dict[int, list[list[int]]] = {}
        self.window: list[dict] = []
        self.ref = None  # the reference's results, once worked out

    # ------------------------------------------------------------------ steps
    def _next_batch(self):
        item = next(self.batches, None)
        if item is None:
            self.batches.close()
            self.epoch += 1
            self.batches = self.loader.epoch(self.epoch)
            item = next(self.batches)
        return item

    def _step(self) -> dict:
        t0 = self.ctx.clock()
        with record_function("bench.next_batch"):
            batch, names, _ = self._next_batch()
        t1 = self.ctx.clock()
        with record_function("bench.train_step"):
            self.state, metrics = self.step_fn(self.state, batch)
        self.steps += 1
        loss = None
        if self.steps % self.training["log_every_n_steps"] == 0:
            with record_function("bench.read_loss"):
                loss = float(metrics["loss"])
        parts = [self.part_sizes[n] for n in names if n in self.part_sizes]
        valid = sum(map(sum, parts))
        return {"points": valid, "slots": batch.num_tokens, "load_wait_s": t1 - t0,
                "parts": parts, "metrics": metrics, "loss": loss}

    def unit(self, i: int) -> dict:
        rec = self._step()
        self.unit_parts[i] = rec.pop("parts")
        rec.pop("metrics")
        self.window.append(rec)
        return rec

    def warmup(self) -> None:
        """The checked steps: losses, the first gradient, the change."""
        from rap_tpu_torch.train.optim import tree_paths

        self.losses, self.vnorms, self.grad_norms = [], [], {}
        for k in range(self.ctx.params["checked_steps"]):
            rec = self._step()
            self.losses.append(float(rec["metrics"]["loss"]))
            self.vnorms.append(float(rec["metrics"]["norm_v_pred"]))
            if k == 0:
                # the (clipped) gradient the optimizer took, from its state:
                # Muon's momentum, AdamW's first moment over 1 - beta1
                b1 = self.opt["muon_betas"][0]
                st = self.state.opt_state
                for path, _ in tree_paths(self.state.params):
                    g = st["momentum"][path] if path in st["momentum"] \
                        else st["mu"][path] / (1.0 - b1)
                    self.grad_norms[path] = float(g.float().norm())
        p0 = dict(ref_train.paths(self.params))
        self.change_norms = {path: float((v - p0[path]).norm())
                             for path, v in tree_paths(self.state.params)}

    def work_of(self, i: int) -> dict:
        parts = self.unit_parts[i]
        fwd = work.dit_forward(self.shape, parts)
        att = work.Work()
        att += fwd.attention
        att += work.dit_backward_attention(self.shape, parts)
        gemm = work.Work()
        gemm += fwd.linear.scaled(3.0)        # forward, and the backward's two products
        gemm += fwd.small_linear.scaled(3.0)
        for rows, cols in self.matrices:
            gemm += work.newton_schulz(rows, cols)
        return {"attention": att, "gemm": gemm, "model_flops": 3.0 * fwd.flops}

    def counters(self) -> dict:
        w = self.window
        if not w:
            return {}
        valid, slots = sum(r["points"] for r in w), sum(r["slots"] for r in w)
        return {"padding_waste": (slots - valid) / slots,
                "load_wait_ms": 1e3 * float(np.mean([r["load_wait_s"] for r in w]))}

    def end_window(self) -> None:
        self.batches.close()

    def free_program(self) -> None:
        self.state = self.step_fn = self.loader = self.batches = None

    # ------------------------------------------------------------------ check
    def reference_run(self, prec=ref_dit.FP32, keep_samples=None) -> dict:
        o = self.opt
        cfg = ref_train.OptimizerConfig(
            lr=o["lr"], muon_lr_mult=o["muon_lr_mult"], muon_weight_decay=o["muon_weight_decay"],
            muon_wd_mult=o["muon_wd_mult"], muon_momentum=o["muon_momentum"],
            muon_betas=tuple(o["muon_betas"]), eps=o["eps"], grad_clip=o["grad_clip"])
        batches = ref_data.epoch_batches(self.root, self.loader_seed, self.dataset_seed,
                                         self.training["max_points_per_batch"], 0, self.device,
                                         self.ctx.params["checked_steps"])
        return ref_train.run_steps(self.params, self.model, batches, self.state_seed, cfg, prec,
                                   keep_samples)

    def compare(self, losses, vnorms, grad_norms, change_norms, ref) -> list[tuple[str, float]]:
        """The numbers the check can compare, and ``self.detail``: the
        leaves that read worst."""
        p0 = dict(ref_train.paths(self.params))
        g_ref = {k: float(g.norm()) for k, g in ref["first_grad"].items()}
        d_ref = {k: float((v - p0[k]).norm()) for k, v in ref["params"].items()}
        g_med = float(np.median(list(g_ref.values())))
        keep = [k for k, v in g_ref.items() if v >= TINY_GRAD * g_med]
        d_med = float(np.median([d_ref[k] for k in keep]))
        steps = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
        vsteps = [abs(a - b) / abs(b) for a, b in zip(vnorms, ref["vnorms"])]
        grad = {k: abs(grad_norms[k] - g_ref[k]) / max(g_ref[k], g_med) for k in keep}
        change = {k: abs(change_norms[k] - d_ref[k]) / max(d_ref[k], d_med) for k in keep}
        worst = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:3]  # noqa: E731
        self.detail = {"loss_steps": steps, "grad_worst": worst(grad),
                       "change_worst": worst(change), "left_out": len(g_ref) - len(keep)}
        return [("loss", max(steps)), ("vnorm", max(vsteps)), ("grad", max(grad.values())),
                ("grad_median", float(np.median(list(grad.values())))),
                ("change", max(change.values())),
                ("change_median", float(np.median(list(change.values()))))]

    def check(self, done: list[int]) -> list[tuple[str, float]]:
        if self.ref is None:
            self.ref = self.reference_run()
        return self.compare(self.losses, self.vnorms, self.grad_norms, self.change_norms,
                            self.ref)

    def control(self, done: list[int]) -> list[tuple[str, float]]:
        """The numbers of the reference at float8 products in the program's place."""
        if self.ref is None:
            self.ref = self.reference_run()
        low = self.reference_run(ref_dit.FP8)
        p0 = dict(ref_train.paths(self.params))
        return self.compare(low["losses"], low["vnorms"],
                            {k: float(g.norm()) for k, g in low["first_grad"].items()},
                            {k: float((v - p0[k]).norm()) for k, v in low["params"].items()},
                            self.ref)

    def share_reference(self, other: "Cell") -> None:
        """Take ``other``'s reference results (the same seed and sizes)."""
        self.ref = other.ref

    def close(self) -> None:
        """Remove the split set-up wrote."""
        shutil.rmtree(self.root, ignore_errors=True)


def make(ctx) -> Cell:
    return Cell(ctx)
