"""Batch loader: datasets -> packed PartBatches with background prefetch
(counterpart of rap_tpu/data/loader.py).

Per epoch (``_epoch_plan``, loader.py:100-141): a plan per dataset
(``plan_batches`` on the num_points size estimates), each dataset first cut
to a random ``max_samples_per_epoch`` of its samples when training caps it
(``np.random.default_rng(SeedSequence([seed, epoch, dataset]))``), packed
after a shuffle seeded ``seed + epoch`` when ``shuffle`` is on, with S
padded to ``s_multiple``; then, with ``shuffle``, the plans of every
dataset in one order from ``SeedSequence([seed, epoch, 999])``. The plan is
host numpy, so it is rap_tpu's to the index. One prefetch thread loads,
augments and collates the batches onto the device while the consumer runs
the previous one. A loaded batch whose true part sizes blow the budget is
split (``_rebucket``), as rap_tpu does in one process. The thread ends when
the epoch ends, and also when the consumer stops early or the generator is
closed: ``epoch()`` joins it before it returns. Each batch it yields bumps
the ``pack.slots`` and ``pack.points`` counters (``telemetry``) by its
padded slots and valid points, on the consumer's thread.

Several processes (``process_index`` of ``process_count``, loader.py:36-160):
every rank computes the same plan. In ``slice`` mode (data-parallel
training) each rank loads its contiguous share of each planned batch's
sample slots (``s_multiple`` must be a multiple of ``process_count``) at
the plan's shapes, never shapes read from its own samples (the ranks must
agree), a part longer than the planned N cut to it (augmentation shuffles
points, so the first N are a uniform subsample), and the batch always
masked (``no_padding`` False, as the ranks of one batch must take one
branch); its ``sample_of_part`` counts from 0 (``parallel/distributed.py``).
In ``stride`` mode (evaluation) rank i takes the whole planned batches
i, i + count, ...
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
from typing import Iterator

import numpy as np

from .. import telemetry
from .dataset import PointCloudDataset, Sample
from .packer import (N_BUCKETS, BatchPlan, _bucket, collate_to_part_batch, pad_to_multiple,
                     plan_batches)

logger = logging.getLogger("rap_tpu_torch.data")


@dataclasses.dataclass(frozen=True)
class LoaderConfig:
    max_points_per_batch: int = 400_000
    shuffle: bool = False
    seed: int = 0
    prefetch: int = 2
    max_samples_per_epoch: int = 0   # per-dataset random cap (0 = all)
    s_multiple: int = 1              # pad each batch's S to a multiple
    process_index: int = 0
    process_count: int = 1
    # "slice": each process loads its contiguous S-slice of the same batch
    # (data-parallel training); "stride": process i takes batches i::count
    # whole (evaluation, metrics reduced by MetricsMeter.reduce_across_hosts)
    shard_mode: str = "slice"


@dataclasses.dataclass
class PaddingStats:
    """Padded-vs-valid token accounting for one epoch."""

    valid_tokens: int = 0
    padded_tokens: int = 0
    batches: int = 0

    @property
    def waste(self) -> float:
        tot = self.valid_tokens + self.padded_tokens
        return self.padded_tokens / tot if tot else 0.0

    def add(self, batch) -> int:
        """Count one batch; returns its valid tokens."""
        valid = int(batch.point_mask.sum())
        self.valid_tokens += valid
        self.padded_tokens += batch.num_tokens - valid
        self.batches += 1
        return valid

    def summary(self) -> str:
        return (f"{self.batches} batches, {self.valid_tokens} valid tokens, "
                f"{self.padded_tokens} padded ({100 * self.waste:.1f}% waste)")


def _truncate_parts(s: Sample, n: int) -> Sample:
    """``s`` with every part cut to its first ``n`` points (loader.py:203-212)."""
    return dataclasses.replace(s, points=[p[:n] for p in s.points],
                               points_gt=[p[:n] for p in s.points_gt],
                               features=[f[:n] for f in s.features])


class BatchLoader:
    """Iterates (PartBatch, names, dataset_name) over one or more datasets,
    the batches on ``device``."""

    def __init__(self, datasets: list[PointCloudDataset], cfg: LoaderConfig,
                 device="cuda"):
        if cfg.shard_mode not in ("slice", "stride"):
            raise ValueError(f"shard_mode must be 'slice' or 'stride', got {cfg.shard_mode!r}")
        if cfg.process_count > 1 and cfg.shard_mode == "slice" \
                and cfg.s_multiple % cfg.process_count:
            raise ValueError(f"slice mode: s_multiple={cfg.s_multiple} must be a multiple of "
                             f"process_count={cfg.process_count}, so every process owns an "
                             "equal S slice")
        self.datasets = datasets
        self.cfg = cfg
        self.device = device
        self.padding_stats = PaddingStats()
        self.last_thread: threading.Thread | None = None

    def _epoch_plan(self, epoch: int) -> list[tuple[int, BatchPlan]]:
        """[(dataset index, plan)] of one epoch (loader.py:100-141)."""
        cfg = self.cfg
        all_plans: list[tuple[int, BatchPlan]] = []
        for d_idx, ds in enumerate(self.datasets):
            rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, epoch, d_idx]))
            indices = np.arange(len(ds))
            if cfg.max_samples_per_epoch and len(indices) > cfg.max_samples_per_epoch:
                indices = rng.choice(indices, cfg.max_samples_per_epoch, replace=False)
            # size estimate: num_points total / parts, else 5000 per part
            counts = [ds.part_counts[i] for i in indices]
            sizes = [max(ds.precomputed_num_points[i] // max(ds.part_counts[i], 1), 1)
                     if ds.precomputed_num_points[i] else 5000 for i in indices]
            for p in plan_batches(counts, sizes, cfg.max_points_per_batch,
                                  shuffle=cfg.shuffle, seed=cfg.seed + epoch,
                                  s_multiple=cfg.s_multiple):
                p.indices = [int(indices[j]) for j in p.indices]
                all_plans.append((d_idx, p))
        if cfg.shuffle:
            rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, epoch, 999]))
            all_plans = [all_plans[i] for i in rng.permutation(len(all_plans))]
        if cfg.shard_mode == "stride" and cfg.process_count > 1:
            all_plans = all_plans[cfg.process_index::cfg.process_count]
        return all_plans

    def num_batches(self, epoch: int = 0) -> int:
        """Planned batches of ``epoch`` (a loaded batch whose true sizes
        blow the budget may still be split at iteration time)."""
        return len(self._epoch_plan(epoch))

    def _load_batch(self, d_idx: int, plan: BatchPlan, epoch: int):
        """[((batch, names, dataset_name), valid tokens)]: one, or more where
        the true part sizes blow the budget (loader.py:213-227)."""
        ds = self.datasets[d_idx]
        cfg = self.cfg
        if cfg.process_count > 1 and cfg.shard_mode == "slice":
            per = plan.S // cfg.process_count
            lo = cfg.process_index * per
            samples = [ds.get(i, epoch=epoch) for i in plan.indices[lo:lo + per]]
            cut = [s.name for s in samples if s.max_part_points > plan.N]
            if cut:
                logger.warning("planned bucket N=%d < the true largest part of %s; cutting "
                               "to fit (slice mode cannot rebucket: the shapes must agree "
                               "across processes)", plan.N, cut[:3])
                samples = [_truncate_parts(s, plan.N) for s in samples]
            batch, names = collate_to_part_batch(samples, plan.N, plan.P, per,
                                                 feat_dim=ds.cfg.feat_dim, device=self.device)
            batch = dataclasses.replace(batch, no_padding=False)
            valid = self.padding_stats.add(batch)
            return [((batch, names, ds.cfg.dataset_name), valid)]
        samples: list[Sample] = [ds.get(i, epoch=epoch) for i in plan.indices]
        out = []
        for group in self._rebucket(samples, plan):
            N = _bucket(max(s.max_part_points for s in group), N_BUCKETS)
            S = pad_to_multiple(len(group), self.cfg.s_multiple)
            batch, names = collate_to_part_batch(group, N, plan.P, S,
                                                 feat_dim=ds.cfg.feat_dim,
                                                 device=self.device)
            valid = self.padding_stats.add(batch)
            out.append(((batch, names, ds.cfg.dataset_name), valid))
        return out

    def _rebucket(self, samples: list[Sample], plan: BatchPlan):
        """Split a loaded batch whose true sizes exceed the token budget."""
        m = self.cfg.s_multiple
        N = _bucket(max(s.max_part_points for s in samples), N_BUCKETS)
        S = pad_to_multiple(len(samples), m)
        if S * plan.P * N <= self.cfg.max_points_per_batch or len(samples) == 1:
            return [samples]
        max_s = max(max(self.cfg.max_points_per_batch // (plan.P * N), 1) // m * m, 1)
        logger.warning("batch of %d samples exceeds token budget at true N=%d "
                       "(estimated sizes were too small); splitting into chunks of %d",
                       len(samples), N, max_s)
        out = []
        for i in range(0, len(samples), max_s):
            g = samples[i:i + max_s]
            out.extend(self._rebucket(g, plan) if len(g) < len(samples) else [g])
        return out

    def epoch(self, epoch: int = 0) -> Iterator:
        """Yield batches with background prefetch. The prefetch thread has
        ended when this generator finishes or is closed."""
        plans = self._epoch_plan(epoch)
        self.padding_stats = PaddingStats()
        if not plans:
            return
        q: queue.Queue = queue.Queue(maxsize=max(self.cfg.prefetch, 1))
        stop = threading.Event()

        def put(item) -> bool:
            # gives up once the consumer is gone, so a full queue cannot pin
            # the thread
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for d_idx, plan in plans:
                    if stop.is_set():
                        return
                    for item in self._load_batch(d_idx, plan, epoch):
                        if not put(item):
                            return
            except Exception as e:  # surface loader errors to the consumer
                put(e)
            finally:
                put(None)

        t = threading.Thread(target=worker, name="rtt-loader", daemon=True)
        self.last_thread = t
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                item, valid = item
                telemetry.bump("pack.slots", item[0].num_tokens)
                telemetry.bump("pack.points", valid)
                yield item
        finally:
            stop.set()
            t.join()
