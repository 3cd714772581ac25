"""Per-dataset metric accumulation and the result table (counterpart of
rap_tpu/eval/meter.py: ``MetricsMeter`` and ``print_eval_table``).

Running sums and counts per dataset and metric over valid samples with
finite values, an ``overall`` split, sample counts and part-count ranges.
``reduce_across_hosts`` sums them over the ranks of a torch.distributed
world (stride-mode evaluation); the table is plain text.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np


class MetricsMeter:
    def __init__(self):
        self._sums: dict[str, dict[str, float]] = defaultdict(lambda: defaultdict(float))
        self._counts: dict[str, dict[str, int]] = defaultdict(lambda: defaultdict(int))
        self._samples: dict[str, int] = defaultdict(int)
        self._part_ranges: dict[str, tuple[int, int]] = {}

    def add_metrics(self, dataset_name, metrics: dict, valid, num_parts=None) -> None:
        """Accumulate per-sample metric arrays (S,) under their dataset names
        (one name, or one per sample). ``num_parts`` marks the primary add of
        a batch, which counts its samples and part ranges (meter.py:56-96)."""
        valid = np.asarray(valid, bool)
        S = int(valid.shape[0])
        names = [dataset_name] * S if isinstance(dataset_name, str) else list(dataset_name)
        for key, vals in metrics.items():
            vals = np.asarray(vals, np.float64).reshape(-1)
            for s in range(S):
                if valid[s] and np.isfinite(vals[s]):
                    self._sums[names[s]][key] += float(vals[s])
                    self._counts[names[s]][key] += 1
        if num_parts is None:
            return
        num_parts = np.asarray(num_parts).reshape(-1)
        for s in range(S):
            if valid[s]:
                self._samples[names[s]] += 1
                p = int(num_parts[s])
                lo, hi = self._part_ranges.get(names[s], (p, p))
                self._part_ranges[names[s]] = (min(lo, p), max(hi, p))

    def compute_average(self) -> dict[str, dict[str, float]]:
        """{dataset: {metric: mean}} plus an 'overall' entry."""
        out: dict[str, dict[str, float]] = {}
        total_sums: dict[str, float] = defaultdict(float)
        total_counts: dict[str, int] = defaultdict(int)
        for ds, sums in self._sums.items():
            out[ds] = {}
            for k, sm in sums.items():
                c = self._counts[ds][k]
                out[ds][k] = sm / max(c, 1)
                total_sums[k] += sm
                total_counts[k] += c
        out["overall"] = {k: total_sums[k] / max(total_counts[k], 1) for k in total_sums}
        return out

    def get_sample_counts(self) -> dict[str, int]:
        return dict(self._samples)

    def get_part_count_ranges(self) -> dict[str, tuple[int, int]]:
        return dict(self._part_ranges)

    def reset(self) -> None:
        self.__init__()

    def reduce_across_hosts(self, dataset_registry: list[str]) -> None:
        """Sum the registry's datasets' sums, counts, sample counts and
        part ranges over the ranks (meter.py:111-160), in place on every
        rank; the identity without a joined world of several. The ranks may
        hold different metric keys (a rank may have seen no pair sample, or
        no batch at all): the result has their union. The per-rank state
        crosses as Python objects (``all_gather_object``), so the float64
        sums stay exact (rap_tpu splits them into float32 pairs because its
        gathers run without x64)."""
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
            return
        mine = {ds: (dict(self._sums.get(ds, {})), dict(self._counts.get(ds, {})),
                     self._samples.get(ds, 0), self._part_ranges.get(ds))
                for ds in dataset_registry}
        gathered: list = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, mine)
        self.reset()
        for rank_state in gathered:
            for ds, (sums, counts, samples, part_range) in rank_state.items():
                for k, v in sums.items():
                    self._sums[ds][k] += v
                    self._counts[ds][k] += counts[k]
                if samples:
                    self._samples[ds] += samples
                if part_range is not None:
                    lo, hi = self._part_ranges.get(ds, part_range)
                    self._part_ranges[ds] = (min(lo, part_range[0]), max(hi, part_range[1]))


def print_eval_table(sections: dict[str, dict[str, dict[str, float]]],
                     sample_counts: dict[str, int] | None = None,
                     part_ranges: dict[str, tuple[int, int]] | None = None) -> None:
    """Print plain-text tables, one per section ({section: {dataset:
    {metric: value}}}): a metric per row, a dataset per column."""
    lines = []
    for sec, per_ds in sections.items():
        datasets = list(per_ds)
        metric_keys = sorted({k for md in per_ds.values() for k in md})
        labels = []
        for ds in datasets:
            label = ds
            if sample_counts and ds in sample_counts:
                label += f" (n={sample_counts[ds]})"
            if part_ranges and ds in part_ranges:
                lo, hi = part_ranges[ds]
                label += f" [{lo}-{hi}p]"
            labels.append(label)
        width = max([len("metric")] + [len(k) for k in metric_keys])
        cols = [max(len(lb), 10) for lb in labels]
        lines.append(f"Evaluation — {sec}")
        lines.append("  ".join([f"{'metric':<{width}}"]
                               + [f"{lb:>{w}}" for lb, w in zip(labels, cols)]))
        for k in metric_keys:
            cells = []
            for ds, w in zip(datasets, cols):
                v = per_ds[ds].get(k)
                cells.append(f"{'-' if v is None else f'{v:.4f}':>{w}}")
            lines.append("  ".join([f"{k:<{width}}"] + cells))
        lines.append("")
    print("\n".join(lines), flush=True)
