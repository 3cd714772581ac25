"""Batch packing: variable-size samples -> regular PartBatches (counterpart
of rap_tpu/data/packer.py).

Every batch is a regular (S, P, N) grid: P = the largest part count and
N = the largest part size, each rounded up a ladder of powers of two. The
greedy packer sorts samples by (bucketed parts, bucketed size) and packs
until the padded token count S·P·N would pass the budget (``plan_batches``
:57, in the order rap_tpu's evaluation uses; its shuffle and S padding are
training options and wait for apps/train, ROADMAP A2).
``collate_to_part_batch`` (:122) builds the port's ``PartBatch`` on a
device, with ``no_padding`` as rap_tpu computes it (:202): no padded point
or part.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device
from ..core.batch import PartBatch
from .dataset import Sample

N_BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536)
P_BUCKETS = (2, 4, 8, 16, 32, 64, 128, 256, 512)


def _bucket(value: int, ladder) -> int:
    for b in ladder:
        if value <= b:
            return b
    raise ValueError(f"value {value} exceeds ladder {ladder[-1]}")


@dataclasses.dataclass
class BatchPlan:
    """Indices of the samples in one batch plus its static shape."""

    indices: list[int]
    N: int
    P: int


def plan_batches(
    part_counts: list[int],
    max_part_points: list[int],
    max_points_per_batch: int,
) -> list[BatchPlan]:
    """Greedy shape-aware packing (packer.py:57-119, in rap_tpu's evaluation
    order: no shuffle, S not padded)."""
    P_of = [_bucket(p, P_BUCKETS) for p in part_counts]
    N_of = [_bucket(max(n, 1), N_BUCKETS) for n in max_part_points]
    order = np.argsort(np.array([p * 10**9 + n for p, n in zip(P_of, N_of)], np.int64),
                       kind="stable")

    plans: list[BatchPlan] = []
    cur: list[int] = []
    cur_P = cur_N = 0
    for i in order:
        new_P, new_N = max(cur_P, P_of[i]), max(cur_N, N_of[i])
        new_tokens = (len(cur) + 1) * new_P * new_N
        # flush on overflow unless the padded shape is unchanged
        if cur and new_tokens > max_points_per_batch and new_tokens != cur_P * cur_N * len(cur):
            plans.append(BatchPlan(cur, cur_N, cur_P))
            cur, new_P, new_N = [], P_of[i], N_of[i]
        cur.append(int(i))
        cur_P, cur_N = new_P, new_N
        if cur_P * cur_N * len(cur) >= max_points_per_batch:
            plans.append(BatchPlan(cur, cur_N, cur_P))
            cur, cur_P, cur_N = [], 0, 0
    if cur:
        plans.append(BatchPlan(cur, cur_N, cur_P))
    return plans


def collate_to_part_batch(
    samples: list[Sample],
    N: int,
    P: int,
    feat_dim: int | None = None,
    device="cuda",
) -> tuple[PartBatch, list[str]]:
    """A regular-layout PartBatch on ``device`` from Samples (one sample slot
    each), and the sample names. Parts larger than N are an error."""
    device = resolve_device(device)
    S = len(samples)
    if feat_dim is None:
        feat_dim = samples[0].features[0].shape[1] if samples else 32
    G = S * P
    points = np.zeros((G, N, 3), np.float32)
    points_gt = np.zeros((G, N, 3), np.float32)
    feats = np.zeros((G, N, feat_dim), np.float32)
    mask = np.zeros((G, N), bool)
    part_valid = np.zeros(G, bool)
    anchor = np.zeros(G, bool)
    rots = np.tile(np.eye(3, dtype=np.float32), (G, 1, 1))
    trans = np.zeros((G, 3), np.float32)
    scale = np.ones(S, np.float32)
    sample_valid = np.ones(S, bool)
    g_rot = np.tile(np.eye(3, dtype=np.float32), (S, 1, 1))
    g_trans = np.zeros((S, 3), np.float32)
    names: list[str] = []
    for s, smp in enumerate(samples):
        if smp.num_parts > P:
            raise ValueError(f"sample {smp.name}: {smp.num_parts} parts > P={P}")
        for p in range(smp.num_parts):
            g = s * P + p
            n = len(smp.points[p])
            if n > N:
                raise ValueError(f"part with {n} points exceeds bucket N={N}")
            points[g, :n] = smp.points[p]
            points_gt[g, :n] = smp.points_gt[p]
            f = smp.features[p]
            feats[g, :n, : f.shape[1]] = f[:, :feat_dim]
            mask[g, :n] = True
            part_valid[g] = True
            rots[g] = smp.rotations[p]
            trans[g] = smp.translations[p]
            anchor[g] = p == smp.anchor_idx
        scale[s] = smp.scale
        g_rot[s] = smp.global_rotation
        g_trans[s] = smp.global_translation
        names.append(smp.name)

    arrays = {
        "points": points, "points_gt": points_gt, "local_feats": feats,
        "point_mask": mask, "part_valid": part_valid,
        "sample_of_part": np.repeat(np.arange(S, dtype=np.int64), P),
        "anchor_part": anchor, "rotations_gt": rots, "translations_gt": trans,
        "scale": scale, "sample_valid": sample_valid, "global_rotation": g_rot,
        "global_translation": g_trans,
    }
    no_padding = bool(mask.all() and part_valid.all())
    return PartBatch(**{k: torch.from_numpy(v).to(device) for k, v in arrays.items()},
                     no_padding=no_padding), names

