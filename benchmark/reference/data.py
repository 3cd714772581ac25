"""The reference's own way from a split on disk to the training batches:
it reads the part PLYs and feature files, poses each sample as the
program's training augmentation does (the benchmark's frozen copy,
``traffic.scenes.posed_sample``, seeded per sample and epoch) and packs
the epoch's batches by the packer's rule (rap_tpu/data/packer.py:57-119,
loader.py:100-141): a seeded shuffle, a stable sort by the (parts, size)
buckets, greedy batches under the token budget, the batches' order
shuffled. Nothing of the program is imported.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from benchmark.traffic import scenes

N_BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536)
P_BUCKETS = (2, 4, 8, 16, 32, 64, 128, 256, 512)


def bucket(value: int, ladder) -> int:
    return next(b for b in ladder if value <= b)


def split_names(root) -> list[str]:
    return [ln.strip() for ln in (Path(root) / "data_split" / "train.txt").read_text().splitlines()
            if ln.strip()]


def load_sample(root, name: str) -> tuple[list[np.ndarray], list[np.ndarray]]:
    d = Path(root) / name
    plys = sorted(d.glob("*.ply"))
    return ([scenes.read_ply(p).astype(np.float64) for p in plys],
            [np.load(d / f"features_{p.stem}.npy") for p in plys])


def plan(counts: list[int], sizes: list[int], budget: int, seed: int, epoch: int):
    """The epoch's batches as lists of sample indices."""
    n = len(counts)
    order = np.random.default_rng(seed + epoch).permutation(n)
    P_of = [bucket(c, P_BUCKETS) for c in counts]
    N_of = [bucket(max(s, 1), N_BUCKETS) for s in sizes]
    keys = np.array([P_of[i] * 10**9 + N_of[i] for i in order], np.int64)
    order = order[np.argsort(keys, kind="stable")]
    batches, cur, cP, cN = [], [], 0, 0
    for i in order:
        nP, nN = max(cP, P_of[i]), max(cN, N_of[i])
        if cur and (len(cur) + 1) * nP * nN > budget and \
                (len(cur) + 1) * nP * nN != cP * cN * max(len(cur), 1):
            batches.append(cur)
            cur, nP, nN = [], P_of[i], N_of[i]
        cur.append(int(i))
        cP, cN = nP, nN
        if cP * cN * len(cur) >= budget:
            batches.append(cur)
            cur, cP, cN = [], 0, 0
    if cur:
        batches.append(cur)
    perm = np.random.default_rng(np.random.SeedSequence([seed, epoch, 999])).permutation(
        len(batches))
    return [batches[j] for j in perm]


def collate(samples: list[dict], device) -> dict:
    """A padded (S, P, N) batch: P, N the buckets of the largest part count
    and part size; each sample's parts from its first slot on."""
    S = len(samples)
    P = bucket(max(len(s["points"]) for s in samples), P_BUCKETS)
    N = bucket(max(len(p) for s in samples for p in s["points"]), N_BUCKETS)
    F = samples[0]["features"][0].shape[1]
    G = S * P
    arr = {"points": np.zeros((G, N, 3), np.float32), "points_gt": np.zeros((G, N, 3), np.float32),
           "local_feats": np.zeros((G, N, F), np.float32), "point_mask": np.zeros((G, N), bool),
           "anchor_part": np.zeros(G, bool), "scale": np.ones(S, np.float32)}
    for s, smp in enumerate(samples):
        for p in range(len(smp["points"])):
            g, n = s * P + p, len(smp["points"][p])
            arr["points"][g, :n] = smp["points"][p]
            arr["points_gt"][g, :n] = smp["points_gt"][p]
            arr["local_feats"][g, :n] = smp["features"][p]
            arr["point_mask"][g, :n] = True
            arr["anchor_part"][g] = p == smp["anchor"]
        arr["scale"][s] = smp["scale"]
    out = {k: torch.from_numpy(v).to(device) for k, v in arr.items()}
    out["parts_per_sample"] = P
    return out


def epoch_batches(root, seed: int, dataset_seed: int, budget: int, epoch: int, device,
                  count: int):
    """The first ``count`` batches from ``epoch`` on (into the next epochs
    where one runs out), collated on ``device``."""
    names = split_names(root)
    totals = [int(x) for x in (Path(root) / "num_points" / "train.txt").read_text().split()]
    loaded = [load_sample(root, n) for n in names]
    counts = [len(p) for p, _ in loaded]
    sizes = [max(t // max(c, 1), 1) for t, c in zip(totals, counts)]
    out = []
    while len(out) < count:
        for idx in plan(counts, sizes, budget, seed, epoch)[:count - len(out)]:
            samples = []
            for i in idx:
                rng = np.random.default_rng(np.random.SeedSequence([dataset_seed, epoch, i]))
                samples.append(scenes.posed_sample(loaded[i][0], loaded[i][1], rng))
            out.append(collate(samples, device))
        epoch += 1
    return out
