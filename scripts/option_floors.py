#!/usr/bin/env python3
"""The bf16 floor of the qk gains' gradients under the training options, on one card.

    python3 scripts/option_floors.py

chip_smoke.py holds each gradient leaf of a training forward through the
kernels to the plain versions within max(5e-2, 2x the plain bf16 path's
distance from the plain fp32 path), and fails a leaf whose distance from
fp32 (its bf16 floor) passes 0.1: there the check cannot see a kernel
fault. The qk gains' gradients have the highest floors. This script prints,
at 2 layers of rap_12's width, for the training options off, the pose loss
(weight 0.1), FF dropout (0.1) and both, each qk gain's floor and its
kernels-vs-plain distance (relative L2), on two batches of 2 x 8 x 4096
slots: the multiview phase's synthetic one and the first batch apps.train's
loader makes of the trainer phase's scans. The last line is one JSON
object with every number and the card's name and power limit.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    if not torch.cuda.is_available():
        print("option_floors: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from rap_tpu_torch.core.batch import make_regular_synthetic_batch
    from rap_tpu_torch.data import BatchLoader, DatasetConfig, LoaderConfig, PointCloudDataset
    from rap_tpu_torch.models.config import MODEL_ZOO
    from rap_tpu_torch.models.dit import init_dit_params
    from rap_tpu_torch.ops import _build
    from rap_tpu_torch.registration import RPFConfig

    _build.load()
    data = cs.write_trainer_data(ROOT / "rap_tpu_torch" / "build" / "trainer_data")
    loader = BatchLoader([PointCloudDataset(DatasetConfig(data_path=str(data),
                                                          dataset_name="scans", split="train"))],
                         LoaderConfig(max_points_per_batch=80_000, shuffle=True, seed=42))
    batches = {"multiview": make_regular_synthetic_batch(
        cs.MV_SEED, cs.multiview_parts(), N=cs.MV_N, P=cs.MV_P, S=cs.MV_S, device="cuda"),
        "trainer": next(iter(loader.epoch(0)))[0]}
    base = dataclasses.replace(MODEL_ZOO["rap_12"], num_layers=2)
    params = init_dit_params(0, base, device="cuda", masters=True)
    out = {}
    for bname, batch in batches.items():
        for label, pose, drop in (("none", 0.0, 0.0), ("pose", 0.1, 0.0),
                                  ("dropout", 0.0, 0.1), ("both", 0.1, 0.1)):
            cfg = RPFConfig(model=dataclasses.replace(base, dropout_rate=drop),
                            pose_loss_weight=pose)
            plain = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                                       use_kernels=False))
            fp32 = dataclasses.replace(plain, model=dataclasses.replace(
                plain.model, compute_dtype=torch.float32))
            (_, gk), (_, gp), (_, g32) = (cs.train_grads(params, c, batch)
                                          for c in (cfg, plain, fp32))
            row = {k: {"floor": cs.rel_l2(gp[k], g32[k]), "kernels": cs.rel_l2(gk[k], gp[k])}
                   for k in gp if k.endswith("_gamma")}
            out[f"{bname} {label}"] = row
            worst = max(row.items(), key=lambda kv: kv[1]["floor"])
            print(f"{bname:9s} {label:8s} highest floor {worst[0]} {worst[1]['floor']:.4f} "
                  f"(kernels vs plain {worst[1]['kernels']:.4f}); all floors "
                  + " ".join(f"{v['floor']:.3f}" for v in row.values()), flush=True)
    print(cs.nvidia_smi())
    print(json.dumps({"card": cs.nvidia_smi(), "floors": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
