"""Feature extraction over processed samples: FPS keypoints and SpinNet
descriptors (counterpart of rap_tpu/dataset_process/extract_features.py).

Per part of a sample: statistical outlier removal, a random cap before FPS
(``pre_fps_cap_mult`` x ``max_points_per_part``), the allocation of
keypoints (``voxel_adaptive``, ``point_count`` or ``spatial_coverage``),
host FPS, then the descriptors of the keypoints with the part's whole
cleaned cloud as context. ``process_dataset_folder`` walks every
``part_*.ply`` sample folder with a per-sample seed and writes the
keypoint PLYs, ``features_*.npy``, the split and num_points files, a
metadata JSON and, optionally, an HDF5 file.

The extractor is a callable ``(cloud, keypoints, des_r) -> (Q, 32)``, e.g.
``spinnet.build_feature_extractor(device=...)``, whose descriptors are
computed on that device (the card by default). Outlier removal finds its
neighbours on the processor's ``device``: without one, the extractor's
device where it names one (``.device``), else the CPU, so a run without
descriptors stays on the host.

rap_tpu degrades any failed extraction to zero descriptors. The port does
so for data faults only (``DATA_FAULTS``: a value, index, arithmetic or
linear-algebra error raised by the data); a ``RuntimeError`` (a CUDA or
launch error, ``torch.AcceleratorError``) propagates. The processor counts
its fallbacks (``fallbacks``; ``process_dataset_folder`` writes them to the
metadata), so a run can show it took none.

    python -m rap_tpu_torch.dataset_process.extract_features \\
        --input <raw sample folders> --output <processed root> \\
        [--spinnet-checkpoint ckpt.pth] [--to-hdf5 out.hdf5] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
import time
from pathlib import Path

import numpy as np

from ..ops import points as P
from ..utils import ply as plyio
from .io import convert_to_hdf5, save_processed_sample, write_metadata
from .splits import make_splits, write_num_points_files, write_split_files

logger = logging.getLogger("rap_tpu_torch.dataset_process")

# what a degenerate part raises; anything else (a RuntimeError from the
# card) is not the data's fault and propagates
DATA_FAULTS = (ValueError, IndexError, ArithmeticError, np.linalg.LinAlgError)


@dataclasses.dataclass(frozen=True)
class SampleProcessorConfig:
    allocation: str = "voxel_adaptive"   # point_count | spatial_coverage | voxel_adaptive
    num_points: int = 8192               # total budget (point_count / spatial_coverage)
    min_points_per_part: int = 200
    max_points_per_part: int = 20_000
    voxel_size: float = 0.4              # allocation voxel (voxel_adaptive)
    voxel_ratio: float = 0.05
    des_r: float = 2.0
    outlier_removal: bool = True
    outlier_neighbors: int = 20
    outlier_std_ratio: float = 2.0
    pre_fps_cap_mult: int = 20           # random cap before FPS
    seed: int = 0


class SampleProcessor:
    """Keypoints and descriptors of one sample's parts (module docstring)."""

    def __init__(self, cfg: SampleProcessorConfig, feature_extractor=None, device=None):
        self.cfg = cfg
        self.feature_extractor = feature_extractor
        self.device = device or getattr(feature_extractor, "device", None) or "cpu"
        self.fallbacks = {"outlier_removal": 0, "features": 0}

    def process_sample(
        self, parts: list[np.ndarray], rng: np.random.Generator
    ) -> tuple[list[np.ndarray], list[np.ndarray] | None]:
        """Per part: outliers -> cap -> allocate -> FPS -> features."""
        cfg = self.cfg
        cleaned = []
        for pts in parts:
            pts = np.asarray(pts, np.float32)
            if cfg.outlier_removal and len(pts) > cfg.outlier_neighbors * 3:
                try:
                    keep = P.statistical_outlier_removal(
                        pts, cfg.outlier_neighbors, cfg.outlier_std_ratio, device=self.device)
                    pts = pts[keep]
                except DATA_FAULTS as e:  # the part stays as it is
                    self.fallbacks["outlier_removal"] += 1
                    logger.warning("outlier removal failed: %s", e)
            cap = cfg.pre_fps_cap_mult * cfg.max_points_per_part
            if len(pts) > cap:
                pts = pts[rng.choice(len(pts), cap, replace=False)]
            cleaned.append(pts)

        if cfg.allocation == "voxel_adaptive":
            targets = P.adaptive_sample_counts(
                cleaned, cfg.voxel_size, cfg.voxel_ratio,
                cfg.min_points_per_part, cfg.max_points_per_part,
            )
        elif cfg.allocation == "point_count":
            targets = P.allocate_by_point_count(
                [len(c) for c in cleaned], cfg.num_points,
                cfg.min_points_per_part, rng,
            ).tolist()
        elif cfg.allocation == "spatial_coverage":
            targets = P.allocate_by_spatial_coverage(
                cleaned, cfg.num_points, cfg.min_points_per_part,
                cfg.voxel_size, rng,
            ).tolist()
        else:
            raise ValueError(f"Unknown allocation: {cfg.allocation}")

        keypoints = []
        for pts, k in zip(cleaned, targets):
            k = int(max(1, min(k, len(pts))))
            idx = P.fps_numpy(pts, k, rng) if len(pts) > k else np.arange(len(pts))
            keypoints.append(pts[idx])

        features = None
        if self.feature_extractor is not None:
            features = []
            for pts, kp in zip(cleaned, keypoints):
                try:
                    features.append(np.asarray(self.feature_extractor(pts, kp, cfg.des_r)))
                except DATA_FAULTS as e:  # zeros for this part (rap_tpu's degrade)
                    self.fallbacks["features"] += 1
                    logger.warning("feature extraction failed: %s", e)
                    features.append(np.zeros((len(kp), 32), np.float32))
        return keypoints, features


def process_dataset_folder(
    input_root: str | Path,
    output_root: str | Path,
    cfg: SampleProcessorConfig = SampleProcessorConfig(),
    feature_extractor=None,
    val_fraction: float = 0.1,
    to_hdf5: str | Path | None = None,
    dataset_name: str = "dataset",
    device=None,
) -> dict:
    """Walk `<input_root>/**/part_*.ply` sample folders, process each with a
    per-sample seed, write splits + num_points (+ optional HDF5 + metadata);
    returns the metadata, the processor's fallback counts included.
    ``device``: the processor's (``SampleProcessor``)."""
    input_root = Path(input_root)
    output_root = Path(output_root)
    proc = SampleProcessor(cfg, feature_extractor, device)

    sample_dirs = sorted({p.parent for p in input_root.rglob("part_*.ply")})
    names, totals = [], {}
    t0 = time.time()
    for i, d in enumerate(sample_dirs):
        name = str(d.relative_to(input_root))
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, i]))
        parts = [
            plyio.read_ply(f)["points"]
            for f in sorted(d.glob("part_*.ply"))
            if not f.name.startswith("features")
        ]
        kpts, feats = proc.process_sample(parts, rng)
        _, total = save_processed_sample(output_root, name, kpts, feats)
        names.append(name)
        totals[name] = total
    train, val = make_splits(names, val_fraction, np.random.default_rng(cfg.seed))
    write_split_files(output_root, train, val)
    write_num_points_files(output_root, "train", [totals[n] for n in train])
    write_num_points_files(output_root, "val", [totals[n] for n in val])
    meta = {
        "dataset_name": dataset_name,
        "num_samples": len(names),
        "num_train": len(train),
        "num_val": len(val),
        "config": dataclasses.asdict(cfg),
        "features": feature_extractor is not None,
        "fallbacks": dict(proc.fallbacks),
        "processing_seconds": round(time.time() - t0, 2),
    }
    write_metadata(output_root, meta)
    if to_hdf5:
        convert_to_hdf5(output_root, to_hdf5, dataset_name)
    logger.info(
        "processed %d samples (%d train / %d val) in %.1fs, fallbacks %s",
        len(names), len(train), len(val), meta["processing_seconds"], proc.fallbacks,
    )
    return meta


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--dataset-name", default="dataset")
    ap.add_argument("--allocation", default="voxel_adaptive",
                    choices=["voxel_adaptive", "point_count", "spatial_coverage"])
    ap.add_argument("--num-points", type=int, default=8192)
    ap.add_argument("--max-points-per-part", type=int, default=20_000)
    ap.add_argument("--min-points-per-part", type=int, default=200)
    ap.add_argument("--voxel-size", type=float, default=0.4)
    ap.add_argument("--voxel-ratio", type=float, default=0.05)
    ap.add_argument("--des-r", type=float, default=2.0)
    ap.add_argument("--no-outlier-removal", action="store_true")
    ap.add_argument("--spinnet-checkpoint", default="")
    ap.add_argument("--no-features", action="store_true")
    ap.add_argument("--to-hdf5", default="")
    ap.add_argument("--val-fraction", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where SpinNet and outlier removal run: cuda (the default with "
                         "features) or cpu; without features the CPU")
    args = ap.parse_args(argv)

    cfg = SampleProcessorConfig(
        allocation=args.allocation,
        num_points=args.num_points,
        max_points_per_part=args.max_points_per_part,
        min_points_per_part=args.min_points_per_part,
        voxel_size=args.voxel_size,
        voxel_ratio=args.voxel_ratio,
        des_r=args.des_r,
        outlier_removal=not args.no_outlier_removal,
        seed=args.seed,
    )
    device = args.device or ("cpu" if args.no_features else "cuda")
    fx = None
    if not args.no_features:
        from ..spinnet import build_feature_extractor

        fx = build_feature_extractor(args.spinnet_checkpoint, device=device)
    return process_dataset_folder(
        args.input, args.output, cfg, fx,
        val_fraction=args.val_fraction,
        to_hdf5=args.to_hdf5 or None,
        dataset_name=args.dataset_name,
        device=device,
    )


if __name__ == "__main__":
    main()
