"""Dry-run / preview tooling for the offline data-generation pipeline.
(A copy of rap_tpu/dataset_process/preview.py: the port imports nothing of
rap_tpu.)

Parity with the reference's dataset_process/utils/validation_utils.py:21-172
(argument validation + per-sequence dry run) and preview_utils.py:15-208
(split previews): answer "what WOULD be processed / how would it split"
without touching the data, so a multi-hour generation run never starts with
a bad configuration.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Callable, Iterable

import numpy as np

from .splits import make_splits

logger = logging.getLogger("rap_tpu_torch.dataset_process")


@dataclasses.dataclass
class SequenceReport:
    name: str
    ok: bool
    frame_count: int = 0
    effective_frames: int = 0   # after keyframe filtering estimate
    planned_samples: int = 0
    error: str = ""


@dataclasses.dataclass
class DryRunReport:
    data_root_ok: bool
    output_dir_ok: bool
    sequences: list[SequenceReport]

    @property
    def ok(self) -> bool:
        return (
            self.data_root_ok
            and self.output_dir_ok
            and all(s.ok for s in self.sequences)
        )

    @property
    def total_samples(self) -> int:
        return sum(s.planned_samples for s in self.sequences)

    def log(self) -> None:
        logger.info("=" * 50)
        logger.info("DRY RUN — configuration and data-path check")
        logger.info("=" * 50)
        for s in self.sequences:
            if s.ok:
                logger.info(
                    "  ok %s: %d frames (%d effective) -> %d samples",
                    s.name, s.frame_count, s.effective_frames, s.planned_samples,
                )
            else:
                logger.error("  FAIL %s: %s", s.name, s.error)
        logger.info(
            "total: %d sequences, %d planned samples%s",
            len(self.sequences), self.total_samples,
            "" if self.ok else "  (ERRORS — fix before processing)",
        )


def dry_run(
    data_root,
    output_dir,
    sequences: Iterable[str],
    sequence_info_fn: Callable[[str], dict],
    samples_per_sequence: int = 10,
    max_samples_per_sequence: int = 0,
    min_frames_required: int = 2,
) -> DryRunReport:
    """Validate paths and estimate work without loading point data.

    ``sequence_info_fn(name)`` must return {"frame_count": int
    [, "effective_frames": int]} or raise — e.g. for KITTI simply count
    velodyne files; for folder datasets count frames on disk.
    """
    data_root = Path(data_root)
    data_root_ok = data_root.exists()
    if not data_root_ok:
        logger.error("data root does not exist: %s", data_root)
    try:
        Path(output_dir).mkdir(parents=True, exist_ok=True)
        output_dir_ok = True
    except OSError as e:
        logger.error("cannot create output dir %s: %s", output_dir, e)
        output_dir_ok = False

    reports = []
    for seq in sequences:
        try:
            info = sequence_info_fn(seq)
            fc = int(info["frame_count"])
            eff = int(info.get("effective_frames", fc))
            if eff < min_frames_required:
                raise ValueError(
                    f"only {eff} usable frames (< {min_frames_required})"
                )
            planned = samples_per_sequence
            if max_samples_per_sequence:
                planned = min(planned, max_samples_per_sequence)
            reports.append(SequenceReport(seq, True, fc, eff, planned))
        except Exception as e:
            reports.append(SequenceReport(seq, False, error=str(e)))
    rep = DryRunReport(data_root_ok, output_dir_ok, reports)
    rep.log()
    return rep


def kitti_sequence_info(data_root) -> Callable[[str], dict]:
    """sequence_info_fn for the KITTI odometry layout (datasets.py)."""

    def info(seq: str) -> dict:
        seq_dir = Path(data_root) / "sequences" / seq
        bins = list((seq_dir / "velodyne").glob("*.bin"))
        if not bins:
            raise FileNotFoundError(f"no velodyne frames under {seq_dir}")
        poses = Path(data_root) / "poses" / f"{seq}.txt"
        if not poses.is_file():
            raise FileNotFoundError(f"missing poses file {poses}")
        n_poses = sum(1 for ln in poses.read_text().splitlines() if ln.strip())
        return {"frame_count": min(len(bins), n_poses)}

    return info


def preview_splits(
    sample_names_by_sequence: dict[str, list[str]],
    val_fraction: float = 0.1,
    keep_sequences_together: bool = True,
    val_sequences: list[str] | None = None,
    seed: int = 0,
) -> dict:
    """Preview train/val membership BEFORE writing split files
    (ref preview_utils.py:15-208: predefined / manual / automatic modes).

    Returns {"train": [names], "val": [names], "per_sequence": {seq:
    ("train"|"val"|"mixed", n_samples)}} and logs a table.
    """
    all_names = [n for ns in sample_names_by_sequence.values() for n in ns]
    if val_sequences is not None:   # manual / predefined mode
        val_set = set(val_sequences)
        train = [
            n for seq, ns in sample_names_by_sequence.items()
            if seq not in val_set for n in ns
        ]
        val = [
            n for seq, ns in sample_names_by_sequence.items()
            if seq in val_set for n in ns
        ]
        missing = val_set - set(sample_names_by_sequence)
        for m in sorted(missing):
            logger.warning("val sequence %s has no samples", m)
    else:                           # automatic mode
        train, val = make_splits(
            all_names,
            val_fraction=val_fraction,
            rng=np.random.default_rng(seed),
            keep_sequences_together=keep_sequences_together,
        )
    val_names = set(val)
    per_seq = {}
    for seq, ns in sorted(sample_names_by_sequence.items()):
        n_val = sum(n in val_names for n in ns)
        kind = "val" if n_val == len(ns) else ("train" if n_val == 0 else "mixed")
        per_seq[seq] = (kind, len(ns))
        logger.info("  %-30s %-5s %5d samples", seq, kind, len(ns))
    logger.info(
        "split preview: %d train / %d val (%.1f%% val)",
        len(train), len(val),
        100.0 * len(val) / max(len(all_names), 1),
    )
    return {"train": train, "val": val, "per_sequence": per_seq}
