"""Multi-part point-cloud dataset on a PLY folder or an HDF5 file, with
augmentation (counterpart of rap_tpu/data/dataset.py).

Folder layout (rap_tpu's, dataset.py:1-20): ``<root>/data_split/{split}
[_random].txt`` lists fragment folders; each ``<root>/<frag>/`` holds
``*.ply`` parts with optional ``features_<part>.npy``; optional
``<root>/num_points/{split}.txt``. HDF5 layout (:333-337, :377-408,
:447-455): ``data_split/<dataset_name>/{split}[_random]`` lists fragment
groups, each group ``<frag>/<part>/vertices`` (and optional ``features``),
optional ``num_points/<dataset_name>/{split}[_random]``; ``h5py`` is
imported only when a ``data_path`` is a file. The split fallback, the
part-count filter, ``limit_val_samples`` and ``min_points_per_part`` are
rap_tpu's.

``augment_sample`` is rap_tpu's label contract (dataset.py:86-247) with the
same numpy/scipy draws in the same order from a per-sample
``np.random.default_rng(SeedSequence([seed, epoch, index]))``, so one scene
gives the same arrays in both packages. Not carried: surface normals,
which rap_tpu keeps for storage parity and nothing in the evaluation reads.
"""

from __future__ import annotations

import dataclasses
import glob
import logging
import os
from pathlib import Path

import numpy as np
from scipy.spatial.transform import Rotation

from ..utils import ply as plyio

logger = logging.getLogger("rap_tpu_torch.data")

FEAT_DIM_DEFAULT = 32


@dataclasses.dataclass
class Sample:
    """One multi-part sample after augmentation (all in scaled space)."""

    name: str
    dataset_name: str
    index: int
    points: list[np.ndarray]        # per part (Ni, 3): condition (augmented)
    points_gt: list[np.ndarray]     # per part (Ni, 3): registered GT
    features: list[np.ndarray]      # per part (Ni, F)
    rotations: np.ndarray           # (P, 3, 3): points @ R^T + t == points_gt
    translations: np.ndarray        # (P, 3)
    anchor_idx: int
    scale: float
    global_rotation: np.ndarray     # (3, 3)
    global_translation: np.ndarray  # (3,)

    @property
    def num_parts(self) -> int:
        return len(self.points)

    @property
    def max_part_points(self) -> int:
        return max(len(p) for p in self.points)


def _random_rotation(rng: np.random.Generator) -> np.ndarray:
    return Rotation.random(random_state=rng).as_matrix()


def _random_yaw_rotation(rng: np.random.Generator, roll_pitch_range: float) -> np.ndarray:
    """Yaw U(-180, 180) about z with small roll and pitch (dataset.py:68-79)."""
    yaw = rng.uniform(-180.0, 180.0)
    roll = rng.uniform(-roll_pitch_range, roll_pitch_range)
    pitch = rng.uniform(-roll_pitch_range, roll_pitch_range)
    return Rotation.from_euler("zxy", np.radians([yaw, roll, pitch])).as_matrix()


def augment_sample(
    name: str,
    dataset_name: str,
    index: int,
    parts_gt: list[np.ndarray],
    features: list[np.ndarray] | None,
    rng: np.random.Generator,
    train: bool,
    yaw_augmentation: bool = False,
    roll_pitch_range: float = 5.0,
    random_scale_range: tuple[float, float] | None = None,
    feat_dim: int = FEAT_DIM_DEFAULT,
    rotate_global: bool = True,
    rotate_parts: bool = True,
) -> Sample:
    """Center on the largest part, rotate (train), scale by 1.5 max|coord| of
    the primary part, re-center and rotate each non-anchor part, shuffle
    points; the anchor keeps the identity rotation (dataset.py:106-247)."""
    n_parts = len(parts_gt)
    counts = np.array([len(p) for p in parts_gt])
    primary = int(np.argmax(counts))
    tran_global = np.concatenate(parts_gt).astype(np.float64).mean(0)

    primary_center = parts_gt[primary].mean(0)
    R_fwd = np.eye(3)
    if train:
        # the draw is always consumed, so the part rotations below see the
        # same stream whatever rotate_global says
        R_draw = (_random_yaw_rotation(rng, roll_pitch_range) if yaw_augmentation
                  else _random_rotation(rng))
        if rotate_global:
            R_fwd = R_draw
    rot_global = R_fwd.T

    primary_rotated = (parts_gt[primary] - primary_center) @ R_fwd.T
    scale = float(np.max(np.abs(primary_rotated))) * 1.5
    if train and random_scale_range is not None:
        scale *= rng.uniform(*random_scale_range)
    scale = max(scale, 1e-12)

    gt_parts = [((p - primary_center) @ R_fwd.T) / scale for p in parts_gt]
    gt_trans = np.concatenate(gt_parts).mean(0)
    gt_parts = [p - gt_trans for p in gt_parts]

    out_pts, out_gt, out_feats = [], [], []
    rots = np.zeros((n_parts, 3, 3), np.float32)
    trans = np.zeros((n_parts, 3), np.float32)
    for i in range(n_parts):
        gt_i = gt_parts[i]
        center = gt_i.mean(0)
        if i == primary:
            cond = gt_i + gt_trans
            rots[i] = np.eye(3)
            trans[i] = -gt_trans
        else:
            R_part = np.eye(3)
            if train:
                R_draw = (_random_yaw_rotation(rng, roll_pitch_range) if yaw_augmentation
                          else _random_rotation(rng))
                if rotate_parts:
                    R_part = R_draw
            cond = (gt_i - center) @ R_part.T
            rots[i] = np.asarray(R_part).T
            trans[i] = center
        order = rng.permutation(len(gt_i))
        out_pts.append(cond[order].astype(np.float32))
        out_gt.append(gt_i[order].astype(np.float32))
        if features is not None and features[i] is not None:
            out_feats.append(np.asarray(features[i])[order].astype(np.float32))
        else:
            out_feats.append(np.zeros((len(gt_i), feat_dim), np.float32))

    return Sample(
        name=name, dataset_name=dataset_name, index=index, points=out_pts,
        points_gt=out_gt, features=out_feats, rotations=rots, translations=trans,
        anchor_idx=primary, scale=scale,
        global_rotation=rot_global.astype(np.float32),
        global_translation=tran_global.astype(np.float32),
    )


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    """rap_tpu's DatasetConfig (dataset.py:255-284), every field kept."""

    data_path: str = ""
    dataset_name: str = "dataset"
    split: str = "val"
    min_parts: int = 2
    max_parts: int = 64
    min_points_per_part: int = 0
    limit_val_samples: int = 0
    use_random_split: bool = False
    load_features: bool = True
    feat_dim: int = FEAT_DIM_DEFAULT
    yaw_augmentation: bool = False
    roll_pitch_range: float = 5.0
    random_scale_range: tuple[float, float] | None = None
    overlap_threshold: float = 0.0
    seed: int = 0
    augment_eval: bool = False
    augment_eval_mode: str = "full"  # full | global_only | parts_only


class PointCloudDataset:
    """Loads fragments from a PLY folder or an HDF5 file and augments them."""

    def __init__(self, cfg: DatasetConfig):
        self.cfg = cfg
        self.data_path = cfg.data_path
        self.use_folder = os.path.isdir(cfg.data_path)
        self._h5 = None
        self.effective_random = self._determine_split_type()
        self.fragments, self.part_counts, self.precomputed_num_points = (
            self._build_fragment_list())

    def _split_file(self, split: str, random_split: bool) -> Path:
        suffix = "_random" if random_split else ""
        return Path(self.data_path) / "data_split" / f"{split}{suffix}.txt"

    def _split_available(self, random_split: bool) -> bool:
        if not self.use_folder:
            h5, ds = self._get_h5(), self.cfg.dataset_name
            if "data_split" not in h5 or ds not in h5["data_split"]:
                return False
            suffix = "_random" if random_split else ""
            return all(f"{s}{suffix}" in h5["data_split"][ds] for s in ("train", "val"))
        return all(self._split_file(s, random_split).is_file()
                   and self._split_file(s, random_split).stat().st_size > 0
                   for s in ("train", "val"))

    def _get_h5(self):
        import h5py

        if self._h5 is None:
            self._h5 = h5py.File(self.data_path, "r", libver="latest", swmr=True)
        return self._h5

    def _determine_split_type(self) -> bool:
        """True: random splits; the bidirectional fallback of dataset.py:315."""
        preferred = self.cfg.use_random_split
        if self._split_available(preferred):
            return preferred
        if self._split_available(not preferred):
            logger.info("%s splits unavailable for %s; falling back to %s",
                        "random" if preferred else "standard", self.data_path,
                        "standard" if preferred else "random")
            return not preferred
        return False

    def _build_fragment_list(self):
        kept, counts, npts = (self._folder_fragments() if self.use_folder
                              else self._h5_fragments())
        cfg = self.cfg
        if (cfg.limit_val_samples > 0 and len(kept) > cfg.limit_val_samples
                and cfg.split.startswith("val")):
            step = len(kept) // cfg.limit_val_samples
            kept, counts, npts = (a[::step][: cfg.limit_val_samples]
                                  for a in (kept, counts, npts))
        return kept, counts, npts

    def _h5_fragments(self):
        cfg = self.cfg
        h5, ds = self._get_h5(), cfg.dataset_name
        split_key = cfg.split + ("_random" if self.effective_random else "")
        alt_key = cfg.split + ("" if self.effective_random else "_random")
        splits = h5["data_split"][ds] if "data_split" in h5 and ds in h5["data_split"] else {}
        if split_key not in splits:
            if alt_key not in splits:
                logger.error("no split '%s' (or '%s') for dataset %s in %s",
                             split_key, alt_key, ds, self.data_path)
                return [], [], []
            split_key = alt_key
        frags = [r.decode() if isinstance(r, bytes) else str(r)
                 for r in splits[split_key][:]]
        if "num_points" in h5 and ds in h5["num_points"] and split_key in h5["num_points"][ds]:
            num_points = list(h5["num_points"][ds][split_key][:])
        else:
            num_points = [0] * len(frags)
        if len(num_points) != len(frags):
            logger.warning("h5 num_points[%s][%s] has %d entries for %d fragments; "
                           "ignoring it", ds, split_key, len(num_points), len(frags))
            num_points = [0] * len(frags)
        kept, counts, npts = [], [], []
        for frag, npnt in zip(frags, num_points):
            if frag not in h5:
                continue
            n = len(h5[frag].keys())
            if cfg.min_parts <= n <= cfg.max_parts:
                kept.append(frag)
                counts.append(n)
                npts.append(int(npnt))
        return kept, counts, npts

    def _folder_fragments(self):
        cfg = self.cfg
        split_key = cfg.split + ("_random" if self.effective_random else "")
        sf = self._split_file(cfg.split, self.effective_random)
        if not sf.is_file() or sf.stat().st_size == 0:
            alt = self._split_file(cfg.split, not self.effective_random)
            if not (alt.is_file() and alt.stat().st_size > 0):
                logger.error("no split file for %s in %s", cfg.split, self.data_path)
                return [], [], []
            sf = alt
            split_key = cfg.split + ("" if self.effective_random else "_random")
        frags = [l.strip() for l in sf.read_text().splitlines() if l.strip()]
        npf = Path(self.data_path) / "num_points" / f"{split_key}.txt"
        num_points = [int(l) for l in npf.read_text().split()] if npf.is_file() else []
        if len(num_points) != len(frags):
            if npf.is_file():
                logger.warning("num_points/%s.txt has %d entries for %d fragments; "
                               "ignoring it", split_key, len(num_points), len(frags))
            num_points = [0] * len(frags)
        kept, counts, npts = [], [], []
        for frag, npnt in zip(frags, num_points):
            n = len(glob.glob(os.path.join(self.data_path, frag, "*.ply")))
            if cfg.min_parts <= n <= cfg.max_parts:
                kept.append(frag)
                counts.append(n)
                npts.append(npnt)
        return kept, counts, npts

    def __len__(self) -> int:
        return len(self.fragments)

    def _load_parts(self, frag: str):
        parts_gt, feats = [], []
        if self.use_folder:
            folder = os.path.join(self.data_path, frag)
            for ply_path in sorted(glob.glob(os.path.join(folder, "*.ply"))):
                parts_gt.append(plyio.read_ply_points(ply_path).astype(np.float64))
                stem = os.path.splitext(os.path.basename(ply_path))[0]
                fpath = os.path.join(folder, f"features_{stem}.npy")
                feats.append(np.load(fpath) if os.path.exists(fpath) else None)
        else:
            group = self._get_h5()[frag]
            for part in sorted(group.keys()):
                sub = group[part]
                parts_gt.append(np.asarray(sub["vertices"][:], np.float64))
                feats.append(np.asarray(sub["features"][:]) if "features" in sub else None)
        if not self.cfg.load_features or any(f is None for f in feats):
            feats = None
        if self.cfg.min_points_per_part > 0:
            keep = [i for i, p in enumerate(parts_gt)
                    if len(p) >= self.cfg.min_points_per_part]
            if len(keep) < len(parts_gt):
                if len(keep) < self.cfg.min_parts:
                    logger.warning("%s: only %d/%d parts have >= %d points; keeping all",
                                   frag, len(keep), len(parts_gt),
                                   self.cfg.min_points_per_part)
                else:
                    parts_gt = [parts_gt[i] for i in keep]
                    feats = None if feats is None else [feats[i] for i in keep]
        return parts_gt, feats

    def get(self, index: int, epoch: int = 0) -> Sample:
        frag = self.fragments[index]
        parts_gt, feats = self._load_parts(frag)
        rng = np.random.default_rng(np.random.SeedSequence([self.cfg.seed, epoch, index]))
        is_train_split = self.cfg.split.startswith("train")
        mode = (self.cfg.augment_eval_mode
                if self.cfg.augment_eval and not is_train_split else "full")
        if mode not in ("full", "global_only", "parts_only"):
            raise ValueError(f"unknown augment_eval_mode: {mode!r}")
        return augment_sample(
            name=frag, dataset_name=self.cfg.dataset_name, index=index,
            parts_gt=parts_gt, features=feats, rng=rng,
            train=is_train_split or self.cfg.augment_eval,
            yaw_augmentation=self.cfg.yaw_augmentation,
            roll_pitch_range=self.cfg.roll_pitch_range,
            random_scale_range=self.cfg.random_scale_range,
            feat_dim=self.cfg.feat_dim, rotate_global=mode in ("full", "global_only"),
            rotate_parts=mode in ("full", "parts_only"),
        )

    def __getitem__(self, index: int) -> Sample:
        return self.get(index)

    def close(self):
        """Close the HDF5 file, if one is open."""
        if self._h5 is not None:
            self._h5.close()
            self._h5 = None
