"""Part-major batch of multi-part point clouds (counterpart of
rap_tpu/core/batch.py:38-308).

The same fixed-shape layout as the JAX ``PartBatch``: ``G`` parts, each
padded to ``N`` points, ``S`` sample slots whose parts occupy contiguous
part slots, and masks for padded points, parts and samples. Here it is a
plain dataclass of tensors; ``no_padding`` is host-side metadata that lets
the DiT take its mask-free fused branch.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from .._device import resolve_device

TENSOR_FIELDS = (
    "points", "points_gt", "local_feats", "point_mask", "part_valid",
    "sample_of_part", "anchor_part", "rotations_gt", "translations_gt",
    "scale", "sample_valid", "global_rotation", "global_translation",
)


@dataclasses.dataclass(frozen=True)
class PartBatch:
    # Per-point
    points: torch.Tensor           # (G, N, 3) f32 condition coords
    points_gt: torch.Tensor        # (G, N, 3) f32 registered GT coords
    local_feats: torch.Tensor      # (G, N, F) f32
    point_mask: torch.Tensor       # (G, N) bool
    # Per-part
    part_valid: torch.Tensor       # (G,) bool
    sample_of_part: torch.Tensor   # (G,) int64 owning sample slot
    anchor_part: torch.Tensor      # (G,) bool
    rotations_gt: torch.Tensor     # (G, 3, 3) f32: pts @ R^T + t == pts_gt
    translations_gt: torch.Tensor  # (G, 3) f32
    # Per-sample
    scale: torch.Tensor            # (S,) f32
    sample_valid: torch.Tensor     # (S,) bool
    global_rotation: torch.Tensor | None = None     # (S, 3, 3) f32
    global_translation: torch.Tensor | None = None  # (S, 3) f32
    # host-side: True iff no point, part or sample slot is padding
    no_padding: bool = False

    @property
    def G(self) -> int:
        return self.points.shape[0]

    @property
    def N(self) -> int:
        return self.points.shape[1]

    @property
    def S(self) -> int:
        return self.scale.shape[0]

    @property
    def device(self) -> torch.device:
        return self.points.device

    def per_sample_to_part(self, x: torch.Tensor) -> torch.Tensor:
        """Gather (S, ...) -> (G, ...) by owning sample."""
        return x[self.sample_of_part]

    @property
    def num_tokens(self) -> int:
        return self.G * self.N

    def per_sample_to_point(self, x: torch.Tensor) -> torch.Tensor:
        """Broadcast (S, ...) -> (G, N, ...)."""
        return self.per_part_to_point(self.per_sample_to_part(x))

    def per_part_to_point(self, x: torch.Tensor) -> torch.Tensor:
        """Broadcast (G, ...) -> (G, N, ...)."""
        return x[:, None].expand((self.G, self.N) + tuple(x.shape[1:]))

    @property
    def anchor_point_mask(self) -> torch.Tensor:
        """(G, N) bool: the valid points of anchor parts."""
        return self.point_mask & self.anchor_part[:, None]

    @property
    def points_per_part(self) -> torch.Tensor:
        """(G,) int32 valid point count per part."""
        return self.point_mask.sum(1, dtype=torch.int32)

    @property
    def part_seg_ids(self) -> torch.Tensor:
        """(G*N,) int32 segment ids for part attention; -1 for invalid tokens."""
        ids = torch.arange(self.G, dtype=torch.int32, device=self.device)[:, None]
        return torch.where(self.point_mask, ids, -1).reshape(-1)

    @property
    def sample_seg_ids(self) -> torch.Tensor:
        """(G*N,) int32 segment ids for global attention; -1 for invalid tokens."""
        ids = self.sample_of_part.to(torch.int32)[:, None]
        return torch.where(self.point_mask, ids, -1).reshape(-1)

    @classmethod
    def from_numpy(cls, arrays: Mapping[str, np.ndarray], no_padding: bool,
                   device="cuda") -> "PartBatch":
        """Build a batch from numpy arrays, e.g. a numpy copy of a rap_tpu
        ``PartBatch`` (``{f: np.asarray(getattr(b, f)) for f in TENSOR_FIELDS}``)."""
        device = resolve_device(device)
        kw = {}
        for f in TENSOR_FIELDS:
            a = arrays.get(f)
            if a is None:
                continue
            t = torch.from_numpy(np.array(a))  # copy: jax arrays are read-only
            if f == "sample_of_part":
                t = t.long()
            kw[f] = t.to(device)
        return cls(**kw, no_padding=bool(no_padding))


def _random_rotation(rng: np.random.Generator) -> np.ndarray:
    """Uniform rotation from a normalised Gaussian quaternion."""
    qv = rng.standard_normal(4)
    w, x, y, z = qv / np.linalg.norm(qv)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], dtype=np.float32)


def make_synthetic_batch(
    seed: int,
    parts_per_sample: list[int],
    points_per_part: list[list[int]],
    N: int,
    G: int | None = None,
    S: int | None = None,
    feat_dim: int = 32,
    device="cuda",
) -> PartBatch:
    """Synthetic batch for tests (counterpart of make_synthetic_batch,
    batch.py:134): parts packed from slot 0, padded part slots after them
    keep the last sample id. Per part, random GT points, a random rigid
    augmentation (the largest part of a sample is its anchor, R = I) and pose
    labels with ``points @ R^T + t == points_gt``. Made on the host with
    numpy from ``seed``, then moved to ``device``."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_samples = len(parts_per_sample)
    G = G or sum(parts_per_sample)
    S = S or n_samples
    if G < sum(parts_per_sample) or S < n_samples:
        raise ValueError("more parts than G or more samples than S")
    points = np.zeros((G, N, 3), np.float32)
    points_gt = np.zeros((G, N, 3), np.float32)
    feats = np.zeros((G, N, feat_dim), np.float32)
    mask = np.zeros((G, N), bool)
    part_valid = np.zeros(G, bool)
    sample_of_part = np.zeros(G, np.int64)
    anchor = np.zeros(G, bool)
    rots = np.tile(np.eye(3, dtype=np.float32), (G, 1, 1))
    trans = np.zeros((G, 3), np.float32)
    sample_valid = np.zeros(S, bool)
    g = 0
    for s, (n_parts, counts) in enumerate(zip(parts_per_sample, points_per_part,
                                             strict=True)):
        if len(counts) != n_parts:
            raise ValueError(f"sample {s}: {len(counts)} part sizes for {n_parts} parts")
        anchor_idx = int(np.argmax(counts))
        for p, cnt in enumerate(counts):
            if not 0 < cnt <= N:
                raise ValueError(f"part size {cnt} outside (0, {N}]")
            gt = rng.standard_normal((cnt, 3)).astype(np.float32)
            if p == anchor_idx:
                aug, R_inv, t = gt.copy(), np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
            else:
                center = gt.mean(0)
                R_fwd = _random_rotation(rng)
                aug = (gt - center) @ R_fwd.T
                R_inv, t = R_fwd.T, center
            points_gt[g, :cnt] = gt
            points[g, :cnt] = aug
            feats[g, :cnt] = rng.standard_normal((cnt, feat_dim)).astype(np.float32)
            mask[g, :cnt] = True
            part_valid[g] = True
            sample_of_part[g] = s
            anchor[g] = p == anchor_idx
            rots[g] = R_inv
            trans[g] = t
            g += 1
        sample_valid[s] = True
    sample_of_part[g:] = sample_of_part[g - 1] if g > 0 else 0
    arrays = {
        "points": points, "points_gt": points_gt, "local_feats": feats,
        "point_mask": mask, "part_valid": part_valid, "sample_of_part": sample_of_part,
        "anchor_part": anchor, "rotations_gt": rots, "translations_gt": trans,
        "scale": np.ones(S, np.float32), "sample_valid": sample_valid,
        "global_rotation": np.tile(np.eye(3, dtype=np.float32), (S, 1, 1)),
        "global_translation": np.zeros((S, 3), np.float32),
    }
    no_padding = bool(mask.all() and part_valid.all() and sample_valid.all())
    return PartBatch.from_numpy(arrays, no_padding, device)


def make_regular_synthetic_batch(
    seed: int,
    points_per_part: list[list[int]],
    N: int,
    P: int,
    S: int | None = None,
    feat_dim: int = 32,
    device="cuda",
) -> PartBatch:
    """Synthetic batch in the regular layout the model requires (counterpart
    of make_regular_synthetic_batch, batch.py:223): G = S*P, sample s owns
    part slots [s*P, (s+1)*P); the parts of ``make_synthetic_batch`` are
    scattered into those blocks, padded slots invalid with R = I."""
    S = S or len(points_per_part)
    if len(points_per_part) > S or any(len(c) > P for c in points_per_part):
        raise ValueError("more samples than S or more parts than P")
    packed = make_synthetic_batch(seed, [len(c) for c in points_per_part],
                                  points_per_part, N, S=S, feat_dim=feat_dim,
                                  device="cpu")
    dst = torch.tensor([s * P + p for s, c in enumerate(points_per_part)
                        for p in range(len(c))])
    G = S * P
    arrays = {}
    for f in TENSOR_FIELDS:
        a = getattr(packed, f)
        if f in ("scale", "sample_valid", "global_rotation", "global_translation"):
            arrays[f] = a.numpy()
            continue
        if f == "rotations_gt":
            out = torch.eye(3).repeat(G, 1, 1)
        else:
            out = torch.zeros((G,) + tuple(a.shape[1:]), dtype=a.dtype)
        out[dst] = a
        arrays[f] = out.numpy()
    arrays["sample_of_part"] = np.repeat(np.arange(S), P)
    no_padding = packed.no_padding and len(dst) == G
    return PartBatch.from_numpy(arrays, no_padding, device)


def validate(batch: PartBatch) -> None:
    """Host-side invariant checks (batch.py:284-308); raises ValueError."""
    sop = batch.sample_of_part.cpu().numpy()
    pv = batch.part_valid.cpu().numpy()
    pm = batch.point_mask.cpu().numpy()
    sv = batch.sample_valid.cpu().numpy()
    anc = batch.anchor_part.cpu().numpy()
    pad = ~pm[..., None]

    def check(cond, msg):
        if not cond:
            raise ValueError(msg)

    check((np.diff(sop) >= 0).all(), "sample_of_part must be non-decreasing")
    check(sop.min() >= 0 and sop.max() < batch.S, "sample_of_part out of range")
    check(not (batch.points.cpu().numpy() * pad).any(),
          "masked points carry nonzero coordinates")
    check(not (batch.points_gt.cpu().numpy() * pad).any(),
          "masked GT points carry nonzero coordinates")
    check(not (anc & ~pv).any(), "anchor flags on invalid parts")
    check(not (pm.any(axis=1) & ~pv).any(), "points on invalid parts")
    check((pm.any(axis=1) | ~pv).all(), "valid parts must have >=1 point")
    for s in range(batch.S):
        sel = (sop == s) & pv
        if sv[s]:
            check(sel.any(), f"valid sample {s} has no parts")
            check(anc[sel].sum() == 1, f"sample {s} needs exactly one anchor")
        else:
            check(not sel.any(), f"invalid sample {s} has parts")
    if batch.no_padding:
        check(pm.all() and pv.all() and sv.all(),
              "no_padding is set on a batch with padding")
