"""Per-dataset offline processors: 3DMatch-test, KITTI, NSS + pose graphs.
(A copy of rap_tpu/dataset_process/datasets.py: the port imports nothing of
rap_tpu.)

Parity with the dataset-specific processors of
the reference's dataset_process/utils/processing_utils.py:

  - 3DMatch / 3DLoMatch test (:591): every GT pair becomes a 2-part training
    sample; the GT ``gt.log`` files form a transformation graph and missing
    pairs resolve through BFS path search (:31-131); per-sequence global
    frame fixes apply (dataset_utils.py:750-770).
  - KITTI odometry (:844): velodyne ``.bin`` frames + calibrated poses feed
    the generic submap pipeline (process.py) — the reference's unreleased
    ``data_loaders`` package is replaced by explicit on-disk-format loaders.
  - NSS (:279): annotated cross-stage pairs with overlap/building/stage
    filters. The reference's loader was never released; the on-disk contract
    here is a ``pairs_{split}.json`` next to the clouds (documented below).
  - pose-graph connected-group sampling (:2153): random connected subgraphs
    of an overlap-edge graph, for multi-view (>2 part) sample generation.

All processors write reference-layout sample folders (part PLYs + poses)
via dataset_process.io, ready for feature extraction + HDF5 conversion.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from collections import defaultdict, deque
from pathlib import Path

import numpy as np

from ..ops.points import voxel_downsample
from ..utils import ply as plyio
from . import geometry as G
from .io import save_training_sample
from .process import SequenceProcessingConfig, process_sequence

logger = logging.getLogger("rap_tpu_torch.dataset_process")


# ---------------------------------------------------------------------------
# 3DMatch test: gt.log transformation graph (ref processing_utils.py:31-131)
# ---------------------------------------------------------------------------

def load_gt_log(gt_dir) -> dict[str, np.ndarray]:
    """Parse a 3DMatch ``gt.log``: blocks of `i j n` + a 4x4 matrix.

    Returns {"{i}_{j}": T (4,4)} where T aligns fragment i into fragment j's
    frame (the benchmark's convention).
    """
    log_file = Path(gt_dir) / "gt.log"
    if not log_file.is_file():
        raise FileNotFoundError(f"ground-truth log not found: {log_file}")
    lines = log_file.read_text().splitlines()
    result: dict[str, np.ndarray] = {}
    i = 0
    while i + 4 < len(lines):  # a block needs the header + 4 matrix rows
        head = lines[i].split()
        if len(head) < 2:
            break
        T = np.array(
            [[float(x) for x in lines[i + r].split()[:4]] for r in range(1, 5)]
        )
        result[f"{int(head[0])}_{int(head[1])}"] = T
        i += 5
    return result


def build_transform_graph(
    gt_log: dict[str, np.ndarray]
) -> dict[tuple[str, str], np.ndarray]:
    """(src_id, tgt_id) -> T, with inverse edges (ref :57-98)."""
    graph: dict[tuple[str, str], np.ndarray] = {}
    for key, T in gt_log.items():
        a, b = key.split("_")
        src, tgt = f"cloud_bin_{a}", f"cloud_bin_{b}"
        graph[(src, tgt)] = T
        graph[(tgt, src)] = np.linalg.inv(T)
    return graph


def find_transformation_path(
    src: str,
    tgt: str,
    graph: dict[tuple[str, str], np.ndarray],
    max_depth: int = 3,
) -> np.ndarray | None:
    """BFS through the transformation graph; composed 4x4 or None (ref :101-131)."""
    if src == tgt:
        return np.eye(4, dtype=np.float32)
    adjacency: dict[str, list[tuple[str, np.ndarray]]] = defaultdict(list)
    for (a, b), T in graph.items():
        adjacency[a].append((b, T))
    queue = deque([(src, np.eye(4))])
    visited = {src}
    for _ in range(max_depth):
        nxt: deque = deque()
        while queue:
            cur, T_cur = queue.popleft()
            for nb, T in adjacency[cur]:
                if nb in visited:
                    continue
                T_new = T_cur @ T
                if nb == tgt:
                    return T_new.astype(np.float32)
                visited.add(nb)
                nxt.append((nb, T_new))
        queue = nxt
        if not queue:
            break
    return None


@dataclasses.dataclass(frozen=True)
class PairProcessingConfig:
    voxel_size: float = 0.05
    max_samples: int = 0            # 0 = all
    min_overlap_ratio: float = 0.0
    max_overlap_ratio: float = 1.0
    seed: int = 0


def _save_pair_sample(
    out_dir: Path,
    sample_idx: int,
    src_pts: np.ndarray,
    tgt_pts: np.ndarray,
    voxel_size: float,
    global_transform: np.ndarray | None = None,
) -> str:
    """One 2-part training sample in the reference folder layout: the source
    is pre-aligned into the target frame (both registered — the runtime
    dataset applies its own augmentation), optional global frame fix
    (applied as a full 4x4 by io.save_training_sample)."""
    if voxel_size > 0:
        src_pts = voxel_downsample(src_pts, voxel_size)
        tgt_pts = voxel_downsample(tgt_pts, voxel_size)
    name = f"sample_{sample_idx:06d}"
    save_training_sample(
        out_dir, name, [src_pts, tgt_pts], global_transform=global_transform
    )
    return name


def process_threedmatch_test(
    data_root,
    sequence: str,
    output_dir,
    benchmark: str = "3DMatch",
    cfg: PairProcessingConfig = PairProcessingConfig(),
) -> list[str]:
    """3DMatch/3DLoMatch test pairs -> 2-part samples (ref :591-843).

    Expects the benchmark layout:
      <root>/test/<sequence>/cloud_bin_<i>.ply           fragment clouds
      <root>/test/3DMatch/gt_result/<sequence>/gt.log    (or 3DLoMatch/<seq>)
    Source fragments align into the target frame through the gt transform,
    falling back to a BFS path through the transformation graph when the
    direct pair is absent.
    """
    data_root = Path(data_root)
    out_dir = Path(output_dir)
    frag_dir = data_root / "test" / sequence
    if benchmark == "3DMatch":
        gt_dir = data_root / "test" / "3DMatch" / "gt_result" / sequence
    elif benchmark == "3DLoMatch":
        gt_dir = data_root / "test" / "3DLoMatch" / sequence
    else:
        raise ValueError(f"unknown benchmark {benchmark}")
    gt_log = load_gt_log(gt_dir)
    graph = build_transform_graph(gt_log)
    g_fix = G.global_frame_fix(sequence)
    g_T = None
    if g_fix is not None:
        g_T = np.eye(4, dtype=np.float32)
        g_T[:3, :3] = g_fix

    pairs = sorted(gt_log.keys(), key=lambda k: tuple(map(int, k.split("_"))))
    rng = np.random.default_rng(cfg.seed)
    if cfg.max_samples and len(pairs) > cfg.max_samples:
        pairs = list(rng.choice(pairs, cfg.max_samples, replace=False))

    names = []
    for sample_idx, key in enumerate(pairs):
        a, b = key.split("_")
        src_id, tgt_id = f"cloud_bin_{a}", f"cloud_bin_{b}"
        src_f = frag_dir / f"{src_id}.ply"
        tgt_f = frag_dir / f"{tgt_id}.ply"
        if not (src_f.is_file() and tgt_f.is_file()):
            logger.warning("missing fragments for pair %s; skipping", key)
            continue
        T = graph.get((src_id, tgt_id))
        if T is None:
            T = find_transformation_path(src_id, tgt_id, graph)
            if T is None:
                logger.warning("no transformation path for pair %s", key)
                continue
        # the gt.log stores the benchmark transform; inverted it maps source
        # points into the target frame (ref :676)
        T_align = np.linalg.inv(T)
        src = plyio.read_ply(src_f)["points"].astype(np.float64)
        tgt = plyio.read_ply(tgt_f)["points"].astype(np.float64)
        src = G.transform_points(src, T_align)
        names.append(
            _save_pair_sample(out_dir, sample_idx, src, tgt, cfg.voxel_size, g_T)
        )
    logger.info(
        "%s/%s: wrote %d samples to %s", benchmark, sequence, len(names), out_dir
    )
    return names


# ---------------------------------------------------------------------------
# KITTI odometry (ref :844-1094)
# ---------------------------------------------------------------------------

def _read_kitti_calib(calib_file) -> np.ndarray:
    """Tr (velodyne -> camera) as 4x4 from calib.txt."""
    for line in Path(calib_file).read_text().splitlines():
        if line.startswith("Tr"):
            vals = [float(x) for x in line.split(":", 1)[1].split()]
            T = np.eye(4)
            T[:3, :4] = np.array(vals).reshape(3, 4)
            return T
    raise ValueError(f"no Tr entry in {calib_file}")


def kitti_frame_loader(data_root, sequence: str, max_frames: int = 0):
    """Yield KITTI odometry frames in the VELODYNE frame.

    Layout: <root>/sequences/<seq>/velodyne/*.bin (float32 Nx4),
    <root>/sequences/<seq>/calib.txt (Tr), <root>/poses/<seq>.txt (3x4 cam
    poses). Velodyne-frame pose: P_velo = Tr^-1 @ P_cam @ Tr.
    """
    data_root = Path(data_root)
    seq_dir = data_root / "sequences" / sequence
    bins = sorted((seq_dir / "velodyne").glob("*.bin"))
    pose_file = data_root / "poses" / f"{sequence}.txt"
    Tr = _read_kitti_calib(seq_dir / "calib.txt")
    Tr_inv = np.linalg.inv(Tr)
    poses_cam = []
    for line in pose_file.read_text().splitlines():
        if not line.strip():
            continue
        P = np.eye(4)
        P[:3, :4] = np.array([float(x) for x in line.split()]).reshape(3, 4)
        poses_cam.append(P)
    n = min(len(bins), len(poses_cam))
    if max_frames:
        n = min(n, max_frames)
    for i in range(n):
        raw = np.fromfile(bins[i], dtype=np.float32).reshape(-1, 4)
        yield {
            "points": raw[:, :3].astype(np.float64),
            "pose": Tr_inv @ poses_cam[i] @ Tr,
            "frame_id": bins[i].stem,
        }


def process_kitti(
    data_root,
    sequence: str,
    output_root,
    cfg: SequenceProcessingConfig | None = None,
    max_frames: int = 0,
) -> list[str]:
    """KITTI sequence -> multi-view submap samples (ref :844): the generic
    submap pipeline over the velodyne frame loader with LiDAR-scale
    thresholds."""
    cfg = cfg or SequenceProcessingConfig(
        voxel_size=0.3,
        keyframe_min_translation=0.5,
        keyframe_min_rotation_deg=2.0,
    )
    loader = kitti_frame_loader(data_root, sequence, max_frames=max_frames)
    return process_sequence(loader, f"kitti_{sequence}", output_root, cfg)


# ---------------------------------------------------------------------------
# NSS pairs (ref :279-590)
# ---------------------------------------------------------------------------
# On-disk contract (the reference's NSSDataLoader was never released):
#   <root>/pairs_{split}.json — list of entries:
#     {"source_file": "...ply", "target_file": "...ply",
#      "transform": [16 floats, row-major source->target],
#      "overlap": float, "building": int,
#      "source_stage": int, "target_stage": int}
#   cloud paths are relative to <root>.

def load_nss_pairs(data_root, split_type: str = "train") -> list[dict]:
    f = Path(data_root) / f"pairs_{split_type}.json"
    if not f.is_file():
        raise FileNotFoundError(f"NSS pair annotations not found: {f}")
    return json.loads(f.read_text())


def process_nss(
    data_root,
    output_dir,
    split_type: str = "train",
    cfg: PairProcessingConfig = PairProcessingConfig(
        voxel_size=0.1, min_overlap_ratio=0.1, max_overlap_ratio=0.8
    ),
    filter_by_building: list[int] | None = None,
    filter_by_stage: list[int] | None = None,
    same_stage_only: bool = False,
    cross_stage_only: bool = False,
) -> tuple[list[str], dict]:
    """NSS annotated pairs -> 2-part samples with the reference's filters
    (overlap range, building, stage, same/cross stage; ref :279-420).
    Returns (sample names, statistics)."""
    assert not (same_stage_only and cross_stage_only)
    data_root = Path(data_root)
    pairs = load_nss_pairs(data_root, split_type)

    def keep(p):
        if not (cfg.min_overlap_ratio <= p.get("overlap", 0.0) <= cfg.max_overlap_ratio):
            return False
        if filter_by_building is not None and p.get("building") not in filter_by_building:
            return False
        if filter_by_stage is not None and not (
            p.get("source_stage") in filter_by_stage
            or p.get("target_stage") in filter_by_stage
        ):
            return False
        same = p.get("source_stage") == p.get("target_stage")
        if same_stage_only and not same:
            return False
        if cross_stage_only and same:
            return False
        return True

    valid = [p for p in pairs if keep(p)]
    rng = np.random.default_rng(cfg.seed)
    if cfg.max_samples and len(valid) > cfg.max_samples:
        idx = rng.choice(len(valid), cfg.max_samples, replace=False)
        valid = [valid[i] for i in sorted(idx)]

    names: list[str] = []
    stats = {
        "overlaps": [],
        "same_stage": 0,
        "cross_stage": 0,
        "buildings": defaultdict(int),
    }
    out_dir = Path(output_dir)
    for sample_idx, p in enumerate(valid):
        src = plyio.read_ply(data_root / p["source_file"])["points"].astype(np.float64)
        tgt = plyio.read_ply(data_root / p["target_file"])["points"].astype(np.float64)
        T = np.array(p["transform"], np.float64).reshape(4, 4)
        src = G.transform_points(src, T)
        names.append(
            _save_pair_sample(out_dir, sample_idx, src, tgt, cfg.voxel_size)
        )
        stats["overlaps"].append(p.get("overlap", 0.0))
        if p.get("source_stage") == p.get("target_stage"):
            stats["same_stage"] += 1
        else:
            stats["cross_stage"] += 1
        stats["buildings"][p.get("building", -1)] += 1
    stats["buildings"] = dict(stats["buildings"])
    logger.info("NSS %s: wrote %d samples", split_type, len(names))
    return names, stats


# ---------------------------------------------------------------------------
# MIT / TIERS benchmark pairs (ref :1095-1598)
# ---------------------------------------------------------------------------
# Both are "benchmark mode" pair datasets exactly like NSS: annotated pairs
# with a source->target transform. Their reference loaders were never
# released, so they share the pairs_{split}.json on-disk contract (see the
# NSS section above); only the default thresholds differ (LiDAR scale).

def process_mit(data_root, output_dir, split_type: str = "benchmark",
                cfg: PairProcessingConfig | None = None, **kw):
    """MIT multi-robot SLAM benchmark pairs (ref :1095)."""
    cfg = cfg or PairProcessingConfig(voxel_size=0.25)
    return process_nss(data_root, output_dir, split_type, cfg=cfg, **kw)


def process_tiers(data_root, output_dir, split_type: str = "benchmark",
                  cfg: PairProcessingConfig | None = None, **kw):
    """TIERS multi-LiDAR benchmark pairs (ref :1346)."""
    cfg = cfg or PairProcessingConfig(voxel_size=0.25)
    return process_nss(data_root, output_dir, split_type, cfg=cfg, **kw)


# ---------------------------------------------------------------------------
# generic posed-frame folder sequences (Waymo-style exports; ref :1599-1849)
# ---------------------------------------------------------------------------

def folder_frame_loader(data_root, sequence: str, max_frames: int = 0):
    """Yield frames from `<root>/<sequence>/frames/*.{ply,pcd,npy,bin}` with
    `<root>/<sequence>/poses.txt` (N rows of 12 or 16 floats, row-major).

    The Waymo processor (ref :1599) reads TFRecords through the unreleased
    loader package; the supported path here is pre-extracted frames in any of
    the four formats (the standard export produced by waymo-open-dataset
    tooling), which keeps this repo free of the TF dependency.
    """
    seq_dir = Path(data_root) / sequence
    frame_dir = seq_dir / "frames"
    files = sorted(
        f for f in frame_dir.iterdir()
        if f.suffix in (".ply", ".pcd", ".npy", ".bin")
    )
    poses = []
    for line in (seq_dir / "poses.txt").read_text().splitlines():
        vals = [float(x) for x in line.split()]
        if not vals:
            continue
        P = np.eye(4)
        if len(vals) == 16:
            P = np.array(vals).reshape(4, 4)
        elif len(vals) == 12:
            P[:3, :4] = np.array(vals).reshape(3, 4)
        else:
            raise ValueError(f"bad pose row with {len(vals)} values")
        poses.append(P)
    n = min(len(files), len(poses))
    if max_frames:
        n = min(n, max_frames)
    for i in range(n):
        f = files[i]
        if f.suffix == ".ply":
            pts = plyio.read_ply(f)["points"].astype(np.float64)
        elif f.suffix == ".pcd":
            pts = plyio.read_pcd(f)["points"].astype(np.float64)
        elif f.suffix == ".npy":
            pts = np.load(f)[:, :3].astype(np.float64)
        else:  # .bin: float32 Nx4 (KITTI/Waymo convention)
            pts = np.fromfile(f, np.float32).reshape(-1, 4)[:, :3].astype(np.float64)
        yield {"points": pts, "pose": poses[i], "frame_id": f.stem}


def process_waymo(
    data_root, sequence: str, output_root,
    cfg: SequenceProcessingConfig | None = None, max_frames: int = 0,
) -> list[str]:
    """Waymo sequence (pre-extracted frames) -> submap samples (ref :1599)."""
    cfg = cfg or SequenceProcessingConfig(
        voxel_size=0.3,
        keyframe_min_translation=1.0,
        keyframe_min_rotation_deg=2.0,
    )
    loader = folder_frame_loader(data_root, sequence, max_frames=max_frames)
    return process_sequence(loader, f"waymo_{sequence}", output_root, cfg)


# ---------------------------------------------------------------------------
# TLS static scans (ETH / WHU-TLS; ref :2876-3083)
# ---------------------------------------------------------------------------

def process_tls(
    data_root,
    sequence: str,
    output_dir,
    min_submaps_per_sample: int = 2,
    max_submaps_per_sample: int = 10,
    num_samples: int = 10,
    min_overlap_ratio: float = 0.001,
    max_overlap_ratio: float = 0.8,
    overlap_voxel_size: float = 2.0,
    voxel_size: float = 0.25,
    seed: int = 0,
) -> list[str]:
    """TLS scans -> multi-view samples: every aligned PLY under
    `<root>/<sequence>/` is one static submap; samples are connected groups
    in the pairwise voxel-IoU overlap graph (ref :2876: fixed 1-frame
    submaps + overlap-connected selection)."""
    scan_dir = Path(data_root) / sequence
    files = sorted(scan_dir.glob("*.ply"))
    if len(files) < min_submaps_per_sample:
        logger.warning("%s: only %d scans; nothing to do", sequence, len(files))
        return []
    clouds = [plyio.read_ply(f)["points"].astype(np.float64) for f in files]
    # overlap graph over the coarse voxel grid
    edges = []
    for i in range(len(clouds)):
        for j in range(i + 1, len(clouds)):
            ov = G.voxel_iou_overlap(clouds[i], clouds[j], overlap_voxel_size)
            edges.append(
                {"source_id": files[i].stem, "target_id": files[j].stem,
                 "overlap_ratio": float(ov)}
            )
    nodes = [{"id": f.stem} for f in files]
    groups = generate_connected_groups(
        edges, nodes, num_samples, min_submaps_per_sample,
        max_submaps_per_sample,
        min_overlap_ratio=min_overlap_ratio,
        max_overlap_ratio=max_overlap_ratio,
        seed=seed,
    )
    names = []
    out_root = Path(output_dir)
    for gi, group in enumerate(groups):
        parts = []
        for ni in group:
            pts = clouds[ni]
            if voxel_size > 0:
                pts = voxel_downsample(pts, voxel_size)
            parts.append(pts)
        name = f"{sequence}_tls_{gi:04d}"
        save_training_sample(out_root, name, parts)
        names.append(name)
    logger.info("TLS %s: wrote %d samples", sequence, len(names))
    return names


# ---------------------------------------------------------------------------
# pose-graph connected-group sampling (ref :2153-2373)
# ---------------------------------------------------------------------------

def generate_connected_groups(
    edges: list[dict],
    node_info: list[dict],
    num_groups: int,
    min_group_size: int,
    max_group_size: int,
    min_overlap_ratio: float = 0.01,
    max_overlap_ratio: float = 0.8,
    max_attempts: int = 50,
    same_stage_only: bool = False,
    seed: int = 0,
) -> list[list[int]]:
    """Sample connected node groups from an overlap-edge pose graph.

    edges: {"source_id", "target_id", "overlap_ratio"}; node_info: {"id"
    [, "stage"]}. Each group is a connected subgraph grown by random frontier
    expansion; nodes are not reused across groups. Deterministic under
    ``seed`` (the reference uses global random state).
    """
    if not edges or not node_info:
        return []
    rng = np.random.default_rng(seed)
    node_id_to_idx = {n["id"]: i for i, n in enumerate(node_info)}
    adjacency: dict[int, set[int]] = defaultdict(set)
    for e in edges:
        if not (min_overlap_ratio <= e.get("overlap_ratio", 0.0) <= max_overlap_ratio):
            continue
        a = node_id_to_idx.get(e["source_id"])
        b = node_id_to_idx.get(e["target_id"])
        if a is None or b is None:
            continue
        if same_stage_only and node_info[a].get("stage") != node_info[b].get("stage"):
            continue
        adjacency[a].add(b)
        adjacency[b].add(a)
    if not adjacency:
        logger.warning("no valid edges for group generation")
        return []

    groups: list[list[int]] = []
    used: set[int] = set()
    for _ in range(num_groups):
        best: list[int] | None = None
        for _attempt in range(max_attempts):
            avail = [n for n in adjacency if n not in used]
            if len(avail) < min_group_size:
                break
            target = int(rng.integers(min_group_size, min(max_group_size, len(avail)) + 1))
            start = int(avail[rng.integers(len(avail))])
            group = [start]
            frontier = set(adjacency[start]) - used
            while len(group) < target and frontier:
                nxt = int(rng.choice(sorted(frontier)))
                group.append(nxt)
                frontier |= adjacency[nxt] - used
                frontier -= set(group)
            if len(group) >= min_group_size:
                if best is None or len(group) > len(best):
                    best = group
                if len(best) >= target:
                    break
        if best is None:
            break
        groups.append(sorted(best))
        used.update(best)
    return groups


def process_pose_graph_groups(
    data_root,
    output_dir,
    pose_graph_file: str = "pose_graph.json",
    num_groups: int = 10,
    min_group_size: int = 3,
    max_group_size: int = 6,
    voxel_size: float = 0.1,
    seed: int = 0,
) -> list[str]:
    """Multi-view (>2 part) samples from a pose graph of posed clouds.

    pose_graph.json: {"nodes": [{"id", "file", "pose" (16 floats)
    [, "stage"]}], "edges": [{"source_id", "target_id", "overlap_ratio"}]}.
    Each sampled connected group becomes one sample; clouds are posed into
    the common frame (ref process_nss_multi_dataset :2374).
    """
    data_root = Path(data_root)
    pg = json.loads((data_root / pose_graph_file).read_text())
    nodes, edges = pg["nodes"], pg["edges"]
    groups = generate_connected_groups(
        edges, nodes, num_groups, min_group_size, max_group_size, seed=seed
    )
    names = []
    out_root = Path(output_dir)
    for gi, group in enumerate(groups):
        parts, poses = [], []
        for ni in group:
            n = nodes[ni]
            pts = plyio.read_ply(data_root / n["file"])["points"].astype(np.float64)
            pose = np.array(n["pose"], np.float64).reshape(4, 4)
            pts = G.transform_points(pts, pose)   # into the common frame
            if voxel_size > 0:
                pts = voxel_downsample(pts, voxel_size)
            parts.append(pts)
            poses.append(pose)
        name = f"group_{gi:04d}"
        save_training_sample(out_root, name, parts, poses=poses)
        names.append(name)
    logger.info("pose-graph groups: wrote %d samples", len(names))
    return names
