"""End-to-end registration demo (counterpart of rap_tpu/apps/demo.py).

    python -m rap_tpu_torch.apps.demo -i demo_data/pair -out demo_output
    python -m rap_tpu_torch.apps.demo -i demo_data/pair --device cpu \\
        --features geometric --n-generations 3 --icp-refine

Registers a folder of part PLYs:
  1. load every PLY (optionally turned from a camera frame);
  2. adaptive parameters from the median bounding box: the voxel size by
     scene scale (divisors 200-1200, clamped to [1e-4, 0.4]), des_r = 20
     voxels, the voxel ratio retargeted so the median part samples 500 to
     ``--max-points-per-part`` points;
  3. per part: voxel downsampling, statistical outlier removal, FPS to the
     voxel-adaptive count, local features (zeros, ``geometric`` shape
     factors or MiniSpinNet descriptors);
  4. the evaluation-mode normalisation (``data.dataset.augment_sample``),
     one padded batch from the packer's buckets, ``--n-generations``
     generations through ``registration.sample`` + ``predict_poses``, the
     one with the lowest rigidity RMSE kept (the first of equal ones),
     optionally refined by trimmed ICP onto the anchor part;
  5. the poses re-based to the first part's frame and applied to the
     original clouds: ``registered/*.ply`` and ``part{i}_transform.txt``
     (4x4, metric), and with ``--output-generated`` the generated keypoint
     clouds under ``generated/``.

Runs on the card (``--device cuda``, the default) unless the CPU is asked
for. The noise of generation g comes from a ``torch.Generator`` on the
run's device seeded with ``--seed`` + g (rap_tpu's from
``jax.random.key(seed + g)``); ``run_demo``'s ``noise`` takes the noise
tensors instead. ``--checkpoint`` takes what ``apps.sample.load_params``
reads: an ``.npz`` export, a torch ``.ckpt``/``.pth``/``.pt`` or a
train-state directory. ``--render-results`` (demo.py:339-353) renders the
registered scene, coloured by part, with the z-buffer raster renderer from
two viewpoints (``registered_e25_a45.png``, ``registered_e25_a135.png``).

``--sequence-sharded`` (demo.py:241-251) merges a map over several GPUs,
one process each (``torchrun --nproc-per-node N -m rap_tpu_torch.apps.demo
--sequence-sharded ...``): every rank preprocesses the same scene, the
batch's part slots are padded to a multiple of N and split over the ranks
(``parallel.mesh.shard_batch``), and sampling runs on each rank's parts
with the global attention as ring attention (``registration.sample``'s
``ring_mesh``). Each rank fits its parts' poses; the poses and points are
gathered, and the rigidity pick and ICP onto the anchor (which may lie on
another rank) run on the gathered outputs. The noise is the global draw,
so the result is a world of 1's. Rank 0 writes the files.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .._device import resolve_device
from ..config import load_config
from ..data.dataset import augment_sample
from ..data.packer import N_BUCKETS, P_BUCKETS, _bucket, collate_to_part_batch, pad_to_multiple
from ..eval.metrics import rigidity_rmse
from ..ops import points as P
from ..parallel.distributed import process_group
from ..parallel.mesh import all_gather, make_mesh, shard_batch
from ..registration import predict_poses, refine_poses_icp, sample
from ..utils import ply as plyio
from .sample import _sync, load_params

logger = logging.getLogger("rap_tpu_torch.demo")

REPO = Path(__file__).resolve().parents[2]

# camera frame -> world: z -> x, -x -> y, -y -> z (rap_tpu/dataset_process/
# geometry.py:124, the reference demo's COORDINATE_TRANSFORM)
CAMERA_FRAME_ROTATION = np.array(
    [[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]], np.float32
)


def adaptive_parameters(clouds: list[np.ndarray], voxel_ratio: float = 0.05,
                        max_points_per_part: int = 20_000):
    """(voxel_size, des_r, voxel_ratio) from the scene's scale."""
    bboxes = np.array([c.max(0) - c.min(0) for c in clouds if len(c)])
    median_size = float(np.median(np.median(bboxes, axis=0)))
    for limit, div in [(5, 200), (30, 400), (100, 600), (250, 800), (500, 1000)]:
        if median_size < limit:
            divide = div
            break
    else:
        divide = 1200
    voxel_size = float(np.clip(median_size / divide, 1e-4, 0.4))
    des_r = 20.0 * voxel_size

    coverages = [P.voxel_coverage(c, 4.0 * voxel_size) for c in clouds if len(c)]
    med_cov = float(np.median(coverages))
    med_count = med_cov * voxel_ratio
    if med_count > max_points_per_part:
        voxel_ratio = max_points_per_part / med_cov
        med_count = med_cov * voxel_ratio
    if med_count < 500:
        voxel_ratio = 500 / med_cov
    return voxel_size, des_r, voxel_ratio


def preprocess_parts(
    clouds: list[np.ndarray],
    voxel_size: float,
    voxel_ratio: float,
    des_r: float,
    max_points_per_part: int,
    min_points_per_part: int = 200,
    outlier_removal: bool = True,
    feature_extractor=None,
    rng: np.random.Generator | None = None,
    device="cuda",
):
    """Downsample, clean and FPS each part: (keypoints, features) per part.
    ``feature_extractor(cloud, keypoints, des_r)`` gives the features (zeros
    without one); outlier removal finds its neighbours on ``device``."""
    rng = rng or np.random.default_rng(0)
    down = [P.voxel_downsample(c.astype(np.float32), voxel_size) for c in clouds]
    if outlier_removal:
        down = [c[P.statistical_outlier_removal(c, device=device)] if len(c) > 50 else c
                for c in down]
    counts = P.adaptive_sample_counts(
        down, 4.0 * voxel_size, voxel_ratio, min_points_per_part, max_points_per_part)
    kpts, feats = [], []
    for cloud, k in zip(down, counts):
        k = max(min(k, len(cloud)), 1)
        idx = P.fps_numpy(cloud, k, rng) if len(cloud) > k else np.arange(len(cloud))
        kp = cloud[idx]
        kpts.append(kp)
        if feature_extractor is not None:
            feats.append(np.asarray(feature_extractor(cloud, kp, des_r)))
        else:
            feats.append(np.zeros((len(kp), 32), np.float32))
    return kpts, feats


def _pose_to_metric(R: np.ndarray, t: np.ndarray, scale: float, primary_center: np.ndarray,
                    gt_trans: np.ndarray, cond_offset: np.ndarray) -> np.ndarray:
    """4x4 metric transform of an original part cloud into the registered
    scene, from the scaled-space pose (R, t). The normalisation maps orig
    -> cond = (orig - pc)/s - o (o = gt_trans + the part's centre, 0 for the
    anchor); the model maps cond -> R cond + t; metric(x) = s (x + gt_trans)
    + pc. Composed: registered = R orig + [s (t + g) + pc - R (pc + s o)]."""
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = scale * (t + gt_trans) + primary_center - R @ (primary_center + scale * cond_offset)
    return T


def _feature_extractor(args, device, record):
    """The --features callable, timed per part into record['feature_ms']."""
    if args.features == "spinnet":
        from ..spinnet import build_feature_extractor

        fn = build_feature_extractor(args.spinnet_checkpoint, device=device)
    elif args.features == "geometric":
        from ..data.synthetic_scenes import compute_geometric_features

        def fn(cloud, kp, r):
            return compute_geometric_features(kp)
    else:
        return None

    def timed(cloud, kp, r):
        _sync(device)
        t0 = time.perf_counter()
        out = fn(cloud, kp, r)
        record["feature_ms"].append((time.perf_counter() - t0) * 1e3)
        record["clouds"].append(cloud)
        return out

    return timed


def run_demo(args, noise: list[torch.Tensor] | None = None, record: dict | None = None) -> int:
    """The demo on ``args`` (``main``'s flags). ``noise``: one (G, N, 3)
    tensor per generation in place of the seeded draws. ``record``, if
    given, receives des_r, the config, the keypoints, features and feature clouds per part,
    the batch, each generation's (points, R, t, rigidity RMSE), the kept
    generation's index and poses, the transforms and the timings
    (preprocessing s, feature ms per part, generation ms, ICP ms); with
    ``--sequence-sharded`` also this rank's shard of the batch."""
    device = resolve_device(args.device)
    if not args.sequence_sharded:
        return _demo(args, device, None, noise, record)
    with process_group(device):
        return _demo(args, device, make_mesh(device=device), noise, record)


def _demo(args, device, mesh, noise, record) -> int:
    rank = 0 if mesh is None else mesh.rank
    if mesh is not None:
        device = mesh.device
    rec = record if record is not None else {}
    rec.update(feature_ms=[], clouds=[], gen_ms=[], generations=[], icp_ms=0.0)
    in_dir = Path(args.input)
    ply_files = sorted(in_dir.glob("*.ply"))
    if len(ply_files) < 2:
        logger.error("need at least 2 PLY parts in %s", in_dir)
        return 1
    out_dir = Path(args.output)
    if rank == 0:
        out_dir.mkdir(parents=True, exist_ok=True)
    if args.n_generations < 1:
        logger.error("--n-generations must be >= 1 (got %d)", args.n_generations)
        return 1
    originals = []
    for f in ply_files:
        pts = plyio.read_ply_points(f)
        if len(pts) == 0:
            logger.error("%s has zero points — remove or fix the input", f.name)
            return 1
        if args.camera_frame:
            pts = pts @ CAMERA_FRAME_ROTATION.T
        originals.append(pts)
        logger.info("loaded %s: %d points", f.name, len(pts))

    # --- adaptive preprocessing ------------------------------------------
    if args.adaptive_parameters:
        voxel_size, des_r, voxel_ratio = adaptive_parameters(
            originals, args.voxel_ratio, args.max_points_per_part)
    else:
        voxel_size, des_r, voxel_ratio = args.voxel_size, args.des_r, args.voxel_ratio
    logger.info("voxel_size=%.4f des_r=%.3f voxel_ratio=%.5f", voxel_size, des_r, voxel_ratio)
    rec["des_r"] = des_r
    feature_extractor = _feature_extractor(args, device, rec)
    t0 = time.perf_counter()
    kpts, feats = preprocess_parts(
        originals, voxel_size, voxel_ratio, des_r, args.max_points_per_part,
        outlier_removal=not args.no_outlier_removal, feature_extractor=feature_extractor,
        rng=np.random.default_rng(args.seed), device=device)
    rec.update(preprocess_s=time.perf_counter() - t0, keypoints=kpts, features=feats)
    logger.info("preprocessing: %.1fs; keypoints per part: %s", rec["preprocess_s"],
                [len(k) for k in kpts])

    # --- normalisation (the evaluation-mode label contract) ---------------
    smp = augment_sample(
        name=in_dir.name, dataset_name="demo", index=0,
        parts_gt=[k.astype(np.float64) for k in kpts], features=feats,
        rng=np.random.default_rng(args.seed), train=False)
    primary = smp.anchor_idx
    primary_center = kpts[primary].mean(0)
    gt_trans = -np.asarray(smp.translations[primary], np.float64)
    cond_offsets = [np.asarray(smp.translations[i], np.float64) + gt_trans
                    for i in range(len(kpts))]

    # --- model --------------------------------------------------------------
    cfg = load_config(args.config, [
        f"model_name={args.model}",
        f"pipeline.inference_sampling_steps={args.num_steps}",
        f"pipeline.n_generations={args.n_generations}",
        f"pipeline.rigidity_forcing={str(args.rigidity_forcing).lower()}",
    ] + (args.override or []))
    if args.checkpoint:
        cfg = dataclasses.replace(cfg, checkpoint=args.checkpoint)
    params = load_params(cfg, device)
    rec["config"] = cfg
    N = _bucket(smp.max_part_points, N_BUCKETS)
    Pp = _bucket(smp.num_parts, P_BUCKETS)
    if mesh is not None:  # every rank holds the same number of part slots
        Pp = pad_to_multiple(Pp, mesh.size)
    batch, _ = collate_to_part_batch([smp], N=N, P=Pp, device=device)
    rec["batch"] = batch
    logger.info("batch (S, P, N) = (1, %d, %d)", Pp, N)
    shard = batch
    if mesh is not None:
        shard = rec["shard"] = shard_batch(batch, mesh)
        logger.info("sequence-sharded over %d ranks (ring attention): %d parts a rank",
                    mesh.size, shard.G)

    # --- generations, the rigidity-RMSE pick, ICP ----------------------------
    logger.info("registering (%d steps, %d generation(s))...", args.num_steps,
                args.n_generations)
    best = None
    for g in range(args.n_generations):
        gen = torch.Generator(device=device).manual_seed(args.seed + g)
        _sync(device)
        t0 = time.perf_counter()
        out = sample(params, cfg.pipeline, shard, generator=gen,
                     x_1=None if noise is None else noise[g].to(device),
                     return_trajectory=False, ring_mesh=mesh)
        if mesh is None:
            R, t = predict_poses(batch, out["points"])
        else:  # each rank's parts, then the poses of all of them
            lo = mesh.rank * shard.G
            R, t = (all_gather(a, mesh) for a in
                    predict_poses(shard, out["points"][lo:lo + shard.G]))
        rig = rigidity_rmse(batch, out["points"], R, t)[0]
        _sync(device)
        rec["gen_ms"].append((time.perf_counter() - t0) * 1e3)
        cand = (out["points"], R, t, float(rig))
        rec["generations"].append(cand)
        logger.info("generation %d: rigidity RMSE %.4f m", g, cand[3])
        if best is None or cand[3] < best[3]:
            best, rec["pick"] = cand, g
    pts, R_all, t_all, _ = best
    if args.icp_refine:
        _sync(device)
        t0 = time.perf_counter()
        R_all, t_all = refine_poses_icp(batch, R_all, t_all, yaw_restarts=args.icp_restarts)
        _sync(device)
        rec["icp_ms"] = (time.perf_counter() - t0) * 1e3
    rec["poses"] = (R_all, t_all)
    logger.info("registration: %.1fs", (sum(rec["gen_ms"]) + rec["icp_ms"]) / 1e3)
    pts, R_all, t_all = (a.float().cpu().numpy() for a in (pts, R_all, t_all))

    # --- apply the poses to the original clouds, re-based to part 0 ---------
    Ts = [_pose_to_metric(R_all[p], t_all[p], smp.scale, primary_center, gt_trans,
                          cond_offsets[p]) for p in range(smp.num_parts)]
    T0_inv = np.linalg.inv(Ts[0])
    rec["transforms"] = [T0_inv @ T for T in Ts]
    if rank != 0:
        return 0
    reg_dir = out_dir / "registered"
    reg_dir.mkdir(exist_ok=True)
    regs = []
    for p, (f, orig, T) in enumerate(zip(ply_files, originals, rec["transforms"])):
        regs.append(orig @ T[:3, :3].T + T[:3, 3])
        plyio.write_ply(reg_dir / f.name, regs[-1])
        np.savetxt(out_dir / f"part{p}_transform.txt", T, fmt="%.8f")
        logger.info("part %d (%s): |t|=%.3f m", p, f.name, np.linalg.norm(T[:3, 3]))
    logger.info("registered clouds written to %s", reg_dir)

    if args.output_generated:
        gen_dir = out_dir / "generated"
        gen_dir.mkdir(exist_ok=True)
        mask = batch.point_mask.cpu().numpy()
        for p, f in enumerate(ply_files):
            metric = smp.scale * (pts[p][mask[p]] + gt_trans) + primary_center
            metric = metric @ T0_inv[:3, :3].T + T0_inv[:3, 3]
            plyio.write_ply(gen_dir / f.name, metric.astype(np.float32))
        logger.info("generated keypoint clouds written to %s", gen_dir)

    if args.render_results:
        from ..utils.render import part_ids_to_colors, render_point_cloud_raster, save_image

        cols = part_ids_to_colors(np.concatenate([np.full(len(r), i)
                                                  for i, r in enumerate(regs)]))
        merged = np.concatenate(regs)
        for elev, azim in ((25, 45), (25, 135)):
            img = render_point_cloud_raster(merged, cols, image_size=800, elev=elev, azim=azim)
            save_image(out_dir / f"registered_e{elev}_a{azim}.png", img)
        logger.info("registered-scene renders written to %s", out_dir)
    return 0


def main(argv=None, noise: list[torch.Tensor] | None = None, record: dict | None = None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-i", "--input", default=str(REPO / "demo_data" / "pair"),
                    help="folder of part PLYs (default: the bundled demo pair)")
    ap.add_argument("-out", "--output", default="demo_output")
    ap.add_argument("--config", default=str(REPO / "configs" / "rap_inference.yaml"))
    ap.add_argument("--checkpoint", default="",
                    help=".npz parameters, a torch .ckpt/.pth/.pt or a train-state "
                         "directory; none: random weights")
    ap.add_argument("--model", default="rap_12")
    ap.add_argument("--num-steps", type=int, default=10)
    ap.add_argument("--n-generations", type=int, default=1)
    ap.add_argument("--rigidity-forcing", action="store_true", default=True)
    ap.add_argument("--no-rigidity-forcing", dest="rigidity_forcing", action="store_false")
    ap.add_argument("--icp-refine", action="store_true",
                    help="refine the kept poses by trimmed ICP onto the anchor part")
    ap.add_argument("--icp-restarts", type=int, default=1,
                    help="with --icp-refine: K yaw-rotated ICP starts per part, the lowest "
                         "trimmed residual kept")
    ap.add_argument("--adaptive-parameters", action="store_true", default=True)
    ap.add_argument("--no-adaptive-parameters", dest="adaptive_parameters",
                    action="store_false")
    ap.add_argument("--voxel-size", type=float, default=0.25)
    ap.add_argument("--des-r", type=float, default=5.0)
    ap.add_argument("--voxel-ratio", type=float, default=0.05)
    ap.add_argument("--max-points-per-part", type=int, default=20_000)
    ap.add_argument("--no-outlier-removal", action="store_true")
    ap.add_argument("--features", choices=["zero", "spinnet", "geometric"], default="zero")
    ap.add_argument("--spinnet-checkpoint", default="",
                    help="a SpinNet .pth; none: random descriptor weights")
    ap.add_argument("--camera-frame", action="store_true")
    ap.add_argument("--output-generated", action="store_true",
                    help="also write the generated keypoint clouds")
    ap.add_argument("--render-results", action="store_true",
                    help="render part-coloured PNGs of the registered scene")
    ap.add_argument("--sequence-sharded", action="store_true",
                    help="shard the parts and the global attention over the world's ranks "
                         "(launch one process per GPU with torchrun)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    ap.add_argument("-o", "--override", action="append", default=[])
    return run_demo(ap.parse_args(argv), noise=noise, record=record)


if __name__ == "__main__":
    sys.exit(main())
