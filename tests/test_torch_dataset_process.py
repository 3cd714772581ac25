"""The port's offline data pipeline (rap_tpu_torch/dataset_process) against
rap_tpu's on the CPU.

The host modules are copies: each pipeline runs in both packages on the
same tiny fabricated layout in ``tmp_path`` (tests/test_datasets_offline.py
builds them: 3DMatch test pairs, KITTI, NSS and its MIT / TIERS tiers, a
folder of frames (Waymo layout), TLS scans, pose-graph groups, the dry-run
preview) and the written trees are byte-identical, the returned names and
statistics equal. rap_tpu's voxel downsampling runs its numpy path (the
port follows it; its C++ core orders voxels otherwise).

Feature extraction: ``SampleProcessor`` / ``process_dataset_folder`` with
MiniSpinNet (rap_tpu's random weights carried over by
``spinnet_params_from_jax``, 64-point patches to keep it small) give equal
keypoints, PLY, split and num_points files, and descriptors within 1e-5; an
HDF5 conversion holds the same arrays. A data fault in the extractor takes
the zero fallback and is counted; a RuntimeError (what a CUDA or launch
error raises) propagates.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import rap_tpu.native
from rap_tpu.dataset_process import datasets as JD
from rap_tpu.dataset_process import extract_features as JX
from rap_tpu.dataset_process import preview as JP
from rap_tpu.dataset_process.process import SequenceProcessingConfig as JSeqCfg
from rap_tpu.spinnet import model as JS
from rap_tpu_torch.dataset_process import datasets as TD
from rap_tpu_torch.dataset_process import extract_features as TX
from rap_tpu_torch.dataset_process import preview as TP
from rap_tpu_torch.dataset_process.process import SequenceProcessingConfig as TSeqCfg
from rap_tpu_torch.spinnet import model as TS
from rap_tpu_torch.utils import ply as plyio
from rap_tpu_torch.weights import spinnet_params_from_jax
from test_datasets_offline import TestKitti, TestNSS, _rt, _write_gt_log
from torch_parity import max_err

K = 64


@pytest.fixture(autouse=True)
def numpy_path(monkeypatch):
    """rap_tpu without its C++ core: the numpy voxel and FPS fallbacks."""
    monkeypatch.setattr(rap_tpu.native, "_LIB", None)
    monkeypatch.setattr(rap_tpu.native, "_TRIED", True)


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def _same_trees(a, b):
    got, ref = _files(a), _files(b)
    assert sorted(got) == sorted(ref) and got, (sorted(got), sorted(ref))
    for k in ref:
        assert got[k] == ref[k], k
    return ref


def _seq_cfg(cls, **kw):
    return cls(min_frames_per_submap=2, max_frames_per_submap=3, submaps_per_sample=2,
               samples_per_sequence=2, keyframe_min_translation=0.0, **kw)


def _threedmatch(root):
    rng = np.random.default_rng(0)
    seq = "7-scenes-redkitchen"
    frag = root / "test" / seq
    frag.mkdir(parents=True)
    base = rng.standard_normal((500, 3)).astype(np.float32)
    T01 = _rt(20, t=(0.5, 0, 0))
    plyio.write_ply(frag / "cloud_bin_0.ply", (base @ T01[:3, :3].T + T01[:3, 3])
                    .astype(np.float32))
    plyio.write_ply(frag / "cloud_bin_1.ply", base)
    plyio.write_ply(frag / "cloud_bin_2.ply", base + 0.1)
    _write_gt_log(root / "test" / "3DMatch" / "gt_result" / seq,
                  [(0, 1, T01), (1, 2, _rt(-10, "y", t=(0, 0.2, 0)))])
    return seq


def _folder_frames(root, seq="w0", n=8):
    rng = np.random.default_rng(5)
    (root / seq / "frames").mkdir(parents=True)
    poses = []
    for i in range(n):
        pts = rng.standard_normal((200, 3)).astype(np.float32) * 5
        plyio.write_ply(root / seq / "frames" / f"{i:03d}.ply", pts)
        poses.append(" ".join(f"{x:.8f}" for x in _rt(3 * i, t=(2.0 * i, 0, 0)).reshape(-1)))
    (root / seq / "poses.txt").write_text("\n".join(poses) + "\n")


def _tls(root):
    rng = np.random.default_rng(6)
    scans = root / "ETH"
    scans.mkdir(parents=True)
    base = rng.uniform(0, 10, (800, 3)).astype(np.float32)
    for i in range(3):
        plyio.write_ply(scans / f"scan_{i}.ply", base + [2.0 * i, 0, 0])
    plyio.write_ply(scans / "scan_far.ply", base + [500.0, 0, 0])


def _pose_graph(root):
    rng = np.random.default_rng(3)
    root.mkdir(parents=True, exist_ok=True)
    nodes = []
    for i in range(5):
        plyio.write_ply(root / f"c{i}.ply", rng.standard_normal((100, 3)).astype(np.float32))
        nodes.append({"id": f"n{i}", "file": f"c{i}.ply", "stage": i % 2,
                      "pose": [float(x) for x in _rt(5 * i, t=(i, 0, 0)).reshape(-1)]})
    edges = [{"source_id": f"n{i}", "target_id": f"n{i + 1}", "overlap_ratio": 0.5}
             for i in range(4)]
    (root / "pose_graph.json").write_text(json.dumps({"nodes": nodes, "edges": edges}))


# (writer, run(module, seq_cfg_class, data root, out dir) -> result)
PIPELINES = {
    "threedmatch": (_threedmatch, lambda M, C, d, o: M.process_threedmatch_test(
        d, "7-scenes-redkitchen", o, cfg=M.PairProcessingConfig(voxel_size=0.05))),
    "kitti": (lambda d: TestKitti()._write_kitti(d, n_frames=10), lambda M, C, d, o:
              M.process_kitti(d, "00", o, cfg=_seq_cfg(C, voxel_size=0.5))),
    "nss": (lambda d: TestNSS()._write_nss(d), lambda M, C, d, o: M.process_nss(
        d, o, cfg=M.PairProcessingConfig(voxel_size=0.0, min_overlap_ratio=0.1,
                                         max_overlap_ratio=0.8))),
    "mit": (lambda d: TestNSS()._write_nss(d) or (d / "pairs_benchmark.json").write_text(
        (d / "pairs_train.json").read_text()), lambda M, C, d, o: M.process_mit(
        d, o, cfg=M.PairProcessingConfig(voxel_size=0.0, min_overlap_ratio=0.0,
                                         max_overlap_ratio=1.0))),
    "waymo": (_folder_frames, lambda M, C, d, o: M.process_waymo(
        d, "w0", o, cfg=_seq_cfg(C, voxel_size=0.3))),
    "tls": (_tls, lambda M, C, d, o: M.process_tls(
        d, "ETH", o, min_submaps_per_sample=2, max_submaps_per_sample=3, num_samples=2,
        overlap_voxel_size=2.0, voxel_size=0.5)),
    "pose_graph": (_pose_graph, lambda M, C, d, o: M.process_pose_graph_groups(
        d, o, num_groups=2, min_group_size=2, max_group_size=3, voxel_size=0.2)),
}


@pytest.mark.parametrize("name", list(PIPELINES))
def test_pipeline_writes_rap_tpus_files(tmp_path, name):
    write, run = PIPELINES[name]
    write(tmp_path / "data")
    ref = run(JD, JSeqCfg, tmp_path / "data", tmp_path / "j")
    got = run(TD, TSeqCfg, tmp_path / "data", tmp_path / "t")
    assert got == ref and ref
    files = _same_trees(tmp_path / "t", tmp_path / "j")
    assert any(k.endswith(".ply") for k in files)


def test_groups_and_gt_graph_are_equal(tmp_path):
    nodes = [{"id": f"n{i}", "stage": 0 if i < 4 else 1} for i in range(8)]
    edges = [{"source_id": f"n{i}", "target_id": f"n{j}", "overlap_ratio": 0.1 + 0.05 * j}
             for i in range(8) for j in range(i + 1, 8)]
    for kw in ({}, {"same_stage_only": True},
               {"min_overlap_ratio": 0.3, "max_overlap_ratio": 0.4}):
        kw = {"num_groups": 3, "min_group_size": 2, "max_group_size": 3, "seed": 4, **kw}
        assert TD.generate_connected_groups(edges, nodes, **kw) == \
            JD.generate_connected_groups(edges, nodes, **kw)
    _write_gt_log(tmp_path, [(0, 1, _rt(10, t=(1, 0, 0))), (1, 2, _rt(-25, "y"))])
    gj, gt = (M.build_transform_graph(M.load_gt_log(tmp_path)) for M in (JD, TD))
    assert gj.keys() == gt.keys() and all(np.array_equal(gj[k], gt[k]) for k in gj)
    assert np.array_equal(TD.find_transformation_path("cloud_bin_0", "cloud_bin_2", gt),
                          JD.find_transformation_path("cloud_bin_0", "cloud_bin_2", gj))


def test_dry_run_preview_is_equal(tmp_path):
    TestKitti()._write_kitti(tmp_path, n_frames=6)
    reps = [P.dry_run(tmp_path, tmp_path / "out", ["00", "01"], P.kitti_sequence_info(tmp_path),
                      samples_per_sequence=5, max_samples_per_sequence=3) for P in (JP, TP)]
    assert dataclasses.asdict(reps[1]) == dataclasses.asdict(reps[0])
    assert not reps[1].ok and reps[1].total_samples == 3
    by_seq = {s: [f"{s}/x{i}" for i in range(5)] for s in ("a", "b", "c")}
    for kw in ({"val_sequences": ["b"]}, {"val_fraction": 0.34, "seed": 1}):
        assert TP.preview_splits(by_seq, **kw) == JP.preview_splits(by_seq, **kw)


def _extractors(aligned: bool = True):
    """rap_tpu's MiniSpinNet (random weights, key 0) and the port's with the
    same weights, both with 64-point patches, as (cloud, keypoints, des_r)
    callables."""
    jcfg = JS.SpinNetConfig(num_points_per_patch=K, is_aligned_to_global_z=aligned)
    jp = JS.init_spinnet_params(jax.random.key(0), jcfg)
    net = TS.MiniSpinNet(TS.SpinNetConfig(num_points_per_patch=K,
                                          is_aligned_to_global_z=aligned))
    net.load_state_dict(spinnet_params_from_jax(jax.tree.map(np.asarray, jp)))
    net.eval()
    return (lambda c, k, r: JS.extract_features(jp, jcfg, c, k, r),
            lambda c, k, r: TS.extract_features(net, c, k, r))


def _raw_samples(root, n=3):
    rng = np.random.default_rng(9)
    for s in range(n):
        d = root / f"seq{s % 2}" / f"s{s}"
        d.mkdir(parents=True)
        for p in range(2):
            pts = rng.uniform(0, 3, (400 + 50 * p, 3)).astype(np.float32)
            pts[:3] += 40.0  # far outliers the removal drops
            plyio.write_ply(d / f"part_{p:02d}.ply", pts)


@pytest.mark.parametrize("allocation", ["voxel_adaptive", "point_count"])
def test_process_dataset_folder_with_spinnet_matches(tmp_path, allocation):
    _raw_samples(tmp_path / "raw")
    jx, tx = _extractors()
    cfg_kw = dict(allocation=allocation, num_points=300, min_points_per_part=40,
                  max_points_per_part=200, voxel_size=0.3, voxel_ratio=0.5, des_r=0.8,
                  outlier_neighbors=8, seed=3)
    JX.process_dataset_folder(tmp_path / "raw", tmp_path / "j", JX.SampleProcessorConfig(**cfg_kw),
                              jx, val_fraction=0.34, to_hdf5=tmp_path / "j.h5",
                              dataset_name="x")
    meta = TX.process_dataset_folder(tmp_path / "raw", tmp_path / "t",
                                     TX.SampleProcessorConfig(**cfg_kw), tx, val_fraction=0.34,
                                     to_hdf5=tmp_path / "t.h5", dataset_name="x", device="cpu")
    assert meta["fallbacks"] == {"outlier_removal": 0, "features": 0}
    got, ref = _files(tmp_path / "t"), _files(tmp_path / "j")
    assert sorted(got) == sorted(ref)
    n_feat = 0
    for k in ref:
        if "features_" in k:
            n_feat += 1
            a, b = np.load(tmp_path / "t" / k), np.load(tmp_path / "j" / k)
            assert a.shape == b.shape and max_err(a, b) <= 1e-5, k
            assert np.linalg.norm(a, axis=1).min() > 0.5  # descriptors, not zeros
        elif k != "metadata.json":  # it holds the run's seconds
            assert got[k] == ref[k], k
    assert n_feat == 6
    h5py = pytest.importorskip("h5py")
    with h5py.File(tmp_path / "t.h5") as ht, h5py.File(tmp_path / "j.h5") as hj:
        names = []
        hj.visit(names.append)
        tnames = []
        ht.visit(tnames.append)
        assert names == tnames
        for n in names:
            if isinstance(hj[n], h5py.Dataset):
                tol = 1e-5 if n.endswith("features") else 0
                assert hj[n].shape == ht[n].shape and max_err(ht[n][()], hj[n][()]) <= tol \
                    if hj[n].dtype.kind == "f" else np.array_equal(ht[n][()], hj[n][()]), n


def test_extractor_faults(tmp_path):
    _raw_samples(tmp_path / "raw", n=1)
    cfg = TX.SampleProcessorConfig(max_points_per_part=100, min_points_per_part=20)
    parts = [plyio.read_ply_points(f) for f in sorted((tmp_path / "raw").rglob("*.ply"))]

    def data_fault(c, k, r):
        raise ValueError("degenerate patch")

    proc = TX.SampleProcessor(cfg, data_fault, device="cpu")
    kp, feats = proc.process_sample(parts, np.random.default_rng(0))
    assert proc.fallbacks == {"outlier_removal": 0, "features": 2}
    assert all(f.shape == (len(k), 32) and not f.any() for f, k in zip(feats, kp))
    # rap_tpu degrades the same data fault the same way
    jkp, jfeats = JX.SampleProcessor(JX.SampleProcessorConfig(max_points_per_part=100,
                                                              min_points_per_part=20),
                                     data_fault).process_sample(parts,
                                                                np.random.default_rng(0))
    assert all(np.array_equal(a, b) for a, b in zip(kp, jkp))

    def device_fault(c, k, r):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")  # a RuntimeError

    with pytest.raises(RuntimeError, match="out of memory"):
        TX.SampleProcessor(cfg, device_fault, device="cpu").process_sample(
            parts, np.random.default_rng(0))


def test_main_without_features_runs_on_the_host(tmp_path):
    _raw_samples(tmp_path / "raw", n=2)
    meta = TX.main(["--input", str(tmp_path / "raw"), "--output", str(tmp_path / "out"),
                    "--no-features", "--max-points-per-part", "100", "--voxel-size", "0.3"])
    assert meta["num_samples"] == 2 and not meta["features"]
    assert (tmp_path / "out" / "data_split" / "train.txt").exists()
    if not torch.cuda.is_available():  # features default to the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TX.main(["--input", str(tmp_path / "raw"), "--output", str(tmp_path / "o2")])
