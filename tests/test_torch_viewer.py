"""The port's viewers (rap_tpu_torch/apps/viewer.py, html_viewer.py) against
rap_tpu's on the CPU.

Both read the same result folders, made by the port's own entry points: the
``eval.save_results`` artifacts of ``apps.sample`` (1 layer, fp32, 2 pairs
of demo_data/synth) and the output folder of ``apps.demo``; and a folder of
training samples from the port's scene generator. The viewers are copies:
every PNG, GIF and HTML they write is byte-identical to rap_tpu's, through
the CLI (``main``) and the functions (orbit GIFs, compare panels, applied
poses, the HTML export with its pose toggle).
"""

from pathlib import Path

import numpy as np
import pytest

from rap_tpu.apps import html_viewer as JH
from rap_tpu.apps import viewer as JV
from rap_tpu_torch.apps import html_viewer as TH
from rap_tpu_torch.apps import viewer as TV
from rap_tpu_torch.utils import ply as plyio

REPO = Path(__file__).resolve().parents[1]


def _files(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """The port's result folders: apps.sample artifacts, an apps.demo
    output, generated training samples."""
    from rap_tpu_torch.apps import demo, sample
    from rap_tpu_torch.data.synthetic_scenes import generate_dataset

    root = tmp_path_factory.mktemp("viewer")
    sample.main(["--config", str(REPO / "configs" / "synth_student.yaml"), "-o", "checkpoint=",
                 "-o", f"data.datasets.0.data_path={REPO / 'demo_data' / 'synth'}",
                 "-o", "data.datasets.0.limit_val_samples=2", "-o", "model.num_layers=1",
                 "-o", "pipeline.inference_sampling_steps=1", "-o", "model.compute_dtype=float32",
                 "-o", "eval.save_results=true", "-o", "eval.save_pointcloud_parts=true",
                 "-o", f"eval.output_dir={root / 'results'}", "--device", "cpu"])
    rng = np.random.default_rng(7)
    scene = rng.uniform(0, 2, (400, 3)).astype(np.float32)
    (root / "in").mkdir()
    plyio.write_ply(root / "in" / "a.ply", scene[:300])
    plyio.write_ply(root / "in" / "b.ply", scene[100:] + 0.2)
    assert demo.main(["-i", str(root / "in"), "-out", str(root / "demo"), "--device", "cpu",
                      "--num-steps", "1", "--max-points-per-part", "128", "-o",
                      "model.num_layers=1", "-o", "model.embed_dim=64", "-o",
                      "model.num_heads=4", "-o", "model.compute_dtype=float32"]) == 0
    generate_dataset(root / "data", n_scenes=2, max_points_per_view=64, seed=1)
    [res] = [p for p in (root / "results").iterdir() if p.is_dir()]
    return {"results": res, "demo": root / "demo", "data": root / "data", "inputs": root / "in"}


@pytest.mark.parametrize("case", ["results", "results_html", "demo", "samples"])
def test_cli_writes_rap_tpus_files(folders, tmp_path, case):
    argv = {
        "results": ["results", "--results-dir", str(folders["results"]), "--renderer",
                    "raster", "--orbit", "3"],
        "results_html": ["results", "--results-dir", str(folders["results"]), "--renderer",
                         "shaded", "--limit", "1"],
        "demo": ["results", "--results-dir", str(folders["demo"]), "--renderer", "raster",
                 "--apply-poses", "--input-dir", str(folders["inputs"]), "--compare"],
        "samples": ["samples", "--data-dir", str(folders["data"])],
    }[case]
    for mod, who in ((JV, "j"), (TV, "t")):
        extra = ["--html", str(tmp_path / who / "v.html")] if case != "demo" else []
        assert mod.main(argv + ["-o", str(tmp_path / who / "out")] + extra) == 0
    got, ref = _files(tmp_path / "t"), _files(tmp_path / "j")
    assert sorted(got) == sorted(ref) and len(got) >= 2
    for k in ref:
        assert got[k] == ref[k], k


def test_functions_agree(folders, tmp_path):
    [sd] = TV.discover_result_samples(folders["demo"])
    rs_t, rs_j = TV.load_result_sample(sd), JV.load_result_sample(sd)
    assert rs_t.part_indices == rs_j.part_indices
    assert all(np.array_equal(a, b) for a, b in zip(rs_t.parts, rs_j.parts))
    inputs = [plyio.read_ply_points(folders["inputs"] / n) for n in ("a.ply", "b.ply")]
    moved_t = TV.apply_estimated_poses(inputs, [0, 1], rs_t.transforms)
    moved_j = JV.apply_estimated_poses(inputs, [0, 1], rs_j.transforms)
    assert all(np.array_equal(a, b) for a, b in zip(moved_t, moved_j))
    rng = np.random.default_rng(0)
    parts = [rng.standard_normal((500, 3)), rng.standard_normal((300, 3))]
    feats = [rng.standard_normal((len(p), 8)).astype(np.float32) for p in parts]
    for M, who in ((JH, "j"), (TH, "t")):
        s, _ = M.build_sample("pair", parts, features=feats, parts_alt=[p + 1 for p in parts],
                              max_points=400)
        M.export_html([s], tmp_path / f"{who}.html")
    assert (tmp_path / "t.html").read_bytes() == (tmp_path / "j.html").read_bytes()
