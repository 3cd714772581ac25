"""RAP's published evaluation protocol through the port's batch evaluation
(``apps.sample.run_eval``) on a padded split, against the plain reference
(``benchmark/reference/evaluate.py``) run scene by scene, unpadded, on the
same noise; the evaluation loop's spans and counters; and the benchmark cell
``rap_10.multiview-eval`` run on the CPU at a tiny size.

The split: 3 scenes of 2, 3 and 5 parts of 64-300 points, packed under a
budget of 4096 slots into two padded batches of 2 x 4 and 1 x 8 parts;
a DiT of 2 layers at D 64, 4 heads, float32; 3 generations of 3 Euler steps
with rigidity forcing.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import model_init, run
from benchmark.reference import dit as ref_dit
from benchmark.reference import evaluate as ref_eval
from benchmark.reference import sampler as ref_sampler
from rap_tpu_torch import telemetry
from rap_tpu_torch.apps.sample import run_eval
from rap_tpu_torch.config import load_config
from rap_tpu_torch.data import BatchLoader, LoaderConfig, PointCloudDataset
from rap_tpu_torch.registration import seeded_generator

ROOT = Path(__file__).resolve().parents[1]
CELL = "rap_10.multiview-eval"
SCENES, POINTS, BUDGET = (2, 3, 5), (64, 300), 4096
GENS, STEPS, SEED, DATA_SEED = 3, 3, 11, 5
MODEL = dict(json.loads((ROOT / "benchmark" / "configs" / "rap_10.json").read_text())["model"],
             embed_dim=64, num_layers=2, num_heads=4, ff_hidden=256, compute_dtype="float32")
MODEL_KEYS = ("embed_dim", "num_layers", "num_heads", "local_feat_dim", "multires",
              "scale_emb_on", "qk_norm", "softcap", "time_embed_channels", "compute_dtype")
EVAL_CELL = run.load_file(ROOT / "benchmark" / "drivers" / "multiview_eval.py",
                          "benchmark_driver_multiview_eval")

# Tolerances, program (float32 on the CPU) against the reference (float32,
# its fits and metrics in float64). Both compute the same arithmetic; they
# part by float32 rounding: the program's fits in float32 and its attention
# in another summation order, amplified by 2 layers and 3 forced steps.
POINTS_TOL = 1e-5   # points and translations, absolute; the scenes span ~1
ROTATION_TOL = 1e-4  # rotation entries: an ill-conditioned fit turns its pose more
METRIC_RTOL = 1e-4  # metrics: the program's |x|^2 - 2 x.y + |y|^2 distances lose digits
# rigidity RMSE of forced generations: float32 zero against float64 zero (metres)
RIGIDITY_ATOL = 1e-5


def _config(root: Path):
    dataset = {"data_path": str(root), "dataset_name": "bench", "split": "val",
               "use_random_split": True, "min_parts": 2, "max_parts": 12,
               "feat_dim": MODEL["local_feat_dim"], "seed": DATA_SEED}
    return load_config(None, ["model_name=rap_10"]
                       + [f"model.{k}={MODEL[k]}" for k in MODEL_KEYS] + [
        f"pipeline.inference_sampling_steps={STEPS}", f"pipeline.n_generations={GENS}",
        "pipeline.rigidity_forcing=true", f"data.max_points_per_batch={BUDGET}",
        f"data.datasets=[{dataset!r}]", "eval.save_results=false", f"trainer.seed={SEED}"])


@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    """One ``run_eval`` epoch under a CPU profiler: (split root, scene sizes,
    config, weights, record, spans, counters gained)."""
    root = tmp_path_factory.mktemp("eval_split")
    sizes = EVAL_CELL.write_scenes(root, np.random.default_rng(3), SCENES, POINTS, 4000,
                                MODEL["local_feat_dim"])
    cfg = _config(root)
    params = model_init.make_params(MODEL, 0, torch.device("cpu"))
    rec: dict = {}
    with telemetry.counted() as gained, profile(activities=[ProfilerActivity.CPU]) as prof:
        run_eval(cfg, params=params, device="cpu", record=rec)
    spans = [e for e in prof.events() if e.name.startswith("rap.")]
    return root, sizes, cfg, params, rec, spans, gained


def test_the_split_packs_into_padded_batches(evaluated):
    _, sizes, _, _, rec, _, _ = evaluated
    shapes = [(len(names), gens[0][0].shape[0] // len(names), gens[0][0].shape[1])
              for names, gens in rec["outputs"]]
    # parts and points each up their ladder of powers of two
    largest = [max(n for name in names for n in sizes[name]) for names, _ in rec["outputs"]]
    assert shapes == [(2, 4, 1 << (largest[0] - 1).bit_length()),
                      (1, 8, 1 << (largest[1] - 1).bit_length())]
    assert sorted(len(s) for s in sizes.values()) == list(SCENES)


def _scene_outputs(rec, sizes):
    """(name, batch index, slot of its first part) of every scene."""
    for b, (names, gens) in enumerate(rec["outputs"]):
        P = gens[0][0].shape[0] // len(names)
        for s, name in enumerate(names):
            yield name, b, s, s * P


def test_padded_run_eval_matches_the_unpadded_reference(evaluated):
    root, sizes, _, params, rec, _, _ = evaluated
    names = list(sizes)
    for name, b, s, g0 in _scene_outputs(rec, sizes):
        gens = rec["outputs"][b][1]
        gen_metrics, agg = rec["metrics"][b]
        n = sizes[name]
        scene = ref_eval.load_scene(root, name, names.index(name), DATA_SEED)
        rows = slice(g0, g0 + len(n))
        # each generation's noise as run_eval drew it, the scene's slots cut out
        noises = [torch.randn(gens[g][0].shape,
                              generator=seeded_generator("cpu", SEED, b, g))[rows, :max(n)]
                  for g in range(GENS)]
        ref = ref_eval.evaluate_scene(params, MODEL, scene, noises, STEPS)
        mask = ref_eval.scene_batch(scene, "cpu")["point_mask"]
        for g, ((pts, R, t), (pts_r, R_r, t_r, m_r)) in enumerate(zip(gens, ref["generations"])):
            d = (pts[rows, :max(n)] - pts_r)[mask]
            assert float(d.abs().max()) < POINTS_TOL, (name, g)
            assert float((t[rows] - t_r).abs().max()) < POINTS_TOL, (name, g)
            assert float((R[rows] - R_r).abs().max()) < ROTATION_TOL, (name, g)
            for k, v in m_r.items():
                got = float(gen_metrics[g][k][s])
                if k.startswith("recall"):
                    assert got == v, (name, g, k)
                elif k.startswith("rigidity"):
                    assert abs(got - v) < RIGIDITY_ATOL, (name, g, k)
                else:
                    assert abs(got - v) <= METRIC_RTOL * abs(v), (name, g, k, got, v)
        assert int(agg["rigidity_selected_gen"][s]) == ref["selected"], name
        for k, v in ref["best_of"].items():
            got = float(agg[f"best_of_{GENS}"][k][s])
            if k.startswith("rigidity"):
                assert abs(got - v) < RIGIDITY_ATOL, (name, k)
            else:
                assert abs(got - v) <= METRIC_RTOL * abs(v), (name, k, got, v)
        for k, v in ref["rigidity_selected"].items():
            if not k.startswith("rigidity"):
                assert abs(float(agg["rigidity_selected"][k][s]) - v) <= METRIC_RTOL * abs(v)


def test_the_reference_generation_is_the_reference_sampler(evaluated):
    root, sizes, _, params, _, _, _ = evaluated
    name = list(sizes)[1]
    scene = ref_eval.load_scene(root, name, 1, DATA_SEED)
    batch = ref_eval.scene_batch(scene, "cpu")
    x_1 = torch.randn(batch["points"].shape, generator=torch.Generator().manual_seed(2))
    got = ref_eval.generate(params, MODEL, batch, x_1, STEPS)
    want = ref_sampler.sample(params, MODEL, batch, x_1, STEPS, ref_dit.FP32)
    for a, b in zip(got[:3], want):
        assert torch.equal(a, b)
    assert len(got[3]) == STEPS


def test_pack_counters_are_the_loaders_padding_stats(evaluated):
    root, _, cfg, _, rec, _, gained = evaluated
    loader = BatchLoader([PointCloudDataset(cfg.data.datasets[0])],
                         LoaderConfig(max_points_per_batch=BUDGET), device="cpu")
    assert len(list(loader.epoch(0))) == len(rec["outputs"])
    stats = loader.padding_stats
    assert gained["pack.points"] == stats.valid_tokens > 0
    assert gained["pack.slots"] == stats.valid_tokens + stats.padded_tokens


def test_sync_eval_counts_three_a_generation(evaluated):
    _, _, _, _, rec, _, gained = evaluated
    assert gained["sync.eval"] == 3 * GENS * len(rec["outputs"])


def test_eval_spans_appear_under_a_profiler(evaluated):
    _, _, _, _, rec, spans, _ = evaluated
    batches = len(rec["outputs"])
    names = [e.name for e in spans]
    assert names.count("rap.eval.batch") == batches
    assert names.count("rap.eval.load") == batches + 1  # the last wait finds the end
    assert names.count("rap.eval.metrics") == batches * (GENS + 1)
    assert names.count("rap.sample") == batches * GENS
    outer = [e for e in spans if e.name == "rap.eval.batch"]
    for e in spans:
        if e.name in ("rap.eval.metrics", "rap.sample"):
            assert any(o.time_range.start <= e.time_range.start
                       and e.time_range.end <= o.time_range.end for o in outer), e.name
    with telemetry.span("rap.eval.batch") as off:
        assert off is None  # no profiler: the shared no-op


TINY_CELL = {
    "config": {"model": {"embed_dim": 64, "num_heads": 4, "num_layers": 2, "ff_hidden": 256,
                         "compute_dtype": "float32"},
               "evaluation": {"steps": 2, "max_points_per_batch": 2048}},
    "params": {"views": [2, 3], "points_per_view": [64, 120], "scene_points": 4000}}


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_the_cell_runs_one_tiny_epoch_on_the_cpu(trace):
    spec = run.benchmark_spec()
    result, compared = run.run(CELL, 2**33 + 29, 0.05, trace, device="cpu",
                               overrides=TINY_CELL)
    assert result["correct"], result["checks"]
    assert {n for n, _, _ in compared} == set(result["checks"]) == {
        "translation", "points_median", "poses_median"}
    if trace:
        listed = {m["name"] for m in spec["per_layer"] if CELL in m.get("workloads", [])}
        assert len(listed) == 8 and all(n.endswith(".eval") for n in listed)
        # the CPU runs no device operation: the device-trace shares but idle read nothing
        assert set(result["metrics"]) == listed - {"attn_roofline.eval", "glue_pct.eval"}
        assert result["metrics"]["idle_pct.eval"]["value"] == 100.0
        assert 0.0 < result["metrics"]["padding_pct.eval"]["value"] < 100.0
        assert result["metrics"]["host_syncs.eval"]["value"] >= 3 * 3
        # D = 64 fails the fused guard's D % 128: every sub-block unfused
        assert result["metrics"]["fused_pct.eval"]["value"] == 0.0
    else:
        assert set(result["metrics"]) == {"points_per_s", "setup_s"}
        assert all(v["value"] > 0 for v in result["metrics"].values())
