"""The port's spans and counters (``rap_tpu_torch.telemetry``) on the CPU.

Spans exist only while a profiler records and nest as the layers do;
counters count the attention guard's routes, the host syncs and the
launches where they are decided; the benchmark's readers of the counters
read them per traced unit.
"""

import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rap_tpu_torch import telemetry
from rap_tpu_torch.core.batch import make_regular_synthetic_batch
from rap_tpu_torch.models.config import DiTConfig
from rap_tpu_torch.models.dit import attach_bounds, dit_forward, init_dit_params
from rap_tpu_torch.ops import KERNELS, launch_counts, reset_launches
from rap_tpu_torch.ops.flash_attention import SAFE_BOUND2
from rap_tpu_torch.registration import RPFConfig, predict_poses, sample

ROOT = Path(__file__).resolve().parents[1]
STEPS, LAYERS = 2, 2


def _cfg(**kw) -> DiTConfig:
    return DiTConfig(embed_dim=kw.pop("embed_dim", 64), num_layers=LAYERS, num_heads=2,
                     local_feat_dim=8, compute_dtype=torch.float32, **kw)


def _rap_spans(prof) -> list:
    return [e for e in prof.events() if e.name.startswith("rap.")]


def _parent(e, spans):
    """The innermost other span whose interval holds ``e``'s, or None."""
    holders = [s for s in spans if s is not e and s.time_range.start <= e.time_range.start
               and e.time_range.end <= s.time_range.end]
    return min(holders, key=lambda s: s.time_range.elapsed_us(), default=None)


@pytest.fixture(scope="module")
def traced_sample():
    """One tiny ``sample`` with forcing and its ``predict_poses`` under a CPU
    profiler: (spans, what the counters gained, the profiled tallies)."""
    cfg = RPFConfig(model=_cfg(), inference_sampling_steps=STEPS, rigidity_forcing=True,
                    return_end_point_trajectory=False)
    params = init_dit_params(0, cfg.model, device="cpu")
    batch = make_regular_synthetic_batch(0, [[48, 40]], N=48, P=2, S=1, feat_dim=8,
                                         device="cpu")
    gen = torch.Generator().manual_seed(0)
    with telemetry.counted() as gained, profile(activities=[ProfilerActivity.CPU]) as prof:
        pts = sample(params, cfg, batch, generator=gen, return_trajectory=False)["points"]
        predict_poses(batch, pts)
    return _rap_spans(prof), gained, telemetry.profiled_counts()


def test_span_is_a_shared_noop_without_a_profiler():
    assert telemetry.span("rap.a") is telemetry.span("rap.b")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert telemetry.span("rap.a") is not telemetry.span("rap.b")
        with telemetry.span("rap.on"):
            pass
    with telemetry.span("rap.off"):
        pass
    assert [e.name for e in _rap_spans(prof)] == ["rap.on"]


def test_sample_spans_nest_as_the_layers(traced_sample):
    spans, _, _ = traced_sample
    names = [e.name for e in spans]
    assert names.count("rap.sample") == names.count("rap.poses") == 1
    assert names.count("rap.step") == names.count("rap.dit") == STEPS
    assert names.count("rap.dit.layer") == STEPS * LAYERS
    assert names.count("rap.kabsch") == STEPS + 1
    expected = {"rap.step": "rap.sample", "rap.dit": "rap.step",
                "rap.dit.layer": "rap.dit"}
    for e in spans:
        parent = _parent(e, spans)
        if e.name == "rap.kabsch":  # the forcing's fits and the pose fit
            assert parent.name in ("rap.step", "rap.poses")
        elif e.name in expected:
            assert parent.name == expected[e.name], e.name
        else:
            assert parent is None, e.name


def test_sync_svd_counts_a_fit_a_step_and_the_poses(traced_sample):
    _, gained, profiled = traced_sample
    assert gained["sync.svd"] == STEPS + 1
    assert gained["sync.bounds"] == 0
    assert profiled["sync.svd"] == STEPS + 1
    # the unfused branch at 48 points: dense attention, part and global a layer
    assert gained["attn.dense"] == profiled["attn.dense"] == 2 * STEPS * LAYERS
    assert gained["attn.fixed"] == gained["attn.online"] == gained["attn.masked"] == 0


def _routes(params, cfg, batch) -> dict:
    x = torch.randn(batch.points.shape, generator=torch.Generator().manual_seed(1))
    with telemetry.counted("attn.") as routes:
        dit_forward(params, cfg, x, torch.full((batch.S,), 0.5), batch,
                    parts_per_sample=batch.G // batch.S)
    return routes


def test_attention_routes_are_counted():
    cfg = _cfg(embed_dim=128)
    params = init_dit_params(0, cfg, device="cpu")
    dense = make_regular_synthetic_batch(0, [[1024, 1024]], N=1024, P=2, S=1, feat_dim=8,
                                         device="cpu")
    # the fused branch: part and global attention take row 2 at random init
    assert _routes(params, cfg, dense) == dict(fixed=2 * LAYERS, online=0, masked=0, dense=0)
    # a qk gain past the guard's bound sends that layer's global call to row 3
    params["layers"][1]["global_q_gamma"] = params["layers"][1]["global_q_gamma"] * 8.0
    with telemetry.counted("sync.") as syncs:
        attach_bounds(params)
    assert syncs["bounds"] == 1
    assert params["layers"][1]["global_bound2"] > SAFE_BOUND2
    assert _routes(params, cfg, dense) == dict(fixed=2 * LAYERS - 1, online=1, masked=0,
                                               dense=0)
    # a padded batch: dense part attention under 1024 keys, masked flash global
    padded = make_regular_synthetic_batch(0, [[512, 400]], N=512, P=2, S=1, feat_dim=8,
                                          device="cpu")
    assert not padded.no_padding
    assert _routes(params, cfg, padded) == dict(fixed=0, online=0, masked=LAYERS,
                                                dense=LAYERS)


def test_profiled_tally_holds_the_latest_recorded_stretch():
    telemetry.bump("attn.dense")
    with profile(activities=[ProfilerActivity.CPU]):
        telemetry.bump("attn.fixed")
        telemetry.bump("attn.fixed")
    telemetry.bump("attn.online")  # after the profiler: not tallied
    assert telemetry.profiled_counts("attn.") == {"fixed": 2}
    with profile(activities=[ProfilerActivity.CPU]):
        telemetry.bump("attn.masked")
    assert telemetry.profiled_counts("attn.") == {"masked": 1}


def test_launch_counts_keep_their_keys():
    reset_launches()
    assert list(launch_counts()) == list(KERNELS)
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    with telemetry.counted("launch.") as launches:
        telemetry.bump("launch.ff")
    assert launches == dict(dict.fromkeys(KERNELS, 0), ff=1)
    assert launch_counts()["ff"] == 1
    reset_launches()
    assert launch_counts()["ff"] == 0
    assert telemetry.counts("sync.").keys() == {"svd", "bounds", "eval"}


def test_benchmark_reads_the_counters_per_traced_request():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark import run
    from benchmark.tests.tiny import TINY

    tiny = TINY["rap_12.pairs-serve"]
    result, _ = run.run("rap_12.pairs-serve", 2**33 + 23, 0.2, True, device="cpu",
                        overrides=tiny)
    assert result["correct"], result["checks"]
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    # each request: a Kabsch fit a step (forcing) and the pose fit
    assert metrics["host_syncs.infer"] == tiny["config"]["inference"]["steps"] + 1
    # 256 points a part: every call is dense attention, none takes row 2
    assert metrics["attn_fixed_pct.infer"] == 0.0
