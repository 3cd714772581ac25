"""A dry run of each cell at a tiny size on the CPU, through the plain
route of the program: the result line's shape, correct, the end-to-end
metrics untraced and the readers' metrics traced."""

import json

import pytest

from benchmark import run
from benchmark.tests.tiny import ROOT, TINY, root_with_training

CELLS = ["rap_12.pairs-serve", "rap_10.multiview-train"]


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("cell", CELLS)
def test_dry_run(cell, trace, tmp_path):
    root = ROOT if cell == "rap_12.pairs-serve" else root_with_training(tmp_path)
    SPEC = json.loads((root / "BENCHMARK.json").read_text())
    result, compared = run.run(cell, 2**33 + 17, 0.5, trace, device="cpu", overrides=TINY[cell],
                               root=root)
    assert list(result)[:3] == ["correct", "attempted", "failed"]
    assert list(result)[-1] == "checks"
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert {n for n, _, _ in compared} == set(result["checks"])
    if trace:
        expected = {m["name"] for m in SPEC["per_layer"] if cell in m.get("workloads", [])}
        assert set(result["metrics"]) <= expected
        assert "breakdown" in result and "window_s" in result["device"]
        # the CPU runs no device operation: no roofline or mfu share is read as 0
        assert not any(k.startswith(("attn_roofline", "gemm_roofline"))
                       for k in result["metrics"])
    else:
        e2e = {m["name"] for m in SPEC["end_to_end"]
               if cell in m.get("workloads", [cell])}
        assert set(result["metrics"]) == e2e
        assert all(v["value"] > 0 for v in result["metrics"].values())
    json.dumps(result)
