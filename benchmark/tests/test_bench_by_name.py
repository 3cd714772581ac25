"""A cell and a per-layer metric added as files only (a workload file, a
driver, a reader and their BENCHMARK.json entries, in a copy of the
checkout's benchmark) are found by name and run."""

import json
import shutil

from benchmark import run
from benchmark.tests.tiny import ROOT

DRIVER = '''
class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
    def warmup(self):
        pass
    def unit(self, i):
        return {"points": self.ctx.params["points"], "latency_s": 0.001}
    def work_of(self, i):
        return {}
    def counters(self):
        return {"dummy_count": 7.0}
    def end_window(self):
        pass
    def free_program(self):
        pass
    def check(self, done):
        return [("dummy_gap", 0.0)]
    def close(self):
        pass


def make(ctx):
    return Cell(ctx)
'''
READER = '''
def read(ctx):
    return ctx.counters.get("dummy_count")
'''


def test_dummy_cell_and_metric_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "rap_12.dummy", "config": "rap_12", "traffic": "dummy",
                              "chips": 1, "why": "a test"})
    spec["end_to_end"].append({"name": "dummy_rate", "unit": "points/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock",
                               "workloads": ["rap_12.dummy"]})
    spec["per_layer"].append({"name": "dummy_metric", "unit": "n", "better": "lower",
                              "source": "program_counter", "layer": "dummy",
                              "moves": "dummy_rate", "workloads": ["rap_12.dummy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    (tmp_path / "benchmark" / "drivers" / "dummy.py").write_text(DRIVER)
    (tmp_path / "benchmark" / "metrics" / "dummy_metric.py").write_text(READER)
    (tmp_path / "benchmark" / "workloads" / "rap_12.dummy.json").write_text(json.dumps({
        "config": "rap_12", "driver": "dummy", "params": {"points": 10},
        "end_to_end": {"dummy_rate": {"kind": "rate", "of": "points"}},
        "trace_units": 1, "checks": {"dummy_gap": 0.0}}))
    res, _ = run.run("rap_12.dummy", 5, 0.05, False, device="cpu", root=tmp_path)
    assert res["correct"] and set(res["metrics"]) == {"dummy_rate", "setup_s"}
    res, _ = run.run("rap_12.dummy", 5, 0.05, True, device="cpu", root=tmp_path)
    assert res["metrics"] == {"dummy_metric": {"value": 7.0, "unit": "n"}}
