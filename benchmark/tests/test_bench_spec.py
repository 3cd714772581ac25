"""BENCHMARK.json against the benchmark's contract: keys, names, units,
limits, and every configuration, cell, driver and per-layer reader a
file of its own under ``benchmark/``."""

import json
import math
import re

from benchmark.tests.tiny import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    checks = 2 + 14 * 24
    assert checks * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_text():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in SPEC["end_to_end"])


def test_every_piece_is_a_file_found_by_name():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    configs = {c["name"]: c for c in SPEC["configs"]}
    for c in configs.values():
        assert c["file"].startswith("benchmark/configs/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in SPEC["workloads"]:
        wl = json.loads((ROOT / "benchmark" / "workloads" / f"{w['name']}.json").read_text())
        assert wl["config"] == w["config"] and w["config"] in configs
        assert (ROOT / "benchmark" / "drivers" / f"{wl['driver']}.py").is_file()
        assert set(wl["end_to_end"]) <= set(e2e)
        for name in wl["end_to_end"]:
            assert w["name"] in e2e[name].get("workloads", [w["name"]])
        assert wl["checks"] and all(math.isfinite(v) for v in wl["checks"].values())
        layered = [m for m in SPEC["per_layer"] if w["name"] in m.get("workloads", [])]
        assert layered, "every cell reports a per-layer metric"
    for m in SPEC["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            wl = json.loads((ROOT / "benchmark" / "workloads" / f"{cell}.json").read_text())
            assert m["moves"] in wl["end_to_end"]
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == set(configs)
