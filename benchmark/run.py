"""The benchmark of rap_tpu_torch on NVIDIA cards: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Everything is found by name: the cell in
``BENCHMARK.json``, its parameters in ``benchmark/workloads/<cell>.json``
(configuration, driver, traffic parameters, how each end-to-end metric is
taken, the limit of each number the check compares), the configuration's
file, the driver ``benchmark/drivers/<driver>.py`` and each per-layer
metric's reader ``benchmark/metrics/<metric>.py``.

A run: set-up (the driver builds the program's inputs and weights from the
seed and warms up every shape the cell uses), then a window of ``--seconds``
that ends at the first unit of work (a request, a training step) finished
after it; then the check against the plain reference over a sample of the
window's outputs. ``--trace 0`` prints the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics from a profiled sub-window of whole
units. The last line of standard output is the result; the last lines of
standard error give each compared number beside its limit.

No card, fewer cards than the cell asks for, or a JAX module loaded in the
process: no result and a non-zero exit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# modules no run may load, compared by their whole top-level name
BANNED = ("jax", "jaxlib", "flax", "rap_tpu")
# caches of the program's and its libraries' builds: fixed paths in the checkout
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton"}


def _prepare_process() -> None:
    if sys.path and Path(sys.path[0]).resolve() == HERE:
        sys.path.pop(0)  # the folder's modules are imported as ``benchmark.*``
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    for var, name in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / ".bench_cache" / name)


def load_file(path: Path, name: str) -> types.ModuleType:
    """Import ``path`` as a module named ``name`` (file names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_files(workload: str, root: Path = ROOT) -> tuple[dict, dict, dict, dict]:
    """(BENCHMARK.json, the cell's entry, its workload file, its configuration file)."""
    bench = benchmark_spec(root)
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"unknown workload {workload!r}")
    wl = json.loads((root / "benchmark" / "workloads" / f"{workload}.json").read_text())
    conf_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((root / conf_entry["file"]).read_text())
    return bench, entry, wl, config


def _merge(base: dict, over: dict | None) -> dict:
    out = json.loads(json.dumps(base))
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def open_cell(workload: str, seed: int, device, overrides: dict | None = None,
              root: Path = ROOT):
    """(ctx, cell): the cell's driver set up from the seed. ``overrides``
    ({"config": {...}, "params": {...}}) shrink a cell for CPU tests."""
    bench, entry, wl, config = cell_files(workload, root)
    overrides = overrides or {}
    ctx = types.SimpleNamespace(
        bench=bench, entry=entry, workload=wl, seed=int(seed), device=device,
        config=_merge(config, overrides.get("config")),
        params=_merge(wl["params"], overrides.get("params")), clock=time.perf_counter)
    driver = load_file(root / "benchmark" / "drivers" / f"{wl['driver']}.py",
                       f"benchmark_driver_{wl['driver']}")
    return ctx, driver.make(ctx)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_window(ctx, cell, seconds: float, trace: bool):
    """Units until ``seconds`` have passed (the window ends at a completion);
    with ``trace``, units 1 .. trace_units profiled. Returns (records, done,
    elapsed, window start, profile or None)."""
    from torch.profiler import record_function

    from benchmark import tracing

    traced = range(1, 1 + ctx.workload["trace_units"]) if trace else range(0)
    records, done, prof, span = [], [], None, None
    clock = ctx.clock
    t0 = clock()
    i = 0
    while True:
        if i == traced.start and trace:
            prof = tracing.start()
            span = record_function(tracing.WINDOW_SPAN)
            span.__enter__()
        records.append(cell.unit(i))
        done.append(i)
        i += 1
        if trace and i == traced.stop:
            _sync(ctx.device)
            span.__exit__(None, None, None)
            prof.stop()
        if clock() - t0 >= seconds and (not trace or i >= traced.stop):
            break
    return records, done, clock() - t0, t0, prof


def end_to_end(ctx, records: list[dict], elapsed: float) -> dict[str, float]:
    """The cell's end-to-end metrics (but ``setup_s``) as its workload file
    defines them: ``rate`` (a record field summed over the window / the
    window's length) or ``percentile`` (of a record field, times ``scale``)."""
    import numpy as np

    out = {}
    for name, how in ctx.workload["end_to_end"].items():
        vals = [r[how["of"]] for r in records]
        if how["kind"] == "rate":
            out[name] = float(sum(vals)) / elapsed
        elif how["kind"] == "percentile":
            out[name] = float(np.percentile(vals, how["q"])) * how.get("scale", 1.0)
        else:
            raise ValueError(f"{name}: unknown kind {how['kind']!r}")
    return out


def per_layer(ctx, cell, trace, done_traced: list[int], root: Path = ROOT) -> dict:
    """Each per-layer metric of the cell that its reader finds something to read."""
    from benchmark import work

    e2e = set(ctx.workload["end_to_end"])
    total: dict = {}
    for i in done_traced:
        for k, v in cell.work_of(i).items():
            if isinstance(v, work.Work):
                total.setdefault(k, work.Work())
                total[k] += v
            else:
                total[k] = total.get(k, 0.0) + v
    rctx = types.SimpleNamespace(trace=trace, work=total, counters=cell.counters(),
                                 units=len(done_traced),
                                 reader=lambda name: load_file(
                                     root / "benchmark" / "metrics" / f"{name}.py",
                                     "benchmark_metric_" + name.replace(".", "_")))
    out = {}
    for m in ctx.bench["per_layer"]:
        cells = m.get("workloads")
        if (cells is not None and ctx.entry["name"] not in cells) or \
                (cells is None and m["moves"] not in e2e):
            continue
        value = rctx.reader(m["name"]).read(rctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def banned_modules(modules=None) -> list[str]:
    """The banned top-level names among ``modules`` (default: the loaded ones)."""
    names = list(sys.modules) if modules is None else list(modules)
    return sorted({name.split(".")[0] for name in names} & set(BANNED))


def run(workload: str, seed: int, seconds: float, trace: bool, device=None,
        overrides: dict | None = None, root: Path = ROOT) -> tuple[dict, list]:
    """One run: (the result's object, [(name, value, limit)] compared)."""
    import torch

    device = torch.device(device or "cuda")
    ctx, cell = open_cell(workload, seed, device, overrides, root=root)
    cell.warmup()
    _sync(device)
    records, done, elapsed, t0, prof = run_window(ctx, cell, seconds, trace)
    setup_s = t0 - T_START
    cell.end_window()
    _sync(device)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    result: dict = {"correct": False, "attempted": len(records), "failed": 0}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": ctx.entry["chips"], "memory_peak_bytes": int(memory_peak)}
    if trace:
        from benchmark import tracing

        tr = tracing.reduce(prof)
        traced = done[1:1 + ctx.workload["trace_units"]]
        result["metrics"] = per_layer(ctx, cell, tr, traced, root)
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_ops(10),
                               "idle_gaps": [[n, s] for n, s in tr.gaps]}
    else:
        metrics = {name: value for name, value in end_to_end(ctx, records, elapsed).items()}
        metrics["setup_s"] = setup_s
        units = {m["name"]: m["unit"] for m in ctx.bench["end_to_end"]}
        result["metrics"] = {k: {"value": v, "unit": units[k]} for k, v in metrics.items()}
    result["device"] = dev
    cell.free_program()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    limits = ctx.workload["checks"]
    t_check = time.perf_counter()
    try:
        compared = [(name, value, limits[name]) for name, value in cell.check(done)
                    if name in limits]
    finally:
        cell.close()
    print(f"run.py: the check took {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    result["correct"] = bool(compared) and all(
        math.isfinite(v) and v <= lim for _, v, lim in compared)
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in compared}
    return result, compared


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _prepare_process()
    _, entry, _, _ = cell_files(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"run.py: {args.workload} needs {entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, compared = run(args.workload, args.seed, args.seconds, bool(args.trace))
    banned = banned_modules()
    if banned:
        print(f"run.py: the process loaded {banned}; the benchmark runs the port only",
              file=sys.stderr)
        return 4
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    for name, value, limit in compared:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
