"""The check's control: the reference put in the program's place at the
precision below the configuration's (float8 e4m3 products for its bf16)
has to come out not correct, while the program comes out correct.

``readings`` runs, in one process, each seed's cell: set-up, a short window
of ``units`` requests, then the numbers the check compares for the program
and, on the control seeds, for the control. On the card it is run at the
cell's own size to set the limits:

    python3 -m benchmark.tests.test_bench_control --workload rap_12.pairs-serve \\
        --seeds 1,2,3 --control-seeds 1,2,3 --out chiprun_out/readings.json

The CPU test runs it at a tiny size; the ``cuda`` test at the cell's size
on three seeds.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import run as harness  # noqa: E402
from benchmark.tests.faults import FAULTS  # noqa: E402
from benchmark.tests.tiny import CONTROL  # noqa: E402



def readings(workload: str, seeds, control_seeds, units: int, device,
             overrides: dict | None = None, faults=()) -> list[dict]:
    """Per seed, the numbers the check compares for the program and, on the
    control seeds, for the control and for each named fault."""
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        ctx, cell = harness.open_cell(workload, seed, device, overrides)
        cell.warmup()
        done = [i for i in range(units) if cell.unit(i) is not None]
        row = {"seed": seed, "program": dict(cell.check(done))}
        if hasattr(cell, "detail"):
            row["program_detail"] = cell.detail
        if seed in control_seeds:
            for name in faults:
                with FAULTS[workload][name]():
                    _, bad = harness.open_cell(workload, seed, device, overrides)
                    bad.share_reference(cell)
                    bad.warmup()
                    bad_done = [i for i in range(units) if bad.unit(i) is not None]
                    row[name] = dict(bad.check(bad_done))
                    bad.close()
                del bad
            row["control"] = dict(cell.control(done))
            if hasattr(cell, "detail"):
                row["control_detail"] = cell.detail
        row["limits"] = ctx.workload["checks"]
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        out.append(row)
        cell.close()
        del cell
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def fails(numbers: dict, limits: dict) -> bool:
    """Whether any number the check compares reads above its limit."""
    return any(not numbers[k] <= lim for k, lim in limits.items())


def test_control_fails_where_the_program_passes_cpu():
    for row in readings("rap_12.pairs-serve", [7, 9], [7, 9], 2, torch.device("cpu"), CONTROL):
        assert not fails(row["program"], row["limits"]), row
        assert fails(row["control"], row["limits"]), row


@pytest.mark.cuda
def test_control_fails_where_the_program_passes_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    seeds = [2**31 + 11, 2**31 + 12, 2**31 + 13]
    rows = readings("rap_12.pairs-serve", seeds, seeds, 4, torch.device("cuda"))
    for row in rows:
        assert not fails(row["program"], row["limits"]), row
        assert fails(row["control"], row["limits"]), row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="rap_12.pairs-serve")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--units", type=int, default=4)
    ap.add_argument("--faults", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    faults = [f for f in args.faults.split(",") if f]
    rows = readings(args.workload, seeds, control, args.units, torch.device("cuda"),
                    faults=faults)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
