#!/usr/bin/env python3
"""Time the Kabsch kernel (csrc/kabsch.cu) on one card, and the host's
enqueue time of one serving step.

    python3 scripts/time_kabsch.py [--out FILE]

Kernel rows: the fit alone and the forcing mode (x_0_hat formed from x_t
and v, the forced state written) at the serving shape (8 parts of 4096
points) and at 2 parts of 32768 points. For each, ms a call on the card
from CUDA events over a CUDA graph of ``REPS`` calls of the public wrapper
(``ops.kabsch.kabsch``: back to back on the device, no host in the time),
the same over ``REPS`` eager calls (the host's launch cost included), the
kernel's own ms under torch.profiler, its byte bound (each input byte read
once, each output byte written once, at 3.35 TB/s: the fit does 3 x 3
products a point, far below the card's ridge) and the plain path with
cuSOLVER's SVD (``core.procrustes._fit`` with ``torch.linalg.svd``, and
the blend in forcing mode; each call waits on the host for the SVD).

Enqueue row: rap_12 (12 layers, D 512, random weights, guard bounds
attached) on 4 pairs x 2 views x 4096 points, dense, as the benchmark's
serving cell runs it. One Euler step with rigidity forcing (the DiT's
velocity, then ``procrustes.forced_state``), from an idle card: the host's
time to return from the step without a synchronise (what the host spends
to enqueue it), and the card's time for it (CUDA events). The host runs
ahead of the card where the first is the smaller. Medians of ``STEPS``
steps. One JSON line, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

REPS = 200
STEPS = 20
PEAK_BYTES = 3.35e12
SHAPES = (("serve", 8, 4096), ("long", 2, 32768))


def events_ms(fn, reps: int) -> float:
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(fn) -> float:
    """ms a call of ``fn`` from CUDA events around replays of a graph of REPS
    calls (median of 5 replays)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return statistics.median(events_ms(graph.replay, 1) / REPS for _ in range(5))


def kernel_ms(fn, name: str = "kabsch_kernel") -> float:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
    times = [e.device_time for e in prof.events() if name in e.name]
    return statistics.median(times) / 1e3 if times else float("nan")


def kernel_rows(gen) -> list[dict]:
    from rap_tpu_torch.core import procrustes
    from rap_tpu_torch.ops import kabsch as kabsch_op

    rows = []
    for label, B, N in SHAPES:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda")

        src, x_t, v, x_1 = rnd(B, N, 3), rnd(B, N, 3), rnd(B, N, 3), rnd(B, N, 3)
        mask = torch.ones((B, N), dtype=torch.bool, device="cuda")
        t, t_next = 0.6, 0.5
        for mode in ("fit", "forcing"):
            if mode == "fit":
                def fn():
                    return kabsch_op.kabsch(src, x_t, mask)

                def plain():
                    return procrustes._fit(src, x_t, mask, None, torch.linalg.svd)

                nbytes = B * N * (12 + 12 + 1) + B * 48
            else:
                def fn():
                    return kabsch_op.kabsch(src, x_t, mask, velocity=v, t=t, x_1=x_1,
                                            t_next=t_next)

                def plain():
                    x0 = x_t - v * t
                    R, tr = procrustes._fit(src, x0, mask, None, torch.linalg.svd)
                    rigid = torch.where(mask[..., None],
                                        procrustes.transform_points(R, tr, src), x0)
                    return rigid * (1.0 - t_next) + x_1 * t_next

                nbytes = B * N * (4 * 12 + 1 + 12) + B * 48
            for _ in range(5):
                fn()
                plain()
            rows.append({
                "row": f"kabsch {mode}", "shape": f"{B} x {N}",
                "graph_ms": graph_ms(fn), "eager_ms": events_ms(fn, REPS),
                "kernel_ms": kernel_ms(fn), "bound_ms": nbytes / PEAK_BYTES * 1e3,
                "bytes": nbytes, "plain_ms": events_ms(plain, 20)})
    return rows


def enqueue_row() -> dict:
    from rap_tpu_torch.core.batch import make_regular_synthetic_batch
    from rap_tpu_torch.core.procrustes import forced_state
    from rap_tpu_torch.models.config import DiTConfig
    from rap_tpu_torch.models.dit import attach_bounds, init_dit_params
    from rap_tpu_torch.registration import RPFConfig, velocity_fn

    cfg = RPFConfig(model=DiTConfig(num_layers=12), inference_sampling_steps=10,
                    rigidity_forcing=True, return_end_point_trajectory=False)
    params = attach_bounds(init_dit_params(0, cfg.model, device="cuda"))
    S, P, N = 4, 2, 4096
    batch = make_regular_synthetic_batch(1, [[N] * P] * S, N=N, P=P, S=S, device="cuda")
    x_1 = torch.randn(batch.points.shape, generator=torch.Generator(device="cuda").manual_seed(5),
                      device="cuda")
    vfn = velocity_fn(params, cfg, batch)
    t, t_next = 0.5, 0.4

    def step():
        v = vfn(x_1, t)
        return forced_state(batch.points, batch.point_mask, x_1, t_next, x_t=x_1, v=v, t=t)

    host, card = [], []
    with torch.no_grad():
        for i in range(STEPS + 3):
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            t0 = time.perf_counter()
            step()
            t1 = time.perf_counter()
            b.record()
            b.synchronize()
            if i >= 3:
                host.append((t1 - t0) * 1e3)
                card.append(a.elapsed_time(b))
    return {"row": "one serving step", "shape": f"{S} x {P} x {N}, 12 layers",
            "host_enqueue_ms": statistics.median(host), "host_enqueue_ms_range":
            [min(host), max(host)], "card_ms": statistics.median(card),
            "card_ms_range": [min(card), max(card)]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = kernel_rows(gen) + [enqueue_row()]
    for r in rows:
        print(json.dumps(r), flush=True)
    line = json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                       "rows": rows})
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
