"""The traced sub-window: torch.profiler over whole units of work (requests
or steps), reduced to what the per-layer readers and the result's
``device`` and ``breakdown`` need.

- kernels: every device operation (kernel, copy, set) that ran inside the
  window, with its name, start and duration, from the profiler's events;
- busy_s: the length of the union of their intervals inside the window,
  so operations that overlap count once;
- idle gaps: the stretches of the window no device operation covers, each
  named by the innermost host operation (a span of the benchmark's or an
  aten op) running at its middle.

The window is the host span ``bench.window`` around the units, which ends
after the last unit's synchronisation; times are seconds.
"""

from __future__ import annotations

import dataclasses

import torch

WINDOW_SPAN = "bench.window"


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: list[tuple[str, float, float]]        # (name, start_s, duration_s)
    gaps: list[tuple[str, float]]                  # (host op, seconds), longest first

    def time_of(self, fragments) -> float:
        """Device seconds of the operations whose name holds a fragment."""
        return sum(d for name, _, d in self.kernels if any(f in name for f in fragments))

    @property
    def kernel_s(self) -> float:
        return sum(d for _, _, d in self.kernels)

    def top_ops(self, n: int = 10) -> list[list]:
        totals: dict[str, float] = {}
        for name, _, d in self.kernels:
            totals[name] = totals.get(name, 0.0) + d
        return [[k[:160], v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


def _is_device(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def _is_annotation(e) -> bool:
    """A host span (``record_function``) mirrored on the device's timeline:
    no operation of the device."""
    return bool(getattr(e, "is_user_annotation", False)) or e.name.startswith("bench.")


def reduce(prof) -> Trace:
    """The trace of a finished ``torch.profiler.profile``."""
    events = list(prof.events())
    window = [e for e in events if e.name == WINDOW_SPAN and not _is_device(e)]
    if not window:
        raise RuntimeError(f"the profile holds no {WINDOW_SPAN!r} span")
    w0, w1 = window[0].time_range.start / 1e6, window[0].time_range.end / 1e6
    kernels, intervals = [], []
    for e in events:
        if not _is_device(e) or _is_annotation(e):
            continue
        a, b = max(e.time_range.start / 1e6, w0), min(e.time_range.end / 1e6, w1)
        if b > a:
            kernels.append((e.name, a, b - a))
            intervals.append((a, b))
    intervals.sort()
    busy, gaps, cursor = 0.0, [], w0
    for a, b in intervals:
        if a > cursor:
            gaps.append((cursor, a))
        if b > cursor:
            busy += b - max(a, cursor)
            cursor = b
    if w1 > cursor:
        gaps.append((cursor, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [e for e in events if not _is_device(e) and e.name != WINDOW_SPAN]
    named = []
    for a, b in gaps[:10]:
        mid = (a + b) / 2 * 1e6
        covering = [e for e in host if e.time_range.start <= mid <= e.time_range.end]
        name = min(covering, key=lambda e: e.time_range.end - e.time_range.start).name \
            if covering else "(no host op)"
        named.append((name[:160], b - a))
    return Trace(w1 - w0, busy, kernels, named)


def start():
    """A started ``torch.profiler.profile`` of the host and, where there is
    one, the card. The caller wraps the units in
    ``torch.profiler.record_function(WINDOW_SPAN)`` and stops it."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof
