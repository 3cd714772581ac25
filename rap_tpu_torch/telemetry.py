"""Spans and counters of the port, on the profiler's clock.

Spans mark the port's layer boundaries: ``rap.sample`` (``registration.sample``),
``rap.step`` (one ODE step of ``flow_sampler``, rigidity forcing included),
``rap.dit`` (``dit_forward``), ``rap.dit.layer`` (one DiT layer, its remat
recompute too), ``rap.kabsch`` (``kabsch_masked``), ``rap.poses``
(``predict_poses``), and in training ``rap.train.step``, ``rap.train.grad``
(forward, backward and the all-reduce) and ``rap.optim`` (the optimizer's
update). While a torch.profiler session records, a span is a
``torch.profiler.record_function`` range: the profiler holds it, writes it
with its trace and puts it on the clock of the device's events, nested under
the span open on the launching thread. Otherwise ``span`` returns one shared
no-op context, at the cost of a check of the profiler's state (a
``record_function`` with no profiler costs some 20 times that). Nothing but a
recording profiler switches spans on: the benchmark's traced runs and the
apps' ``--profile-dir``.

Counters are plain integers, always on, bumped where the decision is taken:

- ``launch.<kernel>``: one launch of a CUDA kernel (``ops.launch_counts``);
- ``attn.fixed`` / ``attn.online``: the no-padding attention's guard chose
  the fixed-bound forward (row 2) or the online one (row 3);
  ``attn.masked``: the online forward with a key mask; ``attn.dense``:
  dense or chunked attention (under 1024 keys);
- ``sync.svd``: ``torch.linalg.svd`` in ``kabsch_masked`` (cuSOLVER on the
  card checks its convergence on the host, which waits for the device);
  ``sync.bounds``: a host read of an attention guard bound
  (``attention_bounds``, once a training step; ``flash_attention``'s
  row-norm bound where no logit bound is given).

``counts()`` takes a snapshot and ``counted()`` gives what a block added.
Each bump made while a profiler records is also tallied in
``profiled_counts()``, over the latest stretch of recording (one starts at
the first bump that finds a profiler recording after one that found none):
what a reader of that profile divides by the units it traced.
"""

from __future__ import annotations

import contextlib
import functools
from collections.abc import Iterable, Iterator

import torch
from torch.profiler import record_function

_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()

COUNTERS = ("attn.fixed", "attn.online", "attn.masked", "attn.dense", "sync.svd",
            "sync.bounds")
_counts: dict[str, int] = dict.fromkeys(COUNTERS, 0)
_profiled: dict[str, int] = {}
_was_profiling = False


def span(name: str):
    """A ``record_function(name)`` range while a profiler records, else a
    shared no-op context."""
    return record_function(name) if _profiling() else _OFF


def spanned(name: str):
    """Decorator: every call of the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def register(names: Iterable[str]) -> None:
    """Counters that read 0 until their first bump."""
    for name in names:
        _counts.setdefault(name, 0)


def bump(name: str) -> None:
    """Count one event of the registered counter ``name``."""
    global _was_profiling
    _counts[name] += 1
    if _profiling():
        if not _was_profiling:
            _profiled.clear()
            _was_profiling = True
        _profiled[name] = _profiled.get(name, 0) + 1
    elif _was_profiling:
        _was_profiling = False


def _under(counters: dict[str, int], prefix: str) -> dict[str, int]:
    n = len(prefix)
    return {k[n:]: v for k, v in counters.items() if k.startswith(prefix)}


def counts(prefix: str = "") -> dict[str, int]:
    """A snapshot of the counters whose names start with ``prefix``, keyed by
    the rest of the name."""
    return _under(_counts, prefix)


def profiled_counts(prefix: str = "") -> dict[str, int]:
    """As ``counts``, for the bumps of the latest stretch in which a profiler
    recorded (a counter not bumped there is absent)."""
    return _under(_profiled, prefix)


def reset(prefix: str = "") -> None:
    """Zero the counters under ``prefix`` and drop their profiled tallies."""
    for name in _counts:
        if name.startswith(prefix):
            _counts[name] = 0
    for name in [k for k in _profiled if k.startswith(prefix)]:
        del _profiled[name]


@contextlib.contextmanager
def counted(prefix: str = "") -> Iterator[dict[str, int]]:
    """Yields a dict that holds, once the block has run, what each counter
    under ``prefix`` gained in it (keyed as ``counts``)."""
    gained: dict[str, int] = {}
    before = counts(prefix)
    yield gained
    gained.update((k, v - before.get(k, 0)) for k, v in counts(prefix).items())
