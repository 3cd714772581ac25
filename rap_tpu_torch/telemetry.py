"""Spans and counters of the port, on the profiler's clock.

Spans mark the port's layer boundaries: ``rap.sample`` (``registration.sample``),
``rap.step`` (one ODE step of ``flow_sampler``, rigidity forcing included),
``rap.dit`` (``dit_forward``), ``rap.dit.layer`` (one DiT layer, its remat
recompute too), ``rap.kabsch`` (``kabsch_masked``, and rigidity forcing's
fused fit on the card, ``procrustes.forced_state``), ``rap.poses``
(``predict_poses``), in training ``rap.train.step``, ``rap.train.grad``
(forward, backward and the all-reduce) and ``rap.optim`` (the optimizer's
update), and in batch evaluation (``apps.sample.run_eval``) ``rap.eval.batch``
(one loader batch, all its generations), ``rap.eval.load`` (the wait on the
loader) and ``rap.eval.metrics`` (the evaluator, the aggregation over
generations and the meter). While a torch.profiler session records, a span is a
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
- ``dit.fused`` / ``dit.unfused``: one attention sub-block of ``dit_forward``
  took the fused branch (rows 1 and 4 around the attention, padded batch or
  not) or the unfused one (``models.dit._fused_ok``);
- ``sync.svd``: ``torch.linalg.svd`` in ``kabsch_masked``, which runs on
  the CPU only: a fit on the card launches csrc/kabsch.cu (``launch.kabsch``)
  or, under a gradient, the sync-free ``svd3``, so the counter reads 0 there
  (cuSOLVER, which checks its convergence on the host, is called nowhere);
  ``sync.bounds``: a host read of an attention guard bound
  (``attention_bounds``, once a training step; ``flash_attention``'s
  row-norm bound where no logit bound is given); ``sync.eval``: each
  ``_sync`` of ``run_eval`` (a ``torch.cuda.synchronize`` on the card,
  three a generation);
- ``pack.slots`` / ``pack.points``: the padded slots and the valid points
  of each batch ``BatchLoader.epoch`` yields (bumped by the count).

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

COUNTERS = ("attn.fixed", "attn.online", "attn.masked", "attn.dense", "dit.fused",
            "dit.unfused", "sync.svd", "sync.bounds", "sync.eval", "pack.slots",
            "pack.points")
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


def bump(name: str, n: int = 1) -> None:
    """Count ``n`` events of the registered counter ``name``."""
    global _was_profiling
    _counts[name] += n
    if _profiling():
        if not _was_profiling:
            _profiled.clear()
            _was_profiling = True
        _profiled[name] = _profiled.get(name, 0) + n
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
