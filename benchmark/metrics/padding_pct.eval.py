"""Padded slots' share of the batches the loader yielded in the traced
epochs: the program's ``pack.slots`` and ``pack.points`` counters
(``rap_tpu_torch.telemetry``) bumped while the profiler recorded, the
quantity of the loader's ``PaddingStats.waste``. None for a program
without those counters. Moves ``points_per_s``.
"""


def read(ctx):
    try:
        from rap_tpu_torch import telemetry
    except ImportError:
        return None
    if "pack.slots" not in telemetry.COUNTERS:
        return None
    pack = telemetry.profiled_counts("pack.")
    slots = pack.get("slots", 0)
    return 100.0 * (slots - pack.get("points", 0)) / slots if slots else None
