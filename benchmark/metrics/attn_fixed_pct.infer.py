"""The attention guard's routes in serving: the share of the traced
requests' attention calls that took the fixed-bound forward (row 2), from
the program's ``attn.*`` counters (``rap_tpu_torch.telemetry``) bumped while
the profiler recorded. The rest take the online forward (row 3, with or
without a key mask) or dense attention. None for a program without those
counters or with no attention call. Moves ``points_per_s``.
"""


def read(ctx):
    try:
        from rap_tpu_torch import telemetry
    except ImportError:
        return None
    routes = telemetry.profiled_counts("attn.")
    total = sum(routes.values())
    return 100.0 * routes.get("fixed", 0) / total if total else None
