"""The attention sub-blocks of a traced evaluation epoch that took the DiT's
fused branch (proj and out_proj kernels around the attention), as a share of
all of them: the program's ``dit.fused`` and ``dit.unfused`` counters
(``rap_tpu_torch.telemetry``) bumped while the profiler recorded. None for a
program without those counters or with no sub-block counted. Moves
``points_per_s``.
"""


def read(ctx):
    try:
        from rap_tpu_torch import telemetry
    except ImportError:
        return None
    if "dit.fused" not in telemetry.COUNTERS:
        return None
    routes = telemetry.profiled_counts("dit.")
    total = routes.get("fused", 0) + routes.get("unfused", 0)
    return 100.0 * routes.get("fused", 0) / total if total else None
