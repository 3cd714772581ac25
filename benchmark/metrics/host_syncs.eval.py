"""Host syncs a traced evaluation epoch: the program's ``sync.*`` counters
(``rap_tpu_torch.telemetry``: ``run_eval``'s three synchronisations a
generation, and the attention guard bounds' host reads) bumped while the
profiler recorded, over the traced epochs. None for a program without the
evaluation loop's counter. Moves ``points_per_s``.
"""


def read(ctx):
    try:
        from rap_tpu_torch import telemetry
    except ImportError:
        return None
    if "sync.eval" not in telemetry.COUNTERS or not ctx.units:
        return None
    return sum(telemetry.profiled_counts("sync.").values()) / ctx.units
