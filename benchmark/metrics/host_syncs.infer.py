"""Host syncs a traced serving request: the program's ``sync.*`` counters
(``rap_tpu_torch.telemetry``: each ``torch.linalg.svd`` of a Kabsch fit,
whose convergence check waits for the card, and the guard bounds' host
read) bumped while the profiler recorded, over the traced requests. None
for a program without those counters. Moves ``points_per_s``.
"""


def read(ctx):
    try:
        from rap_tpu_torch import telemetry
    except ImportError:
        return None
    if not ctx.units:
        return None
    return sum(telemetry.profiled_counts("sync.").values()) / ctx.units
