"""The mean time a batch of the window's evaluation epochs waits on the
loader (``run_eval``'s ``record['load_ms']``: ``next(batches)``, the
prefetch thread's reading, posing and packing not hidden) by the harness's
clock. Moves ``points_per_s``.
"""


def read(ctx):
    return ctx.counters.get("load_wait_ms")
