"""The mean time a training step of the window waits on the loader
(``next(batches)``) by the harness's clock. Moves ``train_points_per_s``.
"""


def read(ctx):
    return ctx.counters.get("load_wait_ms")
