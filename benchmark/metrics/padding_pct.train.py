"""Padded slots' share of the training batches of the window: the
loader's ``PaddingStats.waste`` over the batches it built. Moves
``train_points_per_s``.
"""


def read(ctx):
    waste = ctx.counters.get("padding_waste")
    return None if waste is None else 100.0 * waste
