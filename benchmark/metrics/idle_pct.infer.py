"""The card's idle share in serving.

The share of the traced window in which no operation ran on the card: one
minus the union of the device operations' intervals over the window.
Moves ``points_per_s``.
"""


def read(ctx):
    if not ctx.trace.window_s:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
