"""The card's idle share in multi-view evaluation: the share of the traced
epoch in which no operation ran on the card (``idle_pct.infer``'s rule).
Moves ``points_per_s``.
"""


def read(ctx):
    return ctx.reader("idle_pct.infer").read(ctx)
