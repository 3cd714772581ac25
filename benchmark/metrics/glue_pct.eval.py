"""Glue's share of the device time in multi-view evaluation.

The share of the device's operation time spent outside the attention
kernels and the linear layers' kernels (``glue_pct.infer``'s rule): the
unfused branch's AdaLN and norms, the sampler, Kabsch, the metrics, copies
and elementwise work. Moves ``points_per_s``.
"""


def read(ctx):
    return ctx.reader("glue_pct.infer").read(ctx)
