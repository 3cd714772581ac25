"""The whole serving step's share of the card's peak.

The model's operations for the valid points of the traced units
(``benchmark/work.py``: the forward of every Euler step), over the traced window's length times the
card's 989 TFLOP/s of dense bf16. Moves ``points_per_s``.
"""

from benchmark.work import PEAK_BF16_FLOPS


def read(ctx):
    flops = ctx.work.get("model_flops")
    if not flops or not ctx.trace.window_s:
        return None
    return 100.0 * flops / (ctx.trace.window_s * PEAK_BF16_FLOPS)
