"""The whole training step's share of the card's peak.

The model's operations for the valid points of the traced units
(``benchmark/work.py``: three times the forward; remat's recompute and the optimizer not counted), over the traced window's length times the
card's 989 TFLOP/s of dense bf16. Moves ``train_points_per_s``.
"""

from benchmark.work import PEAK_BF16_FLOPS


def read(ctx):
    flops = ctx.work.get("model_flops")
    if not flops or not ctx.trace.window_s:
        return None
    return 100.0 * flops / (ctx.trace.window_s * PEAK_BF16_FLOPS)
