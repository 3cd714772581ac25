"""Glue's share of the device time in serving.

The share of the device's operation time spent outside the attention
kernels (``attn_roofline.infer``'s names) and the linear layers' kernels
(``gemm_roofline.infer``'s names): the sampler, Kabsch, AdaLN and norms of the
unfused branch, the loss, copies and elementwise work. Moves ``points_per_s``.
"""


def read(ctx):
    total = ctx.trace.kernel_s
    if not total:
        return None
    inside = ctx.trace.time_of(ctx.reader("attn_roofline.infer").KERNELS + ctx.reader(
        "gemm_roofline.infer").KERNELS)
    return 100.0 * (total - inside) / total
