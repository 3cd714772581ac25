"""Glue's share of the device time in training.

The share of the device's operation time spent outside the attention
kernels (``attn_roofline.train``'s names) and the linear layers' kernels
(``gemm_roofline.train``'s names): the sampler, Kabsch, AdaLN and norms of the
unfused branch, the loss, the optimizer's elementwise work, copies and elementwise work. Moves ``train_points_per_s``.
"""


def read(ctx):
    total = ctx.trace.kernel_s
    if not total:
        return None
    inside = ctx.trace.time_of(ctx.reader("attn_roofline.train").KERNELS + ctx.reader(
        "gemm_roofline.train").KERNELS)
    return 100.0 * (total - inside) / total
