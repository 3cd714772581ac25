"""Linear layers' kernels' share of their roofline in training.

The least time of the linear layers' work, counted from shapes
(``benchmark/work.py``: the four projections of every layer, the embedding,
the AdaLN MLPs and the head; forward and the backward's two products per layer, the remat recompute not counted, and Muon's Newton-Schulz products), as a share of the device time of the
kernels that do it: the port's GEMM kernels with their LayerNorm passes
and reductions, and cuBLAS. Moves ``train_points_per_s``.
"""

KERNELS = ("gemm", "nvjet", "cutlass", "xmma", "ff_ln_kernel", "adaln_ln_kernel", "tokens_kernel",
           "ff_bwd_geglu_kernel", "ln_grad_kernel", "dv_copy_kernel", "colsum_kernel",
           "splitsum_kernel")


def read(ctx):
    seconds = ctx.trace.time_of(KERNELS)
    work = ctx.work.get("gemm")
    if not seconds or work is None:
        return None
    return 100.0 * work.least_s / seconds
