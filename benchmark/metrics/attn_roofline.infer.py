"""Attention kernels' share of their roofline in serving.

The least time the step's attention needs on the card (``benchmark/work.py``:
valid keys, the unpadded head width, the forward of every layer and step), as a share of the device time
of the kernels that do attention, whatever implements them: the names
below. Moves ``points_per_s``.
"""

KERNELS = ("flash_fwd_kernel", "dkv_kernel", "dkv128_kernel", "dq_kernel", "dq128_kernel")


def read(ctx):
    seconds = ctx.trace.time_of(KERNELS)
    work = ctx.work.get("attention")
    if not seconds or work is None:
        return None
    return 100.0 * work.least_s / seconds
