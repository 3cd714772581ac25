"""Attention kernels' share of their roofline in multi-view evaluation.

The least time the traced epoch's attention needs on the card
(``benchmark/work.py``: every batch's true part sizes, valid keys only, the
unpadded head width, the forward of every layer, step and generation), as a
share of the device time of the kernels that do attention
(``attn_roofline.infer``'s names): the masked online forward (row 3) at
part and global width. Moves ``points_per_s``.
"""


def read(ctx):
    seconds = ctx.trace.time_of(ctx.reader("attn_roofline.infer").KERNELS)
    work = ctx.work.get("attention")
    if not seconds or work is None:
        return None
    return 100.0 * work.least_s / seconds
