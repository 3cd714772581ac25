#!/usr/bin/env python3
"""Time the attention backward's rows (6, 7, 8) of one or more checkouts, in turns, on one card.

    python3 scripts/time_attention_bwd.py                  # this checkout
    python3 scripts/time_attention_bwd.py A B B A          # trees A and B in turns
    python3 scripts/time_attention_bwd.py --only "row 6" A B   # the rows named so
    python3 scripts/time_attention_bwd.py --only "row 8" A B B A

Each argument is the root of a tree holding ``rap_tpu_torch/`` and
``chip_smoke.py`` (a checkout, or a ``git archive`` of one unpacked in a
git-ignored directory). The trees' kernel libraries are built first, all
at once (one process each); then each argument, in the order given, is timed
in a process of its own, so one tree can be timed before and after another
on the same card. Rows, at chip_smoke.py's shapes and with its inputs:
row 6 dense global (BH=32, T=8192, unmasked), row 6 masked multi-view part
(BH=128, T=4096), its softcap variant at c = 5; rows 7 and 8 (the split
backward's dK/dV and dQ passes) masked multi-view global (BH=16, T=32768),
their softcap variants, and each pair as one call; row 7 at the dense
global shape (unmasked; no path runs it there, it shows what row 6 pays for
its dQ). Each is the median of CUDA-event times over repeated calls of the
public kernel wrapper (its operand copies included), printed with the
card's name and power limit as one JSON line per argument; each row also as
its kernel's own device time (torch.profiler: `dkv_kernel` or `dq_kernel`),
without the wrapper's operand copies and dQ's zeroing and scaling.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def build(root: Path) -> subprocess.Popen:
    code = (f"import sys; sys.path.insert(0, {str(root)!r}); "
            "from rap_tpu_torch.ops import _build; _build.load()")
    return subprocess.Popen([sys.executable, "-c", code])


def kernel_ms(fn, fragment: str, calls: int = 5) -> float:
    """Device ms per call of ``fn`` spent in kernels whose name holds
    ``fragment`` (torch.profiler), the rest of the wrapper's work excluded."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
             if fragment in e.key)
    return us / 1e3 / calls


def time_root(root: Path, only: str) -> dict:
    """Runs in the child process: the rows of ``root``'s kernels whose name
    holds ``only``."""
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    from rap_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1234)
    part_mask, global_mask = cs.multiview_masks(cs.multiview_parts())
    H = cs.H
    rows = {}

    def inputs(BH, T, c, mask):
        if c > 0.0:
            qh, kh, vh = cs.softcap_attention_inputs(gen, BH, T, c)
        else:
            qh, kh, vh = cs.multiview_attention_inputs(gen, BH, T)
        heads = 1 if mask is None else H
        out, lse = fa.flash_online(qh, kh, vh, mask, heads, c)
        dout = torch.randn((BH, T, cs.DH), generator=gen, device="cuda").to(torch.bfloat16)
        return qh, kh, vh, out, lse, dout, heads

    for name, BH, T, c, mask in (("row 6 dense global", 32, 8192, 0.0, None),
                                 ("row 6 masked part", 128, 4096, 0.0, part_mask),
                                 ("row 6s masked part, c=5", 128, 4096, 5.0, part_mask)):
        if only not in name:
            continue
        qh, kh, vh, out, lse, dout, heads = inputs(BH, T, c, mask)
        call = lambda: fa.flash_bwd_kernel(qh, kh, vh, out, lse, dout, mask, heads, c)  # noqa: E731
        rows[name] = cs.cuda_time_ms(call, 10)
        rows[name + ", key-block kernel alone"] = kernel_ms(call, "dkv_kernel")
        del qh, kh, vh, out, lse, dout, call
    for tag, BH, T, c, mask in (("masked global", 16, 32768, 0.0, global_mask),
                                ("masked global, c=5", 16, 32768, 5.0, global_mask),
                                ("dense global", 32, 8192, 0.0, None)):
        s = "s" if c > 0.0 else ""
        row7, row8, pair = f"row 7{s} {tag}", f"row 8{s} {tag}", f"rows 7{s}+8{s} {tag}"
        # rows 8 and 7+8 where a path runs them: behind a key mask
        wanted = [n for n in (row7, row8, pair) if only in n and (mask is not None or n == row7)]
        if not wanted:
            continue
        qh, kh, vh, out, lse, dout, heads = inputs(BH, T, c, mask)
        args = (qh, kh, vh, dout, fa._neg_delta(dout, out), lse, mask, heads, c)
        dkv = lambda: fa.flash_bwd_dkv_kernel(*args)  # noqa: E731
        dq = lambda: fa.flash_bwd_dq_kernel(*args)  # noqa: E731
        if row7 in wanted:
            rows[row7] = cs.cuda_time_ms(dkv, 5)
            rows[row7 + ", key-block kernel alone"] = kernel_ms(dkv, "dkv_kernel")
        if row8 in wanted:
            rows[row8] = cs.cuda_time_ms(dq, 5)
            rows[row8 + ", dQ kernel alone"] = kernel_ms(dq, "dq_kernel")
        if pair in wanted:
            rows[pair] = cs.cuda_time_ms(lambda: (dkv(), dq()), 5)
        del qh, kh, vh, out, lse, dout, args, dkv, dq
    return {"root": str(root), "card": cs.nvidia_smi(), "ms": rows}


def main(argv: list[str]) -> int:
    if argv[:1] == ["--child"]:
        print(json.dumps(time_root(Path(argv[1]).resolve(), argv[2])), flush=True)
        return 0
    only = ""
    if argv[:1] == ["--only"]:
        only, argv = argv[1], argv[2:]
    roots = [Path(a).resolve() for a in argv] or [HERE]
    builds = [build(r) for r in dict.fromkeys(roots)]
    if any(p.wait() != 0 for p in builds):
        print("a build failed", file=sys.stderr)
        return 1
    for root in roots:
        rc = subprocess.run([sys.executable, __file__, "--child", str(root), only]).returncode
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
