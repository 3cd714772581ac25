#!/usr/bin/env python3
"""Time the GEGLU feed-forward's rows (5: forward, 10: backward) of one or more checkouts, in turns, on one card.

    python3 scripts/time_ff.py                  # this checkout
    python3 scripts/time_ff.py A B B A          # trees A and B in turns
    python3 scripts/time_ff.py --only "row 10" A B B A

Each argument is the root of a tree holding ``rap_tpu_torch/`` and
``chip_smoke.py`` (a checkout, or a ``git archive`` of one unpacked in a
git-ignored directory). The trees' kernel libraries are built first, all
at once (one process each); then each argument, in the order given, is timed
in a process of its own, so one tree can be timed before and after another
on the same card (the protocol of scripts/time_attention_bwd.py). Rows, at
D=512, hidden 2048, bf16, with this checkout's chip_smoke.py inputs
(``ff_inputs``), yardstick (``ff_matmuls``) and timer for every tree: row 5
(``fused_ff.ff_kernel``) and row 10 (``fused_ff.ff_bwd_kernel``) at
T = 32768 tokens (serving, the dense step, an evaluation batch) and T =
65536 (the multi-view step). Each is the median of CUDA-event times over
repeated calls of the public wrapper (its scratch allocations included),
and each device kernel's ms per call under torch.profiler; beside them the
yardstick, ``torch.matmul`` over the same products without their epilogues
(two for row 5, five for row 10), timed here and used nowhere in the port.
One JSON line per argument, with the card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
TOKENS = (32768, 65536)


def build(root: Path) -> subprocess.Popen:
    code = (f"import sys; sys.path.insert(0, {str(root)!r}); "
            "from rap_tpu_torch.ops import _build; _build.load()")
    return subprocess.Popen([sys.executable, "-c", code])


def short_name(key: str) -> str:
    """A profiler kernel name without its arguments and namespaces."""
    key = key.replace("(anonymous namespace)::", "").replace("void ", "", 1)
    key = re.sub(r"^rtt::(gemm::)?", "", key)
    depth = 0
    for i, ch in enumerate(key):  # cut at the argument list, after any template
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            return key[:i]
    return key


def device_ms(fn, calls: int = 5) -> dict[str, float]:
    """Device ms per call of ``fn`` for each kernel it launches (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if us > 0:
            name = short_name(e.key)
            out[name] = out.get(name, 0.0) + us / 1e3 / calls
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def this_checkout_smoke():
    """This checkout's chip_smoke.py, whatever tree is timed: the inputs,
    the yardstick and the timer are the same for every tree."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_root(root: Path, only: str) -> dict:
    """Runs in the child process: the rows of ``root``'s kernels whose name
    holds ``only``."""
    here = this_checkout_smoke()
    sys.path.insert(0, str(root))
    import torch

    from rap_tpu_torch.ops import fused_ff as ff

    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows: dict = {}
    for T in TOKENS:
        names = {f"row 5 T={T}", f"row 10 T={T}"}
        if not any(only in n for n in names):
            continue
        fwd, bwd = here.ff_inputs(gen, T, here.D, here.FH)
        mm5, mm10 = here.ff_matmuls(fwd, bwd)
        for name, call, mm in ((f"row 5 T={T}", lambda: ff.ff_kernel(*fwd), mm5),
                               (f"row 10 T={T}", lambda: ff.ff_bwd_kernel(*bwd), mm10)):
            if only not in name:
                continue
            rows[name] = {"ms": here.cuda_time_ms(call, 10), "kernels_ms": device_ms(call),
                          "matmul_ms": here.cuda_time_ms(mm, 10)}
        del fwd, bwd, mm5, mm10
        torch.cuda.empty_cache()
    return {"root": str(root), "card": here.nvidia_smi(), "rows": rows}


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
