#!/usr/bin/env python3
"""Time the QKV projection (row 1), the attention output projection (row 4) and the QKV projection's backward (row 9) of one or more checkouts, in turns, on one card.

    python3 scripts/time_proj.py                  # this checkout
    python3 scripts/time_proj.py A B B A          # trees A and B in turns
    python3 scripts/time_proj.py --only "row 9" A B B A

Each argument is the root of a tree holding ``rap_tpu_torch/`` and
``chip_smoke.py``, as for scripts/time_ff.py, whose protocol this follows:
the trees' kernel libraries are built first, all at once; then each
argument, in the order given, is timed in a process of its own. Rows, bf16,
with this checkout's chip_smoke.py inputs (``proj_inputs``), yardstick
(``proj_matmuls``) and timer for every tree, at the serving shape (8 parts
of 4096 tokens, 2 parts a sample, 32768 tokens): row 1
(``fused_proj.proj_kernel``), row 4 (``fused_proj.out_kernel``) and row 9
(``fused_proj.proj_bwd_kernel``, random cotangents) in the part and the
global layout at D = 512, H = 8 (dh = 64), and in the global layout at D =
512, H = 16 (dh = 32) and D = 768, H = 8 (dh = 96). Each is the median of
CUDA-event times over repeated calls of the public wrapper (its scratch
allocations included), and each device kernel's ms per call under
torch.profiler (the LN passes, the GEMMs, out_proj's token gather, row 9's
dv copy, LN vjp and reductions); beside them the yardstick, ``torch.matmul``
over the same products (one for rows 1 and 4, three for row 9) without the
LN passes, epilogues or relayouts, timed here and used nowhere in the port.
A tree whose kernels refuse a shape records the refusal. One JSON line per
argument, with the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import time_ff  # noqa: E402  (scripts/time_ff.py: build, device_ms, this_checkout_smoke)

G, N, P = 8, 4096, 2
# (label, D, H, layouts)
SHAPES = (("dh=64", 512, 8, (False, True)), ("dh=32", 512, 16, (True,)),
          ("dh=96", 768, 8, (True,)))


def time_root(root: Path, only: str) -> dict:
    """Runs in the child process: the rows of ``root``'s kernels whose name
    holds ``only``."""
    here = time_ff.this_checkout_smoke()
    sys.path.insert(0, str(root))
    import torch

    from rap_tpu_torch.ops import fused_proj as fp

    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows: dict = {}
    for label, width, heads, layouts in SHAPES:
        x, ada, w, gamma_q, gamma_k, w_out, b_out = here.proj_inputs(gen, G, N, width, heads)
        gq_eff, gk_eff = fp.fold_gains(gamma_q, gamma_k)
        mm_proj, mm_out, mm_bwd = here.proj_matmuls(x, w, w_out)
        a5 = cot = None
        for is_global in layouts:
            tag = f"{label} {'global' if is_global else 'part'}"
            lead = (G // P, heads, P, N) if is_global else (G, heads, N)
            dh = width // heads
            a5, dk, dv = (torch.randn(lead + (dh,), generator=gen, device="cuda")
                          .to(torch.bfloat16) for _ in range(3))
            cot = (a5, dk, dv)
            for name, call, mm in (
                    (f"row 1 {tag}", lambda: fp.proj_kernel(x, ada, w, gq_eff, gk_eff, P,
                                                            is_global), mm_proj),
                    (f"row 4 {tag}", lambda: fp.out_kernel(a5, x, w_out, b_out, P, is_global),
                     mm_out),
                    (f"row 9 {tag}", lambda: fp.proj_bwd_kernel(x, ada, w, gq_eff, gk_eff,
                                                                *cot, P, is_global), mm_bwd)):
                if only not in name:
                    continue
                try:
                    call()
                except ValueError as e:
                    rows[name] = {"refused": str(e)}
                    continue
                rows[name] = {"ms": here.cuda_time_ms(call, 10),
                              "kernels_ms": time_ff.device_ms(call),
                              "matmul_ms": here.cuda_time_ms(mm, 10)}
        del x, ada, w, w_out, a5, cot
        torch.cuda.empty_cache()
    return {"root": str(root), "card": here.nvidia_smi(), "rows": rows}


def main(argv: list[str]) -> int:
    if argv[:1] == ["--child"]:
        print(json.dumps(time_root(Path(argv[1]).resolve(), argv[2])), flush=True)
        return 0
    only = ""
    if argv[:1] == ["--only"]:
        only, argv = argv[1], argv[2:]
    roots = [Path(a).resolve() for a in argv] or [time_ff.HERE]
    builds = [time_ff.build(r) for r in dict.fromkeys(roots)]
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
