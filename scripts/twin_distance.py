#!/usr/bin/env python3
"""How far each kernel family moves the port's results from its plain run, on one card.

    python3 scripts/twin_distance.py serving
    python3 scripts/twin_distance.py train               # D = 256, 512, 768
    python3 scripts/twin_distance.py train 256:4 768:12  # width:heads

Each run points one family's kernel calls at their plain twins (the
wrappers' module attributes), so the rest of the path still runs its
kernels:

- ``serving``: chip_smoke.py's serving call (registration.sample +
  predict_poses on 4 pairs x 2 parts x 4096 points, 2 Euler steps,
  rigidity forcing, 6 layers, D=512, random weights from its seed, 6 of the
  12 attention calls per forward online) through every kernel, then with
  rows 2-3 (attention forward), row 1 (proj), row 4 (out_proj), row 5 (ff)
  and rows 1, 4, 5 on their twins. Per run: the points' max abs error over
  max|points| of the plain run, the rotations' max abs error, and for one
  dit_forward at t = 1 the velocity's and each layer's output's max abs
  error over max|plain|.
- ``train``: the 2-layer training check of tests/test_torch_cuda.py
  (``_training_gradients``: fused branch at N=128, S=2 x P=2, one online
  attention per forward, the test's draws from seed 0) at each width: the
  gradient leaves of training_forward through the plain versions in bf16
  and in fp32, then through every kernel and with rows 5+10, 2-3, 6, 1+9 and
  4 on their twins. Per run: the worst leaf's distance as a share of the
  limit the D = 512 test holds it to (relative L2 from the plain path
  within max(5e-2, 2x the plain path's distance from fp32)), and each qk
  gain's distance from the plain path and from fp32.

The last line is one JSON object with every number and the card's name and
power limit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def twins(rows: tuple[str, ...]):
    """Point the kernel calls of ``rows`` (keys of the table below) at their
    plain twins."""
    from rap_tpu_torch.ops import flash_attention as fa
    from rap_tpu_torch.ops import fused_ff, fused_proj

    table = {"1": [(fused_proj, "proj_kernel", fused_proj.proj_plain)],
             "2-3": [(fa, "flash_fixed", fa.flash_fixed_plain),
                     (fa, "flash_online", fa.flash_online_plain)],
             "4": [(fused_proj, "out_kernel", fused_proj.out_plain)],
             "5": [(fused_ff, "ff_kernel", fused_ff.ff_plain)],
             "6": [(fa, "flash_bwd", fa.flash_bwd_plain)],
             "9": [(fused_proj, "proj_bwd_kernel", fused_proj.proj_bwd_plain)],
             "10": [(fused_ff, "ff_bwd_kernel", fused_ff.ff_bwd_plain)]}
    swaps = [swap for row in rows for swap in table[row]]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


def rel(a, b) -> float:
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def max_rel(a, b) -> float:
    return float((a - b).abs().max()) / float(b.abs().max())


# ---- serving ---------------------------------------------------------------------

SERVING_RUNS = (("kernels", ()), ("rows 2-3 plain", ("2-3",)), ("row 1 plain", ("1",)),
                ("row 4 plain", ("4",)), ("row 5 plain", ("5",)),
                ("rows 1, 4, 5 plain", ("1", "4", "5")))


def layer_outputs(params, cfg, x, ts, batch, P):
    """Each layer's output (fp32) of one dit_forward, and the velocity."""
    import torch

    from rap_tpu_torch.models import dit

    outs = []
    layer = dit._layer

    def recording(*args, **kwargs):
        h = layer(*args, **kwargs)
        outs.append(h.float())
        return h

    dit._layer = recording
    try:
        with torch.no_grad():
            v = dit.dit_forward(params, cfg, x, ts, batch, P)
    finally:
        dit._layer = layer
    return outs, v


def serving_report(cs) -> dict:
    import torch

    from rap_tpu_torch.core.batch import make_regular_synthetic_batch
    from rap_tpu_torch.models.config import DiTConfig
    from rap_tpu_torch.registration import RPFConfig, predict_poses, sample

    cfg = DiTConfig(num_layers=cs.LAYERS)
    params = cs.build_main_params(cfg)
    batch = make_regular_synthetic_batch(
        1, [[cs.N] * cs.P for _ in range(cs.S)], N=cs.N, P=cs.P, S=cs.S,
        feat_dim=cfg.local_feat_dim, device="cuda")
    x_1 = torch.randn((cs.S * cs.P, cs.N, 3),
                      generator=torch.Generator(device="cuda").manual_seed(2), device="cuda")
    ts = torch.ones(cs.S, device="cuda")
    plain_cfg = dataclasses.replace(cfg, use_kernels=False)

    def serve(c):
        rcfg = RPFConfig(model=c, inference_sampling_steps=cs.STEPS, rigidity_forcing=True)
        out = sample(params, rcfg, batch, x_1=x_1, return_trajectory=False)
        R, _ = predict_poses(batch, out["points"])
        return out["points"].float(), R.float()

    pts_p, R_p = serve(plain_cfg)
    layers_p, v_p = layer_outputs(params, plain_cfg, x_1, ts, batch, cs.P)
    runs = {}
    for name, rows in SERVING_RUNS:
        with twins(rows):
            pts, R = serve(cfg)
            layers, v = layer_outputs(params, cfg, x_1, ts, batch, cs.P)
        run = {"points": max_rel(pts, pts_p), "rotations_abs": float((R - R_p).abs().max()),
               "velocity": max_rel(v, v_p),
               "layers": [max_rel(a, b) for a, b in zip(layers, layers_p)]}
        runs[name] = run
        print(f"{name}: points {run['points']:.4e} of max, rotations {run['rotations_abs']:.4e} "
              f"abs, velocity at t=1 {run['velocity']:.4e}; layers "
              + ", ".join(f"{r:.3e}" for r in run["layers"]), flush=True)
    return runs


# ---- training ----------------------------------------------------------------------

S, P, N = 2, 2, 128  # tests/test_torch_cuda.py's training check
TRAIN_RUNS = (("all kernels", ()), ("rows 5, 10 twins", ("5", "10")),
              ("rows 2-3 twins", ("2-3",)), ("row 6 twin", ("6",)),
              ("rows 1, 9 twins", ("1", "9")), ("row 4 twin", ("4",)))


def train_report(width: int, heads: int) -> dict:
    import torch

    from rap_tpu_torch.core.batch import make_regular_synthetic_batch
    from rap_tpu_torch.models.config import DiTConfig
    from rap_tpu_torch.models.dit import init_dit_params
    from rap_tpu_torch.registration import RPFConfig, training_forward
    from rap_tpu_torch.train.optim import tree_paths, tree_replace

    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.randn((S * P, N, 3), generator=gen, device="cuda")  # the test's dit_forward draw
    cfg = DiTConfig(embed_dim=width, num_heads=heads, num_layers=2, attn_impl="pallas")
    params = init_dit_params(0, cfg, masters=True)
    params["layers"][0]["global_q_gamma"] *= 3
    params["layers"][0]["global_k_gamma"] *= 3
    batch = make_regular_synthetic_batch(1, [[N] * P] * S, N=N, P=P)
    x_1 = torch.randn((S * P, N, 3), generator=gen, device="cuda")
    t = torch.tensor([0.3, 0.95], device="cuda")

    def grads(c):
        leaves = {k: p.detach().requires_grad_(True) for k, p in tree_paths(params)}
        loss, _ = training_forward(tree_replace(params, leaves), RPFConfig(model=c), batch,
                                   None, x_1=x_1, t=t)
        return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    gp = grads(dataclasses.replace(cfg, use_kernels=False))
    g32 = grads(dataclasses.replace(cfg, use_kernels=False, compute_dtype=torch.float32))
    gains = [k for k in gp if k.endswith("_gamma")]
    out = {"plain_vs_fp32": {k: rel(gp[k], g32[k]) for k in gains}, "runs": {}}
    print(f"D={width}, H={heads}: qk gains, plain vs fp32: "
          + ", ".join(f"{k} {v:.3f}" for k, v in out["plain_vs_fp32"].items()), flush=True)
    for name, rows in TRAIN_RUNS:
        with twins(rows):
            gk = grads(cfg)
        shares = {k: rel(gk[k], gp[k]) / max(5e-2, 2 * rel(gp[k], g32[k])) for k in gp}
        worst = max(shares, key=shares.get)
        run = {"worst_leaf": worst, "worst_share_of_limit": shares[worst],
               "gains": {k: {"vs_plain": rel(gk[k], gp[k]), "vs_fp32": rel(gk[k], g32[k])}
                         for k in gains}}
        out["runs"][name] = run
        print(f"  {name}: worst leaf {worst} at {shares[worst]:.2f} of its limit; gains "
              "vs plain / vs fp32: " + ", ".join(
                  f"{g['vs_plain']:.3f}/{g['vs_fp32']:.3f}" for g in run["gains"].values()),
              flush=True)
    return out


def main(argv: list[str]) -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs

    if not argv or argv[0] not in ("serving", "train"):
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("twin_distance: needs a CUDA card", file=sys.stderr)
        return 2
    report = {"card": cs.nvidia_smi()}
    if argv[0] == "serving":
        report["runs"] = serving_report(cs)
    else:
        widths = [tuple(int(v) for v in a.split(":")) for a in argv[1:]] or [
            (256, 4), (512, 8), (768, 12)]
        report["widths"] = {f"D={w}, H={h}": train_report(w, h) for w, h in widths}
    print(report["card"])
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
