#!/usr/bin/env python3
"""Drive rap_tpu_torch's serving path once on one CUDA card and check it.

    python3 chip_smoke.py              # every phase, as the check runs it
    python3 chip_smoke.py --phases build,kernels

Phases, each printed on its own flushed line with its wall time:

1. build    one nvcc call over rap_tpu_torch/csrc/*.cu into
            rap_tpu_torch/build/ (first use builds, an unchanged tree loads).
2. kernels  each of the five kernels against its plain PyTorch version on the
            card, at the main path's shapes (S=4 pairs x P=2 parts x N=4096
            points, D=512, H=8, dh=64, FF hidden 2048, bf16): max abs and
            relative error beside the stated tolerance. Attention is checked
            at the part and the global shape, both variants, and the online
            variant once more with a random key mask.
3. main     registration.sample + predict_poses at S=4 x 2 x 4096, 2 Euler
            steps, rigidity forcing, bf16, with random weights from a seed at
            the width and depth of teacher3_last (6 layers, D=512). The qk
            gains of self layers 0-2 and global layers 0, 1 and 4 are raised
            so that their guard bound exceeds 60, as teacher3's do, so 6 of
            the 12 attention calls per forward take the online kernel. Checks:
            finite output of the right shape, the launch counts of one sample,
            and agreement with the same call through the plain versions.
4. timing   median ms per batch and pairs/s; each kernel's median time beside
            its plain version, its bound and one PyTorch library call where
            one computes the same function (scaled_dot_product_attention).

Then it prints the card's name and power limit, one JSON line describing the
kernels, and as its last line {"ok": true, "device": {...}}. Any failed
check exits non-zero. The script imports torch, numpy, the standard library
and rap_tpu_torch only, resolves every path from this file, needs no
checkpoint and no network, and needs one CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
PHASES = ("build", "kernels", "main", "timing")

# main path (bench.py:151-157 of the JAX package: 4 pairs of 2 x 4096 points)
S, P, N = 4, 2, 4096
D, H, DH, FH = 512, 8, 64, 2048
LAYERS, STEPS = 6, 2
# (layer, prefix) whose guard bound exceeds SAFE_BOUND2 in teacher3_last
ONLINE_LAYERS = {(0, "self"), (1, "self"), (2, "self"),
                 (0, "global"), (1, "global"), (4, "global")}
ONLINE_GAIN = 3.0  # gq = gk = 3 -> bound2 = log2(e)*8*9 = 103.9 > 60

# H100 SXM published dense peaks (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# Tolerances, relative to max|reference|. Kernel and plain version round to
# bf16 at the same points but sum in different orders, so an output element
# may land one bf16 step (2^-8 relative, 2^-7 at worst) apart; 1/64 allows a
# few steps at the largest element and still catches any layout or math
# error, which moves outputs by O(1).
TOL_KERNEL = 1.0 / 64
TOL_LSE_ABS = 2e-2  # base-2 log-sum-exp: l differs by ~2^-9 relative
# End to end, 6 layers x 3 residual sub-blocks re-round the bf16 stream, so
# the two paths drift apart by ~1% of the velocity; the rigid fit averages
# that over 4096 points per part.
TOL_VELOCITY = 5e-2
TOL_POINTS = 2e-2
TOL_ROTATION_ABS = 2e-2


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    log(f"[phase {name}] start")
    t0 = time.perf_counter()
    yield
    torch.cuda.synchronize()
    log(f"[phase {name}] done in {time.perf_counter() - t0:.3f} s")


class Failures(list):
    def compare(self, name, got, ref, tol_rel=TOL_KERNEL):
        got, ref = got.float(), ref.float()
        finite = bool(torch.isfinite(got).all())
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        rel = err / max(scale, 1e-30)
        ok = finite and rel <= tol_rel
        log(f"  {name}: max_abs_err={err:.4e} max_rel_err={rel:.4e} "
            f"(tol {tol_rel:.2e} of max|ref|={scale:.3e}) finite={finite} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            self.append(name)
        return err

    def check(self, name, cond, detail=""):
        log(f"  {name}: {'ok' if cond else 'FAIL'} {detail}")
        if not cond:
            self.append(name)


def cuda_time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median ms of ``fn`` over ``reps`` calls, each timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time on the card (ms) and what bounds it."""
    t_ops = flops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def run_build(report):
    from rap_tpu_torch.ops import _build

    lib = _build.load()
    log(f"  library {lib.path.relative_to(ROOT)}; nvcc took {lib.build_seconds:.1f} s"
        + ("" if lib.build_seconds else " (cached build loaded)"))
    for line in lib.compiler_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log(f"  ptxas: {line.strip()}")
    report["build_seconds"] = lib.build_seconds


def make_kernel_inputs(gen):
    """Random inputs at the main path's shapes, on the card."""
    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    G = S * P
    T = G * N
    inp = {
        "x": randn(G, N, D),
        "ada": randn(G, 2 * D, dtype=torch.float32, scale=0.1),
        "w_qkv": randn(D, 3 * D, scale=D ** -0.5),
        "gq": 1.0 + randn(H, DH, dtype=torch.float32, scale=0.1),
        "gk": 1.0 + randn(H, DH, dtype=torch.float32, scale=0.1),
        "w_out": randn(D, D, scale=D ** -0.5),
        "b_out": randn(D, scale=0.1),
        "ln_s": 1.0 + randn(D, dtype=torch.float32, scale=0.1),
        "ln_b": randn(D, dtype=torch.float32, scale=0.1),
        "wi": randn(D, 2 * FH, scale=D ** -0.5),
        "bi": randn(2 * FH, scale=0.1),
        "wo": randn(FH, D, scale=FH ** -0.5),
        "bo": randn(D, scale=0.1),
    }
    inp["tokens"] = T
    return inp


def run_kernels(report, fails, state):
    """Each kernel through its public wrapper (CUDA tensors: the kernel)
    against its plain version on the same inputs."""
    from rap_tpu_torch.ops import flash_attention as fa
    from rap_tpu_torch.ops import fused_ff as ff
    from rap_tpu_torch.ops import fused_proj as fp

    gen = torch.Generator(device="cuda").manual_seed(1234)
    inp = make_kernel_inputs(gen)
    state["inputs"] = inp
    state["attn"] = {}
    errs = state["max_abs_err"] = dict.fromkeys(("proj", "flash_fixed", "flash_online",
                                                 "out_proj", "ff"), 0.0)

    def compare(kernel, label, got, ref, **kw):
        err = fails.compare(label, got, ref, **kw)
        errs[kernel] = max(errs[kernel], err)

    def compare_lse(label, got, ref):
        fails.compare(label, got, ref,
                      tol_rel=TOL_LSE_ABS / max(float(ref.abs().max()), 1e-30))

    for is_global in (False, True):
        tag = "global" if is_global else "part"
        args = (inp["x"], inp["ada"], inp["w_qkv"], inp["gq"], inp["gk"], P, is_global)
        got = fp.adaln_qkv(*args)
        for nm, g_, r_ in zip(("q", "k", "va"), got, fp.adaln_qkv_plain(*args)):
            compare("proj", f"proj[{tag}].{nm}", g_, r_)
        B = S if is_global else S * P
        T = P * N if is_global else N
        qh = got[0].reshape(B * H, T, DH)
        kh = got[1].reshape(B * H, T, DH)
        vah = got[2].reshape(B * H, T, DH + 1)
        b2 = float(np.log2(np.e) * np.sqrt(DH)
                   * inp["gq"].abs().max().item() * inp["gk"].abs().max().item())
        state["attn"][tag] = (qh, kh, vah, got, b2)
        o_k, l_k = fa.flash_fixed(qh, kh, vah, b2)
        o_p, l_p = fa.flash_fixed_plain(qh, kh, vah, b2)
        compare("flash_fixed", f"flash_fixed[{tag}].out", o_k, o_p)
        compare_lse(f"flash_fixed[{tag}].lse2", l_k, l_p)
        o_k, l_k = fa.flash_online(qh, kh, vah)
        o_p, l_p = fa.flash_online_plain(qh, kh, vah)
        compare("flash_online", f"flash_online[{tag}].out", o_k, o_p)
        compare_lse(f"flash_online[{tag}].lse2", l_k, l_p)

        out_args = (o_k.reshape(got[0].shape), inp["x"], inp["w_out"], inp["b_out"],
                    P, is_global)
        compare("out_proj", f"out_proj[{tag}]", fp.attn_out(*out_args),
                fp.out_plain(*out_args))

    # online variant with a random key mask (one batch row fully masked, so
    # the empty-row rule is exercised too)
    qh, kh, vah, _, _ = state["attn"]["global"]
    mask = torch.rand((S, P * N), generator=gen, device="cuda") > 0.3
    mask[1] = False
    o_k, l_k = fa.flash_online(qh, kh, vah, mask, heads=H)
    o_p, l_p = fa.flash_online_plain(qh, kh, vah, mask, heads=H)
    compare("flash_online", "flash_online[global,masked].out", o_k, o_p)
    empty = slice(H, 2 * H)
    fails.check("flash_online[global,masked] empty rows",
                bool((o_k[empty] == 0).all()) and bool((l_k[empty] == fa.LSE_EMPTY).all()))
    live = torch.ones(S * H, dtype=torch.bool, device="cuda")
    live[empty] = False
    compare_lse("flash_online[global,masked].lse2 (live rows)", l_k[live], l_p[live])

    ff_args = (inp["x"], inp["ln_s"], inp["ln_b"], inp["wi"], inp["bi"], inp["wo"],
               inp["bo"])
    compare("ff", "ff", ff.geglu_ff(*ff_args), ff.ff_plain(*ff_args))


def build_main_params(cfg):
    from rap_tpu_torch.models.dit import attach_bounds, init_dit_params

    params = init_dit_params(0, cfg, device="cuda")
    for i, prefix in ONLINE_LAYERS:
        lp = params["layers"][i]
        lp[f"{prefix}_q_gamma"] = lp[f"{prefix}_q_gamma"] * ONLINE_GAIN
        lp[f"{prefix}_k_gamma"] = lp[f"{prefix}_k_gamma"] * ONLINE_GAIN
    return attach_bounds(params)


def run_main(report, fails, state):
    from rap_tpu_torch.core.batch import make_regular_synthetic_batch, validate
    from rap_tpu_torch.models.config import DiTConfig
    from rap_tpu_torch.models.dit import dit_forward
    from rap_tpu_torch.ops import launch_counts, reset_launches
    from rap_tpu_torch.ops.flash_attention import SAFE_BOUND2
    from rap_tpu_torch.registration import RPFConfig, predict_poses, sample

    cfg = DiTConfig(num_layers=LAYERS)  # bf16, kernels on
    params = build_main_params(cfg)
    bounds = [(lp["self_bound2"], lp["global_bound2"]) for lp in params["layers"]]
    log("  guard bound2 per layer (self, global): "
        + ", ".join(f"({a:.1f}, {b:.1f})" for a, b in bounds))
    n_online = sum(b > SAFE_BOUND2 for pair in bounds for b in pair)
    batch = make_regular_synthetic_batch(
        1, [[N] * P for _ in range(S)], N=N, P=P, S=S,
        feat_dim=cfg.local_feat_dim, device="cuda",
    )
    validate(batch)
    x_1 = torch.randn((S * P, N, 3), generator=torch.Generator(device="cuda").manual_seed(2),
                      device="cuda")
    rcfg = RPFConfig(model=cfg, inference_sampling_steps=STEPS, rigidity_forcing=True)

    def serve(c):
        out = sample(params, c, batch, x_1=x_1, return_trajectory=False)
        R, t = predict_poses(batch, out["points"])
        return out["points"], R, t

    reset_launches()
    pts, R, t = serve(rcfg)
    torch.cuda.synchronize()
    counts = launch_counts()
    expected = {
        "proj": 2 * LAYERS * STEPS, "out_proj": 2 * LAYERS * STEPS,
        "ff": LAYERS * STEPS, "flash_fixed": (2 * LAYERS - n_online) * STEPS,
        "flash_online": n_online * STEPS,
    }
    log(f"  launches in one sample: {counts}")
    fails.check("launch counts", counts == expected, f"expected {expected}")
    fails.check("both attention variants ran",
                counts["flash_fixed"] > 0 and counts["flash_online"] > 0)
    fails.check("output shapes", tuple(pts.shape) == (S * P, N, 3)
                and tuple(R.shape) == (S * P, 3, 3) and tuple(t.shape) == (S * P, 3))
    fails.check("finite output", bool(torch.isfinite(pts).all() & torch.isfinite(R).all()
                                      & torch.isfinite(t).all()))
    det = torch.linalg.det(R.double())
    fails.check("poses are rotations", bool(((det - 1).abs() < 1e-3).all()),
                f"det in [{float(det.min()):.5f}, {float(det.max()):.5f}]")

    # the same call with every kernel replaced by its plain version
    plain = dataclasses.replace(rcfg, model=dataclasses.replace(cfg, use_kernels=False))
    reset_launches()
    pts_p, R_p, t_p = serve(plain)
    torch.cuda.synchronize()
    fails.check("plain path launched no kernel", sum(launch_counts().values()) == 0)
    ts = torch.ones(S, device="cuda")
    with torch.no_grad():
        v_k = dit_forward(params, cfg, x_1, ts, batch, P)
        v_p = dit_forward(params, plain.model, x_1, ts, batch, P)
    fails.compare("velocity at t=1 vs plain", v_k, v_p, tol_rel=TOL_VELOCITY)
    fails.compare("points vs plain", pts, pts_p, tol_rel=TOL_POINTS)
    err_r = float((R - R_p).abs().max())
    fails.check("rotations vs plain", err_r <= TOL_ROTATION_ABS,
                f"max_abs_err={err_r:.4e} (tol {TOL_ROTATION_ABS})")
    # a translation error is a displacement of every point of the part: it is
    # held to the same tolerance as the points, on the points' scale
    err_t = float((t - t_p).abs().max())
    tol_t = TOL_POINTS * float(pts_p.abs().max())
    fails.check("translations vs plain", err_t <= tol_t,
                f"max_abs_err={err_t:.4e} (tol {tol_t:.4e})")
    report["launches"] = counts
    state.update(params=params, batch=batch, x_1=x_1, rcfg=rcfg, serve=serve,
                 plain_cfg=plain)


def kernel_rows(state, counts):
    """Time each kernel, its plain version and a library call; bounds."""
    import torch.nn.functional as F

    from rap_tpu_torch.ops import flash_attention as fa
    from rap_tpu_torch.ops import fused_ff as ff
    from rap_tpu_torch.ops import fused_proj as fp

    inp = state["inputs"]
    T = inp["tokens"]
    G = S * P
    gq_eff, gk_eff = fp.fold_gains(inp["gq"], inp["gk"])
    rows = []

    def row(name, source, replaces, fn_k, fn_p, fn_lib, flops, nbytes, shape, reps=10):
        ms = cuda_time_ms(fn_k, reps)
        plain_ms = cuda_time_ms(fn_p, 3)
        lib_ms = None if fn_lib is None else cuda_time_ms(fn_lib, reps)
        b_ms, b_by = bound(flops, nbytes)
        r = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "launches": counts.get(name, 0), "max_abs_err": state["max_abs_err"][name],
             "ms": ms, "plain_ms": plain_ms,
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms, "shape": shape}
        log(f"  {name} [{shape}]: {ms:.4f} ms (plain {plain_ms:.4f}, library "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f}'}, bound {b_ms:.4f} by {b_by})")
        return r

    for is_global in (False, True):
        tag = "global" if is_global else "part"
        args = (inp["x"], inp["ada"], inp["w_qkv"], gq_eff, gk_eff, P, is_global)
        r = row("proj", "rap_tpu_torch/csrc/proj.cu", "rap_tpu/ops/fused_proj.py:46",
                lambda: fp.proj_kernel(*args), lambda: fp.proj_plain(*args), None,
                2 * T * D * 3 * D,
                T * D * 2 + G * 2 * D * 4 + D * 3 * D * 2 + 2 * D * 4
                + 2 * T * D * 2 + T * H * (DH + 1) * 2,
                f"{tag}: x ({G},{N},{D}) bf16")
        if is_global:
            rows.append(r)

    for tag in ("part", "global"):
        qh, kh, vah, got, b2 = state["attn"][tag]
        BH, Tn, _ = qh.shape
        flops = 4 * BH * Tn * Tn * DH
        nbytes = 4 * BH * Tn * DH * 2 + BH * Tn * 4
        v = vah[..., :DH].contiguous()
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qh[None], kh[None], v[None], scale=float(np.log(2.0)))
        shape = f"{tag}: BH={BH}, T={Tn}, d={DH} bf16"
        rf = row("flash_fixed", "rap_tpu_torch/csrc/attention.cu",
                 "rap_tpu/ops/pallas_attention.py:188",
                 lambda: fa.flash_fixed_kernel(qh, kh, vah, b2),
                 lambda: fa.flash_fixed_plain(qh, kh, vah, b2), sdpa, flops, nbytes, shape)
        ro = row("flash_online", "rap_tpu_torch/csrc/attention.cu",
                 "rap_tpu/ops/pallas_attention.py:91",
                 lambda: fa.flash_online_kernel(qh, kh, vah),
                 lambda: fa.flash_online_plain(qh, kh, vah), sdpa, flops, nbytes, shape)
        if tag == "global":
            rows += [rf, ro]

    for is_global in (False, True):
        tag = "global" if is_global else "part"
        a5 = state["attn"][tag][3][0]
        out_args = (a5, inp["x"], inp["w_out"], inp["b_out"], P, is_global)
        r = row("out_proj", "rap_tpu_torch/csrc/out_proj.cu", "rap_tpu/ops/fused_proj.py:458",
                lambda: fp.out_kernel(*out_args), lambda: fp.out_plain(*out_args), None,
                2 * T * D * D, 3 * T * D * 2 + D * D * 2 + D * 2,
                f"{tag}: tokens {T}, D={D} bf16")
        if is_global:
            rows.append(r)

    ff_args = (inp["x"].reshape(-1, D), inp["ln_s"], inp["ln_b"], inp["wi"],
               inp["bi"], inp["wo"], inp["bo"])
    rows.append(row("ff", "rap_tpu_torch/csrc/ff.cu", "rap_tpu/ops/fused_ff.py:55",
                    lambda: ff.ff_kernel(*ff_args), lambda: ff.ff_plain(*ff_args), None,
                    2 * T * D * 2 * FH + 2 * T * FH * D,
                    2 * T * D * 2 + D * 2 * FH * 2 + 2 * FH * 2 + FH * D * 2 + D * 2
                    + 2 * D * 4,
                    f"tokens {T}, D={D}, hidden {FH} bf16"))
    return rows


def run_timing(report, fails, state):
    from rap_tpu_torch.ops import reset_launches

    serve, rcfg = state["serve"], state["rcfg"]
    serve(rcfg)  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        serve(rcfg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    per_batch = float(np.median(times))
    t0 = time.perf_counter()
    serve(state["plain_cfg"])
    torch.cuda.synchronize()
    plain_batch = time.perf_counter() - t0
    log(f"  batch of {S} pairs ({P} x {N} points, {STEPS} steps, {LAYERS} layers): "
        f"median {per_batch * 1e3:.2f} ms over 5 -> {S / per_batch:.3f} pairs/s "
        f"(plain versions: {plain_batch * 1e3:.2f} ms, one run)")
    report["batch_ms"] = per_batch * 1e3
    report["pairs_per_s"] = S / per_batch
    report["plain_batch_ms"] = plain_batch * 1e3
    counts = report.get("launches", {})
    reset_launches()
    report["kernels"] = kernel_rows(state, counts)
    reset_launches()  # timing launches are not main-path launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--report", default=None,
                    help="also write every measurement as JSON to this path")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(",")) - {""}
    if phases - set(PHASES):
        ap.error(f"unknown phases {sorted(phases - set(PHASES))}")
    phases.add("build")  # every other phase runs the kernels
    if "timing" in phases:  # times the inputs and the path of the two before
        phases |= {"kernels", "main"}

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import rap_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    # state the fp32 matmul/conv precision of the plain versions: full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    report: dict = {}
    fails = Failures()
    state: dict = {}
    steps = {"build": lambda: run_build(report),
             "kernels": lambda: run_kernels(report, fails, state),
             "main": lambda: run_main(report, fails, state),
             "timing": lambda: run_timing(report, fails, state)}
    for name in PHASES:
        if name in phases:
            with phase(name):
                steps[name]()
    smi = nvidia_smi()
    report["card"] = smi
    log(f"[total] {time.perf_counter() - t_start:.3f} s")
    if args.report:
        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        Path(args.report).write_text(json.dumps(report, indent=1))
    if fails:
        log(f"FAILED checks: {fails}")
        return 1
    log(smi)
    if "kernels" in report:
        log(json.dumps({"kernels": report["kernels"]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
