#!/usr/bin/env python3
"""Drive rap_tpu_torch's serving, evaluation, demo and training paths on one CUDA card, check them.

    python3 chip_smoke.py              # every phase, as the check runs it
    python3 chip_smoke.py --phases build,kernels
    python3 chip_smoke.py --phases build,kernels,sample
    python3 chip_smoke.py --phases build,kernels,demo
    python3 chip_smoke.py --phases build,kernels,train
    python3 chip_smoke.py --phases build,kernels,multiview
    python3 chip_smoke.py --phases build,kernels,trainer

Phases, each printed on its own flushed line with its wall time:

1. build      one nvcc per rap_tpu_torch/csrc/*.cu, all started together,
              linked into rap_tpu_torch/build/ (first use builds, an
              unchanged tree loads); the attention forward's eight
              instantiations (rows 2, 3 and their softcap variants at head
              widths 64 and 128), the key-block backward's eight (rows 6, 7
              and their softcap variants at head widths 64 and 128), the dQ
              pass's four (rows 8, 8s at 64 and 128) and the ff backward's
              fused GEGLU kernel (row 10) must have the
              launch bound's 168 registers, and they and every other kernel
              behind rows 1, 4, 5, 9 and 10 no local memory
              (cudaFuncGetAttributes).
2. kernels    each of the ten kernels against its plain PyTorch version on
              the card, at the shapes of the paths below (D=512, H=8, dh=64,
              FF hidden 2048, bf16): max abs and relative error beside the
              stated tolerance. Dense main-path shapes (S=4 pairs x P=2 parts
              x N=4096 points): attention at the part and the global shape,
              both forward variants, the online one once more with a random
              key mask; the fused attention backward behind each forward
              variant, the proj backward in both layouts, the ff backward at
              32768 tokens; rows 1 and 9 bitwise equal on two calls. Rows 1,
              4 and 9 (csrc/proj.cu, csrc/out_proj.cu, csrc/proj_bwd.cu on
              the TMA + wgmma GEMM of csrc/gemm_sm90.cuh) also at (D, H) =
              (512, 16), (256, 8), (768, 8), (768, 12), (1024, 16) and (1920,
              16) (head widths 32, 64, 96, 120) and at one tile row (128
              tokens), both layouts, rows 1 and 9 bitwise repeatable; and a
              global layout whose N = 192 is not a
              multiple of 128 (P·N is): rap_tpu's rule refuses it, so the
              entry points take the reference compositions, launch nothing
              and stay within the tolerance of the kernels' twins, and the
              kernel wrappers refuse it. Multi-view shapes (2 samples x 8 part slots x 4096
              points, the multiview phase's batch): the split backward (dKV
              and dQ passes) at the global shape (BH=16, T=32768) with the
              batch's key mask and without one, run twice and required to be
              bit-identical, with the fused backward on the same inputs as a
              second witness; the fused backward with the batch's part mask at
              the part shape (BH=128, T=4096), whose two empty part slots must
              get exactly zero gradient. The softcap variants of rows 2, 3, 6,
              7 and 8 against their softcap twins at c = 5 and c = 50: the
              forward at the sample phase's shapes (the first batch the
              port's loader makes of demo_data/synth: S=8 x P=2 x N=2048, so
              part BH=128, T=2048 and global BH=64, T=4096; c = 5 takes the
              fixed-bound variant, c = 50 the online one, as the guard
              does), the masked forward and the backward at the multi-view
              shapes (row 6 at the part shape, rows 7-8 at the global one,
              bitwise repeatable). The attention forward (csrc/attention.cu,
              TMA + wgmma, 128 query rows per block, key tiles of 128) at the
              edges of its design, both variants and their softcap forms at
              c = 5: one key tile (shorter than the TMA ring), an odd number
              of tiles (Tq = Tk = 384), one head (BH = 1), and key masks that
              leave only the first or only the last key tile live. The dQ
              pass (rows 8, 8s: csrc/attention_bwd_dq.cuh, TMA + wgmma, 128
              queries per block, key tiles of 128) at the same edges, at
              softcap 0 and 5, masked (a batch row with every key masked
              must get dq exactly 0) and, where the mask is random,
              unmasked, bitwise repeatable. Rows 2, 3, 2s and 3s at head
              widths 96 (BH = 32, T = 8192, the global shape of a D = 768, H
              = 8 model) and 120 (BH = 16, T = 2048), the kernel's 128-wide
              instantiation, against their twins on the unpadded heads
              (fixed, online, online with a key mask, softcap 5 and 50).
              The attention backward at head widths 96, 120 and 128 (rows 6,
              7, 8 and their softcap variants at c = 5: the 128-wide key
              block and dQ pass, csrc/attention_bwd_dkv128.cuh and
              csrc/attention_bwd_dq128.cuh) behind the masked online forward
              (rows 3, 3s, held to their twins at d = 128, the width only
              the masked path takes), with a random key mask and without,
              against their twins on the unpadded heads (96 and 128 at BH =
              32, T = 8192, 120 and the softcap variants at BH = 16, T =
              2048); the split passes bitwise repeatable, masked keys and
              fully masked batch rows exactly zero; the dQ pass's edges at
              head width 128 too, with the 128-wide key block (fused and
              split) on the same inputs.
              Rows 5 and 10 (the GEGLU
              feed-forward, csrc/ff.cu and csrc/ff_bwd.cu on the TMA +
              wgmma GEMM of csrc/gemm_sm90.cuh) also at the multi-view
              step's 65536 tokens, and at (D, hidden) = (256, 1024), (768,
              3072) and (1024, 4096) with 128 and 512 tokens; row 10's
              gradients bitwise equal on two calls at every shape.
3. main       registration.sample + predict_poses at S=4 x 2 x 4096, 2 Euler
              steps, rigidity forcing, bf16, with random weights from a seed at
              the width and depth of teacher3_last (6 layers, D=512). The qk
              gains of self layers 0-2 and global layers 0, 1 and 4 are raised
              so that their guard bound exceeds 60, as teacher3's do, so 6 of
              the 12 attention calls per forward take the online kernel.
              Checks: finite output of the right shape, the launch counts of
              one sample, and agreement with the same call through the plain
              versions. Then 2-layer D = 768 and D = 1024, H = 8 models
              (head widths 96: the fused branch, attention on heads padded
              to 128; and 128: the unfused branch, the masked online
              forward) serve the same batch: launch counts, points,
              rotations and velocity against plain. And the pruned sampler
              (bench.py's BENCH_PRUNE=1:4 of the JAX package): the first of
              the 2 steps on 1024 of the 4096 points of every part (one
              sorted index set from a seed), the exact switch to full
              resolution, the second step, with the transformer features:
              launch counts, points, rotations and features against the
              same call through the plain versions (same noise and set).
4. sample     rap_tpu_torch.apps.sample.main, the batch-evaluation entry
              point, on configs/synth_student.yaml and demo_data/synth (one
              dense batch of 8 pairs, 6 layers, 4 Euler steps, rigidity
              forcing, trajectories for the rigidity selection), with random
              weights from a seed at the checkpoint's shape written as an
              .npz (the gains of the same 6 attention calls raised past the
              guard as reflow_student.npz's are), at softcap 0 (the fused
              branch), 5 and 50 (the unfused branch with the fixed-bound and
              the online softcap kernel). Each run through the kernels and
              through the plain versions: the launch counts, the metric
              table, every metric finite, points and rotations against the
              plain run, generation ms per batch and the loader's wait; at
              softcap 5 the output must move away from softcap 0's. Then one
              run at softcap 0 with 3 generations and every evaluation option
              on (correspondence RMSE, overlap, part accuracy, ECDF, ICP,
              the artifacts with per-part PLYs and trajectory PCDs, into a
              temporary directory), after one without options: the metric
              keys equal rap_tpu's (a literal list), every metric finite,
              the artifact tree complete and read back by the port's
              readers, points and rotations against the same run through
              the plain versions, the generation ms within the no-option
              run's spread, and the time metrics and artifacts take per
              batch (outside the timed window). Then real weights: the
              committed reflow_student.npz on its config, through the
              kernels and the plain versions (object_chamfer under 0.15, the
              bar of tests/test_bundled_student.py, and the points against
              the plain run), and the same weights exported as a torch .pth
              and read back through checkpoint=<file>.pth (every metric
              within 1e-5 of the .npz run's).
5. demo       rap_tpu_torch.apps.demo.main in-process at rap_12 (12
              layers, D=512, H=8, random weights from the config's seed)
              with its CLI defaults (10 steps, adaptive parameters): the
              bundled demo_data/pair with zero, geometric and SpinNet
              features (random SpinNet weights from a seed; 3 generations,
              ICP with 4 yaw starts, the generated clouds written) and
              without rigidity forcing, and once with the committed
              reflow_student.npz (configs/synth_student.yaml: 6 layers, 4
              steps) and geometric features, then a six-view scene the phase
              writes (20 000 points a view, each in its own rigid frame:
              8 part slots). Each run through the kernels and through the
              plain versions (-o model.use_kernels=false): the launch counts
              (rows 3 and 5 only: the batch is padded, so the masked
              branch; attention over fewer than 1024 keys takes the dense
              route as in rap_tpu), each generation's points and rotations,
              every part{i}_transform.txt where both runs kept the same
              generation (rotation 2e-2 abs, translation 2e-2 of the scene's
              extent), the registered PLYs read back with the originals'
              counts, the SpinNet descriptors against the same module on the
              CPU (1e-4 abs); rows 3 (masked) and 5 at the demo batches'
              shapes against their twins.
6. train      one Muon step of the same model (fp32 random masters from a
              seed, the same raised gains, so 6 online and 6 fixed attention
              calls per forward) on 4 x 2 x 4096 points, remat on. Checks: at
              the step's draws, the loss and every gradient leaf through the
              kernels against the plain versions (and the plain fp32 path for
              the bf16 noise floor); one step through the kernels and one
              through the plain versions from the same state (loss, grad norm,
              each updated leaf's first-order loss change); the launch counts
              of one step; five more steps, finite and never skipped; the loss
              at the fixed (t, x_1) falls over those six steps. Then at 2
              layers on the same batch: a D = 512, H = 16 model (head width
              32), a D = 768, H = 8 model (head width 96, the fused branch:
              the attention backward at 128 wide) and a D = 1024, H = 8
              model (head width 128, the unfused branch: the masked forward,
              the attention backward at 128 wide, the FF kernels at D = 1024)
              each train through the kernels (gradients against plain, one
              step's launch counts, finite).
7. multiview  training on a padded multi-view batch, the shape the packer
              makes of 5-8-scan samples under configs/rap_train.yaml's
              80 000-point budget: S=2 x P=8 x N=4096, sample 0 with 8 parts,
              sample 1 with 6 (two empty slots), part sizes uniform in
              [2500, 4096] from a seed. The model has rap_12's width and depth
              (12 layers, D=512, H=8), bf16, fp32 random masters, Muon, remat,
              u-shaped timesteps. The batch takes the masked branch: online
              attention with the key mask, the fused backward with the mask
              for part attention and, past the 2 GiB dQ slab, the split
              backward for global attention. Checks: the launch counts of one
              12-layer step; at 2 layers of the same width and shape, the loss
              and every gradient leaf through the kernels against the plain
              versions (the train phase's rule), and sample + predict_poses
              through the kernels against the plain versions, and the same
              gradient check with softcap 5 (the softcap variants of the
              masked forward, row 6 and rows 7-8, with their launch counts);
              five more 12-layer steps, finite and never skipped, with the
              loss at a fixed (t, x_1) falling.
8. trainer    rap_tpu_torch.apps.train.main on configs/rap_train.yaml
              (rap_12, Muon, remat, 80 000 points a batch, 20-step
              validation) with overrides only, on a dataset it writes under
              rap_tpu_torch/build/trainer_data: 12 samples of 5-8 scans of
              2500-4096 points cut from a surface scene each (two samples a
              2 x 8 x 4096 batch, so 6 steps an epoch) and a val split
              linking the 8 demo_data/synth scenes. Run 1: two epochs, with
              validation and checkpoints each epoch; every step finite and
              never skipped, the launch counts of every step and every
              validation pass, metrics.jsonl's train/ and val/ rows,
              config.json, code_snapshot.zip, best/ and last/. Run 2: resumed
              from last/ for a third epoch; the restored state (parameters,
              optimizer state, step, generator) equal to run 1's last state
              bit for bit, the run at epoch 2 with the step count carried on,
              best/ rewritten only on a better monitor. Then the options at 2
              layers of the same width on the multiview phase's batch (on
              the trainer's scans the qk gains' bf16 floor passes the rule's
              cap, options or not: scripts/option_floors.py): the pose loss
              (0.1) and FF dropout (0.1), loss and gradients through the
              kernels against the plain versions (the train phase's rule;
              the same generator state gives both the same keep masks), rows
              5 and 10 launched 0 times, the pose loss finite on a batch with
              1- and 2-point parts, no more host syncs in a pose-loss forward
              and backward than without it (CUDA's sync debug mode), wandb
              never imported. Printed: ms a step (wall, synchronised, and
              the device's in one profiled step), valid points/s, the
              loader's wait a step, ms a validation pass, each checkpoint
              save's ms and bytes, the restore's ms, launches a step and a
              validation pass, and at rap_12 the step with the pose loss,
              dropout or both beside the step without.
9. timing     median ms per batch and pairs/s, and the pruned sampler's
              with and without the features; the sample path's median
              generation ms per batch and pairs/s at each softcap over three
              more runs; median ms per train step and
              tokens/s; median ms per multi-view step with valid points/s and
              padded slots/s, and one more multi-view step under
              torch.profiler (each device kernel's total time, the device's
              busy share); each kernel's median time beside its plain
              version, its bound and one PyTorch library call where one
              computes the same function (scaled_dot_product_attention forward,
              and its backward as forward+backward minus forward, with a
              boolean key mask for the masked shapes; for the softcap
              variants torch.compile(flex_attention) with the score_mod
              c·tanh(s) and a block mask from the key mask, timed here and
              used nowhere in the port); row 7 (the dKV pass) also as the
              split pair, rows 7 and 8 in one timed call (``pair_ms``), the
              time to hold beside the library's whole backward; rows 2 and
              3 at head widths 96 and 120 beside SDPA at the same width,
              the bound counting the products at the unpadded width; rows 3
              (masked), 6, 7 and 8 at head widths 96 and 128 (BH = 32, T =
              8192) beside SDPA at the same width (memory-efficient with the
              mask for row 3, the flash backward for rows 6-8); rows 5 and
              10 also at the multi-view step's 65536 tokens, each beside the
              yardstick ``matmul_ms``: torch.matmul over the same products
              without their epilogues (two for row 5, five for row 10; one
              for rows 1 and 4, three for row 9), timed here and used
              nowhere in the port. Rows 6s, 7s and 8s at head width 128
              (BH = 16, T = 2048, c = 5) beside flex_attention's backward.
              The demo: three more runs of each scene
              with zero features (registration ms per generation,
              preprocessing s) and one under torch.profiler; rows 3 and 5 at
              the demo shapes, their launches those of one generation.

Then it prints the card's name and power limit, one JSON line describing the
kernels, and as its last line {"ok": true, "device": {...}}. Any failed
check exits non-zero. The script imports torch, numpy, the standard library
and rap_tpu_torch only, resolves every path from this file, needs no
network, and needs one CUDA card. It reads one committed checkpoint,
demo_data/ckpts/reflow_student.npz (the sample phase's real-weight runs and
one demo run), and writes its random checkpoint, the student's .pth export,
the six-view scene, the trainer's data and checkpoints and the kernel
library under rap_tpu_torch/build/.
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
PHASES = ("build", "kernels", "main", "sample", "demo", "train", "multiview", "trainer",
          "timing")

# main path (bench.py:151-157 of the JAX package: 4 pairs of 2 x 4096 points)
S, P, N = 4, 2, 4096
D, H, DH, FH = 512, 8, 64, 2048
LAYERS, STEPS = 6, 2
# (layer, prefix) whose guard bound exceeds SAFE_BOUND2 in teacher3_last
ONLINE_LAYERS = {(0, "self"), (1, "self"), (2, "self"),
                 (0, "global"), (1, "global"), (4, "global")}
ONLINE_GAIN = 3.0  # gq = gk = 3 -> bound2 = log2(e)*8*9 = 103.9 > 60
# pruned serving (bench.py's BENCH_PRUNE=1:4 of the JAX package): the first
# of the STEPS Euler steps on a 1/4 subsample of every part (N/4 = 1024
# points: the fused branch still takes it), then the exact switch
PRUNE_COARSE, PRUNE_FACTOR = 1, 4

# H100 SXM published dense peaks (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# the special-function unit (exp2, tanh): 16 results per clock per SM (CUDA
# C++ Programming Guide, arithmetic instruction throughput, compute
# capability 9.0) against the tensor cores' 4096 dense bf16 FLOP per clock
# per SM, so at the data sheet's clock one 256th of the bf16 peak
PEAK_MUFU_OPS = PEAK_BF16_FLOPS / 256

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
# Training, kernels against plain versions from the same state. The loss
# and the global gradient norm are sums over every token: 2e-2 relative.
# Each gradient leaf: 5e-2 relative L2, or, where bf16 alone moves a leaf
# further from the fp32 gradient (the qk gains' gradients are sums over all
# tokens that nearly cancel), twice the distance of the plain bf16 path from
# the plain fp32 path on that leaf: the kernels may be no worse than bf16
# itself, with room for their own rounding order. That floored tolerance is
# capped at TOL_TRAIN_LEAF_CAP, and a leaf whose bf16 floor exceeds the cap
# fails: the check cannot see a kernel fault there. Updated parameters: each
# leaf's first-order loss change within 5e-2 of the plain path's, relative
# (the reason is stated in run_train).
TOL_TRAIN_SCALAR = 2e-2
TOL_TRAIN_LEAF = 5e-2
TOL_TRAIN_LEAF_CAP = 0.1
TRAIN_STEPS = 5  # further kernel steps after the first
TRAIN_CHECK_LAYERS = 2  # depth of the train phase's checks at head widths 32 and 96

# multiview phase: the packer's shape for 5-8-scan samples under
# configs/rap_train.yaml (max_points_per_batch 80000: parts round up to 8
# slots of 4096 points, so two samples fill 65536 slots and a third would
# make 98304), rap_12's depth for the steps and 2 layers for the comparison
# with the plain fp32 path
MV_S, MV_P, MV_N = 2, 8, 4096
MV_PARTS = (8, 6)              # parts of sample 0 and sample 1
MV_PART_POINTS = (2500, 4096)  # part sizes, uniform, from MV_SEED
MV_SEED = 21
MV_LAYERS, MV_CHECK_LAYERS = 12, 2
# (D, hidden) of models rows 5 and 10 take beside the main path's (512,
# 2048): rap_tpu's rule admits D % 128 == 0 and hidden % 64 == 0
FF_WIDTHS = ((256, 1024), (768, 3072), (1024, 4096))
# (D, H) of models rows 1, 4 and 9 take beside the main path's (512, 8):
# rap_tpu's rule and fused guard admit D % 128 == 0, dh % 8 == 0, dh < 128;
# head widths 32 (two heads a tile), 96 and 120 (one head a tile; out_proj
# gathers the tokens first) and 64
PROJ_WIDTHS = ((512, 16), (256, 8), (768, 8), (768, 12), (1024, 16), (1920, 16))
# models of head width 96 (D = 768, H = 8; rap_tpu's fused guard admits it)
# and 128 (D = 1024, H = 8; the guard needs dh < 128, so the unfused branch
# with the masked attention path, as in rap_tpu): each served at WIDE_LAYERS
# layers in the main phase and trained at TRAIN_CHECK_LAYERS in the train
# phase
WIDE_D, WIDEST_D, WIDE_LAYERS = 768, 1024, 2
# head widths the attention forward (rows 2, 3, 2s, 3s) runs at its
# 128-wide instantiation, (d, BH, T): d = 96 at the global shape of a D =
# 768, H = 8 model at the main path's batch (kept for the timing phase)
WIDE_HEADS = ((96, S * H, P * N), (120, 16, 2048))
# (d, BH, T): head widths the attention backward (rows 6-8, 6s-8s) and the
# masked online forward (rows 3, 3s at d = 128) run at their 128-wide
# instantiations: d = 96 and 128 at the global shape of a D = 768 or 1024,
# H = 8 model at the main path's batch (kept for the timing phase), d = 120
# at a smaller one
WIDE_BWD = ((96, S * H, P * N), (120, 16, 2048), (128, S * H, P * N))

# sample phase: the batch-evaluation entry point on the shipped config and
# data, random weights from a seed at its checkpoint's shape (6 layers,
# D=512), the gains of ONLINE_LAYERS raised as reflow_student.npz's are (the
# same 6 of 12 attention calls past the guard), at softcap 0 (the fused
# branch), 5 (unfused, fixed-bound softcap kernel: 5 log2(e) = 7.2 <= 60)
# and 50 (unfused, online softcap kernel: 72.1 > 60)
SAMPLE_CONFIG = "configs/synth_student.yaml"
SAMPLE_DATA = "demo_data/synth"
SAMPLE_SEED = 42
SOFTCAPS = (0.0, 5.0, 50.0)
# the every-option evaluation run: rap_tpu's eval options on (artifacts
# included), 3 generations, softcap 0
SAMPLE_OPTIONS = ("rmse_eval_on", "overlap_eval_on", "part_acc_eval_on", "ecdf_eval_on",
                  "use_icp", "save_results", "save_pointcloud_parts",
                  "save_merged_pointcloud_steps")
SAMPLE_OPTION_GENERATIONS = 3
# rap_tpu's metric names with every option on (rap_tpu.apps.sample.run_eval
# on demo_data/synth, configs/synth_student.yaml): each under the average
# section (unprefixed) and the best-of-3, rigidity-selected and
# overlap-selected sections
SAMPLE_OPTION_METRICS = (
    "average_rotation_error (deg)", "average_translation_error (m)", "chamfer_l2 (m)",
    "correspondence_ratio", "correspondence_rmse (m)", "ecdf_rotation_at_10deg",
    "ecdf_rotation_at_30deg", "ecdf_rotation_at_3deg", "ecdf_rotation_at_45deg",
    "ecdf_rotation_at_5deg", "ecdf_translation_at_0.05m", "ecdf_translation_at_0.1m",
    "ecdf_translation_at_0.25m", "ecdf_translation_at_0.5m", "ecdf_translation_at_0.75m",
    "object_chamfer", "overlap_ratio_at_0.5%", "overlap_ratio_at_1%", "overlap_ratio_at_2%",
    "part_accuracy", "recall_at_10deg_0.2m (nss)", "recall_at_10deg_5m (map)",
    "recall_at_15deg_0.3m (indoor_bufferx)", "recall_at_5deg_2m (outdoor_bufferx)",
    "recall_at_chamfer_0.2m", "recall_at_rmse_0.2m", "recall_at_transform_error_rmse_0.2m",
    "rigidity_rmse (m)", "transform_error_rmse (m)")
SAMPLE_OPTION_SECTIONS = ("", "best_of_3/", "rigidity_selected/", "overlap_ratio_selected/")
MV_SOFTCAP = 5.0  # the multi-view softcap training check
# demo phase: rap_tpu_torch.apps.demo.main at rap_12 (12 layers, D=512, H=8,
# random weights from the config's seed) and its CLI defaults (10 steps,
# adaptive parameters), on the bundled pair four ways and on a six-view
# scene this script writes (~20 000 points a view, each under its own rigid
# pose: P = 8 part slots, the map-merging use)
DEMO_PAIR = "demo_data/pair"
STUDENT_PATH = "demo_data/ckpts/reflow_student.npz"
DEMO_RUNS = (("zero", ["--features", "zero"]),
             ("geometric", ["--features", "geometric"]),
             ("spinnet", ["--features", "spinnet", "--n-generations", "3", "--icp-refine",
                          "--icp-restarts", "4", "--output-generated"]),
             ("no-forcing", ["--no-rigidity-forcing"]),
             ("student geometric", ["--config", str(ROOT / "configs" / "synth_student.yaml"),
                                    "--checkpoint", str(ROOT / STUDENT_PATH),
                                    "--features", "geometric", "--num-steps", "4"]))
DEMO_VIEWS, DEMO_VIEW_POINTS, DEMO_SEED = 6, 20_000, 31
TOL_DEMO_TRANSLATION = 2e-2    # of the scene's bounding box
TOL_SPINNET_ABS = 1e-4         # descriptors on the card against the CPU
SAMPLE_TIMING_RUNS = 3
# real weights: the committed reflow student on its own config and data
# (configs/synth_student.yaml, demo_data/synth), the quality bar of
# tests/test_bundled_student.py:74, and the metrics of its .pth export
# against the .npz run
STUDENT_CHAMFER = 0.15
TOL_ROUND_TRIP_METRIC = 1e-5
# trainer phase: rap_tpu_torch.apps.train.main on configs/rap_train.yaml
# (rap_12, Muon, remat, 80 000 points a batch, 20-step validation) with
# overrides only: TRAINER_SAMPLES samples of 5-8 scans of 2500-4096 points
# each (the multiview phase's distribution: two samples a 2 x 8 x 4096
# batch), cut from a surface scene per sample and written under the build
# directory, a val split linking the 8 demo_data/synth scenes; two epochs,
# then a resume for a third; then the training options (pose loss, FF
# dropout) at TRAINER_OPTION_LAYERS layers against the plain versions
TRAINER_CONFIG = "configs/rap_train.yaml"
TRAINER_SAMPLES, TRAINER_SCANS, TRAINER_SEED = 12, (5, 8), 41
TRAINER_EPOCHS = 2
TRAINER_POSE_WEIGHT, TRAINER_DROPOUT = 0.1, 0.1
TRAINER_OPTION_LAYERS = 2


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


def bound(flops: float, nbytes: float, mufu: float = 0.0) -> tuple[float, str]:
    """Least time on the card (ms) and what bounds it: the tensor cores'
    products or the special-function unit's ``mufu`` ops ("operations"), or
    the bytes."""
    t_ops = max(flops / PEAK_BF16_FLOPS, mufu / PEAK_MUFU_OPS)
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def ops_limiter(flops: float, mufu: float) -> str:
    """Which unit bounds the operations: at d = 64 one exp2 per logit ties
    the 4·d FLOP of the forward's two products, and a softcap's tanh tips
    the forward and the dQ pass to the special-function unit."""
    return "MUFU" if mufu / PEAK_MUFU_OPS > flops / PEAK_BF16_FLOPS else "tensor cores"


# device kernel name fragments -> what a profiled step spends the time on
PROFILE_GROUPS = (
    (("flash_fwd_kernel<false, false,",), "row 3: online attention forward"),
    (("flash_fwd_kernel<true, false,",), "row 2: fixed-bound attention forward"),
    (("dkv_kernel<true, false>",), "row 6: fused attention backward"),
    (("dkv_kernel<false, false>",), "row 7: dK, dV pass"),
    (("dq_kernel<false>",), "row 8: dQ pass"),
    (("flash_fwd_kernel<false, true,", "flash_fwd_kernel<true, true,", "dkv_kernel<true, true>",
      "dkv_kernel<false, true>", "dq_kernel<true>"), "rows 2, 3, 6-8: softcap variants"),
    (("FfFwd", "ff_ln_kernel<false>"), "row 5: ff forward"),
    (("ProjEpi", "adaln_ln_kernel<false>"), "row 1: proj forward"),
    (("OutHeadMajor", "OutTokens", "tokens_kernel"), "row 4: out_proj forward"),
    (("ff_bwd_", "ff_ln_kernel<true>", "F32Out<10>", "ln_grad_kernel<false>"),
     "row 10: ff backward"),
    (("ProjBwdEpi", "adaln_ln_kernel<true>", "dv_copy_kernel", "F32Out<9>",
      "ln_grad_kernel<true>"), "row 9: proj backward"),
    (("colsum_kernel", "splitsum_kernel"), "rows 9, 10: fixed-order reductions"),
    (("gemm", "nvjet", "cutlass", "xmma"), "cuBLAS matrix products"),
)


def multiview_parts(seed: int = MV_SEED) -> list[list[int]]:
    """Part sizes of the multi-view batch, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    lo, hi = MV_PART_POINTS
    return [rng.integers(lo, hi, n, endpoint=True).tolist() for n in MV_PARTS]


def multiview_masks(parts) -> tuple[torch.Tensor, torch.Tensor]:
    """The batch's key masks on the card, int32: part attention (S*P, N) and
    global attention (S, P*N)."""
    mask = np.zeros((MV_S * MV_P, MV_N), bool)
    for s, counts in enumerate(parts):
        for p, n in enumerate(counts):
            mask[s * MV_P + p, :n] = True
    part = torch.from_numpy(mask).to(device="cuda", dtype=torch.int32)
    return part, part.reshape(MV_S, MV_P * MV_N).contiguous()


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def run_build(report, fails):
    import ctypes

    from rap_tpu_torch.ops import _build

    lib = _build.load()
    log(f"  library {lib.path.relative_to(ROOT)}; nvcc took {lib.build_seconds:.1f} s"
        + ("" if lib.build_seconds else " (cached build loaded)"))
    for line in lib.compiler_log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill", "wgmma",
                                   "setmaxnreg")) \
                or "error" in line.lower() or "warning" in line.lower():
            log(f"  ptxas: {line.strip()}")
    report["build_seconds"] = lib.build_seconds
    # the key-block backward (rows 6, 7) and the dQ pass (row 8), at head
    # widths 64 and 128: setmaxnreg needs the launch bound's 168 registers;
    # local memory would be a stack or spills
    report["dkv_kernel_attributes"] = {}
    report["dq_kernel_attributes"] = {}
    for entry, key, kernel in (("rtt_flash_bwd_attributes", "dkv", "dkv{}_kernel<true, {}>"),
                               ("rtt_flash_bwd_dkv_attributes", "dkv",
                                "dkv{}_kernel<false, {}>"),
                               ("rtt_flash_bwd_dq_attributes", "dq", "dq{}_kernel<{}>")):
        out = (ctypes.c_int * 8)()
        _build.check(getattr(lib.lib, entry)(out), entry)
        for i, (width, softcap) in enumerate((w, c) for w in ("", "128")
                                             for c in ("false", "true")):
            name = kernel.format(width, softcap)
            regs, local = out[2 * i], out[2 * i + 1]
            report[f"{key}_kernel_attributes"][name] = {"registers": regs, "local_bytes": local}
            fails.check(f"{name}: {regs} registers, {local} local bytes",
                        regs == 168 and local == 0, "(need 168 and 0)")
    # every kernel behind rows 1-5, 9 and 10: no local memory (a stack or
    # spills); the setmaxnreg kernels (the attention forward's eight
    # instantiations, the fused GEGLU backward) need the launch bound's 168
    report["gemm_kernel_attributes"] = {}
    for entry, names in _build.QUERY_KERNELS.items():
        out = (ctypes.c_int * (2 * len(names)))()
        _build.check(getattr(lib.lib, entry)(out), entry)
        for i, name in enumerate(names):
            regs, local = out[2 * i], out[2 * i + 1]
            report["gemm_kernel_attributes"][name] = {"registers": regs, "local_bytes": local}
            need_168 = name == "ff_bwd_geglu_kernel" or name.startswith("flash_fwd_kernel")
            fails.check(f"{name}: {regs} registers, {local} local bytes",
                        local == 0 and (regs == 168 or not need_168),
                        "(need 168 and 0)" if need_168 else "(need 0 local bytes)")


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
                                                 "out_proj", "ff", "flash_bwd", "proj_bwd",
                                                 "ff_bwd", "flash_bwd_dkv", "flash_bwd_dq",
                                                 "flash_bwd_masked", "flash_online_masked"),
                                                0.0)

    def compare(kernel, label, got, ref, **kw):
        err = fails.compare(label, got, ref, **kw)
        errs[kernel] = max(errs.get(kernel, 0.0), err)

    def compare_lse(label, got, ref):
        fails.compare(label, got, ref,
                      tol_rel=TOL_LSE_ABS / max(float(ref.abs().max()), 1e-30))

    for is_global in (False, True):
        tag = "global" if is_global else "part"
        args = (inp["x"], inp["ada"], inp["w_qkv"], inp["gq"], inp["gk"], P, is_global)
        got, again = fp.adaln_qkv(*args), fp.adaln_qkv(*args)
        for nm, g_, r_ in zip(("q", "k", "va"), got, fp.adaln_qkv_plain(*args)):
            compare("proj", f"proj[{tag}].{nm}", g_, r_)
        fails.check(f"proj[{tag}]: bitwise equal on two calls",
                    all(torch.equal(a, b) for a, b in zip(got, again)))
        del again
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

    # ---- backward kernels, at the training shapes --------------------------
    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    state["attn_bwd"] = {}
    for tag in ("part", "global"):
        qh, kh, vah, _, b2 = state["attn"][tag]
        dout = randn(*qh.shape)
        for variant in ("fixed", "online"):
            if variant == "fixed":
                out, lse = fa.flash_fixed_kernel(qh, kh, vah, b2)
            else:
                out, lse = fa.flash_online_kernel(qh, kh, vah)
            got = fa.flash_bwd(qh, kh, vah, out, lse, dout)
            ref = fa.flash_bwd_plain(qh, kh, vah, out, lse, dout)
            for nm, g_, r_ in zip(("dq", "dk", "dv"), got, ref):
                compare("flash_bwd", f"flash_bwd[{tag},{variant}].{nm}", g_, r_)
            state["attn_bwd"][tag, variant] = (out, lse, dout)

    gq_eff, gk_eff = fp.fold_gains(inp["gq"], inp["gk"])
    state["proj_bwd_args"] = {}
    for is_global in (False, True):
        tag = "global" if is_global else "part"
        lead = (S, H, P, N) if is_global else (S * P, H, N)
        dva = randn(*lead, DH + 1)
        dva[..., DH] = 0  # the attention backward's cotangent of the ones column
        args = (inp["x"], inp["ada"], inp["w_qkv"], gq_eff, gk_eff, randn(*lead, DH),
                randn(*lead, DH), dva, P, is_global)
        compare_proj_bwd(fails, compare, f"proj_bwd[{tag}]", args)
        state["proj_bwd_args"][tag] = args

    ffb_args = (inp["x"].reshape(-1, D), randn(inp["tokens"], D, scale=0.1), inp["ln_s"],
                inp["ln_b"], inp["wi"], inp["bi"].float(), inp["wo"])
    compare_ff_bwd(fails, compare, "ff_bwd", ffb_args)
    state["ff_bwd_args"] = ffb_args
    run_kernels_proj(fails, gen, compare)
    run_kernels_ff(fails, state, gen, compare)
    run_kernels_multiview(fails, state, gen, compare)
    run_kernels_softcap(fails, state, gen, compare, compare_lse)
    run_kernels_edges(fails, gen, compare, compare_lse)
    run_kernels_dq_edges(fails, gen, compare)
    run_kernels_wide_heads(fails, state, gen, compare, compare_lse)
    run_kernels_wide_backward(fails, state, gen, compare, compare_lse)


FF_GRADS = ("dx", "dws", "dwb", "dwi", "dbi", "dwo", "dbo")


def compare_proj_bwd(fails, compare, label, args):
    """Row 9 against its twin, and its gradients bitwise equal on a second
    call (every sum over tokens is added in a fixed order)."""
    from rap_tpu_torch.ops import fused_proj as fp

    got, again = fp.proj_bwd_kernel(*args), fp.proj_bwd_kernel(*args)
    for nm, g_, r_ in zip(("dx", "dada", "dw", "dgq", "dgk"), got, fp.proj_bwd_plain(*args)):
        compare("proj_bwd", f"{label}.{nm}", g_, r_)
    fails.check(f"{label}: bitwise equal on two calls",
                all(torch.equal(a, b) for a, b in zip(got, again)))


def compare_ff_bwd(fails, compare, label, args):
    """Row 10 against its twin, and its gradients bitwise equal on a second
    call (every sum over tokens is added in a fixed order)."""
    from rap_tpu_torch.ops import fused_ff as ff

    got, again = ff.ff_bwd_kernel(*args), ff.ff_bwd_kernel(*args)
    for nm, g_, r_ in zip(FF_GRADS, got, ff.ff_bwd_plain(*args)):
        compare("ff_bwd", f"{label}.{nm}", g_, r_)
    fails.check(f"{label}: bitwise equal on two calls",
                all(torch.equal(a, b) for a, b in zip(got, again)))


def proj_inputs(gen, G: int, n: int, width: int, heads: int):
    """Rows 1 and 4's inputs for G parts of n tokens at width D and H heads,
    on the card, with make_kernel_inputs' scales: (x, ada, w_qkv, gamma_q,
    gamma_k, w_out, b_out), the gains unfolded."""
    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    dh = width // heads
    return (randn(G, n, width), randn(G, 2 * width, dtype=torch.float32, scale=0.1),
            randn(width, 3 * width, scale=width ** -0.5),
            1.0 + randn(heads, dh, dtype=torch.float32, scale=0.1),
            1.0 + randn(heads, dh, dtype=torch.float32, scale=0.1),
            randn(width, width, scale=width ** -0.5), randn(width, scale=0.1))


def run_kernels_proj(fails, gen, compare):
    """Rows 1, 4 and 9 at the other head widths they take (4 parts of 1024
    tokens, 2 a sample), at one tile row (1 part of 128 tokens), both
    layouts, and at a global layout whose N is not a multiple of 128 (N =
    192, P·N = 384: rap_tpu's rule refuses it, its fused guard and the
    kernels take it); rows 1 and 9 bitwise equal on two calls. Then a part
    layout of N = 192, which the kernels cannot take: the entry points take
    the twins and launch nothing, and the kernels refuse it."""
    from rap_tpu_torch.ops import fused_proj as fp
    from rap_tpu_torch.ops import launch_counts, reset_launches

    both = (False, True)
    cases = [(f"D={w}, H={h}", 4, 1024, w, h, 2, both) for w, h in PROJ_WIDTHS]
    cases.append(("one tile row", 1, 128, D, H, 1, both))
    cases.append(("N=192, P=2", 4, 192, D, H, 2, (True,)))
    for label, G_, n, width, heads, P_, layouts in cases:
        x, ada, w, gamma_q, gamma_k, w_out, b_out = proj_inputs(gen, G_, n, width, heads)
        gq_eff, gk_eff = fp.fold_gains(gamma_q, gamma_k)
        for is_global in layouts:
            tag = f"{label}, {'global' if is_global else 'part'}"
            args = (x, ada, w, gq_eff, gk_eff, P_, is_global)
            got, again = fp.proj_kernel(*args), fp.proj_kernel(*args)
            for nm, g_, r_ in zip(("q", "k", "va"), got, fp.proj_plain(*args)):
                compare("proj", f"proj[{tag}].{nm}", g_, r_)
            fails.check(f"proj[{tag}]: bitwise equal on two calls",
                        all(torch.equal(a, b) for a, b in zip(got, again)))
            a5 = (torch.randn(got[0].shape, generator=gen, device="cuda")).to(torch.bfloat16)
            out_args = (a5, x, w_out, b_out, P_, is_global)
            compare("out_proj", f"out_proj[{tag}]", fp.out_kernel(*out_args),
                    fp.out_plain(*out_args))
            dva = torch.randn(got[2].shape, generator=gen, device="cuda").to(torch.bfloat16)
            cot = (a5, torch.randn(a5.shape, generator=gen, device="cuda").to(torch.bfloat16), dva)
            compare_proj_bwd(fails, compare, f"proj_bwd[{tag}]",
                             (x, ada, w, gq_eff, gk_eff, *cot, P_, is_global))

    G_, n, P_ = 4, 192, 2
    x, ada, w, gamma_q, gamma_k, w_out, b_out = proj_inputs(gen, G_, n, D, H)
    gq_eff, gk_eff = fp.fold_gains(gamma_q, gamma_k)
    label = f"G={G_}, N={n}, part (refused)"
    reset_launches()
    got = fp.adaln_qkv(x, ada, w, gamma_q, gamma_k, P_, False)
    out = fp.attn_out(got[0], x, w_out, b_out, P_, False)
    torch.cuda.synchronize()
    fails.check(f"{label}: the entry points launch nothing", sum(launch_counts().values()) == 0)
    for nm, g_, r_ in zip(("q", "k", "va"), got,
                          fp.proj_plain(x, ada, w, gq_eff, gk_eff, P_, False)):
        fails.compare(f"{label}: adaln_qkv.{nm} vs the kernel's twin", g_, r_)
    fails.compare(f"{label}: attn_out vs the kernel's twin", out,
                  fp.out_plain(got[0], x, w_out, b_out, P_, False))
    reason = fp.proj_shape_error(G_, n, D, H, D // H, P_, False)
    for name, call in (("proj_kernel", lambda: fp.proj_kernel(x, ada, w, gq_eff, gk_eff, P_,
                                                             False)),
                       ("out_kernel", lambda: fp.out_kernel(got[0], x, w_out, b_out, P_,
                                                           False))):
        try:
            call()
            refused = ""
        except ValueError as e:
            refused = str(e)
        fails.check(f"{label}: {name} refuses it",
                    "multiple of 128 tokens" in refused and "got 192" in refused,
                    f"({refused or 'no error'}; the rule: {reason})")


def ff_inputs(gen, T: int, width: int, hidden: int):
    """Rows 5 and 10's inputs at T tokens, width D, hidden width FH, on the
    card, with make_kernel_inputs' scales: (forward args, backward args)."""
    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    fwd = (randn(T, width), 1.0 + randn(width, dtype=torch.float32, scale=0.1),
           randn(width, dtype=torch.float32, scale=0.1),
           randn(width, 2 * hidden, scale=width ** -0.5), randn(2 * hidden, scale=0.1),
           randn(hidden, width, scale=hidden ** -0.5), randn(width, scale=0.1))
    bwd = (fwd[0], randn(T, width, scale=0.1), fwd[1], fwd[2], fwd[3], fwd[4].float(), fwd[5])
    return fwd, bwd


def run_kernels_ff(fails, state, gen, compare):
    """Rows 5 and 10 at the multi-view step's 65536 tokens (kept for the
    timing phase), and at the other widths the kernels take, 128 and 512
    tokens each."""
    from rap_tpu_torch.ops import fused_ff as ff

    shapes = [(MV_S * MV_P * MV_N, D, FH)] + [(T, w, h) for w, h in FF_WIDTHS for T in (128, 512)]
    for T, width, hidden in shapes:
        fwd, bwd = ff_inputs(gen, T, width, hidden)
        label = f"T={T}, D={width}, hidden {hidden}"
        compare("ff", f"ff[{label}]", ff.ff_kernel(*fwd), ff.ff_plain(*fwd))
        compare_ff_bwd(fails, compare, f"ff_bwd[{label}]", bwd)
        if T == MV_S * MV_P * MV_N:
            state["ff_mv"] = (fwd, bwd)


def multiview_attention_inputs(gen, BH: int, T: int, d: int = DH):
    """q, k, va as the masked branch hands them to the kernels: rows of norm
    sqrt(dh) (qk-norm at unit gains), q pre-scaled by log2(e)/sqrt(dh)."""
    def rows(scale):
        x = torch.randn((BH, T, d), generator=gen, device="cuda")
        return (x / x.norm(dim=-1, keepdim=True) * scale).to(torch.bfloat16)

    v = torch.randn((BH, T, d), generator=gen, device="cuda").to(torch.bfloat16)
    va = torch.cat([v, torch.ones((BH, T, 1), dtype=torch.bfloat16, device="cuda")], -1)
    return rows(np.log2(np.e)), rows(np.sqrt(d)), va.contiguous()


def run_kernels_multiview(fails, state, gen, compare):
    """Rows 7-8 (split backward) and masked row 6 at the multi-view shapes."""
    from rap_tpu_torch.ops import flash_attention as fa

    part_mask, global_mask = multiview_masks(multiview_parts())
    state["mv_attn"] = {}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    # global attention: BH = 2 x 8, T = 8 x 4096; past the 2 GiB slab
    BH, T = MV_S * H, MV_P * MV_N
    qh, kh, vah = multiview_attention_inputs(gen, BH, T)
    dout = randn(BH, T, DH)
    for tag, mask in (("masked", global_mask), ("unmasked", None)):
        out, lse = fa.flash_online(qh, kh, vah, mask, heads=H)
        if mask is not None:
            compare("flash_online_masked", "flash_online[multiview global,masked].out", out,
                    fa.flash_online_plain(qh, kh, vah, mask, H)[0])
        doa = fa.augment_do(dout, out).contiguous()
        args = (qh, kh, vah, doa, lse, mask, H)
        dk, dv = fa.flash_bwd_dkv(*args)
        dq = fa.flash_bwd_dq(*args)
        rk, rv = fa.flash_bwd_dkv_plain(*args)
        compare("flash_bwd_dkv", f"flash_bwd_dkv[global,{tag}].dk", dk, rk)
        compare("flash_bwd_dkv", f"flash_bwd_dkv[global,{tag}].dv", dv, rv)
        compare("flash_bwd_dq", f"flash_bwd_dq[global,{tag}].dq", dq, fa.flash_bwd_dq_plain(*args))
        dk2, dv2 = fa.flash_bwd_dkv(*args)
        dq2 = fa.flash_bwd_dq(*args)
        fails.check(f"flash_bwd_dkv/dq[global,{tag}] bitwise repeatable",
                    torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2))
        # the fused backward needs no slab here: a second witness
        for nm, g_, r_ in zip(("dq", "dk", "dv"),
                              fa.flash_bwd(qh, kh, vah, out, lse, dout, mask, H),
                              (dq, dk, dv)):
            compare("flash_bwd_masked" if mask is not None else "flash_bwd",
                    f"flash_bwd[global,{tag}].{nm} vs split", g_, r_)
        if mask is not None:
            state["mv_attn"]["global"] = (qh, kh, vah, mask, out, lse, dout, doa)

    # part attention: BH = 16 x 8, T = 4096, two empty part slots
    BH, T = MV_S * MV_P * H, MV_N
    qh, kh, vah = multiview_attention_inputs(gen, BH, T)
    dout = randn(BH, T, DH)
    out, lse = fa.flash_online(qh, kh, vah, part_mask, heads=H)
    compare("flash_online_masked", "flash_online[multiview part,masked].out", out,
            fa.flash_online_plain(qh, kh, vah, part_mask, H)[0])
    got = fa.flash_bwd(qh, kh, vah, out, lse, dout, part_mask, H)
    ref = fa.flash_bwd_plain(qh, kh, vah, out, lse, dout, part_mask, H)
    for nm, g_, r_ in zip(("dq", "dk", "dv"), got, ref):
        compare("flash_bwd_masked", f"flash_bwd[part,masked].{nm}", g_, r_)
    empty = (part_mask.sum(1) == 0).repeat_interleave(H)
    masked_keys = (part_mask == 0).repeat_interleave(H, dim=0)
    fails.check("flash_bwd[part,masked] empty part slots: zero gradient",
                int(empty.sum()) == 2 * H
                and all(not bool(g[empty].any()) for g in got),
                f"{int(empty.sum()) // H} empty slots")
    fails.check("flash_bwd[part,masked] masked keys: zero dk, dv",
                not bool(got[1][masked_keys].any()) and not bool(got[2][masked_keys].any()))
    state["mv_attn"]["part"] = (qh, kh, vah, part_mask, out, lse, dout)


def sample_overrides(ckpt, softcap: float, kernels: bool = True) -> list[str]:
    """The ``-o`` overrides of the sample runs, the data path resolved from
    this file."""
    return [f"checkpoint={ckpt}", f"data.datasets.0.data_path={ROOT / SAMPLE_DATA}",
            f"model.softcap={softcap}", f"model.use_kernels={'true' if kernels else 'false'}"]


def sample_argv(ckpt, softcap: float, kernels: bool = True) -> list[str]:
    """The command line of ``rap_tpu_torch.apps.sample`` on the shipped config
    and data."""
    argv = ["--config", str(ROOT / SAMPLE_CONFIG)]
    for ov in sample_overrides(ckpt, softcap, kernels):
        argv += ["-o", ov]
    return argv


def sample_attention_shapes() -> dict[str, tuple[int, int]]:
    """(BH, T) of part and global attention on the first batch the port's
    loader makes of the shipped data under the shipped config."""
    from rap_tpu_torch.config import load_config
    from rap_tpu_torch.data import BatchLoader, LoaderConfig, PointCloudDataset

    cfg = load_config(ROOT / SAMPLE_CONFIG, sample_overrides("", 0.0))
    loader = BatchLoader([PointCloudDataset(cfg.data.datasets[0])], LoaderConfig(
        max_points_per_batch=cfg.data.max_points_per_batch), device="cuda")
    batches = loader.epoch(0)
    batch, _, _ = next(batches)
    batches.close()
    P_ = batch.G // batch.S
    log(f"  the loader's first batch of {SAMPLE_DATA}: S={batch.S} x P={P_} x N={batch.N}, "
        f"no_padding={batch.no_padding}")
    return {"part": (batch.G * H, batch.N), "global": (batch.S * H, P_ * batch.N)}


def softcap_attention_inputs(gen, BH: int, T: int, softcap: float, gain: float = 3.0,
                             d: int = DH):
    """q, k, va as the unfused branch hands them to the softcap kernels:
    qk-norm rows at gain ``gain`` (norm gain·sqrt(dh)), q pre-scaled by
    scale/c, so |q·k| <= gain²·sqrt(dh)/c and the cap bites."""
    def rows(norm):
        x = torch.randn((BH, T, d), generator=gen, device="cuda")
        return (x / x.norm(dim=-1, keepdim=True) * norm).to(torch.bfloat16)

    v = torch.randn((BH, T, d), generator=gen, device="cuda").to(torch.bfloat16)
    va = torch.cat([v, torch.ones((BH, T, 1), dtype=torch.bfloat16, device="cuda")], -1)
    return rows(gain / softcap), rows(gain * np.sqrt(d)), va.contiguous()


def run_kernels_softcap(fails, state, gen, compare, compare_lse):
    """The softcap variants of rows 2, 3, 6, 7 and 8 against their softcap
    twins: forward at the sample path's dense shapes (c = 5: fixed, c = 50:
    online, the choice flash_attention's guard makes), and the masked
    forward and the backward at the multi-view shapes."""
    from rap_tpu_torch.ops import flash_attention as fa

    shapes = state["sample_shapes"] = sample_attention_shapes()
    sc = state["softcap"] = {}
    for tag, (BH, T) in shapes.items():
        for c in (5.0, 50.0):
            qh, kh, vah = softcap_attention_inputs(gen, BH, T, c)
            b2 = fa._cap2(c)
            if b2 <= fa.SAFE_BOUND2:
                name = "flash_fixed_softcap"
                got, ref = (fa.flash_fixed(qh, kh, vah, b2, c),
                            fa.flash_fixed_plain(qh, kh, vah, b2, c))
            else:
                name = "flash_online_softcap"
                got, ref = (fa.flash_online(qh, kh, vah, None, 1, c),
                            fa.flash_online_plain(qh, kh, vah, None, 1, c))
            compare(f"{name}@{c:g}", f"{name}[sample {tag}, c={c:g}].out", got[0], ref[0])
            compare_lse(f"{name}[sample {tag}, c={c:g}].lse2", got[1], ref[1])
            sc["sample", tag, c] = (qh, kh, vah)

    part_mask, global_mask = multiview_masks(multiview_parts())
    for tag, BH, T, mask in (("part", MV_S * MV_P * H, MV_N, part_mask),
                             ("global", MV_S * H, MV_P * MV_N, global_mask)):
        for c in (5.0, 50.0):
            qh, kh, vah = softcap_attention_inputs(gen, BH, T, c)
            dout = torch.randn((BH, T, DH), generator=gen, device="cuda").to(torch.bfloat16)
            out, lse = fa.flash_online(qh, kh, vah, mask, H, c)
            compare(f"flash_online_softcap@{c:g}/mv",
                    f"flash_online_softcap[multiview {tag}, c={c:g}].out", out,
                    fa.flash_online_plain(qh, kh, vah, mask, H, c)[0])
            doa = fa.augment_do(dout, out).contiguous()
            if tag == "part":  # the fused backward, masked (row 6)
                got = fa.flash_bwd(qh, kh, vah, out, lse, dout, mask, H, c)
                ref = fa.flash_bwd_plain(qh, kh, vah, out, lse, dout, mask, H, c)
                for nm, g_, r_ in zip(("dq", "dk", "dv"), got, ref):
                    compare(f"flash_bwd_softcap@{c:g}",
                            f"flash_bwd_softcap[multiview part, c={c:g}].{nm}", g_, r_)
            else:  # the split backward (rows 7-8)
                args = (qh, kh, vah, doa, lse, mask, H)
                dk, dv = fa.flash_bwd_dkv(*args, c)
                dq = fa.flash_bwd_dq(*args, c)
                rk, rv = fa.flash_bwd_dkv_plain(*args, c)
                tag_c = f"multiview global, c={c:g}"
                compare(f"flash_bwd_dkv_softcap@{c:g}", f"flash_bwd_dkv_softcap[{tag_c}].dk",
                        dk, rk)
                compare(f"flash_bwd_dkv_softcap@{c:g}", f"flash_bwd_dkv_softcap[{tag_c}].dv",
                        dv, rv)
                compare(f"flash_bwd_dq_softcap@{c:g}", f"flash_bwd_dq_softcap[{tag_c}].dq", dq,
                        fa.flash_bwd_dq_plain(*args, c))
                fails.check(f"flash_bwd_dkv/dq_softcap[{tag_c}] bitwise repeatable",
                            torch.equal(dq, fa.flash_bwd_dq(*args, c))
                            and all(torch.equal(a, b) for a, b in
                                    zip((dk, dv), fa.flash_bwd_dkv(*args, c))))
            sc["mv", tag, c] = (qh, kh, vah, mask, out, lse, dout, doa)


# (label, BH, Tq, Tk, heads, live): the masked variant gets a random key mask
# (the last batch row fully masked where there are two) or, with live set, a
# mask that leaves only the first or only the last key tile live
FWD_EDGES = (("one key tile", 16, 128, 128, 8, None), ("odd tiles", 16, 384, 384, 8, None),
             ("one head", 1, 1024, 1024, 1, None), ("first tile live", 16, 1024, 1024, 8, "first"),
             ("last tile live", 16, 1024, 1024, 8, "last"))


def edge_mask(gen, B: int, Tk: int, live):
    if live is None:
        mask = torch.rand((B, Tk), generator=gen, device="cuda") > 0.3
        if B > 1:
            mask[-1] = False
        return mask
    mask = torch.zeros((B, Tk), dtype=torch.bool, device="cuda")
    keys = slice(0, 128) if live == "first" else slice(Tk - 128, Tk)
    mask[:, keys] = torch.rand((B, 128), generator=gen, device="cuda") > 0.5
    mask[:, keys.start] = True
    return mask


def run_kernels_edges(fails, gen, compare, compare_lse):
    """csrc/attention.cu at the edges of its design: one key tile (shorter
    than the TMA ring), an odd number of tiles, one head, and masks that
    leave only the first or the last key tile live; the fixed and online
    variants unmasked and the online one masked, each at softcap 0 and 5,
    against their plain twins."""
    from rap_tpu_torch.ops import flash_attention as fa

    for label, BH, Tq, Tk, heads, live in FWD_EDGES:
        for c in (0.0, 5.0):
            if c > 0.0:
                q, k, va = softcap_attention_inputs(gen, BH, max(Tq, Tk), c)
                b2 = fa._cap2(c)
            else:
                q, k, va = multiview_attention_inputs(gen, BH, max(Tq, Tk))
                b2 = float(np.log2(np.e) * np.sqrt(DH))  # |q| = log2(e), |k| = sqrt(dh)
            q, k, va = q[:, :Tq].contiguous(), k[:, :Tk].contiguous(), va[:, :Tk].contiguous()
            sfx = "_softcap" if c > 0.0 else ""
            tag = f"edge {label}, BH={BH}, Tq={Tq}, Tk={Tk}, c={c:g}"
            if live is None:
                for name, got, ref in (
                        (f"flash_fixed{sfx}", fa.flash_fixed(q, k, va, b2, c),
                         fa.flash_fixed_plain(q, k, va, b2, c)),
                        (f"flash_online{sfx}", fa.flash_online(q, k, va, None, 1, c),
                         fa.flash_online_plain(q, k, va, None, 1, c))):
                    compare(f"{name}/edges", f"{name}[{tag}].out", got[0], ref[0])
                    compare_lse(f"{name}[{tag}].lse2", got[1], ref[1])
            mask = edge_mask(gen, BH // heads, Tk, live)
            got = fa.flash_online(q, k, va, mask, heads, c)
            ref = fa.flash_online_plain(q, k, va, mask, heads, c)
            name = f"flash_online{sfx}"
            compare(f"{name}/edges", f"{name}[{tag}, masked].out", got[0], ref[0])
            rows = (mask.sum(1) > 0).repeat_interleave(heads)
            fails.check(f"{name}[{tag}, masked] empty rows",
                        bool((got[0][~rows] == 0).all())
                        and bool((got[1][~rows] == fa.LSE_EMPTY).all()),
                        f"{int((~rows).sum())} empty (batch*head) rows")
            compare_lse(f"{name}[{tag}, masked].lse2 (live rows)", got[1][rows], ref[1][rows])


def run_kernels_dq_edges(fails, gen, compare):
    """The dQ pass (rows 8, 8s: csrc/attention_bwd_dq.cuh, and at head width
    128 csrc/attention_bwd_dq128.cuh) at the edges of its design, FWD_EDGES'
    cases: one key tile (shorter than the TMA ring), an odd number of tiles,
    one head, and masks that leave only the first or the last key tile live;
    each at softcap 0 and 5 against flash_bwd_dq_plain, with the key mask (a
    batch row whose keys are all masked must get dq exactly 0: the kernel
    writes it, the caller does not zero-fill) and, where the mask is random,
    without one; bitwise repeatable. At head width 128 (d = 128) the key
    block's 128-wide instantiation too (rows 6, 7 and their softcap
    variants, csrc/attention_bwd_dkv128.cuh), whose ring of 2 stages is
    longer than one key tile's 128 queries take."""
    from rap_tpu_torch.ops import flash_attention as fa

    for d in (DH, 128):
        for label, BH, Tq, Tk, heads, live in FWD_EDGES:
            for c in (0.0, 5.0):
                if c > 0.0:
                    q, k, va = softcap_attention_inputs(gen, BH, max(Tq, Tk), c, d=d)
                else:
                    q, k, va = multiview_attention_inputs(gen, BH, max(Tq, Tk), d)
                q, k, va = q[:, :Tq].contiguous(), k[:, :Tk].contiguous(), va[:, :Tk].contiguous()
                dout = torch.randn((BH, Tq, d), generator=gen, device="cuda").to(torch.bfloat16)
                sfx = "_softcap" if c > 0.0 else ""
                mask = edge_mask(gen, BH // heads, Tk, live)
                for tag, m in (("masked", mask), ("unmasked", None))[:1 if live else 2]:
                    out, lse = fa.flash_online(q, k, va, m, heads, c)
                    args = (q, k, va, fa.augment_do(dout, out).contiguous(), lse, m, heads, c)
                    name = f"flash_bwd_dq{sfx}"
                    what = (f"{name}[edge {label}, BH={BH}, Tq={Tq}, Tk={Tk}, d={d}, c={c:g}, "
                            f"{tag}]")
                    dq = fa.flash_bwd_dq(*args)
                    compare(f"{name}/edges", f"{what}.dq", dq, fa.flash_bwd_dq_plain(*args))
                    fails.check(f"{what} bitwise repeatable",
                                torch.equal(dq, fa.flash_bwd_dq(*args)))
                    if m is not None:
                        empty = (m.sum(1) == 0).repeat_interleave(heads)
                        fails.check(f"{what} fully masked rows: dq exactly 0",
                                    not bool(dq[empty].any()),
                                    f"{int(empty.sum())} fully masked (batch*head) rows")
                    if d == DH:
                        continue
                    what = what.replace(name, f"flash_bwd_dkv{sfx}")
                    for nm, g_, r_ in zip(("dk", "dv"), fa.flash_bwd_dkv(*args),
                                          fa.flash_bwd_dkv_plain(*args)):
                        compare(f"flash_bwd_dkv{sfx}/edges", f"{what}.{nm}", g_, r_)
                    what = what.replace(f"flash_bwd_dkv{sfx}", f"flash_bwd{sfx}")
                    fused = (q, k, va, out, lse, dout, m, heads, c)
                    for nm, g_, r_ in zip(("dq", "dk", "dv"), fa.flash_bwd(*fused),
                                          fa.flash_bwd_plain(*fused)):
                        compare(f"flash_bwd{sfx}/edges", f"{what}.{nm}", g_, r_)


def run_kernels_wide_heads(fails, state, gen, compare, compare_lse):
    """Rows 2, 3, 2s and 3s at head widths 64 < d < 128 (WIDE_HEADS: the
    kernel's instantiation at 128, q, k and v zero-padded), against their
    twins on the unpadded heads: the fixed-bound and online variants, the
    online one with a random key mask, and the softcap variants at c = 5
    (fixed) and 50 (online), as the guard chooses them."""
    from rap_tpu_torch.ops import flash_attention as fa

    state["wide"] = {}
    for d, BH, T in WIDE_HEADS:
        def rows(norm, d=d, BH=BH, T=T):
            x = torch.randn((BH, T, d), generator=gen, device="cuda")
            return (x / x.norm(dim=-1, keepdim=True) * norm).to(torch.bfloat16)

        v = torch.randn((BH, T, d), generator=gen, device="cuda").to(torch.bfloat16)
        va = torch.cat([v, torch.ones((BH, T, 1), dtype=torch.bfloat16, device="cuda")],
                       -1).contiguous()
        # qk-norm rows at unit gains, q pre-scaled by log2(e)/sqrt(d): bound
        # log2(e) sqrt(d), the fixed variant's range
        q, k = rows(np.log2(np.e)), rows(np.sqrt(d))
        b2 = float(np.log2(np.e) * np.sqrt(d))
        tag = f"d={d}, BH={BH}, T={T}"
        mask = torch.rand((BH // H, T), generator=gen, device="cuda") > 0.3
        for name, label, got, ref in (
                ("flash_fixed", tag, fa.flash_fixed(q, k, va, b2),
                 fa.flash_fixed_plain(q, k, va, b2)),
                ("flash_online", tag, fa.flash_online(q, k, va), fa.flash_online_plain(q, k, va)),
                ("flash_online", f"{tag}, masked", fa.flash_online(q, k, va, mask, H),
                 fa.flash_online_plain(q, k, va, mask, H))):
            compare(f"{name}/wide", f"{name}[{label}].out", got[0], ref[0])
            if "masked" in label:  # a batch row may have no valid key: its lse is LSE_EMPTY
                live = (mask.sum(1) > 0).repeat_interleave(H)
                compare_lse(f"{name}[{label}].lse2 (live rows)", got[1][live], ref[1][live])
            else:
                compare_lse(f"{name}[{label}].lse2", got[1], ref[1])
        state["wide"][d] = (q, k, va, b2)
        for c in (5.0, 50.0):
            qc, kc = rows(3.0 / c), rows(3.0 * np.sqrt(d))
            b2c = fa._cap2(c)
            if b2c <= fa.SAFE_BOUND2:
                name = "flash_fixed_softcap"
                got, ref = fa.flash_fixed(qc, kc, va, b2c, c), fa.flash_fixed_plain(qc, kc, va,
                                                                                     b2c, c)
            else:
                name = "flash_online_softcap"
                got, ref = (fa.flash_online(qc, kc, va, None, 1, c),
                            fa.flash_online_plain(qc, kc, va, None, 1, c))
            compare(f"{name}/wide", f"{name}[{tag}, c={c:g}].out", got[0], ref[0])
            compare_lse(f"{name}[{tag}, c={c:g}].lse2", got[1], ref[1])


def run_kernels_wide_backward(fails, state, gen, compare, compare_lse):
    """The attention backward (rows 6, 7, 8 and their softcap variants at c
    = 5) at head widths 96, 120 and 128 (WIDE_BWD: csrc/attention_bwd_dkv128.cuh
    and csrc/attention_bwd_dq128.cuh, q, k, V and dO zero-padded to 128),
    behind the masked online forward (rows 3, 3s, checked here at d = 128,
    the width only this path takes), with a random key mask (one batch row
    fully masked) and without one, against the plain versions on the
    unpadded heads: the fused pass, the split dKV and dQ passes (bitwise
    repeatable; a fully masked batch row gets dq exactly 0, a masked key
    zero dk, dv). The softcap variants at (BH, T) = (16, 2048). The unmasked
    inputs of d = 96 and 128 at softcap 0 are kept for the timing phase."""
    from rap_tpu_torch.ops import flash_attention as fa

    state["wide_bwd"] = {}
    for d, BH0, T0 in WIDE_BWD:
        for c in (0.0, 5.0):
            BH, T = (BH0, T0) if c == 0.0 else (16, 2048)
            if c > 0.0:
                q, k, va = softcap_attention_inputs(gen, BH, T, c, d=d)
            else:
                q, k, va = multiview_attention_inputs(gen, BH, T, d)
            dout = torch.randn((BH, T, d), generator=gen, device="cuda").to(torch.bfloat16)
            mask = torch.rand((BH // H, T), generator=gen, device="cuda") > 0.3
            mask[-1] = False
            sfx = "_softcap" if c > 0.0 else ""
            for tag, m in (("masked", mask), ("unmasked", None)):
                what = f"d={d}, BH={BH}, T={T}, c={c:g}, {tag}"
                out, lse = fa.flash_online(q, k, va, m, H, c)
                if d == 128:
                    ref = fa.flash_online_plain(q, k, va, m, H, c)
                    compare(f"flash_online{sfx}/wide", f"flash_online{sfx}[{what}].out", out,
                            ref[0])
                    live = (torch.ones(BH, dtype=torch.bool, device="cuda") if m is None
                            else (m.sum(1) > 0).repeat_interleave(H))
                    compare_lse(f"flash_online{sfx}[{what}].lse2 (live rows)", lse[live],
                                ref[1][live])
                fused = (q, k, va, out, lse, dout, m, H, c)
                got = fa.flash_bwd(*fused)
                for nm, g_, r_ in zip(("dq", "dk", "dv"), got, fa.flash_bwd_plain(*fused)):
                    compare(f"flash_bwd{sfx}/wide", f"flash_bwd{sfx}[{what}].{nm}", g_, r_)
                doa = fa.augment_do(dout, out).contiguous()
                args = (q, k, va, doa, lse, m, H, c)
                dk, dv = fa.flash_bwd_dkv(*args)
                dq = fa.flash_bwd_dq(*args)
                for nm, g_, r_ in zip(("dk", "dv"), (dk, dv), fa.flash_bwd_dkv_plain(*args)):
                    compare(f"flash_bwd_dkv{sfx}/wide", f"flash_bwd_dkv{sfx}[{what}].{nm}", g_,
                            r_)
                compare(f"flash_bwd_dq{sfx}/wide", f"flash_bwd_dq{sfx}[{what}].dq", dq,
                        fa.flash_bwd_dq_plain(*args))
                fails.check(f"flash_bwd_dkv/dq{sfx}[{what}] bitwise repeatable",
                            torch.equal(dq, fa.flash_bwd_dq(*args))
                            and all(torch.equal(a, b) for a, b in
                                    zip((dk, dv), fa.flash_bwd_dkv(*args))))
                if m is not None:
                    empty = (m.sum(1) == 0).repeat_interleave(H)
                    masked_keys = (m == 0).repeat_interleave(H, dim=0)
                    fails.check(f"flash_bwd{sfx}[{what}] fully masked rows and masked keys: "
                                "zero gradient",
                                not bool(dq[empty].any()) and not bool(got[0][empty].any())
                                and not bool(dk[masked_keys].any())
                                and not bool(dv[masked_keys].any())
                                and not bool(got[1][masked_keys].any())
                                and not bool(got[2][masked_keys].any()))
                elif c == 0.0 and d in (96, 128):
                    state["wide_bwd"][d] = (q, k, va, out, lse, dout, doa, mask)
                elif d == 128:
                    state["wide_bwd_softcap"] = (q, k, va, out, lse, dout, doa, c)


def write_random_checkpoint(cfg, seed: int) -> Path:
    """fp32 random weights from ``seed`` at ``cfg``'s shape, with the gains
    of ONLINE_LAYERS raised, as an .npz in rap_tpu's layout (flat "a/b/c"
    keys, layers stacked) under the build directory; returns its path."""
    from rap_tpu_torch.models.dit import init_dit_params

    params = init_dit_params(seed, cfg, device="cpu", masters=True)
    for i, prefix in ONLINE_LAYERS:
        for qk in ("q", "k"):
            params["layers"][i][f"{prefix}_{qk}_gamma"] *= ONLINE_GAIN

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                       else {f"{prefix}{k}": v.numpy()})
        return out

    arrays = flat({k: v for k, v in params.items() if k != "layers"})
    layers = [flat(lp, "layers/") for lp in params["layers"]]
    arrays.update({k: np.stack([lp[k] for lp in layers]) for k in layers[0]})
    out = ROOT / "rap_tpu_torch" / "build" / f"sample_random_{seed}.npz"
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **arrays)
    return out


def run_sample(report, fails, state):
    """rap_tpu_torch.apps.sample.main on the shipped config and data at each
    softcap, through the kernels and through the plain versions."""
    from rap_tpu_torch.apps import sample as app
    from rap_tpu_torch.config import load_config
    from rap_tpu_torch.ops import KERNELS, launch_counts, reset_launches

    cfg = load_config(ROOT / SAMPLE_CONFIG)
    ckpt = write_random_checkpoint(cfg.model, SAMPLE_SEED)
    L, steps = cfg.model.num_layers, cfg.pipeline.inference_sampling_steps
    n_online = len(ONLINE_LAYERS)
    runs = state["sample_runs"] = {}
    outs = {}
    for c in SOFTCAPS:
        log(f"  -- apps.sample.main, softcap {c:g}, kernels")
        rec = {}
        reset_launches()
        app.main(sample_argv(ckpt, c), record=rec)
        torch.cuda.synchronize()
        counts = launch_counts()
        log(f"  -- apps.sample.main, softcap {c:g}, plain versions")
        rec_p = {}
        reset_launches()
        app.main(sample_argv(ckpt, c, kernels=False), record=rec_p)
        torch.cuda.synchronize()
        fails.check(f"sample c={c:g}: plain path launched no kernel",
                    sum(launch_counts().values()) == 0)
        forwards = len(rec["batch_gen_ms"]) * cfg.pipeline.n_generations * steps
        expected = dict.fromkeys(KERNELS, 0)
        if c == 0.0:
            expected.update(proj=2 * L * forwards, out_proj=2 * L * forwards, ff=L * forwards,
                            flash_fixed=(2 * L - n_online) * forwards,
                            flash_online=n_online * forwards)
        else:
            name = ("flash_fixed_softcap" if c * np.log2(np.e) <= 60.0
                    else "flash_online_softcap")
            expected.update({"ff": L * forwards, name: 2 * L * forwards})
        log(f"  launches, softcap {c:g}: {counts}")
        fails.check(f"sample c={c:g} launch counts", counts == expected, f"expected {expected}")
        sections = rec["sections"]
        vals = [v for sec in sections.values() for md in sec.values() for v in md.values()]
        fails.check(f"sample c={c:g}: every metric finite ({len(vals)} values)",
                    len(vals) > 0 and all(np.isfinite(v) for v in vals))
        worst_p, worst_r = 0.0, 0.0
        for (names, gens), (_, gens_p) in zip(rec["outputs"], rec_p["outputs"], strict=True):
            for (pts, R, t), (pts_p, R_p, _) in zip(gens, gens_p, strict=True):
                fails.check(f"sample c={c:g}: output finite",
                            all(bool(torch.isfinite(a).all()) for a in (pts, R, t)))
                worst_p = max(worst_p, fails.compare(
                    f"sample c={c:g} points vs plain ({len(names)} samples)", pts, pts_p,
                    tol_rel=TOL_POINTS))
                err_r = float((R - R_p).abs().max())
                worst_r = max(worst_r, err_r)
                fails.check(f"sample c={c:g} rotations vs plain", err_r <= TOL_ROTATION_ABS,
                            f"max_abs_err={err_r:.4e} (tol {TOL_ROTATION_ABS})")
        outs[c] = rec["outputs"][0][1][0][0]
        gen_s = sum(rec["batch_gen_ms"]) / 1e3
        log(f"  softcap {c:g}: {len(rec['batch_gen_ms'])} batch(es), {rec['pairs']} pairs; "
            f"generation {', '.join(f'{x:.2f}' for x in rec['batch_gen_ms'])} ms per batch -> "
            f"{rec['pairs'] / gen_s:.3f} pairs/s (first run); loader wait "
            f"{', '.join(f'{x:.2f}' for x in rec['load_ms'])} ms; plain versions "
            f"{', '.join(f'{x:.2f}' for x in rec_p['batch_gen_ms'])} ms per batch")
        runs[c] = {"launches": counts, "batch_ms_first": rec["batch_gen_ms"],
                   "load_ms": rec["load_ms"], "plain_batch_ms": rec_p["batch_gen_ms"],
                   "pairs": rec["pairs"], "points_err": worst_p, "rotation_err": worst_r,
                   "metrics": sections}
    moved = float((outs[5.0] - outs[0.0]).abs().max())
    fails.check("softcap 5 moves the output away from softcap 0",
                moved > max(1e-6, runs[5.0]["points_err"]),
                f"max|points(c=5) - points(c=0)| = {moved:.4e}, kernels vs plain at c=5 "
                f"{runs[5.0]['points_err']:.4e}")
    report["sample"] = {str(c): {k: v for k, v in r.items() if k != "metrics"}
                        for c, r in runs.items()}
    state["sample_ckpt"] = ckpt
    run_sample_options(report, fails, ckpt)
    run_sample_student(report, fails)


def run_sample_student(report, fails):
    """apps.sample.main on configs/synth_student.yaml with its committed
    reflow_student.npz, through the kernels and through the plain versions:
    object_chamfer under STUDENT_CHAMFER, the points within TOL_POINTS of the
    plain run's; then the same weights exported as a torch .pth
    (export_torch_state_dict, through save_torch_checkpoint) and evaluated
    through ``checkpoint=<file>.pth``: every metric within
    TOL_ROUND_TRIP_METRIC of the .npz run's."""
    from rap_tpu_torch.apps import sample as app
    from rap_tpu_torch.config import load_config
    from rap_tpu_torch.train.checkpoint import save_torch_checkpoint

    npz = ROOT / STUDENT_PATH
    recs, results = {}, {}
    for label, kernels in (("kernels", True), ("plain", False)):
        log(f"  -- apps.sample.main, {STUDENT_PATH}, {label}")
        recs[label] = {}
        results[label] = app.main(sample_argv(npz, 0.0, kernels), record=recs[label])
        torch.cuda.synchronize()
    pth = ROOT / "rap_tpu_torch" / "build" / "reflow_student.pth"
    cfg = load_config(ROOT / SAMPLE_CONFIG, [f"checkpoint={npz}"])
    save_torch_checkpoint(pth, app.load_params(cfg, "cuda"))
    log(f"  -- apps.sample.main, {pth.name} ({pth.stat().st_size} bytes), kernels")
    recs["pth"] = {}
    results["pth"] = app.main(sample_argv(pth, 0.0), record=recs["pth"])
    chamfer = results["kernels"]["overall"]["object_chamfer"]
    fails.check(f"reflow_student object_chamfer < {STUDENT_CHAMFER}", chamfer < STUDENT_CHAMFER,
                f"{chamfer:.6f} (plain versions {results['plain']['overall']['object_chamfer']:.6f})")
    for (names, gens), (_, gens_p) in zip(recs["kernels"]["outputs"], recs["plain"]["outputs"],
                                          strict=True):
        for (pts, R, _), (pts_p, R_p, _) in zip(gens, gens_p, strict=True):
            fails.compare(f"reflow_student points vs plain ({len(names)} samples)", pts, pts_p,
                          tol_rel=TOL_POINTS)
    worst = max(abs(results["pth"]["overall"][k] - v)
                for k, v in results["kernels"]["overall"].items())
    fails.check("reflow_student .pth round trip: the same metrics",
                set(results["pth"]["overall"]) == set(results["kernels"]["overall"])
                and worst <= TOL_ROUND_TRIP_METRIC,
                f"worst |difference| {worst:.3e} (tol {TOL_ROUND_TRIP_METRIC})")
    log(f"  reflow_student on demo_data/synth: {', '.join(f'{k} {v:.6f}' for k, v in sorted(results['kernels']['overall'].items()))}")
    report["sample_student"] = {
        "metrics": results["kernels"]["overall"], "plain_metrics": results["plain"]["overall"],
        "pth_metrics": results["pth"]["overall"], "pth_worst_abs_diff": worst,
        "batch_ms": recs["kernels"]["batch_gen_ms"], "plain_batch_ms": recs["plain"]["batch_gen_ms"]}


def option_argv(ckpt, out_dir, kernels: bool = True, options: bool = True) -> list[str]:
    """The sample command line at softcap 0 with SAMPLE_OPTION_GENERATIONS
    generations and, with ``options``, every SAMPLE_OPTIONS on, artifacts
    into ``out_dir``."""
    argv = sample_argv(ckpt, 0.0, kernels) + [
        "-o", f"pipeline.n_generations={SAMPLE_OPTION_GENERATIONS}",
        "-o", f"eval.output_dir={out_dir}"]
    for name in SAMPLE_OPTIONS if options else ():
        argv += ["-o", f"eval.{name}=true"]
    return argv


def check_artifacts(fails, root: Path, names, generations: int, steps: int) -> int:
    """The artifact tree of one dataset: for every sample and generation,
    rap_tpu's files (metrics JSON, pose, transform and global transform
    files, merged and per-part PLYs, the merged input and every trajectory
    step as PCDs), each read back by the port's readers; the merged PLY
    holds the parts' points, every PCD as many coloured points as the
    merged input. Returns the number of files."""
    from rap_tpu_torch.utils import ply as plyio

    found = {p.relative_to(root).as_posix() for p in root.rglob("*") if p.is_file()}
    expected = set()
    for name in names:
        for g in range(generations):
            d = f"synth/{name}/generation_{g}"
            expected |= {f"{d}/{f}" for f in (
                "metrics.json", "global_transform.txt", "merged_pred.ply",
                "generation/merged_input.pcd",
                *(f"part{p:02d}_{kind}" for p in range(P)
                  for kind in ("pose.txt", "transform.txt", "pred.ply")),
                *(f"generation/{sub}/step_{k}.pcd" for sub in ("endpoint", "midpoint")
                  for k in range(steps)))}
    fails.check("every-option run: the artifact tree is rap_tpu's", found == expected,
                f"{len(found)} files, expected {len(expected)}; missing "
                f"{sorted(expected - found)[:4]}, unexpected {sorted(found - expected)[:4]}")
    readable = True
    for name in names:
        for g in range(generations):
            d = root / "synth" / name / f"generation_{g}"
            merged = len(plyio.read_ply_points(d / "merged_pred.ply"))
            parts = sum(len(plyio.read_ply_points(d / f"part{p:02d}_pred.ply")) for p in range(P))
            metrics = json.loads((d / "metrics.json").read_text())
            transforms_ok = all(np.loadtxt(f).shape == (4, 4) for f in d.glob("*.txt"))
            n_in = len(plyio.read_pcd(d / "generation" / "merged_input.pcd")["points"])
            steps_ok = all(
                plyio.read_pcd(p)["colors"].shape == (n_in, 3)
                for p in (d / "generation").rglob("step_*.pcd"))
            readable &= (merged == parts == n_in > 0 and steps_ok and transforms_ok
                         and set(metrics) == set(SAMPLE_OPTION_METRICS) | {"scale"})
    fails.check("every-option run: the port's readers read every artifact", readable)
    return len(found)


def run_sample_options(report, fails, ckpt):
    """apps.sample.main at softcap 0 with every SAMPLE_OPTIONS on and
    SAMPLE_OPTION_GENERATIONS generations, artifacts into a temporary
    directory, through the kernels and through the plain versions, after one
    run of the same generations without the options: the table's keys equal
    rap_tpu's (SAMPLE_OPTION_METRICS under SAMPLE_OPTION_SECTIONS), every
    metric finite (as rap_tpu's are on this data), the artifact tree
    complete and readable, points and rotations against the plain run by
    the evaluation rule, and the generation ms (per generation, the timed
    window) within the no-option run's range widened by its spread and 5%.
    The time metrics and artifacts take per batch is printed: it is outside
    the timed window."""
    import tempfile

    from rap_tpu_torch.apps import sample as app
    from rap_tpu_torch.config import load_config
    from rap_tpu_torch.ops import launch_counts, reset_launches

    steps = load_config(ROOT / SAMPLE_CONFIG).pipeline.inference_sampling_steps
    recs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, kernels, options in (("no options", True, False), ("kernels", True, True),
                                        ("plain", False, True)):
            log(f"  -- apps.sample.main, softcap 0, {SAMPLE_OPTION_GENERATIONS} generations, "
                f"{'every option' if options else 'no option'}, "
                f"{'kernels' if kernels else 'plain versions'}")
            rec = {}
            reset_launches()
            res = app.main(option_argv(ckpt, Path(tmp) / label, kernels, options), record=rec)
            torch.cuda.synchronize()
            recs[label] = (res, rec, launch_counts())
        res, rec, counts = recs["kernels"]
        fails.check("every-option run went through the kernels",
                    counts["proj"] > 0 and counts["ff"] > 0 and counts["flash_fixed"] > 0)
        fails.check("every-option plain run launched no kernel",
                    sum(recs["plain"][2].values()) == 0)
        want = {sec + m for sec in SAMPLE_OPTION_SECTIONS for m in SAMPLE_OPTION_METRICS}
        got = set(res["synth"])
        fails.check(f"every-option run: metric keys are rap_tpu's ({len(want)})", got == want,
                    f"missing {sorted(want - got)[:4]}, unexpected {sorted(got - want)[:4]}")
        bad = [k for k, v in res["synth"].items() if not np.isfinite(v)]
        fails.check(f"every-option run: every metric finite ({len(got)})", not bad, str(bad))
        names = [n for names, _ in rec["outputs"] for n in names]
        n_files = check_artifacts(fails, Path(tmp) / "kernels", names,
                                  SAMPLE_OPTION_GENERATIONS, steps)
    worst_p = worst_r = 0.0
    for (names, gens), (_, gens_p) in zip(rec["outputs"], recs["plain"][1]["outputs"],
                                          strict=True):
        for (pts, R, _), (pts_p, R_p, _) in zip(gens, gens_p, strict=True):
            worst_p = max(worst_p, fails.compare(
                f"every-option run points vs plain ({len(names)} samples)", pts, pts_p,
                tol_rel=TOL_POINTS))
            worst_r = max(worst_r, float((R - R_p).abs().max()))
    fails.check("every-option run rotations vs plain", worst_r <= TOL_ROTATION_ABS,
                f"max_abs_err={worst_r:.4e} (tol {TOL_ROTATION_ABS})")
    base = recs["no options"][1]["gen_ms"]
    lo, hi = min(base), max(base)
    slack = (hi - lo) + 0.05 * float(np.median(base))
    med = float(np.median(rec["gen_ms"]))
    fails.check("every-option run: generation ms within the no-option run's spread",
                lo - slack <= med <= hi + slack,
                f"median {med:.2f} ms a generation (all {[round(x, 2) for x in rec['gen_ms']]});"
                f" without options {[round(x, 2) for x in base]} (+- {slack:.2f})")
    log(f"  every-option run: generation {', '.join(f'{x:.2f}' for x in rec['batch_gen_ms'])} "
        f"ms per batch ({SAMPLE_OPTION_GENERATIONS} generations; without options "
        f"{', '.join(f'{x:.2f}' for x in recs['no options'][1]['batch_gen_ms'])}); metrics, "
        f"aggregation and artifacts {', '.join(f'{x:.2f}' for x in rec['post_ms'])} ms per "
        f"batch (without options {', '.join(f'{x:.2f}' for x in recs['no options'][1]['post_ms'])}"
        f"; outside the timed window); {n_files} artifact files")
    report["sample_options"] = {
        "batch_ms": rec["batch_gen_ms"], "gen_ms": rec["gen_ms"], "post_ms": rec["post_ms"],
        "no_option_gen_ms": base, "no_option_post_ms": recs["no options"][1]["post_ms"],
        "plain_batch_ms": recs["plain"][1]["batch_gen_ms"], "points_err": worst_p,
        "rotation_err": worst_r, "artifact_files": n_files, "metrics": res["synth"]}


def surface_scene(rng, ground_points: int = 400_000, boxes: int = 12) -> np.ndarray:
    """A 30 x 12 m undulating ground with ``boxes`` boxes (4 walls and a
    lid each, 8000 points a box), drawn from ``rng``: (M, 3) points."""

    def height(xy):
        return 0.4 * np.sin(xy[..., 0] / 3.0) * np.cos(xy[..., 1] / 2.0) + 0.05 * xy[..., 0]

    xy = rng.uniform([0, 0], [30, 12], (ground_points, 2))
    parts = [np.column_stack([xy, height(xy)])]
    for _ in range(boxes):
        c, size = rng.uniform([1, 1], [29, 11]), rng.uniform(0.5, 2.0, 3)
        u = rng.uniform(-0.5, 0.5, (8000, 3))
        face = rng.integers(0, 5, len(u))
        u[face == 0, 2] = 0.5
        for f, axis, side in ((1, 0, 0.5), (2, 0, -0.5), (3, 1, 0.5), (4, 1, -0.5)):
            u[face == f, axis] = side
        parts.append(u * size + [c[0], c[1], size[2] / 2 + height(c)])
    return np.concatenate(parts)


def write_six_view_scene(root: Path, seed: int = DEMO_SEED) -> Path:
    """DEMO_VIEWS overlapping scans of one surface scene (a 30 x 12 m
    undulating ground with boxes), DEMO_VIEW_POINTS points each with 1 cm
    noise, each in its own frame (a random rigid pose), as PLYs in
    ``root``; returns ``root``."""
    from rap_tpu_torch.utils import ply as plyio

    rng = np.random.default_rng(seed)
    scene = surface_scene(rng)
    root.mkdir(parents=True, exist_ok=True)
    for v in range(DEMO_VIEWS):
        center = np.array([3.0 + v * 24.0 / (DEMO_VIEWS - 1), 6.0])
        near = scene[np.linalg.norm(scene[:, :2] - center, axis=1) < 7.0]
        pts = near[rng.choice(len(near), DEMO_VIEW_POINTS, replace=False)]
        pts = pts + rng.normal(0.0, 0.01, pts.shape)
        q = rng.normal(size=4)
        w, x, y, z = q / np.linalg.norm(q)
        R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                      [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                      [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])
        plyio.write_ply(root / f"view_{v}.ply", (pts - rng.uniform(-5, 5, 3)) @ R)
    return root


def demo_argv(inp: Path, out: Path, extra, kernels: bool = True) -> list[str]:
    return (["-i", str(inp), "-out", str(out), *extra]
            + ([] if kernels else ["-o", "model.use_kernels=false"]))


def demo_expected_launches(rec) -> dict:
    """Row 3 (masked online attention, each call whose key sequence is
    >= 1024: part attention at N, global at P·N; shorter ones take the dense
    route, as in rap_tpu) and row 5, per layer of every forward."""
    from rap_tpu_torch.ops import KERNELS

    batch, cfg = rec["batch"], rec["config"]
    G, Nb = batch.points.shape[:2]
    L = cfg.model.num_layers
    forwards = len(rec["gen_ms"]) * cfg.pipeline.inference_sampling_steps
    expected = dict.fromkeys(KERNELS, 0)
    expected.update(flash_online=L * forwards * ((Nb >= 1024) + (G * Nb >= 1024)),
                    ff=L * forwards)
    return expected


def check_demo_kernels(fails, state, label: str, batch) -> None:
    """Rows 3 (masked) and 5 at the demo batch's shapes, with its masks,
    against their plain versions; kept for the timing phase."""
    from rap_tpu_torch.ops import flash_attention as fa
    from rap_tpu_torch.ops import fused_ff as ff

    gen = torch.Generator(device="cuda").manual_seed(77)
    errs = state.setdefault("max_abs_err", {})
    G, Nb = batch.points.shape[:2]
    masks = {"part": batch.point_mask.to(torch.int32),
             "global": batch.point_mask.reshape(1, G * Nb).to(torch.int32)}
    for tag, mask in masks.items():
        if mask.shape[1] < 1024:
            continue  # the dense route, no kernel
        qh, kh, vah = multiview_attention_inputs(gen, mask.shape[0] * H, mask.shape[1])
        got = fa.flash_online(qh, kh, vah, mask, heads=H)[0]
        err = fails.compare(f"flash_online[demo {label} {tag}, masked]", got,
                            fa.flash_online_plain(qh, kh, vah, mask, H)[0])
        errs["flash_online_masked"] = max(errs.get("flash_online_masked", 0.0), err)
        state.setdefault("demo_attn", {})[f"{label} {tag}"] = (qh, kh, vah, mask)
    fwd, _ = ff_inputs(gen, G * Nb, D, FH)
    err = fails.compare(f"ff[demo {label}: T={G * Nb}]", ff.ff_kernel(*fwd), ff.ff_plain(*fwd))
    errs["ff"] = max(errs.get("ff", 0.0), err)
    state.setdefault("demo_ff", {})[label] = fwd


def run_demo(report, fails, state):
    """rap_tpu_torch.apps.demo.main on the card at rap_12 with random
    weights: the bundled pair four ways (DEMO_RUNS) and the six-view scene,
    each through the kernels and through the plain versions (the same
    noise, the same preprocessing)."""
    import tempfile

    from rap_tpu_torch.apps import demo
    from rap_tpu_torch.ops import launch_counts, reset_launches
    from rap_tpu_torch.spinnet import build_feature_extractor
    from rap_tpu_torch.utils import ply as plyio

    report["demo"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        scenes = [("pair", ROOT / DEMO_PAIR, DEMO_RUNS),
                  ("six-view", write_six_view_scene(ROOT / "rap_tpu_torch" / "build" / "six_view"),
                   (("zero", []),))]
        for scene, inp, runs in scenes:
            files = sorted(inp.glob("*.ply"))
            originals = [plyio.read_ply_points(f) for f in files]
            allpts = np.concatenate(originals)
            bbox = float((allpts.max(0) - allpts.min(0)).max())
            for name, extra in runs:
                label = f"{scene} {name}"
                log(f"  -- apps.demo.main, {label}: kernels, then plain versions")
                rec, rec_p = {}, {}
                reset_launches()
                rc = demo.main(demo_argv(inp, tmp / label, extra), record=rec)
                torch.cuda.synchronize()
                counts = launch_counts()
                reset_launches()
                rc_p = demo.main(demo_argv(inp, tmp / f"{label} plain", extra, kernels=False),
                                 record=rec_p)
                torch.cuda.synchronize()
                fails.check(f"demo {label}: both runs exit 0", rc == rc_p == 0)
                fails.check(f"demo {label}: plain path launched no kernel",
                            sum(launch_counts().values()) == 0)
                batch = rec["batch"]
                G, Nb = batch.points.shape[:2]
                fails.check(f"demo {label}: a padded batch (the masked branch)",
                            not batch.no_padding)
                expected = demo_expected_launches(rec)
                log(f"  launches: {counts}")
                fails.check(f"demo {label} launch counts", counts == expected,
                            f"expected {expected}")
                for g, (a, b) in enumerate(zip(rec["generations"], rec_p["generations"],
                                               strict=True)):
                    fails.compare(f"demo {label} generation {g} points vs plain", a[0], b[0],
                                  tol_rel=TOL_POINTS)
                    err_r = float((a[1] - b[1]).abs().max())
                    fails.check(f"demo {label} generation {g} rotations vs plain",
                                err_r <= TOL_ROTATION_ABS,
                                f"max_abs_err={err_r:.4e} (tol {TOL_ROTATION_ABS})")
                if rec["pick"] == rec_p["pick"]:
                    for p, (T, T_p) in enumerate(zip(rec["transforms"], rec_p["transforms"])):
                        err_r = float(np.abs(T[:3, :3] - T_p[:3, :3]).max())
                        err_t = float(np.abs(T[:3, 3] - T_p[:3, 3]).max())
                        fails.check(f"demo {label} part{p}_transform vs plain",
                                    err_r <= TOL_ROTATION_ABS
                                    and err_t <= TOL_DEMO_TRANSLATION * bbox,
                                    f"rotation {err_r:.4e} (tol {TOL_ROTATION_ABS}), "
                                    f"translation {err_t:.4e} m (tol "
                                    f"{TOL_DEMO_TRANSLATION * bbox:.4e})")
                else:  # rigid to ~1e-7, the pick between generations is float noise
                    log(f"  kept generation {rec['pick']} (plain: {rec_p['pick']}); "
                        "the generations are compared one by one above")
                written = [len(plyio.read_ply_points(tmp / label / "registered" / f.name))
                           for f in files]
                fails.check(f"demo {label}: registered PLYs read back",
                            written == [len(o) for o in originals], f"{written}")
                if name == "spinnet":
                    norms = np.concatenate([np.linalg.norm(f, axis=1) for f in rec["features"]])
                    fails.check(f"demo {label}: SpinNet descriptors are unit vectors",
                                bool(np.abs(norms - 1.0).max() <= 1e-4),
                                f"norms in [{norms.min():.6f}, {norms.max():.6f}]")
                    cpu = build_feature_extractor("", device="cpu")
                    err = max(float(np.abs(f - cpu(c, k, rec["des_r"])).max())
                              for c, k, f in zip(rec["clouds"], rec["keypoints"],
                                                 rec["features"]))
                    fails.check(f"demo {label}: SpinNet descriptors on the card vs the CPU",
                                err <= TOL_SPINNET_ABS,
                                f"max_abs_err={err:.4e} (tol {TOL_SPINNET_ABS})")
                if name == "zero":
                    check_demo_kernels(fails, state, scene, batch)
                    state.setdefault("demo_counts", {})[scene] = {
                        k: v // len(rec["gen_ms"]) for k, v in counts.items()}
                    state.setdefault("demo_inputs", {})[scene] = inp
                log(f"  {label}: keypoints per part {[len(k) for k in rec['keypoints']]}; "
                    f"batch (S, P, N) = (1, {G}, {Nb}); preprocessing "
                    f"{rec['preprocess_s']:.3f} s; features "
                    f"{', '.join(f'{x:.2f}' for x in rec['feature_ms']) or 'none'} ms per part; "
                    f"registration {', '.join(f'{x:.2f}' for x in rec['gen_ms'])} ms per "
                    f"generation (plain {', '.join(f'{x:.2f}' for x in rec_p['gen_ms'])}); "
                    f"ICP {rec['icp_ms']:.2f} ms")
                report["demo"][label] = {
                    "launches": counts, "keypoints": [len(k) for k in rec["keypoints"]],
                    "batch": [1, G, Nb], "preprocess_s": rec["preprocess_s"],
                    "feature_ms": rec["feature_ms"], "gen_ms": rec["gen_ms"],
                    "plain_gen_ms": rec_p["gen_ms"], "icp_ms": rec["icp_ms"],
                    "pick": [rec["pick"], rec_p["pick"]]}


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
    expected = dict.fromkeys(counts, 0)
    expected.update({
        "proj": 2 * LAYERS * STEPS, "out_proj": 2 * LAYERS * STEPS,
        "ff": LAYERS * STEPS, "flash_fixed": (2 * LAYERS - n_online) * STEPS,
        "flash_online": n_online * STEPS,
    })
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
    run_main_pruned(report, fails, state, n_online)
    run_main_wide_heads(report, fails, state)


def run_main_pruned(report, fails, state, n_online: int):
    """Serving with the pruned sampler (PRUNE_COARSE coarse steps on a
    1/PRUNE_FACTOR subsample, one index set drawn from a seed) and the
    transformer features, through the kernels and through the plain
    versions on the same noise and index set: the launch counts of one
    batch, points, rotations and features."""
    from rap_tpu_torch.models.dit import dit_forward
    from rap_tpu_torch.ops import launch_counts, reset_launches
    from rap_tpu_torch.registration import predict_poses, prune_size, sample

    params, batch, x_1 = state["params"], state["batch"], state["x_1"]
    n_sub = prune_size(N, PRUNE_FACTOR)
    idx = torch.randperm(N, generator=torch.Generator(device="cuda").manual_seed(3),
                         device="cuda")[:n_sub].sort().values
    rcfg = dataclasses.replace(state["rcfg"], prune_coarse_steps=PRUNE_COARSE,
                               prune_factor=PRUNE_FACTOR)
    plain = dataclasses.replace(rcfg, model=state["plain_cfg"].model)

    def serve(c, features=True):
        out = sample(params, c, batch, x_1=x_1, return_trajectory=False,
                     return_transformer_features=features, prune_index=idx)
        R, t = predict_poses(batch, out["points"])
        return out["points"], R, t, out.get("transformer_features")

    reset_launches()
    pts, R, _, feats = serve(rcfg)
    torch.cuda.synchronize()
    counts = launch_counts()
    # STEPS forwards of the ODE (the coarse ones on n_sub tokens a part) and
    # one for the features, each through the fused branch
    forwards = STEPS + 1
    expected = dict.fromkeys(counts, 0)
    expected.update(proj=2 * LAYERS * forwards, out_proj=2 * LAYERS * forwards,
                    ff=LAYERS * forwards, flash_fixed=(2 * LAYERS - n_online) * forwards,
                    flash_online=n_online * forwards)
    log(f"  pruned serving ({PRUNE_COARSE} of {STEPS} steps on {n_sub} of {N} points a "
        f"part, transformer features): launches {counts}")
    fails.check("pruned serving launch counts", counts == expected, f"expected {expected}")
    reset_launches()
    pts_p, R_p, _, feats_p = serve(plain)
    torch.cuda.synchronize()
    fails.check("pruned serving: plain path launched no kernel",
                sum(launch_counts().values()) == 0)
    fails.check("pruned serving: finite output and features",
                bool(torch.isfinite(pts).all() & torch.isfinite(feats).all()))
    fails.check("pruned serving: feature shape", tuple(feats.shape) == (S * P, N, D))
    fails.compare("pruned serving points vs plain", pts, pts_p, tol_rel=TOL_POINTS)
    err_r = float((R - R_p).abs().max())
    fails.check("pruned serving rotations vs plain", err_r <= TOL_ROTATION_ABS,
                f"max_abs_err={err_r:.4e} (tol {TOL_ROTATION_ABS})")
    # the features are one more forward at the final state, t = 1/STEPS;
    # the two runs' final states differ by bf16 noise (the points above),
    # which this random DiT moves its last residual stream by far more than
    # its velocity, so kernels and plain versions are compared at one state
    ts = torch.full((S,), 1.0 / STEPS, device="cuda")
    with torch.no_grad():
        own = dit_forward(params, rcfg.model, pts, ts, batch, P, return_features=True)[1]
        f_k = dit_forward(params, rcfg.model, pts_p, ts, batch, P, return_features=True)[1]
        f_p = dit_forward(params, plain.model, pts_p, ts, batch, P, return_features=True)[1]
    fails.check("pruned serving: the features are the forward's at the final state",
                torch.equal(feats, own))
    fails.compare("pruned serving transformer features vs plain, at one state", f_k, f_p,
                  tol_rel=TOL_VELOCITY)
    log(f"  (features of the two runs' own final states: max_abs_err "
        f"{float((feats - feats_p).abs().max()):.4e} of max {float(feats_p.abs().max()):.3e})")
    report["launches_pruned"] = state["pruned_counts"] = counts
    state.update(serve_pruned=serve, rcfg_pruned=rcfg)


def wide_model(width: int, layers: int, masters: bool = False):
    """(cfg, params) of a WIDE_LAYERS-deep model of ``width`` at H heads,
    random weights from a seed, the qk gains of layer 0's global attention
    raised past the guard (one online attention a forward on the fused
    branch)."""
    from rap_tpu_torch.models.config import DiTConfig
    from rap_tpu_torch.models.dit import attach_bounds, init_dit_params

    cfg = DiTConfig(embed_dim=width, num_heads=H, num_layers=layers)
    params = init_dit_params(0, cfg, device="cuda", masters=masters)
    lp = params["layers"][0]
    lp["global_q_gamma"] = lp["global_q_gamma"] * ONLINE_GAIN
    lp["global_k_gamma"] = lp["global_k_gamma"] * ONLINE_GAIN
    return cfg, params if masters else attach_bounds(params)


def run_main_wide_heads(report, fails, state):
    """Serving a D = 768 (dh = 96: the fused branch, the attention forward at
    its 128-wide instantiation, rows 1 and 4 one head a tile) and a D = 1024
    (dh = 128: the unfused branch, whose attention takes the masked online
    forward, row 3, at 128 wide) 8-head model at WIDE_LAYERS layers on the
    main path's batch: sample + predict_poses through the kernels (its
    launch counts read around it) against the same call through the plain
    versions, and the velocity at t = 1."""
    from rap_tpu_torch.models.dit import dit_forward
    from rap_tpu_torch.ops import launch_counts, reset_launches
    from rap_tpu_torch.ops.flash_attention import SAFE_BOUND2
    from rap_tpu_torch.registration import RPFConfig, predict_poses, sample

    state["wide_counts"], report["launches_wide_heads"] = {}, {}
    batch, x_1 = state["batch"], state["x_1"]
    for width in (WIDE_D, WIDEST_D):
        dh = width // H
        cfg, params = wide_model(width, WIDE_LAYERS)
        rcfg = RPFConfig(model=cfg, inference_sampling_steps=STEPS, rigidity_forcing=True)
        plain = dataclasses.replace(rcfg, model=dataclasses.replace(cfg, use_kernels=False))

        def serve(c, params=params):
            pts = sample(params, c, batch, x_1=x_1, return_trajectory=False)["points"]
            return (pts,) + tuple(predict_poses(batch, pts))

        reset_launches()
        pts, R, _ = serve(rcfg)
        torch.cuda.synchronize()
        counts = launch_counts()
        expected = dict.fromkeys(counts, 0)
        L_ = WIDE_LAYERS
        if dh < 128:
            n_online = sum(b > SAFE_BOUND2 for lp in params["layers"]
                           for b in (lp["self_bound2"], lp["global_bound2"]))
            expected.update(proj=2 * L_ * STEPS, out_proj=2 * L_ * STEPS, ff=L_ * STEPS,
                            flash_fixed=(2 * L_ - n_online) * STEPS,
                            flash_online=n_online * STEPS)
        else:  # the unfused branch: every attention call the masked online forward
            expected.update(ff=L_ * STEPS, flash_online=2 * L_ * STEPS)
        log(f"  launches in one sample at D={width}, H={H} (dh={dh}): {counts}")
        fails.check(f"dh={dh} serving launch counts", counts == expected,
                    f"expected {expected}")
        pts_p, R_p, _ = serve(plain)
        ts = torch.ones(S, device="cuda")
        with torch.no_grad():
            v_k = dit_forward(params, cfg, x_1, ts, batch, P)
            v_p = dit_forward(params, plain.model, x_1, ts, batch, P)
        fails.compare(f"dh={dh} velocity at t=1 vs plain", v_k, v_p, tol_rel=TOL_VELOCITY)
        fails.compare(f"dh={dh} points vs plain", pts, pts_p, tol_rel=TOL_POINTS)
        err_r = float((R - R_p).abs().max())
        fails.check(f"dh={dh} rotations vs plain", err_r <= TOL_ROTATION_ABS,
                    f"max_abs_err={err_r:.4e} (tol {TOL_ROTATION_ABS})")
        report["launches_wide_heads"][dh] = counts
        state["wide_counts"][dh] = counts


def build_train_params(cfg):
    """fp32 random masters at the main path's width and depth, with the
    same raised gains as ``build_main_params``."""
    from rap_tpu_torch.models.dit import init_dit_params

    params = init_dit_params(0, cfg, device="cuda", masters=True)
    for i, prefix in ONLINE_LAYERS:
        lp = params["layers"][i]
        lp[f"{prefix}_q_gamma"] = lp[f"{prefix}_q_gamma"] * ONLINE_GAIN
        lp[f"{prefix}_k_gamma"] = lp[f"{prefix}_k_gamma"] * ONLINE_GAIN
    return params


def rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm()) / max(float(b.float().norm()), 1e-30)


def train_grads(params, rcfg, batch, seed: int = 7):
    """(loss, {leaf path: gradient}) of training_forward at the draws of a
    generator seeded with ``seed``."""
    from rap_tpu_torch.registration import training_forward
    from rap_tpu_torch.train.optim import tree_paths, tree_replace

    leaves = {k: p.detach().requires_grad_(True) for k, p in tree_paths(params)}
    loss, _ = training_forward(tree_replace(params, leaves), rcfg, batch,
                               torch.Generator(device="cuda").manual_seed(seed))
    g = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, g))


def check_train_gradients(fails, what, params, batch, rcfg):
    """The loss and every gradient leaf through the kernels against the plain
    versions at the same draws: the loss within TOL_TRAIN_SCALAR, each leaf
    within TOL_TRAIN_LEAF, or within twice the plain bf16 path's distance from
    the plain fp32 one, at most TOL_TRAIN_LEAF_CAP. Returns (kernel loss,
    plain loss, plain fp32 gradients)."""
    plain = dataclasses.replace(rcfg, model=dataclasses.replace(rcfg.model, use_kernels=False))
    fp32 = dataclasses.replace(plain, model=dataclasses.replace(
        plain.model, compute_dtype=torch.float32))
    (lk, got), (lp, ref), (_, ref32) = (train_grads(params, c, batch)
                                        for c in (rcfg, plain, fp32))
    fails.check(f"{what} loss vs plain", abs(lk - lp) <= TOL_TRAIN_SCALAR * abs(lp),
                f"kernels {lk:.6f} plain {lp:.6f} (tol {TOL_TRAIN_SCALAR} rel)")
    worst, floored = (-1.0, ""), []
    for k, r in ref.items():
        err, floor = rel_l2(got[k], r), rel_l2(r, ref32[k])
        tol = min(max(TOL_TRAIN_LEAF, 2 * floor), TOL_TRAIN_LEAF_CAP)
        if floor > TOL_TRAIN_LEAF_CAP:
            fails.check(f"{what} gradient {k} bf16 floor", False,
                        f"plain bf16 vs fp32 {floor:.4f} > cap {TOL_TRAIN_LEAF_CAP}")
        if tol > TOL_TRAIN_LEAF:
            floored.append(f"{k} {err:.3f} (floor {floor:.3f})")
        if err / tol > worst[0]:
            worst = (err / tol, f"{k}: {err:.4f} of tol {tol:.4f}")
        if err > tol:
            fails.check(f"{what} gradient {k} vs plain", False, f"rel L2 {err:.4f} > {tol:.4f}")
    log(f"  {len(ref)} {what} gradient leaves vs plain: worst {worst[1]}; {len(floored)} "
        f"held to the bf16 floor: {'; '.join(floored) or 'none'}")
    return lk, lp, ref32


def run_train(report, fails, state):
    from rap_tpu_torch.core.batch import make_regular_synthetic_batch
    from rap_tpu_torch.models.config import DiTConfig
    from rap_tpu_torch.models.dit import attention_bounds
    from rap_tpu_torch.ops import launch_counts, reset_launches
    from rap_tpu_torch.ops.flash_attention import SAFE_BOUND2
    from rap_tpu_torch.registration import RPFConfig
    from rap_tpu_torch.train.optim import Optimizer, OptimizerConfig, tree_paths, tree_replace
    from rap_tpu_torch.train.step import TrainState, make_eval_step, make_train_step

    cfg = DiTConfig(num_layers=LAYERS)  # bf16, kernels on
    rcfg = RPFConfig(model=cfg)
    plain = RPFConfig(model=dataclasses.replace(cfg, use_kernels=False))
    params = build_train_params(cfg)
    n_online = sum(b > SAFE_BOUND2 for pair in attention_bounds(params) for b in pair)
    batch = make_regular_synthetic_batch(
        3, [[N] * P for _ in range(S)], N=N, P=P, S=S, feat_dim=cfg.local_feat_dim,
        device="cuda",
    )
    gen = torch.Generator(device="cuda").manual_seed(5)
    x_1 = torch.randn((S * P, N, 3), generator=gen, device="cuda")
    t_fix = torch.tensor([0.2, 0.45, 0.7, 0.95], device="cuda")  # every t bin

    # 1. loss and gradients at the draws of the step below (generator seed 7):
    #    kernels, plain, plain fp32
    lk, lp, g32 = check_train_gradients(fails, "train", params, batch, rcfg)

    # 2. one step through the kernels and one through the plain versions from
    #    the same parameters and generator state
    opt_cfg = OptimizerConfig()
    step_k, step_p = make_train_step(rcfg, opt_cfg), make_train_step(plain, opt_cfg)
    evaluate = make_eval_step(rcfg)
    loss_before = float(evaluate(params, batch, None, x_1=x_1, t=t_fix)["loss"])
    reset_launches()
    sk, mk = step_k(TrainState.create(params, opt_cfg, seed=7), batch)
    torch.cuda.synchronize()
    counts = launch_counts()
    sp, mp = step_p(TrainState.create(params, opt_cfg, seed=7), batch)
    for name in ("loss", "grad_norm"):
        a, b = float(mk[name]), float(mp[name])
        fails.check(f"step {name} vs plain", abs(a - b) <= TOL_TRAIN_SCALAR * abs(b),
                    f"kernels {a:.6f} plain {b:.6f}")
    # Updated parameters. The update itself, d = new - old, is not fixed at
    # bf16 on every leaf, the plain path's included: Muon's Newton-Schulz
    # (bf16 on the card) lifts the rounding noise of a low-rank gradient to
    # singular values near 1 (the time-MLP and AdaLN matrices see S=4
    # timesteps, so their gradients have rank <= 4), and AdamW's first step
    # is ~ -lr * sign(g), so an element whose gradient is within noise of 0
    # steps either way. What the update does to the loss is fixed: its
    # first-order loss change <g32, d>, g32 the plain fp32 gradient at the
    # same draws, sees only the update's component along the gradient. Each
    # leaf's <g32, d> through the kernels is held within TOL_TRAIN_LEAF of
    # the plain path's, relative: a reversed update flips its sign, a scaled
    # one scales it.
    p0, pk, pp = (dict(tree_paths(x)) for x in (params, sk.params, sp.params))

    def loss_change(p1, k):
        return float((g32[k].double() * (p1[k] - p0[k]).double()).sum())

    worst = (-1.0, "")
    for k in pp:
        dk, dp = loss_change(pk, k), loss_change(pp, k)
        err = abs(dk - dp) / abs(dp) if dp else (0.0 if dk == 0.0 else float("inf"))
        if err > worst[0]:
            worst = (err, f"{k}: {dk:.4e} vs {dp:.4e}")
        if err > TOL_TRAIN_LEAF:
            fails.check(f"updated parameter {k} vs plain", False,
                        f"first-order loss change {dk:.4e} vs {dp:.4e}, rel {err:.4f}")
    log(f"  {len(pp)} updated parameter leaves, first-order loss change <g32, d> vs plain: "
        f"worst {worst[1]}, rel {worst[0]:.2e} (tol {TOL_TRAIN_LEAF})")
    # the raw update, for the record only (not held, as said above): its worst
    # leaf, and how far the plain bf16 update is from the update the same
    # optimizer makes from the plain fp32 gradient
    u32, _ = Optimizer(opt_cfg).update(tree_replace(params, g32),
                                       Optimizer(opt_cfg).init(params), params)
    err_u, k_u = max((rel_l2(pk[k] - p0[k], pp[k] - p0[k]), k) for k in pp)
    log(f"  raw update d, worst leaf {k_u}: kernels vs plain rel L2 {err_u:.3f}; "
        f"plain vs fp32 gradient {rel_l2(pp[k_u] - p0[k_u], u32[k_u]):.3f}")
    expected = dict.fromkeys(counts, 0)
    expected.update({
        "proj": 4 * LAYERS, "out_proj": 4 * LAYERS, "ff": 2 * LAYERS,
        "flash_fixed": 2 * (2 * LAYERS - n_online), "flash_online": 2 * n_online,
        "flash_bwd": 2 * LAYERS, "proj_bwd": 2 * LAYERS, "ff_bwd": LAYERS,
    })
    log(f"  launches in one train step: {counts}")
    fails.check("train launch counts", counts == expected, f"expected {expected}")

    # 3. five more steps through the kernels
    s, losses = sk, [float(mk["loss"])]
    for _ in range(TRAIN_STEPS):
        s, m = step_k(s, batch)
        vals = {k: float(m[k]) for k in ("loss", "grad_norm", "skipped_nonfinite")}
        losses.append(vals["loss"])
        fails.check(f"step {int(s.step)} finite, not skipped",
                    np.isfinite(vals["loss"]) and np.isfinite(vals["grad_norm"])
                    and vals["skipped_nonfinite"] == 0.0, str(vals))
    # 4. the loss at the fixed couple falls
    loss_after = float(evaluate(s.params, batch, None, x_1=x_1, t=t_fix)["loss"])
    fails.check("loss at fixed (t, x_1) falls", loss_after < loss_before,
                f"{loss_before:.6f} -> {loss_after:.6f} over {TRAIN_STEPS + 1} steps")
    log(f"  step losses: {[round(x, 5) for x in losses]}")
    report["train"] = {"loss_kernels": lk, "loss_plain": lp, "launches": counts,
                       "loss_before": loss_before, "loss_after": loss_after,
                       "step_losses": losses, "update_loss_change_rel_worst": worst[0],
                       "update_rel_l2_worst": err_u}
    state.update(train_counts=counts, train_step=step_k, train_state=s, train_batch=batch,
                 train_plain=(step_p, params, opt_cfg))
    run_train_head_widths(report, fails, state, batch)


def train_step_check(fails, what, params, batch, rcfg, expected):
    """One Muon step through the kernels from ``params``: its launch counts
    against ``expected``, finite and not skipped. Returns the counts."""
    from rap_tpu_torch.ops import launch_counts, reset_launches
    from rap_tpu_torch.train.optim import OptimizerConfig
    from rap_tpu_torch.train.step import TrainState, make_train_step

    opt_cfg = OptimizerConfig()
    step = make_train_step(rcfg, opt_cfg)
    reset_launches()
    _, m = step(TrainState.create(params, opt_cfg, seed=7), batch)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = dict.fromkeys(counts, 0)
    want.update(expected)
    log(f"  launches in one {what} step: {counts}")
    fails.check(f"{what} launch counts", counts == want, f"expected {want}")
    vals = {k: float(m[k]) for k in ("loss", "grad_norm", "skipped_nonfinite")}
    fails.check(f"{what} step finite, not skipped", np.isfinite(vals["loss"])
                and np.isfinite(vals["grad_norm"]) and vals["skipped_nonfinite"] == 0.0,
                str(vals))
    return counts


def run_train_head_widths(report, fails, state, batch):
    """Training at other head widths on the dense batch, TRAIN_CHECK_LAYERS
    layers: a D = 512, 16-head model (dh = 32, two heads a GEMM tile in rows
    1, 4 and 9, the attention kernels on heads padded to 64); a D = 768,
    8-head model (dh = 96: the fused branch, the attention forward and
    backward on heads padded to 128, one attention call a forward online);
    a D = 1024, 8-head model (dh = 128: the unfused branch, the masked
    online forward and the attention backward at 128 wide, rows 5 and 10
    at D = 1024). Each: the loss and every gradient leaf through the
    kernels against the plain versions (the rule of
    ``check_train_gradients``), then one Muon step through the kernels with
    its launch counts, finite and not skipped."""
    from rap_tpu_torch.models.config import DiTConfig
    from rap_tpu_torch.models.dit import init_dit_params
    from rap_tpu_torch.registration import RPFConfig

    L_ = TRAIN_CHECK_LAYERS
    cfg = DiTConfig(num_heads=2 * H, num_layers=L_)  # dh = 32
    params = init_dit_params(0, cfg, device="cuda", masters=True)
    rcfg = RPFConfig(model=cfg)
    check_train_gradients(fails, f"dh=32 train ({L_} layers)", params, batch, rcfg)
    counts = {32: train_step_check(
        fails, f"dh=32 train ({L_} layers)", params, batch, rcfg,
        dict(proj=4 * L_, out_proj=4 * L_, ff=2 * L_, flash_fixed=4 * L_, flash_bwd=2 * L_,
             proj_bwd=2 * L_, ff_bwd=L_))}
    for width in (WIDE_D, WIDEST_D):
        dh = width // H
        cfg, params = wide_model(width, L_, masters=True)
        rcfg = RPFConfig(model=cfg)
        what = f"dh={dh} train ({L_} layers)"
        check_train_gradients(fails, what, params, batch, rcfg)
        if dh < 128:  # one online attention a forward (layer 0's global), remat
            expected = dict(proj=4 * L_, out_proj=4 * L_, ff=2 * L_,
                            flash_fixed=2 * (2 * L_ - 1), flash_online=2, flash_bwd=2 * L_,
                            proj_bwd=2 * L_, ff_bwd=L_)
        else:  # the unfused branch: the masked online forward, below the dQ slab
            expected = dict(ff=2 * L_, flash_online=4 * L_, flash_bwd=2 * L_, ff_bwd=L_)
        counts[dh] = train_step_check(fails, what, params, batch, rcfg, expected)
    report["train_head_widths"] = {f"dh{dh}_launches": c for dh, c in counts.items()}
    state["train_wide_counts"] = counts


def run_multiview(report, fails, state):
    from rap_tpu_torch.core.batch import make_regular_synthetic_batch, validate
    from rap_tpu_torch.models.config import MODEL_ZOO
    from rap_tpu_torch.models.dit import init_dit_params
    from rap_tpu_torch.ops import launch_counts, reset_launches
    from rap_tpu_torch.registration import RPFConfig, predict_poses, sample
    from rap_tpu_torch.train.optim import OptimizerConfig
    from rap_tpu_torch.train.step import TrainState, make_eval_step, make_train_step

    cfg = MODEL_ZOO["rap_12"]  # 12 layers, D=512, H=8, bf16, kernels on
    parts = multiview_parts()
    batch = make_regular_synthetic_batch(
        MV_SEED, parts, N=MV_N, P=MV_P, S=MV_S, feat_dim=cfg.local_feat_dim, device="cuda")
    validate(batch)
    n_valid = int(batch.point_mask.sum())
    log(f"  batch {MV_S} x {MV_P} x {MV_N}: parts {parts}, {n_valid} valid points of "
        f"{MV_S * MV_P * MV_N} slots, no_padding={batch.no_padding}")
    fails.check("multiview batch is padded", not batch.no_padding
                and int((~batch.part_valid).sum()) == MV_P * MV_S - sum(MV_PARTS))

    # 1. at 2 layers of the same width: gradients and sampling vs plain
    small = RPFConfig(model=dataclasses.replace(cfg, num_layers=MV_CHECK_LAYERS))
    check_train_gradients(fails, f"multiview ({MV_CHECK_LAYERS} layers)",
                          init_dit_params(0, small.model, device="cuda", masters=True),
                          batch, small)
    serve_params = init_dit_params(0, small.model, device="cuda")
    x_1 = torch.randn((MV_S * MV_P, MV_N, 3),
                      generator=torch.Generator(device="cuda").manual_seed(23), device="cuda")
    outs = []
    for c in (small, dataclasses.replace(small, model=dataclasses.replace(
            small.model, use_kernels=False))):
        c = dataclasses.replace(c, inference_sampling_steps=STEPS, rigidity_forcing=True)
        pts = sample(serve_params, c, batch, x_1=x_1, return_trajectory=False)["points"]
        outs.append((pts,) + tuple(predict_poses(batch, pts)))
    (pts, R, t), (pts_p, R_p, _) = outs
    valid = batch.point_mask[..., None]
    fails.check("multiview sample finite",
                all(bool(torch.isfinite(a).all()) for a in (pts, R, t)))
    fails.compare("multiview points vs plain (valid points)", pts * valid, pts_p * valid,
                  tol_rel=TOL_POINTS)
    err_r = float((R - R_p).abs().max())
    fails.check("multiview rotations vs plain", err_r <= TOL_ROTATION_ABS,
                f"max_abs_err={err_r:.4e} (tol {TOL_ROTATION_ABS})")

    # 1b. the same check with a softcap: the masked forward, masked row 6
    #     (part attention) and rows 7-8 (global attention), softcap variants
    capped = RPFConfig(model=dataclasses.replace(small.model, softcap=MV_SOFTCAP))
    reset_launches()
    check_train_gradients(fails, f"multiview softcap {MV_SOFTCAP:g} ({MV_CHECK_LAYERS} layers)",
                          init_dit_params(0, capped.model, device="cuda", masters=True),
                          batch, capped)
    torch.cuda.synchronize()
    counts = launch_counts()
    Lc = MV_CHECK_LAYERS
    expected = dict.fromkeys(counts, 0)
    expected.update(flash_online_softcap=4 * Lc, ff=2 * Lc, ff_bwd=Lc, flash_bwd_softcap=Lc,
                    flash_bwd_dkv_softcap=Lc, flash_bwd_dq_softcap=Lc)
    log(f"  launches in the {Lc}-layer softcap forward and backward: {counts}")
    fails.check("multiview softcap launch counts", counts == expected, f"expected {expected}")
    state["mv_softcap_counts"] = counts

    # 2. rap_12's depth: the launch counts of one step, five more steps
    rcfg = RPFConfig(model=cfg)
    opt_cfg = OptimizerConfig()
    step = make_train_step(rcfg, opt_cfg)
    evaluate = make_eval_step(rcfg)
    params = init_dit_params(0, cfg, device="cuda", masters=True)
    t_fix = torch.tensor([0.3, 0.8], device="cuda")
    loss_before = float(evaluate(params, batch, None, x_1=x_1, t=t_fix)["loss"])
    s = TrainState.create(params, opt_cfg, seed=29)
    reset_launches()
    s, m = step(s, batch)
    torch.cuda.synchronize()
    counts = launch_counts()
    L = MV_LAYERS
    expected = dict.fromkeys(counts, 0)
    expected.update({"flash_online": 4 * L, "ff": 2 * L, "flash_bwd": L, "ff_bwd": L,
                     "flash_bwd_dkv": L, "flash_bwd_dq": L})
    log(f"  launches in one {L}-layer multiview step: {counts}")
    fails.check("multiview launch counts", counts == expected, f"expected {expected}")
    losses = []
    for _ in range(1 + TRAIN_STEPS):
        vals = {k: float(m[k]) for k in ("loss", "grad_norm", "skipped_nonfinite")}
        losses.append(vals["loss"])
        fails.check(f"multiview step {int(s.step)} finite, not skipped",
                    np.isfinite(vals["loss"]) and np.isfinite(vals["grad_norm"])
                    and vals["skipped_nonfinite"] == 0.0, str(vals))
        if len(losses) <= TRAIN_STEPS:
            s, m = step(s, batch)
    loss_after = float(evaluate(s.params, batch, None, x_1=x_1, t=t_fix)["loss"])
    fails.check("multiview loss at fixed (t, x_1) falls", loss_after < loss_before,
                f"{loss_before:.6f} -> {loss_after:.6f} over {TRAIN_STEPS + 1} steps")
    log(f"  step losses: {[round(x, 5) for x in losses]}")
    report["multiview"] = {"parts": parts, "valid_points": n_valid, "launches": counts,
                           "loss_before": loss_before, "loss_after": loss_after,
                           "step_losses": losses}
    state.update(mv_counts=counts, mv_step=step, mv_state=s, mv_batch=batch)


def write_trainer_data(root: Path, seed: int = TRAINER_SEED) -> Path:
    """The trainer phase's dataset under ``root``: a train split of
    TRAINER_SAMPLES samples, each TRAINER_SCANS scans of one surface scene
    (its own draw), a scan every few metres along the scene, 2500-4096 of the
    points within 7 m of its centre with 1 cm noise, in the scene's frame (the
    registered parts: the loader's training augmentation poses each scan at
    random), with num_points totals; a val split linking the 8 committed
    demo_data/synth scenes."""
    import shutil

    from rap_tpu_torch.utils import ply as plyio

    rng = np.random.default_rng(seed)
    shutil.rmtree(root, ignore_errors=True)
    names, totals = [], []
    lo, hi = MV_PART_POINTS
    for i in range(TRAINER_SAMPLES):
        scene = surface_scene(rng, ground_points=100_000, boxes=6)
        scans = int(rng.integers(TRAINER_SCANS[0], TRAINER_SCANS[1], endpoint=True))
        d = root / f"train_{i:03d}"
        d.mkdir(parents=True)
        total = 0
        for v in range(scans):
            center = np.array([3.0 + v * 24.0 / (scans - 1), 6.0])
            near = scene[np.linalg.norm(scene[:, :2] - center, axis=1) < 7.0]
            m = int(rng.integers(lo, hi, endpoint=True))
            pts = near[rng.choice(len(near), m, replace=False)] + rng.normal(0, 0.01, (m, 3))
            plyio.write_ply(d / f"scan_{v:02d}.ply", pts.astype(np.float32))
            total += m
        names.append(d.name)
        totals.append(total)
    synth = ROOT / SAMPLE_DATA
    val = (synth / "data_split" / "val.txt").read_text().split()
    for name in val:
        (root / name).symlink_to(synth / name, target_is_directory=True)
    (root / "data_split").mkdir()
    (root / "num_points").mkdir()
    (root / "data_split" / "train.txt").write_text("\n".join(names) + "\n")
    (root / "data_split" / "val.txt").write_text("\n".join(val) + "\n")
    (root / "num_points" / "train.txt").write_text("\n".join(map(str, totals)) + "\n")
    shutil.copy(synth / "num_points" / "val.txt", root / "num_points" / "val.txt")
    return root


def trainer_argv(data: Path, ckpt_dir: Path, *extra) -> list[str]:
    """The command line of ``rap_tpu_torch.apps.train`` on TRAINER_CONFIG:
    overrides only."""
    ov = [f"data.datasets=[{{'data_path': '{data}', 'dataset_name': 'scans', 'split': 'train'}},"
          f" {{'data_path': '{data}', 'dataset_name': 'synth', 'split': 'val'}}]",
          f"trainer.max_epochs={TRAINER_EPOCHS}", "trainer.val_every_n_epochs=1",
          "trainer.log_every_n_steps=1", f"trainer.checkpoint_dir={ckpt_dir}", *extra]
    return ["--config", str(ROOT / TRAINER_CONFIG)] + [a for o in ov for a in ("-o", o)]


def trainer_expected(L: int, steps: int) -> tuple[dict, dict]:
    """Launches of one trainer step on a padded 2 x 8 x 4096 batch (the
    masked branch, remat: row 3 at part and global attention twice a layer,
    row 5 twice, the fused backward for part attention and the split one for
    global attention past the dQ slab, row 10) and of one validation pass
    over the dense synth batch (the fused branch at each of ``steps``
    forwards: rows 1 and 4 twice a layer, row 2 or 3 twice, row 5 once)."""
    from rap_tpu_torch.ops import KERNELS

    step = dict.fromkeys(KERNELS, 0)
    step.update(flash_online=4 * L, ff=2 * L, flash_bwd=L, ff_bwd=L, flash_bwd_dkv=L,
                flash_bwd_dq=L)
    val = dict.fromkeys(KERNELS, 0)
    val.update(proj=2 * L * steps, out_proj=2 * L * steps, ff=L * steps)
    return step, val


def run_trainer(report, fails, state):
    """rap_tpu_torch.apps.train.main on the card: run 1 (TRAINER_EPOCHS
    epochs, validation and checkpoints each epoch), run 2 (resume from
    ``last`` for one more epoch), then the options (pose loss, FF dropout)
    against the plain versions; times and launches per step and per
    validation pass."""
    import shutil

    from rap_tpu_torch.apps import train as app
    from rap_tpu_torch.config import load_config
    from rap_tpu_torch.core.batch import make_regular_synthetic_batch
    from rap_tpu_torch.models.dit import init_dit_params
    from rap_tpu_torch.ops import launch_counts, reset_launches
    from rap_tpu_torch.registration import RPFConfig
    from rap_tpu_torch.train.checkpoint import load_metadata, train_state_tensors
    from rap_tpu_torch.train.optim import OptimizerConfig
    from rap_tpu_torch.train.step import TrainState, make_train_step

    build = ROOT / "rap_tpu_torch" / "build"
    t0 = time.perf_counter()
    data = write_trainer_data(build / "trainer_data")
    ckdir = build / "trainer_run"
    shutil.rmtree(ckdir, ignore_errors=True)
    log(f"  dataset written in {time.perf_counter() - t0:.2f} s: {TRAINER_SAMPLES} train "
        f"samples, 8 val scenes, under {data.relative_to(ROOT)}")
    cfg = load_config(ROOT / TRAINER_CONFIG)
    L, vsteps = cfg.model.num_layers, cfg.pipeline.inference_sampling_steps
    want_step, want_val = trainer_expected(L, vsteps)

    # run 1
    log(f"  -- apps.train.main, {TRAINER_EPOCHS} epochs")
    rec = {}
    reset_launches()
    s1 = app.main(trainer_argv(data, ckdir), record=rec)
    torch.cuda.synchronize()
    counts = launch_counts()
    n1 = len(rec["step_ms"])
    fails.check("trainer run 1: every step finite, none skipped",
                n1 > 0 and all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
                               and m["skipped_nonfinite"] == 0.0 for m in rec["metrics"]),
                f"{n1} steps, losses {[round(m['loss'], 5) for m in rec['metrics']]}")
    fails.check("trainer run 1: the state counted every step", int(s1.step) == n1)
    bad = [c for c in rec["step_launches"] if c != want_step]
    fails.check("trainer step launch counts", not bad, f"expected {want_step}, got {bad[:1]}")
    for c in rec["val_launches"]:
        attn = c["flash_fixed"] + c["flash_online"]
        fails.check("trainer validation launch counts",
                    {k: v for k, v in c.items() if k not in ("flash_fixed", "flash_online")}
                    == {k: v for k, v in want_val.items()
                        if k not in ("flash_fixed", "flash_online")}
                    and attn == 2 * L * vsteps, f"{c}")
    run_kernels = {k for k, v in counts.items() if v}
    fails.check("trainer run 1 launched each kernel of its path",
                run_kernels >= {k for k, v in want_step.items() if v} | {"proj", "out_proj"},
                f"{counts}")
    rows = [json.loads(x) for x in (ckdir / "metrics.jsonl").read_text().splitlines()]
    fails.check("trainer: metrics.jsonl has train/ and val/ rows",
                sum("train/loss" in r for r in rows) == n1
                and sum(any(k.startswith("val/") for k in r) for r in rows) == TRAINER_EPOCHS,
                f"{len(rows)} rows")
    fails.check("trainer: the wandb mirror is off by default, wandb never imported (it "
                "reaches the network)", "wandb" not in sys.modules)
    fails.check("trainer: config.json, code_snapshot.zip, best/, last/",
                all((ckdir / f).exists() for f in ("config.json", "code_snapshot.zip",
                                                   "best", "last")))
    saved = train_state_tensors(s1)
    best1 = load_metadata(ckdir / "best")
    best_mtime = (ckdir / "best" / "train_state.pt").stat().st_mtime_ns

    # run 2: the resume
    log("  -- apps.train.main, resumed from last/ for one more epoch")
    rec2 = {}
    s2 = app.main(trainer_argv(data, ckdir, f"checkpoint={ckdir / 'last'}",
                               f"trainer.max_epochs={TRAINER_EPOCHS + 1}"), record=rec2)
    restored = rec2["restored"]
    diff = [k for k in saved if not torch.equal(saved[k], restored[k])]
    fails.check("trainer resume: the restored state equals the saved one bit for bit",
                set(saved) == set(restored) and not diff,
                f"{len(saved)} tensors (params, optimizer state, step, generator); differ: "
                f"{diff[:4]}")
    n2 = len(rec2["step_ms"])
    fails.check("trainer resume: starts at epoch 2, the step count carries on",
                rec2["epochs"] == [TRAINER_EPOCHS] and int(s2.step) == n1 + n2
                and rec2["best_monitor_start"] == best1["monitor"],
                f"epochs {rec2['epochs']}, step {int(s2.step)} = {n1} + {n2}")
    mon2 = rec2["val_results"][0]["overall"]["object_chamfer"]
    best2 = load_metadata(ckdir / "best")
    if mon2 < best1["monitor"]:
        ok = best2 == {"epoch": TRAINER_EPOCHS + 1, "monitor": mon2}
    else:
        ok = best2 == best1 and (ckdir / "best" / "train_state.pt").stat().st_mtime_ns == best_mtime
    fails.check("trainer resume: best/ rewritten only on a better monitor", ok,
                f"monitor {best1['monitor']:.6f} -> {mon2:.6f}; best {best2}")
    fails.check("trainer run 2: every step finite, none skipped",
                all(np.isfinite(m["loss"]) and m["skipped_nonfinite"] == 0.0
                    for m in rec2["metrics"]))

    # run 3: the options, 2 layers at full width, kernels vs plain, on the
    # multiview phase's batch: on the trainer's scans the qk gains' bf16
    # floor is 0.09-0.18 with the options off or on (scripts/option_floors.py),
    # past TOL_TRAIN_LEAF_CAP, so the rule could not see a fault there
    batch = rec["last_batch"]
    mv_batch = make_regular_synthetic_batch(MV_SEED, multiview_parts(), N=MV_N, P=MV_P,
                                            S=MV_S, device="cuda")
    small = dataclasses.replace(cfg.model, num_layers=TRAINER_OPTION_LAYERS,
                                dropout_rate=TRAINER_DROPOUT)
    rcfg = RPFConfig(model=small, pose_loss_weight=TRAINER_POSE_WEIGHT)
    params = init_dit_params(0, small, device="cuda", masters=True)
    reset_launches()
    check_train_gradients(fails, f"trainer options ({TRAINER_OPTION_LAYERS} layers, pose loss "
                          f"{TRAINER_POSE_WEIGHT:g}, dropout {TRAINER_DROPOUT:g}, the multiview "
                          "batch)", params, mv_batch, rcfg)
    torch.cuda.synchronize()
    opt_counts = launch_counts()
    fails.check("trainer options: rows 5 and 10 not launched with dropout on",
                opt_counts["ff"] == opt_counts["ff_bwd"] == 0 and opt_counts["flash_online"] > 0,
                f"{opt_counts}")
    deg = make_regular_synthetic_batch(TRAINER_SEED, [[4096, 2, 3000, 2500], [1, 4096, 3500]],
                                       N=4096, P=4, S=2, device="cuda")
    step = make_train_step(rcfg, OptimizerConfig())
    reset_launches()
    _, m = step(TrainState.create(params, OptimizerConfig(), seed=3), deg)
    vals = {k: float(v) for k, v in m.items()}
    fails.check("trainer options: pose loss finite with 1- and 2-point parts",
                all(np.isfinite(vals[k]) for k in ("loss", "pose_loss", "grad_norm"))
                and vals["skipped_nonfinite"] == 0.0,
                f"loss {vals['loss']:.6f} pose_loss {vals['pose_loss']:.6f} "
                f"grad_norm {vals['grad_norm']:.6f}")
    syncs = trainer_pose_syncs(rcfg, params, batch)
    fails.check("trainer options: the pose loss adds no host sync to a training forward and "
                "backward", syncs["pose"] == syncs["plain"], f"{syncs}")

    # times: the options' step beside the plain step at rap_12, from run 2's
    # state on run 1's last batch, and one profiled step
    option_ms = {}
    dropped = dataclasses.replace(cfg.model, dropout_rate=TRAINER_DROPOUT)
    for label, c in (("no options", cfg.pipeline),
                     ("pose loss", dataclasses.replace(cfg.pipeline,
                                                       pose_loss_weight=TRAINER_POSE_WEIGHT)),
                     ("dropout", dataclasses.replace(cfg.pipeline, model=dropped)),
                     ("pose loss + dropout", dataclasses.replace(
                         cfg.pipeline, pose_loss_weight=TRAINER_POSE_WEIGHT, model=dropped))):
        st = make_train_step(c, cfg.optimizer)
        s_ = TrainState(s2.step, s2.params, s2.opt_state, torch.Generator(device="cuda")
                        .manual_seed(9))
        times = []
        for i in range(4):
            t0 = time.perf_counter()
            s_, m_ = st(s_, batch)
            float(m_["loss"])
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
        option_ms[label] = times
    step_full = make_train_step(cfg.pipeline, cfg.optimizer)
    prof = device_profile("one trainer step (rap_12, 2 x 8 x 4096, Muon, remat)",
                          lambda: float(step_full(TrainState(s2.step, s2.params, s2.opt_state,
                                                             torch.Generator(device="cuda")
                                                             .manual_seed(9)), batch)[1]["loss"]))
    step_ms = rec["step_ms"][1:] + rec2["step_ms"]
    load_ms = rec["load_ms"] + rec2["load_ms"]
    valid = int(batch.point_mask.sum())
    med = float(np.median(step_ms))
    saves = rec["saves"] + rec2["saves"]
    log(f"  trainer step (rap_12, batches of {batch.S} x {batch.G // batch.S} x {batch.N} "
        f"slots, Muon, remat): median {med:.2f} ms over "
        f"{len(step_ms)} (first {rec['step_ms'][0]:.2f}; all "
        f"{', '.join(f'{x:.2f}' for x in step_ms)}) -> {valid / med * 1e3:.1f} valid points/s "
        f"(last batch); device {prof['device_ms']:.2f} ms of a {prof['wall_ms']:.2f} ms "
        f"profiled step")
    log(f"  loader wait per step: median {float(np.median(load_ms)):.2f} ms (all "
        f"{', '.join(f'{x:.2f}' for x in load_ms)})")
    log(f"  validation ({vsteps} steps, {L} layers, the 8 synth pairs): "
        f"{', '.join(f'{x:.2f}' for x in rec['val_ms'] + rec2['val_ms'])} ms per pass; "
        f"object_chamfer {[round(r['overall']['object_chamfer'], 5) for r in rec['val_results'] + rec2['val_results']]}")
    log("  checkpoints: " + "; ".join(f"{x['name']} (epoch {x['epoch']}) {x['ms']:.2f} ms, "
                                       f"{x['bytes']} bytes" for x in saves)
        + f"; restore {rec2['restore_ms']:.2f} ms")
    log(f"  launches per trainer step: {rec['step_launches'][0]}")
    log(f"  launches per validation pass: {rec['val_launches'][0]}")
    log("  options step (rap_12, same batch): "
        + "; ".join(f"{k} {float(np.median(v)):.2f} ms ({', '.join(f'{x:.2f}' for x in v)})"
                    for k, v in option_ms.items())
        + f"; host syncs in a pose-loss step {syncs['pose']} (without {syncs['plain']})")
    report["trainer"] = {
        "steps": [n1, n2], "step_ms": step_ms, "first_step_ms": rec["step_ms"][0],
        "step_ms_median": med, "valid_points": valid, "valid_points_per_s": valid / med * 1e3,
        "load_ms": load_ms, "val_ms": rec["val_ms"] + rec2["val_ms"],
        "val_object_chamfer": [r["overall"]["object_chamfer"]
                               for r in rec["val_results"] + rec2["val_results"]],
        "saves": saves, "restore_ms": rec2["restore_ms"],
        "step_launches": rec["step_launches"][0], "val_launches": rec["val_launches"][0],
        "losses": [m["loss"] for m in rec["metrics"] + rec2["metrics"]],
        "option_step_ms": option_ms, "option_launches": opt_counts, "pose_syncs": syncs,
        "profile": {k: v for k, v in prof.items() if k != "kernels"}}
    state["trainer_counts"] = rec["step_launches"][0]
    state["trainer_val_counts"] = rec["val_launches"][0]


def trainer_pose_syncs(rcfg, params, batch) -> dict:
    """Host syncs CUDA's sync debug mode reports in one training forward and
    backward with and without the pose loss."""
    import warnings

    from rap_tpu_torch.registration import training_forward
    from rap_tpu_torch.train.optim import tree_paths, tree_replace

    out = {}
    for label, c in (("pose", rcfg), ("plain", dataclasses.replace(rcfg, pose_loss_weight=0.0))):
        leaves = {k: p.detach().requires_grad_(True) for k, p in tree_paths(params)}
        gen = torch.Generator(device="cuda").manual_seed(3)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                loss, _ = training_forward(tree_replace(params, leaves), c, batch, gen)
                torch.autograd.grad(loss, list(leaves.values()))
            finally:
                torch.cuda.set_sync_debug_mode("default")
        # the mode's own one-time warning ("a prototype feature ... does not
        # yet detect all synchronizing operations") is not a sync
        out[label] = sum("synchroniz" in str(w.message).lower()
                         and "prototype" not in str(w.message) for w in caught)
    return out


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
    train_counts = state.get("train_counts", {})
    rows = []

    mv_counts = state.get("mv_counts", {})
    pruned_counts = state.get("pruned_counts", {})
    demo_counts = state.get("demo_counts", {})

    def row(name, source, replaces, fn_k, fn_p, fn_lib, flops, nbytes, shape, reps=10,
            lib_ms=None, launches=None, err_key=None, mufu=0.0, **extra):
        ms = cuda_time_ms(fn_k, reps)
        plain_ms = cuda_time_ms(fn_p, 3)
        if fn_lib is not None:
            lib_ms = cuda_time_ms(fn_lib, reps)
        b_ms, b_by = bound(flops, nbytes, mufu)
        if mufu:  # one exp2 per logit (and a tanh under softcap)
            extra = {"mufu_ops": mufu, "ops_limiter": ops_limiter(flops, mufu), **extra}
        # launches: on the serving path for the forward kernels, on the train
        # step for the backward ones, unless given (train_launches and
        # multiview_launches: every kernel's on those steps)
        if launches is None:
            launches = (train_counts if name.endswith("_bwd") else counts).get(name, 0)
        r = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "launches": launches, "train_launches": train_counts.get(name, 0),
             "multiview_launches": mv_counts.get(name, 0),
             "pruned_launches": pruned_counts.get(name, 0),
             "trainer_step_launches": state.get("trainer_counts", {}).get(name, 0),
             "trainer_val_launches": state.get("trainer_val_counts", {}).get(name, 0),
             "demo_launches_per_generation": {k: c.get(name, 0) for k, c in demo_counts.items()},
             "max_abs_err": state["max_abs_err"][err_key or name],
             "ms": ms, "plain_ms": plain_ms,
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms, "shape": shape,
             **extra}
        log(f"  {name} [{shape}]: {ms:.4f} ms (plain {plain_ms:.4f}, library "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f}'}, bound {b_ms:.4f} by {b_by})"
            + "".join(f", {k} {v}" for k, v in extra.items()))
        return r

    mm_proj, mm_out, mm_proj_bwd = proj_matmuls(inp["x"], inp["w_qkv"], inp["w_out"])
    for is_global in (False, True):
        tag = "global" if is_global else "part"
        args = (inp["x"], inp["ada"], inp["w_qkv"], gq_eff, gk_eff, P, is_global)
        r = row("proj", "rap_tpu_torch/csrc/proj.cu", "rap_tpu/ops/fused_proj.py:46",
                lambda: fp.proj_kernel(*args), lambda: fp.proj_plain(*args), None,
                2 * T * D * 3 * D,
                T * D * 2 + G * 2 * D * 4 + D * 3 * D * 2 + 2 * D * 4
                + 2 * T * D * 2 + T * H * (DH + 1) * 2,
                f"{tag}: x ({G},{N},{D}) bf16", matmul_ms=cuda_time_ms(mm_proj, 10))
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
                 lambda: fa.flash_fixed_plain(qh, kh, vah, b2), sdpa, flops, nbytes, shape,
                 mufu=BH * Tn * Tn)
        ro = row("flash_online", "rap_tpu_torch/csrc/attention.cu",
                 "rap_tpu/ops/pallas_attention.py:91",
                 lambda: fa.flash_online_kernel(qh, kh, vah),
                 lambda: fa.flash_online_plain(qh, kh, vah), sdpa, flops, nbytes, shape,
                 mufu=BH * Tn * Tn)
        if tag == "global":
            rows += [rf, ro]

    # rows 2 and 3 at head width 96 (their 128-wide instantiation): the
    # global shape of the main phase's D = 768, H = 8 model; the bound
    # counts the products at d = 96
    wide_counts = state.get("wide_counts", {}).get(WIDE_D // H, {})
    for d, (qh, kh, vah, b2) in state.get("wide", {}).items():
        BH, Tn, _ = qh.shape
        v = vah[..., :d].contiguous()
        sdpa = lambda qh=qh, kh=kh, v=v: F.scaled_dot_product_attention(  # noqa: E731
            qh[None], kh[None], v[None], scale=float(np.log(2.0)))
        shape = f"BH={BH}, T={Tn}, d={d} bf16 (padded to 128)"
        serving = d == WIDE_D // H  # the main phase's D = 768 check runs this width
        common = dict(launches=None, err_key=None, mufu=BH * Tn * Tn, head_width=d,
                      path=f"serving at D={WIDE_D}, H={H}, {WIDE_LAYERS} layers" if serving
                      else "kernels phase check")
        for name, fn_k, fn_p in (
                ("flash_fixed", lambda: fa.flash_fixed_kernel(qh, kh, vah, b2),
                 lambda: fa.flash_fixed_plain(qh, kh, vah, b2)),
                ("flash_online", lambda: fa.flash_online_kernel(qh, kh, vah),
                 lambda: fa.flash_online_plain(qh, kh, vah))):
            common.update(launches=wide_counts.get(name, 0) if serving else 0,
                          err_key=f"{name}/wide")
            rows.append(row(name, "rap_tpu_torch/csrc/attention.cu",
                            "rap_tpu/ops/pallas_attention.py:" + ("188" if name == "flash_fixed"
                                                                  else "91"),
                            fn_k, fn_p, sdpa, 4 * BH * Tn * Tn * d,
                            4 * BH * Tn * d * 2 + BH * Tn * 4, shape, **common))

    for is_global in (False, True):
        tag = "global" if is_global else "part"
        a5 = state["attn"][tag][3][0]
        out_args = (a5, inp["x"], inp["w_out"], inp["b_out"], P, is_global)
        r = row("out_proj", "rap_tpu_torch/csrc/out_proj.cu", "rap_tpu/ops/fused_proj.py:458",
                lambda: fp.out_kernel(*out_args), lambda: fp.out_plain(*out_args), None,
                2 * T * D * D, 3 * T * D * 2 + D * D * 2 + D * 2,
                f"{tag}: tokens {T}, D={D} bf16", matmul_ms=cuda_time_ms(mm_out, 10))
        if is_global:
            rows.append(r)

    ff_args = (inp["x"].reshape(-1, D), inp["ln_s"], inp["ln_b"], inp["wi"],
               inp["bi"], inp["wo"], inp["bo"])
    ff_rows = [("dense", ff_args, state["ff_bwd_args"], counts, train_counts)]
    if "ff_mv" in state:
        ff_rows.append(("multiview", *state["ff_mv"], mv_counts, mv_counts))
    for tag, fwd, _, launched, _ in ff_rows:
        Tn = fwd[0].shape[0]
        rows.append(row("ff", "rap_tpu_torch/csrc/ff.cu", "rap_tpu/ops/fused_ff.py:55",
                        lambda fwd=fwd: ff.ff_kernel(*fwd), lambda fwd=fwd: ff.ff_plain(*fwd),
                        None, *ff_work(Tn), f"{tag}: tokens {Tn}, D={D}, hidden {FH} bf16",
                        launches=launched.get("ff", 0),
                        matmul_ms=cuda_time_ms(ff_matmuls(fwd)[0], 10)))

    # ---- backward kernels, at the training shapes --------------------------
    for tag in ("part", "global"):
        qh, kh, vah, _, _ = state["attn"][tag]
        out, lse, dout = state["attn_bwd"][tag, "fixed"]
        BH, Tn, _ = qh.shape
        q_, k_, v_ = (a[None].detach().clone().requires_grad_(True)
                      for a in (qh, kh, vah[..., :DH].contiguous()))

        def sdpa_fwd(q_=q_, k_=k_, v_=v_):
            with torch.no_grad():
                F.scaled_dot_product_attention(q_, k_, v_, scale=float(np.log(2.0)))

        def sdpa_fwd_bwd(q_=q_, k_=k_, v_=v_, dout=dout):
            o = F.scaled_dot_product_attention(q_, k_, v_, scale=float(np.log(2.0)))
            torch.autograd.grad(o, (q_, k_, v_), dout[None])

        lib = cuda_time_ms(sdpa_fwd_bwd, 10) - cuda_time_ms(sdpa_fwd, 10)
        r = row("flash_bwd", "rap_tpu_torch/csrc/attention_bwd_dkv.cuh",
                "rap_tpu/ops/pallas_attention.py:506",
                lambda: fa.flash_bwd_kernel(qh, kh, vah, out, lse, dout),
                lambda: fa.flash_bwd_plain(qh, kh, vah, out, lse, dout), None,
                10 * BH * Tn * Tn * DH,
                BH * Tn * (4 * DH * 2 + (DH + 1) * 2 + 4) + 3 * BH * Tn * DH * 2,
                f"{tag}: BH={BH}, T={Tn}, d={DH} bf16", lib_ms=lib, mufu=BH * Tn * Tn)
        if tag == "global":
            rows.append(r)

    for tag in ("part", "global"):
        args = state["proj_bwd_args"][tag]
        r = row("proj_bwd", "rap_tpu_torch/csrc/proj_bwd.cu", "rap_tpu/ops/fused_proj.py:184",
                lambda: fp.proj_bwd_kernel(*args), lambda: fp.proj_bwd_plain(*args), None,
                # q and k recomputed (v's cotangent is given), dW, dh
                16 * T * D * D,
                T * D * 2 + G * 2 * D * 4 + D * 3 * D * 2 + 2 * D * 4 + 2 * T * D * 2
                + T * H * (DH + 1) * 2 + T * D * 2 + G * 2 * D * 4 + D * 3 * D * 4
                + 2 * D * 4,
                f"{tag}: x ({G},{N},{D}) bf16", matmul_ms=cuda_time_ms(mm_proj_bwd, 10))
        if tag == "global":
            rows.append(r)

    for tag, fwd, bwd, _, launched in ff_rows:
        Tn = bwd[0].shape[0]
        rows.append(row("ff_bwd", "rap_tpu_torch/csrc/ff_bwd.cu", "rap_tpu/ops/fused_ff.py:121",
                        lambda bwd=bwd: ff.ff_bwd_kernel(*bwd),
                        lambda bwd=bwd: ff.ff_bwd_plain(*bwd), None, *ff_bwd_work(Tn),
                        f"{tag}: tokens {Tn}, D={D}, hidden {FH} bf16",
                        launches=launched.get("ff_bwd", 0),
                        matmul_ms=cuda_time_ms(ff_matmuls(fwd, bwd)[1], 10)))
    if "mv_attn" in state:
        rows += multiview_kernel_rows(state, row)
    if "demo_attn" in state:
        rows += demo_kernel_rows(state, row)
    if "wide_bwd" in state:
        rows += wide_backward_kernel_rows(state, row)
    if "softcap" in state:
        rows += softcap_kernel_rows(state, row)
    return rows


def ff_work(T: int) -> tuple[float, float]:
    """Row 5's bf16 operations and the bytes it must move at T tokens (D,
    FH): the two products; x, the LN and bias vectors, wi, wo in, out."""
    return (2 * T * D * 2 * FH + 2 * T * FH * D,
            2 * T * D * 2 + D * 2 * FH * 2 + 2 * FH * 2 + FH * D * 2 + D * 2 + 2 * D * 4)


def ff_bwd_work(T: int) -> tuple[float, float]:
    """Row 10's: recompute 4 + dact 2 + dwo 2 + dwi 4 + dyln 4 (x T D FH);
    x, g, the weights in, dx and every gradient out."""
    return (16 * T * D * FH,
            2 * T * D * 2 + 2 * D * 4 + D * 2 * FH * 2 + 2 * FH * 4 + FH * D * 2
            + T * D * 2 + 3 * D * 4 + D * 2 * FH * 4 + 2 * FH * 4 + FH * D * 4)


def proj_matmuls(x, w_qkv, w_out):
    """The yardstick of rows 1, 4 and 9: torch.matmul over the same products,
    bf16 in and out, without their LN passes, epilogues and relayouts (dy
    stands in as a tensor of its shape): (row 1's (T x D)(D x 3D), row 4's
    (T x D)(D x D), row 9's three: the q, k recompute (T x D)(D x 2D), dW
    (D x T)(T x 3D), dh (T x 3D)(3D x D)). Timed beside the kernels, used
    nowhere in the port."""
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    dy = torch.ones((x2.shape[0], 3 * d), dtype=torch.bfloat16, device=x.device)

    def row9():
        torch.matmul(x2, w_qkv[:, :2 * d])
        torch.matmul(x2.t(), dy)
        torch.matmul(dy, w_qkv.t())

    return (lambda: torch.matmul(x2, w_qkv)), (lambda: torch.matmul(x2, w_out)), row9


def ff_matmuls(fwd, bwd=None):
    """The yardstick of rows 5 and 10: torch.matmul over the same products,
    bf16 in and out, without their epilogues (act and dproj stand in as
    tensors of their shapes): (row 5's two, row 10's five). Timed beside the
    kernels, used nowhere in the port."""
    x, _, _, wi, _, wo, _ = fwd
    T, fh = x.shape[0], wo.shape[0]
    act = torch.ones((T, fh), dtype=torch.bfloat16, device=x.device)
    dproj = torch.ones((T, 2 * fh), dtype=torch.bfloat16, device=x.device)
    g = x if bwd is None else bwd[1]

    def row5():
        torch.matmul(x, wi)
        torch.matmul(act, wo)

    def row10():
        torch.matmul(x, wi)            # proj
        torch.matmul(g, wo.t())        # dact
        torch.matmul(dproj, wi.t())    # dyln
        torch.matmul(act.t(), g)       # dwo
        torch.matmul(x.t(), dproj)     # dwi

    return row5, row10


def flex_softcap_ms(qh, kh, vah, c: float, mask=None, heads: int = 1, dout=None, out=None,
                    d: int = DH):
    """torch.compile(flex_attention) on the same head-major q, k, v (and dO):
    the logit c·tanh(q·k) (q is pre-scaled, so scale 1) as its score_mod,
    the key mask as a block mask (built once, outside the timing), at head
    width ``d`` (the unpadded columns of q, k and va). Returns
    (forward ms, backward ms as forward+backward minus forward or None
    without ``dout``, max |flex out - out| over the rows with a valid key);
    (None, None, None) if the library refuses the call. Timed here only: the
    port never calls it."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    # every shape and score_mod is a graph of its own: room for them all, so
    # none falls back to the eager version (which holds every score)
    dyn = torch._dynamo.config
    limit = "recompile_limit" if hasattr(dyn, "recompile_limit") else "cache_size_limit"
    setattr(dyn, limit, max(getattr(dyn, limit), 64))
    flex = torch.compile(flex_attention, fullgraph=True, dynamic=False)
    BH, T, _ = qh.shape
    B = BH // heads
    q_, k_, v_ = (a[..., :d].reshape(B, heads, T, d).detach().clone()
                  .requires_grad_(dout is not None) for a in (qh, kh, vah))

    def score_mod(score, b, h, q_idx, kv_idx):
        return c * torch.tanh(score)

    block_mask, rows_ok = None, None
    if mask is not None:
        keys = mask.bool()
        rows_ok = keys.any(1)

        def key_mask(b, h, q_idx, kv_idx):
            return keys[b, kv_idx]

        block_mask = create_block_mask(key_mask, B, None, T, T, device=qh.device)

    def fwd():
        with torch.no_grad():
            return flex(q_, k_, v_, score_mod=score_mod, block_mask=block_mask, scale=1.0)

    try:
        got = fwd().reshape(BH, T, d)
        err = None
        if out is not None:
            diff = (got.float() - out.float()).abs().reshape(B, heads, T, d)
            err = float((diff if rows_ok is None else diff[rows_ok]).max())
        f_ms = cuda_time_ms(fwd, 5)
        if dout is None:
            return f_ms, None, err
        do = dout.reshape(B, heads, T, d)

        def fwd_bwd():
            o = flex(q_, k_, v_, score_mod=score_mod, block_mask=block_mask, scale=1.0)
            torch.autograd.grad(o, (q_, k_, v_), do)

        return f_ms, cuda_time_ms(fwd_bwd, 5) - f_ms, err
    except Exception as e:  # the library's refusal, recorded as "none"
        log(f"  flex_attention (softcap {c:g}, BH={BH}, T={T}) refused: "
            f"{type(e).__name__}: {str(e)[:300]}")
        return None, None, None


def softcap_kernel_rows(state, row):
    """The softcap variants: forward at the sample path's shapes (c = 5 fixed,
    c = 50 online), masked forward and backward at the multi-view shapes
    (c = 5); launches from the sample runs and the multi-view softcap check.
    The bound counts the products as without softcap and two
    special-function ops per logit this run's keys need (exp2 and tanh;
    ``tanh_ops`` is the tanh part): that tips the forward and the dQ pass to
    the special-function unit. The library call is flex_attention with the
    same cap (``flex_softcap_ms``)."""
    from rap_tpu_torch.ops import flash_attention as fa

    runs = state.get("sample_runs", {})
    mv = state.get("mv_softcap_counts", {})
    rows = []
    for tag in ("part", "global"):
        for c, name in ((5.0, "flash_fixed_softcap"), (50.0, "flash_online_softcap")):
            qh, kh, vah = state["softcap"]["sample", tag, c]
            BH, Tn, _ = qh.shape
            b2 = fa._cap2(c)
            if name == "flash_fixed_softcap":
                fn_k = lambda: fa.flash_fixed_kernel(qh, kh, vah, b2, c)  # noqa: E731
                fn_p = lambda: fa.flash_fixed_plain(qh, kh, vah, b2, c)  # noqa: E731
            else:
                fn_k = lambda: fa.flash_online_kernel(qh, kh, vah, None, 1, c)  # noqa: E731
                fn_p = lambda: fa.flash_online_plain(qh, kh, vah, None, 1, c)  # noqa: E731
            lib_ms, _, lib_err = flex_softcap_ms(qh, kh, vah, c, out=fn_k()[0])
            rows.append(row(name, "rap_tpu_torch/csrc/attention.cu",
                            "rap_tpu/ops/pallas_attention.py:" + ("188" if c == 5.0 else "91"),
                            fn_k, fn_p, None, 4 * BH * Tn * Tn * DH,
                            4 * BH * Tn * DH * 2 + BH * Tn * 4,
                            f"sample {tag}: BH={BH}, T={Tn}, d={DH} bf16, softcap {c:g}",
                            lib_ms=lib_ms, mufu=2 * BH * Tn * Tn,
                            launches=runs.get(c, {}).get("launches", {}).get(name, 0),
                            err_key=f"{name}@{c:g}", softcap=c, tanh_ops=BH * Tn * Tn,
                            library="flex_attention", library_max_abs_err=lib_err,
                            path=f"sample, softcap {c:g}"))

    c = MV_SOFTCAP
    for tag in ("part", "global"):
        qh, kh, vah, mask, out, lse, dout, doa = state["softcap"]["mv", tag, c]
        BH, T, _ = qh.shape
        valid = float(mask.sum()) * H
        lib_f, lib_b, lib_err = flex_softcap_ms(qh, kh, vah, c, mask, H, dout, out)
        rows.append(row(
            "flash_online_softcap", "rap_tpu_torch/csrc/attention.cu",
            "rap_tpu/ops/pallas_attention.py:91",
            lambda: fa.flash_online_kernel(qh, kh, vah, mask, H, c),
            lambda: fa.flash_online_plain(qh, kh, vah, mask, H, c), None,
            4 * T * DH * valid,
            BH * T * (DH * 2 + (DH + 1) * 2 + DH * 2 + DH * 2 + 4) + mask.numel() * 4,
            f"multiview {tag}: BH={BH}, T={T}, d={DH} bf16, key mask, softcap {c:g}",
            reps=5, launches=mv.get("flash_online_softcap", 0), lib_ms=lib_f,
            mufu=2 * T * valid, err_key=f"flash_online_softcap@{c:g}/mv", softcap=c,
            tanh_ops=T * valid, library="flex_attention", library_max_abs_err=lib_err,
            path=f"multiview {MV_CHECK_LAYERS}-layer check, softcap {c:g}",
            bound_all_tiles_ms=bound(4 * T * T * DH * BH, 0, 2 * T * T * BH)[0]))
        reads = BH * T * (2 * DH * 2 + 2 * (DH + 1) * 2 + 4) + mask.numel() * 4
        shape = f"multiview {tag}: BH={BH}, T={T}, d={DH} bf16, key mask, softcap {c:g}"
        common = dict(softcap=c, path=f"multiview {MV_CHECK_LAYERS}-layer check, softcap {c:g}",
                      mufu=2 * T * valid, tanh_ops=T * valid, library="flex_attention")
        if tag == "part":
            rows.append(row(
                "flash_bwd_softcap", "rap_tpu_torch/csrc/attention_bwd_dkv.cuh",
                "rap_tpu/ops/pallas_attention.py:506",
                lambda: fa.flash_bwd_kernel(qh, kh, vah, out, lse, dout, mask, H, c),
                lambda: fa.flash_bwd_plain(qh, kh, vah, out, lse, dout, mask, H, c), None,
                10 * T * DH * valid, reads + 3 * BH * T * DH * 2, shape,
                launches=mv.get("flash_bwd_softcap", 0), lib_ms=lib_b,
                err_key=f"flash_bwd_softcap@{c:g}",
                bound_all_tiles_ms=bound(10 * T * T * DH * BH, 0, 2 * T * T * BH)[0],
                **common))
        else:
            # the two passes together are one backward: the library's
            # backward stands beside each (library_backward_ms); they read
            # the pieces of va and [dO | -delta] (backward_operands)
            reads = BH * T * (4 * DH * 2 + 3 * 4) + mask.numel() * 4
            args = (qh, kh, vah, doa, lse, mask, H)
            rows.append(row(
                "flash_bwd_dkv_softcap", "rap_tpu_torch/csrc/attention_bwd_dkv.cuh",
                "rap_tpu/ops/pallas_attention.py:426",
                lambda: fa.flash_bwd_dkv_kernel(*args, c),
                lambda: fa.flash_bwd_dkv_plain(*args, c), None,
                8 * T * DH * valid, reads + 2 * BH * T * DH * 2, shape, reps=5,
                launches=mv.get("flash_bwd_dkv_softcap", 0),
                err_key=f"flash_bwd_dkv_softcap@{c:g}", library_backward_ms=lib_b,
                bound_all_tiles_ms=bound(8 * T * T * DH * BH, 0, 2 * T * T * BH)[0],
                pair_ms=split_pair_ms(args, c), **common))
            rows.append(row(
                "flash_bwd_dq_softcap", "rap_tpu_torch/csrc/attention_bwd_dq.cuh",
                "rap_tpu/ops/pallas_attention.py:471",
                lambda: fa.flash_bwd_dq_kernel(*args, c),
                lambda: fa.flash_bwd_dq_plain(*args, c), None,
                6 * T * DH * valid, reads + BH * T * DH * 2, shape, reps=5,
                launches=mv.get("flash_bwd_dq_softcap", 0),
                err_key=f"flash_bwd_dq_softcap@{c:g}", library_backward_ms=lib_b,
                bound_all_tiles_ms=bound(6 * T * T * DH * BH, 0, 2 * T * T * BH)[0],
                **common))
    return rows


def split_pair_ms(args, c: float = 0.0) -> float:
    """Median ms of the split backward as one call: the dKV pass (row 7)
    then the dQ pass (row 8), the time to hold beside a library's whole
    backward (``library_backward_ms``)."""
    from rap_tpu_torch.ops import flash_attention as fa

    return cuda_time_ms(lambda: (fa.flash_bwd_dkv_kernel(*args, c),
                                 fa.flash_bwd_dq_kernel(*args, c)), 5)


def sdpa_masked_ms(qh, kh, vah, dout, mask, heads: int):
    """(forward, backward) ms of scaled_dot_product_attention on the same
    head-major q, k, v, dO and boolean key mask, the backward as
    forward+backward minus forward, with the memory-efficient backend (the
    one that takes a mask); (None, None) if that backend refuses the call."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    BH, T, d = qh.shape
    B = BH // heads
    q_, k_, v_ = (a.reshape(B, heads, T, d).detach().clone().requires_grad_(True)
                  for a in (qh, kh, vah[..., :d].contiguous()))
    bias = mask.bool()[:, None, None, :]
    do = dout.reshape(B, heads, T, d)

    def fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(q_, k_, v_, attn_mask=bias, scale=float(np.log(2.0)))

    def fwd_bwd():
        o = F.scaled_dot_product_attention(q_, k_, v_, attn_mask=bias, scale=float(np.log(2.0)))
        torch.autograd.grad(o, (q_, k_, v_), do)

    try:
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            f = cuda_time_ms(fwd, 5)
            return f, cuda_time_ms(fwd_bwd, 5) - f
    except RuntimeError as e:  # the library's refusal, recorded as "none"
        log(f"  scaled_dot_product_attention (memory-efficient, key mask) refused: {e}")
        return None, None


def multiview_kernel_rows(state, row):
    """The masked online forward (row 3) at both multi-view shapes, and rows 6
    (masked, part attention), 7 and 8 (global attention); their launches are
    those of one multi-view step. The bound counts the products this run's
    keys need (the kernels skip key blocks with no valid key;
    ``bound_all_tiles_ms`` counts every tile)."""
    from rap_tpu_torch.ops import flash_attention as fa

    mv_counts = state.get("mv_counts", {})
    rows = []
    sdpa = {}
    for tag in ("part", "global"):
        qh, kh, vah, mask, out, lse, dout = state["mv_attn"][tag][:7]
        BH, T, _ = qh.shape
        valid = float(mask.sum()) * H  # valid keys over every (batch, head) row
        sdpa[tag] = sdpa_masked_ms(qh, kh, vah, dout, mask, H)
        rows.append(row(
            "flash_online", "rap_tpu_torch/csrc/attention.cu",
            "rap_tpu/ops/pallas_attention.py:91",
            lambda: fa.flash_online_kernel(qh, kh, vah, mask, H),
            lambda: fa.flash_online_plain(qh, kh, vah, mask, H), None,
            4 * T * DH * valid,
            BH * T * (DH * 2 + (DH + 1) * 2 + DH * 2 + DH * 2 + 4) + mask.numel() * 4,
            f"multiview {tag}: BH={BH}, T={T}, d={DH} bf16, key mask", lib_ms=sdpa[tag][0],
            reps=5, launches=mv_counts.get("flash_online", 0), err_key="flash_online_masked",
            variant="masked", mufu=T * valid,
            bound_all_tiles_ms=bound(4 * T * T * DH * BH, 0, T * T * BH)[0]))

    qh, kh, vah, mask, out, lse, dout = state["mv_attn"]["part"]
    BH, T, _ = qh.shape
    valid = float(mask.sum()) * H
    reads = BH * T * (2 * DH * 2 + 2 * (DH + 1) * 2 + 4) + mask.numel() * 4
    rows.append(row(
        "flash_bwd", "rap_tpu_torch/csrc/attention_bwd_dkv.cuh",
        "rap_tpu/ops/pallas_attention.py:506",
        lambda: fa.flash_bwd_kernel(qh, kh, vah, out, lse, dout, mask, H),
        lambda: fa.flash_bwd_plain(qh, kh, vah, out, lse, dout, mask, H), None,
        10 * T * DH * valid, reads + 3 * BH * T * DH * 2,
        f"multiview part: BH={BH}, T={T}, d={DH} bf16, key mask", lib_ms=sdpa["part"][1],
        launches=mv_counts.get("flash_bwd", 0), err_key="flash_bwd_masked",
        variant="masked", mufu=T * valid,
        bound_all_tiles_ms=bound(10 * T * T * DH * BH, 0, T * T * BH)[0]))

    qh, kh, vah, mask, out, lse, dout, doa = state["mv_attn"]["global"]
    BH, T, _ = qh.shape
    valid = float(mask.sum()) * H
    # q, k, V, dO (bf16), va's ones column, -delta, lse2 (fp32): the pieces
    # the split passes read (backward_operands), and the key mask
    reads = BH * T * (4 * DH * 2 + 3 * 4) + mask.numel() * 4
    args = (qh, kh, vah, doa, lse, mask, H)
    shape = f"multiview global: BH={BH}, T={T}, d={DH} bf16, key mask"
    rows.append(row(
        "flash_bwd_dkv", "rap_tpu_torch/csrc/attention_bwd_dkv.cuh",
        "rap_tpu/ops/pallas_attention.py:426",
        lambda: fa.flash_bwd_dkv_kernel(*args), lambda: fa.flash_bwd_dkv_plain(*args), None,
        8 * T * DH * valid, reads + 2 * BH * T * DH * 2, shape, reps=5,
        launches=mv_counts.get("flash_bwd_dkv", 0), mufu=T * valid,
        bound_all_tiles_ms=bound(8 * T * T * DH * BH, 0, T * T * BH)[0],
        library_backward_ms=sdpa["global"][1], pair_ms=split_pair_ms(args)))
    rows.append(row(
        "flash_bwd_dq", "rap_tpu_torch/csrc/attention_bwd_dq.cuh",
        "rap_tpu/ops/pallas_attention.py:471",
        lambda: fa.flash_bwd_dq_kernel(*args), lambda: fa.flash_bwd_dq_plain(*args), None,
        6 * T * DH * valid, reads + BH * T * DH * 2, shape, reps=5,
        launches=mv_counts.get("flash_bwd_dq", 0), mufu=T * valid,
        bound_all_tiles_ms=bound(6 * T * T * DH * BH, 0, T * T * BH)[0],
        library_backward_ms=sdpa["global"][1]))
    return rows


def demo_kernel_rows(state, row):
    """Rows 3 (masked) and 5 at the demo scenes' shapes; their launches are
    those of one demo generation (10 steps, rap_12's 12 layers)."""
    from rap_tpu_torch.ops import flash_attention as fa
    from rap_tpu_torch.ops import fused_ff as ff

    rows = []
    for label, (qh, kh, vah, mask) in state["demo_attn"].items():
        BH, T, _ = qh.shape
        valid = float(mask.sum()) * H
        launched = state["demo_counts"][label.split()[0]]
        rows.append(row(
            "flash_online", "rap_tpu_torch/csrc/attention.cu",
            "rap_tpu/ops/pallas_attention.py:91",
            lambda qh=qh, kh=kh, vah=vah, mask=mask: fa.flash_online_kernel(qh, kh, vah, mask, H),
            lambda qh=qh, kh=kh, vah=vah, mask=mask: fa.flash_online_plain(qh, kh, vah, mask, H),
            None, 4 * T * DH * valid,
            BH * T * (DH * 2 + (DH + 1) * 2 + DH * 2 + DH * 2 + 4) + mask.numel() * 4,
            f"demo {label}: BH={BH}, T={T}, d={DH} bf16, key mask",
            lib_ms=sdpa_masked_ms(qh, kh, vah, torch.zeros_like(qh), mask, H)[0],
            launches=launched.get("flash_online", 0), err_key="flash_online_masked",
            variant="masked", mufu=T * valid))
    for label, fwd in state["demo_ff"].items():
        Tn = fwd[0].shape[0]
        rows.append(row("ff", "rap_tpu_torch/csrc/ff.cu", "rap_tpu/ops/fused_ff.py:55",
                        lambda fwd=fwd: ff.ff_kernel(*fwd), lambda fwd=fwd: ff.ff_plain(*fwd),
                        None, *ff_work(Tn), f"demo {label}: tokens {Tn}, D={D}, hidden {FH} bf16",
                        launches=state["demo_counts"][label].get("ff", 0),
                        matmul_ms=cuda_time_ms(ff_matmuls(fwd)[0], 10)))
    return rows


def wide_backward_kernel_rows(state, row):
    """Rows 3 (masked), 6, 7 and 8 at head widths 96 and 128 (their
    128-wide instantiations) at the global shape of a D = 768 or 1024, H = 8
    model at the main path's batch (BH = 32, T = 8192): the masked forward
    with the kernels phase's random key mask beside SDPA's memory-efficient
    backend with the same mask, the backward passes unmasked beside SDPA's
    flash backward (forward+backward minus forward) at the same width. The
    bound counts the products at the unpadded width and, for the masked
    forward, the keys the mask leaves. Launches: the D = 1024 serving
    check's masked forwards at d = 128, and the D = 768 / 1024 training
    checks' backward launches."""
    import torch.nn.functional as F

    from rap_tpu_torch.ops import flash_attention as fa

    rows = []
    serving = state.get("wide_counts", {})
    training = state.get("train_wide_counts", {})
    for d, (qh, kh, vah, out, lse, dout, doa, mask) in state["wide_bwd"].items():
        BH, T, _ = qh.shape
        valid = float(mask.sum()) * H
        common = dict(head_width=d, reps=5)
        sdpa = sdpa_masked_ms(qh, kh, vah, dout, mask, H)
        rows.append(row(
            "flash_online", "rap_tpu_torch/csrc/attention.cu",
            "rap_tpu/ops/pallas_attention.py:91",
            lambda: fa.flash_online_kernel(qh, kh, vah, mask.to(torch.int32), H),
            lambda: fa.flash_online_plain(qh, kh, vah, mask, H), None,
            4 * T * d * valid,
            BH * T * (d * 2 + (d + 1) * 2 + d * 2 + d * 2 + 4) + mask.numel() * 4,
            f"BH={BH}, T={T}, d={d} bf16 (padded to 128), key mask", lib_ms=sdpa[0],
            launches=serving.get(d, {}).get("flash_online", 0),
            err_key="flash_online/wide", variant="masked", mufu=T * valid, **common))
        q_, k_, v_ = (a[None].detach().clone().requires_grad_(True)
                      for a in (qh, kh, vah[..., :d].contiguous()))

        def sdpa_fwd(q_=q_, k_=k_, v_=v_):
            with torch.no_grad():
                F.scaled_dot_product_attention(q_, k_, v_, scale=float(np.log(2.0)))

        def sdpa_fwd_bwd(q_=q_, k_=k_, v_=v_, dout=dout):
            o = F.scaled_dot_product_attention(q_, k_, v_, scale=float(np.log(2.0)))
            torch.autograd.grad(o, (q_, k_, v_), dout[None])

        lib = cuda_time_ms(sdpa_fwd_bwd, 10) - cuda_time_ms(sdpa_fwd, 10)
        shape = f"dense global: BH={BH}, T={T}, d={d} bf16 (padded to 128)"
        reads = BH * T * (4 * d * 2 + 3 * 4)
        launched = training.get(d, {})
        rows.append(row(
            "flash_bwd", "rap_tpu_torch/csrc/attention_bwd_dkv128.cuh",
            "rap_tpu/ops/pallas_attention.py:506",
            lambda: fa.flash_bwd_kernel(qh, kh, vah, out, lse, dout),
            lambda: fa.flash_bwd_plain(qh, kh, vah, out, lse, dout), None,
            10 * BH * T * T * d, reads + 3 * BH * T * d * 2, shape, lib_ms=lib,
            launches=launched.get("flash_bwd", 0), err_key="flash_bwd/wide",
            mufu=BH * T * T, **common))
        args = (qh, kh, vah, doa, lse, None, 1)
        rows.append(row(
            "flash_bwd_dkv", "rap_tpu_torch/csrc/attention_bwd_dkv128.cuh",
            "rap_tpu/ops/pallas_attention.py:426",
            lambda: fa.flash_bwd_dkv_kernel(*args), lambda: fa.flash_bwd_dkv_plain(*args), None,
            8 * BH * T * T * d, reads + 2 * BH * T * d * 2, shape,
            launches=launched.get("flash_bwd_dkv", 0), err_key="flash_bwd_dkv/wide",
            mufu=BH * T * T, library_backward_ms=lib, pair_ms=split_pair_ms(args), **common))
        rows.append(row(
            "flash_bwd_dq", "rap_tpu_torch/csrc/attention_bwd_dq128.cuh",
            "rap_tpu/ops/pallas_attention.py:471",
            lambda: fa.flash_bwd_dq_kernel(*args), lambda: fa.flash_bwd_dq_plain(*args), None,
            6 * BH * T * T * d, reads + BH * T * d * 2, shape,
            launches=launched.get("flash_bwd_dq", 0), err_key="flash_bwd_dq/wide",
            mufu=BH * T * T, library_backward_ms=lib, **common))
    if "wide_bwd_softcap" in state:
        rows += wide_softcap_backward_rows(state, row)
    return rows


def wide_softcap_backward_rows(state, row):
    """Rows 6s, 7s and 8s at head width 128 (the 128-wide key block and dQ
    pass with their softcap flag), unmasked, at the kernels phase's (BH, T)
    = (16, 2048), beside torch.compile(flex_attention)'s backward
    (forward+backward minus forward) with the same cap. No model path runs
    them (no shipped config sets a softcap), so no launches."""
    from rap_tpu_torch.ops import flash_attention as fa

    qh, kh, vah, out, lse, dout, doa, c = state["wide_bwd_softcap"]
    BH, T, _ = qh.shape
    d = 128
    _, lib_b, _ = flex_softcap_ms(qh, kh, vah, c, None, H, dout, out, d=d)
    shape = f"BH={BH}, T={T}, d={d} bf16, softcap {c:g}"
    reads = BH * T * (4 * d * 2 + 3 * 4)
    common = dict(head_width=d, reps=5, softcap=c, launches=0, mufu=2 * BH * T * T,
                  tanh_ops=BH * T * T, library="flex_attention", path="kernels phase check")
    args = (qh, kh, vah, doa, lse, None, H)
    return [
        row("flash_bwd_softcap", "rap_tpu_torch/csrc/attention_bwd_dkv128.cuh",
            "rap_tpu/ops/pallas_attention.py:506",
            lambda: fa.flash_bwd_kernel(qh, kh, vah, out, lse, dout, None, H, c),
            lambda: fa.flash_bwd_plain(qh, kh, vah, out, lse, dout, None, H, c), None,
            10 * BH * T * T * d, reads + 3 * BH * T * d * 2, shape, lib_ms=lib_b,
            err_key="flash_bwd_softcap/wide", **common),
        row("flash_bwd_dkv_softcap", "rap_tpu_torch/csrc/attention_bwd_dkv128.cuh",
            "rap_tpu/ops/pallas_attention.py:426",
            lambda: fa.flash_bwd_dkv_kernel(*args, c), lambda: fa.flash_bwd_dkv_plain(*args, c),
            None, 8 * BH * T * T * d, reads + 2 * BH * T * d * 2, shape,
            err_key="flash_bwd_dkv_softcap/wide", library_backward_ms=lib_b,
            pair_ms=split_pair_ms(args, c), **common),
        row("flash_bwd_dq_softcap", "rap_tpu_torch/csrc/attention_bwd_dq128.cuh",
            "rap_tpu/ops/pallas_attention.py:471",
            lambda: fa.flash_bwd_dq_kernel(*args, c), lambda: fa.flash_bwd_dq_plain(*args, c),
            None, 6 * BH * T * T * d, reads + BH * T * d * 2, shape,
            err_key="flash_bwd_dq_softcap/wide", library_backward_ms=lib_b, **common),
    ]


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
    time_pruned(report, state, per_batch)

    step, s, batch = state["train_step"], state["train_state"], state["train_batch"]
    s, _ = step(s, batch)  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        s, m = step(s, batch)
        float(m["loss"])  # the step's metrics reach the host
        times.append(time.perf_counter() - t0)
    per_step = float(np.median(times))
    step_p, params, opt_cfg = state["train_plain"]
    from rap_tpu_torch.train.step import TrainState

    s_p = TrainState.create(params, opt_cfg, seed=7)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, m = step_p(s_p, batch)
    float(m["loss"])
    plain_step = time.perf_counter() - t0
    tokens = S * P * N
    log(f"  train step ({S} x {P} x {N} points, {LAYERS} layers, Muon, remat): median "
        f"{per_step * 1e3:.2f} ms over 5 (all: {', '.join(f'{x * 1e3:.2f}' for x in times)}) "
        f"-> {tokens / per_step:.1f} tokens/s (plain versions: {plain_step * 1e3:.2f} ms, one run)")
    report["train_step_ms"] = per_step * 1e3
    report["train_step_ms_all"] = [x * 1e3 for x in times]
    report["train_tokens_per_s"] = tokens / per_step
    report["plain_train_step_ms"] = plain_step * 1e3

    step, s, batch = state["mv_step"], state["mv_state"], state["mv_batch"]
    s, _ = step(s, batch)  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        s, m = step(s, batch)
        float(m["loss"])
        times.append(time.perf_counter() - t0)
    per_step = float(np.median(times))
    n_valid, slots = int(batch.point_mask.sum()), MV_S * MV_P * MV_N
    log(f"  multiview step ({MV_S} x {MV_P} x {MV_N} slots, {n_valid} valid points, "
        f"{MV_LAYERS} layers, Muon, remat): median {per_step * 1e3:.2f} ms over 5 "
        f"(all: {', '.join(f'{x * 1e3:.2f}' for x in times)}) -> "
        f"{n_valid / per_step:.1f} valid points/s, {slots / per_step:.1f} padded slots/s")
    report["multiview_step_ms"] = per_step * 1e3
    report["multiview_step_ms_all"] = [x * 1e3 for x in times]
    report["multiview_valid_points_per_s"] = n_valid / per_step
    report["multiview_slots_per_s"] = slots / per_step
    time_sample(report, state)
    time_demo(report, state)
    profile_paths(report, state)
    counts = report.get("launches", {})
    reset_launches()
    report["kernels"] = kernel_rows(state, counts)
    reset_launches()  # timing launches are not main-path launches


def time_pruned(report, state, per_batch: float) -> None:
    """Pruned serving (the main phase's call) as a median over 5, without
    and with the transformer features, beside unpruned serving."""
    serve, rcfg = state["serve_pruned"], state["rcfg_pruned"]
    out = {}
    for features in (False, True):
        serve(rcfg, features)  # warm-up
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            serve(rcfg, features)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out["features" if features else "plain"] = times
    med = float(np.median(out["plain"]))
    log(f"  pruned serving ({PRUNE_COARSE} of {STEPS} steps on 1/{PRUNE_FACTOR} of the "
        f"points): median {med:.2f} ms over 5 (all: "
        f"{', '.join(f'{x:.2f}' for x in out['plain'])}) -> {S / med * 1e3:.3f} pairs/s; "
        f"with transformer features {float(np.median(out['features'])):.2f} ms; unpruned "
        f"{per_batch * 1e3:.2f} ms")
    report["pruned_batch_ms"] = med
    report["pruned_batch_ms_all"] = out["plain"]
    report["pruned_features_batch_ms_all"] = out["features"]


def time_demo(report, state) -> None:
    """apps.demo.main on each demo scene with zero features, three more runs
    (registration ms per generation, preprocessing s; the runs of the demo
    phase were the first at their shapes), then one under the profiler."""
    import tempfile

    from rap_tpu_torch.apps import demo

    report["demo_timing"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        for scene, inp in state.get("demo_inputs", {}).items():
            gen_ms, pre_s = [], []
            for i in range(3):
                rec = {}
                demo.main(demo_argv(inp, Path(tmp) / f"{scene}{i}", []), record=rec)
                gen_ms += rec["gen_ms"]
                pre_s.append(rec["preprocess_s"])
            log(f"  demo {scene} (zero features, {len(rec['keypoints'])} parts, "
                f"(S, P, N) = (1, {', '.join(map(str, rec['batch'].points.shape[:2]))})): "
                f"registration median {float(np.median(gen_ms)):.2f} ms per generation (all: "
                f"{', '.join(f'{x:.2f}' for x in gen_ms)}); preprocessing "
                f"{', '.join(f'{x:.3f}' for x in pre_s)} s")
            prof = device_profile(f"one apps.demo.main run, {scene}, zero features",
                                  lambda: demo.main(demo_argv(inp, Path(tmp) / "prof", [])))
            report["demo_timing"][scene] = {"gen_ms": gen_ms, "preprocess_s": pre_s,
                                            "profile": prof}


def time_sample(report, state) -> None:
    """apps.sample.main at each softcap, SAMPLE_TIMING_RUNS more runs: the
    median generation ms per batch (rap_tpu's timing contract: generation
    only, synchronised; metrics and loading excluded) and pairs/s, and the
    loader's wait per batch beside it."""
    from rap_tpu_torch.apps import sample as app
    from rap_tpu_torch.config import load_config

    cfg = load_config(ROOT / SAMPLE_CONFIG)
    report["sample_timing"] = {}
    for c in SOFTCAPS:
        gen_ms, load_ms, pairs = [], [], 0
        for _ in range(SAMPLE_TIMING_RUNS):
            rec = {}
            app.main(sample_argv(state["sample_ckpt"], c), record=rec)
            gen_ms += rec["batch_gen_ms"]
            load_ms += rec["load_ms"]
            pairs = rec["pairs"] // len(rec["batch_gen_ms"])
        med = float(np.median(gen_ms))
        log(f"  sample, softcap {c:g} ({pairs} pairs per batch, "
            f"{cfg.pipeline.inference_sampling_steps} steps, {cfg.model.num_layers} layers): median {med:.2f} ms per batch over {len(gen_ms)} "
            f"(all: {', '.join(f'{x:.2f}' for x in gen_ms)}) -> {pairs / med * 1e3:.3f} pairs/s; "
            f"loader wait median {float(np.median(load_ms)):.2f} ms per batch")
        # one more run under the profiler: its wall time includes loading,
        # the metrics and the profiler's own cost
        prof = device_profile(f"one apps.sample.main run, softcap {c:g}",
                              lambda: app.main(sample_argv(state["sample_ckpt"], c)))
        report["sample_timing"][str(c)] = {
            "batch_ms": med, "batch_ms_all": gen_ms, "pairs_per_s": pairs / med * 1e3,
            "load_ms": float(np.median(load_ms)), "load_ms_all": load_ms,
            "plain_batch_ms": state["sample_runs"][c]["plain_batch_ms"], "profile": prof}


def profile_paths(report, state) -> None:
    """torch.profiler over one serving batch, one dense and one multi-view
    step (see ``device_profile``): where a path's wall time varies between
    runs, whether the device's time varies with it."""
    report["serving_profile"] = device_profile("one serving batch",
                                               lambda: state["serve"](state["rcfg"]))
    for key, what in (("train", "dense step"), ("mv", "multiview step")):
        step, s, batch = state[f"{key}_step"], state[f"{key}_state"], state[f"{key}_batch"]

        def one_step():
            _, m = step(s, batch)
            float(m["loss"])

        report[f"{'multiview' if key == 'mv' else 'train'}_profile"] = device_profile(
            f"one {what}", one_step)


def device_profile(what: str, fn) -> dict:
    """torch.profiler over one call of ``fn``: each device kernel's total
    time and the device's busy share of the call's wall time (the kernels
    run on one stream, so their times add up without overlap)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue  # host ops; their kernels are listed as device events
        ms = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) / 1e3
        kernels.append({"name": e.key, "ms": ms, "count": e.count})
    kernels.sort(key=lambda k: -k["ms"])
    busy_ms = sum(k["ms"] for k in kernels)
    groups: dict[str, float] = {}
    for k in kernels:
        group = next((g for frags, g in PROFILE_GROUPS if any(f in k["name"] for f in frags)),
                     "PyTorch elementwise, reductions, copies")
        groups[group] = groups.get(group, 0.0) + k["ms"]
    log(f"  profile of {what}: wall {wall_ms:.2f} ms, device kernels "
        f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}% busy, {len(kernels)} kernel names)")
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"    {ms:10.3f} ms {100 * ms / wall_ms:5.1f}%  {group}")
    for k in kernels[:12]:
        log(f"    {k['ms']:10.3f} ms x{k['count']:6d}  {k['name'][:100]}")
    return {"wall_ms": wall_ms, "device_ms": busy_ms, "groups": groups, "kernels": kernels}


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
    if "timing" in phases:  # times the inputs and the paths of the phases before
        phases |= {"kernels", "main", "sample", "demo", "train", "multiview"}

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
    steps = {"build": lambda: run_build(report, fails),
             "kernels": lambda: run_kernels(report, fails, state),
             "main": lambda: run_main(report, fails, state),
             "sample": lambda: run_sample(report, fails, state),
             "demo": lambda: run_demo(report, fails, state),
             "train": lambda: run_train(report, fails, state),
             "multiview": lambda: run_multiview(report, fails, state),
             "trainer": lambda: run_trainer(report, fails, state),
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
