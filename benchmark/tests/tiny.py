"""What the benchmark's CPU tests share: tiny sizes at which a cell runs
through the program's plain route in seconds, and a copy of the checkout's
benchmark with the multi-view training cell entered (its files are in
``benchmark/``; ``BENCHMARK.json`` leaves it out until its check can be
set, PERF.md §7)."""

import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {
    "rap_12.pairs-serve": {
        "config": {"model": {"embed_dim": 128, "num_heads": 2, "num_layers": 2, "ff_hidden": 512},
                   "inference": {"steps": 3}},
        "params": {"pairs": 2, "points": 256, "pool_batches": 2, "scene_points": 4000,
                   "check_batches": 2}},
    "rap_10.multiview-train": {
        "config": {"model": {"embed_dim": 128, "num_heads": 2, "num_layers": 1, "ff_hidden": 512,
                             "compute_dtype": "float32"},
                   "training": {"max_points_per_batch": 4096, "log_every_n_steps": 2}},
        "params": {"samples": 4, "views": [2, 3], "points_per_view": [300, 500],
                   "scene_points": 4000}},
}

# the serving control at the configuration's depth and steps, narrow and with
# few points: its float8 readings keep their full-size distance from the
# program's (the error grows with layers and steps, not with width)
CONTROL = {
    "config": {"model": {"embed_dim": 128, "num_heads": 2, "ff_hidden": 512}},
    "params": {"pairs": 2, "points": 256, "pool_batches": 2, "scene_points": 4000,
               "check_batches": 2}}


# the BENCHMARK.json entries the training cell takes
TRAINING = {
    "config": {
        "name": "rap_10",
        "source": "https://github.com/PRBonn/RAP/blob/main/scripts/test_script_example.sh",
        "file": "benchmark/configs/rap_10.json",
        "reduced": [],
        "why": "the published evaluation script's model (released rap_model_10): 10 DiT layers at D 512, trained with Muon as rap_train.yaml"
    },
    "workload": {
        "name": "rap_10.multiview-train",
        "config": "rap_10",
        "traffic": "multiview-train",
        "chips": 1,
        "why": "training on 5-8-scan samples packed as 2 x 8 x 4096 slots (~40% padding): masked attention fwd+bwd, FF kernels, Muon; bypasses fused proj and out_proj"
    },
    "end_to_end": {
        "name": "train_points_per_s",
        "unit": "points/s",
        "better": "higher",
        "bound": 0.03,
        "source": "host_clock",
        "workloads": [
            "rap_10.multiview-train"
        ]
    },
    "per_layer": [
        {
            "name": "attn_roofline.train",
            "unit": "%",
            "better": "higher",
            "source": "device_trace",
            "layer": "kernels",
            "moves": "train_points_per_s",
            "workloads": [
                "rap_10.multiview-train"
            ]
        },
        {
            "name": "gemm_roofline.train",
            "unit": "%",
            "better": "higher",
            "source": "device_trace",
            "layer": "kernels",
            "moves": "train_points_per_s",
            "workloads": [
                "rap_10.multiview-train"
            ]
        },
        {
            "name": "mfu.train",
            "unit": "%",
            "better": "higher",
            "source": "device_trace",
            "layer": "model",
            "moves": "train_points_per_s",
            "workloads": [
                "rap_10.multiview-train"
            ]
        },
        {
            "name": "glue_pct.train",
            "unit": "%",
            "better": "lower",
            "source": "device_trace",
            "layer": "model glue",
            "moves": "train_points_per_s",
            "workloads": [
                "rap_10.multiview-train"
            ]
        },
        {
            "name": "idle_pct.train",
            "unit": "%",
            "better": "lower",
            "source": "device_trace",
            "layer": "device",
            "moves": "train_points_per_s",
            "workloads": [
                "rap_10.multiview-train"
            ]
        },
        {
            "name": "padding_pct.train",
            "unit": "%",
            "better": "lower",
            "source": "program_counter",
            "layer": "data",
            "moves": "train_points_per_s",
            "workloads": [
                "rap_10.multiview-train"
            ]
        },
        {
            "name": "load_wait_ms.train",
            "unit": "ms",
            "better": "lower",
            "source": "host_clock",
            "layer": "data",
            "moves": "train_points_per_s",
            "workloads": [
                "rap_10.multiview-train"
            ]
        }
    ]
}


def root_with_training(tmp_path) -> Path:
    """A copy of the checkout's benchmark whose BENCHMARK.json has the
    training cell."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append(TRAINING["config"])
    spec["workloads"].append(TRAINING["workload"])
    spec["end_to_end"].append(TRAINING["end_to_end"])
    spec["per_layer"] += TRAINING["per_layer"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path
