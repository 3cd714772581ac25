"""Nothing the harness runs loads JAX or rap_tpu (compared by whole
top-level names: rap_tpu_torch is not rap_tpu), and the reference loads
nothing of the program."""

import json
import subprocess
import sys

from benchmark.tests.tiny import ROOT, TINY, root_with_training

CHECK = """
import json, sys, torch
from pathlib import Path
sys.path.insert(0, {root!r})
from benchmark import run
for cell, over in json.loads({tiny!r}).items():
    run.run(cell, 12345678901, 0.2, True, device="cpu", overrides=over, root=Path({copy!r}))
print(json.dumps(run.banned_modules()))
"""


def test_a_run_of_every_cell_loads_no_jax(tmp_path):
    code = CHECK.format(root=str(ROOT), tiny=json.dumps(TINY),
                        copy=str(root_with_training(tmp_path)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_reference_loads_nothing_of_the_program():
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            "import benchmark.reference.dit, benchmark.reference.sampler, "
            "benchmark.reference.train, benchmark.reference.data; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'rap_tpu', 'rap_tpu_torch', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"


def test_the_banned_names_are_compared_whole():
    from benchmark import run

    assert run.banned_modules(["rap_tpu_torch", "rap_tpu_torch.ops", "jaxtyping", "torch"]) == []
    assert run.banned_modules(["rap_tpu.models", "jaxlib.xla", "flax"]) == \
        ["flax", "jaxlib", "rap_tpu"]


def test_no_card_no_result():
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here: a run would measure")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "rap_12.pairs-serve",
                          "--seed", "3", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr
