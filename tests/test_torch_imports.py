"""rap_tpu_torch stands alone: no jax, no flax, no rap_tpu; CUDA by default.

The port runs on a machine that has torch and numpy but no jax and no flax,
so importing every module of the package must pull in neither (checked in a
fresh interpreter), and no source may import rap_tpu, even its modules that
import without jax. chip_smoke.py imports only torch, numpy, the standard
library and rap_tpu_torch. The entry points default to device="cuda" and
raise where there is no card instead of running on the CPU.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "rap_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
    for p in PKG.rglob("*.py")
)


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_importing_the_port_loads_no_jax_flax_or_rap_tpu():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'rap_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(" + repr(MODULES) + "))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(MODULES) > 10


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: p.name)
def test_no_source_imports_jax_or_rap_tpu(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "flax", "rap_tpu"}


def test_chip_smoke_imports_only_torch_numpy_stdlib_and_the_port():
    allowed = {"torch", "numpy", "rap_tpu_torch", "__future__"} | set(sys.stdlib_module_names)
    roots = _imported_roots(REPO / "chip_smoke.py")
    assert roots <= allowed, roots - allowed


def test_cuda_sources_include_no_pytorch_header():
    sources = sorted((PKG / "csrc").glob("*.cu*"))
    assert {p.name for p in sources} >= {"proj.cu", "attention.cu", "out_proj.cu", "ff.cu"}
    for p in sources:
        text = p.read_text()
        assert "torch/" not in text and "ATen" not in text and "c10/" not in text, p.name
        assert "Replaces the TPU kernel" in text or "replaces rap_tpu" in text or p.suffix == ".cuh"


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works here")


def test_batch_defaults_to_cuda():
    from rap_tpu_torch.core.batch import make_regular_synthetic_batch

    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_regular_synthetic_batch(0, [[8, 8]], N=8, P=2)


def test_init_params_defaults_to_cuda():
    from rap_tpu_torch.models.config import DiTConfig
    from rap_tpu_torch.models.dit import init_dit_params

    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_dit_params(0, DiTConfig(embed_dim=64, num_layers=1, num_heads=1))


def test_load_params_defaults_to_cuda():
    from rap_tpu_torch.weights import load_params_npz

    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_params_npz(REPO / "demo_data" / "ckpts" / "teacher3_last.npz")


def test_chip_smoke_fails_without_a_card():
    _no_card()
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_training_slice_modules_and_sources_are_covered():
    assert {"rap_tpu_torch.core.flow", "rap_tpu_torch.train.optim",
            "rap_tpu_torch.train.step"} <= set(MODULES)
    sources = {p.name for p in (PKG / "csrc").glob("*.cu")}
    assert {"attention_bwd.cu", "proj_bwd.cu", "ff_bwd.cu"} <= sources


def test_multiview_slice_modules_and_sources_are_covered():
    from rap_tpu_torch.ops import KERNELS
    from rap_tpu_torch.ops._build import SIGNATURES

    assert {"rap_tpu_torch.ops.attention", "rap_tpu_torch.core.segments"} <= set(MODULES)
    sources = {p.name for p in (PKG / "csrc").iterdir()}
    assert {"attention_bwd_split.cu", "attention_bwd_common.cuh"} <= sources
    # every counted kernel launches through the C entry point rtt_<name>
    assert {f"rtt_{k}" for k in KERNELS} == set(SIGNATURES)


def test_train_step_defaults_to_cuda():
    from rap_tpu_torch.registration import RPFConfig
    from rap_tpu_torch.train.optim import OptimizerConfig
    from rap_tpu_torch.train.step import TrainState, make_train_step

    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(RPFConfig(), OptimizerConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainState.create({"anchor_emb": torch.zeros(2, 4)}, OptimizerConfig(), seed=0)


def test_sample_slice_modules_and_sources_are_covered():
    """The batch-evaluation slice's modules are in MODULES (so the fresh
    interpreter above imports them), and every attention kernel has a
    softcap entry point beside it."""
    from rap_tpu_torch.ops._build import SIGNATURES

    assert {"rap_tpu_torch.config", "rap_tpu_torch.apps.sample", "rap_tpu_torch.data.dataset",
            "rap_tpu_torch.data.packer", "rap_tpu_torch.data.loader",
            "rap_tpu_torch.eval.metrics", "rap_tpu_torch.eval.evaluator",
            "rap_tpu_torch.eval.meter", "rap_tpu_torch.utils.ply"} <= set(MODULES)
    for name in ("flash_fixed", "flash_online", "flash_bwd", "flash_bwd_dkv", "flash_bwd_dq"):
        assert f"rtt_{name}_softcap" in SIGNATURES


def test_collate_defaults_to_cuda():
    from rap_tpu_torch.data.dataset import Sample
    from rap_tpu_torch.data.packer import collate_to_part_batch

    _no_card()
    import numpy as np

    pts = [np.zeros((4, 3), np.float32)] * 2
    smp = Sample("s", "d", 0, pts, pts, [np.zeros((4, 32), np.float32)] * 2,
                 np.tile(np.eye(3, dtype=np.float32), (2, 1, 1)), np.zeros((2, 3), np.float32),
                 0, 1.0, np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        collate_to_part_batch([smp], N=4, P=2)


def test_demo_slice_modules_are_covered_and_import_scipy_lazily():
    """The demo slice's modules are in MODULES (the fresh interpreter above
    imports them), and those that need scipy import it inside the function,
    as rap_tpu's do."""
    demo_slice = {"rap_tpu_torch.ops.points", "rap_tpu_torch.spinnet",
                  "rap_tpu_torch.spinnet.model", "rap_tpu_torch.apps.demo",
                  "rap_tpu_torch.data.synthetic_scenes"}
    assert demo_slice <= set(MODULES)
    for rel in ("ops/points.py", "spinnet/model.py", "data/synthetic_scenes.py",
                "apps/demo.py"):
        tree = ast.parse((PKG / rel).read_text())
        top = {a.name.split(".")[0] for node in tree.body if isinstance(node, ast.Import)
               for a in node.names}
        top |= {node.module.split(".")[0] for node in tree.body
                if isinstance(node, ast.ImportFrom) and node.level == 0}
        assert "scipy" not in top, rel


def test_spinnet_defaults_to_cuda():
    from rap_tpu_torch.spinnet import build_feature_extractor, init_spinnet

    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_spinnet(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_feature_extractor()


def test_trainer_slice_modules_are_covered():
    """The trainer slice's modules are in MODULES (the fresh interpreter
    above imports them, and the source scan checks each)."""
    assert {"rap_tpu_torch.apps.train", "rap_tpu_torch.train.checkpoint",
            "rap_tpu_torch.train.weights", "rap_tpu_torch.train.tracking",
            "rap_tpu_torch.eval.runner"} <= set(MODULES)


def test_trainer_entry_points_default_to_cuda(tmp_path):
    from rap_tpu_torch.apps import train
    from rap_tpu_torch.config import load_config
    from rap_tpu_torch.data import DatasetConfig, PointCloudDataset
    from rap_tpu_torch.eval.runner import evaluate_split

    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--config", str(REPO / "configs" / "rap_train.yaml"),
                    "-o", f"trainer.checkpoint_dir={tmp_path}"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.run_train(load_config(REPO / "configs" / "rap_train.yaml"))
    ds = PointCloudDataset(DatasetConfig(data_path=str(REPO / "demo_data" / "synth")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_split({}, None, ds)
