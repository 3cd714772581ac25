"""YAML configs with ``include`` and dotted ``key=value`` overrides
(counterpart of rap_tpu/config.py).

The same files (``configs/*.yaml``), the same override syntax (``-o
model.softcap=5.0``, each value parsed as YAML) and the same typed
dataclasses, built here from the port's own ``DiTConfig``, ``RPFConfig``,
``DatasetConfig``, ``EvalConfig`` and ``OptimizerConfig``. ``model_name``
picks a ``MODEL_ZOO`` entry and the ``model`` keys override it;
``pipeline.model`` mirrors ``model``. ``model.compute_dtype`` may be given
by name (``float32``, ``bfloat16``, ``float16``). ``visualize: true`` has
``apps.sample`` render each batch through ``eval.visualizer`` with the
``visualizer`` section's settings. Every field of rap_tpu's ``Config`` is
here; ``n_devices`` is the data-parallel world ``apps.train`` expects (0:
whatever world it was launched in; another count than the world's raises).
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path
from typing import Any

import torch
import yaml

from .data.dataset import DatasetConfig
from .eval.evaluator import EvalConfig
from .eval.visualizer import VisualizerConfig
from .models.config import MODEL_ZOO, DiTConfig
from .registration import RPFConfig
from .train.optim import OptimizerConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class DataConfig:
    datasets: tuple[DatasetConfig, ...] = ()
    max_points_per_batch: int = 400_000
    max_parts: int = 512
    max_points_per_part: int = 40_000
    max_samples_per_epoch: int = 0   # per-dataset random cap a training epoch (0 = all)
    num_prefetch: int = 2


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    max_epochs: int = 2000
    val_every_n_epochs: int = 10
    checkpoint_dir: str = "checkpoints"
    keep_last: bool = True
    monitor: str = "val/overall/object_chamfer"
    seed: int = 42
    log_every_n_steps: int = 50
    train_points_per_batch: int = 80_000
    remat: bool = True
    log_file: str = ""   # JSONL metrics log; "" = <checkpoint_dir>/metrics.jsonl


@dataclasses.dataclass(frozen=True)
class Config:
    model_name: str = "rap_12"
    model: DiTConfig = dataclasses.field(default_factory=DiTConfig)
    pipeline: RPFConfig = dataclasses.field(default_factory=RPFConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    trainer: TrainerConfig = dataclasses.field(default_factory=TrainerConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    visualizer: VisualizerConfig = dataclasses.field(default_factory=VisualizerConfig)
    visualize: bool = False
    # .npz parameters, a torch .ckpt/.pth/.pt, or a train-state directory
    # (train/checkpoint.py); "" = random weights from trainer.seed
    checkpoint: str = ""
    n_devices: int = 0     # apps.train's world size; 0 = the launched world's


def _resolve_type(owner, tp):
    """A string annotation (``from __future__ import annotations``) as a type
    in its module's scope, or ``str`` where it names no single type."""
    if not isinstance(tp, str):
        return tp
    try:
        return eval(tp, vars(sys.modules[owner.__module__]))  # noqa: S307 (own module)
    except Exception:
        return str


def _build(dc_type, data: dict[str, Any] | None):
    """A dataclass from a plain dict, nested dataclasses included."""
    if data is None:
        return dc_type()
    fields = {f.name: f for f in dataclasses.fields(dc_type)}
    kwargs = {}
    for key, val in data.items():
        if key not in fields:
            raise KeyError(f"{dc_type.__name__}: unknown config key '{key}'")
        resolved = _resolve_type(dc_type, fields[key].type)
        if dataclasses.is_dataclass(resolved) and isinstance(val, dict):
            kwargs[key] = _build(resolved, val)
        elif key == "datasets" and isinstance(val, list):
            kwargs[key] = tuple(_build(DatasetConfig, v) for v in val)
        elif isinstance(val, list):
            kwargs[key] = tuple(val)
        else:
            kwargs[key] = val
    return dc_type(**kwargs)


def _apply_override(cfg_dict: dict, dotted: str, value: str) -> None:
    keys = dotted.split(".")
    d = cfg_dict
    for k in keys[:-1]:
        if isinstance(d, list):
            d = d[int(k)]
        else:
            nxt = d.setdefault(k, {})
            if nxt is None:  # an empty YAML section
                nxt = d[k] = {}
            d = nxt
    if isinstance(d, list):
        d[int(keys[-1])] = yaml.safe_load(value)
    else:
        d[keys[-1]] = yaml.safe_load(value)


def _model_config(name: str, over: dict) -> DiTConfig:
    if name not in MODEL_ZOO:
        raise KeyError(f"unknown model_name '{name}'; available: {sorted(MODEL_ZOO)}")
    over = dict(over)
    if isinstance(over.get("compute_dtype"), str):
        over["compute_dtype"] = _DTYPES[over["compute_dtype"]]
    return dataclasses.replace(MODEL_ZOO[name], **over)


def load_config(path: str | Path | None = None,
                overrides: list[str] | None = None) -> Config:
    """Load YAML (``include:`` merged under it) and apply key=value overrides."""
    data: dict[str, Any] = _load_yaml_with_includes(Path(path)) if path else {}
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got: {ov}")
        k, v = ov.split("=", 1)
        _apply_override(data, k, v)
    model = _model_config(data.get("model_name", "rap_12"), data.pop("model", {}) or {})
    data["model"] = {}
    cfg = _build(Config, data)
    return dataclasses.replace(cfg, model=model,
                               pipeline=dataclasses.replace(cfg.pipeline, model=model))


def _load_yaml_with_includes(path: Path) -> dict:
    data = yaml.safe_load(path.read_text()) or {}
    inc = data.pop("include", None)
    if inc:
        data = _deep_merge(_load_yaml_with_includes((path.parent / inc).resolve()), data)
    return data


def _deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out
