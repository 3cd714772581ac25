"""Experiment tracking: a JSONL metrics log always, a wandb mirror on request
(counterpart of rap_tpu/train/tracking.py).

- ``find_run_id``: the tracker's run id, kept beside the checkpoints
  (``wandb_run_id.txt``), to re-attach a resumed run;
- ``snapshot_code``: the port's sources (``rap_tpu_torch/**/*.py``) zipped
  into the run directory;
- ``ExperimentTracker``: ``metrics.jsonl`` (or ``jsonl_path``), the config
  as ``config.json``, the code snapshot, ``log``/``log_dict``/``finish``.

The wandb mirror is opt-in (``use_wandb=True``; rap_tpu's is on by
default): ``wandb.init`` reaches the network, and so does wandb's own error
reporting when it fails offline. Off, wandb is never imported and the JSONL
file is the record.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import zipfile
from pathlib import Path
from typing import Any

import numpy as np
import torch

logger = logging.getLogger("rap_tpu_torch.tracking")


def find_run_id(ckpt_dir) -> str | None:
    """The tracker run id persisted next to the checkpoints, if any."""
    f = Path(ckpt_dir) / "wandb_run_id.txt"
    return f.read_text().strip() if f.is_file() else None


def snapshot_code(run_dir, package_root=None) -> Path:
    """Zip the package's Python sources into ``run_dir/code_snapshot.zip``."""
    package_root = Path(package_root or Path(__file__).resolve().parents[1])
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    out = run_dir / "code_snapshot.zip"
    with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as z:
        for f in sorted(package_root.rglob("*.py")):
            z.write(f, Path(package_root.name) / f.relative_to(package_root))
    return out


def _scalar(v) -> float:
    """A metric as a float (a device tensor is read here: the caller's sync)."""
    if isinstance(v, torch.Tensor):
        return float(v.detach().float().cpu())
    return float(np.asarray(v))


def _plain(x):
    """A config as JSON-friendly values (dtypes by name)."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, (tuple, list)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, torch.dtype):
        return str(x).removeprefix("torch.")
    return x


class ExperimentTracker:
    """JSONL metrics log + optional wandb mirror + run-id resume."""

    def __init__(
        self,
        run_dir: str | Path,
        project: str = "rap_tpu",
        config: Any = None,
        use_wandb: bool = False,
        resume_id: str | None = None,
        snapshot: bool = True,
        jsonl_path: str | Path | None = None,
        rank_zero: bool = True,
    ):
        self.run_dir = Path(run_dir)
        self._wandb = None
        self._jsonl = None
        self.rank_zero = rank_zero
        if not rank_zero:  # another rank of a data-parallel run: writes nothing
            return
        self.run_dir.mkdir(parents=True, exist_ok=True)
        jsonl = Path(jsonl_path) if jsonl_path else self.run_dir / "metrics.jsonl"
        jsonl.parent.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(jsonl, "a")
        cfg_dict = _plain(config) if config is not None else {}
        (self.run_dir / "config.json").write_text(json.dumps(cfg_dict, indent=2, default=str))
        if snapshot:
            snapshot_code(self.run_dir)
        if use_wandb:
            try:
                import wandb
            except ImportError:
                logger.info("wandb is not installed; JSONL only")
                return
            try:
                self._wandb = wandb.init(project=project, config=cfg_dict, id=resume_id,
                                         resume="allow" if resume_id else None,
                                         dir=str(self.run_dir))
                (self.run_dir / "wandb_run_id.txt").write_text(self._wandb.id)
                logger.info("wandb run %s (resume=%s)", self._wandb.id, resume_id)
            except Exception as e:  # offline or misconfigured: JSONL stays the record
                logger.info("wandb unavailable (%s); JSONL only", str(e)[:80])
                self._wandb = None

    def log(self, step: int, metrics: dict, prefix: str = "train") -> None:
        if not self.rank_zero:
            return
        scalars = {f"{prefix}/{k}": _scalar(v) for k, v in metrics.items()}
        logger.info("step %d | %s", step, " ".join(f"{k}={v:.4g}" for k, v in scalars.items()))
        if self._jsonl:
            self._jsonl.write(json.dumps({"step": step, **scalars}) + "\n")
            self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log(scalars, step=step)

    def log_dict(self, step: int, nested: dict, prefix: str = "val") -> None:
        """Log a {dataset: {metric: value}} nested dict."""
        self.log(step, {f"{ds}/{k}": v for ds, d in nested.items() for k, v in d.items()},
                 prefix=prefix)

    def finish(self) -> None:
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None
