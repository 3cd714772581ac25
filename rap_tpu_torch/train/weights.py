"""Checkpoint resolution: an existing path, then the local cache
(counterpart of rap_tpu/train/weights.py:38-63, :128-160).

A spec is a path or a known artifact name (``rap_model_12.ckpt``, ...).
``resolve_checkpoint`` returns the path if it exists, else the first file of
that name under the cache directory (``$RAP_TPU_CACHE``, default
``~/.cache/rap_tpu/weights``), each checked against ``sha256`` when one is
given. rap_tpu's two download branches (the HF hub and the weights zip,
:65-125) are not ported: the port never reaches the network. A spec that
resolves nowhere raises ``FileNotFoundError`` naming the places tried.
"""

from __future__ import annotations

import hashlib
import logging
import os
from pathlib import Path

logger = logging.getLogger("rap_tpu_torch.weights")

KNOWN_CHECKPOINTS = (
    "rap_model.ckpt",
    "rap_model_10.ckpt",
    "rap_model_12.ckpt",
    "spinnet_3dmatch_bufferx.pth",
    "spinnet_kitti_bufferx.pth",
    "mini_spinnet_t.pth",
)


def default_cache_dir() -> Path:
    return Path(os.environ.get("RAP_TPU_CACHE", Path.home() / ".cache" / "rap_tpu" / "weights"))


def sha256_of(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _verify(path: Path, sha256: str | None) -> Path:
    if sha256:
        got = sha256_of(path)
        if got != sha256:
            raise ValueError(f"checksum mismatch for {path}: expected {sha256}, got {got}")
        logger.info("checksum OK for %s", path.name)
    return path


def resolve_checkpoint(spec: str, cache_dir: str | Path | None = None,
                       sha256: str | None = None) -> Path:
    """A checkpoint path or artifact name -> an existing local file."""
    if not spec:
        raise ValueError("empty checkpoint spec")
    p = Path(spec).expanduser()
    if p.exists():
        return _verify(p, sha256)
    cache = Path(cache_dir) if cache_dir else default_cache_dir()
    cached = next(cache.rglob(p.name), None) if cache.is_dir() else None
    if cached is not None:
        return _verify(cached, sha256)
    raise FileNotFoundError(
        f"checkpoint '{spec}' not found: tried the path {p.absolute()} and the cache "
        f"{cache} (the port downloads nothing; put the file in one of them)")
