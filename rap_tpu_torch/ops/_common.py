"""What the kernel wrappers share: launch counts, device dispatch, checks.

A wrapper takes its plain PyTorch version only when its tensors lie on the
CPU (the tests); for CUDA tensors it launches its kernel or raises. There is
no fallback from one to the other. Every launch goes through ``launch``,
which makes the tensors' device current around the C call (the launchers
take the device from the calling thread, the stream from the tensor), checks
the error code and counts the launch (the ``launch.<kernel>`` counters of
``telemetry``). ``flash_bwd`` counts the fused attention backward with and
without a key mask; each attention kernel's softcap variant counts under its
own ``*_softcap`` name.
"""

from __future__ import annotations

import torch

from .. import telemetry
from . import _build

KERNELS = ("proj", "flash_fixed", "flash_online", "out_proj", "ff",
           "flash_bwd", "proj_bwd", "ff_bwd", "flash_bwd_dkv", "flash_bwd_dq",
           "flash_fixed_softcap", "flash_online_softcap", "flash_bwd_softcap",
           "flash_bwd_dkv_softcap", "flash_bwd_dq_softcap", "kabsch")

telemetry.register(f"launch.{name}" for name in KERNELS)


def reset_launches() -> None:
    telemetry.reset("launch.")


def launch_counts() -> dict[str, int]:
    """{kernel: launches} for every name of KERNELS."""
    return telemetry.counts("launch.")


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True if every tensor is on the CPU, False if every one is on one CUDA
    device; raises for a mix or any other device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on more than one device: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return False


def check_input(name: str, t: torch.Tensor, dtype: torch.dtype,
                shape: tuple[int, ...]) -> None:
    """Raise unless ``t`` has the dtype, shape and contiguity a kernel takes."""
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def require_aligned(kernels: str, **tensors: torch.Tensor) -> None:
    """TMA and 16-byte loads need 16-byte-aligned base addresses."""
    for name, t in tensors.items():
        require(t.data_ptr() % 16 == 0,
                f"{name}: the {kernels} take 16-byte-aligned inputs (a view at an "
                "offset is not); pass a contiguous copy")


def launch(kernel: str, like: torch.Tensor, *args) -> None:
    """Call the C entry point ``rtt_<kernel>`` with ``args`` and the current
    stream of ``like``'s device, with that device current; raise on a CUDA
    error, else count one launch of ``kernel``."""
    fn = getattr(_build.load().lib, f"rtt_{kernel}")
    with torch.cuda.device(like.device):
        err = fn(*args, torch.cuda.current_stream(like.device).cuda_stream)
    _build.check(err, f"{kernel} kernel")
    telemetry.bump(f"launch.{kernel}")
