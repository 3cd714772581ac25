"""What the kernel wrappers share: launch counters, device dispatch, checks.

A wrapper takes its plain PyTorch version only when its tensors lie on the
CPU (the tests); for CUDA tensors it launches its kernel or raises. There is
no fallback from one to the other.
"""

from __future__ import annotations

import torch

KERNELS = ("proj", "flash_fixed", "flash_online", "out_proj", "ff",
           "flash_bwd", "proj_bwd", "ff_bwd")

# one plain integer per kernel, incremented only where the kernel launches
LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


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


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
