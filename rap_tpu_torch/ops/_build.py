"""Build and load the port's CUDA kernels: one ``nvcc`` call, bound with ctypes.

Every ``csrc/*.cu`` file is compiled by a single
``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC`` into ``rap_tpu_torch/build/librtt_<hash>.so``, where the
hash covers the sources, the headers and the flags, so a changed source
rebuilds and an unchanged one loads at once. The build happens at first use,
never at import: the CPU tests import every module of the port on a machine
with no ``nvcc``. No source includes a PyTorch header, so the build takes
seconds; each C entry point returns ``cudaGetLastError()`` after its launch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points and their argument types (pointers and the stream are
# c_void_p so ctypes never cuts a 64-bit address to an int)
SIGNATURES = {
    "rtt_proj": [_P] * 8 + [_I] * 5 + [_P],
    "rtt_out_proj": [_P] * 5 + [_I] * 5 + [_P],
    "rtt_ff": [_P] * 8 + [_I] * 3 + [_P],
    "rtt_flash_fixed": [_P] * 3 + [_F] + [_P] * 2 + [_I] * 3 + [_P],
    "rtt_flash_online": [_P] * 6 + [_I] * 4 + [_P],
}


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when a cached build was loaded
    compiler_log: str     # nvcc/ptxas output of this process's build, or ""


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [shutil.which("nvcc")]
    if cuda_home:
        candidates.append(str(Path(cuda_home) / "bin" / "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the port's "
        "kernels are built on the machine with the card"
    )


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=1)
def load() -> KernelLibrary:
    """Build (if needed) and load the kernel library; cached per process."""
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    so = BUILD_DIR / f"librtt_{_digest(sources + headers)}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}"
            )
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
        (BUILD_DIR / "nvcc.log").write_text(log)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return KernelLibrary(lib, so, seconds, log)


def check(err: int, what: str) -> None:
    """Raise if a C launcher reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
