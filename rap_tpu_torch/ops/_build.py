"""Build and load the port's CUDA kernels with ``nvcc``, bound with ctypes.

Every ``csrc/*.cu`` file is compiled to an object by its own
``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
-fPIC -c``, all started together, and the objects are linked by one ``nvcc
-shared`` into ``rap_tpu_torch/build/librtt_<hash>.so``, where the hash
covers the sources, the headers and the flags, so a changed source rebuilds
and an unchanged one loads at once. The build happens at first use, never
at import: the CPU tests import every module of the port on a machine with
no ``nvcc``. No source includes a PyTorch header, so the build takes
seconds (the slowest source's); each C entry point returns
``cudaGetLastError()`` after its launch.
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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points and their argument types (pointers and the stream are
# c_void_p so ctypes never cuts a 64-bit address to an int)
SIGNATURES = {
    "rtt_proj": [_P] * 9 + [_I] * 5 + [_P],
    "rtt_out_proj": [_P] * 6 + [_I] * 5 + [_P],
    "rtt_ff": [_P] * 10 + [_I] * 3 + [_P],
    "rtt_flash_fixed": [_P] * 3 + [_F] + [_P] * 2 + [_I] * 4 + [_P],
    "rtt_flash_online": [_P] * 6 + [_I] * 5 + [_P],
    "rtt_flash_bwd": [_P] * 10 + [_I] * 5 + [_P],
    "rtt_flash_bwd_dkv": [_P] * 9 + [_I] * 5 + [_P],
    "rtt_flash_bwd_dq": [_P] * 8 + [_I] * 5 + [_P],
    "rtt_flash_fixed_softcap": [_P] * 3 + [_F] * 2 + [_P] * 2 + [_I] * 4 + [_P],
    "rtt_flash_online_softcap": [_P] * 4 + [_F] + [_P] * 2 + [_I] * 5 + [_P],
    "rtt_flash_bwd_softcap": [_P] * 10 + [_I] * 5 + [_F] * 2 + [_P],
    "rtt_flash_bwd_dkv_softcap": [_P] * 9 + [_I] * 5 + [_F] * 2 + [_P],
    "rtt_flash_bwd_dq_softcap": [_P] * 8 + [_I] * 5 + [_F] * 2 + [_P],
    "rtt_proj_bwd": [_P] * 18 + [_I] * 7 + [_P],
    "rtt_ff_bwd": [_P] * 19 + [_I] * 5 + [_P],
    "rtt_kabsch": [_P] * 9 + [_F] * 3 + [_I] * 2 + [_P],
}
# C entry points that launch nothing: the registers and local bytes of the
# backward's setmaxnreg kernels (the key block's eight instantiations, the dQ
# pass's four, at head widths 64 and 128; 8 ints each) and of every kernel behind rtt_flash_* forward,
# rtt_proj, rtt_out_proj, rtt_ff, rtt_ff_bwd, rtt_proj_bwd and rtt_kabsch (2 ints each,
# in the order of QUERY_KERNELS[entry]; cudaFuncGetAttributes)
QUERIES = {
    "rtt_flash_fwd_attributes": [_P],
    "rtt_flash_bwd_attributes": [_P],
    "rtt_flash_bwd_dkv_attributes": [_P],
    "rtt_flash_bwd_dq_attributes": [_P],
    "rtt_proj_attributes": [_P],
    "rtt_out_proj_attributes": [_P],
    "rtt_ff_attributes": [_P],
    "rtt_ff_bwd_attributes": [_P],
    "rtt_proj_bwd_attributes": [_P],
    "rtt_kabsch_attributes": [_P],
}
# the forward attention kernel's eight instantiations (FIXED_BOUND, SOFTCAP,
# head width), which setmaxnreg needs at the launch bound's 168 registers
FLASH_FWD_KERNELS = tuple(f"flash_fwd_kernel<{fixed}, {cap}, {d}>"
                          for fixed, cap in (("true", "false"), ("false", "false"),
                                             ("true", "true"), ("false", "true"))
                          for d in (64, 128))
PROJ_KERNELS = ("adaln_ln_kernel<false>", "gemm_kernel<K, MN, ProjEpi>")
OUT_PROJ_KERNELS = ("gemm_kernel<K, MN, OutHeadMajor>", "tokens_kernel",
                    "gemm_kernel<K, MN, OutTokens>")
FF_KERNELS = ("ff_ln_kernel<false>", "gemm_kernel<K, MN, FfFwdGeglu>",
              "gemm_kernel<K, MN, FfFwdResidual>")
FF_BWD_KERNELS = ("ff_ln_kernel<true>", "ff_bwd_geglu_kernel", "gemm_kernel<K, K, F32Out<10>>",
                  "ln_grad_kernel<false>", "gemm_kernel<MN, MN, F32Out<10>>", "colsum_kernel",
                  "splitsum_kernel")
PROJ_BWD_KERNELS = ("adaln_ln_kernel<true>", "gemm_kernel<K, MN, ProjBwdEpi>", "dv_copy_kernel",
                    "gemm_kernel<K, K, F32Out<9>>", "ln_grad_kernel<true>",
                    "gemm_kernel<MN, MN, F32Out<9>>")
# the kernels each attribute query reports, in its order
QUERY_KERNELS = {
    "rtt_flash_fwd_attributes": FLASH_FWD_KERNELS,
    "rtt_proj_attributes": PROJ_KERNELS,
    "rtt_out_proj_attributes": OUT_PROJ_KERNELS,
    "rtt_ff_attributes": FF_KERNELS,
    "rtt_ff_bwd_attributes": FF_BWD_KERNELS,
    "rtt_proj_bwd_attributes": PROJ_BWD_KERNELS,
    "rtt_kabsch_attributes": ("kabsch_kernel",),
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
        objs = [so.with_name(f"{so.stem}.{os.getpid()}.{src.stem}.o") for src in sources]
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = [(src, subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True))
                 for src, obj in zip(sources, objs)]
        logs = [(src, proc.communicate()[0], proc.returncode) for src, proc in procs]
        log = "".join(f"== {src.name}\n{out}" for src, out, _ in logs)
        failed = [src.name for src, _, rc in logs if rc != 0]
        if not failed:
            link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                                  capture_output=True, text=True)
            log += link.stdout + link.stderr
            if link.returncode != 0:
                failed = ["the link"]
        seconds = time.perf_counter() - t0
        for obj in objs:
            obj.unlink(missing_ok=True)
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
        (BUILD_DIR / "nvcc.log").write_text(log)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in {**SIGNATURES, **QUERIES}.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return KernelLibrary(lib, so, seconds, log)


def check(err: int, what: str) -> None:
    """Raise if a C launcher reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
