"""Joining a torch.distributed world, and each rank's slice of a batch
(counterpart of rap_tpu/parallel/distributed.py).

One process per GPU, launched by ``torchrun`` (or SLURM / OpenMPI with
``MASTER_ADDR``/``MASTER_PORT`` set), each calling :func:`initialize`.
rap_tpu's processes run one jitted program over *global* arrays whose
shards they own, stitched together by ``make_global_batch``; torch has no
global arrays, so there is no ``make_global_batch`` here: the rank's slice
of a batch *is* its shard, and the code that needs something of the whole
batch says so with a collective (``parallel/mesh.py``).

The data contract is rap_tpu's: every rank computes the same batch plan
and takes its contiguous slice of the sample axis, and, since parts are
sample-major (G = S * P), the matching contiguous slice of the part axis.
One difference: a slice's ``sample_of_part`` indexes the per-sample arrays
the slice holds (it counts from 0 on every rank), where rap_tpu's keeps the
global sample indices that its jitted gathers over global arrays need.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from .._device import resolve_device
from ..core.batch import TENSOR_FIELDS, PartBatch

# (world size, rank, local rank) variables of the launchers the port knows:
# torchrun's, then OpenMPI's and SLURM's, which need MASTER_ADDR/MASTER_PORT
_LAUNCHERS = (("WORLD_SIZE", "RANK", "LOCAL_RANK"),
              ("OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_LOCAL_RANK"),
              ("SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID"))


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def launcher_world() -> tuple[int, int, int]:
    """(world size, rank, local rank) from the launcher's environment; (1, 0,
    0) without one. A SLURM or OpenMPI allocation of one task is a world of
    1: joining it would wait at the rendezvous for peers that never come."""
    for size_var, rank_var, local_var in _LAUNCHERS:
        if size_var in os.environ and _env_int(size_var, 1) > 1:
            return (_env_int(size_var, 1), _env_int(rank_var, 0), _env_int(local_var, 0))
    return 1, 0, _env_int("LOCAL_RANK", 0)


def rank_device(device: str | torch.device = "cuda") -> torch.device:
    """The rank's device: ``cuda`` without an index is ``cuda:LOCAL_RANK``
    (the launcher's local rank), anything else stays as given. Raises where
    a CUDA device is asked for and there is no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", launcher_world()[2])
    return resolve_device(dev)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> tuple[int, int]:
    """(rank, world size) of the joined world; (0, 1) without one."""
    if not is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def initialize(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    backend: str | None = None,
    device: str | torch.device = "cuda",
    timeout_s: float | None = None,
) -> tuple[int, int]:
    """Join the process group; returns (rank, world size).

    The world comes from the arguments, else from the launcher's
    environment (``launcher_world``). A world of 1 joins nothing (a no-op)
    unless ``init_method`` is given; a joined world stays joined (a second
    call returns it). ``device`` is the rank's device (``rank_device``): a
    CUDA one becomes the current device, and picks the ``nccl`` backend, a
    CPU one ``gloo``; ``backend`` overrides that choice, as
    ``init_process_group``'s argument does. Without ``init_method`` the
    rendezvous is ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``)."""
    if is_initialized():
        return world()
    env_world, env_rank, _ = launcher_world()
    world_size = env_world if world_size is None else world_size
    rank = env_rank if rank is None else rank
    if world_size <= 1 and init_method is None:
        return 0, 1
    if init_method is None and not ("MASTER_ADDR" in os.environ
                                    and "MASTER_PORT" in os.environ):
        raise ValueError(f"a world of {world_size} processes needs a rendezvous: set "
                         "MASTER_ADDR and MASTER_PORT (torchrun does) or pass init_method")
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method=init_method or "env://", world_size=world_size,
                            rank=rank, **kw)
    return world()


@contextlib.contextmanager
def process_group(device: str | torch.device = "cuda"):
    """``initialize`` from the launcher's environment around a run: yields
    (rank, world size), and leaves the group again on exit if it joined it
    (a world joined by the caller stays joined)."""
    joined = not is_initialized()
    try:
        yield initialize(device=device)
    finally:
        if joined and is_initialized():
            dist.destroy_process_group()


def process_slice(S_global: int, rank: int | None = None,
                  world_size: int | None = None) -> tuple[int, int]:
    """This rank's contiguous [lo, hi) sample-slot range of a global batch."""
    r, n = world()
    r = r if rank is None else rank
    n = n if world_size is None else world_size
    if S_global % n:
        raise ValueError(f"S={S_global} does not divide over {n} ranks")
    per = S_global // n
    return r * per, (r + 1) * per


def slice_local_batch(batch: PartBatch, process_index: int | None = None,
                      process_count: int | None = None) -> PartBatch:
    """The rank's contiguous S-slice of a global batch: per-sample tensors
    (S leading) [lo, hi), per-part and per-point tensors (G = S * P leading,
    sample-major) [lo * P, hi * P); ``sample_of_part`` counts from 0 (see
    the module docstring)."""
    S, G = batch.S, batch.G
    lo, hi = process_slice(S, process_index, process_count)
    P = G // S

    def sl(x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] == S:
            return x[lo:hi]
        if x.shape[0] != G:
            raise ValueError(f"unexpected leading dim {tuple(x.shape)}")
        return x[lo * P:hi * P]

    fields = {f: sl(getattr(batch, f)) for f in TENSOR_FIELDS if getattr(batch, f) is not None}
    fields["sample_of_part"] = fields["sample_of_part"] - lo
    return dataclasses.replace(batch, **fields)
