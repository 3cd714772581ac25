"""The data axis of a torch.distributed world and the collectives over it
(counterpart of rap_tpu/parallel/mesh.py).

rap_tpu holds a ``jax.sharding.Mesh`` with a ``data`` axis and lets XLA
insert the collectives. Here ``Mesh`` is the world's size, this rank, its
device and its backend, and the code calls the collectives it needs:
``all_reduce_sum`` (the gradient and the loss's denominators of data
parallelism), ``all_gather`` (sequence-sharded sampling's outputs),
``broadcast`` (the trainer's best monitor) and ``ring_shift`` (ring
attention's hop). Each takes the rank's tensor on its device and returns
one there.

Transport: ``nccl`` moves CUDA tensors; ``gloo`` moves CPU tensors only, so
with a gloo group and CUDA tensors (several ranks sharing one card, where
nccl refuses) each collective copies its tensor to the host, runs there and
copies the result back. That copy is the backend's transport, not a
fallback: the computation stays on the card.

A mesh without a process group (a world of 1 that joined nothing) has
collectives that return their input.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..core.batch import TENSOR_FIELDS, PartBatch
from .distributed import is_initialized, rank_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    size: int                 # ranks on the data axis
    rank: int                 # this rank
    device: torch.device      # this rank's device
    backend: str | None = None  # the world's backend; None: no world joined

    @property
    def host_transport(self) -> bool:
        """Whether collectives copy through the host (gloo with CUDA tensors)."""
        return self.backend == "gloo" and self.device.type == "cuda"


def make_mesh(n_devices: int | None = None, device: str | torch.device = "cuda") -> Mesh:
    """The data axis over the joined world: ``n_devices`` (None or 0: the
    world size) must equal the world size. Without a joined world it is a
    mesh of 1 with no backend. The collectives run on the default group, as
    the checkpoint and meter code does."""
    if is_initialized():
        size, rank, backend = dist.get_world_size(), dist.get_rank(), dist.get_backend()
    else:
        size, rank, backend = 1, 0, None
    n = n_devices or size
    if n != size:
        raise ValueError(f"a mesh of {n} devices over a world of {size} processes: launch "
                         f"one process per device (torchrun --nproc-per-node {n})")
    return Mesh(size, rank, rank_device(device), backend)


def _wire(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu() if mesh.host_transport else t.detach().contiguous()


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``t`` over the ranks (no gradient)."""
    if mesh.backend is None:
        return t.detach()
    buf = _wire(mesh, t).clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    return buf.to(t.device)


def all_gather(t: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """The ranks' tensors (one shape) concatenated along ``dim`` in rank
    order (no gradient)."""
    if mesh.backend is None:
        return t.detach()
    w = _wire(mesh, t)
    bufs = [torch.empty_like(w) for _ in range(mesh.size)]
    dist.all_gather(bufs, w)
    return torch.cat(bufs, dim).to(t.device)


def broadcast(t: torch.Tensor, mesh: Mesh, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank."""
    if mesh.backend is None:
        return t.detach()
    buf = _wire(mesh, t).clone()
    dist.broadcast(buf, src=src)
    return buf.to(t.device)


def barrier(mesh: Mesh) -> None:
    if mesh.backend is not None:
        dist.barrier()


def ring_shift(t: torch.Tensor, mesh: Mesh, step: int = 1) -> torch.Tensor:
    """Send ``t`` to rank (r + step) % n and return what rank (r - step) % n
    sent (no gradient: ``ops.ring_attention`` wraps it for autograd)."""
    if mesh.size == 1:
        return t
    w = _wire(mesh, t)
    buf = torch.empty_like(w)
    ops = [dist.P2POp(dist.isend, w, (mesh.rank + step) % mesh.size),
           dist.P2POp(dist.irecv, buf, (mesh.rank - step) % mesh.size)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return buf.to(t.device)


def shard_batch(batch: PartBatch, mesh: Mesh) -> PartBatch:
    """The rank's shard of a global batch, on the rank's device: each tensor
    whose leading axis divides by the mesh size keeps its contiguous slice,
    the others stay whole (replicated), as rap_tpu's leading-axis sharding
    does (distributed.py:152-156): per-sample tensors of an S = 1 map-merge
    batch stay whole while its parts split. The part axis must divide (a
    rank holding every part would make ring attention see each key n
    times): pad the part slots to a multiple of the mesh size, as
    ``apps.demo`` does. Where the per-sample tensors split,
    ``sample_of_part`` counts from 0 on every rank (it indexes the shard's
    own per-sample tensors)."""
    n, r = mesh.size, mesh.rank
    if batch.G % n:
        raise ValueError(f"{batch.G} part slots do not divide over {n} ranks: pad them to a "
                         f"multiple of {n}")

    def shard(x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % n:
            return x.to(mesh.device)
        per = x.shape[0] // n
        return x[r * per:(r + 1) * per].to(mesh.device)

    fields = {f: shard(getattr(batch, f)) for f in TENSOR_FIELDS
              if getattr(batch, f) is not None}
    if batch.S % n == 0:
        fields["sample_of_part"] = fields["sample_of_part"] - r * (batch.S // n)
    return dataclasses.replace(batch, **fields)
