"""The port's counterpart of ``__graft_entry__.py``, its two entry points:
a single-GPU forward and a multi-GPU dry run.

- ``entry(device="cuda")`` returns ``(fn, args)``: ``fn(*args)`` is rap_12's
  velocity field (``dit_forward``, 12 layers, D = 512, H = 8) on the
  flagship batch, one sample of two parts of 512 and 505 points padded to
  N = 512, at t = 0.5, through the hand-written kernels on the card (their
  plain versions on the CPU).
- ``dryrun_multigpu(n, device="cuda")`` runs, on tiny shapes over a world
  of ``n`` processes (``parallel/``): one data-parallel train step, a
  ring-sharded ``sample`` (the global attention as ring attention over the
  ranks), and ``make_scanned_train_steps`` twice, then a data-parallel
  sampling of the rank's shard. Called in a joined world of ``n`` ranks it
  runs this rank's share and returns its results; otherwise it starts the
  ``n`` processes itself (``torch.multiprocessing``, a file store in a
  temporary directory), nccl on cards 0..n-1, or gloo on the CPU when
  ``device="cpu"``. It refuses an ``n`` above the number of cards.

    python -m rap_tpu_torch.graft_entry                # entry's forward
    python -m rap_tpu_torch.graft_entry multigpu 2     # the dry run, 2 GPUs
    python -m rap_tpu_torch.graft_entry multigpu 2 cpu # on 2 gloo CPU ranks
"""

from __future__ import annotations

import dataclasses
import math
import sys
import tempfile
import time
from pathlib import Path

import torch

from ._device import resolve_device
from .core.batch import make_regular_synthetic_batch, validate
from .models.config import DiTConfig
from .models.dit import dit_forward, init_dit_params
from .registration import RPFConfig, parts_per_sample, sample


def flagship(device="cuda", compute_dtype: torch.dtype | None = None):
    """(config, batch) of the flagship forward (``__graft_entry__._flagship``):
    rap_12, one sample of parts of 512 and 505 points in slots of 512."""
    model = DiTConfig(num_layers=12)
    if compute_dtype is not None:
        model = dataclasses.replace(model, compute_dtype=compute_dtype)
    N = 512
    batch = make_regular_synthetic_batch(0, [[N, N - 7]], N=N, P=2, S=1,
                                         feat_dim=model.local_feat_dim, device=device)
    return RPFConfig(model=model), batch


def entry(device="cuda", compute_dtype: torch.dtype | None = None):
    """``(fn, (params, x_t, timesteps, batch))``: rap_12's forward on the
    flagship batch, random weights from seed 1 and noise from seed 2."""
    device = resolve_device(device)
    cfg, batch = flagship(device=device, compute_dtype=compute_dtype)
    params = init_dit_params(1, cfg.model, device=device)
    P = parts_per_sample(batch)

    def fn(params, x_t, timesteps, batch):
        return dit_forward(params, cfg.model, x_t, timesteps, batch, parts_per_sample=P)

    gen = torch.Generator(device=device).manual_seed(2)
    x_t = torch.randn(tuple(batch.points.shape), generator=gen, device=device)
    timesteps = torch.full((batch.S,), 0.5, dtype=torch.float32, device=device)
    return fn, (params, x_t, timesteps, batch)


def _dryrun_rank(n: int, device) -> dict:
    """This rank's share of the dry run in a joined world of ``n``."""
    from .parallel.mesh import make_mesh, shard_batch
    from .train.optim import OptimizerConfig
    from .train.step import TrainState, make_scanned_train_steps, make_train_step

    mesh = make_mesh(n, device)
    dev = mesh.device
    model = DiTConfig(num_layers=2, embed_dim=64, num_heads=4, local_feat_dim=8)
    cfg = RPFConfig(model=model)
    # one sample of 2 parts per rank, N = 32
    S, P, N = n, 2, 32
    batch = make_regular_synthetic_batch(0, [[N, N // 2] for _ in range(S)], N=N, P=P, S=S,
                                         feat_dim=8, device=dev)
    validate(batch)
    shard = shard_batch(batch, mesh)
    opt = OptimizerConfig(name="muon")
    params = init_dit_params(1, model, device=dev, masters=True)
    state = TrainState.create(params, opt, seed=2, device=dev)
    step = make_train_step(cfg, opt, device=dev, mesh=mesh)
    state, metrics = step(state, shard)
    loss = float(metrics["loss"])
    assert math.isfinite(loss), f"non-finite loss {loss}"
    assert int(state.step) == 1

    # sequence-parallel sampling: the global attention over the ranks' parts
    # as ring attention
    from .apps.train import serving_params

    sp = make_regular_synthetic_batch(3, [[N * n, N * n]], N=N * n, P=P * n, S=1,
                                      feat_dim=8, device=dev)
    cfg_inf = RPFConfig(model=model, inference_sampling_steps=2)
    gen = torch.Generator(device=dev).manual_seed(4)
    ring = sample(serving_params(state.params, model), cfg_inf, shard_batch(sp, mesh),
                  generator=gen, return_trajectory=False, ring_mesh=mesh)["points"]
    assert torch.isfinite(ring).all(), "non-finite ring-attention generation"

    # K train steps a call (make_scanned_train_steps), timed on its second call
    K = 4
    scanned = make_scanned_train_steps(cfg, opt, K, device=dev, mesh=mesh)
    state, losses = scanned(state, [shard] * K)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    state, losses = scanned(state, [shard] * K)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt_scan = time.perf_counter() - t0
    assert torch.isfinite(losses).all()
    assert int(state.step) == 1 + 2 * K

    # data-parallel sampling of the rank's shard
    gen = torch.Generator(device=dev).manual_seed(5)
    out = sample(serving_params(state.params, model), cfg_inf, shard, generator=gen,
                 return_trajectory=False)
    assert torch.isfinite(out["points"]).all()
    print(f"dryrun_multigpu({n}) rank {mesh.rank}: loss={loss:.4f} OK; ring-sharded "
          f"inference T={P * n * N * n} OK; scanned {K}-step train program "
          f"{dt_scan / K * 1e3:.1f} ms/step on {n} {dev.type} ranks, DP inference OK",
          flush=True)
    return {"rank": mesh.rank, "loss": loss, "losses": losses.cpu(),
            "ring_points": ring.cpu(), "dp_points": out["points"].cpu(),
            "scan_ms_per_step": dt_scan / K * 1e3}


def _spawned(rank: int, n: int, device: str, store: str) -> None:
    from .parallel.distributed import initialize

    dev = f"cuda:{rank}" if device == "cuda" else "cpu"
    if device == "cpu":
        torch.set_num_threads(1)
    initialize(init_method=f"file://{store}", world_size=n, rank=rank, device=dev,
               timeout_s=300)
    try:
        _dryrun_rank(n, dev)
    finally:
        torch.distributed.destroy_process_group()


def dryrun_multigpu(n: int, device="cuda") -> dict | None:
    """The dry run over ``n`` ranks (module docstring): this rank's results
    in a joined world, else None after the ``n`` processes it started
    passed."""
    from .parallel.distributed import is_initialized, world

    dev = resolve_device(device)
    if dev.type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"dryrun_multigpu({n}): this machine has "
                         f"{torch.cuda.device_count()} card(s)")
    if is_initialized():
        if world()[1] != n:
            raise ValueError(f"dryrun_multigpu({n}) in a world of {world()[1]}")
        return _dryrun_rank(n, device)
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="rap_dryrun_") as d:
        mp.start_processes(_spawned, args=(n, dev.type, str(Path(d) / "store")), nprocs=n,
                           join=True, start_method="spawn")
    return None


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "multigpu":
        dryrun_multigpu(int(argv[1]) if len(argv) > 1 else 2,
                        device=argv[2] if len(argv) > 2 else "cuda")
    else:
        fn, args = entry()
        out = fn(*args)
        print("entry forward:", tuple(out.shape), out.dtype)


if __name__ == "__main__":
    main()
