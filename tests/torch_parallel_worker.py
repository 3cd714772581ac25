"""One rank of a gloo world on the CPU, spawned by the port's multi-process
tests (tests/test_torch_parallel.py, test_torch_trainer.py,
test_torch_demo.py, test_torch_graft_entry.py). Imports no jax.

    python tests/torch_parallel_worker.py <rank> <world> <workdir>

Joins the world through ``rap_tpu_torch.parallel.initialize`` on a file
store in ``workdir``, reads the task list ``workdir/spec.pt`` (written by
the test), runs each task present in it and writes its results to
``workdir/out_<rank>.pt``.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from rap_tpu_torch.parallel import initialize, make_mesh, shard_batch  # noqa: E402


def ring(spec, mesh):
    """Each case's local output and the local gradients of sum(out**2)."""
    from rap_tpu_torch.ops.ring_attention import ring_attention

    out = {}
    for name, c in spec.items():
        per = c["q"].shape[1] // mesh.size
        sl = slice(mesh.rank * per, (mesh.rank + 1) * per)
        q, k, v = (torch.from_numpy(c[x][:, sl].copy()).requires_grad_(True) for x in "qkv")
        o = ring_attention(q, k, v, torch.from_numpy(c["mask"][:, sl].copy()), mesh,
                           softcap=c["softcap"])
        (o ** 2).sum().backward()
        out[name] = {"out": o.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}
    return out


def dit(spec, mesh):
    """dit_forward on the rank's parts with the ring: its local velocity,
    and the gradient of the global sum(v**2) w.r.t. the rank's x with and
    without remat (the ring's hop recomputed under torch.utils.checkpoint)."""
    from rap_tpu_torch.models.dit import dit_forward

    shard = shard_batch(spec["batch"], mesh)
    lo = mesh.rank * shard.G
    out = {}
    for remat in (False, True):
        x = spec["x"][lo:lo + shard.G].clone().requires_grad_(True)
        v = dit_forward(spec["params"], spec["cfg"], x, spec["t"], shard,
                        parts_per_sample=shard.G, ring_mesh=mesh, remat=remat)
        (v ** 2).sum().backward()
        out["remat" if remat else "v"], out[f"dx_{remat}"] = v.detach(), x.grad
    return out


def sample(spec, mesh):
    """registration.sample over the ring for each run config: the global
    outputs."""
    from rap_tpu_torch.registration import sample as run

    shard = shard_batch(spec["batch"], mesh)
    return {name: run(spec["params"], cfg, shard, x_1=spec["x_1"], ring_mesh=mesh, **kw)
            for name, (cfg, kw) in spec["runs"].items()}


def train(spec, mesh):
    """Data-parallel steps on the rank's shard: each step's metrics and the
    parameters after it; with ``draws``, the given global (t, x_1), else
    the state's generator."""
    from rap_tpu_torch.train.optim import tree_paths
    from rap_tpu_torch.train.step import TrainState, make_train_step

    shard = shard_batch(spec["batch"], mesh)
    state = TrainState.create(spec["params"], spec["opt"], seed=spec["seed"], device="cpu")
    step = make_train_step(spec["cfg"], spec["opt"], device="cpu", mesh=mesh)
    out = []
    for draw in spec["draws"]:
        state, m = step(state, shard, **draw)
        out.append({"metrics": {k: float(v) for k, v in m.items()},
                    "params": {k: v.clone() for k, v in tree_paths(state.params)}})
    return out


def meter(spec, mesh):
    """This rank's adds, then the reduction."""
    from rap_tpu_torch.eval.meter import MetricsMeter

    mm = MetricsMeter()
    for args in spec["adds"][mesh.rank]:
        mm.add_metrics(*args)
    mm.reduce_across_hosts(spec["registry"])
    return {"average": mm.compute_average(), "samples": mm.get_sample_counts(),
            "part_ranges": mm.get_part_count_ranges()}


def checkpoint(spec, mesh):
    """Every rank saves (rank 0 writes), every rank restores."""
    from rap_tpu_torch.train.checkpoint import (restore_checkpoint, save_checkpoint,
                                                train_state_tensors)
    from rap_tpu_torch.train.step import TrainState

    state = TrainState.create(spec["params"], spec["opt"], seed=3, device="cpu")
    nbytes = save_checkpoint(spec["path"], state, {"epoch": 1, "monitor": 0.5})
    blank = TrainState.create(spec["params"], spec["opt"], seed=4, device="cpu")
    got = train_state_tensors(restore_checkpoint(spec["path"], blank))
    ref = train_state_tensors(state)
    return {"bytes": nbytes, "equal": set(got) == set(ref)
            and all(torch.equal(got[k], ref[k]) for k in ref)}


def train_app(spec, mesh):
    """apps.train.main with the rank's command line: its record."""
    from rap_tpu_torch.apps import train as app
    from rap_tpu_torch.train.optim import tree_paths

    runs = []
    for argv in spec[mesh.rank]:
        rec = {}
        state = app.main(argv, record=rec)
        runs.append({"step": int(state.step), "metrics": rec["metrics"],
                     "val_results": rec["val_results"], "saves": rec["saves"],
                     "best_monitor_start": rec["best_monitor_start"],
                     "params": dict(tree_paths(state.params)), "params_tree": state.params})
    return runs


def demo_app(spec, mesh):
    """apps.demo.main with --sequence-sharded: its exit code and record."""
    from rap_tpu_torch.apps import demo

    rec = {}
    rc = demo.main(spec["argv"], noise=spec.get("noise"), record=rec)
    return {"rc": rc, "transforms": rec["transforms"], "shard_parts": rec["shard"].G,
            "generations": [tuple(a for a in g[:3]) for g in rec["generations"]]}


def graft(spec, mesh):
    """rap_tpu_torch.graft_entry.dryrun_multigpu in the joined world."""
    from rap_tpu_torch.graft_entry import dryrun_multigpu

    return dryrun_multigpu(mesh.size, device="cpu")


TASKS = {"graft": graft, "ring": ring, "dit": dit, "sample": sample, "train": train, "meter": meter,
         "checkpoint": checkpoint, "train_app": train_app, "demo_app": demo_app}


def main() -> None:
    rank, world, workdir = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
    torch.set_num_threads(1)
    initialize(init_method=f"file://{workdir / 'store'}", world_size=world, rank=rank,
               device="cpu", timeout_s=120)
    spec = torch.load(workdir / "spec.pt", weights_only=False)  # written by the test
    mesh = make_mesh(world, "cpu")
    out = {name: TASKS[name](spec[name], mesh) for name in spec}
    torch.save(out, workdir / f"out_{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
