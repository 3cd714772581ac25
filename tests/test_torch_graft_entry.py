"""The port's entry points of rap_tpu_torch/graft_entry.py against
``__graft_entry__.py`` on the CPU.

- ``entry()``: rap_12's forward on the flagship batch (1 sample, parts of
  512 and 505 points in slots of 512). With rap_tpu's parameters, batch,
  noise and timesteps carried across, the port's ``fn`` matches rap_tpu's
  ``dit_forward`` at fp32 (both entries' configuration with the compute
  dtype set to fp32) within 1e-4 of the largest element; the port's own
  args have the flagship's shapes.
- ``dryrun_multigpu(2, device="cpu")`` on two gloo ranks
  (tests/torch_parallel_worker.py through ``torch_parity.run_world``):
  the data-parallel step, the ring-sharded sampling and the scanned steps
  pass, and both ranks hold the same global loss and ring output.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as J
from rap_tpu.models.dit import dit_forward as jax_dit_forward
from rap_tpu.models.dit import init_dit_params as jax_init
from rap_tpu_torch import graft_entry as T
from torch_parity import batch_to_torch, max_err, params_to_torch, run_world, t


def test_entry_forward_matches_rap_tpus():
    fn, (params, x_t, ts, batch) = T.entry(device="cpu", compute_dtype=torch.float32)
    assert tuple(x_t.shape) == (2, 512, 3) and tuple(ts.shape) == (1,)
    assert batch.point_mask.sum(1).tolist() == [512, 505]
    assert len(params["layers"]) == 12 and params["anchor_emb"].shape[-1] == 512

    cfg, jbatch = J._flagship()
    jcfg = dataclasses.replace(cfg.model, compute_dtype=jnp.float32)
    jp = jax.jit(jax_init, static_argnums=1)(jax.random.key(1), jcfg)  # eager: ~2x slower
    jx = jax.random.normal(jax.random.key(2), jbatch.points.shape)
    jt = jnp.full((jbatch.S,), 0.5, jnp.float32)
    ref = jax.jit(lambda p, x: jax_dit_forward(p, jcfg, x, jt, jbatch, parts_per_sample=2))(
        jp, jx)
    got = fn(params_to_torch(jp), t(jx), t(jt), batch_to_torch(jbatch))
    assert got.shape == ref.shape == (2, 512, 3)
    scale = float(jnp.abs(ref).max())
    assert max_err(got.detach().numpy(), ref) <= 1e-4 * scale
    # the port's own draws run too
    assert torch.isfinite(fn(params, x_t, ts, batch)).all()


def test_dryrun_multigpu_on_two_gloo_ranks(tmp_path):
    outs = [o["graft"] for o in run_world({"graft": {}}, 2, tmp_path)]
    assert [o["rank"] for o in outs] == [0, 1]
    assert np.isfinite(outs[0]["loss"]) and outs[0]["loss"] == outs[1]["loss"]
    assert torch.equal(outs[0]["losses"], outs[1]["losses"]) and len(outs[0]["losses"]) == 4
    assert torch.equal(outs[0]["ring_points"], outs[1]["ring_points"])
    assert torch.isfinite(outs[0]["dp_points"]).all()


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.dryrun_multigpu(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.main([])
