"""The port's checkpoints against rap_tpu's on the CPU.

- torch checkpoint conversion: ``convert_torch_state_dict`` and
  ``export_torch_state_dict`` against rap_tpu's on the same state dict, every
  array bit-exact; a ``.pth`` round trip of the committed
  ``reflow_student.npz`` through ``save_torch_checkpoint`` and
  ``apps.sample.load_params``, bit-exact against the ``.npz``;
- ``save_params_npz``: a port export read by rap_tpu's ``load_params_npz``
  and rap_tpu's export read by the port, bit-exact, and the two exports of
  the same parameters holding the same keys and bits;
- train states: the kill-safe swap and the newest-complete resolution
  (the states of tests/test_checkpoint_resume.py:69-133), and resume is
  invisible: 3 steps, save, restore into a fresh state, 3 steps give the
  losses of 6 straight steps (rtol 1e-6);
- ``resolve_checkpoint``'s path and cache branches, the checksum, the
  refusal when nothing resolves; ``load_params`` on a train state and on
  an orbax directory.
"""

import dataclasses
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rap_tpu.models import DiTConfig as JaxDiTConfig
from rap_tpu.models.dit import init_dit_params as jax_init
from rap_tpu.train import checkpoint as jck
from rap_tpu_torch.apps import sample as app
from rap_tpu_torch.config import load_config
from rap_tpu_torch.core.batch import make_regular_synthetic_batch
from rap_tpu_torch.models.config import DiTConfig
from rap_tpu_torch.models.dit import init_dit_params, master_params
from rap_tpu_torch.registration import RPFConfig
from rap_tpu_torch.train import checkpoint as tck
from rap_tpu_torch.train.optim import OptimizerConfig, tree_paths
from rap_tpu_torch.train.step import TrainState, make_train_step
from rap_tpu_torch.train.weights import resolve_checkpoint, sha256_of
from rap_tpu_torch.weights import read_npz
from torch_parity import jax_flat, params_to_torch

REPO = Path(__file__).resolve().parents[1]
STUDENT = REPO / "demo_data" / "ckpts" / "reflow_student.npz"


@pytest.fixture(scope="module")
def jparams():
    cfg = JaxDiTConfig(embed_dim=64, num_layers=2, num_heads=4, compute_dtype=jnp.float32)
    return jax.tree.map(np.asarray, jax_init(jax.random.key(3), cfg))


def _tensors(params):
    """{path: tensor} of the port's parameters, the host-side bounds left out."""
    return dict(tree_paths(master_params(params, "cpu")))


def _port_flat(params):
    return {k: v.numpy() for k, v in _tensors(params).items()}


def _bit_equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint32), b.view(np.uint32))


# --------------------------------------------------------------------------
# torch checkpoints
# --------------------------------------------------------------------------

def test_convert_and_export_match_rap_tpu_bitwise(jparams):
    sd = jck.export_torch_state_dict(jparams, 2)
    ref = jax_flat(jck.convert_torch_state_dict(sd, 2))
    got = _port_flat(tck.convert_torch_state_dict(sd, 2))
    assert set(got) == set(ref)
    for k in ref:
        assert _bit_equal(got[k], np.asarray(ref[k], np.float32)), k
    # torch tensors in, as a .ckpt holds them
    got_t = _port_flat(tck.convert_torch_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, 2))
    assert all(_bit_equal(got_t[k], got[k]) for k in got)
    exported = tck.export_torch_state_dict(params_to_torch(jparams), 2)
    assert set(exported) == set(sd)
    for k, v in sd.items():
        assert _bit_equal(exported[k], np.asarray(v, np.float32)), k


def test_strip_prefix_and_missing_weight():
    sd = {"flow_model.a": 1, "flow_model.b": 2, "other": 3}
    assert tck.strip_prefix(sd, "flow_model.") == jck.strip_prefix(sd, "flow_model.")
    assert tck.strip_prefix({"a": 1}, "flow_model.") == {"a": 1}
    with pytest.raises(KeyError):
        tck.convert_torch_state_dict({"anchor_part_emb.weight": np.zeros((2, 4))}, 1)


def test_pth_round_trip_of_the_committed_student(tmp_path):
    """reflow_student.npz -> .pth -> load_params: the same parameters as
    loading the .npz, bit for bit, through apps.sample.load_params."""
    cfg = load_config(REPO / "configs" / "synth_student.yaml",
                      ["model.compute_dtype=float32"])
    from_npz = app.load_params(cfg, "cpu")
    pth = tmp_path / "student.pth"
    tck.save_torch_checkpoint(pth, from_npz)
    assert torch.load(pth, weights_only=True)["state_dict"]  # tensors only
    from_pth = app.load_params(dataclasses.replace(cfg, checkpoint=str(pth)), "cpu")
    a, b = _tensors(from_npz), _tensors(from_pth)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for lp, lq in zip(from_npz["layers"], from_pth["layers"]):
        assert lp["self_bound2"] == lq["self_bound2"]
    flat = read_npz(STUDENT)
    assert torch.equal(b["layers/3/global_qkv/kernel"],
                       torch.from_numpy(flat["layers/global_qkv/kernel"][3]))
    with pytest.raises(ValueError, match="layers"):
        app.load_params(dataclasses.replace(
            cfg, checkpoint=str(pth), model=dataclasses.replace(cfg.model, num_layers=4)), "cpu")


# --------------------------------------------------------------------------
# rap_tpu's npz export
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_params_npz_both_ways(tmp_path, jparams, dtype):
    tparams = params_to_torch(jparams)
    port_npz, jax_npz = tmp_path / "port.npz", tmp_path / "jax.npz"
    tck.save_params_npz(port_npz, tparams, dtype=getattr(torch, dtype))
    jck.save_params_npz(jax_npz, jparams, dtype=getattr(jnp, dtype))
    with np.load(port_npz) as a, np.load(jax_npz) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    # rap_tpu reads the port's export into its own tree
    loaded = jck.load_params_npz(port_npz, jax.tree.map(jnp.asarray, jparams))
    ref = jax.tree.map(lambda x: np.asarray(jnp.asarray(x).astype(getattr(jnp, dtype))),
                       jparams)
    for k, v in jax_flat(loaded).items():
        assert np.array_equal(np.asarray(v, np.float32), np.asarray(jax_flat(ref)[k], np.float32)), k
    # the port reads rap_tpu's export
    got = read_npz(jax_npz)
    for k, v in jck.load_params_npz(jax_npz).items():
        assert np.array_equal(got[k], np.asarray(v, np.float32)), k


# --------------------------------------------------------------------------
# train states
# --------------------------------------------------------------------------

def _setup(param_seed=1, gen_seed=2):
    model = DiTConfig(num_layers=2, embed_dim=64, num_heads=4, local_feat_dim=8,
                      compute_dtype=torch.float32)
    batch = make_regular_synthetic_batch(0, [[32, 24]], N=32, P=2, S=1, feat_dim=8,
                                         device="cpu")
    opt = OptimizerConfig(name="muon")
    state = TrainState.create(init_dit_params(param_seed, model, device="cpu", masters=True),
                              opt, seed=gen_seed, device="cpu")
    return state, make_train_step(RPFConfig(model=model), opt, device="cpu"), batch


def test_resume_is_invisible(tmp_path):
    state, step, batch = _setup()
    ref = []
    for _ in range(6):
        state, m = step(state, batch)
        ref.append(float(m["loss"]))
    state2, step2, batch2 = _setup()
    for _ in range(3):
        state2, _ = step2(state2, batch2)
    nbytes = tck.save_checkpoint(tmp_path / "ckpt", state2, {"epoch": 7, "note": "mid"})
    assert nbytes == (tmp_path / "ckpt" / tck.STATE_FILE).stat().st_size > 0
    fresh, _, _ = _setup(param_seed=99, gen_seed=123)
    restored = tck.restore_checkpoint(tmp_path / "ckpt", fresh)
    assert int(restored.step) == 3 and tck.load_metadata(tmp_path / "ckpt")["epoch"] == 7
    saved = tck.train_state_tensors(state2)
    for k, v in tck.train_state_tensors(restored).items():
        assert torch.equal(v, saved[k]), k
    resumed = []
    for _ in range(3):
        restored, m = step2(restored, batch2)
        resumed.append(float(m["loss"]))
    np.testing.assert_allclose(resumed, ref[3:], rtol=1e-6)


def test_kill_safe_save_swap(tmp_path):
    """Each reachable kill state of the swap leaves a restorable resume point."""
    state, step, batch = _setup()
    target, _, _ = _setup()
    last = tmp_path / "last"
    tck.save_checkpoint(last, state, {"steps": 1})
    s2, _ = step(state, batch)
    tck.save_checkpoint(last, s2, {"steps": 2})
    assert tck.load_metadata(last)["steps"] == 2
    assert not (tmp_path / "last.new").exists() and not (tmp_path / "last.old").exists()

    # kill between "path -> old" and "tmp -> path": only .new exists
    last.rename(tmp_path / "last.new")
    assert tck.resolve_checkpoint_dir(last).name == "last.new"
    assert tck.load_metadata(last)["steps"] == 2
    assert int(tck.restore_checkpoint(last, target).step) == 1

    # kill during the .new save itself (no commit marker): path wins
    (tmp_path / "last.new").rename(last)
    (tmp_path / "last.new").mkdir()
    assert tck.resolve_checkpoint_dir(last).name == "last"

    # kill after "path -> old", tmp incomplete: fall back to .old
    shutil.rmtree(tmp_path / "last.new")
    last.rename(tmp_path / "last.old")
    assert tck.resolve_checkpoint_dir(last).name == "last.old"
    assert tck.load_metadata(last)["steps"] == 2
    assert int(tck.restore_checkpoint(last, target).step) == 1


def test_complete_new_beats_stale_path(tmp_path):
    state, step, batch = _setup()
    target, _, _ = _setup()
    last = tmp_path / "last"
    tck.save_checkpoint(last, state, {"steps": 1})
    s2, _ = step(state, batch)
    tck.save_checkpoint(tmp_path / "stage", s2, {"steps": 2})
    (tmp_path / "stage").rename(tmp_path / "last.new")
    assert tck.resolve_checkpoint_dir(last).name == "last.new"
    assert tck.load_metadata(last)["steps"] == 2
    assert int(tck.restore_checkpoint(last, target).step) == 1


def test_restore_refuses_a_mismatched_target(tmp_path):
    state, _, _ = _setup()
    tck.save_checkpoint(tmp_path / "c", state)
    other = TrainState.create(
        init_dit_params(0, DiTConfig(num_layers=2, embed_dim=128, num_heads=4,
                                     local_feat_dim=8), device="cpu", masters=True),
        OptimizerConfig(), seed=0, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tck.restore_checkpoint(tmp_path / "c", other)
    with pytest.raises(FileNotFoundError):
        tck.restore_checkpoint(tmp_path / "nothing", state)


def test_load_params_reads_a_train_state_and_refuses_orbax(tmp_path):
    state, _, _ = _setup()
    tck.save_checkpoint(tmp_path / "run" / "last", state, {"epoch": 1})
    cfg = load_config(None, ["model.num_layers=2", "model.embed_dim=64", "model.num_heads=4",
                             "model.local_feat_dim=8", "model.compute_dtype=float32",
                             f"checkpoint={tmp_path / 'run' / 'last'}"])
    params = app.load_params(cfg, "cpu")
    ref = dict(tree_paths(state.params))
    got = _tensors(params)
    assert set(got) == set(ref)
    for k, v in got.items():
        assert torch.equal(v, ref[k]), k
    orbax = tmp_path / "orbax_dir"
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(NotImplementedError, match="orbax"):
        app.load_params(dataclasses.replace(cfg, checkpoint=str(orbax)), "cpu")


# --------------------------------------------------------------------------
# resolve_checkpoint
# --------------------------------------------------------------------------

def test_resolve_checkpoint_path_and_cache(tmp_path, monkeypatch):
    f = tmp_path / "model.ckpt"
    f.write_bytes(b"weights")
    assert resolve_checkpoint(str(f)) == f
    digest = sha256_of(f)
    assert resolve_checkpoint(str(f), sha256=digest) == f
    with pytest.raises(ValueError, match="checksum"):
        resolve_checkpoint(str(f), sha256="0" * 64)
    cache = tmp_path / "cache"
    (cache / "nested").mkdir(parents=True)
    hit = cache / "nested" / "rap_model_12.ckpt"
    hit.write_bytes(b"x")
    assert resolve_checkpoint("rap_model_12.ckpt", cache_dir=cache) == hit
    monkeypatch.setenv("RAP_TPU_CACHE", str(cache))
    assert resolve_checkpoint("somewhere/rap_model_12.ckpt") == hit
    with pytest.raises(FileNotFoundError, match="cache"):
        resolve_checkpoint("rap_model_10.ckpt")
    with pytest.raises(ValueError):
        resolve_checkpoint("")
