"""The benchmark's plain reference against rap_tpu at float32 on tiny
inputs, on the CPU: the DiT forward on a dense and a padded batch, the
sampler with rigidity forcing and the pose fit, the training loss and its
gradient, and one optimizer step. Only this test imports JAX; the
reference itself imports neither it nor the port.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.reference import dit as ref_dit  # noqa: E402
from benchmark.reference import sampler as ref_sampler  # noqa: E402
from benchmark.reference import train as ref_train  # noqa: E402
from rap_tpu import registration as jreg  # noqa: E402
from rap_tpu.core import flow as jflow  # noqa: E402
from rap_tpu.core import procrustes as jproc  # noqa: E402
from rap_tpu.core.batch import make_regular_synthetic_batch  # noqa: E402
from rap_tpu.models import DiTConfig  # noqa: E402
from rap_tpu.models.dit import dit_forward, init_dit_params  # noqa: E402
from rap_tpu.train import optim as joptim  # noqa: E402
from rap_tpu_torch.weights import params_from_jax  # noqa: E402

D, H, L = 64, 2, 2
MODEL = {"embed_dim": D, "num_layers": L, "num_heads": H, "ff_hidden": 4 * D,
         "time_embed_channels": 256, "local_feat_dim": 32, "multires": 10,
         "scale_emb_on": True, "qk_norm": True}
TOL = 1e-4


def _models(seed: int = 3):
    cfg = DiTConfig(embed_dim=D, num_layers=L, num_heads=H, compute_dtype=jnp.float32,
                    attn_impl="dense", ff_impl="xla")
    jp = init_dit_params(jax.random.key(seed), cfg)
    rng = np.random.default_rng(seed)
    layers = dict(jp["layers"])
    for name in ("self_q_gamma", "self_k_gamma", "global_q_gamma", "global_k_gamma"):
        layers[name] = jnp.asarray(1 + 0.2 * rng.standard_normal(layers[name].shape), jnp.float32)
    jp = {**jp, "layers": layers}
    return cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _batch(sizes, N: int, P: int, seed: int = 5):
    jb = make_regular_synthetic_batch(jax.random.key(seed), sizes, N=N, P=P)
    tb = {f: torch.from_numpy(np.array(getattr(jb, f))) for f in
          ("points", "points_gt", "local_feats", "point_mask", "anchor_part", "scale")}
    tb["parts_per_sample"] = P
    return jb, tb


def _rel(a, b, mask) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    m = np.asarray(mask)[..., None]
    return float(np.abs((a - b) * m).max() / max(np.abs(b * m).max(), 1e-12))


@pytest.mark.parametrize("sizes", [[[64, 64], [64, 64]], [[50, 64], [30, 0]]],
                         ids=["dense", "padded"])
def test_forward_matches_rap_tpu(sizes):
    cfg, jp, tp = _models()
    sizes = [[n for n in s if n] for s in sizes]
    jb, tb = _batch(sizes, N=64, P=2)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 64, 3)).astype(np.float32)
    t = np.array([0.3, 0.8], np.float32)
    want = dit_forward(jp, cfg, jnp.asarray(x), jnp.asarray(t), jb, 2)
    got = ref_dit.forward(tp, MODEL, torch.from_numpy(x), torch.from_numpy(t), tb)
    assert _rel(got.numpy(), want, jb.point_mask) < TOL


def test_sampler_and_poses_match_rap_tpu():
    cfg, jp, tp = _models()
    jb, tb = _batch([[64, 64], [64, 64]], N=64, P=2)
    x_1 = np.random.default_rng(2).standard_normal((4, 64, 3)).astype(np.float32)
    rcfg = jreg.RPFConfig(model=cfg, inference_sampling_steps=3, rigidity_forcing=True)
    want = jreg.sample(jp, rcfg, jb, jax.random.key(0), x_1=jnp.asarray(x_1),
                       return_trajectory=False)["points"]
    R_want, t_want = jproc.fit_transformations(jb.points, want, jb.point_mask)
    pts, R, t = ref_sampler.sample(tp, MODEL, tb, torch.from_numpy(x_1), 3)
    assert _rel(pts.numpy(), want, jb.point_mask) < TOL
    assert float(np.abs(R.numpy() - np.asarray(R_want)).max()) < TOL
    assert float(np.abs(t.numpy() - np.asarray(t_want)).max()) < TOL * float(np.abs(want).max())


def test_loss_gradient_and_optimizer_step_match_rap_tpu():
    cfg, jp, tp = _models()
    jb, tb = _batch([[50, 64], [30]], N=64, P=2)
    rng = np.random.default_rng(4)
    x_1 = rng.standard_normal((4, 64, 3)).astype(np.float32)
    t = np.array([0.2, 0.7], np.float32)

    def jloss(params):
        tp_ = jnp.asarray(t)[jb.sample_of_part][:, None, None]
        x_t, v_t = jflow.flow_interpolate(jb.points_gt, jnp.asarray(x_1), tp_)
        v = dit_forward(params, cfg, x_t, jnp.asarray(t), jb, 2)
        return (jflow.velocity_loss(v, v_t, jb.point_mask, "mse"),
                jflow.velocity_norms(v, v_t, jb.point_mask)[0])

    (want, v_want), jgrad = jax.value_and_grad(jloss, has_aux=True)(jp)
    leaves = {k: v.clone().requires_grad_(True) for k, v in ref_train.paths(tp)}
    got, vnorm = ref_train.loss(ref_train.rebuild(tp, leaves), MODEL, tb, torch.from_numpy(t),
                                torch.from_numpy(x_1))
    grads = dict(zip(leaves, torch.autograd.grad(got, list(leaves.values()))))
    assert abs(float(got.detach()) - float(want)) < TOL * abs(float(want))
    assert abs(float(vnorm) - float(v_want)) < TOL * abs(float(v_want))
    jg = dict(ref_train.paths(params_from_jax(jax.tree.map(np.asarray, jgrad))))
    for k, g in grads.items():
        assert float((g - jg[k]).norm()) <= TOL * max(float(jg[k].norm()), 1e-6), k

    ocfg = joptim.OptimizerConfig()
    tx = joptim.build_optimizer(ocfg)
    upd, _ = tx.update(jgrad, tx.init(jp), jp)
    jnew = dict(ref_train.paths(params_from_jax(jax.tree.map(
        np.asarray, jax.tree.map(lambda p, u: p + u, jp, upd)))))
    rcfg = ref_train.OptimizerConfig(
        lr=ocfg.lr, muon_lr_mult=ocfg.muon_lr_mult, muon_weight_decay=ocfg.muon_weight_decay,
        muon_wd_mult=ocfg.muon_wd_mult, muon_momentum=ocfg.muon_momentum,
        muon_betas=tuple(ocfg.muon_betas), eps=ocfg.eps, grad_clip=ocfg.grad_clip)
    flat = {k: v.detach() for k, v in leaves.items()}
    new = ref_train.optimizer_step(flat, ref_train.clip(jg, ocfg.grad_clip), {}, rcfg)
    for k, v in new.items():
        step = float((jnew[k] - flat[k]).norm())
        assert float((v - jnew[k]).norm()) <= 1e-3 * max(step, 1e-9), k
