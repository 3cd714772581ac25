"""The port's serving slice against rap_tpu on the CPU, same inputs and noise.

Two cases, fp32 (compute_dtype float32 on both sides):
  - a tiny 2-layer config (D=128, H=2) through rap_tpu's fused Pallas path in
    interpret mode, with qk gains on both sides of the attention guard;
  - the committed teacher3_last.npz (6 layers, D=512) at N=128 through
    rap_tpu's dense path, which carries the real weights across.
``dit_forward``, and ``sample`` + ``predict_poses`` on the same x_1 (2 Euler
steps, rigidity forcing), must agree within the stated tolerances.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rap_tpu.core.batch import make_regular_synthetic_batch as jax_batch
from rap_tpu.models import DiTConfig as JaxDiTConfig
from rap_tpu.models.dit import dit_forward as jax_dit_forward
from rap_tpu.models.dit import init_dit_params
from rap_tpu.registration import RPFConfig as JaxRPFConfig
from rap_tpu.registration import predict_poses as jax_predict_poses
from rap_tpu.registration import sample as jax_sample
from rap_tpu.train.checkpoint import load_params_npz as jax_load_npz
from rap_tpu_torch.core.batch import make_regular_synthetic_batch
from rap_tpu_torch.models.config import DiTConfig
from rap_tpu_torch.models.dit import dit_forward
from rap_tpu_torch.ops.flash_attention import SAFE_BOUND2
from rap_tpu_torch.registration import RPFConfig, predict_poses, sample
from rap_tpu_torch.weights import load_params_npz
from torch_parity import batch_to_torch, max_err, params_to_torch, t

REPO = Path(__file__).resolve().parents[1]
TEACHER3 = REPO / "demo_data" / "ckpts" / "teacher3_last.npz"
S, P = 2, 2


def _tiny():
    jcfg = JaxDiTConfig(embed_dim=128, num_layers=2, num_heads=2,
                        compute_dtype=jnp.float32, attn_impl="pallas",
                        ff_impl="pallas")
    tcfg = DiTConfig(embed_dim=128, num_layers=2, num_heads=2,
                     compute_dtype=torch.float32, attn_impl="pallas", ff_impl="pallas")
    jp = init_dit_params(jax.random.key(1), jcfg)
    rng = np.random.default_rng(0)
    layers = dict(jp["layers"])
    H, dh = 2, 64
    for name in ("self_q_gamma", "self_k_gamma", "global_q_gamma", "global_k_gamma"):
        layers[name] = jnp.asarray(1 + 0.1 * rng.standard_normal((2, H, dh)), jnp.float32)
    # layer 0's global attention over the guard bound: the online kernel
    layers["global_q_gamma"] = layers["global_q_gamma"].at[0].multiply(3.0)
    layers["global_k_gamma"] = layers["global_k_gamma"].at[0].multiply(3.0)
    jp = {**jp, "layers": layers}
    return jcfg, tcfg, jp, params_to_torch(jp)


def _teacher3():
    jcfg = JaxDiTConfig(num_layers=6, compute_dtype=jnp.float32)
    tcfg = DiTConfig(num_layers=6, compute_dtype=torch.float32)
    jp = jax_load_npz(TEACHER3, init_dit_params(jax.random.key(0), jcfg))
    tp = load_params_npz(TEACHER3, device="cpu", compute_dtype=torch.float32)
    return jcfg, tcfg, jp, tp


CASES = {
    # (model, N, velocity rtol, points/pose atol)
    "tiny_pallas": (_tiny, 128, 1e-5, 1e-4),
    # real weights: logits up to ~4000 natural units (bound2 5650), so fp32
    # rounding of q.k moves the softmax by ~1e-4 relative
    "teacher3_n128": (_teacher3, 128, 1e-4, 1e-3),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    make, N, rtol, atol = CASES[request.param]
    jcfg, tcfg, jp, tp = make()
    jb = jax_batch(jax.random.key(0), [[N] * P] * S, N=N, P=P, S=S,
                   feat_dim=jcfg.local_feat_dim)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((S * P, N, 3)).astype(np.float32)
    return dict(name=request.param, jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, jb=jb,
                tb=batch_to_torch(jb), x=x, rtol=rtol, atol=atol)


def test_guard_sides(case):
    bounds = [b for lp in case["tp"]["layers"] for b in (lp["self_bound2"], lp["global_bound2"])]
    assert any(b <= SAFE_BOUND2 for b in bounds)
    assert any(b > SAFE_BOUND2 for b in bounds)


def test_dit_forward_matches_jax(case):
    ts = np.array([0.3, 0.9], np.float32)
    ref = np.asarray(jax_dit_forward(case["jp"], case["jcfg"], jnp.asarray(case["x"]),
                                     jnp.asarray(ts), case["jb"], parts_per_sample=P))
    got = dit_forward(case["tp"], case["tcfg"], t(case["x"]), t(ts), case["tb"], P)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    assert max_err(got.numpy(), ref) <= case["rtol"] * np.abs(ref).max()


def test_sample_and_poses_match_jax(case):
    x_1 = np.random.default_rng(12).standard_normal(case["x"].shape).astype(np.float32)
    jr = JaxRPFConfig(model=case["jcfg"], inference_sampling_steps=2, rigidity_forcing=True)
    tr = RPFConfig(model=case["tcfg"], inference_sampling_steps=2, rigidity_forcing=True)
    jo = jax_sample(case["jp"], jr, case["jb"], jax.random.key(3), x_1=jnp.asarray(x_1),
                    return_trajectory=True)
    jR, jt = jax_predict_poses(case["jb"], jo["points"])
    to = sample(case["tp"], tr, case["tb"], x_1=t(x_1), return_trajectory=True)
    tR, tt = predict_poses(case["tb"], to["points"])
    atol = case["atol"]
    assert max_err(to["points"].numpy(), jo["points"]) <= atol
    assert max_err(to["end_point_trajectory"].numpy(), jo["end_point_trajectory"]) <= atol
    assert max_err(to["trajectory"].numpy(), jo["trajectory"]) <= atol
    assert max_err(tR.numpy(), jR) <= atol
    assert max_err(tt.numpy(), jt) <= atol


def test_padded_batch_is_refused():
    """Padded batches were refused until the masked branch was ported; now
    such a batch (one part of 100 of 128 points) runs the masked branch and
    agrees with rap_tpu's (fp32, 1e-5 of the largest velocity)."""
    jcfg, tcfg, jp, tp = _tiny()
    jb = jax_batch(jax.random.key(2), [[128, 100], [128, 128]], N=128, P=P, S=S,
                   feat_dim=jcfg.local_feat_dim)
    tb = batch_to_torch(jb)
    assert not tb.no_padding
    x = np.random.default_rng(4).standard_normal((S * P, 128, 3)).astype(np.float32)
    ts = np.array([0.4, 0.8], np.float32)
    ref = np.asarray(jax_dit_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(ts), jb,
                                     parts_per_sample=P))
    got = dit_forward(tp, tcfg, t(x), t(ts), tb, P)
    assert max_err(got.numpy(), ref) <= 1e-5 * np.abs(ref).max()


def test_pruned_sampler_is_refused():
    """The port refuses the pruned sampler only where rap_tpu would run it:
    prune_coarse_steps > 0 with rigidity forcing and no trajectory."""
    _, tcfg, _, tp = _tiny()
    b = make_regular_synthetic_batch(0, [[128, 128]], N=128, P=P,
                                     feat_dim=tcfg.local_feat_dim, device="cpu")
    cfg = RPFConfig(model=tcfg, prune_coarse_steps=1, inference_sampling_steps=2)
    with pytest.raises(NotImplementedError, match="pruned"):
        sample(tp, cfg, b, generator=torch.Generator().manual_seed(0),
               return_trajectory=False)


@pytest.mark.parametrize("why", ["trajectory", "one_step", "no_forcing"])
def test_unpruned_sampler_fallback_matches_jax(why):
    """Where rap_tpu does not prune despite prune_coarse_steps > 0 (a
    trajectory is returned, a single step, or no rigidity forcing), it runs
    the plain sampler; so does the port, on the same noise (1e-4 abs)."""
    jcfg, tcfg, jp, tp = _tiny()
    steps, forcing, traj = {"trajectory": (2, True, True), "one_step": (1, True, False),
                            "no_forcing": (2, False, False)}[why]
    jb = jax_batch(jax.random.key(0), [[128] * P], N=128, P=P, S=1,
                   feat_dim=jcfg.local_feat_dim)
    x_1 = np.random.default_rng(13).standard_normal((P, 128, 3)).astype(np.float32)
    jr = JaxRPFConfig(model=jcfg, inference_sampling_steps=steps, rigidity_forcing=forcing,
                      prune_coarse_steps=1)
    tr = RPFConfig(model=tcfg, inference_sampling_steps=steps, rigidity_forcing=forcing,
                   prune_coarse_steps=1)
    jo = jax_sample(jp, jr, jb, jax.random.key(3), x_1=jnp.asarray(x_1),
                    return_trajectory=traj)
    to = sample(tp, tr, batch_to_torch(jb), x_1=t(x_1), return_trajectory=traj)
    assert max_err(to["points"].numpy(), jo["points"]) <= 1e-4
    assert ("trajectory" in to) == ("trajectory" in jo) == traj


def test_port_batch_generator_is_regular_and_valid():
    from rap_tpu_torch.core.batch import validate

    b = make_regular_synthetic_batch(5, [[64, 32], [64, 64]], N=64, P=P, device="cpu")
    validate(b)
    assert b.sample_of_part.tolist() == [0, 0, 1, 1]
    # labels: points @ R^T + t == points_gt on every valid point
    posed = torch.einsum("gij,gnj->gni", b.rotations_gt, b.points) + b.translations_gt[:, None]
    err = ((posed - b.points_gt) * b.point_mask[..., None]).abs().max()
    assert float(err) < 1e-5
    assert torch.allclose(torch.linalg.det(b.rotations_gt), torch.ones(4), atol=1e-5)
