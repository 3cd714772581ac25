"""The port's MiniSpinNet (rap_tpu_torch/spinnet) against rap_tpu's on the
CPU: the grid constants (equal), the forward with and without the local
reference frame, patch extraction (equal) and chunked feature extraction
(1e-5), on rap_tpu's random weights carried over by
``spinnet_params_from_jax``, and a checkpoint in the reference's layout
(``Desc.`` prefix) loaded by both packages. Patches hold 64 points to keep
the tests small.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rap_tpu.spinnet import model as J
from rap_tpu_torch.spinnet import model as T
from rap_tpu_torch.weights import spinnet_params_from_jax
from torch_parity import max_err, t

K = 64


def _nets(aligned: bool = True, seed: int = 0):
    """rap_tpu's random weights (key 0: its pooling gate stays open on these
    scenes; keys 1-5 close it on every cell, and every descriptor is 0) and
    the port's module carrying them."""
    jcfg = J.SpinNetConfig(num_points_per_patch=K, is_aligned_to_global_z=aligned)
    tcfg = T.SpinNetConfig(num_points_per_patch=K, is_aligned_to_global_z=aligned)
    jp = J.init_spinnet_params(jax.random.key(seed), jcfg)
    net = T.MiniSpinNet(tcfg)
    net.load_state_dict(spinnet_params_from_jax(jax.tree.map(np.asarray, jp)))
    return jcfg, jp, net


def _scene(seed: int = 0, n: int = 500):
    pts = np.random.default_rng(seed).uniform(-2, 2, (n, 3)).astype(np.float32)
    return pts, pts[::10].copy()


def test_constants_are_equal():
    cfg = J.SpinNetConfig()
    assert np.array_equal(T.voxel_grid_coordinates(T.SpinNetConfig()),
                          J.voxel_grid_coordinates(cfg))
    assert np.array_equal(T.azimuth_rotations(T.SpinNetConfig()), J.azimuth_rotations(cfg))
    assert T.SpinNetConfig().n_cells == cfg.n_cells == 420
    assert dataclasses.asdict(T.SpinNetConfig()) == dataclasses.asdict(cfg)


def test_state_dict_has_the_reference_names():
    names = set(T.MiniSpinNet().state_dict())
    assert {"pnt_layer.0.weight", "pnt_layer.1.running_var", "conv_net.ops.0.weight",
            "conv_net.ops.1.running_mean", "conv_net.ops.21.bias", "pool_layer.3.weight",
            "pool_layer.4.bias"} <= names
    assert not any(n.startswith("conv_net.ops.22") for n in names)


def test_extract_patches_is_equal():
    pts, kps = _scene(1)
    mask = np.random.default_rng(2).random(len(pts)) < 0.9
    ref = J.extract_patches(jnp.asarray(pts), jnp.asarray(kps), 0.6, K, mask=jnp.asarray(mask))
    got = T.extract_patches(t(pts), t(kps), 0.6, K, mask=t(mask))
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert np.array_equal(got[:, -1].numpy(), kps)


@pytest.mark.parametrize("aligned", [True, False])
def test_forward_matches(aligned):
    jcfg, jp, net = _nets(aligned)
    pts, kps = _scene(3)
    patches = J.extract_patches(jnp.asarray(pts), jnp.asarray(kps), 1.2, K)
    ref = np.asarray(J.spinnet_forward(jp, dataclasses.replace(jcfg, des_r=1.2), patches))
    got = net(t(np.asarray(patches)), 1.2).numpy()
    assert got.shape == ref.shape == (len(kps), 32)
    assert max_err(got, ref) <= 1e-5
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("aligned", [True, False])
def test_extract_features_matches(aligned):
    """Chunked keypoints over the whole cloud (rap_tpu pads both to buckets;
    the port does not need to)."""
    jcfg, jp, net = _nets(aligned)
    pts, kps = _scene(4, 700)
    ref = J.extract_features(jp, jcfg, pts, kps, 1.0, chunk=16)
    got = T.extract_features(net, pts, kps, 1.0, chunk=16)
    assert got.dtype == np.float32 and got.shape == ref.shape == (70, 32)
    assert max_err(got, ref) <= 1e-5
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    assert T.extract_features(net, pts, kps[:0], 1.0).shape == (0, 32)


def test_reference_checkpoint_loads_in_both(tmp_path):
    """A SpinNet .pth in the reference's layout: rap_tpu converts it, the
    port loads it with load_state_dict; the descriptors agree (1e-5), and
    rap_tpu's converter gives back the parameters the state dict was made
    from."""
    jcfg, jp, _ = _nets()
    sd = spinnet_params_from_jax(jax.tree.map(np.asarray, jp))
    path = tmp_path / "mini_spinnet_t.pth"
    torch.save({"state_dict": {f"Desc.{k}": v for k, v in sd.items()}}, path)
    back = J.convert_spinnet_torch_state_dict(sd)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    jp2 = J.load_spinnet_torch_checkpoint(str(path))
    net = T.load_spinnet(str(path), T.SpinNetConfig(num_points_per_patch=K), device="cpu")
    pts, kps = _scene(5)
    ref = J.extract_features(jp2, jcfg, pts, kps, 1.0, chunk=32)
    got = T.build_feature_extractor(str(path), T.SpinNetConfig(num_points_per_patch=K),
                                    device="cpu")(pts, kps, 1.0)
    assert max_err(got, ref) <= 1e-5
    assert max_err(T.extract_features(net, pts, kps, 1.0), ref) <= 1e-5
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_random_weights_are_seeded():
    a = T.init_spinnet(3, device="cpu").state_dict()
    b = T.init_spinnet(3, device="cpu").state_dict()
    c = T.init_spinnet(4, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv_net.ops.0.weight"], c["conv_net.ops.0.weight"])
