"""MiniSpinNet: rotation-robust 32-D local point descriptors (counterpart of
rap_tpu/spinnet/model.py).

The same stages as rap_tpu's, in fp32 with full-fp32 products and
convolutions on the card (``fp32_exact``: rap_tpu states
``Precision.HIGHEST``, and cuDNN would otherwise run the convolutions in
TF32):

  1. patches: up to K in-radius neighbours per keypoint, the first K in
     index order (``ops.points.ball_query``); empty slots and the last slot
     hold the keypoint;
  2. offsets from the keypoint over ``des_r``, optionally turned so the
     patch's local-reference-frame z axis (smallest covariance direction,
     towards the viewpoint) becomes +z (``is_aligned_to_global_z=False``);
  3. a cylindrical grid of rad_n x ele_n x azi_n cells, each holding the
     first ``voxel_sample`` in-radius offsets in index order (zeros where
     there are fewer); each azimuth ring i turned by Rz(-2 pi i / azi_n);
  4. a 1x1 point conv + BN + ReLU, max over the cell's samples, a 3x3x3
     Conv3d (valid radially, zero-padded in elevation, circular in
     azimuth), 7 Conv2d (64, 128, 128, 64, 64, 32, 32; the last without BN
     and ReLU) with the same padding, attention pooling (1x1 convs to one
     weight per cell) and an L2 norm.

BatchNorm runs in inference mode from the stored statistics. The module's
parameters carry the reference's state-dict names (``pnt_layer.0/1``,
``conv_net.ops.<i>``, ``pool_layer.0/1/3/4``), so a SpinNet checkpoint's
``Desc.`` entries load with ``load_state_dict``.
"""

from __future__ import annotations

import dataclasses
import logging
import math

import numpy as np
import torch
from torch import nn

from .._device import fp32_exact, resolve_device

logger = logging.getLogger("rap_tpu_torch.spinnet")

CONV2D_CHANNELS = (64, 128, 128, 64, 64, 32, 32)  # after the 3D conv's 64


@dataclasses.dataclass(frozen=True)
class SpinNetConfig:
    des_r: float = 3.0
    num_points_per_patch: int = 512
    rad_n: int = 3
    azi_n: int = 20
    ele_n: int = 7
    delta: float = 0.8
    voxel_sample: int = 10
    is_aligned_to_global_z: bool = True
    out_dim: int = 32

    @property
    def n_cells(self) -> int:
        return self.rad_n * self.azi_n * self.ele_n


def voxel_grid_coordinates(cfg: SpinNetConfig) -> np.ndarray:
    """(rad_n*ele_n*azi_n, 3) cell centres in the unit ball, radius-major,
    then elevation, then azimuth."""
    beta = np.linspace(0, np.pi, cfg.ele_n, endpoint=False) + np.pi / cfg.ele_n / 2
    alpha = np.linspace(0, 2 * np.pi, cfg.azi_n, endpoint=False) + np.pi / cfg.azi_n
    B, A = np.meshgrid(beta, alpha, indexing="ij")
    b, a = B.flatten(), A.flatten()
    xyz = np.stack([np.sin(b) * np.cos(a), np.sin(b) * np.sin(a), np.cos(b)], axis=1)
    scale = (np.arange(cfg.rad_n) / cfg.rad_n + 0.5 / cfg.rad_n)[:, None, None]
    return (scale * xyz[None]).reshape(-1, 3).astype(np.float32)


def azimuth_rotations(cfg: SpinNetConfig) -> np.ndarray:
    """(azi_n, 3, 3) rotations Rz(-2 pi i / azi_n)."""
    out = np.zeros((cfg.azi_n, 3, 3), np.float32)
    for i in range(cfg.azi_n):
        a = -2.0 * np.pi * i / cfg.azi_n
        c, s = np.cos(a), np.sin(a)
        out[i] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    return out


def _bn(bn: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Inference-mode BatchNorm over dim 1, rap_tpu's order of operations."""
    shape = (1, -1) + (1,) * (x.ndim - 2)
    y = (x - bn.running_mean.view(shape)) * torch.rsqrt(bn.running_var.view(shape) + bn.eps)
    if bn.affine:
        y = y * bn.weight.view(shape) + bn.bias.view(shape)
    return y


def _wrap_pad(x: torch.Tensor) -> torch.Tensor:
    """Circular padding of 1 on the last (azimuth) axis, zeros of 1 on the
    one before it (elevation)."""
    x = torch.cat([x[..., -1:], x, x[..., :1]], dim=-1)
    return nn.functional.pad(x, (0, 0, 1, 1))


def _lrf_z_axis(delta: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """Smallest-eigenvalue direction of each patch's covariance, signed
    towards the viewpoint."""
    cov = torch.einsum("bni,bnj->bij", delta, delta)
    z = torch.linalg.eigh(cov).eigenvectors[..., 0]
    flip = (-z * center).sum(-1) < 0
    return torch.where(flip[:, None], -z, z)


def _rodrigues_to_z(z: torch.Tensor) -> torch.Tensor:
    """Rotations taking each unit axis z to (0, 0, 1)."""
    target = torch.tensor([0.0, 0.0, 1.0], device=z.device)
    v = torch.linalg.cross(z, target.expand_as(z))
    s = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    c = (z * target).sum(-1)[:, None, None]
    a, b, cc = v.unbind(-1)
    zeros = torch.zeros_like(a)
    vx = torch.stack([torch.stack([zeros, -cc, b], -1), torch.stack([cc, zeros, -a], -1),
                      torch.stack([-b, a, zeros], -1)], -2)
    eye = torch.eye(3, device=z.device).expand_as(vx)
    return eye + vx + vx @ vx * ((1 - c) / (s * s).clamp_min(1e-12)[..., None])


class MiniSpinNet(nn.Module):
    """Patches (B, K, 3), last slot the keypoint -> L2-normalised (B, 32)."""

    def __init__(self, cfg: SpinNetConfig = SpinNetConfig()):
        super().__init__()
        self.cfg = cfg
        self.pnt_layer = nn.Sequential(nn.Conv2d(3, 16, 1), nn.BatchNorm2d(16), nn.ReLU())
        ops: list[nn.Module] = [nn.Conv3d(16, 64, 3), nn.BatchNorm3d(64, affine=False), nn.ReLU()]
        cin = 64
        for i, cout in enumerate(CONV2D_CHANNELS):
            ops.append(nn.Conv2d(cin, cout, 3))
            if i < len(CONV2D_CHANNELS) - 1:
                ops += [nn.BatchNorm2d(cout, affine=False), nn.ReLU()]
            cin = cout
        self.conv_net = nn.Module()
        self.conv_net.ops = nn.ModuleList(ops)
        self.pool_layer = nn.Sequential(nn.Conv2d(32, 16, 1), nn.BatchNorm2d(16), nn.ReLU(),
                                        nn.Conv2d(16, 1, 1), nn.BatchNorm2d(1), nn.ReLU())
        self.register_buffer("grid", torch.from_numpy(voxel_grid_coordinates(cfg)), persistent=False)
        self.register_buffer("azimuth", torch.from_numpy(azimuth_rotations(cfg)), persistent=False)
        self.eval()

    @torch.no_grad()
    def forward(self, patches: torch.Tensor, des_r: float | None = None) -> torch.Tensor:
        """``des_r`` overrides the config's patch radius."""
        with fp32_exact():
            return self._forward(patches.float(), des_r or self.cfg.des_r)

    def _forward(self, patches: torch.Tensor, des_r: float) -> torch.Tensor:
        cfg = self.cfg
        B = patches.shape[0]
        center = patches[:, -1, :]
        delta = patches - center[:, None, :]
        if not cfg.is_aligned_to_global_z:
            z = _lrf_z_axis(delta, center)
            z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True).clamp_min(1e-12)
            delta = delta @ _rodrigues_to_z(z)
        delta = delta / des_r

        # ---- cells: the first voxel_sample in-radius offsets, index order --
        grid = self.grid
        r = cfg.delta / cfg.rad_n
        d2 = ((grid * grid).sum(-1)[None, :, None]
              - 2.0 * torch.einsum("cd,bkd->bck", grid, delta)
              + (delta * delta).sum(-1)[:, None, :])               # (B, C, K)
        K = delta.shape[1]
        order = torch.where(d2 <= r * r, torch.arange(K, device=delta.device), K)
        first = torch.topk(order, min(cfg.voxel_sample, K), dim=-1, largest=False).values
        if first.shape[-1] < cfg.voxel_sample:
            first = nn.functional.pad(first, (0, cfg.voxel_sample - first.shape[-1]), value=K)
        padded = torch.cat([delta, delta.new_zeros(B, 1, 3)], dim=1)   # row K: zeros
        cell = torch.gather(padded[:, None].expand(B, grid.shape[0], K + 1, 3), 2,
                            first[..., None].expand(-1, -1, -1, 3))  # (B, C, S, 3)

        # azimuth invariance: ring i turned by Rz(-2 pi i / azi_n)
        cp = cell.reshape(B, cfg.rad_n, cfg.ele_n, cfg.azi_n, cfg.voxel_sample, 3)
        cp = torch.einsum("breasd,axd->breasx", cp, self.azimuth)

        # ---- point conv + max over the cell's samples -----------------------
        conv, bn = self.pnt_layer[0], self.pnt_layer[1]
        x = cp @ conv.weight[:, :, 0, 0].T + conv.bias                 # (..., S, 16)
        x = torch.relu(_bn(bn, x.movedim(-1, 1))).amax(-1)           # (B, 16, r, e, a)

        # ---- cylindrical conv stack ---------------------------------------
        ops = self.conv_net.ops
        x = nn.functional.conv3d(_wrap_pad(x), ops[0].weight, ops[0].bias)
        x = torch.relu(_bn(ops[1], x))[:, :, 0]                       # (B, 64, ele, azi)
        convs = [m for m in ops if isinstance(m, nn.Conv2d)]
        bns = [m for m in ops if isinstance(m, nn.BatchNorm2d)]
        for i, conv in enumerate(convs):
            x = nn.functional.conv2d(_wrap_pad(x), conv.weight, conv.bias)
            if i < len(bns):
                x = torch.relu(_bn(bns[i], x))

        # ---- attention pooling + L2 norm -------------------------------------
        p = self.pool_layer
        w = torch.relu(_bn(p[1], torch.einsum("bchw,oc->bohw", x, p[0].weight[:, :, 0, 0])
                           + p[0].bias[None, :, None, None]))
        w = torch.relu(_bn(p[4], torch.einsum("bchw,oc->bohw", w, p[3].weight[:, :, 0, 0])
                           + p[3].bias[None, :, None, None]))
        f = (x * w).mean((2, 3))                                      # (B, 32)
        return f / torch.linalg.vector_norm(f, dim=-1, keepdim=True).clamp_min(1e-12)


def init_spinnet(seed: int = 0, cfg: SpinNetConfig = SpinNetConfig(), device="cuda") -> MiniSpinNet:
    """Random weights from ``seed`` on ``device``: conv kernels and biases
    uniform in ±1/sqrt(fan_in) (rap_tpu's init), BatchNorm statistics and
    affines at identity."""
    device = resolve_device(device)
    net = MiniSpinNet(cfg)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d)):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                for p in (m.weight, m.bias):
                    p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * bound)
    return net.to(device)


def load_spinnet(path: str, cfg: SpinNetConfig = SpinNetConfig(), device="cuda") -> MiniSpinNet:
    """A SpinNet checkpoint (a state dict, or {'state_dict': ...}, with the
    descriptor's entries under ``Desc.`` or unprefixed) on ``device``."""
    device = resolve_device(device)
    raw = torch.load(path, map_location="cpu", weights_only=True)
    sd = raw.get("state_dict", raw)
    desc = {k[len("Desc."):]: v for k, v in sd.items() if k.startswith("Desc.")} or sd
    net = MiniSpinNet(cfg)
    net.load_state_dict({k: v for k, v in desc.items()
                         if k.split(".")[0] in ("pnt_layer", "conv_net", "pool_layer")})
    return net.to(device)


@torch.no_grad()
def extract_patches(points: torch.Tensor, keypoints: torch.Tensor, des_r: float, K: int,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """(Q, K, 3) in-radius patches of ``points`` (N, 3) around ``keypoints``
    (Q, 3); empty slots and the last slot hold the keypoint."""
    from ..ops.points import ball_query

    if mask is None:
        mask = torch.ones(points.shape[0], dtype=torch.bool, device=points.device)
    idx, _, within = ball_query(keypoints, points, mask, float(des_r), K)
    pts = torch.where(within[..., None], points.float()[idx], keypoints.float()[:, None, :])
    pts[:, -1, :] = keypoints
    return pts


@torch.no_grad()
def extract_features(net: MiniSpinNet, points: np.ndarray, keypoints: np.ndarray,
                     des_r: float, chunk: int = 256) -> np.ndarray:
    """The whole cloud as context, the keypoints as queries, ``chunk``
    keypoints at a time on the network's device -> (Q, out_dim) float32."""
    device = net.grid.device
    des_r, K = float(des_r), net.cfg.num_points_per_patch
    pts = torch.as_tensor(np.asarray(points, np.float32), device=device)
    kps = torch.as_tensor(np.asarray(keypoints, np.float32), device=device)
    feats = [net(extract_patches(pts, kps[c:c + chunk], des_r, K), des_r)
             for c in range(0, len(kps), chunk)]
    if not feats:
        return np.zeros((0, net.cfg.out_dim), np.float32)
    return torch.cat(feats).cpu().numpy()


def build_feature_extractor(checkpoint: str = "", cfg: SpinNetConfig = SpinNetConfig(),
                            device="cuda", seed: int = 1):
    """callable(cloud, keypoints, des_r) -> (Q, 32) numpy, from a checkpoint
    or, without one, random weights from ``seed``. (With seed 0 the pooling
    gate's last ReLU closes on every cell, and every descriptor is 0.)"""
    if checkpoint:
        net = load_spinnet(checkpoint, cfg, device)
    else:
        logger.warning("no SpinNet checkpoint — using random descriptor weights")
        net = init_spinnet(seed, cfg, device)

    def fn(cloud: np.ndarray, keypoints: np.ndarray, des_r: float) -> np.ndarray:
        return extract_features(net, cloud, keypoints, des_r)

    fn.device = net.grid.device  # where the descriptors are computed
    return fn
