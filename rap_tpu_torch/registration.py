"""Rectified Point Flow training forward, sampling and pose fitting
(counterpart of rap_tpu/registration.py:34-381).

Ported: ``RPFConfig``, ``training_forward`` (velocity loss, norms and the
t-binned losses), ``velocity_fn``, ``sample`` (euler/rk2/rk4, any schedule,
rigidity forcing, trajectories, the pruned coarse-then-fine sampler and the
transformer features), ``predict_poses`` and ``refine_poses_icp``. The
caller may pass the noise ``x_1`` (and, to training, the timesteps ``t``;
to the pruned sampler, its index set), so the same draws can drive both
packages.
Dense and padded batches both run (the DiT takes its masked branch for the
latter). Training also takes rap_tpu's two options: the auxiliary pose loss
(``pose_loss_weight > 0``, through the gradient of the batched 3x3 SVD of
``core.procrustes``) and FF dropout (``model.dropout_rate > 0``).

Several GPUs (``parallel/``): ``training_forward(mesh=...)`` is one rank's
part of a data-parallel step over the global batch (rap_tpu's jit over the
mesh): the draws are global and sliced, the loss's denominators are summed
over the ranks, and the loss and metrics are the rank's shares of the
global values. ``sample(ring_mesh=...)`` samples an S = 1 batch whose parts
are sharded over the ranks, the DiT's global attention running as ring
attention, and returns the global outputs on every rank.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Any

import numpy as np
import torch

from . import telemetry
from .core import flow, procrustes
from .core.batch import PartBatch
from .core.sampler import flow_sampler, make_schedule
from .models.config import DiTConfig
from .models.dit import attention_bounds, dit_forward
from .parallel.mesh import Mesh, all_gather, all_reduce_sum

# the t-binned losses (registration.py:154-163)
T_BINS = ((0.0, 0.5, "loss_t<0.5"), (0.5, 0.9, "loss_t0.5-0.9"), (0.9, 1.01, "loss_t>0.9"))


@dataclasses.dataclass(frozen=True)
class RPFConfig:
    """Pipeline configuration (rap_tpu's RPFConfig, registration.py:34-70)."""

    model: DiTConfig = dataclasses.field(default_factory=DiTConfig)
    loss_type: str = "mse"
    timestep_sampling: str = "u_shaped"
    # auxiliary Kabsch pose loss on the implied endpoint x0_hat = x_t - t*v_pred
    pose_loss_weight: float = 0.0
    inference_sampling_steps: int = 10
    inference_sampler: str = "euler"
    inference_schedule: str = "uniform"
    n_generations: int = 1  # generations per batch in apps.sample
    rigidity_forcing: bool = True
    return_end_point_trajectory: bool = True
    # the first ``prune_coarse_steps`` ODE steps run on a 1/prune_factor
    # subsample of every part, and the full-resolution state is rebuilt
    # exactly at the switch (registration.py:55-70); needs rigidity forcing
    prune_coarse_steps: int = 0
    prune_factor: int = 4


def parts_per_sample(batch: PartBatch) -> int:
    """Static P of the regular layout (G == S * P)."""
    if batch.G % batch.S:
        raise ValueError("batch is not in regular layout")
    return batch.G // batch.S


def training_forward(
    params,
    cfg: RPFConfig,
    batch: PartBatch,
    generator: torch.Generator | None,
    remat: bool = True,
    x_1: torch.Tensor | None = None,
    t: torch.Tensor | None = None,
    dropout_keep: list[torch.Tensor] | None = None,
    mesh: Mesh | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One training forward (registration.py:92-164): sample t, build the
    flow target, predict v, loss. Returns (loss with its graph, metrics
    detached): loss (the velocity loss alone, as rap_tpu reports it),
    norm_v_pred, norm_v_t, the t-binned losses and, with a pose loss,
    pose_loss.

    ``t`` (S,) and ``x_1`` (G, N, 3) override the draws from ``generator``
    (t first, then the noise, as rap_tpu splits its key). With
    ``model.dropout_rate > 0`` each layer's keep mask comes from
    ``dropout_keep`` (one bool mask a layer, (G, N, FH)) or from a seed a
    layer derived on the host from the generator's state after those draws
    (``dropout_seeds``). For a dense batch the attention guard bounds are
    computed here from the current gains, once per call; a padded batch
    needs none.

    ``mesh``: ``batch`` is this rank's contiguous sample shard of a global
    batch of ``mesh.size`` such shards. t and x_1 are the global ones (drawn,
    or given with the global S and G) and the rank keeps its slice, so every
    world draws what a world of 1 draws; the dropout seeds fold in the rank.
    Every mean's denominator (valid points, valid parts, the samples of
    each t bin) is summed over the ranks, with no gradient, before the
    forward, and the loss and each metric are the rank's numerator over the
    global denominator: their sums over the ranks are the global loss and
    metrics, and the sum of the ranks' gradients is the global loss's.
    """
    n, r = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    S, G = batch.S, batch.G
    x_0 = batch.points_gt
    if t is None:
        t = flow.sample_timesteps(generator, S * n, cfg.timestep_sampling)
    if x_1 is None:
        x_1 = torch.randn((G * n,) + tuple(x_0.shape[1:]), generator=generator,
                          dtype=x_0.dtype, device=x_0.device)
    if mesh is not None:
        if t.shape[0] != S * n or x_1.shape[0] != G * n:
            raise ValueError(f"t {tuple(t.shape)} and x_1 {tuple(x_1.shape)} must be the "
                             f"global draws: S={S * n}, G={G * n}")
        t, x_1 = t[r * S:(r + 1) * S], x_1[r * G:(r + 1) * G]
    dropout = None
    if cfg.model.dropout_rate > 0.0:
        dropout = (list(dropout_keep) if dropout_keep is not None
                   else dropout_seeds(generator, len(params["layers"])))
        if mesh is not None and dropout_keep is None:
            dropout = [_fold_rank(s, r) for s in dropout]
    P = parts_per_sample(batch)
    mask = batch.point_mask.float()
    valid = batch.sample_valid.float()
    bins = [((t >= lo) & (t < hi)).float() * valid for lo, hi, _ in T_BINS]
    counts = [mask.sum()] + [w.sum() for w in bins]
    if cfg.pose_loss_weight > 0.0:
        pw = (batch.part_valid & batch.per_sample_to_part(batch.sample_valid)).float()
        counts.append(pw.sum())
    counts = torch.stack(counts)
    if mesh is not None:
        counts = all_reduce_sum(counts, mesh)
    t_point = batch.per_sample_to_point(t)[..., None]  # (G, N, 1)
    x_t, v_t = flow.flow_interpolate(x_0, x_1, t_point)
    bounds = attention_bounds(params) if batch.no_padding else None
    v_pred = dit_forward(params, cfg.model, x_t, t, batch, parts_per_sample=P,
                         remat=remat, bounds=bounds, dropout=dropout)
    loss = flow.velocity_loss(v_pred, v_t, batch.point_mask, cfg.loss_type, count=counts[0])
    metrics = {"loss": loss.detach()}
    if cfg.pose_loss_weight > 0.0:
        pose_loss = _pose_loss(batch, x_t, t_point, v_pred, pw, counts[-1])
        loss = loss + cfg.pose_loss_weight * pose_loss
        metrics["pose_loss"] = pose_loss.detach()
    with torch.no_grad():
        v_pred = v_pred.detach()
        n_pred, n_t = flow.velocity_norms(v_pred, v_t, batch.point_mask, count=counts[0])
        metrics.update(norm_v_pred=n_pred, norm_v_t=n_t)
        se = ((v_pred - v_t) ** 2 * mask[..., None]).sum((1, 2))        # (G,)
        cnt = 3.0 * mask.sum(1)
        se_s = se.reshape(S, P).sum(1)                                  # (S,)
        cnt_s = cnt.reshape(S, P).sum(1).clamp_min(1.0)
        loss_s = se_s / cnt_s
        for i, (w, (_, _, name)) in enumerate(zip(bins, T_BINS)):
            metrics[name] = (loss_s * w).sum() / counts[1 + i].clamp_min(1.0)
    return loss, metrics


def _fold_rank(seed: int, rank: int) -> int:
    """A rank's dropout seed from the layer's seed: each rank draws its own
    mask (rap_tpu draws one over the global activation)."""
    data = seed.to_bytes(8, "little") + rank.to_bytes(4, "little")
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "little") >> 1


def seeded_generator(device, *entropy: int) -> torch.Generator:
    """A generator on ``device`` seeded from integers (through
    ``np.random.SeedSequence``): the noise of one generation."""
    state = np.random.SeedSequence(list(entropy)).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def dropout_seeds(generator: torch.Generator, n: int) -> list[int]:
    """One dropout seed a layer from the generator's state, read on the host
    (a card generator's state is its Philox seed and offset: no sync), then
    one draw to move the generator on, so the next call gets other seeds
    even where its t and noise were given."""
    if generator is None:
        raise ValueError("FF dropout needs a generator or dropout_keep")
    state = generator.get_state().numpy().tobytes()
    seeds = [int.from_bytes(hashlib.blake2b(state + i.to_bytes(4, "little"),
                                            digest_size=8).digest(), "little") >> 1
             for i in range(n)]
    torch.rand((1,), generator=generator, device=generator.device)
    return seeds


def _pose_loss(batch: PartBatch, x_t, t_point, v_pred, pw, count) -> torch.Tensor:
    """rap_tpu's auxiliary pose loss (registration.py:132-149): the masked
    Kabsch fit of the condition to the implied endpoint x0_hat, then
    1 - clip((tr(R_hat^T R) - 1) / 2) plus the squared translation error,
    averaged over the valid parts of valid samples (``pw``, ``count`` of
    them). Degenerate parts (fewer than 3 points) keep a finite gradient:
    kabsch_masked feeds the SVD an identity there and selects (torch.where,
    no product) its result away, so the SVD backward's non-finite entries
    for them never reach the gradient. No host read."""
    x0_hat = x_t - t_point * v_pred.to(x_t.dtype)
    R_hat, t_hat = procrustes.fit_transformations(batch.points, x0_hat, batch.point_mask)
    tr = (R_hat * batch.rotations_gt).sum((-2, -1))
    rot_l = 1.0 - ((tr - 1.0) / 2.0).clamp(-1.0, 1.0)
    trans_l = ((t_hat - batch.translations_gt) ** 2).sum(-1)
    return ((rot_l + trans_l) * pw).sum() / count.clamp_min(1.0)


def velocity_fn(params, cfg: RPFConfig, batch: PartBatch, ring_mesh: Mesh | None = None):
    """The (x_t, t) -> v closure used by the ODE sampler; ``ring_mesh``: the
    global attention over the ranks' shards (``dit_forward``)."""
    P = parts_per_sample(batch)

    def fn(x_t: torch.Tensor, t: float) -> torch.Tensor:
        ts = torch.full((batch.S,), t, dtype=torch.float32, device=x_t.device)
        return dit_forward(params, cfg.model, x_t, ts, batch, parts_per_sample=P,
                           ring_mesh=ring_mesh)

    return fn


@torch.no_grad()
@telemetry.spanned("rap.sample")
def sample(
    params,
    cfg: RPFConfig,
    batch: PartBatch,
    generator: torch.Generator | None = None,
    x_1: torch.Tensor | None = None,
    return_trajectory: bool = True,
    return_transformer_features: bool = False,
    num_steps: int | None = None,
    schedule: str | None = None,
    prune_index: torch.Tensor | None = None,
    ring_mesh: Mesh | None = None,
) -> dict[str, Any]:
    """Generate a registered scene by integrating the learned flow.

    ``x_1`` (G, N, 3) fp32 is the noise; without it, noise is drawn with
    ``generator`` on the batch's device. Returns a dict with 'points' and,
    with trajectories, 'end_point_trajectory' and 'trajectory'; with
    ``return_transformer_features``, 'transformer_features' (G, N, D) fp32
    from one more forward at the final state and t = 1/steps.

    Where rap_tpu prunes (``prune_coarse_steps`` > 0 with rigidity forcing,
    no trajectory, more than one step), the first steps run on a sorted
    subsample of ``n_sub`` points per part, the same set for every part:
    ``prune_index`` (n_sub,) long, or drawn after the noise from
    ``generator`` (rap_tpu draws it from its key, which the port cannot
    reproduce). ``n_sub`` is N / prune_factor rounded up, then down to a
    multiple of 128, at least 128 and at most N.

    ``ring_mesh`` (registration.py:190-211): ``batch`` is this rank's shard
    of an S = 1 batch (``parallel.mesh.shard_batch``: its contiguous share
    of the parts) and the DiT's global attention runs over the ranks as
    ring attention. The noise is the global one (G = the shard's parts x
    the mesh size), drawn or given, of which the rank keeps its parts, so a
    world of n samples what a world of 1 samples. The per-part work (the
    forcing's Kabsch fits) stays on the rank's parts; the outputs are
    gathered, so every rank returns the global ones.
    """
    n = 1 if ring_mesh is None else ring_mesh.size
    G = batch.G * n
    if x_1 is None:
        x_1 = torch.randn((G,) + tuple(batch.points.shape[1:]), generator=generator,
                          dtype=torch.float32, device=batch.device)
    if ring_mesh is not None:
        if x_1.shape[0] != G:
            raise ValueError(f"x_1 has {x_1.shape[0]} parts; the global noise has {G}")
        x_1 = x_1[ring_mesh.rank * batch.G:(ring_mesh.rank + 1) * batch.G]
    steps = num_steps or cfg.inference_sampling_steps
    return_trajectory = return_trajectory and cfg.return_end_point_trajectory
    schedule = schedule or cfg.inference_schedule
    vfn = velocity_fn(params, cfg, batch, ring_mesh)
    coarse = min(cfg.prune_coarse_steps, steps - 1)
    if coarse > 0 and cfg.rigidity_forcing and not return_trajectory:
        res = _sample_pruned(params, cfg, batch, vfn, x_1, make_schedule(steps, schedule),
                             coarse, generator, prune_index, ring_mesh)
    else:
        res = flow_sampler(
            vfn,
            x_1=x_1,
            condition=batch.points,
            point_mask=batch.point_mask,
            num_steps=steps,
            rigidity_forcing=cfg.rigidity_forcing,
            return_trajectory=return_trajectory,
            method=cfg.inference_sampler,
            schedule=schedule,
        )
    out: dict[str, Any] = {"points": _gather(res.x_final, ring_mesh)}
    if return_trajectory:
        out["end_point_trajectory"] = _gather(res.end_point_trajectory, ring_mesh, 1)
        out["trajectory"] = _gather(res.trajectory, ring_mesh, 1)
    if return_transformer_features:
        ts = torch.full((batch.S,), 1.0 / steps, dtype=torch.float32, device=batch.device)
        _, feats = dit_forward(params, cfg.model, res.x_final, ts, batch,
                               parts_per_sample=parts_per_sample(batch),
                               return_features=True, ring_mesh=ring_mesh)
        out["transformer_features"] = _gather(feats, ring_mesh)
    return out


def _gather(x: torch.Tensor, ring_mesh: Mesh | None, dim: int = 0) -> torch.Tensor:
    """The ranks' part slices of ``x`` joined along its part axis ``dim``."""
    return x if ring_mesh is None else all_gather(x, ring_mesh, dim)


def prune_size(N: int, prune_factor: int) -> int:
    """Points per part in the pruned sampler's coarse segment (registration.py:201)."""
    return min(max(-(-N // prune_factor) // 128 * 128, 128), N)


def _sample_pruned(params, cfg: RPFConfig, batch: PartBatch, vfn, x_1, ts, coarse: int,
                   generator, prune_index, ring_mesh=None):
    """The coarse segment on the subsample, the exact switch to full
    resolution, the fine segment (registration.py:193-245)."""
    N = batch.N
    n_sub = prune_size(N, cfg.prune_factor)
    if prune_index is None:
        prune_index = torch.randperm(N, generator=generator, device=batch.device)[:n_sub]
        prune_index = prune_index.sort().values
    idx = prune_index.to(device=batch.device, dtype=torch.long)
    if tuple(idx.shape) != (n_sub,):
        raise ValueError(f"prune_index has shape {tuple(idx.shape)}, expected ({n_sub},)")
    sub = dataclasses.replace(
        batch, points=batch.points[:, idx], points_gt=batch.points_gt[:, idx],
        local_feats=batch.local_feats[:, idx], point_mask=batch.point_mask[:, idx])
    x_1_sub = x_1[:, idx]
    res1 = flow_sampler(velocity_fn(params, cfg, sub, ring_mesh), x_1=x_1_sub,
                        condition=sub.points, point_mask=sub.point_mask, rigidity_forcing=True,
                        return_trajectory=False, method=cfg.inference_sampler,
                        ts=ts[:coarse + 1])
    # invert the forcing blend to the rigid endpoint, fit its per-part pose
    # (exact: the cloud is rigid by construction) and re-apply it at full
    # resolution
    t_s = float(ts[coarse])
    x0_rigid_sub = (res1.x_final - t_s * x_1_sub) / (1.0 - t_s)
    R, tr = procrustes.fit_transformations(sub.points, x0_rigid_sub, sub.point_mask)
    x0_full = procrustes.transform_points(R, tr, batch.points)
    x_switch = (1.0 - t_s) * x0_full + t_s * x_1
    return flow_sampler(vfn, x_1=x_1, x_start=x_switch, condition=batch.points,
                        point_mask=batch.point_mask, rigidity_forcing=True,
                        return_trajectory=False, method=cfg.inference_sampler,
                        ts=ts[coarse:])


@telemetry.spanned("rap.poses")
def predict_poses(batch: PartBatch, predicted_points: torch.Tensor):
    """Per-part rigid poses condition -> prediction (registration.py:282-287)."""
    return procrustes.fit_transformations(
        batch.points, predicted_points, batch.point_mask
    )


@torch.no_grad()
def refine_poses_icp(
    batch: PartBatch,
    rotations: torch.Tensor,     # (G, 3, 3)
    translations: torch.Tensor,  # (G, 3)
    iters: int = 30,
    trim_fraction: float = 0.7,
    yaw_restarts: int = 1,
):
    """Trimmed-ICP pose refinement (registration.py:289-381): each valid
    non-anchor part, posed, is aligned onto its sample's posed anchor part,
    keeping the closest ``trim_fraction`` of correspondences each step; the
    ICP delta is composed with the input pose. ``yaw_restarts`` > 1 also
    tries K yaw rotations about each part's posed centroid (evenly spaced
    over 2 pi) and keeps, per part, the result with the lowest trimmed
    residual (the first of equal ones). Anchor and invalid parts are
    returned unchanged."""
    from .eval.metrics import icp_point_to_point

    S, P, N = batch.S, parts_per_sample(batch), batch.N
    Rv = rotations.float().reshape(S, P, 3, 3)
    tv = translations.float().reshape(S, P, 3)
    pts = batch.points.float().reshape(S, P, N, 3)
    mask = batch.point_mask.reshape(S, P, N)
    a_idx = batch.anchor_part.reshape(S, P).float().argmax(1)           # (S,)
    rows = torch.arange(S, device=a_idx.device)
    aR, at = Rv[rows, a_idx], tv[rows, a_idx]
    a_pts = torch.einsum("sij,snj->sni", aR, pts[rows, a_idx]) + at[:, None]
    a_mask = mask[rows, a_idx]

    src = (torch.einsum("spij,spnj->spni", Rv, pts) + tv[:, :, None]).reshape(S * P, N, 3)
    src_m = mask.reshape(S * P, N)
    tgt = a_pts[:, None].expand(S, P, N, 3).reshape(S * P, N, 3)
    tgt_m = a_mask[:, None].expand(S, P, N).reshape(S * P, N)

    if yaw_restarts <= 1:
        dR, dt = icp_point_to_point(src, src_m, tgt, tgt_m, iters=iters,
                                    trim_fraction=trim_fraction)
    else:
        cnt = src_m.sum(-1, keepdim=True).clamp_min(1)
        c = torch.where(src_m[..., None], src, 0.0).sum(1) / cnt         # (G, 3)
        angles = torch.arange(yaw_restarts, dtype=torch.float32) * (2.0 * math.pi / yaw_restarts)
        Rk, tk, resk = [], [], []
        for delta in angles:
            ca, sa = torch.cos(delta), torch.sin(delta)
            Rz = torch.tensor([[ca, -sa, 0.0], [sa, ca, 0.0], [0.0, 0.0, 1.0]],
                              device=src.device)
            R0 = Rz.expand(src.shape[0], 3, 3)
            t0 = c - torch.einsum("ij,gj->gi", Rz, c)
            R_, t_, r_ = icp_point_to_point(src, src_m, tgt, tgt_m, iters=iters,
                                            trim_fraction=trim_fraction, init=(R0, t0),
                                            return_residual=True)
            Rk.append(R_)
            tk.append(t_)
            resk.append(r_)
        best = torch.stack(resk).argmin(0)                              # (G,)
        g = torch.arange(src.shape[0], device=src.device)
        dR, dt = torch.stack(Rk)[best, g], torch.stack(tk)[best, g]

    R_new = torch.einsum("gij,gjk->gik", dR, rotations.float())
    t_new = torch.einsum("gij,gj->gi", dR, translations.float()) + dt
    keep = batch.anchor_part | ~batch.part_valid
    return (torch.where(keep[:, None, None], rotations.float(), R_new),
            torch.where(keep[:, None], translations.float(), t_new))
