"""Ring attention: masked attention with the sequence sharded over the
ranks of a mesh (counterpart of rap_tpu/ops/ring_attention.py:33-126).

Each rank holds a contiguous shard of the sequence: its queries and its
K/V/mask block. In each of n steps it attends its queries to the block it
holds (``_block_attend``: unnormalised partial results, the running max
clamped so that a fully masked block stays finite) and merges the result
into its running (max, sum, accumulator) by the online softmax; between
steps the K/V/mask blocks rotate one hop round the ring (send to rank
r + 1, receive from r - 1), so after n steps every query has seen every
key. The final ``l > 0`` select returns zeros for a query with no valid
key. Exact masked softmax attention, not an approximation.

The block product is a plain einsum in fp32 (the products of bf16 inputs
are exact in fp32, as rap_tpu's ``preferred_element_type=float32``
einsum), as rap_tpu computes it outside any Pallas kernel.

Differentiable: ``torch.distributed`` has no differentiable send/recv, so
the hop of k and v is an ``autograd.Function`` whose backward sends the
cotangents the reverse hop; autograd does the rest. Every rank must run the
same forward and backward (a collective per hop in each).
"""

from __future__ import annotations

import math

import torch

from ..parallel.mesh import Mesh, ring_shift

NEG_INF = -1e30


class _Hop(torch.autograd.Function):
    """k, v one hop round the ring; the backward sends their cotangents back."""

    @staticmethod
    def forward(ctx, mesh, k, v):
        ctx.mesh = mesh
        return ring_shift(k, mesh, 1), ring_shift(v, mesh, 1)

    @staticmethod
    def backward(ctx, dk, dv):
        return None, ring_shift(dk, ctx.mesh, -1), ring_shift(dv, ctx.mesh, -1)


def _block_attend(q, k, v, kv_mask, scale: float, softcap: float):
    """Partial (unnormalised) attention of q (B, Tq, H, d) against one block
    k, v (B, Tb, H, d), kv_mask (B, Tb) bool: (m (B, H, Tq, 1), l (B, H, Tq,
    1), acc (B, Tq, H, d)), fp32."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if softcap > 0.0:
        logits = torch.tanh(logits / softcap) * softcap
    valid = kv_mask[:, None, None, :]
    logits = torch.where(valid, logits, NEG_INF)
    # a fully masked block: clamp m so that exp stays finite; p = 0 there
    m_safe = logits.amax(-1, keepdim=True).clamp_min(-1e29)
    p = torch.exp(logits - m_safe) * valid
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return m_safe, l, acc


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_mask: torch.Tensor, mesh: Mesh, scale: float | None = None,
                   softcap: float = 0.0) -> torch.Tensor:
    """Masked MHA over the ranks' shards: q, k, v (B, T_local, H, d) and
    kv_mask (B, T_local) bool are this rank's contiguous shard of the
    sequence; returns its queries' output (B, T_local, H, d) in v's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    B, Tq, H, d = q.shape
    m_run = torch.full((B, H, Tq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l_run = torch.zeros((B, H, Tq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Tq, H, d), dtype=torch.float32, device=q.device)
    mask = kv_mask.bool()
    for i in range(mesh.size):
        m_b, l_b, acc_b = _block_attend(q, k, v, mask, scale, softcap)
        m_new = torch.maximum(m_run, m_b)
        c_run, c_b = torch.exp(m_run - m_new), torch.exp(m_b - m_new)
        l_run = l_run * c_run + l_b * c_b
        acc = acc * c_run.transpose(1, 2) + acc_b * c_b.transpose(1, 2)
        m_run = m_new
        if i + 1 < mesh.size:  # the last step's blocks go nowhere
            k, v = _Hop.apply(mesh, k, v)
            mask = ring_shift(mask.to(torch.uint8), mesh, 1).bool()
    l_t = l_run.transpose(1, 2)                                   # (B, Tq, H, 1)
    out = acc / l_t.clamp_min(1e-30)
    return torch.where(l_t > 0.0, out, 0.0).to(v.dtype)
