"""The yardstick's arithmetic: H100 peaks, the least time of a piece of
work, and the operations and bytes of the DiT's parts counted from shapes.

Every count is of what the inputs need, whatever kernel computes it:
attention over the valid keys of each sequence at the unpadded head width,
each input byte read once and each output byte written once. A linear layer
is 2·M·K·N operations. Attention's forward is two products (QK^T, PV) of
2·q·k·dh operations each, and one exp per logit on the special-function
unit; its backward is four products (dV, dP, dQ, dK), the recompute of QK^T
left out. Training counts three times the forward for the model (``mfu``),
and the backward of a linear layer as two products of the forward's size.

The peaks are NVIDIA's published dense figures for the H100 SXM at 700 W.
"""

from __future__ import annotations

import dataclasses

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# the special-function unit (exp2): 16 results per clock per SM against the
# tensor cores' 4096 dense bf16 operations per clock per SM
PEAK_MUFU_OPS = PEAK_BF16_FLOPS / 256

BF16, FP32 = 2, 4


@dataclasses.dataclass
class Work:
    """Operations, special-function ops and bytes of some calls, and the
    least time they need on the card (the sum over the calls of each
    call's own bound)."""

    flops: float = 0.0
    mufu: float = 0.0
    bytes: float = 0.0
    least_s: float = 0.0

    def add(self, flops: float, nbytes: float, mufu: float = 0.0) -> "Work":
        self.flops += flops
        self.mufu += mufu
        self.bytes += nbytes
        self.least_s += least_time(flops, nbytes, mufu)
        return self

    def __iadd__(self, other: "Work") -> "Work":
        self.flops += other.flops
        self.mufu += other.mufu
        self.bytes += other.bytes
        self.least_s += other.least_s
        return self

    def scaled(self, k: float) -> "Work":
        return Work(self.flops * k, self.mufu * k, self.bytes * k, self.least_s * k)


def least_time(flops: float, nbytes: float, mufu: float = 0.0) -> float:
    """Seconds the card needs at least: the larger of the operations' time
    (tensor cores or special-function unit) and the bytes' time."""
    return max(flops / PEAK_BF16_FLOPS, mufu / PEAK_MUFU_OPS, nbytes / PEAK_BYTES)


def linear(M: int, K: int, N: int, in_bytes: int = BF16, out_bytes: int = BF16,
           w_bytes: int | None = None) -> Work:
    """y (M, N) = x (M, K) @ W (K, N)."""
    w_bytes = in_bytes if w_bytes is None else w_bytes
    return Work().add(2.0 * M * K * N, M * K * in_bytes + K * N * w_bytes + M * N * out_bytes)


def attention_fwd(heads: int, q_lens, k_lens, dh: int) -> Work:
    """Softmax attention of ``heads`` heads over sequences whose valid
    query and key counts are ``q_lens[i]``, ``k_lens[i]``."""
    w = Work()
    for nq, nk in zip(q_lens, k_lens, strict=True):
        x = float(heads) * nq * nk
        io = heads * (2 * nq + 2 * nk) * dh * BF16  # q, o; k, v
        w.add(4.0 * x * dh, io, mufu=x)
    return w


def attention_bwd(heads: int, q_lens, k_lens, dh: int) -> Work:
    w = Work()
    for nq, nk in zip(q_lens, k_lens, strict=True):
        x = float(heads) * nq * nk
        io = heads * (4 * nq + 4 * nk) * dh * BF16  # q, o, dO, dQ; k, v, dK, dV
        w.add(8.0 * x * dh, io)
    return w


@dataclasses.dataclass(frozen=True)
class Shape:
    """The model's widths (a configuration's ``model`` block)."""

    embed_dim: int
    num_layers: int
    num_heads: int
    ff_hidden: int
    time_embed_channels: int
    embed_input_dim: int
    out_dim: int = 3

    @classmethod
    def of(cls, model: dict) -> "Shape":
        m = model["multires"]
        d_in = 2 * 3 * (2 * m + 1) + model["local_feat_dim"]
        if model.get("scale_emb_on", True):
            d_in += 2 * m + 1
        return cls(model["embed_dim"], model["num_layers"], model["num_heads"],
                   model["ff_hidden"], model["time_embed_channels"], d_in)

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


@dataclasses.dataclass
class ForwardWork:
    """One DiT forward, split by the layer that does the work."""

    linear: Work       # the four projections of every layer (qkv, out, ff in, ff out)
    small_linear: Work  # embedding, AdaLN MLPs, head (fp32 cuBLAS)
    attention: Work

    @property
    def flops(self) -> float:
        return self.linear.flops + self.small_linear.flops + self.attention.flops


def dit_forward(shape: Shape, parts: list[list[int]]) -> ForwardWork:
    """One forward over samples whose parts hold ``parts[s][p]`` valid points
    (padding counts for nothing)."""
    D, H, dh, FH = shape.embed_dim, shape.num_heads, shape.head_dim, shape.ff_hidden
    L, C = shape.num_layers, shape.time_embed_channels
    T = sum(sum(p) for p in parts)
    G = sum(len(p) for p in parts)
    lin, small, att = Work(), Work(), Work()
    for _ in range(L):
        for _ in range(2):  # part attention, then global attention
            lin += linear(T, D, 3 * D)
            lin += linear(T, D, D)
            small += linear(G, C, D, FP32, FP32)
            small += linear(G, D, D, FP32, FP32)
            small += linear(G, D, 2 * D, FP32, FP32)
        lin += linear(T, D, 2 * FH)
        lin += linear(T, FH, D)
        part_lens = [n for p in parts for n in p]
        sample_lens = [sum(p) for p in parts]
        att += attention_fwd(H, part_lens, part_lens, dh)
        att += attention_fwd(H, sample_lens, sample_lens, dh)
    small += linear(T, shape.embed_input_dim, D, FP32, FP32)
    small += linear(T, D, D, FP32, FP32)
    small += linear(T, D, D // 2, FP32, FP32)
    small += linear(T, D // 2, shape.out_dim, FP32, FP32)
    return ForwardWork(lin, small, att)


def dit_backward_attention(shape: Shape, parts: list[list[int]]) -> Work:
    """The attention backward of one training step (every layer)."""
    H, dh = shape.num_heads, shape.head_dim
    part_lens = [n for p in parts for n in p]
    sample_lens = [sum(p) for p in parts]
    w = Work()
    for _ in range(shape.num_layers):
        w += attention_bwd(H, part_lens, part_lens, dh)
        w += attention_bwd(H, sample_lens, sample_lens, dh)
    return w


def newton_schulz(rows: int, cols: int, steps: int = 5) -> Work:
    """Muon's quintic Newton-Schulz of one (rows, cols) matrix in bf16: per
    step X X^T, (X X^T) X and (X X^T)(B X) on the short side m."""
    m, n = min(rows, cols), max(rows, cols)
    w = Work()
    for _ in range(steps):
        w += linear(m, n, m)
        w += linear(m, m, n)
        w += linear(m, m, n)
    return w
