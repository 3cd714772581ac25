"""What the attention wrappers hand their kernels, against rap_tpu's ``_augment_do`` (CPU).

rap_tpu feeds its Pallas kernels va = [V | 1] and [dO | -delta] with 65-value
rows (``_augment_do``, rap_tpu/ops/pallas_attention.py:566). The port's
kernels read V and dO as (BH, T, 64) tensors and -delta as an fp32 (BH, T)
vector, which ``_neg_delta`` computes. Same seeded numpy inputs on both
sides, in bf16 and fp32, at a dense shape and at the padded shape of the
masked path (queries and keys padded to rap_tpu's blocks, padded keys
masked):

- -delta against the column ``_augment_do`` writes through JAX: each value
  within the fp32 error bound of a sum of d = 64 products taken in another
  order (d · 2^-24 · sum |dO·O|), plus in bf16 one rounding step of the
  value (2^-8 relative), which that difference may tip; dO against its
  first 64 columns, bit for bit.

With the launch replaced by a recorder (no card here): the memory at the
pointers ``flash_bwd_dq_kernel`` hands its kernel (row 8) holds exactly v,
dO and -delta; the split branch of ``attention_backward`` computes -delta
once and hands the same tensors to both passes; and every forward and
backward wrapper hands its kernel the caller's own v at d = 64, no copy.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rap_tpu.ops import pallas_attention as jpa
from rap_tpu_torch.ops import flash_attention as fa

DH = 64
CASES = {
    # (batch*heads, valid rows, rows): no padding
    "dense": (4, 256, 256),
    # B=2, H=2, T=300 padded to the masked path's block of 384 rows
    "masked": (4, 300, 384),
}
ROUNDING = {torch.bfloat16: 2.0 ** -8, torch.float32: 0.0}  # one step of the dtype


def _inputs(BH, T, seed=5):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((BH, T, DH)).astype(np.float32) for _ in range(3))


def _torch(a, dtype):
    return torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", list(CASES))
def test_backward_operands_match_augment_do(case, dtype):
    BH, valid, T = CASES[case]
    dout, out, _ = (_torch(a, dtype) for a in _inputs(BH, T))
    # rows past the valid ones are padding, as flash_attention pads them: no
    # cotangent
    dout[:, valid:] = 0

    nd = fa._neg_delta(dout, out)
    assert nd.dtype == torch.float32 and nd.shape == dout.shape[:2] and nd.is_contiguous()
    assert torch.equal(nd.to(dtype).float(), nd)  # a value of dO's dtype

    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = jpa._augment_do(jnp.asarray(dout.float().numpy(), jdt),
                          jnp.asarray(out.float().numpy(), jdt))
    ref_nd = np.asarray(ref[..., DH].astype(jnp.float32))
    terms = np.abs(dout.float().numpy() * out.float().numpy()).sum(-1)
    bound = DH * 2.0 ** -24 * terms + ROUNDING[dtype] * np.abs(ref_nd)
    assert (np.abs(nd.numpy() - ref_nd) <= bound).all()
    np.testing.assert_array_equal(dout.float().numpy(),
                                  np.asarray(ref[..., :DH].astype(jnp.float32)))


# pointer arguments of the backward entry points (q, k, v, mask, dout,
# -delta, lse2, then the outputs)
_PIECE_ARGS = {"v": 2, "dout": 4, "-delta": 5}


def _read(ptr, like):
    """A copy of the memory at ``ptr``, as a tensor like ``like``."""
    raw = ctypes.string_at(ptr, like.numel() * like.element_size())
    return torch.frombuffer(bytearray(raw), dtype=like.dtype).view(like.shape)


def _split_inputs(BH, T, seed=7):
    dout, out, vh = (_torch(a, torch.bfloat16) for a in _inputs(BH, T, seed))
    q, k, _ = (_torch(a, torch.bfloat16) for a in _inputs(BH, T, seed + 1))
    return q, k, vh, out, dout, torch.zeros(BH, T)


@pytest.mark.parametrize("softcap", [0.0, 5.0])
def test_dq_wrapper_hands_its_kernel_the_pieces(monkeypatch, softcap):
    """flash_bwd_dq_kernel takes v, dO and -delta; at the launch, the memory
    at its V, dO and -delta pointers equals them bit for bit."""
    qh, kh, vh, out, dout, lse2 = _split_inputs(4, 256)
    want = {"v": vh, "dout": dout, "-delta": fa._neg_delta(dout, out)}
    seen = {}

    def record(kernel, like, *args):
        seen[kernel] = {n: _read(args[i], want[n]) for n, i in _PIECE_ARGS.items()}

    monkeypatch.setattr(fa, "launch", record)
    fa.flash_bwd_dq_kernel(qh, kh, vh, dout, want["-delta"], lse2, None, 1, softcap)
    name = "flash_bwd_dq_softcap" if softcap > 0.0 else "flash_bwd_dq"
    assert list(seen) == [name]
    for piece, got in seen[name].items():
        assert torch.equal(got, want[piece]), piece


@pytest.mark.parametrize("softcap", [0.0, 5.0])
def test_split_backward_splits_once_for_both_passes(monkeypatch, softcap):
    """attention_backward's split branch through the kernels (CUDA tensors,
    stood in for by CPU ones): one _neg_delta call, and the dKV and dQ
    launches both get the same v, dO and -delta pointers."""
    heads, B, T = 2, 2, 256
    qh, kh, vh, out, dout, lse2 = _split_inputs(B * heads, T)
    mask = torch.ones(B, T, dtype=torch.bool)
    mask[1, 100:] = False
    made, launched = [], []
    real = fa._neg_delta
    monkeypatch.setattr(fa, "_neg_delta", lambda *a: made.append(real(*a)) or made[-1])
    monkeypatch.setattr(fa, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(fa, "launch", lambda kernel, like, *args: launched.append((kernel, args)))
    fa.attention_backward(qh, kh, vh, out, lse2, dout, mask, heads, split=True, kernels=True,
                          softcap=softcap)
    sfx = "_softcap" if softcap > 0.0 else ""
    assert [k for k, _ in launched] == [f"flash_bwd_dkv{sfx}", f"flash_bwd_dq{sfx}"]
    assert len(made) == 1
    want = {"v": vh.data_ptr(), "dout": dout.data_ptr(), "-delta": made[0].data_ptr()}
    for kernel, args in launched:
        assert {n: args[i] for n, i in _PIECE_ARGS.items()} == want, kernel
        assert args[0] == qh.data_ptr() and args[1] == kh.data_ptr() and args[6] == lse2.data_ptr()


_WRAPPERS = {
    "fixed": lambda qh, kh, vh, out, dout, lse2: fa.flash_fixed_kernel(qh, kh, vh, 10.0),
    "online": lambda qh, kh, vh, out, dout, lse2: fa.flash_online_kernel(qh, kh, vh),
    "fused": lambda qh, kh, vh, out, dout, lse2: fa.attention_backward(
        qh, kh, vh, out, lse2, dout, None, 1, split=False, kernels=True),
    "split": lambda qh, kh, vh, out, dout, lse2: fa.attention_backward(
        qh, kh, vh, out, lse2, dout, None, 1, split=True, kernels=True),
}


@pytest.mark.parametrize("wrapper", list(_WRAPPERS))
def test_wrappers_hand_their_kernel_v_itself(monkeypatch, wrapper):
    """At d = 64 (the kernels' width) the fixed and online forward wrappers
    and the fused and split backward ones hand their kernel the caller's v:
    its own data_ptr, no copy (the launch recorded instead of made)."""
    qh, kh, vh, out, dout, lse2 = _split_inputs(4, 256)
    launched = []
    monkeypatch.setattr(fa, "on_cpu", lambda *tensors: False)  # as CUDA tensors are
    monkeypatch.setattr(fa, "launch", lambda kernel, like, *args: launched.append((kernel, args)))
    _WRAPPERS[wrapper](qh, kh, vh, out, dout, lse2)
    assert launched and all(args[2] == vh.data_ptr() for _, args in launched), launched
