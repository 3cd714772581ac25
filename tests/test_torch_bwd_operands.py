"""The key-block backward's operand split against rap_tpu's ``_augment_do`` (CPU).

The key-block kernel of rows 6 and 7 (csrc/attention_bwd_dkv.cuh) reads V and
dO with 64-value rows and -delta and va's ones column as fp32 vectors, where
rap_tpu feeds its kernels va = [V | 1] and [dO | -delta] with 65-value rows
(``_augment_do``, rap_tpu/ops/pallas_attention.py:566). ``backward_operands``
makes the split. Same seeded numpy inputs on both sides, in bf16 and fp32, at
a dense shape and at the padded shape of the masked path (queries and keys
padded to rap_tpu's blocks, padded keys masked).

- -delta against the column ``_augment_do`` writes through JAX: each value
  within the fp32 error bound of a sum of d = 64 products taken in another
  order (d · 2^-24 · sum |dO·O|), plus in bf16 one rounding step of the
  value (2^-8 relative), which that difference may tip;
- (V, ones) and (dO, -delta) put back together give ``vah`` and the port's
  ``augment_do(dout, out)`` bit for bit, and the split of an augmented
  tensor (the dKV pass's route) gives the same pieces.

The dQ pass (csrc/attention_bwd_dq.cuh, row 8) reads the same pieces. With
the launch replaced by a recorder (no card here): the memory at the pointers
``flash_bwd_dq_kernel`` hands its kernel holds exactly ``backward_operands``'
pieces, and the split branch of ``attention_backward`` splits va and
[dO | -delta] once and hands the same tensors to both passes.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

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
    dout, out, vh = (_torch(a, dtype) for a in _inputs(BH, T))
    # rows past the valid ones are padding, as flash_attention pads them: zero
    # keys and values with a ones column, no cotangent
    dout[:, valid:] = 0
    vah = F.pad(F.pad(vh[:, :valid], (0, 0, 0, T - valid)), (0, 1), value=1.0)

    v, do, nd, ones = fa.backward_operands(vah, dout, out)
    assert v.shape == do.shape == dout.shape and v.dtype == do.dtype == dtype
    assert nd.dtype == ones.dtype == torch.float32 and nd.shape == dout.shape[:2]
    assert all(x.is_contiguous() for x in (v, do, nd, ones))

    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = jpa._augment_do(jnp.asarray(dout.float().numpy(), jdt),
                          jnp.asarray(out.float().numpy(), jdt))
    ref_nd = np.asarray(ref[..., DH].astype(jnp.float32))
    got_nd = nd.numpy()
    terms = np.abs(dout.float().numpy() * out.float().numpy()).sum(-1)
    bound = DH * 2.0 ** -24 * terms + ROUNDING[dtype] * np.abs(ref_nd)
    assert (np.abs(got_nd - ref_nd) <= bound).all()
    np.testing.assert_array_equal(do.float().numpy(),
                                  np.asarray(ref[..., :DH].astype(jnp.float32)))

    # the pieces put back together, bit for bit
    doa = fa.augment_do(dout, out)
    assert torch.equal(torch.cat([v, ones[..., None].to(dtype)], -1), vah)
    assert torch.equal(torch.cat([do, nd[..., None].to(dtype)], -1), doa)
    # the dKV pass splits the augmented tensors it is given the same way
    for whole, pieces in ((vah, (v, ones)), (doa, (do, nd))):
        for got, want in zip(fa._split_last(whole), pieces):
            assert torch.equal(got, want)


# pointer arguments of the split passes' entry points (q, k, v, ones, mask,
# dout, -delta, lse2, then the outputs)
_PIECE_ARGS = {"v": 2, "ones": 3, "dout": 5, "-delta": 6}


def _read(ptr, like):
    """A copy of the memory at ``ptr``, as a tensor like ``like``."""
    raw = ctypes.string_at(ptr, like.numel() * like.element_size())
    return torch.frombuffer(bytearray(raw), dtype=like.dtype).view(like.shape)


def _split_inputs(BH, T, seed=7):
    dout, out, vh = (_torch(a, torch.bfloat16) for a in _inputs(BH, T, seed))
    q, k, _ = (_torch(a, torch.bfloat16) for a in _inputs(BH, T, seed + 1))
    return q, k, F.pad(vh, (0, 1), value=1.0), out, dout, torch.zeros(BH, T)


@pytest.mark.parametrize("softcap", [0.0, 5.0])
def test_dq_wrapper_hands_its_kernel_the_pieces(monkeypatch, softcap):
    """flash_bwd_dq_kernel takes va and [dO | -delta] with 65-value rows; at
    the launch, the memory at its V, ones, dO and -delta pointers equals
    backward_operands' pieces bit for bit."""
    qh, kh, vah, out, dout, lse2 = _split_inputs(4, 256)
    want = dict(zip(("v", "dout", "-delta", "ones"), fa.backward_operands(vah, dout, out)))
    seen = {}

    def record(kernel, like, *args):
        seen[kernel] = {n: _read(args[i], want[n]) for n, i in _PIECE_ARGS.items()}

    monkeypatch.setattr(fa, "launch", record)
    fa.flash_bwd_dq_kernel(qh, kh, vah, fa.augment_do(dout, out), lse2, None, 1, softcap)
    name = "flash_bwd_dq_softcap" if softcap > 0.0 else "flash_bwd_dq"
    assert list(seen) == [name]
    for piece, got in seen[name].items():
        assert torch.equal(got, want[piece]), piece


@pytest.mark.parametrize("softcap", [0.0, 5.0])
def test_split_backward_splits_once_for_both_passes(monkeypatch, softcap):
    """attention_backward's split branch through the kernels (CUDA tensors,
    stood in for by CPU ones): one backward_operands call, and the dKV and
    dQ launches both get its pieces' pointers."""
    heads, B, T = 2, 2, 256
    qh, kh, vah, out, dout, lse2 = _split_inputs(B * heads, T)
    mask = torch.ones(B, T, dtype=torch.bool)
    mask[1, 100:] = False
    made, launched = [], []
    real = fa.backward_operands
    monkeypatch.setattr(fa, "backward_operands", lambda *a: made.append(real(*a)) or made[-1])
    monkeypatch.setattr(fa, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(fa, "launch", lambda kernel, like, *args: launched.append((kernel, args)))
    fa.attention_backward(qh, kh, vah, out, lse2, dout, mask, heads, split=True, kernels=True,
                          softcap=softcap)
    sfx = "_softcap" if softcap > 0.0 else ""
    assert [k for k, _ in launched] == [f"flash_bwd_dkv{sfx}", f"flash_bwd_dq{sfx}"]
    assert len(made) == 1
    v, do, nd, ones = made[0]
    want = {"v": v.data_ptr(), "ones": ones.data_ptr(), "dout": do.data_ptr(),
            "-delta": nd.data_ptr()}
    for kernel, args in launched:
        assert {n: args[i] for n, i in _PIECE_ARGS.items()} == want, kernel
        assert args[0] == qh.data_ptr() and args[1] == kh.data_ptr() and args[7] == lse2.data_ptr()
