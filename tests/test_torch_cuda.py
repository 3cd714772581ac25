"""rap_tpu_torch's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card (sm_90a) and nvcc; elsewhere they skip.
They import neither jax nor the JAX package, so on the machine with the card
they run without this directory's conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Shapes are small (128 points per part) but the widths are the model's
(D=512, H=8, dh=64, FF hidden 2048). Tolerance: 1/64 of the largest output;
kernel and plain version round to bf16 at the same points and sum in
different orders (see chip_smoke.py, which runs the same checks at the main
path's shapes).
"""

import pytest
import torch

from rap_tpu_torch.ops import flash_attention as fa
from rap_tpu_torch.ops import fused_ff, fused_proj, launch_counts, reset_launches

pytestmark = pytest.mark.cuda

S, P, N, D, H, DH, FH = 2, 2, 128, 512, 8, 64, 2048
TOL = 1.0 / 64


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, dtype=torch.bfloat16, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def _close(got, ref):
    err = float((got.float() - ref.float()).abs().max())
    assert torch.isfinite(got.float()).all()
    assert err <= TOL * float(ref.float().abs().max()), err


@pytest.mark.parametrize("is_global", [False, True], ids=["part", "global"])
def test_proj_attention_out_kernels(gen, is_global):
    G = S * P
    x = _randn(gen, G, N, D)
    ada = _randn(gen, G, 2 * D, dtype=torch.float32, scale=0.1)
    w = _randn(gen, D, 3 * D, scale=D ** -0.5)
    gq, gk = fused_proj.fold_gains(1 + _randn(gen, H, DH, dtype=torch.float32, scale=0.1),
                                   1 + _randn(gen, H, DH, dtype=torch.float32, scale=0.1))
    reset_launches()
    got = fused_proj.proj_kernel(x, ada, w, gq, gk, P, is_global)
    for g_, r_ in zip(got, fused_proj.proj_plain(x, ada, w, gq, gk, P, is_global)):
        _close(g_, r_)
    B, T = (S, P * N) if is_global else (G, N)
    qh, kh, vah = (a.reshape(B * H, T, -1) for a in got)
    for kernel, plain, extra in ((fa.flash_fixed_kernel, fa.flash_fixed_plain, (20.0,)),
                                 (fa.flash_online_kernel, fa.flash_online_plain, ())):
        o_k, l_k = kernel(qh, kh, vah, *extra)
        o_p, l_p = plain(qh, kh, vah, *extra)
        _close(o_k, o_p)
        assert float((l_k - l_p).abs().max()) < 2e-2
    w_out = _randn(gen, D, D, scale=D ** -0.5)
    b_out = _randn(gen, D, scale=0.1)
    a5 = o_k.reshape(got[0].shape)
    _close(fused_proj.out_kernel(a5, x, w_out, b_out, P, is_global),
           fused_proj.out_plain(a5, x, w_out, b_out, P, is_global))
    assert launch_counts() == {"proj": 1, "flash_fixed": 1, "flash_online": 1,
                               "out_proj": 1, "ff": 0}


def test_online_kernel_masked_rows(gen):
    BH, heads, T = 8, 2, 256
    q, k = (_randn(gen, BH, T, DH, scale=0.3) for _ in range(2))
    va = torch.cat([_randn(gen, BH, T, DH), torch.ones(BH, T, 1, device="cuda",
                                                       dtype=torch.bfloat16)], -1)
    mask = (torch.rand((BH // heads, T), generator=gen, device="cuda") > 0.5).to(torch.int32)
    mask[2] = 0
    o_k, l_k = fa.flash_online_kernel(q, k, va, mask, heads)
    o_p, l_p = fa.flash_online_plain(q, k, va, mask.bool(), heads)
    _close(o_k, o_p)
    assert (o_k[4:6] == 0).all() and (l_k[4:6] == fa.LSE_EMPTY).all()


def test_ff_kernel(gen):
    T = S * P * N
    args = (_randn(gen, T, D), 1 + _randn(gen, D, dtype=torch.float32, scale=0.1),
            _randn(gen, D, dtype=torch.float32, scale=0.1),
            _randn(gen, D, 2 * FH, scale=D ** -0.5), _randn(gen, 2 * FH, scale=0.1),
            _randn(gen, FH, D, scale=FH ** -0.5), _randn(gen, D, scale=0.1))
    _close(fused_ff.ff_kernel(*args), fused_ff.ff_plain(*args))


def test_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    x = torch.zeros(4, 100, D, device="cuda", dtype=torch.bfloat16)  # N % 64 != 0
    with pytest.raises(ValueError):
        fused_ff.geglu_ff(x.float(), *(torch.zeros(1, device="cuda"),) * 6)
    with pytest.raises(ValueError, match="multiples of 64"):
        q = torch.zeros(8, 100, DH, device="cuda", dtype=torch.bfloat16)
        fa.flash_fixed(q, q, torch.zeros(8, 100, DH + 1, device="cuda", dtype=torch.bfloat16),
                       1.0)


def test_dit_forward_kernels_match_plain(gen):
    import dataclasses

    from rap_tpu_torch.core.batch import make_regular_synthetic_batch
    from rap_tpu_torch.models.config import DiTConfig
    from rap_tpu_torch.models.dit import attach_bounds, dit_forward, init_dit_params

    cfg = DiTConfig(num_layers=2)
    params = init_dit_params(0, cfg)
    lp = params["layers"][0]
    lp["global_q_gamma"] = lp["global_q_gamma"] * 3
    lp["global_k_gamma"] = lp["global_k_gamma"] * 3
    attach_bounds(params)
    batch = make_regular_synthetic_batch(1, [[N] * P] * S, N=N, P=P)
    x = torch.randn((S * P, N, 3), generator=gen, device="cuda")
    ts = torch.full((S,), 0.7, device="cuda")
    reset_launches()
    v_k = dit_forward(params, cfg, x, ts, batch, P)
    counts = launch_counts()
    v_p = dit_forward(params, dataclasses.replace(cfg, use_kernels=False), x, ts, batch, P)
    assert counts == {"proj": 4, "flash_fixed": 3, "flash_online": 1, "out_proj": 4, "ff": 2}
    err = float((v_k - v_p).abs().max())
    assert err <= 5e-2 * float(v_p.abs().max()), err
