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

from rap_tpu_torch.ops import KERNELS, fused_ff, fused_proj, launch_counts, reset_launches
from rap_tpu_torch.ops import flash_attention as fa

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


def _counts(**launched):
    """Every kernel's launch count: 0 unless given."""
    return {**dict.fromkeys(KERNELS, 0), **launched}


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
    qh, kh, vh = (a.reshape(B * H, T, -1) for a in got)
    for kernel, plain, extra in ((fa.flash_fixed_kernel, fa.flash_fixed_plain, (20.0,)),
                                 (fa.flash_online_kernel, fa.flash_online_plain, ())):
        o_k, l_k = kernel(qh, kh, vh, *extra)
        o_p, l_p = plain(qh, kh, vh, *extra)
        _close(o_k, o_p)
        assert float((l_k - l_p).abs().max()) < 2e-2
    w_out = _randn(gen, D, D, scale=D ** -0.5)
    b_out = _randn(gen, D, scale=0.1)
    a5 = o_k.reshape(got[0].shape)
    _close(fused_proj.out_kernel(a5, x, w_out, b_out, P, is_global),
           fused_proj.out_plain(a5, x, w_out, b_out, P, is_global))
    assert launch_counts() == _counts(proj=1, flash_fixed=1, flash_online=1, out_proj=1)


def test_online_kernel_masked_rows(gen):
    BH, heads, T = 8, 2, 256
    q, k = (_randn(gen, BH, T, DH, scale=0.3) for _ in range(2))
    v = _randn(gen, BH, T, DH)
    mask = (torch.rand((BH // heads, T), generator=gen, device="cuda") > 0.5).to(torch.int32)
    mask[2] = 0
    o_k, l_k = fa.flash_online_kernel(q, k, v, mask, heads)
    o_p, l_p = fa.flash_online_plain(q, k, v, mask.bool(), heads)
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
        fused_ff.geglu_ff(x.float(), *(torch.zeros(1, device="cuda"),) * 6, impl="pallas")
    with pytest.raises(ValueError, match="multiples of 128"):
        q = torch.zeros(8, 100, DH, device="cuda", dtype=torch.bfloat16)
        fa.flash_fixed(q, q, q, 1.0)
    v = torch.zeros(8, 128, DH, device="cuda", dtype=torch.bfloat16)
    q = torch.zeros(8 * 128 * DH + 1, device="cuda", dtype=torch.bfloat16)[1:].view(8, 128, DH)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        fa.flash_fixed(q, q, v, 1.0)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        fa.flash_online(q, q, v)


def _dit_forward_matches_plain(gen, cfg):
    import dataclasses

    from rap_tpu_torch.core.batch import make_regular_synthetic_batch
    from rap_tpu_torch.models.dit import attach_bounds, dit_forward, init_dit_params

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
    assert counts == _counts(proj=4, flash_fixed=3, flash_online=1, out_proj=4, ff=2)
    err = float((v_k - v_p).abs().max())
    assert err <= 5e-2 * float(v_p.abs().max()), err


def test_dit_forward_kernels_match_plain(gen):
    from rap_tpu_torch.models.config import DiTConfig

    _dit_forward_matches_plain(gen, DiTConfig(num_layers=2, attn_impl="pallas"))


def test_dit_forward_kernels_match_plain_at_head_width_32(gen):
    """A D = 512, 16-head model (dh = 32, which rap_tpu's fused branch
    takes): dit_forward through every forward kernel (the attention kernels
    on heads zero-padded to 64) against the plain versions, with the checks
    of ``test_dit_forward_kernels_match_plain``."""
    from rap_tpu_torch.models.config import DiTConfig

    _dit_forward_matches_plain(gen, DiTConfig(num_heads=16, num_layers=2, attn_impl="pallas"))


def test_dit_forward_kernels_match_plain_at_head_width_96(gen):
    """A D = 768, 8-head model (dh = 96, which rap_tpu's fused branch takes):
    dit_forward through every forward kernel (the attention kernels on
    heads zero-padded to 128) against the plain versions, with the checks
    of ``test_dit_forward_kernels_match_plain``."""
    from rap_tpu_torch.models.config import DiTConfig

    _dit_forward_matches_plain(gen, DiTConfig(embed_dim=768, num_heads=8, num_layers=2,
                                              attn_impl="pallas"))


def test_padded_dit_forward_fused_branch_matches_unfused(gen, monkeypatch):
    """A padded (2, 4, 4096) batch at rap_10's widths (D = 512, H = 8, FF
    2048; 2 layers): dit_forward takes the fused branch (rows 1 and 4 around
    the masked online forward) and, with the guard patched to refuse every
    sequence, the unfused one (AdaLN, linears and qk-norm in PyTorch around
    the same masked forward). The valid rows agree within the bf16 rule of
    ``_dit_forward_matches_plain``; the launch counts show each route."""
    from rap_tpu_torch import telemetry
    from rap_tpu_torch.core.batch import make_regular_synthetic_batch
    from rap_tpu_torch.models import dit
    from rap_tpu_torch.models.config import DiTConfig

    cfg = DiTConfig(num_layers=2)
    params = dit.init_dit_params(0, cfg)
    Sb, Pb, Nb = 2, 4, 4096
    batch = make_regular_synthetic_batch(1, [[4096, 3000, 2600, 3500], [4000, 2700, 3300]],
                                         N=Nb, P=Pb, S=Sb)
    assert not batch.no_padding
    x = torch.randn((Sb * Pb, Nb, 3), generator=gen, device="cuda")
    ts = torch.tensor([0.3, 0.8], device="cuda")
    out = {}
    for route in ("fused", "unfused"):
        if route == "unfused":
            monkeypatch.setattr(dit, "_fused_ok", lambda cfg, seq_len: False)
        reset_launches()
        with telemetry.counted("dit.") as routes:
            out[route] = dit.dit_forward(params, cfg, x, ts, batch, Pb)
        torch.cuda.synchronize()
        assert routes == {route: 4, ("unfused" if route == "fused" else "fused"): 0}
        rows = dict(proj=4, out_proj=4) if route == "fused" else {}
        assert launch_counts() == _counts(flash_online=4, ff=2, **rows), route
    valid = batch.point_mask[..., None]
    v_f, v_u = out["fused"] * valid, out["unfused"] * valid
    assert torch.isfinite(v_f).all()
    err = float((v_f - v_u).abs().max())
    assert err <= 5e-2 * float(v_u.abs().max()), err


def test_training_at_head_width_32_runs_through_every_kernel(gen):
    """Training a D = 512, 16-head model (dh = 32): training_forward +
    autograd through every kernel, the proj backward (row 9) among them
    (``_training_gradients`` checks the launch counts and the loss), every
    gradient leaf against the plain path by the rule of
    ``test_training_gradients_kernels_match_plain``; one Muon step finite."""
    from rap_tpu_torch.models.config import DiTConfig

    cfg = DiTConfig(num_heads=16, num_layers=2, attn_impl="pallas")
    (gk, gp, g32, params, batch), rel = _training_gradients(gen, cfg), _rel_l2
    for k, ref in gp.items():
        assert rel(gk[k], ref) <= max(5e-2, 2 * rel(ref, g32[k])), (k, rel(gk[k], ref),
                                                                  rel(ref, g32[k]))
    _one_step_is_finite(cfg, params, batch)


def test_training_at_head_width_96_refuses_in_attention_backward(gen):
    """Training a D = 768, 8-head model (dh = 96), which the attention
    backward once refused (ROADMAP C8), now runs through every kernel, the
    attention forward and backward at their 128-wide instantiations on heads
    zero-padded to 128: the launch counts and loss of ``_training_gradients``,
    every gradient leaf against the plain path by the rule of
    ``test_training_gradients_kernels_match_plain``; one Muon step finite."""
    from rap_tpu_torch.models.config import DiTConfig

    cfg = DiTConfig(embed_dim=768, num_heads=8, num_layers=2, attn_impl="pallas")
    (gk, gp, g32, params, batch), rel = _training_gradients(gen, cfg), _rel_l2
    for k, ref in gp.items():
        assert rel(gk[k], ref) <= max(5e-2, 2 * rel(ref, g32[k])), (k, rel(gk[k], ref),
                                                                  rel(ref, g32[k]))
    _one_step_is_finite(cfg, params, batch)


def test_training_at_head_width_128_runs_through_every_kernel(gen):
    """Training a D = 1024, 8-head model (dh = 128): rap_tpu's fused guard
    needs dh < 128, so the unfused branch, whose attention takes the masked
    online forward and the fused attention backward at 128 wide, and the
    GEGLU kernels at D = 1024; the gradient rule as above; one Muon step."""
    from rap_tpu_torch.models.config import DiTConfig

    cfg = DiTConfig(embed_dim=1024, num_heads=8, num_layers=2, attn_impl="pallas")
    (gk, gp, g32, params, batch), rel = _training_gradients(
        gen, cfg, _counts(flash_online=8, ff=4, flash_bwd=4, ff_bwd=2)), _rel_l2
    for k, ref in gp.items():
        assert rel(gk[k], ref) <= max(5e-2, 2 * rel(ref, g32[k])), (k, rel(gk[k], ref),
                                                                  rel(ref, g32[k]))
    _one_step_is_finite(cfg, params, batch)


@pytest.mark.parametrize("c", [0.0, 5.0], ids=["softcap0", "softcap5"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("d", [72, 96, 120, 128])
def test_backward_kernels_at_wide_heads(gen, d, masked, c):
    """The fused backward and the split dKV and dQ passes at a head width 64
    < d <= 128 (csrc/attention_bwd_dkv128.cuh, csrc/attention_bwd_dq128.cuh,
    on heads zero-padded to 128) behind the masked online forward, against
    their plain twins on the unpadded heads, BH = 4, T = 384 (an odd number
    of key tiles), a random key mask with one batch row fully masked or
    none; one launch each; the split passes bitwise repeatable."""
    BH, T, heads = 4, 384, 2
    q, k = _randn(gen, BH, T, d, scale=0.4), _randn(gen, BH, T, d, scale=0.4)
    if c > 0.0:
        q = q * (3.0 / c)
    v = _randn(gen, BH, T, d)
    mask = _edge_mask(gen, BH // heads, T, "random") if masked else None
    out, lse = fa.flash_online_kernel(q, k, v, mask, heads, c)
    dout = _randn(gen, BH, T, d)
    sfx = "_softcap" if c > 0.0 else ""
    reset_launches()
    got = fa.flash_bwd_kernel(q, k, v, out, lse, dout, mask, heads, c)
    nd = fa._neg_delta(dout, out)
    args = (q, k, v, dout, nd, lse, mask, heads, c)
    dk, dv = fa.flash_bwd_dkv_kernel(*args)
    dq = fa.flash_bwd_dq_kernel(*args)
    assert launch_counts() == _counts(**{f"flash_bwd{sfx}": 1, f"flash_bwd_dkv{sfx}": 1,
                                         f"flash_bwd_dq{sfx}": 1})
    pmask = None if mask is None else mask.bool()
    for g_, r_ in zip(got, fa.flash_bwd_plain(q, k, v, out, lse, dout, pmask, heads, c)):
        assert g_.shape == q.shape
        _close(g_, r_)
    pargs = (q, k, v, dout, nd, lse, pmask, heads, c)
    for g_, r_ in zip((dk, dv), fa.flash_bwd_dkv_plain(*pargs)):
        _close(g_, r_)
    _close(dq, fa.flash_bwd_dq_plain(*pargs))
    assert torch.equal(dq, fa.flash_bwd_dq_kernel(*args))
    assert all(torch.equal(a, b) for a, b in zip((dk, dv), fa.flash_bwd_dkv_kernel(*args)))


# (D, H) beside the model's (512, 8): every head width class the rule takes
_PROJ_WIDTHS = [(512, 16), (256, 8), (768, 8), (768, 12), (1024, 16), (384, 4), (1920, 16)]


@pytest.mark.parametrize("is_global", [False, True], ids=["part", "global"])
@pytest.mark.parametrize("width,heads", _PROJ_WIDTHS,
                         ids=[f"D{w}-H{h}" for w, h in _PROJ_WIDTHS])
def test_proj_out_kernels_at_every_head_width(gen, width, heads, is_global):
    """Rows 1 and 4 at head widths 32, 64, 96 and 120 (two heads a tile, one
    head over a tile, the gathered tokens of out_proj), against their plain
    versions; row 1 bitwise equal on two calls."""
    G, dh = S * P, width // heads
    x = _randn(gen, G, N, width)
    ada = _randn(gen, G, 2 * width, dtype=torch.float32, scale=0.1)
    w = _randn(gen, width, 3 * width, scale=width ** -0.5)
    gq, gk = fused_proj.fold_gains(1 + _randn(gen, heads, dh, dtype=torch.float32, scale=0.1),
                                   1 + _randn(gen, heads, dh, dtype=torch.float32, scale=0.1))
    args = (x, ada, w, gq, gk, P, is_global)
    got, again = fused_proj.proj_kernel(*args), fused_proj.proj_kernel(*args)
    for g_, r_ in zip(got, fused_proj.proj_plain(*args)):
        _close(g_, r_)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    a5 = _randn(gen, *got[0].shape)
    out_args = (a5, x, _randn(gen, width, width, scale=width ** -0.5),
                _randn(gen, width, scale=0.1), P, is_global)
    _close(fused_proj.out_kernel(*out_args), fused_proj.out_plain(*out_args))


# --------------------------------------------------------------------------
# the forward kernel (csrc/attention.cu) at the edges of its design: one key
# tile (shorter than the TMA ring), an odd number of tiles, one head, and
# masks that leave only the first or only the last key tile live
# --------------------------------------------------------------------------

_FWD_VARIANTS = ("fixed", "online", "online_masked", "fixed_softcap", "online_softcap",
                 "online_masked_softcap")
# (id, BH, Tq, Tk, mask): mask applies to the masked variants only
_FWD_EDGES = (("one_tile", 4, 128, 128, "random"), ("odd_tiles", 4, 384, 384, "random"),
              ("one_head", 1, 256, 512, "random"), ("first_tile_live", 4, 384, 384, "first"),
              ("last_tile_live", 4, 384, 384, "last"))
_FWD_CASES = [(v, e) for v in _FWD_VARIANTS for e in _FWD_EDGES
              if "masked" in v or e[4] == "random"]


def _edge_mask(gen, B, Tk, kind):
    """(B, Tk) int32: random keys with the last batch row fully masked (for
    B > 1), or only some keys of the first or of the last tile of 128."""
    if kind == "random":
        mask = (torch.rand((B, Tk), generator=gen, device="cuda") > 0.4).to(torch.int32)
        if B > 1:
            mask[-1] = 0
        return mask
    mask = torch.zeros((B, Tk), dtype=torch.int32, device="cuda")
    live = slice(0, 128) if kind == "first" else slice(Tk - 128, Tk)
    mask[:, live] = (torch.rand((B, 128), generator=gen, device="cuda") > 0.5).to(torch.int32)
    mask[:, live.start] = 1
    return mask


@pytest.mark.parametrize("variant,edge", _FWD_CASES,
                         ids=[f"{v}-{e[0]}" for v, e in _FWD_CASES])
def test_forward_kernel_edges(gen, variant, edge):
    """Each forward variant (softcap 5 for the softcap ones) against its plain
    twin: out within TOL of max|ref|, lse2 within 2e-2 on live rows, fully
    masked rows exactly 0 and LSE_EMPTY; one launch of its kernel."""
    _, BH, Tq, Tk, kind = edge
    c = 5.0 if variant.endswith("softcap") else 0.0
    heads = 1 if BH == 1 else 2
    if c > 0.0:
        q, k, v = _softcap_inputs(gen, BH, max(Tq, Tk), c)
        q, k, v = q[:, :Tq].contiguous(), k[:, :Tk].contiguous(), v[:, :Tk].contiguous()
    else:
        q, k = _randn(gen, BH, Tq, DH, scale=0.4), _randn(gen, BH, Tk, DH, scale=0.4)
        v = _randn(gen, BH, Tk, DH)
    reset_launches()
    if variant.startswith("fixed"):
        b2 = fa._cap2(c) if c > 0.0 else float((q.float() @ k.float().transpose(1, 2)).max())
        got = fa.flash_fixed_kernel(q, k, v, b2, c)
        ref = fa.flash_fixed_plain(q, k, v, b2, c)
        mask = None
    else:
        mask = _edge_mask(gen, BH // heads, Tk, kind) if "masked" in variant else None
        got = fa.flash_online_kernel(q, k, v, mask, heads, c)
        ref = fa.flash_online_plain(q, k, v, None if mask is None else mask.bool(), heads, c)
    name = ("flash_fixed" if variant.startswith("fixed") else "flash_online") + (
        "_softcap" if c > 0.0 else "")
    assert launch_counts() == _counts(**{name: 1})
    _close(got[0], ref[0])
    live = torch.ones(BH, dtype=torch.bool, device="cuda")
    if mask is not None:
        live = (mask.sum(1) > 0).repeat_interleave(heads)
        assert (got[0][~live] == 0).all() and (got[1][~live] == fa.LSE_EMPTY).all()
    assert float((got[1][live] - ref[1][live]).abs().max()) < 2e-2


@pytest.mark.parametrize("d", [72, 96, 120])
@pytest.mark.parametrize("variant", _FWD_VARIANTS)
def test_forward_kernels_at_wide_heads(gen, variant, d):
    """Each forward variant at a head width 64 < d < 128 (the kernel's
    instantiation at 128, q, k and v zero-padded) against its plain twin on
    the unpadded heads, BH = 4, Tq = Tk = 384, softcap 5 for the softcap
    variants: out within TOL, lse2 within 2e-2 on live rows, one launch."""
    BH, T, heads = 4, 384, 2
    c = 5.0 if variant.endswith("softcap") else 0.0
    q, k = _randn(gen, BH, T, d, scale=0.4), _randn(gen, BH, T, d, scale=0.4)
    if c > 0.0:
        q = q * (3.0 / c)
    v = _randn(gen, BH, T, d)
    reset_launches()
    mask = None
    if variant.startswith("fixed"):
        b2 = fa._cap2(c) if c > 0.0 else float((q.float() @ k.float().transpose(1, 2)).max())
        got = fa.flash_fixed_kernel(q, k, v, b2, c)
        ref = fa.flash_fixed_plain(q, k, v, b2, c)
    else:
        mask = _edge_mask(gen, BH // heads, T, "random") if "masked" in variant else None
        got = fa.flash_online_kernel(q, k, v, mask, heads, c)
        ref = fa.flash_online_plain(q, k, v, None if mask is None else mask.bool(), heads, c)
    name = ("flash_fixed" if variant.startswith("fixed") else "flash_online") + (
        "_softcap" if c > 0.0 else "")
    assert launch_counts() == _counts(**{name: 1})
    assert got[0].shape == q.shape
    _close(got[0], ref[0])
    live = torch.ones(BH, dtype=torch.bool, device="cuda")
    if mask is not None:
        live = (mask.sum(1) > 0).repeat_interleave(heads)
        assert (got[0][~live] == 0).all() and (got[1][~live] == fa.LSE_EMPTY).all()
    assert float((got[1][live] - ref[1][live]).abs().max()) < 2e-2


# --------------------------------------------------------------------------
# backward kernels (tolerance: 1/64 of the largest output, as above)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["fixed", "online"])
def test_flash_bwd_kernel(gen, variant):
    BH, T = 8, 256
    q, k = (_randn(gen, BH, T, DH, scale=0.6) for _ in range(2))
    v = _randn(gen, BH, T, DH)
    if variant == "fixed":
        out, lse = fa.flash_fixed_kernel(q, k, v, 40.0)
    else:
        out, lse = fa.flash_online_kernel(q, k, v)
    dout = _randn(gen, BH, T, DH)
    reset_launches()
    got = fa.flash_bwd_kernel(q, k, v, out, lse, dout)
    assert launch_counts()["flash_bwd"] == 1
    for g_, r_ in zip(got, fa.flash_bwd_plain(q, k, v, out, lse, dout)):
        _close(g_, r_)


# (D, H, N, layouts): the model's shape, every width of _PROJ_WIDTHS, and a
# global layout whose N = 192 is not a multiple of 128 (P*N is)
_PROJ_BWD_CASES = ([(D, H, N, g) for g in (False, True)]
                   + [(w, h, N, g) for w, h in _PROJ_WIDTHS for g in (False, True)]
                   + [(D, H, 192, True)])


@pytest.mark.parametrize("width,heads,n,is_global", _PROJ_BWD_CASES,
                         ids=[f"D{w}-H{h}-N{n}-{'global' if g else 'part'}"
                              for w, h, n, g in _PROJ_BWD_CASES])
def test_proj_bwd_kernel(gen, width, heads, n, is_global):
    """Row 9 (csrc/proj_bwd.cu) at every head width the forward takes: its
    five outputs against proj_bwd_plain within TOL, one launch, and bitwise
    equal on two calls (no atomics)."""
    G, dh = S * P, width // heads
    x = _randn(gen, G, n, width)
    ada = _randn(gen, G, 2 * width, dtype=torch.float32, scale=0.1)
    w = _randn(gen, width, 3 * width, scale=width ** -0.5)
    gq, gk = fused_proj.fold_gains(1 + _randn(gen, heads, dh, dtype=torch.float32, scale=0.1),
                                   1 + _randn(gen, heads, dh, dtype=torch.float32, scale=0.1))
    lead = (S, heads, P, n) if is_global else (G, heads, n)
    dq, dk = _randn(gen, *lead, dh), _randn(gen, *lead, dh)
    dv = _randn(gen, *lead, dh)
    args = (x, ada, w, gq, gk, dq, dk, dv, P, is_global)
    reset_launches()
    got = fused_proj.proj_bwd_kernel(*args)
    assert launch_counts() == _counts(proj_bwd=1)
    for g_, r_ in zip(got, fused_proj.proj_bwd_plain(*args)):
        assert g_.dtype == r_.dtype and g_.shape == r_.shape
        _close(g_, r_)
    assert all(torch.equal(a, b) for a, b in zip(got, fused_proj.proj_bwd_kernel(*args)))


def test_ff_bwd_kernel(gen):
    T = S * P * N
    x, g = _randn(gen, T, D), _randn(gen, T, D, scale=0.1)
    args = (x, g, 1 + _randn(gen, D, dtype=torch.float32, scale=0.1),
            _randn(gen, D, dtype=torch.float32, scale=0.1),
            _randn(gen, D, 2 * FH, scale=D ** -0.5),
            _randn(gen, 2 * FH, dtype=torch.float32, scale=0.1),
            _randn(gen, FH, D, scale=FH ** -0.5))
    got = fused_ff.ff_bwd_kernel(*args)
    for g_, r_ in zip(got, fused_ff.ff_bwd_plain(*args)):
        assert g_.dtype == r_.dtype and g_.shape == r_.shape
        _close(g_, r_)


def test_training_gradients_kernels_match_plain(gen):
    """training_forward + autograd of a 2-layer D=512 model through the
    kernels and through the plain versions, same parameters and draws: loss
    within 2e-2 relative; every gradient leaf within 5e-2 relative L2 of the
    plain path's, or within twice the distance of the plain bf16 path from
    the plain fp32 one where bf16 alone moves a leaf further (the qk gains'
    gradients, sums over all tokens that nearly cancel); then one Muon step
    through the kernels stays finite."""
    from rap_tpu_torch.models.config import DiTConfig

    cfg = DiTConfig(num_layers=2, attn_impl="pallas")  # the fused branch at N=128
    (gk, gp, g32, params, batch), rel = _training_gradients(gen, cfg), _rel_l2
    for k, ref in gp.items():
        assert rel(gk[k], ref) <= max(5e-2, 2 * rel(ref, g32[k])), (k, rel(gk[k], ref),
                                                                  rel(ref, g32[k]))
    _one_step_is_finite(cfg, params, batch)


def _rel_l2(a, b):
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def _training_gradients(gen, cfg, launches=None):
    """Every gradient leaf of training_forward for a 2-layer model of
    ``cfg`` (one online attention per forward on the fused branch) through
    the kernels, the plain versions and the plain fp32 path at the same
    draws: (kernels, plain, fp32), the parameters and the batch, after
    checking the kernel launches (the fused branch's, or ``launches``) and
    the loss (within 2e-2 relative of the plain path's)."""
    import dataclasses

    from rap_tpu_torch.core.batch import make_regular_synthetic_batch
    from rap_tpu_torch.models.dit import init_dit_params
    from rap_tpu_torch.registration import RPFConfig, training_forward
    from rap_tpu_torch.train.optim import tree_paths, tree_replace

    params = init_dit_params(0, cfg, masters=True)
    params["layers"][0]["global_q_gamma"] *= 3  # one online attention per forward
    params["layers"][0]["global_k_gamma"] *= 3
    batch = make_regular_synthetic_batch(1, [[N] * P] * S, N=N, P=P)
    x_1 = torch.randn((S * P, N, 3), generator=gen, device="cuda")
    t = torch.tensor([0.3, 0.95], device="cuda")
    out = {}
    for name, c in (("kernels", cfg), ("plain", dataclasses.replace(cfg, use_kernels=False)),
                    ("fp32", dataclasses.replace(cfg, use_kernels=False,
                                                 compute_dtype=torch.float32))):
        leaves = {k: p.detach().requires_grad_(True) for k, p in tree_paths(params)}
        reset_launches()
        loss, _ = training_forward(tree_replace(params, leaves), RPFConfig(model=c), batch,
                                   None, x_1=x_1, t=t)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        out[name] = (float(loss.detach()), dict(zip(leaves, grads)), launch_counts())
    (lk, gk, ck), (lp, gp, cp), (_, g32, _) = out["kernels"], out["plain"], out["fp32"]
    assert ck == (launches or _counts(proj=8, flash_fixed=6, flash_online=2, out_proj=8,
                                      ff=4, flash_bwd=4, proj_bwd=4, ff_bwd=2))
    assert sum(cp.values()) == 0
    assert abs(lk - lp) <= 2e-2 * abs(lp)
    return gk, gp, g32, params, batch


def _one_step_is_finite(cfg, params, batch):
    """One Muon step of ``params`` on ``batch`` through the kernels."""
    from rap_tpu_torch.registration import RPFConfig
    from rap_tpu_torch.train.optim import OptimizerConfig
    from rap_tpu_torch.train.step import TrainState, make_train_step

    state = TrainState.create(params, OptimizerConfig(), seed=0)
    state, m = make_train_step(RPFConfig(model=cfg), OptimizerConfig())(state, batch)
    assert float(m["skipped_nonfinite"]) == 0.0 and torch.isfinite(m["loss"])


@pytest.mark.parametrize("width,heads", [(768, 12), (256, 4)], ids=["D768-H12", "D256-H4"])
def test_other_model_widths_run_through_kernels(gen, width, heads):
    """Models of width 768 (12 heads) and 256 (4 heads), head width 64, as
    rap_tpu runs them on its kernels (the FF kernels took only D = 512
    before they took every width rap_tpu's rule admits): dit_forward
    through the kernels within 5e-2 of the plain path, as at D = 512; the
    loss of a training forward within 2e-2; every gradient leaf within 5e-2
    relative L2 of the plain path's, or no further from the plain fp32
    gradient than twice the plain bf16 path is (the kernels no worse than
    bf16 itself: the qk gains' gradients are sums that nearly cancel, and
    any set of kernels moves them 5-15% at these widths); one Muon step
    finite."""
    from rap_tpu_torch.models.config import DiTConfig

    cfg = DiTConfig(embed_dim=width, num_heads=heads, num_layers=2, attn_impl="pallas")
    _dit_forward_matches_plain(gen, cfg)
    (gk, gp, g32, params, batch), rel = _training_gradients(gen, cfg), _rel_l2
    for k, ref in gp.items():
        assert (rel(gk[k], ref) <= 5e-2
                or rel(gk[k], g32[k]) <= 2 * rel(ref, g32[k])), (k, rel(gk[k], ref),
                                                                 rel(gk[k], g32[k]),
                                                                 rel(ref, g32[k]))
    _one_step_is_finite(cfg, params, batch)


@pytest.mark.parametrize("T,D,FH", [(128, 256, 1024), (512, 768, 3072), (128, 1024, 4096),
                                    (256, 384, 320), (256, 256, 192)])
def test_ff_kernels_at_every_width(gen, T, D, FH):
    """Rows 5 and 10 at widths beside the model's, hidden widths that are odd
    multiples of 64 among them (dwo's last tile then lies half outside the
    matrix): against their twins, and the backward bitwise equal on two
    calls (its sums over tokens are added in a fixed order)."""
    args = (_randn(gen, T, D), 1 + _randn(gen, D, dtype=torch.float32, scale=0.1),
            _randn(gen, D, dtype=torch.float32, scale=0.1),
            _randn(gen, D, 2 * FH, scale=D ** -0.5), _randn(gen, 2 * FH, scale=0.1),
            _randn(gen, FH, D, scale=FH ** -0.5), _randn(gen, D, scale=0.1))
    _close(fused_ff.ff_kernel(*args), fused_ff.ff_plain(*args))
    bargs = (args[0], _randn(gen, T, D, scale=0.1), args[1], args[2], args[3],
             args[4].float(), args[5])
    got, again = fused_ff.ff_bwd_kernel(*bargs), fused_ff.ff_bwd_kernel(*bargs)
    for g_, a_, r_ in zip(got, again, fused_ff.ff_bwd_plain(*bargs)):
        assert g_.dtype == r_.dtype and g_.shape == r_.shape
        assert torch.equal(g_, a_)
        _close(g_, r_)


# --------------------------------------------------------------------------
# the split backward (rows 7-8) and the masked fused backward (row 6)
# --------------------------------------------------------------------------

def _bwd_inputs(gen, BH, T):
    q, k = (_randn(gen, BH, T, DH, scale=0.6) for _ in range(2))
    return q, k, _randn(gen, BH, T, DH)


def _key_mask(gen, B, T):
    """Random keys, the first 256 of row 0 masked (whole key blocks of every
    backward pass) and the last row fully masked."""
    mask = (torch.rand((B, T), generator=gen, device="cuda") > 0.3).to(torch.int32)
    mask[0, :256] = 0
    mask[-1] = 0
    return mask


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_split_backward_kernels(gen, masked):
    heads, B, T = 2, 4, 512
    q, k, v = _bwd_inputs(gen, B * heads, T)
    mask = _key_mask(gen, B, T) if masked else None
    out, lse = fa.flash_online_kernel(q, k, v, mask, heads)
    dout = _randn(gen, B * heads, T, DH)
    args = (q, k, v, dout, fa._neg_delta(dout, out), lse, mask, heads)
    reset_launches()
    dk, dv = fa.flash_bwd_dkv_kernel(*args)
    dq = fa.flash_bwd_dq_kernel(*args)
    counts = launch_counts()
    assert counts["flash_bwd_dkv"] == counts["flash_bwd_dq"] == 1
    rk, rv = fa.flash_bwd_dkv_plain(*args)
    for g_, r_ in ((dq, fa.flash_bwd_dq_plain(*args)), (dk, rk), (dv, rv)):
        _close(g_, r_)
    dk2, dv2 = fa.flash_bwd_dkv_kernel(*args)
    assert torch.equal(dq, fa.flash_bwd_dq_kernel(*args))  # no atomics: bitwise
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    if masked:
        empty = slice((B - 1) * heads, B * heads)
        assert not dq[empty].any() and not dk[empty].any() and not dv[empty].any()
        dead = (mask == 0).repeat_interleave(heads, dim=0)
        assert not dk[dead].any() and not dv[dead].any()


def test_masked_fused_backward_kernel(gen):
    heads, B, T = 2, 4, 512
    q, k, v = _bwd_inputs(gen, B * heads, T)
    mask = _key_mask(gen, B, T)
    out, lse = fa.flash_online_kernel(q, k, v, mask, heads)
    dout = _randn(gen, B * heads, T, DH)
    reset_launches()
    got = fa.flash_bwd_kernel(q, k, v, out, lse, dout, mask, heads)
    assert launch_counts()["flash_bwd"] == 1
    for g_, r_ in zip(got, fa.flash_bwd_plain(q, k, v, out, lse, dout, mask, heads)):
        _close(g_, r_)
    empty = slice((B - 1) * heads, B * heads)
    assert all(not g[empty].any() for g in got)


def test_kernels_launch_on_their_tensors_device():
    """Tensors on cuda:1 while cuda:0 is current: every launch runs on the
    tensors' device and stream (the wrappers make it current)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    gen = torch.Generator().manual_seed(3)
    dev = torch.device("cuda", 1)
    heads, B, T = 2, 2, 256
    q, k = ((torch.randn((B * heads, T, DH), generator=gen) * 0.6).to(dev, torch.bfloat16)
            for _ in range(2))
    v = torch.randn((B * heads, T, DH), generator=gen).to(dev, torch.bfloat16)
    mask = (torch.rand((B, T), generator=gen) > 0.3).to(dev, torch.int32)
    dout = torch.randn((B * heads, T, DH), generator=gen).to(dev, torch.bfloat16)
    with torch.cuda.device(0):
        out, lse = fa.flash_online_kernel(q, k, v, mask, heads)
        nd = fa._neg_delta(dout, out)
        dq = fa.flash_bwd_dq_kernel(q, k, v, dout, nd, lse, mask, heads)
        fused = fa.flash_bwd_kernel(q, k, v, out, lse, dout, mask, heads)
        torch.cuda.synchronize(dev)
    assert out.device == dq.device == dev
    _close(out, fa.flash_online_plain(q, k, v, mask, heads)[0])
    _close(dq, fa.flash_bwd_dq_plain(q, k, v, dout, nd, lse, mask, heads))
    _close(fused[0], dq)


# --------------------------------------------------------------------------
# the softcap variants of rows 2, 3, 6, 7 and 8, and apps.sample
# --------------------------------------------------------------------------

def _softcap_inputs(gen, BH, T, c):
    """qk-norm rows at gain 3, q pre-scaled by scale/c: |q.k| up to 72/c."""
    def rows(norm):
        x = torch.randn((BH, T, DH), generator=gen, device="cuda")
        return (x / x.norm(dim=-1, keepdim=True) * norm).to(torch.bfloat16)

    return rows(3.0 / c), rows(24.0), _randn(gen, BH, T, DH)


@pytest.mark.parametrize("c", [5.0, 50.0])
def test_softcap_forward_kernels(gen, c):
    """c = 5: the fixed-bound variant (bound 5 log2 e); c = 50: online, with
    and without a key mask."""
    heads, B, T = 2, 4, 512
    q, k, v = _softcap_inputs(gen, B * heads, T, c)
    b2 = fa._cap2(c)
    reset_launches()
    o_k, l_k = fa.flash_fixed_kernel(q, k, v, b2, c)
    o_p, l_p = fa.flash_fixed_plain(q, k, v, b2, c)
    _close(o_k, o_p)
    assert float((l_k - l_p).abs().max()) < 2e-2
    mask = _key_mask(gen, B, T)
    for m in (None, mask):
        o_k, l_k = fa.flash_online_kernel(q, k, v, m, heads, c)
        o_p, _ = fa.flash_online_plain(q, k, v, m, heads, c)
        _close(o_k, o_p)
    assert launch_counts() == _counts(flash_fixed_softcap=1, flash_online_softcap=2)
    assert (o_k[(B - 1) * heads:] == 0).all()


@pytest.mark.parametrize("c", [5.0, 50.0])
def test_softcap_backward_kernels(gen, c):
    """Row 6 (fused) and rows 7-8 (split) with a key mask: each against its
    softcap twin; the split passes bitwise repeatable; the fused dQ against
    the split one."""
    heads, B, T = 2, 4, 512
    q, k, v = _softcap_inputs(gen, B * heads, T, c)
    mask = _key_mask(gen, B, T)
    out, lse = fa.flash_online_kernel(q, k, v, mask, heads, c)
    dout = _randn(gen, B * heads, T, DH)
    args = (q, k, v, dout, fa._neg_delta(dout, out), lse, mask, heads)
    reset_launches()
    fused = fa.flash_bwd_kernel(q, k, v, out, lse, dout, mask, heads, c)
    dk, dv = fa.flash_bwd_dkv_kernel(*args, c)
    dq = fa.flash_bwd_dq_kernel(*args, c)
    assert launch_counts() == _counts(flash_bwd_softcap=1, flash_bwd_dkv_softcap=1,
                                      flash_bwd_dq_softcap=1)
    for g_, r_ in zip(fused, fa.flash_bwd_plain(q, k, v, out, lse, dout, mask, heads, c)):
        _close(g_, r_)
    rk, rv = fa.flash_bwd_dkv_plain(*args, c)
    for g_, r_ in ((dq, fa.flash_bwd_dq_plain(*args, c)), (dk, rk), (dv, rv)):
        _close(g_, r_)
    assert torch.equal(dq, fa.flash_bwd_dq_kernel(*args, c))
    _close(fused[0], dq)


@pytest.mark.parametrize("c", [0.0, 5.0])
def test_sample_app_launch_counts(gen, c):
    """apps.sample.main on configs/synth_student.yaml at 2 layers with random
    weights (unit gains: every guard bound under 60): softcap 0 runs the
    fused branch's five kernels (fixed-bound attention), softcap 5 the FF
    kernel and the fixed-bound softcap kernel."""
    from pathlib import Path

    from rap_tpu_torch.apps import sample as app

    root = Path(__file__).resolve().parent.parent
    rec = {}
    reset_launches()
    app.main(["--config", str(root / "configs/synth_student.yaml"), "-o", "checkpoint=",
              "-o", f"data.datasets.0.data_path={root / 'demo_data/synth'}",
              "-o", "model.num_layers=2", "-o", f"model.softcap={c}"], record=rec)
    forwards = len(rec["batch_gen_ms"]) * 4  # 4 Euler steps, one generation
    fits = len(rec["batch_gen_ms"]) * 5  # the 4 steps' forcing and the pose fit a batch
    if c == 0.0:
        expected = _counts(proj=4 * forwards, flash_fixed=4 * forwards, out_proj=4 * forwards,
                           ff=2 * forwards, kabsch=fits)
    else:
        expected = _counts(flash_fixed_softcap=4 * forwards, ff=2 * forwards, kabsch=fits)
    assert launch_counts() == expected
    assert rec["pairs"] == 8


# --------------------------------------------------------------------------
# the key-block backward (rows 6 and 7, csrc/attention_bwd_dkv.cuh) at small
# odd shapes and the edges of its design
# --------------------------------------------------------------------------

_KB_BH, _KB_TQ, _KB_TK = 3, 192, 256  # three heads, 3 query steps, 2 key blocks


def _edge_key_mask(gen):
    """(3, 256) int32: row 0 has a dead first key block and one valid key in
    its second, row 1 random keys, row 2 every key masked."""
    mask = (torch.rand((_KB_BH, _KB_TK), generator=gen, device="cuda") > 0.3).to(torch.int32)
    mask[0] = 0
    mask[0, 200] = 1
    mask[2] = 0
    return mask


@pytest.mark.parametrize("c", [0.0, 5.0, 50.0])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "edges"])
def test_key_block_backward_kernels(gen, c, masked):
    """Rows 6 (fused) and 7 (dKV pass) against their plain twins at BH=3,
    Tq=192, Tk=256, within TOL of the largest output: unmasked, and with a
    dead key block, a block with one valid key and a fully masked head; the
    rows of two query steps carry lse2 = LSE_EMPTY (p = 0 there). Row 7 is
    bitwise repeatable; dead and masked keys get exactly zero dK, dV."""
    BH, Tq, Tk = _KB_BH, _KB_TQ, _KB_TK
    if c > 0.0:
        q, k, v = _softcap_inputs(gen, BH, Tk, c)
    else:
        q, k, v = _bwd_inputs(gen, BH, Tk)
    q = q[:, :Tq].contiguous()
    mask = _edge_key_mask(gen) if masked else None
    out, lse = fa.flash_online_plain(q, k, v, mask, 1, c)  # the forward takes Tq % 128
    lse[:, 70:130] = fa.LSE_EMPTY
    dout = _randn(gen, BH, Tq, DH)
    args = (q, k, v, dout, fa._neg_delta(dout, out), lse, mask, 1, c)
    reset_launches()
    fused = fa.flash_bwd_kernel(q, k, v, out, lse, dout, mask, 1, c)
    dk, dv = fa.flash_bwd_dkv_kernel(*args)
    sfx = "_softcap" if c > 0.0 else ""
    assert launch_counts() == _counts(**{f"flash_bwd{sfx}": 1, f"flash_bwd_dkv{sfx}": 1})
    for g_, r_ in zip(fused, fa.flash_bwd_plain(q, k, v, out, lse, dout, mask, 1, c)):
        _close(g_, r_)
    rk, rv = fa.flash_bwd_dkv_plain(*args)
    _close(dk, rk)
    _close(dv, rv)
    dk2, dv2 = fa.flash_bwd_dkv_kernel(*args)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert not fused[0][:, 70:130].any()  # p = 0 on the LSE_EMPTY rows: no dQ
    if masked:
        dead = (mask == 0)
        for g_ in (fused[1], fused[2], dk, dv):
            assert not g_[dead].any()
        assert fused[1][0, 200].any() and dk[0, 200].any()  # the one valid key


def test_key_block_backward_refuses_what_it_does_not_take(gen):
    """Tk not a multiple of 128, Tq not a multiple of 64, an unaligned dO:
    the wrappers raise before any launch."""
    q, k, v = _bwd_inputs(gen, 2, 256)
    out, lse = fa.flash_online_kernel(q, k, v)
    dout = _randn(gen, 2, 256, DH)
    nd = fa._neg_delta(dout, out)
    reset_launches()
    with pytest.raises(ValueError, match="Tk % 128"):
        fa.flash_bwd_dkv_kernel(q, k[:, :192].contiguous(), v[:, :192].contiguous(), dout, nd,
                                lse)
    with pytest.raises(ValueError, match="multiples of 64"):
        fa.flash_bwd_kernel(q[:, :96].contiguous(), k, v, out[:, :96].contiguous(),
                            lse[:, :96].contiguous(), dout[:, :96].contiguous())
    odd = torch.zeros(dout.numel() + 1, device="cuda", dtype=torch.bfloat16)[1:]
    odd = odd.view(dout.shape).copy_(dout)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        fa.flash_bwd_kernel(q, k, v, out, lse, odd)
    assert launch_counts() == _counts()


# --------------------------------------------------------------------------
# the dQ pass (row 8, csrc/attention_bwd_dq.cuh) at the edges of its design:
# the forward edges' shapes and masks, at softcap 0 and 5
# --------------------------------------------------------------------------

_DQ_CASES = [(e, c) for e in _FWD_EDGES for c in (0.0, 5.0)]


@pytest.mark.parametrize("edge,c", _DQ_CASES, ids=[f"{e[0]}-c{c:g}" for e, c in _DQ_CASES])
def test_dq_pass_edges(gen, edge, c):
    """Row 8 (8s at c = 5) against flash_bwd_dq_plain within TOL of the
    largest output: one key tile (shorter than the TMA ring), an odd number
    of tiles, one head, only the first or only the last key tile live; with
    the key mask (a random one fully masks the last batch row, whose dq must
    be exactly 0: the kernel writes it, nothing zero-fills) and, where the
    mask is random, without one. Bitwise repeatable; one launch each."""
    _, BH, Tq, Tk, kind = edge
    heads = 1 if BH == 1 else 2
    if c > 0.0:
        q, k, v = _softcap_inputs(gen, BH, max(Tq, Tk), c)
        q, k, v = q[:, :Tq].contiguous(), k[:, :Tk].contiguous(), v[:, :Tk].contiguous()
    else:
        q, k = _randn(gen, BH, Tq, DH, scale=0.4), _randn(gen, BH, Tk, DH, scale=0.4)
        v = _randn(gen, BH, Tk, DH)
    dout = _randn(gen, BH, Tq, DH)
    mask = _edge_mask(gen, BH // heads, Tk, kind)
    name = "flash_bwd_dq_softcap" if c > 0.0 else "flash_bwd_dq"
    for m in (mask, None) if kind == "random" else (mask,):
        out, lse = fa.flash_online_kernel(q, k, v, m, heads, c)
        args = (q, k, v, dout, fa._neg_delta(dout, out), lse, m, heads, c)
        reset_launches()
        dq = fa.flash_bwd_dq_kernel(*args)
        assert launch_counts() == _counts(**{name: 1})
        _close(dq, fa.flash_bwd_dq_plain(*args))
        assert torch.equal(dq, fa.flash_bwd_dq_kernel(*args))
        if m is not None:
            empty = (m.sum(1) == 0).repeat_interleave(heads)
            assert not dq[empty].any()


# --------------------------------------------------------------------------
# the demo path: point ops and MiniSpinNet on the card against the CPU, and
# apps.demo through the kernels (rows 3 and 5) against the plain versions
# --------------------------------------------------------------------------

def test_point_ops_on_card_match_cpu(gen):
    """kNN, ball query and FPS on the card: indices equal to the CPU's,
    squared distances within 1e-5."""
    from rap_tpu_torch.ops import points as pts_ops

    g = torch.Generator().manual_seed(1)
    pts = torch.rand((3000, 3), generator=g)
    mask = torch.rand(3000, generator=g) < 0.9
    q = pts[:700]
    d2, idx = pts_ops.knn(q, pts, mask, 8, chunk=256)
    d2_c, idx_c = pts_ops.knn(q.cuda(), pts.cuda(), mask.cuda(), 8, chunk=256)
    assert torch.equal(idx_c.cpu(), idx)
    assert float((d2_c.cpu() - d2).abs().max()) <= 1e-5
    for a, b in zip(pts_ops.ball_query(q, pts, mask, 0.05, 32),
                    pts_ops.ball_query(q.cuda(), pts.cuda(), mask.cuda(), 0.05, 32)):
        assert torch.equal(b.cpu(), a)
    parts, pmask = pts.reshape(3, 1000, 3), mask.reshape(3, 1000)
    assert torch.equal(pts_ops.farthest_point_sampling(parts.cuda(), pmask.cuda(), 64).cpu(),
                       pts_ops.farthest_point_sampling(parts, pmask, 64))


@pytest.mark.parametrize("aligned", [True, False])
def test_spinnet_on_card_matches_cpu_with_tf32_on(gen, aligned):
    """MiniSpinNet states full fp32 itself: with TF32 allowed globally its
    descriptors on the card stay within 1e-4 of the CPU's."""
    import dataclasses

    import numpy as np

    from rap_tpu_torch.spinnet import SpinNetConfig, extract_features, init_spinnet

    cfg = dataclasses.replace(SpinNetConfig(), is_aligned_to_global_z=aligned)
    cloud = np.random.default_rng(2).uniform(-1, 1, (4000, 3)).astype(np.float32)
    kps = cloud[::20]
    ref = extract_features(init_spinnet(1, cfg, device="cpu"), cloud, kps, 0.4)
    assert np.abs(np.linalg.norm(ref, axis=1) - 1.0).max() <= 1e-4
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        got = extract_features(init_spinnet(1, cfg, device="cuda"), cloud, kps, 0.4)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    assert float(np.abs(got - ref).max()) <= 1e-4


def test_demo_runs_through_rows_3_and_5(gen, tmp_path):
    """apps.demo on the bundled pair at rap_12's width (one layer, 2 steps):
    the masked online attention (row 3) and the FF (row 5) launch, the plain
    run launches no kernel of the model (the Kabsch fits run the kernel on
    either), and the transforms agree within 2e-2."""
    import numpy as np

    from rap_tpu_torch.apps import demo

    argv = ["--num-steps", "2", "-o", "model.num_layers=1", "--features", "geometric"]
    reset_launches()
    assert demo.main(argv + ["-out", str(tmp_path / "k")]) == 0
    counts = launch_counts()
    assert counts["flash_online"] > 0 and counts["ff"] > 0
    reset_launches()
    assert demo.main(argv + ["-out", str(tmp_path / "p"), "-o", "model.use_kernels=false"]) == 0
    assert launch_counts() == _counts(kabsch=launch_counts()["kabsch"])
    assert launch_counts()["kabsch"] == counts["kabsch"] > 0
    for p in range(2):
        got = np.loadtxt(tmp_path / "k" / f"part{p}_transform.txt")
        ref = np.loadtxt(tmp_path / "p" / f"part{p}_transform.txt")
        assert np.abs(got[:3, :3] - ref[:3, :3]).max() <= 2e-2


def test_dropout_masks_on_the_card_are_seeded_and_kept_through_remat(gen):
    """A dropout seed draws the same Philox mask every time (the remat
    recompute's draw), with the keep rate asked for; a dropout step takes
    the plain FF composition, so rows 5 and 10 never launch, and it is
    finite with remat on and equal to the step without remat."""
    from rap_tpu_torch.models.config import DiTConfig
    from rap_tpu_torch.models.dit import init_dit_params, keep_mask
    from rap_tpu_torch.registration import RPFConfig
    from rap_tpu_torch.train.optim import OptimizerConfig, tree_paths
    from rap_tpu_torch.train.step import TrainState, make_train_step

    a = keep_mask((S * P, N, FH), 0.1, 1234, torch.device("cuda"))
    assert torch.equal(a, keep_mask((S * P, N, FH), 0.1, 1234, torch.device("cuda")))
    assert not torch.equal(a, keep_mask((S * P, N, FH), 0.1, 1235, torch.device("cuda")))
    assert abs(float(a.float().mean()) - 0.9) < 5e-3
    from rap_tpu_torch.core.batch import make_regular_synthetic_batch

    cfg = RPFConfig(model=DiTConfig(num_layers=2, dropout_rate=0.1))
    batch = make_regular_synthetic_batch(0, [[N] * P] * S, N=N, P=P, S=S, device="cuda")
    params = init_dit_params(0, cfg.model, device="cuda", masters=True)
    out = []
    for remat in (True, False):
        reset_launches()
        state = TrainState.create(params, OptimizerConfig(), seed=3)
        state, m = make_train_step(cfg, OptimizerConfig(), remat=remat)(state, batch)
        torch.cuda.synchronize()
        counts = launch_counts()
        assert counts["ff"] == counts["ff_bwd"] == 0, counts
        assert float(m["skipped_nonfinite"]) == 0.0 and torch.isfinite(m["loss"])
        out.append((float(m["loss"]), dict(tree_paths(state.params))))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-3)
    for k, v in out[0][1].items():
        assert torch.isfinite(v).all(), k


def test_pose_loss_step_on_the_card_matches_plain(gen):
    """A pose-loss step on a padded batch with 1- and 2-point parts: the
    loss and pose loss through the kernels within 2e-2 of the plain
    versions', every gradient finite, nothing skipped."""
    import dataclasses

    from rap_tpu_torch.core.batch import make_regular_synthetic_batch
    from rap_tpu_torch.models.config import DiTConfig
    from rap_tpu_torch.models.dit import init_dit_params
    from rap_tpu_torch.registration import RPFConfig
    from rap_tpu_torch.train.optim import OptimizerConfig
    from rap_tpu_torch.train.step import TrainState, make_train_step

    cfg = RPFConfig(model=DiTConfig(num_layers=2), pose_loss_weight=0.5)
    plain = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, use_kernels=False))
    batch = make_regular_synthetic_batch(1, [[1024, 2], [1, 1024]], N=1024, P=2, S=2,
                                         device="cuda")
    params = init_dit_params(0, cfg.model, device="cuda", masters=True)
    ms = []
    for c in (cfg, plain):
        state = TrainState.create(params, OptimizerConfig(), seed=5)
        _, m = make_train_step(c, OptimizerConfig())(state, batch)
        ms.append({k: float(v) for k, v in m.items()})
    for m in ms:
        assert m["skipped_nonfinite"] == 0.0 and all(map(lambda v: v == v, m.values())), m
    for name in ("loss", "pose_loss", "grad_norm"):
        assert ms[0][name] == pytest.approx(ms[1][name], rel=2e-2), name


# --------------------------------------------------------------------------
# the multi-GPU layer at a world of 1 under nccl
# --------------------------------------------------------------------------

@pytest.fixture
def nccl_mesh(gen, tmp_path):
    """A world of 1 joined under nccl (a file store), left at the end."""
    import torch.distributed as dist

    from rap_tpu_torch.parallel import initialize, make_mesh

    initialize(init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0,
               device="cuda:0", timeout_s=120)
    try:
        yield make_mesh(1, "cuda:0")
    finally:
        dist.destroy_process_group()


def test_ring_attention_at_a_world_of_1_under_nccl(gen, nccl_mesh):
    """One collective over nccl, and the ring at n = 1 against
    batched_attention (the flash route: masked row 3)."""
    from rap_tpu_torch.ops.attention import batched_attention
    from rap_tpu_torch.ops.ring_attention import ring_attention
    from rap_tpu_torch.parallel.mesh import all_reduce_sum

    assert nccl_mesh.backend == "nccl"
    x = torch.arange(8.0, device="cuda")
    assert torch.equal(all_reduce_sum(x, nccl_mesh), x)
    B, T = 2, 1024
    q, k, v = (_randn(gen, B, T, H, DH) for _ in range(3))
    mask = torch.rand((B, T), generator=gen, device="cuda") > 0.3
    reset_launches()
    ref = batched_attention(q, k, v, mask)
    assert launch_counts() == _counts(flash_online=1)
    _close(ring_attention(q, k, v, mask, nccl_mesh), ref)


def test_dp_step_at_a_world_of_1_under_nccl_equals_the_step_without_a_mesh(gen, nccl_mesh):
    """A data-parallel step over a world of 1 (the all-reduce of the loss's
    denominators and of the gradients and metrics run, over nccl) on a
    padded batch: metrics and parameters equal to the step without a mesh."""
    from rap_tpu_torch.core.batch import make_regular_synthetic_batch
    from rap_tpu_torch.models.config import DiTConfig
    from rap_tpu_torch.models.dit import init_dit_params
    from rap_tpu_torch.registration import RPFConfig
    from rap_tpu_torch.train.optim import OptimizerConfig, tree_paths
    from rap_tpu_torch.train.step import TrainState, make_train_step

    cfg = RPFConfig(model=DiTConfig(num_layers=2))
    batch = make_regular_synthetic_batch(1, [[128, 96], [128, 128]], N=128, P=2, S=2,
                                         device="cuda")
    params = init_dit_params(0, cfg.model, device="cuda", masters=True)
    out = []
    for mesh in (None, nccl_mesh):
        state = TrainState.create(params, OptimizerConfig(), seed=5)
        reset_launches()
        state, m = make_train_step(cfg, OptimizerConfig(), mesh=mesh)(state, batch)
        out.append(({k: float(v) for k, v in m.items()}, dict(tree_paths(state.params)),
                    launch_counts()))
    (m0, p0, c0), (m1, p1, c1) = out
    assert m0 == m1 and m0["skipped_nonfinite"] == 0.0
    assert c0 == c1 == _counts(ff=4, ff_bwd=2)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)


def test_sample_processor_spinnet_on_the_card_matches_cpu(gen, tmp_path):
    """dataset_process's SampleProcessor with SpinNet on the card: the same
    keypoints as with the CPU extractor, descriptors within 1e-4 abs (the
    chip_smoke SpinNet rule), no fallback."""
    import numpy as np

    from rap_tpu_torch.dataset_process.extract_features import (SampleProcessor,
                                                                SampleProcessorConfig)
    from rap_tpu_torch.spinnet import build_feature_extractor

    rng = np.random.default_rng(0)
    parts = [rng.uniform(0, 3, (600, 3)).astype(np.float32) for _ in range(2)]
    cfg = SampleProcessorConfig(max_points_per_part=128, min_points_per_part=64, des_r=0.8)
    outs = []
    for device in ("cuda", "cpu"):
        proc = SampleProcessor(cfg, build_feature_extractor(device=device))
        outs.append(proc.process_sample(parts, np.random.default_rng(1)))
        assert proc.fallbacks == {"outlier_removal": 0, "features": 0}
    (kc, fc), (kp, fp) = outs
    assert all(np.array_equal(a, b) for a, b in zip(kc, kp))
    assert max(float(np.abs(a - b).max()) for a, b in zip(fc, fp)) <= 1e-4


def test_reflow_and_synthetic_demo_run_through_the_kernels(gen, tmp_path):
    """apps.train_synthetic_demo (1 layer, 2 steps) and apps.reflow_distill
    (its final state as the teacher, 2 retrain steps) on the card: finite
    losses, the train step's rows launched, and the teacher unchanged."""
    import numpy as np

    from rap_tpu_torch.apps import reflow_distill, train_synthetic_demo
    from rap_tpu_torch.models.config import DiTConfig
    from rap_tpu_torch.models.dit import master_params
    from rap_tpu_torch.train.optim import tree_paths

    argv = ["--scenes", "6", "--points-per-view", "128", "--layers", "1", "--steps", "2",
            "--batch-tokens", "2048", "--eval-steps", "2", "--out", str(tmp_path / "s")]
    rec = {}
    train_synthetic_demo.main(argv, record=rec)
    assert np.isfinite(rec["losses"]).all()
    assert rec["step_launches"][0]["ff"] and rec["step_launches"][0]["ff_bwd"]
    rec = {}
    reflow_distill.main(["--teacher", str(tmp_path / "s" / "ckpts" / "final"), "--data-root",
                         str(tmp_path / "s" / "data"), "--layers", "1", "--steps", "2",
                         "--teacher-steps", "2", "--couple-epochs", "1",
                         "--eval-steps-sweep", "1", "--out", str(tmp_path / "r")], record=rec)
    assert np.isfinite(rec["retrain_losses"]).all()
    assert rec["retrain_launches"][0]["ff_bwd"] and rec["couple_launches"][0]["ff"]
    teacher = reflow_distill.load_model(str(tmp_path / "s" / "ckpts" / "final"),
                                        DiTConfig(num_layers=1), "cuda")
    for (k, a), (_, b) in zip(tree_paths(master_params(teacher, "cuda")),
                              tree_paths(master_params(rec["teacher"], "cuda"))):
        assert torch.equal(a, b), k


def test_graft_entry_forward_on_the_card_matches_plain(gen):
    import dataclasses

    from rap_tpu_torch import graft_entry
    from rap_tpu_torch.models.dit import dit_forward

    fn, args = graft_entry.entry()
    reset_launches()
    v = fn(*args)
    assert launch_counts()["flash_online"] and launch_counts()["ff"]
    cfg, _ = graft_entry.flagship()
    ref = dit_forward(args[0], dataclasses.replace(cfg.model, use_kernels=False), *args[1:],
                      parts_per_sample=2)
    err = float((v - ref).abs().max())
    assert torch.isfinite(v).all() and err <= 5e-2 * float(ref.abs().max()), err


def test_span_holds_the_device_interval_of_its_kernels(gen):
    """A program span and the kernels launched inside it lie on one clock:
    with a synchronise inside the span, its host interval holds theirs."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark import tracing
    from rap_tpu_torch import telemetry

    a = _randn(gen, 2048, 2048, scale=2048 ** -0.5)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with telemetry.span("rap.probe"):
            outs = [a @ a for _ in range(4)]
            torch.cuda.synchronize()
    events = prof.events()
    (host,) = [e for e in events if e.name == "rap.probe" and not tracing._is_device(e)]
    kernels = [e for e in events if tracing._is_device(e) and not tracing._is_annotation(e)]
    assert len(kernels) >= len(outs)
    for k in kernels:
        assert host.time_range.start <= k.time_range.start, k.name
        assert k.time_range.end <= host.time_range.end, k.name


def test_trace_counts_no_program_span_as_device_work(gen):
    """The program's spans mirrored on the device's timeline are not device
    operations in the benchmark's trace."""
    from torch.profiler import record_function

    from benchmark import tracing
    from rap_tpu_torch import telemetry

    a = _randn(gen, 2048, 2048, scale=2048 ** -0.5)
    prof = tracing.start()
    with record_function(tracing.WINDOW_SPAN):
        with telemetry.span("rap.sample"), telemetry.span("rap.step"):
            a @ a
        torch.cuda.synchronize()
    prof.stop()
    tr = tracing.reduce(prof)
    assert tr.kernels and not any(name.startswith("rap.") for name, _, _ in tr.kernels)
    assert tr.busy_s < tr.window_s


def test_serving_syncs_are_the_counted_ones(gen):
    """One serving request (``sample`` with forcing, then ``predict_poses``)
    under ``torch.cuda.set_sync_debug_mode("warn")``: every synchronising
    call warned of is at a site the ``sync.*`` counters count. The Kabsch
    fits run csrc/kabsch.cu, which never waits on the host: no ``sync.svd``
    on the card (cuSOLVER's SVD warned twice a call there), and no warning
    at all."""
    import warnings

    from rap_tpu_torch import telemetry
    from rap_tpu_torch.core.batch import make_regular_synthetic_batch
    from rap_tpu_torch.models.config import DiTConfig
    from rap_tpu_torch.models.dit import init_dit_params
    from rap_tpu_torch.registration import RPFConfig, predict_poses, sample

    steps = 3
    cfg = RPFConfig(model=DiTConfig(num_layers=2), inference_sampling_steps=steps,
                    rigidity_forcing=True, return_end_point_trajectory=False)
    params = init_dit_params(0, cfg.model)
    batch = make_regular_synthetic_batch(1, [[1024] * P] * S, N=1024, P=P)
    x_1 = torch.randn(batch.points.shape, generator=gen, device="cuda")

    def request():
        pts = sample(params, cfg, batch, x_1=x_1, return_trajectory=False)["points"]
        return predict_poses(batch, pts)

    request()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught, telemetry.counted("sync.") as syncs:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            request()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    warned = [w for w in caught if "called a synchronizing" in str(w.message)]
    assert syncs == {"svd": 0, "bounds": 0, "eval": 0}
    assert [(w.filename, w.lineno) for w in warned] == []


# --------------------------------------------------------------------------
# the Kabsch fit (csrc/kabsch.cu)
# --------------------------------------------------------------------------

KABSCH_ATOL = 1e-5


@pytest.mark.parametrize("name", ["random", "one_point", "empty", "reflection", "rank1",
                                  "padded", "two_leading", "weighted", "large"])
def test_kabsch_kernel_matches_plain_path(gen, name):
    """``kabsch_masked`` on the card (one launch of the kernel) against its
    plain path with cuSOLVER's SVD, to 1e-5, bitwise repeatable. A rank-1
    cross-covariance leaves the rotation about the line free: there the
    kernel is held to the plain path through ``svd3`` (the same Jacobi and
    rank-1 axis, exact on this case's numbers), and both it and cuSOLVER's
    fit to their residual."""
    from kabsch_cases import torch_case

    from rap_tpu_torch.core import procrustes

    src, tgt, mask, w = torch_case(name, "cuda")
    reset_launches()
    R, t = procrustes.kabsch_masked(src, tgt, mask, w)
    assert launch_counts() == _counts(kabsch=1)
    R2, t2 = procrustes.kabsch_masked(src, tgt, mask, w)
    assert torch.equal(R, R2) and torch.equal(t, t2)
    svd = procrustes.svd3 if name == "rank1" else torch.linalg.svd
    R_ref, t_ref = procrustes._fit(src, tgt, mask, w, svd)
    assert R.shape == R_ref.shape and t.shape == t_ref.shape
    assert float((R - R_ref).abs().max()) < KABSCH_ATOL
    assert float((t - t_ref).abs().max()) < KABSCH_ATOL
    assert float((torch.linalg.det(R.double()) - 1).abs().max()) < 1e-5
    if name == "rank1":
        R_s, t_s = procrustes._fit(src, tgt, mask, w, torch.linalg.svd)
        for a, b in ((R, t), (R_s, t_s)):
            fit = procrustes.transform_points(a, b, src)
            assert float(torch.where(mask[..., None], fit - tgt, 0.0).abs().max()) < 1e-4


@pytest.mark.parametrize("form", ["broadcast", "float_mask"])
def test_kabsch_kernel_takes_what_the_plain_path_takes(gen, form):
    """``kabsch_masked`` on the card with leading shapes that broadcast (one
    source for three targets) or a mask of weights in [0, 1] with zeros
    (not bool): one launch, and the plain path's fit with cuSOLVER's SVD to
    1e-5."""
    from kabsch_cases import torch_case

    from rap_tpu_torch.core import procrustes

    src, tgt, mask, _ = torch_case("random", "cuda")
    if form == "broadcast":
        args = (src, torch.stack([tgt, tgt + 1.0, tgt.flip(-2)]), mask[0])
    else:
        m = torch.rand(mask.shape, generator=gen, device="cuda")
        args = (src, tgt, torch.where(m > 0.2, m, 0.0))
    reset_launches()
    R, t = procrustes.kabsch_masked(*args)
    assert launch_counts() == _counts(kabsch=1)
    R_ref, t_ref = procrustes._fit(*args, None, torch.linalg.svd)
    assert R.shape == R_ref.shape and t.shape == t_ref.shape
    assert float((R - R_ref).abs().max()) < KABSCH_ATOL
    assert float((t - t_ref).abs().max()) < KABSCH_ATOL


def test_kabsch_forcing_mode_matches_rigidify_and_blend(gen):
    """``forced_state`` on the card (one launch: x_0_hat formed from x_t and
    v) against the plain ``rigidify_prediction`` with cuSOLVER's SVD plus
    the blend, to 1e-5 of each point's scale."""
    from kabsch_cases import torch_case

    from rap_tpu_torch.core import procrustes

    src, tgt, mask, _ = torch_case("padded", "cuda")
    v = torch.randn(tgt.shape, generator=gen, device="cuda")
    x_1 = torch.randn(tgt.shape, generator=gen, device="cuda")
    t, t_next = 0.7, 0.6
    x_t = tgt + v * t
    x_0_hat = x_t - v * t
    R, tr = procrustes._fit(src, x_0_hat, mask, None, torch.linalg.svd)
    rigid = torch.where(mask[..., None], procrustes.transform_points(R, tr, src), x_0_hat)
    want = rigid * (1.0 - t_next) + x_1 * t_next
    reset_launches()
    got = procrustes.forced_state(src, mask, x_1, t_next, x_t, v, t)
    assert launch_counts() == _counts(kabsch=1)
    assert bool(((got - want).abs() <= KABSCH_ATOL * want.abs().clamp_min(1.0)).all())


def test_forcing_sampler_on_the_card_never_syncs(gen):
    """10 Euler steps with rigidity forcing and the pose fit, with no
    trajectory kept, under ``set_sync_debug_mode("error")``: 11 launches of
    the Kabsch kernel, no ``sync.svd``, and the CPU's result (LAPACK's SVD)
    to 1e-4 of each number's scale (the padding sits at 1e3)."""
    import types

    from kabsch_cases import torch_case

    from rap_tpu_torch import telemetry
    from rap_tpu_torch.core.sampler import flow_sampler
    from rap_tpu_torch.registration import predict_poses

    out = {}
    for device in ("cpu", "cuda"):
        src, tgt, mask, _ = torch_case("padded", device)
        x_1 = torch.randn(src.shape, generator=torch.Generator().manual_seed(3)).to(device)

        def field(x, t, tgt=tgt):
            return (x - tgt) / max(t, 1e-3)

        reset_launches()
        with telemetry.counted("sync.") as syncs:
            if device == "cuda":
                torch.cuda.set_sync_debug_mode("error")
            try:
                res = flow_sampler(field, x_1, src, mask, num_steps=10, rigidity_forcing=True,
                                   return_trajectory=False)
                R, t = predict_poses(types.SimpleNamespace(points=src, point_mask=mask),
                                     res.x_final)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        out[device] = (res.x_final.cpu(), R.cpu(), t.cpu(), syncs["svd"], launch_counts())
    assert out["cpu"][3] == 11 and out["cuda"][3] == 0
    assert out["cuda"][4] == _counts(kabsch=11)
    for a, b in zip(out["cuda"][:3], out["cpu"][:3]):
        assert bool(((a - b).abs() <= 1e-4 * b.abs().clamp_min(1.0)).all())
