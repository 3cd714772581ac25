"""benchmark/work.py against counts made by hand."""

from benchmark import work


def test_linear_counts_products_and_bytes_once():
    w = work.linear(4, 8, 16)
    assert w.flops == 2 * 4 * 8 * 16
    assert w.bytes == (4 * 8 + 8 * 16 + 4 * 16) * 2
    assert w.least_s == max(w.flops / work.PEAK_BF16_FLOPS, w.bytes / work.PEAK_BYTES)


def test_attention_forward_and_backward():
    f = work.attention_fwd(2, [3, 5], [3, 5], 8)
    assert f.flops == 4 * 2 * (9 + 25) * 8
    assert f.mufu == 2 * (9 + 25)
    assert f.bytes == 2 * (4 * 3 + 4 * 5) * 8 * 2
    b = work.attention_bwd(2, [3], [4], 8)
    assert b.flops == 8 * 2 * 12 * 8
    assert b.bytes == 2 * (4 * 3 + 4 * 4) * 8 * 2


def test_the_least_time_of_a_sum_is_the_sum_of_each_calls_bound():
    a, b = work.linear(1, 1, 10**6), work.linear(10**4, 10**4, 10**4)
    w = work.Work()
    w += a
    w += b
    assert w.least_s == a.least_s + b.least_s
    assert a.least_s == a.bytes / work.PEAK_BYTES          # bound by bytes
    assert b.least_s == b.flops / work.PEAK_BF16_FLOPS     # bound by operations


def test_dit_forward_by_hand():
    model = {"embed_dim": 16, "num_layers": 2, "num_heads": 2, "ff_hidden": 32,
             "time_embed_channels": 8, "local_feat_dim": 4, "multires": 1}
    s = work.Shape.of(model)
    assert s.embed_input_dim == 2 * 3 * 3 + 3 + 4
    parts = [[5, 3], [4]]
    f = work.dit_forward(s, parts)
    T, G, D, FH, C = 12, 3, 16, 32, 8
    per_layer = 2 * (2 * T * D * 3 * D + 2 * T * D * D) + 2 * T * D * 2 * FH + 2 * T * FH * D
    assert f.linear.flops == 2 * per_layer
    small = 2 * 2 * (2 * G * C * D + 2 * G * D * D + 2 * G * D * 2 * D) + 2 * T * (
        s.embed_input_dim * D + D * D + D * D // 2 + D // 2 * 3)
    assert f.small_linear.flops == small
    att = 2 * 4 * 2 * ((25 + 9 + 16) + (64 + 16)) * 8
    assert f.attention.flops == att
    assert f.flops == 2 * per_layer + small + att


def test_newton_schulz_of_a_wide_matrix():
    w = work.newton_schulz(4, 10, steps=1)
    assert w.flops == 2 * 4 * 10 * 4 + 2 * (2 * 4 * 4 * 10)
