"""The needed-work arithmetic on shapes worked out by hand."""
import pytest

from benchmark import roofline
from benchmark.roofline import HBM, PEAK_BF16, PEAK_INT8, Model

MISTRAL = {"hidden_size": 4096, "num_hidden_layers": 32,
           "num_attention_heads": 32, "num_key_value_heads": 8,
           "intermediate_size": 14336, "vocab_size": 32000}
MIXTRAL = dict(MISTRAL, num_local_experts=8, num_experts_per_tok=2)
B_W = 0.5 + 2 / 128          # q4_j bytes a weight: a nibble, bf16 scales


def test_mistral_decode_token_bytes():
    m = Model(MISTRAL)
    per_layer = 4096 * 4096 * 2 + 4096 * 1024 * 2 + 4096 * 14336 * 3
    weights = (32 * per_layer + 4096 * 32000) * B_W
    # x in and out of each product, bf16, one row
    io = 32 * 2 * (4096 + 4096 + 4096 + 1024 + 4096 + 1024 + 4096 + 4096
                   + 4096 + 14336 + 4096 + 14336 + 14336 + 4096) \
        + 2 * (4096 + 32000)
    got = sum(w.bytes for w in roofline.decode_products(m, 1))
    assert got == pytest.approx(weights + io)
    assert weights == pytest.approx(3.6675e9, rel=1e-3)
    # K/V at fill 1000, bf16: 2 · 32 layers · 8 heads · 128 · 1000 · 2 B
    kv = roofline.decode_attention(m, [1000], 2.0).bytes
    assert kv == 2 * 32 * 8 * 128 * 1000 * 2
    st = roofline.step_least_s(m, {"decode": [1000]}, 2.0)
    assert st == pytest.approx((got + kv) / HBM)


def test_mixtral_step_counts_routed_experts():
    m = Model(MIXTRAL)
    expert = 4096 * 14336 * B_W                  # one [4096, 14336] weight
    one = roofline.layer_products(m, 1, PEAK_BF16)
    # gate, up, down over the 2 routed experts at r = 1
    assert [w.bytes for w in one[4:]] == pytest.approx(
        [2 * expert + 2 * 4096 + 2 * 14336] * 2
        + [2 * expert + 2 * 14336 + 2 * 4096])
    assert one[4].ops_s == pytest.approx(2 * 2 * 4096 * 14336 / PEAK_BF16)
    sixteen = roofline.layer_products(m, 16, PEAK_BF16)
    # r·k = 32 routed rows; all 8 experts' weights read
    assert sixteen[6].bytes == pytest.approx(8 * expert + 16 * 2 * (14336
                                                                    + 4096))
    assert sixteen[6].ops_s == pytest.approx(2 * 32 * 14336 * 4096
                                             / PEAK_BF16)
    # the dense mixture reads 8 experts a token; the routed bound 2
    dense = 32 * 3 * 8 * expert
    routed = sum(w.bytes for w in roofline.decode_products(m, 1))
    assert routed < dense / 3.5


def test_prefill_is_counted_at_int8_and_causal_pairs():
    m = Model(MISTRAL)
    p = roofline.prefill_products(m, 512)
    assert p[0].ops_s == pytest.approx(2 * 512 * 4096 * 4096 / PEAK_INT8)
    a = roofline.prefill_attention(m, 512, 512)
    pairs = 512 * 512 + 512 * 513 // 2
    assert a.ops_s == pytest.approx(4 * 32 * 128 * pairs * 32 / PEAK_BF16)


def test_family_least_time_splits_prefill_and_decode():
    m = Model(MISTRAL)
    steps = [{"prefill": [(0, 512, False)], "decode": [600, 700]},
             {"prefill": [], "decode": [601, 701]}]
    pre = roofline.family_least_s(m, steps, "prefill")
    dec = roofline.family_least_s(m, steps, "decode")
    assert pre == pytest.approx(sum(w.least_s for w in
                                    roofline.prefill_products(m, 512)))
    assert dec == pytest.approx(2 * sum(w.least_s for w in
                                        roofline.decode_products(m, 2)))
    whole = sum(roofline.step_least_s(m, s, 1.0) for s in steps)
    assert whole >= dec
