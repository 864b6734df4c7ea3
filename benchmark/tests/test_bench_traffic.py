"""The traffic mixes: lengths and arrivals for a fixed seed, and the same
work for every seed."""
import json
from collections import Counter

import pytest

from benchmark.generator import Mix, lognormal_quantiles, poisson_gaps
from conftest import BENCH


def mix(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def test_chat_poisson_fixed_seed():
    """A 50 s window after 5 s of lead-in: lengths, due times (scaled by
    the rate) and blocks of the first requests for one seed."""
    spec = mix("chat-poisson")
    rate = spec["arrivals"]["rate"]
    lead = round(rate * spec["lead_in_s"])        # requests of the lead-in
    m = Mix(spec, 12345, 50)
    rs = m.take(lead + 5)
    assert [(len(r.prompt), r.n_out, r.block) for r in rs[:5]] == [
        (1516, 121, 0), (851, 135, 0), (731, 305, 0), (632, 387, 0),
        (2041, 170, 0)]
    assert [round(r.due * rate, 4) for r in rs[:5]] == pytest.approx(
        [0.0, 1.623163, 2.366851, 2.901093, 2.987337], abs=2e-4)
    assert rs[0].prompt[:2] == [29739, 17328]
    # the window's block starts at the end of the lead-in
    assert [r.block for r in rs[lead - 1:]] == [0] + [1] * 5
    assert rs[lead].due == pytest.approx(spec["lead_in_s"])


def test_every_seed_sends_the_same_work():
    """The window holds the same requests' sizes for any seed, due inside
    it, in another order: seeds change the order and not the work."""
    spec = mix("chat-poisson")
    lead, w = spec["lead_in_s"], 50
    got = []
    for seed in (1, 3_000_000_019):
        m = Mix(spec, seed, w)
        win = [r for r in m.take(400) if r.block == m.window_index]
        assert len(win) == round(spec["arrivals"]["rate"] * w)
        assert all(lead - 1e-9 <= r.due < lead + w for r in win)
        got.append(win)
    a, b = got
    assert Counter(len(r.prompt) for r in a) == \
        Counter(len(r.prompt) for r in b)
    assert Counter(r.n_out for r in a) == Counter(r.n_out for r in b)
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]


def test_blocks_without_a_window_repeat_their_sizes():
    spec = dict(mix("chat-poisson"), block=32)
    a, b = Mix(spec, 1).take(32), Mix(spec, 3_000_000_019).take(32)
    assert Counter(len(r.prompt) for r in a) == \
        Counter(len(r.prompt) for r in b)
    assert Counter(r.n_out for r in a) == Counter(r.n_out for r in b)


def test_lengths_and_ids_in_range():
    spec = mix("chat-poisson")
    lo, hi = spec["vocab"]
    for r in Mix(spec, 2**31 + 5, 50).take(300):
        p = spec["prompt"]
        assert p["min"] <= len(r.prompt) <= p["max"]
        assert all(lo <= t < hi for t in r.prompt)
        o = spec["output"]
        assert o["min"] <= r.n_out <= o["max"]


def test_quantiles_follow_the_lognormal():
    q = lognormal_quantiles({"median": 512, "sigma": 1.0, "min": 64,
                             "max": 3072}, 64)
    assert q == sorted(q) and q[0] == 64 and q[-1] == 3072
    assert q[31] <= 512 <= q[32]
    assert sum(poisson_gaps(4.0, 64)) / 64 == pytest.approx(0.25, rel=0.05)
