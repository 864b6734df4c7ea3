"""The control of the correctness check, on the card: the reference put in
the program's place one step below the configuration's precision must
fail the cell's limit, where the program passes it, on three seeds at the
cell's own size and load, over a short window (the dozen-seed readings
behind the limits come from ``benchmark/calibrate.py``; see PERF.md)."""
import json

import pytest

from benchmark import calibrate, harness
from conftest import BENCH, ROOT, card_available


# each cell's control (benchmark/calibrate.py CONTROLS)
CONTROL = {"mistral-7b.serve": "kv"}


@pytest.mark.card
@pytest.mark.parametrize("cell,seconds", [("mistral-7b.serve", 20)])
def test_control_fails_where_the_program_passes(cell, seconds):
    if not card_available():
        pytest.skip("needs the CUDA card")
    spec = harness.Spec(ROOT, BENCH)
    harness.set_cache_dirs(ROOT)
    limits = json.loads((BENCH / "limits" / f"{cell}.json").read_text())
    for seed in (11, 2**31 + 12, 3_000_000_013):
        r = calibrate.readings(spec, cell, seed, seconds, [CONTROL[cell]])
        assert r["failed"] == 0 and r["samples"] > 0
        for k, lim in limits["numbers"].items():
            assert r["program"][k] <= lim, r
        assert any(r[CONTROL[cell]][k] > lim
                   for k, lim in limits["numbers"].items()), r
