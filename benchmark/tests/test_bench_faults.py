"""Each fault a cell can have, planted under a whole run of the harness,
makes ``correct`` false (the harness's look for a card is skipped; tiny
cells on the CPU, where a sound run's widest gap is 0)."""
import json

import pytest

from benchmark import harness
from conftest import write_tiny

# above the widest gap of sound tiny runs on the CPU (one passed 0.05),
# below a planted fault's (0.3 or more)
LIMIT = 0.1


def run(root, cell, capsys):
    rc = harness.main(["--workload", cell, "--seed", "4000000007",
                       "--seconds", "6", "--trace", "0"], root=root,
                      device="cpu")
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture
def root(tmp_path):
    return write_tiny(tmp_path, limit=LIMIT)


def _token_altered(mp):
    from neural_tpu_torch.serving import scheduler as s
    orig = s._decode_sample_all

    def bad(*a, **kw):
        tok, logits = orig(*a, **kw)
        return (tok + 1) % logits.shape[-1], logits
    mp.setattr(s, "_decode_sample_all", bad)


def _state_unchanged(mp):
    """A decode step whose cache write is lost: the cache comes back as it
    was."""
    from neural_tpu_torch.models import transformer as t
    orig_paged = t.paged_update_kv

    def paged(kc, vc, ks, vs, k, v, table, start):
        if k.shape[2] != 1:
            orig_paged(kc, vc, ks, vs, k, v, table, start)
    mp.setattr(t, "paged_update_kv", paged)


def _half_batch(mp):
    """The batched decode leaves half of its rows (every other slot) out:
    they get their input token back instead of a new one."""
    from neural_tpu_torch.serving import scheduler as s
    orig = s._decode_sample_all

    def bad(model, tokens, *a, **kw):
        tok, logits = orig(model, tokens, *a, **kw)
        tok = tok.clone()
        tok[1::2] = tokens[1::2, 0].to(tok.dtype)
        return tok, logits
    mp.setattr(s, "_decode_sample_all", bad)


FAULTS = {"token_altered": _token_altered, "state_unchanged": _state_unchanged,
          "half_batch": _half_batch}
CASES = [(c, f) for c in ("tiny-mistral.tiny-serve", "tiny-mixtral.tiny-serve")
         for f in FAULTS]


def test_sound_runs_pass(root, capsys):
    for cell in ("tiny-mistral.tiny-serve", "tiny-mixtral.tiny-serve"):
        line = run(root, cell, capsys)
        assert line["correct"] is True, line["checks"]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_makes_correct_false(root, capsys, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    line = run(root, cell, capsys)
    assert line["correct"] is False, line["checks"]
    assert line["checks"]["max_gap"]["value"] > LIMIT
