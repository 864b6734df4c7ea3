"""The port's host tools against the JAX package's, on the CPU: the chat
prompt builders (equal strings), ``Timings`` (equal reports),
``verbosity``, and ``maybe_trace`` at ``NEURAL_TPU_VERBOSE=2`` on
``torch.profiler`` (here the CPU's ops: no device time is recorded), also
as ``Model.generate`` and ``transcribe_file`` use them."""
import numpy as np
import pytest
import torch

from neural_tpu.utils import prompts as jprompts
from neural_tpu.utils.profiling import Timings as JTimings
from neural_tpu.utils.profiling import verbosity as jverbosity

from neural_tpu_torch import utils
from neural_tpu_torch.api import Model
from neural_tpu_torch.convert.hf import init_random
from neural_tpu_torch.models.config import ModelConfig
from neural_tpu_torch.utils import prompts

HISTORIES = [["hi"], ["hi", "hello", "how are you?"],
             ["一", "二", "三", "四"], ["a", "b"]]


@pytest.mark.parametrize("arch", ["chatglm1", "chatglm", "chatglm2",
                                  "chatglm3", "chatglm4", "llama"])
def test_build_prompt_equals_jax(arch):
    for h in HISTORIES:
        assert prompts.build_prompt(arch, h) == jprompts.build_prompt(arch, h)
        assert utils.build_prompt(arch, h) == prompts.build_prompt(arch, h)


def test_glm_builders_equal_jax():
    for h in HISTORIES:
        assert prompts.build_prompt_glm1(h) == jprompts.build_prompt_glm1(h)
        assert prompts.build_prompt_glm2(h) == jprompts.build_prompt_glm2(h)
    assert prompts.build_prompt_glm1(["q"]) == "q"


def test_utils_exports_equal_jax():
    import neural_tpu.utils as ju
    assert sorted(utils.__all__) == sorted(ju.__all__)


@pytest.mark.parametrize("value,level", [(None, 0), ("1", 1), ("2", 2),
                                         ("x", 0)])
def test_verbosity(monkeypatch, value, level):
    if value is None:
        monkeypatch.delenv("NEURAL_TPU_VERBOSE", raising=False)
    else:
        monkeypatch.setenv("NEURAL_TPU_VERBOSE", value)
    assert utils.verbosity() == jverbosity() == level


def test_timings_report_equals_jax(monkeypatch, capsys):
    a, b = utils.Timings(), JTimings()
    for t in (a, b):
        t.load_ms, t.prefill_ms, t.prefill_tokens = 12.5, 40.0, 8
        t.decode_ms, t.decode_tokens = 99.0, 33
    assert a.report() == b.report()
    with a.phase("decode", tokens=5):
        pass
    assert a.decode_tokens == 38 and a.decode_ms >= 99.0
    monkeypatch.setenv("NEURAL_TPU_VERBOSE", "0")
    a.print_if_verbose()
    assert capsys.readouterr().out == ""
    monkeypatch.setenv("NEURAL_TPU_VERBOSE", "1")
    a.print_if_verbose()
    assert capsys.readouterr().out.startswith("neural-tpu timings:")


def test_maybe_trace_prints_top_ops(monkeypatch, capsys):
    x = torch.randn(64, 64)
    monkeypatch.setenv("NEURAL_TPU_VERBOSE", "1")
    with utils.maybe_trace("quiet"):
        x @ x
    assert capsys.readouterr().out == ""
    monkeypatch.setenv("NEURAL_TPU_VERBOSE", "2")
    with utils.maybe_trace("mm", top=3):
        for _ in range(3):
            x = torch.tanh(x @ x)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "top host ops (mm, no device time recorded):"
    assert 1 <= len(out) - 1 <= 3
    assert any("mm" in line for line in out[1:])
    assert all(line.strip().split()[1] == "ms" for line in out[1:])


def test_maybe_trace_never_breaks_the_call(monkeypatch, capsys):
    from neural_tpu_torch.utils import profiling
    monkeypatch.setenv("NEURAL_TPU_VERBOSE", "2")

    def broken(*a, **kw):
        raise RuntimeError("no trace")
    monkeypatch.setattr(profiling, "top_ops", broken)
    with utils.maybe_trace("x"):
        y = torch.ones(3).sum()
    assert float(y) == 3.0
    assert "trace analysis failed: no trace" in capsys.readouterr().out


def test_generate_prints_timings_and_top_ops(monkeypatch, capsys):
    cfg = ModelConfig(arch="llama", vocab_size=64, hidden_size=128,
                      n_layers=1, n_heads=1, n_kv_heads=1, head_dim=128,
                      intermediate_size=256, max_seq_len=64)
    m = Model().init_params(init_random(cfg, seed=0, device="cpu"), cfg)
    monkeypatch.setenv("NEURAL_TPU_VERBOSE", "0")
    ref = m.generate([1, 2, 3], max_new_tokens=3)
    assert capsys.readouterr().out == ""
    monkeypatch.setenv("NEURAL_TPU_VERBOSE", "2")
    assert m.generate([1, 2, 3], max_new_tokens=3) == ref
    out = capsys.readouterr().out
    assert "top host ops (generate" in out
    assert "neural-tpu timings:" in out and "decode  :" in out
    assert m.generate([[1, 2, 3], [4, 5]], max_new_tokens=2)
    assert "top host ops (generate" in capsys.readouterr().out


def test_transcribe_file_prints_timings(tmp_path, monkeypatch, capsys):
    import wave
    from neural_tpu_torch.models import whisper as wh
    cfg = wh.WhisperConfig(vocab_size=96, d_model=64, n_heads=2,
                           enc_layers=1, dec_layers=1, ffn_dim=128,
                           eos_token_id=3, sot_token_id=4)
    m = Model().init_whisper_params(wh.init_random(cfg, device="cpu"), cfg)
    p = str(tmp_path / "a.wav")
    with wave.open(p, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.zeros(1600, "<i2").tobytes())
    monkeypatch.setenv("NEURAL_TPU_VERBOSE", "1")
    ids = m.transcribe_file(p, prompt_ids=[4], max_new_tokens=3)
    assert ids[0] == 4
    assert "neural-tpu timings:" in capsys.readouterr().out
