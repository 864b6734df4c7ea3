"""The port's command-line tools (``neural_tpu_torch.cli``), each run as
``main(argv)`` with ``--device cpu`` on a tiny model, against the JAX
package's script of the same use run on the same files (its ``main()``
with ``sys.argv`` set, its printout captured).

Where the JAX script prints ids (``inference`` on a model without a
tokenizer, ``whisper`` on a directory without one) the port prints the
same ids. ``convert`` to GGUF writes the JAX script's file byte for byte;
``perplexity`` agrees within 1e-2 relative (the packages round bf16
activations at different places, ``tests/test_torch_model.py``); ``run``
prints the decode of the port's own greedy ids. ``accuracy`` needs lm-eval,
absent here, and says so; a text flag on a model without a tokenizer
raises, naming why.
"""
import importlib.util
import os
import sys
import wave

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from neural_tpu.api import Model as JModel

from neural_tpu_torch.api import Model
from neural_tpu_torch.cli import (accuracy, convert, inference, perplexity,
                                  quantize, run, whisper)
from test_torch_gguf import MIX_A, write_model
from test_torch_tokenizer import spm_vocab

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


def jax_script(name, argv, capsys):
    """Run ``scripts/<name>.py``'s ``main()`` with ``argv``; its stdout."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    old = sys.argv
    sys.argv = [name] + argv
    try:
        capsys.readouterr()
        mod.main()
    finally:
        sys.argv = old
    return capsys.readouterr().out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A tiny llama GGUF with an SPM vocabulary, and the NTPU file the JAX
    package saves of it (no vocabulary)."""
    d = tmp_path_factory.mktemp("cli")
    gguf = str(d / "m.gguf")
    tokens, _ = spm_vocab()
    write_model(gguf, MIX_A, seed=11, tokens=tokens[:256])
    ntpu = str(d / "m.ntpu")
    JModel().init_from_bin(gguf).save(ntpu)
    return gguf, ntpu


def test_inference_prints_the_jax_scripts_ids(files, capsys):
    _, ntpu = files
    argv = ["--model", ntpu, "--ids", "1,37,201,9", "-n", "6"]
    lines = []
    ids = inference.main(argv + CPU, out=lines.append)
    assert len(ids) == 10 and ids[:4] == [1, 37, 201, 9]
    assert str(lines[0]) + "\n" == jax_script("inference", argv, capsys)


def test_run_generates_text(files):
    gguf, ntpu = files
    lines = []
    text = run.main(["--model", gguf, "--prompt", "hello world", "-n", "5"]
                    + CPU, out=lines.append)
    m = Model().init_from_bin(gguf, device="cpu")
    assert text == m.generate_text("hello world", max_new_tokens=5)
    assert lines == ["hello world" + text]
    outs = run.main(["--model", gguf, "--prompt", "hello", "-b", "2", "-n",
                     "3"] + CPU, out=lines.append)
    assert len(outs) == 2 and outs[0] == outs[1]
    with pytest.raises(ValueError, match="tokenizer"):
        run.main(["--model", ntpu, "-n", "2"] + CPU)
    with pytest.raises(ValueError, match="tokenizer"):
        inference.main(["--model", ntpu, "-n", "2"] + CPU)


def test_run_chat_console(files):
    gguf, _ = files
    said = iter(["hello", "world", ""])
    lines = []
    run.main(["--model", gguf, "--chat", "-n", "3"] + CPU,
             out=lines.append, read=lambda _: next(said))
    assert lines[0].startswith("== neural-tpu chat") and len(lines) == 3


def test_quantize_writes_what_quant_model_writes(files, tmp_path):
    gguf, _ = files
    a, b = str(tmp_path / "a.ntpu"), str(tmp_path / "b.ntpu")
    quantize.main(["--model_file", gguf, "--out_file", a, "--weight_dtype",
                   "int4", "--group_size", "32"] + CPU, out=lambda s: None)
    Model.quant_model(gguf, b, weight_dtype="int4", group_size=32,
                      device="cpu")
    ma, mb = (Model().init_from_bin(p, device="cpu") for p in (a, b))
    sa, sb = ma.params.state_dict(), mb.params.state_dict()
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=256, hidden_size=128, intermediate_size=384,
        num_hidden_layers=2, num_attention_heads=8,
        num_key_value_heads=4)).eval()
    d = tmp_path_factory.mktemp("hf")
    hf.save_pretrained(str(d), safe_serialization=True)
    return str(d)


def test_convert_to_gguf_writes_the_jax_scripts_bytes(hf_dir, tmp_path,
                                                      capsys):
    for outtype in ("q4_0", "f32"):
        ours, ref = str(tmp_path / "p.gguf"), str(tmp_path / "j.gguf")
        convert.main([hf_dir, "--outfile", ours, "--outtype", outtype]
                     + CPU, out=lambda s: None)
        jax_script("convert", [hf_dir, "--outfile", ref, "--outtype",
                               outtype], capsys)
        with open(ours, "rb") as f, open(ref, "rb") as g:
            assert f.read() == g.read(), outtype


def test_convert_to_ntpu(hf_dir, tmp_path):
    """f32 keeps f32 parameters at rest (``dtype="float32"``), bf16 bf16;
    a preset quantizes."""
    for outtype, dt in (("f32", torch.float32), ("bf16", torch.bfloat16),
                        ("q4_0", None)):
        p = str(tmp_path / f"{outtype}.ntpu")
        convert.main([hf_dir, "--outfile", p, "--outtype", outtype] + CPU,
                     out=lambda s: None)
        m = Model().init_from_bin(p, device="cpu")
        lp = m.params.param_dict()["layers"][0]
        if dt is None:
            assert type(lp["wq"]).__name__ == "QTensor"
        else:
            assert lp["wq"].dtype == dt and lp["attn_norm_w"].dtype == dt
        assert np.isfinite(m([[3, 4, 5]])).all()


def test_perplexity_agrees_with_the_jax_script(files, tmp_path, capsys):
    gguf, _ = files
    ids = str(tmp_path / "ids.npy")
    np.save(ids, np.random.default_rng(0).integers(1, 256, 200)
            .astype(np.int32))
    argv = ["--model", gguf, "--ids", ids, "--ctx_size", "64"]
    lines = []
    r = perplexity.main(argv + CPU, out=lines.append)
    ref = jax_script("perplexity", argv, capsys)
    jppl = float(ref.split()[1])
    assert abs(r["ppl"] / jppl - 1) < 1e-2, (r["ppl"], jppl)
    assert lines[0].split()[3:] == ref.split()[3:]


def test_accuracy_needs_lm_eval(files):
    gguf, _ = files
    if importlib.util.find_spec("lm_eval") is not None:
        pytest.skip("lm-eval is installed: this checks the refusal")
    with pytest.raises(ImportError, match="lm-eval"):
        accuracy.main(["--model", gguf, "--tasks", "piqa"] + CPU)


def test_whisper_prints_the_jax_scripts_ids(tmp_path, capsys):
    torch.manual_seed(0)
    hf = transformers.WhisperForConditionalGeneration(
        transformers.WhisperConfig(
            vocab_size=200, d_model=64, encoder_layers=2, decoder_layers=2,
            encoder_attention_heads=4, decoder_attention_heads=4,
            encoder_ffn_dim=128, decoder_ffn_dim=128, num_mel_bins=80,
            max_source_positions=1500, max_target_positions=448,
            eos_token_id=3, decoder_start_token_id=4, pad_token_id=0,
            suppress_tokens=[], begin_suppress_tokens=[])).eval()
    d = str(tmp_path / "w")
    hf.save_pretrained(d, safe_serialization=True)
    wav = str(tmp_path / "a.wav")
    t = np.arange(16000) / 16000
    with wave.open(wav, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((0.3 * np.sin(2 * np.pi * 300 * t) * 32767)
                      .astype("<i2").tobytes())
    argv = ["--model", d, "--audio", wav, "--max_new_tokens", "5"]
    lines = []
    ids = whisper.main(argv + CPU, out=lines.append)
    assert str(lines[0]) + "\n" == jax_script("whisper_example", argv,
                                              capsys)
    assert len(ids) >= 1
