"""Whisper on the port against the JAX package, on the CPU: the twins of
``tests/test_whisper.py``. Each tiny model is built locally
(``transformers.WhisperConfig``) and converted once by the JAX package;
the port computes on the same weights, carried across by
``convert.from_jax.whisper_params_from_numpy``. On the CPU every kernel
wrapper runs its plain version.

Tolerances, and why:
- fp weights: f32 on both sides, only the order of the f32 sums differs
  (XLA's against torch's): encoder states and logits within
  1e-4·max|ref| (measured: below 1e-6).
- int8 and q4_0: the port keeps the weights at rest (bf16 scales, K1 at
  M <= 16 over native codes) where the JAX package's stored planes
  dequantize to bf16 on its CPU path: each weight differs by one bf16
  rounding of its scale or of itself, and each decoder product's x is
  rounded to bf16 on both sides. Within 2e-2·max|ref| (measured: encoder
  3.1e-4 / 2.8e-4, logits 4.2e-3 / 3.6e-3 at int8 / q4_0).
- q4_j (the d_model-128 config, whose encoder rows take K2's plain route):
  on top of the above, the JAX package's jitted XLA division moves a few
  int8 activation codes by one step (ROADMAP C). Within 2e-2·max|ref|
  (measured: encoder 1.2e-3, logits 5.3e-3).
- ids (greedy, beams, timestamps, language): equal; with quantized
  weights, greedy ids are held up to the first step whose top-1/top-2
  margin in JAX's logits falls below the logits tolerance.
- the log-mel: numpy on both sides, the same ops: bit-equal.
"""
import dataclasses
import json
import wave

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax.numpy as jnp

from neural_tpu.api import Model as JModel
from neural_tpu.convert.hf import _quantize_one
from neural_tpu.core.dtypes import PRESETS as JPRESETS
from neural_tpu.models import whisper as J

from neural_tpu_torch.api import Model
from neural_tpu_torch.convert.from_jax import whisper_params_from_numpy
from neural_tpu_torch.core.dtypes import PRESETS
from neural_tpu_torch.core.qtensor import QTensor, quantize
from neural_tpu_torch.models import whisper as P
from neural_tpu_torch.ops import qmatmul as Q
from test_torch_bridge import jax_qtensor_to_numpy, jax_tree_to_numpy, to_np

FP_TOL = 1e-4
Q_TOL = 2e-2


def _hf(seed=0, **kw):
    args = dict(
        vocab_size=200, d_model=64, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=4, decoder_attention_heads=4,
        encoder_ffn_dim=128, decoder_ffn_dim=128, num_mel_bins=80,
        max_source_positions=1500, max_target_positions=448,
        eos_token_id=3, decoder_start_token_id=4, pad_token_id=0,
        suppress_tokens=[], begin_suppress_tokens=[])
    args.update(kw)
    torch.manual_seed(seed)
    return transformers.WhisperForConditionalGeneration(
        transformers.WhisperConfig(**args)).eval()


# the vocab layout of test_whisper.py's language test (timestamp tokens
# from 199, languages from 151)
LANG_VOCAB = dict(vocab_size=1700, eos_token_id=140,
                  decoder_start_token_id=150)


def _pair(m, quant=None):
    """(JAX params, JAX cfg, port params, port cfg) on one set of weights."""
    jp, jc = J.params_from_hf(m, quant=quant)
    pc = P.WhisperConfig(**dataclasses.asdict(jc))
    return jp, jc, whisper_params_from_numpy(jax_tree_to_numpy(jp), "cpu"), pc


def _mel(seed=0, frames=3000, n_mels=80):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n_mels, frames)).astype(np.float32) * 0.5


@pytest.fixture(scope="module")
def setup():
    m = _hf()
    return (m, *_pair(m), _mel(0))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _j_encode(jp, jc, mel):
    return np.asarray(J.encode(jp, jnp.asarray(mel)[None], jc))


def _j_logits(jp, jc, enc, toks):
    state = J.init_decoder_state(jp, jnp.asarray(enc), jc)
    logits, _ = J.decode_step(jp, jnp.asarray([toks], jnp.int32),
                              jnp.zeros((1,), jnp.int32), state, jc)
    return np.asarray(logits)


def _p_logits(pp, pc, enc, toks):
    state = P.init_decoder_state(pp, torch.from_numpy(np.array(enc)), pc)
    return P.decode_step(pp, [toks], 0, state, pc)[0].numpy()


def test_encoder_matches_jax(setup):
    m, jp, jc, pp, pc, mel = setup
    ref = _j_encode(jp, jc, mel)
    got = P.encode(pp, mel[None], pc)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel(got, ref) < FP_TOL
    # and the port's own import of the HF model is the bridged one
    pp2, pc2 = P.params_from_hf(m, device="cpu")
    assert pc2 == pc
    np.testing.assert_array_equal(P.encode(pp2, mel[None], pc).numpy(),
                                  got.numpy())


def test_decoder_logits_match_jax(setup):
    m, jp, jc, pp, pc, mel = setup
    enc = _j_encode(jp, jc, mel)
    toks = [4, 7, 9, 11]
    ref = _j_logits(jp, jc, enc, toks)
    got = _p_logits(pp, pc, enc, toks)
    assert got.shape == ref.shape
    assert _rel(got, ref) < FP_TOL


def test_greedy_transcribe_matches_jax(setup):
    m, jp, jc, pp, pc, mel = setup
    ref = J.transcribe_ids(jp, jc, mel, [4], max_new_tokens=10)
    assert P.transcribe_ids(pp, pc, mel, [4], max_new_tokens=10) == ref


def test_mel_bit_equal_and_matches_hf_feature_extractor():
    rng = np.random.default_rng(1)
    audio = (rng.standard_normal(16000 * 3) * 0.1).astype(np.float32)
    ours = P.log_mel_spectrogram(audio, 80)
    np.testing.assert_array_equal(ours, J.log_mel_spectrogram(audio, 80))
    np.testing.assert_array_equal(P.mel_filterbank(128),
                                  J.mel_filterbank(128))
    fe = transformers.WhisperFeatureExtractor(feature_size=80)
    ref = fe(audio, sampling_rate=16000, return_tensors="np").input_features[0]
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=1e-4)


def _write_wav(path, seconds=1.0, freq=300.0, sr=16000, width=2):
    t = np.arange(int(sr * seconds)) / sr
    sig = 0.3 * np.sin(2 * np.pi * freq * t)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes((sig * 32767).astype("<i2").tobytes())
    return str(path)


def test_audio_reader_equals_jax(tmp_path):
    from neural_tpu.utils.audio import load_audio_16k as jload
    from neural_tpu_torch.utils.audio import load_audio_16k, read_wav
    p = _write_wav(tmp_path / "a.wav", 0.5, sr=22050)
    x, sr = read_wav(p)
    assert sr == 22050 and x.shape[1] == 1
    np.testing.assert_array_equal(load_audio_16k(p), jload(p))


def test_transcribe_file_api(tmp_path):
    m = _hf()
    p = _write_wav(tmp_path / "a.wav")
    japi = JModel().init_whisper(m)
    api = Model().init_whisper(m, device="cpu")
    ids = api.transcribe_file(p, prompt_ids=[4], max_new_tokens=6)
    assert ids[0] == 4 and len(ids) >= 2
    assert ids == japi.transcribe_file(p, prompt_ids=[4], max_new_tokens=6)


def test_segments_from_tokens():
    tsb, eos = 1000, 3
    ids = [tsb, 5, 6, tsb + 50, tsb + 75, 7, tsb + 100, eos]
    segs, last = P.segments_from_tokens(ids, tsb, offset_s=30.0, eos=eos)
    assert segs[0] == (30.0, 31.0, [5, 6])
    assert segs[1] == (31.5, 32.0, [7])
    assert last == 2.0
    assert (segs, last) == J.segments_from_tokens(ids, tsb, 30.0, eos)
    segs2, last2 = P.segments_from_tokens([tsb, 9, 8], tsb, 0.0, eos)
    assert segs2 == [(0.0, 30.0, [9, 8])] and last2 is None


def test_long_form_transcribe_matches_jax(setup):
    """45 s of mel → the seek loop over windows, the same segments."""
    m, jp, jc, pp, pc, _ = setup
    mel = _mel(1, 4500)
    ref = J.transcribe_segments(jp, jc, mel, [4], max_new_tokens=8,
                                ts_begin=150, max_windows=3)
    got = P.transcribe_segments(pp, pc, mel, [4], max_new_tokens=8,
                                ts_begin=150, max_windows=3)
    assert len(got) >= 1 and got == ref
    for t0, t1, ids in got:
        assert 0.0 <= t0 <= t1 <= 75.0 and all(i < 150 for i in ids)


def test_beam_transcribe_matches_jax(setup):
    m, jp, jc, pp, pc, mel = setup
    ref = J.transcribe_ids_beam(jp, jc, mel, [4], beam_size=5,
                                max_new_tokens=10, length_penalty=1.0)
    got = P.transcribe_ids_beam(pp, pc, mel, [4], beam_size=5,
                                max_new_tokens=10, length_penalty=1.0)
    assert got == ref


def test_beam_ties_take_the_lower_index():
    """The joint top-W takes the lower flat index first among equal scores,
    as ``jax.lax.top_k``."""
    s = torch.tensor([0.5, 2.0, 2.0, -1.0, 2.0, 0.5])
    vals, idx = P.top_w(s, 4)
    assert idx.tolist() == [1, 2, 4, 0]
    assert vals.tolist() == [2.0, 2.0, 2.0, 0.5]


@pytest.fixture(scope="module")
def lang_setup():
    m = _hf(seed=1, **LANG_VOCAB)
    return (m, *_pair(m), _mel(2))


def test_detect_language_matches_jax(lang_setup):
    m, jp, jc, pp, pc, mel = lang_setup
    st = P.special_tokens(pc)
    assert st == J.special_tokens(jc)
    assert st["timestamp_begin"] == 1700 - 1501
    ref_tok, ref_probs = J.detect_language(jp, jc, mel)
    tok, probs = P.detect_language(pp, pc, mel)
    assert tok == ref_tok
    assert abs(probs.sum() - 1.0) < 1e-5
    np.testing.assert_allclose(probs, ref_probs, atol=1e-6)


def test_forced_prompt_real_vocab_layout():
    cfg = P.WhisperConfig(vocab_size=51865, sot_token_id=50258)
    jcfg = J.WhisperConfig(vocab_size=51865, sot_token_id=50258)
    st = P.special_tokens(cfg)
    assert st == J.special_tokens(jcfg)
    assert (st["translate"], st["transcribe"], st["notimestamps"],
            st["nospeech"]) == (50358, 50359, 50363, 50362)
    assert st["lang_begin"] == 50259 and st["lang_end"] == 50358
    for args in ((50259, "transcribe", False), (50259, "translate", True),
                 (None, "translate", False), (None, "transcribe", True)):
        assert P.build_forced_prompt(cfg, *args) == \
            J.build_forced_prompt(jcfg, *args)
    assert P.build_forced_prompt(cfg, 50259, "transcribe", False) == \
        [50258, 50259, 50359, 50363]
    # large-v3's vocab: 51866, timestamps from 50365
    v3 = P.WhisperConfig(vocab_size=51866, sot_token_id=50258)
    assert P.timestamp_begin(v3) == 50365
    tiny = P.WhisperConfig(vocab_size=200, sot_token_id=4)
    assert P.build_forced_prompt(tiny, None, "transcribe", False) == [4]


TS_INFO = [(0.001, 0.001, 150), (0.001, 0.001, 150), (0.5, 0.9, 200),
           (0.001, 0.001, 150)]


@pytest.mark.parametrize("with_energy", [False, True])
def test_token_timestamper_matches_jax(with_energy):
    """The timestamper on the same inputs through both packages (anchors,
    the voice-length fill, the VAD snap), then the JAX test's properties."""
    energy = None
    if with_energy:
        rng = np.random.default_rng(3)
        audio = rng.standard_normal(16000 * 3).astype(np.float32) * 0.1
        audio[8000:16000] *= 8.0
        energy = P.signal_energy(audio)
        np.testing.assert_array_equal(energy, J.signal_energy(audio))
    texts = ["hello", "world", "foo", "ba"]
    a = P.TokenTimestamper(150, energy=energy)
    b = J.TokenTimestamper(150, energy=energy)
    for t0, t1 in ((0.0, 2.0), (2.0, 2.8)):
        got = a.segment([10, 11, 12, 13], TS_INFO, texts, t0, t1)
        assert got == b.segment([10, 11, 12, 13], TS_INFO, texts, t0, t1)
    assert (a.t_beg, a.t_last, a.tid_last) == (b.t_beg, b.t_last, b.tid_last)
    if not with_energy:
        times = P.TokenTimestamper(150).segment([10, 11, 12, 13], TS_INFO,
                                                texts, 0.0, 2.0)
        assert abs(times[2][0] - 1.0) < 1e-6
        for j, (s, e) in enumerate(times):
            assert -1e-6 <= s <= e + 1e-6 and e <= 2.0 + 1e-6
            if j:
                assert times[j - 1][1] <= s + 1e-6
    assert P.voice_length(" ") == 0.01 and P.voice_length("ab") == 2.0
    assert P.voice_length(".") == 3.0 and P.voice_length("7") == 3.0


def test_token_timestamps_end_to_end_match_jax(setup):
    m, jp, jc, pp, pc, _ = setup
    mel = _mel(2)
    audio = np.random.default_rng(2).standard_normal(16000 * 30) \
        .astype(np.float32) * 0.1
    kw = dict(max_new_tokens=8, ts_begin=150, max_windows=1,
              token_timestamps=True, audio=audio)
    ref = J.transcribe_segments(jp, jc, mel, [4], **kw)
    got = P.transcribe_segments(pp, pc, mel, [4], **kw)
    assert len(got) >= 1
    assert [s[:3] for s in got] == [s[:3] for s in ref]
    for (_, _, ids, times), (_, _, _, rtimes) in zip(got, ref):
        assert len(times) == len(ids)
        np.testing.assert_allclose(times, rtimes, atol=1e-9)


def _proven_prefix(got, ref, jlogits_rows, tol):
    """The ids agree up to the first step whose top-1/top-2 margin in JAX's
    logits row falls below ``tol``·max|row|."""
    for i, row in enumerate(jlogits_rows):
        top = np.sort(row)[-2:]
        if top[1] - top[0] < tol * np.abs(row).max():
            return got[:i + 1] == ref[:i + 1], i
        if got[i] != ref[i]:
            return False, i
    return True, len(jlogits_rows)


def _j_greedy_rows(jp, jc, mel, prompt, n):
    """JAX's greedy ids after the prompt and each step's logits row."""
    enc = J.encode(jp, jnp.asarray(mel)[None], jc)
    state = J.init_decoder_state(jp, enc, jc)
    logits, state = J.decode_step(jp, jnp.asarray([prompt], jnp.int32),
                                  jnp.zeros((1,), jnp.int32), state, jc)
    rows, ids, pos = [], [], len(prompt)
    for _ in range(n):
        row = np.asarray(logits[0, -1], np.float32)
        rows.append(row)
        ids.append(int(row.argmax()))
        logits, state = J.decode_step(
            jp, jnp.asarray([[ids[-1]]], jnp.int32),
            jnp.asarray([pos], jnp.int32), state, jc)
        pos += 1
    return ids, rows


def _quant_twin(m, quant, mel, prompt, n=6):
    jp, jc, pp, pc = _pair(m, quant)
    ref_e = _j_encode(jp, jc, mel)
    got_e = P.encode(pp, mel[None], pc).numpy()
    enc_rel = _rel(got_e, ref_e)
    toks = prompt + [7, 9]
    log_rel = _rel(_p_logits(pp, pc, ref_e, toks),
                   _j_logits(jp, jc, ref_e, toks))
    ref_ids, rows = _j_greedy_rows(jp, jc, mel, prompt, n)
    got = P.transcribe_ids(pp, pc, mel, prompt, max_new_tokens=n)
    ok, at = _proven_prefix(got[len(prompt):], ref_ids, rows, Q_TOL)
    return jp, pp, enc_rel, log_rel, ok, at


@pytest.mark.parametrize("quant", ["int8", "q4_0"])
def test_quantized_whisper_matches_jax(setup, quant):
    """int8 (per channel) and q4_0 twins: every linear a QTensor at rest
    on the port; convs, embeddings and norms fp; encoder states, logits
    and greedy ids against the JAX package on the same quantized
    weights."""
    m, _, _, _, _, mel = setup
    jp, pp, enc_rel, log_rel, ok, at = _quant_twin(m, quant, mel, [4])
    assert isinstance(pp["enc_layers"][0]["fc1_w"], QTensor)
    assert isinstance(pp["dec_layers"][1]["cross_wk"], QTensor)
    assert not isinstance(pp["conv1_w"], QTensor)
    assert not isinstance(pp["dec_embed"], QTensor)
    assert pp["enc_layers"][0]["attn_wq"].cfg.bits == \
        (8 if quant == "int8" else 4)
    assert enc_rel < Q_TOL and log_rel < Q_TOL, (enc_rel, log_rel)
    assert ok, at


@pytest.mark.parametrize("quant", ["int8", "q4_0", "q4_j"])
def test_quantized_fields_equal_jax_quantize_one(quant):
    """The port quantizes each linear as the JAX package's ``_quantize_one``
    does, field for field; K that does not divide the group stays fp (the
    d_model-64 config at q4_j)."""
    m = _hf()
    pp, _ = P.params_from_hf(m, quant=quant, device="cpu")
    jp, _ = J.params_from_hf(m, quant=quant)
    sd = m.state_dict()
    w = sd["model.encoder.layers.1.fc2.weight"].float().numpy().T
    leaf = pp["enc_layers"][1]["fc2_w"]            # K = 128: quantized
    jq = _quantize_one(np.ascontiguousarray(w, np.float32), JPRESETS[quant])
    pq = quantize(torch.from_numpy(np.ascontiguousarray(w)), PRESETS[quant])
    d = jax_qtensor_to_numpy(jq)
    assert len(pq.planes) == len(d["planes"])
    for a, b in zip(pq.planes, d["planes"]):
        np.testing.assert_array_equal(to_np(a), b)
    np.testing.assert_array_equal(to_np(pq.scales), d["scales"])
    # the imported leaf is that QTensor at rest, as the bridge makes it
    bridged = whisper_params_from_numpy(jax_tree_to_numpy(jp), "cpu")
    other = bridged["enc_layers"][1]["fc2_w"]
    for a, b in zip(leaf.planes + (leaf.scales,),
                    other.planes + (other.scales,)):
        assert torch.equal(a, b)
    # attn products have K = 64: q4_j's group of 128 leaves them fp
    wq = pp["enc_layers"][0]["attn_wq"]
    assert isinstance(wq, QTensor) == (quant != "q4_j")


def test_registry_refused_with_the_jax_text():
    from neural_tpu.convert.quant_registry import MIXED_PRESETS as JMIX
    from neural_tpu_torch.convert.quant_registry import MIXED_PRESETS
    m = _hf()
    name = next(iter(MIXED_PRESETS))
    with pytest.raises(ValueError) as je:
        J.params_from_hf(m, quant=JMIX[name])
    with pytest.raises(ValueError) as pe:
        P.params_from_hf(m, quant=name, device="cpu")
    assert str(pe.value) == str(je.value)


Q4J = dict(d_model=128, encoder_attention_heads=4, decoder_attention_heads=4,
           encoder_ffn_dim=256, decoder_ffn_dim=256, **LANG_VOCAB)


class _Counted:
    def __init__(self, monkeypatch):
        self.n = {"K2": 0, "K1": 0, "K5": 0}
        for key, name in (("K2", "qmm_a8_plain"), ("K1", "qmm_native_plain"),
                          ("K5", "qmm_general_plain")):
            monkeypatch.setattr(Q, name, self._wrap(key, getattr(Q, name)))

    def _wrap(self, key, fn):
        def counted(*a, **kw):
            self.n[key] += 1
            return fn(*a, **kw)
        return counted

    def take(self):
        out, self.n = self.n, {k: 0 for k in self.n}
        return out


def test_q4_j_encoder_takes_k2_route(monkeypatch):
    """The d_model-128 q4_j twin: the encoder's 1500 rows take K2's plain
    version with f32 x (12 products and the 4 cross K/V), each decoder
    step K1's (16 products); against the JAX package within 2e-2."""
    m = _hf(seed=2, **Q4J)
    mel = _mel(3)
    jp, jc, pp, pc = _pair(m, "q4_j")
    counted = _Counted(monkeypatch)
    enc = P.encode(pp, mel[None], pc)
    assert counted.take() == {"K2": 12, "K1": 0, "K5": 0}
    state = P.init_decoder_state(pp, enc, pc)
    assert counted.take() == {"K2": 4, "K1": 0, "K5": 0}
    P.decode_step(pp, [[150]], 0, state, pc)
    assert counted.take() == {"K2": 0, "K1": 16, "K5": 0}
    assert Q.route(1500, 128, 128, pp["enc_layers"][0]["attn_wq"]) == "K2"
    # K2 quantizes x from its f32 rows: the plain version's codes are those
    # of quantize_act_i8 on the f32 x, never a bf16 copy
    x = torch.from_numpy(_mel(4, 128, 1500))            # [1500, 128]
    qt = pp["enc_layers"][0]["attn_wq"]
    a = Q.qmm_a8_plain(x, qt.planes[0], qt.scales, 128, 128, torch.float32)
    b = Q.qmm_a8_plain(x.bfloat16().float(), qt.planes[0], qt.scales, 128,
                       128, torch.float32)
    assert not torch.equal(a, b)
    monkeypatch.undo()
    _, _, enc_rel, log_rel, ok, at = _quant_twin(m, "q4_j", mel, [150])
    assert enc_rel < Q_TOL and log_rel < Q_TOL, (enc_rel, log_rel)
    assert ok, at


def test_init_whisper_from_directory(tmp_path, setup):
    """A ``save_pretrained(safe_serialization=True)`` directory read by the
    port itself (``config.json``, ``*.safetensors``): the same params as
    the in-memory import and the JAX package's ids."""
    m, jp, jc, pp, pc, mel = setup
    d = tmp_path / "whisper"
    m.save_pretrained(str(d), safe_serialization=True)
    api = Model().init_whisper(str(d), device="cpu")
    assert api.cfg == pc and api.tokenizer is None
    mem, _ = P.params_from_hf(m, device="cpu")
    for name in ("conv1_w", "dec_embed", "enc_pos", "dec_pos"):
        assert torch.equal(api.params[name], mem[name])
    for a, b in zip(api.params["dec_layers"], mem["dec_layers"]):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert P.transcribe_ids(api.params, api.cfg, mel, [4], 6) == \
        J.transcribe_ids(jp, jc, mel, [4], 6)
    q = Model().init_whisper(str(d), weight_dtype="q4_0", device="cpu")
    assert isinstance(q.params["enc_layers"][0]["fc1_w"], QTensor)


def test_init_whisper_refuses_a_name_that_is_not_a_directory(tmp_path):
    with pytest.raises(NotImplementedError, match="not a local directory"):
        Model().init_whisper(str(tmp_path / "openai-whisper-tiny"),
                             device="cpu")


def _tokenizer_json(path, vocab_size, lang_begin):
    """A minimal byte-level BPE tokenizer.json with Whisper's language
    tokens at their ids."""
    from neural_tpu_torch.tokenizer import _bytes_to_unicode
    chars = list(_bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(chars)}
    added = [{"id": lang_begin + i, "content": f"<|{code}|>",
              "special": True} for i, code in enumerate(("en", "zh", "de"))]
    added.append({"id": 140, "content": "<|endoftext|>", "special": True})
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"model": {"type": "BPE", "vocab": vocab, "merges": []},
                   "added_tokens": added}, fh)


def test_language_code_and_auto_through_transcribe_file(tmp_path,
                                                         lang_setup):
    """``language="de"`` through the directory's tokenizer.json gives the
    JAX package's prompt for that token id; "auto" its detected one; a code
    without a tokenizer raises."""
    m, jp, jc, pp, pc, _ = lang_setup
    d = tmp_path / "w"
    m.save_pretrained(str(d), safe_serialization=True)
    st = P.special_tokens(pc)
    _tokenizer_json(d / "tokenizer.json", 1700, st["lang_begin"])
    wav = _write_wav(tmp_path / "a.wav", 2.0, 440.0)
    api = Model().init_whisper(str(d), device="cpu")
    assert api.tokenizer.convert_tokens_to_ids("<|de|>") == \
        st["lang_begin"] + 2
    japi = JModel().init_whisper(m)
    for lang, jlang in (("de", st["lang_begin"] + 2), ("auto", "auto"),
                        (st["lang_begin"], st["lang_begin"])):
        got = api.transcribe_file(wav, max_new_tokens=4, language=lang,
                                  task="translate")
        assert got == japi.transcribe_file(wav, max_new_tokens=4,
                                           language=jlang, task="translate")
    bare = Model().init_whisper(m, device="cpu")
    with pytest.raises(ValueError, match="language codes need a tokenizer"):
        bare.transcribe_file(wav, max_new_tokens=2, language="en")


def test_transcribe_file_timestamps_and_beams_match_jax(tmp_path,
                                                         lang_setup):
    """The API's timestamped and beam branches on a real-layout vocab
    (timestamp tokens exist)."""
    m, jp, jc, pp, pc, _ = lang_setup
    wav = _write_wav(tmp_path / "a.wav", 3.0, 220.0)
    api = Model().init_whisper(m, device="cpu")
    japi = JModel().init_whisper(m)
    for kw in (dict(timestamps=True), dict(token_timestamps=True),
               dict(num_beams=3)):
        got = api.transcribe_file(wav, max_new_tokens=5, **kw)
        ref = japi.transcribe_file(wav, max_new_tokens=5, **kw)
        if kw.get("token_timestamps"):
            assert [s[:3] for s in got] == [s[:3] for s in ref]
            for g, r in zip(got, ref):
                np.testing.assert_allclose(g[3], r[3], atol=1e-9)
        else:
            assert got == ref, kw


def test_f32_exact_restores_the_callers_switches():
    conv, mm = torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        with P.f32_exact():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def test_init_random_shapes_and_quantized_linears():
    cfg = P.WhisperConfig(vocab_size=1700, d_model=128, n_heads=4,
                          enc_layers=1, dec_layers=1, ffn_dim=256,
                          eos_token_id=140, sot_token_id=150)
    params = P.init_random(cfg, seed=0, quant="q4_j", device="cpu")
    assert params["conv1_w"].shape == (128, 80, 3)
    assert params["dec_embed"].shape == (1700, 128)
    wq = params["dec_layers"][0]["cross_wq"]
    assert isinstance(wq, QTensor) and wq.cfg.native_pack
    ids = P.transcribe_ids(params, cfg, _mel(5), [150], max_new_tokens=3)
    assert len(ids) >= 2 and all(0 <= i < 1700 for i in ids)


@pytest.mark.parametrize("fmt,enc,dec", [("q4_j", "K2", "K1"),
                                         ("q4_0", "K5", "K1"),
                                         ("int8", "K5", "K1")])
def test_routes_at_large_v3_shapes(fmt, enc, dec):
    """At large-v3's widths (1280 × 1280, 1280 × 5120, 5120 × 1280) each
    format's weights at rest take the kernels the card runs: the encoder's
    1500 rows K2 (q4_j) or K5's tiles, the decoder's 1 (greedy) and 5
    (beams) rows K1; none falls to the plain route."""
    from neural_tpu_torch.core.qtensor import to_native
    gen = torch.Generator().manual_seed(0)
    for K, N in ((1280, 1280), (1280, 5120), (5120, 1280)):
        qt = to_native(quantize(torch.randn((K, N), generator=gen) * 0.02,
                                PRESETS[fmt]))
        assert Q.route(1500, K, N, qt) == enc
        assert Q.route(1, K, N, qt) == Q.route(5, K, N, qt) == dec
