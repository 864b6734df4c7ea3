"""The port's file-level API against the JAX package's: ``quant_model``
file to file (GGUF, NTPU and an HF directory in; both packages' outputs
loaded by the port equal tensor for tensor, the JAX side quantized with
its optional C++ codec off, as ``test_torch_mixed.py`` does); ragged
``__call__`` within ``test_torch_model.py``'s 3e-2·max|logit| of JAX's on
the same GGUF file, each row's valid positions equal to its own eval;
``generate_text`` through a GGUF file's vocabulary; ``ModelServer(
model_path=...)`` on the CPU equal to a Scheduler over the same file's
model; and the twin of ``tests/test_native.py`` on the port's ctypes
binding of the same codec.
"""
import time

import numpy as np
import pytest
import torch

from neural_tpu import native as jnative
from neural_tpu.api import Model as JModel

from neural_tpu_torch import native
from neural_tpu_torch.api import Model
from neural_tpu_torch.convert.gguf import GGUFReader
from neural_tpu_torch.core.dtypes import QuantConfig
from neural_tpu_torch.core.qtensor import pack_plane, quantize, unpack_plane
from neural_tpu_torch.runtime.sampling import SamplingParams
from neural_tpu_torch.serving import ModelServer, Query, Scheduler
from test_torch_gguf import MIX_A, packed, write_model
from test_torch_model import REL_TOL
from test_torch_tokenizer import spm_vocab


@pytest.fixture(scope="module")
def gguf_file(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("api") / "m.gguf")
    tokens, _ = spm_vocab()
    write_model(p, MIX_A, seed=11, tokens=tokens[:256])
    return p


def _equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k


@pytest.fixture(scope="module")
def q41_file(tmp_path_factory):
    """One layer, every quantized tensor Q4_1 (a constant group in each)."""
    p = str(tmp_path_factory.mktemp("quant") / "q41.gguf")
    types = dict.fromkeys(list(MIX_A), "Q4_1")
    write_model(p, types, seed=12, n_layers=1)
    return p


@pytest.mark.parametrize("source,weight_dtype", [("gguf", "int4"),
                                                 ("ntpu", "q4_j")])
def test_quant_model_file_to_file_equals_jax(tmp_path, q41_file, source,
                                             weight_dtype, monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)
    src = q41_file
    if source == "ntpu":
        src = str(tmp_path / "src.ntpu")
        JModel().init_from_bin(q41_file).save(src)
    j_out, p_out = str(tmp_path / "j.ntpu"), str(tmp_path / "p.ntpu")
    JModel.quant_model(src, j_out, weight_dtype=weight_dtype)
    assert Model.quant_model(src, p_out, weight_dtype=weight_dtype,
                             device="cpu") == p_out
    got = Model().init_from_bin(p_out, device="cpu")
    want = Model().init_from_bin(j_out, device="cpu")
    _equal(got.params, want.params)
    assert got.params.layers[0].wq.cfg.bits == 4
    with pytest.raises(ValueError, match="export_gguf"):
        Model.quant_model(src, str(tmp_path / "x.gguf"), device="cpu")


def test_quant_model_of_a_directory(tmp_path):
    """An HF directory in: the streamed conversion at the dtype, saved."""
    transformers = pytest.importorskip("transformers")
    src = str(tmp_path / "hf")
    torch.manual_seed(0)
    transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2)).save_pretrained(src)
    out = str(tmp_path / "p.ntpu")
    Model.quant_model(src, out, weight_dtype="int8", device="cpu")
    got = Model().init_from_bin(out, device="cpu")
    want = Model().init(src, weight_dtype="int8", device="cpu")
    _equal(got.params, want.params)
    assert got.params.layers[0].wq.cfg.bits == 8


def test_call_ragged_equals_jax(gguf_file):
    jm = JModel().init_from_bin(gguf_file)
    pm = Model().init_from_bin(gguf_file, device="cpu")
    rows = [[1, 37, 201, 9, 144], [5, 6], [7, 8, 9]]
    got = pm(rows)
    assert isinstance(got, np.ndarray) and got.shape == (3, 5, 256)
    want = np.asarray(jm(rows))
    for b, r in enumerate(rows):
        ref = want[b, :len(r)]
        np.testing.assert_allclose(got[b, :len(r)], ref, rtol=0,
                                   atol=REL_TOL * np.abs(ref).max())
    solo = pm([[5, 6]])
    np.testing.assert_array_equal(got[1, :2], solo[0])


def test_generate_text(gguf_file):
    """``init_from_bin`` brings the file's SPM vocabulary; ``generate_text``
    is its encode, ``generate`` and decode of the new ids."""
    m = Model().init_from_bin(gguf_file, device="cpu")
    assert type(m.tokenizer).__name__ == "SPMTokenizer"
    text = m.generate_text("hello world", max_new_tokens=5,
                           stop_at_eos=False)
    ids = m.tokenizer.encode("hello world")
    out = m.generate(ids, max_new_tokens=5, stop_at_eos=False)[0]
    assert isinstance(text, str)
    assert text == m.tokenizer.decode(out[len(ids):])
    with pytest.raises(RuntimeError, match="tokenizer"):
        Model().init_params(m.params, m.cfg).generate_text("hi")


def test_model_server_from_model_path(tmp_path, gguf_file):
    """``ModelServer(model_path=...)`` on a GGUF file and on the NTPU file
    it saves to: every query's ids equal a Scheduler's over a model loaded
    from the same file."""
    greedy = SamplingParams(greedy=True, repeat_penalty=1.0)
    prompts = [[1, 37, 201], [5, 6, 7, 8], [9, 9]]
    m = Model().init_from_bin(gguf_file, device="cpu")
    sched = Scheduler(m.params, m.cfg, max_batch=2, max_len=64,
                      sampling=greedy)
    for i, p in enumerate(prompts):
        sched.add_request(i, p, max_new_tokens=4)
    ref = {s.request_id: list(s.output_ids)
           for s in sched.run_to_completion()}
    ntpu = str(tmp_path / "m.ntpu")
    m.save(ntpu)
    for path in (gguf_file, ntpu):
        got = {}

        def cb(done):
            for s in done:
                got[s.request_id] = list(s.output_ids)

        with ModelServer(response_callback=cb, max_batch=2, max_len=64,
                         sampling=greedy, model_path=path,
                         device="cpu") as srv:
            srv.issueQuery([Query(i, p, 4) for i, p in enumerate(prompts)])
            t0 = time.time()
            while len(got) < len(prompts) and time.time() - t0 < 120:
                time.sleep(0.05)
        assert got == ref, path


def test_whisper_entry_points_raise():
    """Whisper runs on the port (``tests/test_torch_whisper.py``); what
    still raises: a name that is not a local directory (nothing is
    fetched), and ``transcribe_file`` before ``init_whisper``."""
    with pytest.raises(NotImplementedError, match="not a local directory"):
        Model().init_whisper("x")
    with pytest.raises(RuntimeError, match="init_whisper"):
        Model().transcribe_file("x")


# ---------------------------------------------------------------------------
# the native codec (twin of tests/test_native.py)
# ---------------------------------------------------------------------------

needs_codec = pytest.mark.skipif(not native.available(),
                                 reason="no C++ compiler with OpenMP")


@needs_codec
@pytest.mark.parametrize("bits,sym", [(4, True), (4, False), (8, True),
                                      (3, True), (2, False), (1, True)])
def test_rtn_matches_python(bits, sym):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((128, 64)).astype(np.float32)
    cfg = QuantConfig(bits=bits, sym=sym, group_size=32)
    qn = native.quantize_qtensor(w, cfg)
    qp = quantize(torch.from_numpy(w), cfg)
    for a, b in zip(qn.planes, qp.planes):
        assert torch.equal(a, b)
    np.testing.assert_allclose(qn.scales.numpy(), qp.scales.numpy(),
                               rtol=1e-6)
    if qp.zeros is not None:
        assert torch.equal(qn.zeros, qp.zeros)


@needs_codec
@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_pack_unpack_matches(p):
    rng = np.random.default_rng(p)
    vals = rng.integers(0, 1 << p, (128, 32)).astype(np.uint8)
    a = native.pack_plane(vals, p, 32)
    b = pack_plane(torch.from_numpy(vals), p, 32).numpy()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(native.unpack_plane(a, p, 32), vals)
    np.testing.assert_array_equal(
        unpack_plane(torch.from_numpy(a), p, 32).numpy(), vals)


@needs_codec
@pytest.mark.parametrize("type_name", ["Q4_0", "Q8_0"])
def test_dequant_matches_gguf_reader(tmp_path, type_name):
    from neural_tpu_torch.convert.gguf import GGUFWriter
    from test_torch_gguf import TYPES
    rng = np.random.default_rng(3)
    w = rng.standard_normal((4, 256)).astype(np.float32)
    path = str(tmp_path / "q.gguf")
    wr = GGUFWriter(path)
    wr.add_tensor_raw("w", w.shape, TYPES[type_name], packed(w, type_name))
    wr.write()
    r = GGUFReader(path)
    blocks = np.frombuffer(bytes(r.tensor_bytes(r.tensors["w"])), np.uint8)
    fn = native.dequant_q4_0 if type_name == "Q4_0" else native.dequant_q8_0
    np.testing.assert_array_equal(fn(blocks, w.size),
                                  r.dequantize("w").reshape(-1))
    r.close()


@needs_codec
def test_native_threads_reported():
    lib = native.get_lib()
    assert lib.ntpu_native_threads() >= 1
    assert lib.ntpu_native_version() == 1
    assert native.lib_path().parent == native.BUILD_DIR
