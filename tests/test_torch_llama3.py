"""Twin of ``tests/test_llama3.py`` on the port: the Llama-3 specifics
(a list ``eos_token_id``, the <|eot_id|> stop set on every load path, the
llama3 RoPE scaling, the BOS prepend) at vocabulary 128256, with the tiny
checkpoint loaded in f32 (``dtype="float32"``) by both packages.

The end-to-end check holds the port's greedy ids to the JAX package's on
the same checkpoint: the logits agree within 1e-2·max|ref| and the ids are
compared while JAX's margins stay above that (``tests/test_torch_f32.py``'s
rule); the beam search and the Scheduler run as the JAX test runs them.
"""
import dataclasses

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import neural_tpu as nt
from neural_tpu.ops.rope import rope_freqs as jrope_freqs

import neural_tpu_torch as ntt
from neural_tpu_torch.models import llama
from neural_tpu_torch.models.config import ModelConfig
from neural_tpu_torch.ops.rope import rope_freqs
from neural_tpu_torch.runtime.generate import truncate_at_eos
from neural_tpu_torch.serving.scheduler import Scheduler, SeqStatus, Sequence

L3_ROPE = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
           "high_freq_factor": 4.0,
           "original_max_position_embeddings": 8192}
VOCAB = 128256
REL_TOL = 1e-2


def tiny_llama3():
    """``tests/test_llama3.py``'s checkpoint: vocab 128256, a list eos, the
    llama3 rope scaling."""
    torch.manual_seed(0)
    return transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=VOCAB, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, rope_theta=500000.0,
        rope_scaling=dict(L3_ROPE),
        bos_token_id=128000, eos_token_id=[128001, 128009])).eval()


@pytest.fixture(scope="module")
def models():
    hf = tiny_llama3()
    jm = nt.Model().init_from_hf_model(hf, weight_dtype=None,
                                       dtype="float32")
    pm = ntt.Model().init_from_hf_model(hf, weight_dtype=None,
                                        dtype="float32", device="cpu")
    return hf, jm, pm


def test_config_normalizes_list_eos():
    cfg = ModelConfig(eos_token_id=[128001, 128009])
    assert cfg.eos_token_id == 128001
    assert cfg.eos_token_ids == (128001, 128009)
    assert hash(cfg)
    cfg2 = ModelConfig(eos_token_id=2)
    assert cfg2.eos_token_ids == (2,)
    cfg3 = ModelConfig(eos_token_id=2, extra_eos_ids=(2, 7))
    assert cfg3.eos_token_ids == (2, 7)
    assert dataclasses.replace(cfg2, eos_token_id=5).eos_token_ids == (5,)


def test_config_from_hf_llama3_stop_set(models):
    hf = tiny_llama3().config
    cfg = llama.config_from_hf(hf)
    assert cfg.eos_token_id == 128001
    assert cfg.eos_token_ids == (128001, 128009)
    assert cfg == models[2].cfg and cfg.vocab_size == VOCAB
    hf.eos_token_id = 128001
    assert llama.config_from_hf(hf).eos_token_ids == (128001, 128009)
    # every load path: a GGUF-shaped construction gets the stop set too
    assert ModelConfig(arch="llama", vocab_size=VOCAB,
                       eos_token_id=128001).eos_token_ids == (128001, 128009)
    assert ModelConfig(arch="llama", vocab_size=32000,
                       eos_token_id=2).eos_token_ids == (2,)


def test_truncate_at_eos_any_member():
    cfg = ModelConfig(eos_token_id=[5, 9])
    assert truncate_at_eos([1, 2, 9, 3], cfg) == [1, 2, 9]
    assert truncate_at_eos([1, 5, 9], cfg) == [1, 5]
    assert truncate_at_eos([1, 2, 3], cfg) == [1, 2, 3]


def test_rope_llama3_and_dynamic_ntk_match_jax():
    from transformers.modeling_rope_utils import ROPE_INIT_FUNCTIONS
    inv_ref, _ = ROPE_INIT_FUNCTIONS["llama3"](tiny_llama3().config,
                                               device="cpu")
    inv = rope_freqs(16, None, 500000.0, dict(L3_ROPE))
    np.testing.assert_allclose(inv, np.asarray(inv_ref, np.float32),
                               rtol=1e-6)
    np.testing.assert_array_equal(
        inv, jrope_freqs(16, None, 500000.0, dict(L3_ROPE)))
    dyn = {"type": "dynamic", "factor": 2.0}
    np.testing.assert_array_equal(rope_freqs(16, None, 1e4, dyn, 8192),
                                  rope_freqs(16, None, 1e4))
    longer = dict(dyn, original_max_position_embeddings=4096)
    np.testing.assert_array_equal(rope_freqs(16, None, 1e4, longer, 8192),
                                  jrope_freqs(16, None, 1e4, longer, 8192))


def test_llama3_e2e_generate_serve_beam(models):
    _, jm, pm = models
    pd = pm.params.param_dict()
    assert pd["embed"].dtype == torch.float32 and pd["embed"].shape[0] == \
        VOCAB
    # the BOS ensure-prepend, as JAX; the same greedy ids
    out = pm.generate([[3, 17, 91]], max_new_tokens=4, stop_at_eos=False)
    jout = jm.generate([[3, 17, 91]], max_new_tokens=4, stop_at_eos=False)
    assert out[0][0] == 128000 and len(out[0]) == 8
    ref = np.asarray(jm([[128000, 3, 17, 91]]))
    got = pm([[128000, 3, 17, 91]])
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=REL_TOL * np.abs(ref).max())
    top = np.sort(ref[0, -1])
    if top[-1] - top[-2] > REL_TOL * np.abs(ref).max():
        assert out[0][4] == jout[0][4]
    led = pm.generate([[128000, 3, 17]], max_new_tokens=3,
                      stop_at_eos=False)
    assert led[0][:3] == [128000, 3, 17] and led[0].count(128000) <= \
        out[0].count(128000) + 1
    b = pm.generate([3, 17, 91], max_new_tokens=3, num_beams=2)
    assert len(b[0]) >= 3
    s = Scheduler(pm.params, pm.cfg, max_batch=2, max_len=64)
    s.add_request("r0", [128000, 3, 17], max_new_tokens=4)
    s.add_request("r1", [128000, 9, 1, 4], max_new_tokens=4)
    done = s.run_to_completion()
    assert {q.request_id for q in done} == {"r0", "r1"}
    for q in done:
        assert 1 <= len(q.output_ids) <= 4


def test_scheduler_stops_on_any_eos_member(models):
    pm = models[2]
    s = Scheduler(pm.params, pm.cfg, max_batch=1, max_len=64)
    seq = Sequence("x", [1, 2], max_new_tokens=10)
    seq.slot = 0
    seq.output_ids = [128009]          # <|eot_id|>, not the primary eos
    s.lengths[0] = 3
    s.running[0] = seq
    s._maybe_finish(seq)
    assert seq.status == SeqStatus.FINISHED
