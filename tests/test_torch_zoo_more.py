"""The second half of ``test_torch_zoo.py``'s families: GPT-BigCode (one
KV head, learned positions), Qwen2 (q/k/v biases, G = 7), Phi-2 (partial
NeoX RoPE, one shared norm, the lm_head bias), Phi-3 (fused qkv_proj and
gate_up_proj), StableLM (partial RoPE, LayerNorms with biases) and SOLAR
(Llama's graph under its own name), with that file's checks and
tolerances."""
import pytest

pytest.importorskip("transformers")

from test_torch_zoo import (cases, check_logits_and_greedy,  # noqa: E402
                            check_params, make_pair)

ARCHS = ["gpt_bigcode", "qwen2", "phi", "phi3", "stablelm", "solar"]


@pytest.fixture(**cases(ARCHS))
def pair(request):
    return make_pair(*request.param)


def test_from_hf_model_equals_bridged_params(pair):
    check_params(pair)


def test_logits_and_greedy_ids(pair):
    check_logits_and_greedy(pair)
