"""The converters' defaults against the JAX package's (ROADMAP C8).

``from_hf_model``, ``build_params`` and ``init_random`` of both packages
default to ``quant=None``: bf16 weights, no QTensor anywhere. On one tiny
``LlamaForCausalLM`` built locally (``tests/test_llama_golden.py``'s), every
parameter leaf of the two conversions with their defaults is equal, value
for value and dtype for dtype: the JAX tree's stacked ``[L, ...]`` leaves
row for row against the port's per-layer tensors. The two ``init_random``
draw different numbers (each its own generator), so there the leaves are
held by name, shape and dtype.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from neural_tpu.convert import from_hf_model as jfrom_hf_model
from neural_tpu.convert import init_random as jinit_random
from neural_tpu.core.qtensor import QTensor as JQTensor

from neural_tpu_torch.convert.hf import from_hf_model, init_random
from neural_tpu_torch.core.qtensor import QTensor
from test_torch_bridge import jax_array_to_numpy, to_np


def _tiny_llama():
    cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=128, intermediate_size=352,
        num_hidden_layers=3, num_attention_heads=8, num_key_value_heads=4,
        max_position_embeddings=512, rms_norm_eps=1e-5, rope_theta=10000.0)
    torch.manual_seed(0)
    return transformers.LlamaForCausalLM(cfg).eval()


def _port_leaves(model):
    """name → tensor of every leaf of the port's param dict, a layer's
    under ``layers.<name>.<l>``."""
    pd = model.param_dict()
    out = {}
    for l, lp in enumerate(pd.pop("layers")):
        for name, v in lp.items():
            out[f"layers.{name}.{l}"] = v
    out.update(pd)
    return {k: v for k, v in out.items() if v is not None}


def _jax_leaves(params):
    out = {}
    for name, v in params["layers"].items():
        for l in range(v.shape[0]):
            out[f"layers.{name}.{l}"] = v[l]
    out.update({k: v for k, v in params.items() if k != "layers"})
    return out


@pytest.fixture(scope="module")
def hf():
    return _tiny_llama()


def test_from_hf_model_defaults_equal_the_reference(hf):
    jp, jcfg = jfrom_hf_model(hf)
    pm, cfg = from_hf_model(hf, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    port, ref = _port_leaves(pm), _jax_leaves(jp)
    assert port.keys() == ref.keys()
    for name, t in port.items():
        assert not isinstance(t, QTensor), name
        assert not isinstance(ref[name], JQTensor), name
        a, b = to_np(t), jax_array_to_numpy(ref[name])
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert port["layers.wq.0"].dtype == torch.bfloat16
    # no FFN padding without quantization, in either package
    assert port["layers.w_down.0"].shape == (352, 128)


def test_init_random_defaults_are_unquantized_like_the_reference(hf):
    _, cfg = from_hf_model(hf, device="cpu")
    port = _port_leaves(init_random(cfg, device="cpu"))
    ref = _jax_leaves(jinit_random(cfg_to_jax(cfg)))
    assert port.keys() == ref.keys()
    for name, t in port.items():
        assert not isinstance(t, QTensor), name
        assert not isinstance(ref[name], JQTensor), name
        b = ref[name]
        assert tuple(t.shape) == tuple(b.shape), name
        assert (t.dtype == torch.bfloat16) == (b.dtype == jnp.bfloat16), name


def cfg_to_jax(cfg):
    from neural_tpu.models.config import ModelConfig as JModelConfig
    return JModelConfig(**dataclasses.asdict(cfg))
