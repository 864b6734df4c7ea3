"""Mixture-of-experts weights through the port's import paths, each held to
the JAX package on the same inputs:

- the bridge of a JAX tree not yet at rest (bit-plane packed ``[L, E, ...]``
  expert stacks): the port's ``params_to_native`` converts one expert at a
  time into the same tensors as its own ``from_hf_model``, field for field;
- the GPTQ Mixtral twin of ``tests/test_gptq_zoo.py``'s
  ``test_gptq_mixtral_moe_experts`` (quantized experts, an fp router),
  widened to head dim 128: the port's import equal to JAX's leaf for leaf,
  the experts QTensor stacks, logits within 3e-2·max|ref| of the port's fp
  import of the dequantized twin and of JAX (``test_torch_gptq_zoo.py``'s
  tolerance);
- the streamed conversion of a tiny Mixtral directory written here as
  several safetensors shards: equal to ``from_hf_model`` and to JAX's
  ``params_from_hf_dir`` then the port's ``params_to_native``, and its
  ``config.json`` read without transformers gives ``MixtralConfig``'s
  defaults; Grok-1's is remote code, whose missing key raises naming it;
- NTPU checkpoints both ways: a JAX MoE model file (stacked ``[L, E, ...]``
  experts) loads in the port equal to the bridged JAX tree, and the port's
  file (per-layer ``[E, ...]`` stacks at rest) loads in JAX within
  3e-2·max|logit| of the port's logits and back in the port equal.
"""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from neural_tpu import native as jnative  # noqa: E402
from neural_tpu.api import Model as JModel  # noqa: E402
from neural_tpu.convert import from_hf_model as jfrom_hf_model  # noqa: E402
from neural_tpu.convert.stream import \
    params_from_hf_dir as jparams_from_dir  # noqa: E402

from neural_tpu_torch.api import Model  # noqa: E402
from neural_tpu_torch.convert.files import (HF_DEFAULTS,  # noqa: E402
                                            read_config)
from neural_tpu_torch.convert.from_jax import params_from_numpy  # noqa: E402
from neural_tpu_torch.convert.hf import family, from_hf_model  # noqa: E402
from neural_tpu_torch.convert.stream import params_from_hf_dir  # noqa: E402
from neural_tpu_torch.core.qtensor import QTensor  # noqa: E402
from test_gptq_zoo import _embed, _linear, _vec  # noqa: E402
from test_torch_bridge import jax_tree_to_numpy  # noqa: E402
from test_torch_gptq_zoo import _cfg, _compare  # noqa: E402
from test_torch_moe import build_mixtral  # noqa: E402

REL_TOL = 3e-2


def _equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k


@pytest.fixture(scope="module")
def hf():
    return build_mixtral()


@pytest.mark.parametrize("quant", ["q4_j", "q4_0"])
def test_bridge_converts_packed_experts_at_rest(hf, quant):
    """JAX's import keeps bit-plane packed [L, E, K/2, N] expert stacks; the
    bridge unstacks them into per-layer [E, ...] stacks and the port's
    ``params_to_native`` repacks each expert."""
    jp, _ = jfrom_hf_model(hf, quant)
    assert jp["layers"]["experts"]["w_up"].planes[0].ndim == 4
    port, cfg = from_hf_model(hf, quant, device="cpu")
    bridged = params_from_numpy(jax_tree_to_numpy(jp), cfg, "cpu")
    _equal(bridged, port)
    assert bridged.layers[1].experts.w_up.cfg.native_pack


def test_gptq_mixtral_moe_experts():
    """Quantized experts and an fp router (the reference's
    ``convert_quantized_mixtral.py``)."""
    E, D, NH, NKV, I = 4, 256, 2, 1, 128
    kw = _cfg("mixtral", D, NH, NKV, I, n_experts=E, n_experts_active=2)
    q, kv = NH * (D // NH), NKV * (D // NH)
    rng = np.random.default_rng(5)
    sd, fp = {}, {}
    s = 500
    for i in range(kw["n_layers"]):
        p = f"model.layers.{i}."
        for nm, K, N in [("self_attn.q_proj", D, q),
                         ("self_attn.k_proj", D, kv),
                         ("self_attn.v_proj", D, kv),
                         ("self_attn.o_proj", q, D)]:
            s += 1
            _linear(sd, fp, p + nm, K, N, seed=s)
        for e in range(E):
            ep = p + f"block_sparse_moe.experts.{e}."
            for nm, K, N in [("w1", D, I), ("w3", D, I), ("w2", I, D)]:
                s += 1
                _linear(sd, fp, ep + nm, K, N, seed=s)
        router = rng.standard_normal((E, D)).astype(np.float32) * 0.1
        sd[p + "block_sparse_moe.gate.weight"] = router
        fp[p + "block_sparse_moe.gate.weight"] = router
        _vec(sd, fp, p + "input_layernorm.weight", D, rng)
        _vec(sd, fp, p + "post_attention_layernorm.weight", D, rng)
    _embed(sd, fp, "model.embed_tokens.weight", rng, rows=kw["vocab_size"],
           cols=D)
    _vec(sd, fp, "model.norm.weight", D, rng)
    _embed(sd, fp, "lm_head.weight", rng, rows=kw["vocab_size"], cols=D)
    port = _compare(sd, fp, kw)
    ex = port.layers[0].experts
    # the experts really are QTensor stacks (not silently dequantized)
    assert ex.quantized and all(
        isinstance(ex.weights()[k], QTensor) and
        ex.weights()[k].planes[0].shape[0] == E
        for k in ("w_gate", "w_up", "w_down"))
    assert port.layers[0].router.cfg is None


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory, hf):
    d = tmp_path_factory.mktemp("tiny_mixtral_shards")
    hf.save_pretrained(d, max_shard_size="300KB", safe_serialization=True)
    assert os.path.exists(os.path.join(d, "model.safetensors.index.json"))
    return str(d)


@pytest.mark.parametrize("quant", [None, "q4_j"])
def test_streamed_mixtral_equals_in_memory_and_jax(hf, hf_dir, quant,
                                                   monkeypatch):
    """A tensor at a time from the shards: equal to ``from_hf_model`` and
    to JAX's streamed params after the port's ``params_to_native`` (the
    JAX side quantized with its C++ codec off, as ``test_torch_stream.py``
    does)."""
    got, cfg = params_from_hf_dir(hf_dir, quant, device="cpu")
    ref, cfg_ref = from_hf_model(hf, quant, device="cpu")
    assert cfg == cfg_ref and cfg.n_experts == 4
    _equal(got, ref)
    monkeypatch.setattr(jnative, "available", lambda: False)
    jparams, _ = jparams_from_dir(hf_dir, quant, jnp.bfloat16)
    _equal(got, params_from_numpy(jax_tree_to_numpy(jparams), cfg, "cpu"))


def test_config_json_defaults_and_remote_grok(tmp_path):
    """A Mixtral ``config.json`` with only its model type reads as
    transformers' ``MixtralConfig`` would; Grok-1's config class is the
    checkpoint's remote code, so a key its ``config_from_hf`` needs and the
    file lacks raises naming it."""
    (tmp_path / "config.json").write_text(
        json.dumps({"model_type": "mixtral"}))
    got = read_config(str(tmp_path))
    want = transformers.MixtralConfig()
    for k in HF_DEFAULTS["mixtral"]:
        assert getattr(got, k) == getattr(want, k, None), k
    cfg = family("mixtral").config_from_hf(got)
    assert (cfg.n_experts, cfg.n_experts_active, cfg.rope_theta) == \
        (8, 2, 1e6)
    (tmp_path / "config.json").write_text(json.dumps(
        {"model_type": "grok-1", "vocab_size": 131072, "hidden_size": 6144,
         "num_hidden_layers": 64, "num_attention_heads": 48,
         "intermediate_size": 32768, "rms_norm_eps": 1e-5}))
    with pytest.raises(AttributeError, match="num_key_value_heads"):
        family("grok-1").config_from_hf(read_config(str(tmp_path)))


def test_jax_moe_file_loads_in_port(tmp_path, hf):
    """``Model.save`` of a JAX q4_0 Mixtral (stacked [L, E, ...] experts) →
    the port's ``init_from_bin``: every tensor equals the bridged JAX
    tree's."""
    p = str(tmp_path / "j.ntpu")
    jm = JModel().init_from_hf_model(hf, "q4_0")
    jm.save(p)
    pm = Model().init_from_bin(p, device="cpu")
    _equal(pm.params,
           params_from_numpy(jax_tree_to_numpy(jm.params), jm.cfg, "cpu"))
    assert dataclasses.asdict(pm.cfg) == dataclasses.asdict(jm.cfg)


def test_port_moe_file_loads_in_jax(tmp_path, hf):
    """The port's at-rest Mixtral (native-pack expert stacks, a bf16
    router) saved and loaded by JAX: its logits within 3e-2·max|logit| of
    the port's, and loaded back by the port equal."""
    pm = Model().init_from_hf_model(hf, "q4_j", device="cpu")
    p = str(tmp_path / "p.ntpu")
    pm.save(p)
    jm = JModel().init_from_bin(p)
    rows = [[3, 17, 91, 5, 6], [9, 1, 2]]
    want = pm(rows)
    got = np.asarray(jm(rows))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL_TOL * np.abs(want).max())
    _equal(Model().init_from_bin(p, device="cpu").params, pm.params)
