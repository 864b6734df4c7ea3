"""The streamed safetensors conversion in the port (``convert/stream.py``)
against the JAX package and against the port's in-memory path: twins of
``tests/test_stream.py``. The streamed params equal, tensor for tensor, the
port's ``from_hf_model`` of the same model and JAX's ``params_from_hf_dir``
then the port's ``params_to_native`` (the JAX side quantized with its
optional C++ codec off, as ``test_torch_mixed.py`` does: the codec rounds
one tie the other way); a layer-heterogeneous registry streams; and the
host's RSS high-water mark while streaming stays far below the state
dict's size, at the JAX test's own size.
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from neural_tpu import native as jnative
from neural_tpu.convert.stream import params_from_hf_dir as jparams_from_dir

from neural_tpu_torch.api import Model
from neural_tpu_torch.convert.from_jax import params_from_numpy
from neural_tpu_torch.convert.hf import from_hf_model
from neural_tpu_torch.convert.quant_registry import QuantRegistry
from neural_tpu_torch.convert.stream import (ShardedCheckpoint,
                                             params_from_hf_dir)
from neural_tpu_torch.runtime.generate import greedy_generate
from test_stream import TINY_LLAMA
from test_torch_bridge import jax_tree_to_numpy


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """A transformers tiny llama saved as multi-shard safetensors."""
    d = tmp_path_factory.mktemp("tiny_llama_shards")
    cfg = transformers.LlamaConfig(**{k: v for k, v in TINY_LLAMA.items()
                                      if k != "architectures"})
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(cfg)
    model.save_pretrained(d, max_shard_size="100KB", safe_serialization=True)
    assert os.path.exists(os.path.join(d, "model.safetensors.index.json"))
    return str(d), model


def _equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype, k
        assert torch.equal(sa[k], sb[k]), k


def test_sharded_reader_reads_every_tensor(hf_dir):
    d, model = hf_dir
    r = ShardedCheckpoint(d)
    sd = model.state_dict()
    assert set(r.names()) == set(sd)
    for n in r.names():
        np.testing.assert_array_equal(r.tensor(n), sd[n].numpy())
    r.release()


@pytest.mark.parametrize("quant", [None, "q4_0"])
def test_streamed_matches_from_hf_model(hf_dir, quant):
    d, model = hf_dir
    ref, cfg_ref = from_hf_model(model, quant, device="cpu")
    got, cfg = params_from_hf_dir(d, quant, device="cpu")
    assert cfg == cfg_ref
    _equal(got, ref)


@pytest.mark.parametrize("quant", [None, "q4_j"])
def test_streamed_equals_jax(hf_dir, quant, monkeypatch):
    """The port's streamed model equals JAX's streamed params (bf16) after
    the port's ``params_to_native``."""
    d, _ = hf_dir
    monkeypatch.setattr(jnative, "available", lambda: False)
    jparams, jcfg = jparams_from_dir(d, quant, jnp.bfloat16)
    got, cfg = params_from_hf_dir(d, quant, device="cpu")
    _equal(got, params_from_numpy(jax_tree_to_numpy(jparams), cfg, "cpu"))


@pytest.mark.parametrize("model_type,cls", [
    ("llama", "LlamaConfig"), ("mistral", "MistralConfig"),
    ("gemma", "GemmaConfig"), ("gemma2", "Gemma2Config"),
    ("bloom", "BloomConfig"), ("mpt", "MptConfig")])
def test_hf_defaults_are_transformers_defaults(tmp_path, model_type, cls):
    """``read_config`` of a config.json with only its model type gives
    each attribute the family's ``config_from_hf`` reads the value a
    transformers config object would."""
    from neural_tpu_torch.convert.files import HF_DEFAULTS, read_config
    (tmp_path / "config.json").write_text(
        json.dumps({"model_type": model_type}))
    got = read_config(str(tmp_path))
    want = getattr(transformers, cls)()
    for k in HF_DEFAULTS[model_type]:
        assert getattr(got, k) == getattr(want, k, None), k


def test_streamed_through_model_init(hf_dir):
    d, _ = hf_dir
    m = Model().init(d, weight_dtype="q4_0", device="cpu")
    assert m.tokenizer is None
    out = m.generate([[3, 5, 7]], max_new_tokens=4, stop_at_eos=False)
    assert len(out[0]) == 7
    assert m.params.layers[0].w_up.cfg.bits == 4


def test_streamed_registry_mixed(hf_dir):
    """A layer-heterogeneous registry through the streamed path: each layer
    gets its own configs, and the model generates."""
    d, _ = hf_dir
    reg = QuantRegistry(rules=[("layers.0.w_up", "int8")], default="q4_0")
    params, cfg = params_from_hf_dir(d, reg, device="cpu")
    assert params.layers[0].w_up.cfg.bits == 8
    assert params.layers[1].w_up.cfg.bits == 4
    out = greedy_generate(params, cfg, [3, 5], max_new_tokens=3,
                          stop_at_eos=False)
    assert len(out) == 5


_RSS_SCRIPT = r"""
import json, sys
sys.path.insert(0, {root!r})

def vm(field):
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(field):
                return int(line.split()[1])   # kB
    raise KeyError(field)

import torch
from neural_tpu_torch.models import llama as llama_mod
from neural_tpu_torch.models.config import ModelConfig
cfg = ModelConfig(arch="llama", vocab_size=8192, hidden_size=1024,
                  n_layers=4, n_heads=8, n_kv_heads=8, head_dim=128,
                  intermediate_size=2816, max_seq_len=128)
torch.set_num_threads(2)
hwm0 = vm("VmHWM")
if {streamed!r} == "streamed":
    from neural_tpu_torch.convert.stream import params_from_hf_dir
    params, _ = params_from_hf_dir({ckpt!r}, "q4_0", cfg=cfg,
                                   arch_mod=llama_mod, device="cpu")
else:   # control: the whole state dict read first
    from neural_tpu_torch.convert.files import read_safetensors_dir
    from neural_tpu_torch.convert.hf import build_params
    sd = read_safetensors_dir({ckpt!r})
    params = build_params(sd, cfg, llama_mod, "q4_0", device="cpu")
hwm1 = vm("VmHWM")
print(json.dumps({{"hwm0_kb": hwm0, "hwm1_kb": hwm1,
                   "n_tensors": len(params.state_dict())}}))
"""


def test_streamed_rss_bounded(tmp_path):
    """A ~270 MB fp32 multi-shard checkpoint: the streamed path's RSS
    high-water delta stays far below the state dict's size and below the
    whole-state-dict control's (the JAX test's sizes and bounds)."""
    from safetensors.numpy import save_file
    from neural_tpu_torch.convert.hf import _shape_for
    from neural_tpu_torch.models import llama as llama_mod
    from neural_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig(arch="llama", vocab_size=8192, hidden_size=1024,
                      n_layers=4, n_heads=8, n_kv_heads=8, head_dim=128,
                      intermediate_size=2816, max_seq_len=128)
    d = tmp_path / "big"
    d.mkdir()
    rng = np.random.default_rng(0)
    weight_map, total = {}, 0
    for i in range(cfg.n_layers):
        shard = {}
        for ours, (hf, tr) in llama_mod.hf_layer_map(i, cfg).items():
            if ours.startswith(("attn_norm", "ffn_norm")):
                shard[hf] = np.ones(cfg.hidden_size, np.float32)
            else:
                K, N = _shape_for(ours, cfg, cfg.intermediate_size)
                shard[hf] = rng.standard_normal((N, K)).astype(np.float32) \
                    * 0.02
        fn = f"model-{i:05d}.safetensors"
        save_file(shard, str(d / fn))
        weight_map.update({k: fn for k in shard})
        total += sum(v.nbytes for v in shard.values())
    top = {
        "model.embed_tokens.weight": rng.standard_normal(
            (cfg.vocab_size, cfg.hidden_size)).astype(np.float32) * 0.02,
        "model.norm.weight": np.ones(cfg.hidden_size, np.float32),
        "lm_head.weight": rng.standard_normal(
            (cfg.vocab_size, cfg.hidden_size)).astype(np.float32) * 0.02,
    }
    save_file(top, str(d / "model-top.safetensors"))
    weight_map.update({k: "model-top.safetensors" for k in top})
    total += sum(v.nbytes for v in top.values())
    with open(d / "model.safetensors.index.json", "w") as f:
        json.dump({"weight_map": weight_map}, f)
    assert total > 250e6

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def run(mode):
        script = _RSS_SCRIPT.format(root=root, ckpt=str(d), streamed=mode)
        r = subprocess.run([sys.executable, "-c", script],
                           capture_output=True, text=True, timeout=600)
        assert r.returncode == 0, r.stderr[-2000:]
        out = json.loads(r.stdout.strip().splitlines()[-1])
        assert out["n_tensors"] > 10
        return (out["hwm1_kb"] - out["hwm0_kb"]) / 1024

    streamed = run("streamed")
    control = run("control")
    assert streamed < 350, f"streamed RSS delta {streamed:.0f} MB"
    assert streamed < 0.62 * control, \
        f"streamed {streamed:.0f} MB vs full-materialize {control:.0f} MB"
