"""Reading a local HF checkpoint directory without transformers or
safetensors (neither is on the machine with the card): ``config.json`` as
an attribute namespace for a family's ``config_from_hf``, the GPTQ/AWQ
quantize config, and ``*.safetensors`` files as numpy arrays.

A safetensors file is an 8-byte little-endian header length, a JSON header
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` plus an
optional ``__metadata__``), then the raw little-endian bytes, offsets
counted from the end of the header. BF16 arrives as float32 (numpy has no
bf16; the widening is exact).
"""
from __future__ import annotations

import glob
import json
import os
import struct
import types
from typing import Dict, Optional, Tuple

import numpy as np

# the defaults a transformers config object fills in for the attributes
# Llama's config_from_hf reads, where a config.json leaves them out
# (transformers' LlamaConfig and MistralConfig)
_LLAMA = dict(vocab_size=32000, hidden_size=4096, num_hidden_layers=32,
              num_attention_heads=32, hidden_act="silu", rms_norm_eps=1e-6,
              rope_theta=10000.0, rope_scaling=None,
              tie_word_embeddings=False, bos_token_id=1, eos_token_id=2)
# transformers' GemmaConfig and Gemma2Config (4.57): the attributes
# gemma.config_from_hf reads
_GEMMA = dict(vocab_size=256000, head_dim=256,
              max_position_embeddings=8192, rms_norm_eps=1e-6,
              rope_theta=10000.0, bos_token_id=2, eos_token_id=1)
HF_DEFAULTS = {
    "llama": dict(_LLAMA, intermediate_size=11008,
                  max_position_embeddings=2048),
    "mistral": dict(_LLAMA, intermediate_size=14336, num_key_value_heads=8,
                    max_position_embeddings=131072, sliding_window=4096),
    # transformers' MixtralConfig (4.57; mistralai/Mixtral-8x7B-v0.1): 8
    # experts a layer, top 2
    "mixtral": dict(_LLAMA, intermediate_size=14336, num_key_value_heads=8,
                    max_position_embeddings=131072, rms_norm_eps=1e-5,
                    rope_theta=1e6, sliding_window=None,
                    num_local_experts=8, num_experts_per_tok=2),
    "gemma": dict(_GEMMA, hidden_size=3072, intermediate_size=24576,
                  num_hidden_layers=28, num_attention_heads=16,
                  num_key_value_heads=16),
    "gemma2": dict(_GEMMA, hidden_size=2304, intermediate_size=9216,
                   num_hidden_layers=26, num_attention_heads=8,
                   num_key_value_heads=4, attn_logit_softcapping=50.0,
                   final_logit_softcapping=30.0, sliding_window=4096,
                   query_pre_attn_scalar=256),
    # transformers' BloomConfig (4.57)
    "bloom": dict(vocab_size=250880, hidden_size=64, n_layer=2, n_head=8,
                  layer_norm_epsilon=1e-5, bos_token_id=1, eos_token_id=2),
    # transformers' MptConfig (4.57; its attn_config defaults to ALiBi on,
    # which mpt.config_from_hf assumes when the key is absent)
    "mpt": dict(d_model=2048, n_heads=16, n_layers=24, expansion_ratio=4,
                max_seq_len=2048, vocab_size=50368),
    # transformers' GPTJConfig (4.57; its defaults are EleutherAI/gpt-j-6b)
    "gptj": dict(vocab_size=50400, n_embd=4096, n_layer=28, n_head=16,
                 n_inner=None, layer_norm_epsilon=1e-5, rotary_dim=64,
                 n_positions=2048, bos_token_id=50256, eos_token_id=50256),
    # transformers' GPTNeoXConfig (4.57; EleutherAI/gpt-neox-20b)
    "gpt_neox": dict(vocab_size=50432, hidden_size=6144,
                     num_hidden_layers=44, num_attention_heads=64,
                     intermediate_size=24576, layer_norm_eps=1e-5,
                     hidden_act="gelu", rotary_pct=0.25,
                     rotary_emb_base=10000, use_parallel_residual=True,
                     max_position_embeddings=2048, bos_token_id=0,
                     eos_token_id=2),
    # transformers' OPTConfig (4.57; facebook/opt-125m)
    "opt": dict(vocab_size=50272, hidden_size=768, num_hidden_layers=12,
                num_attention_heads=12, ffn_dim=3072,
                activation_function="relu", word_embed_proj_dim=768,
                tie_word_embeddings=True, max_position_embeddings=2048,
                bos_token_id=2, eos_token_id=2),
    # transformers' FalconConfig (4.57; tiiuae/falcon-7b; num_kv_heads
    # defaults to the head count there)
    "falcon": dict(vocab_size=65024, hidden_size=4544, num_hidden_layers=32,
                   num_attention_heads=71, num_kv_heads=71,
                   new_decoder_architecture=False, multi_query=True,
                   ffn_hidden_size=18176, layer_norm_epsilon=1e-5,
                   bias=False, rope_theta=10000.0, parallel_attn=True,
                   max_position_embeddings=2048, bos_token_id=11,
                   eos_token_id=11),
    # transformers' GPTBigCodeConfig (4.57)
    "gpt_bigcode": dict(vocab_size=50257, n_embd=768, n_layer=12, n_head=12,
                        multi_query=True, n_inner=None,
                        layer_norm_epsilon=1e-5, n_positions=1024,
                        bos_token_id=50256, eos_token_id=50256),
    # transformers' Qwen2Config (4.57; its bos/eos default to None, which
    # llama.config_from_hf reads as 1 and 2)
    "qwen2": dict(vocab_size=151936, hidden_size=4096, num_hidden_layers=32,
                  num_attention_heads=32, num_key_value_heads=32,
                  intermediate_size=22016, rms_norm_eps=1e-6,
                  hidden_act="silu", rope_theta=10000.0, rope_scaling=None,
                  tie_word_embeddings=False, max_position_embeddings=32768,
                  bos_token_id=None, eos_token_id=None),
    # transformers' PhiConfig (4.57; microsoft/phi-1)
    "phi": dict(vocab_size=51200, hidden_size=2048, num_hidden_layers=24,
                num_attention_heads=32, num_key_value_heads=32,
                intermediate_size=8192, layer_norm_eps=1e-5,
                partial_rotary_factor=0.5, rope_theta=10000.0,
                max_position_embeddings=2048, bos_token_id=1, eos_token_id=2),
    # transformers' Phi3Config (4.57; microsoft/Phi-3-mini-4k-instruct)
    "phi3": dict(vocab_size=32064, hidden_size=3072, num_hidden_layers=32,
                 num_attention_heads=32, num_key_value_heads=32,
                 intermediate_size=8192, rms_norm_eps=1e-5,
                 rope_theta=10000.0, rope_scaling=None,
                 tie_word_embeddings=False, max_position_embeddings=4096,
                 bos_token_id=1, eos_token_id=32000),
    # transformers' StableLmConfig (4.57; stabilityai/stablelm-3b-4e1t)
    "stablelm": dict(vocab_size=50304, hidden_size=2560,
                     num_hidden_layers=32, num_attention_heads=32,
                     num_key_value_heads=32, intermediate_size=6912,
                     layer_norm_eps=1e-5, use_qkv_bias=False,
                     partial_rotary_factor=0.25, rope_theta=10000,
                     max_position_embeddings=4096, bos_token_id=0,
                     eos_token_id=0),
    # transformers' WhisperConfig (4.57): the attributes
    # whisper.config_from_hf reads
    "whisper": dict(vocab_size=51865, d_model=384, encoder_layers=4,
                    decoder_layers=4, encoder_attention_heads=6,
                    encoder_ffn_dim=1536, num_mel_bins=80,
                    max_source_positions=1500, max_target_positions=448,
                    eos_token_id=50256, decoder_start_token_id=50257),
    # ChatGLM-1/2/3, Qwen v1, Baichuan and Grok-1 have no config class in
    # transformers (each checkpoint carries its own remote code): their
    # config.json has to hold every key their config_from_hf reads, beyond
    # the few that function defaults itself, and a missing one raises
    # (RemoteConfig)
}
# model types whose config class is the checkpoint's own remote code
REMOTE_CODE = ("chatglm", "chatglm1", "qwen", "baichuan", "grok", "grok-1")


class RemoteConfig(types.SimpleNamespace):
    """The keys of a remote-code model's config.json; reading a key it
    lacks raises an AttributeError that names the key and the file
    (``getattr`` with a default still works)."""

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        raise AttributeError(
            f"{self.__dict__.get('_path', 'config.json')} has no {name!r}, "
            f"which a {self.__dict__.get('model_type')!r} config needs "
            "(the model type's config class is the checkpoint's own remote "
            "code, which the port does not run)")


def read_config(path: str) -> types.SimpleNamespace:
    """``<path>/config.json`` → a namespace of its keys (nested dicts stay
    dicts), with the transformers defaults of its ``model_type`` under the
    keys it leaves out; a remote-code type's is a :class:`RemoteConfig`."""
    file = os.path.join(path, "config.json")
    with open(file) as fh:
        d = json.load(fh)
    if d.get("model_type") in REMOTE_CODE:
        return RemoteConfig(_path=file, **d)
    return types.SimpleNamespace(**{**HF_DEFAULTS.get(d.get("model_type"),
                                                      {}), **d})


def quantize_config(path: str, hf_cfg) -> Tuple[int, Optional[int]]:
    """(bits, group_size) of a GPTQ/AWQ checkpoint: the config's
    ``quantization_config`` when it has the bits, else
    ``quantize_config.json`` beside it, else (4, None)."""
    qc = getattr(hf_cfg, "quantization_config", None)
    if isinstance(qc, dict) and "bits" in qc:
        return int(qc["bits"]), qc.get("group_size")
    qcp = os.path.join(path, "quantize_config.json")
    if os.path.exists(qcp):
        with open(qcp) as fh:
            qj = json.load(fh)
        return int(qj.get("bits", 4)), qj.get("group_size")
    return 4, None


_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
           "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
           "U64": np.uint64, "U32": np.uint32, "U16": np.uint16,
           "U8": np.uint8, "BOOL": np.bool_, "BF16": np.uint16}


def safetensors_header(file: str) -> Tuple[Dict[str, dict], int]:
    """A ``.safetensors`` file's tensor table {name: {"dtype", "shape",
    "data_offsets"}} (without ``__metadata__``) and the byte offset of its
    data."""
    with open(file, "rb") as fh:
        (n,) = struct.unpack("<Q", fh.read(8))
        header = json.loads(fh.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def decode_tensor(buf, info: dict, file: str = "", name: str = ""
                  ) -> np.ndarray:
    """One table entry's bytes ``buf`` → a numpy array of its own (BF16
    widened to f32)."""
    dt = info["dtype"]
    if dt not in _DTYPES:
        raise ValueError(f"{file}: {name} has dtype {dt}, which this reader "
                         "does not take")
    a = np.frombuffer(buf, dtype=np.dtype(_DTYPES[dt]).newbyteorder("<")
                      ).reshape(info["shape"])
    if dt == "BF16":
        a = (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(a.dtype.newbyteorder("="))


def read_safetensors(file: str) -> Dict[str, np.ndarray]:
    """One ``.safetensors`` file → {name: numpy array}."""
    header, base = safetensors_header(file)
    out = {}
    with open(file, "rb") as fh:
        for name, info in header.items():
            b, e = info["data_offsets"]
            fh.seek(base + b)
            out[name] = decode_tensor(fh.read(e - b), info, file, name)
    return out


def read_safetensors_dir(path: str) -> Dict[str, np.ndarray]:
    """Every ``*.safetensors`` file of a directory, in name order, merged."""
    sd: Dict[str, np.ndarray] = {}
    files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no .safetensors file in {path}")
    for f in files:
        sd.update(read_safetensors(f))
    return sd
