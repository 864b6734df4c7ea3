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
HF_DEFAULTS = {
    "llama": dict(_LLAMA, intermediate_size=11008,
                  max_position_embeddings=2048),
    "mistral": dict(_LLAMA, intermediate_size=14336, num_key_value_heads=8,
                    max_position_embeddings=131072, sliding_window=4096),
}


def read_config(path: str) -> types.SimpleNamespace:
    """``<path>/config.json`` → a namespace of its keys (nested dicts stay
    dicts), with the transformers defaults of its ``model_type`` under the
    keys it leaves out."""
    with open(os.path.join(path, "config.json")) as fh:
        d = json.load(fh)
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


def read_safetensors(file: str) -> Dict[str, np.ndarray]:
    """One ``.safetensors`` file → {name: numpy array}."""
    out = {}
    with open(file, "rb") as fh:
        (n,) = struct.unpack("<Q", fh.read(8))
        header = json.loads(fh.read(n))
        base = 8 + n
        for name, info in header.items():
            if name == "__metadata__":
                continue
            dt = info["dtype"]
            if dt not in _DTYPES:
                raise ValueError(f"{file}: {name} has dtype {dt}, which "
                                 "this reader does not take")
            b, e = info["data_offsets"]
            fh.seek(base + b)
            a = np.frombuffer(fh.read(e - b), dtype=np.dtype(
                _DTYPES[dt]).newbyteorder("<")).reshape(info["shape"])
            if dt == "BF16":
                a = (a.astype(np.uint32) << 16).view(np.float32)
            out[name] = a.astype(a.dtype.newbyteorder("="))
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
