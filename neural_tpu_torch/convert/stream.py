"""Streamed HF-checkpoint conversion: safetensors shards → the port's
decoder, one layer at a time, without the whole state dict in host memory
(port of ``neural_tpu/convert/stream.py``).

Reference analog: the converter's LazyTensor machinery
(neural_speed/convert/convert_llama.py:146-520) and the mmap'd multi-shard
loader (models/model_utils/model_files.h:1432-1620). Each shard is mapped
(``mmap``) and each tensor is read from its own byte range through the
port's safetensors header reader (``convert.files``); it goes to the
target device as it arrives and is converted there by the same per-tensor
pipeline as the in-memory path (``convert.hf._Converter``: transpose → FFN
pad → RTN quantize or cast); the host holds one tensor's file bytes at a
time (a BF16 tensor is widened on the device), and a shard is mapped only
while one of its tensors is copied out. Families whose fused
projections are split before conversion (Bloom, MPT, ChatGLM-1) read a
layer's tensors together first. A mixture-of-experts layer's experts are
read, quantized and converted one expert weight at a time and stacked into
the layer's ``[E, ...]`` layout (``_Converter.expert_stack``), so no
layer's experts exist in f32 at once. No transformers
and no safetensors package are needed: ``config.json`` is read by
``convert.files.read_config``.

The result equals :func:`convert.hf.build_params` on the same state dict,
tensor for tensor, and the JAX ``params_from_hf_dir`` followed by the
port's ``params_to_native`` (``tests/test_torch_stream.py``).
"""
from __future__ import annotations

import json
import mmap
import os
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core.dtypes import QuantConfig
from ..models.config import ModelConfig
from ..models.transformer import Transformer
from . import files


class ShardedCheckpoint:
    """Per-tensor reader over a safetensors checkpoint directory (a single
    ``*.safetensors`` file, several, or shards listed by
    ``model.safetensors.index.json``). Each read maps the tensor's shard,
    copies the tensor's bytes and unmaps it again, so no page of a shard
    stays resident after its tensor is read (dropping them with
    ``madvise`` is not honoured everywhere); only the shards' tables are
    kept."""

    def __init__(self, path: str):
        self.dir = path
        self.weight_map: Dict[str, str] = {}
        idx = os.path.join(path, "model.safetensors.index.json")
        if os.path.exists(idx):
            with open(idx) as f:
                self.weight_map = dict(json.load(f)["weight_map"])
        else:
            singles = [f for f in sorted(os.listdir(path))
                       if f.endswith(".safetensors")]
            if not singles:
                raise FileNotFoundError(
                    f"no .safetensors files under {path}")
            for fn in singles:
                header, _ = files.safetensors_header(os.path.join(path, fn))
                for k in header:
                    self.weight_map[k] = fn
        self._tables: Dict[str, Tuple[dict, int]] = {}

    def names(self) -> List[str]:
        return list(self.weight_map)

    def _read(self, name: str, decode):
        """``decode(bytes view, table entry)`` of one tensor, read from
        its shard's map; ``decode`` copies what it keeps."""
        fn = self.weight_map[name]
        file = os.path.join(self.dir, fn)
        if fn not in self._tables:
            self._tables[fn] = files.safetensors_header(file)
        header, base = self._tables[fn]
        info = header[name]
        b, e = base + info["data_offsets"][0], base + info["data_offsets"][1]
        with open(file, "rb") as fh:
            mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
        try:
            view = memoryview(mm)[b:e]
            try:
                return decode(view, info)
            finally:
                view.release()
        finally:
            mm.close()

    def tensor(self, name: str) -> np.ndarray:
        """One tensor as a numpy array of its own (BF16 widened to f32)."""
        return self._read(name, lambda v, info: files.decode_tensor(
            v, info, self.weight_map[name], name))

    def tensor_on(self, name: str, device) -> torch.Tensor:
        """One tensor on ``device``, floats widened to f32 there: the host
        holds the file's bytes of that one tensor only (a BF16 tensor
        crosses as its 16-bit patterns)."""
        def decode(view, info):
            if info["dtype"] != "BF16":
                return torch.from_numpy(files.decode_tensor(
                    view, info, self.weight_map[name], name)).to(device)
            bits = np.frombuffer(view, "<i2").reshape(info["shape"]).copy()
            return torch.from_numpy(bits).to(device).view(torch.bfloat16)
        t = self._read(name, decode)
        return t.to(torch.float32) if t.is_floating_point() else t

    def release(self):
        """Forget the shards' tables (no shard stays mapped between
        reads)."""
        self._tables.clear()

    close = release


def _layer_prefix(m: Dict[str, tuple]) -> str:
    """Longest common prefix of a layer map's HF names, cut after its last
    '.', so that layer 1 never claims layer 11's names."""
    pre = os.path.commonprefix([v[0] for v in m.values()])
    return pre[: pre.rfind(".") + 1]


def params_from_hf_dir(path: str,
                       quant: Union[None, str, QuantConfig] = None,
                       dtype: torch.dtype = torch.bfloat16,
                       cfg: Optional[ModelConfig] = None, arch_mod=None,
                       device=None) -> Tuple[Transformer, ModelConfig]:
    """Streamed directory → (Transformer at rest, cfg), every tensor
    converted on ``device`` (the card unless ``device="cpu"``) as it is
    read. ``quant`` is a preset or mixed-preset name, a QuantConfig, a
    QuantRegistry, or None (bf16 projections). ``cfg``/``arch_mod`` come
    from the directory's ``config.json`` unless given."""
    from ..runtime.generate import params_to_native
    from .hf import _Converter, family, resolve_quant
    if cfg is None or arch_mod is None:
        hf_cfg = files.read_config(path)
        arch_mod = arch_mod or family(hf_cfg.model_type)
        cfg = cfg or arch_mod.config_from_hf(hf_cfg)
    mod = arch_mod
    conv = _Converter(cfg, mod, resolve_quant(quant), dtype, device,
                      at_rest=True)
    reader = ShardedCheckpoint(path)

    def on_device(names):
        return {n: reader.tensor_on(n, conv.dev) for n in names}

    class _OnRead(dict):
        """A layer's state dict read a tensor at a time, as the converter
        asks for it: the host holds one tensor's bytes at a time."""

        def __missing__(self, name):
            return reader.tensor_on(name, conv.dev)

    all_names = reader.names()
    claimed = set()
    layers = []
    try:
        for i in range(cfg.n_layers):
            pre = _layer_prefix(mod.hf_layer_map(i, cfg))
            lnames = [n for n in all_names if n.startswith(pre)]
            claimed.update(lnames)
            if hasattr(mod, "preprocess_state_dict"):
                # a fused projection is split before its parts convert
                lsd = mod.preprocess_state_dict(on_device(lnames), cfg)
            else:
                lsd = _OnRead()
            layers.append(params_to_native(conv.layer(lsd, i)))
            del lsd
            reader.release()
        conv.flags(layers)
        top_names = [n for n in all_names if n not in claimed]
        top_sd = mod.preprocess_state_dict(on_device(top_names), cfg) \
            if hasattr(mod, "preprocess_state_dict") else _OnRead()
        top = params_to_native(conv.top(top_sd))
    finally:
        reader.close()
    return Transformer(cfg, {"layers": layers, **top}), cfg
