"""HF model / random weights → the port's decoder (port of the Llama part
of ``neural_tpu/convert/hf.py``).

Every quantized tensor is converted once, here, to the at-rest native-pack
layout (``core.qtensor.to_native_packed``) that the kernels read; the port
keeps no second layout. Dtypes follow the JAX package's ``build_params``:
layer norms in the model dtype, ``final_norm_w`` in f32, the embedding in
the model dtype, the RoPE table in f32.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import torch

from ..core.device import resolve_device
from ..core.dtypes import PRESETS, QuantConfig
from ..core.qtensor import quantize
from ..models import llama as llama_mod
from ..models.config import ModelConfig
from ..models.transformer import Transformer
from ..ops.rope import rope_freqs
from ..runtime.generate import params_to_native

ARCH_MODULES = {"llama": llama_mod, "mistral": llama_mod}


def resolve_quant(quant: Union[str, QuantConfig]) -> QuantConfig:
    """Preset name or QuantConfig → QuantConfig. Unquantized (bf16)
    projections are a later slice."""
    if quant is None:
        raise NotImplementedError("bf16 (unquantized) projections are a "
                                  "later slice; pass a quant preset")
    return quant if isinstance(quant, QuantConfig) else PRESETS[quant]


def ffn_padded_size(I: int, tile: int = 1024, max_overhead: float = 0.05):
    """Pad the FFN width to a ``tile`` multiple when that costs ≤5% (Llama's
    11008 → 11264). Zero columns of gate/up and zero rows of down are exact,
    so nothing is sliced afterwards."""
    t = -(-I // tile) * tile
    return t if t <= I * (1 + max_overhead) else I


def _shape_for(name: str, cfg: ModelConfig):
    D, I_ = cfg.hidden_size, cfg.intermediate_size
    return {
        "wq": (D, cfg.q_dim), "wk": (D, cfg.kv_dim), "wv": (D, cfg.kv_dim),
        "wo": (cfg.q_dim, D),
        "w_gate": (D, I_), "w_up": (D, I_), "w_down": (I_, D),
    }[name]


def _add_aux(params: Dict[str, Any], cfg: ModelConfig, device):
    params["rope_inv_freqs"] = torch.from_numpy(
        rope_freqs(cfg.head_dim, cfg.rope_dim, cfg.rope_theta,
                   cfg.rope_scaling_dict, max_seq_len=cfg.max_seq_len)
    ).to(device)


def _pad_ffn(name: str, w: torch.Tensor, cfg: ModelConfig, Ip: int):
    """Conversion-time FFN padding of gate/up columns and down rows."""
    I_ = cfg.intermediate_size
    if Ip == I_:
        return w
    if name in ("w_gate", "w_up") and w.shape[-1] == I_:
        return torch.nn.functional.pad(w, (0, Ip - I_))
    if name == "w_down" and w.shape[-2] == I_:
        return torch.nn.functional.pad(w, (0, 0, 0, Ip - I_))
    return w


def build_params(sd: Dict[str, torch.Tensor], cfg: ModelConfig, mod=llama_mod,
                 quant: Union[str, QuantConfig] = "q4_j",
                 dtype: torch.dtype = torch.bfloat16,
                 device=None) -> Transformer:
    """Assemble the decoder from an f32 HF-named state dict. Weights are
    moved to ``device`` before they are quantized, one at a time."""
    dev = resolve_device(device)
    qcfg = resolve_quant(quant)
    qnames = set(mod.QUANT_TENSORS)
    Ip = ffn_padded_size(cfg.intermediate_size)

    def get(hf_name, transpose):
        w = sd[hf_name].to(device=dev, dtype=torch.float32)
        return w.T.contiguous() if transpose else w

    layers = []
    for i in range(cfg.n_layers):
        lp = {}
        for name, (hf_name, tr) in mod.hf_layer_map(i, cfg).items():
            w = get(hf_name, tr)
            if w.ndim == 2 and name in qnames:
                lp[name] = quantize(_pad_ffn(name, w, cfg, Ip), qcfg)
            else:
                lp[name] = w.to(dtype)
        layers.append(lp)
    params: Dict[str, Any] = {"layers": layers}
    for name, (hf_name, tr) in mod.hf_top_map(cfg).items():
        w = get(hf_name, tr)
        if name == "lm_head" and name in qnames:
            params[name] = quantize(w, qcfg)
        elif name == "embed":
            params[name] = w.to(dtype)
        else:
            params[name] = w.to(dtype if w.ndim > 1 else torch.float32)
    _add_aux(params, cfg, dev)
    return Transformer(cfg, params_to_native(params))


def from_hf_model(model, quant: Union[str, QuantConfig] = "q4_j",
                  dtype: torch.dtype = torch.bfloat16, device=None):
    """A transformers ``*ForCausalLM`` (only its ``config`` attributes and
    ``state_dict()`` are read) → (Transformer, ModelConfig)."""
    mod = ARCH_MODULES.get(model.config.model_type)
    if mod is None:
        raise NotImplementedError(
            f"model type {model.config.model_type!r}: this slice ports Llama")
    cfg = mod.config_from_hf(model.config)
    sd = {k: v.detach().to(torch.float32)
          for k, v in model.state_dict().items()}
    return build_params(sd, cfg, mod, quant, dtype, device), cfg


@torch.inference_mode()
def init_random(cfg: ModelConfig, seed: int = 0,
                quant: Union[str, QuantConfig] = "q4_j",
                dtype: torch.dtype = torch.bfloat16,
                device=None) -> Transformer:
    """Random weights for benchmarks and smoke runs without a checkpoint.

    Each weight is drawn on ``device`` by a seeded ``torch.Generator``
    (N(0, 0.02²)), quantized there and converted to the at-rest layout;
    its f32 copy is freed before the next one is drawn, so a 7B model never
    exists in f32. Norm weights are ones. (The JAX package's ``init_random``
    builds the whole f32 state dict on the host instead; the two draw
    different numbers.)"""
    dev = resolve_device(device)
    qcfg = resolve_quant(quant)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    Ip = ffn_padded_size(cfg.intermediate_size)

    def weight(K, N):
        w = torch.randn((K, N), generator=gen, device=dev,
                        dtype=torch.float32) * 0.02
        return params_to_native(quantize(w, qcfg))

    layers = []
    for _ in range(cfg.n_layers):
        lp = {}
        for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            K, N = _shape_for(name, cfg)
            if name in ("w_gate", "w_up"):
                N = Ip
            elif name == "w_down":
                K = Ip
            lp[name] = weight(K, N)
        for name in ("attn_norm_w", "ffn_norm_w"):
            lp[name] = torch.ones(cfg.hidden_size, dtype=dtype, device=dev)
        layers.append(lp)
    params: Dict[str, Any] = {
        "layers": layers,
        "embed": (torch.randn((cfg.vocab_size, cfg.hidden_size),
                              generator=gen, device=dev) * 0.02).to(dtype),
        "final_norm_w": torch.ones(cfg.hidden_size, dtype=torch.float32,
                                   device=dev),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = weight(cfg.hidden_size, cfg.vocab_size)
    _add_aux(params, cfg, dev)
    return Transformer(cfg, params)
