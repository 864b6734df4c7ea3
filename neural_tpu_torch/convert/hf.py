"""HF model / random weights → the port's decoder (port of the Llama,
Gemma, Bloom, MPT and ChatGLM-1 part of ``neural_tpu/convert/hf.py``).

Every quantized tensor is converted once, here, to the at-rest layout
(``runtime.generate.params_to_native``) that the kernels read; the port
keeps no second layout. A ``quant`` of None keeps the projections in bf16
(and the FFN unpadded, as the JAX package does). ``quant`` may also be a
:class:`~neural_tpu_torch.convert.quant_registry.QuantRegistry` (or a mixed
preset's name), which gives each tensor of each layer its own config; the
port's per-layer blocks hold such layers as they are. A QTensor already in
the state dict (a GPTQ/AWQ import) passes through as it is. Dtypes follow
the JAX package's ``build_params``: layer norms and biases in the model dtype,
the top-level 1-D tensors (``final_norm_w``/``_b``, Bloom's
``embed_norm_w``/``_b``) in f32, the embedding in the model dtype, the RoPE
table (absent under ALiBi) and the ALiBi slopes in f32.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import torch

from ..core.device import resolve_device
from ..core.dtypes import QuantConfig, quant_config_from_args
from ..core.qtensor import QTensor, quantize
from ..models import bloom as bloom_mod
from ..models import chatglm as chatglm_mod
from ..models import gemma as gemma_mod
from ..models import llama as llama_mod
from ..models import mpt as mpt_mod
from ..models.config import ModelConfig
from ..models.transformer import LINEARS, Transformer
from ..ops.rope import alibi_slopes, rope_freqs
from ..runtime.generate import params_to_native

ARCH_MODULES = {"llama": llama_mod, "mistral": llama_mod,
                "gemma": gemma_mod, "gemma2": gemma_mod, "bloom": bloom_mod,
                "mpt": mpt_mod, "chatglm": chatglm_mod,
                "chatglm1": chatglm_mod}


def ffn_padded_size(I: int, tile: int = 1024, max_overhead: float = 0.05):
    """Pad the FFN width to a ``tile`` multiple when that costs ≤5% (Llama's
    11008 → 11264). Zero columns of gate/up and zero rows of down are exact,
    so nothing is sliced afterwards."""
    t = -(-I // tile) * tile
    return t if t <= I * (1 + max_overhead) else I


def _shape_for(name: str, cfg: ModelConfig, Ip: int):
    """The shape of a projection (FFN padded to ``Ip``) or of a bias."""
    D = cfg.hidden_size
    return {
        "wq": (D, cfg.q_dim), "wk": (D, cfg.kv_dim), "wv": (D, cfg.kv_dim),
        "wo": (cfg.q_dim, D),
        "w_gate": (D, Ip), "w_up": (D, Ip), "w_down": (Ip, D),
        "bq": (cfg.q_dim,), "bk": (cfg.kv_dim,), "bv": (cfg.kv_dim,),
        "bo": (D,), "b_gate": (Ip,), "b_up": (Ip,), "b_down": (D,),
    }[name]


def _add_flags(layers, cfg: ModelConfig, mod, device):
    """The family's per-layer flags (Gemma-2's ``use_sliding``), as 0-d
    tensors in each layer's dict, as the JAX ``build_params`` stacks
    them."""
    flags = mod.layer_flags(cfg) if hasattr(mod, "layer_flags") else {}
    for name, arr in flags.items():
        for lp, f in zip(layers, arr):
            lp[name] = torch.tensor(bool(f), device=device)


def _add_aux(params: Dict[str, Any], cfg: ModelConfig, device):
    if cfg.rope_style != "none":
        params["rope_inv_freqs"] = torch.from_numpy(
            rope_freqs(cfg.head_dim, cfg.rope_dim, cfg.rope_theta,
                       cfg.rope_scaling_dict, max_seq_len=cfg.max_seq_len)
        ).to(device)
    if cfg.use_alibi:
        params["alibi_slopes"] = torch.from_numpy(
            alibi_slopes(cfg.n_heads)).to(device)


def _pad_ffn(name: str, w: torch.Tensor, cfg: ModelConfig, Ip: int):
    """Conversion-time FFN padding of gate/up columns (and biases) and down
    rows."""
    I_ = cfg.intermediate_size
    if Ip == I_:
        return w
    if name in ("w_gate", "w_up", "b_gate", "b_up") and w.shape[-1] == I_:
        return torch.nn.functional.pad(w, (0, Ip - I_))
    if name == "w_down" and w.shape[-2] == I_:
        return torch.nn.functional.pad(w, (0, 0, 0, Ip - I_))
    return w


def _resolver(qcfg):
    """(name, layer) → the QuantConfig of that tensor (None: keep it in the
    model dtype), for one config or a QuantRegistry."""
    from .quant_registry import QuantRegistry
    if isinstance(qcfg, QuantRegistry):
        return qcfg.resolve
    return lambda name, layer=None: qcfg


def qtensor_to(qt: QTensor, device) -> QTensor:
    """A QTensor with every tensor moved to ``device``."""
    mv = lambda t: None if t is None else t.to(device)
    return QTensor(tuple(mv(p) for p in qt.planes), mv(qt.scales),
                   mv(qt.zeros), mv(qt.perm), qt.cfg)


def build_param_dict(sd: Dict[str, Any], cfg: ModelConfig, mod=llama_mod,
                     quant: Union[str, QuantConfig, None] = "q4_j",
                     dtype: torch.dtype = torch.bfloat16,
                     device=None) -> Dict[str, Any]:
    """The param dict (``layers`` a list of per-layer dicts) of an HF-named
    state dict of f32 tensors or numpy arrays, with the QTensors of a
    GPTQ/AWQ import passing through (moved to ``device``, in the [K, N]
    orientation whatever the map's transpose flag says). Weights are moved
    to ``device`` before they are quantized, one at a time; the result is
    not yet at rest."""
    dev = resolve_device(device)
    qcfg = quant_config_from_args(quant)
    resolve = _resolver(qcfg)
    qnames = set(mod.QUANT_TENSORS)
    # as in the JAX package, only a quantized FFN is padded
    Ip = cfg.intermediate_size if qcfg is None else \
        ffn_padded_size(cfg.intermediate_size)

    if hasattr(mod, "preprocess_state_dict"):
        sd = mod.preprocess_state_dict(dict(sd), cfg)

    def get(hf_name, transpose):
        w = sd[hf_name]
        if isinstance(w, QTensor):
            return qtensor_to(w, dev)
        w = torch.as_tensor(w).to(device=dev, dtype=torch.float32)
        return w.T.contiguous() if transpose else w

    def quantized(name, w, layer=None):
        qc = resolve(name, layer)
        return w.to(dtype) if qc is None else quantize(w, qc)

    layers = []
    for i in range(cfg.n_layers):
        lp = {}
        for name, (hf_name, tr) in mod.hf_layer_map(i, cfg).items():
            w = get(hf_name, tr)
            if isinstance(w, QTensor):
                lp[name] = w
                continue
            w = _pad_ffn(name, w, cfg, Ip)
            if w.ndim == 2 and name in qnames:
                lp[name] = quantized(name, w, i)
            else:
                lp[name] = w.to(dtype)
        layers.append(lp)
    _add_flags(layers, cfg, mod, dev)
    params: Dict[str, Any] = {"layers": layers}
    for name, (hf_name, tr) in mod.hf_top_map(cfg).items():
        w = get(hf_name, tr)
        if isinstance(w, QTensor):
            params[name] = w
        elif name == "lm_head" and name in qnames:
            params[name] = quantized(name, w)
        elif name == "embed":
            params[name] = w.to(dtype)
        else:
            params[name] = w.to(dtype if w.ndim > 1 else torch.float32)
    _add_aux(params, cfg, dev)
    return params


def build_params(sd: Dict[str, Any], cfg: ModelConfig, mod=llama_mod,
                 quant: Union[str, QuantConfig, None] = "q4_j",
                 dtype: torch.dtype = torch.bfloat16,
                 device=None) -> Transformer:
    """Assemble the decoder from an HF-named state dict
    (:func:`build_param_dict`), its weights converted to the at-rest
    layouts."""
    return Transformer(cfg, params_to_native(build_param_dict(
        sd, cfg, mod, quant, dtype, device)))


def from_hf_model(model, quant: Union[str, QuantConfig] = "q4_j",
                  dtype: torch.dtype = torch.bfloat16, device=None):
    """A transformers ``*ForCausalLM`` (only its ``config`` attributes and
    ``state_dict()`` are read) → (Transformer, ModelConfig)."""
    mod = ARCH_MODULES.get(model.config.model_type)
    if mod is None:
        raise NotImplementedError(
            f"model type {model.config.model_type!r}: the port has "
            f"{sorted(ARCH_MODULES)}")
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
    exists in f32. Norm weights are drawn so that ``w + norm_offset`` is 1
    (ones, Gemma's zeros); the family's post norms and per-layer flags are
    there; projection and LayerNorm biases (Bloom, ChatGLM-1) are drawn
    like the weights, after each layer's projections, so a model without
    them draws what it drew before they existed; a tied lm_head is the
    embedding; Bloom's embedding LayerNorm has a unit weight and a zero
    bias. (The JAX package's ``init_random`` builds the whole f32 state
    dict on the host instead, with norm weights and biases of ones; the
    two draw different numbers.)"""
    dev = resolve_device(device)
    mod = ARCH_MODULES.get(cfg.arch, llama_mod)
    qcfg = quant_config_from_args(quant)
    resolve = _resolver(qcfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    Ip = cfg.intermediate_size if qcfg is None else \
        ffn_padded_size(cfg.intermediate_size)
    normal = lambda shape: torch.randn(shape, generator=gen, device=dev,
                                       dtype=torch.float32) * 0.02

    def weight(name, K, N, layer=None):
        w = normal((K, N))
        qc = resolve(name, layer)
        if qc is None:
            return w.to(dtype)
        return params_to_native(quantize(w, qc))

    names = list(mod.hf_layer_map(0, cfg))
    ones = lambda: torch.full((cfg.hidden_size,), 1.0 - cfg.norm_offset,
                              dtype=dtype, device=dev)
    layers = []
    for i in range(cfg.n_layers):
        lp = {n: weight(n, *_shape_for(n, cfg, Ip), i) for n in LINEARS
              if n in names}
        for n in names:
            if n.endswith("norm_w"):
                lp[n] = ones()
            elif n.endswith("norm_b"):
                lp[n] = normal((cfg.hidden_size,)).to(dtype)
            elif n not in lp:
                lp[n] = normal(_shape_for(n, cfg, Ip)).to(dtype)
        layers.append(lp)
    _add_flags(layers, cfg, mod, dev)
    D = cfg.hidden_size
    params: Dict[str, Any] = {
        "layers": layers,
        "embed": (torch.randn((cfg.vocab_size, D), generator=gen,
                              device=dev) * 0.02).to(dtype),
        "final_norm_w": torch.full((D,), 1.0 - cfg.norm_offset,
                                   dtype=torch.float32, device=dev),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = weight("lm_head", D, cfg.vocab_size)
    top = mod.hf_top_map(cfg)
    if "final_norm_b" in top:
        params["final_norm_b"] = normal((D,))
    if "embed_norm_w" in top:
        params["embed_norm_w"] = torch.ones(D, device=dev)
        params["embed_norm_b"] = torch.zeros(D, device=dev)
    _add_aux(params, cfg, dev)
    return Transformer(cfg, params)
