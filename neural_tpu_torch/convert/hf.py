"""HF model / random weights → the port's decoder (port of
``neural_tpu/convert/hf.py`` for every family of its registry).

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
``embed_norm_w``/``_b``, ``lm_head_b``) in f32, the embedding and the
learned position table in the model dtype, the RoPE table (absent under
ALiBi and learned positions) and the ALiBi slopes in f32. A
mixture-of-experts layer (Mixtral, Grok) keeps its router in the model
dtype (it is no ``QUANT_TENSORS`` name) and stacks each expert projection
into an ``[E, ...]`` layer stack, quantized one expert at a time by the
config its name resolves to without a layer (``reg.resolve(sub)``, as the
JAX ``build_params``), never FFN-padded.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.dtypes import PRESETS, QuantConfig, quant_config_from_args
from ..core.qtensor import (QTensor, concat_n, dequantize, quantize,
                           stack_qtensors, to_native, unstack_qtensor)
from ..models import (baichuan, bloom, chatglm, falcon, gemma, gptj,
                      gptneox, grok, llama, mpt, opt, phi, qwen, stablelm,
                      starcoder)
from ..models.config import ModelConfig
from ..models.transformer import LINEARS, Transformer
from ..ops.rope import alibi_slopes, rope_freqs
from ..runtime.generate import params_to_native


# HF model_type → family module, the JAX registry's names
# (neural_tpu/convert/hf.py:33-47) but for those of REFUSED
ARCH_MODULES = {"llama": llama, "mistral": llama, "mixtral": llama,
                "solar": llama, "grok": grok, "grok-1": grok,
                "gptj": gptj, "gpt_neox": gptneox, "opt": opt,
                "bloom": bloom, "mpt": mpt, "falcon": falcon,
                "gpt_bigcode": starcoder, "qwen": qwen, "qwen2": qwen,
                "phi": phi, "phi3": phi, "gemma": gemma, "gemma2": gemma,
                "stablelm": stablelm, "baichuan": baichuan,
                "chatglm": chatglm, "chatglm1": chatglm}


def register_arch(names, module):
    """Add ``module`` as the family of each HF ``model_type`` in
    ``names`` (the JAX package's ``register_arch``)."""
    for n in names:
        ARCH_MODULES[n] = module


# the model types the JAX package, the port's reference, does not run, each
# with why (ROADMAP §C)
REFUSED = {"qwen2_moe": qwen.QWEN2_MOE_GAP, "qwen3": qwen.QWEN3_FAULT}
# the refusals the port keeps from the JAX package's MoE import
MOE_REQUANT = "registry requantization of MoE experts is unsupported"
MOE_HETERO = ("layer-heterogeneous quant registries are not supported for "
              "MoE experts; use layer-uniform rules")


def family(model_type: str):
    """The family module of an HF ``model_type``; raises
    ``NotImplementedError`` naming why for the refused ones and the
    unknown ones."""
    if model_type in REFUSED:
        raise NotImplementedError(REFUSED[model_type])
    mod = ARCH_MODULES.get(model_type)
    if mod is None:
        raise NotImplementedError(
            f"model type {model_type!r}: the port has {sorted(ARCH_MODULES)}")
    return mod


def ffn_padded_size(I: int, tile: int = 1024, max_overhead: float = 0.05):
    """Pad the FFN width to a ``tile`` multiple when that costs ≤5% (Llama's
    11008 → 11264). Zero columns of gate/up and zero rows of down are exact,
    so nothing is sliced afterwards."""
    t = -(-I // tile) * tile
    return t if t <= I * (1 + max_overhead) else I


def _shape_for(name: str, cfg: ModelConfig, Ip: int):
    """The shape of a projection (FFN padded to ``Ip``), of a bias or of the
    router."""
    D = cfg.hidden_size
    return {
        "wq": (D, cfg.q_dim), "wk": (D, cfg.kv_dim), "wv": (D, cfg.kv_dim),
        "wo": (cfg.q_dim, D), "router": (D, cfg.n_experts),
        "w_gate": (D, Ip), "w_up": (D, Ip), "w_down": (Ip, D),
        "bq": (cfg.q_dim,), "bk": (cfg.kv_dim,), "bv": (cfg.kv_dim,),
        "bo": (D,), "b_gate": (Ip,), "b_up": (Ip,), "b_down": (D,),
        "q_norm_w": (cfg.head_dim,), "k_norm_w": (cfg.head_dim,),
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


def expert_subs(names) -> list:
    """The expert projections (``experts.{e}.{sub}``) among a layer map's
    names."""
    return sorted({n.split(".", 2)[2] for n in names
                   if n.startswith("experts.")})


def _resolver(qcfg):
    """(name, layer) → the QuantConfig of that tensor (None: keep it in the
    model dtype), for one config or a QuantRegistry."""
    from .quant_registry import QuantRegistry
    if isinstance(qcfg, QuantRegistry):
        return qcfg.resolve
    return lambda name, layer=None: qcfg


def resolve_quant(quant: Union[None, str, QuantConfig]):
    """Preset name / QuantConfig / QuantRegistry / mixed-preset name →
    QuantConfig or QuantRegistry (or None)."""
    from .quant_registry import MIXED_PRESETS, QuantRegistry
    if quant is None or isinstance(quant, (QuantConfig, QuantRegistry)):
        return quant
    if quant in MIXED_PRESETS:
        return MIXED_PRESETS[quant]
    return PRESETS[quant]


def requantize(params: Dict[str, Any], qcfg) -> Dict[str, Any]:
    """Re-quantize every QTensor of a param dict (``layers`` a list of
    per-layer dicts) to ``qcfg``: dequantize to f32 on the tensor's device,
    then RTN ``quantize`` there (the reference quant_model file→file path,
    quant_utils.cpp:269). ``qcfg`` may be a QuantRegistry (per-tensor
    configs; a rule of None dequantizes the tensor to bf16). The result is
    not at rest. Raises for params without a QTensor: quantize those at
    conversion (``Model.init(weight_dtype=...)``). A layer's expert stacks
    requantize one expert at a time; a registry refuses them, as the JAX
    package's does."""
    from .quant_registry import QuantRegistry
    qcfg = resolve_quant(qcfg)
    registry = isinstance(qcfg, QuantRegistry)
    resolve = qcfg.resolve if registry else (lambda name, layer=None: qcfg)
    if registry and any("experts" in lp for lp in params["layers"]):
        raise NotImplementedError(MOE_REQUANT)
    found = [False]

    def req(leaf, name, layer):
        if isinstance(leaf, dict):                 # a layer's experts
            return {k: req(v, k, layer) for k, v in leaf.items()}
        if not isinstance(leaf, QTensor):
            return leaf
        found[0] = True
        if leaf.planes[0].ndim > 2:
            return stack_qtensors([req(q, name, layer)
                                   for q in unstack_qtensor(leaf)])
        w = dequantize(leaf)
        qc = resolve(name, layer)
        return w.to(torch.bfloat16) if qc is None else quantize(w, qc)

    out = {k: req(v, k, None) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: req(v, k, i) for k, v in lp.items()}
                     for i, lp in enumerate(params["layers"])]
    if not found[0]:
        raise ValueError("params hold no quantized tensors; quantize at "
                         "conversion time via Model.init(weight_dtype=...)")
    return out


def qtensor_to(qt: QTensor, device) -> QTensor:
    """A QTensor with every tensor moved to ``device``."""
    mv = lambda t: None if t is None else t.to(device)
    return QTensor(tuple(mv(p) for p in qt.planes), mv(qt.scales),
                   mv(qt.zeros), mv(qt.perm), qt.cfg)


# the elements of one slice of a weight quantized at a time
_SLICE_ELEMS = 1 << 20


class _Converter:
    """The per-tensor pipeline of :func:`build_param_dict`, a layer or the
    top-level tensors at a time (the streamed conversion,
    ``convert.stream``, feeds it one layer's state dict after another):
    f32 on ``device`` → transpose → FFN pad → quantize, or cast. With
    ``at_rest``, each quantized slice is converted to the at-rest layout
    as it is made (``core.qtensor.to_native``), so no whole tensor's
    unpacked codes exist at once."""

    def __init__(self, cfg: ModelConfig, mod, quant, dtype, device,
                 at_rest: bool = False):
        self.cfg, self.mod, self.dtype = cfg, mod, dtype
        self.at_rest = at_rest
        self.dev = resolve_device(device)
        qcfg = quant_config_from_args(quant)
        self.resolve = _resolver(qcfg)
        self.qnames = set(mod.QUANT_TENSORS)
        if cfg.is_moe:
            # the JAX ``build_params`` refuses a registry whose rules for a
            # layer's plain quantized names differ by layer
            plain = [n for n in mod.hf_layer_map(0, cfg)
                     if n in self.qnames]
            if not _uniform(qcfg, plain, cfg.n_layers):
                raise NotImplementedError(MOE_HETERO)
        # as in the JAX package, only a quantized FFN is padded
        self.Ip = cfg.intermediate_size if qcfg is None else \
            ffn_padded_size(cfg.intermediate_size)

    def get(self, sd, hf_name, transpose):
        w = sd[hf_name]
        if isinstance(w, QTensor):
            return qtensor_to(w, self.dev)
        w = torch.as_tensor(w).to(device=self.dev, dtype=torch.float32)
        return w.T.contiguous() if transpose else w

    def quantized(self, name, w, layer=None):
        """``w`` [K, N] quantized to its config, in slices of N (columns
        quantize independently, so the result is the whole tensor's) to
        bound the temporaries, or cast when its config is None."""
        qc = self.resolve(name, layer)
        if qc is None:
            return w.to(self.dtype)
        one = (lambda x: to_native(quantize(x, qc))) if self.at_rest \
            else (lambda x: quantize(x, qc))
        step = max(128, _SLICE_ELEMS // w.shape[0])
        if w.shape[1] <= step:
            return one(w)
        return concat_n([one(w[:, n0:n0 + step].contiguous())
                         for n0 in range(0, w.shape[1], step)])

    def layer(self, sd, i: int) -> Dict[str, Any]:
        lp = {}
        m = self.mod.hf_layer_map(i, self.cfg)
        for name, (hf_name, tr) in m.items():
            if name.startswith("experts."):
                continue
            w = self.get(sd, hf_name, tr)
            if isinstance(w, QTensor):
                lp[name] = w
                continue
            w = _pad_ffn(name, w, self.cfg, self.Ip)
            if w.ndim == 2 and name in self.qnames:
                lp[name] = self.quantized(name, w, i)
            else:
                lp[name] = w.to(self.dtype)
        subs = expert_subs(m)
        if subs:
            lp["experts"] = {sub: self.expert_stack(sd, m, sub)
                             for sub in subs}
        return lp

    def expert_stack(self, sd, m, sub: str):
        """One expert projection of a layer as its ``[E, ...]`` stack, read
        and converted one expert at a time: a GPTQ/AWQ expert passes
        through, a quantized name resolves without its layer, the rest is
        cast; never padded."""
        ws = []
        for e in range(self.cfg.n_experts):
            w = self.get(sd, *m[f"experts.{e}.{sub}"])
            if not isinstance(w, QTensor):
                w = self.quantized(sub, w) if sub in self.qnames \
                    else w.to(self.dtype)
            ws.append(w)
        if isinstance(ws[0], QTensor):
            return stack_qtensors(ws)
        return torch.stack(ws)

    def top(self, sd) -> Dict[str, Any]:
        params: Dict[str, Any] = {}
        for name, (hf_name, tr) in self.mod.hf_top_map(self.cfg).items():
            w = self.get(sd, hf_name, tr)
            if isinstance(w, QTensor):
                params[name] = w
            elif name == "lm_head" and name in self.qnames:
                params[name] = self.quantized(name, w)
            elif name in ("embed", "pos_embed"):
                params[name] = w.to(self.dtype)
            else:
                params[name] = w.to(self.dtype if w.ndim > 1
                                    else torch.float32)
        _add_aux(params, self.cfg, self.dev)
        return params

    def flags(self, layers):
        _add_flags(layers, self.cfg, self.mod, self.dev)


def _uniform(qcfg, qnames, n_layers: int) -> bool:
    """Whether every quantized name resolves to one config in every layer:
    a QuantRegistry's rules may differ by layer, one config cannot."""
    from .quant_registry import QuantRegistry
    if not isinstance(qcfg, QuantRegistry):
        return True
    return all(len({qcfg.resolve(n, i) for i in range(n_layers)}) == 1
               for n in qnames)


def build_param_dict(sd: Dict[str, Any], cfg: ModelConfig, mod=llama,
                     quant: Union[str, QuantConfig, None] = None,
                     dtype: torch.dtype = torch.bfloat16,
                     device=None) -> Dict[str, Any]:
    """The param dict (``layers`` a list of per-layer dicts) of an HF-named
    state dict of f32 tensors or numpy arrays, with the QTensors of a
    GPTQ/AWQ import passing through (moved to ``device``, in the [K, N]
    orientation whatever the map's transpose flag says). Weights are moved
    to ``device`` before they are quantized, one at a time; the result is
    not yet at rest."""
    conv = _Converter(cfg, mod, quant, dtype, device)
    if hasattr(mod, "preprocess_state_dict"):
        sd = mod.preprocess_state_dict(dict(sd), cfg)
    layers = [conv.layer(sd, i) for i in range(cfg.n_layers)]
    conv.flags(layers)
    return {"layers": layers, **conv.top(sd)}


def build_params(sd: Dict[str, Any], cfg: ModelConfig, mod=llama,
                 quant: Union[str, QuantConfig, None] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 device=None) -> Transformer:
    """Assemble the decoder from an HF-named state dict
    (:func:`build_param_dict`), its weights converted to the at-rest
    layouts."""
    return Transformer(cfg, params_to_native(build_param_dict(
        sd, cfg, mod, quant, dtype, device)))


def from_hf_model(model, quant: Union[str, QuantConfig, None] = None,
                  dtype: torch.dtype = torch.bfloat16, device=None):
    """A transformers ``*ForCausalLM`` (only its ``config`` attributes and
    ``state_dict()`` are read) → (Transformer, ModelConfig)."""
    mod = family(model.config.model_type)
    cfg = mod.config_from_hf(model.config)
    sd = {k: v.detach().to(torch.float32)
          for k, v in model.state_dict().items()}
    return build_params(sd, cfg, mod, quant, dtype, device), cfg


@torch.inference_mode()
def init_random(cfg: ModelConfig, seed: int = 0,
                quant: Union[str, QuantConfig, None] = None,
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
    bias; a parallel-residual family without ``ffn_norm_w`` (GPT-J, Phi-2,
    Falcon-7B) shares its one norm; qk-norm weights are ones; the learned
    position table (``max_seq_len + pos_offset`` rows) and the lm_head
    bias are drawn like the weights, last, so the draws before them are
    the same as before they existed. A mixture-of-experts layer draws its
    router like a bias, then each expert's gate, up and down weights, one
    ``[K, N]`` f32 weight at a time, quantized by the config its name
    resolves to without a layer, after everything else of the layer: a
    dense config draws what it drew before. (The JAX package's
    ``init_random``
    builds the whole f32 state dict on the host instead, with norm weights
    and biases of ones; the two draw different numbers.)"""
    dev = resolve_device(device)
    mod = ARCH_MODULES.get(cfg.arch, llama)
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

    m0 = mod.hf_layer_map(0, cfg)
    names = [n for n in m0 if not n.startswith("experts.")]
    subs = expert_subs(m0)
    if subs and not _uniform(qcfg, set(names) & set(mod.QUANT_TENSORS),
                             cfg.n_layers):
        raise NotImplementedError(MOE_HETERO)
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
        if cfg.qk_norm:
            for n in ("q_norm_w", "k_norm_w"):
                lp[n] = torch.ones(cfg.head_dim, dtype=dtype, device=dev)
        if subs:
            I_ = cfg.intermediate_size
            stack = lambda ws: stack_qtensors(ws) \
                if isinstance(ws[0], QTensor) else torch.stack(ws)
            lp["experts"] = {
                sub: stack([weight(sub, *_shape_for(sub, cfg, I_))
                            for _ in range(cfg.n_experts)])
                for sub in subs}
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
    if cfg.learned_pos_emb:
        params["pos_embed"] = normal((cfg.max_seq_len + cfg.pos_offset,
                                      D)).to(dtype)
    if "lm_head_b" in top:
        params["lm_head_b"] = normal((cfg.vocab_size,))
    _add_aux(params, cfg, dev)
    return Transformer(cfg, params)


def _jax_shape_for(name: str, cfg: ModelConfig):
    """The JAX ``init_random``'s shape table (unpadded FFN)."""
    D, I_ = cfg.hidden_size, cfg.intermediate_size
    if name in ("attn_norm_w", "ffn_norm_w", "post_attn_norm_w",
                "attn_norm_b", "ffn_norm_b", "post_ffn_norm_w",
                "post_ffn_norm_b"):
        return (D,)
    return _shape_for(name, cfg, I_)


def init_random_numpy(cfg: ModelConfig, seed: int = 0) -> Dict[str, Any]:
    """The JAX package's ``init_random`` (``neural_tpu/convert/hf.py``) up
    to its conversion: the HF-named f32 state dict it draws, by its rule —
    one ``numpy.random.default_rng(seed)``, N(0, 0.02²) weights layer by
    layer in the family's HF map order, ones for norm weights and biases,
    then the embedding, the lm_head, the learned positions, zeros for the
    lm_head bias and ones for the other top-level tensors. Through
    :func:`build_params` it gives the two packages the same weights from
    one seed (the port's own :func:`init_random` draws on the device with a
    ``torch.Generator`` instead). Made on the host in f32: for small
    models (the accuracy gate's)."""
    mod = ARCH_MODULES.get(cfg.arch, llama)
    rng = np.random.default_rng(seed)
    D, V = cfg.hidden_size, cfg.vocab_size

    def r(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    sd: Dict[str, Any] = {}
    for i in range(cfg.n_layers):
        for ours, (hf, tr) in mod.hf_layer_map(i, cfg).items():
            shape = _jax_shape_for(ours.split(".")[-1], cfg)
            w = r(*shape) if len(shape) > 1 else np.ones(shape, np.float32)
            sd[hf] = w.T if tr else w
    for ours, (hf, tr) in mod.hf_top_map(cfg).items():
        if ours == "embed":
            sd[hf] = r(V, D)
        elif ours == "lm_head":
            sd[hf] = r(D, V).T if tr else r(D, V)
        elif ours == "pos_embed":
            sd[hf] = r(cfg.max_seq_len + cfg.pos_offset, D)
        elif ours == "lm_head_b":
            sd[hf] = np.zeros(V, np.float32)
        else:
            sd[hf] = np.ones(D, np.float32)
    return sd

