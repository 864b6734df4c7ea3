"""LoRA adapters merged at load (port of ``neural_tpu/convert/lora.py``):
``W += scale · B @ A`` on the f32 state dict, before quantization, as the
reference requires an fp base.

Adapter names follow PEFT: ``...<module>.lora_A.weight`` [r, in] and
``...<module>.lora_B.weight`` [out, r]; scale = alpha / r.
"""
from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch

_LORA_RE = re.compile(r"^(?:base_model\.model\.)?(.*)\.lora_A(?:\.default)?"
                      r"\.weight$")


def merge_lora(sd: Dict[str, np.ndarray], lora_sd: Dict[str, np.ndarray],
               alpha: Optional[float] = None) -> Dict[str, np.ndarray]:
    """A copy of ``sd`` (numpy or torch values) with every matching LoRA
    pair merged into its base weight, as f32 numpy."""
    sd = dict(sd)
    merged = 0
    for k in list(lora_sd):
        m = _LORA_RE.match(k)
        if not m:
            continue
        A = np.asarray(lora_sd[k], np.float32)                   # [r, in]
        B = np.asarray(lora_sd[k.replace("lora_A", "lora_B")],
                       np.float32)                               # [out, r]
        r = A.shape[0]
        scale = (alpha if alpha is not None else float(r)) / r
        target = m.group(1) + ".weight"
        if target not in sd:
            raise KeyError(f"LoRA targets missing base tensor {target}")
        sd[target] = (np.asarray(sd[target], np.float32)
                      + scale * (B @ A)).astype(np.float32)
        merged += 1
    if merged == 0:
        raise ValueError("no LoRA tensors matched")
    return sd


def from_hf_model_with_lora(model, lora_sd: Dict[str, np.ndarray],
                            alpha: Optional[float] = None, quant="q4_j",
                            dtype: torch.dtype = torch.bfloat16,
                            device=None):
    """A transformers ``*ForCausalLM`` (its ``config`` and ``state_dict()``)
    and a PEFT adapter state dict → the merged (Transformer, ModelConfig),
    quantized with ``quant`` on ``device``."""
    from .hf import build_params, family
    mod = family(model.config.model_type)
    cfg = mod.config_from_hf(model.config)
    sd = {k: v.detach().float().numpy()
          for k, v in model.state_dict().items()}
    sd = merge_lora(sd, lora_sd, alpha)
    return build_params(sd, cfg, mod, quant, dtype, device), cfg
