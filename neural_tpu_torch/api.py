"""Top-level Model API (port of the single-row, greedy part of
``neural_tpu/api.py`` and of its GPTQ/AWQ ``Model.init``; its
``quant_config_from_args`` lives in :mod:`neural_tpu_torch.core.dtypes`)."""
from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from .core.dtypes import QuantConfig, quant_config_from_args
from .models.config import ModelConfig
from .models.transformer import Transformer
from .runtime.sampling import SamplingParams


def _to_id_list(x) -> List[List[int]]:
    """list[int], list[list[int]], numpy or torch ids → list of rows."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    if isinstance(x, (list, tuple)) and x and \
            isinstance(x[0], (list, tuple, np.ndarray)):
        return [list(map(int, row)) for row in x]
    a = np.asarray(x)
    if a.ndim == 1:
        a = a[None]
    return [list(map(int, row)) for row in a]


class Model:
    """One object that holds a quantized decoder and generates with it."""

    def __init__(self):
        self.params: Optional[Transformer] = None
        self.cfg: Optional[ModelConfig] = None
        self.tokenizer = None     # no tokenizer is ported yet

    def init(self, model_name_or_path: str,
             weight_dtype: Union[str, QuantConfig, None] = "q4_0",
             use_quant: bool = True, use_gptq: bool = False,
             use_awq: bool = False, use_autoround: bool = False,
             alg: str = "sym", group_size: int = 32,
             scale_dtype: str = "fp32", compute_dtype: str = "int8",
             use_ggml: bool = False, model_hub: str = "huggingface",
             dtype: str = "bfloat16", trust_remote_code: bool = False,
             device=None):
        """Load a local HF checkpoint directory, as the JAX ``Model.init``
        does. The GPTQ/AWQ branch (``use_gptq``, ``use_awq``, and
        ``use_autoround``, which exports the GPTQ format) reads
        ``config.json``, the bits and group size of ``quantization_config``
        or ``quantize_config.json``, and every ``*.safetensors`` file, with
        the port's own readers (``convert.files``), and converts the
        checkpoint on ``device`` (the card unless ``device="cpu"``). The
        other branch, the streamed conversion of an fp checkpoint, is not
        ported yet and raises. ``tokenizer`` stays None: no tokenizer is
        ported yet."""
        if model_hub != "huggingface":
            raise ValueError(f"model_hub {model_hub!r} is not available "
                             "offline; use a local huggingface-format "
                             "directory")
        if dtype != "bfloat16":
            raise NotImplementedError("only bf16 activations are ported")
        if not (use_gptq or use_awq or use_autoround):
            raise NotImplementedError(
                "Model.init of an fp checkpoint (the JAX package's streamed "
                "conversion, convert/stream.py, or AutoModelForCausalLM) is "
                "not ported yet; use init_from_hf_model with a model object, "
                "or use_gptq / use_awq for a quantized checkpoint")
        from .convert import files
        from .convert.gptq import params_from_gptq_state_dict
        from .convert.hf import ARCH_MODULES
        hf_cfg = files.read_config(model_name_or_path)
        mod = ARCH_MODULES.get(hf_cfg.model_type)
        if mod is None:
            raise NotImplementedError(
                f"model type {hf_cfg.model_type!r}: the port has "
                f"{sorted(ARCH_MODULES)}")
        self.cfg = mod.config_from_hf(hf_cfg)
        bits, gsize = files.quantize_config(model_name_or_path, hf_cfg)
        sd = files.read_safetensors_dir(model_name_or_path)
        self.params = params_from_gptq_state_dict(
            sd, self.cfg, fmt="awq" if use_awq else "gptq", bits=bits,
            dtype=torch.bfloat16, group_size=gsize, arch_mod=mod,
            device=device)
        return self

    def init_from_hf_model(self, model,
                           weight_dtype: Union[str, QuantConfig, None] = "q4_0",
                           dtype: str = "bfloat16", device=None,
                           alg: str = "sym", group_size: int = 32,
                           scale_dtype: str = "fp32",
                           compute_dtype: str = "int8",
                           use_ggml: bool = False):
        """In-memory HF torch model (Llama, Mistral, Gemma, Gemma-2, Bloom,
        MPT; ChatGLM-1 through a model object with its config and state
        dict) → ready Model. ``weight_dtype`` and the reference-style knobs are
        those of the JAX ``Model.init`` (:func:`quant_config_from_args`);
        None keeps bf16 projections.
        Weights are quantized on ``device`` (the card unless
        ``device="cpu"``)."""
        from .convert.hf import from_hf_model
        if dtype != "bfloat16":
            raise NotImplementedError("only bf16 activations are ported")
        qcfg = quant_config_from_args(weight_dtype, alg, group_size,
                                      scale_dtype, compute_dtype, use_ggml)
        self.params, self.cfg = from_hf_model(model, qcfg, torch.bfloat16,
                                              device)
        return self

    def init_params(self, params: Transformer, cfg: ModelConfig):
        """Use an already-built decoder (``convert.hf.init_random``,
        ``convert.from_jax.params_from_numpy``)."""
        self.params, self.cfg = params, cfg
        return self

    def generate(self, input_ids, max_new_tokens: int = 128,
                 do_sample: bool = False, temperature: float = 0.8,
                 top_k: int = 40, top_p: float = 0.95,
                 repetition_penalty: float = 1.1, num_beams: int = 1,
                 seed: int = 0, stop_at_eos: bool = True,
                 max_len: Optional[int] = None, ignore_prompt: bool = False,
                 kv_dtype: str = "bf16", **unported) -> List[List[int]]:
        """Greedy generation of one prompt: full id lists (prompt + new
        tokens), or new tokens only with ``ignore_prompt``. The repetition
        penalty applies before the argmax, as in the reference.
        ``kv_dtype``: "bf16" or "int8" KV cache (reference memory_dtype).

        Sampling, beam search, batches of prompts, streaming, sessions and
        meshes are later slices and raise."""
        if self.params is None:
            raise RuntimeError("call init_from_hf_model or init_params first")
        rows = _to_id_list(input_ids)
        asked = [k for k, v in unported.items() if v]
        if do_sample:
            asked.append("do_sample")
        if num_beams != 1:
            asked.append("num_beams")
        if len(rows) != 1:
            asked.append("a batch of prompts")
        if kv_dtype not in ("bf16", "int8", torch.bfloat16, torch.int8):
            raise ValueError(f"kv_dtype must be 'bf16' or 'int8', got "
                             f"{kv_dtype!r}")
        if asked:
            raise NotImplementedError(
                f"generate({', '.join(asked)}) is not ported yet: this slice "
                "runs single-prompt greedy generation")
        if self.cfg.arch in ("llama", "mistral", "mixtral") \
                and self.cfg.vocab_size == 128256:
            # Llama-3: make the prompt start with <|begin_of_text|>
            bos = self.cfg.bos_token_id
            rows = [r if (r and r[0] == bos) else [bos] + list(r)
                    for r in rows]
        from .runtime.generate import generate
        sp = SamplingParams(greedy=True, temperature=temperature, top_k=top_k,
                            top_p=top_p, repeat_penalty=repetition_penalty)
        kvdt = torch.int8 if kv_dtype in ("int8", torch.int8) else \
            torch.bfloat16
        out = generate(self.params, self.cfg, rows[0], sp, max_new_tokens,
                       max_len, stop_at_eos, kvdt)
        return [out[len(rows[0]):] if ignore_prompt else out]
