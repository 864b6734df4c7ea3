"""Top-level Model API (port of the single-row, greedy part of
``neural_tpu/api.py``)."""
from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from .core.dtypes import QuantConfig
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

    def init_from_hf_model(self, model,
                           weight_dtype: Union[str, QuantConfig, None] = "q4_0",
                           dtype: str = "bfloat16", device=None):
        """In-memory HF torch model → ready Model. Weights are quantized on
        ``device`` (the card unless ``device="cpu"``)."""
        from .convert.hf import from_hf_model
        if dtype != "bfloat16":
            raise NotImplementedError("only bf16 activations are ported")
        self.params, self.cfg = from_hf_model(model, weight_dtype,
                                              torch.bfloat16, device)
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

        Sampling, beam search, batches of prompts, int8 KV, streaming,
        sessions and meshes are later slices and raise."""
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
        if kv_dtype != "bf16":
            asked.append(f"kv_dtype={kv_dtype}")
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
        out = generate(self.params, self.cfg, rows[0], sp, max_new_tokens,
                       max_len, stop_at_eos)
        return [out[len(rows[0]):] if ignore_prompt else out]
