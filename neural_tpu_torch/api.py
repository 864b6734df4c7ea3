"""Top-level Model API (port of ``neural_tpu/api.py``: ``Model.generate``
with sampling, beam search, batches of prompts, StreamingLLM and the
host-stepped hooks, and the GPTQ/AWQ ``Model.init``; its
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
        self._session = None      # interactive: (cache, position, max_len)
        self._token_end = True

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
                 streaming: bool = False, max_len: Optional[int] = None,
                 streamer=None, interactive: bool = False,
                 ignore_prompt: bool = False, stopping_criteria=None,
                 session_file: Optional[str] = None, kv_dtype="bf16",
                 n_keep: int = 4, n_discard: Optional[int] = None,
                 mesh=None, **kw) -> List[List[int]]:
        """Generate from one prompt or a batch of prompts, as the JAX
        ``Model.generate``: full id lists (prompt + new tokens), one per row,
        or new tokens only with ``ignore_prompt`` (and on interactive
        continuation rounds).

        - ``do_sample``: temperature, top-k and top-p sampling from a
          generator seeded with ``seed``; otherwise greedy. Both apply the
          repetition penalty over the last 64 ids first.
        - A batch of prompts (without hooks, beams or streaming) goes
          through one padded prefill and one decode loop
          (``runtime.generate.batched_generate``).
        - ``num_beams > 1`` (greedy): beam search, the best hypothesis.
        - ``streaming``: StreamingLLM within a ``max_len`` cache (the
          config's context by default), ``n_keep`` sinks, ``n_discard``
          dropped at each shift.
        - ``streamer`` (``.put(ids)`` / ``.end()``, batch 1),
          ``stopping_criteria`` (``callable(ids_2d, scores) -> bool``, each
          token) and ``interactive`` (the KV cache kept across calls) take
          the host-stepped loop.
        - ``kv_dtype``: "bf16" or "int8" KV cache.

        ``session_file`` (KV snapshots on disk) waits for the checkpoint
        converters (ROADMAP A10) and ``mesh`` for parallelism (A12); both
        raise."""
        if self.params is None:
            raise RuntimeError("call init_from_hf_model or init_params first")
        if session_file is not None:
            raise NotImplementedError(
                "generate(session_file=...) needs convert/checkpoint.py, "
                "a later slice (ROADMAP A10)")
        if mesh is not None:
            raise NotImplementedError(
                "generate(mesh=...) is tensor/data parallelism, a later "
                "slice (ROADMAP A12)")
        if kv_dtype not in ("bf16", "int8", torch.bfloat16, torch.int8):
            raise ValueError(f"kv_dtype must be 'bf16' or 'int8', got "
                             f"{kv_dtype!r}")
        kvdt = torch.int8 if kv_dtype in ("int8", torch.int8) else \
            torch.bfloat16
        rows = _to_id_list(input_ids)
        if self.cfg.arch in ("llama", "mistral", "mixtral") \
                and self.cfg.vocab_size == 128256:
            # Llama-3: make the prompt start with <|begin_of_text|>
            bos = self.cfg.bos_token_id
            rows = [r if (r and r[0] == bos) else [bos] + list(r)
                    for r in rows]
        hooked = (streamer is not None or stopping_criteria is not None
                  or interactive)
        if not interactive:
            self._session = None
        if streamer is not None:
            if len(rows) != 1:
                raise ValueError("a streamer takes batch size 1")
            if num_beams != 1:
                raise ValueError("a streamer cannot be used with beam search")
        if stopping_criteria is not None and num_beams > 1 and not do_sample:
            raise ValueError(
                "stopping_criteria is not applied inside beam search; "
                "use num_beams=1 or post-filter the returned hypotheses")
        sp = SamplingParams(greedy=not do_sample, temperature=temperature,
                            top_k=top_k, top_p=top_p,
                            repeat_penalty=repetition_penalty)
        if len(rows) > 1 and num_beams == 1 and not hooked \
                and not streaming:
            from .runtime.generate import batched_generate
            outs = batched_generate(self.params, self.cfg, rows, sp,
                                    max_new_tokens, max_len, seed,
                                    stop_at_eos, kv_dtype=kvdt)
            return [o[len(r):] for o, r in zip(outs, rows)] \
                if ignore_prompt else outs
        outs = []
        for ids in rows:
            if num_beams > 1 and not do_sample:
                from .runtime.beam import beam_search
                hyp = beam_search(self.params, self.cfg, ids,
                                  beam_size=num_beams,
                                  max_new_tokens=max_new_tokens)[0]
                outs.append(hyp.ids[len(ids):] if ignore_prompt else hyp.ids)
                continue
            if hooked:
                outs.append(self._generate_hooked(
                    ids, sp, max_new_tokens, max_len, seed, stop_at_eos,
                    streamer, stopping_criteria, interactive, ignore_prompt,
                    kvdt))
                continue
            if streaming:
                from .runtime.streaming import stream_generate
                out = stream_generate(
                    self.params, self.cfg, ids, max_new_tokens,
                    max_len or self.cfg.max_seq_len, n_keep=n_keep,
                    n_discard=n_discard, sampling=sp, seed=seed,
                    stop_at_eos=stop_at_eos, kv_dtype=kvdt)
            else:
                from .runtime.generate import generate
                out = generate(self.params, self.cfg, ids, sp,
                               max_new_tokens, max_len, seed, stop_at_eos,
                               kv_dtype=kvdt)
            outs.append(out[len(ids):] if ignore_prompt else out)
        return outs

    def _generate_hooked(self, ids, sp, max_new_tokens, max_len, seed,
                         stop_at_eos, streamer, stopping_criteria,
                         interactive, ignore_prompt, kv_dtype):
        """``runtime.generate.generate`` with per-token hooks, and with
        ``interactive`` a KV session kept across calls (the reference's
        multi-round chat)."""
        from .runtime.generate import generate
        from .runtime.kvcache import init_cache
        first_round = self._session is None or not interactive
        cache, pos = None, 0
        if interactive:
            if first_round:
                S = max_len or self.cfg.max_seq_len
                cache = init_cache(self.cfg, 1, S, kv_dtype,
                                   device=self.params.device)
            else:
                cache, pos, S = self._session
            if pos + len(ids) + max_new_tokens > S:
                raise ValueError(
                    f"context overflow: {pos}+{len(ids)}+{max_new_tokens} > "
                    f"{S}; raise max_len or use streaming=True "
                    "(StreamingLLM)")
        if streamer is not None and first_round and not ignore_prompt:
            streamer.put(np.asarray([ids]))
        self._token_end = False

        def on_token(full, logits):
            if streamer is not None:
                streamer.put(np.asarray([[full[-1]]]))
            return stopping_criteria is not None and bool(stopping_criteria(
                np.asarray([full]), logits.cpu().numpy()))

        full = generate(self.params, self.cfg, ids, sp, max_new_tokens,
                        max_len, seed, stop_at_eos, kv_dtype,
                        on_token=on_token, cache=cache, start=pos)
        self._token_end = True
        if streamer is not None:
            streamer.end()
        if interactive:     # the last new id is not in the cache yet
            n_new = len(full) - len(ids)
            self._session = (cache, pos + len(ids) + max(n_new - 1, 0), S)
        return full if first_round and not ignore_prompt \
            else full[len(ids):]

    def is_token_end(self) -> bool:
        """Whether the last generation reached its end (a stop id, the
        token budget or a stopping criterion)."""
        return self._token_end

    def reset_kv_cache(self):
        """Drop the interactive session."""
        self._session = None
        self._token_end = True
