"""Top-level Model API (port of ``neural_tpu/api.py``): ``Model.init`` of a
local HF directory (the streamed conversion of an fp checkpoint, or a
GPTQ/AWQ one), ``init_from_bin`` (GGUF, with its embedded tokenizer, or
the native ``.ntpu`` file), ``save``, ``quant_model``, ``generate`` with
sampling, beam search, batches of prompts, StreamingLLM, the host-stepped
hooks and session files, ``generate_text``, ``__call__``, and Whisper's
``init_whisper`` and ``transcribe_file``. Its
``quant_config_from_args`` lives in :mod:`neural_tpu_torch.core.dtypes`.

Deliberate differences from the JAX package: an HF directory gets no
tokenizer (the JAX package asks transformers for one), and a directory
without ``*.safetensors`` files, or of a model type the port does not
have, raises instead of falling back to transformers'
``AutoModelForCausalLM``; a session file carries the port's
``torch.Generator`` state, not the JAX key."""
from __future__ import annotations

import glob
import os
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


def param_dtype(dtype) -> torch.dtype:
    """The parameters' dtype at rest for a loader's ``dtype``, the JAX
    package's rule (``neural_tpu/api.py``): bf16 for ``"bfloat16"``, f32
    for anything else — the embedding, the norm weights, the dense weights
    and the biases; the activations stay bf16 either way (the graph casts
    the residual stream to bf16, a dense weight is rounded to x's dtype at
    its product)."""
    return torch.bfloat16 if dtype == "bfloat16" else torch.float32


class Model:
    """One object that holds a quantized decoder and generates with it."""

    def __init__(self):
        self.params: Optional[Transformer] = None
        self.cfg: Optional[ModelConfig] = None
        self.tokenizer = None     # a GGUF file's vocab brings one
        self._session = None      # interactive: (cache, position, max_len)
        self._token_end = True
        self._whisper = False     # params and cfg are Whisper's

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
        does, converting it on ``device`` (the card unless
        ``device="cpu"``). ``config.json`` is read by the port itself
        (``convert.files``). An fp checkpoint goes through the streamed
        conversion (``convert.stream.params_from_hf_dir``: a layer at a
        time, each tensor quantized on the device as it arrives) to
        ``weight_dtype`` — a preset, a QuantConfig or registry, or a
        reference-style name with ``alg``/``group_size``/``scale_dtype``/
        ``compute_dtype``/``use_ggml`` (:func:`quant_config_from_args`);
        ``use_quant=False`` keeps bf16 projections (f32 with
        ``dtype="float32"``: :func:`param_dtype`). The GPTQ/AWQ branch
        (``use_gptq``, ``use_awq``, and ``use_autoround``, which exports
        the GPTQ format) reads the bits and group size of
        ``quantization_config`` or ``quantize_config.json`` and every
        ``*.safetensors`` file. The directory needs ``*.safetensors`` files
        and a model type the port has; otherwise this raises (the JAX
        package falls back to transformers). ``tokenizer`` stays None."""
        if model_hub != "huggingface":
            raise ValueError(f"model_hub {model_hub!r} is not available "
                             "offline; use a local huggingface-format "
                             "directory")
        from .convert import files
        from .convert.hf import family
        hf_cfg = files.read_config(model_name_or_path)
        mod = family(hf_cfg.model_type)
        if not glob.glob(os.path.join(model_name_or_path, "*.safetensors")):
            raise NotImplementedError(
                f"{model_name_or_path} holds no *.safetensors file; the port "
                "reads safetensors checkpoints only (the JAX package's "
                "AutoModelForCausalLM fallback needs transformers)")
        self.cfg = mod.config_from_hf(hf_cfg)
        self.tokenizer = None
        if use_gptq or use_awq or use_autoround:
            from .convert.gptq import params_from_gptq_state_dict
            bits, gsize = files.quantize_config(model_name_or_path, hf_cfg)
            sd = files.read_safetensors_dir(model_name_or_path)
            self.params = params_from_gptq_state_dict(
                sd, self.cfg, fmt="awq" if use_awq else "gptq", bits=bits,
                dtype=param_dtype(dtype), group_size=gsize, arch_mod=mod,
                device=device)
            return self
        from .convert.stream import params_from_hf_dir
        qcfg = quant_config_from_args(weight_dtype, alg, group_size,
                                      scale_dtype, compute_dtype, use_ggml) \
            if use_quant else None
        self.params, self.cfg = params_from_hf_dir(
            model_name_or_path, qcfg, param_dtype(dtype), cfg=self.cfg,
            arch_mod=mod, device=device)
        return self

    def init_from_hf_model(self, model,
                           weight_dtype: Union[str, QuantConfig, None] = "q4_0",
                           dtype: str = "bfloat16", device=None,
                           alg: str = "sym", group_size: int = 32,
                           scale_dtype: str = "fp32",
                           compute_dtype: str = "int8",
                           use_ggml: bool = False):
        """In-memory HF torch model (any family of
        ``convert.hf.ARCH_MODULES``; the remote-code ones, Qwen v1,
        Baichuan and ChatGLM, through a model object with their config and
        state dict) → ready Model. ``weight_dtype`` and the reference-style
        knobs are those of the JAX ``Model.init`` (:func:`quant_config_from_args`);
        None keeps bf16 projections. ``dtype`` sets the parameters' dtype at
        rest by :func:`param_dtype`.
        Weights are quantized on ``device`` (the card unless
        ``device="cpu"``)."""
        from .convert.hf import from_hf_model
        qcfg = quant_config_from_args(weight_dtype, alg, group_size,
                                      scale_dtype, compute_dtype, use_ggml)
        self.params, self.cfg = from_hf_model(model, qcfg,
                                              param_dtype(dtype), device)
        return self

    def init_params(self, params: Transformer, cfg: ModelConfig):
        """Use an already-built decoder (``convert.hf.init_random``,
        ``convert.from_jax.params_from_numpy``)."""
        self.params, self.cfg = params, cfg
        return self

    def init_from_bin(self, path: str, device=None):
        """Load a GGUF file (its block bytes unpacked on ``device``,
        ``convert.gguf_models.load_gguf``; the tokenizer its vocab
        declares, when it has one) or a native ``.ntpu`` checkpoint, the
        port's or the JAX package's (``convert.checkpoint``), onto
        ``device`` (the card unless ``device="cpu"``)."""
        with open(path, "rb") as f:
            magic = f.read(4)
        if magic == b"GGUF":
            from .convert.gguf import GGUFReader
            from .convert.gguf_models import load_gguf
            from .tokenizer import tokenizer_from_gguf
            self.params, self.cfg = load_gguf(path, device=device)
            r = GGUFReader(path)
            self.tokenizer = tokenizer_from_gguf(r) \
                if "tokenizer.ggml.tokens" in r.kv else None
            r.close()
        elif magic == b"NTPU":
            from .convert.checkpoint import load_checkpoint, params_from_tree
            tree, cfg, _ = load_checkpoint(path, device)
            if cfg is None:
                raise ValueError(f"{path} holds no model config (a session "
                                 "file?)")
            self.params, self.cfg = params_from_tree(tree, cfg), cfg
        else:
            raise ValueError(f"unknown checkpoint magic {magic!r}")
        return self

    def save(self, path: str):
        """Write the model, at rest as it is, to a native ``.ntpu`` file
        that either package loads."""
        from .convert.checkpoint import save_checkpoint
        save_checkpoint(path, self.params.param_dict(), self.cfg)

    @staticmethod
    def quant_model(model_path: str, out_path: str,
                    weight_dtype="int4", alg="sym", group_size=32,
                    scale_dtype="fp32", compute_dtype="int8",
                    use_ggml=False, device=None):
        """File → file quantization (reference Model.quant_model →
        quant_utils.cpp:269 bestla_quantize) on ``device`` (the card unless
        ``device="cpu"``). Input: a GGUF file, an NTPU checkpoint, or an HF
        directory (converted at ``weight_dtype``); a file's QTensors are
        dequantized, as loaded, and quantized again
        (``convert.hf.requantize``). Output: an NTPU checkpoint, at rest.
        GGUF output raises: use ``convert.gguf_models.export_gguf``."""
        from .convert.checkpoint import save_checkpoint
        from .convert.hf import requantize
        from .runtime.generate import params_to_native
        if out_path.endswith(".gguf"):
            raise ValueError("GGUF output: use convert.gguf_models."
                             "export_gguf on the HF model instead")
        qcfg = quant_config_from_args(weight_dtype, alg, group_size,
                                      scale_dtype, compute_dtype, use_ggml)
        if os.path.isdir(model_path):
            m = Model().init(model_path, weight_dtype=qcfg, device=device)
            save_checkpoint(out_path, m.params.param_dict(), m.cfg)
            return out_path
        with open(model_path, "rb") as f:
            magic = f.read(4)
        if magic == b"GGUF":
            from .convert.gguf_models import load_gguf_params
            params, cfg = load_gguf_params(model_path, device=device,
                                           at_rest=False)
        elif magic == b"NTPU":
            from .convert.checkpoint import load_checkpoint, param_tree
            tree, cfg, _ = load_checkpoint(model_path, device)
            params = param_tree(tree)
        else:
            raise ValueError(f"unknown checkpoint magic {magic!r}")
        save_checkpoint(out_path, params_to_native(requantize(params, qcfg)),
                        cfg)
        return out_path

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
        - ``kv_dtype``: "int8" (or ``torch.int8``) for an int8 KV cache,
          any other value bf16, as in the JAX package (an f32 cache is the
          server's: ``ModelServer(kv_dtype="float32")``).
        - ``session_file`` (one prompt, no beams): a prompt-keyed KV
          snapshot on disk (reference CLI --session, main_run.cpp:614):
          when the file's saved prompt is a prefix of this one and its
          cache has this call's geometry, the matched prefix is not
          evaluated again; an exact match restores the saved logits,
          generator state and mirostat ``mu``, so the run is the first
          one's, sampled or not, with no evaluation at all. After the
          prefill the state is saved back.

        - ``mesh`` (``parallel.make_mesh`` / ``auto_mesh``; every rank of
          the process group calls ``generate`` with the same prompts):
          tensor/data-parallel generation, one sharded padded prefill and
          one sharded decode loop (``parallel.tp.tp_generate``). The rank's
          shards are made once and kept on the Model for repeat calls.
          Beams, ``streamer``, ``stopping_criteria``, ``interactive``,
          ``session_file`` and ``streaming`` are refused under a mesh, as in
          the JAX package.

        ``NEURAL_TPU_VERBOSE=1`` prints the decode phase's wall time, ``=2``
        also traces the call and prints its top device ops
        (``utils.profiling``), as the JAX package does."""
        if self.params is None:
            raise RuntimeError("call init_from_hf_model or init_params first")
        from .utils.profiling import Timings, maybe_trace
        timings = Timings()
        kvdt = torch.int8 if kv_dtype in ("int8", torch.int8) else \
            torch.bfloat16
        rows = _to_id_list(input_ids)
        if self.cfg.arch in ("llama", "mistral", "mixtral") \
                and self.cfg.vocab_size == 128256:
            # Llama-3: make the prompt start with <|begin_of_text|>
            bos = self.cfg.bos_token_id
            rows = [r if (r and r[0] == bos) else [bos] + list(r)
                    for r in rows]
        if mesh is not None:
            if num_beams != 1:
                raise ValueError("beam search not supported under mesh")
            unsupported = {
                "streamer": streamer, "stopping_criteria": stopping_criteria,
                "interactive": interactive or None,
                "session_file": session_file,
                "streaming": streaming or None,
            }
            bad = [k for k, v in unsupported.items() if v]
            if bad:
                raise ValueError(
                    f"generate(mesh=...) does not support {bad}; run these "
                    "on the single-device path (drop mesh=)")
            return self._generate_mesh(
                mesh, rows, do_sample, temperature, top_k, top_p,
                repetition_penalty, max_new_tokens, max_len, seed,
                stop_at_eos, kvdt, ignore_prompt)
        hooked = (streamer is not None or stopping_criteria is not None
                  or interactive or session_file is not None)
        if session_file is not None and (len(rows) != 1 or num_beams != 1):
            raise ValueError("session_file takes one prompt, without beam "
                             "search")
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
            with maybe_trace("generate"), \
                    timings.phase("decode", tokens=max_new_tokens * len(rows)):
                outs = batched_generate(self.params, self.cfg, rows, sp,
                                        max_new_tokens, max_len, seed,
                                        stop_at_eos, kv_dtype=kvdt)
            timings.print_if_verbose()
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
                    kvdt, session_file))
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
                with maybe_trace("generate"), \
                        timings.phase("decode", tokens=max_new_tokens):
                    out = generate(self.params, self.cfg, ids, sp,
                                   max_new_tokens, max_len, seed,
                                   stop_at_eos, kv_dtype=kvdt)
            outs.append(out[len(ids):] if ignore_prompt else out)
        timings.print_if_verbose()
        return outs

    def _generate_mesh(self, mesh, rows, do_sample, temperature, top_k,
                       top_p, repetition_penalty, max_new_tokens, max_len,
                       seed, stop_at_eos, kv_dtype, ignore_prompt):
        """``generate(mesh=...)``: ``tp_generate`` over this rank's shards,
        made on the first call with this mesh and these params and kept."""
        from .parallel.sharding import shard_model
        from .parallel.tp import tp_generate
        sp = SamplingParams(greedy=not do_sample, temperature=temperature,
                            top_k=top_k, top_p=top_p,
                            repeat_penalty=repetition_penalty)
        # the mesh and params themselves are kept with the shards (an id
        # alone could be reused by new weights once the old are freed)
        held = getattr(self, "_mesh_shards", None)
        if held is None or held[0] is not mesh or held[1] is not self.params:
            held = self._mesh_shards = None   # the old shards freed first
            held = self._mesh_shards = (mesh, self.params, shard_model(
                self.params, self.cfg, mesh))
        outs = tp_generate(held[2], self.cfg, mesh, rows, sp,
                           max_new_tokens, max_len, seed, stop_at_eos,
                           kv_dtype=kv_dtype, sharded=True)
        if ignore_prompt:
            outs = [o[len(r):] for o, r in zip(outs, rows)]
        return outs

    def _generate_hooked(self, ids, sp, max_new_tokens, max_len, seed,
                         stop_at_eos, streamer, stopping_criteria,
                         interactive, ignore_prompt, kv_dtype,
                         session_file=None):
        """``runtime.generate.generate`` with per-token hooks; with
        ``interactive`` a KV session kept across calls (the reference's
        multi-round chat), with ``session_file`` one kept on disk
        (:meth:`_session_prefill`)."""
        from .runtime.generate import generate
        from .runtime.kvcache import init_cache
        first_round = self._session is None or not interactive
        cache, pos = None, 0
        if interactive and not first_round:
            cache, pos, S = self._session
        elif interactive or session_file is not None:
            S = max_len or self.cfg.max_seq_len
            cache = init_cache(self.cfg, 1, S, kv_dtype,
                               device=self.params.device)
        resumed = {}
        if session_file is not None and first_round:
            pos, resumed = self._session_prefill(session_file, ids, sp, seed,
                                                 cache, max_new_tokens)
        elif cache is not None and pos + len(ids) + max_new_tokens > S:
            raise ValueError(
                f"context overflow: {pos}+{len(ids)}+{max_new_tokens} > "
                f"{S}; raise max_len or use streaming=True (StreamingLLM)")
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
                        on_token=on_token, cache=cache, start=pos, **resumed)
        self._token_end = True
        if streamer is not None:
            streamer.end()
        if interactive:     # the last new id is not in the cache yet
            filled = pos if resumed else pos + len(ids)
            n_new = len(full) - len(ids)
            self._session = (cache, filled + max(n_new - 1, 0), S)
        return full if first_round and not ignore_prompt \
            else full[len(ids):]

    def _session_prefill(self, path, ids, sp, seed, cache, max_new_tokens):
        """The session-file half of a hooked generation (the JAX
        ``_generate_hooked``): reuse the file's cache when its saved prompt
        is a prefix of ``ids`` (copied into ``cache`` in place: its storage
        is what the caller holds), evaluate the rest at its offset, and
        save the state back; on an exact match with saved logits restore
        them, the generator state and ``mu`` instead, evaluating nothing.
        Returns the cache's fill (the prompt's length) and the keyword
        arguments that resume ``runtime.generate.generate`` there."""
        from .convert.checkpoint import load_session, save_session
        from .runtime.generate import _generator, prefill_step
        from .runtime.sampling import SamplerState
        dev = self.params.device
        S = cache.k.shape[3]
        pos, eval_ids = 0, list(ids)
        if os.path.exists(path):
            scache, slens, extra = load_session(path, dev)
            saved = list(extra.get("prompt_ids", []))
            n = int(slens[0])
            # reuse iff the saved prompt is a prefix of ours and the cache
            # geometry matches (reference: session token-prefix match,
            # main_run.cpp "session file matches %d / %d tokens")
            if (saved and saved == list(ids[:len(saved)]) and n == len(saved)
                    and scache.k.shape == cache.k.shape
                    and scache.k.dtype == cache.k.dtype):
                for dst, src in zip((cache.k, cache.v, cache.k_scale,
                                     cache.v_scale),
                                    (scache.k, scache.v, scache.k_scale,
                                     scache.v_scale)):
                    if dst is not None:
                        dst.copy_(src)
                pos, eval_ids = n, list(ids[n:])
                if not eval_ids and "logits" in extra:
                    # full-state resume (reference model_set_state_data,
                    # model_utils.cpp:1659): no evaluation at all
                    resumed = {"logits": extra["logits"][:, None, :]}
                    if "torch_generator" in extra:
                        gen = torch.Generator(device=dev)
                        try:
                            gen.set_state(extra["torch_generator"])
                            resumed["generator"] = gen
                        except RuntimeError:
                            pass    # another device's generator: reseed
                    if "sampler_mu" in extra:
                        resumed["state"] = SamplerState(
                            mu=extra["sampler_mu"])
                    return pos, resumed
                if not eval_ids:    # a file without logits
                    pos, eval_ids = pos - 1, [ids[-1]]
            del scache
        if pos + len(eval_ids) + max_new_tokens > S:
            raise ValueError(
                f"context overflow: {pos}+{len(eval_ids)}+{max_new_tokens}"
                f" > {S}; raise max_len or use streaming=True (StreamingLLM)")
        gen = _generator(dev, seed)
        state = SamplerState.init(1, sp, dev)
        logits = prefill_step(
            self.params, torch.tensor([eval_ids], dtype=torch.long,
                                      device=dev),
            torch.tensor([pos], dtype=torch.long, device=dev), cache)
        pos += len(eval_ids)
        save_session(path, cache, [pos], {"prompt_ids": list(ids)},
                     logits=logits[:, -1], generator_state=gen.get_state(),
                     sampler_mu=state.mu)
        return pos, {"logits": logits, "generator": gen, "state": state}

    def is_token_end(self) -> bool:
        """Whether the last generation reached its end (a stop id, the
        token budget or a stopping criterion)."""
        return self._token_end

    def reset_kv_cache(self):
        """Drop the interactive session."""
        self._session = None
        self._token_end = True

    def generate_text(self, prompt: str, **kw) -> str:
        """Encode ``prompt`` with the model's tokenizer, generate, decode
        the new ids."""
        if self.tokenizer is None:
            raise RuntimeError("no tokenizer loaded (a GGUF file with a "
                               "vocab brings one)")
        ids = self.tokenizer.encode(prompt)
        out = self.generate(ids, **kw)[0]
        return self.tokenizer.decode(out[len(ids):])

    def __call__(self, input_ids, pad_token: int = 0) -> np.ndarray:
        """Teacher-forced logits [B, T, V] f32 as numpy (reference
        Model.__call__, __init__.py:439). Ragged rows are right-padded with
        ``pad_token``; the logits at pad positions are computed on pad
        inputs and are to be ignored."""
        from .runtime.generate import batch_logits
        rows = _to_id_list(input_ids)
        T = max(len(r) for r in rows)
        padded = np.full((len(rows), T), pad_token, np.int64)
        for b, r in enumerate(rows):
            padded[b, :len(r)] = r
        return batch_logits(self.params, self.cfg, padded).cpu().numpy()

    # -- whisper ------------------------------------------------------------
    def init_whisper(self, model_name_or_path_or_model, weight_dtype=None,
                     device=None):
        """Load a Whisper checkpoint onto ``device`` (the card unless
        ``device="cpu"``): a local HF directory (``config.json`` and
        ``*.safetensors``, read without transformers; its
        ``tokenizer.json``, when there is one, becomes ``self.tokenizer``)
        or an in-memory model with ``.config`` and ``.state_dict()``.

        ``weight_dtype``: quantize the encoder/decoder linears ("int8",
        "q4_0", "q4_j", a QuantConfig, ...; reference quant_whisper.cpp /
        quant_utils.h:79 whisper_model_quantize), stored at rest; None
        keeps them f32. A path that is not a local directory raises (the
        JAX package falls back to transformers' ``from_pretrained``)."""
        from .models import whisper as wh
        self.tokenizer = None
        if isinstance(model_name_or_path_or_model, str):
            path = model_name_or_path_or_model
            if not os.path.isdir(path):
                raise NotImplementedError(
                    f"{path} is not a local directory; the port reads local "
                    "Whisper checkpoint directories (config.json and "
                    "*.safetensors) only, and fetches nothing")
            self.params, self.cfg = wh.params_from_dir(
                path, quant=weight_dtype, device=device)
            tok = os.path.join(path, "tokenizer.json")
            if os.path.exists(tok):
                from .tokenizer import BPETokenizer
                self.tokenizer = BPETokenizer.from_hf_json(tok)
        else:
            self.params, self.cfg = wh.params_from_hf(
                model_name_or_path_or_model, quant=weight_dtype,
                device=device)
        self._whisper = True
        return self

    def init_whisper_params(self, params, cfg):
        """Use already-built Whisper params (``models.whisper.init_random``,
        ``convert.from_jax.whisper_params_from_numpy``)."""
        self.params, self.cfg, self._whisper = params, cfg, True
        self.tokenizer = None
        return self

    def transcribe_file(self, wav_path: str, prompt_ids=None,
                        max_new_tokens: int = 224, timestamps: bool = False,
                        language=None, task: str = "transcribe",
                        num_beams: int = 1, length_penalty: float = 1.0,
                        token_timestamps: bool = False):
        """WAV file → token ids (reference: whisper CLI audio_run.cpp), as
        the JAX ``transcribe_file``.

        ``timestamps=True``: long-form mode, 30 s windows advanced by the
        last decoded timestamp; returns a list of (start_s, end_s,
        token_ids) segments (with ``token_timestamps=True`` each also has
        its per-token (t0, t1) times). Otherwise one flat id list for the
        first window.

        ``language``: a language code ("en", through the tokenizer of the
        checkpoint directory), a language token id, or "auto" (one-step
        detection over the language block). ``task``: "transcribe" or
        "translate". ``num_beams > 1``: beam decode."""
        from .models import whisper as wh
        from .utils.audio import load_audio_16k
        from .utils.profiling import Timings, maybe_trace
        if not self._whisper:
            raise RuntimeError("call init_whisper first")
        timings = Timings()
        audio = load_audio_16k(wav_path)
        mel = wh.log_mel_spectrogram(audio, self.cfg.n_mels)
        if prompt_ids is not None:
            prompt = list(prompt_ids)
        else:
            lang_tok = None
            if language == "auto":
                lang_tok, _ = wh.detect_language(self.params, self.cfg, mel)
            elif isinstance(language, (int, np.integer)):
                lang_tok = int(language)
            elif isinstance(language, str):
                if self.tokenizer is None:
                    raise ValueError("language codes need a tokenizer; pass "
                                     "a token id")
                lang_tok = self.tokenizer.convert_tokens_to_ids(
                    f"<|{language}|>")
            prompt = wh.build_forced_prompt(self.cfg, lang_tok, task,
                                            timestamps)
        with maybe_trace("transcribe"), \
                timings.phase("decode", tokens=max_new_tokens):
            if timestamps or token_timestamps:
                text_fn = None
                if self.tokenizer is not None:
                    text_fn = lambda i: self.tokenizer.decode([i])
                out = wh.transcribe_segments(
                    self.params, self.cfg, mel, prompt, max_new_tokens,
                    token_timestamps=token_timestamps,
                    audio=audio if token_timestamps else None,
                    token_text_fn=text_fn)
            elif num_beams > 1:
                out = wh.transcribe_ids_beam(self.params, self.cfg, mel,
                                             prompt, num_beams,
                                             max_new_tokens, length_penalty)
            else:
                out = wh.transcribe_ids(self.params, self.cfg, mel, prompt,
                                        max_new_tokens)
        timings.print_if_verbose()
        return out
