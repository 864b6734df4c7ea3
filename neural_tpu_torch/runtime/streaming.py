"""StreamingLLM: attention sinks and shift-RoPE infinite generation (port
of ``neural_tpu/runtime/streaming.py``).

When the cache is full, one compact-and-shift makes room:

- the first ``n_keep`` sink tokens stay;
- the next ``n_discard`` are dropped;
- the rest move down by ``n_discard`` slots, and their keys are rotated by
  ``-n_discard`` RoPE steps (rope(x, p)·R(-Δ) == rope(x, p - Δ)), in f32
  with the model's own inverse frequencies, so the cache is one built at
  the shifted positions; an int8 key is dequantized, rotated and
  quantized again (``quantize_kv``: the bf16-rounded scale, the ±127
  clip);
- values, and the value scales, move unchanged; the freed tail is zeroed.

The shift runs in place on the cache's own tensors, one layer at a time,
so a CUDA graph that holds the cache stays valid across it and the f32
copy of the moved keys is one layer's. An ALiBi model (``rope_style``
"none") moves its keys without rotating them.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..models.config import ModelConfig
from ..models.transformer import Transformer
from ..ops.attention import quantize_kv
from ..ops.rope import apply_rope
from .generate import _generator, _history, _SampledStep, prefill_step
from .kvcache import KVCache, init_cache
from .sampling import SamplerState, SamplingParams, sample


def shift_cache_impl(cache: KVCache, inv_freqs: Optional[torch.Tensor],
                     cfg: ModelConfig, n_keep: int,
                     n_discard: int) -> KVCache:
    """Compact a full cache in place: [sink | dropped | moved] → [sink |
    moved | 0], the moved keys rotated by -n_discard RoPE steps. Returns
    the same cache."""
    if cfg.rope_style not in ("neox", "gptj", "none"):
        raise ValueError(f"the shift rotates neox or gptj RoPE keys, not "
                         f"{cfg.rope_style!r}")
    S = cache.k.shape[3]
    m0 = n_keep + n_discard
    kept = slice(n_keep, S - n_discard)
    rotate = cfg.rope_style != "none"
    if rotate:
        ang = (-float(n_discard)) * inv_freqs.to(torch.float32)
        cos, sin = torch.cos(ang)[None, :], torch.sin(ang)[None, :]
    int8 = cache.k_scale is not None
    for l in range(cache.k.shape[0]):
        k, v = cache.k[l], cache.v[l]                    # [B, H, S, Dh]
        ks, vs = (cache.k_scale[l], cache.v_scale[l]) if int8 else (None,
                                                                    None)
        if rotate:
            mf = k[:, :, m0:].to(torch.float32)
            if int8:
                mf = mf * ks[:, :, m0:].to(torch.float32)[..., None]
            # [B, H, S', Dh] → [B, S', H, Dh], apply_rope's layout
            mf = apply_rope(mf.transpose(1, 2), cos, sin, cfg.rope_style,
                            cfg.rope_dim).transpose(1, 2)
            if int8:
                mq, msc = quantize_kv(mf)
                k[:, :, kept].copy_(mq)
                ks[:, :, kept].copy_(msc)
            else:
                k[:, :, kept].copy_(mf.to(k.dtype))
        else:
            k[:, :, kept].copy_(k[:, :, m0:].clone())
            if int8:
                ks[:, :, kept].copy_(ks[:, :, m0:].clone())
        v[:, :, kept].copy_(v[:, :, m0:].clone())
        if int8:
            vs[:, :, kept].copy_(vs[:, :, m0:].clone())
        for c in (k, v, ks, vs):
            if c is not None:
                c[:, :, S - n_discard:].zero_()
    return cache


@torch.inference_mode()
def shift_cache(cache: KVCache, inv_freqs: Optional[torch.Tensor],
                cfg: ModelConfig, n_keep: int, n_discard: int) -> KVCache:
    return shift_cache_impl(cache, inv_freqs, cfg, n_keep, n_discard)


@torch.inference_mode()
def stream_generate(model: Transformer, cfg: ModelConfig,
                    prompt_ids: Sequence[int], max_new_tokens: int,
                    max_len: int, n_keep: int = 4,
                    n_discard: Optional[int] = None,
                    sampling: Optional[SamplingParams] = None,
                    seed: int = 0, stop_at_eos: bool = False,
                    kv_dtype=torch.bfloat16) -> list:
    """Generation past a fixed ``max_len`` cache: the prompt prefills with
    last-row logits, each later token is one sampled step
    (:class:`~neural_tpu_torch.runtime.generate._SampledStep`, one CUDA
    graph replay on the card), and a full cache shifts before the step that
    would overflow it. ``n_discard`` defaults to half the non-sink window.
    Returns the full id list."""
    n_discard = n_discard or (max_len - n_keep) // 2
    if len(prompt_ids) >= max_len:
        raise ValueError("the prompt must fit in the cache")
    sampling = sampling or SamplingParams(greedy=True, repeat_penalty=1.0)
    dev = model.device
    cache = init_cache(cfg, 1, max_len, kv_dtype, device=dev)
    gen = _generator(dev, seed)
    out = list(prompt_ids)
    pos = len(prompt_ids)       # the position of the next write
    logits = prefill_step(model, torch.tensor([out], device=dev),
                          torch.zeros(1, dtype=torch.long, device=dev), cache)
    hist, valid = _history([out], sampling.repeat_last_n, dev)
    tok, state = sample(logits[:, -1], sampling,
                        SamplerState.init(1, sampling, dev),
                        prev_tokens=hist, prev_valid=valid, generator=gen)
    out.append(int(tok[0]))
    if max_new_tokens <= 1 or (stop_at_eos and out[-1] in cfg.eos_token_ids):
        return out
    hist, valid = _history([out], sampling.repeat_last_n, dev)
    st = _SampledStep(model, cache, sampling, tok[:, None].long(),
                      torch.tensor([pos], device=dev), hist, valid,
                      generator=gen, mu=state.mu)
    pending = []
    for i in range(1, max_new_tokens):
        if pos >= max_len:      # full: shift before this step's write
            shift_cache_impl(cache, model.rope_inv_freqs, cfg, n_keep,
                             n_discard)
            pos -= n_discard
            st.pos.sub_(n_discard)
        if dev.type == "cuda" and st.graph is None:
            st.capture()
        tok = st.step()
        pos += 1
        if stop_at_eos:
            out.append(int(tok[0]))
            if out[-1] in cfg.eos_token_ids:
                break
        else:
            pending.append(tok)
    if pending:
        out += torch.cat(pending).tolist()
    return out
