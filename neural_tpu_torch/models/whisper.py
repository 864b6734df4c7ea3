"""Whisper speech-to-text: encoder-decoder with cross-attention (port of
``neural_tpu/models/whisper.py``).

Structure (as OpenAI Whisper):
- frontend: log-mel spectrogram (80/128 mels, n_fft 400, hop 160), numpy on
  the host, the JAX package's arithmetic op for op;
- encoder: gelu(conv1 k3 s1) → gelu(conv2 k3 s2) → + positions → pre-LN
  blocks → final LN;
- decoder: token + learned-position embeddings → pre-LN blocks with causal
  self-attention over an f32 cache [L, B, S, D] and cross-attention over
  the encoder states (their K/V computed once an utterance) → final LN →
  logits against the tied embedding.

Activations are f32, as in the JAX package. Every linear goes through
``models.transformer.linear``: a QTensor through ``ops.qmatmul.qmatmul``
and its kernels (K2 at M >= 256 with int8 activations quantized from the
f32 rows, K1 for codes at rest at M <= 16, K5 otherwise; K1 and K5 round x
to bf16 first, every output f32), an unquantized weight through one f32
product. ``_mha`` is plain f32 torch (the JAX package's is XLA, not a
Pallas kernel), as are the conv stem and the tied logits. The f32
products and convolutions run inside :func:`f32_exact`, so that neither
TF32 switch of the caller (``torch.backends.cudnn.allow_tf32``, on by
default, and ``torch.backends.cuda.matmul.allow_tf32``) changes a result.

Params are a dict of tensors on one device: ``enc_layers`` and
``dec_layers`` are lists of per-layer dicts (the JAX package stacks them
along a leading L axis for ``lax.scan``); quantized linears are QTensors
at rest (``runtime.generate.params_to_native``), ``[K, N]``.

Deliberate differences from the JAX package: the decoder linears at
M <= 16 take K1 over native codes, where the JAX package's stored planes
go to K5; beam search keeps the cross K/V as one row that every beam
reads (its rows are identical copies; the JAX package broadcasts them to
W rows) and reorders only the self-attention cache; ties in the beam's
top-k take the lower index first by a stable descending sort, as
``jax.lax.top_k`` does.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..ops.norms import layer_norm
from .transformer import linear

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    vocab_size: int = 51865
    d_model: int = 384
    n_heads: int = 6
    enc_layers: int = 4
    dec_layers: int = 4
    n_mels: int = 80
    n_audio_ctx: int = 1500         # encoder positions (30 s / 2 / 10 ms)
    n_text_ctx: int = 448
    ffn_dim: int = 1536
    eos_token_id: int = 50257
    sot_token_id: int = 50258

    @property
    def head_dim(self):
        return self.d_model // self.n_heads


def config_from_hf(c) -> WhisperConfig:
    """An HF ``WhisperConfig`` (or ``convert.files.read_config``'s
    namespace of a ``config.json``) → :class:`WhisperConfig`."""
    return WhisperConfig(
        vocab_size=c.vocab_size, d_model=c.d_model,
        n_heads=c.encoder_attention_heads,
        enc_layers=c.encoder_layers, dec_layers=c.decoder_layers,
        n_mels=c.num_mel_bins, n_audio_ctx=c.max_source_positions,
        n_text_ctx=c.max_target_positions, ffn_dim=c.encoder_ffn_dim,
        eos_token_id=c.eos_token_id,
        sot_token_id=getattr(c, "decoder_start_token_id", 50258))


# ---------------------------------------------------------------------------
# audio frontend (reference: whisper.cpp log_mel_spectrogram)
# ---------------------------------------------------------------------------

SAMPLE_RATE, N_FFT, HOP = 16000, 400, 160


def mel_filterbank(n_mels: int = 80, n_fft: int = N_FFT,
                   sr: int = SAMPLE_RATE) -> np.ndarray:
    """Slaney-style mel filter matrix [n_mels, n_fft//2+1] (the librosa / HF
    WhisperFeatureExtractor one)."""
    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        mel = 3.0 * f / 200.0
        log_region = f >= 1000.0
        mel = np.where(log_region,
                       15.0 + np.log(np.maximum(f, 1e-9) / 1000.0)
                       / np.log(6.4) * 27.0, mel)
        return mel

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        f = 200.0 * m / 3.0
        log_region = m >= 15.0
        f = np.where(log_region, 1000.0 * np.exp(np.log(6.4) *
                                                 (m - 15.0) / 27.0), f)
        return f

    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2.0),
                                    n_mels + 2))
    fb = np.zeros((n_mels, n_fft // 2 + 1))
    for i in range(n_mels):
        lo, ce, hi = mel_pts[i], mel_pts[i + 1], mel_pts[i + 2]
        up = (fft_freqs - lo) / max(ce - lo, 1e-9)
        down = (hi - fft_freqs) / max(hi - ce, 1e-9)
        fb[i] = np.maximum(0, np.minimum(up, down))
        fb[i] *= 2.0 / (hi - lo)          # Slaney normalization
    return fb.astype(np.float32)


def log_mel_spectrogram(audio: np.ndarray, n_mels: int = 80,
                        pad_to: Optional[int] = 3000) -> np.ndarray:
    """f32 audio [n] at 16 kHz → log-mel [n_mels, frames] (the HF
    WhisperFeatureExtractor pipeline), on the host."""
    audio = np.asarray(audio, np.float32)
    if pad_to is not None:
        target = pad_to * HOP
        audio = audio[:target]
        audio = np.pad(audio, (0, max(0, target - len(audio))))
    window = np.hanning(N_FFT + 1)[:-1].astype(np.float32)
    pad = N_FFT // 2
    x = np.pad(audio, (pad, pad), mode="reflect")
    n_frames = 1 + (len(x) - N_FFT) // HOP
    frames = np.lib.stride_tricks.as_strided(
        x, (n_frames, N_FFT), (x.strides[0] * HOP, x.strides[0]))
    stft = np.fft.rfft(frames * window, axis=-1)
    power = np.abs(stft[:-1]) ** 2            # drop the last frame
    mel = mel_filterbank(n_mels) @ power.T    # [n_mels, frames]
    logm = np.log10(np.maximum(mel, 1e-10))
    logm = np.maximum(logm, logm.max() - 8.0)
    return ((logm + 4.0) / 4.0).astype(np.float32)


# ---------------------------------------------------------------------------
# encoder / decoder graphs
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def f32_exact():
    """Turn TF32 off for cuDNN convolutions and CUDA matmuls inside the
    block, restoring the caller's switches after: Whisper's f32 ops give the
    same result whatever the process set."""
    conv = torch.backends.cudnn.allow_tf32
    mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def device_of(params: Params) -> torch.device:
    return params["dec_embed"].device


def _linear(x, w, b=None):
    """The JAX ``linear``: ``x @ w`` in x's dtype (f32), then the bias."""
    y = linear(x, w)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def causal_mask(positions: torch.Tensor, S: int) -> torch.Tensor:
    """[B, T, S] bool: key s is visible to the query at absolute position
    ``positions[b, t]`` iff s <= that position."""
    return torch.arange(S, device=positions.device)[None, None, :] \
        <= positions[:, :, None]


def _mha(q, k, v, n_heads: int, mask: Optional[torch.Tensor] = None):
    """Plain multi-head attention in f32. q [B, T, D], k/v [Bk, S, D] with
    Bk = B, or Bk = 1 for keys that every row of q shares (the beams' one
    cross K/V row: the B·T queries then attend as one row of B·T, the same
    sums). Where ``mask`` [B, T, S] (:func:`causal_mask`) is False the
    score is -1e30."""
    B, T, D = q.shape
    if k.shape[0] != B:
        if k.shape[0] != 1 or mask is not None:
            raise ValueError(f"keys of batch {k.shape[0]} for queries of "
                             f"batch {B}")
        return _mha(q.reshape(1, B * T, D), k, v, n_heads).reshape(B, T, D)
    S = k.shape[1]
    H = n_heads
    Dh = D // H
    qh = q.reshape(B, T, H, Dh).transpose(1, 2).to(torch.float32)
    kh = k.reshape(B, S, H, Dh).transpose(1, 2).to(torch.float32)
    vh = v.reshape(B, S, H, Dh).transpose(1, 2).to(torch.float32)
    scores = torch.matmul(qh, kh.transpose(-1, -2)) * (Dh ** -0.5)
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None], -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs, vh)
    return out.transpose(1, 2).reshape(B, T, D).to(q.dtype)


def _attn_proj(x, lp, prefix):
    q = _linear(x, lp[f"{prefix}_wq"], lp.get(f"{prefix}_bq"))
    k = _linear(x, lp[f"{prefix}_wk"])               # whisper: k has no bias
    v = _linear(x, lp[f"{prefix}_wv"], lp.get(f"{prefix}_bv"))
    return q, k, v


def _gelu(x):
    return F.gelu(x, approximate="none")


def _as_input(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32) if not isinstance(
        a, torch.Tensor) else a).to(device=dev, dtype=torch.float32)


@torch.inference_mode()
def encode(params: Params, mel, cfg: WhisperConfig) -> torch.Tensor:
    """mel [B, n_mels, 3000] (numpy or a tensor) → encoder states
    [B, 1500, D] f32 on the params' device."""
    x = _as_input(mel, device_of(params))
    with f32_exact():
        x = F.conv1d(x, params["conv1_w"], params["conv1_b"], padding=1)
        x = _gelu(x)
        x = F.conv1d(x, params["conv2_w"], params["conv2_b"], stride=2,
                     padding=1)
        x = _gelu(x)
        x = x.transpose(1, 2)                       # [B, T, D]
        x = x + params["enc_pos"][None, : x.shape[1]]
        for lp in params["enc_layers"]:
            h = layer_norm(x, lp["ln1_w"], lp["ln1_b"])
            q, k, v = _attn_proj(h, lp, "attn")
            a = _mha(q, k, v, cfg.n_heads)
            x = x + _linear(a, lp["attn_wo"], lp["attn_bo"])
            h = layer_norm(x, lp["ln2_w"], lp["ln2_b"])
            h = _gelu(_linear(h, lp["fc1_w"], lp["fc1_b"]))
            x = x + _linear(h, lp["fc2_w"], lp["fc2_b"])
        return layer_norm(x, params["enc_ln_w"], params["enc_ln_b"])


@torch.inference_mode()
def init_decoder_state(params: Params, enc_out: torch.Tensor,
                       cfg: WhisperConfig, max_len: Optional[int] = None):
    """The per-layer cross-attention K/V of ``enc_out`` [B, Tenc, D],
    computed once an utterance (reference: whisper.cpp's cross-attn KV
    precompute), [L, B, Tenc, D] each; and a zeroed f32 self-attention
    cache [L, B, S, D], S = ``max_len`` or the text context."""
    B, Tenc, D = enc_out.shape
    S = max_len or cfg.n_text_ctx
    L = cfg.dec_layers
    dev = enc_out.device
    cross_k = torch.empty((L, B, Tenc, D), dtype=torch.float32, device=dev)
    cross_v = torch.empty_like(cross_k)
    with f32_exact():
        for i, lp in enumerate(params["dec_layers"]):
            cross_k[i] = _linear(enc_out, lp["cross_wk"])
            cross_v[i] = _linear(enc_out, lp["cross_wv"], lp.get("cross_bv"))
    self_k = torch.zeros((L, B, S, D), dtype=torch.float32, device=dev)
    return {"cross_k": cross_k, "cross_v": cross_v,
            "self_k": self_k, "self_v": torch.zeros_like(self_k)}


@torch.inference_mode()
def decode_step(params: Params, tokens, start: int, state,
                cfg: WhisperConfig):
    """tokens [B, T] at positions start..start+T, the same in every row
    (the JAX package takes a start a row; its callers give one value) →
    (logits [B, T, V] f32, state). The self-attention cache of ``state``
    is written in place (the JAX package donates it)."""
    dev = device_of(params)
    tokens = torch.as_tensor(tokens).to(device=dev, dtype=torch.long)
    B, T = tokens.shape
    S = state["self_k"].shape[2]
    if not 0 <= start <= S - T:
        raise ValueError(f"positions {start}..{start + T} outside the "
                         f"decoder cache of {S}")
    positions = (start + torch.arange(T, device=dev))[None, :].expand(B, T)
    x = params["dec_embed"][tokens].to(torch.float32)
    x = x + params["dec_pos"][positions]
    mask = causal_mask(positions, S)
    with f32_exact():
        for i, lp in enumerate(params["dec_layers"]):
            sk, sv = state["self_k"][i], state["self_v"][i]
            h = layer_norm(x, lp["ln1_w"], lp["ln1_b"])
            q, k, v = _attn_proj(h, lp, "attn")
            sk[:, start:start + T] = k
            sv[:, start:start + T] = v
            a = _mha(q, sk, sv, cfg.n_heads, mask)
            x = x + _linear(a, lp["attn_wo"], lp["attn_bo"])

            h = layer_norm(x, lp["ln_cross_w"], lp["ln_cross_b"])
            qc = _linear(h, lp["cross_wq"], lp.get("cross_bq"))
            a = _mha(qc, state["cross_k"][i], state["cross_v"][i],
                     cfg.n_heads)
            x = x + _linear(a, lp["cross_wo"], lp["cross_bo"])

            h = layer_norm(x, lp["ln2_w"], lp["ln2_b"])
            h = _gelu(_linear(h, lp["fc1_w"], lp["fc1_b"]))
            x = x + _linear(h, lp["fc2_w"], lp["fc2_b"])
        x = layer_norm(x, params["dec_ln_w"], params["dec_ln_b"])
        logits = torch.matmul(x, params["dec_embed"].to(x.dtype).T)
    return logits.to(torch.float32), state


def _ts_probs(row: np.ndarray, ts_begin: int):
    """(pt, ptsum, tid) of one step's logits row: the timestamp-token
    probability stats the reference records per sampled token
    (whisper.cpp whisper_process_logits → token.pt/ptsum/tid)."""
    row = row - row.max()
    p = np.exp(row)
    p /= p.sum()
    tail = p[ts_begin:]
    tid = int(tail.argmax()) + ts_begin
    return float(tail.max()), float(tail.sum()), tid


def _host_row(logits) -> np.ndarray:
    """The last position's logits of row 0, a writable f32 host copy."""
    return np.array(logits[0, -1].cpu().numpy(), np.float32)


@torch.inference_mode()
def transcribe_ids(params: Params, cfg: WhisperConfig, mel: np.ndarray,
                   prompt_ids: Sequence[int], max_new_tokens: int = 64,
                   suppress_ids: Sequence[int] = (),
                   force_first: Optional[int] = None,
                   collect_ts: Optional[int] = None) -> List[int]:
    """Greedy decode (reference whisper_full greedy path). ``prompt_ids``
    are the forced SOT/language/task tokens; ``suppress_ids`` are masked
    from every step (e.g. <|notimestamps|> in timestamp mode);
    ``force_first`` pins the first token (a timestamped window opens with a
    timestamp token). Each step's logits row is copied to the host and
    picked there, as in the JAX package.

    ``collect_ts``: the timestamp-begin token id; when set, returns (ids,
    info) with info[i] = (pt, ptsum, tid) per generated token."""
    enc = encode(params, np.asarray(mel)[None], cfg)
    state = init_decoder_state(params, enc, cfg)
    logits, state = decode_step(params, [list(prompt_ids)], 0, state, cfg)

    def pick(row):
        if suppress_ids:
            row = row.copy()
            row[list(suppress_ids)] = -np.inf
        return int(row.argmax())

    out = list(prompt_ids)
    info = []
    row = _host_row(logits)
    nxt = force_first if force_first is not None else pick(row)
    out.append(nxt)
    if collect_ts is not None:
        info.append(_ts_probs(row, collect_ts))
    pos = len(prompt_ids)
    for _ in range(max_new_tokens - 1):
        if nxt == cfg.eos_token_id:
            break
        logits, state = decode_step(params, [[nxt]], pos, state, cfg)
        row = _host_row(logits)
        nxt = pick(row)
        out.append(nxt)
        if collect_ts is not None:
            info.append(_ts_probs(row, collect_ts))
        pos += 1
    if collect_ts is not None:
        return out, info
    return out


# ---------------------------------------------------------------------------
# Beam decode (reference whisper.cpp beam-search strategy)
# ---------------------------------------------------------------------------


def _reorder_state(state, parents: torch.Tensor):
    """Reindex the beam rows of the self-attention cache in place (the
    whisper analog of beam_search_kv_cache_reorder, model_utils.h:423).
    The cross K/V is one row that every beam reads: nothing to reorder."""
    for key in ("self_k", "self_v"):
        state[key].copy_(state[key].index_select(1, parents))
    return state


def top_w(scores: torch.Tensor, W: int):
    """The W largest entries of a 1-D tensor and their indices, the lower
    index first on a tie (``jax.lax.top_k``): a stable descending sort,
    where ``torch.topk`` on the card promises no order among ties."""
    idx = torch.sort(scores, descending=True, stable=True).indices[:W]
    return scores[idx], idx


@torch.inference_mode()
def _beam_step(params, tokens, pos, scores, state, alive,
               cfg: WhisperConfig, W: int):
    """One beam expansion over the whisper decoder (forward → joint top-W
    over W·V → self-cache reorder). ``scores`` f32 [W] and ``alive`` bool
    [W] on the device → (parents, tokens, scores) on the device."""
    logits, state = decode_step(params, tokens, pos, state, cfg)
    logp = torch.log_softmax(logits[:, -1].to(torch.float32), dim=-1)
    V = logp.shape[-1]
    logp = torch.where(alive[:, None], logp,
                       torch.full((), -1e30, device=logp.device))
    total = scores[:, None] + logp
    top_scores, top_idx = top_w(total.reshape(-1), W)
    parents = top_idx // V
    toks = top_idx % V
    _reorder_state(state, parents)
    return parents, toks, top_scores


@torch.inference_mode()
def transcribe_ids_beam(params: Params, cfg: WhisperConfig, mel: np.ndarray,
                        prompt_ids: Sequence[int], beam_size: int = 5,
                        max_new_tokens: int = 64,
                        length_penalty: float = 1.0) -> List[int]:
    """Beam-search transcription (reference whisper.cpp beam strategy; HF
    generate(num_beams=N) semantics with the can't-be-beaten early stop).
    Returns prompt + best hypothesis ids. The host bookkeeping keeps f64
    scores, as the JAX package does."""
    W = beam_size
    T = len(prompt_ids)
    dev = device_of(params)
    enc = encode(params, np.asarray(mel)[None], cfg)
    # prefill the prompt once at B=1, then copy the self cache into the W
    # beam rows; the cross K/V stays one row
    state = init_decoder_state(params, enc, cfg)
    logits, state = decode_step(params, [list(prompt_ids)], 0, state, cfg)
    for key in ("self_k", "self_v"):
        state[key] = state[key].repeat(1, W, 1, 1)
    logp0 = torch.log_softmax(logits[0, -1].to(torch.float32), dim=-1)
    top_scores, top_toks = top_w(logp0, W)

    beams = [list(prompt_ids) + [int(t)] for t in top_toks.tolist()]
    scores = top_scores.cpu().numpy().astype(np.float64)
    alive = np.ones(W, bool)
    done: List[Tuple[List[int], float]] = []

    def lp(n_new):
        return max(n_new, 1) ** length_penalty

    for w in range(W):
        if beams[w][-1] == cfg.eos_token_id:
            done.append((beams[w], scores[w] / lp(1)))
            alive[w] = False
            scores[w] = -1e30

    pos = T
    for step in range(1, max_new_tokens):
        if not alive.any():
            break
        tokens = [[b[-1]] for b in beams]
        parents, toks, new_scores = _beam_step(
            params, tokens, pos,
            torch.tensor(scores, dtype=torch.float32, device=dev), state,
            torch.tensor(alive, device=dev), cfg, W)
        parents = parents.cpu().numpy()
        toks = toks.cpu().numpy()
        new_scores = new_scores.cpu().numpy().astype(np.float64)
        new_beams, new_alive = [], np.ones(W, bool)
        for w in range(W):
            seq = beams[parents[w]] + [int(toks[w])]
            new_beams.append(seq)
            if int(toks[w]) == cfg.eos_token_id:
                done.append((seq, new_scores[w] / lp(step + 1)))
                new_alive[w] = False
                new_scores[w] = -1e30
        beams, scores, alive = new_beams, new_scores, new_alive
        pos += 1
        if len(done) >= W:
            best_alive = scores[alive].max() if alive.any() else -np.inf
            worst_done = sorted(done, key=lambda h: -h[1])[W - 1][1]
            if best_alive / lp(max_new_tokens) < worst_done:
                break

    for w in range(W):
        if alive[w]:
            done.append((beams[w], scores[w] / lp(len(beams[w]) - T)))
    done.sort(key=lambda h: -h[1])
    return done[0][0]


# ---------------------------------------------------------------------------
# Special-token layout, language auto-detect, task plumbing
# ---------------------------------------------------------------------------


def special_tokens(cfg: WhisperConfig) -> Dict[str, int]:
    """Structure-derived special ids (whisper vocabs end with
    [...languages...] <|translate|> <|transcribe|> <|startoflm|>
    <|startofprev|> <|nospeech|> <|notimestamps|> [1500 timestamps];
    reference: whisper.cpp token_* fields)."""
    ts = timestamp_begin(cfg)
    no_ts = ts - 1
    return {
        "timestamp_begin": ts, "notimestamps": no_ts,
        "nospeech": no_ts - 1, "startofprev": no_ts - 2,
        "startoflm": no_ts - 3, "transcribe": no_ts - 4,
        "translate": no_ts - 5,
        "lang_begin": cfg.sot_token_id + 1,     # <|en|> ...
        "lang_end": no_ts - 5,                  # exclusive
    }


@torch.inference_mode()
def detect_language(params: Params, cfg: WhisperConfig, mel: np.ndarray,
                    enc: Optional[torch.Tensor] = None):
    """One decoder step from [sot], softmax restricted to the language
    token block (reference whisper_lang_auto_detect). Returns
    (lang_token_id, probs [n_langs] over ids lang_begin..lang_end)."""
    st = special_tokens(cfg)
    if st["lang_end"] <= st["lang_begin"]:
        raise ValueError("vocab has no language token block")
    if enc is None:
        enc = encode(params, np.asarray(mel)[None], cfg)
    state = init_decoder_state(params, enc, cfg, max_len=8)
    logits, _ = decode_step(params, [[cfg.sot_token_id]], 0, state, cfg)
    row = _host_row(logits)
    block = row[st["lang_begin"]:st["lang_end"]]
    probs = np.exp(block - block.max())
    probs /= probs.sum()
    return st["lang_begin"] + int(block.argmax()), probs


def build_forced_prompt(cfg: WhisperConfig, language: Optional[int] = None,
                        task: str = "transcribe",
                        timestamps: bool = False) -> List[int]:
    """SOT-sequence builder: [sot, <|lang|>, <|task|>, (<|notimestamps|>)]
    (reference whisper_full forced decoder tokens; HF forced_decoder_ids).
    ``language`` is a language TOKEN id (use detect_language for auto)."""
    if timestamp_begin(cfg) < 1:      # non-whisper vocab (tiny test models)
        return [cfg.sot_token_id]
    st = special_tokens(cfg)
    ids = [cfg.sot_token_id]
    if language is not None:
        ids.append(int(language))
    if language is not None or task != "transcribe":
        ids.append(st[task])
    if not timestamps:
        ids.append(st["notimestamps"])
    return ids


# ---------------------------------------------------------------------------
# Long-form transcription with timestamps (reference whisper_full seek loop)
# ---------------------------------------------------------------------------

TS_STEP = 0.02          # seconds per timestamp token
MEL_HOP_S = 0.01        # seconds per mel frame


def timestamp_begin(cfg: WhisperConfig) -> int:
    """First timestamp token id <|0.00|>. Whisper vocabs end with 1500
    timestamp tokens (0.00-30.00 in 0.02 s steps) plus <|notimestamps|>
    right before them, so en (51864) and multilingual (51865) both give
    vocab_size - 1501 (reference: whisper.cpp token_beg)."""
    return cfg.vocab_size - 1501


def segments_from_tokens(ids: Sequence[int], ts_begin: int, offset_s: float,
                         eos: int):
    """Split one window's decoded ids at timestamp tokens.

    Returns (segments, last_ts_s): segments are (start_s, end_s, text_ids)
    with absolute times; last_ts_s is the final timestamp in the window
    (the seek advance), or None if the window had no closing timestamp.
    """
    segs, cur = [], []
    t0 = 0.0
    last_ts = None
    for t in ids:
        if t == eos:
            break
        if t >= ts_begin:
            ts = (t - ts_begin) * TS_STEP
            if cur:
                segs.append((offset_s + t0, offset_s + ts, cur))
                cur = []
            t0 = ts
            last_ts = ts
        else:
            cur.append(int(t))
    if cur:  # unterminated segment: close at the window end
        segs.append((offset_s + t0, offset_s + 30.0, cur))
        last_ts = None
    return segs, last_ts


# ---------------------------------------------------------------------------
# Token-level timestamps (reference whisper_exp_compute_token_level_timestamps,
# whisper.cpp:2910 definition, applied per new segment at :4102-4147)
# ---------------------------------------------------------------------------


def voice_length(text: str) -> float:
    """Heuristic spoken length of a token's text (reference voice_length):
    spaces ~0, punctuation/digits long, letters 1."""
    res = 0.0
    for c in text:
        if c == " ":
            res += 0.01
        elif c == ",":
            res += 2.0
        elif c in ".!?" or c.isdigit():
            res += 3.0
        else:
            res += 1.0
    return res


def signal_energy(audio: np.ndarray, hw: int = 32) -> np.ndarray:
    """Smoothed |amplitude| per sample (reference get_signal_energy)."""
    a = np.abs(np.asarray(audio, np.float32).reshape(-1))
    kernel = np.ones(2 * hw + 1, np.float32) / (2 * hw + 1)
    return np.convolve(a, kernel, mode="same")


class TokenTimestamper:
    """Carries the cross-segment anchors (reference state->t_beg / t_last /
    tid_last) and computes per-token (t0, t1) seconds for one segment at a
    time."""

    def __init__(self, ts_begin: int, thold_pt: float = 0.01,
                 thold_ptsum: float = 0.01,
                 energy: Optional[np.ndarray] = None,
                 sample_rate: int = SAMPLE_RATE):
        self.ts_begin = ts_begin
        self.thold_pt = thold_pt
        self.thold_ptsum = thold_ptsum
        self.energy = energy
        self.sr = sample_rate
        self.t_beg = 0.0
        self.t_last = 0.0
        self.tid_last = ts_begin

    def segment(self, ids: Sequence[int], info, texts: Sequence[str],
                t0: float, t1: float) -> List[Tuple[float, float]]:
        """ids/info/texts: the segment's tokens (incl. any timestamp
        tokens), their (pt, ptsum, tid) stats, and their decoded text;
        t0/t1: segment bounds in seconds. Returns [(t0_s, t1_s)] per token:
        anchored on confidently-sampled timestamp probabilities, the gaps
        split in proportion to voice length, then snapped to the signal
        energy when audio is available."""
        n = len(ids)
        if n == 0:
            return []
        if n == 1:
            self.t_last = t1
            return [(t0, t1)]
        UNSET = -1.0
        tok_t0 = [UNSET] * n
        tok_t1 = [UNSET] * n

        if ids[0] == self.ts_begin:
            tok_t0[0] = tok_t1[0] = t0
            tok_t0[1] = t0
            self.t_beg = t0
            self.t_last = t0
            self.tid_last = self.ts_begin
        else:
            tok_t0[0] = self.t_last

        for j in range(n):
            pt, ptsum, tid = info[j]
            tt = self.t_beg + TS_STEP * (tid - self.ts_begin)
            if (pt > self.thold_pt and ptsum > self.thold_ptsum
                    and tid > self.tid_last and tt <= t1):
                if j > 0:
                    tok_t1[j - 1] = tt
                tok_t0[j] = tt
                self.tid_last = tid
        tok_t1[n - 2] = t1
        tok_t0[n - 1] = t1
        tok_t1[n - 1] = t1
        self.t_last = t1

        # proportional fill of unknown intervals by voice length
        vlens = [voice_length(t) for t in texts]
        p0 = 0
        while True:
            p1 = p0
            while p1 < n and tok_t1[p1] < 0:
                p1 += 1
            if p1 >= n:
                p1 = n - 1
            if p1 > p0:
                psum = sum(vlens[p0:p1 + 1]) or 1.0
                dt = tok_t1[p1] - tok_t0[p0]
                for j in range(p0 + 1, p1 + 1):
                    ct = tok_t0[j - 1] + dt * vlens[j - 1] / psum
                    tok_t1[j - 1] = ct
                    tok_t0[j] = ct
            p0 = p1 + 1
            if p0 >= n:
                break
        # monotonicity fixups (reference "fix up (just in case)")
        for j in range(n - 1):
            if tok_t1[j] < 0:
                tok_t0[j + 1] = tok_t1[j]
            if j > 0 and tok_t1[j - 1] > tok_t0[j]:
                tok_t0[j] = tok_t1[j - 1]
                tok_t1[j] = max(tok_t0[j], tok_t1[j])

        if self.energy is not None:
            self._vad(ids, tok_t0, tok_t1)
        return list(zip(tok_t0, tok_t1))

    def _vad(self, ids, tok_t0, tok_t1):
        """Expand/contract token intervals to the local voice activity
        (reference VAD block of the same function)."""
        e = self.energy
        ns_total = len(e)
        hw = self.sr // 8

        def to_sample(t):
            return min(max(int(round(t * self.sr)), 0), ns_total - 1)

        n = len(ids)
        for j in range(n):
            if ids[j] >= self.ts_begin:
                continue
            s0, s1 = to_sample(tok_t0[j]), to_sample(tok_t1[j])
            ss0, ss1 = max(s0 - hw, 0), min(s1 + hw, ns_total)
            if ss1 <= ss0:
                continue
            thold = 0.5 * float(e[ss0:ss1].sum()) / (ss1 - ss0)

            k = s0
            if e[k] > thold and j > 0:
                while k > 0 and e[k] > thold:
                    k -= 1
                t = k / self.sr
                tok_t0[j] = max(t, tok_t1[j - 1])
            else:
                while k < s1 and e[k] < thold:
                    k += 1
                tok_t0[j] = k / self.sr
                s0 = k

            k = s1
            if e[k] > thold:
                while k < ns_total - 1 and e[k] > thold:
                    k += 1
                t = k / self.sr
                tok_t1[j] = min(t, tok_t0[j + 1]) if j < n - 1 \
                    and tok_t0[j + 1] >= 0 else t
            else:
                while k > s0 and e[k] < thold:
                    k -= 1
                tok_t1[j] = k / self.sr


def transcribe_segments(params: Params, cfg: WhisperConfig, mel: np.ndarray,
                        prompt_ids: Sequence[int],
                        max_new_tokens: int = 224,
                        ts_begin: Optional[int] = None,
                        max_windows: Optional[int] = None,
                        token_timestamps: bool = False,
                        audio: Optional[np.ndarray] = None,
                        token_text_fn=None):
    """Long-audio transcription: 30 s windows advanced by the last decoded
    timestamp, with per-segment (start, end) times (the reference's
    whisper_full seek loop).

    mel: [n_mels, T_frames] (any length). Returns a list of
    (start_s, end_s, token_ids) segments, or with ``token_timestamps=True``
    (start_s, end_s, token_ids, token_times) where token_times[i] =
    (t0_s, t1_s) per text token (reference params.token_timestamps).
    ``audio`` (16 kHz samples) enables the energy-VAD snap;
    ``token_text_fn`` maps an id to its text for the voice-length split
    (defaults to a uniform length).
    """
    if ts_begin is None:
        ts_begin = timestamp_begin(cfg)
    if ts_begin < 1:
        raise ValueError(
            f"vocab_size {cfg.vocab_size} has no timestamp tokens; pass "
            "ts_begin explicitly for non-whisper vocabs")
    no_ts = ts_begin - 1
    win = cfg.n_audio_ctx * 2                       # mel frames per window
    mel = np.asarray(mel)
    n_frames = mel.shape[-1]
    segments = []
    seek = 0
    n_win = 0
    stamper = None
    if token_timestamps:
        energy = signal_energy(audio) if audio is not None else None
        stamper = TokenTimestamper(ts_begin, energy=energy)
        text_fn = token_text_fn or (lambda i: "x")
    while seek < n_frames and (max_windows is None or n_win < max_windows):
        n_win += 1
        window = mel[:, seek:seek + win]
        if window.shape[-1] < win:
            window = np.pad(window,
                            ((0, 0), (0, win - window.shape[-1])),
                            constant_values=float(window.min())
                            if window.size else 0.0)
        ids = transcribe_ids(params, cfg, window, prompt_ids,
                             max_new_tokens, suppress_ids=(no_ts,),
                             force_first=ts_begin,
                             collect_ts=ts_begin if token_timestamps
                             else None)
        if token_timestamps:
            ids, info = ids
        new = ids[len(prompt_ids):]
        offset_s = seek * MEL_HOP_S
        segs, last_ts = segments_from_tokens(
            new, ts_begin, offset_s, cfg.eos_token_id)
        if token_timestamps:
            # re-scan with indices so each segment's text tokens map back
            # to their per-step (pt, ptsum, tid) stats
            idx_segs, cur = [], []
            for i, t in enumerate(new):
                if t == cfg.eos_token_id:
                    break
                if t >= ts_begin:
                    if cur:
                        idx_segs.append(cur)
                        cur = []
                else:
                    cur.append(i)
            if cur:
                idx_segs.append(cur)
            for (t0, t1, text_ids), idxs in zip(segs, idx_segs):
                times = stamper.segment(
                    [new[i] for i in idxs], [info[i] for i in idxs],
                    [text_fn(new[i]) for i in idxs], t0, t1)
                segments.append((t0, t1, text_ids, times))
        else:
            segments.extend(segs)
        if last_ts is not None and last_ts > 0:
            seek += int(round(last_ts / MEL_HOP_S))
        else:
            seek += win
    return segments


# ---------------------------------------------------------------------------
# Weights: the HF layout, local directories, random weights
# ---------------------------------------------------------------------------

def _attn_names(p: str, prefix: str):
    """(port name, HF name, transposed, a quantized linear) of one attention
    block's tensors."""
    return [(f"{prefix}_wq", p + "q_proj.weight", True, True),
            (f"{prefix}_bq", p + "q_proj.bias", False, False),
            (f"{prefix}_wk", p + "k_proj.weight", True, True),
            (f"{prefix}_wv", p + "v_proj.weight", True, True),
            (f"{prefix}_bv", p + "v_proj.bias", False, False),
            (f"{prefix}_wo", p + "out_proj.weight", True, True),
            (f"{prefix}_bo", p + "out_proj.bias", False, False)]


def _mlp_names(p: str):
    return [("ln1_w", p + "self_attn_layer_norm.weight", False, False),
            ("ln1_b", p + "self_attn_layer_norm.bias", False, False),
            ("ln2_w", p + "final_layer_norm.weight", False, False),
            ("ln2_b", p + "final_layer_norm.bias", False, False),
            ("fc1_w", p + "fc1.weight", True, True),
            ("fc1_b", p + "fc1.bias", False, False),
            ("fc2_w", p + "fc2.weight", True, True),
            ("fc2_b", p + "fc2.bias", False, False)]


def enc_layer_names(i: int):
    p = f"model.encoder.layers.{i}."
    return _mlp_names(p) + _attn_names(p + "self_attn.", "attn")


def dec_layer_names(i: int):
    p = f"model.decoder.layers.{i}."
    return (_mlp_names(p)
            + [("ln_cross_w", p + "encoder_attn_layer_norm.weight", False,
                False),
               ("ln_cross_b", p + "encoder_attn_layer_norm.bias", False,
                False)]
            + _attn_names(p + "self_attn.", "attn")
            + _attn_names(p + "encoder_attn.", "cross"))


TOP_NAMES = [
    ("conv1_w", "model.encoder.conv1.weight"),
    ("conv1_b", "model.encoder.conv1.bias"),
    ("conv2_w", "model.encoder.conv2.weight"),
    ("conv2_b", "model.encoder.conv2.bias"),
    ("enc_pos", "model.encoder.embed_positions.weight"),
    ("enc_ln_w", "model.encoder.layer_norm.weight"),
    ("enc_ln_b", "model.encoder.layer_norm.bias"),
    ("dec_embed", "model.decoder.embed_tokens.weight"),
    ("dec_pos", "model.decoder.embed_positions.weight"),
    ("dec_ln_w", "model.decoder.layer_norm.weight"),
    ("dec_ln_b", "model.decoder.layer_norm.bias")]


def hf_shapes(cfg: WhisperConfig) -> Dict[str, Tuple[int, ...]]:
    """Every tensor of an HF Whisper state dict (the tied ``proj_out``
    aside) and its shape."""
    D, Fd = cfg.d_model, cfg.ffn_dim
    shapes = {
        "model.encoder.conv1.weight": (D, cfg.n_mels, 3),
        "model.encoder.conv2.weight": (D, D, 3),
        "model.encoder.embed_positions.weight": (cfg.n_audio_ctx, D),
        "model.decoder.embed_tokens.weight": (cfg.vocab_size, D),
        "model.decoder.embed_positions.weight": (cfg.n_text_ctx, D)}
    for _, hf in TOP_NAMES:
        shapes.setdefault(hf, (D,))
    layers = [enc_layer_names(i) for i in range(cfg.enc_layers)] + \
        [dec_layer_names(i) for i in range(cfg.dec_layers)]
    for names in layers:
        for _, hf, _, _ in names:
            kind = hf.rsplit(".", 2)[-2]
            if kind == "fc1":
                s = (Fd, D) if hf.endswith("weight") else (Fd,)
            elif kind == "fc2":
                s = (D, Fd) if hf.endswith("weight") else (D,)
            elif kind.endswith("_proj") and hf.endswith("weight"):
                s = (D, D)
            else:
                s = (D,)
            shapes[hf] = s
    return shapes


def _build(fetch, cfg: WhisperConfig, qcfg, dtype) -> Params:
    """The port's params from ``fetch(hf_name)`` (an f32 tensor on the
    target device, in HF's orientation): the encoder/decoder attention and
    MLP linears quantized to ``qcfg`` where it is set, is one config, the
    weight is 2-D and its K divides the group (the JAX package's rule: the
    reference quantizes 2-D linears only, and a K that does not divide the
    group stays fp); convs, embeddings, norms and the tied logits stay fp.
    Quantized weights are at rest (``params_to_native``)."""
    from ..core.qtensor import quantize, to_native

    def g(hf, transpose=False, q=False):
        w = fetch(hf)
        w = w.T.contiguous() if transpose else w
        if q and qcfg is not None and w.ndim == 2 and \
                (qcfg.group_size == -1 or w.shape[0] % qcfg.group_size == 0):
            return to_native(quantize(w, qcfg))
        return w.to(dtype)

    params: Params = {name: g(hf) for name, hf in TOP_NAMES}
    params["enc_layers"] = [{n: g(hf, tr, q) for n, hf, tr, q in
                             enc_layer_names(i)}
                            for i in range(cfg.enc_layers)]
    params["dec_layers"] = [{n: g(hf, tr, q) for n, hf, tr, q in
                             dec_layer_names(i)}
                            for i in range(cfg.dec_layers)]
    return params


def _resolve(quant):
    from ..convert.hf import resolve_quant
    from ..convert.quant_registry import QuantRegistry
    qcfg = resolve_quant(quant)
    if isinstance(qcfg, QuantRegistry):
        raise ValueError(
            "whisper quantization takes a single preset/QuantConfig — "
            "per-tensor QuantRegistry rules target decoder-family tensor "
            "names and do not apply to the whisper encoder-decoder")
    return qcfg


def params_from_hf(model, dtype=torch.float32, quant=None,
                   device=None) -> Tuple[Params, WhisperConfig]:
    """Any object with ``.config`` (an HF WhisperConfig or a namespace of
    its keys) and ``.state_dict()`` (torch tensors or numpy arrays; an HF
    ``WhisperForConditionalGeneration`` is one) → (params, cfg) on
    ``device`` (the card unless ``device="cpu"``); no transformers import.

    ``quant`` (a preset name or a QuantConfig): the encoder/decoder linears
    quantized as :func:`_build` says, the analog of the reference's
    whisper quantization (quant_utils.h:79 whisper_model_quantize); a
    QuantRegistry is refused."""
    qcfg = _resolve(quant)
    cfg = config_from_hf(model.config)
    dev = resolve_device(device)
    sd = model.state_dict()
    if "model.decoder.embed_tokens.weight" not in sd and \
            "proj_out.weight" in sd:     # the tied copy kept instead
        sd = dict(sd)
        sd["model.decoder.embed_tokens.weight"] = sd["proj_out.weight"]

    def fetch(hf):
        w = sd[hf]
        if not isinstance(w, torch.Tensor):
            w = torch.from_numpy(np.ascontiguousarray(w))
        return w.detach().to(device=dev, dtype=torch.float32)

    return _build(fetch, cfg, qcfg, dtype), cfg


class LocalCheckpoint:
    """A local HF Whisper directory (``config.json`` and ``*.safetensors``),
    read by ``convert.files`` without transformers: ``.config`` and
    ``.state_dict()`` for :func:`params_from_hf`."""

    def __init__(self, path: str):
        from ..convert import files
        self.path = path
        self.config = files.read_config(path)
        if getattr(self.config, "model_type", None) != "whisper":
            raise ValueError(f"{path}: model_type "
                             f"{getattr(self.config, 'model_type', None)!r}"
                             ", not 'whisper'")

    def state_dict(self):
        from ..convert import files
        return files.read_safetensors_dir(self.path)


def params_from_dir(path: str, quant=None, device=None):
    """A local HF Whisper directory → (params, cfg) (:func:`params_from_hf`)."""
    return params_from_hf(LocalCheckpoint(path), quant=quant, device=device)


def sinusoids(length: int, channels: int,
              max_timescale: float = 10000.0) -> torch.Tensor:
    """Whisper's encoder positions [length, channels]: sin then cos of
    log-spaced timescales."""
    inc = math.log(max_timescale) / (channels // 2 - 1)
    inv = torch.exp(-inc * torch.arange(channels // 2, dtype=torch.float32))
    t = torch.arange(length, dtype=torch.float32)[:, None] * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1)


def init_random(cfg: WhisperConfig, seed: int = 0, quant=None,
                device=None) -> Params:
    """Random f32 weights from ``seed``, made on ``device`` (the card
    unless ``device="cpu"``) a tensor at a time and quantized there as
    :func:`params_from_hf` would: linears and embeddings N(0, 0.02²), the
    convs N(0, 1/fan_in), biases N(0, 0.02²), norm weights 1, the encoder
    positions sinusoidal."""
    qcfg = _resolve(quant)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = hf_shapes(cfg)

    def fetch(hf):
        shape = shapes[hf]
        if hf.endswith("embed_positions.weight") and "encoder" in hf:
            return sinusoids(*shape).to(dev)
        if "layer_norm" in hf:
            return (torch.ones if hf.endswith("weight") else torch.zeros)(
                shape, device=dev)
        std = 1.0 / math.sqrt(shape[1] * shape[2]) if len(shape) == 3 \
            else 0.02
        return torch.randn(shape, generator=gen, device=dev) * std

    return _build(fetch, cfg, qcfg, torch.float32)
