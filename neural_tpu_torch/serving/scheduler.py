"""Iteration-level continuous batching (port of
``neural_tpu/serving/scheduler.py``).

A fixed pool of B cache slots; prompts prefill into one slot at a time, a
chunk per iteration, each chunk padded to a bucket length; one batched
[B, 1] decode step advances every running slot per iteration. The KV cache
is either one contiguous ``[L, B, Hkv, S, Dh]`` buffer (``kv_mode="slots"``)
or a shared page pool with a page table per slot (``kv_mode="paged"``),
bf16 or int8. Each request samples with its own SamplingParams (greedy,
the filters, or mirostat with a mu per slot kept across steps), from one
``torch.Generator`` seeded with ``seed``.

As the reference worker does (scheduler.cpp:99-148), the batch also runs:

- beam groups: a request with ``num_beams`` W takes W contiguous slots,
  prefills single-shot into the first and copies the prompt's KV to the
  others; each decode step ranks the group's rows on the device
  (:func:`~neural_tpu_torch.runtime.beam.rank_beams`, as ``beam_search``
  does), reads back W parents, ids and scores, and reorders the group's KV
  in place (rows in slots mode, page contents in paged mode);
- StreamingLLM slots (``streaming=True``, slots mode): a slot whose cache
  row is full is compacted and rotated in place
  (``runtime.streaming.shift_cache_impl`` on that row), so requests may run
  past ``max_len``;
- decode blocks (``decode_block=k``): when nothing can be admitted and every
  running request shares one SamplingParams, k tokens per iteration through
  one :class:`~neural_tpu_torch.runtime.generate._SampledStep`.

On the card the decode step — forward and batched sampling — is one CUDA
graph per (penalty width, sampling branches, logits output, fusion
switches) (:class:`_DecodeGraph`): the JAX package runs it as one jitted
executable (``_decode_sample_all``), and launched eagerly from Python the
step would be bound by the host. The host fills the graph's static inputs
(tokens, lengths, sampling rows, penalty history, a prefix-LM model's
per-slot prompt lengths), refills the shared noise buffer from the
generator, replays it and reads back [B] ids; the mirostat mu [B] is a
device tensor the graph updates; a step with a beam group also returns the
f32 logits [B, V], which stay on the card. Every cache edit (page table,
prompt copies, beam reorders, shifts) is in place, so the captured graphs
stay valid. Prefill chunks run eagerly. A prefix-LM model (ChatGLM-1)
prefills single-shot, as in the JAX package (its prefix mask needs the
whole prompt); in paged mode its prefix mask reaches K3 too, where the JAX
Scheduler's paged prefill is causal.

The TPU's decode block-size hint (``pick_decode_blk``) and the
weight-residency policy (``ensure_decode_residency``) have no counterpart:
the port's kernels take no block size, and its weights are native-packed
once at load.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from enum import Enum
from typing import Dict, List, Optional, Sequence as Seq, Tuple

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.transformer import fuse_switches
from ..runtime.beam import rank_beams, stop_mask
from ..runtime.generate import _Graph, _generator, _SampledStep
from ..runtime.kvcache import copy_kv, init_cache
from ..runtime.paged import PageAllocator, init_paged_cache, pages_needed
from ..runtime.sampling import (BatchedSamplingParams, SamplerState,
                                SamplingParams, batch_params, sample,
                                sample_batched)
from ..runtime.streaming import shift_cache_impl


class SeqStatus(Enum):
    # reference: seq_status (pool.h:22)
    WAITING = 0
    PREFILL = 1
    DECODING = 2
    FINISHED = 3


@dataclasses.dataclass
class Sequence:
    """reference: sequence (pool.h:43)."""
    request_id: str
    prompt_ids: List[int]
    max_new_tokens: int = 128
    sampling: Optional[SamplingParams] = None   # per-request override
    status: SeqStatus = SeqStatus.WAITING
    slot: int = -1
    prefill_pos: int = 0   # tokens already prefilled (chunked prefill)
    chunk: Optional[int] = None  # this request's prefill chunk (None =
    #                              single-shot), set at admission
    output_ids: List[int] = dataclasses.field(default_factory=list)
    receive_time: float = dataclasses.field(default_factory=time.time)
    first_token_time: Optional[float] = None
    end_time: Optional[float] = None
    # beam-search requests (reference scheduler.cpp:99-148; beam state
    # model_utils.h:297)
    num_beams: int = 1
    length_penalty: float = 1.0
    min_new_tokens: int = 0
    beam: Optional["BeamGroup"] = None
    hypotheses: List[Tuple[List[int], float]] = \
        dataclasses.field(default_factory=list)  # (new_token_ids, score)


@dataclasses.dataclass
class BeamGroup:
    """Host-side bookkeeping of one in-scheduler beam request: its W beams
    live in the contiguous slots [base, base+W)."""
    width: int
    base: int                         # first slot of the contiguous block
    beams: List[List[int]]            # full token ids per live beam row
    scores: np.ndarray                # cumulative log-probs [W]
    alive: np.ndarray                 # bool [W]
    done: List[Tuple[List[int], float]]  # finished (ids, penalized score)
    step: int = 0                     # generated tokens so far


def _bucket(n: int, buckets: Seq[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds max bucket {buckets[-1]}")


def _penalty_hist(rows, B: int, RL: int):
    """Repetition-penalty history for a batch of rows.

    ``rows``: iterable of (row_index, Sequence, repeat_last_n). Returns
    right-aligned (hist [B, RL] int32, valid [B, RL] bool) over each
    sequence's last min(rl, RL) prompt+output tokens."""
    hist = np.zeros((B, max(RL, 1)), np.int32)
    valid = np.zeros((B, max(RL, 1)), bool)
    for r, seq, rl in rows:
        t = (seq.prompt_ids + seq.output_ids)[-min(rl, RL):] if rl > 0 else []
        if t:
            hist[r, -len(t):] = t
            valid[r, -len(t):] = True
    return hist, valid


def _is_greedy(sp: SamplingParams) -> bool:
    return sp.greedy or sp.temperature <= 0


def _decode_sample_all(model, tokens, lengths, cache, bp, hist, valid, mu,
                       noise, eos_ids: tuple, enable: tuple, prompt_len=None):
    """One decode step for every slot plus the batched sampling: tokens
    [B, 1] at offsets lengths [B] (a prefix-LM model's per-slot
    ``prompt_len`` [B]) → (ids [B] int32, the step's f32 logits [B, V], which
    beam groups rank); the cache is written in place and, when
    ``enable`` holds "mirostat", the mirostat ``mu`` [B] too. Inactive slots
    still compute (static shapes): their ids are ignored and their cache
    rows overwritten on the next prefill."""
    logits = model(tokens, lengths, cache, prompt_len=prompt_len)[:, -1]
    tok, new_mu = sample_batched(logits, bp, mu, eos_ids=eos_ids,
                                 prev_tokens=hist, prev_valid=valid,
                                 enable=enable, noise=noise)
    if "mirostat" in enable:
        mu.copy_(new_mu)
    return tok, logits


class _DecodeGraph:
    """:func:`_decode_sample_all` captured in a CUDA graph
    (:class:`~neural_tpu_torch.runtime.generate._Graph`), with static input
    buffers for one penalty-history width RL (0: no penalties) and one set
    of sampling branches ``enable``; the
    mirostat ``mu`` and the draw's ``noise`` are the Scheduler's own device
    buffers, shared by its graphs.

    Captured on its first :meth:`run`, once the buffers hold that step's
    real inputs: the capture protocol runs the step once eagerly on a side
    stream and puts mu back, and the replay that follows writes the same KV
    slots with the same values, so the step is not taken twice. Any failure
    to capture raises; there is no eager fallback. The capture takes the
    path of the fusion switches (``models.transformer.fuse_switches``) as
    they stand: the Scheduler keys its graphs by the switches too, so a
    switch flipped between steps captures a new graph and never replays
    one of the other path."""

    def __init__(self, model, cache, B: int, RL: int, eos_ids: tuple,
                 enable: tuple, mu: torch.Tensor,
                 noise: torch.Tensor, prefix_lm: bool = False):
        dev = model.device
        self.model, self.cache, self.eos_ids = model, cache, eos_ids
        self.enable = enable
        self.mu, self.noise = mu, noise
        self.tokens = torch.zeros((B, 1), dtype=torch.long, device=dev)
        self.lengths = torch.zeros(B, dtype=torch.long, device=dev)
        self.prompt_len = torch.zeros(B, dtype=torch.long, device=dev) \
            if prefix_lm else None
        self.bp = batch_params([SamplingParams(greedy=True)] * B).to(dev)
        self.hist = self.valid = None
        if RL:
            self.hist = torch.zeros((B, RL), dtype=torch.int32, device=dev)
            self.valid = torch.zeros((B, RL), dtype=torch.bool, device=dev)
        self.graph: Optional[_Graph] = None

    @property
    def launches(self) -> Dict[str, int]:
        """Kernel launches of one replay."""
        return self.graph.launches if self.graph is not None else {}

    def _step(self):
        return _decode_sample_all(self.model, self.tokens, self.lengths,
                                  self.cache, self.bp, self.hist, self.valid,
                                  self.mu, self.noise, self.eos_ids,
                                  self.enable, self.prompt_len)

    def run(self, tokens: torch.Tensor, lengths: torch.Tensor,
            bp: BatchedSamplingParams, hist, valid, prompt_len=None):
        """Fill the static inputs and replay → (ids [B], logits [B, V]),
        static tensors that the next replay overwrites."""
        self.tokens.copy_(tokens)
        self.lengths.copy_(lengths)
        if self.prompt_len is not None:
            self.prompt_len.copy_(prompt_len)
        self.bp.copy_(bp)
        if self.hist is not None:
            self.hist.copy_(hist)
            self.valid.copy_(valid)
        if self.graph is None:
            self.graph = _Graph(self._step, [self.mu])
        return self.graph.replay()


class Scheduler:
    """FCFS continuous-batching scheduler (reference scheduler.cpp:278).

    Usage: add_request(...) any time; step() runs one iteration (at most one
    prefill chunk plus one batched decode); poll finished sequences with
    pop_finished(). ``params`` is the port's decoder
    (:class:`~neural_tpu_torch.models.transformer.Transformer`); caches
    live on its device.
    """

    #: inactive slots and beam rows sample with this trivial config
    #: (argmax, no state) — their ids are discarded, so give them the
    #: cheapest row
    _IDLE_SP = SamplingParams(greedy=True, repeat_penalty=1.0,
                              repeat_last_n=0)

    def __init__(self, params, cfg: ModelConfig, max_batch: int = 8,
                 max_len: int = 2048,
                 sampling: Optional[SamplingParams] = None,
                 kv_dtype=torch.bfloat16, seed: int = 0,
                 prefill_buckets: Seq[int] = (32, 64, 128, 256, 512,
                                              1024, 2048),
                 kv_mode: str = "slots", page_size: int = 256,
                 n_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = 512,
                 streaming: bool = False, n_keep: int = 4,
                 n_discard: Optional[int] = None, decode_block: int = 1):
        """``kv_mode="paged"``: shared page pool + per-slot page tables
        (runtime/paged.py). ``n_pages`` sizes the pool below worst case
        (default batch·max_len/page_size); admission defers when the pool
        can't cover a request's prompt+max_new reservation.

        ``prefill_chunk``: long prompts prefill in chunks of this many
        tokens, with a batched decode step interleaved after every chunk
        (the mixed prefill+decode iteration of the reference worker,
        scheduler.cpp:55-98). None = single-shot prefill.

        ``seed`` seeds the generator every sampled draw takes its uniforms
        from (the JAX package's key streams are not reproduced).

        ``streaming=True`` (slots mode only): StreamingLLM per slot — when a
        slot's row is full, keep ``n_keep`` sink tokens, drop ``n_discard``
        (default half the non-sink window) and shift-RoPE the rest down, so
        requests may generate past ``max_len``.

        ``decode_block > 1``: when nothing can be admitted, no beam group
        runs and every running request shares one non-mirostat
        SamplingParams with its min_new_tokens met, decode advances
        ``decode_block`` tokens per iteration; tokens past a request's EOS
        or max_new_tokens are discarded. Greedy ids equal
        ``decode_block=1``'s."""
        if streaming and kv_mode != "slots":
            raise ValueError("streaming (StreamingLLM slots) requires "
                             f"kv_mode='slots', got {kv_mode!r}")
        self.sampling = sampling or SamplingParams(greedy=True)
        self.params = params
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.kv_mode = kv_mode
        dev = params.device
        if kv_mode == "paged":
            self.page_size = page_size
            self.cache = init_paged_cache(cfg, max_batch, max_len, n_pages,
                                          page_size, kv_dtype, dev)
            self.maxp = max_len // page_size
            # last page = trash: inactive slots' table rows point there, so
            # their (ignored, static-shape) decode writes can never alias a
            # live sequence's pages
            self._trash_page = self.cache.n_pages - 1
            self.allocator = PageAllocator(self.cache.n_pages - 1)
            self.table_np = np.full((max_batch, self.maxp),
                                    self._trash_page, np.int32)
            self.slot_pages: Dict[int, List[int]] = {}
            self._table_dirty = True
        elif kv_mode == "slots":
            self.cache = init_cache(cfg, max_batch, max_len, kv_dtype, dev)
        else:
            raise ValueError(f"kv_mode must be 'slots' or 'paged', got "
                             f"{kv_mode!r}")
        self.lengths = np.zeros(max_batch, np.int64)
        self.prefix_lm = cfg.prefix_lm or cfg.rope_style == "glm1"
        self.prompt_lens = np.zeros(max_batch, np.int64)
        self.buckets = [b for b in prefill_buckets if b <= max_len]
        if not self.buckets or self.buckets[-1] < max_len:
            # terminal bucket = the cache itself, so single-shot prefill
            # can hold any admissible prompt (T <= max_len)
            self.buckets.append(max_len)
        if self.prefix_lm:
            prefill_chunk = None   # the prefix mask needs the whole prompt
        if prefill_chunk is not None and kv_mode == "paged":
            # paged multi-token writes stream whole pages, so chunks must
            # begin page-aligned (paged_update_kv's T>1 path)
            prefill_chunk = -(-prefill_chunk // page_size) * page_size
        if prefill_chunk is not None:
            # chunk sizes must be bucket members to bound the shape count
            fit = [b for b in self.buckets
                   if b >= min(prefill_chunk, self.buckets[-1])]
            prefill_chunk = min(fit) if fit else None
            if kv_mode == "paged" and prefill_chunk is not None \
                    and prefill_chunk % page_size:
                prefill_chunk = None   # no aligned bucket → single-shot
        self.prefill_chunk = prefill_chunk
        self._prefilling: Optional[Sequence] = None
        self.streaming = streaming
        if streaming:
            self.n_keep = n_keep
            self.n_discard = n_discard or (max_len - n_keep) // 2
            self.inv_freqs = getattr(params, "rope_inv_freqs", None)
        self.waiting: deque[Sequence] = deque()
        self.running: Dict[int, Sequence] = {}     # slot → seq
        self.finished: List[Sequence] = []
        self.free_slots = list(range(max_batch))[::-1]
        self.gen = _generator(dev, seed)
        # per-SLOT mirostat mu on the device, kept across steps; set to
        # 2*tau at every slot assignment (_reset_mu): a reused slot must not
        # inherit the previous request's mu
        self._mu = torch.full((max_batch,), 2.0 * self.sampling.mirostat_tau,
                              dtype=torch.float32, device=dev)
        # the uniforms of one sampled step's draw, refilled before each step
        self._noise = torch.zeros((max_batch, cfg.vocab_size),
                                  dtype=torch.float32, device=dev)
        self._next_tokens = np.zeros(max_batch, np.int64)
        self.decode_block = max(1, decode_block)
        self.steps_decoding_for_next_prefill = 0  # reference scheduler.cpp:355
        # decode-step graphs by (penalty width, sampling branches, logits
        # output, fusion switches); None runs the step eagerly, as on the CPU
        self._graphs: Optional[Dict[tuple, _DecodeGraph]] = \
            {} if dev.type == "cuda" else None
        # decode blocks' sampled steps by (sampling, penalty width, switches)
        self._blocks: Dict[tuple, _SampledStep] = {}

    # -- client API ---------------------------------------------------------
    def validate(self, prompt_ids: Seq[int], max_new_tokens: int = 128,
                 num_beams: int = 1):
        """Raise ValueError for a request this scheduler can never serve.
        Reads only the configuration, so a client thread may call it."""
        T = len(prompt_ids)
        if not T:
            raise ValueError("a request needs at least one prompt token")
        if self.streaming:
            if T >= self.max_len:
                raise ValueError(f"a streaming prompt must be shorter than "
                                 f"max_len: {T} >= {self.max_len}")
        elif T + max_new_tokens > self.max_len:
            raise ValueError(f"request exceeds max_len: {T} prompt + "
                             f"{max_new_tokens} new > {self.max_len}")
        if num_beams > self.max_batch:
            raise ValueError(f"num_beams {num_beams} exceeds the slot pool "
                             f"(max_batch {self.max_batch})")
        if self.kv_mode == "paged":
            # reject requests the pool can NEVER satisfy — otherwise
            # admission defers forever and run_to_completion() livelocks.
            # Same worst-case formula as _can_admit / _begin_prefill.
            need = self._pages_required(T, max_new_tokens, num_beams)
            cap = self.cache.n_pages - 1
            if need > cap:
                raise ValueError(
                    f"request needs {need} pages but the pool holds {cap} "
                    f"(n_pages={self.cache.n_pages}, page_size="
                    f"{self.page_size}); raise n_pages or lower "
                    "max_new_tokens")

    def add_request(self, request_id: str, prompt_ids: Seq[int],
                    max_new_tokens: int = 128,
                    sampling: Optional[SamplingParams] = None,
                    num_beams: int = 1, length_penalty: float = 1.0,
                    min_new_tokens: int = 0):
        """``sampling`` overrides the scheduler default for this request
        (reference: per-query generation config in Query). ``num_beams > 1``
        runs beam search inside the batched step (reference
        scheduler.cpp:99-148): the request takes num_beams cache slots and
        its result is the best length-penalized hypothesis."""
        self.validate(prompt_ids, max_new_tokens, num_beams)
        self.waiting.append(Sequence(request_id, list(prompt_ids),
                                     max_new_tokens, sampling,
                                     num_beams=num_beams,
                                     length_penalty=length_penalty,
                                     min_new_tokens=min_new_tokens))

    def pop_finished(self) -> List[Sequence]:
        out, self.finished = self.finished, []
        return out

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running
                    or self._prefilling is not None)

    # -- one scheduling iteration (reference scheduler.cpp:369 step) --------
    def _find_contiguous(self, W: int) -> Optional[int]:
        """Base of a run of W contiguous free slots, or None."""
        free = sorted(self.free_slots)
        run = 1
        for i in range(1, len(free)):
            run = run + 1 if free[i] == free[i - 1] + 1 else 1
            if run == W:
                return free[i] - W + 1
        return free[0] if W == 1 and free else None

    def _chunk_for(self, T: int) -> Optional[int]:
        """The prefill chunk a T-token prompt gets (None = single-shot):
        single-shot when any chunk's bucket pad would cross max_len (the pad
        keys would land past the cache end)."""
        chunk = self.prefill_chunk
        if chunk is None:
            return None
        for b in range(0, T, chunk):
            e = min(b + chunk, T)
            if b + _bucket(e - b, self.buckets) > self.max_len:
                return None
        return chunk

    def _pad_end(self, T: int) -> int:
        """Furthest padded cache offset a T-token prompt's prefill writes:
        the last chunk's bucket pad end (== bucket(T) when single-shot)."""
        chunk = self._chunk_for(T)
        if chunk is None or T == 0:
            return _bucket(max(T, 1), self.buckets)
        last_b = ((T - 1) // chunk) * chunk
        return last_b + _bucket(T - last_b, self.buckets)

    def _pages_required(self, T: int, max_new_tokens: int,
                        num_beams: int = 1) -> int:
        """Worst-case page reservation for a request: prompt+max_new or the
        prefill's furthest pad offset, whichever is larger, capped at the
        per-slot table size, per beam. Shared by the never-fits rejection,
        _can_admit, _begin_prefill and _prefill_beam so the gates can never
        disagree. A beam prefill is single-shot, so its pad end is bucket(T)
        even where a plain prompt's chunks end earlier."""
        pad = _bucket(max(T, 1), self.buckets) if num_beams > 1 \
            else self._pad_end(T)
        per_beam = min(pages_needed(max(T + max_new_tokens, pad),
                                    self.page_size), self.maxp)
        return per_beam * max(num_beams, 1)

    def _can_admit(self, seq: Sequence) -> bool:
        if not self.free_slots:
            return False
        if seq.num_beams > 1 and \
                self._find_contiguous(seq.num_beams) is None:
            return False
        if self.kv_mode != "paged":
            return True
        need = self._pages_required(len(seq.prompt_ids), seq.max_new_tokens,
                                    seq.num_beams)
        return self.allocator.n_free >= need

    def _flush_table(self):
        """Copy table_np into the device page table if it changed. The
        table buffer itself is never replaced: a captured decode graph
        reads it."""
        if self.kv_mode == "paged" and self._table_dirty:
            self.cache.table.copy_(torch.from_numpy(self.table_np))
            self._table_dirty = False

    @torch.inference_mode()
    def step(self):
        """One mixed iteration: at most one prefill CHUNK plus one batched
        decode step for all running slots (reference mixed prefill+decode
        inputs, scheduler.cpp:55-98)."""
        if (self._prefilling is None and self.waiting
                and self._can_admit(self.waiting[0])
                and self.steps_decoding_for_next_prefill == 0):
            seq = self.waiting.popleft()
            if seq.num_beams > 1:
                self._prefill_beam(seq)   # a beam prefill is single-shot
            else:
                self._begin_prefill(seq)
        if self._prefilling is not None:
            self._prefill_chunk_step()
        if self.running:
            self._decode_step()
            if self.steps_decoding_for_next_prefill > 0:
                self.steps_decoding_for_next_prefill -= 1
        if self.waiting and not self._can_admit(self.waiting[0]):
            # pool full (slots or pages): decode-only until capacity frees
            self.steps_decoding_for_next_prefill = max(
                1, self.steps_decoding_for_next_prefill)

    def run_to_completion(self):
        while self.has_work:
            self.step()
        return self.pop_finished()

    # -- internals ----------------------------------------------------------
    def _reset_mu(self, seq: Sequence, slots):
        """Fresh mirostat state for newly assigned slot(s)."""
        tau = (seq.sampling or self.sampling).mirostat_tau
        for s in slots:
            self._mu[s] = 2.0 * tau

    def _sample_one(self, logits_row: torch.Tensor, seq: Sequence) -> int:
        """The first token, from the last prefill row's logits [V]: the
        min-new-tokens EOS mask, then the request's sampling (its slot's
        mirostat mu, updated)."""
        sp = seq.sampling or self.sampling
        logits_row = logits_row.to(torch.float32)
        V = logits_row.shape[-1]
        eos = [t for t in self.cfg.eos_token_ids if 0 <= t < V]
        if len(seq.output_ids) < seq.min_new_tokens and eos:
            logits_row = logits_row.clone()
            logits_row[eos] = -np.inf
        hist = None
        if sp.repeat_last_n > 0:  # 0 disables penalties (llama.cpp conv.)
            hist = torch.tensor(
                [(seq.prompt_ids + seq.output_ids)[-sp.repeat_last_n:]],
                dtype=torch.long, device=logits_row.device)
        mu = self._mu[seq.slot:seq.slot + 1]
        tok, st = sample(logits_row[None], sp, SamplerState(mu),
                         prev_tokens=hist, generator=self.gen)
        if sp.mirostat:
            mu.copy_(st.mu)
        return int(tok[0])

    # -- in-scheduler beam search (reference scheduler.cpp:99-148) ----------
    @staticmethod
    def _lp(n_new: int, penalty: float) -> float:
        # length-penalty divisor (reference logits_processor model_utils.h:404)
        return max(n_new, 1) ** penalty

    def _prefill_beam(self, seq: Sequence):
        """Admit a beam request: W contiguous slots, a single-shot prefill
        into the first, its KV copied to the others (positions [0, Tb) in
        slots mode, the prefill's pages in paged mode), and the first W
        tokens ranked from the last prompt row's logits."""
        W = seq.num_beams
        base = self._find_contiguous(W)
        slots = range(base, base + W)
        for s in slots:
            self.free_slots.remove(s)
        self._reset_mu(seq, slots)
        T = len(seq.prompt_ids)
        Tb = _bucket(T, self.buckets)
        dev = self.params.device
        toks = torch.zeros((1, Tb), dtype=torch.long)
        toks[0, :T] = torch.tensor(seq.prompt_ids)
        if self.kv_mode == "paged":
            # every beam row owns its pages exclusively (no refcounting);
            # prompt sharing and KV reorder are page-content copies
            need = self._pages_required(T, seq.max_new_tokens, W) // W
            for s in slots:
                pages = self.allocator.alloc(need)
                if pages is None:
                    raise RuntimeError("admission admitted a beam request "
                                       "the page pool cannot hold")
                self.slot_pages[s] = pages
                self.table_np[s, :] = self._trash_page
                self.table_np[s, :need] = pages
            self._table_dirty = True
        self._flush_table()
        logits = self.params(toks.to(dev),
                             torch.zeros(1, dtype=torch.long, device=dev),
                             self.cache.rows(base, 1),
                             logit_positions=torch.tensor([T - 1],
                                                          device=dev),
                             prompt_len=torch.tensor([T], device=dev))
        if self.kv_mode == "paged":
            used = self.slot_pages[base][:pages_needed(Tb, self.page_size)]
            copy_kv(self.cache, used * (W - 1),
                    [p for s in slots[1:]
                     for p in self.slot_pages[s][:len(used)]])
        else:
            copy_kv(self.cache, [base] * (W - 1), list(slots[1:]), Tb)
        eos = self.cfg.eos_token_ids
        _, top, scores = rank_beams(
            logits[0], torch.zeros(1, device=dev),
            torch.ones(1, dtype=torch.bool, device=dev),
            stop_mask(eos, logits.shape[-1], seq.min_new_tokens > 0, dev), W)
        beams = [seq.prompt_ids + [int(t)] for t in top.tolist()]
        scores = np.asarray(scores.cpu(), np.float64).copy()
        alive = np.ones(W, bool)
        done: List[Tuple[List[int], float]] = []
        for w in range(W):
            if beams[w][-1] in eos and seq.min_new_tokens <= 1:
                done.append((beams[w], scores[w] / self._lp(
                    1, seq.length_penalty)))
                alive[w] = False
                scores[w] = -1e30
        seq.beam = BeamGroup(W, base, beams, scores, alive, done, step=1)
        for w, s in enumerate(slots):
            self.lengths[s] = T
            self.prompt_lens[s] = T
            self._next_tokens[s] = beams[w][-1]
            self.running[s] = seq
        seq.first_token_time = time.time()
        seq.status = SeqStatus.DECODING
        seq.slot = base
        if seq.max_new_tokens <= 1 or not alive.any():
            self._finish_beam(seq)

    def _beam_advance(self, seq: Sequence, logits: torch.Tensor):
        """One joint top-W expansion and KV reorder of a beam group, from
        the batched step's f32 logits [B, V] on the device: only W parents,
        ids and scores come back to the host."""
        g = seq.beam
        W, base = g.width, g.base
        dev = logits.device
        parents, toks, new_scores = rank_beams(
            logits[base:base + W],
            torch.tensor(g.scores, dtype=torch.float32, device=dev),
            torch.tensor(g.alive, device=dev),
            stop_mask(self.cfg.eos_token_ids, logits.shape[-1],
                      g.step + 1 <= seq.min_new_tokens, dev), W)
        parents = parents.cpu().numpy()
        toks = toks.cpu().numpy()
        new_scores = np.asarray(new_scores.cpu(), np.float64)
        if not np.array_equal(parents, np.arange(W)):
            # rows keep their slots (and pages); contents copy from the
            # parent's, up to the token just written at offset lengths
            n = int(self.lengths[base]) + 1
            moved = [w for w in range(W) if parents[w] != w]
            if self.kv_mode == "paged":
                used = pages_needed(n, self.page_size)
                copy_kv(
                    self.cache,
                    [p for w in moved
                     for p in self.slot_pages[base + parents[w]][:used]],
                    [p for w in moved for p in self.slot_pages[base + w][:used]])
            else:
                copy_kv(self.cache, [base + parents[w] for w in moved],
                        [base + w for w in moved], n)
        g.step += 1
        new_beams, new_alive = [], np.ones(W, bool)
        for w in range(W):
            ids = g.beams[parents[w]] + [int(toks[w])]
            new_beams.append(ids)
            if int(toks[w]) in self.cfg.eos_token_ids:
                g.done.append((ids, new_scores[w] / self._lp(
                    g.step, seq.length_penalty)))
                new_alive[w] = False
                new_scores[w] = -1e30
            self.lengths[base + w] += 1
            self._next_tokens[base + w] = int(toks[w])
        g.beams, g.scores, g.alive = new_beams, new_scores, new_alive

        finish = (not g.alive.any() or g.step >= seq.max_new_tokens
                  or self.lengths[base] + 1 >= self.max_len)
        if not finish and len(g.done) >= W:
            # HF early stop: the best score left can't beat the worst kept
            # hypothesis (runtime/beam.py)
            best_alive = g.scores[g.alive].max() if g.alive.any() else -np.inf
            worst_done = sorted(g.done, key=lambda h: -h[1])[W - 1][1]
            if best_alive / self._lp(seq.max_new_tokens,
                                     seq.length_penalty) < worst_done:
                finish = True
        if finish:
            self._finish_beam(seq)

    def _finish_beam(self, seq: Sequence):
        g = seq.beam
        T = len(seq.prompt_ids)
        done = list(g.done)
        for w in range(g.width):
            if g.alive[w]:
                done.append((g.beams[w], g.scores[w] / self._lp(
                    len(g.beams[w]) - T, seq.length_penalty)))
        done.sort(key=lambda h: -h[1])
        seq.hypotheses = [(ids[T:], float(s)) for ids, s in done[:g.width]]
        seq.output_ids = list(seq.hypotheses[0][0])
        seq.status = SeqStatus.FINISHED
        seq.end_time = time.time()
        self.finished.append(seq)
        for s in range(g.base, g.base + g.width):
            self._release(s)

    def _release(self, slot: int):
        """Free a slot and, paged, its pages."""
        self.running.pop(slot, None)
        self.free_slots.append(slot)
        self.lengths[slot] = 0
        if self.kv_mode == "paged" and slot in self.slot_pages:
            self.allocator.release(self.slot_pages.pop(slot))
            self.table_np[slot, :] = self._trash_page
            self._table_dirty = True

    # -- plain requests -----------------------------------------------------
    def _begin_prefill(self, seq: Sequence):
        slot = self.free_slots.pop()
        seq.slot = slot
        self._reset_mu(seq, [slot])
        seq.status = SeqStatus.PREFILL
        seq.prefill_pos = 0
        seq.chunk = self._chunk_for(len(seq.prompt_ids))
        if self.kv_mode == "paged":
            # reserve prompt+max_new worst case up front → decode never
            # runs out of pages mid-sequence (preemption-free policy); the
            # bucket pad keys must not alias other slots' pages either
            need = self._pages_required(len(seq.prompt_ids),
                                        seq.max_new_tokens)
            pages = self.allocator.alloc(need)
            if pages is None:
                raise RuntimeError("admission admitted a request the page "
                                   "pool cannot hold")
            self.slot_pages[slot] = pages
            self.table_np[slot, :] = self._trash_page
            self.table_np[slot, :need] = pages
            self._table_dirty = True
        self._prefilling = seq

    def _prefill_chunk_step(self):
        """Advance the in-flight prefill by one chunk; on the last chunk,
        sample the first token and move the sequence to DECODING.

        The chunk [begin, end) is padded to ``begin + Tb``; offsets in
        [end, begin+Tb) hold pad keys, but lengths[slot] stays <= end, so
        attention never reads them, and real tokens overwrite each one when
        they reach its offset."""
        seq = self._prefilling
        slot = seq.slot
        T = len(seq.prompt_ids)
        begin = seq.prefill_pos
        end = min(begin + (seq.chunk or T), T)
        n = end - begin
        Tb = _bucket(n, self.buckets)
        dev = self.params.device
        toks = torch.zeros((1, Tb), dtype=torch.long)
        toks[0, :n] = torch.tensor(seq.prompt_ids[begin:end])
        self._flush_table()
        logits = self.params(toks.to(dev),
                             torch.tensor([begin], device=dev),
                             self.cache.rows(slot, 1),
                             logit_positions=torch.tensor([n - 1],
                                                          device=dev),
                             prompt_len=torch.tensor([T], device=dev))
        seq.prefill_pos = end
        self.lengths[slot] = end
        if end < T:
            return
        self._prefilling = None
        self.prompt_lens[slot] = T
        tok = self._sample_one(logits[0, -1], seq)
        seq.output_ids.append(tok)
        seq.first_token_time = time.time()
        seq.status = SeqStatus.DECODING
        self.running[slot] = seq
        self._next_tokens[slot] = tok
        self._maybe_finish(seq)

    def _block_sampling(self) -> Optional[SamplingParams]:
        """The one SamplingParams a decode block runs with, or None when
        this iteration must step one token: streaming, a prefill in flight
        or admissible, a beam group, mixed or mirostat sampling, or a
        request short of its min_new_tokens (the JAX Scheduler's
        conditions)."""
        if self.decode_block <= 1 or self.streaming \
                or self._prefilling is not None \
                or (self.waiting and self._can_admit(self.waiting[0])
                    and self.steps_decoding_for_next_prefill == 0):
            return None
        seqs = list(self.running.values())
        if any(q.num_beams > 1 for q in seqs):
            return None
        sps = {q.sampling or self.sampling for q in seqs}
        if len(sps) != 1:
            return None
        sp = next(iter(sps))
        if sp.mirostat or any(len(q.output_ids) < q.min_new_tokens
                              for q in seqs):
            return None
        return sp

    def _decode_step(self):
        self._flush_table()
        sp = self._block_sampling()
        if sp is not None:
            return self._decode_block_step(sp, self.decode_block)
        items = [(s, q) for s, q in self.running.items() if q.beam is None]
        beam_seqs = list({id(q): q for q in self.running.values()
                          if q.beam is not None}.values())
        out, logits = self._decode_sample_step()
        for slot, seq in items:
            self.lengths[slot] += 1
            t = int(out[slot])
            seq.output_ids.append(t)
            self._next_tokens[slot] = t
            self._maybe_finish(seq)
        for seq in beam_seqs:
            self._beam_advance(seq, logits)

    def _decode_sample_step(self):
        """One fused decode + sample step over every slot → (ids [B] on the
        host, the step's f32 logits [B, V] on the device). Plain rows sample on the device with
        their own SamplingParams; beam rows and idle slots take the idle
        row."""
        B = self.max_batch
        sps, mask_eos = [], []
        plain = [s for s, q in self.running.items() if q.beam is None]
        for s in range(B):
            seq = self.running.get(s) if s in plain else None
            sps.append((seq.sampling or self.sampling) if seq
                       else self._IDLE_SP)
            mask_eos.append(bool(seq)
                            and len(seq.output_ids) < seq.min_new_tokens)
        enable = []
        if any(not _is_greedy(sps[s]) for s in plain):
            enable.append("filters")
        if any(sps[s].mirostat for s in plain):
            enable.append("mirostat")
        enable = tuple(enable)
        penal = [s for s in plain
                 if sps[s].repeat_last_n > 0
                 and (sps[s].repeat_penalty != 1.0
                      or sps[s].frequency_penalty
                      or sps[s].presence_penalty)]
        RL, hist, valid = 0, None, None
        if penal:
            rl_max = max(sps[s].repeat_last_n for s in penal)
            RL = -(-rl_max // 64) * 64          # pad → bounded graph count
            h, v = _penalty_hist(
                ((s, self.running[s], sps[s].repeat_last_n) for s in penal),
                B, RL)
            hist, valid = torch.from_numpy(h), torch.from_numpy(v)
        tokens = torch.from_numpy(self._next_tokens[:, None].copy())
        lengths = torch.from_numpy(self.lengths.copy())
        plens = torch.from_numpy(self.prompt_lens.copy()) \
            if self.prefix_lm else None
        bp = batch_params(sps, mask_eos)
        eos = tuple(self.cfg.eos_token_ids)
        if enable:
            self._noise.uniform_(0.0, 1.0, generator=self.gen)
        if self._graphs is not None:
            key = (RL, enable, fuse_switches())
            g = self._graphs.get(key)
            if g is None:
                g = self._graphs[key] = _DecodeGraph(
                    self.params, self.cache, B, RL, eos, enable, self._mu,
                    self._noise, self.prefix_lm)
            tok, logits = g.run(tokens, lengths, bp, hist, valid, plens)
        else:
            dev = self.params.device
            opt = lambda t: None if t is None else t.to(dev)
            tok, logits = _decode_sample_all(
                self.params, tokens.to(dev), lengths.to(dev), self.cache,
                bp.to(dev), opt(hist), opt(valid), self._mu, self._noise,
                eos, enable, opt(plens))
        return tok.cpu().numpy(), logits

    def _block_step(self, sp: SamplingParams, rl: int, token, pos, hist,
                    valid, plen) -> _SampledStep:
        """The decode block's sampled step for ``sp``, set to this block's
        start: one per (sampling, penalty width, fusion switches), captured
        on the card on first use and reset in place after that."""
        key = (sp, rl, fuse_switches())
        st = self._blocks.get(key)
        if st is None:
            st = self._blocks[key] = _SampledStep(
                self.params, self.cache, sp, token, pos, hist, valid, plen,
                self.gen)
            if self._graphs is not None:
                st.capture()
        else:
            st.reset(token, pos, hist, valid, plen)
        return st

    def _decode_block_step(self, sp: SamplingParams, k: int):
        """k decode steps through one sampled step (sampling, penalties
        included, on the device), the ids [k, B] read back once; the host
        then keeps each request's ids up to its EOS or max_new_tokens.
        Engaged by _decode_step when :meth:`_block_sampling` allows."""
        active = list(self.running.items())
        # per-row capacity: a block writes k cache rows at lengths..+k
        room = min(self.max_len - int(self.lengths[s]) for s, _ in active)
        if room < k:
            k = 1
        dev = self.params.device
        rl = max(sp.repeat_last_n, 0)
        hist = valid = None
        if rl:
            h, v = _penalty_hist(((slot, seq, rl) for slot, seq in active),
                                 self.max_batch, rl)
            hist = torch.from_numpy(h).to(dev)
            valid = torch.from_numpy(v).to(dev)
        token = torch.from_numpy(self._next_tokens[:, None].copy()).to(dev)
        pos = torch.from_numpy(self.lengths.copy()).to(dev)
        plen = torch.from_numpy(self.prompt_lens.copy()).to(dev) \
            if self.prefix_lm else None
        st = self._block_step(sp, rl, token, pos, hist, valid, plen)
        toks = torch.stack([st.step() for _ in range(k)]).cpu().numpy()
        for slot, seq in active:
            for i in range(k):
                t = int(toks[i, slot])
                seq.output_ids.append(t)
                self.lengths[slot] += 1
                self._next_tokens[slot] = t
                self._maybe_finish(seq)
                if seq.status == SeqStatus.FINISHED:
                    break   # tokens past EOS/max_new are discarded
        # a k-block counts as k decode-only iterations for prefill-defer
        self.steps_decoding_for_next_prefill = max(
            0, self.steps_decoding_for_next_prefill - (k - 1))

    def _maybe_finish(self, seq: Sequence):
        done = (len(seq.output_ids) >= seq.max_new_tokens
                or (seq.output_ids[-1] in self.cfg.eos_token_ids
                    and len(seq.output_ids) >= seq.min_new_tokens)
                or (not self.streaming
                    and self.lengths[seq.slot] + 1 >= self.max_len))
        if not done and self.streaming \
                and self.lengths[seq.slot] >= self.max_len:
            # the row is full: compact-and-rotate this slot in place and go
            # on (stream_generate's trigger, pos >= max_len, so the two
            # give the same ids)
            shift_cache_impl(self.cache.rows(seq.slot, 1), self.inv_freqs,
                             self.cfg, self.n_keep, self.n_discard)
            self.lengths[seq.slot] -= self.n_discard
        if done:
            seq.status = SeqStatus.FINISHED
            seq.end_time = time.time()
            self.finished.append(seq)
            self._release(seq.slot)
