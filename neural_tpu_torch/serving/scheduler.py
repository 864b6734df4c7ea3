"""Iteration-level continuous batching (port of
``neural_tpu/serving/scheduler.py`` for greedy, non-beam requests).

A fixed pool of B cache slots; prompts prefill into one slot at a time, a
chunk per iteration, each chunk padded to a bucket length; one batched
[B, 1] decode step advances every running slot per iteration. The KV cache
is either one contiguous ``[L, B, Hkv, S, Dh]`` buffer (``kv_mode="slots"``)
or a shared page pool with a page table per slot (``kv_mode="paged"``),
bf16 or int8.

On the card the decode step — forward and batched sampling — is one CUDA
graph per penalty-history width (:class:`_DecodeGraph`): the JAX package
runs it as one jitted executable (``_decode_sample_all``), and launched
eagerly from Python the step would be bound by the host. The host fills
the graph's static inputs (tokens, lengths, sampling rows, penalty
history, and for a prefix-LM model the per-slot prompt lengths), replays
it and reads back [B] ids; the page table is the cache's own device
buffer, rewritten in place. Prefill chunks run eagerly. A prefix-LM model
(ChatGLM-1) prefills single-shot, as in the JAX package (its prefix mask
needs the whole prompt); in paged mode its prefix mask reaches K3 too,
where the JAX Scheduler's paged prefill is causal.

Not ported here (they raise; ROADMAP A9): beam search in the scheduler,
StreamingLLM slots, ``decode_block > 1`` and stochastic sampling. The TPU's
decode block-size hint (``pick_decode_blk``) and the weight-residency policy
(``ensure_decode_residency``) have no counterpart: the port's kernels take
no block size, and its weights are native-packed once at load.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from enum import Enum
from typing import Dict, List, Optional, Sequence as Seq

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.transformer import fuse_switches
from ..ops import _cuda
from ..runtime.kvcache import init_cache
from ..runtime.paged import PageAllocator, init_paged_cache, pages_needed
from ..runtime.sampling import (BatchedSamplingParams, SamplingParams,
                                batch_params, sample, sample_batched)


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
    min_new_tokens: int = 0


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


def _decode_sample_all(model, tokens, lengths, cache, bp, hist, valid,
                       eos_ids: tuple, prompt_len=None):
    """One decode step for every slot plus the batched greedy sampling:
    tokens [B, 1] at offsets lengths [B] (a prefix-LM model's per-slot
    ``prompt_len`` [B]) → ids [B] int32; the cache is written in place.
    Inactive slots still compute (static shapes): their ids are ignored and
    their cache rows overwritten on the next prefill."""
    logits = model(tokens, lengths, cache, prompt_len=prompt_len)
    return sample_batched(logits[:, -1], bp, eos_ids=eos_ids,
                          prev_tokens=hist, prev_valid=valid, enable=())[0]


class _DecodeGraph:
    """:func:`_decode_sample_all` captured in a CUDA graph, with static
    input buffers for one penalty-history width RL (0: no penalties).

    Captured on its first :meth:`run`, once the buffers hold that step's
    real inputs: the capture protocol runs the step once eagerly on a side
    stream, and the replay that follows writes the same KV slots with the
    same values, so the step is not taken twice. Any failure to capture
    raises; there is no eager fallback. The capture takes the path of the
    fusion switches (``models.transformer.fuse_switches``) as they stand:
    the Scheduler keeps one graph per penalty width and switches, so a
    switch flipped between steps captures a new graph and never replays
    one of the other path."""

    def __init__(self, model, cache, B: int, RL: int, eos_ids: tuple,
                 prefix_lm: bool = False):
        dev = model.device
        self.model, self.cache, self.eos_ids = model, cache, eos_ids
        self.tokens = torch.zeros((B, 1), dtype=torch.long, device=dev)
        self.lengths = torch.zeros(B, dtype=torch.long, device=dev)
        self.prompt_len = torch.zeros(B, dtype=torch.long, device=dev) \
            if prefix_lm else None
        self.bp = batch_params([SamplingParams(greedy=True)] * B).to(dev)
        self.hist = self.valid = None
        if RL:
            self.hist = torch.zeros((B, RL), dtype=torch.int32, device=dev)
            self.valid = torch.zeros((B, RL), dtype=torch.bool, device=dev)
        self.graph = None
        self.out = None
        self.launches = {}   # kernel launches of one replay

    def _step(self):
        return _decode_sample_all(self.model, self.tokens, self.lengths,
                                  self.cache, self.bp, self.hist, self.valid,
                                  self.eos_ids, self.prompt_len)

    def _capture(self):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self._step()
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        self.out, self.launches = _cuda.capture(self.graph, self._step)

    def run(self, tokens: torch.Tensor, lengths: torch.Tensor,
            bp: BatchedSamplingParams, hist, valid,
            prompt_len=None) -> np.ndarray:
        self.tokens.copy_(tokens)
        self.lengths.copy_(lengths)
        if self.prompt_len is not None:
            self.prompt_len.copy_(prompt_len)
        self.bp.copy_(bp)
        if self.hist is not None:
            self.hist.copy_(hist)
            self.valid.copy_(valid)
        if self.graph is None:
            self._capture()
        self.graph.replay()
        _cuda.add_launches(self.launches)
        return self.out.cpu().numpy()


class Scheduler:
    """FCFS continuous-batching scheduler (reference scheduler.cpp:278).

    Usage: add_request(...) any time; step() runs one iteration (at most one
    prefill chunk plus one batched decode); poll finished sequences with
    pop_finished(). ``params`` is the port's decoder
    (:class:`~neural_tpu_torch.models.transformer.Transformer`); caches
    live on its device.
    """

    #: inactive slots sample with this trivial config (argmax, no state) —
    #: their tokens are discarded, so give them the cheapest row
    _IDLE_SP = SamplingParams(greedy=True, repeat_penalty=1.0,
                              repeat_last_n=0)

    def __init__(self, params, cfg: ModelConfig, max_batch: int = 8,
                 max_len: int = 2048,
                 sampling: Optional[SamplingParams] = None,
                 kv_dtype=torch.bfloat16,
                 prefill_buckets: Seq[int] = (32, 64, 128, 256, 512,
                                              1024, 2048),
                 kv_mode: str = "slots", page_size: int = 256,
                 n_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = 512,
                 streaming: bool = False, decode_block: int = 1):
        """``kv_mode="paged"``: shared page pool + per-slot page tables
        (runtime/paged.py). ``n_pages`` sizes the pool below worst case
        (default batch·max_len/page_size); admission defers when the pool
        can't cover a request's prompt+max_new reservation.

        ``prefill_chunk``: long prompts prefill in chunks of this many
        tokens, with a batched decode step interleaved after every chunk
        (the mixed prefill+decode iteration of the reference worker,
        scheduler.cpp:55-98). None = single-shot prefill.

        ``streaming`` and ``decode_block > 1`` are the JAX Scheduler's
        StreamingLLM slots and multi-token decode blocks; they raise here."""
        if streaming:
            raise NotImplementedError("StreamingLLM serving slots are a "
                                      "later slice (ROADMAP A9)")
        if decode_block > 1:
            raise NotImplementedError("decode_block > 1 is a later slice "
                                      "(ROADMAP A9)")
        self.sampling = sampling or SamplingParams(greedy=True)
        self._check_sampling(self.sampling)
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
        self.waiting: deque[Sequence] = deque()
        self.running: Dict[int, Sequence] = {}     # slot → seq
        self.finished: List[Sequence] = []
        self.free_slots = list(range(max_batch))[::-1]
        self._next_tokens = np.zeros(max_batch, np.int64)
        self.steps_decoding_for_next_prefill = 0  # reference scheduler.cpp:355
        # decode-step graphs by penalty width and fusion switches; None runs
        # the step eagerly, as on the CPU
        self._graphs: Optional[Dict[tuple, _DecodeGraph]] = \
            {} if dev.type == "cuda" else None

    # -- client API ---------------------------------------------------------
    @staticmethod
    def _check_sampling(sp: SamplingParams):
        if not _is_greedy(sp) or sp.mirostat:
            raise NotImplementedError(
                "stochastic sampling in the scheduler is a later slice "
                "(ROADMAP A9); use SamplingParams(greedy=True)")

    def validate(self, prompt_ids: Seq[int], max_new_tokens: int = 128,
                 sampling: Optional[SamplingParams] = None,
                 num_beams: int = 1):
        """Raise for a request this scheduler can never serve. Reads only
        the configuration, so a client thread may call it."""
        if num_beams > 1:
            raise NotImplementedError("beam search in the scheduler is a "
                                      "later slice (ROADMAP A9)")
        self._check_sampling(sampling or self.sampling)
        if not prompt_ids:
            raise ValueError("a request needs at least one prompt token")
        if len(prompt_ids) + max_new_tokens > self.max_len:
            raise ValueError(f"request exceeds max_len: {len(prompt_ids)} "
                             f"prompt + {max_new_tokens} new > "
                             f"{self.max_len}")
        if self.kv_mode == "paged":
            # reject requests the pool can NEVER satisfy — otherwise
            # admission defers forever and run_to_completion() livelocks.
            # Same worst-case formula as _can_admit / _begin_prefill.
            need = self._pages_required(len(prompt_ids), max_new_tokens)
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
                    num_beams: int = 1, min_new_tokens: int = 0):
        """``sampling`` overrides the scheduler default for this request
        (reference: per-query generation config in Query)."""
        self.validate(prompt_ids, max_new_tokens, sampling, num_beams)
        self.waiting.append(Sequence(request_id, list(prompt_ids),
                                     max_new_tokens, sampling,
                                     min_new_tokens=min_new_tokens))

    def pop_finished(self) -> List[Sequence]:
        out, self.finished = self.finished, []
        return out

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running
                    or self._prefilling is not None)

    # -- one scheduling iteration (reference scheduler.cpp:369 step) --------
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

    def _pages_required(self, T: int, max_new_tokens: int) -> int:
        """Worst-case page reservation for a request: prompt+max_new or the
        prefill's furthest pad offset, whichever is larger, capped at the
        per-slot table size. Shared by the never-fits rejection,
        _can_admit and _begin_prefill so the gates can never disagree."""
        return min(pages_needed(max(T + max_new_tokens, self._pad_end(T)),
                                self.page_size), self.maxp)

    def _can_admit(self, seq: Sequence) -> bool:
        if not self.free_slots:
            return False
        if self.kv_mode != "paged":
            return True
        need = self._pages_required(len(seq.prompt_ids), seq.max_new_tokens)
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
            self._begin_prefill(self.waiting.popleft())
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
    def _sample_one(self, logits_row: torch.Tensor, seq: Sequence) -> int:
        """The first token, from the last prefill row's logits [V]: the
        min-new-tokens EOS mask, the request's penalties, the argmax."""
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
        return int(sample(logits_row[None], sp, prev_tokens=hist)[0][0])

    def _begin_prefill(self, seq: Sequence):
        slot = self.free_slots.pop()
        seq.slot = slot
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

    def _decode_step(self):
        self._flush_table()
        items = list(self.running.items())
        out = self._decode_sample_step()
        for slot, seq in items:
            self.lengths[slot] += 1
            t = int(out[slot])
            seq.output_ids.append(t)
            self._next_tokens[slot] = t
            self._maybe_finish(seq)

    def _decode_sample_step(self) -> np.ndarray:
        """One fused decode + sample step over every slot → [B] ids. Only
        the [B] ids come back to the host, never the [B, V] logits."""
        B = self.max_batch
        sps, mask_eos = [], []
        for s in range(B):
            seq = self.running.get(s)
            sps.append((seq.sampling or self.sampling) if seq
                       else self._IDLE_SP)
            mask_eos.append(bool(seq)
                            and len(seq.output_ids) < seq.min_new_tokens)
        penal = [s for s in self.running
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
        if self._graphs is not None:
            key = (RL, fuse_switches())
            g = self._graphs.get(key)
            if g is None:
                g = self._graphs[key] = _DecodeGraph(self.params, self.cache,
                                                     B, RL, eos,
                                                     self.prefix_lm)
            return g.run(tokens, lengths, bp, hist, valid, plens)
        dev = self.params.device
        opt = lambda t: None if t is None else t.to(dev)
        out = _decode_sample_all(self.params, tokens.to(dev),
                                 lengths.to(dev), self.cache, bp.to(dev),
                                 opt(hist), opt(valid), eos, opt(plens))
        return out.cpu().numpy()

    def _maybe_finish(self, seq: Sequence):
        done = (len(seq.output_ids) >= seq.max_new_tokens
                or (seq.output_ids[-1] in self.cfg.eos_token_ids
                    and len(seq.output_ids) >= seq.min_new_tokens)
                or self.lengths[seq.slot] + 1 >= self.max_len)
        if not done:
            return
        seq.status = SeqStatus.FINISHED
        seq.end_time = time.time()
        self.finished.append(seq)
        self.running.pop(seq.slot, None)
        self.free_slots.append(seq.slot)
        self.lengths[seq.slot] = 0
        if self.kv_mode == "paged" and seq.slot in self.slot_pages:
            self.allocator.release(self.slot_pages.pop(seq.slot))
            self.table_np[seq.slot, :] = self._trash_page
            self._table_dirty = True
