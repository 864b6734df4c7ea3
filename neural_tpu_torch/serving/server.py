"""ModelServer: background continuous-batching worker with callbacks (port
of ``neural_tpu/serving/server.py``).

Mirrors the reference pybind ModelServer (application/main_pybind.cpp:150-323:
the constructor starts a worker thread, ``issueQuery`` appends to the
waiting queue, finished responses surface through a callback) — a Python
thread around the :class:`~.scheduler.Scheduler`. The worker thread is the
only one that touches the card.
"""
from __future__ import annotations

import inspect
import threading
import time
import traceback
from typing import Callable, List, Optional

import torch

from ..models.config import ModelConfig
from ..runtime.sampling import SamplingParams
from .scheduler import Scheduler, Sequence as Seq


class Query:
    """reference: Query (main_pybind.cpp:59)."""

    def __init__(self, query_id, token_ids, max_new_tokens: int = 128,
                 sampling=None, num_beams: Optional[int] = None,
                 length_penalty: Optional[float] = None,
                 min_new_tokens: Optional[int] = None):
        """Beam fields default to None = inherit the server's defaults."""
        self.id = query_id
        self.token_ids = list(token_ids)
        self.max_new_tokens = max_new_tokens
        self.sampling = sampling
        self.num_beams = num_beams
        self.length_penalty = length_penalty
        self.min_new_tokens = min_new_tokens


class ModelServer:
    def __init__(self, params=None, cfg: Optional[ModelConfig] = None,
                 response_callback: Callable[[List[Seq]], None] = None,
                 max_batch: int = 8, max_len: int = 2048,
                 sampling: Optional[SamplingParams] = None,
                 kv_dtype="bfloat16", poll_interval: float = 0.001,
                 model_path: Optional[str] = None, **server_kwargs):
        """Pass the port's decoder and its config (``params`` is a
        :class:`~neural_tpu_torch.models.transformer.Transformer`). The
        reference server kwargs are accepted: ctx_size → max_len,
        max_request_num/batch_size → max_batch, memory_dtype ("auto"/"f16"
        → bf16, "int8"), max_new_tokens, kv_mode ("slots"/"paged"),
        page_size, prefill_chunk, decode_block, seed (the Scheduler's
        draws); do_sample / temperature / top_k / top_p /
        repetition_penalty → the default sampling; num_beams /
        length_penalty / min_new_tokens → the defaults for queries that set
        none (beam requests run inside the batched step, reference
        scheduler.cpp:99-148); shift_roped_k → StreamingLLM slots, with
        n_keep (a negative value means 4 sinks) and n_discard (a negative
        value means the default, half the non-sink window). ``threads``,
        ``scratch_size_ratio``, ``continuous_batching`` (always on),
        ``print_log``, ``early_stopping`` (the HF can't-be-beaten stop is
        always on) and ``return_prompt`` are accepted and ignored, as the
        JAX package does.

        ``model_path`` (checkpoint loading) is not ported yet and raises
        (ROADMAP A10)."""
        if model_path is not None:
            raise NotImplementedError("ModelServer(model_path=...) needs "
                                      "init_from_bin, a later slice "
                                      "(ROADMAP A10); pass params and cfg")
        if params is None or cfg is None:
            raise ValueError("pass params (the decoder) and cfg")
        kw = dict(server_kwargs)
        max_len = kw.pop("ctx_size", max_len) or max_len
        max_batch = max(kw.pop("max_request_num", max_batch),
                        kw.pop("batch_size", 1))
        md = kw.pop("memory_dtype", None)
        if md is not None:
            kv_dtype = "int8" if md == "int8" else "bfloat16"
        self.default_max_new_tokens = kw.pop("max_new_tokens", 128)
        if sampling is None and (kw.get("do_sample") or "temperature" in kw
                                 or "top_k" in kw or "top_p" in kw
                                 or "repetition_penalty" in kw):
            sampling = SamplingParams(
                greedy=not kw.pop("do_sample", False),
                temperature=kw.pop("temperature", 0.8),
                top_k=kw.pop("top_k", 40), top_p=kw.pop("top_p", 0.95),
                repeat_penalty=kw.pop("repetition_penalty", 1.1))
        self.default_num_beams = kw.pop("num_beams", 1)
        self.default_length_penalty = kw.pop("length_penalty", 1.0)
        self.default_min_new_tokens = kw.pop("min_new_tokens", 0)
        sched_kw = {k: kw.pop(k) for k in ("kv_mode", "page_size",
                                           "prefill_chunk", "decode_block",
                                           "seed") if k in kw}
        sched_kw["streaming"] = bool(kw.pop("shift_roped_k", False))
        n_keep = kw.pop("n_keep", 4)
        n_discard = kw.pop("n_discard", None)
        # reference: n_keep -1 keeps the whole prompt, which depends on the
        # request; a server keeps 4 sinks instead
        sched_kw["n_keep"] = 4 if n_keep < 0 else n_keep
        sched_kw["n_discard"] = None if n_discard is not None \
            and n_discard < 0 else n_discard
        for ignored in ("threads", "scratch_size_ratio",
                        "continuous_batching", "print_log", "early_stopping",
                        "do_sample", "temperature", "top_k", "top_p",
                        "repetition_penalty", "pad_token", "init_cb",
                        "return_prompt"):
            kw.pop(ignored, None)
        if kw:
            raise TypeError(f"unknown server kwargs: {sorted(kw)}")
        kv = torch.int8 if kv_dtype in ("int8", torch.int8) else \
            torch.bfloat16
        self.scheduler = Scheduler(params, cfg, max_batch=max_batch,
                                   max_len=max_len, sampling=sampling,
                                   kv_dtype=kv, **sched_kw)
        self.callback = response_callback
        self._cb_arity = 1
        if response_callback is not None:
            try:  # 2-arg reference form iff (finished, working) can bind
                inspect.signature(response_callback).bind([], 0)
                self._cb_arity = 2
            except (TypeError, ValueError):
                self._cb_arity = 1
        self.poll_interval = poll_interval
        self._lock = threading.Lock()
        self._pending: List[Query] = []
        self._draining = False   # queries popped from _pending but not yet
        #                          in the scheduler (Empty() must see them)
        self._outstanding = 0    # issued but not yet delivered (finished
        #                          list / callback) — the Empty() invariant
        self.finished: List[Seq] = []  # drained here when no callback
        self.error: Optional[BaseException] = None
        self._running = True
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def issueQuery(self, queries, token_ids=None):
        """Thread-safe enqueue (main_pybind.cpp:230). Accepts a list of
        Query objects, a single Query, or the reference's
        ``issueQuery(index, token_ids)`` form (__init__.py:549). A query the
        scheduler can never serve raises here, in the caller's thread."""
        if token_ids is not None:
            queries = [Query(queries, token_ids,
                             self.default_max_new_tokens)]
        elif isinstance(queries, Query):
            queries = [queries]
        for q in queries:
            self.scheduler.validate(q.token_ids, q.max_new_tokens,
                                    self._num_beams(q))
        with self._lock:
            self._pending.extend(queries)
            self._outstanding += len(queries)

    def _num_beams(self, q: Query) -> int:
        return q.num_beams or self.default_num_beams

    def Empty(self) -> bool:
        """True iff every issued query has been DELIVERED (callback fired
        or drained into .finished). Raises the worker's error if it
        stopped on one, so a client polling Empty() never waits on a dead
        worker."""
        with self._lock:
            if self.error is not None:
                raise RuntimeError("the server's worker stopped") \
                    from self.error
            return (not self._pending and not self._draining
                    and self._outstanding == 0
                    and not self.scheduler.has_work)

    def stop(self):
        self._running = False
        self._worker.join(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    def _loop(self):
        try:
            while self._running:
                self._iteration()
        except Exception as e:  # the worker's boundary: report, then stop
            traceback.print_exc()
            with self._lock:
                self.error = e

    def _iteration(self):
        with self._lock:
            pending, self._pending = self._pending, []
            self._draining = bool(pending)
        for q in pending:
            self.scheduler.add_request(
                q.id, q.token_ids, q.max_new_tokens, sampling=q.sampling,
                num_beams=self._num_beams(q),
                length_penalty=q.length_penalty
                or self.default_length_penalty,
                min_new_tokens=q.min_new_tokens
                or self.default_min_new_tokens)
        if pending:
            with self._lock:
                self._draining = False
        if not self.scheduler.has_work:
            time.sleep(self.poll_interval)
            return
        self.scheduler.step()
        done = self.scheduler.pop_finished()
        if not done:
            return
        if self.callback is not None:
            # reference callback signature is response(finished,
            # working_size) (main_pybind.cpp:209-220); 1-arg callbacks get
            # just the finished list
            if self._cb_arity >= 2:
                working = (len(self.scheduler.running)
                           + len(self.scheduler.waiting))
                self.callback(done, working)
            else:
                self.callback(done)
            with self._lock:
                self._outstanding -= len(done)
        else:
            with self._lock:
                self.finished.extend(done)
                self._outstanding -= len(done)
