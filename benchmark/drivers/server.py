"""Open-loop traffic into ``ModelServer``: requests issued at their due
times by the generator's schedule, answers taken by the response callback.

Every request due in the window is followed to its end; the schedule keeps
sending, at the same rate, until the last of them has finished, or until
``drain_s`` (a minute unless the mix says otherwise) past the window. A
request that the server still holds then
(pending, waiting or running) is late, not failed: it leaves the check's
sample and the result's ``failed`` alone. One that the server no longer
holds and never answered, or answered with another count of tokens, has
failed. Requests due before the window (``lead_in_s``) warm the queue;
those due after it are sent but not measured. Each request is timed from
its due time.

The harness wraps ``server.scheduler.step`` (the scheduler's iteration,
called by the worker thread) to count the tokens each iteration makes, to
note the prompt chunk and decode rows it ran (the roofline's work
records) and, in a traced run, to start and stop the profiler between two
iterations.
"""
from __future__ import annotations

import threading
import time

from benchmark.generator import Mix

NAME = "server"


class Driver:
    clock = staticmethod(time.time)     # the wall clock of Sequence times

    def __init__(self, ctx, params, cfg):
        from neural_tpu_torch.runtime.sampling import SamplingParams
        from neural_tpu_torch.serving.server import ModelServer, Query
        self.ctx, self.Query = ctx, Query
        self.sp = SamplingParams(greedy=True, repeat_penalty=1.0)
        self.done = {}
        self.lock = threading.Lock()
        self.server = ModelServer(params, cfg, response_callback=self._cb,
                                  sampling=self.sp, **ctx.mix["server"])
        self.sched = self.server.scheduler
        self.steps = []
        self.seen = {}            # id(seq) → seq, seen waiting or prefilling
        self.window = (float("inf"), float("inf"))
        self.span = None
        self.span_at = None
        self._orig = self.sched.step
        self.sched.step = self._step

    # -- the worker thread's side -----------------------------------------
    def _cb(self, seqs):
        now = time.time()
        with self.lock:
            for q in seqs:
                self.done[q.request_id] = dict(
                    receive=q.receive_time, first=q.first_token_time,
                    end=q.end_time or now, out=list(q.output_ids))

    def _step(self):
        s = self.sched
        for q in s.waiting:
            self.seen.setdefault(id(q), q)
        before = {id(q): (len(q.output_ids), q.prefill_pos)
                  for q in list(self.seen.values()) + list(s.running.values())}
        t0 = time.time()
        if self.span_at and self.span is None and t0 >= self.span_at[0]:
            self._span_start()
        self._orig()
        t1 = time.time()
        after = {id(q): q for q in list(s.running.values())
                 + list(s.finished)}
        prefill, fills, made = [], [], 0
        for q in {**self.seen, **after}.values():
            n0, p0 = before.get(id(q), (0, 0))
            T = len(q.prompt_ids)
            if q.prefill_pos > p0:            # a prompt chunk ran
                prefill.append((p0, q.prefill_pos - p0, q.prefill_pos >= T))
            if id(q) in after:
                grew = len(q.output_ids) - n0
                made += grew
                # the first token comes from the prompt's last chunk
                if grew - (p0 < T <= q.prefill_pos) >= 1:
                    fills.append(T + len(q.output_ids) - 1)
        for q in list(self.seen.values()):
            if q.prefill_pos >= len(q.prompt_ids):
                self.seen.pop(id(q), None)
        self.steps.append(dict(t0=t0, t1=t1, made=made, prefill=prefill,
                               decode=fills))
        if self.span is not None and self.span.t1 is None \
                and t1 >= self.span_at[1]:
            self._span_stop()

    # -- the traced span: started and stopped by the worker thread, between
    # two iterations (the profiler records the device work of the thread
    # that starts it) -------------------------------------------------------
    def _span_start(self):
        from benchmark.spans import Span
        self.span = Span()
        self.span.start()
        # the span's length counts from its real start
        self.span_at = (self.span_at[0], self.clock()
                        + self.ctx.mix["trace"]["seconds"])
        self.span_first_step = len(self.steps)

    def _span_stop(self):
        self.span.stop()
        self.span_last_step = len(self.steps)

    # -- the client's side -------------------------------------------------
    def _issue(self, rid, prompt, n_out):
        self.server.issueQuery([self.Query(
            rid, prompt, max_new_tokens=n_out, sampling=self.sp,
            min_new_tokens=n_out)])

    def warm_up(self):
        """The prefill buckets the mix's lengths reach and the decode
        graph, all at once, then wait for them."""
        w = self.ctx.mix["warmup"]
        gen = Mix(self.ctx.mix, self.ctx.seed)
        for i, n in enumerate(w["prompts"]):
            ids = gen.rng.integers(gen.lo, gen.hi, size=n).tolist()
            self._issue(f"warm{i}", ids, w["output"])
        while not self.server.Empty():
            time.sleep(0.01)
        with self.lock:
            self.done.clear()

    def run_window(self, seconds: float):
        ctx = self.ctx
        mix = Mix(ctx.mix, ctx.seed, seconds)
        lead = float(ctx.mix.get("lead_in_s", 0.0))
        t_start = time.time() + 0.05
        w0, w1 = t_start + lead, t_start + lead + seconds
        self.window = (w0, w1)
        if ctx.trace:
            # the span follows the window, at the same load, once every
            # request due in it has been picked up: starting and stopping
            # the profiler stops the worker for seconds
            a = w1 + ctx.mix["trace"]["after_s"]
            self.span_at = (a, a + ctx.mix["trace"]["seconds"])
        deadline = w1 + float(ctx.mix.get("drain_s", 60.0))
        sent, measured = [], []
        self.queue = []       # (time, waiting, running), every half second
        while True:
            r = mix.next()
            due = t_start + r.due
            is_measured = r.block == mix.window_index
            if self._finished(r, mix, measured):
                break
            now = time.time()
            if now >= deadline:
                break
            while now < due:
                time.sleep(min(due - now, 0.02))
                self._sample_queue()
                if self.server.error is not None:
                    raise RuntimeError("the server's worker stopped") \
                        from self.server.error
                if self._finished(r, mix, measured):
                    break
                now = time.time()
            if self._finished(r, mix, measured):
                break
            rid = f"r{r.idx}"
            issued = time.time()
            self._issue(rid, r.prompt, r.n_out)
            rec = dict(id=rid, due=due, issued=issued, prompt=r.prompt,
                       n_out=r.n_out)
            sent.append(rec)
            if is_measured:
                measured.append(rec)
        self.server.stop()
        held = self._held()
        with self.lock:
            done = dict(self.done)
        for rec in sent:
            d = done.get(rec["id"])
            rec["late"] = d is None and rec["id"] in held
            rec["failed"] = not rec["late"] and (
                d is None or len(d["out"]) != rec["n_out"])
            if d is not None:
                rec.update(d)
        made = sum(s["made"] for s in self.steps if w0 <= s["t1"] < w1)
        last_end = max([s["t1"] for s in self.steps if s["t1"] < w1],
                       default=w1)
        return dict(kind=NAME, requests=measured, sent=sent, window=(w0, w1),
                    tokens_in_window=made, window_elapsed=seconds,
                    steps=[s for s in self.steps if w0 <= s["t0"] < w1],
                    span=self.span, span_steps=self._span_steps(),
                    launches=self.span.launches if self.span else None,
                    queue=self.queue,
                    last_step_end=last_end)

    def _held(self):
        """Ids of the requests the stopped server still holds: issued but
        not yet handed to the scheduler, waiting, in prefill, running, or
        finished but not yet delivered."""
        s = self.sched
        seqs = list(s.waiting) + list(s.running.values()) + list(s.finished)
        if s._prefilling is not None:
            seqs.append(s._prefilling)
        return ({q.id for q in self.server._pending}
                | {q.request_id for q in seqs})

    def _sample_queue(self):
        now = time.time()
        if not self.queue or now - self.queue[-1][0] >= 0.5:
            self.queue.append((now, len(self.sched.waiting),
                               len(self.sched.running)))

    def _span_steps(self):
        if self.span is None or self.span.t1 is None:
            return []
        return self.steps[self.span_first_step:self.span_last_step]

    def _finished(self, r, mix, measured):
        """Past the window, every measured request answered and the traced
        span (if any) over."""
        return (r.block > mix.window_index and self._all_done(measured)
                and (self.span_at is None or (self.span is not None
                                              and self.span.t1 is not None)))

    def _all_done(self, measured):
        with self.lock:
            return all(m["id"] in self.done for m in measured)

    def samples(self, rec, rng, min_tokens, max_requests):
        """Finished measured requests for the check: the one with the most
        served tokens, then others drawn by the seed."""
        ok = [r for r in rec["requests"] if not r["failed"] and not r["late"]]
        if not ok:
            return []
        ok.sort(key=lambda r: -len(r["out"]))
        pick, rest = [ok[0]], ok[1:]
        order = rng.permutation(len(rest)).tolist()
        n = len(ok[0]["out"])
        for i in order:
            if n >= min_tokens or len(pick) >= max_requests:
                break
            pick.append(rest[i])
            n += len(rest[i]["out"])
        return [(r["prompt"], r["out"]) for r in pick]

    def close(self):
        self.server.stop()
        self.server = self.sched = self._orig = None
        self.seen.clear()
