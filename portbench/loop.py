"""The benchmark's open loop: the front end that the measured window drives.

It feeds the port's own serving parts, on the wall clock:

* ``serving.scheduler.Scheduler`` stamps each request's budget when the
  request falls due (FIFO, ``observe=False``: the allocation is solved
  once at set-up, so the same work is served on every commit);
* at each chunk boundary the loop offers the queued requests, in order,
  to ``ContinuousBatchingEngine.admit_many``, one request a call, and
  stops at the first that back-pressure refuses (it is offered again at
  the next boundary);
* ``step_chunk`` then advances every live row by one chunk.

A request's first token is read at the end of its admission, the rest at
the end of the chunks that emit them. Each call into a layer runs under a
``torch.profiler.record_function`` label (``portbench.admit``,
``portbench.decode_chunk``, ``portbench.host``), so a trace can name
what the host was doing in each idle gap of the device.
"""
from __future__ import annotations

import collections
import dataclasses
import time

from torch.profiler import record_function


@dataclasses.dataclass
class Chunk:
    start: float
    end: float
    # per live row: (positions cached at the chunk's start, tokens taken)
    rows: list


class OpenLoop:
    def __init__(self, engine, scheduler, requests, make_request, t0: float):
        self.engine, self.scheduler = engine, scheduler
        self.make_request = make_request     # ours -> the port's Request
        self.t0 = t0
        self.pending = collections.deque(sorted(requests,
                                                key=lambda r: r.due))
        self.waiting: collections.deque = collections.deque()
        self.live: dict = {}                 # slot -> Request
        self.chunks: list = []
        self.admissions: list = []           # (rid, start, end, prompt len)
        self.lateness: list = []             # noticed - due, seconds
        self.queue_len: list = []            # (t, queued, live) a boundary
        self.hooks: list = []                # fn(now) at each boundary

    def now(self) -> float:
        return time.perf_counter() - self.t0

    def queued(self) -> int:
        return len(self.waiting) + len(self.scheduler)

    def _notice(self, now: float) -> None:
        while self.pending and self.pending[0].due <= now:
            r = self.pending.popleft()
            self.scheduler.admit(self.make_request(r), now, observe=False)
            self.lateness.append(now - r.due)

    def _next(self):
        if self.waiting:
            return self.waiting.popleft()
        return self.scheduler.next_request()

    def _admit(self, by_rid: dict) -> None:
        eng = self.engine
        while any(s is None for s in eng.slots):
            preq = self._next()
            if preq is None:
                return
            r = by_rid[preq.rid]
            start = self.now()
            with record_function("portbench.admit"):
                ok = eng.admit_many([(r.rid, r.prompt, preq.budget,
                                      r.max_extra)])[0]
            end = self.now()
            if not ok:
                self.waiting.appendleft(preq)
                return
            r.budget, r.admit_start = int(preq.budget), start
            r.read_times.append(end)
            self.admissions.append((r.rid, start, end, r.prompt_len))
            slot = next(i for i, s in enumerate(eng.slots)
                        if s is not None and s.rid == r.rid)
            self.live[slot] = r

    def _decode(self) -> None:
        eng = self.engine
        before = {i: (eng.slots[i].cache_len, eng.slots[i].generated)
                  for i in self.live}
        start = self.now()
        with record_function("portbench.decode_chunk"):
            finished = eng.step_chunk()
        end = self.now()
        done = {s.rid: s for s in finished}
        rows = []
        for i, r in list(self.live.items()):
            s = done.get(r.rid) or eng.slots[i]
            ctx, gen = before[i]
            n = s.generated - gen
            rows.append((ctx, n))
            r.read_times.extend([end] * n)
            if r.rid in done:
                r.tokens, r.done = list(s.tokens), True
                del self.live[i]
        self.chunks.append(Chunk(start, end, rows))

    def run_until(self, t_end: float, by_rid: dict,
                  stop=lambda loop: False) -> None:
        """Serve until the loop's clock reaches ``t_end`` (or ``stop``)."""
        while True:
            now = self.now()
            if now >= t_end or stop(self):
                return
            with record_function("portbench.host"):
                self._notice(now)
                for hook in self.hooks:
                    hook(now)
                self.queue_len.append((now, self.queued(), len(self.live)))
            self._admit(by_rid)
            if self.live:
                self._decode()
            elif not self.queued():
                nxt = self.pending[0].due if self.pending else t_end
                with record_function("portbench.host"):
                    time.sleep(max(0.0, min(nxt, t_end) - self.now()))
