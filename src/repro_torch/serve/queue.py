# Copy of repro/serve/queue.py: the request types and the EDF queue, with its tracer hooks.
"""Request/response types, admission control and the deadline-aware queue.

The serving analogue of the paper's contract is applied at the *request*
granularity: a request either gets an answer or an explicit terminal status —
never a silent drop, never a hang. Statuses:

* ``OK``       — decoded to completion;
* ``REJECTED`` — refused at admission (queue full / does not fit the cache);
* ``EXPIRED``  — deadline passed before completion;
* ``FAILED``   — unrecoverable after the retry budget (poisoned cache that
  re-faults on every recompute — the serving counterpart of ABORT).

The queue orders by earliest deadline first (EDF) with FIFO tie-break, and is
thread-safe because a :class:`~repro_torch.serve.group.ServeGroup` re-routes a
dead replica's requests into survivor queues from other rank threads.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

from ..obs.trace import NULL_TRACER, Tracer


# Terminal request statuses.
OK = "ok"
REJECTED = "rejected"
EXPIRED = "expired"
FAILED = "failed"


@dataclass
class Request:
    """One generation request (mutable: the scheduler tracks retries on it)."""

    id: int
    prompt: tuple[int, ...]
    max_new_tokens: int = 16
    deadline: Optional[float] = None     # absolute, in the queue's clock domain
    arrival_t: Optional[float] = None    # stamped once by RequestQueue.submit
    retries: int = 0                     # LFLR recomputes consumed so far
    trace_id: Optional[int] = None       # stamped once by RequestQueue.submit
                                         # (None = untraced / sampled out);
                                         # survives re-routes, requeues and
                                         # the WAL, so a post-mortem sees one
                                         # causal chain

    def __post_init__(self):
        self.prompt = tuple(int(t) for t in self.prompt)
        if not self.prompt:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")

    @property
    def total_len(self) -> int:
        return len(self.prompt) + self.max_new_tokens


@dataclass(frozen=True)
class Response:
    """Terminal answer for one request."""

    id: int
    status: str                          # OK | REJECTED | EXPIRED | FAILED
    tokens: tuple[int, ...] = ()         # generated tokens (no prompt)
    latency_s: float = 0.0               # submit → terminal
    ttft_s: Optional[float] = None       # submit → first generated token
    retries: int = 0                     # faults recovered while serving it
    replica: Optional[int] = None        # rank that answered it
    detail: str = ""
    trace_id: Optional[int] = None       # the request's trace id, if traced

    @property
    def ok(self) -> bool:
        return self.status == OK


@dataclass(frozen=True)
class AdmissionPolicy:
    """Static admission checks, applied before a request ever holds a slot."""

    max_queue: int = 256
    max_total_len: int = 4096            # prompt + max_new must fit the cache

    def reject_reason(self, req: Request, queue_len: int) -> Optional[str]:
        if queue_len >= self.max_queue:
            return f"queue full ({queue_len}/{self.max_queue})"
        if req.total_len > self.max_total_len:
            return (f"request needs {req.total_len} cache positions, "
                    f"capacity is {self.max_total_len}")
        return None


class RequestQueue:
    """Deadline-aware (EDF) admission queue.

    ``submit`` returns ``None`` on acceptance or a terminal ``REJECTED``
    response; ``pop`` returns the most urgent request that can still meet its
    deadline and reports the ones that cannot via ``drain_expired``.
    """

    def __init__(self, policy: AdmissionPolicy | None = None, *,
                 clock: Callable[[], float] = time.monotonic,
                 tracer: Tracer | None = None):
        self.policy = policy or AdmissionPolicy()
        self.clock = clock
        self.tracer = tracer or NULL_TRACER
        self._lock = threading.Lock()
        self._heap: list[tuple[float, int, Request]] = []
        self._seq = itertools.count()
        self._rseq = itertools.count(-1, -1)   # requeue: ahead of same-deadline
        self._expired: list[Request] = []

    def __len__(self) -> int:
        with self._lock:
            return len(self._heap)

    def submit(self, req: Request) -> Optional[Response]:
        now = self.clock()
        with self._lock:
            reason = self.policy.reject_reason(req, len(self._heap))
            if reason is not None:
                if self.tracer.enabled:
                    self.tracer.instant("reject", "request", ts=now,
                                        request_id=req.id, reason=reason)
                return Response(id=req.id, status=REJECTED, detail=reason)
            stamp = req.arrival_t is None
            if stamp:
                # stamp once: a re-submitted request keeps its original
                # acceptance time, so latency/TTFT include the whole delay,
                # and its trace id, so a post-mortem stitches both replicas
                # into one causal chain
                req.arrival_t = now
            key = req.deadline if req.deadline is not None else float("inf")
            heapq.heappush(self._heap, (key, next(self._seq), req))
        if stamp and self.tracer.enabled and req.trace_id is None:
            req.trace_id = self.tracer.start_request(req, now)
        elif not stamp and self.tracer.enabled and req.trace_id is not None:
            # re-submission of an accepted request (a ledger re-route after
            # a kill): a causal hop, not a new request
            self.tracer.instant("resubmit", "request", ts=now,
                                trace_id=req.trace_id)
        return None

    def requeue(self, req: Request) -> None:
        """Put an *already accepted* request back in the queue, ahead of its
        deadline class (negative sequence keys sort before every submitted
        entry with the same deadline, newest requeue first).

        The zero-drop re-queue path: admission checks are bypassed (the
        request was admitted once and must eventually get a terminal
        answer), and ``arrival_t`` is kept, so latency and TTFT span the
        preemption. Used when a slot is preempted, e.g. by paged-KV
        eviction under memory pressure."""
        if req.arrival_t is None:
            raise ValueError("requeue is for accepted requests")
        if self.tracer.enabled and req.trace_id is not None:
            self.tracer.instant("requeue", "sched", trace_id=req.trace_id)
        with self._lock:
            key = req.deadline if req.deadline is not None else float("inf")
            heapq.heappush(self._heap, (key, next(self._rseq), req))

    def submit_all(self, reqs: Iterable[Request]) -> list[Response]:
        """Submit many; returns the rejections (accepted ones return later)."""
        out = []
        for r in reqs:
            resp = self.submit(r)
            if resp is not None:
                out.append(resp)
        return out

    def pop(self, now: Optional[float] = None) -> Optional[Request]:
        """Earliest-deadline request still able to start; expired ones are set
        aside for ``drain_expired``."""
        now = self.clock() if now is None else now
        with self._lock:
            while self._heap:
                deadline, _, req = heapq.heappop(self._heap)
                if req.deadline is not None and now >= req.deadline:
                    self._expired.append(req)
                    continue
                return req
            return None

    def drain_expired(self, now: Optional[float] = None) -> list[Request]:
        """All queued requests whose deadline has passed (removed from queue)."""
        now = self.clock() if now is None else now
        with self._lock:
            keep: list[tuple[float, int, Request]] = []
            for entry in self._heap:
                req = entry[2]
                if req.deadline is not None and now >= req.deadline:
                    self._expired.append(req)
                else:
                    keep.append(entry)
            heapq.heapify(keep)
            self._heap = keep
            out, self._expired = self._expired, []
            return out
