# Copy of repro/obs/trace.py (stdlib only).
"""Span-based fault-causality tracing for the serving stack (``repro_torch.obs``).

The paper's core claim is that local errors become *legible, propagated
events* instead of silent deadlocks. Aggregate counters (``ServeMetrics``)
prove recovery happened; they cannot reconstruct *how* — which window a
fault latched in, which slot paid the LFLR re-prefill, which replica a
request landed on after a ULFM shrink. This module adds that substrate:

* :class:`Tracer` — a thread-safe, append-only recorder of Chrome/Perfetto
  ``trace_event`` dicts. Every hot-path call is one dict build + one list
  append under a lock, built from values the host already holds (no device
  read); ``chip_smoke.py``'s traced ``lflr`` phase reports its cost per
  window step beside the untraced run's; a :class:`NullTracer`
  (the default everywhere) costs a single attribute check.
* A **trace id** is stamped on every :class:`~repro_torch.serve.queue.Request` the
  first time a :class:`~repro_torch.serve.queue.RequestQueue` accepts it — derived
  from the (unique) request id, so the id survives cross-replica re-routes
  after a replica kill and the post-mortem can stitch the two halves of the
  request's life into one causal chain.
* **Span taxonomy** (the ``cat`` field): ``request`` (submit → terminal
  response, plus first-token instants), ``sched`` (slot assignment,
  requeues), ``window`` (dispatch → retire of one decode window,
  double-buffer occupancy, window waits), ``prefill`` (chunks fed into fused
  windows, blocking prefills), ``page`` (paged-KV allocate / evict /
  reclaim), ``spec`` (draft/verify accept–reject per window), ``fault``
  (the error-word history mapped back onto host time: one event per faulted
  ``(step, slot)`` with the exact :class:`~repro_torch.core.errors.ErrorCode`
  word from ``DeviceFuture.fault_codes()``), ``recovery`` (LFLR lane begin
  → first healthy token), and ``group`` (membership lifecycle: kill / ULFM
  shrink / ledger re-route, plus the elastic events — ``fleet_stop`` when
  the whole fleet crashes, ``ledger_replay`` when a restart reconstructs
  the outstanding set from the write-ahead log, ``state_transfer`` (span,
  ``complete=True`` on success) for the background weights+page-pool copy
  a joiner receives, ``replica_join`` (span) covering warm-up → transfer →
  first exchange on the widened group, and ``autoscale`` instants for
  policy-driven grow/shrink decisions; the multihost supervisor adds
  ``epoch`` instants carrying the agreed member list), and ``host`` (the
  process-level fault domain of :mod:`repro_torch.serve.multihost`): one
  ``heartbeat`` span per worker summarising its beat stream on the
  supervisor lane — ``pid = SUPERVISOR_PID`` — plus ``host_kill`` /
  ``host_stop`` / ``host_resume`` instants for executed faults and
  ``host_suspect`` / ``host_suspect_clear`` / ``host_evict`` instants for
  the failure detector's suspect → evict ladder, each stamped with the
  observed silence and phi score).
* Export is plain ``trace_event`` JSON (``{"traceEvents": [...]}``): load it
  in Perfetto / ``chrome://tracing``, or feed it to
  :mod:`repro_torch.obs.postmortem`, which reconstructs per-request
  timelines and a fault-causality report (the JAX package's CLI
  ``scripts/trace_tool.py`` reads the same JSON). Training runs share the format through
  :func:`event_log_to_events` over the executor's ``EventLog``.

Sampling: ``Tracer(sample=0.1)`` keeps request-scoped spans for a
deterministic ~10% of requests (hash of the request id — no RNG, so a rerun
traces the same requests); engine-scoped spans (windows, faults, group
events) are always kept, because a fault on an unsampled request must still
be attributable.
"""
from __future__ import annotations

import json
import threading
import time
from typing import TYPE_CHECKING, Any, Iterable, Optional

if TYPE_CHECKING:  # pragma: no cover - typing only, avoids a serve<->obs cycle
    from ..core.resilient import EventLog

# Knuth multiplicative hash over the request id: deterministic sampling that
# is stable across reruns and uncorrelated with sequential id assignment.
_HASH_MULT = 2654435761
_HASH_MOD = 1 << 32

# tid of the engine-wide lane (window spans); slot lanes use their slot index.
ENGINE_TID = 1 << 20
# base tid of the tensor-parallel shard lanes: shard s of a TP replica emits
# its reconciliation events (``shard_fanout``) on SHARD_TID + s, so the shard
# fan-out renders as its own lane block above the engine lane.
SHARD_TID = 1 << 21


class Tracer:
    """Thread-safe recorder of ``trace_event`` dicts.

    One tracer per replica (``pid`` = replica rank); a ``ServeGroup`` gives
    each rank thread its own and merges them at export. All timestamps come
    from ``clock`` (monotonic seconds) and are stored as microseconds, the
    trace_event unit.
    """

    enabled = True

    def __init__(self, *, pid: int = 0, clock=time.monotonic,
                 sample: float = 1.0):
        if not 0.0 <= sample <= 1.0:
            raise ValueError(f"sample must be in [0, 1], got {sample}")
        self.pid = pid
        self.clock = clock
        self.sample = float(sample)
        self._lock = threading.Lock()
        self._events: list[dict] = []

    # ----------------------------------------------------------- primitives
    def emit(self, name: str, cat: str, ph: str, ts: float, *,
             dur: float = 0.0, tid: int = ENGINE_TID,
             args: Optional[dict] = None) -> None:
        """Record one event. ``ts``/``dur`` in seconds (converted to µs)."""
        ev = {"name": name, "cat": cat, "ph": ph, "ts": ts * 1e6,
              "pid": self.pid, "tid": tid}
        if ph == "X":
            ev["dur"] = max(dur, 0.0) * 1e6
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def instant(self, name: str, cat: str, *, ts: Optional[float] = None,
                tid: int = ENGINE_TID, **args) -> None:
        self.emit(name, cat, "i", self.clock() if ts is None else ts,
                  tid=tid, args=args or None)

    def span(self, name: str, cat: str, t0: float, t1: float, *,
             tid: int = ENGINE_TID, **args) -> None:
        self.emit(name, cat, "X", t0, dur=t1 - t0, tid=tid, args=args or None)

    # ------------------------------------------------------- request lifecycle
    def sampled(self, request_id: int) -> bool:
        """Deterministic per-request sampling decision."""
        if self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        return ((int(request_id) * _HASH_MULT) % _HASH_MOD
                < self.sample * _HASH_MOD)

    def start_request(self, req, now: float) -> Optional[int]:
        """Stamp-and-record a request's acceptance; returns its trace id (the
        request id — unique by the queue/ledger contract, stable across
        re-routes) or None if sampled out."""
        if not self.sampled(req.id):
            return None
        self.instant("submit", "request", ts=now, trace_id=req.id,
                     prompt_len=len(req.prompt),
                     max_new_tokens=req.max_new_tokens)
        return req.id

    def end_request(self, resp, now: float) -> None:
        """One complete span covering the request's whole life (accept →
        terminal response), reconstructed from the response's latency."""
        if resp.trace_id is None:
            return
        self.span("request", "request", now - resp.latency_s, now,
                  trace_id=resp.trace_id, status=resp.status,
                  tokens=len(resp.tokens), retries=resp.retries,
                  replica=resp.replica,
                  ttft_s=resp.ttft_s, detail=resp.detail or None)

    # --------------------------------------------------------------- queries
    @property
    def num_events(self) -> int:
        with self._lock:
            return len(self._events)

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()


class NullTracer(Tracer):
    """The default tracer: records nothing, costs one attribute check.

    Call sites guard span construction with ``if tracer.enabled:`` so the
    disabled path never builds an args dict — this is what keeps the no-op
    tracer literally free and the token stream bit-exact by construction.
    """

    enabled = False

    def __init__(self):
        super().__init__()

    def emit(self, *a, **kw) -> None:  # noqa: D102 - no-op by design
        pass

    def start_request(self, req, now):
        return None

    def end_request(self, resp, now):
        pass


NULL_TRACER = NullTracer()


# ------------------------------------------------------------------- export
def merge_traces(*tracers: Tracer) -> dict:
    """Merge tracers (e.g. one per group rank) into one trace_event JSON
    object, events sorted by timestamp."""
    events: list[dict] = []
    for tr in tracers:
        events.extend(tr.events())
    events.sort(key=lambda e: (e.get("ts", 0.0), e.get("pid", 0)))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def merge_trace_dicts(*traces: dict) -> dict:
    """Merge already-exported trace objects into one, events re-sorted.

    The crash-restart post-mortem needs this: the pre-crash fleet and the
    replayed fleet are two ``run_ranks`` invocations with two tracer sets,
    but one causal story — submits from the first incarnation pair with
    terminal spans from the second (trace ids survive the write-ahead log),
    so ``validate`` only passes on the merged object."""
    events: list[dict] = []
    for tr in traces:
        events.extend(tr.get("traceEvents", ()))
    events.sort(key=lambda e: (e.get("ts", 0.0), e.get("pid", 0)))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def dump_trace(path: str, *tracers: Tracer) -> dict:
    """Write the merged trace to ``path``; returns the trace object."""
    trace = merge_traces(*tracers)
    with open(path, "w") as f:
        json.dump(trace, f, indent=1)
        f.write("\n")
    return trace


def load_trace(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def event_log_to_events(log: "EventLog", *, pid: int = 0) -> list[dict]:
    """Convert a training executor :class:`~repro_torch.core.resilient.EventLog`
    into the same trace_event schema, so one post-mortem tool reads training
    and serving runs alike. Events carry their wall-clock ``t`` (stamped by
    the executor / ``ServeMetrics.to_event_log``) as the timestamp; the step
    duration becomes the span length."""
    out = []
    for ev in log.events:
        e = {"name": ev.kind, "cat": "train", "pid": pid, "tid": 0,
             "ts": ev.t * 1e6,
             "args": {"step": ev.step, "detail": ev.detail or None,
                      "code": ev.code, "action": ev.action}}
        if ev.duration_s:
            e["ph"] = "X"
            e["dur"] = ev.duration_s * 1e6
            # the stamp is taken at the step's *end*; the span starts earlier
            e["ts"] = (ev.t - ev.duration_s) * 1e6
        else:
            e["ph"] = "i"
        out.append(e)
    return out
