# Trimmed copy of repro/serve/metrics.py: the counters of the stepwise, window, overlap, paged and speculative engines.
"""Serving metrics: per-request latency, throughput, fault counters.

Feeds the same :class:`~repro_torch.core.resilient.EventLog` record the
training executor uses, so one post-mortem tool reads both kinds of run.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..core.errors import ErrorCode
from ..core.resilient import Event, EventLog
from .queue import OK, Response


@dataclass
class FaultRecord:
    step: int
    code: int
    action: str
    slots: tuple[int, ...] = ()
    t: float = 0.0               # wall clock (metrics clock) of detection


class ServeMetrics:
    """Thread-safe accumulator for one replica."""

    def __init__(self, clock=time.monotonic):
        self._lock = threading.Lock()
        self.clock = clock
        self.responses: list[Response] = []
        self._resp_t: list[float] = []       # completion wall time per response
        self.faults: list[FaultRecord] = []
        self.decode_steps = 0
        self.prefills = 0
        self.decode_tokens = 0               # all committed tokens (incl. the
                                             # first one, from prefill logits)
        self._t0: Optional[float] = None
        self._t_last: Optional[float] = None
        self.windows = 0                     # decode windows retired
        self.discarded_tokens = 0            # trailing tokens dropped at window
                                             # boundaries (EOS/budget/fault)
        self.prefill_chunks = 0              # prompt chunks fused into windows
        self.prefill_chunk_tokens = 0        # prompt tokens fed via chunks
        self.host_stalls = 0                 # blocking prefills (admission/LFLR
        self.host_stall_s = 0.0              # that froze the dispatch loop)
        self.window_waits = 0                # windows not yet done at retire
                                             # (device-bound, host keeping up)
        self.peak_active_slots = 0           # most lanes concurrently serving
        self.pages_allocated = 0             # paged KV: pages granted
        self.pages_freed = 0                 # pages reclaimed
        self.peak_pages_in_use = 0           # high-water mark of the pool
        self.page_evictions = 0              # lanes preempted for pages
        self.draft_tokens = 0                # speculation: tokens proposed by
                                             # the shallow-exit drafter
        self.accepted_draft_tokens = 0       # ... accepted by the verify
                                             # (DRAFT_REJECT carries the
                                             # misses in-band)
        self._spec_per_slot: dict[int, list] = {}   # slot -> [drafted, accepted]

    # ------------------------------------------------------------- recording
    def record_step(self, committed_tokens: int) -> None:
        with self._lock:
            self._tick()
            self.decode_steps += 1
            self.decode_tokens += committed_tokens

    def record_window(self, committed_tokens: int, discarded_tokens: int,
                      window: int) -> None:
        """One retired decode window: K deferred device steps, one host sync."""
        with self._lock:
            self._tick()
            self.windows += 1
            self.decode_steps += window
            self.decode_tokens += committed_tokens
            self.discarded_tokens += discarded_tokens

    def record_prefill(self, committed_tokens: int = 1) -> None:
        """A (re-)prefill that committed its first token from prefill logits."""
        with self._lock:
            self._tick()
            self.prefills += 1
            self.decode_tokens += committed_tokens

    def record_chunk(self, tokens_fed: int) -> None:
        """A prompt chunk fused into a decode window (overlapped prefill)."""
        with self._lock:
            self._tick()
            self.prefill_chunks += 1
            self.prefill_chunk_tokens += tokens_fed

    def record_host_stall(self, seconds: float) -> None:
        """Wall time the dispatch loop spent blocked on a synchronous prefill
        — the stall the overlapped engine exists to eliminate."""
        with self._lock:
            self.host_stalls += 1
            self.host_stall_s += max(0.0, seconds)

    def record_window_wait(self) -> None:
        """A window that was still computing when the host came to retire it."""
        with self._lock:
            self.window_waits += 1

    def record_pages(self, *, allocated: int = 0, freed: int = 0,
                     in_use: int = 0) -> None:
        """Paged-KV ledger movement (allocation / reclamation + high-water)."""
        with self._lock:
            self.pages_allocated += allocated
            self.pages_freed += freed
            self.peak_pages_in_use = max(self.peak_pages_in_use, in_use)

    def record_page_eviction(self) -> None:
        """A lane preempted (and requeued) to free pages under pressure."""
        with self._lock:
            self.page_evictions += 1

    def record_spec(self, drafted: int, accepted: int,
                    per_slot: Optional[dict] = None) -> None:
        """One retired speculative window's drafts and accepts; ``per_slot``
        maps slot -> (drafted, accepted), so a lane that always rejects
        shows as itself, not only in the global rate."""
        with self._lock:
            self.draft_tokens += drafted
            self.accepted_draft_tokens += accepted
            for slot, (d, a) in (per_slot or {}).items():
                cell = self._spec_per_slot.setdefault(slot, [0, 0])
                cell[0] += d
                cell[1] += a

    def record_active_slots(self, n: int) -> None:
        with self._lock:
            self.peak_active_slots = max(self.peak_active_slots, n)

    def _tick(self) -> None:
        now = self.clock()
        if self._t0 is None:
            self._t0 = now
        self._t_last = now

    def record_response(self, resp: Response) -> None:
        with self._lock:
            self.responses.append(resp)
            self._resp_t.append(self.clock())

    def record_fault(self, step: int, code: int | ErrorCode, action: str,
                     slots: tuple[int, ...] = ()) -> None:
        with self._lock:
            self.faults.append(FaultRecord(step, int(code), action, slots,
                                           t=self.clock()))

    # --------------------------------------------------------------- queries
    def by_status(self) -> dict[str, int]:
        with self._lock:
            out: dict[str, int] = {}
            for r in self.responses:
                out[r.status] = out.get(r.status, 0) + 1
            return out

    def fault_counts(self) -> dict[str, int]:
        """Faults keyed by ErrorCode class name."""
        with self._lock:
            out: dict[str, int] = {}
            for f in self.faults:
                for cls in ErrorCode(f.code).classes() or [ErrorCode.OK]:
                    out[cls.name] = out.get(cls.name, 0) + 1
            return out

    def tokens_per_s(self) -> float:
        """Committed tokens per wall second, first to last retired window."""
        with self._lock:
            if self._t0 is None or self._t_last is None or self._t_last <= self._t0:
                return 0.0
            return self.decode_tokens / (self._t_last - self._t0)

    def tokens_per_step(self) -> float:
        with self._lock:
            if not self.decode_steps:
                return 0.0
            return self.decode_tokens / self.decode_steps

    def acceptance_rate(self) -> float:
        """Fraction of the drafted tokens the full-model verify accepted."""
        with self._lock:
            if not self.draft_tokens:
                return 0.0
            return self.accepted_draft_tokens / self.draft_tokens

    def acceptance_rate_per_slot(self) -> dict[int, float]:
        with self._lock:
            return {slot: (a / d if d else 0.0)
                    for slot, (d, a) in sorted(self._spec_per_slot.items())}

    def _percentiles(self, values, ps) -> dict[str, float]:
        if not values:
            return {f"p{p}": float("nan") for p in ps}
        arr = np.asarray(values)
        return {f"p{p}": float(np.percentile(arr, p)) for p in ps}

    def latency_percentiles(self, ps=(50, 99)) -> dict[str, float]:
        with self._lock:
            lats = [r.latency_s for r in self.responses if r.status == OK]
        return self._percentiles(lats, ps)

    def ttft_percentiles(self, ps=(50, 99)) -> dict[str, float]:
        with self._lock:
            tt = [r.ttft_s for r in self.responses
                  if r.status == OK and r.ttft_s is not None]
        return self._percentiles(tt, ps)

    def summary(self) -> dict:
        out = {
            "requests": len(self.responses),
            "statuses": self.by_status(),
            "decode_steps": self.decode_steps,
            "prefills": self.prefills,
            "decode_tokens": self.decode_tokens,
            "windows": self.windows,
            "discarded_tokens": self.discarded_tokens,
            "prefill_chunks": self.prefill_chunks,
            "prefill_chunk_tokens": self.prefill_chunk_tokens,
            "host_stalls": self.host_stalls,
            "host_stall_s": self.host_stall_s,
            "window_waits": self.window_waits,
            "peak_active_slots": self.peak_active_slots,
            "pages_allocated": self.pages_allocated,
            "pages_freed": self.pages_freed,
            "page_evictions": self.page_evictions,
            "peak_pages_in_use": self.peak_pages_in_use,
            "draft_tokens": self.draft_tokens,
            "accepted_draft_tokens": self.accepted_draft_tokens,
            "rejected_draft_tokens": (self.draft_tokens
                                      - self.accepted_draft_tokens),
            "acceptance_rate": self.acceptance_rate(),
            "acceptance_rate_per_slot": self.acceptance_rate_per_slot(),
            "tokens_per_step": self.tokens_per_step(),
            "tokens_per_s": self.tokens_per_s(),
            "faults": self.fault_counts(),
            "retries": sum(r.retries for r in self.responses),
        }
        out.update({f"latency_{k}_s": v
                    for k, v in self.latency_percentiles().items()})
        out.update({f"ttft_{k}_s": v
                    for k, v in self.ttft_percentiles().items()})
        return out

    # --------------------------------------------------------------- export
    def to_event_log(self) -> EventLog:
        """EventLog record: requests as ok/fault events, faults with the
        recovery action taken, in wall order."""
        log = EventLog()
        with self._lock:
            entries = [(f.t, Event(step=f.step, kind="fault", code=f.code,
                                   action=f.action,
                                   detail=f"slots={list(f.slots)}", t=f.t))
                       for f in self.faults]
            resp_order = sorted(zip(self._resp_t, self.responses),
                                key=lambda p: p[0])
            entries += [(t, Event(step=i,
                                  kind="ok" if r.status == OK else "fault",
                                  detail=f"request {r.id}: {r.status}",
                                  duration_s=r.latency_s, t=t))
                        for i, (t, r) in enumerate(resp_order)]
        for _, ev in sorted(entries, key=lambda p: p[0]):
            log.add(ev)
        return log

    # ---------------------------------------------------------------- merging
    @classmethod
    def merged(cls, parts: "list[ServeMetrics]") -> "ServeMetrics":
        """One accumulator equal to the union of ``parts``: counters sum,
        peaks take the max, responses and faults pool (percentiles over the
        whole population), and the wall window spans the earliest start to
        the latest tick."""
        out = cls()
        for m in parts:
            with m._lock:
                out.responses.extend(m.responses)
                out._resp_t.extend(m._resp_t)
                out.faults.extend(m.faults)
                for name in ("decode_steps", "prefills", "decode_tokens",
                             "windows", "discarded_tokens", "prefill_chunks",
                             "prefill_chunk_tokens", "host_stalls",
                             "host_stall_s", "window_waits",
                             "pages_allocated", "pages_freed",
                             "page_evictions", "draft_tokens",
                             "accepted_draft_tokens"):
                    setattr(out, name, getattr(out, name) + getattr(m, name))
                out.peak_pages_in_use = max(out.peak_pages_in_use,
                                            m.peak_pages_in_use)
                out.peak_active_slots = max(out.peak_active_slots,
                                            m.peak_active_slots)
                for slot, (d, a) in m._spec_per_slot.items():
                    cell = out._spec_per_slot.setdefault(slot, [0, 0])
                    cell[0] += d
                    cell[1] += a
                if m._t0 is not None:
                    out._t0 = m._t0 if out._t0 is None else min(out._t0, m._t0)
                if m._t_last is not None:
                    out._t_last = (m._t_last if out._t_last is None
                                   else max(out._t_last, m._t_last))
        return out
