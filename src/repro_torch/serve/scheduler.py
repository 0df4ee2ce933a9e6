# Trimmed copy of repro/serve/scheduler.py: ContinuousBatchingScheduler and the paged-KV PageAllocator.
"""Continuous-batching scheduler: fixed decode slots, evict + backfill.

The scheduler is the host-side brain of a replica. It never touches the
device: it tracks which request occupies which decode slot, plans the prompt
chunks each decode window feeds (or the stepwise engine's inputs), consumes
the sampled tokens per slot, evicts finished/expired/faulted sequences and
backfills freed slots
from the admission queue *every step* — prefill and decode share the same
fixed-shape batch, so a long request never blocks the lane (the serving
counterpart of the paper's "local errors must not block global progress").

:class:`PageAllocator` is the host half of the paged KV pool
(``launch/paging.py`` holds the device half): a free list plus a per-slot
ownership ledger. It is pure accounting, so its invariants (no page owned
twice, double frees rejected, exact free-count arithmetic under any
interleaving of allocations and frees) are testable without a device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from .queue import EXPIRED, OK, Request, RequestQueue, Response


class PagePoolExhausted(RuntimeError):
    """Not enough free pages — the caller must evict or defer (never drop)."""


class PageAllocator:
    """Free list + per-slot page-ownership ledger for the paged KV pool.

    * **allocation order is irrelevant by design** — the device addresses
      pages through the table, so fragmentation of the physical id space
      never degrades anything (there is no "contiguity" to lose);
    * **watermark-driven admission**: :meth:`can_admit` says whether a new
      sequence's first pages fit while keeping ``watermark`` pages free as
      headroom for in-flight lanes to grow into (one page per active lane is
      a sensible default at call sites);
    * **strict frees**: freeing a slot that owns nothing, or a page that is
      not owned by that slot, raises — a double free means the host ledger
      and the device table have diverged, which is exactly the corruption
      the in-band ``PAGE_FAULT`` probe exists to catch, so it must never be
      papered over.
    """

    def __init__(self, num_pages: int, page_size: int, *, watermark: int = 0):
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if watermark < 0:
            raise ValueError(f"watermark must be >= 0, got {watermark}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.watermark = int(watermark)
        self._free: list[int] = list(range(num_pages - 1, -1, -1))
        self._owned: dict[int, list[int]] = {}

    # ---------------------------------------------------------------- queries
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    def pages_for(self, n_tokens: int) -> int:
        return -(-max(int(n_tokens), 0) // self.page_size)

    def owns(self, slot: int) -> bool:
        return bool(self._owned.get(slot))

    def owned(self, slot: int) -> tuple[int, ...]:
        """Slot's pages in logical-page order (index i holds positions
        ``[i*page_size, (i+1)*page_size)``)."""
        return tuple(self._owned.get(slot, ()))

    def can_admit(self, n_tokens: int) -> bool:
        """True iff ``n_tokens`` worth of pages fit with the watermark spare.

        The headroom is waived for a request so large that ``need +
        watermark`` exceeds the whole pool: such a request could *never*
        pass the gated check even with every page free, and an accepted
        request must eventually be admitted, not deferred forever — it is
        admitted whenever it plainly fits instead."""
        need = self.pages_for(n_tokens)
        headroom = (self.watermark
                    if need + self.watermark <= self.num_pages else 0)
        return need <= self.free_pages - headroom

    # ------------------------------------------------------------- alloc/free
    def alloc(self, slot: int, n: int) -> list[int]:
        """Grow ``slot`` by ``n`` pages; returns the new physical ids (the
        caller appends them to the device table *and scrubs them* before any
        step reads them). Raises :class:`PagePoolExhausted` without partial
        effect when the pool cannot cover the request."""
        if n < 0:
            raise ValueError(f"cannot alloc {n} pages")
        if n > len(self._free):
            raise PagePoolExhausted(
                f"slot {slot} needs {n} pages, {len(self._free)} free "
                f"of {self.num_pages}")
        got = [self._free.pop() for _ in range(n)]
        self._owned.setdefault(slot, []).extend(got)
        return got

    def free_slot(self, slot: int) -> list[int]:
        """Return all of ``slot``'s pages to the free list; returns the freed
        ids. Freeing a slot that owns nothing is a double free — rejected."""
        pages = self._owned.pop(slot, None)
        if not pages:
            raise ValueError(f"double free: slot {slot} owns no pages")
        # cross-ownership corruption is asserted by check() (tests/debug);
        # scanning every owner here would put an O(pages²) walk on the hot
        # finish/evict path
        self._free.extend(pages)
        return pages

    # -------------------------------------------------------------- invariant
    def check(self) -> None:
        """Assert ledger consistency (tests / debugging / the fuzzer oracle):
        every page is free or owned exactly once. Raises ``AssertionError``
        explicitly (not via ``assert``) so the invariant still fires under
        ``python -O`` — a fuzz oracle that silently evaporates is worse than
        none."""
        seen: dict[int, str] = {}
        for p in self._free:
            if p in seen:
                raise AssertionError(f"page {p} double-listed as free")
            seen[p] = "free"
        for slot, pages in self._owned.items():
            for p in pages:
                if p in seen:
                    raise AssertionError(
                        f"page {p} owned by slot {slot} and {seen[p]}")
                seen[p] = f"slot {slot}"
        if len(seen) != self.num_pages:
            raise AssertionError(
                f"{self.num_pages - len(seen)} pages leaked")


@dataclass
class Slot:
    """One decode lane. ``req is None`` ⇔ the lane is free.

    ``pending`` is the overlapped-prefill lane state: the token sequence being
    chunked into the cache through decode windows (the prompt at admission,
    prompt + generated at an LFLR recompute). ``pending is None`` ⇔ the slot
    is decoding; ``prefill_pos`` counts pending tokens already dispatched to
    the device chain.
    """

    idx: int
    req: Optional[Request] = None
    generated: list[int] = field(default_factory=list)
    t_first: Optional[float] = None      # wall time of the first generated token
    pending: Optional[list[int]] = None  # tokens being chunk-prefilled, or None
    prefill_pos: int = 0                 # pending tokens already fed on device

    @property
    def active(self) -> bool:
        return self.req is not None

    @property
    def prefilling(self) -> bool:
        return self.req is not None and self.pending is not None

    @property
    def seq_len(self) -> int:
        """Tokens whose state is already in the cache (prompt + generated)."""
        return len(self.req.prompt) + len(self.generated) if self.req else 0

    def clear(self) -> None:
        self.req = None
        self.generated = []
        self.t_first = None
        self.pending = None
        self.prefill_pos = 0


@dataclass(frozen=True)
class ChunkPlan:
    """One lane's share of a decode window's prefill budget.

    ``rem`` steps of the window feed ``tokens`` (prompt chunk) instead of
    greedy feedback; ``rem == 0`` means the lane is deferred this window (it
    must be masked out — its cache holds no valid state yet). ``exhausts``
    marks the flip window: the lane's last pending token lands at step
    ``rem - 1``, whose argmax is its first real generated token. ``fresh``
    marks a lane's first chunk — the replica must reset the slot's cache (and
    position) on device before dispatching this window.
    """

    tokens: tuple[int, ...]
    rem: int
    exhausts: bool
    fresh: bool


class ContinuousBatchingScheduler:
    """Slot bookkeeping for one replica.

    The replica drives it in a strict cycle::

        expire_active → backfill → begin_prefill (admitted slots)
        → plan_prefill → [fused window on device] → commit_block per slot

    ``commit_block`` consumes each lane's K-token block up to EOS / budget /
    fault boundary and discards the trailing tokens the deferred-detection
    window over-decoded.

    On a fault, ``sequence_tokens``/``note_retry`` feed the LFLR recompute.
    """

    def __init__(self, num_slots: int, queue: RequestQueue, *,
                 replica: Optional[int] = None, eos_id: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 prefill_budget: Optional[int] = None,
                 can_admit: Optional[Callable[[Request], bool]] = None,
                 on_release: Optional[Callable[[int], None]] = None):
        if num_slots < 1:
            raise ValueError("need at least one slot")
        if prefill_budget is not None and prefill_budget < 1:
            raise ValueError("prefill_budget must be >= 1 (or None)")
        self.queue = queue
        self.slots = [Slot(i) for i in range(num_slots)]
        self.replica = replica
        self.eos_id = eos_id
        self.clock = clock
        self.prefill_budget = prefill_budget
        # paged-KV hooks: `can_admit` gates backfill on pool headroom
        # (watermark admission); `on_release` fires whenever a slot stops
        # owning its request (finish, expiry, failure, preemption) so the
        # page ledger can reclaim without the replica chasing every exit path
        self.can_admit = can_admit
        self.on_release = on_release

    # ---------------------------------------------------------------- queries
    @property
    def num_slots(self) -> int:
        return len(self.slots)

    def active_slots(self) -> list[int]:
        return [s.idx for s in self.slots if s.active]

    def free_slots(self) -> list[int]:
        return [s.idx for s in self.slots if not s.active]

    def prefilling_slots(self) -> list[int]:
        return [s.idx for s in self.slots if s.prefilling]

    def has_active(self) -> bool:
        return any(s.active for s in self.slots)

    def in_flight(self) -> int:
        return len(self.active_slots())

    def pressure(self) -> dict:
        """Occupancy snapshot: queued requests, busy slots, total slots.
        Pure bookkeeping — no device sync."""
        return {"queued": len(self.queue), "active": self.in_flight(),
                "slots": self.num_slots}

    def request(self, slot: int) -> Request:
        req = self.slots[slot].req
        assert req is not None, f"slot {slot} is free"
        return req

    def sequence_tokens(self, slot: int) -> list[int]:
        """Prompt + generated so far — the LFLR recompute input."""
        s = self.slots[slot]
        assert s.req is not None
        return list(s.req.prompt) + s.generated

    # ------------------------------------------------- overlapped prefill lanes
    def begin_prefill(self, slot: int) -> None:
        """Turn a slot into a background prefill lane.

        Admission and LFLR recovery are literally the same lane: the pending
        sequence is prompt + generated-so-far (empty at admission), chunked
        into the cache by subsequent decode windows via :meth:`plan_prefill`.
        Re-calling on an already-prefilling lane restarts it from position 0
        (the LFLR restart after a fault mid-chunk — the recurrent state is
        poisoned, so the whole sequence recomputes; committed tokens are kept
        and replayed, which is what makes the recovery bit-exact)."""
        s = self.slots[slot]
        assert s.req is not None, f"begin_prefill on free slot {slot}"
        s.pending = self.sequence_tokens(slot)
        s.prefill_pos = 0

    def plan_prefill(self, window: int,
                     budget: Optional[int] = None) -> dict[int, ChunkPlan]:
        """Split the next window's token budget between decode and prefill.

        Returns a :class:`ChunkPlan` per prefilling lane and advances each
        planned lane's ``prefill_pos`` (the device chain consumes the chunk at
        dispatch; a fault later rewinds via :meth:`begin_prefill`). Budgeting
        (Sarathi-style, per window):

        * an in-progress lane (``prefill_pos > 0``) always gets
          ``min(window, remaining)`` — a half-built cache must keep advancing
          every window it participates in, because a parked lane would decode
          garbage into its own state (the no-park invariant);
        * a fresh lane starts only if the remaining budget covers its first
          chunk *whole* (a partial non-exhausting chunk would break the
          no-park invariant); fresh lanes start oldest-arrival-first, so
          under load the budget prioritises the TTFT of the longest-waiting
          request;
        * a deferred fresh lane gets ``ChunkPlan(rem=0)`` — the replica masks
          it out of the window entirely;
        * the effective budget is clamped to ≥ ``window``: a first chunk is
          at most one window, so a smaller budget could never admit it and a
          fresh lane would starve for as long as any slot keeps decoding.

        ``budget=None`` means unthrottled (every lane chunks every window).
        When a lane's chunk exhausts its pending sequence the lane flips to
        decoding (``pending = None``) — from step ``rem - 1`` of that window
        onwards its token block is real output.
        """
        budget = self.prefill_budget if budget is None else budget
        left = float("inf") if budget is None else max(int(budget),
                                                       int(window))
        lanes = [s for s in self.slots if s.prefilling]
        # in-progress first (correctness), then fresh by arrival (TTFT)
        lanes.sort(key=lambda s: (s.prefill_pos == 0,
                                  s.req.arrival_t if s.req.arrival_t is not None
                                  else float("inf"), s.idx))
        # liveness: deferring is only legal while something else makes progress
        work = any(s.active and not s.prefilling for s in self.slots)
        plan: dict[int, ChunkPlan] = {}
        for s in lanes:
            remaining = len(s.pending) - s.prefill_pos
            n = min(window, remaining)
            fresh = s.prefill_pos == 0
            if fresh and n > left and work:
                plan[s.idx] = ChunkPlan(tokens=(), rem=0, exhausts=False,
                                        fresh=True)
                continue
            toks = tuple(s.pending[s.prefill_pos:s.prefill_pos + n])
            exhausts = s.prefill_pos + n == len(s.pending)
            plan[s.idx] = ChunkPlan(tokens=toks, rem=n, exhausts=exhausts,
                                    fresh=fresh)
            s.prefill_pos += n
            left -= n
            work = True
            if exhausts:
                s.pending = None
                s.prefill_pos = 0
        return plan

    # ------------------------------------------------------------- admission
    def backfill(self, now: Optional[float] = None) -> list[tuple[int, Request]]:
        """Fill free slots from the queue; returns (slot, request) pairs the
        replica must prefill before the next decode step."""
        now = self.clock() if now is None else now
        admitted = []
        for s in self.slots:
            if s.active:
                continue
            req = self.queue.pop(now)
            if req is None:
                break
            if self.can_admit is not None and not self.can_admit(req):
                # pool headroom exhausted: put it back (ahead of its class)
                # and stop admitting this cycle — deferred, never dropped
                self.queue.requeue(req)
                break
            s.req = req
            s.generated = []
            s.t_first = None
            admitted.append((s.idx, req))
        return admitted

    # ------------------------------------------------------------ step cycle
    def step_inputs(self) -> tuple[np.ndarray, np.ndarray]:
        """(tokens (S,) int32, pos (S,) int32) for the stepwise engine's
        slot decode step.

        An active slot feeds its last token at its own absolute position;
        free slots decode a dummy token at position 0 (their word is masked
        out and their cache is overwritten at admission, so the work is dead
        weight the fixed-shape batch pays for simplicity).
        """
        S = self.num_slots
        tokens = np.zeros((S,), np.int32)
        pos = np.zeros((S,), np.int32)
        for s in self.slots:
            if not s.active:
                continue
            # The cache holds states for positions [0, seq_len-1): prefill
            # consumed the prompt, decode consumed every generated token but
            # the newest. The input is that newest token (the first one comes
            # from the prefill logits, committed in Replica._prefill_slot, so
            # active slots always have generated >= 1), at position seq_len-1.
            last = s.generated[-1] if s.generated else s.req.prompt[-1]
            tokens[s.idx] = last
            pos[s.idx] = s.seq_len - 1
        return tokens, pos

    def active_mask(self) -> np.ndarray:
        return np.asarray([1 if s.active else 0 for s in self.slots], np.uint32)

    def commit_token(self, slot: int, token: int,
                     now: Optional[float] = None) -> Optional[Response]:
        """Record one sampled token; returns a Response iff the slot finished."""
        now = self.clock() if now is None else now
        s = self.slots[slot]
        assert s.req is not None, f"commit on free slot {slot}"
        if s.t_first is None:
            s.t_first = now
        s.generated.append(int(token))
        done = (len(s.generated) >= s.req.max_new_tokens
                or (self.eos_id is not None and int(token) == self.eos_id))
        if not done:
            return None
        return self._finish(s, OK, now)

    def commit_block(self, slot: int, tokens, now: Optional[float] = None,
                     limit: Optional[int] = None
                     ) -> tuple[int, Optional[Response]]:
        """Commit a window's token block for one lane.

        Feeds ``tokens[:limit]`` through :meth:`commit_token` until the
        request finishes (EOS / token budget); returns ``(consumed, response)``
        where ``response`` is non-None iff the lane finished mid-block —
        everything after that boundary is discarded by the caller.

        ``tokens`` is a variable-length sequence: the plain window engine
        hands K tokens, the speculative engine each lane's flattened
        accepted runs (1 to K (D + 1) tokens, cut at the lane's fault
        boundary). EOS and the token budget are checked token by token, so a
        request that ends inside an accepted run finishes on the same token
        as in the plain engine, and the accepts after it are discarded.
        """
        now = self.clock() if now is None else now
        limit = len(tokens) if limit is None else min(limit, len(tokens))
        consumed = 0
        for k in range(limit):
            resp = self.commit_token(slot, int(tokens[k]), now)
            consumed += 1
            if resp is not None:
                return consumed, resp
        return consumed, None

    def note_retry(self, slot: int) -> int:
        """Count one LFLR recompute against the slot's request; returns total."""
        req = self.request(slot)
        req.retries += 1
        return req.retries

    # -------------------------------------------------------------- eviction
    def evict(self, slot: int, status: str, now: Optional[float] = None,
              detail: str = "") -> Response:
        """Terminal eviction (EXPIRED / FAILED); frees the slot."""
        now = self.clock() if now is None else now
        return self._finish(self.slots[slot], status, now, detail=detail)

    def expire_active(self, now: Optional[float] = None) -> list[Response]:
        """Evict active sequences whose deadline passed mid-decode."""
        now = self.clock() if now is None else now
        out = []
        for s in self.slots:
            if s.active and s.req.deadline is not None and now >= s.req.deadline:
                out.append(self._finish(s, EXPIRED, now,
                                        detail="deadline passed mid-decode"))
        return out

    def _finish(self, s: Slot, status: str, now: float,
                detail: str = "") -> Response:
        req = s.req
        resp = Response(
            id=req.id, status=status, tokens=tuple(s.generated),
            latency_s=now - req.arrival_t,
            ttft_s=(s.t_first - req.arrival_t) if s.t_first is not None else None,
            retries=req.retries, replica=self.replica, detail=detail,
            trace_id=req.trace_id)
        s.clear()
        if self.on_release is not None:
            self.on_release(s.idx)
        return resp

    def preempt(self, slot: int) -> Request:
        """Non-terminal eviction: pull the request out of its slot with its
        progress discarded (the next owner recomputes from the prompt; the
        paged engine's memory-pressure path). The caller MUST requeue the
        returned request: an accepted request is never dropped. Fault
        retries already consumed are *preserved*, so a persistently
        faulting request still converges to FAILED instead of laundering
        its retry budget through evictions."""
        s = self.slots[slot]
        req = s.req
        if req is None:
            raise ValueError(f"preempt on free slot {slot}")
        s.clear()
        if self.on_release is not None:
            self.on_release(slot)
        return req

    # ------------------------------------------------------------- re-route
    def drain_in_flight(self) -> list[Request]:
        """Pull every in-flight request out of its slot (progress discarded:
        the receiving replica recomputes from the prompt), for a caller that
        rebalances work off a live replica. A serve group re-routes a dead
        replica's requests through its ledger instead."""
        out = []
        for s in self.slots:
            if s.active:
                out.append(s.req)
                s.clear()
                if self.on_release is not None:
                    self.on_release(s.idx)
        return out
