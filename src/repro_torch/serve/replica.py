"""Serving replica: the stepwise engine, and zero-sync decode windows with
blocking or overlapped prefill, plain or speculative, with per-sequence
LFLR, on one device.

The port of ``repro/serve/replica.py`` in its three engines, each window
engine also paged, and the overlapped one also speculative:

- ``window=0`` (``EngineConfig()``'s default): the stepwise engine. Every
  step decodes every slot once (:func:`~repro_torch.launch.steps.
  make_slot_decode_step`), waits for the per-slot words and commits each
  slot's argmax; admission and LFLR are blocking prefills.
- ``window=K, overlap=False``: K greedy steps run on the device per dispatch
  (:func:`~repro_torch.launch.steps.make_decode_window`); fault detection is
  deferred to the window boundary (the paper's asynchrony contract — errors
  latch in-band, raise at the *wait*), and the commit loop is
  double-buffered: window N+1 is dispatched from window N's device-resident
  outputs (next token, next positions, in-place caches) *before* window N's
  token block is read back. Admission and LFLR are blocking prefills, which
  patch the lane's device state.
- ``window=K, overlap=True``: the same windows with prompt chunks fed in
  (:func:`~repro_torch.launch.steps.make_prefill_decode_window`). Admission
  and LFLR are background prefill lanes, so the healthy slots' token stream
  never stalls.
- ``paged=True`` (with either window engine): the K/V leaves of capacity
  ``max_len`` live in a shared page pool addressed through a ``(slots,
  max_pages)`` page table (:mod:`repro_torch.launch.paging`); the host
  ledger (:class:`~repro_torch.serve.scheduler.PageAllocator`) grows each
  lane a window ahead, preempts the oldest lane back into the queue when
  the pool runs dry, and rejects at submit a request the pool can never
  hold. The table goes to the device once per window, from a copy of the
  host table; growth is planned from a host mirror of the positions, never
  from a device read. The streams are bit-equal to the contiguous
  engine's.
- ``speculate=True`` (``window=K, overlap=True``; pure full-attention
  models): each window step drafts ``draft_len`` tokens per slot with the
  first ``draft_layers`` layers and verifies them in one full-model pass
  (:func:`~repro_torch.launch.steps.make_speculative_decode_window`),
  emitting 1 to ``draft_len + 1`` tokens a step — the plain engine's stream,
  since each is a full-model argmax. The prompt feed rides the verify
  width, the position chain stays on the device (the advance depends on
  the data; the host mirror learns it from the accepted counts at
  retirement), the commit takes each lane's variable-length block, and a
  rejected draft rides the word history as the attribution-only
  ``DRAFT_REJECT`` lane, masked out of the word the wait raises on.

Recovery is the paper's use case 1 applied to inference: non-finite logits
on slot *i* (the probe kernel's word) → LFLR: slot *i* recomputes its cache
from its prompt + committed tokens through the same decode step (greedy
decode is deterministic, so the recomputed trajectory is the pre-fault one
bit for bit) while the other slots commit their tokens; the
:class:`~repro_torch.core.recovery.RecoveryPolicy` escalates, and a request
that re-faults past ``max_request_retries`` is answered ``FAILED``.

The blocking prefill runs at the slots' batch size, every row holding the
lane's sequence, into a scratch cache allocated once, and keeps row
``slot``: a product's rounding may depend on how many rows it is given, so a
batch-1 prefill would not give the bits the slot step gives, and LFLR
replays and blocking ≡ overlap would stop being bit-exact. It costs S times
the arithmetic of a batch-1 prefill on a step that is host-bound anyway.

Host syncs: two :func:`~repro_torch.core.device_channel.readback` calls per
stepwise step or retired window (the error word with its enumeration table,
then the tokens — speculating, the tokens and the accepted counts in one
copy) and per blocking prefill (its word, then its token), plus the window
history on the fault path, read once for the fault steps, the per-slot codes
and the trace's fault events.

Tracing: with a :class:`~repro_torch.obs.Tracer` (given, or the queue's),
the replica emits the JAX replica's events — slot assignment, prompt
chunks, window and decode spans, first tokens, page allocation, frees and
evictions, speculation counts, one ``fault`` event per attributed slot with
its exact word, and a recovery lane from each decision to the lane's first
healthy token — each from values the host already holds; the
``NULL_TRACER`` default records nothing.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.device_channel import (
    DeviceFuture,
    enumerate_errors_ref,
    or_reduce,
    readback,
    record_event,
)
from ..core.errors import ErrorCode, PropagatedError
from ..core.faults import INJECTABLE_CODE_MASK
from ..core.recovery import Action, RecoveryPolicy
from ..launch.paging import PagedLayout
from ..launch.steps import (make_cache_prefill, make_decode_window,
                            make_prefill_decode_window, make_slot_decode_step,
                            make_speculative_decode_window)
from ..models.model import (KV_LEAVES, Model, insert_cache_slot,
                            reset_cache_slot, slot_layer_view)
from ..models.transformer import RECURRENT_STATE
from ..obs.trace import NULL_TRACER, Tracer
from .config import EngineConfig
from .metrics import ServeMetrics
from .queue import EXPIRED, FAILED, AdmissionPolicy, Request, RequestQueue, Response
from .scheduler import (ContinuousBatchingScheduler, PageAllocator,
                        PagePoolExhausted)


def _check_supported(config: EngineConfig) -> None:
    """The mode of the JAX replica this port does not run yet."""
    if config.tp > 1:
        raise NotImplementedError(
            "tp>1 is not ported yet: ROADMAP Queue 1, item 11 (tensor "
            "parallel)")


def slot_enum(words: torch.Tensor, mask: torch.Tensor):
    """``(words (S,), mask (S,)) -> (combined, count, table)`` on the device
    (the JAX package's ``make_enum_fn``): free slots are masked out (their
    caches may hold stale values from an evicted sequence, and a free slot
    decodes a dummy token), then the paper's enumeration attributes each
    remaining word to its slot (``max_errors = S``, so attribution never
    truncates)."""
    words = words * mask
    count, table = enumerate_errors_ref(words, max_errors=words.shape[0])
    return or_reduce(words, dim=0), count, table


def window_enum(history: torch.Tensor, mask: torch.Tensor, ignore: int = 0):
    """``(history (K, S), mask (S,)) -> (combined, count, table, hist)``:
    the window variant of :func:`slot_enum`. Free slots are masked out of
    the whole word history, each slot's words are OR-folded over the window
    (one check per K tokens), and the folds go through the same per-slot
    enumeration, so the engines cannot diverge in attribution. ``ignore``
    strips attribution-only bits (``DRAFT_REJECT``) from the fold, so a
    window whose only events are speculation misses waits clean; the
    history keeps them for :meth:`DeviceFuture.fault_codes`."""
    hist = history * mask[None, :]
    return (*slot_enum(or_reduce(hist & ~ignore, dim=0), mask), hist)


@dataclass
class _WindowInFlight:
    """One dispatched decode window awaiting retirement.

    ``req_ids`` snapshots which request occupied each slot at dispatch (None =
    free lane); a lane's block only commits if the same request still holds
    the slot. ``valid`` is cleared for a lane whose state is restarted (LFLR)
    while this window is in flight — its tokens and words are then stale.
    ``start`` is the first committable step per lane: 0 for a decoding slot,
    ``rem - 1`` for a lane whose prompt chunk ends in this window, K for a
    lane still mid-prefill. A speculative window adds, per lane, the flip
    step's first committable verify row (``start_row``), the prompt tokens
    fed in this window (``rem0``) and whether the lane was deferred.
    """

    fut: DeviceFuture
    req_ids: tuple
    valid: np.ndarray
    start: np.ndarray
    start_row: Optional[np.ndarray] = None
    rem0: Optional[np.ndarray] = None
    deferred: Optional[np.ndarray] = None
    # tracing only: the dispatch's wall time and index (``_step_count`` at
    # dispatch), so the retire-side span covers the window's whole life and
    # a fault event names its window; ``trace_ids`` snapshots the lanes'
    # trace ids at dispatch (empty when tracing is off), so a fault goes to
    # the request whose state the window computed with, even if it left the
    # slot before the deferred detection surfaced the fault
    t_dispatch: float = 0.0
    index: int = 0
    trace_ids: tuple = ()


class Replica:
    """One continuous-batching serving replica on one device."""

    def __init__(self, cfg: ModelConfig, model: Optional[Model] = None, *,
                 config: Optional[EngineConfig] = None,
                 device=None, seed: int = 0,
                 queue: RequestQueue | None = None,
                 policy: RecoveryPolicy | None = None,
                 metrics: ServeMetrics | None = None,
                 rank: int = 0,
                 clock: Callable[[], float] = time.monotonic,
                 tracer: Optional[Tracer] = None,
                 fault_injector: Optional[Callable] = None):
        config = config if config is not None else EngineConfig()
        _check_supported(config)
        if model is not None and device is not None and (
                torch.device(device) != model.device):
            raise ValueError(f"model lives on {model.device}, not {device}")
        self.config = config
        self.cfg = cfg
        self.model = model if model is not None else Model(cfg, device=device,
                                                           seed=seed)
        self.device = self.model.device
        self.max_len = config.max_len
        self.rank = rank
        self.clock = clock
        self.policy = policy or RecoveryPolicy()
        self.metrics = metrics or ServeMetrics(clock=clock)
        # fault-causality tracing: an explicit tracer, else the given
        # queue's (a ServeGroup threads one per rank through both), else the
        # NullTracer. Every emit site checks ``self.trace.enabled`` first,
        # and builds its event from values the host already holds
        if tracer is not None:
            self.trace = tracer
        elif queue is not None and queue.tracer.enabled:
            self.trace = queue.tracer
        else:
            self.trace = NULL_TRACER
        # slot -> open recovery lane (trace_id, t0, code, action, window):
        # opened at the recovery decision, closed by the lane's first
        # healthy committed token, or swept as abandoned when its request
        # leaves the slot without one (its terminal response resolves it)
        self._recovering: dict[int, dict] = {}
        self.max_request_retries = config.max_request_retries
        # deterministic in-band fault-word injection: called once per
        # dispatch with the dispatch index and the (K, slots) words shape;
        # may return a uint32 array OR'd into the device words before
        # enumeration, so injected codes ride the real detection path
        self._injector = fault_injector
        self.window = int(config.window)
        self.overlap = bool(self.window) and bool(config.overlap)
        # speculative windows: up to draft_len + 1 tokens a full-model step;
        # the commit reads each (step, slot)'s accepted count
        self.speculate = bool(config.speculate)
        self.draft_len = int(config.draft_len)
        self.draft_layers = int(config.draft_layers)
        if self.speculate and not self.model.supports_speculation():
            raise ValueError(
                f"{cfg.name}: speculation requires a pure full-attention"
                ", non-MoE architecture")
        # attribution-only codes stripped from the word the wait raises on
        self._ignore_codes = (int(ErrorCode.DRAFT_REJECT) if self.speculate
                              else 0)
        num_slots = config.num_slots
        # ---- paged KV pool (paged=True, window mode only): the K/V leaves
        # of capacity max_len become one shared page pool addressed through
        # a (slots, max_pages) table; the allocator owns the free list and
        # the per-slot ownership ledger
        self.paged = bool(config.paged)
        self.layout: Optional[PagedLayout] = None
        self.alloc: Optional[PageAllocator] = None
        pool_cap = config.max_len
        if self.paged:
            one = self.model.init_cache(1, config.max_len)
            num_pages = (config.page_budget if config.page_budget is not None
                         else num_slots * (config.max_len // config.page_size))
            self.layout = PagedLayout(one, config.max_len,
                                      page_size=config.page_size,
                                      num_pages=num_pages)
            self.alloc = PageAllocator(num_pages, config.page_size,
                                       watermark=config.page_watermark)
            self.page_table = self.layout.empty_table(num_slots)
            self.caches = self.layout.init_hybrid(one, num_slots)
            if self.layout.has_paged_leaves:
                # a request the pool can never hold is REJECTED at submit,
                # not deferred forever by the watermark gate
                pool_cap = self.layout.capacity_tokens
        else:
            self.caches = self.model.init_cache(num_slots, config.max_len)
        self.queue = queue or RequestQueue(
            AdmissionPolicy(max_total_len=pool_cap), clock=clock,
            tracer=self.trace)
        self.sched = ContinuousBatchingScheduler(
            num_slots, self.queue, replica=rank, eos_id=config.eos_id,
            clock=clock, prefill_budget=config.prefill_budget,
            can_admit=self._can_admit if self.paged else None,
            on_release=self._release_pages if self.paged else None)
        paged = self.layout
        if not self.window:
            self._decode = make_slot_decode_step(self.model)
            self._slot_logits: Optional[torch.Tensor] = None
        elif self.speculate:
            self._decode_window = make_speculative_decode_window(
                self.model, window=self.window, draft_len=self.draft_len,
                draft_layers=self.draft_layers, paged=paged)
        elif self.overlap:
            self._decode_window = make_prefill_decode_window(
                self.model, window=self.window, paged=paged)
        else:
            self._decode_window = make_decode_window(
                self.model, window=self.window, paged=paged)
        if not self.overlap:
            self._prefill = make_cache_prefill(self.model, paged=paged)
            if not self.paged:
                # the blocking prefill's S-wide scratch cache (module
                # docstring); the paged prefill replicates the lane's view
                self._scratch = self.model.init_cache(num_slots,
                                                      config.max_len)
        self._step_count = 0
        self._pending: Optional[_WindowInFlight] = None
        # window modes: the device-resident chain window N+1 consumes, next
        # input token and position per slot (never read back inside or
        # between windows; a blocking prefill patches a lane's entries)
        self._dev_tokens = torch.zeros(num_slots, dtype=torch.int32,
                                       device=self.device)
        self._dev_pos = torch.zeros(num_slots, dtype=torch.int32,
                                    device=self.device)
        # the host mirror of _dev_pos, advanced by what the host knows (K
        # per window, 0 at a lane's restart, the sequence after a blocking
        # prefill; speculating, the accepted counts of each retired window):
        # page growth is planned from it, never from an extra readback
        self._host_pos = np.zeros(num_slots, np.int64)

    # ------------------------------------------------------------- page ledger
    def _check_pages(self) -> None:
        """Ledger invariant, checked where the ledger changes (preemption,
        requeue, LFLR reclaim) so that a corrupted ledger fails at the
        operation that corrupted it. Off under ``python -O``."""
        if __debug__ and self.alloc is not None:
            self.alloc.check()

    def _can_admit(self, req: Request) -> bool:
        """Watermark admission: a fresh sequence joins only if its prompt's
        pages (plus the first generated position) fit with the configured
        headroom left free for in-flight lanes to grow into."""
        if not self.layout.has_paged_leaves:
            return True
        return self.alloc.can_admit(len(req.prompt) + 1)

    def _release_pages(self, slot: int) -> None:
        """Free a slot's pages and unmap its table row. Host bookkeeping
        only: the device stream orders every dispatched read and write of
        these pages before the scrub their next owner's allocation queues,
        so reclamation never stalls or races the window in flight."""
        if self.alloc.owns(slot):
            freed = self.alloc.free_slot(slot)
            self.page_table[slot, :] = self.layout.sentinel
            self.metrics.record_pages(freed=len(freed),
                                      in_use=self.alloc.pages_in_use)
            if self.trace.enabled:
                self.trace.instant("page_free", "page", tid=slot, slot=slot,
                                   pages=len(freed),
                                   in_use=self.alloc.pages_in_use)

    def _oldest_active(self, exclude: frozenset) -> Optional[int]:
        """Eviction victim: the oldest-arrival active lane that owns pages."""
        best = None
        for s in self.sched.slots:
            if not s.active or s.idx in exclude or not self.alloc.owns(s.idx):
                continue
            key = (s.req.arrival_t if s.req.arrival_t is not None
                   else float("inf"), s.idx)
            if best is None or key < best[0]:
                best = (key, s.idx)
        return None if best is None else best[1]

    def _evict_for_pages(self, victim: int) -> None:
        """Memory-pressure preemption: pull the victim's request out of its
        slot and requeue it (progress discarded — it recomputes from the
        prompt on its next slot; no request is dropped). The window in
        flight's lane is invalidated so its stale block is skipped."""
        req = self.sched.preempt(victim)          # on_release frees the pages
        if self.trace.enabled:
            self.trace.instant("page_evict", "page", tid=victim, slot=victim,
                               trace_id=req.trace_id)
        self.queue.requeue(req)
        self.metrics.record_page_eviction()
        if self._pending is not None:
            self._pending.valid[victim] = False
        self._check_pages()

    def _grow_slot(self, slot: int, target_tokens: int, *,
                   exclude_self: bool = False) -> Optional[list[int]]:
        """Make ``slot`` own pages covering ``target_tokens`` positions,
        evicting the oldest lanes under pressure. Returns the newly
        allocated (unscrubbed) page ids, or None if ``slot`` itself was
        evicted.

        The target is clamped to the pool's token capacity, not only to
        ``max_len``: window over-decode can push ``pos + K`` past what any
        lane may hold, and demanding pages that cannot exist would evict
        the whole fleet and livelock (positions past the clamp drop their
        writes and are discarded at retirement anyway)."""
        target = min(int(target_tokens), self.layout.capacity_tokens)
        while True:
            need = self.alloc.pages_for(target) - len(self.alloc.owned(slot))
            if need <= 0:
                return []
            try:
                got = self.alloc.alloc(slot, need)
                break
            except PagePoolExhausted:
                victim = self._oldest_active(
                    frozenset((slot,)) if exclude_self else frozenset())
                if victim is None:
                    raise      # unreachable under the admission clamp
                self._evict_for_pages(victim)
                if victim == slot:
                    return None
        # append-only: write just the new tail entries, never the whole row
        # — the device table is the mapping of record, and a full-row
        # rewrite would paper over exactly the ledger/table divergence the
        # in-band PAGE_FAULT probe exists to surface
        n_owned = len(self.alloc.owned(slot))
        self.page_table[slot, n_owned - len(got):n_owned] = got
        self.metrics.record_pages(allocated=len(got),
                                  in_use=self.alloc.pages_in_use)
        if self.trace.enabled:
            self.trace.instant("page_alloc", "page", tid=slot, slot=slot,
                               pages=len(got), in_use=self.alloc.pages_in_use)
        return got

    def _paged_prepare(self, plan: dict) -> None:
        """Page maintenance before a window is dispatched.

        1. **Lane (re)starts** (fresh chunk plans — admission or LFLR): free
           the lane's old pages (the LFLR page *reclaim*, a host ledger
           operation) and zero its dense rows on the device stream; step 2
           acquires its new pages.
        2. **Growth**: every lane that writes in this window gets the pages
           holding positions ``[pos, pos + K)`` (``pos`` from the host
           mirror); exhaustion preempts the oldest lanes into the queue.
           Speculating, a window advances a lane by 1 to ``K (D + 1)``
           positions, known only at its retirement, and the mirror lags the
           window in flight: growth covers the worst case, the retired
           position plus this window's horizon ``K (D + 1)`` plus the
           in-flight window's.
        3. **Scrub**: the new pages are zeroed on the device stream before
           the window, so a recycled page never leaks a previous owner's
           (possibly poisoned) state.
        """
        sched, K = self.sched, self.window
        for slot, cp in plan.items():
            if cp.rem == 0 or not cp.fresh:
                continue
            self._release_pages(slot)
            self._check_pages()
            self.layout.reset_slot(self.caches, slot)
            self._dev_pos.narrow(0, slot, 1).fill_(0)     # queued, no sync
            self._host_pos[slot] = 0
        if not self.layout.has_paged_leaves:
            return
        deferred = {slot for slot, cp in plan.items() if cp.rem == 0}
        horizon = K * (self.draft_len + 1) if self.speculate else K
        slack = horizon if self.speculate and self._pending is not None else 0
        new_ids: list[int] = []
        for s in sched.slots:
            if not s.active or s.idx in deferred:
                continue
            got = self._grow_slot(s.idx,
                                  int(self._host_pos[s.idx]) + horizon + slack)
            if got:
                new_ids.extend(got)
        if new_ids:
            # an eviction inside the growth loop recycles ids, so one page
            # may be granted twice within one prepare: dedupe
            ids = np.asarray(list(dict.fromkeys(new_ids)), np.int32)
            self.layout.scrub(self.caches, self._to_device(ids))

    # ---------------------------------------------------------------- warmup
    def warmup(self, *, max_new: int = 8) -> None:
        """Run one throwaway request end to end before real traffic (builds
        the kernels, warms the libraries), then swap in fresh metrics so the
        warm-up never pollutes reported numbers."""
        if not self.idle():
            raise RuntimeError("warmup must run before traffic is admitted")
        req = Request(id=-1, prompt=(1, 2, 3),
                      max_new_tokens=min(max_new, self.max_len - 4))
        if self.submit(req) is not None:
            raise RuntimeError("warmup request rejected")
        self.run()
        self.metrics = ServeMetrics(clock=self.clock)
        self.trace.clear()       # the warm-up's events would pollute the trace

    # ------------------------------------------------------------- submission
    def submit(self, req: Request) -> Optional[Response]:
        """Admit a request; returns a ``REJECTED`` response or None (accepted).
        Every accepted request is eventually answered by ``step``/``run``."""
        resp = self.queue.submit(req)
        if resp is not None:
            self.metrics.record_response(resp)
        return resp

    def readmit(self, req: Request) -> Optional[Response]:
        """Idempotent re-admission after a ledger replay (crash-restart).

        A request the write-ahead log proves was already *accepted* re-enters
        through the negative-sequence requeue lane: admission checks are
        bypassed (it was admitted once and is owed a terminal answer), it
        sorts ahead of its deadline class, and its original ``arrival_t``
        and ``trace_id`` are kept, so latency spans the whole crash-recovery
        window. A request the log shows as submitted but never accepted
        goes through normal admission."""
        if req.arrival_t is None:
            return self.submit(req)
        self.queue.requeue(req)
        return None

    def load(self) -> int:
        """Queued + in-flight requests — the group's take limit and
        autoscale pressure signal."""
        return len(self.queue) + self.sched.in_flight()

    # ---------------------------------------------------------- fault surface
    def inject_state_fault(self, slot: Optional[int] = None, *,
                           rng: Optional[np.random.Generator] = None
                           ) -> Optional[int]:
        """Simulated SDC, on the device, where the JAX replica puts it:

        - recurrent architectures: NaN element ``(slot, 0, …)`` of every
          ``h`` or ``ssm`` leaf of the JAX cache tree — the first element of
          the state of the period-0 layer of each recurrent pattern position
          and of each remainder recurrent layer. The state probe then
          latches STATE_FAULT;
        - attention-only architectures: NaN the K entry at position 0 (first
          KV head, first feature) of the first K leaf, in the JAX cache
          tree's order, whose capacity is ``max_len`` — a full layer, or a
          sliding layer's ring when ``max_len <= window``; the next step's
          logits for that slot go non-finite and the probe latches
          NONFINITE_LOSS. Paged, that leaf is the first pool, and the entry
          lies in the page the slot's table maps first.

        ``slot=None`` picks the first active slot, or a seeded-random one
        with ``rng``. Returns the slot, or None if no slot is active or a
        paged slot owns no page yet."""
        if slot is None:
            active = self.sched.active_slots()
            if not active:
                return None
            slot = int(rng.choice(active)) if rng is not None else active[0]
        model, layers = self.model, self.state_fault_layers()
        if model.state_leaves:
            for l in layers:
                state = slot_layer_view(
                    self.caches, RECURRENT_STATE[self.cfg.pattern_layers[l]])
                state[(slot, model.cache_index[l]) + (0,) * (state.dim() - 2)] = (
                    float("nan"))
            return slot
        (l,) = layers
        name = KV_LEAVES[self.cfg.pattern_layers[l]][0]
        if self.paged and self.layout.is_paged_path(name):
            pid = int(self.page_table[slot, 0])
            if pid >= self.layout.num_pages:
                return None              # the lane owns no page yet
            self.caches[name][model.cache_index[l], pid, 0, 0, 0] = float("nan")
            return slot
        k = slot_layer_view(self.caches, name)
        k[slot, model.cache_index[l], 0, 0, 0] = float("nan")
        return slot

    def corrupt_page_table(self, slot: int) -> bool:
        """Ledger-divergence injection: unmap a lane's page-table row behind
        the allocator's back. The host ledger still says the slot owns its
        pages; the table the next window uploads says it owns none —
        exactly the corruption the in-band ``PAGE_FAULT`` probe latches at
        the next step. Returns True iff there was a mapped row."""
        if not (self.paged and self.layout.has_paged_leaves):
            return False
        if int(self.page_table[slot, 0]) >= self.layout.num_pages:
            return False
        self.page_table[slot, :] = self.layout.sentinel
        return True

    def preempt_slot(self, slot: int) -> bool:
        """Preemption injection: pull ``slot``'s request out mid-flight and
        requeue it ahead of its class — the zero-drop contract of the paged
        memory-pressure eviction, as an explicit hook. The window in
        flight's lane is invalidated and the page ledger, if any, checked.
        Returns True iff the slot held a request."""
        if not self.sched.slots[slot].active:
            return False
        req = self.sched.preempt(slot)    # on_release reclaims any pages
        self.queue.requeue(req)
        if self._pending is not None:
            self._pending.valid[slot] = False
        self._check_pages()
        return True

    def state_fault_layers(self) -> list[int]:
        """The layers :meth:`inject_state_fault` poisons, from the config
        and ``max_len`` alone (no device read)."""
        model, cfg = self.model, self.cfg
        if model.state_leaves:
            n_scan = cfg.num_periods * cfg.period
            return [l for l in model.recurrent_layers
                    if l >= n_scan or (cfg.num_periods and l < cfg.period)]
        for l in self._jax_tree_order():
            kind = cfg.pattern_layers[l]
            if kind in KV_LEAVES and (
                    model.kv_capacity(kind, self.max_len) == self.max_len):
                return [l]
        raise ValueError(f"{cfg.name}: no recurrent state or full-attention "
                         "KV to poison")

    def _jax_tree_order(self) -> list[int]:
        """The layers in the order the JAX cache tree flattens them: the
        period-0 layer of each pattern position (``periods["b<pos>"]``, keys
        in sorted order), then the remainder layers."""
        cfg = self.cfg
        n_scan = cfg.num_periods * cfg.period
        heads = (sorted(range(cfg.period), key=lambda p: f"b{p}")
                 if cfg.num_periods else [])
        return heads + list(range(n_scan, cfg.num_layers))

    def _inject_words(self, words: torch.Tensor, shape: tuple) -> torch.Tensor:
        """OR the injector's validated fault words for this dispatch into
        the device words, before masking and enumeration."""
        if self._injector is None:
            return words
        inj = self._injector(self._step_count, shape)
        if inj is None:
            return words
        inj = np.asarray(inj, np.uint32)
        if inj.shape != shape:
            raise ValueError(
                f"fault_injector returned shape {inj.shape}, expected {shape}")
        bad = int(np.bitwise_or.reduce(inj, axis=None)) & ~int(
            INJECTABLE_CODE_MASK)
        if bad:
            raise ValueError(
                f"fault_injector word {bad:#x} carries non-injectable bits "
                "(attribution-only / hard / undefined)")
        return words | torch.from_numpy(inj.astype(np.int32)).to(self.device)

    # ------------------------------------------------------------- step cycle
    def step(self) -> list[Response]:
        """One scheduler cycle: expire → admit (a blocking prefill, or a
        prefill lane with overlap) → one stepwise step, or dispatch window
        N+1 and retire window N. Returns every request answered."""
        now = self.clock()
        out: list[Response] = []
        for req in self.queue.drain_expired(now):
            out.append(Response(id=req.id, status=EXPIRED,
                                latency_s=now - req.arrival_t,
                                replica=self.rank,
                                detail="deadline passed in queue",
                                trace_id=req.trace_id))
        out.extend(self.sched.expire_active(now))
        for slot, _req in self.sched.backfill(now):
            if self.trace.enabled and _req.trace_id is not None:
                self.trace.instant("slot_assign", "sched", ts=now, tid=slot,
                                   trace_id=_req.trace_id, slot=slot)
            if self.overlap:
                # admission is a background lane: the scheduler chunks the
                # prompt into subsequent decode windows — no blocking prefill
                self.sched.begin_prefill(slot)
            else:
                resp = self._prefill_slot(slot)
                if resp is not None:
                    out.append(resp)
        self.metrics.record_active_slots(self.sched.in_flight())
        if self.window:
            if self.sched.has_active() or self._pending is not None:
                out.extend(self._window_cycle())
        elif self.sched.has_active():
            out.extend(self._decode_step())
        for resp in out:
            self.metrics.record_response(resp)
        if self.trace.enabled:
            t_done = self.clock()
            for resp in out:
                self.trace.end_request(resp, t_done)
            self._sweep_recoveries(t_done)
        return out

    def run(self, *, max_steps: int = 100_000) -> list[Response]:
        """Serve until the queue and all slots drain; returns all responses.
        Raises if ``max_steps`` is exhausted with work still pending."""
        out: list[Response] = []
        for _ in range(max_steps):
            if self.idle():
                return out
            out.extend(self.step())
        if not self.idle():
            raise RuntimeError(
                f"replica {self.rank}: {len(self.queue)} queued + "
                f"{self.sched.in_flight()} in-flight requests unanswered "
                f"after {max_steps} steps")
        return out

    def idle(self) -> bool:
        return (not len(self.queue) and not self.sched.has_active()
                and self._pending is None)

    # ------------------------------------------------------ recovery lanes
    def _trace_recovery_begin(self, slot: int, trace_id: Optional[int],
                              code: int, action: str, window: int,
                              now: float) -> None:
        """Open a recovery lane for ``slot``, first closing as re-faulted
        any lane the slot still had open (its recompute faulted again
        before a healthy token)."""
        old = self._recovering.pop(slot, None)
        if old is not None:
            self.trace.span("recovery", "recovery", old["t0"], now, tid=slot,
                            trace_id=old["trace_id"], slot=slot,
                            window=old["window"], action=old["action"],
                            code=old["code"], outcome="refaulted")
        if trace_id is None:
            return
        self._recovering[slot] = {"trace_id": trace_id, "t0": now,
                                  "code": code, "action": action,
                                  "window": window}

    def _trace_recovery_end(self, slot: int, trace_id: Optional[int],
                            now: float, outcome: str) -> None:
        """Close ``slot``'s recovery lane: the span runs from the recovery
        decision to the first healthy token after it."""
        ctx = self._recovering.get(slot)
        if ctx is None or ctx["trace_id"] != trace_id:
            return
        del self._recovering[slot]
        self.trace.span("recovery", "recovery", ctx["t0"], now, tid=slot,
                        trace_id=trace_id, slot=slot, window=ctx["window"],
                        action=ctx["action"], code=ctx["code"],
                        outcome=outcome)

    def _sweep_recoveries(self, now: float) -> None:
        """Close the recovery lanes whose request left the slot without a
        token after the recovery (FAILED, EXPIRED, preempted): its terminal
        response resolves the fault, and the span records the recompute as
        abandoned."""
        for slot, ctx in list(self._recovering.items()):
            s = self.sched.slots[slot]
            if s.active and s.req.trace_id == ctx["trace_id"]:
                continue
            del self._recovering[slot]
            self.trace.span("recovery", "recovery", ctx["t0"], now, tid=slot,
                            trace_id=ctx["trace_id"], slot=slot,
                            window=ctx["window"], action=ctx["action"],
                            code=ctx["code"], outcome="abandoned")

    def _fault_event(self, t: float, slot: int, trace_id: Optional[int],
                     word: int, action: str, **where) -> None:
        """One ``fault`` event: the slot's exact error word, its classes,
        the recovery action, and where it latched (``window``/``step``)."""
        self.trace.instant(
            "fault", "fault", ts=t, tid=slot, trace_id=trace_id, slot=slot,
            **where, code=word,
            code_names=[c.name for c in ErrorCode(word).classes()],
            action=action)

    # ------------------------------------------------------- stepwise engine
    def _decode_step(self) -> list[Response]:
        self._step_count += 1
        S = self.sched.num_slots
        tokens, pos = self.sched.step_inputs()
        mask = self.sched.active_mask().astype(np.int32)
        logits, words = self._decode(self.caches, self._to_device(tokens),
                                     self._to_device(pos))
        words = self._inject_words(words, (S,))
        combined, count, table = slot_enum(words, self._to_device(mask))
        fut = DeviceFuture(outputs=logits, word=combined, count=count,
                           table=table)
        try:
            self._slot_logits = fut.wait()
            return self._commit(skip=frozenset())
        except PropagatedError as exc:
            return self._recover(exc, fut)

    def _commit(self, skip: frozenset) -> list[Response]:
        now = self.clock()
        out = []
        # argmax on the device: S int32 to the host, not S×V logits
        toks = readback(torch.argmax(self._slot_logits, dim=-1))
        committed = 0
        for slot in self.sched.active_slots():
            if slot in skip:
                continue
            resp = self.sched.commit_token(slot, int(toks[slot]), now)
            committed += 1
            if resp is not None:
                out.append(resp)
        self.metrics.record_step(committed)
        return out

    def _recover(self, exc: PropagatedError,
                 fut: DeviceFuture) -> list[Response]:
        """Stepwise recovery: no window history — the enumeration's
        ``(slot, code)`` pairs are the attribution. The other slots' outputs
        of the step are valid (rows are independent), so they commit and
        only the attributed lanes recompute."""
        decision = self.policy.decide(exc, self._step_count)
        num_slots = self.sched.num_slots
        faulted = sorted({e.rank for e in exc.errors if 0 <= e.rank < num_slots})
        if not faulted:                      # unattributed word: assume all
            faulted = list(self.sched.active_slots())
        self.metrics.record_fault(self._step_count, int(exc.combined_code),
                                  decision.action.value, tuple(faulted))
        slot_codes: dict[int, int] = {}
        if self.trace.enabled:
            # no window history: the enumeration's (slot, code) pairs are
            # the exact attribution
            for e in exc.errors:
                if 0 <= e.rank < num_slots:
                    slot_codes[e.rank] = slot_codes.get(e.rank, 0) | int(e.code)
            t_fault = self.clock()
            for slot in faulted:
                s = self.sched.slots[slot]
                self._fault_event(
                    t_fault, slot, s.req.trace_id if s.active else None,
                    slot_codes.get(slot, int(exc.combined_code)),
                    decision.action.value, step=self._step_count)
        self._slot_logits = fut.outputs
        if decision.action is Action.ROLLBACK:
            # escalation: recompute every lane (whole-batch recompute is the
            # serving analogue of restoring the last checkpoint)
            targets, fail_now = list(self.sched.active_slots()), False
        elif decision.action is Action.ABORT:
            targets, fail_now = faulted, True
        else:   # SKIP_BATCH / RESTORE_GOOD / CONTINUE / ... → per-sequence LFLR
            targets, fail_now = faulted, False
        out = self._commit(skip=frozenset(targets))
        faulted_set = set(faulted)
        for slot in targets:
            if not self.sched.slots[slot].active:
                continue                     # already evicted this cycle
            # only the attributed slots pay a retry: a healthy lane swept
            # into a ROLLBACK recompute must not burn its budget
            if slot in faulted_set:
                retries = self.sched.note_retry(slot)
            else:
                retries = self.sched.request(slot).retries
            if fail_now or retries > self.max_request_retries:
                out.append(self.sched.evict(
                    slot, FAILED,
                    detail=f"{decision.reason} (retries={retries})"))
                continue
            if self.trace.enabled:
                word = (slot_codes.get(slot, int(exc.combined_code))
                        if slot in faulted_set else 0)
                self._trace_recovery_begin(
                    slot, self.sched.request(slot).trace_id, word,
                    decision.action.value, self._step_count, self.clock())
            resp = self._prefill_slot(slot)  # LFLR: recompute, don't restart
            if resp is not None:
                out.append(resp)
        return out

    # --------------------------------------------------------------- prefill
    def _prefill_slot(self, slot: int) -> Optional[Response]:
        """*Blocking* (re-)compute of a slot's cache from its full token
        history, committing the next token from the prefill logits. Serves
        admission and LFLR on the stepwise and non-overlapped window
        engines. It runs at the slots' batch size with every row holding the
        sequence, into the scratch cache, and keeps row ``slot`` (module
        docstring); a faulted prefill retries until the request's retries
        pass ``max_request_retries``, then the request FAILs. The wall time
        inside — the stall every healthy slot pays — goes to
        ``metrics.record_host_stall``.

        Paged, each attempt frees the lane's pages and acquires pages for
        the whole sequence and its first generated position, and the
        prefill writes the rebuilt cache straight into them (every row
        holding the lane's view, row ``slot`` scattered back): there is no
        cache to insert afterwards.

        In window mode this is also the patch point of the double-buffered
        pipeline: the lane's next token and position are written into the
        device tensors the next dispatch reads (outputs of the window in
        flight), and the lane is marked invalid in that window so its stale
        block is skipped at retirement."""
        t0 = self.clock()
        S = self.sched.num_slots
        if self.trace.enabled:
            # read before the commit: a finishing lane clears its slot
            tr = self.sched.request(slot).trace_id
            first_before = self.sched.slots[slot].t_first
        try:
            while True:
                seq = np.asarray(self.sched.sequence_tokens(slot), np.int32)
                tokens = self._to_device(seq)[None].expand(S, -1)
                if self.paged:
                    self._release_pages(slot)
                    self._check_pages()
                    if self._grow_slot(slot, len(seq) + 1,
                                       exclude_self=True) is None:
                        raise RuntimeError("blocking prefill self-evicted")
                    row = self._to_device(self.page_table[slot].copy())
                    logits, _, word = self._prefill(self.caches, row, slot,
                                                    tokens)
                else:
                    logits, _, word = self._prefill(tokens, self.max_len,
                                                    cache=self._scratch)
                fut = DeviceFuture(outputs=logits, word=word)
                try:
                    logits = fut.wait()
                    break
                except PropagatedError as exc:
                    retries = self.sched.note_retry(slot)
                    self.metrics.record_fault(self._step_count,
                                              int(exc.combined_code),
                                              "prefill_retry", (slot,))
                    if self.trace.enabled:
                        word = int(exc.combined_code)
                        self._fault_event(self.clock(), slot, tr, word,
                                          "prefill_retry",
                                          step=self._step_count)
                        self._trace_recovery_begin(
                            slot, tr, word, "prefill_retry",
                            self._step_count, self.clock())
                    if retries > self.max_request_retries:
                        return self.sched.evict(
                            slot, FAILED,
                            detail=f"prefill faulted {retries} times: {exc}")
            tok = int(readback(torch.argmax(logits[slot, -1])))
            if not self.paged:
                insert_cache_slot(self.caches, self._scratch, slot, slot)
            t_commit = self.clock()
            resp = self.sched.commit_token(slot, tok, t_commit)
            self.metrics.record_prefill(1)
            if self.trace.enabled and tr is not None:
                self.trace.span("prefill", "prefill", t0, t_commit, tid=slot,
                                trace_id=tr, slot=slot, tokens=len(seq))
                if first_before is None:
                    self.trace.instant("first_token", "request", ts=t_commit,
                                       tid=slot, trace_id=tr)
                self._trace_recovery_end(slot, tr, t_commit, "recovered")
            if self.window:
                s = self.sched.slots[slot]
                pos = s.seq_len - 1 if s.active else 0
                # fills queued on the stream: indexing a device tensor with
                # a host value would copy it through a synchronising H2D
                self._dev_tokens.narrow(0, slot, 1).fill_(tok)
                self._dev_pos.narrow(0, slot, 1).fill_(pos)
                self._host_pos[slot] = pos
                if self._pending is not None:
                    self._pending.valid[slot] = False
            return resp
        finally:
            self.metrics.record_host_stall(self.clock() - t0)

    # --------------------------------------------------------- window engine
    def _window_cycle(self) -> list[Response]:
        """Double-buffered commit loop: dispatch window N+1 from window N's
        device-resident outputs *before* reading back window N's tokens."""
        prev = self._pending
        self._pending = (self._dispatch_window()
                         if self.sched.has_active() else None)
        return self._retire_window(prev) if prev is not None else []

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device, non_blocking=True)

    def _dispatch_window(self) -> _WindowInFlight:
        self._step_count += 1
        sched, K = self.sched, self.window
        S = sched.num_slots
        t_disp = self.clock() if self.trace.enabled else 0.0
        # speculating, the prompt feed rides the verify width: up to
        # K (D + 1) prompt tokens per lane a window
        width = self.draft_len + 1 if self.speculate else 1
        plan = sched.plan_prefill(K * width) if self.overlap else {}
        if self.paged:
            # page maintenance first: lane restarts recycle their pages,
            # every writing lane gets its growth pages, eviction preempts
            # under pressure — host bookkeeping and queued device work
            self._paged_prepare(plan)
        mask = sched.active_mask().astype(np.int32)
        req_ids = tuple(s.req.id if s.active else None for s in sched.slots)
        lanes = {"start": np.zeros(S, np.int64)}
        if self.speculate:
            lanes.update(start_row=np.zeros(S, np.int64),
                         rem0=np.zeros(S, np.int64), deferred=np.zeros(S, bool))
        feed = (self._plan_chunks(plan, mask, lanes, t_disp) if self.overlap
                else ())
        # one upload per window, from a copy: the host table may change
        # before the copy engine reads it
        table = ((self._to_device(self.page_table.copy()),) if self.paged
                 else ())
        out = self._decode_window(self.caches, self._dev_tokens, self._dev_pos,
                                  *feed, *table)
        if self.speculate:
            # the position chain stays on the device; tokens and counts go
            # back in one copy
            toks, counts, words, self._dev_tokens, self._dev_pos = out
            outputs = torch.cat([toks.flatten(), counts.flatten()])
        else:
            outputs, words, self._dev_tokens, self._dev_pos = out
            self._host_pos += K
        words = self._inject_words(words, (K, S))
        combined, count, table, hist = window_enum(
            words, self._to_device(mask), self._ignore_codes)
        fut = DeviceFuture(outputs=outputs, word=combined, count=count,
                           table=table, history=hist,
                           event=record_event(self.device))
        return _WindowInFlight(
            fut=fut, req_ids=req_ids, valid=np.ones(S, bool), **lanes,
            t_dispatch=t_disp, index=self._step_count,
            trace_ids=(tuple(s.req.trace_id if s.active else None
                             for s in sched.slots)
                       if self.trace.enabled else ()))

    def _plan_chunks(self, plan: dict, mask: np.ndarray, lanes: dict,
                     t_disp: float) -> tuple:
        """The overlapped window's prompt feed on the device, ``(chunk (K,
        S), rem (S,))`` or, speculating, ``(chunk (K, D + 1, S), rem (S,))``,
        from the scheduler's ``plan``; deferred lanes are masked out, and
        the per-lane arrays of ``lanes`` (:class:`_WindowInFlight`'s
        ``start`` and, speculating, ``start_row``, ``rem0`` and
        ``deferred``) set in place."""
        sched, K = self.sched, self.window
        S = sched.num_slots
        width = self.draft_len + 1 if self.speculate else 1
        chunk = np.zeros((K, width, S), np.int32)
        rem = np.zeros((S,), np.int32)
        for slot, cp in plan.items():
            if not sched.slots[slot].active:
                continue                 # preempted by the page-pressure loop
            if cp.rem == 0:
                # deferred fresh lane: no valid state yet — fully masked
                mask[slot] = 0
                lanes["start"][slot] = K
                if self.speculate:
                    lanes["deferred"][slot] = True
                continue
            if cp.fresh and not self.paged:
                # lane (re)start: the slot's row of EVERY cache tensor (K/V,
                # recurrent state, conv history) back to the fresh zeros and
                # position 0, queued on the device stream — never a host
                # sync (paged: _paged_prepare did it, with the page
                # free, re-acquire and scrub in place of the K/V reset)
                reset_cache_slot(self.caches, slot)
                self._dev_pos.narrow(0, slot, 1).fill_(0)
                self._host_pos[slot] = 0
            chunk.reshape(K * width, S)[:cp.rem, slot] = cp.tokens
            rem[slot] = cp.rem
            # flip point: the argmax after the last prompt token is the first
            # committable token — step kf, verify row rf
            kf, rf = divmod(cp.rem - 1, width)
            lanes["start"][slot] = kf if cp.exhausts else K
            if self.speculate:
                lanes["start_row"][slot] = rf if cp.exhausts else 0
                lanes["rem0"][slot] = cp.rem
            self.metrics.record_chunk(cp.rem)
            if self.trace.enabled:
                tr = sched.slots[slot].req.trace_id
                if tr is not None:
                    self.trace.instant(
                        "chunk", "prefill", ts=t_disp, tid=slot,
                        trace_id=tr, slot=slot, tokens=cp.rem,
                        fresh=cp.fresh, exhausts=cp.exhausts,
                        window=self._step_count)
        if not self.speculate:
            chunk = np.ascontiguousarray(chunk[:, 0])   # one token a step
        return self._to_device(chunk), self._to_device(rem)

    def _retire_window(self, win: _WindowInFlight) -> list[Response]:
        if not win.fut.done():
            # the device is still computing this window at its retirement —
            # the pipeline, not the host, is the bottleneck right now
            self.metrics.record_window_wait()
            if self.trace.enabled:
                self.trace.instant("window_wait", "window", window=win.index)
        try:
            block = win.fut.wait()
        except PropagatedError as exc:
            if self.trace.enabled:
                self.trace.span("window", "window", win.t_dispatch,
                                self.clock(), window=win.index, faulted=True)
            return self._recover_window(win, exc)
        if self.trace.enabled:
            self.trace.span("window", "window", win.t_dispatch, self.clock(),
                            window=win.index, faulted=False)
        toks, counts = self._read_block(block)
        if counts is not None:
            self._note_advance(win, counts)
        return self._commit_window(win, toks, counts=counts)

    def _read_block(self, block: torch.Tensor):
        """A retired window's outputs on the host, in one copy: the tokens
        ``(K, S)`` and None, or, speculating, the tokens ``(K, S, D + 1)``
        and the accepted counts ``(K, S)``."""
        host = readback(block)
        if not self.speculate:
            return host, None
        K, S = self.window, self.sched.num_slots
        n = K * S * (self.draft_len + 1)
        return host[:n].reshape(K, S, -1), host[n:].reshape(K, S)

    def _note_advance(self, win: _WindowInFlight, counts: np.ndarray,
                      metric_limits: Optional[np.ndarray] = None) -> None:
        """Fold a retired speculative window's accepted counts into the host
        position mirror — the one place the host learns how far the device
        chain advanced — for the lanes still held by the request they were
        dispatched for and not restarted meanwhile (a restart reset the
        mirror with the device position). Also counts the drafted and
        accepted tokens: step k of a lane fed ``rem0`` prompt tokens forces
        ``f_k = max(clip(rem0 - k (D + 1), 0, D + 1), 1)`` rows, drafts the
        other ``D + 1 - f_k``, and accepted drafts are what the count shows
        past the forced rows. ``metric_limits`` (each lane's first faulting
        step) caps the counters — steps from a real fault on ran on
        corrupted state — while the mirror folds the whole window, as the
        device chain advanced through every step."""
        D1, K = self.draft_len + 1, self.window
        drafted = accepted = 0
        per_slot: dict[int, tuple[int, int]] = {}
        for slot, rid in enumerate(win.req_ids):
            if rid is None or not win.valid[slot] or win.deferred[slot]:
                continue
            s = self.sched.slots[slot]
            if s.active and s.req.id == rid:
                self._host_pos[slot] += int(counts[:, slot].sum())
            lim = K if metric_limits is None else int(metric_limits[slot])
            forced = np.maximum(
                np.clip(int(win.rem0[slot]) - np.arange(lim) * D1, 0, D1), 1)
            d = int((D1 - forced).sum())
            if d > 0:
                a = int(counts[:lim, slot].sum() - forced.sum())
                drafted += d
                accepted += a
                per_slot[slot] = (d, a)
        if drafted:
            self.metrics.record_spec(drafted, accepted, per_slot)
            if self.trace.enabled:
                self.trace.instant("speculate", "spec", window=win.index,
                                   drafted=drafted, accepted=accepted)

    def _flat_block(self, win: _WindowInFlight, toks: np.ndarray,
                    counts: np.ndarray, slot: int, lo: int,
                    hi: int) -> list[int]:
        """A speculative lane's committable tokens, flattened: window steps
        ``lo .. hi - 1``, each contributing its accepted rows, from the
        lane's flip row in its flip step (the rows before it are the
        argmaxes at prompt positions, fed, not generated)."""
        out = []
        for k in range(lo, hi):
            j0 = int(win.start_row[slot]) if k == lo else 0
            out.extend(int(toks[k, slot, j])
                       for j in range(j0, int(counts[k, slot])))
        return out

    def _commit_window(self, win: _WindowInFlight, toks: np.ndarray,
                       limits: Optional[np.ndarray] = None,
                       counts: Optional[np.ndarray] = None) -> list[Response]:
        """Commit each lane's block from its first real step up to EOS /
        token budget / its fault boundary (``limits``, in window steps);
        trailing tokens are discarded. Lanes whose request left the slot, or
        whose state was restarted mid-flight, are skipped. Speculating
        (``counts`` given), a step contributes its accepted tokens, 1 to
        ``D + 1``, instead of one."""
        now = self.clock()
        K = self.window
        out: list[Response] = []
        committed = discarded = 0
        for slot, rid in enumerate(win.req_ids):
            if rid is None:
                continue                         # lane was free at dispatch
            lo = int(win.start[slot])
            if counts is None:
                emitted = K - lo
            else:
                # the flip step's leading prompt rows are fed, not generated
                emitted = max(int(counts[lo:, slot].sum())
                              - int(win.start_row[slot]), 0)
            s = self.sched.slots[slot]
            if not s.active or s.req.id != rid or not win.valid[slot]:
                discarded += emitted
                continue
            limit = K if limits is None else int(limits[slot])
            if limit <= lo:
                block = []
            elif counts is None:
                block = toks[lo:limit, slot]
            else:
                block = self._flat_block(win, toks, counts, slot, lo, limit)
            if self.trace.enabled:
                # read before the commit: a finishing lane clears its slot
                tr = s.req.trace_id
                first_before = s.t_first
            k, done = (self.sched.commit_block(slot, block, now)
                       if len(block) else (0, None))
            committed += k
            discarded += emitted - k
            if self.trace.enabled and tr is not None:
                self.trace.span("decode", "window", win.t_dispatch, now,
                                tid=slot, trace_id=tr, window=win.index,
                                committed=k, discarded=emitted - k)
                if k and first_before is None:
                    self.trace.instant("first_token", "request", ts=now,
                                       tid=slot, trace_id=tr)
                if k:
                    self._trace_recovery_end(slot, tr, now, "recovered")
            if done is not None:
                out.append(done)
        self.metrics.record_window(committed, discarded, K)
        return out

    def _recover_window(self, win: _WindowInFlight,
                        exc: PropagatedError) -> list[Response]:
        """Deferred-detection recovery: the ``(K, slots)`` history attributes
        the fault to its exact ``(step, slot)``; the clean prefix before the
        fault step commits and only the faulted lane recomputes (LFLR)."""
        num_slots = self.sched.num_slots
        K = self.window
        faulted = sorted({e.rank for e in exc.errors if 0 <= e.rank < num_slots})
        if not faulted:                      # unattributed word: assume all
            faulted = list(self.sched.active_slots())
        # a lane restarted while this window was in flight re-reports its old
        # fault (the window computed with the poisoned state) — stale: drop it
        faulted = [s for s in faulted if win.valid[s]]
        toks, counts = self._read_block(win.fut.outputs)
        if not faulted:
            if counts is not None:
                self._note_advance(win, counts)
            return self._commit_window(win, toks, counts=counts)
        # each lane's first *faulting* step: attribution-only lanes
        # (speculation misses) are masked out, so a rejected draft never
        # cuts the clean prefix, and a real fault drops every token from its
        # step on (no stale draft token commits)
        steps = win.fut.fault_steps(ignore=self._ignore_codes)
        limits = np.full(num_slots, K, np.int64)
        for slot in faulted:
            limits[slot] = steps[slot] if steps[slot] >= 0 else 0
        if counts is not None:
            self._note_advance(win, counts, metric_limits=limits)
        decision = self.policy.decide(exc, self._step_count)
        self.metrics.record_fault(self._step_count, int(exc.combined_code),
                                  decision.action.value, tuple(faulted))
        # the per-slot words: the window history's OR-fold, which never
        # truncates (unlike the enumeration table), read back once with the
        # fault steps above
        codes = (win.fut.fault_codes()
                 if (self.paged or self.trace.enabled) else None)
        if self.paged:
            # a page-ownership fault gets its own record: the LFLR re-queue
            # repairs it too (free + re-acquire rebuilds the mapping), but a
            # PAGE_FAULT means the host ledger and the device table diverged
            page_slots = tuple(s for s in faulted
                               if int(codes[s]) & int(ErrorCode.PAGE_FAULT))
            if page_slots:
                self.metrics.record_fault(self._step_count,
                                          int(ErrorCode.PAGE_FAULT),
                                          "page_reclaim", page_slots)
        if self.trace.enabled:
            # one fault event per attributed slot: its exact word, and the
            # (window, step) the history latched it at. Speculating, the
            # word keeps the DRAFT_REJECT bits of the steps (attribution);
            # the step is the first that faulted without them
            t_fault = self.clock()
            for slot in faulted:
                self._fault_event(
                    t_fault, slot,
                    win.trace_ids[slot] if win.trace_ids else None,
                    int(codes[slot]), decision.action.value,
                    window=win.index,
                    step=int(steps[slot]) if steps[slot] >= 0 else None)
        if decision.action is Action.ROLLBACK:
            targets, fail_now = list(self.sched.active_slots()), False
        elif decision.action is Action.ABORT:
            targets, fail_now = faulted, True
        else:   # SKIP_BATCH / RESTORE_GOOD / CONTINUE / ... → per-sequence LFLR
            targets, fail_now = faulted, False
        out = self._commit_window(win, toks, limits=limits, counts=counts)
        faulted_set = set(faulted)
        for slot in targets:
            s = self.sched.slots[slot]
            if not s.active or s.req.id != win.req_ids[slot]:
                continue                     # finished inside its prefix
            if slot in faulted_set:
                retries = self.sched.note_retry(slot)
            else:
                retries = self.sched.request(slot).retries
            if fail_now or retries > self.max_request_retries:
                out.append(self.sched.evict(
                    slot, FAILED,
                    detail=f"{decision.reason} (retries={retries})"))
                if self._pending is not None:
                    # the in-flight window computed with the same poisoned
                    # state; its lane would re-raise this fault at retire
                    self._pending.valid[slot] = False
                continue
            if self.trace.enabled:
                word = int(codes[slot]) if slot in faulted_set else 0
                self._trace_recovery_begin(
                    slot, s.req.trace_id, word, decision.action.value,
                    win.index, self.clock())
            resp = self._lflr_slot(slot)     # LFLR: recompute, don't restart
            if resp is not None:
                out.append(resp)
        return out

    def _lflr_slot(self, slot: int) -> Optional[Response]:
        """Window-mode LFLR recompute for one lane.

        Overlapped: re-queue it as a prefill lane — the scheduler chunks
        prompt + committed tokens back into the cache through the next
        windows (the cache reset rides the next dispatch), and the in-flight
        window's stale lane is invalidated. The host never blocks. Blocking
        mode: the synchronous re-prefill."""
        if not self.overlap:
            return self._prefill_slot(slot)
        self.sched.begin_prefill(slot)
        if self._pending is not None:
            self._pending.valid[slot] = False
        return None
