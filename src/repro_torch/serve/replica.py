"""Serving replica: zero-sync decode windows with overlapped prefill and
per-sequence LFLR, on one device.

The port of ``repro/serve/replica.py`` in window+overlap mode (``window=K``,
``overlap=True``). K greedy steps run on the device per dispatch
(:func:`~repro_torch.launch.steps.make_prefill_decode_window`); fault
detection is deferred to the window boundary (the paper's asynchrony
contract — errors latch in-band, raise at the *wait*); and the commit loop is
double-buffered: window N+1 is dispatched from window N's device-resident
outputs (next token, next positions, in-place caches) *before* window N's
token block is read back. Admission and LFLR recovery are background prefill
lanes: a joining or recovering slot's sequence is chunked into the same
windows, so the healthy slots' token stream never stalls.

Recovery is the paper's use case 1 applied to inference: non-finite logits
on slot *i* (the probe kernel's word) → LFLR: slot *i* re-prefills its prompt
+ committed tokens through the same decode step (greedy decode is
deterministic, so the recomputed trajectory is the pre-fault one bit for
bit) while the other slots commit their tokens; the
:class:`~repro_torch.core.recovery.RecoveryPolicy` escalates, and a request
that re-faults past ``max_request_retries`` is answered ``FAILED``.

Host syncs: two :func:`~repro_torch.core.device_channel.readback` calls per
retired window (the error word with its enumeration table, then the token
block), plus the window history on the fault path.
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
from ..core.errors import PropagatedError
from ..core.faults import INJECTABLE_CODE_MASK
from ..core.recovery import Action, RecoveryPolicy
from ..launch.steps import make_prefill_decode_window
from ..models.model import Model, reset_cache_slot, slot_layer_view
from .config import EngineConfig
from .metrics import ServeMetrics
from .queue import EXPIRED, FAILED, AdmissionPolicy, Request, RequestQueue, Response
from .scheduler import ContinuousBatchingScheduler


def _check_supported(config: EngineConfig, tracer: Any) -> None:
    """The modes of the JAX replica this port does not run yet."""
    missing = [
        (config.window == 0, "window=0 (the stepwise engine)",
         "ROADMAP Queue 1, item 5 (replica modes still to port)"),
        (not config.overlap, "overlap=False (blocking prefill)",
         "ROADMAP Queue 1, item 5 (replica modes still to port)"),
        (config.paged, "paged=True", "ROADMAP Queue 1, item 7 (paged KV)"),
        (config.speculate, "speculate=True",
         "ROADMAP Queue 1, item 8 (speculative windows)"),
        (config.tp > 1, "tp>1", "ROADMAP Queue 1, item 11 (tensor parallel)"),
        (config.trace or tracer is not None, "tracing",
         "ROADMAP Queue 1, item 9 (tracing and fuzz kits)"),
    ]
    for bad, what, item in missing:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet: {item}")


def window_enum(history: torch.Tensor, mask: torch.Tensor):
    """``(history (K, S), mask (S,)) -> (combined, count, table, hist)`` on
    the device: free slots are masked out of the whole word history, each
    slot's words are OR-folded over the window (one check per K tokens),
    and the paper's enumeration attributes the folds to their slots
    (``max_errors = S``, so attribution never truncates)."""
    hist = history * mask[None, :]
    words = or_reduce(hist, dim=0)
    count, table = enumerate_errors_ref(words, max_errors=words.shape[0])
    return or_reduce(words, dim=0), count, table, hist


@dataclass
class _WindowInFlight:
    """One dispatched decode window awaiting retirement.

    ``req_ids`` snapshots which request occupied each slot at dispatch (None =
    free lane); a lane's block only commits if the same request still holds
    the slot. ``valid`` is cleared for a lane whose state is restarted (LFLR)
    while this window is in flight — its tokens and words are then stale.
    ``start`` is the first committable step per lane: 0 for a decoding slot,
    ``rem - 1`` for a lane whose prompt chunk ends in this window, K for a
    lane still mid-prefill.
    """

    fut: DeviceFuture
    req_ids: tuple
    valid: np.ndarray
    start: np.ndarray


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
                 tracer: Any = None,
                 fault_injector: Optional[Callable] = None):
        config = config if config is not None else EngineConfig()
        _check_supported(config, tracer)
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
        self.max_request_retries = config.max_request_retries
        # deterministic in-band fault-word injection: called once per
        # dispatch with the dispatch index and the (K, slots) words shape;
        # may return a uint32 array OR'd into the device words before
        # enumeration, so injected codes ride the real detection path
        self._injector = fault_injector
        self.window = int(config.window)
        num_slots = config.num_slots
        self.queue = queue or RequestQueue(
            AdmissionPolicy(max_total_len=config.max_len), clock=clock)
        self.sched = ContinuousBatchingScheduler(
            num_slots, self.queue, replica=rank, eos_id=config.eos_id,
            clock=clock, prefill_budget=config.prefill_budget)
        self.caches = self.model.init_cache(num_slots, config.max_len)
        self._decode_window = make_prefill_decode_window(
            self.model, window=self.window)
        self._step_count = 0
        self._pending: Optional[_WindowInFlight] = None
        # the device-resident chain window N+1 consumes: next input token and
        # position per slot (never read back inside or between windows)
        self._dev_tokens = torch.zeros(num_slots, dtype=torch.int32,
                                       device=self.device)
        self._dev_pos = torch.zeros(num_slots, dtype=torch.int32,
                                    device=self.device)

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

    # ------------------------------------------------------------- submission
    def submit(self, req: Request) -> Optional[Response]:
        """Admit a request; returns a ``REJECTED`` response or None (accepted).
        Every accepted request is eventually answered by ``step``/``run``."""
        resp = self.queue.submit(req)
        if resp is not None:
            self.metrics.record_response(resp)
        return resp

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
          full-attention layer, first KV head, first feature); the next
          window's logits for that slot go non-finite and the probe latches
          NONFINITE_LOSS.

        ``slot=None`` picks the first active slot, or a seeded-random one
        with ``rng``. Returns the slot, or None if no slot is active."""
        if slot is None:
            active = self.sched.active_slots()
            if not active:
                return None
            slot = int(rng.choice(active)) if rng is not None else active[0]
        model, cfg = self.model, self.cfg
        if model.state_leaf is not None:
            n_scan = cfg.num_periods * cfg.period
            rows = [model.cache_index[l] for l in model.recurrent_layers
                    if l >= n_scan or (cfg.num_periods and l < cfg.period)]
            state = slot_layer_view(self.caches, model.state_leaf)
            state[(slot, rows) + (0,) * (state.dim() - 2)] = float("nan")
            return slot
        full = [l for l in model.attn_layers if cfg.pattern_layers[l] == "attn"]
        if not full:
            raise ValueError(f"{cfg.name}: no recurrent state or "
                             "full-attention KV to poison")
        k = slot_layer_view(self.caches, "k")
        k[slot, model.cache_index[full[0]], 0, 0, 0] = float("nan")
        return slot

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
        """One scheduler cycle: expire → admit (as prefill lanes) → dispatch
        window N+1 → retire window N. Returns every request answered."""
        now = self.clock()
        out: list[Response] = []
        for req in self.queue.drain_expired(now):
            out.append(Response(id=req.id, status=EXPIRED,
                                latency_s=now - req.arrival_t,
                                replica=self.rank,
                                detail="deadline passed in queue"))
        out.extend(self.sched.expire_active(now))
        for slot, _req in self.sched.backfill(now):
            self.sched.begin_prefill(slot)
        self.metrics.record_active_slots(self.sched.in_flight())
        if self.sched.has_active() or self._pending is not None:
            out.extend(self._window_cycle())
        for resp in out:
            self.metrics.record_response(resp)
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
        plan = sched.plan_prefill(K)
        mask = sched.active_mask().astype(np.int32)
        start = np.zeros(S, np.int64)
        chunk = np.zeros((K, S), np.int32)
        rem = np.zeros((S,), np.int32)
        for slot, cp in plan.items():
            if cp.rem == 0:
                # deferred fresh lane: no valid state yet — fully masked
                mask[slot] = 0
                start[slot] = K
                continue
            if cp.fresh:
                # lane (re)start: the slot's row of EVERY cache tensor (K/V,
                # recurrent state, conv history) back to the fresh zeros and
                # position 0, queued on the device stream — never a host sync
                reset_cache_slot(self.caches, slot)
                self._dev_pos[slot] = 0
            chunk[:cp.rem, slot] = cp.tokens
            rem[slot] = cp.rem
            # flip point: the argmax after the last prompt token is the first
            # committable token
            start[slot] = cp.rem - 1 if cp.exhausts else K
            self.metrics.record_chunk(cp.rem)
        toks, words, self._dev_tokens, self._dev_pos = self._decode_window(
            self.caches, self._dev_tokens, self._dev_pos,
            self._to_device(chunk), self._to_device(rem))
        words = self._inject_words(words, (K, S))
        combined, count, table, hist = window_enum(words, self._to_device(mask))
        fut = DeviceFuture(outputs=toks, word=combined, count=count,
                           table=table, history=hist,
                           event=record_event(self.device))
        return _WindowInFlight(
            fut=fut,
            req_ids=tuple(s.req.id if s.active else None for s in sched.slots),
            valid=np.ones(S, bool), start=start)

    def _retire_window(self, win: _WindowInFlight) -> list[Response]:
        if not win.fut.done():
            # the device is still computing this window at its retirement —
            # the pipeline, not the host, is the bottleneck right now
            self.metrics.record_window_wait()
        try:
            block = win.fut.wait()
        except PropagatedError as exc:
            return self._recover_window(win, exc)
        return self._commit_window(win, readback(block))

    def _commit_window(self, win: _WindowInFlight, toks: np.ndarray,
                       limits: Optional[np.ndarray] = None) -> list[Response]:
        """Commit each lane's block from its first real step up to EOS /
        token budget / its fault boundary (``limits``, in window steps);
        trailing tokens are discarded. Lanes whose request left the slot, or
        whose state was restarted mid-flight, are skipped."""
        now = self.clock()
        K = self.window
        out: list[Response] = []
        committed = discarded = 0
        for slot, rid in enumerate(win.req_ids):
            if rid is None:
                continue                         # lane was free at dispatch
            lo = int(win.start[slot])
            emitted = K - lo
            s = self.sched.slots[slot]
            if not s.active or s.req.id != rid or not win.valid[slot]:
                discarded += emitted
                continue
            limit = K if limits is None else int(limits[slot])
            block = toks[lo:limit, slot] if limit > lo else []
            k, done = (self.sched.commit_block(slot, block, now)
                       if len(block) else (0, None))
            committed += k
            discarded += emitted - k
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
        toks = readback(win.fut.outputs)
        if not faulted:
            return self._commit_window(win, toks)
        steps = win.fut.fault_steps()
        limits = np.full(num_slots, K, np.int64)
        for slot in faulted:
            limits[slot] = steps[slot] if steps[slot] >= 0 else 0
        decision = self.policy.decide(exc, self._step_count)
        self.metrics.record_fault(self._step_count, int(exc.combined_code),
                                  decision.action.value, tuple(faulted))
        if decision.action is Action.ROLLBACK:
            targets, fail_now = list(self.sched.active_slots()), False
        elif decision.action is Action.ABORT:
            targets, fail_now = faulted, True
        else:   # SKIP_BATCH / RESTORE_GOOD / CONTINUE / ... → per-sequence LFLR
            targets, fail_now = faulted, False
        out = self._commit_window(win, toks, limits=limits)
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
            self._lflr_slot(slot)
        return out

    def _lflr_slot(self, slot: int) -> None:
        """LFLR recompute for one lane: re-queue it as a prefill lane — the
        scheduler chunks prompt + committed tokens back into the cache
        through the next windows (the cache reset rides the next dispatch),
        and the in-flight window's stale lane is invalidated. The host never
        blocks."""
        self.sched.begin_prefill(slot)
        if self._pending is not None:
            self._pending.valid[slot] = False
