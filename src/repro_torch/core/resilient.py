"""ResilientExecutor — the paper's technique integrated into the training loop.

The port of ``repro/core/resilient.py``. One object owns the full detection
→ propagation → exception → recovery cycle:

* each step is dispatched asynchronously; its in-band error word is wrapped in
  a :class:`~repro_torch.core.device_channel.DeviceFuture` (the paper's
  ``Future``), with a CUDA event marking the step's end on a card;
* ``wait()`` converts faults into ``PropagatedError`` / ``CommCorruptedError``
  with one host read of the word — the step's only host sync;
* a :class:`~repro_torch.core.recovery.RecoveryPolicy` decides skip / LFLR
  restore / optimizer reset / rollback / shrink; the executor applies it;
* a wall-clock watchdog flags stragglers (EMA-based);
* known-good snapshots (a device copy of every leaf, no sync) refresh every
  ``good_state_interval`` steps; durable checkpoints every
  ``checkpoint_interval`` steps.

The executor is model-agnostic: it only needs a ``step_fn(state, batch,
inject) -> (new_state, metrics, err_word)`` that leaves ``state`` as it was,
and an optional ``reset_opt_fn``. Its :class:`Event`/:class:`EventLog` are
also the serving metrics' records.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional

import torch

from ..tree import tree_map
from .device_channel import DeviceFuture, record_event
from .errors import ErrorCode, ReproError
from .faults import FaultSchedule, apply_host_fault
from .recovery import Action, RecoveryDecision, RecoveryPolicy


@dataclass
class ExecutorConfig:
    good_state_interval: int = 10
    checkpoint_interval: int = 100
    straggler_factor: float = 3.0
    straggler_warmup_steps: int = 5
    step_timeout: Optional[float] = None
    max_consecutive_failures: int = 10


@dataclass
class Event:
    step: int
    kind: str                  # ok|fault|straggler|checkpoint|shrink
    detail: str = ""
    code: int = 0
    action: Optional[str] = None
    duration_s: float = 0.0
    t: float = 0.0             # wall clock (monotonic) the event was recorded
                               # at — spans end here and start duration_s
                               # earlier. 0.0 = legacy unstamped event.


@dataclass
class EventLog:
    events: list[Event] = field(default_factory=list)

    def add(self, ev: Event) -> None:
        self.events.append(ev)

    def faults(self) -> list[Event]:
        return [e for e in self.events if e.kind == "fault"]

    def by_action(self, action: Action) -> list[Event]:
        return [e for e in self.events if e.action == action.value]


def snapshot(state):
    """Defensive device copy of every leaf (the live state's tensors may be
    reused); queued on the device, no host sync."""
    return tree_map(lambda t: t.clone() if torch.is_tensor(t) else t, state)


class ResilientExecutor:
    def __init__(self, step_fn: Callable, *,
                 policy: RecoveryPolicy | None = None,
                 config: ExecutorConfig | None = None,
                 checkpointer=None,
                 reset_opt_fn: Callable | None = None,
                 on_shrink: Callable | None = None,
                 rank: int = 0):
        self.step_fn = step_fn
        self.policy = policy or RecoveryPolicy()
        self.config = config or ExecutorConfig()
        self.checkpointer = checkpointer
        self.reset_opt_fn = reset_opt_fn
        self.on_shrink = on_shrink
        self.rank = rank
        self.log = EventLog()
        self._ema_step_time: Optional[float] = None

    # ------------------------------------------------------------------ dispatch
    def dispatch(self, state, batch, inject: int = 0) -> DeviceFuture:
        new_state, metrics, word = self.step_fn(state, batch, inject)
        return DeviceFuture(outputs=(new_state, metrics), word=word,
                            event=record_event(word.device))

    # ------------------------------------------------------------------ main loop
    def run(self, state, data_iter: Iterator, num_steps: int, *,
            faults: FaultSchedule | None = None, start_step: int = 0):
        faults = faults or FaultSchedule()
        good = snapshot(state)
        good_step = start_step
        consecutive_failures = 0
        step = start_step
        while step < start_step + num_steps:
            batch = next(data_iter)
            inject = faults.inject_word(step, self.rank)

            t0 = time.monotonic()
            # host-level faults (straggle/user) count into the step wall time —
            # a straggling host IS a slow step from the watchdog's perspective
            for spec in faults.at(step, self.rank):
                if spec.kind in ("straggle", "user", "kill"):
                    apply_host_fault(spec)
            fut = self.dispatch(state, batch, inject=inject)
            try:
                # no second name for the new state: one left over from the
                # last good step would keep a whole state alive through the
                # next recovery
                state, _ = fut.wait(timeout=self.config.step_timeout)
                dt = time.monotonic() - t0
                self._watchdog(step, dt)
                consecutive_failures = 0
                self.log.add(Event(step, "ok", duration_s=dt,
                                   t=time.monotonic()))
                # refresh known-good snapshot / durable checkpoint
                if (step - good_step) >= self.config.good_state_interval:
                    good, good_step = snapshot(state), step
                if (self.checkpointer is not None
                        and step % self.config.checkpoint_interval == 0
                        and step > start_step):
                    self.checkpointer.save(step, state)
                    self.log.add(Event(step, "checkpoint",
                                       t=time.monotonic()))
            except ReproError as exc:
                # drop the discarded step's state now: the exception's frames
                # keep the future alive until this handler ends
                fut.outputs = None
                dt = time.monotonic() - t0
                consecutive_failures += 1
                if consecutive_failures > self.config.max_consecutive_failures:
                    self.log.add(Event(step, "fault", detail="abort: too many",
                                       action=Action.ABORT.value,
                                       duration_s=dt, t=time.monotonic()))
                    raise
                decision = self.policy.decide(exc, step)
                code = int(getattr(exc, "combined_code", ErrorCode.COMM_CORRUPTED))
                self.log.add(Event(step, "fault", detail=decision.reason,
                                   code=code, action=decision.action.value,
                                   duration_s=dt, t=time.monotonic()))
                state, good, good_step = self._apply(
                    decision, exc, state, good, good_step, step)
            step += 1
        return state, self.log

    # ------------------------------------------------------------------ recovery
    def _apply(self, decision: RecoveryDecision, exc: ReproError, state, good,
               good_step: int, step: int):
        act = decision.action
        if act in (Action.CONTINUE, Action.SKIP_BATCH):
            return state, good, good_step            # discard faulty update
        if act is Action.RESET_OPTIMIZER:
            if self.reset_opt_fn is None:
                return state, good, good_step
            state = self.reset_opt_fn(state, decision.lr_scale)
            return state, good, good_step
        if act is Action.RESTORE_GOOD:
            return snapshot(good), good, good_step   # LFLR: in-memory restore
        if act is Action.ROLLBACK:
            if self.checkpointer is None:
                return snapshot(good), good, good_step
            restored = self.checkpointer.restore_latest(like=state)
            if restored is None:
                return snapshot(good), good, good_step
            ck_step, restored_state = restored
            return restored_state, snapshot(restored_state), ck_step
        if act is Action.SHRINK:
            if self.on_shrink is None:
                raise exc
            state = self.on_shrink(exc, state)
            self.log.add(Event(step, "shrink", detail="elastic re-mesh",
                               t=time.monotonic()))
            return state, snapshot(state), step
        raise exc  # ABORT

    # ------------------------------------------------------------------ watchdog
    def _watchdog(self, step: int, dt: float) -> None:
        cfg = self.config
        if step == 0:
            # step 0 pays the first launches' set-up (the kernel library's
            # build and load, cuBLAS plans): seeding the EMA with it
            # inflates the threshold and masks real stragglers
            return
        if self._ema_step_time is None:
            self._ema_step_time = dt
            return
        warmed = step >= cfg.straggler_warmup_steps
        if warmed and dt > cfg.straggler_factor * self._ema_step_time:
            self.log.add(Event(step, "straggler",
                               detail=f"{dt:.3f}s vs ema {self._ema_step_time:.3f}s",
                               code=int(ErrorCode.STRAGGLER),
                               t=time.monotonic()))
        # EMA update after detection, robust to the straggler itself
        self._ema_step_time = 0.9 * self._ema_step_time + 0.1 * min(
            dt, 4.0 * self._ema_step_time)
