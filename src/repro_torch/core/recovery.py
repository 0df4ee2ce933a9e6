# Trimmed copy of repro/core/recovery.py: Action, RecoveryDecision, RecoveryPolicy.
"""Recovery policies — the paper's three use cases (§I) as decision objects.

1. **LFLR** (local failure local recovery): restore only what was lost.
2. **Hierarchical escalation**: local repair plus a (semi-)global reset.
3. **Global rollback**: restore the full state.

A policy receives the exception + context and returns a
:class:`RecoveryDecision`; the caller applies it.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field

from .errors import CommCorruptedError, ErrorCode, PropagatedError, ReproError


class Action(enum.Enum):
    CONTINUE = "continue"              # ignore (log only)
    SKIP_BATCH = "skip_batch"          # drop this step's update, keep state
    RESET_OPTIMIZER = "reset_optimizer"  # use case 2: keep params, reset solver state
    RESTORE_GOOD = "restore_good"      # LFLR: restore last known-good in-memory state
    ROLLBACK = "rollback"              # use case 3: restore from durable checkpoint
    SHRINK = "shrink"                  # hard fault: rebuild communicator/mesh minus dead
    ABORT = "abort"                    # unrecoverable


@dataclass
class RecoveryDecision:
    action: Action
    reason: str = ""
    lr_scale: float = 1.0


@dataclass
class RecoveryPolicy:
    """Escalating default policy (identical decisions to the JAX package's).

    Soft faults: transient → SKIP_BATCH; repeated within ``escalate_window``
    steps → RESTORE_GOOD; divergence → RESET_OPTIMIZER; persistent →
    ROLLBACK. Hard faults → SHRINK (or ROLLBACK when shrinking is impossible).
    """

    escalate_window: int = 20
    max_soft_retries: int = 3
    divergence_lr_decay: float = 0.5
    can_shrink: bool = True

    _recent_faults: list = field(default_factory=list)

    def decide(self, exc: ReproError, step: int) -> RecoveryDecision:
        if isinstance(exc, CommCorruptedError):
            if self.can_shrink:
                return RecoveryDecision(Action.SHRINK,
                                        reason="hard fault: shrink + buddy restore")
            return RecoveryDecision(Action.ROLLBACK,
                                    reason="hard fault without ULFM: rollback")
        if not isinstance(exc, PropagatedError):
            return RecoveryDecision(Action.ABORT, reason=f"unhandled: {exc!r}")

        code = exc.combined_code
        self._recent_faults = [s for s in self._recent_faults
                               if step - s < self.escalate_window]
        self._recent_faults.append(step)
        repeats = len(self._recent_faults)

        if code & ErrorCode.RANK_FAILED:
            return (RecoveryDecision(Action.SHRINK, reason="rank failed")
                    if self.can_shrink else
                    RecoveryDecision(Action.ROLLBACK, reason="rank failed"))
        if repeats > self.max_soft_retries:
            return RecoveryDecision(
                Action.ROLLBACK,
                reason=f"{repeats} soft faults in {self.escalate_window} steps")
        if code & ErrorCode.DIVERGENCE:
            return RecoveryDecision(Action.RESET_OPTIMIZER,
                                    reason="divergence: optimizer reset",
                                    lr_scale=self.divergence_lr_decay)
        if code & (ErrorCode.NONFINITE_LOSS | ErrorCode.NONFINITE_GRAD
                   | ErrorCode.OVERFLOW | ErrorCode.DATA_FAULT):
            if repeats > 1:
                return RecoveryDecision(Action.RESTORE_GOOD,
                                        reason="repeated soft fault: LFLR restore")
            return RecoveryDecision(Action.SKIP_BATCH,
                                    reason="transient soft fault: skip batch")
        if code & ErrorCode.STATE_FAULT:
            return RecoveryDecision(Action.RESTORE_GOOD,
                                    reason="recurrent-state fault: LFLR restore")
        if code & ErrorCode.PAGE_FAULT:
            return RecoveryDecision(Action.RESTORE_GOOD,
                                    reason="page-ownership fault: reclaim + LFLR")
        if code & ErrorCode.ROUTER_OVERFLOW:
            return RecoveryDecision(Action.CONTINUE, reason="router overflow: logged")
        if code & ErrorCode.STRAGGLER:
            return RecoveryDecision(Action.CONTINUE, reason="straggler: logged")
        if code & ErrorCode.USER:
            return RecoveryDecision(Action.SKIP_BATCH, reason="user-signalled")
        return RecoveryDecision(Action.SKIP_BATCH, reason=f"default for {code!r}")

    def reset(self) -> None:
        """Forget the escalation window's fault history."""
        self._recent_faults.clear()
