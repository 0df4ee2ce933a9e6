# Trimmed copy of repro/core/resilient.py: the Event/EventLog records ServeMetrics exports.
"""Event records shared by the training executor and the serving metrics."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Event:
    step: int
    kind: str                  # ok|fault|straggler|checkpoint|shrink
    detail: str = ""
    code: int = 0
    action: Optional[str] = None
    duration_s: float = 0.0
    t: float = 0.0             # wall clock (monotonic) the event was recorded at


@dataclass
class EventLog:
    events: list[Event] = field(default_factory=list)

    def add(self, ev: Event) -> None:
        self.events.append(ev)

    def faults(self) -> list[Event]:
        return [e for e in self.events if e.kind == "fault"]

    def by_action(self, action) -> list[Event]:
        """The events whose recovery action is ``action`` (an
        :class:`~repro_torch.core.recovery.Action`)."""
        return [e for e in self.events if e.action == action.value]
