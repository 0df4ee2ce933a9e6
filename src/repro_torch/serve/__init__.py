"""repro_torch.serve — fault-tolerant continuous-batching inference on the card.

The port of ``repro.serve``: :class:`Replica` wraps each step or K-step
decode window in a ``DeviceFuture``, attributes faults to their ``(step,
slot)`` through the paper's enumeration, and recovers a faulted sequence by
LFLR without stalling the other slots; :class:`ServeGroup` runs a fleet of
replicas over the paper's host protocols (ULFM shrink and re-route on a
replica's death, a write-ahead log to restart a crashed fleet from);
:class:`MultiHostSupervisor` runs the same fault contract across real OS
processes: worker processes (one replica each) under a phi-accrual
heartbeat failure detector, a SIGKILL'd worker detected, mapped to
``RANK_FAILED`` on the survivors and repaired through the same
:func:`agree_round` epoch ladder over a length-prefixed socket transport.
Tracing (:mod:`repro_torch.obs`): pass ``tracer=Tracer(...)`` to a replica,
or ``trace=True`` to a :class:`ServeGroup`, and each request's life becomes
a causal chain of ``trace_event`` spans.
"""
from .config import EngineConfig  # noqa: F401
from .group import (  # noqa: F401
    AgreeDecision,
    GroupResult,
    RankReport,
    ServeGroup,
    agree_round,
)
from .metrics import FaultRecord, ServeMetrics  # noqa: F401
from .multihost import (  # noqa: F401
    MultiHostResult,
    MultiHostSupervisor,
    PhiAccrualDetector,
    sim_tokens,
)
from .queue import (  # noqa: F401
    EXPIRED,
    FAILED,
    OK,
    REJECTED,
    AdmissionPolicy,
    Request,
    RequestQueue,
    Response,
)
from .replica import Replica  # noqa: F401
from .scheduler import (  # noqa: F401
    ChunkPlan,
    ContinuousBatchingScheduler,
    PageAllocator,
    PagePoolExhausted,
    Slot,
)
