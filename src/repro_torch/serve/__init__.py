"""repro_torch.serve — fault-tolerant continuous-batching inference on the card.

The port of ``repro.serve`` in window+overlap mode: :class:`Replica` wraps
each K-step decode window in a ``DeviceFuture``, attributes faults to their
``(step, slot)`` through the paper's enumeration, and recovers a faulted
sequence by LFLR without stalling the other slots.
"""
from .config import EngineConfig  # noqa: F401
from .metrics import FaultRecord, ServeMetrics  # noqa: F401
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
from .scheduler import ChunkPlan, ContinuousBatchingScheduler, Slot  # noqa: F401
