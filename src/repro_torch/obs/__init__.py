# Copy of repro/obs/__init__.py.
"""repro_torch.obs — end-to-end fault-causality tracing.

Span-based observability for the serving (and training) stack: a trace id is
stamped on every accepted request, carried through scheduler slot assignment,
window dispatch/retire, prefill chunks, paged-KV page movement, speculative
draft/verify, every recovery lane, and the ServeGroup's kill → shrink →
re-route choreography; the on-device ``(K, slots)`` error-word histories are
mapped onto host-time spans so each :class:`~repro_torch.core.errors.ErrorCode`
class becomes a causal edge. Export is Chrome/Perfetto ``trace_event`` JSON;
:mod:`~repro_torch.obs.postmortem` reconstructs timelines and the fault
report from it.
"""
from .postmortem import (  # noqa: F401
    FaultResolution,
    events_of,
    fault_report,
    format_fault_report,
    format_timeline,
    group_chains,
    request_timelines,
    validate,
)
from .trace import (  # noqa: F401
    ENGINE_TID,
    NULL_TRACER,
    NullTracer,
    Tracer,
    dump_trace,
    event_log_to_events,
    load_trace,
    merge_trace_dicts,
    merge_traces,
)
