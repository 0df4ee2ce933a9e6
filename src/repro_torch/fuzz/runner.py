"""Execute one trajectory against the port's serving stack and judge it.

The port of ``repro/fuzz/runner.py``. No mocks: a trajectory builds a live
:class:`~repro_torch.serve.replica.Replica` (or
:class:`~repro_torch.serve.group.ServeGroup`) over the kits' model, drives it
request for request, injects its faults through the deterministic hooks,
and checks the run against the stack's own contracts — the **oracles**:

1. **Completeness**: every accepted request is answered exactly once, with a
   terminal status in {OK, FAILED}; FAILED is legal only when the trajectory
   injected faults — a clean run must answer everything OK.
2. **Bit-exactness**: every OK token stream equals the clean run of the
   same engine and load, on the same model and device. Greedy LFLR
   recompute is deterministic, so injected faults on any lane must leave
   the final streams bit-identical.
3. **Page-ledger invariants**: ``PageAllocator.check()`` holds at the end of
   every paged run (and, under ``__debug__``, at every preempt, requeue and
   reclaim inside the replica).
4. **Trace causality**: the post-mortem ``validate()`` over the run's trace
   finds no orphans — every traced request one terminal, every fault
   resolved, every recovery span closed, every kill chained to a shrink.
5. **No wedge / no crash**: the drive loop reaches idle within
   ``MAX_CYCLES`` cycles and no exception escapes the stack.

The kits are built over one :class:`~repro_torch.models.Model` and its
device: by default ``Model(smoke_config("qwen3-1.7b"), seed=0)`` on the
card, which raises without one, as every entry point of the port does (the
JAX package's kits init their params with JAX, which the port cannot
import); :func:`use_model` sets another, e.g. the JAX params carried over
with :func:`repro_torch.weights.params_from_jax` on the CPU, or a
full-width model on the card. Each group kit is built once per model and
kept, as the reference keeps its compiled kits. The ``multihost`` engine
runs the sim backend's worker processes, no model. The ``overlap_tp``
engine raises ``NotImplementedError`` (ROADMAP item 11).
"""
from __future__ import annotations

import functools
import hashlib
import json
import os
import shutil
import tempfile
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..configs import smoke_config
from ..core.errors import ErrorCode
from ..core.faults import FaultSchedule, FaultSpec
from ..models.model import Model
from ..obs import postmortem
from ..obs.trace import Tracer, merge_trace_dicts, merge_traces
from ..serve.config import EngineConfig
from ..serve.group import ServeGroup
from ..serve.multihost import MultiHostSupervisor
from ..serve.queue import FAILED, OK, Request
from ..serve.replica import Replica
from .coverage import Cell
from .trajectory import GROUP_ENGINE, MULTIHOST_ENGINE, Op, Trajectory

MODEL = "qwen3-1.7b"      # smoke config: tiny, full-attention → every engine
MAX_CYCLES = 400          # drive-loop bound: far past any legal run length
GROUP_RANKS = 3

# multihost lane timing: a lease short enough that the SIGKILL → evict →
# re-route round trip stays inside a fuzz run's seconds, and a stop pause at
# half the lease so the resumed worker is *provably* inside the no-evict
# guarantee (the false-positive guard is an oracle below, not just
# coverage). The reference's lease is 0.6 s; the port's 1.5 s, because
# worker processes starved on a loaded host miss 0.6 s leases
MULTIHOST_SUSPECT_TIMEOUT = 1.5
MULTIHOST_STOP_PAUSE = 0.5 * MULTIHOST_SUSPECT_TIMEOUT

#: The engines the port does not run yet, with the ROADMAP item of each.
UNPORTED = {"overlap_tp": "ROADMAP Queue 1, item 11 (tensor parallel)"}


# --------------------------------------------------------------- engine kits
@dataclass(frozen=True)
class EngineSpec:
    """Replica-shape knobs for one engine variant (kept tiny: the fuzzer's
    job is path coverage, not throughput)."""

    window: int = 0
    overlap: bool = False
    paged: bool = False
    page_size: int = 8
    speculate: bool = False
    draft_len: int = 2
    draft_layers: int = 1
    max_len: int = 32     # spec engines use 64: verify-width page growth room
    num_slots: int = 2
    tp: int = 1           # tensor-parallel width (not ported: item 11)

    def engine_config(self, max_request_retries: int) -> EngineConfig:
        """This variant's shape as the one validated EngineConfig surface."""
        return EngineConfig(
            num_slots=self.num_slots, max_len=self.max_len,
            max_request_retries=max_request_retries, window=self.window,
            overlap=self.overlap, paged=self.paged, page_size=self.page_size,
            speculate=self.speculate, draft_len=self.draft_len,
            draft_layers=self.draft_layers, tp=self.tp)


#: The reference's specs; ``overlap_tp`` stays, so the mutator draws as the
#: reference's does, and its runs raise.
ENGINE_SPECS: dict[str, EngineSpec] = {
    "stepwise": EngineSpec(),
    "window": EngineSpec(window=4, overlap=False),
    "overlap": EngineSpec(window=4, overlap=True),
    "overlap_tp": EngineSpec(window=4, overlap=True, tp=2),
    "overlap_paged": EngineSpec(window=4, overlap=True, paged=True,
                                page_size=8),
    "spec": EngineSpec(window=4, overlap=True, speculate=True, max_len=64),
    "spec_paged": EngineSpec(window=4, overlap=True, speculate=True,
                             paged=True, page_size=16, max_len=64),
}


@dataclass(frozen=True)
class EngineKit:
    """One engine variant over the kits' model. Each run builds its own
    ``Replica`` from it (its caches and step closures are the replica's;
    the weights are the model's, shared)."""

    engine: str
    spec: EngineSpec
    cfg: object
    model: Model


_MODEL: Optional[Model] = None


@functools.lru_cache(maxsize=None)
def default_model() -> Model:
    """The kits' default model: the qwen3-1.7b smoke config on the card,
    from the port's seeded init. Raises without a card: a CPU run passes
    its model to :func:`use_model`."""
    return Model(smoke_config(MODEL), seed=0)


def kit_model() -> Model:
    return _MODEL if _MODEL is not None else default_model()


def use_model(model: Optional[Model]) -> None:
    """Build the kits over ``model`` (on its device) from now on; None
    restores :func:`default_model`. The cached kits and clean runs of the
    previous model are dropped."""
    global _MODEL
    _MODEL = model
    get_kit.cache_clear()
    _group_kit.cache_clear()
    reference_tokens.cache_clear()


def _check_ported(engine: str) -> None:
    if engine in UNPORTED:
        raise NotImplementedError(
            f"the {engine} engine is not ported yet: {UNPORTED[engine]}")


@functools.lru_cache(maxsize=None)
def get_kit(engine: str) -> EngineKit:
    _check_ported(engine)
    model = kit_model()
    return EngineKit(engine=engine, spec=ENGINE_SPECS[engine], cfg=model.cfg,
                     model=model)


@functools.lru_cache(maxsize=None)
def _group_kit(max_request_retries: int,
               max_ranks: int = GROUP_RANKS) -> ServeGroup:
    model = kit_model()
    return ServeGroup(model.cfg, nranks=GROUP_RANKS, max_ranks=max_ranks,
                      model=model,
                      config=EngineConfig(
                          num_slots=2, max_len=32, window=4, overlap=True,
                          eos_id=None,
                          max_request_retries=max_request_retries,
                          trace=True))


# ----------------------------------------------------------------- injection
class _ScheduledInjector:
    """The ``Replica(fault_injector=...)`` callable for one trajectory: a
    pure lookup from dispatch index to the uint32 word array to OR in — no
    state, no randomness, so replay is bit for bit."""

    def __init__(self, word_ops):
        self._by_index: dict[int, list[Op]] = {}
        for op in word_ops:
            self._by_index.setdefault(op.cycle, []).append(op)

    def __call__(self, index: int, shape: tuple):
        ops = self._by_index.get(index)
        if not ops:
            return None
        w = np.zeros(shape, np.uint32)
        for op in ops:
            if len(shape) == 1:               # stepwise: (slots,)
                w[op.slot % shape[0]] |= np.uint32(op.code)
            else:                             # windowed: (K, slots)
                w[op.step % shape[0], op.slot % shape[1]] |= np.uint32(op.code)
        return w


def _apply_host_op(rep: Replica, op: Op) -> bool:
    """Host-side mutations between drive cycles. The op's slot is a starting
    preference, not a hard target: the lanes are tried in turn from it, and
    the first where the mutation bites takes it (an op on an empty lane
    would be dead code). Returns False when nothing bit this cycle; the
    drive loop retries the op next cycle. Deterministic: a function of
    (op.slot, the lanes' states)."""
    S = rep.sched.num_slots
    for k in range(S):
        slot = (op.slot + k) % S
        if op.op == "poison":
            if (rep.sched.slots[slot].active
                    and rep.inject_state_fault(slot) is not None):
                return True
        elif op.op == "page_table":
            if rep.corrupt_page_table(slot):
                return True
        elif op.op == "preempt":
            if rep.preempt_slot(slot):
                return True
        else:
            raise AssertionError(f"unexpected host op {op!r}")
    return False


# -------------------------------------------------------------------- result
@dataclass
class RunResult:
    trajectory: Trajectory
    responses: dict = field(default_factory=dict)   # id -> Response
    violations: list = field(default_factory=list)
    cells: set = field(default_factory=set)
    summary: dict = field(default_factory=dict)

    @property
    def failed(self) -> bool:
        return bool(self.violations)

    def digest(self) -> str:
        """Stable hash of the observable outcome (id, status, tokens): two
        replays of the same trajectory must produce the same digest."""
        blob = json.dumps(
            sorted((rid, r.status, list(r.tokens))
                   for rid, r in self.responses.items()))
        return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _requests(traj: Trajectory) -> list[Request]:
    return [Request(id=i, prompt=p, max_new_tokens=traj.max_new)
            for i, p in enumerate(traj.prompts())]


# ------------------------------------------------------------------- oracles
def _check_outcomes(traj: Trajectory, responses: dict,
                    reference: dict, violations: list) -> None:
    injected = bool(traj.ops)
    for rid in range(traj.n_requests):
        resp = responses.get(rid)
        if resp is None:
            violations.append(f"dropped: request {rid} never answered")
            continue
        if resp.status == OK:
            if tuple(resp.tokens) != reference[rid]:
                violations.append(
                    f"token mismatch on request {rid}: got "
                    f"{list(resp.tokens)}, clean run gave "
                    f"{list(reference[rid])}")
        elif resp.status == FAILED:
            if not injected:
                violations.append(
                    f"request {rid} FAILED with no injected faults "
                    f"({resp.detail})")
        else:
            violations.append(
                f"illegal terminal status {resp.status!r} for request {rid} "
                f"({resp.detail})")


def _metrics_cells(metrics, engine: str) -> set[Cell]:
    cells: set[Cell] = set()
    for f in metrics.faults:
        for cls in ErrorCode(f.code).classes():
            cells.add((cls.name, f.action, engine))
    return cells


# ----------------------------------------------------------- reference cache
@functools.lru_cache(maxsize=None)
def reference_tokens(engine: str, n_requests: int, prompt_len: int,
                     max_new: int) -> dict:
    """Token streams of the clean (zero-op) run of ``engine`` under this
    load on the kits' model — the bit-exactness baseline. A non-OK response
    here is a harness bug, not a finding, and raises immediately."""
    traj = Trajectory(seed=0, engine=engine, n_requests=n_requests,
                      prompt_len=prompt_len, max_new=max_new)
    res = _runner(engine)(traj, reference={}, check=False)
    if set(res.responses) != set(range(n_requests)):
        raise RuntimeError(f"clean {engine} run dropped requests: "
                           f"{sorted(res.responses)}")
    bad = [r for r in res.responses.values() if r.status != OK]
    if bad:
        raise RuntimeError(f"clean {engine} run not all OK: {bad}")
    return {rid: tuple(r.tokens) for rid, r in res.responses.items()}


# --------------------------------------------------------------------- drive
def _run_single(traj: Trajectory, *, reference: dict,
                check: bool = True) -> RunResult:
    kit = get_kit(traj.engine)
    tracer = Tracer(pid=0)
    rep = Replica(kit.cfg, kit.model,
                  config=kit.spec.engine_config(traj.max_request_retries),
                  tracer=tracer,
                  fault_injector=_ScheduledInjector(traj.ops_of("word")))
    res = RunResult(trajectory=traj)
    host_ops: dict[int, list[Op]] = {}
    for op in traj.ops_of("poison", "page_table", "preempt"):
        host_ops.setdefault(op.cycle, []).append(op)
    for req in _requests(traj):
        rej = rep.submit(req)
        if rej is not None:
            res.responses[rej.id] = rej
    try:
        cycle = 0
        pending: list[Op] = []       # host ops that found no lane to bite yet
        while not rep.idle() and cycle < MAX_CYCLES:
            pending.extend(host_ops.get(cycle, ()))
            pending = [op for op in pending if not _apply_host_op(rep, op)]
            for resp in rep.step():
                if resp.id in res.responses:
                    res.violations.append(
                        f"duplicate response for request {resp.id}")
                res.responses[resp.id] = resp
            cycle += 1
        if not rep.idle():
            res.violations.append(
                f"wedged: {len(rep.queue)} queued + "
                f"{rep.sched.in_flight()} in-flight after {MAX_CYCLES} "
                "cycles")
    except Exception as exc:                      # oracle 5: nothing escapes
        res.violations.append(f"crash: {type(exc).__name__}: {exc}")
    res.cells = _metrics_cells(rep.metrics, traj.engine)
    if rep.alloc is not None:
        try:
            rep.alloc.check()
        except AssertionError as exc:
            res.violations.append(f"page ledger corrupt at end of run: {exc}")
    if check:
        _check_outcomes(traj, res.responses, reference, res.violations)
        res.violations.extend(
            f"trace: {p}" for p in postmortem.validate(merge_traces(tracer)))
    res.summary = {"faults": rep.metrics.fault_counts(),
                   "statuses": rep.metrics.by_status(),
                   "trace_events": tracer.num_events}
    return res


def _run_group(traj: Trajectory, *, reference: dict,
               check: bool = True) -> RunResult:
    kills = traj.ops_of("kill")
    rejoins = traj.ops_of("rejoin")
    restarts = traj.ops_of("restart")
    # a rejoin without a restart needs a spare rank beyond the initial fleet;
    # after a restart the previously killed rank itself is the spare
    max_ranks = GROUP_RANKS + (1 if rejoins and not restarts else 0)
    group = _group_kit(traj.max_request_retries, max_ranks)
    res = RunResult(trajectory=traj)
    faults = FaultSchedule(
        [FaultSpec(step=op.cycle, kind="kill", rank=op.slot % group.nranks)
         for op in kills], seed=traj.seed)
    crash_at = restarts[0].cycle if restarts else None
    joins = sorted(op.cycle for op in rejoins) or None
    tmp = tempfile.mkdtemp(prefix="fuzz-ledger-")
    ledger_path = os.path.join(tmp, "ledger.wal")
    outs = []
    traces = []
    try:
        # every group trajectory runs durable: the write-ahead log is part of
        # the submit path, so the fuzzer always exercises it
        out = group.serve(_requests(traj), faults=faults,
                          ledger_path=ledger_path, crash_at=crash_at,
                          joins=None if restarts else joins)
        outs.append(out)
        traces.append(out.trace())
        res.responses = dict(out.responses)
        if restarts:
            if out.crashed:
                out2 = group.serve_from_ledger(ledger_path, joins=joins)
                outs.append(out2)
                traces.append(out2.trace())
                res.responses.update(out2.responses)
                res.cells.add((ErrorCode.RANK_FAILED.name, "replay",
                               traj.engine))
            else:
                # the fleet drained before the crash round — legal, but the
                # mutator's timing search wants to know the op was dead code
                res.summary["restart_noop"] = True
    except Exception as exc:
        res.violations.append(f"crash: {type(exc).__name__}: {exc}")
        return res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for out in outs:
        for rr in out.reports:
            report = (rr.value if rr.exception is None and not rr.killed
                      else None)
            if report is None:
                continue
            if report.metrics is not None:
                res.cells |= _metrics_cells(report.metrics, traj.engine)
            if any(ev[0] == "shrink" for ev in report.events):
                res.cells.add((ErrorCode.COMM_CORRUPTED.name, "shrink",
                               traj.engine))
        if out.rerouted:
            res.cells.add((ErrorCode.RANK_FAILED.name, "reroute",
                           traj.engine))
        if out.joined:
            res.cells.add((ErrorCode.RANK_FAILED.name, "rejoin",
                           traj.engine))
    if kills and not any(out.rerouted for out in outs):
        # a kill with no re-route means the dead rank had already answered
        # everything — legal, but worth noting for the mutator's timing search
        res.summary["kill_noop"] = True
    if rejoins and not any(out.joined for out in outs):
        res.summary["rejoin_noop"] = True
    if check:
        _check_outcomes(traj, res.responses, reference, res.violations)
        # a crash-restart scenario is ONE causal story across two fleet
        # incarnations: submits from the first pair with terminals from the
        # second, so the oracle only holds on the merged trace
        res.violations.extend(
            f"trace: {p}" for p in postmortem.validate(
                merge_trace_dicts(*traces)))
    res.summary.setdefault("statuses", {})
    for r in res.responses.values():
        res.summary["statuses"][r.status] = (
            res.summary["statuses"].get(r.status, 0) + 1)
    return res


def _run_multihost(traj: Trajectory, *, reference: dict,
                   check: bool = True) -> RunResult:
    """Drive the real-process fault domain: 3 sim-backend subprocess workers
    under the heartbeat supervisor. ``host_kill`` ops SIGKILL a worker once
    ``cycle`` responses retired fleet-wide; ``host_stop`` ops SIGSTOP one for
    half the suspect timeout. Extra oracle beyond the shared ones: a stopped
    worker that was never also killed must NOT be evicted (the detector's
    slow-but-alive discrimination, asserted on every fuzzed trajectory)."""
    res = RunResult(trajectory=traj)
    specs = [FaultSpec(step=op.cycle, kind="host_kill",
                       rank=op.slot % GROUP_RANKS)
             for op in traj.ops_of("host_kill")]
    specs += [FaultSpec(step=op.cycle, kind="host_stop",
                        rank=op.slot % GROUP_RANKS,
                        magnitude=MULTIHOST_STOP_PAUSE)
              for op in traj.ops_of("host_stop")]
    sup = MultiHostSupervisor(
        GROUP_RANKS, backend="sim",
        suspect_timeout=MULTIHOST_SUSPECT_TIMEOUT,
        heartbeat_interval=0.05, trace=True, timeout=180.0,
        sim_tokens_per_step=2, sim_step_delay_s=0.01)
    try:
        out = sup.serve(_requests(traj),
                        faults=FaultSchedule(tuple(specs), seed=traj.seed))
    except Exception as exc:                      # oracle 5: nothing escapes
        res.violations.append(f"crash: {type(exc).__name__}: {exc}")
        return res
    res.responses = dict(out.responses)
    killed_ranks = {s.rank for s in specs if s.kind == "host_kill"}
    for rank in out.evicted:
        if rank not in killed_ranks:
            res.violations.append(
                f"false positive: host {rank} evicted but never SIGKILLed "
                f"(stopped={out.stopped}, detection={out.detection.get(rank)})")
    if out.evicted:
        res.cells.add((ErrorCode.RANK_FAILED.name, "evict", traj.engine))
    if out.resumed:
        res.cells.add((ErrorCode.STRAGGLER.name, "resume", traj.engine))
    if specs and killed_ranks and not out.evicted:
        # the kill fired after the drain (or never) — legal, but the
        # mutator's timing search wants to know the op was dead code
        res.summary["kill_noop"] = True
    if any(s.kind == "host_stop" for s in specs) and not out.stopped:
        res.summary["stop_noop"] = True
    if check:
        _check_outcomes(traj, res.responses, reference, res.violations)
        res.violations.extend(
            f"trace: {p}" for p in postmortem.validate(out.trace()))
    res.summary.setdefault("statuses", {})
    for r in res.responses.values():
        res.summary["statuses"][r.status] = (
            res.summary["statuses"].get(r.status, 0) + 1)
    return res


def _runner(engine: str):
    return {GROUP_ENGINE: _run_group,
            MULTIHOST_ENGINE: _run_multihost}.get(engine, _run_single)


def run_trajectory(traj: Trajectory) -> RunResult:
    """Run one trajectory end to end and apply every oracle. Never raises on
    a stack failure — crashes become violations (counterexamples). Raises
    ``NotImplementedError`` for an engine the port does not run yet."""
    _check_ported(traj.engine)
    reference = reference_tokens(traj.engine, *traj.load_key)
    return _runner(traj.engine)(traj, reference=reference)
