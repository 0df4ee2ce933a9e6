# Copy of repro/fuzz/trajectory.py (stdlib only): the JSON is the reference's, so its corpus loads unchanged.
"""Trajectories: fully deterministic fault-injection scenarios.

A :class:`Trajectory` is the fuzzer's genome — one self-contained, seeded
description of a serving run plus every fault injected into it. It carries
*everything* the runner needs: the engine variant (which serving code path),
the synthetic request load (derived arithmetically from the counts, never
stored), and an ordered list of injection :class:`Op`\\ s with explicit
timing. Replay is therefore bit-for-bit: the same trajectory JSON produces
the same dispatches, the same injected words, the same recovery decisions and
the same token streams, on any machine (greedy decode + seeded injection =
no hidden entropy).

Op timing model (the injection surfaces of DESIGN.md §3.6):

* ``word``    — OR an :class:`~repro_torch.core.errors.ErrorCode` word into the
  device error words of dispatch ``cycle`` at window step ``step``, slot
  ``slot`` (via ``Replica(fault_injector=...)``): the in-band mutation that
  reaches every soft-error lane of the recovery matrix, timed relative to
  window dispatch/retire, prefill chunks and speculative draft/verify
  boundaries (all of which are window steps).
* ``poison``  — NaN a real element of slot state / KV / page pool before
  drive-loop cycle ``cycle`` (``Replica.inject_state_fault``): the probe
  path, not just the word path.
* ``page_table`` — unmap a lane's device page-table row behind the allocator
  (``Replica.corrupt_page_table``): host-ledger/device-table divergence the
  in-band ``PAGE_FAULT`` probe must latch.
* ``preempt`` — pull a lane's request out mid-flight and requeue it
  (``Replica.preempt_slot``): the zero-drop preemption path.
* ``kill``    — hard-kill replica rank ``slot`` at serving round ``cycle``
  (ServeGroup engines only): ULFM shrink + ledger re-route.
* ``restart`` — stop the *whole fleet* at serving round ``cycle`` and replay
  it from the durable request ledger alone (``serve`` with ``crash_at=`` then
  ``serve_from_ledger``): the crash-restart zero-drop path. At most one per
  trajectory — the replayed incarnation is part of the same scenario.
* ``rejoin``  — summon a spare / previously-killed rank back into the group
  at round ``cycle`` (the ledger ``joins`` schedule): non-blocking join with
  background state transfer and epoch re-balance. Lands in the post-restart
  incarnation when a ``restart`` op rides the same trajectory.
* ``host_kill`` / ``host_stop`` — SIGKILL / SIGSTOP(+SIGCONT) worker
  *process* ``slot`` once ``cycle`` responses have been retired fleet-wide
  (multihost engine only): the heartbeat detector's suspect → evict ladder,
  WAL re-route across a real process boundary, and the SIGSTOP
  slow-but-alive false-positive guard.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field, replace
from typing import Iterable, Optional, Sequence

OP_KINDS = ("word", "poison", "page_table", "preempt", "kill", "restart",
            "rejoin", "host_kill", "host_stop")

#: Ops that only make sense on the multi-replica ULFM engine.
GROUP_OPS = frozenset({"kill", "restart", "rejoin"})

#: Ops that only make sense on the multihost (real OS process) engine —
#: they signal a worker *process*, there is no thread to signal elsewhere.
HOST_OPS = frozenset({"host_kill", "host_stop"})

#: Engine variants a trajectory can target. ``group`` is the multi-replica
#: ULFM engine; ``multihost`` is the real-process fault domain (subprocess
#: workers under the heartbeat supervisor); the rest are single-replica
#: serving code paths. The port runs all but ``overlap_tp`` (ROADMAP item
#: 11): :data:`PORT_ENGINES`.
SINGLE_ENGINES = ("stepwise", "window", "overlap", "overlap_tp",
                  "overlap_paged", "spec", "spec_paged")
GROUP_ENGINE = "group"
MULTIHOST_ENGINE = "multihost"
ENGINES = SINGLE_ENGINES + (GROUP_ENGINE, MULTIHOST_ENGINE)
PORT_ENGINES = tuple(e for e in ENGINES if e != "overlap_tp")

#: Tensor-parallel engine variants: their ``word`` ops may carry a ``shard``
#: target (the injection surface is per-shard — DESIGN §3.8).
TP_ENGINES = frozenset(e for e in SINGLE_ENGINES if e.endswith("_tp"))


@dataclass(frozen=True)
class Op:
    """One injection, fully timed. ``slot`` doubles as the target rank for
    ``kill``/``rejoin`` ops (``restart`` stops the whole fleet and ignores
    it); ``step``/``code`` are only meaningful for ``word`` ops. ``shard``
    targets one tensor-parallel shard of a ``word`` op on a TP engine (-1 =
    inject on every shard); the cross-shard OR-fold must make the two cases
    indistinguishable at retirement — that equivalence is exactly what
    shard-targeted trajectories probe."""

    op: str
    cycle: int
    slot: int = 0
    step: int = 0
    code: int = 0
    shard: int = -1

    def __post_init__(self):
        if self.op not in OP_KINDS:
            raise ValueError(f"unknown op {self.op!r} (known: {OP_KINDS})")
        if self.cycle < 0 or self.slot < 0 or self.step < 0:
            raise ValueError(f"negative timing/target in {self!r}")
        if self.shard < -1:
            raise ValueError(f"shard must be >= -1 in {self!r}")
        if self.op == "word" and self.code == 0:
            raise ValueError("word op needs a nonzero ErrorCode word")
        if self.shard >= 0 and self.op != "word":
            raise ValueError("shard targeting is only meaningful for word "
                             f"ops, got {self!r}")


@dataclass(frozen=True)
class Trajectory:
    """One deterministic fuzz scenario (see module docstring)."""

    seed: int
    engine: str
    n_requests: int = 3
    prompt_len: int = 5
    max_new: int = 8
    max_request_retries: int = 6
    ops: tuple = ()
    note: str = ""

    def __post_init__(self):
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r} "
                             f"(known: {ENGINES})")
        if self.n_requests < 1 or self.prompt_len < 1 or self.max_new < 1:
            raise ValueError("degenerate request load")
        object.__setattr__(self, "ops", tuple(self.ops))
        for op in self.ops:
            if not isinstance(op, Op):
                raise TypeError(f"ops must be Op instances, got {op!r}")
            if op.op in HOST_OPS:
                if self.engine != MULTIHOST_ENGINE:
                    raise ValueError(
                        f"{op.op!r} op targets a worker process and is only "
                        "valid on the multihost engine")
            elif self.engine == MULTIHOST_ENGINE:
                raise ValueError(
                    f"{op.op!r} op is not valid on the multihost engine "
                    f"(host ops only: {sorted(HOST_OPS)})")
            elif (op.op in GROUP_OPS) != (self.engine == GROUP_ENGINE):
                raise ValueError(
                    f"{op.op!r} op is "
                    f"{'only' if op.op in GROUP_OPS else 'not'} "
                    "valid on the group engine")
            if op.shard >= 0 and self.engine not in TP_ENGINES:
                raise ValueError(
                    f"shard-targeted op {op!r} on non-TP engine "
                    f"{self.engine!r} (TP engines: {sorted(TP_ENGINES)})")
        if sum(1 for o in self.ops if o.op == "restart") > 1:
            raise ValueError("at most one restart op per trajectory: the "
                             "replayed incarnation is the same scenario")

    # ----------------------------------------------------------- derived load
    def prompts(self) -> list[tuple]:
        """The synthetic prompts, derived arithmetically (never stored): the
        same scheme the serving test suites use, parameterised by the
        trajectory so the reference cache can key on three small ints."""
        return [tuple(5 + i + j for j in range(self.prompt_len))
                for i in range(self.n_requests)]

    def ops_of(self, *kinds: str) -> list[Op]:
        return [o for o in self.ops if o.op in kinds]

    def with_ops(self, ops: Iterable[Op]) -> "Trajectory":
        return replace(self, ops=tuple(ops))

    @property
    def load_key(self) -> tuple:
        """Reference-cache key: everything that shapes the *clean* token
        streams (injections never do — that is the oracle)."""
        return (self.n_requests, self.prompt_len, self.max_new)

    # ------------------------------------------------------------------- JSON
    def to_json(self) -> dict:
        d = asdict(self)
        d["ops"] = [asdict(o) for o in self.ops]
        return d

    @classmethod
    def from_json(cls, d: dict) -> "Trajectory":
        d = dict(d)
        d["ops"] = tuple(Op(**o) for o in d.get("ops", ()))
        return cls(**d)

    def dumps(self) -> str:
        return json.dumps(self.to_json(), sort_keys=True)

    @classmethod
    def loads(cls, s: str) -> "Trajectory":
        return cls.from_json(json.loads(s))
