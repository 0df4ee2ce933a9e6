# Copy of repro/fuzz/mutator.py; its default engines are the port's.
"""FaultMutator: seeded trajectory generation, biased toward uncovered cells.

Two modes, chosen per proposal from a per-index generator
(``default_rng((seed, index))`` — trajectory *i* of a campaign is a pure
function of the campaign seed, the index and the coverage state, never of
wall clock or global RNG state):

* **Targeted** (preferred while the universe has holes): pick an uncovered
  ``(code, action, engine)`` cell, look up the code's escalation ladder from
  the real :class:`~repro_torch.core.recovery.RecoveryPolicy`, and emit one ``word``
  op per consecutive window up to the deepest uncovered rung — a single
  trajectory then sweeps every action on that code's ladder (skip →
  restore → rollback) in one run. One code per trajectory: the policy's
  repeat counter is shared across codes, so mixing codes would skew the
  ladder walk.
* **Random / mutate**: draw a fresh random trajectory (any engine, any mix
  of word/poison/page-table/preempt ops), or mutate a coverage-novel parent
  from the campaign pool (add/drop/retune one op, or reshape the load) —
  the classic fuzzing loop that finds the bugs the targeted mode's clean
  ladder walks never would.

Explicit caps (not silent): group trajectories carry exactly one ``kill``
op (sequential multi-kill shrink is out of scope for this corpus), at most
one ``restart`` and one ``rejoin`` op ride along with it (crash-replay and
elastic regrow lanes), multihost trajectories carry at most one
``host_kill`` plus at most one ``host_stop`` (one detection story per run —
the stop-then-kill interleaving is covered, concurrent multi-host loss is
not), and at most ``MAX_OPS`` ops ride any trajectory.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Iterable, Optional, Sequence

import numpy as np

from ..core.errors import ErrorCode
from .coverage import (
    INJECTABLE_CLASSES,
    PAGED_ENGINES,
    CoverageDB,
    action_ladder,
    reachable_cells,
)
from .runner import ENGINE_SPECS, GROUP_RANKS
from .trajectory import (
    ENGINES,
    GROUP_ENGINE,
    HOST_OPS,
    MULTIHOST_ENGINE,
    PORT_ENGINES,
    TP_ENGINES,
    Op,
    Trajectory,
)

MAX_OPS = 6
NUM_SLOTS = 2                       # every runner kit uses two lanes
N_REQUESTS = (2, 3, 4)
PROMPT_LENS = (3, 5, 7)
MAX_NEWS = (5, 8, 12)
RETRIES = (1, 2, 6)

_LADDERS = {code: action_ladder(code) for code in INJECTABLE_CLASSES}


def _pick(rng: np.random.Generator, seq: Sequence):
    return seq[int(rng.integers(len(seq)))]


class FaultMutator:
    """Seeded, coverage-guided trajectory source (see module docstring)."""

    def __init__(self, seed: int, db: CoverageDB,
                 engines: Optional[Iterable[str]] = None,
                 targeted_bias: float = 0.7):
        self.seed = int(seed)
        self.db = db
        self.engines = tuple(engines) if engines else PORT_ENGINES
        unknown = set(self.engines) - set(ENGINES)
        if unknown:
            raise ValueError(f"unknown engines: {sorted(unknown)}")
        self.universe = sorted(c for c in reachable_cells()
                               if c[2] in self.engines)
        self.targeted_bias = float(targeted_bias)

    # -------------------------------------------------------------- proposal
    def propose(self, index: int,
                pool: Sequence[Trajectory] = ()) -> Trajectory:
        rng = np.random.default_rng((self.seed, index))
        uncovered = self.db.uncovered(self.universe)
        if uncovered and rng.random() < self.targeted_bias:
            return self._targeted(rng, uncovered)
        if pool and rng.random() < 0.5:
            return self.mutate(_pick(rng, pool), rng)
        return self._random(rng)

    # -------------------------------------------------------------- targeted
    def _targeted(self, rng: np.random.Generator,
                  uncovered: Sequence) -> Trajectory:
        code_name, action, engine = _pick(rng, uncovered)
        if engine == GROUP_ENGINE:
            return self._group(rng, note=f"targeted:{code_name}:{action}",
                               want=action)
        if engine == MULTIHOST_ENGINE:
            return self._multihost(rng,
                                   note=f"targeted:{code_name}:{action}",
                                   want=action)
        base = Trajectory(seed=int(rng.integers(1 << 31)), engine=engine,
                          n_requests=_pick(rng, N_REQUESTS[1:]),
                          prompt_len=_pick(rng, PROMPT_LENS),
                          max_new=_pick(rng, MAX_NEWS[1:]),
                          max_request_retries=6,
                          note=f"targeted:{code_name}:{engine}")
        if code_name == ErrorCode.PAGE_FAULT.name and rng.random() < 0.3:
            # real ledger divergence, not just the word: unmap the device row
            return base.with_ops([Op("page_table",
                                     cycle=int(rng.integers(3, 7)),
                                     slot=int(rng.integers(NUM_SLOTS)))])
        code = ErrorCode[code_name]
        ladder = _LADDERS[code]
        # deepest still-uncovered rung for this (code, engine): one trajectory
        # sweeps the whole ladder prefix, covering every rung on the way down
        holes = {a for c, a, e in uncovered if c == code_name and e == engine}
        depth = max((i + 1 for i, a in enumerate(ladder) if a in holes),
                    default=1)
        start = int(rng.integers(1, 4))
        ops = [Op("word", cycle=start + k, slot=k % NUM_SLOTS,
                  step=int(rng.integers(4)), code=int(code))
               for k in range(min(depth, MAX_OPS))]
        return base.with_ops(ops)

    # ---------------------------------------------------------------- random
    def _random(self, rng: np.random.Generator) -> Trajectory:
        engine = _pick(rng, self.engines)
        if engine == GROUP_ENGINE:
            return self._group(rng, note="random")
        if engine == MULTIHOST_ENGINE:
            return self._multihost(rng, note="random")
        base = Trajectory(seed=int(rng.integers(1 << 31)), engine=engine,
                          n_requests=_pick(rng, N_REQUESTS),
                          prompt_len=_pick(rng, PROMPT_LENS),
                          max_new=_pick(rng, MAX_NEWS),
                          max_request_retries=_pick(rng, RETRIES),
                          note=f"random:{engine}")
        ops = [self._random_op(rng, engine)
               for _ in range(int(rng.integers(MAX_OPS + 1)))]
        return base.with_ops(ops)

    def _random_op(self, rng: np.random.Generator, engine: str) -> Op:
        kinds = ["word", "word", "word", "poison", "preempt"]
        if engine in PAGED_ENGINES:
            kinds.append("page_table")
        kind = _pick(rng, kinds)
        cycle = int(rng.integers(1, 10))
        slot = int(rng.integers(NUM_SLOTS))
        if kind != "word":
            return Op(kind, cycle=cycle, slot=slot)
        code = int(_pick(rng, INJECTABLE_CLASSES))
        if rng.random() < 0.25:       # multi-bit word: combined-code routing
            code |= int(_pick(rng, INJECTABLE_CLASSES))
        shard = -1
        if engine in TP_ENGINES and rng.random() < 0.5:
            # shard-targeted half of the TP corpus: the OR-fold must make a
            # one-shard injection indistinguishable from an all-shard one
            shard = int(rng.integers(ENGINE_SPECS[engine].tp))
        return Op("word", cycle=cycle, slot=slot,
                  step=int(rng.integers(4)), code=code, shard=shard)

    def _group(self, rng: np.random.Generator, *, note: str,
               want: Optional[str] = None) -> Trajectory:
        """One group scenario: a kill, optionally followed by a full-fleet
        ``restart`` (crash-replay from the ledger) and/or a ``rejoin``
        (elastic regrow). ``want`` forces the lane a targeted cell needs."""
        kill_cycle = int(rng.integers(1, 4))
        restart = want == "replay" or (want is None and rng.random() < 0.35)
        rejoin = want == "rejoin" or (want is None and rng.random() < 0.35)
        ops = [Op("kill", cycle=kill_cycle,
                  slot=int(rng.integers(GROUP_RANKS)))]
        if restart:
            # the crash must land before the survivors drain the backlog, so
            # keep it close behind the kill and carry a heavier load below
            ops.append(Op("restart",
                          cycle=kill_cycle + 3 + int(rng.integers(2))))
        if rejoin:
            ops.append(Op("rejoin", cycle=int(rng.integers(1, 3)),
                          slot=int(rng.integers(GROUP_RANKS))))
        heavy = restart or rejoin
        return Trajectory(
            seed=int(rng.integers(1 << 31)), engine=GROUP_ENGINE,
            n_requests=_pick(rng, (8, 10) if heavy else (4, 6)),
            prompt_len=_pick(rng, PROMPT_LENS),
            max_new=_pick(rng, (8, 12) if heavy else MAX_NEWS),
            ops=ops, note=f"{note}:group")

    def _multihost(self, rng: np.random.Generator, *, note: str,
                   want: Optional[str] = None) -> Trajectory:
        """One multihost scenario: a SIGKILL'd worker process (the evict
        lane), a SIGSTOP'd-then-resumed one (the false-positive guard as a
        coverage target), or both on one run. ``want`` forces the lane a
        targeted cell needs (``evict`` → host_kill, ``resume`` →
        host_stop)."""
        kill = want == "evict" or (want is None and rng.random() < 0.7)
        stop = want == "resume" or (want is None and rng.random() < 0.4)
        ops = []
        if kill:
            ops.append(Op("host_kill", cycle=int(rng.integers(1, 4)),
                          slot=int(rng.integers(GROUP_RANKS))))
        if stop or not ops:
            ops.append(Op("host_stop", cycle=int(rng.integers(1, 4)),
                          slot=int(rng.integers(GROUP_RANKS))))
        # heavy-ish load: the faults fire on retire counts, so the fleet
        # must still be mid-decode when the scheduled cycle is reached
        return Trajectory(
            seed=int(rng.integers(1 << 31)), engine=MULTIHOST_ENGINE,
            n_requests=_pick(rng, (8, 10, 12)),
            prompt_len=_pick(rng, PROMPT_LENS),
            max_new=_pick(rng, (8, 12)),
            ops=ops, note=f"{note}:multihost")

    # ---------------------------------------------------------------- mutate
    def mutate(self, parent: Trajectory,
               rng: np.random.Generator) -> Trajectory:
        """One structural edit of a coverage-novel parent."""
        traj = replace(parent, seed=int(rng.integers(1 << 31)),
                       note=f"mutant:{parent.note}")
        ops = list(traj.ops)
        moves = ["add", "load"]
        if ops:
            moves += ["drop", "tweak"]
        move = _pick(rng, moves)
        if move == "add" and traj.engine not in (GROUP_ENGINE,
                                                 MULTIHOST_ENGINE):
            if len(ops) < MAX_OPS:
                ops.append(self._random_op(rng, traj.engine))
        elif move == "drop":
            ops.pop(int(rng.integers(len(ops))))
        elif move == "tweak":
            i = int(rng.integers(len(ops)))
            op = ops[i]
            ops[i] = replace(op, cycle=max(1, op.cycle
                                           + int(rng.integers(-2, 3))),
                             slot=int(rng.integers(
                                 GROUP_RANKS
                                 if op.op == "kill" or op.op in HOST_OPS
                                 else NUM_SLOTS)))
        else:   # load reshape
            traj = replace(traj, n_requests=_pick(rng, N_REQUESTS),
                           prompt_len=_pick(rng, PROMPT_LENS),
                           max_new=_pick(rng, MAX_NEWS),
                           max_request_retries=_pick(rng, RETRIES)
                           if traj.engine != GROUP_ENGINE else 6)
        return traj.with_ops(ops)
