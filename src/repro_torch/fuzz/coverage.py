# Copy of repro/fuzz/coverage.py, over the engines the port runs.
"""Coverage model: which recovery-matrix cells has the fuzzer exercised?

A **cell** is ``(error-code class, recovery action, engine)`` — one entry of
the fault-handling matrix the serving stack claims to implement. The
reachable universe is *derived*, not hand-written: for every injectable
single-bit :class:`~repro_torch.core.errors.ErrorCode` we replay the real
:class:`~repro_torch.core.recovery.RecoveryPolicy` against an escalating run of
repeats and collect the actions it actually routes to (so a policy change
automatically reshapes the target set), then cross that with every engine
variant, plus the engine-specific lanes the policy does not own (the paged
``page_reclaim`` ledger record, the group's shrink / re-route cells).

:class:`CoverageDB` persists hit counts as JSON. The mutator asks it for
uncovered cells and biases trajectory generation toward them — the
"coverage-guided" half of the fuzzer.

The port's universe is the JAX package's without the cells of the engine
it does not run yet: ``overlap_tp`` (tensor parallel, ROADMAP item 11).
"""
from __future__ import annotations

import json
import os
from typing import Iterable, Optional

from ..core.errors import ErrorCode, PropagatedError, RankError
from ..core.faults import INJECTABLE_CODE_MASK
from ..core.recovery import RecoveryPolicy
from .trajectory import GROUP_ENGINE, MULTIHOST_ENGINE, PORT_ENGINES, SINGLE_ENGINES

#: (code_name, action, engine)
Cell = tuple[str, str, str]

#: The single-replica engines the port runs (no ``overlap_tp``: item 11).
PORT_SINGLE_ENGINES = tuple(e for e in SINGLE_ENGINES if e in PORT_ENGINES)

#: Engines that run the paged-KV pool (and therefore the page_reclaim lane).
PAGED_ENGINES = frozenset(e for e in PORT_SINGLE_ENGINES if "paged" in e)

#: Injectable single-bit classes, as ErrorCode members (sorted by bit).
INJECTABLE_CLASSES: tuple[ErrorCode, ...] = tuple(
    ErrorCode(INJECTABLE_CODE_MASK).classes())


def action_ladder(code: ErrorCode, depth: int = 6) -> list[str]:
    """The action sequence a fresh policy takes for ``depth`` consecutive
    faults of ``code`` (one per step, all inside the escalation window) —
    the escalation ladder a targeted trajectory walks."""
    pol = RecoveryPolicy()
    exc = PropagatedError([RankError(rank=0, code=int(code))])
    return [pol.decide(exc, step).action.value
            for step in range(1, depth + 1)]


def reachable_cells() -> frozenset[Cell]:
    """The derived coverage universe (see module docstring)."""
    cells: set[Cell] = set()
    for code in INJECTABLE_CLASSES:
        actions = set(action_ladder(code))
        for engine in PORT_SINGLE_ENGINES:
            for action in actions:
                cells.add((code.name, action, engine))
    for engine in PAGED_ENGINES:
        # ledger-divergence repair is recorded as its own lane alongside the
        # policy's RESTORE_GOOD (replica._recover_window)
        cells.add((ErrorCode.PAGE_FAULT.name, "page_reclaim", engine))
    cells.add((ErrorCode.COMM_CORRUPTED.name, "shrink", GROUP_ENGINE))
    cells.add((ErrorCode.RANK_FAILED.name, "reroute", GROUP_ENGINE))
    # elastic recovery lanes: a full-fleet crash replayed from the durable
    # ledger, and a dead/spare rank re-admitted via the non-blocking join
    cells.add((ErrorCode.RANK_FAILED.name, "replay", GROUP_ENGINE))
    cells.add((ErrorCode.RANK_FAILED.name, "rejoin", GROUP_ENGINE))
    # multihost (real OS process) lanes: a SIGKILL'd worker detected by the
    # heartbeat detector and evicted (RANK_FAILED latched on the survivors),
    # and a SIGSTOP'd worker that resumes inside the timeout — suspicion
    # cleared, never evicted (the false-positive guard as a coverage target)
    cells.add((ErrorCode.RANK_FAILED.name, "evict", MULTIHOST_ENGINE))
    cells.add((ErrorCode.STRAGGLER.name, "resume", MULTIHOST_ENGINE))
    return frozenset(cells)


class CoverageDB:
    """Persisted hit counts per cell (JSON: ``{"CODE|action|engine": n}``)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.counts: dict[str, int] = {}
        if path is not None and os.path.exists(path):
            with open(path) as f:
                data = json.load(f)
            self.counts = {str(k): int(v)
                           for k, v in data.get("cells", {}).items()}

    # ------------------------------------------------------------------ keys
    @staticmethod
    def key(cell: Cell) -> str:
        return "|".join(cell)

    @staticmethod
    def unkey(key: str) -> Cell:
        code, action, engine = key.split("|")
        return (code, action, engine)

    # ------------------------------------------------------------- recording
    def record(self, cells: Iterable[Cell]) -> list[Cell]:
        """Count every cell; returns the ones never seen before."""
        new: list[Cell] = []
        for cell in cells:
            k = self.key(cell)
            if k not in self.counts:
                new.append(cell)
            self.counts[k] = self.counts.get(k, 0) + 1
        return new

    def covered(self, cell: Cell) -> bool:
        return self.key(cell) in self.counts

    def cells(self) -> set[Cell]:
        return {self.unkey(k) for k in self.counts}

    # --------------------------------------------------------------- queries
    def uncovered(self, universe: Iterable[Cell]) -> list[Cell]:
        return sorted(c for c in universe if not self.covered(c))

    def fraction(self, universe: Iterable[Cell]) -> float:
        universe = list(universe)
        if not universe:
            return 1.0
        hit = sum(1 for c in universe if self.covered(c))
        return hit / len(universe)

    def report(self, universe: Iterable[Cell]) -> dict:
        universe = sorted(universe)
        return {
            "universe": len(universe),
            "covered": sum(1 for c in universe if self.covered(c)),
            "fraction": self.fraction(universe),
            "uncovered": [self.key(c) for c in self.uncovered(universe)],
            "extra": sorted(self.key(c) for c in self.cells()
                            if c not in set(universe)),
        }

    # ------------------------------------------------------------ persistence
    def save(self, path: Optional[str] = None) -> None:
        path = path or self.path
        if path is None:
            return
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump({"version": 1, "cells": self.counts}, f, indent=1,
                      sort_keys=True)
