# Copy of repro/fuzz/campaign.py; it writes entries only where its caller says.
"""Campaign loop: propose → run → record coverage → minimize → promote.

Ties the fuzzer together: a :class:`FaultMutator` proposes seeded
trajectories (biased toward uncovered recovery-matrix cells), the runner
executes each against the real stack and applies the oracles, the
:class:`~repro_torch.fuzz.coverage.CoverageDB` accumulates which cells fired, and
every failing trajectory is **minimized** (greedy op-dropping + load
shrinking while the failure still reproduces) and written to the corpus
directory the caller names (``corpus_dir``; None writes nothing) as a
self-contained JSON counterexample. Passing, coverage-novel trajectories
can be promoted as ``seed`` entries. The entries have the JAX package's
format, so either package replays the other's corpus (the port's tests
replay the reference's ``tests/fuzz_corpus/``, and write nothing there).

Corpus entry statuses:

* ``seed`` / ``regression`` — must replay clean: zero violations and a
  bit-identical outcome digest.
* ``counterexample`` — must still *reproduce* its violations; once the bug
  is fixed, the replay test fails and the entry is flipped to
  ``regression`` (with a fresh digest) to pin the fix.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field, replace
from typing import Iterable, Optional

from .coverage import CoverageDB
from .mutator import FaultMutator
from .runner import RunResult, run_trajectory
from .trajectory import Trajectory

MINIMIZE_BUDGET = 24      # replays spent shrinking one counterexample


# ----------------------------------------------------------------- minimizer
def minimize(traj: Trajectory,
             budget: int = MINIMIZE_BUDGET) -> tuple[Trajectory, RunResult]:
    """Greedy delta-debugging: drop ops one at a time (then shrink the
    request load) while the trajectory still fails any oracle. Returns the
    smallest still-failing trajectory and its result."""
    best_res = run_trajectory(traj)
    if not best_res.failed:           # flaky caller — nothing to minimize
        return traj, best_res
    best = traj
    runs = 1

    def fails(cand: Trajectory):
        nonlocal runs
        runs += 1
        r = run_trajectory(cand)
        return r if r.failed else None

    changed = True
    while changed and runs < budget:
        changed = False
        for i in range(len(best.ops)):
            if runs >= budget:
                break
            r = fails(best.with_ops(best.ops[:i] + best.ops[i + 1:]))
            if r is not None:
                best, best_res, changed = best.with_ops(
                    best.ops[:i] + best.ops[i + 1:]), r, True
                break
        if changed:
            continue
        for cand in (replace(best, n_requests=2), replace(best, max_new=5),
                     replace(best, prompt_len=3)):
            if cand == best or runs >= budget:
                continue
            r = fails(cand)
            if r is not None:
                best, best_res, changed = cand, r, True
                break
    return best, best_res


# -------------------------------------------------------------------- corpus
def write_entry(corpus_dir: str, name: str, traj: Trajectory, *,
                status: str, digest: Optional[str] = None,
                violations: Iterable[str] = (),
                cells: Iterable = (), provenance: Optional[dict] = None
                ) -> str:
    os.makedirs(corpus_dir, exist_ok=True)
    path = os.path.join(corpus_dir, f"{name}.json")
    with open(path, "w") as f:
        json.dump({
            "version": 1,
            "status": status,
            "trajectory": traj.to_json(),
            "digest": digest,
            "violations": sorted(violations),
            "cells": sorted("|".join(c) for c in cells),
            "provenance": provenance or {},
        }, f, indent=1, sort_keys=True)
    return path


def load_entry(path: str) -> dict:
    with open(path) as f:
        entry = json.load(f)
    entry["trajectory"] = Trajectory.from_json(entry["trajectory"])
    return entry


# ------------------------------------------------------------------ campaign
@dataclass
class CampaignReport:
    seed: int
    budget: int
    ran: int = 0
    truncated: bool = False           # time box hit before the budget
    coverage: dict = field(default_factory=dict)
    new_cells: list = field(default_factory=list)
    counterexamples: list = field(default_factory=list)
    promoted: list = field(default_factory=list)
    wall_s: float = 0.0

    def to_json(self) -> dict:
        return {
            "seed": self.seed, "budget": self.budget, "ran": self.ran,
            "truncated": self.truncated, "coverage": self.coverage,
            "new_cells": sorted("|".join(c) for c in self.new_cells),
            "counterexamples": self.counterexamples,
            "promoted": self.promoted, "wall_s": round(self.wall_s, 1),
        }


class FuzzCampaign:
    def __init__(self, *, seed: int = 0, db: Optional[CoverageDB] = None,
                 corpus_dir: Optional[str] = None,
                 engines: Optional[Iterable[str]] = None,
                 time_budget_s: Optional[float] = None,
                 minimize_budget: int = MINIMIZE_BUDGET):
        self.seed = int(seed)
        self.db = db or CoverageDB()
        self.corpus_dir = corpus_dir
        self.mutator = FaultMutator(self.seed, self.db, engines)
        self.time_budget_s = time_budget_s
        self.minimize_budget = minimize_budget
        # coverage-novel passing runs: (trajectory, digest, cells) — the
        # mutation pool and the seed-promotion candidates
        self.pool: list[tuple[Trajectory, str, frozenset]] = []

    def run(self, budget: int) -> CampaignReport:
        t0 = time.monotonic()
        rep = CampaignReport(seed=self.seed, budget=budget)
        for index in range(budget):
            if (self.time_budget_s is not None
                    and time.monotonic() - t0 > self.time_budget_s):
                rep.truncated = True      # explicit, never a silent cap
                break
            traj = self.mutator.propose(
                index, pool=[t for t, _, _ in self.pool])
            res = run_trajectory(traj)
            new = self.db.record(res.cells)
            rep.ran += 1
            rep.new_cells.extend(new)
            if res.failed:
                self._counterexample(rep, index, traj)
            elif new:
                self.pool.append((traj, res.digest(), frozenset(res.cells)))
        rep.coverage = self.db.report(self.mutator.universe)
        self.db.save()
        rep.wall_s = time.monotonic() - t0
        return rep

    def _counterexample(self, rep: CampaignReport, index: int,
                        traj: Trajectory) -> None:
        small, res = minimize(traj, self.minimize_budget)
        if not res.failed:                # did not reproduce on replay
            small, res = traj, run_trajectory(traj)
            if not res.failed:
                rep.counterexamples.append(
                    {"index": index, "flaky": True,
                     "trajectory": traj.to_json()})
                return
        record = {"index": index, "flaky": False,
                  "violations": res.violations,
                  "trajectory": small.to_json()}
        if self.corpus_dir is not None:
            record["path"] = write_entry(
                self.corpus_dir, f"ce_{self.seed}_{index:04d}", small,
                status="counterexample", violations=res.violations,
                cells=res.cells,
                provenance={"campaign_seed": self.seed, "index": index})
        rep.counterexamples.append(record)

    def promote_seeds(self, k: int, corpus_dir: Optional[str] = None
                      ) -> list[str]:
        """Write up to ``k`` coverage-diverse passing trajectories as ``seed``
        corpus entries (greedy max-new-cell selection over the pool)."""
        corpus_dir = corpus_dir or self.corpus_dir
        if corpus_dir is None:
            return []
        chosen: list[tuple[Trajectory, str, frozenset]] = []
        covered: set = set()
        pool = list(self.pool)
        while pool and len(chosen) < k:
            pool.sort(key=lambda p: (len(p[2] - covered), len(p[2])),
                      reverse=True)
            best = pool.pop(0)
            if not (best[2] - covered) and chosen:
                break                     # nothing new left to pin
            chosen.append(best)
            covered |= best[2]
        paths = []
        for i, (traj, digest, cells) in enumerate(chosen):
            paths.append(write_entry(
                corpus_dir, f"seed_{traj.engine}_{self.seed}_{i:02d}", traj,
                status="seed", digest=digest, cells=cells,
                provenance={"campaign_seed": self.seed}))
        return paths
