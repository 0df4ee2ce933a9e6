#!/usr/bin/env python
"""Coverage-guided fault-injection fuzz campaign over the port's serving stack.

The counterpart of ``scripts/fuzz.py`` over ``repro_torch.fuzz``, with the
same options and exit codes, and ``--device``: the kits' model (the
qwen3-1.7b smoke config from the port's seeded init) lies on the card
unless ``--device cpu`` asks for the CPU. The engines default to those the
port runs; the tensor-parallel ``overlap_tp`` waits for ROADMAP item 11
and is refused. Counterexamples and seeds go to the port's own corpus
directory (the reference's ``tests/fuzz_corpus`` is replayed by the JAX
package's tests).

Runs ``--budget`` seeded trajectories through the real engines, biased
toward uncovered (error code × recovery action × engine) cells, applies the
oracles (bit-exactness vs the clean run, zero drops, page-ledger invariants,
trace causality), minimizes every counterexample and writes it to
``--corpus``. Exit status is non-zero iff a (non-flaky) counterexample was
found — the CI smoke gates on that.

Usage:
  python scripts/fuzz_torch.py --budget 200 --seed 0          # on the card
  python scripts/fuzz_torch.py --budget 8 --engines overlap,spec_paged \
      --time-box 240 --no-promote                             # smoke
  python scripts/fuzz_torch.py --device cpu --budget 4 --engines stepwise

The coverage DB (``--db``) persists across campaigns, so successive runs
keep pushing into the uncovered tail instead of re-proving the easy cells.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.fuzz import (  # noqa: E402
    ENGINES,
    PORT_ENGINES,
    CoverageDB,
    FuzzCampaign,
    use_model,
)
from repro_torch.fuzz.runner import MODEL, UNPORTED  # noqa: E402
from repro_torch.models import Model  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--budget", type=int, default=50,
                    help="trajectories to run (default 50)")
    ap.add_argument("--seed", type=int, default=0,
                    help="campaign seed: trajectories replay from it")
    ap.add_argument("--corpus", default="artifacts/fuzz-torch-out/corpus",
                    help="directory for counterexample / seed entries")
    ap.add_argument("--db", default="artifacts/fuzz-torch-out/coverage_db.json",
                    help="persisted coverage DB (JSON)")
    ap.add_argument("--report", default="artifacts/fuzz-torch-out/report.json",
                    help="campaign report path (JSON)")
    ap.add_argument("--engines", default=None,
                    help=f"comma-separated subset of {','.join(PORT_ENGINES)}")
    ap.add_argument("--device", default="cuda",
                    help="the kits' model's device (default cuda)")
    ap.add_argument("--time-box", type=float, default=None,
                    help="wall-clock budget in seconds (truncates the run)")
    ap.add_argument("--promote-seeds", type=int, default=0, metavar="N",
                    help="promote up to N coverage-diverse passing "
                         "trajectories as seed corpus entries")
    ap.add_argument("--no-promote", action="store_true",
                    help="do not write anything to the corpus directory")
    args = ap.parse_args(argv)

    engines = args.engines.split(",") if args.engines else list(PORT_ENGINES)
    for e in engines:
        if e in UNPORTED:
            ap.error(f"the {e} engine is not ported yet: {UNPORTED[e]}")
        if e not in ENGINES:
            ap.error(f"unknown engine {e!r}; known: {','.join(PORT_ENGINES)}")
    use_model(Model(smoke_config(MODEL), device=args.device, seed=0))
    campaign = FuzzCampaign(
        seed=args.seed, db=CoverageDB(args.db),
        corpus_dir=None if args.no_promote else args.corpus,
        engines=engines, time_budget_s=args.time_box)
    rep = campaign.run(args.budget)
    if args.promote_seeds and not args.no_promote:
        rep.promoted = campaign.promote_seeds(args.promote_seeds)

    cov = rep.coverage
    print(f"fuzz: ran {rep.ran}/{rep.budget} trajectories "
          f"({'time-boxed, ' if rep.truncated else ''}{rep.wall_s:.0f}s), "
          f"coverage {cov['covered']}/{cov['universe']} cells "
          f"({100 * cov['fraction']:.1f}%), "
          f"{len(rep.new_cells)} new this run")
    if cov["uncovered"]:
        print("uncovered:", ", ".join(cov["uncovered"][:12])
              + (" ..." if len(cov["uncovered"]) > 12 else ""))
    real = [c for c in rep.counterexamples if not c.get("flaky")]
    flaky = [c for c in rep.counterexamples if c.get("flaky")]
    for c in real:
        print(f"COUNTEREXAMPLE (index {c['index']}):")
        for v in c["violations"]:
            print(f"  - {v}")
        if "path" in c:
            print(f"  promoted: {c['path']}")
    if flaky:
        print(f"note: {len(flaky)} non-reproducing (flaky) failure(s) — "
              "recorded in the report, not promoted")
    for p in rep.promoted:
        print(f"seed entry: {p}")

    if args.report:
        d = os.path.dirname(args.report)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(rep.to_json(), f, indent=1, sort_keys=True)
        print(f"report: {args.report}")
    return 1 if real else 0


if __name__ == "__main__":
    raise SystemExit(main())
