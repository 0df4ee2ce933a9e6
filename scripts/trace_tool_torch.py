#!/usr/bin/env python
"""Post-mortem CLI over a serving/training trace_event JSON dump of the
PyTorch port.

The counterpart of ``scripts/trace_tool.py`` over ``repro_torch.obs``, with
the same options and exit codes. Reads the trace a
:class:`repro_torch.obs.Tracer` exported (``dump_trace`` /
``GroupResult.trace``), from a run on the card or on the CPU alike: it
reads a JSON file and runs nothing on a device. It reconstructs the two
things a human wants after a faulted run:

* **per-request timelines** — every span of one request's life in wall order:
  submit → slot assignment → prefill chunks → decode windows → (faults →
  recovery lanes →) first/terminal token, across replicas if a kill re-routed
  it;
* **the fault-causality report** — one line per fault event joining the exact
  error word (bit-for-bit what ``DeviceFuture.fault_codes()`` read back) to
  the recovery action the policy chose and the recovery-complete span (or the
  terminal FAILED/EXPIRED answer that legally resolved it);
* **group chains** — replica kill → ULFM shrink → ledger re-routes → the
  re-routed requests' terminal statuses on the survivors.

``--check`` runs the same round-trip validation the CI trace smoke relies on
(every traced request reaches exactly one terminal span, every fault
resolves, every kill chains to a shrink, every host eviction was preceded by
detector suspicion and followed by an epoch that excludes the dead host) and
exits non-zero on any problem.

Usage:
  python scripts/trace_tool_torch.py trace.json              # report everything
  python scripts/trace_tool_torch.py trace.json --request 7  # one timeline
  python scripts/trace_tool_torch.py trace.json --faults     # fault report only
  python scripts/trace_tool_torch.py trace.json --chains     # membership chains
  python scripts/trace_tool_torch.py trace.json --check      # validation
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.obs import (  # noqa: E402
    format_fault_report,
    format_timeline,
    group_chains,
    load_trace,
    request_timelines,
    validate,
)


def _print_chains(trace: dict) -> None:
    chains = group_chains(trace)
    if not chains:
        print("no replica kills recorded")
        return
    for c in chains:
        shr = ", ".join(
            f"r{s['pid']}@{s['ts'] / 1e3:.1f}ms" for s in c["shrinks"])
        print(f"replica {c['dead_rank']} killed "
              f"@{c['kill']['ts'] / 1e3:.1f}ms -> shrink observed by "
              f"[{shr or 'NOBODY'}] -> {len(c['reroutes'])} request(s) "
              "re-routed:")
        for r in c["reroutes"]:
            a = r.get("args", {})
            tid = a.get("trace_id")
            if tid is None:
                tid = a.get("request")
            term = c["terminals"].get(tid)
            status = (term.get("args", {}).get("status")
                      if term is not None else "UNANSWERED")
            print(f"  request {a.get('request')} "
                  f"r{a.get('from_rank')} -> r{a.get('to_rank')}: {status}")
        for j in c.get("rejoins", ()):
            a = j.get("args", {})
            print(f"  rank {a.get('rank')} REJOINED "
                  f"@{j['ts'] / 1e3:.1f}ms epoch {a.get('epoch')} "
                  f"({a.get('reason')}, {j.get('dur', 0.0) / 1e3:.1f}ms "
                  "warm-up to first exchange)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="reconstruct causal timelines from a trace_event dump")
    ap.add_argument("trace", help="trace_event JSON file")
    ap.add_argument("--request", type=int, default=None,
                    help="print one request's timeline (by trace id)")
    ap.add_argument("--faults", action="store_true",
                    help="print only the fault-causality report")
    ap.add_argument("--chains", action="store_true",
                    help="print only the group membership chains "
                         "(kill -> shrink -> reroute -> rejoin)")
    ap.add_argument("--check", action="store_true",
                    help="validate the trace round-trip; exit 1 on problems")
    args = ap.parse_args(argv)

    trace = load_trace(args.trace)
    n = len(trace.get("traceEvents", []))

    if args.check:
        problems = validate(trace)
        if problems:
            print(f"{args.trace}: {len(problems)} problem(s) in {n} events:")
            for p in problems:
                print(f"  FAIL {p}")
            return 1
        timelines = request_timelines(trace)
        print(f"{args.trace}: OK — {n} events, {len(timelines)} traced "
              "request(s), every fault resolved, every request answered")
        return 0

    if args.request is not None:
        print(format_timeline(trace, args.request))
        return 0

    if args.faults:
        print(format_fault_report(trace))
        return 0

    if args.chains:
        _print_chains(trace)
        return 0

    timelines = request_timelines(trace)
    print(f"{args.trace}: {n} events, {len(timelines)} traced request(s)")
    print()
    for tid in sorted(timelines, key=lambda t: (t is None, t)):
        print(format_timeline(trace, tid))
        print()
    print(format_fault_report(trace))
    print()
    _print_chains(trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
