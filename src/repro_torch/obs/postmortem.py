# Copy of repro/obs/postmortem.py (stdlib only).
"""Post-mortem reconstruction over trace_event JSON (``repro_torch.obs``).

Pure functions from a trace object (``{"traceEvents": [...]}`` as produced by
:func:`repro_torch.obs.trace.merge_traces`) to the two artefacts a human (or the
future fault-injection fuzzer's oracle) wants after a faulted run:

* :func:`request_timelines` — every event of one request's life, in wall
  order, keyed by trace id: submit → slot assignment → prefill chunks →
  decode windows → (faults → recovery lanes →) first/terminal token.
* :func:`fault_report` — one :class:`FaultResolution` per fault event,
  joining the fault to its recovery action and the recovery-complete span
  (or the terminal FAILED/EXPIRED response that abandoned it): the causal
  chain *fault → detection → recovery → re-prefill → first healthy token*.
* :func:`validate` — the round-trip check the CI trace smoke runs: every
  fault resolves, every traced request reaches exactly one terminal span,
  every recovery span closes, every kill chains to a shrink, every elastic
  rejoin chains to a *completed* state transfer, and every multihost
  ``host_evict`` is preceded by a ``host_suspect`` for the same rank and
  followed by an ``epoch`` whose membership excludes it. Returns a list of
  problems (empty = clean).

Everything here is stdlib-only on plain dicts, so a command-line tool over
it needs no dependency.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Optional


def _args(ev: dict) -> dict:
    a = ev.get("args")
    return a if isinstance(a, dict) else {}


def _tid_of(ev: dict):
    return _args(ev).get("trace_id")


def events_of(trace: dict) -> list[dict]:
    evs = trace.get("traceEvents", [])
    return sorted(evs, key=lambda e: (e.get("ts", 0.0), e.get("pid", 0)))


def request_timelines(trace: dict) -> dict[int, list[dict]]:
    """Events grouped per trace id, in wall order. Request-scoped engine
    events (decode/prefill/fault/recovery spans carrying a ``trace_id`` arg)
    are included; anonymous engine events (window spans) are not."""
    out: dict[int, list[dict]] = {}
    for ev in events_of(trace):
        tid = _tid_of(ev)
        if tid is not None:
            out.setdefault(tid, []).append(ev)
    return out


@dataclass
class FaultResolution:
    """One fault event joined to its recovery outcome."""

    trace_id: Optional[int]
    pid: int                      # replica rank
    window: Optional[int]         # dispatch counter of the faulted window
    step: Optional[int]           # first faulting step within the window
    slot: Optional[int]
    code: int                     # exact error word from fault_codes()
    code_names: tuple[str, ...]
    action: Optional[str]         # recovery action the policy chose
    detected_ts: float            # wall time the wait surfaced the fault (µs)
    recovery: Optional[dict] = None    # the recovery-complete span, if any
    terminal: Optional[dict] = None    # the request's terminal span, if traced

    @property
    def resolved(self) -> bool:
        """A fault is resolved iff its recovery lane completed, or the
        request was given a terminal answer anyway (FAILED / EXPIRED — the
        serving ABORT is a legal resolution, a silent drop is not)."""
        if self.recovery is not None:
            return True
        return self.terminal is not None

    @property
    def recovery_s(self) -> Optional[float]:
        if self.recovery is None:
            return None
        return ((self.recovery["ts"] + self.recovery.get("dur", 0.0)
                 - self.detected_ts) / 1e6)


def fault_report(trace: dict) -> list[FaultResolution]:
    """Join every ``fault`` event to the recovery span / terminal response
    that resolved it (same trace id, same slot when attributable, later in
    wall time)."""
    evs = events_of(trace)
    faults = [e for e in evs if e.get("cat") == "fault"]
    recoveries = [e for e in evs if e.get("cat") == "recovery"
                  and e.get("name") == "recovery"]
    terminals = [e for e in evs if e.get("cat") == "request"
                 and e.get("name") == "request"]
    out = []
    for f in faults:
        a = _args(f)
        tid = a.get("trace_id")
        rec = None
        for r in recoveries:
            ra = _args(r)
            if ra.get("trace_id") != tid:
                continue
            if r["ts"] + r.get("dur", 0.0) < f["ts"]:
                continue                      # resolved an earlier fault
            if rec is None or r["ts"] < rec["ts"]:
                rec = r
        term = None
        for t in terminals:
            # no ts ordering requirement: detection is deferred by design, so
            # a stale window's fault can legally surface *after* its lane's
            # request was answered — the answer still resolves it
            if _tid_of(t) == tid:
                term = t
                break
        out.append(FaultResolution(
            trace_id=tid, pid=f.get("pid", 0),
            window=a.get("window"), step=a.get("step"), slot=a.get("slot"),
            code=int(a.get("code", 0)),
            code_names=tuple(a.get("code_names", ())),
            action=a.get("action"), detected_ts=f["ts"],
            recovery=rec, terminal=term))
    return out


def group_chains(trace: dict) -> list[dict]:
    """Cross-replica causal chains: one dict per replica kill, linking the
    kill to the ULFM shrink that detected it, the ledger re-routes it caused,
    the re-routed requests' terminal spans on the survivors, and — when the
    elastic layer later re-admitted the same rank — the ``replica_join`` span
    that closed the kill → shrink → rejoin loop."""
    evs = events_of(trace)
    kills = [e for e in evs if e.get("name") == "replica_kill"]
    shrinks = [e for e in evs if e.get("name") == "ulfm_shrink"]
    reroutes = [e for e in evs if e.get("name") == "reroute"]
    joins = [e for e in evs if e.get("name") == "replica_join"]
    terminals = {_tid_of(e): e for e in evs
                 if e.get("cat") == "request" and e.get("name") == "request"}
    chains = []
    for k in kills:
        dead = _args(k).get("rank", k.get("pid"))
        chain_shrinks = [s for s in shrinks if s["ts"] >= k["ts"]
                         and dead not in _args(s).get("survivors", ())]
        chain_routes = [r for r in reroutes
                        if _args(r).get("from_rank") == dead]
        chain_joins = [j for j in joins if j["ts"] >= k["ts"]
                       and _args(j).get("rank") == dead]
        routed = {}
        for r in chain_routes:
            tid = _tid_of(r)
            if tid is None:
                # re-routed before its first queue accept (e.g. while still
                # pending in the ledger): no trace id stamped yet, but the
                # trace id *is* the request id by contract, so the eventual
                # terminal — possibly in a post-restart incarnation — still
                # links by id
                tid = _args(r).get("request")
            routed[tid] = terminals.get(tid)
        chains.append({"kill": k, "dead_rank": dead,
                       "shrinks": chain_shrinks, "reroutes": chain_routes,
                       "terminals": routed, "rejoins": chain_joins})
    return chains


def validate(trace: dict) -> list[str]:
    """Round-trip consistency check; returns problems (empty = clean)."""
    problems: list[str] = []
    evs = events_of(trace)
    if not evs:
        return ["trace carries no events"]
    # every traced request reaches exactly one terminal span
    submits = {}
    terminals: dict[int, int] = {}
    for e in evs:
        tid = _tid_of(e)
        if e.get("name") == "submit":
            submits[tid] = e
        elif e.get("cat") == "request" and e.get("name") == "request":
            terminals[tid] = terminals.get(tid, 0) + 1
    for tid in submits:
        n = terminals.get(tid, 0)
        if n != 1:
            problems.append(
                f"request {tid}: {n} terminal spans (want exactly 1)")
    # terminal spans contain their request's scoped events. The span start is
    # anchored at the submit event when present: the terminal span's own start
    # is reconstructed from the response latency at record time, a hair after
    # the commit that produced it, so the first events of a request's life
    # legitimately precede it by that recording gap.
    timelines = request_timelines(trace)
    for tid, term_n in terminals.items():
        term = next(e for e in evs if e.get("cat") == "request"
                    and e.get("name") == "request" and _tid_of(e) == tid)
        sub = submits.get(tid)
        t0 = sub["ts"] if sub is not None else term["ts"]
        t1 = term["ts"] + term.get("dur", 0.0)
        for ev in timelines.get(tid, ()):
            if ev.get("name") in ("request", "reroute"):
                continue            # reroutes are group-scoped, not contained
            lo = ev["ts"]
            hi = ev["ts"] + ev.get("dur", 0.0)
            if ev.get("cat") == "fault" and lo >= t0 - 1.0:
                continue            # deferred detection: a stale window's
                                    # fault legally surfaces after the answer
            if lo < t0 - 1.0 or hi > t1 + 1.0:     # 1 µs slack
                problems.append(
                    f"request {tid}: {ev.get('name')} at {lo:.0f}µs outside "
                    f"its request span [{t0:.0f}, {t1:.0f}]µs")
    # every fault resolves
    for fr in fault_report(trace):
        if not fr.resolved:
            problems.append(
                f"fault {fr.code_names or fr.code} on trace {fr.trace_id} "
                f"slot {fr.slot} (window {fr.window} step {fr.step}) never "
                "resolved: no recovery span, no terminal response")
    # every kill chains to a shrink
    for chain in group_chains(trace):
        if not chain["shrinks"]:
            problems.append(
                f"replica {chain['dead_rank']} killed but no survivor "
                "recorded a ulfm_shrink")
    # host fault domain (multihost supervisor): an eviction must have been
    # *detected*, never decreed — a host_evict without a preceding
    # host_suspect for the same rank means the heartbeat detector was
    # bypassed (e.g. an EOF shortcut) — and must be followed by an epoch
    # event whose membership excludes the dead rank (the repair half of the
    # suspect → evict → shrink contract, DESIGN §3.9)
    suspects = [(e["ts"], _args(e).get("rank")) for e in evs
                if e.get("name") == "host_suspect"]
    epochs = [e for e in evs if e.get("name") == "epoch"]
    for e in evs:
        if e.get("name") != "host_evict":
            continue
        rank = _args(e).get("rank")
        if not any(r == rank and ts <= e["ts"] + 1.0 for ts, r in suspects):
            problems.append(
                f"host {rank} evicted without a preceding host_suspect "
                "(eviction must come from the failure detector)")
        if not any(ep["ts"] >= e["ts"] - 1.0
                   and rank not in _args(ep).get("members", (rank,))
                   for ep in epochs):
            problems.append(
                f"host {rank} evicted but no subsequent epoch excludes it "
                "(membership was never repaired)")
    # every rejoin chains to a completed state transfer: a rank may not serve
    # on the widened group without having received the weights + page-pool
    # snapshot first (the background lane must have *finished*, not started)
    transfers = [e for e in evs if e.get("name") == "state_transfer"]
    for j in (e for e in evs if e.get("name") == "replica_join"):
        j_end = j["ts"] + j.get("dur", 0.0)
        ok = any(t.get("pid") == j.get("pid")
                 and _args(t).get("complete")
                 and t["ts"] + t.get("dur", 0.0) <= j_end + 1.0  # 1 µs slack
                 for t in transfers)
        if not ok:
            problems.append(
                f"replica {_args(j).get('rank', j.get('pid'))} joined without "
                "a completed state_transfer span preceding the join")
    # tensor-parallel reconciliation: a fault on a TP replica fans out one
    # shard_fanout instant per shard — all shards 0..tp-1 must appear for
    # each (replica, window), or a shard diverged from its peers' view of
    # the folded error word (exactly what the cross-shard OR-fold forbids)
    fanouts: dict[tuple, set[int]] = {}
    fanout_tp: dict[tuple, int] = {}
    for e in evs:
        if e.get("name") != "shard_fanout":
            continue
        a = _args(e)
        key = (e.get("pid", 0), a.get("window"))
        fanouts.setdefault(key, set()).add(int(a.get("shard", -1)))
        fanout_tp[key] = int(a.get("tp", 0))
    for key, shards in fanouts.items():
        tp = fanout_tp[key]
        missing = sorted(set(range(tp)) - shards)
        if missing:
            problems.append(
                f"replica {key[0]} window {key[1]}: fault fanned out to "
                f"shards {sorted(shards)} but not {missing} (tp={tp}) — "
                "cross-shard reconciliation incomplete")
    # a TP shard loss is a hard fault of the whole owning replica: every
    # shard_loss must be followed by that replica's kill (one SPMD program —
    # a surviving half-replica would violate the shard-set contract)
    kills_by_pid = [(e.get("pid", 0), e["ts"]) for e in evs
                    if e.get("name") == "replica_kill"]
    for e in evs:
        if e.get("name") != "shard_loss":
            continue
        pid = e.get("pid", 0)
        if not any(kp == pid and kt >= e["ts"] - 1.0
                   for kp, kt in kills_by_pid):
            problems.append(
                f"replica {pid}: shard {_args(e).get('shard')} lost but the "
                "owning replica never died (a TP replica must fail whole)")
    return problems


# ------------------------------------------------------------ pretty printing
def _fmt_args(a: dict) -> str:
    skip = {"trace_id"}
    parts = [f"{k}={v}" for k, v in a.items()
             if k not in skip and v is not None]
    return " ".join(parts)


def format_timeline(trace: dict, trace_id: int) -> str:
    """Human-readable per-request timeline, timestamps relative to submit."""
    evs = request_timelines(trace).get(trace_id, [])
    if not evs:
        return f"trace {trace_id}: no events"
    t0 = evs[0]["ts"]
    lines = [f"request trace_id={trace_id}"]
    for ev in evs:
        rel = (ev["ts"] - t0) / 1e3
        dur = ev.get("dur")
        dur_s = f" [{dur / 1e3:.2f}ms]" if dur else ""
        lines.append(
            f"  +{rel:9.2f}ms  r{ev.get('pid', 0)}/s{ev.get('tid', 0):<3} "
            f"{ev.get('cat', '?'):8s} {ev.get('name', '?'):14s}{dur_s}  "
            f"{_fmt_args(_args(ev))}")
    return "\n".join(lines)


def format_fault_report(trace: dict) -> str:
    """The causal fault table: fault → attribution → action → resolution."""
    report = fault_report(trace)
    if not report:
        return "no faults recorded"
    lines = [f"{len(report)} fault(s):"]
    for fr in report:
        codes = "|".join(fr.code_names) if fr.code_names else hex(fr.code)
        if fr.recovery is not None:
            res = f"recovered in {fr.recovery_s * 1e3:.1f}ms"
            out = _args(fr.recovery).get("outcome")
            if out and out != "recovered":
                res = f"{out} after {fr.recovery_s * 1e3:.1f}ms"
        elif fr.terminal is not None:
            res = f"terminal {_args(fr.terminal).get('status')}"
        else:
            res = "UNRESOLVED"
        lines.append(
            f"  trace {fr.trace_id} r{fr.pid}: window {fr.window} "
            f"step {fr.step} slot {fr.slot} {codes} "
            f"-> {fr.action or '?'} -> {res}")
    return "\n".join(lines)
