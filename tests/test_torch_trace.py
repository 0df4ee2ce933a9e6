"""Fault-causality tracing in the port (``repro_torch.obs``) against the JAX
package's, on the qwen3-1.7b smoke config (float32) with the JAX weights
carried over by ``params_from_jax``, prompts from numpy seeds, and the same
word injections and state faults on both sides:

* the stepwise, blocking-window, overlap, paged and speculative replicas
  emit the JAX replica's events as multisets: every event's name,
  category, lane and arguments (trace id, slot, window, step, exact error
  word, recovery action and outcome, pages, drafts, ...), and the request
  spans' (trace id, status, tokens, retries). Timestamps, durations and
  ``*_s`` arguments are left out: they are wall-clock readings of two
  different runs. So are ``window_wait`` instants, which record whether the
  device had finished a window when the host reached it — a race on both
  sides;
* a three-replica group through a kill, and through a crash and a replay
  with a joining spare, emits the JAX group's ``group`` events (kill,
  shrink, re-routes; fleet stop, ledger replay, state transfer, join) and
  request spans, and its chains and ``validate`` agree (``_group_events``
  says what of a fleet is a race in both packages);
* a traced run gives an untraced run's streams bit for bit, with the same
  host syncs, and the ``NULL_TRACER`` records nothing;
* a fault retired after its lane was freed and reassigned goes to the
  request that held the slot at dispatch;
* the sampled request set equals the reference's for ``sample=0.3``;
* ``validate``, ``fault_report``, ``group_chains``, ``request_timelines``
  and the formatters give the reference's results on the same trace dicts;
* the serving ``EventLog`` export is wall-ordered and merges with a trace
  (the reference's satellite checks).

The paged JAX replica's window waits for its outputs: on the CPU its page
table aliases the host array (``test_torch_paged_serve.py``).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import obs as jax_obs
from repro.core.faults import FaultSchedule as JaxFaultSchedule
from repro.core.faults import FaultSpec as JaxFaultSpec
from repro.core.resilient import Event as JaxEvent
from repro.core.resilient import EventLog as JaxEventLog
from repro.launch.paging import PagedLayout as JaxLayout
from repro.launch.steps import make_cache_prefill as jax_cache_prefill
from repro.launch.steps import make_prefill_decode_window as jax_prefill_window
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import Replica as JaxReplica
from repro.serve import Request as JaxRequest
from repro.serve import ServeGroup as JaxServeGroup
from repro.serve.replica import SERVE_PROBES
from repro_torch import obs
from repro_torch.core.device_channel import readback
from repro_torch.core.errors import ErrorCode
from repro_torch.core.faults import FaultSchedule, FaultSpec
from repro_torch.core.resilient import Event, EventLog
from repro_torch.serve import (OK, EngineConfig, Replica, Request, ServeGroup,
                               ServeMetrics)
from repro_torch.serve.queue import Response
from test_torch_serve import _env

torch.set_num_threads(2)

ARCH = "qwen3-1.7b"
OVERFLOW = int(ErrorCode.OVERFLOW)
NONFINITE = int(ErrorCode.NONFINITE_LOSS)
REJECT = int(ErrorCode.DRAFT_REJECT)
ENGINES = {
    "stepwise": dict(num_slots=2, max_len=48),
    "window": dict(num_slots=2, max_len=48, window=4, overlap=False),
    "overlap": dict(num_slots=2, max_len=48, window=4, overlap=True),
    # 5 pages of 16 for 4 lanes of up to 64 positions: the pool evicts
    "paged": dict(num_slots=4, max_len=64, window=4, overlap=True,
                  paged=True, page_size=16, page_budget=5),
    "spec": dict(num_slots=2, max_len=64, window=4, overlap=True,
                 speculate=True, draft_len=2, draft_layers=1),
}
# dispatch index -> [(window step, slot, word)]: two faults on one lane
# inside the escalation window, one on the other
WORDS = {3: [(1, 0, OVERFLOW)], 5: [(2, 1, NONFINITE)], 6: [(0, 0, OVERFLOW)]}
POISON_AT = 4           # drive cycle of the state fault (a NaN in K)
GROUP = dict(num_slots=2, max_len=48, window=4, overlap=True, trace=True)


def _injector(words):
    def inject(index, shape):
        if index not in words:
            return None
        w = np.zeros(shape, np.uint32)
        for step, slot, code in words[index]:
            w[(slot,) if len(shape) == 1 else (step, slot)] |= np.uint32(code)
        return w
    return inject


def _waited(fn):
    return lambda *args: jax.block_until_ready(fn(*args))


def _traffic(n, seed, prompt=(3, 10), new=(8, 15)):
    rng = np.random.default_rng(seed)
    return [(tuple(int(t) for t in rng.integers(1, 500, int(rng.integers(*prompt)))),
             int(rng.integers(*new))) for _ in range(n)]


def _requests(cls, traffic):
    return [cls(id=i, prompt=p, max_new_tokens=n) for i, (p, n) in enumerate(traffic)]


def _jax_replica(engine, tracer, **kw):
    jcfg, _, jmodel, params, _ = _env(ARCH)
    conf = dict(ENGINES[engine], max_request_retries=6)
    if conf.get("paged"):
        layout = JaxLayout(jmodel.init_cache(1, conf["max_len"]), conf["max_len"],
                           page_size=conf["page_size"],
                           num_pages=conf["page_budget"])
        kw.update(paged_layout=layout, window_fn=_waited(jax_prefill_window(
            jcfg, SERVE_PROBES, window=conf["window"], paged=layout)),
            prefill_fn=_waited(jax_cache_prefill(
                jcfg, SERVE_PROBES, fused=True, paged=layout, donate=True)))
    return JaxReplica(jcfg, params=params, config=JaxEngineConfig(**conf),
                      tracer=tracer, **kw)


def _port_replica(engine, tracer, **kw):
    _, cfg, _, _, model = _env(ARCH)
    conf = dict(ENGINES[engine], max_request_retries=6)
    return Replica(cfg, model, config=EngineConfig(**conf), tracer=tracer, **kw)


def _serve(rep, cls, traffic, poison_at=None):
    """Serve ``traffic``; from cycle ``poison_at`` on, a NaN goes once into
    the first lane that is decoding (``inject_state_fault``)."""
    for r in _requests(cls, traffic):
        assert rep.submit(r) is None
    out, cycles, poisoned = {}, 0, poison_at is None
    while not rep.idle():
        if not poisoned and cycles >= poison_at:
            lanes = [s.idx for s in rep.sched.slots
                     if s.active and s.pending is None and s.generated]
            poisoned = bool(lanes) and rep.inject_state_fault(lanes[0]) is not None
        for resp in rep.step():
            out[resp.id] = resp
        cycles += 1
        assert cycles < 500
    return out


ARG_KEYS = ("trace_id", "slot", "window", "step", "code", "code_names",
            "action", "outcome", "status", "tokens", "retries", "replica",
            "prompt_len", "max_new_tokens", "pages", "in_use", "drafted",
            "accepted", "faulted", "fresh", "exhausts", "committed",
            "discarded", "request", "reason", "rank", "round", "survivors",
            "from_rank", "to_rank", "epoch", "records", "torn",
            "outstanding", "answered", "complete", "chunks", "num_pages",
            "bytes")


def _key(ev, *, pid=True):
    """An event without its wall-clock readings (module docstring)."""
    a = ev.get("args") or {}
    assert not set(a) - set(ARG_KEYS) - {"detail", "ttft_s"}, sorted(a)
    return repr((ev["name"], ev["cat"], ev["ph"], ev["pid"] if pid else None,
                 ev["tid"], tuple((k, a.get(k)) for k in ARG_KEYS)))


def _multiset(events, **kw):
    return sorted(_key(e, **kw) for e in events if e["name"] != "window_wait")


def _request_spans(events):
    return sorted((a["trace_id"], a["status"], a["tokens"], a["retries"])
                  for e in events if e["name"] == "request"
                  for a in [e["args"]])


def _tokens(out):
    return {i: tuple(r.tokens) for i, r in out.items()}


@pytest.mark.parametrize("engine", list(ENGINES))
def test_replica_events_match_the_reference(engine):
    traffic = (_traffic(6, seed=4, prompt=(6, 10), new=(10, 14))
               if engine == "paged" else _traffic(4, seed=2))
    poison = None if engine == "spec" else POISON_AT
    jtr, tr = jax_obs.Tracer(), obs.Tracer()
    ref = _serve(_jax_replica(engine, jtr, fault_injector=_injector(WORDS)),
                 JaxRequest, traffic, poison)
    rep = _port_replica(engine, tr, fault_injector=_injector(WORDS))
    readback.count = 0
    got = _serve(rep, Request, traffic, poison)
    syncs = readback.count
    assert _tokens(got) == _tokens(ref)
    assert {r.status for r in got.values()} == {OK}
    assert rep.metrics.faults                          # the injections landed
    want = jtr.events()
    assert _multiset(tr.events()) == _multiset(want)
    assert _request_spans(tr.events()) == _request_spans(want)
    trace = obs.merge_traces(tr)
    assert obs.validate(trace) == [] == jax_obs.validate(jax_obs.merge_traces(jtr))
    # one batch of fault events per fault record, one event per attributed
    # slot: the OR of their words, DRAFT_REJECT stripped, is the word the
    # policy saw
    batches: dict = {}
    for e in tr.events():
        if e["cat"] == "fault" and e["args"]["action"] != "prefill_retry":
            batches.setdefault(e["ts"], []).append(e["args"])
    records = [f for f in rep.metrics.faults
               if f.action not in ("prefill_retry", "page_reclaim")]
    assert len(batches) == len(records)
    for batch, f in zip(batches.values(), records):
        word = 0
        for a in batch:
            word |= a["code"]
            assert a["action"] == f.action
            assert a["code_names"] == [c.name for c in ErrorCode(a["code"]).classes()]
        # the record's word also ORs the stale lanes' words (dropped from
        # the attribution, as in the reference)
        assert word & ~REJECT & ~f.code == 0, (batch, f)
        assert {a["slot"] for a in batch} == set(f.slots)
    report = obs.fault_report(trace)
    assert report and all(fr.resolved for fr in report)
    if engine == "paged":
        assert rep.metrics.page_evictions and any(
            e["name"] == "page_evict" for e in tr.events())
    if engine == "spec":
        spec = [e["args"] for e in tr.events() if e["name"] == "speculate"]
        assert sum(a["drafted"] for a in spec) == rep.metrics.draft_tokens
    # tracing changes no bit and adds no host sync
    plain = _port_replica(engine, None, fault_injector=_injector(WORDS))
    assert plain.trace is obs.NULL_TRACER
    readback.count = 0
    assert _tokens(_serve(plain, Request, traffic, poison)) == _tokens(got)
    assert readback.count == syncs
    assert [(f.step, f.code, f.action, f.slots) for f in plain.metrics.faults] == [
        (f.step, f.code, f.action, f.slots) for f in rep.metrics.faults]
    assert obs.NULL_TRACER.num_events == 0


def test_clean_run_causal_timeline_per_request():
    """Each request's life is one ordered chain: submit, slot assignment,
    prompt chunks, decode spans, first token, and one terminal span that
    contains it all; window spans ride the engine lane."""
    traffic = _traffic(4, seed=3, prompt=(6, 10))
    jtr, tr = jax_obs.Tracer(), obs.Tracer()
    _serve(_jax_replica("overlap", jtr), JaxRequest, traffic)
    rep = _port_replica("overlap", tr)
    out = _serve(rep, Request, traffic)
    assert _multiset(tr.events()) == _multiset(jtr.events())
    trace = obs.merge_traces(tr)
    assert obs.validate(trace) == []
    timelines = obs.request_timelines(trace)
    assert sorted(timelines) == sorted(out)
    for tid, evs in timelines.items():
        names = [e["name"] for e in evs]
        assert names[0] == "submit" and names.count("request") == 1
        assert (names.index("slot_assign") < names.index("chunk")
                < names.index("first_token"))
        assert "decode" in names
        term = [e for e in evs if e["name"] == "request"][0]["args"]
        assert term["status"] == OK and term["tokens"] == len(out[tid].tokens)
    chunks = [e["args"] for e in tr.events() if e["name"] == "chunk"]
    assert len(chunks) == rep.metrics.prefill_chunks
    assert sum(a["tokens"] for a in chunks) == rep.metrics.prefill_chunk_tokens
    wins = [e for e in tr.events() if e["name"] == "window"]
    assert wins and all(w["tid"] == obs.ENGINE_TID for w in wins)


def test_fault_after_lane_reuse_goes_to_the_dispatch_owner():
    """A window in flight when its lane's request finishes still carries
    that request's trace id: a fault it retires is attributed to it, not to
    the request that took the slot meanwhile."""
    # request 0 (3 prompt tokens, 4 new) ends when window 2 retires; window
    # 3, dispatched just before, faults on its lane, which request 2 holds
    # by the time window 3 retires
    traffic = [((7, 8, 9), 4), ((11, 12, 13, 14), 12), ((21, 22), 6)]
    words = {3: [(3, 0, OVERFLOW)]}
    jtr, tr = jax_obs.Tracer(), obs.Tracer()
    ref = _serve(_jax_replica("overlap", jtr, fault_injector=_injector(words)),
                 JaxRequest, traffic)
    got = _serve(_port_replica("overlap", tr, fault_injector=_injector(words)),
                 Request, traffic)
    assert _tokens(got) == _tokens(ref)
    faults = [e for e in tr.events() if e["cat"] == "fault"]
    assert [(e["args"]["trace_id"], e["args"]["slot"]) for e in faults] == [(0, 0)]
    assigns = [e["args"]["trace_id"] for e in tr.events()
               if e["name"] == "slot_assign" and e["args"]["slot"] == 0]
    assert assigns[:2] == [0, 2]
    assert _multiset(tr.events()) == _multiset(jtr.events())
    assert obs.validate(obs.merge_traces(tr)) == []


def _jax_group():
    """The JAX group inits the params ``_env`` carries over (PRNGKey(0))."""
    jcfg = _env(ARCH)[0]
    return JaxServeGroup(jcfg, 3, config=JaxEngineConfig(**GROUP))


def _port_group(max_ranks=3):
    _, cfg, _, _, model = _env(ARCH)
    return ServeGroup(cfg, 3, model=model, config=EngineConfig(**GROUP),
                      max_ranks=max_ranks)


def _group_events(trace, reroutes=True):
    """The fleet's ``group`` events, each ``reroute`` without its pid: it is
    recorded by whichever survivor shrinks first, a race in both packages
    (``test_torch_group.py``). The replicas' own events of a fleet are not
    compared one by one: a survivor takes its re-routed requests in the
    round after the shrink or, when the other survivor moves them only
    after this one's next take, in the round after that, and a rank may
    retire one more window before the group closes — races in both
    packages that shift window indices, not streams."""
    evs = [e for e in trace["traceEvents"] if e["cat"] == "group"]
    return (_multiset([e for e in evs if e["name"] != "reroute"]),
            _multiset([e for e in evs if e["name"] == "reroute" and reroutes],
                      pid=False))


def test_group_kill_trace_matches_the_reference():
    traffic = _traffic(9, seed=6)
    kill = [dict(step=2, kind="kill", rank=1)]
    ref = _jax_group().serve(_requests(JaxRequest, traffic), faults=JaxFaultSchedule(
        [JaxFaultSpec(**s) for s in kill]))
    got = _port_group().serve(_requests(Request, traffic), faults=FaultSchedule(
        [FaultSpec(**s) for s in kill]))
    assert _tokens(got.responses) == _tokens(ref.responses)
    trace, want = got.trace(), ref.trace()
    assert sorted(got.tracers) == [0, 1, 2]
    assert _group_events(trace) == _group_events(want)
    assert _request_spans(trace["traceEvents"]) == _request_spans(want["traceEvents"])
    assert obs.validate(trace) == [] == jax_obs.validate(want)
    (chain,) = obs.group_chains(trace)
    assert chain["dead_rank"] == 1 and {s["pid"] for s in chain["shrinks"]} == {0, 2}
    assert {r["args"]["request"] for r in chain["reroutes"]} == set(got.rerouted)
    for r in chain["reroutes"]:
        term = chain["terminals"][r["args"]["trace_id"]]
        assert term["args"]["status"] == OK and term["pid"] == r["args"]["to_rank"]
    assert any(e["pid"] == 1 and e["name"] == "replica_kill"
               for e in trace["traceEvents"])


def test_group_replay_trace_matches_the_reference(tmp_path):
    """A fleet crash at round 3, then a restart from the log that summons a
    spare: one causal story over both incarnations' merged traces."""
    traffic = _traffic(9, seed=6)
    merged = {}
    for name, group, spare, cls in (("jax", _jax_group(), None, JaxRequest),
                                    ("torch", _port_group(), _port_group(4), Request)):
        path = str(tmp_path / f"{name}.wal")
        r1 = group.serve(_requests(cls, traffic), ledger_path=path, crash_at=3)
        if spare is None:
            group.max_ranks = 4          # the restart provisions one spare
            spare = group
        r2 = spare.serve_from_ledger(path, joins=[1])
        assert r1.crashed and r2.joined == (3,)
        merged[name] = (r1, r2, (jax_obs if name == "jax" else obs).merge_trace_dicts(
            r1.trace(), r2.trace()))
    (j1, j2, want), (p1, p2, trace) = merged["jax"], merged["torch"]
    assert _tokens({**p1.responses, **p2.responses}) == _tokens(
        {**j1.responses, **j2.responses})
    # re-balancing at the join moves what is still untaken: a race
    assert _group_events(trace, False) == _group_events(want, False)
    assert _request_spans(trace["traceEvents"]) == _request_spans(want["traceEvents"])
    assert obs.validate(trace) == [] == jax_obs.validate(want)
    names = {e["name"] for e in trace["traceEvents"] if e["cat"] == "group"}
    assert {"fleet_stop", "ledger_replay", "state_transfer", "replica_join"} <= names
    # the trace ids came back from the WAL: every submit pairs with one
    # terminal, over the two incarnations
    subs = {e["args"]["trace_id"] for e in trace["traceEvents"] if e["name"] == "submit"}
    assert subs == set(range(len(traffic)))


def test_sampling_matches_the_reference():
    assert [obs.Tracer(sample=0.3).sampled(i) for i in range(4096)] == [
        jax_obs.Tracer(sample=0.3).sampled(i) for i in range(4096)]
    traffic = _traffic(6, seed=8)
    jtr, tr = jax_obs.Tracer(sample=0.3), obs.Tracer(sample=0.3)
    ref = _serve(_jax_replica("overlap", jtr), JaxRequest, traffic)
    got = _serve(_port_replica("overlap", tr), Request, traffic)
    sampled = {r.trace_id for r in got.values()} - {None}
    assert sampled == {r.trace_id for r in ref.values()} - {None}
    assert 0 < len(sampled) < len(traffic)
    assert _multiset(tr.events()) == _multiset(jtr.events())
    assert any(e["name"] == "window" for e in tr.events())   # engine spans kept
    with pytest.raises(ValueError):
        obs.Tracer(sample=1.5)


def _problem_trace():
    """A trace with one problem of every kind ``validate`` reports."""
    ev = lambda name, cat, ts, pid=0, dur=None, **a: {  # noqa: E731
        "name": name, "cat": cat, "ph": "X" if dur is not None else "i",
        "ts": ts, "pid": pid, "tid": 0, **({"dur": dur} if dur is not None else {}),
        "args": a}
    return {"traceEvents": [
        ev("submit", "request", 1.0, trace_id=5),
        ev("fault", "fault", 2.0, trace_id=6, slot=1, window=3, step=0, code=8,
           code_names=["OVERFLOW"], action="skip_batch"),
        ev("decode", "window", 0.0, dur=1.0, trace_id=7, slot=0),
        ev("request", "request", 3.0, dur=1.0, trace_id=7, status=OK, tokens=1,
           retries=0),
        ev("replica_kill", "group", 4.0, pid=2, rank=2, round=1),
        ev("host_evict", "host", 5.0, rank=1),
        ev("epoch", "host", 6.0, members=[0, 1]),
        ev("replica_join", "group", 7.0, pid=3, dur=1.0, rank=3),
        ev("shard_fanout", "shard", 8.0, window=2, shard=0, tp=2),
        ev("shard_loss", "group", 9.0, pid=4, shard=1),
    ]}


def test_postmortem_matches_the_reference():
    traffic = _traffic(4, seed=2)
    tr = obs.Tracer()
    _serve(_port_replica("overlap", tr, fault_injector=_injector(WORDS)),
           Request, traffic, POISON_AT)
    group = _port_group().serve(_requests(Request, _traffic(9, seed=6)),
                                faults=FaultSchedule([FaultSpec(step=2, kind="kill",
                                                                rank=1)]))
    for trace in (obs.merge_traces(tr), group.trace(), _problem_trace()):
        problems = obs.validate(trace)
        assert problems == jax_obs.validate(trace)
        assert [dataclasses.asdict(f) for f in obs.fault_report(trace)] == [
            dataclasses.asdict(f) for f in jax_obs.fault_report(trace)]
        assert obs.group_chains(trace) == jax_obs.group_chains(trace)
        assert obs.request_timelines(trace) == jax_obs.request_timelines(trace)
        assert obs.format_fault_report(trace) == jax_obs.format_fault_report(trace)
        for tid in obs.request_timelines(trace):
            assert obs.format_timeline(trace, tid) == jax_obs.format_timeline(trace, tid)
    assert len(problems) == 9          # one per check, two for the eviction


def _clock(values):
    it = iter(values)
    last = [0.0]

    def tick():
        for v in it:
            last[0] = v
            return v
        return last[0]

    return tick


def test_event_log_export_is_wall_ordered_and_merges(tmp_path):
    """``ServeMetrics.to_event_log`` stamps each event with its wall time, in
    wall order, so ``event_log_to_events`` merges it with a serving trace
    as the reference's does; dump and load round-trip."""
    m = ServeMetrics(clock=_clock([10.0, 11.0, 12.0, 13.0]))
    m.record_response(Response(id=0, status=OK, tokens=(1,), latency_s=2.0))
    m.record_fault(step=3, code=int(ErrorCode.STATE_FAULT), action="skip",
                   slots=(0,))
    m.record_response(Response(id=1, status=OK, tokens=(2,), latency_s=1.0))
    log = m.to_event_log()
    assert [(e.kind, e.t) for e in log.events] == [
        ("ok", 10.0), ("fault", 11.0), ("ok", 12.0)]
    evs = obs.event_log_to_events(log)
    jlog = JaxEventLog()
    for e in log.events:
        jlog.add(JaxEvent(**dataclasses.asdict(e)))
    assert evs == jax_obs.event_log_to_events(jlog)
    assert [e["ts"] for e in evs] == [8.0e6, 11.0e6, 11.0e6]
    train = EventLog()
    train.add(Event(step=0, kind="ok", duration_s=0.5, t=10.5))
    train.add(Event(step=1, kind="fault", code=NONFINITE, action="restore_good",
                    t=11.0))
    tr = obs.Tracer(clock=_clock([10.2]))
    tr.instant("submit", "request", trace_id=0)
    merged = obs.merge_traces(tr)
    merged["traceEvents"].extend(obs.event_log_to_events(train, pid=7))
    assert [e["name"] for e in obs.events_of(merged)] == ["ok", "submit", "fault"]
    path = str(tmp_path / "trace.json")
    dumped = obs.dump_trace(path, tr)
    assert obs.load_trace(path) == dumped == obs.merge_traces(tr)
