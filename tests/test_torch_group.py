"""The port's ``ServeGroup`` against the JAX package's, on the
recurrentgemma-2b smoke config with the JAX group's weights carried over
(float32), in the reference group's default engine
(``EngineConfig(num_slots=2)``, stepwise) and in the overlap engine, under
four schedules: clean; rank 1 killed at round 2; ``state_nan`` on rank 0 at
round 2 (a NaN in ``h``, caught by the state probe); and a fleet crash at
round 3 replayed from the write-ahead log, regrowing to 3 ranks through a
join. The two groups agree on:

* the killed ranks, each survivor's ``shrink`` and ``inject`` events by
  round, the ids re-routed at each round (the ``reroute`` record lands on
  whichever survivor shrinks first, a race in both packages, so the union
  over survivors is compared), the ``rerouted`` and ``replayed`` sets, who
  joined, and the final epoch;
* every response's status, and its tokens except where the reference's
  top-2 logit gap is below ``LOGIT_TOL`` (``test_torch_serve.py``);

and the port's group is bit-equal to one port ``Replica`` with the same
config, and replays the JAX group's log to the JAX group's outcome. One
paged and one speculative fleet (qwen3-1.7b smoke) give the contiguous,
plain fleet's streams bit for bit, and ``agree_round`` decides as the
reference's on a grid. Each JAX group is built once for the module, as
``test_serve.py`` does.
"""
import itertools
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core.faults import FaultSchedule as JaxFaultSchedule
from repro.core.faults import FaultSpec as JaxFaultSpec
from repro.models import build_model
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import Request as JaxRequest
from repro.serve import ServeGroup as JaxServeGroup
from repro.serve.group import agree_round as jax_agree_round
from repro_torch.configs import smoke_config
from repro_torch.core.faults import FaultSchedule, FaultSpec
from repro_torch.models import Model
from repro_torch.serve import (EngineConfig, Replica, Request, ServeGroup,
                               agree_round)
from repro_torch.weights import params_from_jax
from test_torch_serve import LOGIT_TOL

torch.set_num_threads(2)

ARCH = "recurrentgemma-2b"
ENGINES = {"stepwise": dict(num_slots=2, max_len=48),
           "overlap": dict(num_slots=2, max_len=48, window=4, overlap=True)}
SCHEDULES = {
    "clean": [],
    "kill": [dict(step=2, kind="kill", rank=1)],
    "state_nan": [dict(step=2, kind="state_nan", rank=0)],
}
CRASH_AT = 3

_GROUPS: dict = {}


def _groups(engine):
    """(JAX group, port group, port model, JAX model, JAX params), built
    once per engine for the module."""
    if engine not in _GROUPS:
        jg = JaxServeGroup(jax_smoke_config(ARCH), 3,
                           config=JaxEngineConfig(**ENGINES[engine]))
        model = params_from_jax(jax.device_get(jg.params), smoke_config(ARCH),
                                device="cpu")
        pg = ServeGroup(smoke_config(ARCH), 3, model=model,
                        config=EngineConfig(**ENGINES[engine]))
        _GROUPS[engine] = (jg, pg, model, build_model(jg.cfg), jg.params)
    return _GROUPS[engine]


def _traffic(n=9, seed=3):
    """(prompt, max_new): 2–12-token prompts, 3–14 new tokens."""
    rng = np.random.default_rng(seed)
    return [(tuple(int(t) for t in rng.integers(1, 500, int(rng.integers(2, 13)))),
             int(rng.integers(3, 15))) for _ in range(n)]


def _requests(cls, traffic):
    return [cls(id=i, prompt=p, max_new_tokens=n) for i, (p, n) in enumerate(traffic)]


def _events(res):
    """Per rank: killed, None (a spare never summoned), or its shrink and
    inject events by round."""
    out = {}
    for rr in res.reports:
        if rr.killed:
            out[rr.rank] = "killed"
            continue
        assert rr.exception is None, (rr.rank, rr.exception)
        if rr.value is None:
            out[rr.rank] = None                  # a spare never summoned
            continue
        ev = rr.value.events
        out[rr.rank] = [e for e in ev if e[0] in ("shrink", "inject")]
    return out


def _reroutes(res):
    """The ids re-routed at each round, over every survivor."""
    got: dict = {}
    for rr in res.reports:
        if rr.value is not None:
            for kind, rnd, ids in rr.value.events:
                if kind == "reroute":
                    got.setdefault(rnd, set()).update(ids)
    return got


def _assert_streams_match(engine, ref, got, traffic):
    """Equal statuses; equal streams except from a position where the JAX
    reference's top-2 logit gap is below the tolerance."""
    *_, jmodel, params = _groups(engine)
    assert sorted(ref) == sorted(got)
    for i, (prompt, _) in enumerate(traffic):
        assert ref[i].status == got[i].status, i
        a, b = ref[i].tokens, got[i].tokens
        if a == b:
            continue
        k = next(j for j in range(min(len(a), len(b))) if a[j] != b[j])
        logits, _ = jmodel.forward(
            params, jax.numpy.asarray([list(prompt) + list(a[:k])]), impl="ref")
        top2 = np.sort(np.asarray(logits[0, -1]))[-2:]
        assert top2[1] - top2[0] < LOGIT_TOL, (i, k, a, b)


def _single_replica(engine, traffic):
    """The same traffic through one port Replica with the group's config."""
    _, _, model, *_ = _groups(engine)
    rep = Replica(smoke_config(ARCH), model, config=EngineConfig(**ENGINES[engine]))
    for r in _requests(Request, traffic):
        assert rep.submit(r) is None
    return {r.id: r for r in rep.run()}


def _tokens(responses):
    return {i: r.tokens for i, r in responses.items()}


@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("engine", list(ENGINES))
def test_group_agrees_with_the_reference(engine, schedule):
    jg, pg, *_ = _groups(engine)
    traffic = _traffic()
    specs = SCHEDULES[schedule]
    ref = jg.serve(_requests(JaxRequest, traffic),
                   faults=JaxFaultSchedule([JaxFaultSpec(**s) for s in specs]))
    got = pg.serve(_requests(Request, traffic),
                   faults=FaultSchedule([FaultSpec(**s) for s in specs]))
    assert _events(got) == _events(ref)
    assert _reroutes(got) == _reroutes(ref)
    assert sorted(got.rerouted) == sorted(ref.rerouted)
    assert got.epoch == ref.epoch
    _assert_streams_match(engine, ref.responses, got.responses, traffic)
    assert all(r.ok for r in got.responses.values())
    assert _tokens(got.responses) == _tokens(_single_replica(engine, traffic))
    if schedule == "kill":
        assert got.rerouted and {r.replica for r in got.responses.values()} <= {0, 2}
        for rank in (0, 2):
            assert [e for e in got.report(rank).events if e[0] == "shrink"] == [
                ("shrink", 2, 2)]
    elif schedule == "state_nan":
        assert got.rerouted == ()
        r0 = got.report(0)
        assert [e[0] for e in r0.events] == ["inject"]
        assert r0.metrics.fault_counts().get("STATE_FAULT") == 1
        assert all(not got.report(r).events for r in (1, 2))


@pytest.mark.parametrize("engine", list(ENGINES))
def test_crash_and_replay_agree_with_the_reference(engine, tmp_path):
    """A fleet crash at round 3, then a fresh incarnation with a spare
    (``max_ranks=4``) restarts from the log and summons it at round 1. The
    port also replays the JAX group's log to the JAX group's outcome."""
    jg, pg, model, *_ = _groups(engine)
    traffic = _traffic()
    out = {}
    for name, group, req_cls in (("jax", jg, JaxRequest), ("torch", pg, Request)):
        path = str(tmp_path / f"{name}.wal")
        r1 = group.serve(_requests(req_cls, traffic), ledger_path=path,
                         crash_at=CRASH_AT)
        shutil.copy(path, str(tmp_path / f"{name}-crashed.wal"))
        group.max_ranks = 4           # the restart provisions one spare
        try:
            r2 = group.serve_from_ledger(path, joins=[1])
        finally:
            group.max_ranks = 3
        out[name] = (r1, r2)
    (j1, j2), (p1, p2) = out["jax"], out["torch"]
    for a, b in ((j1, p1), (j2, p2)):
        assert (b.crashed, b.replayed, b.joined, b.epoch) == (
            a.crashed, a.replayed, a.joined, a.epoch)
        assert [rr.killed for rr in b.reports] == [rr.killed for rr in a.reports]
        assert all(rr.exception is None for rr in a.reports + b.reports)
    assert p1.crashed and p2.joined == (3,) and p2.replayed
    ref = {**j1.responses, **j2.responses}
    got = {**p1.responses, **p2.responses}
    _assert_streams_match(engine, ref, got, traffic)
    assert _tokens(got) == _tokens(_single_replica(engine, traffic))
    # the JAX group's log, replayed by the port
    cross = ServeGroup(smoke_config(ARCH), 3, model=model, max_ranks=4,
                       config=EngineConfig(**ENGINES[engine])
                       ).serve_from_ledger(str(tmp_path / "jax-crashed.wal"),
                                           joins=[1])
    assert (cross.replayed, cross.joined, cross.epoch) == (
        j2.replayed, j2.joined, j2.epoch)
    assert _tokens({**j1.responses, **cross.responses}) == _tokens(got)


# ---------------------------------------------------- paged and speculative
@pytest.fixture(scope="module")
def qwen3():
    cfg = smoke_config("qwen3-1.7b")
    return cfg, Model(cfg, device="cpu", seed=1)


FLEET = dict(num_slots=3, max_len=48, window=4, overlap=True)


@pytest.mark.parametrize("mode", [dict(paged=True, page_size=8),
                                  dict(speculate=True, draft_len=2)],
                         ids=["paged", "speculative"])
def test_paged_and_speculative_fleets_give_the_plain_streams(qwen3, mode):
    cfg, model = qwen3
    traffic = _traffic(n=8, seed=5)
    kill = FaultSchedule([FaultSpec(step=2, kind="kill", rank=1)])
    plain = ServeGroup(cfg, 3, model=model, config=EngineConfig(**FLEET))
    fleet = ServeGroup(cfg, 3, model=model, config=EngineConfig(**FLEET, **mode))
    want = plain.serve(_requests(Request, traffic))
    for faults in (None, kill):
        got = fleet.serve(_requests(Request, traffic), faults=faults)
        assert all(r.ok for r in got.responses.values())
        assert _tokens(got.responses) == _tokens(want.responses)
    assert got.rerouted and [rr.rank for rr in got.reports if rr.killed] == [1]


# ------------------------------------------------------------------ agreement
def test_agree_round_matches_the_reference():
    for rem, agreed, mine, hold in itertools.product(
            (0, 1, 5), (0, 1, 2, 3), (0, 1, 2, 3), (False, True)):
        got = agree_round(rem, agreed, mine, hold_close=hold)
        want = jax_agree_round(rem, agreed, mine, hold_close=hold)
        assert (got.action, got.epoch) == (want.action, want.epoch)


def test_group_defaults_to_the_card_and_refuses_what_is_not_ported():
    cfg = smoke_config(ARCH)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ServeGroup(cfg, 3)
    # tracing is ported: a traced group builds; tp > 1 is not
    assert ServeGroup(cfg, 3, device="cpu",
                      config=EngineConfig(trace=True, trace_sample=0.5)).trace
    with pytest.raises(NotImplementedError, match="item 11"):
        ServeGroup(cfg, 3, device="cpu", config=EngineConfig(tp=2, window=4))
    with pytest.raises(ValueError, match=">= 2"):
        ServeGroup(cfg, 1, device="cpu")
