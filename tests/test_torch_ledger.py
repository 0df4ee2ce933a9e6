"""The port's durable request ledger (``repro_torch.serve.ledger``), the
cases of ``test_serve_elastic.py`` on it:

* the write-ahead log's torn-write contract (a truncated *final* record is
  a legal crash artefact and is discarded; the same damage mid-log is
  fatal), reopening, compaction;
* an epoch transition torn mid-epoch or mid-route replays to a consistent
  membership and outstanding set, and a restarted port group serves the
  backlog to completion, bit-exact;
* kill a rank, stop the whole fleet, restart from the ledger alone, regrow
  through the non-blocking join: zero drops, every stream bit-equal to a
  clean run;
* the autoscaler's hysteresis (grow on sustained backlog, cooldown, shrink
  on idle down to the floor), and a scheduled join that outlives a full
  drain;

and across the packages: the same ledger history written by either package
gives the same bytes, and a log written by either replays in the other to
the same outstanding ids, members, epoch and responses.
"""
import os
from types import SimpleNamespace

import pytest
import torch

import repro.serve.ledger as jax_ledger
import repro.serve.queue as jax_queue
import repro_torch.serve.ledger as port_ledger
import repro_torch.serve.queue as port_queue
from repro_torch.configs import smoke_config
from repro_torch.core.faults import FaultSchedule, FaultSpec
from repro_torch.models import Model
from repro_torch.serve import EngineConfig, ServeGroup
from repro_torch.serve.group import AutoscalePolicy
from repro_torch.serve.ledger import (
    GroupLedger,
    LedgerCorrupt,
    WriteAheadLog,
    replay,
    request_record,
)
from repro_torch.serve.queue import OK, Request, Response

torch.set_num_threads(2)


def _req(i, max_new=8):
    return Request(id=i, prompt=(5 + i, 6 + i, 7 + i), max_new_tokens=max_new)


# ------------------------------------------------------------------- the WAL
class TestWriteAheadLog:
    def _three(self, path):
        wal = WriteAheadLog(path)
        for i in range(3):
            wal.append(request_record(_req(i)))
        wal.close()

    def test_torn_final_record_discarded_not_fatal(self, tmp_path):
        path = str(tmp_path / "ledger.wal")
        self._three(path)
        with open(path, "r+") as f:            # crash mid-write
            f.truncate(os.path.getsize(path) - 20)
        rep = replay(path)
        assert rep.torn == 1
        assert sorted(rep.requests) == [0, 1]
        assert [r.id for r in rep.outstanding()] == [0, 1]

    def test_reopen_truncates_torn_tail_and_continues(self, tmp_path):
        path = str(tmp_path / "ledger.wal")
        self._three(path)
        with open(path, "r+") as f:
            f.truncate(os.path.getsize(path) - 20)
        wal2 = WriteAheadLog(path)             # the restart reopens the log
        wal2.append(request_record(_req(7)))
        wal2.close()
        rep = replay(path)
        assert rep.torn == 0
        assert sorted(rep.requests) == [0, 1, 7]

    def test_midfile_corruption_is_fatal(self, tmp_path):
        path = str(tmp_path / "ledger.wal")
        self._three(path)
        lines = open(path).read().splitlines()
        # valid JSON, wrong checksum: damage, not a crash artefact
        assert '"kind":"submit"' in lines[1]
        lines[1] = lines[1].replace('"kind":"submit"', '"kind":"sabmit"')
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        with pytest.raises(LedgerCorrupt):
            replay(path)

    def test_compaction_bounds_log_and_preserves_replay(self, tmp_path):
        path = str(tmp_path / "ledger.wal")
        led = GroupLedger([_req(i) for i in range(20)], ranks=(0, 1),
                          wal=WriteAheadLog(path, compact_every=8))
        for rank in (0, 1):
            led.take(rank)
        for i in range(16):
            led.complete(Response(id=i, status=OK, tokens=(1, 2), replica=0))
        led.wal.close()
        assert sum(1 for _ in open(path)) <= 16
        rep = replay(path)
        assert sorted(rep.responses) == list(range(16))
        assert [r.id for r in rep.outstanding()] == [16, 17, 18, 19]
        assert rep.members == (0, 1)


# ------------------------------------------------------------- the group
@pytest.fixture(scope="module")
def group():
    cfg = smoke_config("recurrentgemma-2b")
    return ServeGroup(cfg, 3, max_ranks=4, model=Model(cfg, device="cpu"),
                      config=EngineConfig(num_slots=2, max_len=48, window=4,
                                          overlap=True))


# --------------------------------------------- torn epoch transitions
class TestTornEpochTransition:
    """A crash during an epoch transition: ``on_death`` appends the
    shrink's epoch record, then one route record per re-routed request, so
    the log can tear mid-epoch (the transition never happened) or mid-route
    (it did, a re-route didn't). Replay must be consistent at both tear
    points, and a restarted group must serve the backlog to completion."""

    N = 9

    def _mid_transition_wal(self, tmp_path, retire=()):
        path = str(tmp_path / "ledger.wal")
        led = GroupLedger([_req(i) for i in range(self.N)], ranks=(0, 1, 2),
                          wal=WriteAheadLog(path))
        for rank in (0, 1, 2):
            led.take(rank)
        for rid in retire:
            led.complete(Response(id=rid, status=OK, tokens=(1, 2),
                                  replica=rid % 3))
        moved = led.on_death([2])
        assert moved, "the dead rank had nothing outstanding"
        led.wal.close()
        return path, moved

    @staticmethod
    def _lines(path):
        with open(path, "rb") as f:
            return f.read().splitlines(keepends=True)

    @staticmethod
    def _tear_into(path, lines, idx):
        """Everything before line ``idx`` intact, line ``idx`` half
        written, everything after gone."""
        with open(path, "wb") as f:
            f.writelines(lines[:idx])
            f.write(lines[idx][:max(len(lines[idx]) // 2, 1)])

    def _last_epoch_idx(self, lines):
        return max(i for i, ln in enumerate(lines) if b'"kind":"epoch"' in ln)

    def test_torn_epoch_record_replays_pre_transition_membership(
            self, tmp_path):
        path, _ = self._mid_transition_wal(tmp_path, retire=(0, 1))
        lines = self._lines(path)
        self._tear_into(path, lines, self._last_epoch_idx(lines))
        rep = replay(path)
        assert rep.torn == 1
        assert rep.epoch == 0
        assert rep.members == (0, 1, 2)
        assert sorted(rep.responses) == [0, 1]
        assert [r.id for r in rep.outstanding()] == [
            i for i in range(self.N) if i not in (0, 1)]
        assert any(rank == 2 for rank in rep.routes.values())

    def test_torn_route_record_keeps_membership_and_outstanding_set(
            self, tmp_path):
        path, moved = self._mid_transition_wal(tmp_path, retire=(0, 1))
        lines = self._lines(path)
        epoch_idx = self._last_epoch_idx(lines)
        route_idx = next(i for i in range(epoch_idx + 1, len(lines))
                         if b'"kind":"route"' in lines[i])
        self._tear_into(path, lines, route_idx)
        rep = replay(path)
        assert rep.torn == 1
        assert rep.epoch == 1
        assert rep.members == (0, 1)
        moved_ids = sorted(rid for rid, _, _ in moved)
        assert all(rep.routes[rid] == 2 for rid in moved_ids)
        outstanding = {r.id for r in rep.outstanding()}
        assert set(moved_ids) <= outstanding
        assert outstanding == {i for i in range(self.N) if i not in (0, 1)}

    def test_restart_from_torn_transition_serves_to_completion(
            self, group, tmp_path):
        clean = group.serve([_req(i) for i in range(self.N)])
        assert all(r.ok for r in clean.responses.values())
        path, _ = self._mid_transition_wal(tmp_path)     # nothing retired
        lines = self._lines(path)
        self._tear_into(path, lines, self._last_epoch_idx(lines))
        r2 = group.serve_from_ledger(path)
        assert sorted(r2.responses) == list(range(self.N))
        assert all(r.ok for r in r2.responses.values())
        for rid, resp in r2.responses.items():
            assert resp.tokens == clean.responses[rid].tokens, rid


# --------------------------------------------------------------- autoscaler
class TestAutoscaler:
    def _tick(self, group, led, pol, round_i, report):
        group._autoscale_tick(led, pol, None, round_i, report)

    def test_grows_only_on_sustained_backlog(self, group):
        led = GroupLedger([_req(i) for i in range(8)], ranks=(0, 1),
                          spares=(2,))
        pol = AutoscalePolicy(queue_high=2, grow_sustain=3, cooldown=0)
        report = SimpleNamespace(events=[])
        for r in range(2):           # pressure, but not sustained yet
            self._tick(group, led, pol, r, report)
            assert led.autoscale_events == []
        self._tick(group, led, pol, 2, report)
        assert led.autoscale_events == [
            {"round": 2, "action": "grow", "rank": 2}]
        assert led.summoned(2) == "autoscale"
        for r in range(3, 8):        # spares exhausted: no over-grow
            self._tick(group, led, pol, r, report)
        assert len(led.autoscale_events) == 1

    def test_cooldown_separates_grow_decisions(self, group):
        led = GroupLedger([_req(i) for i in range(8)], ranks=(0, 1),
                          spares=(2, 3))
        pol = AutoscalePolicy(queue_high=2, grow_sustain=1, cooldown=10)
        report = SimpleNamespace(events=[])
        for r in range(10):
            self._tick(group, led, pol, r, report)
        assert [e["rank"] for e in led.autoscale_events] == [2]
        self._tick(group, led, pol, 10, report)     # cooldown elapsed
        assert [e["rank"] for e in led.autoscale_events] == [2, 3]

    def test_shrinks_on_idle_down_to_the_floor(self, group):
        led = GroupLedger([_req(i) for i in range(6)], ranks=(0, 1, 2))
        for rank in (0, 1, 2):
            led.take(rank)           # backlog drained, work still in flight
        pol = AutoscalePolicy(queue_high=2, shrink_idle=3, cooldown=0,
                              min_ranks=2)
        report = SimpleNamespace(events=[])
        for r in range(2):
            self._tick(group, led, pol, r, report)
            assert led.leaving is None
        self._tick(group, led, pol, 2, report)
        assert led.leaving == 2      # highest non-leader rank drains out
        assert led.autoscale_events == [
            {"round": 2, "action": "shrink", "rank": 2}]
        for r in range(3, 8):        # one leave at a time, never below 2
            self._tick(group, led, pol, r, report)
        assert len(led.autoscale_events) == 1
        led2 = GroupLedger([_req(0)], ranks=(0, 1))
        led2.take(0), led2.take(1)
        report2 = SimpleNamespace(events=[])
        for r in range(8):
            self._tick(group, led2, pol, r, report2)
        assert led2.leaving is None and led2.autoscale_events == []


def test_scheduled_join_survives_full_drain(group):
    """A tiny workload drains long before the summoned spare finishes its
    (stretched) state transfer: the survivors hold the final close until
    the join lands, so the joiner is never stranded."""
    old = group.transfer_chunks
    group.transfer_chunks = 60          # ~120 ms, many idle gate rounds
    try:
        res = group.serve([_req(i, max_new=4) for i in range(4)], joins=[1])
    finally:
        group.transfer_chunks = old
    assert sorted(res.responses) == list(range(4))
    assert all(r.ok for r in res.responses.values())
    assert 3 in res.joined
    assert res.report(3).events[0][0] == "join"
    assert all(rr.exception is None and not rr.killed for rr in res.reports)


# ------------------------------------------------------------ the whole story
def test_kill_crash_replay_regrow_end_to_end(group, tmp_path):
    path = str(tmp_path / "ledger.wal")
    mk = lambda: [_req(i, max_new=10) for i in range(30)]  # noqa: E731
    clean = group.serve(mk())
    assert all(r.ok for r in clean.responses.values())
    # act 1: rank 2 dies at round 2, then the WHOLE fleet stops at round 5
    r1 = group.serve(mk(), faults=FaultSchedule(
        [FaultSpec(step=2, kind="kill", rank=2)]), ledger_path=path, crash_at=5)
    assert r1.crashed
    assert len(r1.responses) < 30
    # every active rank died (rank 2 by the schedule, the rest in the fleet
    # stop); the dormant spare returned without serving
    assert [rr.rank for rr in r1.reports if rr.killed] == [0, 1, 2]
    assert all(rr.exception is None for rr in r1.reports)
    assert r1.reports[3].value is None
    # act 2: a new incarnation restarts from the ledger alone, replays the
    # outstanding set onto the survivors, and regrows to 3 ranks by
    # re-admitting the killed rank through the non-blocking join
    r2 = group.serve_from_ledger(path, joins=[1])
    merged = {**r1.responses, **r2.responses}
    assert sorted(merged) == list(range(30))                   # zero drops
    assert all(r.ok for r in merged.values())
    assert 2 in r2.joined
    assert r2.epoch >= 2          # kill-shrink epoch + join epoch
    assert r2.replayed
    assert ("join", r2.epoch, "scheduled") in r2.report(2).events
    for rid, resp in merged.items():
        assert resp.tokens == clean.responses[rid].tokens, rid


# ------------------------------------------------------ across the packages
PACKAGES = {"jax": (jax_ledger, jax_queue), "torch": (port_ledger, port_queue)}


def _history(pkg, path):
    """One ledger history: submits, routes, stamps, retirements, a death
    that re-routes, a join epoch, and a compaction."""
    ledger, queue = PACKAGES[pkg]
    reqs = [queue.Request(id=i, prompt=(3 + i, 4 + i), max_new_tokens=4 + i)
            for i in range(10)]
    led = ledger.GroupLedger(reqs, ranks=(0, 1, 2), spares=(3,),
                             wal=ledger.WriteAheadLog(path, compact_every=64))
    for rank in (0, 1, 2):
        for req in led.take(rank, 2):
            req.arrival_t = 100.0 + req.id / 8
            led.note_stamp(req)
    for rid in (0, 4):
        led.complete(queue.Response(id=rid, status=queue.OK, tokens=(7, rid),
                                    latency_s=0.5, ttft_s=0.25, retries=1,
                                    replica=rid % 3, detail="d"))
    led.on_death([1])
    led.summon_next("scheduled")
    led.enter_epoch(led.request_join(3))
    led.complete(queue.Response(id=2, status=queue.FAILED, replica=2,
                                detail="retries"))
    led.wal.close()


@pytest.mark.parametrize("writer, reader",
                         [("jax", "torch"), ("torch", "jax")])
def test_log_replays_in_the_other_package(tmp_path, writer, reader):
    paths = {pkg: str(tmp_path / f"{pkg}.wal") for pkg in PACKAGES}
    for pkg, path in paths.items():
        _history(pkg, path)
    # the same history gives the same CRC'd JSON lines in both packages
    assert open(paths["jax"], "rb").read() == open(paths["torch"], "rb").read()
    got = PACKAGES[reader][0].replay(paths[writer])
    want = PACKAGES[writer][0].replay(paths[writer])
    assert got.torn == want.torn == 0
    assert [r.id for r in got.outstanding()] == [r.id for r in want.outstanding()]
    assert [(r.arrival_t, r.prompt, r.max_new_tokens)
            for r in got.outstanding()] == [
        (r.arrival_t, r.prompt, r.max_new_tokens) for r in want.outstanding()]
    assert (got.members, got.epoch) == (want.members, want.epoch) == ((0, 2, 3), 2)
    assert {i: vars(r) for i, r in got.responses.items()} == {
        i: vars(r) for i, r in want.responses.items()}
    assert sorted(got.responses) == [0, 2, 4]
