"""The port's multi-host fault domain (``repro_torch.serve.multihost``)
against the JAX package's, on the CPU.

* the phi-accrual detector: the reference's detector cases
  (``test_multihost_detector.py``) run through both detectors with the same
  injected ``now`` stamps, and every ``phi``, suspicion and eviction is
  equal exactly (pure Python float arithmetic);
* the framing: ``send_msg`` frames are byte-equal to the reference's for
  the same dicts, and ``recv_msg`` reads them back; ``sim_tokens`` is the
  reference's;
* the supervisor's eager validation is the reference's, the device fault
  kinds are refused, and ``jax_coordinator`` raises (ROADMAP item 11);
  ``agree_round``, which every worker runs on each ``reduce``, decides as
  the reference's over a grid of ``(rem, epoch, my_epoch, hold_close)``;
* the reference's sim-backend process cases (``test_serve_multihost.py``)
  against ``sim_oracle``: clean and stable; SIGKILL detect → map → repair
  with zero drops; the WAL re-routes durably; SIGSTOP within the timeout
  never evicts; stop then kill; and the port's one departure: a kill
  whose target has not said ``hello`` yet waits for it;
* one ``replica``-backend run: 3 port worker processes on the qwen3 smoke
  config with the JAX init's params (an ``.npz`` the workers load), rank 1
  SIGKILL'd: every stream bit-equal to an in-process port ``Replica`` on
  the same weights, and equal to the JAX ``Replica``'s except where the
  reference's top-2 logit gap is below ``LOGIT_TOL``.

Every process run uses a 1.5 s suspect timeout and a 180 s serve timeout:
the reference's tests use 0.6 s, which a worker process starved on a
loaded host can miss. The latency bound asserted is the reference's,
``2 x suspect_timeout``.
"""
import dataclasses
import os
import socket
import struct
import sys

import jax
import numpy as np
import pytest

import repro.serve.multihost as ref_mh
from repro.configs import smoke_config as jax_smoke_config
from repro.models import build_model
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import Replica as JaxReplica
from repro.serve import Request as JaxRequest
from repro_torch.configs import smoke_config
from repro_torch.core.errors import ErrorCode
from repro_torch.core.faults import FaultSchedule, FaultSpec
from repro_torch.obs import validate
from repro_torch.serve import (EngineConfig, MultiHostSupervisor,
                               PhiAccrualDetector, Replica, Request, sim_tokens)
from repro_torch.serve import multihost as mh
from repro_torch.serve.ledger import replay as replay_ledger
from repro_torch.weights import params_from_jax, save_tree_npz
from test_torch_serve import LOGIT_TOL

SUSPECT_TIMEOUT = 1.5
TIMEOUT = 180.0
N = 12
HB = 0.05
DET_TIMEOUT = 1.0


def mk_requests(n=N, prompt_len=8, max_new=12):
    return [Request(id=i, prompt=tuple(5 + i + j for j in range(prompt_len)),
                    max_new_tokens=max_new) for i in range(n)]


def mk_staggered(n=N, prompt_len=8):
    """Early ids retire quickly (arming the retire-count fault trigger)
    while late ids are still mid-decode, so a kill finds work to re-route."""
    return [Request(id=i, prompt=tuple(5 + i + j for j in range(prompt_len)),
                    max_new_tokens=6 + 4 * i) for i in range(n)]


def sim_oracle(reqs):
    return {r.id: sim_tokens(r.prompt, r.max_new_tokens) for r in reqs}


def sim_supervisor(nranks=3, **kw):
    kw.setdefault("suspect_timeout", SUSPECT_TIMEOUT)
    kw.setdefault("heartbeat_interval", HB)
    kw.setdefault("sim_tokens_per_step", 2)
    kw.setdefault("sim_step_delay_s", 0.01)
    kw.setdefault("timeout", TIMEOUT)
    return MultiHostSupervisor(nranks, backend="sim", **kw)


def assert_bit_exact(res, reqs):
    assert sorted(res.responses) == [r.id for r in reqs]
    assert all(r.ok for r in res.responses.values())
    oracle = sim_oracle(reqs)
    for rid, resp in res.responses.items():
        assert tuple(resp.tokens) == oracle[rid], rid


# ------------------------------------------------------------------ detector
class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


def _beat(det, clock, rank, n, log, interval=HB):
    for _ in range(n):
        clock.advance(interval)
        log.append(("hb", det.heartbeat(rank), det.phi(rank)))


def _poll(det, log):
    log.append(("poll", det.poll(), {r: det.phi(r) for r in det.ranks()},
                {r: det.is_suspect(r) for r in det.ranks()}))
    return log[-1][1]


def _validation(cls, clock, log):
    for kw in (dict(suspect_timeout=0.0), dict(suspect_timeout=-1.0),
               dict(heartbeat_interval=0.0), dict(heartbeat_interval=2.0),
               dict(evict_factor=1.0), dict(evict_factor=2.5),
               dict(phi_threshold=0.0)):
        kw = {"suspect_timeout": DET_TIMEOUT, "heartbeat_interval": HB, **kw}
        try:
            cls(clock=clock, **kw)
            log.append(("built", kw))
        except ValueError:
            log.append(("refused", kw))
    assert all(e[0] == "refused" for e in log)


def _bookkeeping(det, clock, log):
    det.register(0)
    det.register(1)
    log.append(det.ranks())
    det.remove(0)
    log.append(det.ranks())
    log.append(det.heartbeat(7))
    _poll(det, log)


def _healthy(det, clock, log):
    det.register(0)
    for _ in range(200):
        clock.advance(HB)
        det.heartbeat(0)
        assert _poll(det, log) == ([], [])


def _hard_timeout(det, clock, log):
    det.register(0)
    for k in range(40):
        clock.advance(HB if k % 2 else 8 * HB)
        log.append(det.heartbeat(0))
    for dt in (0.95 * DET_TIMEOUT, 0.06 * DET_TIMEOUT, 0.01):
        clock.advance(dt)
        _poll(det, log)
    clock.advance(0.8 * DET_TIMEOUT)
    assert _poll(det, log)[1] == [0]


def _adaptive(det, clock, log):
    det.register(0)
    det.register(1)
    for k in range(120):
        clock.advance(HB)
        det.heartbeat(0)
        if k % 17 in (0, 1, 7):
            det.heartbeat(1)
    clock.advance(0.5 * DET_TIMEOUT)
    newly, _ = _poll(det, log)
    assert 0 in newly and 1 not in newly


def _one_late_beat(det, clock, log):
    det.register(0)
    _beat(det, clock, 0, 60, log)
    clock.advance(1.9 * HB)
    assert _poll(det, log) == ([], [])


def _stopped_then_resumed(det, clock, log):
    det.register(0)
    _beat(det, clock, 0, 60, log)
    clock.advance(0.9 * DET_TIMEOUT)
    assert _poll(det, log) == ([0], [])
    log.append(det.heartbeat(0))
    _poll(det, log)
    _beat(det, clock, 0, 60, log)
    _poll(det, log)
    clock.advance(2.1 * DET_TIMEOUT)
    assert _poll(det, log) == ([0], [0])


def _clearing_beat_rearms(det, clock, log):
    det.register(0)
    _beat(det, clock, 0, 40, log)
    clock.advance(0.95 * DET_TIMEOUT)
    _poll(det, log)
    log.append(det.heartbeat(0))
    resumed_at = clock.t
    clock.advance(1.0 * DET_TIMEOUT)
    assert _poll(det, log)[1] == []
    clock.advance(1.8 * DET_TIMEOUT - (clock.t - resumed_at) + 0.01)
    assert _poll(det, log)[1] == [0]


DETECTOR_CASES = {
    "parameter_validation": _validation,
    "register_remove_bookkeeping": _bookkeeping,
    "healthy_host_is_never_suspected": _healthy,
    "hard_timeout_suspects_then_evicts_within_bound": _hard_timeout,
    "adaptive_threshold_fires_early_for_tight_beats_only": _adaptive,
    "one_late_beat_is_never_suspicious": _one_late_beat,
    "stopped_then_resumed_host_is_cleared_not_evicted": _stopped_then_resumed,
    "clearing_beat_rearms_eviction_clock": _clearing_beat_rearms,
}


@pytest.mark.parametrize("case", list(DETECTOR_CASES))
def test_detector_decides_as_the_reference(case):
    logs = []
    for cls in (ref_mh.PhiAccrualDetector, PhiAccrualDetector):
        clock, log = FakeClock(), []
        if case == "parameter_validation":
            DETECTOR_CASES[case](cls, clock, log)
        else:
            det = cls(clock=clock, suspect_timeout=DET_TIMEOUT,
                      heartbeat_interval=HB, evict_factor=1.8)
            DETECTOR_CASES[case](det, clock, log)
        logs.append(log)
    assert logs[0] and logs[1] == logs[0]


# --------------------------------------------------------- framing and rules
FRAMES = [{"type": "hello", "rank": 2},
          {"type": "exchange", "rank": 1, "round": 7, "remaining": 3, "epoch": 1},
          {"type": "reduce", "round": 7, "rem": 5, "epoch": 2,
           "members": [0, 2], "evicted": [1]},
          {"type": "bye", "rank": 0, "word": int(ErrorCode.RANK_FAILED),
           "launches": {"flash_decode": 56, "probe_rows": 2}},
          {"type": "trace", "events": [{"name": "é", "ts": 0.1, "x": None}]}]


def _frames(send, frames):
    a, b = socket.socketpair()
    with a, b:
        for f in frames:
            send(a, f)
        a.shutdown(socket.SHUT_WR)
        raw = b""
        while chunk := b.recv(1 << 16):
            raw += chunk
    return raw


def test_frames_are_the_reference_bytes():
    mine, ref = _frames(mh.send_msg, FRAMES), _frames(ref_mh.send_msg, FRAMES)
    assert mine == ref
    (n,) = struct.unpack(">I", mine[:4])
    assert mine[4:4 + n] == b'{"type":"hello","rank":2}'
    a, b = socket.socketpair()
    with a, b:
        a.sendall(mine)
        a.shutdown(socket.SHUT_WR)
        got = [mh.recv_msg(b) for _ in FRAMES]
        assert got == FRAMES
        assert mh.recv_msg(b) is None                 # EOF: the peer is gone


def test_sim_tokens_are_the_reference_tokens():
    rng = np.random.default_rng(0)
    for _ in range(50):
        prompt = tuple(int(t) for t in rng.integers(0, 10 ** 6, int(rng.integers(0, 40))))
        n = int(rng.integers(0, 30))
        assert sim_tokens(prompt, n) == ref_mh.sim_tokens(prompt, n)
        assert sim_tokens(prompt, n, 97) == ref_mh.sim_tokens(prompt, n, 97)
    assert mh.SUPERVISOR_PID == ref_mh.SUPERVISOR_PID
    assert mh.HOST_FAULT_KINDS == ref_mh.HOST_FAULT_KINDS


def test_supervisor_validates_as_the_reference():
    for kw in (dict(nranks=1), dict(nranks=3, backend="gpu"),
               dict(nranks=3, suspect_timeout=0.0),
               dict(nranks=3, evict_factor=3.0),
               dict(nranks=3, heartbeat_interval=2.0)):
        with pytest.raises(ValueError):
            ref_mh.MultiHostSupervisor(**kw)
        with pytest.raises(ValueError):
            MultiHostSupervisor(**kw)
    with pytest.raises(ValueError, match="width"):
        MultiHostSupervisor(3, backend="replica", width="half")
    with pytest.raises(NotImplementedError, match="item 11"):
        MultiHostSupervisor(3, jax_coordinator="localhost:1234")
    for sup in (ref_mh.MultiHostSupervisor(3), MultiHostSupervisor(3)):
        with pytest.raises(ValueError, match="host faults"):
            sup.serve(mk_requests(2), faults=FaultSchedule(
                [FaultSpec(step=1, kind="kill", rank=0)]))
    sup = MultiHostSupervisor(3, backend="replica", device="cpu",
                              width="full", params_path="w.npz")
    spec = sup._worker_spec(1, 4242)
    assert (spec["device"], spec["width"]) == ("cpu", "full")
    assert spec["params_path"] == os.path.abspath("w.npz")
    want = ref_mh.MultiHostSupervisor(3)._worker_spec(1, 4242)
    assert spec["engine"] == dataclasses.asdict(EngineConfig(num_slots=2))
    assert {k: v for k, v in spec.items()
            if k not in ("device", "width", "params_path", "engine")} == {
        k: v for k, v in want.items()
        if k not in ("jax_coordinator", "engine")} | {"backend": "replica"}


@pytest.mark.parametrize("hold_close", [False, True])
@pytest.mark.parametrize("rem", [0, 1, 7])
def test_agree_round_decides_as_the_reference(rem, hold_close):
    for agreed in range(3):
        for my_epoch in range(3):
            mine = mh.agree_round(rem, agreed, my_epoch, hold_close=hold_close)
            ref = ref_mh.agree_round(rem, agreed, my_epoch, hold_close=hold_close)
            assert (mine.action, mine.epoch) == (ref.action, ref.epoch), (
                rem, agreed, my_epoch, hold_close)


def test_default_worker_cmd_is_the_port_module():
    cmd = mh._default_worker_cmd()
    assert cmd[-2:] == ["-m", "repro_torch.serve.multihost"]
    assert not any("worker.py" in c for c in cmd)


# ------------------------------------------------------ sim-backend processes
def test_clean_run_is_bit_exact_and_stable():
    reqs = mk_requests()
    res = sim_supervisor(trace=True).serve(reqs)
    assert_bit_exact(res, reqs)
    assert res.evicted == () and res.suspected == () and res.rerouted == ()
    assert res.epoch == 0
    assert res.words == {0: 0, 1: 0, 2: 0}
    assert res.launches == {}                     # the sim backend has none
    assert not validate(res.trace())


def test_sigkill_detect_map_repair_zero_drop():
    reqs = mk_staggered()
    res = sim_supervisor(trace=True).serve(reqs, faults=FaultSchedule(
        [FaultSpec(step=3, kind="host_kill", rank=2)]))
    assert_bit_exact(res, reqs)
    assert res.evicted == (2,)
    assert res.rerouted, "nothing re-routed off the dead worker"
    assert res.epoch >= 1
    det = res.detection[2]
    assert det["suspect_ts"] > det["kill_ts"]
    assert det["evict_ts"] - det["kill_ts"] <= 2 * SUSPECT_TIMEOUT
    in_window = [rid for (ts, rank, rid) in res.retires
                 if det["kill_ts"] < ts < det["evict_ts"] and rank != 2]
    assert in_window, "survivors blocked on the dead peer"
    trace = res.trace()
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"host_kill", "host_suspect", "host_evict", "replica_kill",
            "ulfm_shrink", "reroute", "epoch", "rank_failed"} <= names
    assert not validate(trace)
    latched = [e for e in trace["traceEvents"] if e.get("name") == "rank_failed"]
    assert latched and all(e["pid"] != 2 for e in latched)
    # the mapped group word: the survivors' bye carries RANK_FAILED, the
    # killed worker sent none
    assert sorted(res.words) == [0, 1]
    assert all(w & int(ErrorCode.RANK_FAILED) for w in res.words.values())


def test_sigkill_with_wal_reroutes_durably(tmp_path):
    wal = str(tmp_path / "multihost.wal")
    reqs = mk_staggered()
    res = sim_supervisor(ledger_path=wal).serve(reqs, faults=FaultSchedule(
        [FaultSpec(step=3, kind="host_kill", rank=1)]))
    assert sorted(res.responses) == [r.id for r in reqs]
    assert res.evicted == (1,)
    assert res.rerouted
    rep = replay_ledger(wal)
    assert sorted(rep.responses) == [r.id for r in reqs]
    assert rep.outstanding() == []
    assert rep.epoch >= 1
    assert 1 not in rep.members
    for rid in res.rerouted:
        assert rep.routes[rid] != 1


def test_sigstop_within_timeout_is_never_evicted():
    reqs = mk_requests()
    res = sim_supervisor(trace=True).serve(reqs, faults=FaultSchedule(
        [FaultSpec(step=2, kind="host_stop", rank=1,
                   magnitude=0.5 * SUSPECT_TIMEOUT)]))
    assert_bit_exact(res, reqs)
    assert res.stopped == (1,)
    assert res.evicted == ()
    assert 1 in res.suspected and 1 in res.resumed
    assert res.epoch == 0
    trace = res.trace()
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"host_stop", "host_resume", "host_suspect",
            "host_suspect_clear"} <= names
    assert "host_evict" not in names
    assert not validate(trace)


def test_stop_then_kill_interleaving():
    reqs = mk_requests()
    res = sim_supervisor(trace=True).serve(reqs, faults=FaultSchedule([
        FaultSpec(step=1, kind="host_stop", rank=0,
                  magnitude=0.4 * SUSPECT_TIMEOUT),
        FaultSpec(step=4, kind="host_kill", rank=2),
    ]))
    assert_bit_exact(res, reqs)
    assert res.evicted == (2,)
    assert res.stopped == (0,)
    assert not validate(res.trace())


LATE_HELLO = 3.0


def test_kill_waits_for_its_targets_hello():
    """A kill due before its target said ``hello`` fires at that hello, and
    the detector, which leases the worker from then, evicts it in time: the
    target's start is held back ``LATE_HELLO`` s by a stand-in worker
    command that then runs the real worker."""
    late = [sys.executable, "-u", "-c",
            "import json, sys, time\n"
            "spec = json.loads(sys.argv[sys.argv.index('--spec') + 1])\n"
            f"time.sleep({LATE_HELLO} if spec['rank'] == 1 else 0)\n"
            "from repro_torch.serve.multihost import worker_main\n"
            "raise SystemExit(worker_main())"]
    reqs = mk_requests()
    res = sim_supervisor(trace=True, worker_cmd=late).serve(
        reqs, faults=FaultSchedule([FaultSpec(step=0, kind="host_kill", rank=1)]))
    assert_bit_exact(res, reqs)
    assert res.ready_s[1] >= LATE_HELLO        # it said hello, then died
    assert res.evicted == (1,)
    assert res.rerouted
    det = res.detection[1]
    assert det["suspect_ts"] > det["kill_ts"]
    assert det["evict_ts"] - det["kill_ts"] <= 2 * SUSPECT_TIMEOUT
    assert sorted(res.words) == [0, 2]
    assert not validate(res.trace())


# ---------------------------------------------------- replica-backend processes
def test_replica_backend_bit_exact_across_process_kill(tmp_path, monkeypatch):
    """Three port worker processes serve the qwen3 smoke model with the JAX
    init's weights; worker 1 is SIGKILL'd after the second retirement. The
    streams equal an in-process port Replica's bit for bit, and the JAX
    Replica's up to near-ties of its logits."""
    arch = "qwen3-1.7b"
    engine = dict(num_slots=2, max_len=32)
    params = jax.device_get(build_model(jax_smoke_config(arch)).init(
        jax.random.PRNGKey(0)))
    path = str(tmp_path / "params.npz")
    save_tree_npz(path, params)
    reqs = lambda cls: [cls(id=i, prompt=tuple(5 + i + j for j in range(8)),  # noqa: E731
                            max_new_tokens=8) for i in range(8)]

    model = params_from_jax(params, smoke_config(arch), device="cpu")
    rep = Replica(smoke_config(arch), model, config=EngineConfig(**engine))
    for r in reqs(Request):
        assert rep.submit(r) is None
    port_ref = {r.id: tuple(r.tokens) for r in rep.run()}
    jrep = JaxReplica(jax_smoke_config(arch), params=params,
                      config=JaxEngineConfig(**engine))
    for r in reqs(JaxRequest):
        assert jrep.submit(r) is None
    jax_ref = {r.id: tuple(r.tokens) for r in jrep.run()}

    monkeypatch.setenv("OMP_NUM_THREADS", "1")    # three workers, one core each
    sup = MultiHostSupervisor(3, backend="replica", arch=arch,
                              config=EngineConfig(**engine), device="cpu",
                              params_path=path, suspect_timeout=SUSPECT_TIMEOUT,
                              timeout=TIMEOUT, trace=True)
    res = sup.serve(reqs(Request), faults=FaultSchedule(
        [FaultSpec(step=2, kind="host_kill", rank=1)]))
    assert sorted(res.responses) == list(range(8))
    assert all(r.ok for r in res.responses.values())
    assert res.evicted == (1,)
    assert res.rerouted
    det = res.detection[1]
    assert det["evict_ts"] - det["kill_ts"] <= 2 * SUSPECT_TIMEOUT
    assert not validate(res.trace())
    assert sorted(res.launches) == [0, 2]         # the plain versions: no launch
    got = {i: tuple(r.tokens) for i, r in res.responses.items()}
    assert got == port_ref
    jmodel = build_model(jax_smoke_config(arch))
    for i, r in enumerate(reqs(JaxRequest)):
        a, b = jax_ref[i], got[i]
        if a == b:
            continue
        k = next(j for j in range(min(len(a), len(b))) if a[j] != b[j])
        logits, _ = jmodel.forward(
            params, jax.numpy.asarray([list(r.prompt) + list(a[:k])]), impl="ref")
        top2 = np.sort(np.asarray(logits[0, -1]))[-2:]
        assert top2[1] - top2[0] < LOGIT_TOL, (i, k, a, b)
