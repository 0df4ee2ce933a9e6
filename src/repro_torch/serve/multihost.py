"""Multi-host fault domain: real-process workers under a heartbeat supervisor.

The port of ``repro/serve/multihost.py``. Everything before this module
*simulated* node loss: a "killed rank" was a thread told to unwind. Here
each host is a **real OS process** — a localhost subprocess worker owning one
replica — coordinated by a supervisor over a length-prefixed socket
protocol. A SIGKILL'd worker is a genuinely lost process: no flag, no
in-band error word, just silence. The paper's hard-fault story must
therefore run across a real process boundary, in three acts:

* **Detect** — the supervisor runs a heartbeat/lease failure detector
  (:class:`PhiAccrualDetector`): workers beat every ``heartbeat_interval``;
  the detector keeps per-host inter-arrival statistics and suspects a host
  when the phi-accrual score of its silence crosses the adaptive threshold
  (or the hard ``suspect_timeout`` bound). A suspect that beats again is
  cleared — a SIGSTOP'd (slow-but-alive) host resumed within
  ``suspect_timeout`` is never evicted. A suspect silent past
  ``evict_factor × suspect_timeout`` is evicted; with ``evict_factor ≤ 2``
  the detection-to-evict latency is bounded by ``2 × suspect_timeout``.
* **Map** — eviction latches
  :class:`~repro_torch.core.errors.ErrorCode.RANK_FAILED` into the surviving
  group: every survivor learns the death through the next agreement reply
  and ORs the bit into its local group error word, exactly as the in-band
  probes latch soft faults.
* **Repair** — the supervisor owns the durable
  :class:`~repro_torch.serve.ledger.GroupLedger` (+ write-ahead log) and
  drives the same ULFM epoch machinery the thread-rank group uses:
  ``ledger.on_death`` proposes the shrunken epoch and deterministically
  re-routes the dead host's unanswered requests (``id % n_survivors``); the
  ``all_reduce([remaining, epoch], emax)`` agreement is re-run over the
  socket transport in star topology — each worker's contribution is folded
  (elementwise max) with the supervisor's ledger view and broadcast back —
  and survivors keep decoding throughout detection: they only ever wait on
  the supervisor, never on a peer, so a dead host can not block anybody.

Protocol (4-byte big-endian length + JSON, one frame per message):

========== =============================================================
worker →   ``hello`` (post-warmup readiness), ``hb`` (heartbeat),
           ``exchange {round, remaining, epoch}`` (agreement contribution),
           ``retire {resp}`` (terminal response), ``trace {events}``,
           ``bye {word, launches}`` (``launches``: the ``replica``
           worker's kernel launch counts, a diagnostic key the supervisor
           only stores — the port's one addition to the frames)
supervisor ``work {requests, rerouted}`` (assignment / re-route),
→          ``reduce {round, rem, epoch, members, evicted}`` (agreement
           result), ``retire_ack {id}`` (sent only after the response is
           fsync'd into the WAL — the durability handshake), ``stop``
========== =============================================================

The worker half (:func:`worker_main`) lives in this module too, and the
module is its entry point (``python -m repro_torch.serve.multihost --spec
JSON``): workers are fresh interpreters started by ``subprocess.Popen``,
never forked from a process that holds a CUDA context. Workers run either
the real :class:`~repro_torch.serve.replica.Replica` engine
(``backend="replica"`` — every worker builds the same weights, so
re-routed requests recompute bit-exact token streams) or a deterministic
arithmetic simulator (``backend="sim"`` — :func:`sim_tokens`) for
protocol/detector tests and fuzz lanes that don't need a model.

The port's additions to :class:`MultiHostSupervisor`, all carried in the
worker spec to the ``replica`` backend: ``device`` (cuda unless ``"cpu"``),
because the replica runs on the card; ``width`` (``"smoke"``, the
reference's ``smoke_config(arch)``, or ``"full"``, ``get_config(arch)``),
because the card serves the full-width model; and ``params_path`` (an
``.npz`` of the JAX init's numpy leaves, loaded through
:func:`~repro_torch.weights.params_from_jax`; without one, the port's
seeded init ``Model(cfg, seed=seed)``), so that CPU tests carry the
reference's weights into the workers without importing JAX there; the CPU
test that holds worker streams to the JAX ``Replica`` is its only caller,
and every card run builds from the seed. A worker
that cannot build its backend exits non-zero before its ``hello``; it never
falls back to the CPU or to ``sim``. :class:`MultiHostResult` keeps each
worker's ``bye`` word and launch counts (``words``, ``launches``) and its
seconds from spawn to ``hello`` (``ready_s``). A host fault whose target has
not said ``hello`` yet waits for it: the reference's supervisor signals it
at once, before its lease starts, and the detector, which registers a host
at its ``hello``, never evicts a worker killed then (its serve times out).
The reference's ``jax_coordinator`` (a cross-host ``jax.distributed`` runtime)
raises ``NotImplementedError``: a multi-node runtime waits for ROADMAP item
11.

Trace events (merged across processes — ``time.monotonic`` is
``CLOCK_MONOTONIC``, one clock domain per machine): ``host_suspect`` /
``host_suspect_clear`` / ``host_evict`` / ``host_kill`` / ``host_stop`` /
``host_resume`` instants and one ``heartbeat`` span per host on the
supervisor lane (pid ``SUPERVISOR_PID``), plus the usual ``group`` events
(``replica_kill``, ``ulfm_shrink``, ``reroute``, ``epoch``) so the
post-mortem rules — every evict preceded by a suspect and followed by an
epoch that excludes the dead rank — check the whole causal chain.
"""
from __future__ import annotations

import json
import math
import os
import queue
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from ..core.errors import ErrorCode
from ..core.faults import FaultSchedule
from ..obs.trace import NULL_TRACER, Tracer
from .config import EngineConfig
from .group import agree_round
from .ledger import (
    GroupLedger,
    WriteAheadLog,
    request_from,
    request_record,
    response_from,
    response_record,
)
from .queue import OK, Request, Response

#: trace pid of the supervisor's lane (workers use their rank as pid).
SUPERVISOR_PID = 1 << 10

#: host fault kinds the supervisor executes on worker processes.
HOST_FAULT_KINDS = frozenset({"host_kill", "host_stop"})

_SIM_VOCAB = 512


# ------------------------------------------------------------------- framing
def send_msg(sock: socket.socket, obj: dict,
             lock: Optional[threading.Lock] = None) -> None:
    """One length-prefixed JSON frame (4-byte big-endian length + body).
    ``lock`` serialises concurrent senders (worker main + heartbeat thread)
    so frames never interleave."""
    data = json.dumps(obj, separators=(",", ":")).encode()
    frame = struct.pack(">I", len(data)) + data
    if lock is not None:
        with lock:
            sock.sendall(frame)
    else:
        sock.sendall(frame)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def recv_msg(sock: socket.socket) -> Optional[dict]:
    """Read one frame; None on a clean/forced EOF (the peer is gone)."""
    hdr = _recv_exact(sock, 4)
    if hdr is None:
        return None
    (n,) = struct.unpack(">I", hdr)
    body = _recv_exact(sock, n)
    if body is None:
        return None
    return json.loads(body.decode())


# ---------------------------------------------------------------- sim tokens
def sim_tokens(prompt: Sequence[int], max_new: int,
               vocab: int = _SIM_VOCAB) -> tuple[int, ...]:
    """The sim backend's deterministic token rule — a pure function of the
    prompt, shared by workers and the supervisor-side bit-exactness oracle
    (the sim analogue of greedy decode's determinism)."""
    base = sum(int(t) for t in prompt) % vocab
    return tuple((base * 31 + 7 * j) % vocab for j in range(int(max_new)))


# ------------------------------------------------------------------ detector
class PhiAccrualDetector:
    """Phi-accrual heartbeat failure detector with a suspect → evict ladder.

    Per-host inter-arrival statistics feed a phi score of the current
    silence (``-log10`` of the one-sided normal tail probability); a host is
    **suspected** when phi crosses ``phi_threshold`` (with a two-interval
    grace so one late beat is never suspicious) *or* when silence reaches the
    hard ``suspect_timeout`` bound — the adaptive path fires earlier for
    hosts with historically tight, regular beats. A beat from a suspect
    clears the suspicion (:meth:`heartbeat` returns True): a SIGSTOP'd
    host resumed within ``suspect_timeout`` is slow-but-alive, not dead.
    A suspect whose silence reaches ``evict_factor × suspect_timeout`` is
    **evictable**; ``1 < evict_factor ≤ 2`` bounds detection-to-evict
    latency by ``2 × suspect_timeout`` while leaving a
    ``(evict_factor − 1) × suspect_timeout`` margin that makes the
    SIGSTOP-no-evict guarantee hold.
    """

    def __init__(self, *, suspect_timeout: float = 1.0,
                 heartbeat_interval: float = 0.05,
                 evict_factor: float = 1.8, phi_threshold: float = 8.0,
                 window: int = 64,
                 clock: Callable[[], float] = time.monotonic):
        if suspect_timeout <= 0:
            raise ValueError(f"suspect_timeout must be > 0, got "
                             f"{suspect_timeout}")
        if not 0 < heartbeat_interval < suspect_timeout:
            raise ValueError(
                f"heartbeat_interval must be in (0, suspect_timeout), got "
                f"{heartbeat_interval} vs {suspect_timeout}")
        if not 1.0 < evict_factor <= 2.0:
            raise ValueError(
                f"evict_factor must be in (1, 2] (≤2 bounds detection-to-"
                f"evict by 2×suspect_timeout; >1 is the SIGSTOP margin), "
                f"got {evict_factor}")
        if phi_threshold <= 0:
            raise ValueError(f"phi_threshold must be > 0, got {phi_threshold}")
        self.suspect_timeout = float(suspect_timeout)
        self.heartbeat_interval = float(heartbeat_interval)
        self.evict_after = float(evict_factor) * float(suspect_timeout)
        self.phi_threshold = float(phi_threshold)
        self.clock = clock
        self._window = int(window)
        self._last: dict[int, float] = {}
        self._intervals: dict[int, deque] = {}
        self._suspect_since: dict[int, float] = {}

    # ------------------------------------------------------------- lifecycle
    def register(self, rank: int, now: Optional[float] = None) -> None:
        now = self.clock() if now is None else now
        self._last[rank] = now
        self._intervals[rank] = deque(maxlen=self._window)

    def remove(self, rank: int) -> None:
        self._last.pop(rank, None)
        self._intervals.pop(rank, None)
        self._suspect_since.pop(rank, None)

    def ranks(self) -> list[int]:
        return sorted(self._last)

    # ------------------------------------------------------------------ beats
    def heartbeat(self, rank: int, now: Optional[float] = None) -> bool:
        """Record a beat; returns True when it cleared a standing suspicion
        (the slow-but-alive discrimination the SIGSTOP guard relies on)."""
        if rank not in self._last:
            return False
        now = self.clock() if now is None else now
        self._intervals[rank].append(max(now - self._last[rank], 0.0))
        self._last[rank] = now
        return self._suspect_since.pop(rank, None) is not None

    # ------------------------------------------------------------------ state
    def silence(self, rank: int, now: Optional[float] = None) -> float:
        now = self.clock() if now is None else now
        return now - self._last[rank]

    def _stats(self, rank: int) -> tuple[float, float]:
        xs = self._intervals.get(rank)
        if not xs:
            return self.heartbeat_interval, 0.1 * self.heartbeat_interval
        mean = sum(xs) / len(xs)
        var = sum((x - mean) ** 2 for x in xs) / len(xs)
        # floor the spread at 10% of the mean: perfectly regular beats must
        # not make a single scheduling hiccup look like a death
        return mean, max(math.sqrt(var), 0.1 * mean, 1e-6)

    def phi(self, rank: int, now: Optional[float] = None) -> float:
        """Phi-accrual score of the current silence: ``-log10`` of the
        one-sided normal tail probability of a gap this long, under the
        host's observed inter-arrival distribution."""
        silence = self.silence(rank, now)
        mean, std = self._stats(rank)
        y = (silence - mean) / std
        p = 0.5 * math.erfc(y / math.sqrt(2.0))
        return -math.log10(max(p, 1e-30))

    def is_suspect(self, rank: int) -> bool:
        return rank in self._suspect_since

    def suspect_since(self, rank: int) -> Optional[float]:
        return self._suspect_since.get(rank)

    # ------------------------------------------------------------------- poll
    def poll(self, now: Optional[float] = None) -> tuple[list[int], list[int]]:
        """One detector tick: ``(newly_suspect, evictable)`` transitions.
        Suspicion is entered at most once per silent stretch (a clearing
        beat re-arms it); eviction is the caller's decision to execute."""
        now = self.clock() if now is None else now
        newly: list[int] = []
        evictable: list[int] = []
        for rank in self._last:
            silence = now - self._last[rank]
            if rank not in self._suspect_since:
                mean, _ = self._stats(rank)
                # grace floor: queue jitter can compress *measured*
                # inter-arrivals well below the configured beat period, and
                # one missed beat must never look suspicious
                grace = max(2.0 * mean, 2.0 * self.heartbeat_interval)
                adaptive = (silence >= grace
                            and self.phi(rank, now) >= self.phi_threshold)
                if silence >= self.suspect_timeout or adaptive:
                    self._suspect_since[rank] = now
                    newly.append(rank)
            if rank in self._suspect_since and silence >= self.evict_after:
                evictable.append(rank)
        return newly, evictable


# -------------------------------------------------------------------- result
@dataclass
class MultiHostResult:
    """Outcome of one multi-host serve: terminal responses plus the fault
    domain's own story (detection timings, evictions, re-routes)."""

    responses: dict[int, Response]
    rerouted: tuple[int, ...] = ()
    evicted: tuple[int, ...] = ()
    suspected: tuple[int, ...] = ()     # ever entered suspicion
    resumed: tuple[int, ...] = ()       # suspicion cleared by a late beat
    stopped: tuple[int, ...] = ()       # SIGSTOP'd by a host_stop fault
    epoch: int = 0
    detection: dict[int, dict] = field(default_factory=dict)
    retires: tuple = ()                 # (ts, rank, id) — survivor liveness
    events: list = field(default_factory=list)   # merged trace events
    # per rank that said ``bye`` (a killed worker has no entry): its group
    # error word, and the replica worker's kernel launch counts
    words: dict[int, int] = field(default_factory=dict)
    launches: dict[int, dict] = field(default_factory=dict)
    ready_s: dict[int, float] = field(default_factory=dict)  # spawn → hello

    @property
    def ok(self) -> dict[int, Response]:
        return {i: r for i, r in self.responses.items() if r.ok}

    def trace(self) -> dict:
        evs = sorted(self.events,
                     key=lambda e: (e.get("ts", 0.0), e.get("pid", 0)))
        return {"traceEvents": evs, "displayTimeUnit": "ms"}


class _Conn:
    """One worker connection: socket + send lock + liveness flag."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.lock = threading.Lock()
        self.alive = True

    def send(self, obj: dict) -> None:
        if not self.alive:
            return
        try:
            send_msg(self.sock, obj, self.lock)
        except OSError:
            self.alive = False

    def close(self) -> None:
        self.alive = False
        try:
            self.sock.close()
        except OSError:
            pass


def _default_worker_cmd() -> list[str]:
    """The worker entry point: this module, in a fresh interpreter."""
    return [sys.executable, "-u", "-m", "repro_torch.serve.multihost"]


# ---------------------------------------------------------------- supervisor
class MultiHostSupervisor:
    """A fleet of worker *processes* under heartbeat supervision.

    The supervisor owns the request ledger (and its WAL when
    ``ledger_path`` is set), distributes work, folds each worker's
    ``[remaining, epoch]`` agreement contribution with its own ledger view
    (star-topology emax), runs the failure detector, executes scheduled host
    faults (``host_kill`` → SIGKILL, ``host_stop`` → SIGSTOP/SIGCONT), and
    repairs membership through the same epoch machinery the thread-rank
    :class:`~repro_torch.serve.group.ServeGroup` uses.
    """

    def __init__(self, nranks: int, *,
                 backend: str = "sim",
                 arch: str = "qwen3-1.7b",
                 config: Optional[EngineConfig] = None,
                 seed: int = 0,
                 suspect_timeout: float = 1.0,
                 heartbeat_interval: float = 0.05,
                 evict_factor: float = 1.8,
                 phi_threshold: float = 8.0,
                 ledger_path: Optional[str] = None,
                 trace: bool = False,
                 timeout: float = 120.0,
                 sim_tokens_per_step: int = 4,
                 sim_step_delay_s: float = 0.005,
                 worker_cmd: Optional[Sequence[str]] = None,
                 jax_coordinator: Optional[str] = None,
                 device=None,
                 width: str = "smoke",
                 params_path: Optional[str] = None):
        if jax_coordinator is not None:
            raise NotImplementedError(
                "a jax_coordinator (a cross-host runtime) is not ported: "
                "ROADMAP Queue 1, item 11")
        if width not in ("smoke", "full"):
            raise ValueError(f"unknown width {width!r} (known: smoke, full)")
        if nranks < 2:
            raise ValueError("a multi-host group needs >= 2 workers")
        if backend not in ("sim", "replica"):
            raise ValueError(f"unknown worker backend {backend!r} "
                             "(known: sim, replica)")
        self.nranks = int(nranks)
        self.backend = backend
        self.arch = arch
        self.config = config if config is not None else EngineConfig(
            num_slots=2)
        self.seed = int(seed)
        self.suspect_timeout = float(suspect_timeout)
        self.heartbeat_interval = float(heartbeat_interval)
        self.evict_factor = float(evict_factor)
        self.phi_threshold = float(phi_threshold)
        self.ledger_path = ledger_path
        self.trace = bool(trace)
        self.timeout = float(timeout)
        self.sim_tokens_per_step = int(sim_tokens_per_step)
        self.sim_step_delay_s = float(sim_step_delay_s)
        self.worker_cmd = (list(worker_cmd) if worker_cmd
                           else _default_worker_cmd())
        self.jax_coordinator = jax_coordinator
        self.device = None if device is None else str(device)
        self.width = width
        self.params_path = (None if params_path is None
                            else os.path.abspath(params_path))
        # validate the detector parameters now, not mid-serve
        PhiAccrualDetector(suspect_timeout=self.suspect_timeout,
                           heartbeat_interval=self.heartbeat_interval,
                           evict_factor=self.evict_factor,
                           phi_threshold=self.phi_threshold)

    # -------------------------------------------------------------- plumbing
    def _worker_spec(self, rank: int, port: int) -> dict:
        import dataclasses
        return {
            "rank": rank, "port": port, "nranks": self.nranks,
            "backend": self.backend, "arch": self.arch, "seed": self.seed,
            "heartbeat_interval": self.heartbeat_interval,
            "trace": self.trace, "io_timeout": self.timeout,
            "engine": dataclasses.asdict(self.config),
            "sim": {"tokens_per_step": self.sim_tokens_per_step,
                    "step_delay_s": self.sim_step_delay_s,
                    "vocab": _SIM_VOCAB},
            "device": self.device, "width": self.width,
            "params_path": self.params_path,
        }

    def _spawn(self, rank: int, port: int) -> subprocess.Popen:
        env = dict(os.environ)
        src = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = (src + os.pathsep + env["PYTHONPATH"]
                             if env.get("PYTHONPATH") else src)
        # ``-m`` runs this module after its package imported it: runpy's
        # warning about that says nothing about the worker
        quiet = "ignore::RuntimeWarning:runpy"
        env["PYTHONWARNINGS"] = (env["PYTHONWARNINGS"] + "," + quiet
                                 if env.get("PYTHONWARNINGS") else quiet)
        cmd = self.worker_cmd + [
            "--spec", json.dumps(self._worker_spec(rank, port))]
        return subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL)

    # ------------------------------------------------------------------ serve
    def serve(self, requests: Sequence[Request], *,
              faults: FaultSchedule | None = None) -> MultiHostResult:
        """Serve ``requests`` to completion across the worker processes.

        ``faults`` accepts host-level specs only: ``kind="host_kill"``
        SIGKILLs worker ``rank`` once ``step`` responses have been retired
        fleet-wide (so the kill lands mid-decode), ``kind="host_stop"``
        SIGSTOPs it for ``magnitude`` seconds then SIGCONTs. Device-word
        kinds belong to the engines, not the host domain, and are rejected.
        """
        requests = list(requests)
        faults = (faults or FaultSchedule()).resolve(range(self.nranks))
        pending_faults = []
        for spec in faults.specs:
            if spec.kind not in HOST_FAULT_KINDS:
                raise ValueError(
                    f"multihost supervisor only executes host faults "
                    f"{sorted(HOST_FAULT_KINDS)}, got kind={spec.kind!r} "
                    "(in-band words are the engines' injection surface)")
            pending_faults.append(spec)
        pending_faults.sort(key=lambda s: s.step)

        wal = WriteAheadLog(self.ledger_path) if self.ledger_path else None
        ledger = GroupLedger(requests, range(self.nranks), wal=wal)
        tracer = Tracer(pid=SUPERVISOR_PID) if self.trace else NULL_TRACER
        detector = PhiAccrualDetector(
            suspect_timeout=self.suspect_timeout,
            heartbeat_interval=self.heartbeat_interval,
            evict_factor=self.evict_factor,
            phi_threshold=self.phi_threshold)

        listener = socket.create_server(("127.0.0.1", 0))
        port = listener.getsockname()[1]
        listener.settimeout(0.2)
        inbox: queue.Queue = queue.Queue()
        stop_accept = threading.Event()
        conns: dict[int, _Conn] = {}

        def reader(sock: socket.socket) -> None:
            """Per-connection reader: the first frame must be ``hello`` (it
            names the rank); afterwards every frame lands in the inbox."""
            try:
                first = recv_msg(sock)
            except OSError:
                first = None
            if not first or first.get("type") != "hello":
                try:
                    sock.close()
                except OSError:
                    pass
                return
            rank = int(first["rank"])
            conns[rank] = _Conn(sock)
            inbox.put((rank, first))
            while True:
                try:
                    msg = recv_msg(sock)
                except OSError:
                    msg = None
                if msg is None:
                    inbox.put((rank, {"type": "_eof"}))
                    return
                inbox.put((rank, msg))

        def acceptor() -> None:
            while not stop_accept.is_set():
                try:
                    sock, _ = listener.accept()
                except socket.timeout:
                    continue
                except OSError:
                    return
                threading.Thread(target=reader, args=(sock,),
                                 daemon=True).start()

        threading.Thread(target=acceptor, daemon=True).start()

        spawned = time.monotonic()
        procs = {r: self._spawn(r, port) for r in range(self.nranks)}
        timers: list[threading.Timer] = []

        live = set(range(self.nranks))      # not yet evicted
        ready: set[int] = set()             # said hello
        done: set[int] = set()              # said bye
        evict_notices: dict[int, set] = {r: set() for r in range(self.nranks)}
        beats: dict[int, list] = {}         # rank -> [first, last, count]
        worker_events: list[dict] = []
        retires: list[tuple] = []
        words: dict[int, int] = {}
        launches: dict[int, dict] = {}
        ready_s: dict[int, float] = {}
        detection: dict[int, dict] = {}
        suspected: set[int] = set()
        resumed: set[int] = set()
        stopped: set[int] = set()
        retired_total = 0

        def note(rank: int) -> dict:
            return detection.setdefault(rank, {})

        def ship_rerouted(moved) -> None:
            for owner in sorted({new for _, _, new in moved}):
                if owner not in ready or owner not in live:
                    continue    # its hello-time take will scoop these up
                reqs = ledger.take(owner)
                if reqs:
                    conns[owner].send({
                        "type": "work", "rerouted": True,
                        "requests": [request_record(q) for q in reqs]})

        def evict(rank: int, now: float) -> None:
            live.discard(rank)
            silence = detector.silence(rank, now)
            phi = detector.phi(rank, now)
            detector.remove(rank)
            proc = procs.get(rank)
            if proc is not None and proc.poll() is None:
                try:                       # a stopped process can't die
                    proc.send_signal(signal.SIGCONT)
                except (OSError, ProcessLookupError):
                    pass
                proc.kill()
            if rank in conns:
                conns[rank].close()
            note(rank)["evict_ts"] = now
            if tracer.enabled:
                tracer.instant("host_evict", "host", ts=now, rank=rank,
                               silence_s=silence, phi=phi)
            moved = ledger.on_death({rank})
            survivors = sorted(ledger.members)
            if tracer.enabled:
                tracer.instant("ulfm_shrink", "group", ts=now, rank=rank,
                               survivors=survivors)
                tracer.instant("epoch", "group", ts=now, epoch=ledger.epoch,
                               members=survivors, reason="shrink")
                for rid, old, new in moved:
                    tracer.instant("reroute", "group", ts=now, request=rid,
                                   trace_id=ledger.requests[rid].trace_id,
                                   from_rank=old, to_rank=new)
            ship_rerouted(moved)
            for r in live:
                evict_notices[r].add(rank)

        def fire_faults(now: float) -> None:
            while pending_faults and retired_total >= pending_faults[0].step:
                rank = int(pending_faults[0].rank)
                if rank in live and rank not in ready:
                    break      # not up yet, no lease to miss: fires at its hello
                spec = pending_faults.pop(0)
                proc = procs.get(rank)
                if rank not in live or rank in done or proc is None \
                        or proc.poll() is not None:
                    continue               # target already gone: a no-op
                if spec.kind == "host_kill":
                    note(rank)["kill_ts"] = now
                    if tracer.enabled:
                        tracer.instant("host_kill", "host", ts=now, rank=rank,
                                       retired=retired_total)
                        tracer.instant("replica_kill", "group", ts=now,
                                       rank=rank)
                    proc.kill()            # SIGKILL: a genuinely lost process
                else:                      # host_stop: slow-but-alive
                    stopped.add(rank)
                    note(rank)["stop_ts"] = now
                    if tracer.enabled:
                        tracer.instant("host_stop", "host", ts=now, rank=rank,
                                       duration_s=spec.magnitude)
                    try:
                        proc.send_signal(signal.SIGSTOP)
                    except (OSError, ProcessLookupError):
                        continue

                    def resume(r=rank, p=proc):
                        try:
                            p.send_signal(signal.SIGCONT)
                        except (OSError, ProcessLookupError):
                            return
                        if tracer.enabled:
                            tracer.instant("host_resume", "host", rank=r)

                    t = threading.Timer(float(spec.magnitude), resume)
                    t.daemon = True
                    t.start()
                    timers.append(t)

        def handle(rank: int, msg: dict, now: float) -> None:
            nonlocal retired_total
            kind = msg.get("type")
            if kind == "hello":
                ready.add(rank)
                ready_s[rank] = now - spawned
                detector.register(rank, now)
                reqs = ledger.take(rank)
                conns[rank].send({
                    "type": "work", "rerouted": False,
                    "requests": [request_record(q) for q in reqs]})
                fire_faults(now)       # step-0 specs fire once targets exist
            elif kind == "hb":
                if rank not in live:
                    return
                b = beats.setdefault(rank, [now, now, 0])
                b[1] = now
                b[2] += 1
                if detector.heartbeat(rank, now):
                    resumed.add(rank)
                    if tracer.enabled:
                        tracer.instant("host_suspect_clear", "host", ts=now,
                                       rank=rank)
            elif kind == "exchange":
                if rank not in live:
                    return
                # star-topology emax: fold the worker's [remaining, epoch]
                # contribution with the supervisor's authoritative ledger view
                rem = max(ledger.remaining(), int(msg.get("remaining", 0)))
                agreed = max(ledger.epoch, int(msg.get("epoch", 0)))
                notices = sorted(evict_notices[rank])
                evict_notices[rank].clear()
                conns[rank].send({
                    "type": "reduce", "round": msg.get("round"),
                    "rem": rem, "epoch": agreed,
                    "members": sorted(ledger.members), "evicted": notices})
            elif kind == "retire":
                resp = response_from(msg["resp"])
                if ledger.complete(resp):
                    retired_total += 1
                    retires.append((now, rank, resp.id))
                    fire_faults(now)
                if rank in live:
                    conns[rank].send({"type": "retire_ack", "id": resp.id})
            elif kind == "trace":
                worker_events.extend(msg.get("events", ()))
            elif kind == "bye":
                done.add(rank)
                detector.remove(rank)
                words[rank] = int(msg.get("word", 0))
                if "launches" in msg:
                    launches[rank] = dict(msg["launches"])
            elif kind == "_eof":
                # the socket died (SIGKILL closes it instantly on localhost);
                # death is only ever *declared* by the heartbeat detector —
                # real networks don't deliver EOFs — so just stop sending
                if rank in conns:
                    conns[rank].alive = False

        deadline = time.monotonic() + self.timeout
        failure: Optional[str] = None
        try:
            while True:
                now = time.monotonic()
                if now > deadline:
                    failure = (f"multihost serve timed out after "
                               f"{self.timeout}s: remaining="
                               f"{ledger.remaining()} live={sorted(live)} "
                               f"ready={sorted(ready)} done={sorted(done)}")
                    break
                if ready and (live & ready) <= done \
                        and ledger.remaining() == 0:
                    break
                if live <= done and ledger.remaining() > 0 and ready:
                    failure = (f"all workers finished but "
                               f"{ledger.remaining()} requests unanswered")
                    break
                try:
                    rank, msg = inbox.get(timeout=0.01)
                except queue.Empty:
                    rank, msg = -1, None
                now = time.monotonic()
                if msg is not None:
                    handle(rank, msg, now)
                newly, evictable = detector.poll(now)
                for r in newly:
                    if r in live:
                        suspected.add(r)
                        note(r)["suspect_ts"] = now
                        if tracer.enabled:
                            tracer.instant(
                                "host_suspect", "host", ts=now, rank=r,
                                silence_s=detector.silence(r, now),
                                phi=detector.phi(r, now))
                for r in evictable:
                    if r in live:
                        evict(r, now)
        finally:
            ledger.close()
            stop_accept.set()
            for t in timers:
                t.cancel()
            # drain stragglers (late byes / trace batches) briefly, then stop
            drain_until = time.monotonic() + 2.0
            while time.monotonic() < drain_until:
                try:
                    rank, msg = inbox.get(timeout=0.05)
                except queue.Empty:
                    if all(p.poll() is not None for p in procs.values()):
                        break
                    continue
                if msg.get("type") in ("trace", "bye", "retire"):
                    handle(rank, msg, time.monotonic())
            for r, c in conns.items():
                c.send({"type": "stop"})
            for r, p in procs.items():
                if p.poll() is None:
                    try:
                        p.send_signal(signal.SIGCONT)
                    except (OSError, ProcessLookupError):
                        pass
                try:
                    p.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait(timeout=5.0)
            for c in conns.values():
                c.close()
            try:
                listener.close()
            except OSError:
                pass
            if wal is not None:
                wal.close()

        if tracer.enabled:
            for r, (first, last, count) in sorted(beats.items()):
                mean = (last - first) / max(count - 1, 1)
                tracer.span("heartbeat", "host", first, last, rank=r,
                            beats=count, mean_interval_s=mean)

        if failure is not None:
            raise RuntimeError(failure)

        events = list(worker_events)
        events.extend(tracer.events())
        return MultiHostResult(
            responses=dict(ledger.responses),
            rerouted=tuple(ledger.rerouted),
            evicted=tuple(r for r in range(self.nranks) if r not in live),
            suspected=tuple(sorted(suspected)),
            resumed=tuple(sorted(resumed)),
            stopped=tuple(sorted(stopped)),
            epoch=ledger.epoch, detection=detection,
            retires=tuple(retires), events=events, words=words,
            launches=launches, ready_s=ready_s)


# -------------------------------------------------------------------- worker
class _SimBackend:
    """Deterministic arithmetic decode (no model, no jit): emits
    ``tokens_per_step`` tokens of :func:`sim_tokens` per step. Used by
    protocol/detector tests and the fuzzer's host-fault lanes."""

    def __init__(self, rank: int, *, tokens_per_step: int = 4,
                 step_delay_s: float = 0.0, vocab: int = _SIM_VOCAB,
                 tracer: Tracer = NULL_TRACER,
                 clock: Callable[[], float] = time.monotonic):
        self.rank = rank
        self.tokens_per_step = max(int(tokens_per_step), 1)
        self.step_delay_s = float(step_delay_s)
        self.vocab = int(vocab)
        self.tracer = tracer
        self.clock = clock
        self._inflight: dict[int, dict] = {}

    def submit(self, req: Request) -> Optional[Response]:
        now = self.clock()
        req.arrival_t = now
        if self.tracer.enabled and req.trace_id is None:
            req.trace_id = self.tracer.start_request(req, now)
        self._inflight[req.id] = {
            "req": req,
            "tokens": sim_tokens(req.prompt, req.max_new_tokens, self.vocab),
            "emitted": 0, "ttft": None}
        return None

    def step(self) -> list[Response]:
        if self.step_delay_s:
            time.sleep(self.step_delay_s)
        out: list[Response] = []
        for rid in list(self._inflight):
            st = self._inflight[rid]
            if st["emitted"] == 0 and st["tokens"]:
                st["ttft"] = self.clock() - st["req"].arrival_t
            st["emitted"] = min(st["emitted"] + self.tokens_per_step,
                                len(st["tokens"]))
            if st["emitted"] >= len(st["tokens"]):
                now = self.clock()
                req = st["req"]
                resp = Response(
                    id=rid, status=OK, tokens=tuple(st["tokens"]),
                    latency_s=now - req.arrival_t, ttft_s=st["ttft"],
                    replica=self.rank, trace_id=req.trace_id)
                if self.tracer.enabled:
                    self.tracer.end_request(resp, now)
                out.append(resp)
                del self._inflight[rid]
        return out

    def load(self) -> int:
        return len(self._inflight)


class _ReplicaBackend:
    """The real engine: one :class:`~repro_torch.serve.replica.Replica` per
    worker process, on ``spec["device"]``, with the weights every worker
    builds alike (the ``.npz`` at ``params_path``, else the seeded init), so
    token streams are bit-exact across process boundaries. The kernel
    launch counts start from 0 after the warm-up."""

    def __init__(self, spec: dict, tracer: Tracer):
        from ..configs import get_config, smoke_config
        from ..kernels import reset_launch_counts
        from ..models import Model
        from ..weights import load_tree_npz, params_from_jax
        from .replica import Replica
        arch = spec["arch"]
        cfg = get_config(arch) if spec.get("width") == "full" else smoke_config(arch)
        device = spec.get("device")
        if spec.get("params_path"):
            model = params_from_jax(load_tree_npz(spec["params_path"]), cfg,
                                    device=device)
        else:
            model = Model(cfg, seed=int(spec.get("seed", 0)), device=device)
        engine = dict(spec.get("engine") or {})
        engine.pop("trace", None)          # workers trace via the tracer obj
        engine.pop("trace_sample", None)
        self.replica = Replica(cfg, model, config=EngineConfig(**engine),
                               rank=int(spec["rank"]), tracer=tracer)
        self.replica.warmup()
        reset_launch_counts()

    def submit(self, req: Request) -> Optional[Response]:
        return self.replica.submit(req)

    def step(self) -> list[Response]:
        return self.replica.step()

    def load(self) -> int:
        return self.replica.load() + len(self.replica.queue)


class _Stop(Exception):
    pass


def worker_main(argv: Optional[Sequence[str]] = None) -> int:
    """One worker process: connect, warm up, say hello, heartbeat, serve.

    The ``hello`` is sent only *after* the backend finished warming up (the
    kernel library's load and the first steps included), so those pauses can never read as missed
    heartbeats — the lease only starts once the worker is actually able to
    honour it.
    """
    import argparse
    parser = argparse.ArgumentParser(prog="worker")
    parser.add_argument("--worker", action="store_true",
                        help="compatibility no-op (python -m launch path)")
    parser.add_argument("--spec", required=True,
                        help="JSON worker spec from the supervisor")
    args = parser.parse_args(argv)
    spec = json.loads(args.spec)
    rank = int(spec["rank"])
    io_timeout = float(spec.get("io_timeout", 120.0))

    tracer = Tracer(pid=rank) if spec.get("trace") else NULL_TRACER
    if spec.get("backend") == "replica":
        backend = _ReplicaBackend(spec, tracer)
    else:
        sim = spec.get("sim") or {}
        backend = _SimBackend(
            rank, tokens_per_step=int(sim.get("tokens_per_step", 4)),
            step_delay_s=float(sim.get("step_delay_s", 0.0)),
            vocab=int(sim.get("vocab", _SIM_VOCAB)), tracer=tracer)

    sock = socket.create_connection(("127.0.0.1", int(spec["port"])),
                                    timeout=io_timeout)
    send_lock = threading.Lock()
    send_msg(sock, {"type": "hello", "rank": rank}, send_lock)

    stop_hb = threading.Event()
    hb_interval = float(spec.get("heartbeat_interval", 0.05))

    def hb_loop() -> None:
        while not stop_hb.wait(hb_interval):
            try:
                send_msg(sock, {"type": "hb", "rank": rank}, send_lock)
            except OSError:
                return

    threading.Thread(target=hb_loop, daemon=True).start()

    inq: queue.Queue = queue.Queue()

    def read_loop() -> None:
        while True:
            try:
                msg = recv_msg(sock)
            except OSError:
                msg = None
            inq.put(msg)
            if msg is None:
                return

    threading.Thread(target=read_loop, daemon=True).start()

    def retire(resp: Response) -> None:
        send_msg(sock, {"type": "retire", "rank": rank,
                        "resp": response_record(resp)}, send_lock)

    def dispatch(msg: Optional[dict]) -> Optional[dict]:
        """Apply a pushed message; returns it when it is a ``reduce`` the
        round loop is waiting for."""
        if msg is None:
            raise _Stop("supervisor connection lost")
        kind = msg.get("type")
        if kind == "work":
            for rec in msg.get("requests", ()):
                rej = backend.submit(request_from(rec))
                if rej is not None:
                    retire(rej)
            return None
        if kind == "stop":
            raise _Stop("stop requested")
        if kind == "reduce":
            return msg
        return None          # retire_ack and anything future-compatible

    my_epoch = 0
    group_word = 0
    round_i = 0
    rc = 0
    try:
        while True:
            try:
                while True:
                    dispatch(inq.get_nowait())
            except queue.Empty:
                pass
            for resp in backend.step():
                retire(resp)
            send_msg(sock, {"type": "exchange", "rank": rank,
                            "round": round_i, "remaining": backend.load(),
                            "epoch": my_epoch}, send_lock)
            reduce_msg = None
            wait_until = time.monotonic() + io_timeout
            while reduce_msg is None:
                left = wait_until - time.monotonic()
                if left <= 0:
                    raise RuntimeError(
                        f"worker {rank}: no reduce for round {round_i} "
                        f"within {io_timeout}s")
                try:
                    reduce_msg = dispatch(inq.get(timeout=min(left, 1.0)))
                except queue.Empty:
                    continue
            for dead in reduce_msg.get("evicted", ()):
                # the supervisor declared a peer dead: latch RANK_FAILED into
                # this worker's group error word — the remote fault mapped to
                # the same local code an in-band probe would latch
                group_word |= int(ErrorCode.RANK_FAILED)
                if tracer.enabled:
                    tracer.instant("rank_failed", "group", rank=rank,
                                   dead=int(dead),
                                   code=int(ErrorCode.RANK_FAILED))
            decision = agree_round(int(reduce_msg["rem"]),
                                   int(reduce_msg["epoch"]), my_epoch)
            if decision.action == "reconfigure":
                my_epoch = decision.epoch
            elif decision.action == "close":
                break
            elif backend.load() == 0:
                time.sleep(0.002)      # idle but the fleet isn't done yet
            round_i += 1
    except _Stop:
        pass
    except (OSError, RuntimeError):
        rc = 1
    finally:
        stop_hb.set()
        try:
            if tracer.enabled:
                send_msg(sock, {"type": "trace", "rank": rank,
                                "events": tracer.events()}, send_lock)
            bye = {"type": "bye", "rank": rank, "word": group_word}
            if isinstance(backend, _ReplicaBackend):
                from ..kernels import launch_counts
                bye["launches"] = launch_counts()
            send_msg(sock, bye, send_lock)
        except OSError:
            rc = 1
        try:
            sock.close()
        except OSError:
            pass
    return rc


if __name__ == "__main__":
    raise SystemExit(worker_main())
