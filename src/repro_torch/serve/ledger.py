# Copy of repro/serve/ledger.py.
"""Durable request ledger: write-ahead log + elastic group membership.

Two layers, both serving the same contract — **an accepted request is never
dropped**, now extended across full-fleet crashes:

* :class:`WriteAheadLog` — an append-only, checksummed JSONL log. Every
  record is CRC32-stamped and ``fsync``'d before the append returns, so a
  request is only *acknowledged* once it would survive a power cut. On
  restart :func:`replay` reconstructs the outstanding set; a torn final
  record (the crash landed mid-``write``) is discarded and counted, while a
  corrupt record anywhere else raises :class:`LedgerCorrupt` — silent
  damage in the middle of an intact log is data loss, not a crash artefact.
  A compaction pass (snapshot record + atomic rename) bounds log growth
  from long-running groups and repeated re-routes.

* :class:`GroupLedger` — the shared (thread-safe) request ledger of a
  :class:`~repro_torch.serve.group.ServeGroup`, grown from the PR-1 in-memory
  router log into the **single membership authority**: fault-driven shrink,
  replica join/rejoin and autoscale grow/shrink all propose a new *epoch*
  (member list version) here, and every rank reconfigures by entering the
  highest epoch it observes — exactly one reconfiguration code path. Queued
  work is deterministically re-balanced (``id % n_members`` over the sorted
  member list, the PR-1 re-route rule) whenever the membership widens or
  shrinks, and every submit / route / retirement is mirrored into the WAL
  when one is attached.

Record kinds (all JSON objects with ``seq`` + ``crc`` envelope fields):

``submit``   request payload (prompt, budget, deadline) — written before the
             request is visible to any replica;
``stamp``    arrival time + trace id, written once when a replica first
             accepts the request (so replay preserves latency accounting and
             the causal trace chain across a restart);
``route``    request → rank assignment (initial, re-route, re-balance);
``retire``   full terminal :class:`~repro_torch.serve.queue.Response` payload —
             replay returns answered requests bit-exactly without re-serving;
``epoch``    membership change (epoch number, member list, reason);
``snapshot`` compaction: the live state in one record, everything before it
             superseded.
"""
from __future__ import annotations

import json
import os
import threading
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence

from .queue import Request, Response


class LedgerCorrupt(Exception):
    """A WAL record failed its checksum *before* the final record — the log
    itself is damaged (not a torn tail) and must not be trusted."""


# ------------------------------------------------------------------ records
def _encode(seq: int, record: dict) -> str:
    body = dict(record)
    body["seq"] = seq
    payload = json.dumps(body, sort_keys=True, separators=(",", ":"))
    body["crc"] = zlib.crc32(payload.encode())
    return json.dumps(body, sort_keys=True, separators=(",", ":"))


def _decode(line: str) -> dict:
    body = json.loads(line)
    crc = body.pop("crc")
    payload = json.dumps(body, sort_keys=True, separators=(",", ":"))
    if zlib.crc32(payload.encode()) != crc:
        raise ValueError("crc mismatch")
    return body


def request_record(req: Request) -> dict:
    return {"kind": "submit", "id": req.id, "prompt": list(req.prompt),
            "max_new_tokens": req.max_new_tokens, "deadline": req.deadline}


def request_from(rec: dict, stamp: Optional[dict] = None) -> Request:
    req = Request(id=int(rec["id"]), prompt=tuple(rec["prompt"]),
                  max_new_tokens=int(rec["max_new_tokens"]),
                  deadline=rec.get("deadline"))
    if stamp is not None:
        req.arrival_t = stamp.get("arrival_t")
        req.trace_id = stamp.get("trace_id")
    return req


def response_record(resp: Response) -> dict:
    return {"kind": "retire", "id": resp.id, "status": resp.status,
            "tokens": list(resp.tokens), "latency_s": resp.latency_s,
            "ttft_s": resp.ttft_s, "retries": resp.retries,
            "replica": resp.replica, "detail": resp.detail,
            "trace_id": resp.trace_id}


def response_from(rec: dict) -> Response:
    return Response(id=int(rec["id"]), status=rec["status"],
                    tokens=tuple(rec.get("tokens", ())),
                    latency_s=float(rec.get("latency_s", 0.0)),
                    ttft_s=rec.get("ttft_s"),
                    retries=int(rec.get("retries", 0)),
                    replica=rec.get("replica"),
                    detail=rec.get("detail", ""),
                    trace_id=rec.get("trace_id"))


# ---------------------------------------------------------------------- WAL
class WriteAheadLog:
    """Append-only checksummed JSONL log, fsync'd before acknowledgement."""

    def __init__(self, path: str, *, fsync: bool = True,
                 compact_every: int = 512):
        self.path = path
        self.fsync = bool(fsync)
        self.compact_every = int(compact_every)
        self._lock = threading.Lock()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        # reopening an existing log (crash-restart): a torn final record is
        # truncated away here so subsequent appends continue a *valid* log —
        # otherwise the garbage tail would sit mid-file forever and turn a
        # legal crash artefact into fatal corruption at the next replay
        if os.path.exists(path) and os.path.getsize(path):
            records, _, valid_bytes = _scan(path)
            if valid_bytes < os.path.getsize(path):
                with open(path, "r+", encoding="utf-8") as f:
                    f.truncate(valid_bytes)
            self._seq = len(records)
        else:
            self._seq = 0
        self._f = open(path, "a", encoding="utf-8")
        self.appended_since_compact = 0

    def append(self, record: dict) -> None:
        """Durably append one record: the call returns only after the bytes
        are flushed and fsync'd — the WAL's acknowledgement contract."""
        with self._lock:
            self._f.write(_encode(self._seq, record) + "\n")
            self._f.flush()
            if self.fsync:
                os.fsync(self._f.fileno())
            self._seq += 1
            self.appended_since_compact += 1

    def should_compact(self) -> bool:
        return (self.compact_every > 0
                and self.appended_since_compact >= self.compact_every)

    def rewrite(self, records: Iterable[dict]) -> None:
        """Compaction: atomically replace the log with ``records`` (normally
        one ``snapshot``) via temp file + rename, so a crash mid-compaction
        leaves either the old log or the new one — never a hybrid."""
        with self._lock:
            tmp = self.path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                for i, rec in enumerate(records):
                    f.write(_encode(i, rec) + "\n")
                f.flush()
                os.fsync(f.fileno())
            self._f.close()
            os.replace(tmp, self.path)
            self._f = open(self.path, "a", encoding="utf-8")
            self._seq = _count_records(self.path)
            self.appended_since_compact = 0

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


def _count_records(path: str) -> int:
    with open(path, encoding="utf-8") as f:
        return sum(1 for _ in f)


def _scan(path: str) -> tuple[list[dict], int, int]:
    """Decode a WAL: ``(records, torn, valid_bytes)``.

    ``torn`` counts a truncated/corrupt **final** record (discarded — the
    crash interrupted the write); the same damage earlier raises
    :class:`LedgerCorrupt`. ``valid_bytes`` is the byte length of the valid
    prefix, so a reopening writer can truncate the torn tail away."""
    with open(path, "rb") as f:
        raw_lines = f.read().split(b"\n")
    # ignore a trailing empty segment from the final newline
    if raw_lines and not raw_lines[-1]:
        raw_lines.pop()
    records: list[dict] = []
    valid_bytes = 0
    for i, raw in enumerate(raw_lines):
        line = raw.decode("utf-8", errors="replace").strip()
        try:
            if not line:
                raise ValueError("blank record")
            rec = _decode(line)
            if int(rec.get("seq", -1)) != len(records):
                raise ValueError(
                    f"seq {rec.get('seq')} != expected {len(records)}")
        except (ValueError, KeyError, json.JSONDecodeError) as exc:
            if i == len(raw_lines) - 1:
                return records, 1, valid_bytes
            raise LedgerCorrupt(
                f"{path}: record {i} is corrupt mid-log: {exc}") from exc
        records.append(rec)
        valid_bytes += len(raw) + 1
    return records, 0, valid_bytes


# ------------------------------------------------------------------- replay
@dataclass
class LedgerReplay:
    """Everything :func:`replay` reconstructs from a WAL."""

    requests: dict[int, Request] = field(default_factory=dict)
    responses: dict[int, Response] = field(default_factory=dict)
    routes: dict[int, int] = field(default_factory=dict)   # last known owner
    epoch: int = 0
    members: tuple[int, ...] = ()
    records: int = 0
    torn: int = 0               # truncated/corrupt final records discarded

    def outstanding(self) -> list[Request]:
        """Unanswered accepted requests, id order — the re-submission set."""
        return [self.requests[rid] for rid in sorted(self.requests)
                if rid not in self.responses]


def replay(path: str) -> LedgerReplay:
    """Reconstruct ledger state from a WAL.

    Torn-write recovery: the **final** record may be truncated or
    checksum-corrupt (the crash interrupted the write) — it is discarded and
    counted in ``torn``, never fatal. The same damage anywhere earlier
    raises :class:`LedgerCorrupt`: an fsync'd record that later fails its
    CRC means the log is damaged, and replaying around it would silently
    drop acknowledged requests."""
    out = LedgerReplay()
    submits: dict[int, dict] = {}
    stamps: dict[int, dict] = {}
    decoded, out.torn, _ = _scan(path)
    for rec in decoded:
        kind = rec.get("kind")
        if kind == "submit":
            submits[int(rec["id"])] = rec
        elif kind == "stamp":
            stamps[int(rec["id"])] = rec
        elif kind == "route":
            out.routes[int(rec["id"])] = int(rec["rank"])
        elif kind == "retire":
            out.responses[int(rec["id"])] = response_from(rec)
        elif kind == "epoch":
            out.epoch = int(rec["epoch"])
            out.members = tuple(rec["members"])
        elif kind == "snapshot":
            submits = {int(r["id"]): r for r in rec.get("requests", ())}
            stamps = {int(r["id"]): r for r in rec.get("stamps", ())}
            out.responses = {int(r["id"]): response_from(r)
                             for r in rec.get("responses", ())}
            out.routes = {int(k): int(v)
                          for k, v in rec.get("routes", {}).items()}
            out.epoch = int(rec.get("epoch", 0))
            out.members = tuple(rec.get("members", ()))
        else:
            raise LedgerCorrupt(f"{path}: unknown record kind {kind!r}")
    out.requests = {rid: request_from(rec, stamps.get(rid))
                    for rid, rec in submits.items()}
    out.records = len(decoded)
    return out


# ------------------------------------------------------------- group ledger
class GroupLedger:
    """Shared (thread-safe) request ledger + the group's membership
    authority (see module docstring). Epochs move only forward; every
    membership change — ULFM shrink, join, autoscale — is an epoch proposal,
    and ranks converge on the highest proposed epoch through the health
    exchange."""

    def __init__(self, requests: Sequence[Request], ranks: Sequence[int], *,
                 spares: Sequence[int] = (), wal: Optional[WriteAheadLog] = None,
                 responses: Optional[dict] = None,
                 replayed: Iterable[int] = (),
                 stamped: Iterable[int] = (),
                 epoch0: int = 0, epoch_reason: str = "init",
                 log_submits: bool = True):
        self._lock = threading.Lock()
        self.wal = wal
        self.requests = {r.id: r for r in requests}
        if len(self.requests) != len(requests):
            raise ValueError("duplicate request ids")
        self.responses: dict[int, Response] = dict(responses or {})
        self.replayed = frozenset(replayed)     # ids re-admitted from a WAL
        self.alive = sorted(int(r) for r in ranks)
        self.epoch = int(epoch0)
        self.agreed_epoch = self.epoch          # highest epoch a rank entered
        self._members_by_epoch: dict[int, tuple[int, ...]] = {
            self.epoch: tuple(self.alive)}
        self._epoch_reason: dict[int, str] = {self.epoch: epoch_reason}
        self._entered: set[int] = {self.epoch}
        self.pending: dict[int, deque[Request]] = {
            r: deque() for r in list(self.alive) + [int(s) for s in spares]}
        self.owner: dict[int, int] = {}
        self.rerouted: list[int] = []           # moved by fault re-route
        self.rebalanced: list[int] = []         # moved by epoch re-balance
        self.joined: list[int] = []             # ranks admitted via join
        self.departed: list[int] = []           # ranks that left via autoscale
        self.autoscale_events: list[dict] = []
        self.scale_state = {"hot": 0, "idle": 0, "last_change": -(1 << 30)}
        self._dormant: list[int] = sorted(int(s) for s in spares)
        self._summoned: dict[int, str] = {}     # rank -> reason
        self._pending_joins: set[int] = set()   # scheduled, not yet landed
        self._leaving: Optional[int] = None
        self._stamped: set[int] = set(stamped)
        self.closed = False
        self.crashed = False
        self.state_snapshot: Optional[dict] = None
        if self.wal is not None:
            if log_submits:
                for rid in sorted(self.requests):
                    self.wal.append(request_record(self.requests[rid]))
            self.wal.append({"kind": "epoch", "epoch": self.epoch,
                             "members": list(self.alive),
                             "reason": epoch_reason})
        # initial assignment: round-robin over the sorted member list
        for i, req in enumerate(requests):
            rank = self.alive[i % len(self.alive)]
            self.pending[rank].append(req)
            self.owner[req.id] = rank
            if self.wal is not None:
                self.wal.append({"kind": "route", "id": req.id, "rank": rank})

    # ------------------------------------------------------------ work flow
    def take(self, rank: int, limit: Optional[int] = None) -> list[Request]:
        """Pop up to ``limit`` pending requests assigned to ``rank`` (all of
        them when ``limit`` is None). The elastic serve loop takes lazily —
        bounded by replica capacity — so a widened group finds untaken work
        to re-balance onto the joiner."""
        with self._lock:
            q = self.pending.get(rank)
            if not q:
                return []
            n = len(q) if limit is None else max(0, min(limit, len(q)))
            return [q.popleft() for _ in range(n)]

    def note_stamp(self, req: Request) -> None:
        """Mirror a request's acceptance stamp (arrival time + trace id) into
        the WAL, once — replay then preserves latency accounting and the
        causal trace chain across a restart."""
        if self.wal is None or req.id in self._stamped:
            return
        with self._lock:
            if req.id in self._stamped:
                return
            self._stamped.add(req.id)
            self.wal.append({"kind": "stamp", "id": req.id,
                             "arrival_t": req.arrival_t,
                             "trace_id": req.trace_id})

    def complete(self, resp: Response) -> bool:
        """Retire a request. The WAL record is fsync'd *before* the response
        becomes visible (first terminal answer wins). Returns True when the
        response was newly retired, False for a duplicate — the multihost
        supervisor acks a worker's ``retire`` only on (or after) the durable
        first copy, so a re-routed duplicate never double-counts."""
        with self._lock:
            if resp.id in self.responses:
                return False
            if self.wal is not None:
                self.wal.append(response_record(resp))
            self.responses[resp.id] = resp
            if self.wal is not None and self.wal.should_compact():
                self._compact_locked()
            return True

    def remaining(self) -> int:
        # count ids, don't subtract sizes: a replayed ledger's ``responses``
        # holds pre-crash answers whose ids are not in ``requests``
        with self._lock:
            return sum(1 for rid in self.requests
                       if rid not in self.responses)

    def backlog(self) -> int:
        """Accepted-but-untaken requests — the autoscaler's queue-depth
        signal and the re-balance pool."""
        with self._lock:
            return sum(len(q) for q in self.pending.values())

    # ------------------------------------------------------------ membership
    @property
    def members(self) -> tuple[int, ...]:
        with self._lock:
            return self._members_by_epoch[self.epoch]

    def members_of(self, epoch: int) -> tuple[int, ...]:
        with self._lock:
            return self._members_by_epoch[epoch]

    def reason_of(self, epoch: int) -> str:
        with self._lock:
            return self._epoch_reason.get(epoch, "?")

    def _propose_locked(self, members: Sequence[int], reason: str) -> int:
        members = tuple(sorted(int(m) for m in members))
        if not members:
            raise ValueError("cannot propose an empty membership")
        self.epoch += 1
        self._members_by_epoch[self.epoch] = members
        self._epoch_reason[self.epoch] = reason
        self.alive = list(members)
        if self.wal is not None:
            self.wal.append({"kind": "epoch", "epoch": self.epoch,
                             "members": list(members), "reason": reason})
        return self.epoch

    def on_shrink(self, survivors: Sequence[int]) -> list[tuple]:
        """Fault-driven membership change expressed as a survivor list (the
        value ``Comm.shrink_to_survivors`` hands back)."""
        current = self.members
        return self.on_death(set(current) - set(int(s) for s in survivors))

    def on_death(self, dead: Iterable[int]) -> list[tuple]:
        """Fault-driven membership change (ULFM shrink): drop ``dead`` from
        the current membership and reassign their unanswered requests
        (``id % n_survivors`` over the sorted survivor list). Idempotent: the
        first survivor to observe a given death performs the re-route and
        bumps the epoch; expressed as a death set (not a survivor list) so a
        concurrently proposed join is never mistaken for a failure."""
        with self._lock:
            current = list(self._members_by_epoch[self.epoch])
            dead = {int(d) for d in dead} & set(current)
            if not dead:
                return []
            survivors = [m for m in current if m not in dead]
            self._propose_locked(survivors, "shrink")
            moved = []
            for d in dead:
                self.pending.get(d, deque()).clear()
            for rid, owner in list(self.owner.items()):
                if owner in dead and rid not in self.responses:
                    new = survivors[rid % len(survivors)]
                    self.owner[rid] = new
                    req = self.requests[rid]
                    # the new owner recomputes from scratch: retries consumed
                    # on the dead replica don't count against it (arrival_t is
                    # kept, so latency still spans the recovery)
                    req.retries = 0
                    self.pending[new].append(req)
                    moved.append((rid, owner, new))
                    if self.wal is not None:
                        self.wal.append({"kind": "route", "id": rid,
                                         "rank": new})
            self.rerouted.extend(rid for rid, _, _ in moved)
            return moved

    def request_join(self, rank: int) -> Optional[int]:
        """A warmed-up rank proposes a widened membership. Returns the epoch
        the joiner must enter (the survivors converge on it through the
        health exchange), or None when the group already stopped — a join
        proposed after the final exchange would strand the joiner on a
        collective nobody else will post."""
        with self._lock:
            self._pending_joins.discard(rank)
            if self.closed or self.crashed:
                return None
            members = list(self._members_by_epoch[self.epoch])
            if rank in members:
                return self.epoch
            self._summoned.pop(rank, None)
            self.joined.append(rank)
            return self._propose_locked(members + [rank], "join")

    def depart(self, rank: int) -> int:
        """A drained rank proposes a narrowed membership (autoscale shrink's
        clean-leave half: the victim keeps exchanging until everyone has
        moved past the epoch that excludes it, then goes quiet)."""
        with self._lock:
            members = [m for m in self._members_by_epoch[self.epoch]
                       if m != rank]
            self.departed.append(rank)
            if self._leaving == rank:
                self._leaving = None
            return self._propose_locked(members, "autoscale_shrink")

    def enter_epoch(self, epoch: int) -> list[tuple]:
        """Converge on ``epoch``: the first entrant re-balances every
        untaken request over the epoch's member list (same deterministic
        ``id % n`` rule as the fault re-route) and the rest just observe.
        Returns the (rid, old, new) moves the entrant performed."""
        with self._lock:
            members = self._members_by_epoch[epoch]
            self.agreed_epoch = max(self.agreed_epoch, epoch)
            if epoch in self._entered:
                return []
            self._entered.add(epoch)
            moved = []
            untaken: list[Request] = []
            for q in self.pending.values():
                untaken.extend(q)
                q.clear()
            for req in sorted(untaken, key=lambda r: r.id):
                new = members[req.id % len(members)]
                old = self.owner.get(req.id)
                self.pending[new].append(req)
                self.owner[req.id] = new
                if new != old:
                    moved.append((req.id, old, new))
                    if self.wal is not None:
                        self.wal.append({"kind": "route", "id": req.id,
                                         "rank": new})
            self.rebalanced.extend(rid for rid, _, _ in moved)
            return moved

    # ------------------------------------------------------- spares / summon
    def summon_next(self, reason: str) -> Optional[int]:
        """Wake the lowest dormant spare (join schedule or autoscale grow).

        An operator-*scheduled* summons is a promise: the group defers its
        final close until the joiner lands (or explicitly abandons), so a
        requested regrow cannot silently lose the race against the drain.
        Autoscale summonses carry no such promise — an idle shutdown always
        beats speculative growth."""
        with self._lock:
            if not self._dormant:
                return None
            rank = self._dormant.pop(0)
            self._summoned[rank] = reason
            if reason == "scheduled":
                self._pending_joins.add(rank)
            return rank

    def summoned(self, rank: int) -> Optional[str]:
        with self._lock:
            return self._summoned.get(rank)

    def abandon_join(self, rank: int) -> None:
        """A summoned joiner gave up (fleet stopped mid-transfer, poll
        deadline, …): release the close-deferral promise so the survivors
        are not held open for a joiner that will never arrive."""
        with self._lock:
            self._pending_joins.discard(rank)

    def has_pending_joins(self) -> bool:
        with self._lock:
            return bool(self._pending_joins)

    def request_leave(self, rank: int) -> bool:
        """Mark ``rank`` as the autoscale-shrink victim (one at a time)."""
        with self._lock:
            if self._leaving is not None or rank not in self.alive:
                return False
            self._leaving = rank
            return True

    @property
    def leaving(self) -> Optional[int]:
        with self._lock:
            return self._leaving

    # ------------------------------------------------------------- lifecycle
    def close(self) -> None:
        with self._lock:
            self.closed = True

    def crash(self) -> None:
        with self._lock:
            self.crashed = True

    @property
    def stopped(self) -> bool:
        with self._lock:
            return self.closed or self.crashed

    def publish_state(self, snap: dict) -> None:
        with self._lock:
            self.state_snapshot = snap

    # ------------------------------------------------------------ compaction
    def _compact_locked(self) -> None:
        """Rewrite the WAL as one snapshot record (caller holds the lock)."""
        outstanding = [rid for rid in sorted(self.requests)
                       if rid not in self.responses]
        snap = {
            "kind": "snapshot",
            "epoch": self.epoch,
            "members": list(self._members_by_epoch[self.epoch]),
            "requests": [request_record(self.requests[rid])
                         for rid in outstanding],
            "stamps": [{"kind": "stamp", "id": rid,
                        "arrival_t": self.requests[rid].arrival_t,
                        "trace_id": self.requests[rid].trace_id}
                       for rid in outstanding if rid in self._stamped],
            "routes": {str(rid): self.owner[rid] for rid in outstanding
                       if rid in self.owner},
            "responses": [response_record(r)
                          for _, r in sorted(self.responses.items())],
        }
        self.wal.rewrite([snap])

    def compact(self) -> None:
        with self._lock:
            if self.wal is not None:
                self._compact_locked()
