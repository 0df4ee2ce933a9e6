# Copy of repro/core/transport.py.
"""In-process multi-rank transport: the substrate under the paper's protocols.

The paper's mechanisms (black channel, ULFM adoption) are defined against MPI
point-to-point / collective semantics. JAX has no user-level point-to-point runtime, so
for the *faithful reproduction* we implement the exact request semantics the paper
relies on — non-blocking (synchronous-mode) sends, pre-posted wildcard receives,
``MPI_Cancel``, ``MPI_Waitany``, and fault-aware collectives — over OS threads, one
thread per rank. This is the same role the MPI library plays in the paper; the
protocols in ``blackchannel.py`` / ``ulfm.py`` are written purely against the
:class:`RankCtx` API and do not know they are running on threads.

Failure model:

* ``Transport.kill(rank)`` simulates a *hard fault* (paper §II-A): the rank's thread is
  unwound at its next transport call, it stops participating in all communication.
* In **plain mode** (``ulfm=False``, i.e. MPI-3.0 semantics) operations involving a dead
  peer simply never complete — exactly the deadlock the paper sets out to preclude.
  Tests assert this via wait timeouts.
* In **ULFM mode** (``ulfm=True``) a built-in failure detector makes any operation
  involving a dead peer raise :class:`~repro_torch.core.errors.RankFailedError`
  (``MPI_ERR_PROC_FAILED``), pending wildcard receives fail
  (``MPI_ERR_PROC_FAILED_PENDING``), ``revoke`` poisons a communicator
  (``MPI_ERR_COMM_REVOKED``), ``agree`` is a fault-tolerant AND-allreduce over
  survivors, and ``shrink`` builds a new communicator from survivors.
"""
from __future__ import annotations

import enum
import itertools
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

from .errors import (
    CancelledError,
    MpiError,
    RankFailedError,
    RevokedError,
    TimeoutError_,
)

ANY_SOURCE = -1
ANY_TAG = -1


class _RankKilled(BaseException):
    """Unwinds a killed rank's thread. BaseException so user ``except Exception``
    blocks (application code) cannot swallow a simulated process death."""


class ReqState(enum.Enum):
    PENDING = "pending"
    COMPLETE = "complete"
    CANCELLED = "cancelled"
    FAILED = "failed"


_req_ids = itertools.count()


class Request:
    """A communication request (``MPI_Request`` analogue)."""

    __slots__ = ("id", "kind", "ctx_id", "owner", "peer", "tag", "data", "state",
                 "error", "source", "synchronous")

    def __init__(self, kind: str, ctx_id: int, owner: int, peer: int, tag: int,
                 data: Any = None, synchronous: bool = False):
        self.id = next(_req_ids)
        self.kind = kind              # "send" | "recv"
        self.ctx_id = ctx_id
        self.owner = owner            # global rank that posted the request
        self.peer = peer              # global rank of the peer (or ANY_SOURCE)
        self.tag = tag
        self.data = data              # payload (send) / received payload (recv)
        self.state = ReqState.PENDING
        self.error: Optional[Exception] = None
        self.source: Optional[int] = None   # actual source for wildcard recvs
        self.synchronous = synchronous      # Issend: complete only on match

    @property
    def done(self) -> bool:
        return self.state is not ReqState.PENDING

    def __repr__(self) -> str:  # pragma: no cover
        return (f"<Request {self.id} {self.kind} owner={self.owner} peer={self.peer} "
                f"tag={self.tag} {self.state.value}>")


@dataclass
class CommContext:
    """A communicator: an ordered member list + collective state + revocation flag."""

    id: int
    members: tuple[int, ...]             # global ranks, ordered; index = comm-local rank
    revoked: bool = False
    # per-global-rank collective sequence counter (keeps slots aligned across ranks)
    coll_seq: dict[int, int] = field(default_factory=dict)
    # per-global-rank derived-communicator sequence counter (dup/split consistency)
    dup_seq: dict[int, int] = field(default_factory=dict)
    # agree has its OWN sequence space: after a revoke, ordinary collective
    # counters are misaligned across ranks (some ops failed before, some after
    # incrementing) — exactly why ULFM specifies agree as a separate
    # fault-tolerant protocol rather than an ordinary collective.
    agree_seq: dict[int, int] = field(default_factory=dict)

    def local_rank(self, global_rank: int) -> int:
        return self.members.index(global_rank)

    def global_rank(self, local: int) -> int:
        return self.members[local]

    @property
    def size(self) -> int:
        return len(self.members)


_COLL_OPS: dict[str, Callable[[Any, Any], Any]] = {
    "sum": lambda a, b: a + b,
    "max": lambda a, b: max(a, b),
    "min": lambda a, b: min(a, b),
    "band": lambda a, b: a & b,
    "bor": lambda a, b: a | b,
    "land": lambda a, b: bool(a) and bool(b),
    "lor": lambda a, b: bool(a) or bool(b),
    # elementwise max over equal-length sequences (paper §III-B enumeration table)
    "emax": lambda a, b: [max(x, y) for x, y in zip(a, b)],
}


class _CollSlot:
    """One in-flight collective operation instance."""

    __slots__ = ("key", "ctx_id", "kind", "op", "required", "arrived", "done",
                 "result", "error", "root")

    def __init__(self, key, ctx_id, kind, op, required, root=None):
        self.key = key
        self.ctx_id = ctx_id
        self.kind = kind              # barrier|allreduce|scan|bcast|gather|agree
        self.op = op
        self.required = set(required)  # global ranks that must arrive
        self.arrived: dict[int, Any] = {}
        self.done = False
        self.result: Any = None
        self.error: Optional[Exception] = None
        self.root = root


class Transport:
    """N simulated ranks over threads. All state guarded by one condition variable."""

    def __init__(self, nranks: int, *, ulfm: bool = False):
        self.nranks = nranks
        self.ulfm = ulfm
        self._cv = threading.Condition()
        self._ctx_ids = itertools.count()
        self.dead: set[int] = set()
        # mailboxes: (ctx_id, dst_global) -> list of unmatched send Requests
        self._mail: dict[tuple[int, int], list[Request]] = {}
        # pending receives: (ctx_id, dst_global) -> list of pending recv Requests
        self._recvs: dict[tuple[int, int], list[Request]] = {}
        self._slots: dict[tuple, _CollSlot] = {}
        self._contexts: dict[int, CommContext] = {}
        self._derived: dict[tuple, CommContext] = {}
        self.world = self._new_context(tuple(range(nranks)))

    # ------------------------------------------------------------------ contexts
    def _new_context(self, members: tuple[int, ...]) -> CommContext:
        ctx = CommContext(id=next(self._ctx_ids), members=members,
                          coll_seq={r: 0 for r in members})
        self._contexts[ctx.id] = ctx
        return ctx

    def dup(self, ctx: CommContext, rank: int | None = None) -> CommContext:
        """``MPI_Comm_dup``: same members, fresh context (fresh tag/collective space).

        Collective-consistent: the k-th dup of a given context yields the *same* new
        context on every rank (keyed by a per-rank dup sequence counter, like the
        collective sequence numbers)."""
        with self._cv:
            if rank is None:
                return self._new_context(ctx.members)
            seq = ctx.dup_seq.get(rank, 0)
            ctx.dup_seq[rank] = seq + 1
            key = (ctx.id, "dup", seq)
            got = self._derived.get(key)
            if got is None:
                got = self._new_context(ctx.members)
                self._derived[key] = got
            return got

    def split(self, ctx: CommContext, members: Sequence[int],
              rank: int | None = None) -> CommContext:
        """Collective-consistent split (all ranks calling with the same member list
        in the same order share the resulting context)."""
        with self._cv:
            members = tuple(members)
            if rank is None:
                return self._new_context(members)
            seq = ctx.dup_seq.get(rank, 0)
            ctx.dup_seq[rank] = seq + 1
            key = (ctx.id, "split", seq, members)
            got = self._derived.get(key)
            if got is None:
                got = self._new_context(members)
                self._derived[key] = got
            return got

    def repair(self, members: Sequence[int], key: object) -> CommContext:
        """Fault-aware **non-collective** communicator creation (the
        reparation primitive of arXiv 2209.01849): build a context from an
        explicit global member list without a collective over any parent —
        so it works when the parent communicator contains dead ranks, and a
        *joining* rank (not a member of any survivor communicator) can reach
        the same context as the survivors.

        Every participant calls independently with the same ``(members,
        key)`` and receives the same context; ``key`` disambiguates repeated
        repairs over the same membership (the serve group keys it by its
        ledger epoch)."""
        with self._cv:
            members = tuple(members)
            cache_key = ("repair", members, key)
            got = self._derived.get(cache_key)
            if got is None:
                got = self._new_context(members)
                self._derived[cache_key] = got
            return got

    # ------------------------------------------------------------------- failure
    def kill(self, rank: int) -> None:
        """Simulate a hard fault of ``rank`` (process/node loss)."""
        with self._cv:
            if rank in self.dead:
                return
            self.dead.add(rank)
            if self.ulfm:
                self._fail_requests_involving(rank)
                self._reeval_slots_after_death()
            self._cv.notify_all()

    def revoke(self, ctx: CommContext) -> None:
        """ULFM ``MPI_Comm_revoke``: poison the context for every rank."""
        with self._cv:
            if ctx.revoked:
                return
            ctx.revoked = True
            err = RevokedError()
            for (cid, _dst), reqs in list(self._mail.items()):
                if cid == ctx.id:
                    for r in reqs:
                        self._finish(r, ReqState.FAILED, error=err)
                    reqs.clear()
            for (cid, _dst), reqs in list(self._recvs.items()):
                if cid == ctx.id:
                    for r in reqs:
                        self._finish(r, ReqState.FAILED, error=err)
                    reqs.clear()
            for slot in self._slots.values():
                if slot.ctx_id == ctx.id and not slot.done and slot.kind != "agree":
                    slot.error = RevokedError()
                    slot.done = True
            self._cv.notify_all()

    def _fail_requests_involving(self, rank: int) -> None:
        """ULFM failure detector: fail pending requests whose peer is dead."""
        err = RankFailedError([rank])
        for reqs in self._mail.values():
            for r in list(reqs):
                if r.peer == rank or r.owner == rank:
                    self._finish(r, ReqState.FAILED, error=err)
                    reqs.remove(r)
        for reqs in self._recvs.values():
            for r in list(reqs):
                # MPI_ERR_PROC_FAILED (named peer) / _PENDING (wildcard)
                if r.peer == rank or r.peer == ANY_SOURCE or r.owner == rank:
                    self._finish(r, ReqState.FAILED, error=err)
                    reqs.remove(r)

    def _reeval_slots_after_death(self) -> None:
        for slot in self._slots.values():
            if slot.done:
                continue
            dead_members = slot.required & self.dead
            if not dead_members:
                continue
            if slot.kind == "agree":
                # fault-tolerant: requirement shrinks to survivors
                slot.required -= self.dead
                self._maybe_complete_slot(slot)
            else:
                slot.error = RankFailedError(sorted(dead_members))
                slot.done = True

    # ------------------------------------------------------------- rank liveness
    def _check_alive(self, rank: int) -> None:
        if rank in self.dead:
            raise _RankKilled()

    def _check_ctx(self, ctx: CommContext, *, allow_revoked: bool = False) -> None:
        if ctx.revoked and not allow_revoked:
            raise RevokedError()

    # ------------------------------------------------------------- point-to-point
    def _post_send(self, ctx: CommContext, src: int, dst_local: int, tag: int,
                   data: Any, synchronous: bool) -> Request:
        with self._cv:
            self._check_alive(src)
            self._check_ctx(ctx)
            dst = ctx.global_rank(dst_local)
            req = Request("send", ctx.id, src, dst, tag, data=data,
                          synchronous=synchronous)
            if self.ulfm and dst in self.dead:
                req.state = ReqState.FAILED
                req.error = RankFailedError([dst])
                return req
            # try to match a pending recv at the destination
            key = (ctx.id, dst)
            for r in self._recvs.get(key, []):
                if self._match(r, src, tag):
                    self._deliver(r, req)
                    self._recvs[key].remove(r)
                    self._cv.notify_all()
                    return req
            self._mail.setdefault(key, []).append(req)
            if not synchronous:
                # buffered send: complete immediately (payload copied by value)
                req.state = ReqState.COMPLETE
            self._cv.notify_all()
            return req

    def isend(self, ctx, src, dst_local, tag, data) -> Request:
        return self._post_send(ctx, src, dst_local, tag, data, synchronous=False)

    def issend(self, ctx, src, dst_local, tag, data) -> Request:
        """Synchronous-mode send: completes only when matched (``MPI_Issend``)."""
        return self._post_send(ctx, src, dst_local, tag, data, synchronous=True)

    def irecv(self, ctx: CommContext, owner: int, src_local: int, tag: int) -> Request:
        with self._cv:
            self._check_alive(owner)
            self._check_ctx(ctx)
            src = ANY_SOURCE if src_local == ANY_SOURCE else ctx.global_rank(src_local)
            req = Request("recv", ctx.id, owner, src, tag)
            if self.ulfm and src != ANY_SOURCE and src in self.dead:
                req.state = ReqState.FAILED
                req.error = RankFailedError([src])
                return req
            key = (ctx.id, owner)
            for s in self._mail.get(key, []):
                if self._match(req, s.owner, s.tag):
                    self._deliver(req, s)
                    self._mail[key].remove(s)
                    self._cv.notify_all()
                    return req
            self._recvs.setdefault(key, []).append(req)
            self._cv.notify_all()
            return req

    @staticmethod
    def _match(recv: Request, src: int, tag: int) -> bool:
        return ((recv.peer == ANY_SOURCE or recv.peer == src)
                and (recv.tag == ANY_TAG or recv.tag == tag))

    def _deliver(self, recv: Request, send: Request) -> None:
        recv.data = send.data
        recv.source = send.owner
        self._finish(recv, ReqState.COMPLETE)
        self._finish(send, ReqState.COMPLETE)

    def _finish(self, req: Request, state: ReqState, error: Exception | None = None) -> None:
        if req.state is ReqState.PENDING:
            req.state = state
            req.error = error

    def cancel(self, req: Request) -> bool:
        """``MPI_Cancel``: succeeds iff the request has not been matched yet."""
        with self._cv:
            if req.state is not ReqState.PENDING:
                return False
            store = self._mail if req.kind == "send" else self._recvs
            for key, lst in store.items():
                if key[0] == req.ctx_id and req in lst:
                    lst.remove(req)
                    break
            self._finish(req, ReqState.CANCELLED, error=CancelledError())
            self._cv.notify_all()
            return True

    # ------------------------------------------------------------------- waiting
    def test(self, rank: int, req: Request) -> bool:
        with self._cv:
            self._check_alive(rank)
            return req.done

    def wait(self, rank: int, req: Request, timeout: float | None = None) -> Request:
        idx, r = self.waitany(rank, [req], timeout=timeout)
        return r

    def waitany(self, rank: int, reqs: Sequence[Request],
                timeout: float | None = None) -> tuple[int, Request]:
        """``MPI_Waitany``: block until any request completes/fails/cancels."""
        with self._cv:
            deadline = None if timeout is None else _now() + timeout
            while True:
                self._check_alive(rank)
                for i, r in enumerate(reqs):
                    if r.done:
                        return i, r
                remaining = None if deadline is None else deadline - _now()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError_(f"waitany timed out after {timeout}s")
                self._cv.wait(timeout=remaining if remaining is not None else 0.25)

    def waitall(self, rank: int, reqs: Sequence[Request],
                timeout: float | None = None) -> None:
        with self._cv:
            deadline = None if timeout is None else _now() + timeout
            while True:
                self._check_alive(rank)
                if all(r.done for r in reqs):
                    return
                remaining = None if deadline is None else deadline - _now()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError_(f"waitall timed out after {timeout}s")
                self._cv.wait(timeout=remaining if remaining is not None else 0.25)

    # ---------------------------------------------------------------- collectives
    def _collective(self, ctx: CommContext, rank: int, kind: str, value: Any,
                    op: str | None = None, root: int | None = None,
                    timeout: float | None = None) -> Any:
        allow_revoked = kind == "agree"
        with self._cv:
            self._check_alive(rank)
            self._check_ctx(ctx, allow_revoked=allow_revoked)
            counter = ctx.agree_seq if kind == "agree" else ctx.coll_seq
            seq = counter.get(rank, 0)
            counter[rank] = seq + 1
            key = (ctx.id, kind, seq)
            slot = self._slots.get(key)
            if slot is None:
                required = set(ctx.members)
                if kind == "agree":
                    required -= self.dead
                slot = _CollSlot(key, ctx.id, kind,
                                 _COLL_OPS.get(op) if op else None, required, root)
                self._slots[key] = slot
            slot.arrived[rank] = value
            # ULFM failure detector also fires for slots created *after* a death
            if (self.ulfm and not slot.done and kind != "agree"
                    and slot.required & self.dead):
                slot.error = RankFailedError(sorted(slot.required & self.dead))
                slot.done = True
            self._maybe_complete_slot(slot)
            self._cv.notify_all()
            deadline = None if timeout is None else _now() + timeout
            while not slot.done:
                self._check_alive(rank)
                if ctx.revoked and not allow_revoked:
                    raise RevokedError()
                remaining = None if deadline is None else deadline - _now()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError_(f"collective {kind} timed out")
                self._cv.wait(timeout=remaining if remaining is not None else 0.25)
            if slot.error is not None:
                raise slot.error
            if kind == "scan":
                # inclusive prefix over comm-local rank order
                local = ctx.local_rank(rank)
                acc = None
                for gr in ctx.members[: local + 1]:
                    if gr in slot.arrived:
                        v = slot.arrived[gr]
                        acc = v if acc is None else slot.op(acc, v)
                return acc
            if kind == "gather":
                return [slot.arrived.get(gr) for gr in ctx.members]
            return slot.result

    def _maybe_complete_slot(self, slot: _CollSlot) -> None:
        if slot.done or not slot.required.issubset(slot.arrived.keys()):
            return
        if slot.kind == "barrier":
            slot.result = None
        elif slot.kind in ("allreduce", "agree"):
            acc = None
            for r in sorted(slot.arrived.keys() & slot.required):
                v = slot.arrived[r]
                acc = v if acc is None else slot.op(acc, v)
            slot.result = acc
        elif slot.kind == "bcast":
            slot.result = slot.arrived.get(slot.root)
        elif slot.kind in ("scan", "gather"):
            slot.result = None  # computed per-rank at return
        slot.done = True

    def barrier(self, ctx, rank, timeout=None) -> None:
        self._collective(ctx, rank, "barrier", None, timeout=timeout)

    def allreduce(self, ctx, rank, value, op="sum", timeout=None) -> Any:
        return self._collective(ctx, rank, "allreduce", value, op=op, timeout=timeout)

    def scan(self, ctx, rank, value, op="sum", timeout=None) -> Any:
        return self._collective(ctx, rank, "scan", value, op=op, timeout=timeout)

    def bcast(self, ctx, rank, value, root=0, timeout=None) -> Any:
        root_global = ctx.global_rank(root)
        return self._collective(ctx, rank, "bcast", value, root=root_global,
                                timeout=timeout)

    def gather_all(self, ctx, rank, value, timeout=None) -> list:
        """Convenience allgather (used by tests/benchmarks, not the paper protocol)."""
        return self._collective(ctx, rank, "gather", value, timeout=timeout)

    def agree(self, ctx, rank, flag: int, timeout=None) -> int:
        """ULFM ``MPI_Comm_agree``: bitwise AND over surviving ranks; tolerant of
        failures and usable on a revoked communicator."""
        if not self.ulfm:
            raise MpiError(-1, "agree requires ULFM support")
        return self._collective(ctx, rank, "agree", int(flag), op="band",
                                timeout=timeout)

    def shrink(self, ctx: CommContext, rank: int, timeout=None) -> CommContext:
        """ULFM ``MPI_Comm_shrink``: new communicator over surviving members.

        Implemented as agree-on-membership: every survivor observes the same dead set
        (consistent under the global lock), then deterministically derives the new
        context. A per-source-context cache makes all survivors share one new context.
        """
        if not self.ulfm:
            raise MpiError(-1, "shrink requires ULFM support")
        # rendezvous among survivors so the dead-set is agreed upon
        self._collective(ctx, rank, "agree", 1, op="band", timeout=timeout)
        with self._cv:
            survivors = tuple(m for m in ctx.members if m not in self.dead)
            cache_key = ("shrink", ctx.id, survivors)
            slot = self._slots.get(cache_key)
            if slot is None:
                new_ctx = self._new_context(survivors)
                slot = _CollSlot(cache_key, ctx.id, "shrinkctx", None, set())
                slot.result = new_ctx
                slot.done = True
                self._slots[cache_key] = slot
            return slot.result


def _now() -> float:
    import time

    return time.monotonic()


# --------------------------------------------------------------------------- RankCtx
class RankCtx:
    """Per-rank handle: the only API the protocol layers see."""

    def __init__(self, transport: Transport, rank: int):
        self.t = transport
        self.rank = rank

    # communicator management
    @property
    def world(self) -> CommContext:
        return self.t.world

    def dup(self, ctx: CommContext) -> CommContext:
        return self.t.dup(ctx, rank=self.rank)

    def repair(self, members: Sequence[int], key: object) -> CommContext:
        return self.t.repair(members, key)

    def local_rank(self, ctx: CommContext) -> int:
        return ctx.local_rank(self.rank)

    def size(self, ctx: CommContext) -> int:
        return ctx.size

    # point-to-point
    def isend(self, ctx, dst, tag, data) -> Request:
        return self.t.isend(ctx, self.rank, dst, tag, data)

    def issend(self, ctx, dst, tag, data) -> Request:
        return self.t.issend(ctx, self.rank, dst, tag, data)

    def irecv(self, ctx, src, tag) -> Request:
        return self.t.irecv(ctx, self.rank, src, tag)

    def cancel(self, req) -> bool:
        return self.t.cancel(req)

    def test(self, req) -> bool:
        return self.t.test(self.rank, req)

    def wait(self, req, timeout=None) -> Request:
        return self.t.wait(self.rank, req, timeout=timeout)

    def waitany(self, reqs, timeout=None):
        return self.t.waitany(self.rank, reqs, timeout=timeout)

    def waitall(self, reqs, timeout=None):
        return self.t.waitall(self.rank, reqs, timeout=timeout)

    # collectives
    def barrier(self, ctx, timeout=None):
        return self.t.barrier(ctx, self.rank, timeout=timeout)

    def allreduce(self, ctx, value, op="sum", timeout=None):
        return self.t.allreduce(ctx, self.rank, value, op=op, timeout=timeout)

    def scan(self, ctx, value, op="sum", timeout=None):
        return self.t.scan(ctx, self.rank, value, op=op, timeout=timeout)

    def bcast(self, ctx, value, root=0, timeout=None):
        return self.t.bcast(ctx, self.rank, value, root=root, timeout=timeout)

    def gather_all(self, ctx, value, timeout=None):
        return self.t.gather_all(ctx, self.rank, value, timeout=timeout)

    # ULFM surface
    def revoke(self, ctx):
        return self.t.revoke(ctx)

    def agree(self, ctx, flag, timeout=None):
        return self.t.agree(ctx, self.rank, flag, timeout=timeout)

    def shrink(self, ctx, timeout=None):
        return self.t.shrink(ctx, self.rank, timeout=timeout)

    @property
    def ulfm(self) -> bool:
        return self.t.ulfm

    def die(self) -> None:
        """Hard-fault *this* rank from inside (used by fault injection)."""
        self.t.kill(self.rank)
        raise _RankKilled()


# ------------------------------------------------------------------------ run harness
@dataclass
class RankResult:
    rank: int
    value: Any = None
    exception: Optional[BaseException] = None
    killed: bool = False


def run_ranks(nranks: int, fn: Callable[[RankCtx], Any], *, ulfm: bool = False,
              join_timeout: float = 60.0,
              transport: Transport | None = None) -> list[RankResult]:
    """Run ``fn(ctx)`` on ``nranks`` simulated ranks; collect results/exceptions.

    The ``transport`` is exposed to ``fn`` via ``ctx.t`` so tests can inject faults
    (e.g. ``ctx.t.kill(3)``).
    """
    t = transport or Transport(nranks, ulfm=ulfm)
    results = [RankResult(r) for r in range(nranks)]

    def runner(rank: int):
        ctx = RankCtx(t, rank)
        try:
            results[rank].value = fn(ctx)
        except _RankKilled:
            results[rank].killed = True
        except BaseException as e:  # noqa: BLE001 - harness must capture everything
            results[rank].exception = e

    threads = [threading.Thread(target=runner, args=(r,), daemon=True)
               for r in range(nranks)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=join_timeout)
    alive = [i for i, th in enumerate(threads) if th.is_alive()]
    if alive:
        # unstick any thread still blocked (test misuse / genuine deadlock): mark dead
        for r in alive:
            t.kill(r)
        for th in threads:
            th.join(timeout=5.0)
        raise TimeoutError_(f"ranks {alive} did not terminate (deadlock?)")
    return results
