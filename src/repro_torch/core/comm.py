# Copy of repro/core/comm.py.
"""``Comm`` facade (paper Fig. 1): communicator + futures + error signalling.

The user-facing surface mirrors the paper's class diagram:

* ``send`` / ``recv`` / ``all_reduce`` return :class:`~repro_torch.core.future.Future`;
* ``signal_error(code)`` propagates a local error to every rank;
* the object is a context manager: leaving the ``with`` block while an exception is
  unwinding marks the communicator corrupted on *all* ranks (the C++
  ``std::uncaught_exception``-in-destructor idiom, §III-A "Corrupted communicator");
* ``duplicate()`` / ``split()`` create derived communicators (Comm is 1:1 with an MPI
  communicator and therefore non-copyable — here: no ``__copy__``).

The protocol backend is chosen by capability, exactly as in the paper: ULFM if the
transport supports it, otherwise the Black Channel.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

from .blackchannel import BlackChannel
from .errors import CommCorruptedError, ErrorCode, ReproError
from .future import AsyncOp, Future
from .transport import ANY_SOURCE, ANY_TAG, CommContext, RankCtx
from .ulfm import UlfmChannel

DATA_TAG = 0


class Comm:
    """One communicator on one rank."""

    def __init__(self, ctx: RankCtx, base: CommContext | None = None, *,
                 default_timeout: float | None = None):
        self._ctx = ctx
        base = base if base is not None else ctx.world
        self._default_timeout = default_timeout
        if ctx.ulfm:
            self._protocol = UlfmChannel(ctx, base, default_timeout=default_timeout)
        else:
            self._protocol = BlackChannel(ctx, base, default_timeout=default_timeout)

    # --------------------------------------------------------------- introspection
    @property
    def rank(self) -> int:
        return self._protocol.comm.local_rank(self._ctx.rank)

    @property
    def size(self) -> int:
        return self._protocol.comm.size

    @property
    def context(self) -> CommContext:
        return self._protocol.comm

    @property
    def alive(self) -> bool:
        return self._protocol.alive

    @property
    def ulfm(self) -> bool:
        return self._ctx.ulfm

    # ------------------------------------------------------------- communication
    def send(self, data: Any, dst: int, tag: int = DATA_TAG) -> Future:
        req = self._protocol.post(
            lambda c: self._ctx.isend(c, dst, tag, data))
        return Future(self, self._protocol.track(req))

    def ssend(self, data: Any, dst: int, tag: int = DATA_TAG) -> Future:
        req = self._protocol.post(
            lambda c: self._ctx.issend(c, dst, tag, data))
        return Future(self, self._protocol.track(req))

    def recv(self, src: int = ANY_SOURCE, tag: int = ANY_TAG) -> Future:
        req = self._protocol.post(
            lambda c: self._ctx.irecv(c, src, tag))
        return Future(self, self._protocol.track(req))

    def all_reduce(self, value: Any, op: str = "sum") -> Future:
        """Non-blocking collective (paper: 'We exemplarily implemented the all_reduce
        functionality'). Backed by a helper thread; like MPI non-blocking
        collectives it cannot be cancelled — abandoning it leaks (paper §IV-B)."""
        ctx = self._ctx
        op_ = self._protocol.post(
            lambda c: AsyncOp(ctx.t, lambda: ctx.allreduce(c, value, op=op)))
        return Future(self, op_)

    def barrier(self, timeout: float | None = None) -> None:
        self._protocol.post(
            lambda c: self._ctx.barrier(
                c, timeout=timeout or self._default_timeout))

    # ------------------------------------------------------------------- errors
    def signal_error(self, code: int | ErrorCode, *,
                     timeout: float | None = None) -> None:
        """Propagate a local error to all ranks; raises ``PropagatedError`` locally
        (paper: 'The rank itself throws a Propagated_exception within the method
        signal_error')."""
        self._protocol.signal_error(code, timeout=timeout)

    # ------------------------------------------------------------------ derived
    def duplicate(self) -> "Comm":
        return Comm(self._ctx, self._ctx.dup(self._protocol.comm),
                    default_timeout=self._default_timeout)

    def split(self, members: Sequence[int]) -> Optional["Comm"]:
        """Create a sub-communicator from comm-local ranks ``members``; returns None
        on ranks not included (cf. ``MPI_Comm_split``)."""
        base = self._protocol.comm
        global_members = tuple(base.global_rank(m) for m in members)
        new_ctx = self._ctx.t.split(base, global_members, rank=self._ctx.rank)
        if self._ctx.rank not in global_members:
            return None
        return Comm._wrap(self._ctx, new_ctx, self._default_timeout)

    def repair(self, members: Sequence[int], key: object) -> Optional["Comm"]:
        """Fault-aware non-collective creation/reparation (arXiv 2209.01849):
        build a communicator over explicit **global** ranks ``members``
        without a collective over this (possibly corrupted) communicator.
        Unlike :meth:`split`, the member list may exclude dead ranks and may
        include ranks that were never members of this communicator — the one
        primitive that serves both fault-driven shrink *and* grow (rejoin /
        scale-out). All participants calling with the same ``(members, key)``
        share the resulting context. Returns None on excluded ranks."""
        global_members = tuple(int(m) for m in members)
        new_ctx = self._ctx.repair(global_members, key)
        if self._ctx.rank not in global_members:
            return None
        return Comm._wrap(self._ctx, new_ctx, self._default_timeout)

    @classmethod
    def _wrap(cls, ctx: RankCtx, base: CommContext,
              default_timeout: float | None = None) -> "Comm":
        obj = cls.__new__(cls)
        obj._ctx = ctx
        obj._default_timeout = default_timeout
        if ctx.ulfm:
            obj._protocol = UlfmChannel(ctx, base, default_timeout=default_timeout)
        else:
            obj._protocol = BlackChannel(ctx, base, default_timeout=default_timeout)
        return obj

    # ----------------------------------------------------- recovery (ULFM only)
    def shrink_to_survivors(self) -> "Comm":
        """After ``CommCorruptedError`` under ULFM: rebuild from survivors (LFLR)."""
        if not self._ctx.ulfm:
            raise CommCorruptedError(
                msg="black-channel communicator cannot shrink; rebuild required")
        self._protocol.shrink_to_survivors()
        return self

    # -------------------------------------------------------------- RAII analogue
    def __enter__(self) -> "Comm":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        """Paper: 'The Comm object detects in the destructor whether it gets
        destructed during stack unwinding due to a thrown exception ... interpreted
        as an unrecoverable error within the communicator.'

        An exception of the framework's own corrupted/propagated kind that was
        already globally agreed does not need re-signalling.
        """
        if exc_type is None:
            self._protocol.close()
            return False
        already_global = isinstance(exc, CommCorruptedError)
        if not already_global and self._protocol.alive:
            self._protocol.corrupted_teardown()
        return False  # never swallow the user's exception

    def close(self) -> None:
        self._protocol.close()
