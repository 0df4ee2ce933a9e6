# Copy of repro/core/ulfm.py.
"""ULFM-backed protocol — faithful implementation of paper §III-C.

When the transport advertises ULFM support, no black channel is needed: hard-failure
detection and revocation are provided by the runtime. The protocol becomes:

* ``wait`` is a plain ``MPI_Wait`` that inspects the completion status;
* ``signal_error`` calls ``MPI_Comm_revoke`` — every pending or future operation on
  the communicator fails with ``MPI_ERR_COMM_REVOKED`` on all ranks;
* all ranks then ``MPI_Comm_agree`` on an integer flag (bitwise AND): ranks that
  observed a hard failure (``MPI_ERR_PROC_FAILED``) or are unwinding (corrupted)
  contribute 0; a clean ``signal_error`` contributes 1;
* if the AND is 0 the communicator is corrupted → ``CommCorruptedError``; otherwise
  ``MPI_Comm_shrink`` yields a working communicator (same membership when no rank
  died) and the *same enumeration algorithm as the black channel* runs on it.

This covers hard faults (node loss) that the black channel cannot observe — the
paper's motivation for the dedicated ULFM code path.
"""
from __future__ import annotations

from typing import Optional

from .errors import (
    CommCorruptedError,
    ErrorCode,
    MpiError,
    PropagatedError,
    RankError,
    RankFailedError,
    RevokedError,
)
from .transport import CommContext, RankCtx, ReqState


class UlfmChannel:
    """Per-rank ULFM protocol state for one communicator."""

    def __init__(self, ctx: RankCtx, base: CommContext,
                 default_timeout: float | None = None):
        if not ctx.ulfm:
            raise MpiError(-1, "UlfmChannel requires a ULFM-capable transport")
        self.ctx = ctx
        self.comm = base
        self.alive = True
        self.default_timeout = default_timeout

    @property
    def rank(self) -> int:
        return self.comm.local_rank(self.ctx.rank)

    @property
    def size(self) -> int:
        return self.comm.size

    def _t(self, timeout):
        return timeout if timeout is not None else self.default_timeout

    def track(self, req) -> "Request":
        """ULFM needs no drain bookkeeping: revoke fails every pending request on
        the communicator at the transport level."""
        return req

    def post(self, fn):
        """Issue an operation; a post-time ULFM error (revoked comm / dead peer)
        routes into the agreement phase exactly like a wait-time error — the paper's
        contract is that *any* MPI call site may throw the unified exceptions."""
        if not self.alive:
            raise CommCorruptedError(msg="operation on corrupted communicator")
        try:
            return fn(self.comm)
        except RevokedError:
            self._post_revoke(flag=1, am_signaller=False, my_code=0,
                              timeout=self.default_timeout)
            raise AssertionError("unreachable")  # pragma: no cover
        except RankFailedError:
            self.ctx.revoke(self.comm)
            self._post_revoke(flag=0, am_signaller=True,
                              my_code=int(ErrorCode.RANK_FAILED),
                              timeout=self.default_timeout)
            raise AssertionError("unreachable")  # pragma: no cover

    # ------------------------------------------------------------------- waiting
    def wait(self, request, timeout: float | None = None) -> None:
        """Paper: 'If ULFM is available, the wait method of the Future invokes an
        MPI_Wait, instead of the MPI_Waitany, and checks the return code.'"""
        if not self.alive:
            raise CommCorruptedError(msg="wait on corrupted communicator")
        timeout = self._t(timeout)
        r = self.ctx.wait(request, timeout=timeout)
        if r.state is not ReqState.FAILED:
            return
        err = r.error
        if isinstance(err, RevokedError):
            # someone revoked: join the agreement phase as an innocent party
            self._post_revoke(flag=1, am_signaller=False, my_code=0, timeout=timeout)
        elif isinstance(err, RankFailedError):
            # hard failure observed locally: revoke and vote 'corrupted'
            self.ctx.revoke(self.comm)
            self._post_revoke(flag=0, am_signaller=True,
                              my_code=int(ErrorCode.RANK_FAILED), timeout=timeout)
        else:
            raise MpiError(-1, f"request failed: {err}") from err

    # ---------------------------------------------------------------- signalling
    def signal_error(self, code: int | ErrorCode, *, corrupted: bool = False,
                     timeout: float | None = None, reraise: bool = True) -> None:
        """Paper: 'There are three cases in which the communicator is revoked. The
        first case is the call of the method signal_error.'"""
        if not self.alive:
            raise CommCorruptedError(msg="signal_error on corrupted communicator")
        self.ctx.revoke(self.comm)
        self._post_revoke(flag=0 if corrupted else 1, am_signaller=True,
                          my_code=int(code), timeout=self._t(timeout),
                          reraise=reraise)

    # ------------------------------------------------------------- post-revoke
    def _post_revoke(self, flag: int, am_signaller: bool, my_code: int,
                     timeout: float | None, reraise: bool = True) -> None:
        ctx = self.ctx
        # "the function MPI_Comm_agree is used to determine whether the communicator
        # is corrupted or an error code is signaled"
        ok = ctx.agree(self.comm, flag, timeout=timeout)
        if ok == 0:
            self.alive = False
            # a hard failure or unwinding destructor: communicator unusable
            exc: Exception = CommCorruptedError()
            if reraise:
                raise exc
            return
        # "otherwise MPI_Comm_shrink is called to obtain a valid communicator"
        new_comm = ctx.shrink(self.comm, timeout=timeout)
        old = self.comm
        self.comm = new_comm  # the Comm facade now operates on the shrunk context
        # "Then we proceed with the same algorithm like in the Black-Channel case to
        # propagate the rank numbers and error codes of the failed ranks."
        errors = self._enumerate_failed(new_comm, am_signaller, my_code,
                                        old, timeout)
        if reraise:
            raise PropagatedError(errors)

    def _enumerate_failed(self, comm: CommContext, am_signaller: bool, my_code: int,
                          old_comm: CommContext, timeout: float | None) -> list[RankError]:
        ctx = self.ctx
        my_rank, size = comm.local_rank(ctx.rank), comm.size
        flag = 1 if am_signaller else 0
        idx = ctx.scan(comm, flag, op="sum", timeout=timeout)
        count = ctx.bcast(comm, idx if my_rank == size - 1 else None,
                          root=size - 1, timeout=timeout)
        table = [0] * (2 * count)
        if am_signaller:
            k = idx - 1
            # report ranks in the *old* communicator's numbering so that the
            # application can identify which shard of work was affected
            table[2 * k] = old_comm.local_rank(ctx.rank)
            table[2 * k + 1] = my_code
        table = ctx.allreduce(comm, table, op="emax", timeout=timeout)
        return [RankError(rank=table[2 * i], code=table[2 * i + 1])
                for i in range(count)]

    # ------------------------------------------------------------------ teardown
    def corrupted_teardown(self, timeout: float | None = None) -> None:
        """Destructor-during-unwinding: revoke + vote 0 (paper: 'the other cases are
        when the communicator object is deconstructed during stack unwinding...')."""
        if not self.alive:
            return
        try:
            self.signal_error(ErrorCode.COMM_CORRUPTED, corrupted=True,
                              timeout=self._t(timeout), reraise=False)
        finally:
            self.alive = False

    def shrink_to_survivors(self, timeout: float | None = None) -> CommContext:
        """Recovery aid after ``CommCorruptedError``: agree + shrink among survivors.

        This is the paper's use-case 1 (LFLR): 'clear the broken communicator and
        create a new one with a reduced number of processors'.
        """
        new_comm = self.ctx.shrink(self.comm, timeout=self._t(timeout))
        self.comm = new_comm
        self.alive = True
        return new_comm

    def close(self) -> None:
        self.alive = False
