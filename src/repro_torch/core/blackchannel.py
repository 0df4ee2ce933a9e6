# Copy of repro/core/blackchannel.py.
"""The Black-Channel protocol — faithful implementation of paper §III-B.

Requires only MPI-3.0-level primitives (here: :class:`~repro_torch.core.transport.RankCtx`):

* construction duplicates the user communicator into an *error communicator*
  (``comm_err``) and pre-posts one wildcard non-blocking receive (``err_req``);
* ``signal_error`` posts a matching synchronous-mode send (``MPI_Issend``) to every
  other rank and cancels the local ``err_req``;
* every wait is ``MPI_Waitany({request, err_req})`` so a rank blocked in communication
  is released the moment any peer signals — this *precludes the deadlock* that a local
  exception would otherwise cause;
* the rendezvous is ``barrier → allreduce(BAND)`` (corrupted-communicator vote), then
  the failed-rank enumeration: ``scan(SUM)`` assigns each signaller an index,
  ``bcast`` from the last rank publishes the count, and ``allreduce(MAX)`` over a
  zero-initialised table delivers every ``(rank, code)`` pair to every rank.
"""
from __future__ import annotations

from typing import Optional, Sequence

from .errors import (
    CommCorruptedError,
    ErrorCode,
    MpiError,
    PropagatedError,
    RankError,
)
from .transport import ANY_SOURCE, CommContext, RankCtx, ReqState, Request

ERR_TAG = 999


class _ErrOutcome(Exception):
    """Internal: carries the protocol outcome through the common error path."""

    def __init__(self, exc: Exception):
        self.exc = exc


class BlackChannel:
    """Per-rank protocol state for one communicator (paper Fig. 1 ``Comm`` internals)."""

    def __init__(self, ctx: RankCtx, base: CommContext,
                 default_timeout: float | None = None):
        self.ctx = ctx
        self.comm = base
        # paper: "The constructor of the Comm object duplicates the MPI communicator
        # by calling MPI_Comm_dup. The new communicator is called comm_err."
        self.err_comm = ctx.dup(base)
        self.err_req: Optional[Request] = None
        self.alive = True           # False once the communicator is corrupted
        self.default_timeout = default_timeout
        self._tracked: list[Request] = []   # outstanding user requests on this comm
        self._post_err_recv()

    # ------------------------------------------------------------------ plumbing
    def _post_err_recv(self) -> None:
        # paper: "In comm_err we create a non-blocking receive operation via
        # MPI_Irecv and store the pending request in err_req."
        self.err_req = self.ctx.irecv(self.err_comm, ANY_SOURCE, ERR_TAG)

    @property
    def rank(self) -> int:
        return self.comm.local_rank(self.ctx.rank)

    @property
    def size(self) -> int:
        return self.comm.size

    def _t(self, timeout):
        return timeout if timeout is not None else self.default_timeout

    def track(self, req: Request) -> Request:
        """Register a user request so an error epoch can drain it (a request
        abandoned by an exception must not steal a post-recovery match)."""
        self._tracked = [r for r in self._tracked if not r.done]
        self._tracked.append(req)
        return req

    def _drain_tracked(self) -> None:
        for r in self._tracked:
            if not r.done:
                self.ctx.cancel(r)
        self._tracked.clear()

    def post(self, fn):
        """Issue an operation on the user communicator (no ULFM error surface in
        MPI-3.0 mode; kept symmetric with :class:`UlfmChannel.post`)."""
        if not self.alive:
            raise CommCorruptedError(msg="operation on corrupted communicator")
        return fn(self.comm)

    # ------------------------------------------------------------------- waiting
    def wait(self, request, timeout: float | None = None) -> None:
        """Paper: ``MPI_Waitany`` over {request, err_req}; on completion of the user
        request, additionally ``MPI_Test`` the error request."""
        if not self.alive:
            raise CommCorruptedError(msg="wait on corrupted communicator")
        timeout = self._t(timeout)
        idx, r = self.ctx.waitany([request, self.err_req], timeout=timeout)
        if idx == 0:
            if r.state is ReqState.FAILED:
                raise MpiError(-1, f"request failed: {r.error}") from r.error
            # "if MPI_Waitany completes request, the method uses MPI_Test to check
            # whether an error was signaled"
            if self.ctx.test(self.err_req):
                self._enter_error_state(timeout=timeout)
            return
        # err_req completed: an error was signalled remotely
        self._enter_error_state(timeout=timeout)

    # ------------------------------------------------------------------ signalling
    def signal_error(self, code: int | ErrorCode, *, corrupted: bool = False,
                     timeout: float | None = None, reraise: bool = True) -> None:
        """Paper: propagate a local error to all remote ranks.

        ``corrupted=True`` is the destructor-during-stack-unwinding path: this rank
        votes 0 in the BAND allreduce and every rank throws ``CommCorruptedError``.
        Otherwise every rank (including this one) throws ``PropagatedError`` carrying
        all (rank, code) pairs.
        """
        if not self.alive:
            raise CommCorruptedError(msg="signal_error on corrupted communicator")
        self._enter_error_state(signal=(int(code), corrupted),
                                timeout=self._t(timeout), reraise=reraise)

    # ---------------------------------------------------------------- error state
    def _enter_error_state(self, signal: tuple[int, bool] | None = None,
                           timeout: float | None = None,
                           reraise: bool = True) -> None:
        ctx, err = self.ctx, self.err_comm
        my_rank, size = err.local_rank(ctx.rank), err.size
        am_signaller = signal is not None
        my_code, corrupted = signal if signal is not None else (0, False)

        # Drain abandoned user requests *before* the barrier: every rank drains
        # before any rank can exit the epoch (the allreduce is the fence), so a
        # stale posted receive can never steal a post-recovery message.
        self._drain_tracked()

        send_reqs: list[Request] = []
        if am_signaller:
            # "The function signal_error issues a matching MPI_Issend for err_req to
            # all other ranks and cancels its own err_req. It uses the non-blocking
            # operation since it is possible that two ranks simultaneously propagate
            # errors."
            for dst in range(size):
                if dst != my_rank:
                    send_reqs.append(
                        ctx.issend(err, dst, ERR_TAG, (my_rank, my_code)))
            ctx.cancel(self.err_req)  # may fail if a peer signalled concurrently — fine

        # "Once all error messages have been send or a rank receives an error
        # message, it calls MPI_Barrier to wait for all ranks being in the error
        # state."
        ctx.barrier(err, timeout=timeout)

        # "When all ranks reach the barrier, the propagating ranks cancel the pending
        # send requests, which are the send requests to the ranks that got signaled
        # by another rank."
        for s in send_reqs:
            ctx.cancel(s)

        # "Then all ranks perform an MPI_Allreduce operation with an MPI_BAND operator
        # to determine if the communicator is corrupted, i.e. signal_error was called
        # by the destructor of Comm during stack unwinding."
        ok = ctx.allreduce(err, 0 if corrupted else 1, op="band", timeout=timeout)
        if ok == 0:
            self.alive = False
            exc: Exception = CommCorruptedError()
        else:
            errors = self._enumerate_failed(am_signaller, my_code, timeout)
            # channel survives a recoverable (propagated) error: re-arm for reuse
            self._post_err_recv()
            exc = PropagatedError(errors)
        if reraise:
            raise exc

    def _enumerate_failed(self, am_signaller: bool, my_code: int,
                          timeout: float | None) -> list[RankError]:
        """Paper §III-B, 'Determine failed ranks and codes'."""
        ctx, err = self.ctx, self.err_comm
        my_rank, size = err.local_rank(ctx.rank), err.size
        flag = 1 if am_signaller else 0
        # "we do an MPI_Scan with the operation MPI_SUM, where failed ranks
        # participate with a 1 ... This assigns every failed node an index."
        idx = ctx.scan(err, flag, op="sum", timeout=timeout)
        # "The number of failed nodes is then propagated by an MPI_Bcast of the last
        # rank."
        count = ctx.bcast(err, idx if my_rank == size - 1 else None,
                          root=size - 1, timeout=timeout)
        # "Now all ranks allocate memory for the rank numbers and error codes of the
        # failed ranks and initialise it with zeros. The failed ranks write their rank
        # number and error code ... with respect to their index. Finally an
        # MPI_Allreduce with MPI_MAX is performed to propagate all the information."
        table = [0] * (2 * count)
        if am_signaller:
            k = idx - 1
            table[2 * k] = my_rank
            table[2 * k + 1] = my_code
        table = ctx.allreduce(err, table, op="emax", timeout=timeout)
        return [RankError(rank=table[2 * i], code=table[2 * i + 1])
                for i in range(count)]

    # ------------------------------------------------------------------ teardown
    def corrupted_teardown(self, timeout: float | None = None) -> None:
        """Destructor-during-unwinding path (swallows the resulting exception so the
        original user exception keeps unwinding, like a C++ destructor must)."""
        if not self.alive:
            return
        try:
            self.signal_error(ErrorCode.COMM_CORRUPTED, corrupted=True,
                              timeout=self._t(timeout), reraise=False)
        finally:
            self.alive = False

    def close(self) -> None:
        """Orderly destruction (no unwinding): cancel the pre-posted receive."""
        if self.err_req is not None and not self.err_req.done:
            self.ctx.cancel(self.err_req)
        self.alive = False
