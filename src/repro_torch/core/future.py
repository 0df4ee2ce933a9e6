# Copy of repro/core/future.py.
"""Future abstractions (paper §III-A: the ``Future`` class).

Two flavours:

* :class:`Future` — wraps a transport :class:`~repro_torch.core.transport.Request` (or a
  thread-backed :class:`AsyncOp` for collectives) plus the error channel of its
  ``Comm``. ``wait()`` is the paper's single choke point: it returns normally only if
  the operation completed *and* no error was signalled; otherwise it raises
  ``PropagatedError`` / ``CommCorruptedError`` / ``RevokedError`` / ``MpiError``.
* :class:`DeviceFuture` — the JAX adaptation: wraps the dispatched (asynchronous)
  outputs of a jitted step together with the in-band error word.  ``wait()`` blocks on
  the error word only (4 bytes), decodes it, and raises exactly the same exception
  types. See ``core/device_channel.py``.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Optional

from .errors import CancelledError, MpiError
from .transport import ReqState, Request


class AsyncOp:
    """A thread-backed non-blocking operation (used for collectives).

    The paper (§IV-B) notes that non-blocking *collectives* cannot be cancelled
    (``MPI_Cancel`` is erroneous for them) and therefore leak buffers/requests when a
    communicator is abandoned after an error. This class reproduces those semantics
    deliberately: an abandoned ``AsyncOp`` keeps its daemon thread and payload alive
    until the underlying collective completes — which, for an abandoned communicator,
    may be never. ``Transport.leaked_ops`` accounting in tests relies on this.
    """

    def __init__(self, transport, fn: Callable[[], Any]):
        self._t = transport
        self.state = ReqState.PENDING
        self.data: Any = None
        self.error: Optional[Exception] = None
        self.kind = "collective"

        def runner():
            try:
                self.data = fn()
                self.state = ReqState.COMPLETE
            except Exception as e:  # noqa: BLE001
                self.error = e
                self.state = ReqState.FAILED
            with self._t._cv:
                self._t._cv.notify_all()

        self._thread = threading.Thread(target=runner, daemon=True)
        self._thread.start()

    @property
    def done(self) -> bool:
        return self.state is not ReqState.PENDING


class Future:
    """Handle to one non-blocking operation on a ``Comm`` (paper Listing 1)."""

    def __init__(self, comm=None, request: Request | AsyncOp | None = None):
        self._comm = comm
        self._request = request
        self._waited = False

    @property
    def request(self):
        return self._request

    def valid(self) -> bool:
        return self._request is not None

    def test(self) -> bool:
        """Non-blocking completion probe (no error-channel handling)."""
        return self._request is not None and self._request.done

    def wait(self, timeout: float | None = None) -> Any:
        """Block until the operation completes or an error is delivered.

        Returns the received payload for receives, the reduction result for
        collectives, ``None`` for sends. Raises the paper's exception taxonomy.
        """
        if self._request is None:
            return None
        if self._waited:
            return self._payload()
        self._comm._protocol.wait(self._request, timeout=timeout)
        self._waited = True
        return self._payload()

    def _payload(self) -> Any:
        r = self._request
        if r.state is ReqState.CANCELLED:
            raise CancelledError("request was cancelled")
        if r.state is ReqState.FAILED and r.error is not None:
            raise r.error
        if getattr(r, "kind", None) in ("recv", "collective"):
            return r.data
        return None

    def cancel(self) -> bool:
        if isinstance(self._request, Request):
            return self._comm._ctx.cancel(self._request)
        return False  # paper §IV-B: collectives cannot be cancelled
