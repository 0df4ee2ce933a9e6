"""Device-side error channel: error words, enumeration, the DeviceFuture.

The port of ``repro/core/device_channel.py`` for one device. Every serving
step computes an ``int32`` error word per slot on the device (the
:class:`~repro_torch.core.errors.ErrorCode` lattice; bit 31 is never set);
the host wraps the dispatched outputs in a :class:`DeviceFuture` whose
``wait()`` reads the combined word and the paper's ``(rank, code)``
enumeration table back in ONE device-to-host copy and raises the paper's
exceptions. Words become ``np.uint32`` at readback, so decoding and the
recovery policy see the JAX package's values.

Every device-to-host copy of the port goes through :func:`readback`, whose
``count`` is the port's host-sync counter (the JAX tests' ``count_syncs``).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from .errors import (
    CommCorruptedError,
    ErrorCode,
    PropagatedError,
    RankError,
    TimeoutError_,
    strip_codes,
)

# static capacity of the (rank, code) table; errors beyond it are still
# reported through the combined word, only unattributed
MAX_ERRORS = 8

WORD_DTYPE = torch.int32
_WORD_BITS = 31            # codes stop at 1 << 25: the sign bit is never set


_COUNT_LOCK = threading.Lock()


def readback(t: torch.Tensor) -> np.ndarray:
    """Copy ``t`` to the host as numpy — for a CUDA tensor a host sync.
    The only device-to-host path of the port; ``readback.count`` counts
    the calls, atomically (a serve group's rank threads read back at
    once)."""
    with _COUNT_LOCK:
        readback.count += 1
    return t.detach().cpu().numpy()


readback.count = 0


def or_reduce(words: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise-or fold of int32 words over ``dim`` (non-negative), on the
    device, as a max over the 31 bit planes."""
    shifts = torch.arange(_WORD_BITS, device=words.device, dtype=WORD_DTYPE)
    bits = (words.to(WORD_DTYPE).unsqueeze(-1) >> shifts) & 1
    return (bits.amax(dim=dim) << shifts).sum(dim=-1, dtype=WORD_DTYPE)


def combine_words(*words: torch.Tensor) -> torch.Tensor:
    """Bitwise-or of error words (associative, commutative, idempotent)."""
    out = torch.zeros((), dtype=WORD_DTYPE, device=words[0].device)
    for w in words:
        out = out | w.to(WORD_DTYPE)
    return out


def enumerate_errors_ref(words: torch.Tensor, max_errors: int = MAX_ERRORS):
    """The paper's enumeration (§III-B) over one array of per-rank words:
    ``(count, table)`` with ``table[i] = (rank, code)`` for the i-th failed
    rank in rank order and zero rows beyond ``count``. A cumsum gives each
    failed rank its row and one scatter writes the rows — no loop, no sync
    (ranks past ``max_errors`` go to a spare row that is dropped)."""
    w = words.to(WORD_DTYPE)
    n = w.shape[0]
    failed = (w != 0).to(WORD_DTYPE)
    idx = torch.cumsum(failed, dim=0, dtype=WORD_DTYPE) - 1
    count = failed.sum(dtype=WORD_DTYPE)
    write = (failed == 1) & (idx < max_errors)
    dest = torch.where(write, idx, torch.full_like(idx, max_errors)).long()
    rows = torch.stack([torch.arange(n, device=w.device, dtype=WORD_DTYPE), w],
                       dim=1)
    table = torch.zeros((max_errors + 1, 2), dtype=WORD_DTYPE, device=w.device)
    table.scatter_(0, dest[:, None].expand(n, 2), rows)
    return count, table[:max_errors]


def decode_table(count: int, table: np.ndarray) -> list[RankError]:
    out = []
    for i in range(min(int(count), table.shape[0])):
        out.append(RankError(rank=int(table[i, 0]), code=int(table[i, 1])))
    return out


def record_event(device: torch.device) -> Optional["torch.cuda.Event"]:
    """A CUDA event on the current stream (None on the CPU, where work is
    done when dispatch returns)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


@dataclass
class DeviceFuture:
    """Future over dispatched device work (the paper's ``Future``).

    ``outputs`` stay asynchronous; :meth:`wait` reads the error word (with
    the enumeration table) back in one copy and converts it to the paper's
    exceptions. A window future covers K deferred steps: ``word`` is the OR
    over the window and ``history`` the ``(K, ranks)`` per-step words, so
    :meth:`fault_steps` attributes a fault to its exact ``(step, rank)``.
    """

    outputs: Any
    word: torch.Tensor
    count: Optional[torch.Tensor] = None
    table: Optional[torch.Tensor] = None
    history: Optional[torch.Tensor] = None   # (K, ranks) per-step words
    event: Optional["torch.cuda.Event"] = None
    _waited: bool = False
    _history_host: Optional[np.ndarray] = None

    def wait(self, timeout: Optional[float] = None) -> Any:
        """Read the word back and raise the paper's exception for a fault.
        With ``timeout`` (seconds), first poll the work's event until it is
        done and raise :class:`TimeoutError_` past the deadline (the
        straggler watchdog's bound on one step); on the CPU, with no event,
        the work is done at dispatch."""
        if self._waited:
            return self.outputs
        if timeout is not None and self.event is not None:
            deadline = time.monotonic() + timeout
            while not self.event.query():
                if time.monotonic() > deadline:
                    raise TimeoutError_(f"device step exceeded {timeout}s "
                                        "(straggler watchdog)")
                time.sleep(0.001)
        parts = [self.word.reshape(1)]
        with_table = self.count is not None and self.table is not None
        if with_table:
            parts += [self.count.reshape(1), self.table.reshape(-1)]
        host = readback(torch.cat([p.to(WORD_DTYPE) for p in parts]))
        host = host.astype(np.uint32)
        self._waited = True
        word = int(host[0])
        if word == 0:
            return self.outputs
        errors = (decode_table(int(host[1]), host[2:].reshape(-1, 2))
                  if with_table else [])
        if with_table and not errors:
            errors = [RankError(rank=-1, code=word)]
        if word & ErrorCode.COMM_CORRUPTED:
            raise CommCorruptedError(errors)
        raise PropagatedError(errors or [RankError(rank=-1, code=word)])

    def result(self, timeout: Optional[float] = None) -> Any:
        return self.wait(timeout=timeout)

    def done(self) -> bool:
        """Non-blocking readiness probe (the paper's ``MPI_Test``): True iff
        ``wait()`` would not block — a CUDA ``Event.query()``."""
        return self._waited or self.event is None or self.event.query()

    def _host_history(self, ignore: int) -> Optional[np.ndarray]:
        """The ``(K, ranks)`` history on the host, read back once: the
        fault path's step attribution, its per-rank codes and the tracer's
        fault events share one copy."""
        if self.history is None:
            return None
        if self._history_host is None:
            self._history_host = readback(self.history).astype(np.uint32)
        return strip_codes(self._history_host, ignore)

    def fault_steps(self, *, ignore: int = 0) -> Optional[np.ndarray]:
        """Per-rank index of the first faulting window step, or -1 if clean
        (``ignore`` masks code bits out first). Steps before it are a clean,
        committable prefix."""
        hist = self._host_history(ignore)
        if hist is None:
            return None
        bad = hist != 0
        return np.where(bad.any(axis=0), bad.argmax(axis=0), -1).astype(np.int64)

    def fault_codes(self, *, ignore: int = 0) -> Optional[np.ndarray]:
        """Per-rank OR of the window history (never truncates, unlike the
        enumeration table); ``(ranks,)`` uint32."""
        hist = self._host_history(ignore)
        if hist is None:
            return None
        return np.bitwise_or.reduce(hist, axis=0).astype(np.uint32)
