# Trimmed copy of repro/core/errors.py: the code lattice and the paper's exception taxonomy.
"""Exception hierarchy and error-code lattice (paper §III-A).

* ``PropagatedError``    <- ``MPICXX::Propagated_exception``: one or more
  ranks (here: serving slots) signalled a recoverable error; carries every
  ``(rank, code)`` pair;
* ``CommCorruptedError`` <- ``MPICXX::Comm_corrupted_exception``: the
  communicator is unusable;
* ``MpiError``           <- ``MPICXX::MPI_error_exception``: any other
  transport error, with its raw status;
* ``RevokedError``       <- ULFM ``MPI_ERR_COMM_REVOKED``;
* ``RankFailedError``    <- ULFM ``MPI_ERR_PROC_FAILED``: a peer is dead.

:class:`ErrorCode` is the device-representable bitmask the in-band channel
reduces with bitwise-or. The highest code is ``COMM_CORRUPTED = 1 << 25``, so
a word never sets the sign bit of an ``int32`` — the port keeps words as
``int32`` on the device and casts to ``uint32`` at readback.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np


class ErrorCode(enum.IntFlag):
    """Bitmask of fault classes; codes combine with ``|``."""

    OK = 0
    # -- soft faults: numerical ---------------------------------------------------
    NONFINITE_LOSS = 1 << 0        # NaN/Inf in the scalar loss (serving: logits)
    NONFINITE_GRAD = 1 << 1        # NaN/Inf anywhere in the gradient pytree
    NONFINITE_PARAM = 1 << 2       # NaN/Inf in parameters (post-update check)
    OVERFLOW = 1 << 3              # |value| above overflow threshold
    DIVERGENCE = 1 << 4            # loss above divergence threshold
    # -- soft faults: data / algorithm -------------------------------------------
    DATA_FAULT = 1 << 5            # pipeline produced out-of-range / corrupt batch
    ROUTER_OVERFLOW = 1 << 6       # MoE: token dropped-fraction above threshold
    STATE_FAULT = 1 << 7           # SSM / RG-LRU recurrent state non-finite
    USER = 1 << 8                  # user-signalled
    # -- structural / runtime -----------------------------------------------------
    STRAGGLER = 1 << 16            # step-time watchdog tripped on this rank
    CHECKPOINT_IO = 1 << 17        # async checkpoint write failed
    PAGE_FAULT = 1 << 18           # paged KV: write landed on an unmapped page
    # -- attribution-only lanes (never trigger recovery) --------------------------
    DRAFT_REJECT = 1 << 19         # speculative decode: drafted token rejected
    # -- hard faults (ULFM territory) ---------------------------------------------
    RANK_FAILED = 1 << 24          # peer process/node lost
    COMM_CORRUPTED = 1 << 25       # communicator destroyed during unwinding

    @property
    def is_hard(self) -> bool:
        """A hard fault (ULFM territory): a rank lost or a communicator
        destroyed; the rest are soft, survivable in place."""
        return bool(self & (ErrorCode.RANK_FAILED | ErrorCode.COMM_CORRUPTED))

    @property
    def is_soft(self) -> bool:
        return bool(self) and not self.is_hard

    def classes(self) -> list["ErrorCode"]:
        """Decompose a combined code into its constituent single-bit classes."""
        return [c for c in ErrorCode if c != ErrorCode.OK and c & self and c.value & (c.value - 1) == 0]


# Encoded "no error" word for device-side channels.
OK_WORD = 0

# Codes that attribute expected in-band events rather than faults.
ATTRIBUTION_ONLY = ErrorCode.DRAFT_REJECT


@dataclass(frozen=True)
class RankError:
    """One signalled error: which rank (slot), which code."""

    rank: int
    code: int

    @property
    def error_code(self) -> ErrorCode:
        return ErrorCode(self.code)

    def __str__(self) -> str:  # pragma: no cover - repr sugar
        return f"rank {self.rank}: {ErrorCode(self.code)!r}"


class ReproError(Exception):
    """Base class for all errors raised by this framework."""


class LocalError(ReproError):
    """A purely local failure detected before any propagation happened.

    Carries the code so the catch-site can decide to ``signal_error`` it (the
    paper's Listing 1 inner try/catch)."""

    def __init__(self, code: int | ErrorCode, msg: str = ""):
        self.code = int(code)
        super().__init__(msg or f"local error: {ErrorCode(self.code)!r}")


class PropagatedError(ReproError):
    """Rank(s) signalled a recoverable error (paper: ``Propagated_exception``)."""

    def __init__(self, errors: Iterable[RankError]):
        self.errors: tuple[RankError, ...] = tuple(errors)
        super().__init__(
            "propagated error(s): " + "; ".join(str(e) for e in self.errors)
        )

    @property
    def ranks(self) -> tuple[int, ...]:
        return tuple(e.rank for e in self.errors)

    @property
    def combined_code(self) -> ErrorCode:
        out = 0
        for e in self.errors:
            out |= e.code
        return ErrorCode(out)


class CommCorruptedError(ReproError):
    """The communicator is unusable (paper: ``Comm_corrupted_exception``)."""

    def __init__(self, errors: Iterable[RankError] = (), msg: str = ""):
        self.errors: tuple[RankError, ...] = tuple(errors)
        super().__init__(msg or ("communicator corrupted: " + "; ".join(str(e) for e in self.errors) if self.errors else "communicator corrupted"))


class RevokedError(ReproError):
    """Operation on a revoked communicator (ULFM ``MPI_ERR_COMM_REVOKED``)."""

    def __init__(self, msg: str = "communicator revoked"):
        super().__init__(msg)


class RankFailedError(ReproError):
    """A peer involved in this operation is dead (ULFM ``MPI_ERR_PROC_FAILED``)."""

    def __init__(self, failed_ranks: Sequence[int] = (), msg: str = ""):
        self.failed_ranks = tuple(failed_ranks)
        super().__init__(msg or f"rank(s) failed: {list(self.failed_ranks)}")


class MpiError(ReproError):
    """Any other transport error (paper: ``MPI_error_exception``)."""

    def __init__(self, status: int, msg: str = ""):
        self.status = status
        super().__init__(msg or f"transport error, status={status}")


class CancelledError(ReproError):
    """A request was cancelled (``MPI_Cancel`` analogue)."""


class TimeoutError_(ReproError):
    """A wait exceeded its deadline (used by the straggler watchdog)."""


def combine_codes(codes: Iterable[int]) -> int:
    out = 0
    for c in codes:
        out |= int(c)
    return out


def strip_codes(words, ignore: int = 0):
    """Mask ``ignore`` code bits out of an error word (python int) or a
    host word array (numpy)."""
    if not ignore:
        return words
    keep = np.uint32(~np.uint32(ignore & 0xFFFFFFFF))
    if isinstance(words, int):
        return words & int(keep)
    return words & keep
