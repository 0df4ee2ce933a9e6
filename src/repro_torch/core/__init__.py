"""Core: the paper's contribution — exception propagation, asynchrony and
fault handling.

Host level: ``Instance``/``Comm``/``Future`` over a multi-rank transport with
Black-Channel (MPI-3.0-only) and ULFM protocol backends. Device level: the
in-band error word and ``DeviceFuture``, and the recovery policy.
"""
from .blackchannel import ERR_TAG, BlackChannel  # noqa: F401
from .comm import Comm  # noqa: F401
from .detect import SERVE_PROBES, ProbeConfig, logits_probe  # noqa: F401
from .device_channel import (  # noqa: F401
    MAX_ERRORS,
    DeviceFuture,
    combine_words,
    decode_table,
    enumerate_errors_ref,
    readback,
)
from .errors import (  # noqa: F401
    OK_WORD,
    CancelledError,
    CommCorruptedError,
    ErrorCode,
    LocalError,
    MpiError,
    PropagatedError,
    RankError,
    RankFailedError,
    ReproError,
    RevokedError,
    TimeoutError_,
    combine_codes,
    strip_codes,
)
from .faults import FaultSchedule, FaultSpec  # noqa: F401
from .future import AsyncOp, Future  # noqa: F401
from .instance import Instance, initialize  # noqa: F401
from .recovery import Action, RecoveryDecision, RecoveryPolicy  # noqa: F401
from .resilient import Event, EventLog  # noqa: F401
from .transport import (  # noqa: F401
    ANY_SOURCE,
    ANY_TAG,
    RankCtx,
    RankResult,
    Transport,
    run_ranks,
)
from .ulfm import UlfmChannel  # noqa: F401
