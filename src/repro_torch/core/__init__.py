from .detect import SERVE_PROBES, ProbeConfig, logits_probe  # noqa: F401
from .device_channel import DeviceFuture, readback  # noqa: F401
from .errors import (  # noqa: F401
    CommCorruptedError,
    ErrorCode,
    PropagatedError,
    RankError,
)
from .recovery import Action, RecoveryDecision, RecoveryPolicy  # noqa: F401
