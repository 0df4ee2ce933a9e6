# Trimmed copy of repro/core/faults.py: only the injectable-code mask the replica validates against.
"""Which :class:`ErrorCode` bits may be injected as in-band fault words."""
from __future__ import annotations

from .errors import ATTRIBUTION_ONLY, ErrorCode

# every defined soft / structural class except the attribution-only lanes
# (injecting DRAFT_REJECT as a fault would make a reject-only window raise)
# and the hard-fault bits (a word cannot take a rank down)
_DEFINED_MASK = 0
for _c in ErrorCode:
    _DEFINED_MASK |= _c.value
_HARD_MASK = int(ErrorCode.RANK_FAILED | ErrorCode.COMM_CORRUPTED)
INJECTABLE_CODE_MASK = _DEFINED_MASK & ~int(ATTRIBUTION_ONLY) & ~_HARD_MASK
