from .ops import probe_rows  # noqa: F401
from .ref import probe_rows_ref  # noqa: F401
