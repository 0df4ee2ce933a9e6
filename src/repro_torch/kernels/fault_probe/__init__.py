from .ops import probe_rows, probe_tree  # noqa: F401
from .ref import probe_rows_ref, probe_tree_ref  # noqa: F401
