from .adamw import (  # noqa: F401
    AdamWConfig,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    init_opt_state,
    reset_moments,
    schedule,
)
