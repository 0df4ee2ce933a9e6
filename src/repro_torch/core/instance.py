# Copy of repro/core/instance.py.
"""``Instance`` singleton (paper §III-A).

The paper wraps ``MPI_Init``/``MPI_Finalize`` in a singleton so that initialisation
happens exactly once and finalisation only if this object performed the init. In the
simulated multi-rank runtime the "process" is a rank thread, so the singleton is
per-(transport, rank).
"""
from __future__ import annotations

import threading
from typing import Optional

from .comm import Comm
from .errors import MpiError
from .transport import RankCtx

_registry: dict[tuple[int, int], "Instance"] = {}
_registry_lock = threading.Lock()


class Instance:
    """Per-rank runtime instance; owns ``comm_world``."""

    def __init__(self, ctx: RankCtx, *, default_timeout: float | None = None):
        self._ctx = ctx
        self._finalized = False
        self._world: Optional[Comm] = None
        self._default_timeout = default_timeout

    def comm_world(self) -> Comm:
        if self._finalized:
            raise MpiError(-1, "instance already finalized")
        if self._world is None:
            self._world = Comm(self._ctx, self._ctx.world,
                               default_timeout=self._default_timeout)
        return self._world

    @property
    def rank(self) -> int:
        return self._ctx.rank

    @property
    def size(self) -> int:
        return self._ctx.world.size

    def finalize(self) -> None:
        if self._world is not None:
            self._world.close()
        self._finalized = True
        with _registry_lock:
            _registry.pop((id(self._ctx.t), self._ctx.rank), None)

    def __enter__(self) -> "Instance":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.finalize()
        return False


def initialize(ctx: RankCtx, *, default_timeout: float | None = None) -> Instance:
    """Idempotent per-rank initialisation (paper: 'The constructor checks if MPI is
    already initialised')."""
    key = (id(ctx.t), ctx.rank)
    with _registry_lock:
        inst = _registry.get(key)
        if inst is None or inst._finalized:
            inst = Instance(ctx, default_timeout=default_timeout)
            _registry[key] = inst
        return inst
