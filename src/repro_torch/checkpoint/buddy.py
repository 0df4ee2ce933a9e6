"""Buddy (peer-redundant, in-memory) store — the LFLR substrate.

The port of ``repro/checkpoint/buddy.py``. Paper use case 1 (Teranishi &
Heroux LFLR; Huber et al. multigrid recovery): a failed rank's state is
recovered from *surviving* memory instead of a global disk rollback. Each
rank pushes a copy of its shard to its buddy (``(rank + 1) % n``) every
``interval`` steps; after a shrink, survivors reconstruct the lost rank's
shard from the buddy copy.

In the simulated multi-controller runtime the "remote memories" live in one
process, so the store is a thread-safe dict keyed by rank. A pushed shard is
copied to host numpy arrays at once: a later in-place update of the pushed
tensor (an optimizer step on the card) cannot change the stored copy.
"""
from __future__ import annotations

import threading
from typing import Any, Optional

import numpy as np
import torch

from ..tree import tree_map


def _host_copy(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy().copy()
    return np.array(x)


class BuddyStore:
    def __init__(self, world_size: int, *, stride: int = 1):
        self.world_size = world_size
        self.stride = stride
        self._lock = threading.Lock()
        # buddy memory: rank -> (step, host tree of that rank's shard)
        self._mem: dict[int, tuple[int, Any]] = {}

    def buddy_of(self, rank: int) -> int:
        return (rank + self.stride) % self.world_size

    def push(self, rank: int, step: int, shard) -> None:
        """Rank pushes its shard to its buddy's memory."""
        host = tree_map(_host_copy, shard)
        with self._lock:
            self._mem[rank] = (step, host)

    def recover(self, failed_rank: int) -> Optional[tuple[int, Any]]:
        """Survivors fetch the last pushed copy of the failed rank's shard."""
        with self._lock:
            return self._mem.get(failed_rank)

    def drop(self, rank: int) -> None:
        with self._lock:
            self._mem.pop(rank, None)

    def ranks_covered(self) -> list[int]:
        with self._lock:
            return sorted(self._mem)
