# Device side of repro/launch/paging.py over the port's cache dict (tp_storage_specs not ported).
"""Paged KV pool: a page table over one shared page pool per K/V leaf.

Every decode slot of the contiguous layout holds one ``max_len`` block of
K/V, so a 16-token chat reserves what a 1024-token prompt does. Paging
scopes cache memory to what a sequence holds (the paper's move of scoping
state to the smallest recoverable unit, applied to memory):

* a K/V leaf whose capacity is ``max_len`` (a full layer's ``k``/``v``, and
  a sliding layer's ``k_ring``/``v_ring`` when ``max_len <= window``) is
  pooled into ``(layers, num_pages + 2, page_size, kv_heads, head_dim)``
  pages shared by all slots;
* a ``(slots, max_pages)`` int32 **page table** maps each slot's logical
  page to a physical page; an unassigned entry holds the sentinel
  ``num_pages``;
* rings of capacity below ``max_len`` and the recurrent state stay dense,
  one row per slot: every entry of theirs is always live.

The two extra pages are what keep every index in range. Page ``num_pages``
(the sentinel's own index) is a **zero page** that nothing writes: a
gather reads an unmapped entry from it, as zeros — the bits of a freshly
reset contiguous cache, so attention over the gathered view computes the
same bits (the JAX ``mode="fill", fill_value=0``). Page ``num_pages + 1``
is a **sink** that nothing reads: a scatter or scrub sends an unmapped
entry's write there, so a lane that owns no page writes nowhere another
lane could read (the JAX ``mode="drop"``). Any other id outside ``[0,
num_pages)`` is treated as the sentinel.

The pool is layer-major, so the gather of every slot's pages is one
``index_select`` whose output already has the contiguous leaf's shape,
dtype and memory layout ``(layers, slots, max_len, kv_heads, head_dim)``:
the flash wrappers read it as a cache.

:meth:`PagedLayout.probe` checks in-band that every page up to the one a
step writes is mapped, ORing ``PAGE_FAULT`` into the slot's word: ledger
corruption surfaces at the wait, like every other fault, and the LFLR
re-queue (free and re-acquire the pages) repairs it.

Ownership (free list, per-slot ledger, watermark admission, eviction) is
host logic in :class:`repro_torch.serve.scheduler.PageAllocator`; this
module is the device side only.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.errors import ErrorCode
from ..models.model import CACHE_LAYOUT, KV_LEAVES

# the K/V leaves a layout may page (every attention kind's pair)
KV_NAMES = frozenset(n for pair in KV_LEAVES.values() for n in pair)


def pages_for(n_tokens: int, page_size: int) -> int:
    """Physical pages needed to hold ``n_tokens`` cache positions."""
    return -(-max(int(n_tokens), 0) // page_size)


@dataclass(frozen=True)
class _LeafSpec:
    page_shape: tuple    # (layers, page_size, kv_heads, head_dim)
    dtype: torch.dtype


class PagedLayout:
    """Which cache leaves are pooled, and how to address them.

    Built from one per-slot cache (``model.init_cache(1, max_len)``). A
    leaf is **paged** iff it is a K/V leaf whose capacity axis (axis 2 of
    ``(layers, batch, cap, kv_heads, head_dim)``) has ``max_len`` entries,
    as the JAX layout's rule (``"k"``/``"v"`` keys of capacity ``max_len``,
    whichever attention kind holds them).
    """

    def __init__(self, slot_cache: dict, max_len: int, *, page_size: int,
                 num_pages: int):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if max_len % page_size != 0:
            raise ValueError(
                f"max_len ({max_len}) must be a multiple of page_size "
                f"({page_size}) so the gathered view is exactly the "
                "contiguous layout")
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        self.max_len = int(max_len)
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self.max_pages = max_len // page_size
        self.sentinel = self.num_pages           # the zero page's index
        self.sink = self.num_pages + 1
        # positions one sequence can ever hold state for: a pool smaller
        # than max_len bounds every lane (admission clamps to it too), and
        # growth or probing past it would demand pages that cannot exist
        self.capacity_tokens = min(self.max_len,
                                   self.num_pages * self.page_size)
        self._specs: dict[str, _LeafSpec] = {}
        for name, leaf in slot_cache.items():
            if self._leaf_is_paged(name, leaf):
                layers, _, _, *rest = leaf.shape
                self._specs[name] = _LeafSpec(
                    (layers, self.page_size, *rest), leaf.dtype)

    # ------------------------------------------------------------ classification
    def _leaf_is_paged(self, name: str, leaf: torch.Tensor) -> bool:
        return (name in KV_NAMES and leaf.dim() == 5
                and leaf.shape[2] == self.max_len)

    @property
    def has_paged_leaves(self) -> bool:
        return bool(self._specs)

    def is_paged_path(self, name: str) -> bool:
        return name in self._specs

    # ----------------------------------------------------------------- building
    def init_hybrid(self, slot_cache: dict, num_slots: int) -> dict:
        """The hybrid cache: paged leaves → zeroed pools ``(layers,
        num_pages + 2, page_size, ...)``, dense leaves → ``num_slots``
        copies of the per-slot leaf along its slot axis (the contiguous
        layout). The same leaf names as the contiguous cache."""
        out = {}
        for name, leaf in slot_cache.items():
            spec = self._specs.get(name)
            if spec is not None:
                layers, *page = spec.page_shape
                out[name] = torch.zeros((layers, self.num_pages + 2, *page),
                                        dtype=spec.dtype, device=leaf.device)
            else:
                axis = CACHE_LAYOUT[name].slot_axis
                shape = list(leaf.shape)
                shape[axis] = num_slots
                out[name] = leaf.expand(shape).clone()
        return out

    def empty_table(self, num_slots: int) -> np.ndarray:
        return np.full((num_slots, self.max_pages), self.sentinel, np.int32)

    # ------------------------------------------------------------ addressing
    def _ids(self, table: torch.Tensor, unmapped: int) -> torch.Tensor:
        """``table`` as int64 page ids, every entry outside ``[0,
        num_pages)`` sent to page ``unmapped`` (the zero page or the
        sink)."""
        t = table.long()
        return torch.where((t >= 0) & (t < self.num_pages), t,
                           torch.full_like(t, unmapped))

    def _read(self, pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        """The pages of ``table (..., max_pages)`` as ``(layers, ...,
        max_len, ...)``, contiguous; unmapped pages read as zeros."""
        ids = self._ids(table, self.sentinel)
        pages = pool.index_select(1, ids.reshape(-1))
        return pages.view(pool.shape[0], *table.shape[:-1], self.max_len,
                          *pool.shape[3:])

    def _write(self, pool: torch.Tensor, table: torch.Tensor,
               view: torch.Tensor) -> None:
        """Write ``view (layers, ..., max_len, ...)`` through ``table``;
        unmapped pages go to the sink."""
        ids = self._ids(table, self.sink).reshape(-1)
        pool.index_copy_(1, ids, view.reshape(
            pool.shape[0], ids.numel(), *pool.shape[2:]).to(pool.dtype))

    # ----------------------------------------------------------- gather/scatter
    def gather(self, hybrid: dict, table: torch.Tensor) -> dict:
        """Hybrid cache + ``(S, max_pages)`` table (a device tensor) → the
        contiguous per-slot cache, in shape, dtype, memory layout and
        **bits** (unmapped pages read as zeros). Dense leaves are the
        hybrid's own tensors, so a step's in-place writes land in them."""
        return {name: self._read(leaf, table) if name in self._specs else leaf
                for name, leaf in hybrid.items()}

    def scatter(self, hybrid: dict, views: dict, table: torch.Tensor) -> None:
        """Write the per-slot views back through the page table, in place;
        entries mapped to the sentinel are dropped — an unmapped lane
        writes nowhere."""
        for name, leaf in hybrid.items():
            if name in self._specs:
                self._write(leaf, table, views[name])
            elif views[name] is not leaf:
                leaf.copy_(views[name])

    def gather_slot(self, hybrid: dict, row: torch.Tensor, slot: int) -> dict:
        """One slot's cache at batch 1 (a new tensor per leaf): ``row`` is
        its ``(max_pages,)`` table row."""
        return {name: (self._read(leaf, row[None]) if name in self._specs
                       else leaf.narrow(CACHE_LAYOUT[name].slot_axis, slot,
                                        1).clone())
                for name, leaf in hybrid.items()}

    def scatter_slot(self, hybrid: dict, view: dict, row: torch.Tensor,
                     slot: int) -> None:
        """Write a batch-1 ``view`` back as slot ``slot``, in place."""
        for name, leaf in hybrid.items():
            if name in self._specs:
                self._write(leaf, row[None], view[name])
            else:
                leaf.narrow(CACHE_LAYOUT[name].slot_axis, slot, 1).copy_(
                    view[name])

    # ------------------------------------------------------------------- probes
    def probe(self, table: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """In-band page-ownership probe: per-slot int32 ``PAGE_FAULT`` word
        iff *any* logical page up to (and including) the one holding the
        slot's write position is unmapped — an unmapped write page drops
        the new K/V entry, and an unmapped earlier page reads as zeros, so
        both are table/ledger divergence that must surface at the wait.
        Free and deferred lanes are masked out by the caller's
        enumeration mask, like every other per-slot word."""
        if not self._specs:
            return torch.zeros(pos.shape, dtype=torch.int32, device=pos.device)
        # clamped to the pool's capacity: positions past it are over-decode
        # steps whose tokens are discarded at retirement, and their dropped
        # writes are no ledger divergence
        lp = pos.clamp(0, self.capacity_tokens - 1) // self.page_size
        live = (torch.arange(self.max_pages, device=pos.device)[None, :]
                <= lp[:, None])
        unmapped = (table < 0) | (table >= self.num_pages)
        bad = (live & unmapped).any(dim=1)
        return bad.to(torch.int32) * int(ErrorCode.PAGE_FAULT)

    # -------------------------------------------------------------- maintenance
    def scrub(self, hybrid: dict, page_ids: torch.Tensor) -> None:
        """Zero the given physical pages in every pool, in place (sentinel
        entries are dropped): the paged half of a lane's reset, queued on
        the device at (re)allocation, so a page recycled from a faulted or
        evicted sequence never leaks its state — NaNs included — to its
        next owner."""
        ids = self._ids(page_ids, self.sink).reshape(-1)
        for name in self._specs:
            hybrid[name].index_fill_(1, ids, 0)

    def reset_slot(self, hybrid: dict, slot: int) -> None:
        """Zero slot ``slot``'s row of the *dense* leaves, in place (the
        fresh per-slot cache is all zeros); pools are untouched — their
        reset is :meth:`scrub` of the slot's pages."""
        for name, leaf in hybrid.items():
            if name not in self._specs:
                leaf.narrow(CACHE_LAYOUT[name].slot_axis, slot, 1).zero_()

    # -------------------------------------------------------------- accounting
    def page_bytes(self) -> int:
        """Device bytes of ONE physical page across all pooled leaves."""
        return sum(int(np.prod(s.page_shape)) * s.dtype.itemsize
                   for s in self._specs.values())

    def pool_bytes(self) -> int:
        """Bytes of the ``num_pages`` pages (the zero page and the sink,
        two pages more, are not counted)."""
        return self.num_pages * self.page_bytes()

    def contiguous_paged_bytes_per_slot(self) -> int:
        """Bytes ONE slot's paged leaves occupy in the contiguous layout
        (= ``max_pages`` pages) — the equal-memory comparison baseline."""
        return self.max_pages * self.page_bytes()
