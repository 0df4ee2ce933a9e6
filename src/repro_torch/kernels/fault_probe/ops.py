"""Wrappers of the fault-probe kernel (``csrc/fault_probe.cu``).

A tensor on the CPU goes to the plain version (``ref.py``); a CUDA tensor
goes to the kernel or raises — there is no fallback.

The kernel reads segments (a pointer, an element count, a dtype) cut into
chunks of ``CHUNK_BYTES``; :func:`plan_tree` lays a tree's leaves out as the
kernel walks them (each leaf's head up to its first 16-byte boundary, its
chunk count, the prefix sum of the counts, the split into launches of at
most ``MAX_LEAVES`` leaves), in plain Python that the CPU tests reach.
"""
from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass

import torch

from ...tree import tree_leaves
from ..build import (DTYPE_CODES, check_device, check_launch, count_launch,
                     library, run_plain, stream_of)
from .ref import probe_rows_ref, probe_tree_ref

MAX_ROWS = 2 ** 31 - 1          # rows cross the C boundary as an int
CHUNK_BYTES = 32 * 1024         # the kernel's kChunkBytes
VECTOR_BYTES = 16               # one vector load
MAX_LEAVES = 1024               # the kernel's kMaxLeaves: one table's leaves
ELEMENT_BYTES = {0: 4, 1: 2}    # by dtype code

_COPY_LOCK = threading.Lock()


def _check_codes(name: str, *codes: int) -> None:
    for code in codes:
        if not 0 <= int(code) < 2 ** 31:
            raise ValueError(f"{name}: code {code} does not fit an int32 word")


def probe_rows(x: torch.Tensor, threshold: float, *, nonfinite_code: int,
               overflow_code: int) -> torch.Tensor:
    """Error word per row of ``x (R, N)`` as an int32 ``(R,)`` tensor.

    Each word is what the TPU kernel ``probe_rows`` computes over that row's
    values; with ``R = 1`` it is the TPU kernel's word over the whole stream.
    Rows may hold more than 2^31 elements (the kernel indexes in 64 bits).
    On the card: one launch, which zeroes its own words (no fill launch).
    """
    kind = check_device("probe_rows", x)
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"probe_rows: x must be (rows, cols), got {tuple(x.shape)}")
    if x.shape[0] > MAX_ROWS:
        raise ValueError(f"probe_rows: {x.shape[0]} rows exceed the kernel's "
                         f"{MAX_ROWS}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"probe_rows: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("probe_rows: x must be contiguous")
    _check_codes("probe_rows", nonfinite_code, overflow_code)
    if kind == "cpu":
        return run_plain(probe_rows, probe_rows_ref, x, threshold,
                         nonfinite_code=nonfinite_code,
                         overflow_code=overflow_code)
    rows, cols = x.shape
    out = torch.empty((rows,), dtype=torch.int32, device=x.device)
    rc = library().repro_probe_rows(
        x.data_ptr(), rows, cols, DTYPE_CODES[x.dtype], float(threshold),
        int(nonfinite_code), int(overflow_code), out.data_ptr(), stream_of(x))
    check_launch("probe_rows", rc)
    count_launch(probe_rows)
    return out


probe_rows.launches = 0


def head_elements(ptr: int, count: int, code: int) -> int:
    """Elements of a segment at ``ptr`` before its first 16-byte boundary
    (read as scalars by its first chunk), at most ``count``."""
    return min(count, (-ptr % VECTOR_BYTES) // ELEMENT_BYTES[code])


def leaf_chunks(ptr: int, count: int, code: int) -> int:
    """The kernel's chunks of one segment: its whole vectors after the head,
    ``CHUNK_BYTES`` a chunk, at least one (which also reads the head and
    the tail)."""
    body = count - head_elements(ptr, count, code)
    per_chunk = CHUNK_BYTES // ELEMENT_BYTES[code]
    return max(1, -(-body // per_chunk))


@dataclass(frozen=True)
class TreeLaunch:
    """One launch's table: the leaves' pointers, element counts, dtype
    codes and the inclusive prefix sum of their chunk counts."""
    ptrs: tuple
    counts: tuple
    dtypes: tuple
    chunk_ends: tuple

    def arrays(self):
        """The table as the C entry takes it (host arrays)."""
        n = len(self.ptrs)
        return ((ctypes.c_longlong * n)(*self.ptrs),
                (ctypes.c_longlong * n)(*self.counts),
                (ctypes.c_int * n)(*self.dtypes),
                (ctypes.c_longlong * n)(*self.chunk_ends))


def plan_tree(segments) -> list:
    """``[(ptr, count, dtype code), ...]`` (each count >= 1) → the
    :class:`TreeLaunch` es that probe them, ``MAX_LEAVES`` leaves a launch."""
    launches = []
    for i in range(0, len(segments), MAX_LEAVES):
        group = segments[i:i + MAX_LEAVES]
        ends, total = [], 0
        for ptr, count, code in group:
            total += leaf_chunks(ptr, count, code)
            ends.append(total)
        launches.append(TreeLaunch(*(tuple(v) for v in zip(*group)), tuple(ends)))
    return launches


def tree_segments(leaves) -> list:
    """The kernel's segments of ``leaves``: ``(ptr, count, dtype code)`` of
    each floating leaf that holds elements (non-floating leaves are skipped,
    as the reference skips them); raises on a floating dtype the kernel does
    not take. The leaves it keeps must be contiguous."""
    segments = []
    for leaf in leaves:
        if not torch.is_floating_point(leaf) or leaf.numel() == 0:
            continue
        if leaf.dtype not in DTYPE_CODES:
            raise TypeError(f"probe_tree: unsupported dtype {leaf.dtype}")
        segments.append((leaf.data_ptr(), leaf.numel(), DTYPE_CODES[leaf.dtype]))
    return segments


def probe_tree(tree, threshold: float, *, nonfinite_code: int,
               overflow_code: int) -> torch.Tensor:
    """One int32 word over every floating leaf of ``tree`` (0-d, on the
    leaves' device, no host sync): the reference's ``probe_tree``, the OR of
    each leaf's word. On the card one launch for up to ``MAX_LEAVES``
    leaves (the first zeroes the word), no fill launch. A non-contiguous
    leaf is copied first (``probe_tree.copies`` counts them)."""
    leaves = tree_leaves(tree)
    _check_codes("probe_tree", nonfinite_code, overflow_code)
    kind = check_device("probe_tree", *leaves) if leaves else "cpu"
    probed = [leaf for leaf in leaves
              if torch.is_floating_point(leaf) and leaf.numel()]
    if kind == "cuda":
        copies = sum(not leaf.is_contiguous() for leaf in probed)
        if copies:
            with _COPY_LOCK:
                probe_tree.copies += copies
        # a copy is freed after the launch, in stream order
        probed = [leaf.contiguous() for leaf in probed]
    segments = tree_segments(probed)
    if kind == "cpu":
        return run_plain(probe_tree, probe_tree_ref, leaves, threshold,
                         nonfinite_code=nonfinite_code,
                         overflow_code=overflow_code)
    out = torch.empty((), dtype=torch.int32, device=leaves[0].device)
    if not segments:
        return out.zero_()
    stream = stream_of(out)
    for i, launch in enumerate(plan_tree(segments)):
        ptrs, counts, dtypes, ends = launch.arrays()
        rc = library().repro_probe_tree(
            ctypes.addressof(ptrs), ctypes.addressof(counts), ctypes.addressof(dtypes),
            ctypes.addressof(ends), len(launch.ptrs), float(threshold),
            int(nonfinite_code), int(overflow_code), out.data_ptr(), int(i == 0), stream)
        check_launch("probe_tree", rc)
        count_launch(probe_tree)
    return out


probe_tree.launches = 0
probe_tree.copies = 0
