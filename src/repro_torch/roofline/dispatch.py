"""Counts over one step run under ``FakeTensorMode``: the aten ops, the
bytes at each op's boundary and the bytes live at once.

The counterpart of ``repro/roofline/hlo.py``. The reference parses the
compiled XLA module's text, where a fusion is one kernel and its boundary
is what reaches HBM. Eager PyTorch runs each aten op as one kernel, so the
port counts at the aten ops' boundaries instead, as a
``TorchDispatchMode`` sees them: :class:`DispatchCount` over a step on
fake tensors (shapes and dtypes, no memory, no arithmetic), on the CPU.

- A view moves no bytes (it is the reference's ``bitcast``).
- The FLOPs are ``torch.utils.flop_counter``'s formulas (what
  ``FlopCounterMode`` counts) over every op.
- Where a hand-written kernel's plain version stands in (a fake tensor
  lies on the CPU), the kernel wrapper runs it through
  ``kernels/build.py::run_plain``; the counter takes the kernel's own
  inputs and outputs once, under ``kernel.<wrapper>``, and none of the
  plain version's steps or temporaries; its FLOPs are the plain version's.
  A call whose arguments have the shapes of an earlier call's is not run
  again: its outputs are made empty with the shapes that call gave, and it
  counts that call's FLOPs (the layers of a stack repeat their calls).
- The live bytes are those of every storage the step's arguments and ops
  hold, swept when the storage is freed. Their peak is what the card's
  allocator would hold at least, with no fragmentation or cached blocks.

The reference's ``parse_collectives`` counts the collectives of a module
sharded over TPU chips. One card runs none: it waits for tensor
parallelism (ROADMAP item 11).
"""
from __future__ import annotations

from collections import Counter

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten
from torch.utils.flop_counter import flop_registry

from ..kernels import build


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _signature(tree) -> tuple:
    """What a plain version's outputs depend on but for values: the tree's
    structure, each tensor's shape, strides and dtype, the other leaves."""
    leaves, spec = tree_flatten(tree)
    return (str(spec),) + tuple(
        (tuple(x.shape), x.stride(), x.dtype) if isinstance(x, torch.Tensor)
        else repr(x) for x in leaves)


class DispatchCount(TorchDispatchMode):
    """Under ``with DispatchCount() as count:``, every aten op's calls
    (``ops``) and boundary bytes (``op_bytes``: its tensor inputs and
    outputs, each read or written once; 0 for a view), each kernel's under
    ``kernel.<wrapper>``, ``flops``, and ``peak_bytes``, the most bytes
    live at once. :meth:`track` adds the storages that live before the step
    (its arguments)."""

    def __init__(self):
        super().__init__()
        self.ops: Counter = Counter()
        self.op_bytes: Counter = Counter()
        self.live: dict = {}            # StorageWeakRef → bytes
        self.live_bytes = 0
        self.peak_bytes = 0
        self.flops = 0
        self._inside = 0                # > 0 within a kernel's plain version
        self._hook = None
        self._plain_calls: dict = {}    # signature → (outputs' metas, FLOPs)

    def __enter__(self):
        self._hook, build.PLAIN_HOOK = build.PLAIN_HOOK, self._plain
        return super().__enter__()

    def __exit__(self, *exc):
        build.PLAIN_HOOK = self._hook
        return super().__exit__(*exc)

    def track(self, tree) -> None:
        """Count every storage of ``tree``'s tensors as live."""
        for t in _tensors(tree):
            ref = StorageWeakRef(t.untyped_storage())
            if ref not in self.live:
                self.live[ref] = t.untyped_storage().nbytes()
                self.live_bytes += self.live[ref]
        if self.live_bytes > self.peak_bytes:
            # freed storages are swept only here: while the unswept sum
            # stays under the peak, the true one does too
            for ref in [r for r in self.live if r.expired()]:
                self.live_bytes -= self.live.pop(ref)
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _record(self, name: str, inputs, out, nbytes: bool = True) -> None:
        self.ops[name] += 1
        self.op_bytes[name] += _nbytes(inputs) + _nbytes(out) if nbytes else 0
        self.track(out)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.overloadpacket in flop_registry:
            self.flops += flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out)
        # prim ops read metadata (a tensor's device): no kernel
        if not self._inside and func.namespace != "prim":
            self._record(str(func.overloadpacket), (args, kwargs), out,
                         nbytes=not func.is_view)
        return out

    def _plain(self, wrapper, fn, args, kwargs):
        key = (fn, _signature((args, kwargs)))
        seen = self._plain_calls.get(key)
        self._inside += 1
        try:
            if seen is None:
                before = self.flops
                out = fn(*args, **kwargs)
                leaves, spec = tree_flatten(out)
                self._plain_calls[key] = (spec, [
                    (tuple(t.shape), t.stride(), t.dtype) for t in leaves],
                    self.flops - before)
            else:
                spec, metas, flops = seen
                device = _tensors((args, kwargs))[0].device
                out = tree_unflatten([torch.empty_strided(
                    shape, stride, dtype=dtype, device=device)
                    for shape, stride, dtype in metas], spec)
                self.flops += flops
        finally:
            self._inside -= 1
        self._record(f"kernel.{wrapper.__name__}", (args, kwargs), out)
        return out


def op_histogram(count: DispatchCount) -> dict:
    """``{op: calls}``, the most called first (kernels as ``kernel.<name>``)."""
    return dict(count.ops.most_common())


def estimate_hbm_bytes(count: DispatchCount) -> dict:
    """The step's bytes at the ops' boundaries: ``total_bytes``, and
    ``by_op`` (the largest first), the memory term's numerator."""
    return {"total_bytes": sum(count.op_bytes.values()),
            "by_op": dict(count.op_bytes.most_common())}
