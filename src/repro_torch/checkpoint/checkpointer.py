"""Asynchronous, atomic, versioned disk checkpointing (global-rollback store).

The port of ``repro/checkpoint/checkpointer.py``:

* ``save`` copies every leaf to the host (through the port's one
  device-to-host path, :func:`~repro_torch.core.device_channel.readback`)
  and hands the write to a background thread — training never blocks on
  disk (the paper's premise that recovery machinery must not slow the
  failure-free path).
* Writes are atomic: ``tmp-`` directory + ``os.replace`` rename; a manifest
  records step, each leaf's path in the tree, dtype, shape and checksum.
  bfloat16 leaves (no numpy dtype) are stored as their 16-bit patterns.
* ``restore_latest`` validates checksums and skips corrupt checkpoints
  (CHECKPOINT_IO soft-fault semantics: a broken rollback target must surface
  as an error, not as silently-wrong weights), and puts each leaf back on
  the device and in the dtype of the matching leaf of ``like``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from ..core.device_channel import readback
from ..core.errors import ErrorCode
from ..tree import tree_items, tree_unflatten

# torch dtypes numpy lacks, stored as raw bits of the same width
_BITS = {torch.bfloat16: np.int16}


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as ``(numpy array, its torch dtype name)``."""
    if not torch.is_tensor(leaf):
        arr = np.asarray(leaf)
        return arr, str(arr.dtype)
    name = str(leaf.dtype).removeprefix("torch.")
    if leaf.dtype in _BITS:
        leaf = leaf.view(torch.int16)
    return readback(leaf), name


def _to_leaf(arr: np.ndarray, dtype: str, like) -> Any:
    if not torch.is_tensor(like):
        return arr
    t = torch.from_numpy(arr)
    if dtype != str(like.dtype).removeprefix("torch.") or tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {dtype} {tuple(t.shape)} does not "
                         f"match {like.dtype} {tuple(like.shape)}")
    if like.dtype in _BITS:
        t = t.view(like.dtype)
    return t.to(like.device)


class Checkpointer:
    def __init__(self, directory: str | Path, *, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[Exception] = None

    # ---------------------------------------------------------------- saving
    def save(self, step: int, state, *, blocking: bool = False) -> None:
        """Snapshot to host, then write in the background."""
        host = [(path, *_to_host(leaf)) for path, leaf in tree_items(state)]
        self.wait()          # one in-flight write at a time
        t = threading.Thread(target=self._write, args=(step, host),
                             daemon=True)
        t.start()
        self._thread = t
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: list) -> None:
        try:
            tmp = self.dir / f"tmp-{step}"
            final = self.dir / f"step-{step:010d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {"step": step, "num_leaves": len(host), "leaves": []}
            for i, (path, arr, dtype) in enumerate(host):
                np.save(tmp / f"leaf-{i:05d}.npy", arr)
                manifest["leaves"].append({
                    "i": i, "path": path, "shape": list(arr.shape),
                    "dtype": dtype, "crc": zlib.crc32(arr.tobytes()),
                })
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)      # atomic publish
            self._gc()
        except Exception as e:  # noqa: BLE001
            self.last_error = e

    def _gc(self) -> None:
        steps = self.list_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step-{s:010d}", ignore_errors=True)

    # -------------------------------------------------------------- restoring
    def list_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step-*"):
            try:
                out.append(int(p.name.split("-")[1]))
            except ValueError:
                continue
        return sorted(out)

    def restore(self, step: int, like) -> Any:
        """Restore into the structure of ``like``, each leaf on the device of
        ``like``'s. Raises on a checksum, structure or dtype mismatch."""
        d = self.dir / f"step-{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())
        items = tree_items(like)
        if manifest["num_leaves"] != len(items):
            raise ValueError(
                f"checkpoint step {step}: leaf count mismatch "
                f"({manifest['num_leaves']} vs {len(items)})")
        out = []
        for i, (path, leaf) in enumerate(items):
            meta = manifest["leaves"][i]
            if meta["path"] != path:
                raise ValueError(f"checkpoint step {step} leaf {i}: "
                                 f"{meta['path']!r}, expected {path!r}")
            arr = np.load(d / f"leaf-{i:05d}.npy")
            if zlib.crc32(arr.tobytes()) != meta["crc"]:
                raise IOError(f"checkpoint step {step} leaf {i}: CRC mismatch "
                              f"(code={ErrorCode.CHECKPOINT_IO!r})")
            out.append(_to_leaf(arr, meta["dtype"], leaf))
        return tree_unflatten(like, out)

    def restore_latest(self, like) -> Optional[tuple[int, Any]]:
        """(step, state) from the newest valid checkpoint, skipping corrupt
        ones; None if nothing restorable."""
        for step in reversed(self.list_steps()):
            try:
                return step, self.restore(step, like)
            except Exception:  # noqa: BLE001 - corrupt ckpt: try the previous
                continue
        return None
