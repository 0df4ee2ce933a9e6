"""Wrappers of the RG-LRU scan kernels, chunked over time in chunks of
``CHUNK`` steps: the forward (``csrc/rglru_scan.cu``), its backward
(``csrc/rglru_scan_bwd.cu``, one pass whose blocks hand the adjoint's carry
from chunk to chunk through :class:`_HandOff`'s scratch) and
:class:`RGLRUScan`, the two as one autograd Function.

A tensor on the CPU goes to the plain version (``ref.py``); a CUDA tensor
goes to the kernel or raises — there is no fallback.
"""
from __future__ import annotations

import threading

import torch

from ..build import (check_device, check_launch, check_no_grad, count_launch,
                     library, run_plain, stream_of)
from .ref import rglru_scan_backward_ref, rglru_scan_ref

CHUNK = 128                     # steps per chunk, whatever the length
LANES = 32                      # channels per block of the backward kernel


def _check(name: str, *tensors: torch.Tensor) -> str:
    """Shared checks: one device, one non-empty (B, S, W) fp32 shape,
    contiguous; returns the device's type."""
    kind = check_device(name, *tensors)
    shape = tensors[0].shape
    if (tensors[0].dim() != 3 or 0 in shape
            or any(t.shape != shape for t in tensors)):
        raise ValueError(f"{name}: the inputs must share one non-empty "
                         f"(B, S, W) shape, got {[tuple(t.shape) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name}: float32 inputs expected, got "
                        f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    if kind == "cuda" and shape[0] > 65535:
        raise ValueError(f"{name}: batch {shape[0]} exceeds the grid's 65535")
    return kind


def _scratch(x: torch.Tensor) -> torch.Tensor:
    """The forward's chunk aggregates: two values (decay product, end
    state) per (batch, chunk but one, channel)."""
    B, S, W = x.shape
    nc = -(-S // CHUNK)
    return torch.empty(2 * B * (nc - 1) * W, dtype=torch.float32, device=x.device)


class _HandOff:
    """The backward kernel's scratch on one (device, stream): word 0 is the
    ticket counter, then one carry word per (batch row, chunk, channel),
    the call's epoch in its high half. Calls on one stream run in order, so
    each takes the tickets after the last one's (``issued``) and a new
    epoch, and the scratch is zeroed only when it grows: there is no reset
    launch."""

    _all: dict = {}
    _lock = threading.Lock()

    def __init__(self, words: int, device):
        self.words = torch.zeros(words, dtype=torch.int64, device=device)
        self.issued = 0               # tickets taken by earlier calls
        self.epoch = 0                # the last call's

    @classmethod
    def launch(cls, x: torch.Tensor, words: int, blocks: int, fn) -> int:
        """``fn(scratch pointer, base, epoch)`` → the launcher's code, with
        the scratch of ``x``'s device and current stream grown to
        ``words``; the tickets and the epoch advance only on a launch."""
        key = (x.device, stream_of(x))
        with cls._lock:
            hand = cls._all.get(key)
            if hand is None or hand.words.numel() < words:
                hand = cls._all[key] = cls(words, x.device)
            rc = fn(hand.words.data_ptr(), hand.issued, hand.epoch + 1)
            if not rc:
                hand.issued += blocks
                hand.epoch += 1
            return rc


def rglru_scan(x_in: torch.Tensor, log_a: torch.Tensor) -> torch.Tensor:
    """x_in (pre-gate input ``i ⊙ x``), log_a (≤ 0): fp32 (B, S, W) → the
    RG-LRU states h (B, S, W) fp32 — what the JAX package's ``ops.py
    rglru_scan`` and its Pallas kernel compute together. Refuses inputs
    that need a gradient: :class:`RGLRUScan` carries one."""
    kind = _check("rglru_scan", x_in, log_a)
    check_no_grad("rglru_scan", x_in, log_a)
    if kind == "cpu":
        return run_plain(rglru_scan, rglru_scan_ref, x_in, log_a)
    B, S, W = x_in.shape
    out = torch.empty_like(x_in)
    rc = library().repro_rglru_scan(x_in.data_ptr(), log_a.data_ptr(),
                                    out.data_ptr(), _scratch(x_in).data_ptr(),
                                    B, S, W, CHUNK, stream_of(x_in))
    check_launch("rglru_scan", rc)
    count_launch(rglru_scan)
    return out


def rglru_scan_bwd(x_in: torch.Tensor, log_a: torch.Tensor, h: torch.Tensor,
                   dh: torch.Tensor):
    """The scan's vector-Jacobian product: the inputs, the states ``h`` the
    forward returned and their gradient ``dh``, all fp32 (B, S, W) →
    ``(dx_in, dlog_a)`` fp32 (B, S, W)."""
    if _check("rglru_scan_bwd", x_in, log_a, h, dh) == "cpu":
        return run_plain(rglru_scan_bwd, rglru_scan_backward_ref, x_in, log_a,
                         h, dh)
    B, S, W = x_in.shape
    dx_in, dlog_a = torch.empty_like(x_in), torch.empty_like(x_in)
    nc = -(-S // CHUNK)
    rc = _HandOff.launch(
        x_in, 1 + B * nc * W, nc * B * -(-W // LANES),
        lambda hand, base, epoch: library().repro_rglru_scan_bwd(
            x_in.data_ptr(), log_a.data_ptr(), h.data_ptr(), dh.data_ptr(),
            dx_in.data_ptr(), dlog_a.data_ptr(), hand, B, S, W, CHUNK, base,
            epoch, stream_of(x_in)))
    check_launch("rglru_scan_bwd", rc)
    count_launch(rglru_scan_bwd)
    return dx_in, dlog_a


rglru_scan.launches = 0
rglru_scan_bwd.launches = 0


class RGLRUScan(torch.autograd.Function):
    """The scan with a gradient: ``RGLRUScan.apply(x_in, log_a)`` → h, as
    :func:`rglru_scan`. The forward is one :func:`rglru_scan` call and saves
    ``(x_in, log_a, h)``; the backward one :func:`rglru_scan_bwd` call (the
    kernel on a CUDA tensor, the plain version on the CPU) — what
    ``jax.grad`` of the JAX package's ``rglru_scan_assoc`` computes."""

    @staticmethod
    def forward(ctx, x_in, log_a):
        h = rglru_scan(x_in, log_a)
        ctx.save_for_backward(x_in, log_a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        return rglru_scan_bwd(*ctx.saved_tensors, dh.contiguous())
