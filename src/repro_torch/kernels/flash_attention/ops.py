"""Wrapper of the flash-attention kernels (``csrc/*.cu``).

A tensor on the CPU goes to the plain version (``ref.py``); a CUDA tensor
goes to a kernel or raises — there is no fallback. :func:`plan` picks the
kernel from the shape, the dtype and whether the rows verify a cache:

- ``flash_decode`` (``csrc/flash_decode.cu``): one query row per slot
  (S == 1) in bf16, on the tensor cores; each slot's keys split across the
  blocks of a cluster, merged in split order;
- ``flash_verify`` (the same kernel, ``verify=True`` with S > 1): the
  speculative verify's S rows per slot over its cache, row ``s`` at
  ``q_offset + s`` and bit-equal to ``flash_decode`` there — the split is
  the decode's, whatever S is;
- ``flash_forward`` (``csrc/flash_forward.cu``): S > 1 in bf16, on the tensor
  cores;
- ``flash_f32`` (``csrc/flash_f32.cu``): fp32, any S, on the CUDA cores (TF32
  would not hold fp32 results to 2e-5).

``lse=True`` also returns each row's log-sum-exp (the training forward's,
read by the recompute backward) and takes ``flash_forward`` (bf16, any S) or
``flash_f32``. :class:`FlashAttention` is the autograd Function around it:
its forward is that launch, its backward the plain-torch port of the JAX
package's chunked recompute (``ref.py::flash_backward``). The wrapper
itself has no gradient and raises when autograd would need one.

A verify that takes no ``flash_verify`` launch — the CPU's plain version,
or fp32 on the card — runs row by row at S = 1, so that its rows too are
the decode's bits (both round otherwise at another row count).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..build import (DTYPE_CODES, check_device, check_launch, check_no_grad,
                     count_launch, library, stream_of)
from .ref import flash_backward, sdpa_ref

HEAD_DIMS = (16, 32, 64, 128, 256)   # the kernels are instantiated for these
MAX_GROUP = 16                  # a block holds the group's query rows
KERNELS = ("flash_decode", "flash_verify", "flash_forward", "flash_f32")
DECODE_TILE = 64                # keys per tile of flash_decode
MAX_SPLITS = 8                  # blocks of one decode cluster (flash_decode.cu)
SPLIT_TARGET = 32               # decode blocks wanted per slot: KV heads x splits


@dataclass(frozen=True)
class Plan:
    kernel: str                 # one of KERNELS
    splits: int = 1             # decode: blocks per (slot, KV head)
    keys_per_split: int = 0     # decode: a multiple of DECODE_TILE


def plan(S: int, seq_kv: int, Hkv: int, dtype: torch.dtype, *,
         verify: bool = False, lse: bool = False) -> Plan:
    """The kernel a launch of this shape and dtype takes and, for decode
    and verify, how the keys ``[0, seq_kv)`` are split.

    The split depends on ``seq_kv`` and the KV heads alone — never on the
    slots' positions nor on S, so a slot's output depends only on its own
    data, its own position and the launch shape (bit-exact LFLR replays),
    and a verify row is the decode's. Slots x KV heads x splits is aimed at
    ``SPLIT_TARGET`` blocks per slot; a split holds whole tiles, and none is
    empty for every position. ``lse`` (the training forward) takes the
    forward kernels whatever S is."""
    if dtype != torch.bfloat16:
        return Plan("flash_f32")
    if (S != 1 and not verify) or lse:
        return Plan("flash_forward")
    tiles = max(1, -(-seq_kv // DECODE_TILE))
    splits = max(1, min(MAX_SPLITS, tiles, SPLIT_TARGET // Hkv))
    per = -(-tiles // splits)                           # tiles per split
    return Plan("flash_decode" if S == 1 else "flash_verify",
                -(-tiles // per), per * DECODE_TILE)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_offset: torch.Tensor, *, causal: bool, window: int = 0,
                    seq_kv: int | None = None, verify: bool = False,
                    lse: bool = False):
    """q (B, S, Hq, D), k/v (B, T, Hkv, D) → (B, S, Hq, D) in q's dtype.

    ``q_offset`` is an int32 tensor (B,) on q's device: row ``s`` of batch
    ``b`` sits at position ``q_offset[b] + s`` (decode: S = 1 and the slot's
    position; a full forward: zeros). Keys at positions ``>= seq_kv`` (default
    T) are masked. ``verify`` marks S rows per slot over a decode cache (the
    speculative verify): each row's output is then bit-equal to this
    function's at S = 1 and ``q_offset + s``; no window. ``lse`` returns
    ``(out, lse)`` with ``lse (B, S, Hq)`` fp32, ``m + log(max(l, 1e-30))``
    of each row; not with ``verify``.
    """
    kind = check_device("flash_attention", q, k, v, q_offset)
    check_no_grad("flash_attention", q, k, v)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention: q (B,S,Hq,D) and k, v (B,T,Hkv,D) "
                         f"expected, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree on batch or head_dim")
    if Hkv < 1 or Hq % Hkv or not 1 <= Hq // Hkv <= MAX_GROUP:
        raise ValueError(f"flash_attention: {Hq} query heads over {Hkv} KV "
                         f"heads (group must divide and be <= {MAX_GROUP})")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not in {HEAD_DIMS}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype} (one of {list(DTYPE_CODES)} expected)")
    if q_offset.dtype != torch.int32 or q_offset.shape != (B,):
        raise TypeError("flash_attention: q_offset must be int32 of shape "
                        f"({B},), got {q_offset.dtype} {tuple(q_offset.shape)}")
    if not all(t.is_contiguous() for t in (q, k, v, q_offset)):
        raise ValueError("flash_attention: inputs must be contiguous")
    seq_kv = T if seq_kv is None else int(seq_kv)
    if not 0 <= seq_kv <= T or window < 0:
        raise ValueError(f"flash_attention: seq_kv {seq_kv} not in [0, {T}] "
                         f"or window {window} < 0")
    if verify and (window or lse):
        raise ValueError("flash_attention: a verify reads a full-attention "
                         "cache (no window) and returns no lse")
    p = plan(S, seq_kv, Hkv, q.dtype, verify=verify, lse=lse)
    if verify and S > 1 and p.kernel != "flash_verify":
        # the plain version and flash_f32 round by row count: row by row
        return torch.cat([flash_attention(
            q[:, s:s + 1].contiguous(), k, v, q_offset + s, causal=causal,
            seq_kv=seq_kv) for s in range(S)], dim=1)
    if kind == "cpu":
        return sdpa_ref(q, k, v, q_offset=q_offset, causal=causal,
                        window=window, seq_kv=seq_kv, return_lse=lse)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be 16-byte aligned "
                         "(the kernel reads rows as 16-byte vectors)")
    out = torch.empty_like(q)
    row_lse = (torch.empty((B, S, Hq), dtype=torch.float32, device=q.device)
               if lse else None)
    lib = library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), q_offset.data_ptr(),
            out.data_ptr())
    if p.kernel in ("flash_decode", "flash_verify"):
        rc = lib.repro_flash_decode(
            *args, B, T, Hq, Hkv, D, int(bool(causal)), int(window), seq_kv,
            p.splits, p.keys_per_split, S, stream_of(q))
    else:
        rc = getattr(lib, f"repro_{p.kernel}")(
            *args, row_lse.data_ptr() if lse else None, B, S, T, Hq, Hkv, D,
            int(bool(causal)), int(window), seq_kv, stream_of(q))
    check_launch(p.kernel, rc)
    count_launch(flash_attention, p.kernel)
    return (out, row_lse) if lse else out


flash_attention.launches = 0          # wrapper calls that launched a kernel
flash_attention.kernel_launches = dict.fromkeys(KERNELS, 0)


class FlashAttention(torch.autograd.Function):
    """Causal or sliding self-attention over a full sequence (positions
    0..S-1) with a gradient: ``FlashAttention.apply(q, k, v, causal, window,
    q_chunk, kv_chunk)`` → out, as :func:`flash_attention`.

    The forward is one :func:`flash_attention` launch with ``lse=True`` (the
    kernel on a CUDA tensor, the plain version on the CPU) and saves
    ``(q, k, v, out, lse)``; the backward recomputes the probabilities chunk
    by chunk from them (:func:`~.ref.flash_backward`, the JAX package's
    ``_flash_bwd`` with ``q_chunk``/``kv_chunk``), in plain torch, as the
    JAX package's backward is jnp and not a Pallas kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, q_chunk: int,
                kv_chunk: int):
        zeros = torch.zeros((q.shape[0],), dtype=torch.int32, device=q.device)
        out, lse = flash_attention(q, k, v, zeros, causal=causal,
                                   window=window, lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.config = (causal, window, q_chunk, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, q_chunk, kv_chunk = ctx.config
        dq, dk, dv = flash_backward(q, k, v, out, lse, do, causal=causal,
                                    window=window, q_chunk=q_chunk,
                                    kv_chunk=kv_chunk)
        return dq, dk, dv, None, None, None, None
