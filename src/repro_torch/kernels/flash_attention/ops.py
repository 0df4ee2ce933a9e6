"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``).

A tensor on the CPU goes to the plain version (``ref.py``); a CUDA tensor
goes to the kernel or raises — there is no fallback.
"""
from __future__ import annotations

import torch

from ..build import (DTYPE_CODES, check_device, check_launch, library,
                     stream_of)
from .ref import sdpa_ref

HEAD_DIMS = (16, 32, 64, 128, 256)   # the kernel is instantiated for these
MAX_GROUP = 16                  # a block holds the group's query rows


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_offset: torch.Tensor, *, causal: bool, window: int = 0,
                    seq_kv: int | None = None) -> torch.Tensor:
    """q (B, S, Hq, D), k/v (B, T, Hkv, D) → (B, S, Hq, D) in q's dtype.

    ``q_offset`` is an int32 tensor (B,) on q's device: row ``s`` of batch
    ``b`` sits at position ``q_offset[b] + s`` (decode: S = 1 and the slot's
    position; a full forward: zeros). Keys at positions ``>= seq_kv`` (default
    T) are masked.
    """
    kind = check_device("flash_attention", q, k, v, q_offset)
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
    if kind == "cpu":
        return sdpa_ref(q, k, v, q_offset=q_offset, causal=causal,
                        window=window, seq_kv=seq_kv)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be 16-byte aligned "
                         "(the kernel reads rows as 16-byte vectors)")
    out = torch.empty_like(q)
    rc = library().repro_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_offset.data_ptr(),
        out.data_ptr(), B, S, T, Hq, Hkv, D, int(bool(causal)), int(window),
        seq_kv, DTYPE_CODES[q.dtype], stream_of(q))
    check_launch("flash_attention", rc)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
