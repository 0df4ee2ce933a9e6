"""Plain PyTorch version of flash attention (the CPU path and the oracle the
CUDA kernel is held against): full materialisation, one softmax."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def sdpa_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             q_offset: torch.Tensor, causal: bool, window: int = 0,
             seq_kv: int | None = None) -> torch.Tensor:
    """q (B, S, Hq, D), k/v (B, T, Hkv, D) → (B, S, Hq, D) in q's dtype.

    Row ``s`` of batch ``b`` sits at position ``q_offset[b] + s``; keys at
    positions ``>= seq_kv`` are masked, as are keys after the query
    (``causal``) or ``window`` or more positions before it.
    """
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    seq_kv = T if seq_kv is None else seq_kv
    kr = k.repeat_interleave(group, dim=2).float()
    vr = v.repeat_interleave(group, dim=2).float()
    scores = torch.einsum("bshd,bthd->bhst", q.float(), kr) / math.sqrt(D)
    qpos = (torch.arange(S, device=q.device)[None, :]
            + q_offset.to(q.device, torch.int64)[:, None])          # (B, S)
    kpos = torch.arange(T, device=q.device)
    mask = (kpos < seq_kv)[None, None, :].expand(B, S, T)
    if causal:
        mask = mask & (kpos[None, None, :] <= qpos[:, :, None])
    if window:
        mask = mask & (kpos[None, None, :] > qpos[:, :, None] - window)
    scores = torch.where(mask[:, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, vr)
    return out.to(q.dtype)
