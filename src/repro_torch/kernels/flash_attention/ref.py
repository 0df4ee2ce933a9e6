"""Plain PyTorch versions of flash attention: the forward (the CPU path and
the oracle the CUDA kernels are held against: full materialisation, one
softmax) and the training backward (the chunked recompute that the autograd
Function runs on every device)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def sdpa_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             q_offset: torch.Tensor, causal: bool, window: int = 0,
             seq_kv: int | None = None, return_lse: bool = False):
    """q (B, S, Hq, D), k/v (B, T, Hkv, D) → (B, S, Hq, D) in q's dtype.

    Row ``s`` of batch ``b`` sits at position ``q_offset[b] + s``; keys at
    positions ``>= seq_kv`` are masked, as are keys after the query
    (``causal``) or ``window`` or more positions before it. ``return_lse``
    also returns each row's log-sum-exp of the scaled, masked scores,
    ``(B, S, Hq)``. The arithmetic is fp32 (float64 for float64 inputs).
    """
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    seq_kv = T if seq_kv is None else seq_kv
    acc = torch.promote_types(q.dtype, torch.float32)
    kr = k.repeat_interleave(group, dim=2).to(acc)
    vr = v.repeat_interleave(group, dim=2).to(acc)
    scores = torch.einsum("bshd,bthd->bhst", q.to(acc), kr) / math.sqrt(D)
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
    out = torch.einsum("bhst,bthd->bshd", probs, vr).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(scores, dim=-1).transpose(1, 2).contiguous()
    return out


def chunk_ranges(nq: int, nk: int, q_chunk: int, kv_chunk: int, causal: bool,
                 window: int):
    """Static per-query-chunk KV ranges and per-KV-chunk query ranges,
    ``(first, count)`` each (the JAX package's ``_chunk_ranges`` at
    ``q_offset = 0``)."""
    q_ranges = []
    for qi in range(nq):
        q_lo, q_hi = qi * q_chunk, (qi + 1) * q_chunk - 1
        k_first, k_last = 0, nk - 1
        if causal:
            k_last = min(k_last, q_hi // kv_chunk)
        if window:
            k_first = max(0, (q_lo - window + 1) // kv_chunk)
        q_ranges.append((k_first, max(k_last - k_first + 1, 1)))
    kv_ranges = []
    for kj in range(nk):
        k_lo, k_hi = kj * kv_chunk, (kj + 1) * kv_chunk - 1
        q_first, q_last = 0, nq - 1
        if causal:
            q_first = max(0, k_lo // q_chunk)
        if window:
            q_last = min(q_last, (k_hi + window - 1) // q_chunk)
        kv_ranges.append((q_first, max(q_last - q_first + 1, 1)))
    return q_ranges, kv_ranges


def flash_backward(q, k, v, out, lse, do, *, causal: bool, window: int = 0,
                   q_chunk: int = 2048, kv_chunk: int = 2048):
    """``(dq, dk, dv)`` of :func:`sdpa_ref` at positions 0..S-1 (no
    ``seq_kv`` cut), recomputed chunk by chunk from the forward's ``out``
    and ``lse (B, S, Hq)``: the plain-torch port of the JAX package's
    ``_flash_bwd`` (``models/attention.py:201``). ``delta = Σ do·out`` per
    row; dq loops query chunks over their KV chunks, dk/dv loop KV chunks
    over their query chunks, in fp32 (float64 for float64 inputs); GQA runs as grouped products
    (``(B, S, Hkv, group, D)`` against ``(B, T, Hkv, D)``), so dk and dv sum
    each KV head's group in the product — no repeat, no scatter. Every sum
    has a fixed order: the same inputs give the same bits."""
    B, S, Hq, D = q.shape
    T, Kv = k.shape[1], k.shape[2]
    g = Hq // Kv
    q_chunk, kv_chunk = min(q_chunk, S), min(kv_chunk, T)
    nq, nk = -(-S // q_chunk), -(-T // kv_chunk)
    Sp, Tp = nq * q_chunk, nk * kv_chunk
    scale = 1.0 / math.sqrt(float(D))
    acc = torch.promote_types(q.dtype, torch.float32)
    pad_s = lambda x: F.pad(x, (0, 0, 0, 0, 0, Sp - S))  # noqa: E731  (B,S,H,D)
    qp = pad_s(q.to(acc)).reshape(B, Sp, Kv, g, D)
    kp = F.pad(k.to(acc), (0, 0, 0, 0, 0, Tp - T))
    vp = F.pad(v.to(acc), (0, 0, 0, 0, 0, Tp - T))
    dop = pad_s(do.to(acc)).reshape(B, Sp, Kv, g, D)
    lsep = F.pad(lse.to(acc).reshape(B, S, Kv, g).permute(0, 2, 3, 1),
                 (0, Sp - S))                                    # (B,Kv,g,Sp)
    delta = (do.to(acc) * out.to(acc)).sum(dim=-1)               # (B,S,Hq)
    delta = F.pad(delta, (0, 0, 0, Sp - S)).reshape(B, Sp, Kv, g).permute(
        0, 2, 3, 1)                                              # (B,Kv,g,Sp)
    q_ranges, kv_ranges = chunk_ranges(nq, nk, q_chunk, kv_chunk, causal,
                                       window)
    dev = q.device

    def probs(qi, kj):
        """Chunk (qi, kj)'s recomputed probabilities and its K, V, dO,
        delta slices."""
        qs = qp[:, qi * q_chunk:(qi + 1) * q_chunk]
        ks = kp[:, kj * kv_chunk:(kj + 1) * kv_chunk]
        vs = vp[:, kj * kv_chunk:(kj + 1) * kv_chunk]
        s = torch.einsum("bskgd,btkd->bkgst", qs, ks) * scale
        qpos = qi * q_chunk + torch.arange(q_chunk, device=dev)
        kpos = kj * kv_chunk + torch.arange(kv_chunk, device=dev)
        mask = (kpos[None, :] < T).expand(q_chunk, kv_chunk)
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        s = torch.where(mask, s, NEG_INF)
        rows = slice(qi * q_chunk, (qi + 1) * q_chunk)
        p = torch.exp(s - lsep[..., rows, None])
        return p, qs, ks, vs, dop[:, rows], delta[..., rows, None]

    dqs = []
    for qi, (k_first, n) in enumerate(q_ranges):
        dq = torch.zeros((B, q_chunk, Kv, g, D), dtype=acc, device=dev)
        for kj in range(k_first, k_first + n):
            p, _, ks, vs, dos, dl = probs(qi, kj)
            dp = torch.einsum("bskgd,btkd->bkgst", dos, vs)
            ds = p * (dp - dl) * scale
            dq = dq + torch.einsum("bkgst,btkd->bskgd", ds, ks)
        dqs.append(dq)
    dks, dvs = [], []
    for kj, (q_first, n) in enumerate(kv_ranges):
        dk = torch.zeros((B, kv_chunk, Kv, D), dtype=acc, device=dev)
        dv = torch.zeros_like(dk)
        for qi in range(q_first, q_first + n):
            p, qs, _, vs, dos, dl = probs(qi, kj)
            dv = dv + torch.einsum("bkgst,bskgd->btkd", p, dos)
            dp = torch.einsum("bskgd,btkd->bkgst", dos, vs)
            ds = p * (dp - dl) * scale
            dk = dk + torch.einsum("bkgst,bskgd->btkd", ds, qs)
        dks.append(dk)
        dvs.append(dv)
    dq = torch.cat(dqs, dim=1)[:, :S].reshape(B, S, Hq, D)
    dk = torch.cat(dks, dim=1)[:, :T]
    dv = torch.cat(dvs, dim=1)[:, :T]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
