"""Attention: GQA with optional qk-norm, full (``attn``), sliding
(``sliding``) and cross (``cross``) layers.

The port of ``repro/models/attention.py``. Every path runs through the flash
kernel (``repro_torch.kernels.flash_attention``): the full-sequence forward
with ``q_offset = 0`` (and the sliding window, for ``sliding`` layers;
non-causal for an encoder, ``cfg.causal`` False, and for cross-attention
over the image tokens), slot decode with one query row per slot at that
slot's runtime position over the whole cache capacity, and cross decode
with one query row per slot over all the image keys, unmasked. Plain
``torch.matmul`` carries the projections, as the JAX package leaves them to
XLA; the attention itself is never a library call on the card.

Decode caches: a full layer writes at ``min(pos, cap - 1)`` (the JAX
package's capacity clamp, :func:`cache_write_index`); a sliding layer keeps a
ring of capacity ``cap = min(window, max_len)`` and writes at ``pos % cap``
(:func:`ring_write_index`). Both then read with the same kernel mask — see
:func:`attention_decode`. The speculative verify (:func:`attention_verify`)
writes T entries of a full layer at once and drops those at or past ``cap``
(:func:`verify_write`).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..kernels.flash_attention import (FlashAttention, flash_attention,  # noqa: F401
                                       sdpa_ref)
from .layers import apply_rope, dense_init, rms_norm_vec


# the backward's query and KV chunk (the JAX package's sdpa_chunked defaults)
TRAIN_CHUNK = 2048


class Attention(nn.Module):
    """Projection weights kept 3-D as in the JAX package: wq (d, Hq, hd),
    wk/wv (d, Hkv, hd), wo (Hq, hd, d)."""

    def __init__(self, cfg, *, device, dtype, generator=None):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        shapes = {"wq": (d, cfg.num_heads, hd), "wk": (d, cfg.num_kv_heads, hd),
                  "wv": (d, cfg.num_kv_heads, hd), "wo": (cfg.num_heads, hd, d)}
        scales = {"wq": d ** -0.5, "wk": d ** -0.5, "wv": d ** -0.5,
                  "wo": (cfg.num_heads * hd) ** -0.5}
        for name, shape in shapes.items():
            w = (torch.empty(shape, device=device, dtype=dtype)
                 if generator is None else
                 dense_init(shape, generator=generator, device=device,
                            dtype=dtype, scale=scales[name]))
            setattr(self, name, nn.Parameter(w, requires_grad=False))
        if cfg.qk_norm:
            self.q_norm = nn.Parameter(torch.ones(hd, device=device, dtype=dtype),
                                       requires_grad=False)
            self.k_norm = nn.Parameter(torch.ones(hd, device=device, dtype=dtype),
                                       requires_grad=False)


def _project_q(p: Attention, x: torch.Tensor, cfg) -> torch.Tensor:
    B, S, d = x.shape
    q = (x @ p.wq.reshape(d, -1)).view(B, S, cfg.num_heads, cfg.resolved_head_dim)
    return rms_norm_vec(q, p.q_norm) if cfg.qk_norm else q


def _project_kv(p: Attention, x: torch.Tensor, cfg):
    B, T, d = x.shape
    hd = cfg.resolved_head_dim
    k = (x @ p.wk.reshape(d, -1)).view(B, T, cfg.num_kv_heads, hd)
    v = (x @ p.wv.reshape(d, -1)).view(B, T, cfg.num_kv_heads, hd)
    return (rms_norm_vec(k, p.k_norm) if cfg.qk_norm else k), v


def _project_qkv(p: Attention, x: torch.Tensor, cfg, xkv=None):
    """q from ``x``, K and V from ``xkv`` (default ``x``), each normed when
    ``cfg.qk_norm``."""
    return (_project_q(p, x, cfg),
            *_project_kv(p, x if xkv is None else xkv, cfg))


def _out_proj(p: Attention, out: torch.Tensor) -> torch.Tensor:
    B, S = out.shape[:2]
    return out.reshape(B, S, -1) @ p.wo.reshape(-1, p.wo.shape[-1])


def attention_train(p: Attention, x: torch.Tensor, rope, cfg, *,
                    window: int = 0,
                    kv_src: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self- or cross-attention over a full sequence (x (B, S, d)).

    Self-attention (``kv_src`` None): ``rope`` from
    :func:`~repro_torch.models.layers.rope_tables` at positions 0..S-1,
    causal unless the config is an encoder's (``cfg.causal`` False);
    ``window > 0`` masks keys ``window`` or more positions back (the kernel
    also skips their tiles). Cross-attention (``kv_src (B, T, d)``, the
    image embeddings): K and V from ``kv_src``, no rotary, no mask, no
    window — every row reads all T keys.

    Where autograd needs the gradient (the train step), the attention goes
    through :class:`FlashAttention` — the same kernel launch, with a
    recompute backward; the plain wrapper would refuse such inputs, never
    detach its output."""
    cross = kv_src is not None
    q, k, v = _project_qkv(p, x, cfg, kv_src)
    if not cross:
        q, k = apply_rope(q, rope), apply_rope(k, rope)
    causal = cfg.causal and not cross
    window = 0 if cross else window
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out = FlashAttention.apply(q, k, v, causal, window, TRAIN_CHUNK,
                                   TRAIN_CHUNK)
    else:
        zeros = torch.zeros((x.shape[0],), dtype=torch.int32, device=x.device)
        out = flash_attention(q, k, v, zeros, causal=causal, window=window)
    return _out_proj(p, out)


def precompute_cross_kv(p: Attention, img_embeds: torch.Tensor, cfg):
    """``(k, v)`` of the image embeddings ``(B, T, d)`` for a cross layer's
    decode cache, each ``(B, T, Hkv, hd)``: the K and V projections, K
    normed when ``cfg.qk_norm``, no rotary. The serving engines never call
    it, as the JAX package's do not: a served cross layer reads the zeros
    of a fresh cache."""
    return _project_kv(p, img_embeds, cfg)


def cross_attention_decode(p: Attention, x: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, zeros: torch.Tensor,
                           cfg) -> torch.Tensor:
    """One query row per slot (x (B, 1, d)) against the slot's static image
    K/V ``(B, T, Hkv, hd)``, read and never written: q (normed when
    ``cfg.qk_norm``, no rotary), one flash launch over all T keys with no
    mask (non-causal, ``q_offset`` ``zeros`` (B,) int32, ``seq_kv`` T)."""
    q = _project_q(p, x, cfg)
    out = flash_attention(q, k, v, zeros, causal=False, seq_kv=k.shape[1])
    return _out_proj(p, out)


def cache_write_index(pos: torch.Tensor, cap: int):
    """``(rows, slots)`` index of each batch row's new K/V entry in a full
    layer's cache: ``min(pos, cap - 1)``, the JAX package's capacity clamp.
    The same for every full layer, so a step computes it once."""
    rows = torch.arange(pos.shape[0], device=pos.device)
    return rows, torch.clamp(pos, max=cap - 1).long()


def ring_write_index(pos: torch.Tensor, cap: int):
    """``(rows, slots)`` index of each batch row's new K/V entry in a
    sliding layer's ring of capacity ``cap``: ``pos % cap``, as the JAX
    package's ring. The same for every sliding layer."""
    rows = torch.arange(pos.shape[0], device=pos.device)
    return rows, torch.remainder(pos, cap).long()


def attention_decode(p: Attention, x: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, rope,
                     write_idx, cfg) -> torch.Tensor:
    """One new token per batch row (slot) at its own position.

    x (B, 1, d); caches (B, cap, Hkv, hd), written IN PLACE at ``write_idx``
    (:func:`cache_write_index` for a full layer, :func:`ring_write_index`
    for a sliding layer's ring); pos (B,) int32 on x's device; ``rope`` the
    tables at ``pos``. The write and the read stay on the device: no host
    sync.

    Both cache kinds read through ONE kernel mask: ``causal`` with
    ``q_offset = pos`` over ``seq_kv = cap`` and no window, i.e. slot
    index ``< min(cap, pos + 1)``.
    - Full layer: slot index = position up to the clamp, so this is the JAX
      ``valid = slots <= pos``.
    - Sliding ring: ``cap <= window`` by construction, so every slot written
      so far holds a position inside the window, and the JAX ring mask
      (``slot_pos >= 0 & slot_pos > pos - window``) keeps exactly the
      written slots — slot index ``< min(cap, pos + 1)`` again. Passing the
      sliding ``window`` to the kernel here would be WRONG: the kernel
      compares key *indices* with ``qpos - window``, and ring indices are
      not positions: from ``pos >= window`` on it would drop live slots,
      and from ``pos >= window + cap - 1`` on every key.
    """
    q, k_new, v_new = _project_qkv(p, x, cfg)
    q, k_new = apply_rope(q, rope), apply_rope(k_new, rope)
    k_cache.index_put_(write_idx, k_new[:, 0])
    v_cache.index_put_(write_idx, v_new[:, 0])
    out = flash_attention(q, k_cache, v_cache, pos, causal=True,
                          seq_kv=k_cache.shape[1])
    return _out_proj(p, out)


def verify_write(cache: torch.Tensor, new: torch.Tensor,
                 pos: torch.Tensor) -> None:
    """Write ``new (B, T, ...)`` into a full layer's ``cache (B, cap, ...)``
    IN PLACE at positions ``pos .. pos + T - 1`` of each row, dropping the
    positions ``>= cap`` — the JAX package's ``.at[:, qpos].set(...,
    mode="drop")``. A clamp would overwrite the last entry before a row
    that attends to it reads it.

    Torch indexing has no drop mode, and ``index_put_`` with repeated
    indices has no defined winner. So each dropped entry goes to ``cap - 1``
    carrying the bits that entry ends with — the new one if the row writes
    position ``cap - 1``, else the cache's own: the repeated writes agree,
    and one launch with no sync does the whole write."""
    B, T = new.shape[:2]
    cap = cache.shape[1]
    p = pos.long()
    rows = torch.arange(B, device=pos.device)
    idx = p[:, None] + torch.arange(T, device=pos.device)             # (B, T)
    keep = (idx < cap).view(B, T, *(1,) * (new.dim() - 2))
    writes_last = ((p <= cap - 1) & (p + T > cap - 1)).view(
        B, *(1,) * (new.dim() - 2))
    last = torch.where(writes_last, new[rows, (cap - 1 - p).clamp(0, T - 1)],
                       cache[:, cap - 1])
    cache.index_put_((rows[:, None].expand(B, T), idx.clamp(max=cap - 1)),
                     torch.where(keep, new, last[:, None]))


def attention_verify(p: Attention, xs: list, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, ropes: list,
                     cfg) -> list:
    """T new tokens per batch row at positions ``pos .. pos + T - 1``
    against a full layer's cache (the speculative verify).

    ``xs`` holds row t's input ``(B, 1, d)`` for each t and ``ropes`` the
    tables at ``pos + t``; returns each row's attention output ``(B, 1, d)``.
    All T new K/V entries are written first (:func:`verify_write`, positions
    past capacity dropped), then ONE flash launch reads them (``verify=True``:
    the ``flash_verify`` route on the card), each row with its own causal
    mask. A row's projections, rope and output projection run at the decode
    step's shape, B rows, as in :func:`attention_decode`: a product's
    rounding may depend on how many rows it is given (cuBLAS, the CPU
    libraries), and so row t — its output and the K/V entry it leaves —
    is bit-equal to a decode at ``pos + t``.
    """
    qs, ks, vs = [], [], []
    for x, rope in zip(xs, ropes):
        q, k_new, v_new = _project_qkv(p, x, cfg)
        qs.append(apply_rope(q, rope))
        ks.append(apply_rope(k_new, rope))
        vs.append(v_new)
    verify_write(k_cache, torch.cat(ks, dim=1), pos)
    verify_write(v_cache, torch.cat(vs, dim=1), pos)
    out = flash_attention(torch.cat(qs, dim=1), k_cache, v_cache, pos,
                          causal=True, seq_kv=k_cache.shape[1], verify=True)
    # each row contiguous, as the decode's: a strided view into the product
    # rounds otherwise on the CPU
    return [_out_proj(p, out[:, t:t + 1].contiguous()) for t in range(len(xs))]
