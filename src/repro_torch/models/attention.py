"""Attention for the dense qwen3 path: GQA with qk-norm, full (causal) only.

The port of ``repro/models/attention.py``. Both paths run through the flash
kernel (``repro_torch.kernels.flash_attention``): the full-sequence forward
with ``q_offset = 0``, and slot decode with one query row per slot at that
slot's runtime position over the whole cache capacity — which is exactly the
JAX ``attention_decode``'s ``valid = slots <= pos`` mask after its write at
``min(pos, cap - 1)``. Plain ``torch.matmul`` carries the projections, as
the JAX package leaves them to XLA; the attention itself is never a library
call on the card.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..kernels.flash_attention import flash_attention, sdpa_ref  # noqa: F401
from .layers import apply_rope, dense_init, rms_norm_vec


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


def _project_qkv(p: Attention, x: torch.Tensor, cfg):
    B, S, d = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ p.wq.reshape(d, -1)).view(B, S, cfg.num_heads, hd)
    k = (x @ p.wk.reshape(d, -1)).view(B, S, cfg.num_kv_heads, hd)
    v = (x @ p.wv.reshape(d, -1)).view(B, S, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm_vec(q, p.q_norm)
        k = rms_norm_vec(k, p.k_norm)
    return q, k, v


def _out_proj(p: Attention, out: torch.Tensor) -> torch.Tensor:
    B, S = out.shape[:2]
    return out.reshape(B, S, -1) @ p.wo.reshape(-1, p.wo.shape[-1])


def attention_train(p: Attention, x: torch.Tensor, rope, cfg) -> torch.Tensor:
    """Causal self-attention over a full sequence (x (B, S, d)); ``rope``
    from :func:`~repro_torch.models.layers.rope_tables` at positions 0..S-1."""
    q, k, v = _project_qkv(p, x, cfg)
    q, k = apply_rope(q, rope), apply_rope(k, rope)
    zeros = torch.zeros((x.shape[0],), dtype=torch.int32, device=x.device)
    out = flash_attention(q, k, v, zeros, causal=cfg.causal)
    return _out_proj(p, out)


def cache_write_index(pos: torch.Tensor, cap: int):
    """``(rows, slots)`` index of each batch row's new K/V entry:
    ``min(pos, cap - 1)``, the JAX package's capacity clamp. The same for
    every layer, so a step computes it once."""
    rows = torch.arange(pos.shape[0], device=pos.device)
    return rows, torch.clamp(pos, max=cap - 1).long()


def attention_decode(p: Attention, x: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, rope,
                     write_idx, cfg) -> torch.Tensor:
    """One new token per batch row (slot) at its own position.

    x (B, 1, d); caches (B, cap, Hkv, hd), written IN PLACE at
    ``write_idx = cache_write_index(pos, cap)``; pos (B,) int32 on x's
    device; ``rope`` the tables at ``pos``. The write and the read stay on
    the device: no host sync.
    """
    q, k_new, v_new = _project_qkv(p, x, cfg)
    q, k_new = apply_rope(q, rope), apply_rope(k_new, rope)
    k_cache.index_put_(write_idx, k_new[:, 0])
    v_cache.index_put_(write_idx, v_new[:, 0])
    out = flash_attention(q, k_cache, v_cache, pos, causal=True,
                          seq_kv=k_cache.shape[1])
    return _out_proj(p, out)
