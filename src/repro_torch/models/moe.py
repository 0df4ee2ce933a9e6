"""Mixture-of-Experts FFN: top-k routing into per-row capacity buffers.

The port of ``repro/models/moe.py``. Tokens are scattered into per-(row,
expert) capacity buffers (the JAX package's ``(B, E, C, d)``, laid out
expert-major here) and the experts are dense batched products over them, so every product's shape is fixed by ``(B, S)`` and the
config: never by the routing or by the other rows' tokens. A row's bits
therefore do not depend on its neighbours (the serve engines' LFLR replays
rest on that), and nothing is summed with atomics: the combine is a sum over
each token's K assignments in a fixed order.

Capacity is per batch row, ``C = max(8, ceil8(int(cf · S · K / E)))``;
position-in-expert is a cumsum over the row's flattened ``(s, k)`` order, so
the tokens past C that the JAX package drops are the ones dropped here. The
dropped fraction feeds the ``ROUTER_OVERFLOW`` probe
(:func:`repro_torch.core.detect.router_probe`).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import dense_init, gelu_tanh, silu


class MoE(nn.Module):
    """``router`` (d, E) in fp32; ``wi``, ``wg`` (E, d, f) and ``wo`` (E, f,
    d) in the model dtype (no ``wg`` for the plain ``gelu`` kind). The
    seeded init draws each leaf as the JAX package's ``_dense_init`` does,
    scale ``1/sqrt(shape[0])``: the expert weights at ``1/sqrt(E)``."""

    def __init__(self, cfg, *, device, dtype, generator=None):
        super().__init__()
        E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
        shapes = [("router", (d, E), torch.float32), ("wi", (E, d, f), dtype)]
        if cfg.mlp_kind in ("swiglu", "geglu"):
            shapes.append(("wg", (E, d, f), dtype))
        shapes.append(("wo", (E, f, d), dtype))
        for name, shape, dt in shapes:
            w = (torch.empty(shape, device=device, dtype=dt)
                 if generator is None else
                 dense_init(shape, generator=generator, device=device, dtype=dt))
            setattr(self, name, nn.Parameter(w, requires_grad=False))


def capacity(tokens_per_group: int, cfg) -> int:
    """Slots per (row, expert): ``cf · S · K / E`` truncated, rounded up to
    a multiple of 8, at least 8."""
    c = int(cfg.expert_capacity_factor * tokens_per_group
            * cfg.num_experts_per_tok / cfg.num_experts)
    return max(8, -(-c // 8) * 8)


def route(p: MoE, x: torch.Tensor, cfg):
    """The fp32 router: softmax over the experts, the top K, the gates
    renormalised over the K. Returns ``(gates (B, S, K) fp32, experts (B,
    S, K) int64)``."""
    probs = torch.softmax(x.float() @ p.router, dim=-1)
    gates, experts = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    return gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9), experts


def dispatch(experts: torch.Tensor, E: int, C: int):
    """Each assignment's buffer row in its batch row's ``(E * C + 1)`` rows
    (``E * C``, the trash row, for one past capacity) and whether it was
    kept: position-in-expert is the count of earlier assignments to the same
    expert in the row's flattened ``(s, k)`` order. experts (B, S, K) →
    ``(buf_idx, keep)``, each (B, S * K)."""
    B = experts.shape[0]
    flat = experts.reshape(B, -1)
    pos = torch.cumsum(F.one_hot(flat, E), dim=1) - 1
    pos = torch.gather(pos, 2, flat[..., None])[..., 0]
    keep = pos < C
    return torch.where(keep, flat * C + pos, E * C), keep


def apply_moe(p: MoE, x: torch.Tensor, cfg, *, with_aux: bool = True):
    """x (B, S, d) → ``(out (B, S, d), {"dropped_fraction", "load_max"})``,
    both 0-d fp32 tensors on x's device (no host sync); ``with_aux=False``
    returns ``(out, None)`` without computing them (the decode ignores
    them).

    The buffers are laid out expert-major, ``(E, B * C, d)`` — row ``(e, b,
    c)`` is the JAX package's ``buffers[b, e, c]`` — so each expert's
    products are one batched matmul over its ``B * C`` rows with no copy of
    the buffers or the weights."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    C = capacity(S, cfg)
    gates, experts = route(p, x, cfg)
    buf_idx, keep = dispatch(experts, E, C)

    # each kept assignment's token into its own buffer row (the kept rows are
    # distinct; every dropped one lands in the trash row, cut off below)
    row = torch.arange(B, device=x.device)[:, None] * C
    rows = torch.where(keep, (buf_idx // C) * (B * C) + row + buf_idx % C, E * B * C)
    buffers = torch.zeros((E * B * C + 1, d), device=x.device, dtype=x.dtype)
    buffers[rows.reshape(-1)] = x.repeat_interleave(K, dim=1).reshape(-1, d)
    buffers = buffers[:E * B * C].view(E, B * C, d)

    h = torch.bmm(buffers, p.wi)
    if cfg.mlp_kind == "swiglu":
        h = silu(torch.bmm(buffers, p.wg)) * h
    elif cfg.mlp_kind == "geglu":
        h = gelu_tanh(torch.bmm(buffers, p.wg)) * h
    else:
        h = gelu_tanh(h)
    out_e = torch.bmm(h, p.wo).view(E * B * C, d)

    # the combine: each assignment's expert output, zeroed if dropped, times
    # its gate, summed over the token's K assignments in order (the JAX
    # package's segment sum, which adds them one by one in the model dtype)
    got = out_e[torch.where(keep, rows, 0)] * keep[..., None].to(x.dtype)
    weighted = (got * gates.reshape(B, S * K, 1).to(x.dtype)).view(B, S, K, d)
    out = weighted[:, :, 0]
    for k in range(1, K):
        out = out + weighted[:, :, k]
    if not with_aux:
        return out, None

    load = F.one_hot(experts, E).float().mean(dim=(0, 1, 2)) * E
    aux = {"dropped_fraction": 1.0 - keep.float().mean(),
           "load_max": load.max()}
    return out, aux
