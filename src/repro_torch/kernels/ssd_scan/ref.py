"""Plain PyTorch versions of the Mamba-2 SSD scan (the CPU path and the
oracles the CUDA kernel is held against).

Layout as the JAX package's: x (b, s, h, p) heads, dt (b, s, h), A (h,),
B and C (b, s, g, n) groups (g | h; head ``i`` reads group ``i // (h / g)``).
Recurrence per head: ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t ⊗ B_t``,
``y_t = C_t · h_t``.

* :func:`ssd_intra_chunk_ref` — what the kernel computes, in einsums;
* :func:`ssd_intra_chunk_backward_ref` — its gradient, by autograd;
* :func:`ssd_inter_chunk` — the recurrence over chunk states (linear in
  the chunks) and the off-diagonal term, which stay in torch beside the
  kernel;
* :func:`ssd_scan_ref` — the two together, the whole chunked scan;
* :func:`ssd_naive_ref` — the per-token recurrence (the tests' oracle).
"""
from __future__ import annotations

import torch


def _chunks(t: torch.Tensor, L: int) -> torch.Tensor:
    """(b, s, ...) → (b, s / L, L, ...)."""
    return t.reshape(t.shape[0], t.shape[1] // L, L, *t.shape[2:])


def _per_head(t: torch.Tensor, heads: int) -> torch.Tensor:
    """Group-major (..., g, n) → head-major (..., h, n) fp32 (``jnp.repeat``)."""
    return t.float().repeat_interleave(heads // t.shape[-2], dim=-2)


def ssd_intra_chunk_ref(x, dt, A, B, C, L: int):
    """The kernel's function over chunks of ``L`` steps (``s % L == 0``):
    ``xd = x dt`` and ``ā = dt A`` formed in fp32, then per (batch, chunk,
    head)

    - ``y_diag = (C Bᵀ ⊙ tril(exp(segsum ā))) xd`` → (b, s, h, p) fp32;
    - ``states = Σ_j exp(cum_L − cum_j) xd_j ⊗ B_j`` → (b, s/L, h, p, n)
      fp32, the chunk's state from a zero start.

    Above the diagonal the segment sum is positive and its ``exp`` may be
    inf, so it is masked before ``exp`` and the product selected after, in
    the kernel's order of operations: a clean input never makes a NaN
    there."""
    b, s, h, p = x.shape
    xd = _chunks(x.float() * dt.float()[..., None], L)        # (b,c,L,h,p)
    cum = torch.cumsum(_chunks(dt.float() * A.float(), L), dim=2)   # (b,c,L,h)
    Bc = _chunks(_per_head(B, h), L)                          # (b,c,L,h,n)
    Cc = _chunks(_per_head(C, h), L)
    seg = cum.transpose(2, 3)[..., :, None] - cum.transpose(2, 3)[..., None, :]
    tril = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    scores = torch.einsum("bclhn,bcmhn->bchlm", Cc, Bc)       # (b,c,h,L,L)
    mixed = torch.where(tril, scores * torch.exp(seg.masked_fill(~tril, 0.0)),
                        0.0)
    y_diag = torch.einsum("bchlm,bcmhp->bclhp", mixed, xd)
    weights = torch.exp(cum[:, :, -1:] - cum)                 # (b,c,L,h)
    states = torch.einsum("bclhn,bclhp->bchpn", Bc, xd * weights[..., None])
    return y_diag.reshape(b, s, h, p), states


def ssd_intra_chunk_backward_ref(x, dt, A, B, C, L: int, dy_diag, dstates):
    """The vector-Jacobian product of :func:`ssd_intra_chunk_ref` (the CPU
    path and the oracle the backward kernel is held against): the gradients
    ``dy_diag`` (b, s, h, p) and ``dstates`` (b, s/L, h, p, n) of its two
    outputs → ``(dx, ddt, dA, dB, dC)`` fp32 in the inputs' shapes, by
    autograd through a recompute in fp32 (x, B, C widened first, as the
    forward widens them)."""
    with torch.enable_grad():
        leaves = [t.detach().float().requires_grad_(True) for t in (x, dt, A, B, C)]
        outs = ssd_intra_chunk_ref(*leaves, L)
        return torch.autograd.grad(outs, leaves, (dy_diag.float(), dstates.float()))


BLOCK = 32      # chunk states a decay-matrix product spans, at most


def _chunk_inputs(chunk_sum, states):
    """Each chunk's incoming state from a zero start over the chunks given:
    ``h_c = sum_{d < c} exp(chunk_sum_{d+1} + ... + chunk_sum_{c-1})
    states_d``, as one product with the chunk-level decay matrix, as in the
    Mamba-2 paper's minimal SSD. chunk_sum (b, h, c), states (b, c, h, p,
    n) → (b, c, h, p, n)."""
    upto = torch.cumsum(chunk_sum, dim=-1)           # decay through chunk c
    # chunk c starts from chunk c' < c's state decayed over chunks c'+1 … c-1
    seg = (upto - chunk_sum)[..., :, None] - upto[..., None, :]
    nc = seg.shape[-1]
    before = torch.ones(nc, nc, dtype=torch.bool, device=seg.device).tril(-1)
    carry = torch.exp(seg.masked_fill(~before, float("-inf")))     # (b,h,c,c')
    return torch.einsum("bhcd,bdhpn->bchpn", carry, states)


def ssd_inter_chunk(y_diag, states, dt, A, C, L: int) -> torch.Tensor:
    """The rest of the chunked scan, fp32: each chunk's incoming state from
    the chunk states (``h_c = exp(total_{c-1}) h_{c-1} + states_{c-1}``),
    then ``y = y_diag + exp(cum_l) C_l · h_c`` → (b, s, h, p) fp32. C stays
    per group: heads of one group share it without a copy per head.

    Memory and work grow linearly in the ``nc = s / L`` chunks. Up to
    ``BLOCK`` chunks the incoming states are one decay-matrix product
    (:func:`_chunk_inputs`: (b, h, nc, nc) decays, no Python loop; every
    path of the port has nc ≤ 32). Past it the chunks go in blocks of
    ``BLOCK``: the decay-matrix product inside each block (all blocks in one
    product) and, between blocks, the reference's sequential carry
    ``h = exp(total) h + states`` over the last chunk of each, one step a
    block — the blocked recurrence a long-context prefill needs."""
    b, s, h, p = y_diag.shape
    g, n = C.shape[2], C.shape[3]
    cum = torch.cumsum(_chunks(dt.float() * A.float(), L), dim=2)   # (b,c,L,h)
    chunk_sum = cum[:, :, -1].transpose(1, 2)                       # (b,h,c)
    nc = chunk_sum.shape[-1]
    if nc <= BLOCK:
        h_in = _chunk_inputs(chunk_sum, states)
    else:
        nb = -(-nc // BLOCK)
        pad = nb * BLOCK - nc                # zero chunks after the last
        cs = torch.nn.functional.pad(chunk_sum, (0, pad)).reshape(b, h, nb, BLOCK)
        st = torch.nn.functional.pad(states, (0, 0, 0, 0, 0, 0, 0, pad))
        st = st.reshape(b, nb, BLOCK, h, p, n)
        local = _chunk_inputs(cs.transpose(1, 2).reshape(b * nb, h, BLOCK),
                              st.reshape(b * nb, BLOCK, h, p, n))
        local = local.reshape(b, nb, BLOCK, h, p, n)
        # decay from the block's start to each chunk's
        into = torch.exp(torch.cumsum(cs, dim=-1) - cs)     # (b,h,nb,BLOCK)
        carry = torch.zeros_like(local[:, 0, 0])            # (b,h,p,n)
        blocks = []
        for k in range(nb):
            blk = local[:, k] + into[:, :, k].transpose(1, 2)[..., None, None] * carry[:, None]
            blocks.append(blk)
            carry = (blk[:, -1] * torch.exp(cs[:, :, k, -1])[..., None, None]
                     + st[:, k, -1])
        h_in = torch.stack(blocks, dim=1).reshape(b, nb * BLOCK, h, p, n)[:, :nc]
    h_in = h_in.reshape(b, nc, g, h // g, p, n)
    y_off = torch.einsum("bclgn,bcgrpn->bclgrp", _chunks(C.float(), L), h_in)
    y_off = y_off.reshape(b, nc, L, h, p) * torch.exp(cum)[..., None]
    return y_diag + y_off.reshape(b, s, h, p)


def check_scan_shapes(x, dt, A, B, C, chunk: int) -> int:
    """The chunk length ``L = min(chunk, s)`` of a valid call; raises where
    the JAX scan asserts (``s % L``) and on shapes that do not fit."""
    if x.dim() != 4 or 0 in x.shape:
        raise ValueError(f"ssd_scan: x must be a non-empty (b, s, h, p), got "
                         f"{tuple(x.shape)}")
    b, s, h, p = x.shape
    if B.dim() != 4 or B.shape[:2] != (b, s) or C.shape != B.shape:
        raise ValueError(f"ssd_scan: B and C must be one (b, s, g, n) shape, "
                         f"got {tuple(B.shape)} and {tuple(C.shape)}")
    g = B.shape[2]
    if g < 1 or B.shape[3] < 1 or h % g:
        raise ValueError(f"ssd_scan: {h} heads do not split over {g} groups")
    if tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,):
        raise ValueError(f"ssd_scan: dt must be {(b, s, h)} and A {(h,)}, got "
                         f"{tuple(dt.shape)} and {tuple(A.shape)}")
    if chunk < 1:
        raise ValueError(f"ssd_scan: chunk must be >= 1, got {chunk}")
    L = min(chunk, s)
    if s % L:
        raise ValueError(f"ssd_scan: {s} steps are not a multiple of the "
                         f"chunk {L}")
    return L


def ssd_scan_ref(x, dt, A, B, C, chunk: int = 128) -> torch.Tensor:
    """The whole chunked scan in plain torch → y (b, s, h, p) in x's dtype."""
    L = check_scan_shapes(x, dt, A, B, C, chunk)
    y_diag, states = ssd_intra_chunk_ref(x, dt, A, B, C, L)
    return ssd_inter_chunk(y_diag, states, dt, A, C, L).to(x.dtype)


def ssd_naive_ref(x, dt, A, B, C) -> torch.Tensor:
    """Per-token recurrence (the oracle) → y (b, s, h, p) in x's dtype."""
    b, s, h, p = x.shape
    Bh, Ch = _per_head(B, h), _per_head(C, h)
    dtf = dt.float()
    state = torch.zeros(b, h, p, B.shape[-1], dtype=torch.float32,
                        device=x.device)
    ys = []
    for t in range(s):
        a = torch.exp(dtf[:, t] * A.float())                   # (b,h)
        inp = (dtf[:, t, :, None] * x[:, t].float())[..., None] * Bh[:, t, :, None, :]
        state = state * a[..., None, None] + inp
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype)
