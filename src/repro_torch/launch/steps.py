"""Step factories: the decode steps (one word for the batch, or one per
slot), the decode windows (plain, fused with prompt chunks, and
speculative), the cache-building prefills (chunked and whole) and the
full-sequence prefill step.

The port of ``repro/launch/steps.py:120 make_train_step`` (with its
``microbatch`` and ``ce_chunk`` levers), ``:997
make_reset_opt_fn``, ``:226 make_decode_step``, ``:244
make_slot_decode_step``, ``:271 _paged_slot_step``, ``:404
make_decode_window``, ``:491 make_prefill_decode_window``, ``:594
make_speculative_decode_window``, ``:791 make_chunked_prefill``, ``:867
make_cache_prefill`` and ``:208 make_prefill_step``, each window and cache
prefill also in its paged form
(``paged=`` a :class:`~repro_torch.launch.paging.PagedLayout`). The JAX package vmaps
a batch-1 decode step over slots and scans K of them in one jitted program;
PyTorch runs eagerly, so the slots are the batch dimension of one decode
step (each slot at its own position, held in a device tensor) and the window
is a K-step Python loop whose token feedback, positions and word history
never leave the device. Caches are updated in place (the JAX package
donates them).

Every step here runs the same ``Model.decode_step``, so a cache built by a
prefill is bit-equal to one built by the window steps *at the same batch
size*: a product's rounding may depend on the number of rows it is given
(cuBLAS may pick another kernel for one row than for eight; the CPU
libraries block rows too), never on the other rows' values. The serving
replica therefore rebuilds a lane at the slots' batch size.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.detect import ProbeConfig, logits_probe, state_probe, step_probe
from ..core.errors import ErrorCode
from ..core.faults import inject_batch, inject_grads, inject_loss
from ..models.model import CACHE_LAYOUT, Model
from ..optim import AdamWConfig, adamw_update, reset_moments
from .paging import PagedLayout


def make_loss_and_grads(cfg, ce_chunk: int = 0):
    """``(params, batch) → (loss, grads, aux)``: the training loss of
    ``batch`` under a train state's ``params``, its gradient, a dict in
    ``params``' order, and ``{"dropped_fraction"}`` (the MoE layers' mean,
    :meth:`Model.forward`; 0 without MoE). The model is a skeleton on the
    ``meta`` device (no weights of its own): :meth:`Model.loss` runs on the
    given tensors, each taken as a fresh autograd leaf, so the params
    themselves never require a gradient. Every block kind trains: the
    attention gradient goes through ``FlashAttention``, the RG-LRU's through
    ``RGLRUScan`` and the SSD's through ``SSDIntraChunk``, each a kernel
    forward with a kernel (or, for attention, plain recompute) backward.
    ``ce_chunk`` chunks the loss over the sequence (:meth:`Model.loss`)."""
    skeleton = Model(cfg, device="meta", seed=None)

    def loss_and_grads(params: dict, batch: dict):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        with torch.enable_grad():
            loss, aux = skeleton.loss(leaves, batch, ce_chunk=ce_chunk)
            # a leaf the loss never reads (an encoder's token embedding, fed
            # frame embeddings) gets zeros, as jax.grad gives it
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
        return (loss.detach(), dict(zip(leaves, grads)),
                {k: v.detach() for k, v in aux.items()})

    return loss_and_grads


def accumulate_grads(loss_and_grads, params: dict, batch: dict, k: int):
    """The JAX package's gradient accumulation over ``k`` microbatches:
    every batch key cut into ``k`` slices of ``B // k`` rows (the last
    ``B % k`` rows take no part), the slices run in order, and ``loss / k``,
    each gradient ``g.float() / k`` and ``dropped_fraction / k`` summed
    from fp32 zeros. Returns ``(loss, fp32 grads, aux)`` as
    ``loss_and_grads`` does. Each slice's gradients are freed before the
    next slice runs: the fp32 sums and one slice's activations are live."""
    n = batch["labels"].shape[0] // k
    acc = {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for name, p in params.items()}
    loss = torch.zeros((), dtype=torch.float32, device=batch["labels"].device)
    dropped = torch.zeros_like(loss)
    for i in range(k):
        part = {key: v[i * n:(i + 1) * n] for key, v in batch.items()}
        loss_i, grads, aux = loss_and_grads(params, part)
        for name, g in grads.items():
            acc[name].add_(g.float() / k)
        del grads
        loss = loss + loss_i / k
        dropped = dropped + aux["dropped_fraction"] / k
    return loss, acc, {"dropped_fraction": dropped}


def make_train_step(cfg, opt_cfg: Optional[AdamWConfig] = None,
                    probe_cfg: Optional[ProbeConfig] = None, *,
                    microbatch: int = 0, ce_chunk: int = 0):
    """``(state, batch, inject) → (state', metrics, error_word)``.

    ``state`` is ``{"params", "opt": {"m", "v"}, "step", "lr_scale"}`` (the
    JAX package's tree: dicts of tensors in its flatten order, the scalars
    0-d tensors); ``batch`` ``{"tokens", "labels"}`` (or, by family,
    ``inputs_embeds`` for the tokens, ``img_embeds`` beside them) on the
    same device;
    ``inject`` an int or an int32 0-d device tensor of ``INJ_*`` bits. The
    word is the in-band device channel: the loss, the whole gradient stream
    (one ``probe_tree`` launch over every leaf) and the input tokens
    (where the batch has them),
    OR-combined into one int32 that the host's DeviceFuture turns into the paper's
    exceptions; for an MoE config also the router probe over the dropped
    fraction (ROUTER_OVERFLOW). The injections, the probes, the AdamW update
    and the metrics (``loss``, ``grad_norm``, ``lr``, ``dropped_fraction``)
    all stay on the device: no host sync. ``state`` is left as it was, so
    the executor may discard the step.

    The JAX package's ``PerfOptions`` levers: ``microbatch=k > 1``
    accumulates the gradient over ``k`` slices of the batch
    (:func:`accumulate_grads`; the tokens are injected into the whole batch
    first, and the injections, the probe and AdamW take the fp32 sums),
    ``ce_chunk`` chunks the loss over the sequence (:meth:`Model.loss`).
    """
    opt_cfg = opt_cfg or AdamWConfig()
    probe_cfg = probe_cfg or ProbeConfig()
    loss_and_grads = make_loss_and_grads(cfg, ce_chunk)

    def train_step(state, batch, inject):
        if not torch.is_tensor(inject):
            inject = torch.full((), int(inject), dtype=torch.int32,
                                device=state["step"].device)
        # an audio batch has frame embeddings and no tokens: no bad-data
        # injection and no data probe, as in the JAX package
        tokens = batch.get("tokens")
        if tokens is not None:
            tokens = inject_batch(tokens, inject)
            batch = {**batch, "tokens": tokens}
        if microbatch > 1:
            loss, grads, aux = accumulate_grads(loss_and_grads, state["params"],
                                                batch, microbatch)
        else:
            loss, grads, aux = loss_and_grads(state["params"], batch)
        loss = inject_loss(loss, inject)
        grads = inject_grads(grads, inject)
        dropped = aux["dropped_fraction"]
        word = step_probe(loss, grads, tokens=tokens,
                          vocab_size=cfg.vocab_size if tokens is not None else None,
                          router_dropped=dropped if cfg.is_moe else None,
                          cfg=probe_cfg)
        with torch.no_grad():
            params, opt, stats = adamw_update(
                opt_cfg, state["params"], grads, state["opt"], state["step"],
                lr_scale=state["lr_scale"])
        new_state = {"params": params, "opt": opt, "step": state["step"] + 1,
                     "lr_scale": state["lr_scale"]}
        metrics = {"loss": loss, "grad_norm": stats["grad_norm"],
                   "lr": stats["lr"], "dropped_fraction": dropped}
        return new_state, metrics, word

    return train_step


def make_reset_opt_fn(cfg):
    """Paper use case 2: optimizer-moment reset + lr decay ('solver
    restart'): ``(state, lr_scale) → state'`` with zero moments and
    ``lr_scale`` multiplied in; the params are kept."""

    def reset(state, lr_scale):
        return {"params": state["params"], "opt": reset_moments(state["opt"]),
                "step": state["step"], "lr_scale": state["lr_scale"] * lr_scale}

    return reset


def make_decode_step(model: Model):
    """Batch decode with one error word for the whole batch::

      step(cache, token, pos)
        cache  model.init_cache(B, cap), updated in place
        token  (B, 1) int
        pos    an int (every row there) or an int32 (B,) device tensor
      → (logits (B, 1, V) fp32, word int32 0-d)

    The word is the JAX step's: the logits probe (NONFINITE_LOSS iff a
    logit is NaN or ±inf) folded over the rows, ORed with the state probe
    over ``h``/``ssm`` where the model has recurrent state. The row words
    of each probe are 0 or its one code, so their max is their OR. Nothing
    is read back.
    """

    def step(cache, token, pos):
        logits = model.decode_step(token, cache, pos)
        word = logits_probe(logits[:, 0]).amax()
        for leaf in model.state_leaves:
            word = word | state_probe(cache[leaf]).amax()
        return logits, word

    return step


def make_slot_decode_step(model: Model):
    """Per-slot decode for continuous batching::

      step(caches, tokens, pos)
        caches  model.init_cache(slots, cap), updated in place
        tokens  (S,) int32   input token per slot
        pos     (S,) int32   per-slot absolute position (device tensor)
      → (logits (S, V) fp32, words (S,) int32)

    The word is per slot — the logits probe kernel reduces each slot's row —
    which is what makes per-sequence LFLR possible. A model with recurrent
    state ORs in the state word over each updated state leaf, ``h`` and/or
    ``ssm`` (the JAX decode step's ``state_probe`` over the leaves its
    ``_recurrent_states`` picks; never a convolution's), one more probe
    launch per leaf a step.
    """

    def step(caches, tokens, pos):
        logits = model.decode_step(tokens[:, None], caches, pos)[:, 0]
        words = logits_probe(logits)
        for leaf in model.state_leaves:
            words = words | state_probe(caches[leaf])
        return logits, words

    return step


def _paged_slot_step(slot_step, paged: PagedLayout):
    """Wrap the slot-decode step with page-table addressing::

      step(hybrid, tokens, pos, table (S, max_pages) int32 device tensor)

    Gather builds every slot's contiguous view of the pools (unmapped pages
    read as zeros — the bits of a fresh contiguous cache), the unchanged
    slot step runs on it, and scatter writes it back through the table
    (unmapped pages dropped, so a lane that owns no page writes nowhere).
    The page probe ORs ``PAGE_FAULT`` into a slot's word iff a page up to
    the one it writes is unmapped. The whole tree is gathered and scattered
    every step, as in the JAX package.
    """

    def step(hybrid, tokens, pos, table):
        views = paged.gather(hybrid, table)
        logits, words = slot_step(views, tokens, pos)
        paged.scatter(hybrid, views, table)
        return logits, words | paged.probe(table, pos)

    return step


def make_prefill_step(model: Model):
    """Full-sequence prefill::

      prefill_step(tokens (B, S) int, *, inputs_embeds=None, img_embeds=None)
        → (logits (B, S, V) fp32, word)

    ``inputs_embeds (B, S, d)`` stand for the tokens (the audio frontend's
    frames: pass ``tokens=None``), ``img_embeds (B, T, d)`` feed the cross
    layers, as the JAX step's batch dict carries them (:meth:`Model.forward`).

    ``word`` is the JAX step's one word for the batch,
    ``loss_probe(max|logits|)`` at threshold ``inf``: NONFINITE_LOSS iff
    some logit is NaN or ±inf. The probe kernel gives one word per row of
    ``logits.view(B * S, V)`` and the rows fold on the device; the row
    words are 0 or that one code, so their max is their OR. ``word`` is an
    int32 0-d tensor on the model's device (nothing is read back).
    """

    def prefill_step(tokens=None, *, inputs_embeds=None, img_embeds=None):
        logits = model(tokens, inputs_embeds=inputs_embeds,
                       img_embeds=img_embeds)
        rows = logits.view(-1, logits.shape[-1])
        return logits, logits_probe(rows).amax()

    return prefill_step


def _window_loop(slot_step, window: int, caches, tokens, pos, feed=None):
    """K slot steps with the greedy token fed back on the device; ``feed(k,
    tok)`` replaces step k's input (the prompt chunks). Returns ``(tokens
    (K, S), words (K, S), next_tok, next_pos)``."""
    toks, words = [], []
    tok, p = tokens, pos
    for k in range(window):
        inp = tok if feed is None else feed(k, tok)
        logits, w = slot_step(caches, inp, p)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(tok)
        words.append(w)
        p = p + 1
    return torch.stack(toks), torch.stack(words), tok, p


def make_decode_window(model: Model, *, window: int,
                       paged: Optional[PagedLayout] = None):
    """Pipelined decode window: K slot-decode steps with the greedy token
    fed back on the device and no prompt feed::

      window_step(caches, tokens, pos)
        tokens  (S,) int32     input token per slot
        pos     (S,) int32     per-slot position at the window's first step
      → (tokens (K, S) int32, words (K, S) int32,
         next_tok (S,) int32, next_pos (S,) int32)   all on the device

    The same loop as :func:`make_prefill_decode_window` without its chunk
    feed, so the two are bit-equal when no lane takes a chunk (``rem = 0``).

    With ``paged`` the caches argument is the hybrid cache
    (:meth:`PagedLayout.init_hybrid`) and the function takes a trailing
    ``table (S, max_pages)`` int32 device tensor; every step goes through
    :func:`_paged_slot_step`, so the streams are bit-equal to the
    contiguous window's.
    """
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    slot_step = make_slot_decode_step(model)
    if paged is not None:
        pstep = _paged_slot_step(slot_step, paged)

        def paged_window_step(hybrid, tokens, pos, table):
            return _window_loop(lambda c, t, p: pstep(c, t, p, table),
                                window, hybrid, tokens, pos)

        return paged_window_step

    def window_step(caches, tokens, pos):
        return _window_loop(slot_step, window, caches, tokens, pos)

    return window_step


def make_prefill_decode_window(model: Model, *, window: int,
                               paged: Optional[PagedLayout] = None):
    """Fused decode+prefill window: K slot-decode steps with the greedy
    token fed back on the device and prompt chunks fed in per slot::

      window_step(caches, tokens, pos, chunk, rem)
        tokens  (S,) int32     greedy feedback feed per slot
        pos     (S,) int32     per-slot position at the window's first step
        chunk   (K, S) int32   prompt tokens per step × slot
        rem     (S,) int32     step k of slot s consumes chunk[k, s] iff
                               k < rem[s], else its own previous argmax
      → (tokens (K, S) int32, words (K, S) int32,
         next_tok (S,) int32, next_pos (S,) int32)   all on the device

    A lane whose chunk ends at step ``rem - 1`` flips there: that step's
    argmax is its first generated token (the JAX window's flip semantics).
    All inputs must already be on the model's device; nothing is read back.

    With ``paged`` the function takes a trailing ``table`` as
    :func:`make_decode_window` does; a chunking lane writes its prompt
    through the same page addressing.
    """
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    slot_step = make_slot_decode_step(model)

    def feed(chunk, rem):
        return lambda k, tok: torch.where(k < rem, chunk[k], tok)

    if paged is not None:
        pstep = _paged_slot_step(slot_step, paged)

        def paged_window_step(hybrid, tokens, pos, chunk, rem, table):
            return _window_loop(lambda c, t, p: pstep(c, t, p, table),
                                window, hybrid, tokens, pos, feed(chunk, rem))

        return paged_window_step

    def window_step(caches, tokens, pos, chunk, rem):
        return _window_loop(slot_step, window, caches, tokens, pos,
                            feed(chunk, rem))

    return window_step


def make_speculative_decode_window(model: Model, *, window: int,
                                   draft_len: int, draft_layers: int,
                                   paged: Optional[PagedLayout] = None):
    """Speculative decode window: draft and verify inside one dispatch.

    Each of the K window steps

    1. drafts ``D = draft_len`` tokens per slot with the shallow-exit
       self-draft (:meth:`Model.draft_chain`: the first ``draft_layers``
       layers of the same weights and caches, the final norm and the
       unembedding);
    2. verifies all ``D + 1`` positions in one full-model pass
       (:meth:`Model.verify_step`), greedy: draft ``d_{i+1}`` survives iff it
       equals the full model's argmax after ``d_i``, so every emitted token
       is a full-model argmax and the stream equals the plain window's;
    3. latches a rejected draft as the attribution-only ``DRAFT_REJECT``
       lane of the ``(K, slots)`` word history, beside the verify's logits
       probe (one ``probe_rows`` launch over the ``S * (D + 1)`` rows, folded
       per slot).

    A rejected draft's cache writes are not rolled back: full-attention
    writes are positional, and every stale entry lies past the accepted
    prefix, so it is overwritten before a masked read could reach it::

      window_step(caches, tokens, pos, chunk, rem)
        tokens  (S,) int32        greedy feedback feed per slot
        pos     (S,) int32        per-slot position (device-resident: the
                                  advance is data-dependent)
        chunk   (K, D+1, S) int32 prompt tokens per step x row x slot
        rem     (S,) int32        pending prompt tokens per slot this window
      → (tokens (K, S, D+1) int32 the full model's argmaxes,
         counts (K, S) int32      positions consumed per step and slot: the
                                  prompt rows and the accepted tokens,
                                  1 <= count <= D+1,
         words (K, S) int32, next_tok (S,) int32, next_pos (S,) int32)
                                  all on the device

    Step k of slot s feeds its next ``clip(rem - k (D+1), 0, D+1)`` prompt
    tokens into the verify rows (forced, accepted as given); rows past the
    prompt chain off the drafter, so speculation starts inside the flip
    step. With ``paged`` the caches argument is the hybrid cache and a
    trailing ``table`` follows: each step gathers once, drafts and
    verifies on the views, scatters once, and the page probe checks the
    pages up to the last accepted position ``pos + a - 1``.
    """
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if draft_len < 1:
        raise ValueError(f"draft_len must be >= 1, got {draft_len}")
    cfg = model.cfg
    if not 0 < draft_layers < cfg.num_layers:
        raise ValueError(
            f"draft_layers must be in [1, num_layers), got {draft_layers} "
            f"for {cfg.num_layers} layers")
    if not model.supports_speculation():
        raise ValueError(
            f"{cfg.name}: speculative decode windows require a pure "
            "full-attention, non-MoE architecture (ring buffers and "
            "recurrent states cannot absorb rejected-draft over-writes)")
    D = int(draft_len)
    reject = int(ErrorCode.DRAFT_REJECT)

    def macro_step(caches, tok, p, chunk_rows, k, rem):
        """One draft + verify step: ``chunk_rows`` is this step's (D+1, S)
        prompt feed, ``rem`` the slots' pending prompt tokens for the whole
        window. Returns ``(next_tok, next_pos, argmaxes (S, D+1), counts
        (S,), words (S,))``."""
        rem_k = (rem - k * (D + 1)).clamp(0, D + 1)        # prompt rows
        t0 = torch.where(rem_k > 0, chunk_rows[0], tok)
        proposals = model.draft_chain(
            t0[:, None], caches, p, draft_layers=draft_layers, draft_len=D,
            override=chunk_rows[1:].t(), n_forced=rem_k)
        seq = torch.cat([t0[:, None], proposals], dim=1)    # (S, D+1)
        logits = model.verify_step(seq, caches, p)          # (S, D+1, V)
        S = seq.shape[0]
        words = logits_probe(logits.view(S * (D + 1), -1)).view(S, D + 1).amax(1)
        g = torch.argmax(logits, dim=-1).to(torch.int32)
        # acceptance: the prompt rows are given, then the leading run of
        # drafts that match the full model's argmax chain, plus the bonus
        # token after the run
        rows = torch.arange(1, D + 1, device=p.device)
        ok = (rows < rem_k[:, None]) | (g[:, :D] == seq[:, 1:])
        a = (1 + torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1)).to(torch.int32)
        # a miss latches iff an actual draft (a row past the forced ones;
        # row 0 is always given) was rejected
        forced = rem_k.clamp(min=1)
        words = words | torch.where((forced <= D) & (a < D + 1), reject, 0)
        next_tok = g.gather(1, (a - 1).long()[:, None])[:, 0]
        return next_tok, p + a, g, a, words.to(torch.int32)

    def loop(step, tokens, pos, chunk, rem):
        toks, counts, words = [], [], []
        tok, p = tokens, pos
        for k in range(window):
            tok, p_next, g, a, w = step(tok, p, chunk[k], k, rem)
            toks.append(g)
            counts.append(a)
            words.append(w)
            p = p_next
        return (torch.stack(toks), torch.stack(counts), torch.stack(words),
                tok, p)

    if paged is not None:
        def paged_window_step(hybrid, tokens, pos, chunk, rem, table):
            def step(tok, p, chunk_rows, k, rem):
                views = paged.gather(hybrid, table)
                out = macro_step(views, tok, p, chunk_rows, k, rem)
                paged.scatter(hybrid, views, table)
                return (*out[:4], out[4] | paged.probe(table, out[1] - 1))
            return loop(step, tokens, pos, chunk, rem)

        return paged_window_step

    def window_step(caches, tokens, pos, chunk, rem):
        return loop(lambda *a: macro_step(caches, *a), tokens, pos, chunk, rem)

    return window_step


def make_chunked_prefill(model: Model, *, chunk: int,
                         paged: Optional[PagedLayout] = None):
    """Advance an *existing* cache by at most ``chunk`` tokens::

      chunk_step(cache, tokens (B, C), n, start_pos)
        feeds tokens[:, :n] (n <= C) through the decode step at positions
        start_pos, start_pos + 1, ...
      → (last logits (B, 1, V) fp32, cache, word int32 0-d)

    ``n == 0`` gives zero logits and a clean word, as the JAX loop of no
    trips. The caller owns the cache (a serving lane resumes a half-built
    one chunk by chunk), and a chain of chunks is bit-equal to
    :func:`make_cache_prefill` over the whole sequence: the same decode step
    at the same positions and batch.

    With ``paged`` the signature becomes ``chunk_step(hybrid, row, slot,
    tokens, n, start_pos)``: the cache advanced is slot ``slot`` of the
    hybrid cache, its pages addressed through its ``(max_pages,)`` table
    ``row`` (a device tensor). Each step gathers the slot's view
    (:meth:`PagedLayout.gather_slot`), runs the decode step on it with every
    one of the B rows holding that view, scatters row ``slot`` back (row 0
    when B is 1) and ORs in the row's page probe at the step's position.
    A serving lane passes its sequence in every row of the slots' batch, so
    the products have the slot step's shapes (module docstring).
    """
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    step = make_decode_step(model)

    def check(tokens, n):
        if tokens.dim() != 2 or tokens.shape[1] > chunk or not 0 <= n <= tokens.shape[1]:
            raise ValueError(f"tokens {tuple(tokens.shape)} and n {n} do not "
                             f"fit a chunk of {chunk}")

    if paged is not None:
        def paged_chunk_step(hybrid, row, slot: int, tokens, n: int,
                             start_pos: int):
            check(tokens, n)
            B = tokens.shape[0]
            if B > 1 and not 0 <= slot < B:
                raise ValueError(f"slot {slot} is no row of tokens "
                                 f"{tuple(tokens.shape)}")
            keep = slot if B > 1 else 0

            def slot_step(_, tok, p: int):
                view = paged.gather_slot(hybrid, row, slot)
                rows = {name: _rows(v, CACHE_LAYOUT[name].slot_axis, B)
                        for name, v in view.items()}
                logits, w = step(rows, tok, p)
                paged.scatter_slot(hybrid, {
                    name: v.narrow(CACHE_LAYOUT[name].slot_axis, keep, 1)
                    for name, v in rows.items()}, row, slot)
                pos = torch.full((1,), p, dtype=torch.int32,
                                 device=model.device)
                return logits, w | paged.probe(row[None], pos)[0]

            return _feed(model, slot_step, hybrid, tokens, n, start_pos)

        return paged_chunk_step

    def chunk_step(cache, tokens, n: int, start_pos: int):
        check(tokens, n)
        return _feed(model, step, cache, tokens, n, start_pos)

    return chunk_step


def _rows(leaf: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """A batch-1 cache leaf repeated into ``n`` rows along its slot axis,
    in the contiguous layout."""
    shape = list(leaf.shape)
    shape[axis] = n
    return leaf.expand(shape).contiguous()


def _feed(model: Model, step, cache, tokens, n: int, start_pos: int):
    """``tokens[:, :n]`` through ``step`` one position at a time: the last
    logits (zeros when ``n == 0``), the cache and the OR of the words."""
    logits = torch.zeros((tokens.shape[0], 1, model.cfg.vocab_size),
                         dtype=torch.float32, device=model.device)
    word = torch.zeros((), dtype=torch.int32, device=model.device)
    for i in range(n):
        logits, w = step(cache, tokens[:, i:i + 1], start_pos + i)
        word = word | w
    return logits, cache, word


def make_cache_prefill(model: Model, *, paged: Optional[PagedLayout] = None):
    """Cache-producing prefill through the decode step::

      prefill(tokens (B, S), max_len, start_pos=0, *, cache=None)
      → (last-position logits (B, 1, V) fp32, cache, word int32 0-d)

    The recompute path of serving LFLR: run over prompt + generated tokens
    it rebuilds a sequence's state exactly (greedy decode is deterministic,
    and the step is the serving one), so recovery never restarts the
    request. ``cache`` is a cache of ``model.init_cache(B, max_len)``'s
    shape to fill instead of a new one; it is zeroed first, so a caller that
    prefills often allocates it once.

    The JAX factory's ``fused`` flag chooses between a host loop of jitted
    steps and one jitted ``fori_loop``, which give the same bits; an eager
    PyTorch step has only the loop, so the port has no such flag.

    With ``paged`` the signature becomes ``prefill(hybrid, row, slot,
    tokens, start_pos=0)``: the rebuilt cache is written straight into slot
    ``slot``'s pages through its table ``row``, after a scrub of those pages
    and a reset of the slot's dense leaves, by the paged
    :func:`make_chunked_prefill` over the whole sequence — so a recycled
    page never leaves stale (possibly poisoned) bytes behind.
    """
    step = make_decode_step(model)
    if paged is not None:
        chunked = make_chunked_prefill(model, chunk=paged.max_len, paged=paged)

        def paged_prefill(hybrid, row, slot: int, tokens: torch.Tensor,
                          start_pos: int = 0):
            if tokens.dim() != 2 or tokens.shape[1] == 0:
                raise ValueError(f"tokens must be (B, S>0), got {tuple(tokens.shape)}")
            S = tokens.shape[1]
            if S > paged.max_len:
                raise ValueError(
                    f"prompt of {S} tokens exceeds capacity {paged.max_len}")
            paged.scrub(hybrid, row)
            paged.reset_slot(hybrid, slot)
            return chunked(hybrid, row, slot, tokens, S, start_pos)

        return paged_prefill

    def prefill(tokens: torch.Tensor, max_len: int, start_pos: int = 0, *,
                cache: Optional[dict] = None):
        if tokens.dim() != 2 or tokens.shape[1] == 0:
            raise ValueError(f"tokens must be (B, S>0), got {tuple(tokens.shape)}")
        B, S = tokens.shape
        if S > max_len:
            raise ValueError(f"prompt of {S} tokens exceeds capacity {max_len}")
        if cache is None:
            cache = model.init_cache(B, max_len)
        else:
            for t in cache.values():
                t.zero_()
        return _feed(model, step, cache, tokens, S, start_pos)

    return prefill
