"""Step factories: the decode steps (one word for the batch, or one per
slot), the decode windows (plain, and fused with prompt chunks), the
cache-building prefills (chunked and whole) and the full-sequence prefill
step.

The port of ``repro/launch/steps.py:226 make_decode_step``, ``:244
make_slot_decode_step``, ``:404 make_decode_window``, ``:491
make_prefill_decode_window``, ``:791 make_chunked_prefill``, ``:867
make_cache_prefill`` and ``:208 make_prefill_step``. The JAX package vmaps
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

from ..core.detect import logits_probe, state_probe
from ..models.model import Model


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
        if model.state_leaf is not None:
            word = word | state_probe(cache[model.state_leaf]).amax()
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
    state ORs in the state word over the updated state leaf, ``h`` or
    ``ssm`` (the JAX decode step's ``state_probe`` over the leaves its
    ``_recurrent_states`` picks; never ``conv``), one more probe launch per
    step.
    """

    def step(caches, tokens, pos):
        logits = model.decode_step(tokens[:, None], caches, pos)[:, 0]
        words = logits_probe(logits)
        if model.state_leaf is not None:
            words = words | state_probe(caches[model.state_leaf])
        return logits, words

    return step


def make_prefill_step(model: Model):
    """Full-sequence prefill::

      prefill_step(tokens (B, S) int) → (logits (B, S, V) fp32, word)

    ``word`` is the JAX step's one word for the batch,
    ``loss_probe(max|logits|)`` at threshold ``inf``: NONFINITE_LOSS iff
    some logit is NaN or ±inf. The probe kernel gives one word per row of
    ``logits.view(B * S, V)`` and the rows fold on the device; the row
    words are 0 or that one code, so their max is their OR. ``word`` is an
    int32 0-d tensor on the model's device (nothing is read back).
    """

    def prefill_step(tokens):
        logits = model(tokens)
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


def make_decode_window(model: Model, *, window: int):
    """Pipelined decode window: K slot-decode steps with the greedy token
    fed back on the device and no prompt feed::

      window_step(caches, tokens, pos)
        tokens  (S,) int32     input token per slot
        pos     (S,) int32     per-slot position at the window's first step
      → (tokens (K, S) int32, words (K, S) int32,
         next_tok (S,) int32, next_pos (S,) int32)   all on the device

    The same loop as :func:`make_prefill_decode_window` without its chunk
    feed, so the two are bit-equal when no lane takes a chunk (``rem = 0``).
    """
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    slot_step = make_slot_decode_step(model)

    def window_step(caches, tokens, pos):
        return _window_loop(slot_step, window, caches, tokens, pos)

    return window_step


def make_prefill_decode_window(model: Model, *, window: int):
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
    """
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    slot_step = make_slot_decode_step(model)

    def window_step(caches, tokens, pos, chunk, rem):
        return _window_loop(slot_step, window, caches, tokens, pos,
                            lambda k, tok: torch.where(k < rem, chunk[k], tok))

    return window_step


def make_chunked_prefill(model: Model, *, chunk: int):
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
    """
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    step = make_decode_step(model)

    def chunk_step(cache, tokens, n: int, start_pos: int):
        if tokens.dim() != 2 or tokens.shape[1] > chunk or not 0 <= n <= tokens.shape[1]:
            raise ValueError(f"tokens {tuple(tokens.shape)} and n {n} do not "
                             f"fit a chunk of {chunk}")
        return _feed(model, step, cache, tokens, n, start_pos)

    return chunk_step


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


def make_cache_prefill(model: Model):
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
    """
    step = make_decode_step(model)

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
