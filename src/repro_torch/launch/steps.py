"""Step factories: the slot-batched decode step, the fused prefill+decode
window, and the full-sequence prefill step.

The port of ``repro/launch/steps.py:244 make_slot_decode_step``,
``:491 make_prefill_decode_window`` and ``:208 make_prefill_step``. The JAX
package vmaps a batch-1 decode step over slots and scans K of them in one
jitted program; PyTorch runs eagerly, so the slots are the batch dimension
of one decode step (each slot at its own position, held in a device tensor)
and the window is a K-step Python loop whose token feedback, positions and
word history never leave the device. Caches are updated in place (the JAX
package donates them).
"""
from __future__ import annotations

import torch

from ..core.detect import logits_probe, state_probe
from ..models.model import Model


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
        toks, words = [], []
        tok, p = tokens, pos
        for k in range(window):
            inp = torch.where(k < rem, chunk[k], tok)
            logits, w = slot_step(caches, inp, p)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            toks.append(tok)
            words.append(w)
            p = p + 1
        return torch.stack(toks), torch.stack(words), tok, p

    return window_step
