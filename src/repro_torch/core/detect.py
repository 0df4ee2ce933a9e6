"""Soft-fault probes (paper §II-A 'soft failures') for the serving, prefill
and train steps.

The port of ``repro/core/detect.py``. Each probe returns an int32 error word
on the device (the :class:`~repro_torch.core.errors.ErrorCode` lattice);
words combine with bitwise-or and ride the in-band device channel. The heavy
probes run the fault-probe kernel: the whole gradient or parameter stream in
one ``probe_tree`` launch, the logits and the recurrent state through
``probe_rows``.

The JAX serving step probes ``loss_probe(max|logits|)`` with a divergence
threshold of ``inf``: NONFINITE_LOSS exactly when some logit is NaN or ±inf.
The port computes the same word per slot with the ``probe_rows`` kernel over
the ``(slots, vocab)`` fp32 logits (its overflow branch, DIVERGENCE, cannot
fire at an infinite threshold). For recurrent architectures the JAX step
also runs ``state_probe`` over the recurrent state (``h`` for RG-LRU,
``ssm`` for Mamba-2); the port runs the same kernel over that state viewed
as ``(slots, everything else)``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

# probe_tree: the JAX package's name, one kernel launch over a whole tree
from ..kernels.fault_probe import probe_rows, probe_tree
from .device_channel import WORD_DTYPE, combine_words
from .errors import ErrorCode


@dataclass(frozen=True)
class ProbeConfig:
    overflow_threshold: float = 1e4      # pre-NaN early warning on grads
    loss_divergence_threshold: float = 1e3
    router_drop_threshold: float = 0.5   # MoE: fraction of dropped tokens
    probe_params: bool = False           # post-update param check (2x memory traffic)


# the serving word: non-finite logits only (the JAX serve steps' threshold)
SERVE_PROBES = ProbeConfig(loss_divergence_threshold=math.inf)


def _flag(cond: torch.Tensor, code: ErrorCode) -> torch.Tensor:
    return torch.where(cond, int(code), 0).to(WORD_DTYPE)


def loss_probe(loss: torch.Tensor, cfg: ProbeConfig = ProbeConfig()) -> torch.Tensor:
    """NONFINITE_LOSS | DIVERGENCE (paper: 'a solver could diverge')."""
    loss = loss.float()
    finite = torch.isfinite(loss)
    return (_flag(~finite, ErrorCode.NONFINITE_LOSS)
            | _flag(finite & (loss > cfg.loss_divergence_threshold),
                    ErrorCode.DIVERGENCE))


def grad_probe(grads, cfg: ProbeConfig = ProbeConfig()) -> torch.Tensor:
    """NONFINITE_GRAD | OVERFLOW over the whole gradient tree."""
    return probe_tree(grads, cfg.overflow_threshold,
                      nonfinite_code=int(ErrorCode.NONFINITE_GRAD),
                      overflow_code=int(ErrorCode.OVERFLOW))


def param_probe(params, cfg: ProbeConfig = ProbeConfig()) -> torch.Tensor:
    return probe_tree(params, math.inf,
                      nonfinite_code=int(ErrorCode.NONFINITE_PARAM),
                      overflow_code=int(ErrorCode.OVERFLOW))


def router_probe(dropped_fraction: torch.Tensor,
                 cfg: ProbeConfig = ProbeConfig()) -> torch.Tensor:
    """MoE local misbehaviour: ROUTER_OVERFLOW when more than
    ``router_drop_threshold`` of the routed tokens were dropped (capacity
    overflow)."""
    return _flag(dropped_fraction > cfg.router_drop_threshold,
                 ErrorCode.ROUTER_OVERFLOW)


def data_probe(tokens: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Corrupt-batch check: token ids outside [0, vocab)."""
    return _flag(((tokens < 0) | (tokens >= vocab_size)).any(),
                 ErrorCode.DATA_FAULT)


def logits_probe(logits: torch.Tensor) -> torch.Tensor:
    """Per-row serving word over ``logits (rows, vocab)``: NONFINITE_LOSS for
    a row with a NaN/±inf (DIVERGENCE cannot fire at the infinite threshold
    of :data:`SERVE_PROBES`). int32 ``(rows,)`` on the logits' device."""
    return probe_rows(logits, SERVE_PROBES.loss_divergence_threshold,
                      nonfinite_code=int(ErrorCode.NONFINITE_LOSS),
                      overflow_code=int(ErrorCode.DIVERGENCE))


def state_probe(state: torch.Tensor) -> torch.Tensor:
    """Per-slot recurrent-state word over ``state (slots, ...)`` (every
    layer's state of the slot, ``h`` or ``ssm``): STATE_FAULT for a
    NaN/±inf — the JAX ``state_probe`` at threshold ``inf``, whose overflow
    code is STATE_FAULT too. Only the state is probed, as the JAX step picks
    only the ``h``/``ssm`` leaves, not ``conv``. int32 ``(slots,)`` on the
    state's device."""
    code = int(ErrorCode.STATE_FAULT)
    return probe_rows(state.reshape(state.shape[0], -1), math.inf,
                      nonfinite_code=code, overflow_code=code)


def step_probe(loss: torch.Tensor, grads, *, tokens: Optional[torch.Tensor] = None,
               vocab_size: Optional[int] = None,
               router_dropped: Optional[torch.Tensor] = None,
               cfg: ProbeConfig = ProbeConfig()) -> torch.Tensor:
    """Combined per-step error word: the standard probe set for a train step
    (the JAX package's, less its ``states`` argument, which its train step
    never passes). ``router_dropped``, an MoE model's dropped fraction, adds
    the router probe."""
    words = [loss_probe(loss, cfg), grad_probe(grads, cfg)]
    if tokens is not None and vocab_size is not None:
        words.append(data_probe(tokens, vocab_size))
    if router_dropped is not None:
        words.append(router_probe(router_dropped, cfg))
    return combine_words(*words)
