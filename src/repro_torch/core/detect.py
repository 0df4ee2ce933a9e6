"""Soft-fault probes (paper §II-A) for the serving and prefill steps.

The port of ``repro/core/detect.py`` for the serve path. The JAX serving
step probes ``loss_probe(max|logits|)`` with a divergence threshold of
``inf``: NONFINITE_LOSS exactly when some logit is NaN or ±inf. The port
computes the same word per slot with the ``probe_rows`` kernel over the
``(slots, vocab)`` fp32 logits (its overflow branch, DIVERGENCE, cannot fire
at an infinite threshold). For recurrent architectures the JAX step also
runs ``state_probe`` over the recurrent state (``h`` for RG-LRU, ``ssm``
for Mamba-2); the port runs the same kernel over that state viewed as
``(slots, everything else)``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..kernels.fault_probe import probe_rows
from .errors import ErrorCode


@dataclass(frozen=True)
class ProbeConfig:
    loss_divergence_threshold: float


# the serving word: non-finite logits only (the JAX serve steps' threshold)
SERVE_PROBES = ProbeConfig(loss_divergence_threshold=math.inf)


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
