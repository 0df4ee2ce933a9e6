# Trimmed copy of repro/serve/config.py: EngineConfig without the knobs of unported modes or the flag parser.
"""EngineConfig — the one validated construction surface for serving engines.

Every engine-shape knob lives here, validated once in ``__post_init__``.
Runtime wiring (queues, clocks, injectors) stays out.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class EngineConfig:
    """Shape of one serving engine. Frozen, hashable, validated.

    The fields keep the JAX package's names, defaults and cross-field
    rules: ``EngineConfig()`` is the stepwise engine (``window=0``) in both
    packages. ``paged=True`` (window mode only) pools the K/V leaves of
    capacity ``max_len`` into ``page_budget`` pages of ``page_size``
    positions (``None``: ``num_slots * max_len // page_size``), and admits a
    request only while ``page_watermark`` pages stay free.
    ``speculate=True`` (window and overlap) drafts ``draft_len`` tokens a
    step with the first ``draft_layers`` layers. The knobs of modes the port
    does not run yet (trace sampling, donation) are left out; their switches
    stay, so the port's :class:`~repro_torch.serve.Replica` can raise
    ``NotImplementedError`` on ``tp > 1`` and ``trace``, naming the ROADMAP
    item that ports each.
    """

    num_slots: int = 4
    max_len: int = 64
    eos_id: Optional[int] = None
    max_request_retries: int = 2
    # ---- decode windows ------------------------------------------------
    window: int = 0
    overlap: bool = True
    prefill_budget: Optional[int] = None
    # ---- paged KV pool -------------------------------------------------
    paged: bool = False
    page_size: int = 8
    page_budget: Optional[int] = None
    page_watermark: int = 0
    # ---- speculative windows -------------------------------------------
    speculate: bool = False
    draft_len: int = 3
    draft_layers: int = 1
    # ---- modes not ported yet --------------------------------------------
    tp: int = 1
    trace: bool = False

    def __post_init__(self):
        if self.num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {self.num_slots}")
        if self.max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {self.max_len}")
        if self.max_request_retries < 0:
            raise ValueError("max_request_retries must be >= 0, got "
                             f"{self.max_request_retries}")
        if self.window < 0:
            raise ValueError(f"window must be >= 0, got {self.window}")
        if self.prefill_budget is not None and self.prefill_budget < 1:
            raise ValueError("prefill_budget must be >= 1 (or None), got "
                             f"{self.prefill_budget}")
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.page_budget is not None and self.page_budget < 1:
            raise ValueError("page_budget must be >= 1 (or None), got "
                             f"{self.page_budget}")
        if self.page_watermark < 0:
            raise ValueError("page_watermark must be >= 0, got "
                             f"{self.page_watermark}")
        if self.draft_len < 1:
            raise ValueError(f"draft_len must be >= 1, got {self.draft_len}")
        if self.draft_layers < 1:
            raise ValueError("draft_layers must be >= 1, got "
                             f"{self.draft_layers}")
        # cross-field rules
        if self.paged and not self.window:
            raise ValueError("paged=True requires window mode (window=K)")
        if self.speculate and not self.window:
            raise ValueError("speculate=True requires window mode (window=K)")
        if self.speculate and not self.overlap:
            raise ValueError(
                "speculate=True requires overlap=True (admission/LFLR must "
                "ride the window: the blocking-prefill patch path assumes a "
                "host-predictable position chain)")
        if self.tp < 1:
            raise ValueError(f"tp must be >= 1, got {self.tp}")
        if self.tp > 1 and not self.window:
            raise ValueError(
                "tp>1 requires window mode (window=K): the cross-shard "
                "error-word fold lives in the window enumeration")
        if self.tp > 1 and not self.overlap:
            raise ValueError(
                "tp>1 requires overlap=True: admission/LFLR must ride the "
                "sharded windows (the blocking prefill path is single-device)")
