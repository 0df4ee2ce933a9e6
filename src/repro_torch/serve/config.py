# Trimmed copy of repro/serve/config.py: EngineConfig and its flag parser, without buffer donation.
"""EngineConfig — the one validated construction surface for serving engines.

Every engine-shape knob lives here, validated once in ``__post_init__``;
:meth:`EngineConfig.from_flags` parses the ``"win=8,spec=1,dlen=3"`` strings
of command-line tools. Runtime wiring (queues, tracers, clocks, injectors)
stays out.
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
    step with the first ``draft_layers`` layers. ``trace=True`` gives a
    :class:`~repro_torch.serve.ServeGroup` one tracer per rank, keeping the
    request-scoped events of a ``trace_sample`` share of the requests (a
    :class:`~repro_torch.serve.Replica` takes a ``Tracer`` directly).
    ``tp > 1`` stays a switch only: the port's replica raises
    ``NotImplementedError`` on it, naming ROADMAP item 11. JAX's buffer
    donation (``donate``) has no field: the port's caches update in place.
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
    # ---- tensor parallelism (not ported yet: ROADMAP item 11) -----------
    tp: int = 1
    # ---- tracing (consumed by ServeGroup; a Replica takes a Tracer) -------
    trace: bool = False
    trace_sample: float = 1.0

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
        if not 0.0 <= self.trace_sample <= 1.0:
            raise ValueError("trace_sample must be in [0, 1], got "
                             f"{self.trace_sample}")
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

    # ------------------------------------------------------------ construction
    @classmethod
    def from_flags(cls, spec: str, **overrides) -> "EngineConfig":
        """Parse ``"win=8,spec=1,dlen=3,paged=1,page=16"`` into an
        EngineConfig. Bare keys are boolean shorthand (``"paged,spec"`` is
        ``"paged=1,spec=1"``); ``overrides`` apply on top. Unknown keys
        raise: a typo must not configure the default engine."""
        bool_fields = {"overlap", "paged", "speculate", "trace"}
        alias = {
            "win": "window", "window": "window",
            "slots": "num_slots", "num_slots": "num_slots",
            "max_len": "max_len", "eos": "eos_id", "eos_id": "eos_id",
            "retries": "max_request_retries",
            "max_request_retries": "max_request_retries",
            "overlap": "overlap",
            "budget": "prefill_budget", "prefill_budget": "prefill_budget",
            "page": "page_size", "page_size": "page_size",
            "paged": "paged", "pages": "page_budget",
            "page_budget": "page_budget",
            "watermark": "page_watermark", "page_watermark": "page_watermark",
            "spec": "speculate", "speculate": "speculate",
            "dlen": "draft_len", "draft_len": "draft_len",
            "dlayers": "draft_layers", "draft_layers": "draft_layers",
            "tp": "tp", "trace": "trace", "trace_sample": "trace_sample",
        }
        kw: dict = {}
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            k, _, v = part.partition("=")
            if k not in alias:
                raise ValueError(
                    f"unknown engine flag {k!r} (known: "
                    f"{sorted(set(alias))})")
            field = alias[k]
            if not v:
                if field not in bool_fields and field != "window":
                    raise ValueError(f"engine flag {k!r} needs a value")
                kw[field] = True if field in bool_fields else kw.get(field, 0)
                continue
            if field in bool_fields:
                kw[field] = bool(int(v))
            elif field == "trace_sample":
                kw[field] = float(v)
            else:
                kw[field] = int(v)
            # ``page=16`` means a paged pool of 16-position pages
            if k == "page" and int(v) > 0:
                kw["paged"] = True
        kw.update(overrides)
        return cls(**kw)
