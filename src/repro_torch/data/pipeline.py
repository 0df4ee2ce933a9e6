"""Deterministic, shardable, checkpointable synthetic LM data pipeline.

The port of ``repro/data/pipeline.py``. Every batch is a pure function of
(seed, step, shard), drawn by the same numpy generator as the JAX package's,
so the tokens are bit-equal to its; they are handed over as int32 tensors on
the consumer's device (pinned and copied without a host sync on a card).
The iterator's state is one integer that travels inside checkpoints; after
an elastic shrink the surviving hosts re-shard the stream by changing
``num_shards``/``shard`` only.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..models.model import resolve_device


@dataclass
class PipelineConfig:
    vocab_size: int
    seq_len: int
    batch_size: int            # per-shard batch
    seed: int = 0
    num_shards: int = 1
    shard: int = 0
    family: str = "lm"         # lm | audio | vlm
    d_model: int = 0           # audio/vlm stubs
    img_tokens: int = 0


def _batch_rng(cfg: PipelineConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        (cfg.seed * 1_000_003 + step) * 65_521 + cfg.shard)


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(arr)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def make_batch(cfg: PipelineConfig, step: int, device=None) -> dict:
    """Pure function of (config, step): ``{"labels", "tokens"}`` int32
    ``(batch, seq)`` on ``device`` (``cuda`` unless the caller passes
    another)."""
    if cfg.family != "lm":
        raise NotImplementedError(
            f"{cfg.family!r} batches (frame / patch embeddings) are not "
            "ported: ROADMAP Queue 1, item 14")
    device = resolve_device(device)
    rng = _batch_rng(cfg, step)
    B, S, V = cfg.batch_size, cfg.seq_len, cfg.vocab_size
    # structured stream: per-sequence drift + short-range repetition
    base = rng.integers(0, V, size=(B, 1))
    drift = rng.integers(-3, 4, size=(B, S)).cumsum(axis=1)
    noise = rng.integers(0, V // 8 + 1, size=(B, S))
    tokens = np.abs(base + drift * (V // 64 + 1) + noise) % V
    tokens = tokens.astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = tokens[:, 0]
    return {"labels": _to_device(labels, device),
            "tokens": _to_device(tokens, device)}


@dataclass
class DataIterator:
    """Stateful wrapper with a checkpointable cursor; batches on ``device``."""

    cfg: PipelineConfig
    step: int = 0
    device: Any = field(default=None, compare=False)  # resolved at init

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)

    def __iter__(self) -> "DataIterator":
        return self

    def __next__(self) -> dict:
        b = make_batch(self.cfg, self.step, self.device)
        self.step += 1
        return b

    # --- checkpoint / elastic hooks ---
    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed,
                "shard": self.cfg.shard, "num_shards": self.cfg.num_shards}

    def load_state_dict(self, s: dict) -> None:
        self.step = int(s["step"])

    def reshard(self, num_shards: int, shard: int) -> "DataIterator":
        """Elastic shrink: same stream, new shard layout, same cursor."""
        new_cfg = dataclasses.replace(self.cfg, num_shards=num_shards,
                                      shard=shard)
        return DataIterator(new_cfg, step=self.step, device=self.device)
