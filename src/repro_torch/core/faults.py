# Port of repro/core/faults.py: the plan, the injectable-code mask, the host faults and the device helpers.
"""Deterministic fault injection (testing + benchmarks).

Covers the paper's fault taxonomy (§II-A): soft faults that leave the rank
able to communicate and hard faults (rank/node loss), plus stragglers. A
:class:`FaultSchedule` is a seeded list of :class:`FaultSpec`; the serve
group executes ``kill``/``shard_kill`` as a rank death and ``state_nan``
through ``Replica.inject_state_fault``. Two injection surfaces:

* **inside-step** (device): the train step takes an ``inject`` word (an
  int32 0-d tensor on the step's device) and the helpers below turn its bits
  into a NaN'd loss, corrupted gradients or an invalid token id with device
  ops — no host sync, so detection is exercised on the real path;
* **host-level** (simulated cluster): kill a rank thread, delay a rank
  (straggler), a user error.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..tree import tree_leaves
from .errors import ATTRIBUTION_ONLY, ErrorCode

# injection bits (distinct from ErrorCode — these say what to *break*, the
# probes decide what they *see*)
INJ_NAN_LOSS = 1 << 0
INJ_NAN_GRAD = 1 << 1
INJ_SPIKE_LOSS = 1 << 2
INJ_BAD_DATA = 1 << 3
INJ_STATE_NAN = 1 << 4

_INJ_BITS = {
    "nan_loss": INJ_NAN_LOSS,
    "nan_grad": INJ_NAN_GRAD,
    "spike_loss": INJ_SPIKE_LOSS,
    "bad_data": INJ_BAD_DATA,
    "state_nan": INJ_STATE_NAN,
}
# host-level faults executed on the simulated cluster (not via inject
# words). "shard_kill" is the tensor-parallel hard fault: it takes the whole
# owning replica down. "host_kill"/"host_stop" are process-level faults of a
# multihost worker, executed only by a supervisor that owns the processes
_HOST_KINDS = frozenset({"kill", "shard_kill", "straggle", "user",
                         "host_kill", "host_stop"})
# every legal FaultSpec.kind: the device-word kinds, the host kinds, and
# "code" (inject a raw ErrorCode word in-band)
KNOWN_KINDS = frozenset(_INJ_BITS) | _HOST_KINDS | {"code"}

# every defined soft / structural class except the attribution-only lanes
# (injecting DRAFT_REJECT as a fault would make a reject-only window raise)
# and the hard-fault bits (a word cannot take a rank down)
_DEFINED_MASK = 0
for _c in ErrorCode:
    _DEFINED_MASK |= _c.value
_HARD_MASK = int(ErrorCode.RANK_FAILED | ErrorCode.COMM_CORRUPTED)
INJECTABLE_CODE_MASK = _DEFINED_MASK & ~int(ATTRIBUTION_ONLY) & ~_HARD_MASK


def validate_injectable_code(code: int | ErrorCode) -> int:
    """Check that ``code`` is a nonzero OR of injectable soft/structural
    :class:`ErrorCode` bits; returns the validated int word. Raises
    ``ValueError`` for the empty word, undefined bits, attribution-only
    lanes (``DRAFT_REJECT``) and hard-fault bits."""
    word = int(code)
    if word == 0:
        raise ValueError("cannot inject ErrorCode.OK (empty fault word)")
    bad = word & ~INJECTABLE_CODE_MASK
    if bad:
        names = [c.name for c in ErrorCode
                 if c.value & bad and c.value & (c.value - 1) == 0
                 and c != ErrorCode.OK]
        raise ValueError(
            f"code {word:#x} is not injectable: offending bits "
            f"{names or [hex(bad)]} (attribution-only lanes like DRAFT_REJECT "
            "and hard-fault bits cannot be injected as device fault words)")
    return word


@dataclass(frozen=True)
class FaultSpec:
    step: int
    kind: str          # nan_loss|nan_grad|spike_loss|bad_data|state_nan|code|kill|shard_kill|straggle|user
    rank: Optional[int] = 0  # None = "a seeded-random alive rank" — resolved
                             # to a concrete rank by FaultSchedule.resolve()
    magnitude: float = 1.0   # straggle: seconds; spike: factor
    code: int = 0            # kind="code": the ErrorCode word to latch in-band
    shard: int = 0           # kind="shard_kill": which model-mesh shard dies

    @property
    def inject_bit(self) -> int:
        return _INJ_BITS.get(self.kind, 0)


@dataclass
class FaultSchedule:
    """A deterministic, fully seedable fault plan.

    ``seed`` drives every random choice the schedule (or a consumer holding
    it) makes: :meth:`resolve` materialises ``rank=None`` wildcard specs
    into concrete ranks, and :meth:`rng_for` derives a per-(rank, step)
    generator for consumer-side choices (which active slot a ``state_nan``
    poisons) — so a trajectory replays bit for bit from ``(specs, seed)``.
    """

    specs: Sequence[FaultSpec] = ()
    seed: int = 0

    def at(self, step: int, rank: int | None = None) -> list[FaultSpec]:
        return [s for s in self.specs
                if s.step == step and (rank is None or s.rank == rank)]

    def inject_word(self, step: int, rank: int | None = None) -> int:
        """OR of the INJ_* device-injection bits scheduled for (step, rank).
        Unknown kinds are rejected: a spec that matches no injection surface
        would otherwise be dropped and its test would assert nothing."""
        word = 0
        for s in self.at(step, rank):
            if s.kind not in KNOWN_KINDS:
                raise ValueError(
                    f"unknown fault kind {s.kind!r} (known: "
                    f"{sorted(KNOWN_KINDS)})")
            if s.kind == "code":
                # validated here, so a bad spec fails at schedule time even
                # if the consumer reads only the INJ word
                validate_injectable_code(s.code)
            word |= s.inject_bit
        return word

    def code_word(self, step: int, rank: int | None = None) -> int:
        """OR of the validated in-band ErrorCode words scheduled for
        (step, rank) through ``kind="code"`` specs."""
        word = 0
        for s in self.at(step, rank):
            if s.kind == "code":
                word |= validate_injectable_code(s.code)
        return word

    def device_faults(self) -> list[FaultSpec]:
        return [s for s in self.specs if s.inject_bit or s.kind == "code"]

    def host_faults(self) -> list[FaultSpec]:
        return [s for s in self.specs if s.kind in _HOST_KINDS]

    def rng_for(self, rank: int, step: int) -> np.random.Generator:
        """Per-(rank, step) generator derived from the schedule seed."""
        return np.random.default_rng((int(self.seed), int(rank), int(step)))

    def resolve(self, ranks: Sequence[int]) -> "FaultSchedule":
        """Materialise ``rank=None`` wildcard specs into concrete members of
        ``ranks``, chosen by the schedule's seeded rng. Deterministic and
        idempotent for already-concrete schedules; each wildcard gets an
        independent draw keyed by its spec index."""
        ranks = sorted(int(r) for r in ranks)
        if not ranks:
            raise ValueError("cannot resolve a schedule over zero ranks")
        out = []
        for i, s in enumerate(self.specs):
            if s.rank is None:
                rng = np.random.default_rng((int(self.seed), 0xFA017, i))
                s = dataclasses.replace(s, rank=int(rng.choice(ranks)))
            out.append(s)
        return FaultSchedule(tuple(out), seed=self.seed)


# ------------------------------------------------------------------ device helpers
def _bit(inject: torch.Tensor, bit: int) -> torch.Tensor:
    """0-d bool tensor: is ``bit`` set in the device word ``inject``?"""
    return (inject.to(torch.int32) & bit) != 0


def inject_loss(loss: torch.Tensor, inject: torch.Tensor) -> torch.Tensor:
    """Apply the loss-level injections: NaN for INJ_NAN_LOSS, times 1e6 for
    INJ_SPIKE_LOSS."""
    loss = torch.where(_bit(inject, INJ_NAN_LOSS), float("nan"), loss)
    return torch.where(_bit(inject, INJ_SPIKE_LOSS), loss * 1e6, loss)


def _poison_first(tree, on: torch.Tensor):
    """NaN the first element of every floating leaf of ``tree`` where ``on``
    (a 0-d bool device tensor), IN PLACE: one masked fill per leaf, no
    sync. Returns ``tree``."""
    for leaf in tree_leaves(tree):
        if torch.is_floating_point(leaf):
            leaf.view(-1)[:1].masked_fill_(on, float("nan"))
    return tree


def inject_grads(grads, inject: torch.Tensor):
    """NaN the first element of every gradient leaf when INJ_NAN_GRAD is
    set. The leaves are the step's own gradients and are written in place
    (the JAX package returns new arrays with the same values)."""
    return _poison_first(grads, _bit(inject, INJ_NAN_GRAD))


def inject_batch(tokens: torch.Tensor, inject: torch.Tensor) -> torch.Tensor:
    """Make the first token id invalid (-1) when INJ_BAD_DATA is set (tripped
    by ``data_probe``); a new tensor, ``tokens`` is left as it was."""
    out = tokens.clone()
    out.view(-1)[:1].masked_fill_(_bit(inject, INJ_BAD_DATA), -1)
    return out


def inject_state(state, inject: torch.Tensor):
    """NaN the first element of every floating leaf of ``state`` when
    INJ_STATE_NAN is set, in place (as :func:`inject_grads`)."""
    return _poison_first(state, _bit(inject, INJ_STATE_NAN))


# -------------------------------------------------------------------- host helpers
def apply_host_fault(spec: FaultSpec, ctx=None) -> Optional[ErrorCode]:
    """Execute a host-level fault on the simulated cluster. Returns the error
    code a detector would raise locally, or None for silent faults (kill).
    Only host kinds are accepted: a device-injection spec (or an unknown
    kind) here is a scheduling bug."""
    if spec.kind in ("kill", "shard_kill"):
        if ctx is not None:
            ctx.die()  # unwinds the rank thread (hard fault)
        return None
    if spec.kind == "straggle":
        time.sleep(spec.magnitude)
        return ErrorCode.STRAGGLER
    if spec.kind == "user":
        return ErrorCode.USER
    if spec.kind in ("host_kill", "host_stop"):
        raise ValueError(
            f"apply_host_fault: {spec.kind!r} targets a real OS process and "
            "is executed by the multihost supervisor (it owns the worker "
            "Popen handles) — the thread-rank cluster has nothing to signal")
    raise ValueError(
        f"apply_host_fault: {spec.kind!r} is not a host fault kind "
        f"(host kinds: {sorted(_HOST_KINDS)}; device kinds are injected "
        "in-band)")
