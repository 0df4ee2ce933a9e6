# Copy of repro/roofline/analysis.py with the H100's constants in place of the TPU's.
"""Three-term roofline from the dry run's counts (NVIDIA H100 SXM targets).

    compute    = HLO_FLOPs_global / (chips × peak_FLOP/s)
    memory     = HLO_bytes_global / (chips × HBM_bw)
    collective = collective_bytes_per_device / link_bw
                 (the assignment's 'collective_bytes / (chips × link_bw)' with
                  collective_bytes summed over chips — the SPMD module is
                  per-device, so per-device bytes × chips / (chips × link_bw)
                  reduces to this)

The port's dry run (``launch/dryrun.py``) counts one card's step: FLOPs by
``torch.utils.flop_counter.FlopCounterMode``, bytes at each aten op's (or
hand-written kernel's) boundary by ``roofline/dispatch.py``, both under
``FakeTensorMode``; with one card the per-device numbers are the global
ones, so the terms are per-device times — directly comparable to a
per-step wall clock.
"""
from __future__ import annotations

from dataclasses import dataclass, field

# NVIDIA H100 SXM5 80GB constants (per card), from NVIDIA's data sheet for
# the part at its 700 W limit: a card set to a lower power limit runs below
# them under load
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense bf16 on the tensor cores
HBM_BW = 3.35e12                # B/s, HBM3
ICI_LINK_BW = 450e9
"""B/s per direction of the card's link to its peers. The name is the
reference's (a TPU's inter-chip interconnect); on this card it is NVLink 4
(900 GB/s in both directions together)."""


@dataclass
class RooflineTerms:
    chips: int
    hlo_flops_per_device: float
    hlo_bytes_per_device: float
    collective_bytes_per_device: float
    model_flops: float = 0.0     # 6·N·D (or 6·N_active·D)

    @property
    def compute_s(self) -> float:
        return self.hlo_flops_per_device / PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / ICI_LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def model_flops_ratio(self) -> float:
        """MODEL_FLOPS / HLO_FLOPS_global — 'useful compute' fraction; catches
        remat/redundancy waste. >1 means HLO under-counts (fusion estimates)."""
        total = self.hlo_flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the dominant-term roofline that *useful* model FLOPs
        represent: (MODEL_FLOPS/(chips·peak)) / bound_s. 1.0 = the step is exactly
        as long as the useful math at peak — the hillclimb score."""
        useful_s = self.model_flops / (self.chips * PEAK_FLOPS_BF16)
        return useful_s / self.bound_s if self.bound_s else 0.0

    def to_dict(self) -> dict:
        return {
            "chips": self.chips,
            "hlo_flops_per_device": self.hlo_flops_per_device,
            "hlo_bytes_per_device": self.hlo_bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops_ratio": self.model_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D for training, 2·N·D for inference (fwd only); MoE uses
    active params. D = tokens processed by the step."""
    n = cfg.active_params_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch
