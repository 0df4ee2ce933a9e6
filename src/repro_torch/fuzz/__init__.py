# Copy of repro/fuzz/__init__.py, over the engines the port runs.
"""Coverage-guided fault-injection fuzzer for the port's serving stack.

The port of ``repro.fuzz``: it drives the port's engines (stepwise,
windowed, overlapped, paged and speculative replicas, the ULFM
ServeGroup, and the multi-host fleet of worker processes) end to end with seeded, reproducible fault trajectories;
measures coverage over the derived (error code × recovery action × engine)
matrix; judges every run against the stack's own contracts (bit-exactness,
zero drops, ledger invariants, trace causality); and minimizes
counterexamples into corpus entries of the JAX package's format. The
``overlap_tp`` engine waits for ROADMAP item 11.
"""
from .campaign import CampaignReport, FuzzCampaign, load_entry, minimize, write_entry
from .coverage import Cell, CoverageDB, action_ladder, reachable_cells
from .mutator import FaultMutator
from .runner import RunResult, run_trajectory, use_model
from .trajectory import (
    ENGINES,
    GROUP_ENGINE,
    MULTIHOST_ENGINE,
    PORT_ENGINES,
    SINGLE_ENGINES,
    Op,
    Trajectory,
)

__all__ = [
    "CampaignReport", "FuzzCampaign", "load_entry", "minimize", "write_entry",
    "Cell", "CoverageDB", "action_ladder", "reachable_cells",
    "FaultMutator", "RunResult", "run_trajectory", "use_model",
    "ENGINES", "GROUP_ENGINE", "MULTIHOST_ENGINE", "PORT_ENGINES",
    "SINGLE_ENGINES", "Op",
    "Trajectory",
]
