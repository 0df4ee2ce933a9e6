"""Elastic scaling: continue training after losing ranks.

The port of ``repro/launch/elastic.py``'s multi-controller elastic trainer
(:func:`elastic_train`): the paper's full choreography on the thread-rank
runtime — data-parallel ranks, gradient all-reduce through
``Comm``/``Future`` (waits raise the paper's exceptions), soft faults
propagated via ``signal_error``, hard faults (rank kill) detected by ULFM,
survivors ``shrink``, restore the lost shard's contribution from the buddy
store, re-partition the stream, and keep training. This is use case 1
(LFLR) + use case 3 (rollback fallback) of the paper, driving real training.

The model is the reference's 16-dim linear regression, its local gradient
the analytic gradient of the same mean squared error in fp32 on ``device``
(cuda unless the caller passes ``"cpu"``); the all-reduce runs in float64
numpy, as the reference's. The reference's single-controller re-mesh
(``shrink_remesh``) re-shards a train state over its ``sharding/`` rules and
waits for tensor parallelism (ROADMAP item 11).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..checkpoint import BuddyStore
from ..core import (
    CommCorruptedError,
    ErrorCode,
    PropagatedError,
    initialize,
    run_ranks,
)
from ..core.faults import FaultSchedule, apply_host_fault
from ..models.model import pin_matmul_precision, resolve_device


@dataclass
class ElasticResult:
    rank: int
    steps_done: int = 0
    final_loss: float = float("nan")
    world_sizes: list = field(default_factory=list)
    events: list = field(default_factory=list)
    weights: Optional[np.ndarray] = None


def _local_grad(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Loss and gradient of ``mean((x @ w - y) ** 2)`` in w (tiny
    data-parallel linear regression — the protocol under test is the
    communication/recovery choreography, not the model)."""
    d = x @ w - y
    return torch.mean(d * d), x.T @ ((2.0 / d.numel()) * d)


def elastic_train(nranks: int, steps: int, *, dim: int = 16, lr: float = 0.1,
                  faults: FaultSchedule | None = None, seed: int = 0,
                  timeout: float = 30.0, device=None) -> list:
    """Run the elastic trainer on ``nranks`` simulated hosts; returns per-rank
    RankResults of ElasticResult. Survivors finish all ``steps`` even if
    ranks die."""
    faults = faults or FaultSchedule()
    buddies = BuddyStore(nranks)
    dev = resolve_device(device)
    pin_matmul_precision()               # fp32 products in fp32 on the card

    # ground-truth weights for the regression stream
    rng = np.random.default_rng(seed)
    w_true = rng.standard_normal((dim, 1)).astype(np.float32)

    def rank_fn(ctx):
        inst = initialize(ctx, default_timeout=timeout)
        comm = inst.comm_world()
        res = ElasticResult(rank=ctx.rank)
        w = torch.zeros((dim, 1), dtype=torch.float32, device=dev)
        step = 0
        while step < steps:
            res.world_sizes.append(comm.size)
            # host-level faults for this rank at this step
            for spec in faults.at(step, ctx.rank):
                if spec.kind == "kill":
                    apply_host_fault(spec, ctx)     # never returns
            # deterministic per-(rank, step) batch over the *current* membership
            bg = np.random.default_rng(1000 * step + comm.rank)
            x = bg.standard_normal((8, dim)).astype(np.float32)
            y = x @ w_true
            loss, g = _local_grad(w, torch.from_numpy(x).to(dev),
                                  torch.from_numpy(y).to(dev))
            code = 0
            for spec in faults.at(step, ctx.rank):
                if spec.kind == "nan_grad":
                    g = torch.full_like(g, float("nan"))
            if not bool(torch.isfinite(g).all()):
                code = int(ErrorCode.NONFINITE_GRAD)
            try:
                if code:
                    comm.signal_error(code)     # raises PropagatedError locally
                fut = comm.all_reduce(g.cpu().numpy().astype(np.float64), op="sum")
                g_sum = fut.wait()
                w = w - lr * torch.as_tensor(g_sum, dtype=torch.float32,
                                             device=dev) / comm.size
                step += 1
                res.steps_done += 1
                if step % 5 == 0:
                    buddies.push(comm.rank, step, {"w": w})
            except PropagatedError as e:
                # LFLR: skip the poisoned update everywhere, keep going
                res.events.append(("propagated", step, [err.rank for err in e.errors]))
                step += 1
                continue
            except CommCorruptedError:
                # hard fault: shrink, recover from buddy coverage, continue
                comm.shrink_to_survivors()
                got = None
                for r in buddies.ranks_covered():
                    got = buddies.recover(r)
                    if got is not None:
                        break
                if got is not None:
                    ck_step, shard = got
                    w = torch.as_tensor(shard["w"], device=dev)
                    step = ck_step
                res.events.append(("shrink", step, comm.size))
                continue
        res.final_loss = float(loss)
        res.weights = w.cpu().numpy()
        return res

    return run_ranks(nranks, rank_fn, ulfm=True, join_timeout=timeout * 4)
