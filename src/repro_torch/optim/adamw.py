"""AdamW with global-norm clipping and a warmup + cosine LR schedule.

The port of ``repro/optim/adamw.py``: a pure-function optimizer over a
params dict (a train state's ``"params"``), fp32 moments of the same
structure, every scalar a tensor on the params' device, so a step needs no
host sync. Sums over the leaves (the global norm) run in the dict's order,
which the port builds as the JAX tree's flatten order
(:func:`repro_torch.weights.param_order`); each leaf's update is its own
elementwise pass, as the JAX package's, so no sum crosses leaves but the
norm's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..tree import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay (fp32 0-d tensor on ``step``'s device)."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_opt_state(params: dict) -> dict:
    """fp32 zero moments ``{"m": ..., "v": ...}`` shaped like ``params``."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares (fp32), the leaves
    summed in the tree's order."""
    total = None
    for g in tree_leaves(tree):
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """``(grads scaled to at most max_norm in global norm, the norm)``."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def adamw_update(cfg: AdamWConfig, params: dict, grads: dict, opt_state: dict,
                 step: torch.Tensor, *, lr_scale=1.0):
    """One AdamW step; returns ``(new_params, new_opt_state, stats)``, all
    new tensors (the inputs are left as they were: the executor may discard
    the step). Each gradient is clipped as :func:`clip_by_global_norm` does
    (scaled in fp32, rounded to its dtype) inside its leaf's update, so no
    clipped copy of the whole gradient tree is held at once."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(cfg, step) * lr_scale
    t = (step + 1).float()
    bc1 = 1.0 - torch.pow(cfg.b1, t)
    bc2 = 1.0 - torch.pow(cfg.b2, t)

    def upd(p, g, m, v):
        gf = (g.float() * scale).to(g.dtype).float()
        m_ = cfg.b1 * m + (1 - cfg.b1) * gf
        v_ = cfg.b2 * v + (1 - cfg.b2) * torch.square(gf)
        mh = m_ / bc1
        vh = v_ / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m_, v_

    new_p, new_m, new_v = {}, {}, {}
    for name, p in params.items():
        new_p[name], new_m[name], new_v[name] = upd(
            p, grads[name], opt_state["m"][name], opt_state["v"][name])
    return new_p, {"m": new_m, "v": new_v}, {"grad_norm": gnorm, "lr": lr}


def reset_moments(opt_state):
    """Paper use case 2 ('hierarchical escalation'): reset the solver state —
    the optimizer-moments analogue of a Krylov restart — keeping the params."""
    return tree_map(torch.zeros_like, opt_state)
