"""Plain PyTorch version of the fault probe (the CPU path and the oracle the
CUDA kernel is held against)."""
from __future__ import annotations

import torch

from ...tree import tree_leaves


def probe_rows_ref(x: torch.Tensor, threshold: float, *, nonfinite_code: int,
                   overflow_code: int) -> torch.Tensor:
    """One int32 word per row of ``x (R, N)``: ``nonfinite_code`` if the row
    holds a NaN/±inf, ``overflow_code`` if a finite value has
    ``|x| > threshold``."""
    xf = x.float()
    finite = torch.isfinite(xf)
    nonfinite = ~finite.all(dim=1)
    over = (torch.where(finite, xf.abs(), torch.zeros_like(xf))
            > threshold).any(dim=1)
    zero = torch.zeros((), dtype=torch.int32, device=x.device)
    return (torch.where(nonfinite, torch.full_like(zero, nonfinite_code), zero)
            | torch.where(over, torch.full_like(zero, overflow_code), zero))


def probe_tree_ref(tree, threshold: float, *, nonfinite_code: int,
                   overflow_code: int) -> torch.Tensor:
    """One 0-d int32 word over a tree: the OR of each floating leaf's
    word, each leaf compared in fp32 as one row (non-floating leaves are
    skipped, an empty leaf gives 0). The reference's ``probe_tree_ref``."""
    leaves = tree_leaves(tree)
    word = torch.zeros((), dtype=torch.int32,
                       device=leaves[0].device if leaves else "cpu")
    for leaf in leaves:
        if torch.is_floating_point(leaf):
            word = word | probe_rows_ref(leaf.reshape(1, -1), threshold,
                                         nonfinite_code=nonfinite_code,
                                         overflow_code=overflow_code)[0]
    return word
