"""Weight and cache bridge between the JAX package's pytrees and the port.

The JAX model stacks the parameters of each block-pattern position over
periods (``periods["b<pos>"]`` leaves carry a leading ``n_per`` axis;
layer ``l`` is period ``l // period``, position ``l % period``) and keeps
remainder layers in ``rest``; the port keeps one module per layer. Trees
cross as numpy arrays — the bridge imports nothing of JAX, so the tests hand
it ``jax.device_get(params)``.

Caches cross both ways, so mid-run states can be compared: the JAX decode
cache (period leaves ``(n_per, B, ...)``, remainder leaves ``(B, ...)``) or
the slot-stacked serve cache (``(S, n_per, 1, ...)`` and ``(S, 1, ...)``,
``slots=True``), against the port's cache: ``k``/``v`` ``(full layers, B,
max_len, Hkv, D)``, ``k_ring``/``v_ring`` ``(sliding layers, B, ring, Hkv,
D)``, the recurrent state ``h`` ``(B, rglru layers, w)`` or ``ssm`` ``(B, ssd
layers, H, P, N)``, and ``conv`` ``(B, recurrent layers, 3, channels)``. A
JAX layer cache names its K/V ``k``/``v`` whatever the layer's kind; the
port's leaf for each is :data:`~repro_torch.models.model.BLOCK_LEAVES`'s.

bfloat16 leaves arrive as ``ml_dtypes.bfloat16`` numpy arrays and go back as
float32 arrays (exact: every bfloat16 is a float32).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .configs.base import ModelConfig
from .models.model import BLOCK_LEAVES, CACHE_LAYOUT, Model, resolve_device

_ATTN = ("wq", "wk", "wv", "wo")
_QK_NORM = ("q_norm", "k_norm")
_RGLRU = ("wx", "wy", "conv_w", "gate_a", "gate_i", "lam", "out")
_SSD = ("in_x", "in_z", "in_B", "in_C", "in_dt", "conv_w", "dt_bias",
        "A_log", "D", "norm_scale", "out")


def _mlp_names(cfg: ModelConfig) -> tuple:
    return ("wi", "wg", "wo") if cfg.mlp_kind in ("swiglu", "geglu") else ("wi", "wo")


def _mixer(cfg: ModelConfig, btype: str) -> tuple[str, tuple]:
    """The block's mixer key in both trees and its leaves."""
    if btype == "rglru":
        return "rglru", _RGLRU
    if btype == "ssd":
        return "ssd", _SSD
    return "attn", _ATTN + (_QK_NORM if cfg.qk_norm else ())


def _to_tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def _fill(param: torch.Tensor, arr, name: str) -> None:
    src = _to_tensor(arr)
    if tuple(src.shape) != tuple(param.shape) or src.dtype != param.dtype:
        raise ValueError(f"{name}: got {src.dtype} {tuple(src.shape)}, the "
                         f"model holds {param.dtype} {tuple(param.shape)}")
    param.copy_(src.to(param.device))


def _layer_paths(cfg: ModelConfig) -> list[tuple]:
    """Where layer ``l`` lives in the JAX tree: ``("periods", key, c)`` or
    ``("rest", i)``."""
    n_scan = cfg.num_periods * cfg.period
    return [("periods", f"b{l % cfg.period}", l // cfg.period) if l < n_scan
            else ("rest", l - n_scan) for l in range(cfg.num_layers)]


def _layer(tree: dict, path: tuple, select) -> Any:
    """The sub-tree of one layer; ``select(leaf, c)`` cuts period ``c`` out
    of a period-stacked leaf."""
    if path[0] == "rest":
        return tree["rest"][path[1]]
    sub = tree["periods"][path[1]]
    return _map(sub, lambda leaf: select(leaf, path[2]))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(tree: dict, cfg: ModelConfig, *, device=None) -> Model:
    """A port model on ``device`` holding the JAX params ``tree`` (numpy)."""
    model = Model(cfg, device=device, seed=None)
    with torch.no_grad():
        _fill(model.embed, tree["embed"]["embedding"], "embed")
        _fill(model.final_norm, tree["final_norm"]["scale"], "final_norm")
        for l, path in enumerate(_layer_paths(cfg)):
            lp = _layer(tree["stack"], path, lambda leaf, c: np.asarray(leaf)[c])
            blk = model.blocks[l]
            _fill(blk.norm1, lp["norm1"]["scale"], f"layer {l} norm1")
            key, names = _mixer(cfg, blk.btype)
            for name in names:
                _fill(getattr(getattr(blk, key), name), lp[key][name],
                      f"layer {l} {key}.{name}")
            if blk.mlp is None:
                continue
            _fill(blk.norm2, lp["norm2"]["scale"], f"layer {l} norm2")
            for name in _mlp_names(cfg):
                _fill(getattr(blk.mlp, name), lp["mlp"][name],
                      f"layer {l} mlp.{name}")
    model.tie_unembed()
    return model


def params_to_numpy(model: Model) -> dict:
    """The JAX param tree layout of ``model``'s weights, as numpy."""
    cfg = model.cfg
    layers = []
    for blk in model.blocks:
        key, names = _mixer(cfg, blk.btype)
        mixer = getattr(blk, key)
        layer = {"norm1": {"scale": _to_numpy(blk.norm1)},
                 key: {n: _to_numpy(getattr(mixer, n)) for n in names}}
        if blk.mlp is not None:
            layer["norm2"] = {"scale": _to_numpy(blk.norm2)}
            layer["mlp"] = {n: _to_numpy(getattr(blk.mlp, n))
                            for n in _mlp_names(cfg)}
        layers.append(layer)
    return {"embed": {"embedding": _to_numpy(model.embed)},
            "stack": _stack(layers, cfg, lambda xs: np.stack(xs)),
            "final_norm": {"scale": _to_numpy(model.final_norm)}}


def _stack(layers: list, cfg: ModelConfig, stack) -> dict:
    """Regroup per-layer trees into the JAX period-stacked layout."""
    periods: dict = {}
    rest = []
    for l, path in enumerate(_layer_paths(cfg)):
        if path[0] == "rest":
            rest.append(layers[l])
        else:
            periods.setdefault(path[1], []).append(layers[l])
    return {"periods": {key: _zip(group, stack) for key, group in periods.items()},
            "rest": rest}


def _zip(trees: list, stack):
    if isinstance(trees[0], dict):
        return {k: _zip([t[k] for t in trees], stack) for k in trees[0]}
    return stack(trees)


def cache_from_jax(tree: dict, cfg: ModelConfig, *, slots: bool = False,
                   device=None) -> dict:
    """Port cache from a JAX decode cache tree (numpy); ``slots=True`` for
    the serve engines' slot-stacked caches."""
    dev = resolve_device(device)
    if slots:
        select = lambda leaf, c: np.asarray(leaf)[:, c, 0]  # noqa: E731
    else:
        select = lambda leaf, c: np.asarray(leaf)[c]  # noqa: E731
    per_layer = []
    for path, b in zip(_layer_paths(cfg), cfg.pattern_layers):
        lc = _layer(tree, path, select)
        if path[0] == "rest" and slots:
            lc = {k: np.asarray(v)[:, 0] for k, v in lc.items()}
        # every leaf (B, ...), under the port's name
        per_layer.append({ours: lc[theirs]
                          for ours, theirs in BLOCK_LEAVES[b].items()})
    cache = {}
    for name, leaf in CACHE_LAYOUT.items():
        # in layer order, so row j of a leaf is the j-th layer holding it
        rows = [_to_tensor(lc[name]) for lc in per_layer if name in lc]
        if rows:
            cache[name] = torch.stack(rows, dim=leaf.layer_axis).to(dev)
    return cache


def cache_to_numpy(cache: dict, cfg: ModelConfig, *, slots: bool = False) -> dict:
    """Inverse of :func:`cache_from_jax`: the JAX cache tree, as numpy."""
    arrays = {name: _to_numpy(t) for name, t in cache.items()}
    index = dict.fromkeys(arrays, 0)
    layers = []
    for b in cfg.pattern_layers:
        lc = {}
        for ours, theirs in BLOCK_LEAVES[b].items():
            row = np.take(arrays[ours], index[ours],
                          axis=CACHE_LAYOUT[ours].layer_axis)
            index[ours] += 1
            lc[theirs] = row[:, None] if slots else row  # per-slot batch of one
        layers.append(lc)
    axis = 1 if slots else 0
    return _stack(layers, cfg, lambda xs: np.stack(xs, axis=axis))
