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
    src = arr if torch.is_tensor(arr) else _to_tensor(arr)
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


def _layer_leaves(cfg: ModelConfig, btype: str) -> list[tuple]:
    """``(JAX path within a layer, port name suffix)`` of a layer's
    parameters, in the JAX tree's flatten order (dict keys sorted)."""
    key, names = _mixer(cfg, btype)
    leaves = [(("norm1", "scale"), "norm1")]
    leaves += [((key, n), f"{key}.{n}") for n in names]
    if btype != "ssd":
        leaves += [(("norm2", "scale"), "norm2")]
        leaves += [(("mlp", n), f"mlp.{n}") for n in _mlp_names(cfg)]
    return sorted(leaves)


def param_order(cfg: ModelConfig) -> list[tuple]:
    """Every parameter as ``(port name, JAX path, period index or None)``,
    in the JAX params tree's flatten order, each period-stacked leaf
    expanded into its layers in period order. The port name is the
    ``named_parameters`` name; the JAX leaf is ``tree[path]`` (its row
    ``index`` when stacked). A train state's dicts are built in this order,
    so the optimizer's sums over the leaves run in it."""
    order = [("embed", ("embed", "embedding"), None),
             ("final_norm", ("final_norm", "scale"), None)]
    n_scan = cfg.num_periods * cfg.period
    for pos in sorted(range(cfg.period), key=lambda p: f"b{p}"):
        if pos >= n_scan:
            continue
        for sub, suffix in _layer_leaves(cfg, cfg.pattern_layers[pos]):
            for c in range(cfg.num_periods):
                order.append((f"blocks.{c * cfg.period + pos}.{suffix}",
                              ("stack", "periods", f"b{pos}", *sub), c))
    for i, l in enumerate(range(n_scan, cfg.num_layers)):
        for sub, suffix in _layer_leaves(cfg, cfg.pattern_layers[l]):
            order.append((f"blocks.{l}.{suffix}", ("stack", "rest", i, *sub), None))
    return order


def train_params(model: Model) -> dict:
    """A copy of ``model``'s weights as a train state's params: a dict by
    ``named_parameters`` name, in :func:`param_order`. The model is left as
    it was (its own weights never require a gradient)."""
    named = dict(model.named_parameters())
    names = [name for name, _, _ in param_order(model.cfg)]
    if sorted(names) != sorted(named):
        raise ValueError(f"{model.cfg.name}: param_order {sorted(names)} != "
                         f"the model's {sorted(named)}")
    return {name: named[name].detach().clone() for name in names}


def load_train_params(model: Model, params: dict) -> Model:
    """Copy a train state's ``params`` into ``model``'s weights (in place)
    and remake its fp32 unembedding copy (:meth:`Model.tie_unembed`): the
    serving forward reads that copy, not the embedding, so a model loaded
    from a trained state without it would unembed with the old weights."""
    named = dict(model.named_parameters())
    if sorted(params) != sorted(named):
        raise ValueError(f"params {sorted(params)} != the model's {sorted(named)}")
    with torch.no_grad():
        for name, t in params.items():
            _fill(named[name], t, name)
    model.tie_unembed()
    return model


def _get(tree, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def _flat_from_jax(tree: dict, cfg: ModelConfig, dev: torch.device) -> dict:
    return {name: _to_tensor(np.asarray(_get(tree, path)) if c is None
                             else np.asarray(_get(tree, path))[c]).to(dev)
            for name, path, c in param_order(cfg)}


def _flat_to_jax(flat: dict, cfg: ModelConfig) -> dict:
    tree: dict = {}
    stacked: dict = {}
    for name, path, c in param_order(cfg):
        arr = _to_numpy(flat[name])
        if c is not None:
            stacked.setdefault(path, []).append(arr)    # periods in order
            continue
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr
    for path, arrs in stacked.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack(arrs)
    stack = tree.setdefault("stack", {})
    stack.setdefault("periods", {})
    rest = stack.get("rest", {})
    stack["rest"] = [rest[i] for i in range(len(rest))]
    return tree


def train_state_from_jax(state: dict, cfg: ModelConfig, *, device=None) -> dict:
    """A port train state on ``device`` from the JAX one (numpy: params,
    ``opt.m``, ``opt.v``, ``step``, ``lr_scale``)."""
    dev = resolve_device(device)
    return {"params": _flat_from_jax(state["params"], cfg, dev),
            "opt": {k: _flat_from_jax(state["opt"][k], cfg, dev)
                    for k in ("m", "v")},
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=dev),
            "lr_scale": torch.tensor(float(np.asarray(state["lr_scale"])),
                                     dtype=torch.float32, device=dev)}


def train_state_to_numpy(state: dict, cfg: ModelConfig) -> dict:
    """Inverse of :func:`train_state_from_jax`: the JAX train state tree, as
    numpy under the JAX tree's names (bfloat16 leaves as float32)."""
    return {"params": _flat_to_jax(state["params"], cfg),
            "opt": {k: _flat_to_jax(state["opt"][k], cfg) for k in ("m", "v")},
            "step": np.int32(_to_numpy(state["step"])),
            "lr_scale": np.float32(_to_numpy(state["lr_scale"]))}


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
