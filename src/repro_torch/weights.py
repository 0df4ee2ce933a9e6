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
D)``, ``k_cross``/``v_cross`` ``(cross layers, B, img_tokens, Hkv, D)``, the
recurrent state ``h`` ``(B, rglru layers, w)`` and/or ``ssm`` ``(B, ssd
layers, H, P, N)``, and ``conv`` ``(B, recurrent layers, 3, channels)``
(``conv_ssd`` for the SSD layers of a stack of both kinds). A JAX layer
cache names its K/V ``k``/``v`` whatever the layer's kind; the port's leaf
for each is :func:`~repro_torch.models.model.block_leaves`'s.

bfloat16 leaves arrive as ``ml_dtypes.bfloat16`` numpy arrays and go back as
float32 arrays (exact: every bfloat16 is a float32).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .configs.base import ModelConfig
from .models.model import CACHE_LAYOUT, Model, block_leaves, resolve_device
from .models.transformer import GATES

_ATTN = ("wq", "wk", "wv", "wo")
_QK_NORM = ("q_norm", "k_norm")
_RGLRU = ("wx", "wy", "conv_w", "gate_a", "gate_i", "lam", "out")
_SSD = ("in_x", "in_z", "in_B", "in_C", "in_dt", "conv_w", "dt_bias",
        "A_log", "D", "norm_scale", "out")


def _mlp_names(cfg: ModelConfig) -> tuple:
    return ("wi", "wg", "wo") if cfg.mlp_kind in ("swiglu", "geglu") else ("wi", "wo")


def _ffn(cfg: ModelConfig) -> tuple[str, tuple]:
    """The FFN's key in both trees and its leaves: ``mlp``, or ``moe`` with
    its router; no leaves for a config without either (``d_ff`` 0)."""
    if cfg.is_moe:
        return "moe", ("router",) + _mlp_names(cfg)
    return "mlp", (_mlp_names(cfg) if cfg.d_ff else ())


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


def _norm_leaves(owner, cfg: ModelConfig, name: str) -> dict:
    """A norm's parameters on ``owner`` (a block or the model) by JAX leaf
    name: ``scale`` and, for a layer norm, ``bias`` (:func:`_norm_order`)."""
    return {path[-1]: getattr(owner, port) for path, port in _norm_order(cfg, name)}


def _fill_norm(owner, cfg: ModelConfig, name: str, leaves: dict, where: str) -> None:
    params = _norm_leaves(owner, cfg, name)
    if set(leaves) != set(params):
        raise ValueError(f"{where} {name}: leaves {sorted(leaves)}, the model "
                         f"holds {sorted(params)}")
    for leaf, param in params.items():
        _fill(param, leaves[leaf], f"{where} {name}.{leaf}")


def params_from_jax(tree: dict, cfg: ModelConfig, *, device=None) -> Model:
    """A port model on ``device`` holding the JAX params ``tree`` (numpy)."""
    model = Model(cfg, device=device, seed=None)
    with torch.no_grad():
        _fill(model.embed, tree["embed"]["embedding"], "embed")
        _fill_norm(model, cfg, "final_norm", tree["final_norm"], "model")
        for l, path in enumerate(_layer_paths(cfg)):
            lp = _layer(tree["stack"], path, lambda leaf, c: np.asarray(leaf)[c])
            blk = model.blocks[l]
            _fill_norm(blk, cfg, "norm1", lp["norm1"], f"layer {l}")
            key, names = _mixer(cfg, blk.btype)
            for name in names:
                _fill(getattr(getattr(blk, key), name), lp[key][name],
                      f"layer {l} {key}.{name}")
            for name in _gates(blk.btype):
                _fill(getattr(blk, name), lp[name], f"layer {l} {name}")
            if blk.norm2 is None:
                continue
            _fill_norm(blk, cfg, "norm2", lp["norm2"], f"layer {l}")
            key, names = _ffn(cfg)
            for name in names:
                _fill(getattr(getattr(blk, key), name), lp[key][name],
                      f"layer {l} {key}.{name}")
        if model.unembed is not None:
            _fill(model.unembed, tree["unembed"]["kernel"], "unembed")
    model.tie_unembed()
    return model


def params_to_numpy(model: Model) -> dict:
    """The JAX param tree layout of ``model``'s weights, as numpy."""
    cfg = model.cfg
    layers = []
    for blk in model.blocks:
        key, names = _mixer(cfg, blk.btype)
        mixer = getattr(blk, key)
        layer = {"norm1": _norm_numpy(blk, cfg, "norm1"),
                 key: {n: _to_numpy(getattr(mixer, n)) for n in names},
                 **{n: _to_numpy(getattr(blk, n)) for n in _gates(blk.btype)}}
        if blk.norm2 is not None:
            key, names = _ffn(cfg)
            layer["norm2"] = _norm_numpy(blk, cfg, "norm2")
            if names:
                layer[key] = {n: _to_numpy(getattr(getattr(blk, key), n))
                              for n in names}
        layers.append(layer)
    tree = {"embed": {"embedding": _to_numpy(model.embed)},
            "stack": _stack(layers, cfg, lambda xs: np.stack(xs)),
            "final_norm": _norm_numpy(model, cfg, "final_norm")}
    if model.unembed is not None:
        tree["unembed"] = {"kernel": _to_numpy(model.unembed)}
    return tree


def _norm_numpy(owner, cfg: ModelConfig, name: str) -> dict:
    return {leaf: _to_numpy(t) for leaf, t in _norm_leaves(owner, cfg, name).items()}


def save_tree_npz(path: str, tree: dict) -> None:
    """Write a numpy param tree (nested dicts and lists, e.g. the JAX
    params through ``jax.device_get``) to one ``.npz``, a leaf per
    ``/``-joined path. Leaves must have a numpy dtype of their own (a
    ``bfloat16`` leaf is refused: ``np.load`` could not read it back)."""
    from .tree import tree_items
    flat = {}
    for key, leaf in tree_items(tree):
        arr = np.asarray(leaf)
        if arr.dtype.name == "bfloat16":
            raise ValueError(f"{key}: bfloat16 leaves cannot be saved to .npz")
        flat[key] = arr
    np.savez(path, **flat)


def load_tree_npz(path: str) -> dict:
    """The tree :func:`save_tree_npz` wrote: a level whose keys are all
    indices comes back as a list."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


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


def _gates(btype: str) -> tuple:
    """A block's 0-d gate leaves, the same name in both trees: a ``cross``
    block's ``gate_attn`` and ``gate_mlp``, none elsewhere."""
    return GATES if btype == "cross" else ()


def _layer_leaves(cfg: ModelConfig, btype: str) -> list[tuple]:
    """``(JAX path within a layer, port name suffix)`` of a layer's
    parameters, in the JAX tree's flatten order (dict keys sorted: a cross
    block's ``attn, gate_attn, gate_mlp, mlp, norm1, norm2``)."""
    key, names = _mixer(cfg, btype)
    leaves = _norm_order(cfg, "norm1")
    leaves += [((key, n), f"{key}.{n}") for n in names]
    leaves += [((n,), n) for n in _gates(btype)]
    if btype != "ssd":
        ffn, ffn_names = _ffn(cfg)
        leaves += _norm_order(cfg, "norm2")
        leaves += [((ffn, n), f"{ffn}.{n}") for n in ffn_names]
    return sorted(leaves)


def _norm_order(cfg: ModelConfig, name: str) -> list[tuple]:
    """``(JAX path, port name)`` of a norm's leaves: ``scale``, and a layer
    norm's ``bias`` (which sorts before it)."""
    out = [((name, "scale"), name)]
    if cfg.norm == "layernorm":
        out.insert(0, ((name, "bias"), f"{name}_bias"))
    return out


def param_order(cfg: ModelConfig) -> list[tuple]:
    """Every parameter as ``(port name, JAX path, period index or None)``,
    in the JAX params tree's flatten order, each period-stacked leaf
    expanded into its layers in period order. The port name is the
    ``named_parameters`` name; the JAX leaf is ``tree[path]`` (its row
    ``index`` when stacked). A train state's dicts are built in this order,
    so the optimizer's sums over the leaves run in it."""
    order = [("embed", ("embed", "embedding"), None)]
    order += [(name, path, None) for path, name in _norm_order(cfg, "final_norm")]
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
    if not cfg.tie_embeddings:          # "unembed" sorts after "stack"
        order.append(("unembed", ("unembed", "kernel"), None))
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
    serving forward reads that copy, not the embedding or the ``unembed``
    kernel, so a model loaded from a trained state without it would unembed
    with the old weights."""
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
    per_layer, leaves = [], block_leaves(cfg)
    for path, b in zip(_layer_paths(cfg), cfg.pattern_layers):
        lc = _layer(tree, path, select)
        if path[0] == "rest" and slots:
            lc = {k: np.asarray(v)[:, 0] for k, v in lc.items()}
        # every leaf (B, ...), under the port's name
        per_layer.append({ours: lc[theirs]
                          for ours, theirs in leaves[b].items()})
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
    layers, leaves = [], block_leaves(cfg)
    for b in cfg.pattern_layers:
        lc = {}
        for ours, theirs in leaves[b].items():
            row = np.take(arrays[ours], index[ours],
                          axis=CACHE_LAYOUT[ours].layer_axis)
            index[ours] += 1
            lc[theirs] = row[:, None] if slots else row  # per-slot batch of one
        layers.append(lc)
    axis = 1 if slots else 0
    return _stack(layers, cfg, lambda xs: np.stack(xs, axis=axis))
