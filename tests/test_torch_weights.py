"""The weight and cache bridge round-trips exactly: JAX params → port model
→ JAX layout, and JAX caches (decode and slot-stacked serve layouts) → port
cache → JAX layout, leaf for leaf, bit for bit — for qwen3 (full-attention
K/V), qwen3-moe (the MoE leaves ``moe.{router,wi,wg,wo}`` and the untied
``unembed.kernel``, also through the train-state bridge), gemma3 (full K/V
and sliding rings in one stack), recurrentgemma (RG-LRU leaves, ring K/V,
``h``/``conv`` state, remainder layers), mamba2 (SSD leaves, blocks
without norm2 or MLP, ``ssm``/``conv`` state), starcoder2 (rings only, the
plain-GeLU MLP's ``wi``/``wo``) and phi3.5-moe (MoE leaves), both with the
layer norms' ``bias`` leaves — also through the train-state bridge, in the
JAX flatten order (``bias`` before ``scale``) —, chatglm3,
llama-3.2-vision (the cross blocks' 0-d ``gate_attn``/``gate_mlp`` leaves,
which sort between ``attn`` and ``mlp``, and their ``k_cross``/``v_cross``
image K/V of ``img_tokens`` entries; remainder layers at depth 7) and
hubert-xlarge (the encoder: LayerNorm, no rotary)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import build_model
from repro_torch.configs import smoke_config
from repro_torch.models import Model
from repro_torch.weights import (
    cache_from_jax,
    cache_to_numpy,
    load_train_params,
    param_order,
    params_from_jax,
    params_to_numpy,
    train_params,
    train_state_from_jax,
    train_state_to_numpy,
)

ARCH = "qwen3-1.7b"
MOE = "qwen3-moe-30b-a3b"
SC2, GLM, PHI = "starcoder2-3b", "chatglm3-6b", "phi3.5-moe-42b-a6.6b"
VLM, HUB = "llama-3.2-vision-11b", "hubert-xlarge"
ARCHS = ["qwen3-1.7b", "gemma3-1b", "recurrentgemma-2b", "mamba2-2.7b", MOE,
         SC2, GLM, PHI, VLM, HUB]
# (arch, layers): a depth without and with remainder layers (recurrentgemma:
# 5 = one period + 2 rest, 8 = the smoke depth, two periods + 2 rest;
# gemma3: 6 = one period, 14 = the smoke depth, two periods + 2 rest)
DEPTHS = [("qwen3-1.7b", 2), ("qwen3-1.7b", 3), ("gemma3-1b", 6),
          ("gemma3-1b", 14), ("recurrentgemma-2b", 5),
          ("recurrentgemma-2b", 8), ("mamba2-2.7b", 2), ("mamba2-2.7b", 3),
          (MOE, 2), (MOE, 3), (SC2, 2), (SC2, 3), (GLM, 2), (GLM, 3),
          (PHI, 2), (PHI, 3), (VLM, 5), (VLM, 7), (VLM, 10), (HUB, 2),
          (HUB, 3)]


def _leaves_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        x = np.asarray(x, np.float32)
        assert x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,layers", DEPTHS)
def test_params_round_trip(dtype, arch, layers):
    jcfg = jax_smoke_config(arch).replace(dtype=dtype, num_layers=layers)
    cfg = smoke_config(arch).replace(dtype=dtype, num_layers=layers)
    params = jax.device_get(build_model(jcfg).init(jax.random.PRNGKey(1)))
    model = params_from_jax(params, cfg, device="cpu")
    # every weight matrix in the model dtype (norms, gates' fp32 vectors and
    # the MoE router, fp32 in the JAX package too, aside)
    want = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert {p.dtype for n, p in model.named_parameters()
            if p.dim() >= 2 and not n.endswith("moe.router")} == {want}
    assert len(model.blocks) == layers
    _leaves_equal(params, params_to_numpy(model))
    # the fp32 unembedding copy is the tied embedding's transpose or the
    # untied kernel, exactly
    un = (params["embed"]["embedding"].T if cfg.tie_embeddings
          else params["unembed"]["kernel"])
    assert model.unembed_f32.dtype == torch.float32
    np.testing.assert_array_equal(model.unembed_f32.numpy(),
                                  np.asarray(un, np.float32))


@pytest.mark.parametrize("slots", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_round_trip(slots, arch):
    """max_len 20 > the smoke window 16: the sliding layers' rings
    (recurrentgemma, gemma3) hold 16, the full layers' caches 20."""
    jcfg = jax_smoke_config(arch)
    cfg = smoke_config(arch)
    shapes = build_model(jcfg).cache_shapes(1 if slots else 3, 20)
    rng = np.random.default_rng(0)
    lead = (3,) if slots else ()
    tree = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(lead + s.shape).astype(np.float32), shapes)
    cache = cache_from_jax(tree, cfg, slots=slots, device="cpu")
    model = Model(cfg, device="cpu", seed=None)
    want = model.init_cache(3, 20)
    assert {k: v.shape for k, v in cache.items()} == {k: v.shape for k, v in want.items()}
    for kind, (k, _), cap in (("attn", ("k", "v"), 20),
                              ("sliding", ("k_ring", "v_ring"), 16),
                              ("cross", ("k_cross", "v_cross"), cfg.img_tokens)):
        n = cfg.pattern_layers.count(kind)
        assert (k in cache) == bool(n)
        if n:
            assert cache[k].shape == (n, 3, cap, cfg.num_kv_heads,
                                      cfg.resolved_head_dim)
    _leaves_equal(tree, cache_to_numpy(cache, cfg, slots=slots))


def test_bridge_rejects_mismatched_params():
    jcfg = jax_smoke_config(ARCH)
    cfg = smoke_config(ARCH)
    params = jax.device_get(build_model(jcfg.replace(d_ff=64)).init(
        jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="mlp"):
        params_from_jax(params, cfg, device="cpu")
    assert dataclasses.replace(cfg, d_ff=64).d_ff == 64


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_train_state_round_trip(dtype):
    """qwen3-moe's train state through the bridge: the params tree, with its
    ``moe`` leaves and the untied ``unembed.kernel``, in the JAX flatten
    order (``unembed`` last, after ``stack``), leaf for leaf both ways; the
    params into a serving model and back, its fp32 unembedding copy remade
    from the loaded kernel."""
    jcfg = jax_smoke_config(MOE).replace(dtype=dtype)
    cfg = smoke_config(MOE).replace(dtype=dtype)
    params = jax.device_get(build_model(jcfg).init(jax.random.PRNGKey(2)))
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), params)
    state = {"params": params, "opt": {"m": params, "v": zeros},
             "step": np.int32(7), "lr_scale": np.float32(0.5)}
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    names = [name for name, _, _ in param_order(cfg)]
    assert names[-1] == "unembed" and sum(
        n.endswith(("moe.router", "moe.wi", "moe.wg", "moe.wo")) for n in names) == 8
    assert len(names) == sum(
        a.shape[0] if "periods" in jax.tree_util.keystr(k) else 1 for k, a in flat)
    tstate = train_state_from_jax(state, cfg, device="cpu")
    assert list(tstate["params"]) == names
    back = train_state_to_numpy(tstate, cfg)
    _leaves_equal(state["params"], back["params"])
    _leaves_equal(state["opt"], back["opt"])
    assert int(back["step"]) == 7 and float(back["lr_scale"]) == 0.5
    model = load_train_params(Model(cfg, device="cpu", seed=3), tstate["params"])
    _leaves_equal(params, params_to_numpy(model))
    np.testing.assert_array_equal(model.unembed_f32.numpy(), np.asarray(
        params["unembed"]["kernel"], np.float32))
    assert all(torch.equal(a, b) for a, b in zip(
        train_params(model).values(), tstate["params"].values()))


@pytest.mark.parametrize("arch", [SC2, GLM, PHI, VLM, HUB])
def test_param_order_and_train_state_with_norm_biases(arch):
    """``param_order`` is the JAX params tree's flatten order — a layer
    norm's ``bias`` leaf before its ``scale`` (``final_norm_bias`` second,
    after ``embed``), a cross block's ``attn.*, gate_attn, gate_mlp, mlp.*,
    norm1, norm2`` — and names every parameter of the model; the train
    state crosses the bridge both ways leaf for leaf, with non-zero biases
    and gates."""
    jcfg, cfg = jax_smoke_config(arch), smoke_config(arch)
    params = jax.device_get(build_model(jcfg).init(jax.random.PRNGKey(4)))
    rng = np.random.default_rng(4)
    drawn = ("bias", "gate_attn", "gate_mlp")
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.standard_normal(a.shape).astype(np.float32)
                         if getattr(path[-1], "key", None) in drawn else a),
        params)
    want = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)
        n = leaf.shape[0] if keys[1:2] == ("periods",) else None
        want += [(keys, c) for c in range(n)] if n else [(keys, None)]
    order = param_order(cfg)
    assert [(path, c) for _, path, c in order] == want
    names = [name for name, _, _ in order]
    assert sorted(names) == sorted(n for n, _ in Model(
        cfg, device="meta", seed=None).named_parameters())
    if "cross" in cfg.block_pattern:
        layer4 = [n.split(".", 2)[2] for n in names if n.startswith("blocks.4.")]
        assert [n.split(".")[0] for n in layer4] == (
            ["attn"] * 4 + ["gate_attn", "gate_mlp"] + ["mlp"] * 3 + ["norm1", "norm2"])
        assert sum(n.endswith(".gate_attn") for n in names) == 2
    biases = [n for n in names if n.endswith("_bias")]
    if cfg.norm == "layernorm":
        assert names[1:3] == ["final_norm_bias", "final_norm"]
        assert len(biases) == 1 + 2 * cfg.num_layers
    else:
        assert biases == []
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), params)
    state = {"params": params, "opt": {"m": params, "v": zeros},
             "step": np.int32(3), "lr_scale": np.float32(1.0)}
    tstate = train_state_from_jax(state, cfg, device="cpu")
    assert list(tstate["params"]) == names
    back = train_state_to_numpy(tstate, cfg)
    _leaves_equal(state["params"], back["params"])
    _leaves_equal(state["opt"], back["opt"])
    model = load_train_params(Model(cfg, device="cpu", seed=1), tstate["params"])
    _leaves_equal(params, params_to_numpy(model))
