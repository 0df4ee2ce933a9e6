"""The weight and cache bridge round-trips exactly: JAX params → port model
→ JAX layout, and JAX caches (decode and slot-stacked serve layouts) → port
cache → JAX layout, leaf for leaf, bit for bit."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import build_model
from repro_torch.configs import smoke_config
from repro_torch.weights import (
    cache_from_jax,
    cache_to_numpy,
    params_from_jax,
    params_to_numpy,
)

ARCH = "qwen3-1.7b"


def _leaves_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        x = np.asarray(x, np.float32)
        assert x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layers", [2, 3])
def test_params_round_trip(dtype, layers):
    jcfg = jax_smoke_config(ARCH).replace(dtype=dtype, num_layers=layers)
    cfg = smoke_config(ARCH).replace(dtype=dtype, num_layers=layers)
    params = jax.device_get(build_model(jcfg).init(jax.random.PRNGKey(1)))
    model = params_from_jax(params, cfg, device="cpu")
    assert model.blocks[0].attn.wq.dtype == (
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    assert len(model.blocks) == layers
    _leaves_equal(params, params_to_numpy(model))
    # the fp32 unembedding copy is the embedding itself, exactly
    np.testing.assert_array_equal(model.embed_f32.numpy(),
                                  np.asarray(params["embed"]["embedding"], np.float32))


@pytest.mark.parametrize("slots", [False, True])
def test_cache_round_trip(slots):
    jcfg = jax_smoke_config(ARCH)
    cfg = smoke_config(ARCH)
    shapes = build_model(jcfg).cache_shapes(1 if slots else 3, 10)
    rng = np.random.default_rng(0)
    lead = (3,) if slots else ()
    tree = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(lead + s.shape).astype(np.float32), shapes)
    cache = cache_from_jax(tree, cfg, slots=slots, device="cpu")
    assert cache["k"].shape == (cfg.num_layers, 3, 10, cfg.num_kv_heads,
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
