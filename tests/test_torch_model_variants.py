"""Stacks no published config of the JAX package has, which it builds and
runs all the same, against it on smoke widths (d_model 64, float32): a
stack of both recurrent kinds (RG-LRU, SSD and sliding layers, two
periods: the RG-LRU and SSD convolutions differ in width and channels, so
the port keeps ``conv`` and ``conv_ssd``), and blocks without an MLP
(``d_ff`` 0: the block adds zeros after ``norm2``, as the reference's) in
an attention stack and in an RG-LRU stack.

The forward logits, eight decode steps (logits and every cache leaf), the
slot-batched decode step's error words with a NaN in a recurrent state (bit
for bit), and the loss's gradients. Tolerances as ``test_torch_model.py``'s
(1e-4 absolute on logits and caches: float32, reduction order only) and
``test_torch_train.py``'s (1e-5 of each gradient leaf's largest value).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.data import pipeline as jpipe
from repro.launch.steps import make_slot_decode_step as jax_slot_step
from repro.models import build_model
from repro_torch.configs import smoke_config
from repro_torch.core.errors import ErrorCode
from repro_torch.data import pipeline
from repro_torch.launch.steps import make_loss_and_grads, make_slot_decode_step
from repro_torch.weights import (_flat_from_jax, cache_from_jax, cache_to_numpy,
                                 params_from_jax, train_params)

torch.set_num_threads(2)

TOL, GRAD_TOL = 1e-4, 1e-5
MIXED = dict(block_pattern=("rglru", "ssd", "sliding"), num_layers=6,
             ssm_state_dim=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=8)
VARIANTS = {
    "rglru_and_ssd": ("recurrentgemma-2b", MIXED),
    "attn_without_mlp": ("qwen3-1.7b", dict(d_ff=0)),
    "rglru_without_mlp": ("recurrentgemma-2b", dict(d_ff=0)),
}


@functools.lru_cache(maxsize=None)
def _env(variant):
    arch, kw = VARIANTS[variant]
    jcfg, cfg = jax_smoke_config(arch).replace(**kw), smoke_config(arch).replace(**kw)
    jmodel = build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    model = params_from_jax(jax.device_get(params), cfg, device="cpu")
    return jcfg, cfg, jmodel, params, model


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=TOL, atol=TOL)


def test_variants_build_their_caches():
    """Both recurrent kinds keep their own state and convolution leaves;
    a block without an MLP has its norm2 and no FFN."""
    _, cfg, _, _, model = _env("rglru_and_ssd")
    cache = model.init_cache(2, 12)
    assert sorted(cache) == ["conv", "conv_ssd", "h", "k_ring", "ssm", "v_ring"]
    assert model.state_leaves == ("h", "ssm")
    assert cache["conv"].shape[1:3] == (2, 3) and cache["conv_ssd"].shape[1] == 2
    assert model.cache_index == [0, 0, 0, 1, 1, 1]
    model = _env("attn_without_mlp")[4]
    assert model.blocks[0].mlp is None and model.blocks[0].norm2 is not None


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_forward_matches_jax(variant):
    """24 tokens: past the smoke window (16), and three SSD chunks of 8."""
    jcfg, cfg, jmodel, params, model = _env(variant)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    want, _ = jmodel.forward(params, jnp.asarray(toks))
    with torch.no_grad():
        got = model(torch.from_numpy(toks))
    _close(got.numpy(), want)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_decode_matches_jax(variant):
    """Eight decode steps from an empty cache: logits and the whole cache
    after every step."""
    jcfg, cfg, jmodel, params, model = _env(variant)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    jcache, cache = jmodel.init_cache(2, 12), model.init_cache(2, 12)
    for p in range(8):
        tok = toks[:, p:p + 1]
        want, jcache = jmodel.decode_step(params, jnp.asarray(tok), jcache, p)
        with torch.no_grad():
            got = model.decode_step(torch.from_numpy(tok), cache, p)
        _close(got.numpy(), want)
        for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(jcache)),
                        jax.tree_util.tree_leaves(cache_to_numpy(cache, cfg))):
            _close(b, a)


@pytest.mark.parametrize("leaf,index", [("b0", "h"), ("b1", "ssm"), (None, None)])
def test_mixed_slot_step_words_bit_equal(leaf, index):
    """The slot step over a stack of both kinds: the state probe reads
    ``h`` and ``ssm`` (a NaN in either latches STATE_FAULT in its slot
    only), the words bit-equal to the JAX vmapped step's."""
    jcfg, cfg, jmodel, params, model = _env("rglru_and_ssd")
    positions = np.asarray([0, 5, 15, 19], np.int32)
    rng = np.random.default_rng(2)
    shapes = jax.tree_util.tree_map(lambda s: s.shape, jmodel.cache_shapes(1, 16))
    tree = jax.tree_util.tree_map(
        lambda shape: 0.1 * rng.standard_normal((4, *shape)).astype(np.float32),
        shapes, is_leaf=lambda x: isinstance(x, tuple))
    toks = rng.integers(0, cfg.vocab_size, 4).astype(np.int32)
    if leaf is not None:
        tree["periods"][leaf][index][1, 1, 0].reshape(-1)[3] = np.nan
    jlogits, jcaches, jwords = jax_slot_step(jcfg)(
        params, jax.tree_util.tree_map(jnp.asarray, tree),
        jnp.asarray(toks)[:, None, None], jnp.asarray(positions))
    caches = cache_from_jax(tree, cfg, slots=True, device="cpu")
    with torch.no_grad():
        logits, words = make_slot_decode_step(model)(caches, torch.from_numpy(toks),
                                                     torch.from_numpy(positions))
    assert words.numpy().astype(np.uint32).tolist() == np.asarray(jwords).tolist()
    code = int(ErrorCode.STATE_FAULT | ErrorCode.NONFINITE_LOSS)
    assert words.tolist() == ([0, code, 0, 0] if leaf else [0, 0, 0, 0])
    if leaf is None:
        _close(logits.numpy(), np.asarray(jlogits[:, 0, 0]))
        for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(jcaches)),
                        jax.tree_util.tree_leaves(cache_to_numpy(caches, cfg,
                                                                 slots=True))):
            _close(b, a)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_gradients_match_jax(variant):
    """The training loss's gradient on every leaf (a block without an MLP:
    its norm2 gets zeros on both sides)."""
    jcfg, cfg, jmodel, params, model = _env(variant)
    pcfg = pipeline.PipelineConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                   batch_size=2)
    jbatch = jpipe.make_batch(jpipe.PipelineConfig(**pcfg.__dict__), 0)
    jg = jax.grad(lambda p: jmodel.loss(p, jbatch)[0])(params)
    want = _flat_from_jax(jax.device_get(jg), cfg, torch.device("cpu"))
    _, got, _ = make_loss_and_grads(cfg)(train_params(model),
                                         pipeline.make_batch(pcfg, 0, "cpu"))
    assert list(got) == list(want)
    for name, g in got.items():
        scale = want[name].abs().max().item()
        assert (g - want[name]).abs().max().item() <= GRAD_TOL * scale, name
    if cfg.d_ff == 0:
        assert not got["blocks.0.norm2"].any() and not want["blocks.0.norm2"].any()
