"""The port's model against the JAX package on the smoke configs of each
ported architecture (qwen3-1.7b: 2 layers, d_model 64; gemma3-1b: 14
layers — five sliding, one full, twice, then two sliding — window 16;
recurrentgemma-2b: 8 layers — RG-LRU, RG-LRU, sliding — d_model 64,
lru_width 64, window 16;
mamba2-2.7b: 2 SSD layers, d_model 64, 8 heads of 16, state 16, chunk 8;
qwen3-moe-30b-a3b: 2 layers, 8 experts top-2, untied unembedding;
starcoder2-3b: 2 sliding layers, window 16, LayerNorm, plain-GeLU MLP;
chatglm3-6b: 2 layers, the partial 2-D rotary over 8 of 16 head dims;
phi3.5-moe-42b-a6.6b: 2 layers, LayerNorm, 8 experts top-2; all float32),
with the JAX weights carried over by the bridge — the layer norms' biases
drawn non-zero, so that they act (the init's are zeros): full-forward
logits (against the JAX forward with its reference paths and with its Pallas
kernels in interpret mode), decode steps (logits and caches; for
recurrentgemma across the ring's wrap), the slot-batched decode step at
mixed positions, and the error words; and, inside the port, the decode
steps against its own forward (starcoder2 across its ring's wrap).

Tolerance 1e-4 (absolute, on logits of magnitude ~50-80 and caches of ~1):
both sides compute in float32 and differ only in reduction order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.launch.steps import make_slot_decode_step as jax_slot_step
from repro.models import build_model
from repro_torch.configs import smoke_config
from repro_torch.core.errors import ErrorCode
from repro_torch.launch.steps import make_slot_decode_step
from repro_torch.models.model import KV_LEAVES
from repro_torch.weights import cache_from_jax, cache_to_numpy, params_from_jax

torch.set_num_threads(2)

TOL = 1e-4
ARCHS = ["qwen3-1.7b", "gemma3-1b", "recurrentgemma-2b", "mamba2-2.7b",
         "qwen3-moe-30b-a3b", "starcoder2-3b", "chatglm3-6b",
         "phi3.5-moe-42b-a6.6b"]


@pytest.fixture(scope="module", params=ARCHS)
def env(request):
    jcfg = jax_smoke_config(request.param)
    cfg = smoke_config(request.param)
    jmodel = build_model(jcfg)
    params = with_biases(jmodel.init(jax.random.PRNGKey(0)))
    model = params_from_jax(jax.device_get(params), cfg, device="cpu")
    return jcfg, cfg, jmodel, params, model


def with_biases(params, seed=5):
    """``params`` with every layer norm's ``bias`` leaf drawn from a normal
    of scale 0.5 (the init's are zeros, under which a dropped bias would
    pass unseen); no other leaf changes."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if getattr(path[-1], "key", None) != "bias":
            return leaf
        return jnp.asarray(0.5 * rng.standard_normal(leaf.shape), leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, params)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_configs_agree(arch):
    """Both packages build the same smoke model."""
    assert (dataclasses.asdict(smoke_config(arch))
            == dataclasses.asdict(jax_smoke_config(arch)))


@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_forward_logits_match_jax(env, impl):
    """19 tokens: past the smoke sliding window (16), so the window mask
    acts; 24 for mamba2, whose scan (in both packages) takes a multiple of
    its chunk (8): three chunks, so the inter-chunk recurrence acts."""
    jcfg, cfg, jmodel, params, model = env
    S = 24 if "ssd" in cfg.block_pattern else 19
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    want, _ = jmodel.forward(params, jnp.asarray(toks), impl=impl)
    with torch.no_grad():
        got = model(torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (2, S, cfg.vocab_size)
    _close(got.numpy(), want)


def test_decode_steps_match_jax(env):
    """Eight decode steps from an empty cache: logits and the whole cache
    after every step."""
    jcfg, cfg, jmodel, params, model = env
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    jcache = jmodel.init_cache(2, 12)
    cache = model.init_cache(2, 12)
    for p in range(8):
        tok = toks[:, p:p + 1]
        want, jcache = jmodel.decode_step(params, jnp.asarray(tok), jcache, p)
        got = model.decode_step(torch.from_numpy(tok), cache, p)
        _close(got.numpy(), want)
        for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(jcache)),
                        jax.tree_util.tree_leaves(cache_to_numpy(cache, cfg))):
            _close(b, a)


def test_decode_across_the_ring_wrap():
    """recurrentgemma: 41 decode steps with a ring of capacity 16 (the smoke
    window; max_len 24), so every sliding layer's ring wraps twice — logits
    and every cache tensor after each step, against the JAX decode."""
    arch = "recurrentgemma-2b"
    jcfg, cfg = jax_smoke_config(arch), smoke_config(arch)
    jmodel = build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(3))
    model = params_from_jax(jax.device_get(params), cfg, device="cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 41)).astype(np.int32)
    jcache = jmodel.init_cache(2, 24)
    cache = model.init_cache(2, 24)
    assert cache["k_ring"].shape[2] == cfg.sliding_window == 16
    jstep = jax.jit(jmodel.decode_step)
    for p in range(41):
        tok = toks[:, p:p + 1]
        want, jcache = jstep(params, jnp.asarray(tok), jcache, jnp.int32(p))
        got = model.decode_step(torch.from_numpy(tok), cache, p)
        _close(got.numpy(), want)
        for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(jcache)),
                        jax.tree_util.tree_leaves(cache_to_numpy(cache, cfg))):
            _close(b, a)


def _slot_inputs(cfg, jcfg, cap, positions, seed=2):
    """Random slot-stacked caches (as the serve engines hold them) and one
    token per slot."""
    rng = np.random.default_rng(seed)
    shapes = jax.tree_util.tree_map(
        lambda s: s.shape, build_model(jcfg).cache_shapes(1, cap))
    tree = jax.tree_util.tree_map(
        lambda shape: rng.standard_normal((len(positions), *shape)).astype(np.float32),
        shapes, is_leaf=lambda x: isinstance(x, tuple))
    toks = rng.integers(0, cfg.vocab_size, len(positions)).astype(np.int32)
    return tree, toks


# where each architecture's slot-step test plants its poison in slot 1, and
# the word that must latch there: a V entry the slot reads (non-finite
# logits), or the recurrent state (the state probe, and the logits after it)
POISON_SITES = {
    "qwen3-1.7b": (("periods", "b0", "v"), (1, 0, 0, 2, 1, 3),
                   int(ErrorCode.NONFINITE_LOSS)),
    "qwen3-moe-30b-a3b": (("periods", "b0", "v"), (1, 1, 0, 2, 0, 3),
                          int(ErrorCode.NONFINITE_LOSS)),
    "gemma3-1b": (("periods", "b5", "v"), (1, 0, 0, 2, 0, 3),
                  int(ErrorCode.NONFINITE_LOSS)),
    "recurrentgemma-2b": (("periods", "b1", "h"), (1, 0, 0, 7),
                          int(ErrorCode.NONFINITE_LOSS | ErrorCode.STATE_FAULT)),
    "mamba2-2.7b": (("periods", "b0", "ssm"), (1, 1, 0, 6, 3, 5),
                    int(ErrorCode.NONFINITE_LOSS | ErrorCode.STATE_FAULT)),
    "starcoder2-3b": (("periods", "b0", "v"), (1, 1, 0, 2, 0, 3),
                      int(ErrorCode.NONFINITE_LOSS)),
    "chatglm3-6b": (("periods", "b0", "v"), (1, 0, 0, 2, 0, 3),
                    int(ErrorCode.NONFINITE_LOSS)),
    "phi3.5-moe-42b-a6.6b": (("periods", "b0", "v"), (1, 1, 0, 2, 0, 3),
                             int(ErrorCode.NONFINITE_LOSS)),
}


@pytest.mark.parametrize("poison", [None, "nan", "inf"])
def test_slot_step_matches_jax(env, poison):
    """The slot-batched step at mixed per-slot positions — including the
    capacity clamp (positions >= cap write at cap-1 and read everything) or
    the ring's wrap — against the JAX vmapped ``make_slot_decode_step``:
    logits and caches to tolerance, error words bit-equal (a NaN or inf
    planted in slot 1's cache must latch there and only there)."""
    jcfg, cfg, jmodel, params, model = env
    cap = 16
    positions = np.asarray([0, 5, cap - 1, cap + 3], np.int32)
    tree, toks = _slot_inputs(cfg, jcfg, cap, positions)
    path, index, code = POISON_SITES[cfg.name]
    if poison is not None:
        leaf = tree
        for key in path:
            leaf = leaf[key]
        leaf[index] = float(poison)
    jlogits, jcaches, jwords = jax_slot_step(jcfg)(
        params, jax.tree_util.tree_map(jnp.asarray, tree),
        jnp.asarray(toks)[:, None, None], jnp.asarray(positions))
    caches = cache_from_jax(tree, cfg, slots=True, device="cpu")
    step = make_slot_decode_step(model)
    logits, words = step(caches, torch.from_numpy(toks),
                         torch.from_numpy(positions))
    assert words.dtype == torch.int32
    assert words.numpy().astype(np.uint32).tolist() == np.asarray(jwords).tolist()
    assert words.tolist() == ([0, code, 0, 0] if poison else [0, 0, 0, 0])
    finite = np.isfinite(np.asarray(jlogits[:, 0, 0]))
    np.testing.assert_array_equal(np.isfinite(logits.numpy()), finite)
    _close(logits.numpy()[finite], np.asarray(jlogits[:, 0, 0])[finite])
    if poison is None:
        for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(jcaches)),
                        jax.tree_util.tree_leaves(cache_to_numpy(caches, cfg,
                                                                 slots=True))):
            _close(b, a)


def test_cache_write_positions(env):
    """Decode writes each slot's K/V at its write index and nowhere else:
    min(pos, cap-1) in a full layer's cache, pos % cap in a ring (gemma3
    holds both kinds, each with its own index). Without
    attention (mamba2) the step's input lands in the newest tap of every
    layer's conv history, and the older taps of a fresh cache stay zero."""
    _, cfg, _, _, model = env
    cap = 8
    cache = model.init_cache(3, cap)
    pos = torch.tensor([0, 3, cap + 2], dtype=torch.int32)
    make_slot_decode_step(model)(cache, torch.tensor([1, 2, 3], dtype=torch.int32), pos)
    if not model.attn_layers:
        written = cache["conv"].abs().sum(dim=-1) != 0      # (slot, layer, tap)
        taps = cache["conv"].shape[2]
        assert written.nonzero().tolist() == [
            [s, l, taps - 1] for s in range(3)
            for l in range(len(model.recurrent_layers))]
        return
    for kind, (k, _) in KV_LEAVES.items():
        if k not in cache:
            continue
        written = (cache[k][0].abs().sum(dim=(-1, -2)) != 0)
        last = 2 if kind == "sliding" else cap - 1
        assert written.nonzero().tolist() == [[0, 0], [1, 3], [2, last]], kind


@pytest.mark.parametrize("scale", ["smoke", "gemma3-1b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serving_embedding_scale_is_the_tensor_product(dtype, scale):
    """The serving embedding multiplies by the scale rounded to the model
    dtype as a Python number, so a decode step makes no tensor on the device
    for it (a host-to-device copy, a hidden sync on the card): bit-equal to
    the product with a 0-d tensor of the model dtype that it replaced, at
    the smoke config's scale (8) and at full-width gemma3-1b's
    (sqrt(1152), which neither dtype holds)."""
    from repro_torch.models import Model
    from repro_torch.models.layers import embed_tokens
    cfg = dataclasses.replace(smoke_config("gemma3-1b"), dtype=dtype)
    if scale != "smoke":
        cfg = dataclasses.replace(cfg, embed_scale=float(np.sqrt(1152.0)))
    model = Model(cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 9)))
    old = embed_tokens(model.embed, tokens, model.dtype) * torch.tensor(
        cfg.embed_scale, dtype=model.dtype)
    got = model._embed(tokens)
    assert got.dtype == model.dtype and torch.equal(got, old)


@pytest.mark.parametrize("arch", ["starcoder2-3b", "chatglm3-6b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_decode_steps_equal_the_forward(arch):
    """Inside the port: 40 decode steps from an empty cache give the
    forward's logits at every position, within TOL (the same fp32 sums in
    another order) — starcoder2's rings (capacity 16, max_len 48) wrap
    twice, chatglm3's partial rotary runs at both, phi3.5-moe's experts
    (ample capacity: a 40-token forward drops nothing) take the same
    tokens."""
    cfg = smoke_config(arch)
    if cfg.is_moe:
        cfg = cfg.replace(expert_capacity_factor=8.0)
    jmodel = build_model(jax_smoke_config(arch))
    params = with_biases(jmodel.init(jax.random.PRNGKey(6)))
    model = params_from_jax(jax.device_get(params), cfg, device="cpu")
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    with torch.no_grad():
        want = model(torch.from_numpy(toks))
        cache = model.init_cache(2, 48)
        got = torch.cat([model.decode_step(torch.from_numpy(toks[:, p:p + 1]),
                                           cache, p) for p in range(40)], dim=1)
    if cfg.sliding_window and "sliding" in cfg.block_pattern:
        assert cache["k_ring"].shape[2] == cfg.sliding_window == 16
    _close(got.numpy(), want.numpy())
