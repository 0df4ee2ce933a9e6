"""Cross-attention and the VLM stack against the JAX package, on the smoke
config of llama-3.2-vision-11b (10 layers: four self-attention layers and
one cross layer, twice; d_model 64, 4/1 heads of 16, 8 image tokens;
float32), the JAX weights carried over by the bridge with the cross
blocks' gates drawn non-zero (the init's are zeros, under which a dropped
gate, or a cross layer that computes anything finite, would pass unseen)
and, for the ``qk_norm`` variant, the q/k norms drawn away from ones:

* ``precompute_cross_kv``, ``cross_attention_decode`` and
  ``attention_train`` with ``kv_src`` against the JAX functions, with
  ``qk_norm`` off (the config's) and on;
* the cross block's train and decode bodies;
* ``Model.forward`` with ``img_embeds`` (against the JAX forward with its
  reference paths and with its Pallas kernel in interpret mode) and without
  them: each cross layer then runs as causal self-attention with the
  rotary, gated, as the JAX package's does;
* ``decode_step`` with the cross leaves zero (as serving leaves them) and
  filled from ``precompute_cross_kv`` (the filled JAX cache carried over by
  ``cache_from_jax``);
* the window+overlap ``Replica`` against the JAX one, clean and with the
  KV fault (K of layer 0, as the JAX replica's), the port's LFLR streams
  bit-equal to its clean run's, a slot's cross leaves zero again after its
  reset (or the blocking engine's insert), and the stepwise and blocking
  engines bit-equal to the window engine;
* the paged replica (self-attention K/V in the pool, cross leaves dense, as
  the JAX replica pages them) against the JAX paged replica and bit-equal
  to the port's contiguous engine, clean and faulted.

Tolerance 1e-4 (absolute, as ``test_torch_model.py``: logits of magnitude
~5-50, float32 on both sides, other reduction orders); the streams as
``test_torch_serve._assert_streams_match`` (equal, but at a near-tie of the
reference's top-2 logits within 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import build_model
from repro.models import attention as jattn
from repro.models import transformer as jtrans
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import Replica as JaxReplica
from repro.serve import Request as JaxRequest
from repro_torch.configs import smoke_config
from repro_torch.core.errors import ErrorCode
from repro_torch.models.attention import (attention_train, cross_attention_decode,
                                          precompute_cross_kv)
from repro_torch.models.model import reset_cache_slot
from repro_torch.models.transformer import apply_block_decode, apply_block_train
from repro_torch.serve import OK, EngineConfig, Replica, Request
from repro_torch.weights import cache_from_jax, cache_to_numpy, params_from_jax
from test_torch_serve import _assert_streams_match, _serve, _traffic

torch.set_num_threads(2)

ARCH = "llama-3.2-vision-11b"
TOL = 1e-4
PERIOD = 5                     # four self-attention layers, one cross
CROSS = 4                      # the first cross layer (period position 4)
ENGINE = dict(window=4, overlap=True, num_slots=3, max_len=48)

_ENVS: dict = {}


def with_gates(params, seed=7):
    """``params`` with every cross gate drawn from a normal of scale 0.5
    and every ``q_norm``/``k_norm`` from 1 + that (the init's are 0 and 1,
    under which a dropped gate or norm passes); no other leaf changes."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        key = getattr(path[-1], "key", None)
        if key in ("gate_attn", "gate_mlp"):
            return jnp.asarray(0.5 * rng.standard_normal(leaf.shape), leaf.dtype)
        if key in ("q_norm", "k_norm"):
            return jnp.asarray(1 + 0.5 * rng.standard_normal(leaf.shape), leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(draw, params)


def _env(qk_norm=False):
    """(JAX config, port config, JAX model, JAX params, port model)."""
    if qk_norm not in _ENVS:
        jcfg = jax_smoke_config(ARCH).replace(qk_norm=qk_norm)
        cfg = smoke_config(ARCH).replace(qk_norm=qk_norm)
        jmodel = build_model(jcfg)
        params = with_gates(jmodel.init(jax.random.PRNGKey(0)))
        model = params_from_jax(jax.device_get(params), cfg, device="cpu")
        _ENVS[qk_norm] = (jcfg, cfg, jmodel, params, model)
    return _ENVS[qk_norm]


@pytest.fixture(params=[False, True], ids=["config", "qk_norm"])
def env(request):
    return _env(request.param)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=TOL, atol=TOL)


def _jax_block(params, layer=CROSS):
    """Layer ``layer``'s params, cut out of the JAX period stack."""
    sub = params["stack"]["periods"][f"b{layer % PERIOD}"]
    return jax.tree_util.tree_map(lambda a: a[layer // PERIOD], sub)


def _img(cfg, B=2, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.img_tokens, cfg.d_model)).astype(np.float32)


def _x(cfg, B=2, S=6, seed=4):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


# ------------------------------------------------------------ attention
def test_gates_drawn_and_carried(env):
    _, cfg, _, params, model = env
    blk = model.blocks[CROSS]
    jp = _jax_block(params)
    for name in ("gate_attn", "gate_mlp"):
        got = getattr(blk, name)
        assert got.dtype == torch.float32 and got.shape == ()
        assert float(got) == float(jp[name]) != 0.0
    assert model.blocks[0].gate_attn is None


def test_precompute_cross_kv_matches_jax(env):
    jcfg, cfg, _, params, model = env
    img = _img(cfg)
    want = jattn.precompute_cross_kv(_jax_block(params)["attn"], jnp.asarray(img), jcfg)
    k, v = precompute_cross_kv(model.blocks[CROSS].attn, torch.from_numpy(img), cfg)
    assert k.shape == (2, cfg.img_tokens, cfg.num_kv_heads, cfg.resolved_head_dim)
    _close(k.numpy(), want["k"])
    _close(v.numpy(), want["v"])


def test_cross_attention_decode_matches_jax(env):
    jcfg, cfg, _, params, model = env
    jp = _jax_block(params)["attn"]
    img = jnp.asarray(_img(cfg))
    kv = jattn.precompute_cross_kv(jp, img, jcfg)
    x = _x(cfg, S=1)
    want = jattn.cross_attention_decode(jp, jnp.asarray(x), kv, jcfg)
    k, v = (torch.from_numpy(np.array(kv[n])) for n in ("k", "v"))
    got = cross_attention_decode(model.blocks[CROSS].attn, torch.from_numpy(x), k, v,
                                 torch.zeros(2, dtype=torch.int32), cfg)
    _close(got.numpy(), want)


@pytest.mark.parametrize("cross", [True, False], ids=["kv_src", "self"])
def test_attention_train_matches_jax(env, cross):
    """With ``kv_src``: no rotary, no mask, S 6 queries over 8 image keys;
    without: the cross layer's weights as causal self-attention with the
    rotary."""
    jcfg, cfg, _, params, model = env
    jp = _jax_block(params)["attn"]
    x, img = _x(cfg), _img(cfg)
    B, S = x.shape[:2]
    positions = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    want = jattn.attention_train(jp, jnp.asarray(x), positions, jcfg,
                                 kv_src=jnp.asarray(img) if cross else None,
                                 impl="ref")
    rope = model._rope(torch.arange(S, dtype=torch.int32).expand(B, S))
    got = attention_train(model.blocks[CROSS].attn, torch.from_numpy(x), rope, cfg,
                          kv_src=torch.from_numpy(img) if cross else None)
    _close(got.numpy(), want)


# ---------------------------------------------------------------- block
@pytest.mark.parametrize("with_img", [True, False], ids=["img", "no_img"])
def test_cross_block_train_matches_jax(env, with_img):
    jcfg, cfg, _, params, model = env
    x, img = _x(cfg), _img(cfg)
    B, S = x.shape[:2]
    positions = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    want, _ = jtrans.apply_block_train(
        _jax_block(params), jnp.asarray(x), positions, jcfg, "cross",
        img_embeds=jnp.asarray(img) if with_img else None, impl="ref")
    rope = model._rope(torch.arange(S, dtype=torch.int32).expand(B, S))
    got, drop = apply_block_train(model.blocks[CROSS], torch.from_numpy(x), rope, cfg,
                                  torch.from_numpy(img) if with_img else None)
    assert drop is None
    _close(got.numpy(), want)


@pytest.mark.parametrize("filled", [True, False], ids=["filled", "zeros"])
def test_cross_block_decode_matches_jax(env, filled):
    """The decode body over the image K/V (or the zeros a fresh cache
    holds), which it reads and leaves as they were."""
    jcfg, cfg, _, params, model = env
    jp = _jax_block(params)
    shape = (2, cfg.img_tokens, cfg.num_kv_heads, cfg.resolved_head_dim)
    kv = (jattn.precompute_cross_kv(jp["attn"], jnp.asarray(_img(cfg)), jcfg)
          if filled else {"k": jnp.zeros(shape), "v": jnp.zeros(shape)})
    x = _x(cfg, S=1)
    want, jcache, _ = jtrans.apply_block_decode(jp, jnp.asarray(x), kv, 3, jcfg, "cross")
    k, v = (torch.from_numpy(np.array(kv[n])) for n in ("k", "v"))
    k0, v0 = k.clone(), v.clone()
    got = apply_block_decode(model.blocks[CROSS], torch.from_numpy(x),
                             (k, v, torch.zeros(2, dtype=torch.int32)),
                             torch.full((2,), 3, dtype=torch.int32), None, cfg)
    _close(got.numpy(), want)
    assert torch.equal(k, k0) and torch.equal(v, v0)
    assert jcache is kv


# ---------------------------------------------------------------- model
@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_forward_with_img_embeds_matches_jax(impl):
    jcfg, cfg, jmodel, params, model = _env()
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    img = _img(cfg)
    want, _ = jmodel.forward(params, jnp.asarray(toks), img_embeds=jnp.asarray(img),
                             impl=impl)
    with torch.no_grad():
        got = model(torch.from_numpy(toks), img_embeds=torch.from_numpy(img))
    assert got.dtype == torch.float32 and got.shape == (2, 11, cfg.vocab_size)
    _close(got.numpy(), want)


def test_forward_without_img_embeds_matches_jax(env):
    """No image: each cross layer is gated causal self-attention with the
    rotary — which the drawn gates make differ from skipping it."""
    jcfg, cfg, jmodel, params, model = env
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    want, _ = jmodel.forward(params, jnp.asarray(toks), impl="ref")
    with torch.no_grad():
        got = model(torch.from_numpy(toks))
        with_img = model(torch.from_numpy(toks), img_embeds=torch.from_numpy(_img(cfg)))
    _close(got.numpy(), want)
    assert np.abs(got.numpy() - with_img.numpy()).max() > 100 * TOL


@pytest.mark.parametrize("filled", [True, False], ids=["filled", "zeros"])
def test_decode_steps_match_jax(filled):
    """Eight decode steps from a cache whose cross leaves hold the image
    K/V of every cross layer (``precompute_cross_kv``, in both packages) or
    the zeros of a fresh cache: logits and the whole cache after each step
    (the cross leaves unchanged)."""
    jcfg, cfg, jmodel, params, model = _env()
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    jcache = jmodel.init_cache(2, 12)
    if filled:
        img = jnp.asarray(_img(cfg))
        cross = jcache["periods"]["b4"]
        kv = [jattn.precompute_cross_kv(_jax_block(params, CROSS + PERIOD * c)["attn"], img, jcfg)
              for c in range(2)]
        jcache["periods"]["b4"] = {n: jnp.stack([kv[c][n] for c in range(2)])
                                   .astype(cross[n].dtype) for n in ("k", "v")}
    cache = cache_from_jax(jax.device_get(jcache), cfg, device="cpu")
    assert set(cache) == {"k", "v", "k_cross", "v_cross"}
    assert cache["k_cross"].shape == (2, 2, cfg.img_tokens, 1, 16)
    if filled:
        k, v = precompute_cross_kv(model.blocks[CROSS + PERIOD].attn,
                                   torch.from_numpy(_img(cfg)), cfg)
        _close(cache["k_cross"][1].numpy(), k.numpy())
        _close(cache["v_cross"][1].numpy(), v.numpy())
    cross0 = cache["k_cross"].clone()
    for p in range(8):
        tok = toks[:, p:p + 1]
        want, jcache = jmodel.decode_step(params, jnp.asarray(tok), jcache, p)
        got = model.decode_step(torch.from_numpy(tok), cache, p)
        _close(got.numpy(), want)
        for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(jcache)),
                        jax.tree_util.tree_leaves(cache_to_numpy(cache, cfg))):
            _close(b, a)
    assert torch.equal(cache["k_cross"], cross0)
    assert bool(cache["k_cross"].any()) == filled


# --------------------------------------------------------------- serving
def _jax_replica(fault_injector=None, **conf):
    jcfg, _, _, params, _ = _env()
    return JaxReplica(jcfg, params=params, fault_injector=fault_injector,
                      config=JaxEngineConfig(**{**ENGINE, **conf}))


def _port_replica(**conf):
    _, cfg, _, _, model = _env()
    return Replica(cfg, model, config=EngineConfig(**{**ENGINE, **conf}))


def _tokens(out):
    return {i: r.tokens for i, r in out.items()}


def _records(rep):
    return [(f.step, f.code, f.action, f.slots) for f in rep.metrics.faults]


def test_streams_match_jax_replica():
    traffic = _traffic()
    ref, _ = _serve(_jax_replica(), JaxRequest, traffic)
    got, _ = _serve(_port_replica(), Request, traffic)
    _assert_streams_match(_env(), ref, got, traffic)


def test_state_fault_matches_jax_and_lflr():
    """The poisoned element is the JAX replica's (K of layer 0, mapped
    through the bridge; never a cross leaf); served with the fault, both
    replicas latch NONFINITE_LOSS on the same slot at the same step with
    the same action, their streams are equal, and the port's are bit-equal
    to its clean run's."""
    cfg = _env()[1]
    jrep, prep = _jax_replica(), _port_replica()
    assert jrep.inject_state_fault(1) == prep.inject_state_fault(1) == 1
    want = cache_from_jax(jax.device_get(jrep.caches), cfg, slots=True, device="cpu")
    assert set(want) == set(prep.caches) == {"k", "v", "k_cross", "v_cross"}
    for name, t in prep.caches.items():
        assert torch.equal(torch.isnan(t), torch.isnan(want[name])), name
    assert int(torch.isnan(prep.caches["k"]).sum()) == 1
    assert prep.state_fault_layers() == [0]

    traffic = _traffic()
    clean, _ = _serve(_port_replica(), Request, traffic)
    jrep, prep = _jax_replica(), _port_replica()
    ref, jslot = _serve(jrep, JaxRequest, traffic, inject_at=3)
    got, slot = _serve(prep, Request, traffic, inject_at=3)
    assert slot == jslot is not None
    assert prep.metrics.faults[0].code == int(ErrorCode.NONFINITE_LOSS)
    assert prep.metrics.faults[0].slots == (slot,)
    assert _records(prep) == _records(jrep)
    assert all(r.status == OK for r in got.values())
    assert sum(r.retries for r in got.values()) == 1
    assert _tokens(got) == _tokens(clean)
    _assert_streams_match(_env(), ref, got, traffic)


ENGINES = {"overlap": {}, "blocking": dict(overlap=False)}


@pytest.mark.parametrize("engine", list(ENGINES))
def test_cross_leaves_zero_after_a_slot_reset(engine):
    """Every slot's cross leaves filled with ones before serving: each lane
    start zeroes its slot's row of them (the overlap engine's reset; the
    blocking engine's insert of its scratch cache's row), as every leaf of
    a fresh cache, so the streams are the clean replica's and the leaves
    end zero."""
    traffic = _traffic(seed=3)
    clean, _ = _serve(_port_replica(), Request, traffic)
    rep = _port_replica(**ENGINES[engine])
    for name in ("k_cross", "v_cross"):
        rep.caches[name].fill_(1.0)
    s = 1
    reset_cache_slot(rep.caches, s)
    assert not rep.caches["k_cross"][:, s].any() and rep.caches["k_cross"][:, 0].all()
    got, _ = _serve(rep, Request, traffic)
    assert _tokens(got) == _tokens(clean)
    assert not any(bool(rep.caches[n].any()) for n in ("k_cross", "v_cross"))


@pytest.mark.parametrize("conf", [dict(window=0, overlap=False), ENGINES["blocking"]],
                         ids=["stepwise", "blocking"])
def test_engines_bit_equal_window(conf):
    traffic = _traffic(seed=5)
    step, _ = _serve(_port_replica(**conf), Request, traffic)
    win, _ = _serve(_port_replica(), Request, traffic)
    assert all(r.status == OK for r in step.values())
    assert _tokens(step) == _tokens(win)


PAGED = dict(paged=True, page_size=8)


@pytest.mark.parametrize("inject_at", [None, 3], ids=["steady", "faulted"])
def test_paged_replica_matches_jax_and_contiguous(inject_at):
    """The JAX replica pages a cross stack: its self-attention K/V
    (capacity ``max_len``) go into the pool, its cross leaves (capacity
    ``img_tokens``) stay dense. The port's paged replica pages the same
    leaves; its streams and fault records are the JAX paged replica's, and
    bit-equal to its own contiguous engine's."""
    traffic = _traffic()
    jrep, prep = _jax_replica(**PAGED), _port_replica(**PAGED)
    assert [n for n in prep.caches if prep.layout.is_paged_path(n)] == ["k", "v"]
    ref, jslot = _serve(jrep, JaxRequest, traffic, inject_at=inject_at)
    got, slot = _serve(prep, Request, traffic, inject_at=inject_at)
    contiguous, _ = _serve(_port_replica(), Request, traffic, inject_at=inject_at)
    assert slot == jslot and (slot is None) == (inject_at is None)
    assert _records(prep) == _records(jrep)
    assert all(r.status == OK for r in got.values())
    assert _tokens(got) == _tokens(contiguous)
    _assert_streams_match(_env(), ref, got, traffic)
