"""The encoder against the JAX package, on the smoke config of
hubert-xlarge (2 layers, d_model 64, 4/4 heads of 16 — MHA, group 1 —,
LayerNorm with its biases drawn non-zero, plain-GeLU MLP, no rotary,
``causal`` False; float32), the JAX weights carried over by the bridge:

* the bidirectional forward from frame embeddings (``inputs_embeds``),
  against the JAX forward with its reference paths and with its Pallas
  kernel in interpret mode;
* ``make_prefill_step``'s logits and word against the JAX
  ``prefill_step``, clean and with a NaN in one frame of batch row 0: the
  attention is bidirectional, so every logit row of that batch row goes
  non-finite, and the other row's stay finite;
* the decode step, which masks causally whatever ``cfg.causal`` says, as the
  JAX package's decode does;
* the plain flash version at head_dim 80 (hubert-xlarge's: 1280 / 16), with
  and without the causal mask, S != T, against the JAX ``sdpa_ref``; the
  wrapper takes D 80 on the CPU.

Tolerance 1e-4 (absolute, as ``test_torch_model.py``: float32 on both
sides, other reduction orders; the flash outputs are of magnitude ~1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.models import attention as jattn
from repro.models import build_model
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.errors import ErrorCode
from repro_torch.kernels.flash_attention import flash_attention, sdpa_ref
from repro_torch.kernels.flash_attention.ops import HEAD_DIMS
from repro_torch.launch.steps import make_prefill_step
from repro_torch.weights import params_from_jax
from test_torch_model import with_biases

torch.set_num_threads(2)

ARCH = "hubert-xlarge"
TOL = 1e-4
_ENV: list = []


def _env():
    """(JAX config, port config, JAX model, JAX params, port model)."""
    if not _ENV:
        jcfg, cfg = jax_smoke_config(ARCH), smoke_config(ARCH)
        jmodel = build_model(jcfg)
        params = with_biases(jmodel.init(jax.random.PRNGKey(0)))
        model = params_from_jax(jax.device_get(params), cfg, device="cpu")
        _ENV.extend((jcfg, cfg, jmodel, params, model))
    return tuple(_ENV)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=TOL, atol=TOL)


def _frames(cfg, B=2, S=13, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def test_config_is_the_encoder():
    cfg = get_config(ARCH)
    assert cfg.is_encoder and not cfg.causal and cfg.rope_style == "none"
    assert cfg.resolved_head_dim == 80 and 80 in HEAD_DIMS
    assert cfg.num_heads == cfg.num_kv_heads == 16
    assert not get_config("llama-3.2-vision-11b").is_encoder


@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_forward_from_frames_matches_jax(impl):
    jcfg, cfg, jmodel, params, model = _env()
    x = _frames(cfg)
    want, _ = jmodel.forward(params, None, inputs_embeds=jnp.asarray(x), impl=impl)
    with torch.no_grad():
        got = model(inputs_embeds=torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 13, cfg.vocab_size)
    _close(got.numpy(), want)


def test_forward_is_bidirectional():
    """Redrawing the last frame moves the first position's logits (it would
    not under a causal mask)."""
    _, cfg, _, _, model = _env()
    x = _frames(cfg)
    y = x.copy()
    y[:, -1] = _frames(cfg, S=1, seed=9)[:, 0]
    with torch.no_grad():
        a = model(inputs_embeds=torch.from_numpy(x))
        b = model(inputs_embeds=torch.from_numpy(y))
    assert (a[:, 0] - b[:, 0]).abs().max() > 100 * TOL


@pytest.mark.parametrize("poison", [None, "nan"])
def test_prefill_step_matches_jax(poison):
    jcfg, cfg, _, params, model = _env()
    x = _frames(cfg, seed=1)
    if poison:
        x[0, 5, 3] = np.nan
    want, jword = jax_prefill_step(jcfg, impl="ref")(
        params, {"inputs_embeds": jnp.asarray(x)})
    got, word = make_prefill_step(model)(inputs_embeds=torch.from_numpy(x))
    assert word.dtype == torch.int32 and word.shape == ()
    assert int(word) == int(jword) == (int(ErrorCode.NONFINITE_LOSS) if poison else 0)
    finite = np.isfinite(np.asarray(want))
    np.testing.assert_array_equal(np.isfinite(got.numpy()), finite)
    _close(got.numpy()[finite], np.asarray(want)[finite])
    if poison:          # every row of batch 0, none of batch 1
        assert not finite[0].any(axis=-1).any() and finite[1].all()


def test_decode_masks_causally_as_jax():
    """Served, the encoder decodes as the JAX package's does: each step
    reads the keys written so far, never a later one (``cfg.causal`` is
    ignored by the decode mask in both packages)."""
    jcfg, cfg, jmodel, params, model = _env()
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    jcache, cache = jmodel.init_cache(2, 8), model.init_cache(2, 8)
    for p in range(6):
        tok = toks[:, p:p + 1]
        want, jcache = jmodel.decode_step(params, jnp.asarray(tok), jcache, p)
        got = model.decode_step(torch.from_numpy(tok), cache, p)
        _close(got.numpy(), want)
    # the first step's logits are the forward's over that token alone
    with torch.no_grad():
        one = model(torch.from_numpy(toks[:, :1]).long())
        first = model.decode_step(torch.from_numpy(toks[:, :1]), model.init_cache(2, 8), 0)
    _close(first.numpy(), one.numpy())


@pytest.mark.parametrize("causal", [False, True], ids=["bidirectional", "causal"])
@pytest.mark.parametrize("heads", [(4, 4), (8, 2)], ids=["mha", "gqa"])
def test_flash_plain_version_at_head_dim_80(causal, heads):
    """S 19 queries over T 23 keys (T > S: the causal rows see keys up to
    their position), D 80, against the JAX ``sdpa_ref``; the wrapper (the
    plain version on the CPU) gives the same bits as ``sdpa_ref``."""
    Hq, Hkv = heads
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 19, Hq, 80)).astype(np.float32)
    k = rng.standard_normal((2, 23, Hkv, 80)).astype(np.float32)
    v = rng.standard_normal((2, 23, Hkv, 80)).astype(np.float32)
    want = jattn.sdpa_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    zeros = torch.zeros(2, dtype=torch.int32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = sdpa_ref(tq, tk, tv, q_offset=zeros, causal=causal)
    _close(got.numpy(), want)
    assert torch.equal(flash_attention(tq, tk, tv, zeros, causal=causal), got)
