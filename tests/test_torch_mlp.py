"""The port's bf16 MLPs against the JAX package's, rounding by rounding.

Each elementwise op rounds to the dtype it is declared in, in both packages
when the JAX side runs op by op (jit off: under jit XLA fuses the bf16
elementwise ops and rounds them otherwise than their dtypes say). The port
spells ``jax.nn.silu`` and ``jax.nn.gelu(approximate=True)`` op for op, so
in bf16 the activations agree bit for bit and an MLP's outputs differ only
where fp32 summation order flips a rounding. ``F.silu`` and
``F.gelu(approximate="tanh")`` round once and differ from JAX on about 40%
of the activations; through the output projection that flips the rounding
of far more than ``BF16_SHARE`` of the outputs. Then the whole bf16
qwen3-1.7b and recurrentgemma-2b smoke models (2 and 8 layers, d_model 64),
forward and decode, within 2 bf16 ulps of the largest logit, as
``tests/test_torch_ssd.py`` holds mamba2.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import build_model
from repro.models.layers import apply_mlp as jax_apply_mlp
from repro_torch.configs import smoke_config
from repro_torch.models.layers import apply_mlp, gelu_tanh, silu
from repro_torch.weights import params_from_jax
from test_torch_ssd import BF16_SHARE, _within_bf16_ulps

torch.set_num_threads(2)

ACTIVATIONS = {"silu": (silu, jax.nn.silu),
               "gelu": (gelu_tanh, lambda x: jax.nn.gelu(x, approximate=True))}


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


@pytest.mark.parametrize("name", sorted(ACTIVATIONS))
def test_bf16_activation_rounds_as_jax(name):
    """200 000 values (normal x 3): each within one bf16 ulp of its own
    magnitude of the JAX activation, and at most ``BF16_SHARE`` different
    at all (the op-for-op spellings differ on none here)."""
    port, ref = ACTIVATIONS[name]
    x = (3 * np.random.default_rng(0).standard_normal(200_000)).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(ref(jnp.asarray(x, jnp.bfloat16)), np.float32)
    got = port(_bf16(x)).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    assert (np.abs(got - want) <= ulp).all()
    assert (got != want).mean() <= BF16_SHARE


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_bf16_mlp_rounds_as_jax(kind):
    """``apply_mlp`` at the smoke widths (d_model 64, d_ff 192) on 64 rows:
    within one bf16 ulp of the largest output, at most ``BF16_SHARE`` of
    the outputs different."""
    rng = np.random.default_rng(1)
    d, f = 64, 192
    w = {"wi": rng.standard_normal((d, f)) / np.sqrt(d),
         "wo": rng.standard_normal((f, d)) / np.sqrt(f)}
    if kind != "gelu":
        w["wg"] = rng.standard_normal((d, f)) / np.sqrt(d)
    x = rng.standard_normal((4, 16, d))
    with jax.disable_jit():
        want = jax_apply_mlp({k: jnp.asarray(v, jnp.bfloat16) for k, v in w.items()},
                             jnp.asarray(x, jnp.bfloat16), kind)
    got = apply_mlp(SimpleNamespace(**{k: _bf16(v) for k, v in w.items()}),
                    _bf16(x), kind)
    assert got.dtype == torch.bfloat16
    _within_bf16_ulps(got.float().numpy(), np.asarray(want, np.float32), 1,
                      share=BF16_SHARE)


@pytest.fixture(scope="module", params=["qwen3-1.7b", "recurrentgemma-2b"])
def env_bf16(request):
    jcfg = jax_smoke_config(request.param).replace(dtype="bfloat16")
    cfg = smoke_config(request.param).replace(dtype="bfloat16")
    jmodel = build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    model = params_from_jax(jax.device_get(params), cfg, device="cpu")
    return jcfg, cfg, jmodel, params, model


@pytest.mark.parametrize("path", ["forward", "decode"])
def test_bf16_logits_match_jax(env_bf16, path):
    """The whole bf16 model's fp32 logits over 20 tokens (past
    recurrentgemma's smoke window of 16), the forward and the decode step
    by step, against the JAX model with jit off: within two bf16 ulps of
    the largest logit (a rounding flipped by summation order in the
    residual stream reaches every logit)."""
    jcfg, cfg, jmodel, params, model = env_bf16
    S = 20
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    cache = model.init_cache(2, S)
    with jax.disable_jit(), torch.no_grad():
        if path == "forward":
            want = jmodel.forward(params, jnp.asarray(toks))[0]
            got = model(torch.from_numpy(toks))
        else:
            jcache, want, got = jmodel.init_cache(2, S), [], []
            for t in range(S):
                tok = toks[:, t:t + 1]
                lg, jcache = jmodel.decode_step(params, jnp.asarray(tok), jcache,
                                                jnp.int32(t))
                want.append(np.asarray(lg, np.float32).reshape(2, 1, -1))
                got.append(model.decode_step(torch.from_numpy(tok), cache, t)
                           .reshape(2, 1, -1))
            want, got = np.concatenate(want, 1), torch.cat(got, 1)
    assert got.dtype == torch.float32 and got.shape == (2, S, cfg.vocab_size)
    _within_bf16_ulps(got.numpy(), want, 2)
