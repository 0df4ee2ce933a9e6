"""The port's LayerNorm and partial 2-D rotary against the JAX package's
``repro.models.layers`` (``apply_norm`` with ``kind="layernorm"``,
``apply_rope`` with ``style="partial2d"``), and the half-split rotary
unchanged:

* LayerNorm in fp32 and bf16 with a non-trivial scale and bias. fp32:
  both sides compute the mean, the centred variance and the affine map in
  fp32 and differ in summation order only, ~1e-6 on outputs of magnitude
  ~10 — held to 1e-5 absolute. bf16: both round the same fp32 value once,
  so an element may differ by the one bf16 ulp that a last-bit fp32
  difference can cross — held to 2^-8 of itself.
* ``partial2d`` at head_dim 16 and 128, fraction 0.5 (chatglm3's), at
  positions up to 2^15: the rotated half within 1e-6 absolute in fp32 (the
  two sides' ``cos``/``sin`` of angles up to 2^15 rad differ by an ulp or
  two; inputs of magnitude ~3), within a bf16 ulp in bf16; the pass-through
  half bit-equal to the input in both.
* ``standard`` against the JAX package at the same tolerances, and
  bit-equal to the half-split formula the port had before ``partial2d``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jax_layers
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models.layers import apply_norm, apply_rope, rope_tables

torch.set_num_threads(2)

NORM_TOL = 1e-5
ROPE_TOL = 1e-6
BF16_RTOL = 2.0 ** -8
THETA = 10000.0
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _as_np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype, atol):
    if dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_layernorm_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    # an offset mean, so centring matters, and a spread of row scales
    x = (rng.standard_normal((3, 7, 64)) * rng.uniform(0.1, 4.0, (3, 7, 1))
         + 1.5).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    want = jax_layers.apply_norm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                                 jnp.asarray(x).astype(jdt), "layernorm")
    got = apply_norm(torch.from_numpy(scale), torch.from_numpy(x).to(tdt),
                     "layernorm", bias=torch.from_numpy(bias))
    assert got.dtype == tdt and got.shape == x.shape
    _close(_as_np(got), _as_np(want), dtype, NORM_TOL)
    # the bias is added: zero bias gives the output less the bias
    unbiased = apply_norm(torch.from_numpy(scale), torch.from_numpy(x),
                          "layernorm", bias=torch.zeros(64))
    assert not torch.equal(unbiased, apply_norm(
        torch.from_numpy(scale), torch.from_numpy(x), "layernorm",
        bias=torch.from_numpy(bias)))


def test_unknown_norm_raises():
    with pytest.raises(ValueError, match="unknown norm"):
        apply_norm(torch.ones(4), torch.ones(2, 4), "groupnorm")


def _positions():
    """(2, 9) int32: 0..8, and positions out to 2^15."""
    return np.stack([np.arange(9), [0, 1, 100, 4095, 4096, 12345,
                                    2 ** 15 - 2, 2 ** 15 - 1, 2 ** 15]]).astype(np.int32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("head_dim", [16, 128])
def test_partial2d_matches_jax(head_dim, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(head_dim)
    x = (3 * rng.standard_normal((2, 9, 3, head_dim))).astype(np.float32)
    pos = _positions()
    want = jax_layers.apply_rope(jnp.asarray(x).astype(jdt), jnp.asarray(pos),
                                 theta=THETA, style="partial2d", fraction=0.5)
    rope = rope_tables(torch.from_numpy(pos), head_dim=head_dim, theta=THETA,
                       style="partial2d", fraction=0.5)
    assert rope.rot_dim == head_dim // 2
    assert rope.cos.shape == (2, 9, 1, head_dim // 4)
    xt = torch.from_numpy(x).to(tdt)
    got = apply_rope(xt, rope)
    assert got.dtype == tdt and got.shape == x.shape
    half = head_dim // 2
    _close(_as_np(got)[..., :half], _as_np(want)[..., :half], dtype, ROPE_TOL)
    # the pass-through half keeps the input's bits, in both packages
    assert torch.equal(got[..., half:], xt[..., half:])
    np.testing.assert_array_equal(_as_np(want)[..., half:], _as_np(xt)[..., half:])
    # and the rotation acts: position 0 is the identity, later ones are not
    assert torch.equal(got[0, 0], xt[0, 0])
    assert not torch.equal(got[1, 2:, :, :half], xt[1, 2:, :, :half])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("head_dim", [16, 128])
def test_standard_rope_unchanged(head_dim, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(head_dim + 1)
    x = (3 * rng.standard_normal((2, 9, 3, head_dim))).astype(np.float32)
    pos = _positions()
    want = jax_layers.apply_rope(jnp.asarray(x).astype(jdt), jnp.asarray(pos),
                                 theta=THETA)
    rope = rope_tables(torch.from_numpy(pos), head_dim=head_dim, theta=THETA)
    xt = torch.from_numpy(x).to(tdt)
    got = apply_rope(xt, rope)
    _close(_as_np(got), _as_np(want), dtype, ROPE_TOL)
    # the half-split formula, spelled as before partial2d came
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    ang = torch.from_numpy(pos).float()[..., None] * (1.0 / (THETA ** exps))
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = xt.float().chunk(2, dim=-1)
    old = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(tdt)
    assert torch.equal(got, old)


def test_rope_none_and_unknown_style():
    pos = torch.zeros((1, 2), dtype=torch.int32)
    assert rope_tables(pos, head_dim=16, theta=THETA, style="none") is None
    x = torch.ones(1, 2, 1, 16)
    assert apply_rope(x, None) is x
    with pytest.raises(ValueError, match="unknown rope style"):
        rope_tables(pos, head_dim=16, theta=THETA, style="yarn")


@pytest.mark.parametrize("arch", ["starcoder2-3b", "chatglm3-6b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_new_architectures_build(arch):
    """The three configs build (on the meta device: no memory) with their
    layer norms' biases, or the partial rotary at the model's ``_rope``."""
    cfg = get_config(arch)
    model = Model(cfg, device="meta", seed=None)
    names = {n for n, _ in model.named_parameters()}
    has_bias = cfg.norm == "layernorm"
    assert ("final_norm_bias" in names) == has_bias
    assert ("blocks.0.norm1_bias" in names) == has_bias
    assert ("blocks.0.norm2_bias" in names) == has_bias
    rope = model._rope(torch.zeros((1, 1), dtype=torch.int32, device="meta"))
    assert rope.style == cfg.rope_style
    assert rope.rot_dim == (64 if cfg.rope_style == "partial2d" else 128)


def test_cross_attention_still_raises():
    """The two architectures of the cross block and the encoder resolve and
    build (on the meta device), ``cross`` is a block kind with its gates;
    an unknown block kind or architecture still raises."""
    from repro_torch.models.transformer import BLOCK_KINDS, check_block_kind
    check_block_kind("cross")
    assert "cross" in BLOCK_KINDS
    vlm, hub = get_config("llama-3.2-vision-11b"), get_config("hubert-xlarge")
    assert vlm.pattern_layers.count("cross") == 8 and vlm.img_tokens == 1601
    assert hub.is_encoder and hub.resolved_head_dim == 80
    model = Model(vlm, device="meta", seed=None)
    names = {n for n, _ in model.named_parameters()}
    assert {"blocks.4.gate_attn", "blocks.4.gate_mlp"} <= names
    assert "blocks.0.gate_attn" not in names
    cache = model.init_cache(2, 16)
    assert cache["k_cross"].shape == (8, 2, 1601, 8, 128) and cache["k"].shape[0] == 32
    assert Model(hub, device="meta", seed=None).blocks[0].norm1_bias is not None
    with pytest.raises(ValueError, match="unknown block type"):
        check_block_kind("conv")
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("llama-3.2-vision-90b")
