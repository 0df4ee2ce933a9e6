"""The port's recurrentgemma pieces against the JAX package on the smoke
recurrentgemma-2b config (8 layers, d_model 64, lru_width 64 over 4 gate
blocks, sliding window 16, float32), inputs from numpy seeds:

* the RG-LRU scan's plain version against the JAX Pallas kernel (interpret
  mode) and ``rglru_scan_ref``;
* ``rglru_mixer`` (through the scan) and ``rglru_decode`` over several steps;
* ring-cache ``attention_decode`` across the wrap (positions 0…40, window 16);
* the prefill step's logits and its error word, clean and with a NaN in the
  input embedding.

Tolerances are stated per test; everything is float32, so they cover the
reduction order only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.kernels.rglru_scan import rglru_scan as jax_rglru_scan
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.models import attention as jattn
from repro.models import build_model
from repro.models import rglru as jrglru
from repro_torch.configs import smoke_config
from repro_torch.core.errors import ErrorCode
from repro_torch.kernels import rglru_scan
from repro_torch.kernels.rglru_scan import rglru_scan_ref
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models.attention import (Attention, attention_decode,
                                          ring_write_index)
from repro_torch.models.layers import rope_tables
from repro_torch.models.rglru import rglru_decode, rglru_mixer
from repro_torch.weights import params_from_jax

torch.set_num_threads(2)

ARCH = "recurrentgemma-2b"
TOL = 1e-4        # float32, reduction order only (logits of magnitude ~80)


@pytest.fixture(scope="module")
def env():
    jcfg = jax_smoke_config(ARCH)
    cfg = smoke_config(ARCH)
    jmodel = build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    model = params_from_jax(jax.device_get(params), cfg, device="cpu")
    return jcfg, cfg, jmodel, params, model


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ------------------------------------------------------------------ the scan
@pytest.mark.parametrize("B,S,W,blk", [(1, 16, 128, 128), (2, 32, 256, 128),
                                       (1, 64, 128, 64), (2, 40, 64, 64)])
def test_scan_plain_matches_jax_kernel(B, S, W, blk):
    """The scan's plain version (the wrapper's CPU path) against the JAX
    Pallas kernel in interpret mode and its sequential oracle, on the JAX
    kernel test's input distribution. Tolerance 1e-5 as the JAX kernel's
    own test: fp32 recurrences, reduction order only."""
    rng = np.random.default_rng(B * 1000 + S + W)
    x = rng.standard_normal((B, S, W)).astype(np.float32)
    log_a = -np.log1p(np.exp(rng.standard_normal((B, S, W)))).astype(np.float32)
    got = rglru_scan(_t(x), _t(log_a))
    assert got.dtype == torch.float32 and got.shape == (B, S, W)
    want = jax_rglru_scan(jnp.asarray(x), jnp.asarray(log_a), block_w=blk)
    _close(got.numpy(), want, 1e-5)
    _close(got.numpy(), jrglru.rglru_scan_ref(jnp.asarray(x), jnp.asarray(log_a)),
           1e-5)
    np.testing.assert_array_equal(rglru_scan_ref(_t(x), _t(log_a)).numpy(),
                                  got.numpy())


def _gated(x_in, log_a):
    a = torch.exp(log_a)
    return a, torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * x_in


def _chunked_scan(x_in, log_a, T, drop_prod=False):
    """The kernel's order of work, in torch: each chunk of T steps but the
    last scanned from a zero state (its decay product and end state), the
    carries folded in chunk order, and each chunk scanned again from the
    carry-out of the chunk before it. ``drop_prod`` folds a decay product
    of 0 (a faulty combine that keeps only the last chunk's end state)."""
    a, x = _gated(x_in, log_a)
    S = x.shape[1]
    starts = list(range(0, S, T))
    carry = [torch.zeros_like(x[:, 0])]
    for t0 in starts[:-1]:
        prod, h = torch.ones_like(x[:, 0]), torch.zeros_like(x[:, 0])
        for t in range(t0, t0 + T):
            h = a[:, t] * h + x[:, t]
            prod = prod * a[:, t]
        if drop_prod:
            prod = torch.zeros_like(prod)
        carry.append(prod * carry[-1] + h)
    out = torch.empty_like(x)
    for k, t0 in enumerate(starts):
        h = carry[k]
        for t in range(t0, min(S, t0 + T)):
            h = a[:, t] * h + x[:, t]
            out[:, t] = h
    return out


def _log_a(rng, B, S, W, memory):
    """log_a as recurrentgemma makes it, -8 softplus(lam) sigmoid(.), over
    W channels from the longest memory to the shortest: ``init`` spans the
    model's initial lam (softplus 0.9 to 4: a over a 128-step chunk decays
    to 0 in fp32), ``long`` the Griffin paper's a^8 in [0.9, 0.999] (a
    chunk's decay product up to about 0.94, so the carry matters)."""
    lo, hi = {"init": (0.9, 4.0), "long": (-np.log(0.999) / 8, -np.log(0.9) / 8)}[memory]
    lam = torch.log(torch.expm1(torch.linspace(lo, hi, W)))
    return -8.0 * torch.nn.functional.softplus(lam) * torch.sigmoid(
        _t(rng.standard_normal((B, S, W))))


def _excess(got, want):
    return ((got - want).abs() / (1e-4 + 1e-4 * want.abs())).max().item()


# (B, S, W): several chunks and a ragged last chunk, and one chunk
CHUNKED_CASES = [(2, 1000, 64), (1, 300, 32), (2, 100, 16)]


@pytest.mark.parametrize("memory", ["init", "long"])
@pytest.mark.parametrize("shape", CHUNKED_CASES)
def test_chunked_combine_holds_the_scan_tolerance(shape, memory):
    """The chunked scan the kernel runs (``csrc/rglru_scan.cu``, chunks of
    ``ops.CHUNK`` steps), emulated in torch in its order, against the
    sequential plain version: within the card's scan limit (1e-4 abs +
    1e-4 rel); one step's log_a halved (a control) is not."""
    from repro_torch.kernels.rglru_scan.ops import CHUNK
    B, S, W = shape
    rng = np.random.default_rng(S + W)
    x_in = _t(rng.standard_normal((B, S, W)))
    log_a = _log_a(rng, B, S, W, memory)
    want = rglru_scan_ref(x_in, log_a)
    assert _excess(_chunked_scan(x_in, log_a, CHUNK), want) <= 1
    bad = log_a.clone()
    bad[0, S // 2 + 5, 0] *= 0.5
    assert _excess(_chunked_scan(x_in, bad, CHUNK), want) > 1


# (B, S, W): three or more chunks, the last ragged
CARRY_CASES = [(2, 1000, 64), (1, 300, 32), (1, 2000, 16)]


@pytest.mark.parametrize("shape", CARRY_CASES)
def test_chunk_carry_reaches_later_chunks(shape):
    """On long-memory log_a the carry decides chunks 2 onward, so there the
    combine is held to the scan limit where it matters: chunk 2 sees chunk
    0 only through chunk 1's decay product. Controls, each over chunks 2
    onward: one log_a of chunk 0 set to -1 exceeds the limit, and so does a
    combine that folds a decay product of 0."""
    from repro_torch.kernels.rglru_scan.ops import CHUNK
    B, S, W = shape
    rng = np.random.default_rng(7 * S + W)
    x_in = _t(rng.standard_normal((B, S, W)))
    log_a = _log_a(rng, B, S, W, "long")
    later = slice(2 * CHUNK, S)
    want = rglru_scan_ref(x_in, log_a)[:, later]
    assert _excess(_chunked_scan(x_in, log_a, CHUNK)[:, later], want) <= 1
    bad = log_a.clone()
    bad[0, CHUNK - 8, 0] = -1.0
    assert _excess(_chunked_scan(x_in, bad, CHUNK)[:, later], want) > 1
    assert _excess(_chunked_scan(x_in, log_a, CHUNK, drop_prod=True)[:, later],
                   want) > 1


@pytest.mark.parametrize("bad", [
    lambda x, a: (x, a[:, :3]),                         # shapes differ
    lambda x, a: (x[0], a[0]),                          # not 3-D
    lambda x, a: (x.double(), a.double()),              # dtype
    lambda x, a: (x.bfloat16(), a),                     # mixed / bf16
    lambda x, a: (x.transpose(1, 2), a.transpose(1, 2)),  # not contiguous
    lambda x, a: (x[:, :0], a[:, :0]),                  # empty
    lambda x, a: (x, a.to("meta")),                     # two devices
])
def test_scan_wrapper_rejects(bad):
    x, a = torch.zeros((2, 5, 8)), torch.zeros((2, 5, 8))
    with pytest.raises((ValueError, TypeError)):
        rglru_scan(*bad(x, a))


def test_scan_never_takes_the_plain_path_off_the_cpu():
    with pytest.raises(ValueError, match="unsupported device"):
        rglru_scan(torch.zeros((1, 2, 4), device="meta"),
                   torch.zeros((1, 2, 4), device="meta"))


# ------------------------------------------------------------- mixer, decode
def _layer(env, l):
    """Layer ``l``'s RG-LRU params from the JAX tree, and the port's."""
    jcfg, cfg, _, params, model = env
    sub = params["stack"]["periods"][f"b{l % jcfg.period}"]["rglru"]
    jp = jax.tree_util.tree_map(lambda leaf: leaf[l // jcfg.period], sub)
    return jp, model.blocks[l].rglru


@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_rglru_mixer_matches_jax(env, impl):
    """The full-sequence mixer (the port's scan) against the JAX mixer with
    its sequential scan and with its Pallas kernel (interpret mode)."""
    jcfg, cfg = env[:2]
    jp, p = _layer(env, 3)
    x = np.random.default_rng(5).standard_normal((2, 23, cfg.d_model)).astype(np.float32)
    want = jrglru.rglru_mixer(jp, jnp.asarray(x), jcfg, impl=impl)
    _close(rglru_mixer(p, _t(x)).numpy(), want)


def test_rglru_decode_steps_match_jax(env):
    """Twelve one-step updates from a zero state against the JAX decode:
    output, ``h`` and the conv history after every step; and the decode
    chain equals the full-sequence mixer row for row."""
    jcfg, cfg = env[:2]
    jp, p = _layer(env, 1)
    x = np.random.default_rng(6).standard_normal((3, 12, cfg.d_model)).astype(np.float32)
    jcache = jrglru.init_rglru_cache(3, jcfg, jnp.float32)
    w = cfg.resolved_lru_width
    h, conv = torch.zeros((3, w)), torch.zeros((3, 3, w))
    outs = []
    for t in range(x.shape[1]):
        want, jcache = jrglru.rglru_decode(jp, jnp.asarray(x[:, t:t + 1]), jcache, jcfg)
        y, h, conv = rglru_decode(p, _t(x[:, t:t + 1]), h, conv)
        _close(y.numpy(), want)
        _close(h.numpy(), jcache["h"])
        _close(conv.numpy(), jcache["conv"])
        outs.append(y)
    _close(torch.cat(outs, 1).numpy(), rglru_mixer(p, _t(x)).numpy())


# --------------------------------------------------------- ring attention
def test_ring_attention_decode_across_the_wrap(env):
    """A sliding layer's ring (capacity = window = 16) through positions
    0…40: the port writes at ``pos % cap`` and reads with the kernel's
    causal mask and NO window (slot index < min(cap, pos + 1)); the JAX
    ring reconstructs slot positions and masks by the window. Outputs and
    the whole ring agree at every step, long past the wrap."""
    jcfg, cfg, _, params, model = env
    l = 2                                           # the first sliding layer
    assert cfg.pattern_layers[l] == "sliding"
    jp = jax.tree_util.tree_map(lambda leaf: leaf[0],
                                params["stack"]["periods"]["b2"]["attn"])
    p: Attention = model.blocks[l].attn
    cap, B = cfg.sliding_window, 2
    hd = cfg.resolved_head_dim
    jcache = jattn.init_kv_cache(B, cap, cfg.num_kv_heads, hd, jnp.float32)
    k = torch.zeros((B, cap, cfg.num_kv_heads, hd))
    v = torch.zeros_like(k)
    x = np.random.default_rng(7).standard_normal((B, 41, cfg.d_model)).astype(np.float32)
    for pos in range(41):
        want, jcache = jattn.attention_decode(
            jp, jnp.asarray(x[:, pos:pos + 1]), jcache, pos, jcfg,
            window=cfg.sliding_window)
        posv = torch.full((B,), pos, dtype=torch.int32)
        rope = rope_tables(posv[:, None], head_dim=hd, theta=cfg.rope_theta)
        got = attention_decode(p, _t(x[:, pos:pos + 1]), k, v, posv, rope,
                               ring_write_index(posv, cap), cfg)
        _close(got.numpy(), want)
        _close(k.numpy(), jcache["k"])
        _close(v.numpy(), jcache["v"])


def test_ring_write_index_wraps():
    pos = torch.tensor([0, 15, 16, 17, 40], dtype=torch.int32)
    rows, slots = ring_write_index(pos, 16)
    assert rows.tolist() == [0, 1, 2, 3, 4] and slots.tolist() == [0, 15, 0, 1, 8]


# ---------------------------------------------------------------- prefill
@pytest.mark.parametrize("poison", [False, True])
def test_prefill_step_matches_jax(env, poison):
    """The prefill step's logits (through the scan and the sliding flash
    path) and its one word for the batch, against the JAX prefill step; a
    NaN in the input embedding of one prompt token must give
    NONFINITE_LOSS, bit-equal to the reference word."""
    jcfg, cfg, _, params, model = env
    toks = np.random.default_rng(8).integers(1, cfg.vocab_size, (2, 37)).astype(np.int32)
    if poison:
        params = jax.tree_util.tree_map(lambda a: a, params)
        emb = np.array(params["embed"]["embedding"])
        emb[toks[1, 20], 5] = np.nan
        params["embed"]["embedding"] = jnp.asarray(emb)
        model = params_from_jax(jax.device_get(params), cfg, device="cpu")
    jlogits, jword = jax_prefill_step(jcfg, impl="pallas")(
        params, {"tokens": jnp.asarray(toks)})
    logits, word = make_prefill_step(model)(torch.from_numpy(toks))
    assert word.dtype == torch.int32 and word.shape == ()
    assert int(word) == int(np.asarray(jword))
    assert int(word) == (int(ErrorCode.NONFINITE_LOSS) if poison else 0)
    if not poison:
        assert logits.shape == (2, 37, cfg.vocab_size)
        _close(logits.numpy(), jlogits)
