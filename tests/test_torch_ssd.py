"""The port's Mamba-2 pieces against the JAX package on the smoke
mamba2-2.7b config (2 SSD layers, d_model 64, d_inner 128 over 8 heads of
16, state 16, 1 group, chunk 8, float32), inputs from numpy seeds:

* the SSD kernel's plain version against the JAX Pallas ``ssd_intra_chunk``
  (interpret mode): y_diag and the chunk states;
* the port's ``ssd_scan`` against the JAX ``ssd_scan`` (Pallas, interpret
  mode), ``ssd_chunked`` and ``ssd_naive_ref``; its chunk-state recurrence
  past 32 chunks (96 and 1024);
* ``mamba2_mixer`` (through the scan) and ``mamba2_decode`` over several
  steps, with the state carried across the cache bridge;
* the prefill step's logits and its error word, clean and with a NaN in the
  input embedding;
* the wrapper's refusals;
* in bf16, the mixer, the decode and the whole model's logits element by
  element, which pins where each cast to the model dtype sits.

The rest is float32, so those tolerances cover reduction order only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_scan.kernel import ssd_intra_chunk as jax_intra_chunk
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.models import build_model
from repro.models import ssm as jssm
from repro_torch.configs import smoke_config
from repro_torch.core.errors import ErrorCode
from repro_torch.kernels import ssd_scan
from repro_torch.kernels.ssd_scan import (ssd_intra_chunk, ssd_intra_chunk_ref,
                                          ssd_naive_ref, ssd_scan_ref)
from repro_torch.kernels.ssd_scan.ref import ssd_inter_chunk
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models.ssm import mamba2_decode, mamba2_mixer
from repro_torch.weights import cache_from_jax, cache_to_numpy, params_from_jax

torch.set_num_threads(2)

ARCH = "mamba2-2.7b"
TOL = 1e-4        # float32 logits of magnitude ~50, reduction order only
SCAN_TOL = 2e-4   # the JAX package's own SSD test, fp32 outputs of ~5

# (b, s, h, p, g, n, chunk): the JAX package's SSD_CASES
# (tests/test_kernels.py), a case with 3 groups over 6 heads, and one at the
# full model's head_dim 64 and state 128
SSD_CASES = [
    (1, 16, 2, 8, 1, 8, 8),
    (2, 32, 4, 8, 2, 8, 8),
    (1, 24, 2, 16, 1, 8, 8),
    (1, 32, 2, 8, 1, 8, 16),
    (2, 16, 6, 8, 3, 8, 8),
    (1, 32, 2, 64, 1, 128, 16),
]
# the scan also below the chunk (s < chunk: one chunk of s steps) and at a
# chunk other than the smoke default
SCAN_CASES = SSD_CASES + [(2, 5, 4, 8, 2, 8, 8), (1, 12, 2, 8, 1, 8, 128),
                          (1, 48, 4, 16, 2, 16, 12)]


def _build(dtype):
    jcfg = jax_smoke_config(ARCH).replace(dtype=dtype)
    cfg = smoke_config(ARCH).replace(dtype=dtype)
    jmodel = build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    model = params_from_jax(jax.device_get(params), cfg, device="cpu")
    return jcfg, cfg, jmodel, params, model


@pytest.fixture(scope="module")
def env():
    return _build("float32")


@pytest.fixture(scope="module")
def env_bf16():
    return _build("bfloat16")


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def _inputs(case, seed=1):
    """x, dt, A, B, C as numpy fp32, drawn like the JAX package's SSD test:
    dt = softplus(normal), A = -exp(0.3 normal), B and C half-normal."""
    b, s, h, p, g, n, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = (-np.exp(0.3 * rng.standard_normal(h))).astype(np.float32)
    B = (0.5 * rng.standard_normal((b, s, g, n))).astype(np.float32)
    C = (0.5 * rng.standard_normal((b, s, g, n))).astype(np.float32)
    return x, dt, A, B, C


def _t(*arrays):
    return [torch.from_numpy(np.array(a, np.float32)) for a in arrays]


def _within_bf16_ulps(got, want, ulps, *, share=1.0):
    """Every element within ``ulps`` bf16 ulps of the largest |want|, and
    at most ``share`` of the elements different at all."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    diff = np.abs(got - want)
    assert diff.max() <= ulps * ulp, f"max |diff| {diff.max()} > {ulps} x {ulp}"
    assert (diff > 0).mean() <= share, f"{(diff > 0).mean():.3f} of the elements differ"


# ------------------------------------------------------------------ the scan
@pytest.mark.parametrize("case", SSD_CASES)
def test_intra_chunk_plain_matches_jax_kernel(case):
    """The kernel's function (its plain version, the wrapper's CPU path)
    against the JAX Pallas kernel in interpret mode, fed what the JAX
    wrapper feeds it: xd = x dt, ā = dt A, B and C repeated to every head.
    Tolerance 2e-4 as the JAX package's SSD test (fp32)."""
    b, s, h, p, g, n, chunk = case
    x, dt, A, B, C = _inputs(case)
    L = min(chunk, s)
    nc, rep = s // L, h // g
    y, states = ssd_intra_chunk(*_t(x, dt, A, B, C), chunk)
    assert y.dtype == states.dtype == torch.float32
    assert y.shape == (b, s, h, p) and states.shape == (b, nc, h, p, n)
    jy, jstates = jax_intra_chunk(
        jnp.asarray((x * dt[..., None]).reshape(b, nc, L, h, p)),
        jnp.asarray((dt * A).reshape(b, nc, L, h)),
        jnp.asarray(np.repeat(B, rep, axis=2).reshape(b, nc, L, h, n)),
        jnp.asarray(np.repeat(C, rep, axis=2).reshape(b, nc, L, h, n)),
        interpret=True)
    _close(y.numpy(), np.asarray(jy).reshape(b, s, h, p), SCAN_TOL)
    _close(states.numpy(), jstates, SCAN_TOL)
    ref_y, ref_states = ssd_intra_chunk_ref(*_t(x, dt, A, B, C), L)
    assert torch.equal(ref_y, y) and torch.equal(ref_states, states)


@pytest.mark.parametrize("case", SCAN_CASES)
def test_scan_matches_jax(case):
    """The port's ``ssd_scan`` (its CPU path: the plain intra-chunk part and
    the torch inter-chunk part) against the JAX ``ssd_scan`` (Pallas,
    interpret mode), ``ssd_chunked`` and the per-token ``ssd_naive_ref``;
    the port's copy of the naive oracle against the JAX one. 2e-4, fp32."""
    chunk = case[-1]
    x, dt, A, B, C = _inputs(case)
    got = ssd_scan(*_t(x, dt, A, B, C), chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == x.shape
    jin = [jnp.asarray(a) for a in (x, dt, A, B, C)]
    _close(got.numpy(), jax_ssd_scan(*jin, chunk=chunk), SCAN_TOL)
    _close(got.numpy(), jssm.ssd_chunked(*jin, chunk=chunk), SCAN_TOL)
    naive = jssm.ssd_naive_ref(*jin)
    _close(got.numpy(), naive, SCAN_TOL)
    _close(ssd_naive_ref(*_t(x, dt, A, B, C)).numpy(), naive, SCAN_TOL)
    assert torch.equal(ssd_scan_ref(*_t(x, dt, A, B, C), chunk=chunk), got)


def test_scan_in_bf16_keeps_the_model_dtype():
    """bf16 x, B, C (the model's dtype) with fp32 dt and A: the result comes
    back in bf16 and equals the fp32 scan of the same (widened) values
    rounded once — the widening inside the kernel's function is exact."""
    case = (2, 32, 4, 16, 2, 16, 8)
    x, dt, A, B, C = _t(*_inputs(case))
    xb, Bb, Cb = (t.bfloat16() for t in (x, B, C))
    got = ssd_scan(xb, dt, A, Bb, Cb, chunk=8)
    assert got.dtype == torch.bfloat16
    want = ssd_scan(xb.float(), dt, A, Bb.float(), Cb.float(), chunk=8)
    assert torch.equal(got, want.bfloat16())


def test_no_nan_from_the_masked_decay():
    """Segment sums above the diagonal are positive; with a steep decay
    their exp overflows to inf, and a 0/1 mask applied after exp would give
    inf · 0 = NaN. The decay is masked before exp, so a clean input gives a
    finite result, equal to the per-token oracle's."""
    case = (1, 16, 2, 8, 1, 8, 16)
    x, dt, A, B, C = _inputs(case)
    A = np.full_like(A, -50.0)                  # exp(50 * 16 * dt) = inf
    got = ssd_scan(*_t(x, dt, A, B, C), chunk=16)
    assert bool(torch.isfinite(got).all())
    _close(got.numpy(), jssm.ssd_naive_ref(*[jnp.asarray(a) for a in
                                             (x, dt, A, B, C)]), SCAN_TOL)


# ------------------------------------------------- the chunk-state recurrence
def _decay_matrix_inter_chunk(y_diag, states, dt, A, C, L):
    """The inter-chunk part as one product with the (b, h, nc, nc) chunk
    decay matrix, written out: the form ``ssd_inter_chunk`` keeps up to
    ``BLOCK`` chunks."""
    b, s, h, p = y_diag.shape
    g, n = C.shape[2], C.shape[3]
    nc = s // L
    cum = torch.cumsum((dt.float() * A.float()).reshape(b, nc, L, h), dim=2)
    chunk_sum = cum[:, :, -1].transpose(1, 2)
    upto = torch.cumsum(chunk_sum, dim=2)
    seg = (upto - chunk_sum)[..., :, None] - upto[..., None, :]
    before = torch.ones(nc, nc, dtype=torch.bool).tril(-1)
    carry = torch.exp(seg.masked_fill(~before, float("-inf")))
    h_in = torch.einsum("bhcd,bdhpn->bchpn", carry, states)
    h_in = h_in.reshape(b, nc, g, h // g, p, n)
    y_off = torch.einsum("bclgn,bcgrpn->bclgrp", C.float().reshape(b, nc, L, g, n), h_in)
    y_off = y_off.reshape(b, nc, L, h, p) * torch.exp(cum)[..., None]
    return y_diag + y_off.reshape(b, s, h, p)


@pytest.mark.parametrize("nc", [1, 8, 32])
def test_inter_chunk_is_the_decay_matrix_product_up_to_a_block(nc):
    """Up to ``BLOCK`` (32) chunks the inter-chunk part runs the decay-matrix
    product it always ran, bit for bit (every path of the port has nc <=
    32, so no measured bit moves)."""
    case = (2, 4 * nc, 6, 8, 3, 8, 4)
    x, dt, A, B, C = _t(*_inputs(case, seed=nc))
    y_diag, states = ssd_intra_chunk(x, dt, A, B, C, 4)
    want = _decay_matrix_inter_chunk(y_diag, states, dt, A, C, 4)
    assert torch.equal(ssd_inter_chunk(y_diag, states, dt, A, C, 4), want)


def test_inter_chunk_past_a_block_matches_the_jax_scan():
    """96 chunks (three blocks of 32: the blocked recurrence) against the
    JAX ``ssd_scan`` (its Pallas kernel in interpret mode and its sequential
    ``lax.scan`` over chunk states) and ``ssd_chunked``; fp32, 2e-4."""
    case = (1, 192, 2, 4, 1, 4, 2)
    x, dt, A, B, C = _inputs(case, seed=96)
    got = ssd_scan(*_t(x, dt, A, B, C), chunk=2)
    jin = [jnp.asarray(a) for a in (x, dt, A, B, C)]
    _close(got.numpy(), jax_ssd_scan(*jin, chunk=2), SCAN_TOL)
    _close(got.numpy(), jssm.ssd_chunked(*jin, chunk=2), SCAN_TOL)


def test_inter_chunk_at_1024_chunks_is_linear():
    """1024 chunks (32 blocks) against the JAX ``ssd_chunked`` and the
    per-token ``ssd_naive_ref``; fp32, 2e-4. The decay-matrix form would
    hold 1024 x 1024 decays per head; the blocked one 32 per chunk."""
    case = (1, 2048, 2, 2, 1, 2, 2)
    x, dt, A, B, C = _inputs(case, seed=1024)
    got = ssd_scan(*_t(x, dt, A, B, C), chunk=2)
    jin = [jnp.asarray(a) for a in (x, dt, A, B, C)]
    _close(got.numpy(), jssm.ssd_chunked(*jin, chunk=2), SCAN_TOL)
    _close(got.numpy(), ssd_naive_ref(*_t(x, dt, A, B, C)).numpy(), SCAN_TOL)


def _hi_lo(t):
    """``t`` (fp32) as a bf16 high part and the bf16 rounding of the rest,
    both widened back to fp32."""
    hi = t.bfloat16().float()
    return hi, (t - hi).bfloat16().float()


@pytest.mark.parametrize("out", ["y_diag", "states"])
def test_hi_lo_split_holds_the_ssd_tolerance(out):
    """Why the bf16 SSD kernel (``csrc/ssd_chunk_tc.cu``) splits its fp32
    MMA operands into a bf16 high and low part: the decay matrix
    ``M'_ij = (C_i·B_j) exp(cum_i − cum_j) dt_j`` for y_diag, the scaled
    ``x_j dt_j exp(cum_{L-1} − cum_j)`` for the state. At one chunk of the
    card test's statistics (L 128, P 64, N 128, 16 heads; x, B, C in bf16,
    exact in the MMA) each rounded to bf16 alone misses the card's SSD limit
    (1e-4 of the largest |want| plus 1e-4 of each; about 10-14x), while
    hi + lo stays near 0.03x. Emulated in fp32 on the CPU: the plain
    version's output is ``want``."""
    rng = np.random.default_rng(3)
    L, h, p, n = 128, 16, 64, 128
    t = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32))
    x = t(1, L, h, p).bfloat16()
    dt = torch.nn.functional.softplus(t(1, L, h))
    A = -torch.exp(0.3 * t(h))
    B, C = (0.5 * t(1, L, 1, n)).bfloat16(), (0.5 * t(1, L, 1, n)).bfloat16()
    want_y, want_states = ssd_intra_chunk_ref(x, dt, A, B, C, L)
    Bf, xf = B[0, :, 0].float(), x[0].float().transpose(0, 1)    # (L, n), (h, L, p)
    cum = torch.cumsum(dt[0] * A, 0)                               # (L, h)
    if out == "y_diag":
        scores = C[0, :, 0].float() @ Bf.T                         # once per group
        seg = cum.T[:, :, None] - cum.T[:, None, :]
        tril = torch.ones(L, L, dtype=torch.bool).tril()
        M = torch.where(tril, scores * torch.exp(seg.masked_fill(~tril, 0.0))
                        * dt[0].T[:, None, :], 0.0)
        hi, lo = _hi_lo(M)
        got = lambda *parts: sum(m @ xf for m in parts)  # noqa: E731
        want = want_y[0].transpose(0, 1)
    else:
        xs = xf * (dt[0] * torch.exp(cum[-1:] - cum)).T[:, :, None]
        hi, lo = _hi_lo(xs)
        got = lambda *parts: sum(m.transpose(1, 2) @ Bf for m in parts)  # noqa: E731
        want = want_states[0, 0]

    def excess(v):
        return ((v - want).abs() / (1e-4 * want.abs().max() + 1e-4 * want.abs())).max().item()
    assert excess(got(hi)) > 5
    assert excess(got(hi, lo)) < 0.1


@pytest.mark.parametrize("bad", [
    lambda x, dt, A, B, C: (x[:, :, :3], dt[..., :3], A[:3], B, C),  # H % G
    lambda x, dt, A, B, C: (x[:, :12], dt[:, :12], A, B[:, :12], C[:, :12]),  # S % L
    lambda x, dt, A, B, C: (x, dt[:, :, :2], A, B, C),          # dt shape
    lambda x, dt, A, B, C: (x, dt, A[:2], B, C),                # A shape
    lambda x, dt, A, B, C: (x, dt, A, B, C[..., :4]),           # C shape
    lambda x, dt, A, B, C: (x[0], dt, A, B, C),                 # not 4-D
    lambda x, dt, A, B, C: (x.double(), dt, A, B.double(), C.double()),  # dtype
    lambda x, dt, A, B, C: (x, dt, A, B.bfloat16(), C),         # mixed dtypes
    lambda x, dt, A, B, C: (x, dt.bfloat16(), A, B, C),         # dt not fp32
    lambda x, dt, A, B, C: (x.transpose(2, 3).contiguous().transpose(2, 3),
                            dt, A, B, C),                       # not contiguous
    lambda x, dt, A, B, C: (x[:, :0], dt[:, :0], A, B[:, :0], C[:, :0]),  # empty
    lambda x, dt, A, B, C: (x, dt, A, B, C.to("meta")),         # two devices
])
def test_scan_wrapper_rejects(bad):
    x, dt = torch.zeros((1, 16, 4, 8)), torch.zeros((1, 16, 4))
    A, B, C = torch.zeros(4), torch.zeros((1, 16, 2, 8)), torch.zeros((1, 16, 2, 8))
    with pytest.raises((ValueError, TypeError)):
        ssd_scan(*bad(x, dt, A, B, C), chunk=8)


def test_scan_never_takes_the_plain_path_off_the_cpu():
    meta = lambda *shape: torch.zeros(shape, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="unsupported device"):
        ssd_scan(meta(1, 8, 2, 4), meta(1, 8, 2), meta(2), meta(1, 8, 1, 4),
                 meta(1, 8, 1, 4), chunk=8)


# ------------------------------------------------------------- mixer, decode
def _layer(env, l):
    """Layer ``l``'s Mamba-2 params from the JAX tree, and the port's."""
    jcfg, cfg, _, params, model = env
    sub = params["stack"]["periods"][f"b{l % jcfg.period}"]["ssd"]
    jp = jax.tree_util.tree_map(lambda leaf: leaf[l // jcfg.period], sub)
    return jp, model.blocks[l].ssd


@pytest.mark.parametrize("S", [24, 5])
@pytest.mark.parametrize("impl", ["pallas", "chunked"])
def test_mamba2_mixer_matches_jax(env, impl, S):
    """The full-sequence mixer (the port's scan) against the JAX mixer with
    its Pallas kernel (interpret mode) and with its jnp ``ssd_chunked``:
    three chunks of 8, and one sequence shorter than the chunk."""
    jcfg, cfg = env[:2]
    jp, p = _layer(env, 1)
    x = np.random.default_rng(5).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    want = jssm.mamba2_mixer(jp, jnp.asarray(x), jcfg, impl=impl)
    _close(mamba2_mixer(p, *_t(x), cfg).numpy(), want)


def test_mamba2_decode_steps_match_jax(env):
    """Sixteen one-step updates from a zero state against the JAX decode:
    output, ``ssm`` and the conv history after every step; and the decode
    chain equals the full-sequence mixer (two chunks) row for row."""
    jcfg, cfg = env[:2]
    jp, p = _layer(env, 0)
    x = np.random.default_rng(6).standard_normal((3, 16, cfg.d_model)).astype(np.float32)
    jcache = jssm.init_mamba2_cache(3, jcfg, jnp.float32)
    state = torch.zeros((3, cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state_dim))
    conv = torch.zeros((3, cfg.ssm_conv_width - 1, jcache["conv"].shape[-1]))
    outs = []
    for t in range(x.shape[1]):
        want, jcache = jssm.mamba2_decode(jp, jnp.asarray(x[:, t:t + 1]), jcache, jcfg)
        y, state, conv = mamba2_decode(p, *_t(x[:, t:t + 1]), state, conv, cfg)
        _close(y.numpy(), want)
        _close(state.numpy(), jcache["ssm"])
        _close(conv.numpy(), jcache["conv"])
        outs.append(y)
    _close(torch.cat(outs, 1).numpy(), mamba2_mixer(p, *_t(x), cfg).numpy())


def test_decode_state_crosses_the_cache_bridge(env):
    """Six JAX decode steps, their cache carried into the port through the
    bridge, then six more steps on both sides: logits and every cache
    tensor (mapped back through the bridge) agree after each step."""
    jcfg, cfg, jmodel, params, model = env
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jcache = jmodel.init_cache(2, 16)
    for t in range(6):
        _, jcache = jmodel.decode_step(params, jnp.asarray(toks[:, t:t + 1]), jcache, t)
    cache = cache_from_jax(jax.device_get(jcache), cfg, device="cpu")
    assert set(cache) == {"ssm", "conv"}
    for t in range(6, 12):
        tok = toks[:, t:t + 1]
        want, jcache = jmodel.decode_step(params, jnp.asarray(tok), jcache, t)
        got = model.decode_step(torch.from_numpy(tok), cache, t)
        _close(got.numpy(), want)
        for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(jcache)),
                        jax.tree_util.tree_leaves(cache_to_numpy(cache, cfg))):
            _close(b, a)


# ---------------------------------------------------------------- prefill
@pytest.mark.parametrize("poison", [False, True])
def test_prefill_step_matches_jax(env, poison):
    """The prefill step's logits (through the SSD scan) and its one word for
    the batch, against the JAX prefill step with its Pallas kernel; a NaN
    in the input embedding of one prompt token must give NONFINITE_LOSS,
    bit-equal to the reference word."""
    jcfg, cfg, _, params, model = env
    toks = np.random.default_rng(8).integers(1, cfg.vocab_size, (2, 32)).astype(np.int32)
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
        assert logits.shape == (2, 32, cfg.vocab_size)
        _close(logits.numpy(), jlogits)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_decode_and_forward_drift_as_in_jax(dtype):
    """Two smoke layers: the decode's and the forward's logits over the same
    24 tokens, in both packages. In bf16 the SSD path's decode (one-step
    state update, the conv as one product) and forward (chunked scan, the
    conv as a sum of shifted products) round differently, and the JAX
    package's two paths drift apart as much: the port's mean drift stays
    within 1.5x the reference's. In fp32 they agree to 1e-4 — which is why
    the card's full-width forward check of this model holds its stream to
    the forward in fp32 as well as in bf16."""
    jcfg = jax_smoke_config(ARCH).replace(dtype=dtype)
    cfg = smoke_config(ARCH).replace(dtype=dtype)
    jmodel = build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    model = params_from_jax(jax.device_get(params), cfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 24)).astype(np.int32)

    def drift(forward, decode):
        fl = np.asarray(forward, np.float32)[0]
        dl = np.stack([np.asarray(decode(t), np.float32).reshape(-1)
                       for t in range(24)])
        return np.abs(dl - fl).mean()

    jcache = [jmodel.init_cache(1, 24)]
    jstep = jax.jit(jmodel.decode_step)

    def jdecode(t):
        lg, jcache[0] = jstep(params, jnp.asarray(toks[:, t:t + 1]), jcache[0],
                              jnp.int32(t))
        return lg
    want = drift(jmodel.forward(params, jnp.asarray(toks))[0], jdecode)
    cache = model.init_cache(1, 24)
    with torch.no_grad():
        got = drift(model(torch.from_numpy(toks)).float(),
                    lambda t: model.decode_step(torch.from_numpy(toks[:, t:t + 1]),
                                                cache, t).float())
    if dtype == "float32":
        assert got < 1e-4 and want < 1e-4
    else:
        assert 0 < got < 1.5 * want


# -------------------------------------------------------- bf16, cast by cast
# Each op rounds to the dtype it is declared in, in both packages (the JAX
# mixer runs op by op; ``jax.nn.silu`` rounds each of its steps, and the
# port spells it so), so the bf16 outputs differ only where fp32 summation
# order flips a rounding: a few percent of the elements at most, by at most
# one bf16 ulp of the largest output. A cast moved (the conv or silu in
# fp32, the D term added to the fp32 scan output) changes about half of the
# elements or more.
BF16_SHARE = 0.05
@pytest.mark.parametrize("impl", ["pallas", "chunked"])
def test_bf16_mixer_rounds_as_jax(env_bf16, impl):
    jcfg, cfg = env_bf16[:2]
    jp, p = _layer(env_bf16, 1)
    x = np.random.default_rng(5).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    want = jssm.mamba2_mixer(jp, jnp.asarray(x, jnp.bfloat16), jcfg, impl=impl)
    with torch.no_grad():
        got = mamba2_mixer(p, _t(x)[0].bfloat16(), cfg)
    assert got.dtype == torch.bfloat16
    _within_bf16_ulps(got.float().numpy(), want, 1, share=BF16_SHARE)


def test_bf16_decode_rounds_as_jax(env_bf16):
    """Twenty-four one-step updates: the output as the mixer's above, the
    fp32 state to reduction order, the bf16 conv history bit-equal."""
    jcfg, cfg = env_bf16[:2]
    jp, p = _layer(env_bf16, 0)
    x = np.random.default_rng(6).standard_normal((3, 24, cfg.d_model)).astype(np.float32)
    xb = _t(x)[0].bfloat16()
    jcache = jssm.init_mamba2_cache(3, jcfg, jnp.bfloat16)
    state = torch.zeros((3, cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state_dim))
    conv = torch.zeros((3, cfg.ssm_conv_width - 1, jcache["conv"].shape[-1]),
                       dtype=torch.bfloat16)
    wants, gots = [], []
    with torch.no_grad():
        for t in range(x.shape[1]):
            want, jcache = jssm.mamba2_decode(
                jp, jnp.asarray(x[:, t:t + 1], jnp.bfloat16), jcache, jcfg)
            y, state, conv = mamba2_decode(p, xb[:, t:t + 1], state, conv, cfg)
            wants.append(np.asarray(want, np.float32))
            gots.append(y.float().numpy())
    _within_bf16_ulps(np.concatenate(gots, 1), np.concatenate(wants, 1), 1,
                      share=BF16_SHARE)
    assert state.dtype == torch.float32
    _close(state.numpy(), jcache["ssm"])
    np.testing.assert_array_equal(conv.float().numpy(),
                                  np.asarray(jcache["conv"], np.float32))


@pytest.mark.parametrize("path", ["forward", "decode"])
def test_bf16_logits_match_jax(env_bf16, path):
    """The whole bf16 model's fp32 logits over 24 tokens, the forward
    (through the scan) and the decode step by step, against the JAX model
    with jit off (under jit XLA fuses the bf16 elementwise ops and rounds
    them otherwise than their declared dtypes say). A rounding flipped by
    summation order in the residual stream reaches every logit, by up to
    about one bf16 ulp of the largest logit; two are allowed."""
    jcfg, cfg, jmodel, params, model = env_bf16
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    cache = model.init_cache(2, 24)
    with jax.disable_jit(), torch.no_grad():
        if path == "forward":
            want = jmodel.forward(params, jnp.asarray(toks))[0]
            got = model(torch.from_numpy(toks))
        else:
            jcache, want, got = jmodel.init_cache(2, 24), [], []
            for t in range(toks.shape[1]):
                tok = toks[:, t:t + 1]
                lg, jcache = jmodel.decode_step(params, jnp.asarray(tok), jcache,
                                                jnp.int32(t))
                want.append(np.asarray(lg, np.float32).reshape(2, 1, -1))
                got.append(model.decode_step(torch.from_numpy(tok), cache, t)
                           .reshape(2, 1, -1))
            want, got = np.concatenate(want, 1), torch.cat(got, 1)
    assert got.dtype == torch.float32 and got.shape == (2, 24, cfg.vocab_size)
    _within_bf16_ulps(got.numpy(), want, 2)
