"""The SSD scan's gradient in the port against ``jax.vjp`` of the JAX
package's ``ssd_chunked`` (what the reference's training step
differentiates), inputs from numpy seeds:

* ``ssd_scan`` under autograd — ``SSDIntraChunk`` (forward
  ``ssd_intra_chunk``, backward ``ssd_chunk_bwd``; on the CPU their plain
  versions) with the torch inter-chunk part differentiated by autograd —
  for x, dt, A, B and C: several chunks, one chunk (s = L), fewer steps
  than the chunk, groups over heads (g > 1), and bf16 x, B, C;
* ``mamba2_mixer``'s parameter gradients against ``jax.grad`` of the JAX
  mixer on the smoke mamba2-2.7b config;
* the wrappers' refusals.

fp32 tolerances cover summation order, relative to each gradient's largest
value; bf16 gradients are rounded from fp32 values on both sides, so they
are held to 2 bf16 ulps of each element besides. The B and C gradients in
bf16 round at other places: the reference repeats B and C to the heads in
bf16, so its gradient rounds each head's part (and C's intra- and
inter-chunk parts) to bf16 and sums them in bf16, where the port sums the
heads in fp32 and rounds once per part. They are held to 2^-6 of their
largest value, 2 to 4 bf16 ulps of it (measured: under half of that).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import build_model
from repro.models import ssm as jssm
from repro_torch.configs import smoke_config
from repro_torch.kernels import ssd_chunk_bwd, ssd_scan
from repro_torch.kernels.ssd_scan import (SSDIntraChunk, ssd_intra_chunk,
                                          ssd_intra_chunk_backward_ref,
                                          ssd_intra_chunk_ref)
from repro_torch.models.ssm import mamba2_mixer
from repro_torch.weights import params_from_jax

torch.set_num_threads(2)

ARCH = "mamba2-2.7b"
GRAD_TOL = 2e-5          # fp32: of each gradient's largest |value|
BF16_REL = 2.0 ** -6     # bf16 gradients: 2 ulps of each element besides

# (b, s, h, p, g, n, chunk): several chunks, one chunk (s = L), s below the
# chunk, 3 groups over 6 heads, 2 groups over 4 with a ragged state, the
# full model's head_dim 64 and state 128
SCAN_CASES = [(2, 32, 4, 8, 1, 8, 8), (1, 16, 2, 8, 1, 8, 16),
              (2, 5, 4, 8, 2, 8, 8), (2, 24, 6, 8, 3, 8, 8),
              (1, 48, 4, 16, 2, 12, 12), (1, 32, 2, 64, 1, 128, 16)]


def _inputs(case, seed=1):
    """x, dt, A, B, C (numpy fp32) as the JAX package's SSD test draws them,
    and a cotangent of y."""
    b, s, h, p, g, n, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = (-np.exp(0.3 * rng.standard_normal(h))).astype(np.float32)
    B = (0.5 * rng.standard_normal((b, s, g, n))).astype(np.float32)
    C = (0.5 * rng.standard_normal((b, s, g, n))).astype(np.float32)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    return x, dt, A, B, C, dy


def _check(got, want, name, bf16=False, of_max=GRAD_TOL):
    got = got.detach().float().numpy().astype(np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape, name
    limit = of_max * np.abs(want).max() + (BF16_REL * np.abs(want) if bf16 else 0)
    assert (np.abs(got - want) <= limit).all(), (name, np.abs(got - want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SCAN_CASES)
def test_scan_vjp_matches_jax(case, dtype):
    """x, dt, A, B, C gradients of the port's ``ssd_scan`` against
    ``jax.vjp`` of ``ssd_chunked``; x, B, C (and y, dy) in ``dtype``."""
    x, dt, A, B, C, dy = _inputs(case, seed=sum(case))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    cast = (0, 3, 4)                              # x, B, C in the model dtype
    leaves = [torch.from_numpy(a).to(tdt if i in cast else torch.float32)
              .requires_grad_() for i, a in enumerate((x, dt, A, B, C))]
    y = ssd_scan(*leaves, chunk=case[-1])
    got = torch.autograd.grad(y, leaves, torch.from_numpy(dy).to(tdt))
    jin = [jnp.asarray(a, jdt if i in cast else jnp.float32)
           for i, a in enumerate((x, dt, A, B, C))]
    jy, vjp = jax.vjp(lambda *a: jssm.ssd_chunked(*a, chunk=case[-1]), *jin)
    want = vjp(jnp.asarray(dy, jdt))
    _check(y, jy, "y", dtype == "bfloat16")
    bf16 = dtype == "bfloat16"
    for name, g, w, t in zip("x dt A B C".split(), got, want, leaves):
        assert g.dtype == t.dtype, name
        _check(g, w, name, bf16, BF16_REL if bf16 and name in "BC" else GRAD_TOL)


def test_function_forward_is_the_wrapper():
    """ssd_scan gives the same bits with and without a gradient (the
    serving path's bits do not move), and SSDIntraChunk's outputs are the
    raw wrapper's."""
    x, dt, A, B, C, _ = [torch.from_numpy(a) for a in _inputs(SCAN_CASES[3])]
    want = ssd_scan(x, dt, A, B, C, chunk=8)
    got = ssd_scan(x.requires_grad_(), dt, A, B, C, chunk=8)
    assert got.requires_grad and torch.equal(got.detach(), want)
    with torch.no_grad():
        raw = ssd_intra_chunk(x, dt, A, B, C, 8)
    fn = SSDIntraChunk.apply(x, dt, A, B, C, 8)
    assert all(torch.equal(a.detach(), b) for a, b in zip(fn, raw))


def test_plain_backward_is_autograd_of_the_plain_forward():
    """ssd_chunk_bwd's CPU path against autograd through the plain forward
    in float64: the recompute in fp32 is its vjp up to fp32 rounding."""
    case = (2, 24, 6, 8, 3, 8, 8)
    x, dt, A, B, C, _ = [torch.from_numpy(a) for a in _inputs(case, seed=9)]
    rng = np.random.default_rng(10)
    dy = torch.from_numpy(rng.standard_normal((2, 24, 6, 8)).astype(np.float32))
    ds = torch.from_numpy(rng.standard_normal((2, 3, 6, 8, 8)).astype(np.float32))
    got = ssd_chunk_bwd(x, dt, A, B, C, 8, dy, ds)
    f64 = [t.double().requires_grad_() for t in (x, dt, A, B, C)]
    want = torch.autograd.grad(ssd_intra_chunk_ref(*f64, 8), f64,
                               (dy.double(), ds.double()))
    assert torch.equal(torch.stack([g.abs().max() for g in got]),
                       torch.stack([g.abs().max() for g in ssd_intra_chunk_backward_ref(
                           x, dt, A, B, C, 8, dy, ds)]))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert (g.double() - w).abs().max() <= 1e-5 * w.abs().max()


def test_raw_wrapper_refuses_a_gradient():
    x, dt, A, B, C, _ = [torch.from_numpy(a) for a in _inputs(SCAN_CASES[0])]
    with pytest.raises(RuntimeError, match="SSDIntraChunk"):
        ssd_intra_chunk(x.requires_grad_(), dt, A, B, C, 8)


@pytest.mark.parametrize("bad", [
    lambda dy, ds: (dy[:, :4], ds),                   # dy shape
    lambda dy, ds: (dy, ds[:, :1]),                   # dstates shape
    lambda dy, ds: (dy.double(), ds),                 # dtype
    lambda dy, ds: (dy.transpose(2, 3).contiguous().transpose(2, 3), ds),
    lambda dy, ds: (dy, ds.to("meta")),               # two devices
])
def test_bwd_wrapper_rejects(bad):
    x, dt, A, B, C = (torch.zeros((1, 16, 4, 8)), torch.zeros((1, 16, 4)),
                      torch.zeros(4), torch.zeros((1, 16, 2, 8)),
                      torch.zeros((1, 16, 2, 8)))
    dy, ds = torch.zeros((1, 16, 4, 8)), torch.zeros((1, 2, 4, 8, 8))
    ssd_chunk_bwd(x, dt, A, B, C, 8, dy, ds)
    with pytest.raises((ValueError, TypeError)):
        ssd_chunk_bwd(x, dt, A, B, C, 8, *bad(dy, ds))


# ------------------------------------------------------------------ the mixer
@pytest.fixture(scope="module")
def env():
    jcfg, cfg = jax_smoke_config(ARCH), smoke_config(ARCH)
    params = build_model(jcfg).init(jax.random.PRNGKey(0))
    model = params_from_jax(jax.device_get(params), cfg, device="cpu")
    return jcfg, cfg, params, model


@pytest.mark.parametrize("S", [24, 5])
def test_mamba2_mixer_grads_match_jax(env, S):
    """Every parameter's gradient (and the input's) of ``mamba2_mixer``
    under a seeded cotangent against jax.grad of the JAX mixer with
    ``ssd_chunked``: three chunks of 8, and fewer steps than the chunk."""
    jcfg, cfg, params, model = env
    sub = params["stack"]["periods"]["b0"]["ssd"]
    jp = jax.tree_util.tree_map(lambda leaf: leaf[1], sub)
    p = model.blocks[1].ssd
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    cot = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)

    def jloss(jp, x):
        return jnp.sum(jssm.mamba2_mixer(jp, x, jcfg, impl="chunked") * cot)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: getattr(p, k).detach().clone().requires_grad_() for k in jp}
    xt = torch.from_numpy(x).requires_grad_()
    out = mamba2_mixer(types.SimpleNamespace(**leaves), xt, cfg)
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                [*leaves.values(), xt])
    for (name, _), g in zip(leaves.items(), grads):
        _check(g, jgp[name], name)
    _check(grads[-1], jgx, "x")
