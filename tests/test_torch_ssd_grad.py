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
* the wrappers' refusals, and the backward's route by dtype;
* the tensor-core backward's bf16 hi + lo products, emulated in fp32.

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


def test_scan_vjp_past_a_block_matches_jax():
    """40 chunks (the blocked chunk-state recurrence past 32): x, dt, A, B,
    C gradients of ``ssd_scan`` under autograd against ``jax.vjp`` of
    ``ssd_chunked``; fp32, 2e-5 of each gradient's largest value."""
    case = (2, 80, 4, 4, 2, 4, 2)
    x, dt, A, B, C, dy = _inputs(case, seed=40)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, dt, A, B, C)]
    y = ssd_scan(*leaves, chunk=2)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    jy, vjp = jax.vjp(lambda *a: jssm.ssd_chunked(*a, chunk=2),
                      *[jnp.asarray(a) for a in (x, dt, A, B, C)])
    _check(y, jy, "y")
    for name, g, w in zip("x dt A B C".split(), got, vjp(jnp.asarray(dy))):
        _check(g, w, name)


# ------------------------------------- the tensor-core backward's arithmetic
def _hi_lo(t):
    hi = t.bfloat16().float()
    return hi, (t - hi).bfloat16().float()


def _product(a, b, how):
    """a @ b in fp32 with the operands entered as ``how`` says: ``exact``
    (fp32 products, the plain version's), ``a`` or ``b`` (that fp32
    operand as bf16 hi + lo, the other exact in bf16), ``ab`` (both fp32:
    hi hi + hi lo + lo hi; ``hh+lh``, ``hh+hl``: two of the three), or that
    operand rounded to bf16 alone (``a16``, ``b16``, ``ab16``)."""
    if how == "exact":
        return a @ b
    if how.endswith("16"):
        a = a.bfloat16().float() if "a" in how else a
        b = b.bfloat16().float() if "b" in how else b
        return a @ b
    if how == "a":
        return sum(part @ b for part in _hi_lo(a))
    if how == "b":
        return sum(a @ part for part in _hi_lo(b))
    (ah, al), (bh, bl) = _hi_lo(a), _hi_lo(b)
    if how == "hh+lh":
        return ah @ bh + al @ bh
    if how == "hh+hl":
        return ah @ bh + ah @ bl
    return ah @ bh + ah @ bl + al @ bh


# the tensor-core kernel's products, as it enters each: D = dy x^T, Q B,
# B dS^T, M^T dy, x dS, Q^T C
TC_SPLIT = dict(D="a", QB="a", BdS="b", Mdy="ab", xdS="b", QC="a")
BF16_ALONE = dict(D="a16", QB="a16", BdS="b16", Mdy="ab16", xdS="b16", QC="a16")


def _tc_backward(x, dt, A, B, C, dy, dS, how):
    """``csrc/ssd_chunk_bwd_tc.cu``'s algebra over one chunk of one group
    (x (L, h, p) bf16, dt (L, h), A (h,), B, C (L, n) bf16, dy (L, h, p),
    dS (h, p, n)), each product entered as ``how`` says: dt applied to a
    row or column after a product, D = dy x^T, Q = D E dt_j, dG = Q G,
    M = G E; dx, ddt, dA (per head), dB and dC summed over the heads."""
    Bf, Cf = B.float(), C.float()
    G = Cf @ Bf.T
    cum = torch.cumsum(dt * A, 0)
    L = x.shape[0]
    tril = torch.ones(L, L, dtype=torch.bool).tril()
    grads = [[] for _ in range(5)]
    for k in range(x.shape[1]):
        xk, c, d = x[:, k].float(), cum[:, k], dt[:, k]
        E = torch.where(tril, torch.exp((c[:, None] - c[None, :]).masked_fill(~tril, 0)), 0.0)
        Q = _product(dy[:, k], xk.T, how["D"]) * E * d[None, :]
        dG = Q * G
        U = _product(Bf, dS[k].T, how["BdS"])
        w = torch.exp(c[-1] - c)
        dxd = w[:, None] * U + _product((G * E).T, dy[:, k], how["Mdy"])
        ww = w * d * (xk * U).sum(1)
        dcum = dG.sum(1) - dG.sum(0) - ww
        dcum[-1] += ww.sum()
        dabar = torch.flip(torch.cumsum(torch.flip(dcum, [0]), 0), [0])
        for out, v in zip(grads, (
                d[:, None] * dxd, dabar * A[k] + (xk * dxd).sum(1), (dabar * d).sum(),
                (w * d)[:, None] * _product(xk, dS[k], how["xdS"])
                + _product(Q.T, Cf, how["QC"]),
                _product(Q, Bf, how["QB"]))):
            out.append(v)
    dx, ddt, dB, dC = (torch.stack(grads[i], 1) for i in (0, 1, 3, 4))
    return dx, ddt, torch.stack(grads[2]), dB.sum(1), dC.sum(1)


@pytest.fixture(scope="module")
def tc_case():
    """One chunk at the card test's statistics (L 128, P 64, N 128, 16
    heads; x, B, C in bf16) and the plain backward's gradients of it."""
    rng = np.random.default_rng(3)
    L, h, p, n = 128, 16, 64, 128
    t = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32))
    x = t(1, L, h, p).bfloat16()
    dt = torch.nn.functional.softplus(t(1, L, h))
    A = -torch.exp(0.3 * t(h))
    B, C = (0.5 * t(1, L, 1, n)).bfloat16(), (0.5 * t(1, L, 1, n)).bfloat16()
    dy, dS = t(1, L, h, p), t(1, 1, h, p, n)
    want = ssd_intra_chunk_backward_ref(x, dt, A, B, C, L, dy, dS)
    want = (want[0][0], want[1][0], want[2], want[3][0, :, 0], want[4][0, :, 0])
    return (x[0], dt[0], A, B[0, :, 0], C[0, :, 0], dy[0], dS[0, 0]), want


def _excesses(got, want):
    """Each gradient's largest |got - want| over the card's SSD limit (1e-4
    of the largest |want| plus 1e-4 of each)."""
    return [((g - w).abs() / (1e-4 * w.abs().max() + 1e-4 * w.abs())).max().item()
            for g, w in zip(got, want)]


def test_tc_backward_split_holds_the_ssd_tolerance(tc_case):
    """Why ``csrc/ssd_chunk_bwd_tc.cu`` enters every fp32 operand as a bf16
    high and low part, and M^T dy as hi hi + hi lo + lo hi: its algebra
    emulated in fp32 on the CPU, against the plain version. With exact
    products it is the plain version's function (summation order only);
    with every fp32 operand rounded to bf16 alone, dx, ddt, dB and dC miss
    the card's limit (about 12-22x; dA, a sum over the chunk, 0.6x); with
    the kernel's split each gradient stays under 0.1x."""
    args, want = tc_case
    assert max(_excesses(_tc_backward(*args, dict.fromkeys(TC_SPLIT, "exact")), want)) < 0.05
    alone = _excesses(_tc_backward(*args, BF16_ALONE), want)
    assert min(alone[i] for i in (0, 1, 3, 4)) > 5, alone
    split = _excesses(_tc_backward(*args, TC_SPLIT), want)
    assert max(split) < 0.1, split


@pytest.mark.parametrize("product", sorted(TC_SPLIT))
def test_tc_backward_needs_each_split(tc_case, product):
    """Each product's split is needed: that product alone in bf16 (the rest
    as the kernel enters them) takes some gradient past the limit, and so
    does M^T dy with only two of its three products."""
    args, want = tc_case
    how = dict(TC_SPLIT, **{product: BF16_ALONE[product]})
    assert max(_excesses(_tc_backward(*args, how), want)) > 5


@pytest.mark.parametrize("two", ["hh+lh", "hh+hl"])
def test_tc_backward_needs_three_products_for_two_fp32_operands(tc_case, two):
    """M^T dy with two of its three hi/lo products misses the limit."""
    args, want = tc_case
    assert max(_excesses(_tc_backward(*args, dict(TC_SPLIT, Mdy=two)), want)) > 5


def test_backward_route_follows_the_dtype(monkeypatch):
    """On the card ``ssd_chunk_bwd`` launches the kernel ``plan_bwd`` picks
    from the dtype alone: bf16 x, B, C to ``ssd_chunk_bwd_tc`` (its C entry
    ``repro_ssd_chunk_bwd_tc``), fp32 to ``ssd_chunk_bwd_f32``
    (``repro_ssd_chunk_bwd_f32``), each counted in ``kernel_launches``. The
    launchers are recorded here in place of the library (no card)."""
    from repro_torch.kernels.ssd_scan import ops
    calls = []

    class Library:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args[12:])) or 0

    monkeypatch.setattr(ops, "library", Library)
    monkeypatch.setattr(ops, "check_device", lambda *a: "cuda")
    monkeypatch.setattr(ops, "stream_of", lambda t: 0)
    assert ops.plan_bwd(torch.bfloat16) == "ssd_chunk_bwd_tc"
    assert ops.plan_bwd(torch.float32) == "ssd_chunk_bwd_f32"
    x, dt, A, B, C, _ = [torch.from_numpy(a) for a in _inputs((1, 32, 4, 8, 2, 8, 8))]
    dy, ds = torch.zeros((1, 32, 4, 8)), torch.zeros((1, 4, 4, 8, 8))
    for dtype, entry, kernel in ((torch.bfloat16, "repro_ssd_chunk_bwd_tc", "ssd_chunk_bwd_tc"),
                                 (torch.float32, "repro_ssd_chunk_bwd_f32", "ssd_chunk_bwd_f32")):
        before = dict(ssd_chunk_bwd.kernel_launches), ssd_chunk_bwd.launches
        calls.clear()
        ssd_chunk_bwd(x.to(dtype), dt, A, B.to(dtype), C.to(dtype), 8, dy, ds)
        assert calls == [(entry, (1, 32, 4, 8, 2, 8, 8, 0))]
        assert ssd_chunk_bwd.launches == before[1] + 1
        moved = {k for k, n in ssd_chunk_bwd.kernel_launches.items() if n != before[0][k]}
        assert moved == {kernel}


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
