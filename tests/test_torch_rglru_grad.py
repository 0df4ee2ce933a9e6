"""The RG-LRU scan's gradient in the port against ``jax.vjp`` of the JAX
package's scans, inputs from numpy seeds:

* ``RGLRUScan`` (forward ``rglru_scan``, backward ``rglru_scan_bwd``; on the
  CPU their plain versions) against the vjp of ``rglru_scan_assoc`` (what
  the reference's training step differentiates) and of ``rglru_scan_ref``,
  on the model's decay distribution, on long memory, and with ``log_a`` at
  and near 0, where the clamp of ``1 - a²`` at 1e-12 holds;
* ``rglru_mixer``'s parameter gradients against ``jax.grad`` of the JAX
  mixer on the smoke recurrentgemma-2b config (its associative and its
  sequential scan);
* the one-pass backward kernel's order of work, emulated, against the
  plain reverse loop;
* the wrappers' refusals: the raw forward refuses a tensor that needs a
  gradient, the backward wrapper what its kernel does not take.

Everything is float32 on both sides; the tolerances cover summation order
and the associative scan's other grouping of products, relative to the
largest gradient of each tensor.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import build_model
from repro.models import rglru as jrglru
from repro_torch.configs import smoke_config
from repro_torch.kernels import rglru_scan, rglru_scan_bwd
from repro_torch.kernels.rglru_scan import (RGLRUScan, rglru_scan_backward_ref,
                                            rglru_scan_ref)
from repro_torch.models.rglru import rglru_mixer
from repro_torch.weights import params_from_jax

torch.set_num_threads(2)

ARCH = "recurrentgemma-2b"
# fp32 on both sides: the reverse recurrence compounds rounding over
# ~1/(1-a) steps and the associative scan groups products otherwise; dlog_a
# subtracts two terms of similar size, so the limit is relative to each
# tensor's largest value
SCAN_TOL = 2e-5
MIXER_TOL = 2e-5   # of each leaf's largest gradient: the mixer's products too


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _log_a(rng, shape, kind):
    """``init``: -8 softplus(lam) sigmoid(normal) over the model's init
    range of lam (softplus 0.9 to 4); ``long``: the Griffin paper's a^8 in
    [0.9, 0.999]; ``clamp``: ``init`` with every 5th step at 0 (a = 1) and
    every 7th at -1e-9 (a rounds to 1 in fp32), where 1 - a² is clamped."""
    W = shape[-1]
    lo, hi = (0.9, 4.0) if kind != "long" else (-np.log(0.999) / 8, -np.log(0.9) / 8)
    lam = np.log(np.expm1(np.linspace(lo, hi, W)))
    z = rng.standard_normal(shape)
    log_a = -8.0 * np.log1p(np.exp(lam)) / (1.0 + np.exp(-z))
    if kind == "clamp":
        log_a[:, ::5] = 0.0
        log_a[:, 3::7] = -1e-9
    return log_a.astype(np.float32)


def _excess(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (tol * max(np.abs(want).max(), 1e-30))


SCAN_CASES = [(1, 16, 8), (2, 33, 16), (2, 130, 8), (1, 300, 4)]


@pytest.mark.parametrize("kind", ["init", "long", "clamp"])
@pytest.mark.parametrize("shape", SCAN_CASES)
def test_scan_vjp_matches_jax(shape, kind):
    """(dx_in, dlog_a) of RGLRUScan against jax.vjp of rglru_scan_assoc and
    of rglru_scan_ref on the same inputs and cotangent; the states too."""
    rng = np.random.default_rng(sum(shape) + len(kind))
    x = rng.standard_normal(shape).astype(np.float32)
    log_a = _log_a(rng, shape, kind)
    dh = rng.standard_normal(shape).astype(np.float32)
    xt, lt = _t(x).requires_grad_(), _t(log_a).requires_grad_()
    h = RGLRUScan.apply(xt, lt)
    got = torch.autograd.grad(h, (xt, lt), _t(dh))
    for scan in (jrglru.rglru_scan_assoc, jrglru.rglru_scan_ref):
        jh, vjp = jax.vjp(scan, jnp.asarray(x), jnp.asarray(log_a))
        want = vjp(jnp.asarray(dh))
        assert _excess(h.detach().numpy(), jh, 1e-5) <= 1
        for g, w in zip(got, want):
            assert np.isfinite(g.numpy()).all()
            assert _excess(g.numpy(), w, SCAN_TOL) <= 1, scan.__name__


def _fma(a, b, c):
    """fmaf in float32 (the product exact in float64, one rounding)."""
    return (a.double() * b.double() + c.double()).float()


def _one_pass_backward(x_in, log_a, h, dh, drop_carry=False):
    """``csrc/rglru_scan_bwd.cu``'s order of work, in torch: chunks of
    ``CHUNK`` steps, each in four stretches of 32 (one warp each); each
    stretch scanned back from a zero carry (its decay product and
    carry-out); from the last chunk to the first, the carry-in handed on
    between blocks folded through the stretches, fmaf(prod, c, e); each
    stretch re-scanned from its carry-in. ``drop_carry`` hands every block
    a zero carry-in (a lost hand-off)."""
    from repro_torch.kernels.rglru_scan.ops import CHUNK
    a = torch.exp(log_a)
    om = 1.0 - a * a
    s = torch.sqrt(torch.clamp(om, min=1e-12))
    ds = torch.where(om > 1e-12, -a / s, 0.0)
    hp = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    S, sub = a.shape[1], CHUNK // 4
    dx, dla = torch.empty_like(a), torch.empty_like(a)
    cin = torch.zeros_like(a[:, 0])
    for t0 in reversed(range(0, S, CHUNK)):
        spans = [(u, min(S, u + sub)) for u in range(t0, min(S, t0 + CHUNK), sub)]
        agg = []
        for lo, hi in spans:
            prod, g = torch.ones_like(cin), torch.zeros_like(cin)
            for t in range(hi - 1, lo - 1, -1):
                d = dh[:, t] + g
                prod = prod * a[:, t]
                g = a[:, t] * d
            agg.append((prod, g))
        c = torch.zeros_like(cin) if drop_carry else cin
        starts = []
        for prod, e in reversed(agg):
            starts.append(c)
            c = _fma(prod, c, e)
        cin = c
        for (lo, hi), g in zip(spans, reversed(starts)):
            for t in range(hi - 1, lo - 1, -1):
                d = dh[:, t] + g
                dx[:, t] = d * s[:, t]
                dla[:, t] = (d * hp[:, t] + (d * x_in[:, t]) * ds[:, t]) * a[:, t]
                g = a[:, t] * d
    return dx, dla


@pytest.mark.parametrize("kind", ["init", "long", "clamp"])
@pytest.mark.parametrize("shape", [(2, 300, 16), (1, 1000, 32)])
def test_one_pass_hand_off_holds_the_backward_tolerance(shape, kind):
    """The one-pass backward kernel's association (stretches of 32 steps,
    chunks of 128 handed on from the last to the first), emulated in fp32,
    against the plain reverse loop: within the card's limit (1e-4 of the
    largest |want| plus 1e-4 of each). A lost hand-off (every block's
    carry-in zero) is not."""
    rng = np.random.default_rng(sum(shape) + 3 * len(kind))
    x = _t(rng.standard_normal(shape))
    log_a = _t(_log_a(rng, shape, kind))
    dh = _t(rng.standard_normal(shape))
    h = rglru_scan_ref(x, log_a)
    want = rglru_scan_backward_ref(x, log_a, h, dh)
    limit = lambda w: 1e-4 * w.abs().max() + 1e-4 * w.abs()  # noqa: E731
    excess = lambda got: max(((g - w).abs() / limit(w)).max().item()  # noqa: E731
                             for g, w in zip(got, want))
    assert excess(_one_pass_backward(x, log_a, h, dh)) <= 1
    assert excess(_one_pass_backward(x, log_a, h, dh, drop_carry=True)) > 1


def test_clamped_steps_get_no_gradient_through_the_gate():
    """Where a = 1 (log_a 0) the clamp holds: dx_in is delta · 1e-6 and
    dlog_a is delta · h_{t-1} alone, as jax.grad of jnp.maximum against the
    constant gives."""
    rng = np.random.default_rng(3)
    shape = (2, 20, 8)
    x, dh = _t(rng.standard_normal(shape)), _t(rng.standard_normal(shape))
    log_a = _t(_log_a(rng, shape, "init"))
    log_a[:, 10] = 0.0
    h = rglru_scan_ref(x, log_a)
    dx, dla = rglru_scan_backward_ref(x, log_a, h, dh)
    delta = dx[:, 10] / 1e-6
    torch.testing.assert_close(dla[:, 10], delta * h[:, 9], rtol=1e-6, atol=0)
    jx, jla = jax.vjp(jrglru.rglru_scan_assoc, jnp.asarray(x.numpy()),
                      jnp.asarray(log_a.numpy()))[1](jnp.asarray(dh.numpy()))
    assert _excess(dla[:, 10].numpy(), np.asarray(jla)[:, 10], SCAN_TOL) <= 1


def test_function_forward_is_the_wrapper():
    """RGLRUScan's forward is the wrapper's, bit for bit (the serving path's
    bits do not move), with and without a gradient."""
    rng = np.random.default_rng(4)
    x = _t(rng.standard_normal((2, 40, 16)))
    log_a = _t(_log_a(rng, (2, 40, 16), "init"))
    want = rglru_scan(x, log_a)
    with torch.no_grad():
        assert torch.equal(RGLRUScan.apply(x, log_a), want)
    assert torch.equal(RGLRUScan.apply(x.requires_grad_(), log_a).detach(), want)


def test_raw_wrapper_refuses_a_gradient():
    x = torch.zeros((1, 4, 8), requires_grad=True)
    with pytest.raises(RuntimeError, match="RGLRUScan"):
        rglru_scan(x, torch.zeros((1, 4, 8)))
    with torch.no_grad():
        rglru_scan(x, torch.zeros((1, 4, 8)))


@pytest.mark.parametrize("bad", [
    lambda x, a, h, g: (x, a, h[:, :3], g),                      # shapes differ
    lambda x, a, h, g: (x, a, h, g.double()),                    # dtype
    lambda x, a, h, g: (x, a, h.transpose(1, 2).contiguous().transpose(1, 2), g),
    lambda x, a, h, g: (x[:, :0], a[:, :0], h[:, :0], g[:, :0]),  # empty
    lambda x, a, h, g: (x, a, h, g.to("meta")),                  # two devices
])
def test_bwd_wrapper_rejects(bad):
    t = [torch.zeros((2, 5, 8)) for _ in range(4)]
    with pytest.raises((ValueError, TypeError)):
        rglru_scan_bwd(*bad(*t))


def test_bwd_never_takes_the_plain_path_off_the_cpu():
    meta = [torch.zeros((1, 2, 4), device="meta") for _ in range(4)]
    with pytest.raises(ValueError, match="unsupported device"):
        rglru_scan_bwd(*meta)


# ------------------------------------------------------------------ the mixer
@pytest.fixture(scope="module")
def env():
    jcfg, cfg = jax_smoke_config(ARCH), smoke_config(ARCH)
    params = build_model(jcfg).init(jax.random.PRNGKey(0))
    model = params_from_jax(jax.device_get(params), cfg, device="cpu")
    return jcfg, cfg, params, model


@pytest.mark.parametrize("impl", ["assoc", "ref"])
@pytest.mark.parametrize("layer", [0, 4])
def test_rglru_mixer_grads_match_jax(env, layer, impl):
    """Every parameter's gradient (and the input's) of ``rglru_mixer``
    under a seeded cotangent, against jax.grad of the JAX mixer with its
    associative scan (the training path) and its sequential one."""
    jcfg, cfg, params, model = env
    sub = params["stack"]["periods"][f"b{layer % jcfg.period}"]["rglru"]
    jp = jax.tree_util.tree_map(lambda leaf: leaf[layer // jcfg.period], sub)
    p = model.blocks[layer].rglru
    rng = np.random.default_rng(layer + 7)
    x = rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    cot = rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)

    def jloss(jp, x):
        return jnp.sum(jrglru.rglru_mixer(jp, x, jcfg, impl=impl) * cot)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: getattr(p, k).detach().clone().requires_grad_() for k in jp}
    xt = _t(x).requires_grad_()
    out = rglru_mixer(types.SimpleNamespace(**leaves), xt)
    grads = torch.autograd.grad((out * _t(cot)).sum(), [*leaves.values(), xt])
    for (name, _), g in zip(leaves.items(), grads):
        assert _excess(g.numpy(), jgp[name], MIXER_TOL) <= 1, name
    assert _excess(grads[-1].numpy(), jgx, MIXER_TOL) <= 1
