"""The port's AdamW (``repro_torch.optim``) against the JAX package's, on the
same numpy-seeded trees: the schedule bit for bit, the norm, the clip and the
update within fp32 rounding (XLA and torch's CPU kernels may round ``pow``,
``sqrt`` and a division otherwise, and sum the norm in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jopt
from repro_torch.optim import (AdamWConfig, adamw_update, clip_by_global_norm,
                               global_norm, init_opt_state, reset_moments,
                               schedule)

# fp32 results of a few ops each, from the same inputs: within a few ulps
RTOL, ATOL = 2e-6, 1e-7


def _tree(rng, shapes, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in shapes.items()}


SHAPES = {"embed": (16, 8), "blocks.0.attn.wq": (8, 2, 4),
          "blocks.0.norm1": (8,), "final_norm": (8,)}


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("cfg", [AdamWConfig(), AdamWConfig(
    lr=1e-3, warmup_steps=5, total_steps=60)])
def test_schedule_matches_jax(cfg):
    """The same fp32 ops in the same order; XLA's ``cos`` and torch's differ
    by one ulp (at most 2^-24 near ±1) on about 2% of the arguments, which
    ``lr (min + (1 - min) (1 + cos) / 2)`` scales by at most 0.45 lr: the two
    are held to ``lr 2^-23`` plus one ulp, and are equal through the warmup,
    where no cos is taken."""
    jcfg = jopt.AdamWConfig(**cfg.__dict__)
    steps = np.arange(0, 20001, 7, dtype=np.int32)
    got = np.array([schedule(cfg, torch.tensor(s)).item() for s in steps],
                   np.float32)
    want = np.array([float(jopt.schedule(jcfg, jnp.int32(s))) for s in steps],
                    np.float32)
    np.testing.assert_allclose(got, want, rtol=2.0 ** -23, atol=cfg.lr * 2.0 ** -23)
    warm = steps <= cfg.warmup_steps
    np.testing.assert_array_equal(got[warm], want[warm])


@pytest.mark.parametrize("scale", [1e-3, 1.0, 30.0])
def test_norm_and_clip_match_jax(scale):
    rng = np.random.default_rng(0)
    g = _tree(rng, SHAPES, scale)
    np.testing.assert_allclose(global_norm(_t(g)).item(),
                               float(jopt.global_norm(_j(g))), rtol=RTOL)
    got, n = clip_by_global_norm(_t(g), 1.0)
    want, jn = jopt.clip_by_global_norm(_j(g), 1.0)
    np.testing.assert_allclose(n.item(), float(jn), rtol=RTOL)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("step,lr_scale,gscale", [
    (0, 1.0, 0.1), (3, 1.0, 10.0), (150, 0.5, 0.01), (9000, 0.25, 1.0)])
def test_adamw_update_matches_jax(step, lr_scale, gscale):
    rng = np.random.default_rng(step)
    cfg = AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=10000)
    jcfg = jopt.AdamWConfig(**cfg.__dict__)
    p, g = _tree(rng, SHAPES), _tree(rng, SHAPES, gscale)
    m = _tree(rng, SHAPES, 0.01)
    v = {k: np.abs(x) for k, x in _tree(rng, SHAPES, 0.001).items()}
    tp, tg = _t(p), _t(g)
    got_p, got_o, stats = adamw_update(
        cfg, tp, tg, {"m": _t(m), "v": _t(v)}, torch.tensor(step, dtype=torch.int32),
        lr_scale=torch.tensor(lr_scale))
    want_p, want_o, jstats = jopt.adamw_update(
        jcfg, _j(p), _j(g), {"m": _j(m), "v": _j(v)}, jnp.int32(step),
        lr_scale=jnp.float32(lr_scale))
    for k in p:
        np.testing.assert_allclose(got_p[k].numpy(), np.asarray(want_p[k]),
                                   rtol=RTOL, atol=ATOL)
        for part in ("m", "v"):
            np.testing.assert_allclose(got_o[part][k].numpy(),
                                       np.asarray(want_o[part][k]),
                                       rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(stats["grad_norm"].item(),
                               float(jstats["grad_norm"]), rtol=RTOL)
    np.testing.assert_allclose(stats["lr"].item(), float(jstats["lr"]), rtol=RTOL)
    # the inputs are left as they were (the executor may discard the step)
    assert all(torch.equal(tp[k], torch.from_numpy(p[k])) for k in p)
    assert all(torch.equal(tg[k], torch.from_numpy(g[k])) for k in g)


def test_adamw_update_keeps_bf16_params_and_fp32_moments():
    rng = np.random.default_rng(5)
    p = {k: v.to(torch.bfloat16) for k, v in _t(_tree(rng, SHAPES)).items()}
    g = {k: v.to(torch.bfloat16) for k, v in _t(_tree(rng, SHAPES)).items()}
    opt = init_opt_state(p)
    assert all(t.dtype == torch.float32 and not t.any() for t in opt["m"].values())
    new_p, new_o, _ = adamw_update(AdamWConfig(warmup_steps=1), p, g, opt,
                                   torch.tensor(3, dtype=torch.int32))
    assert all(new_p[k].dtype == torch.bfloat16 for k in p)
    assert all(new_o["v"][k].dtype == torch.float32 for k in p)
    assert list(new_p) == list(p)                  # the leaf order is kept
    reset = reset_moments(new_o)
    assert all(not t.any() for part in reset.values() for t in part.values())
