"""The port's training path against the JAX package's, on the smoke qwen3
config (2 layers, d_model 64, fp32; the reference's own fixture: B 2, S 16):
batches, fault injections, probe words, the attention gradient, the train
step, the executor's recovery decisions, LFLR replays and the command line.
The gradients, the train step's injections, the executor's decisions and
the LFLR replay also run on the recurrent smoke stacks (``TRAIN_ARCHS``:
recurrentgemma-2b's RG-LRU and sliding layers, mamba2-2.7b's SSD layers),
whose gradients go through the scans' backward (``RGLRUScan``,
``SSDIntraChunk``; their plain versions here), on the encoder
(hubert-xlarge: frame embeddings, no tokens, bidirectional) and on the VLM
(llama-3.2-vision-11b: 8 image tokens that every fifth layer
cross-attends), their gates and layer norms' biases drawn non-zero.

The JAX side is built once per module (its jitted step compiles once). Words,
batches, actions and event lists must be equal; numbers are held to
tolerances stated where they are used: both sides compute in fp32 and
differ in summation order only.
"""
import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro.configs import smoke_config as jax_smoke_config
from repro.core import ExecutorConfig as JaxExecutorConfig
from repro.core import FaultSchedule as JaxSchedule
from repro.core import FaultSpec as JaxSpec
from repro.core import ResilientExecutor as JaxExecutor
from repro.core import detect as jdetect
from repro.core import faults as jfaults
from repro.core.recovery import RecoveryPolicy as JaxPolicy
from repro.data import pipeline as jpipe
from repro.core.detect import ProbeConfig as JaxProbeConfig
from repro.launch.steps import make_reset_opt_fn as jax_reset_fn
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.launch.train import build_train_setup as jax_build
from repro.models.attention import sdpa_chunked
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import smoke_config
from repro_torch.core import (ExecutorConfig, FaultSchedule, FaultSpec,
                              ResilientExecutor)
from repro_torch.core import detect, faults
from repro_torch.core.detect import ProbeConfig
from repro_torch.core.device_channel import readback
from repro_torch.core.errors import ErrorCode
from repro_torch.core.recovery import RecoveryPolicy
from repro_torch.data import pipeline
from repro_torch.kernels.flash_attention import (FlashAttention, flash_attention,
                                                 flash_backward, sdpa_ref)
from repro_torch.launch import train as train_cli
from repro_torch.launch.steps import make_loss_and_grads, make_reset_opt_fn
from repro_torch.models import Model
from repro_torch.models.layers import EmbedLookup
from repro_torch.tree import tree_leaves
from repro_torch.weights import (_flat_from_jax, load_train_params, param_order,
                                 train_params, train_state_from_jax,
                                 train_state_to_numpy)

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH, B, S, TOTAL = "qwen3-1.7b", 2, 16, 60
# fp32 on both sides, other summation orders: relative to each leaf's
# largest value (measured ~1e-6)
GRAD_TOL = 1e-5
LOSS_RTOL = 1e-6
# a cross layer's 0-d gate: its gradient is one sum over B x S x d_model
# products of the branch's output and its adjoint, which cancel ~260-fold
# at the smoke VLM's drawn gates; the reference's fp32 order lands 1.3e-5
# of the value from the float64 sum of the same products (the port's 4e-7)
GATE_GRAD_TOL = 1e-4
CPU = torch.device("cpu")


# the stacks the gradient, injection, executor and LFLR tests run on: every
# block kind (attention, RG-LRU with sliding attention, SSD, cross) and
# every batch family (tokens; frame embeddings; tokens and image embeddings)
TRAIN_ARCHS = [ARCH, "recurrentgemma-2b", "mamba2-2.7b", "hubert-xlarge",
               "llama-3.2-vision-11b"]
# the divergence threshold of both sides' probes: the reference's 50, but
# for recurrentgemma, whose smoke loss starts above it (~62: the tied
# embedding scaled by sqrt(d_model)), so that every clean step would read
# DIVERGENCE; 1e3 stays far below a spiked loss (x 1e6)
DIVERGENCE = {"recurrentgemma-2b": 1e3}


def drawn(params, seed=11):
    """``params`` with every cross gate and layer norm bias drawn from a
    normal of scale 0.5: the init's zeros give a cross layer's weights an
    exactly zero gradient (tanh(0) = 0) and would pass a dropped bias
    unseen. No other leaf changes."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if getattr(path[-1], "key", None) not in ("gate_attn", "gate_mlp", "bias"):
            return leaf
        return jnp.asarray(0.5 * rng.standard_normal(leaf.shape), leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, params)


@functools.lru_cache(maxsize=None)
def _jax_env(arch):
    cfg = jax_smoke_config(arch)
    model, step_fn, state, pipe, opt_cfg = jax_build(
        cfg, batch_size=B, seq_len=S, total_steps=TOTAL)
    state = {**state, "params": drawn(state["params"])}
    if arch in DIVERGENCE:
        step_fn = jax.jit(jax_make_train_step(cfg, opt_cfg, JaxProbeConfig(
            loss_divergence_threshold=DIVERGENCE[arch])))
    return cfg, model, step_fn, state, pipe.cfg


@functools.lru_cache(maxsize=None)
def _env(arch):
    cfg = smoke_config(arch)
    _, step_fn, _, pipe, opt_cfg = train_cli.build_train_setup(
        cfg, batch_size=B, seq_len=S, total_steps=TOTAL, device="cpu",
        probe_cfg=ProbeConfig(loss_divergence_threshold=DIVERGENCE.get(arch, 50.0)))
    return cfg, step_fn, pipe.cfg


@pytest.fixture(scope="module")
def jax_env():
    return _jax_env(ARCH)


@pytest.fixture(scope="module")
def env(jax_env):
    return _env(ARCH)


over_archs = pytest.mark.parametrize("arch", TRAIN_ARCHS)


def _port_state(jstate, cfg):
    return train_state_from_jax(jax.device_get(jstate), cfg, device="cpu")


def _jbatch(pcfg, step):
    return jpipe.make_batch(jpipe.PipelineConfig(**pcfg.__dict__), step)


# --------------------------------------------------------------------- data
@pytest.mark.parametrize("seed,shard,num_shards", [(0, 0, 1), (3, 1, 2)])
def test_batches_bit_equal(seed, shard, num_shards):
    kw = dict(vocab_size=512, seq_len=S, batch_size=B, seed=seed, shard=shard,
              num_shards=num_shards)
    it = pipeline.DataIterator(pipeline.PipelineConfig(**kw), device="cpu")
    jit = jpipe.DataIterator(jpipe.PipelineConfig(**kw))
    for _ in range(5):
        got, want = next(it), next(jit)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in got:
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert it.state_dict() == jit.state_dict()
    moved = it.reshard(4, 3)
    jmoved = jit.reshard(4, 3)
    np.testing.assert_array_equal(next(moved)["tokens"].numpy(),
                                  np.asarray(next(jmoved)["tokens"]))
    it.load_state_dict({"step": 1})
    jit.load_state_dict({"step": 1})
    np.testing.assert_array_equal(next(it)["labels"].numpy(),
                                  np.asarray(next(jit)["labels"]))


# ---------------------------------------------------------------- injection
INJECTS = [0, faults.INJ_NAN_LOSS, faults.INJ_NAN_GRAD, faults.INJ_SPIKE_LOSS,
           faults.INJ_BAD_DATA, faults.INJ_STATE_NAN,
           faults.INJ_NAN_LOSS | faults.INJ_SPIKE_LOSS | faults.INJ_BAD_DATA,
           0b11111]


def _word(x):
    return torch.tensor(x, dtype=torch.int32)


@pytest.mark.parametrize("inject", INJECTS)
def test_inject_helpers_match_jax(inject):
    rng = np.random.default_rng(inject)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}
    tokens = rng.integers(0, 50, (2, 6)).astype(np.int32)
    for loss in (3.5, 1e-3):
        got = faults.inject_loss(torch.tensor(loss), _word(inject))
        want = jfaults.inject_loss(jnp.float32(loss), jnp.uint32(inject))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for ours, theirs in ((faults.inject_grads, jfaults.inject_grads),
                         (faults.inject_state, jfaults.inject_state)):
        got = ours({k: torch.from_numpy(v.copy()) for k, v in tree.items()},
                   _word(inject))
        want = theirs({k: jnp.asarray(v) for k, v in tree.items()},
                      jnp.uint32(inject))
        for k in tree:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    t = torch.from_numpy(tokens.copy())
    got = faults.inject_batch(t, _word(inject))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jfaults.inject_batch(jnp.asarray(tokens), jnp.uint32(inject))))
    assert torch.equal(t, torch.from_numpy(tokens))   # a new tensor


# ------------------------------------------------------------------- probes
V = 512
PROBE_CASES = {
    "clean": (2.0, {}, None),
    "nan_leaf": (2.0, {"b": (1, float("nan"))}, None),
    "inf_leaf": (2.0, {"a": (0, float("-inf"))}, None),
    "overflow": (2.0, {"a": (5, 2e4)}, None),
    "divergence": (2e3, {}, None),
    "nonfinite_loss": (float("inf"), {}, None),
    "nan_loss_and_leaf": (float("nan"), {"a": (2, float("nan")), "b": (0, 3e4)}, None),
    "bad_data": (2.0, {}, (0, -1)),
    "id_past_vocab": (2.0, {}, (3, V)),
    "everything": (5e3, {"a": (1, 1e5)}, (2, V + 7)),
}


@pytest.mark.parametrize("case", list(PROBE_CASES))
@pytest.mark.parametrize("threshold", [1e3, 50.0])
def test_probe_words_bit_equal(case, threshold):
    loss, edits, bad = PROBE_CASES[case]
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal(7).astype(np.float32)}
    for leaf, (i, x) in edits.items():
        tree[leaf].reshape(-1)[i] = x
    tokens = rng.integers(0, V, (2, 4)).astype(np.int32)
    if bad:
        tokens.reshape(-1)[bad[0]] = bad[1]
    cfg = detect.ProbeConfig(loss_divergence_threshold=threshold)
    jcfg = jdetect.ProbeConfig(loss_divergence_threshold=threshold)
    grads = {k: torch.from_numpy(v) for k, v in tree.items()}
    got = detect.step_probe(torch.tensor(loss), grads,
                            tokens=torch.from_numpy(tokens), vocab_size=V, cfg=cfg)
    want = jdetect.step_probe(jnp.float32(loss), {k: jnp.asarray(v) for k, v in tree.items()},
                              tokens=jnp.asarray(tokens), vocab_size=V, cfg=jcfg)
    assert got.dtype == torch.int32 and int(got) == int(want)
    pw = detect.param_probe(grads)
    assert int(pw) == int(jdetect.param_probe({k: jnp.asarray(v) for k, v in tree.items()}))


def test_probe_defaults_are_the_references():
    assert detect.ProbeConfig() == detect.ProbeConfig(
        **{f: getattr(jdetect.ProbeConfig(), f)
           for f in ("overflow_threshold", "loss_divergence_threshold", "probe_params")})


# ------------------------------------------------------- attention gradient
# (B, S, T, Hq, Hkv, D, causal, window, q_chunk, kv_chunk): S queries over
# T keys (T != S: a cross layer's image keys, never masked)
FLASH_GRAD_CASES = [
    (2, 16, 16, 4, 2, 16, True, 0, 2048, 2048),     # the smoke model's
    (1, 24, 24, 4, 1, 16, True, 0, 2048, 2048),     # MQA
    (2, 20, 20, 4, 2, 16, True, 6, 2048, 2048),     # sliding window
    (1, 23, 23, 6, 2, 16, True, 0, 8, 5),           # ragged chunks
    (2, 19, 19, 4, 2, 32, True, 7, 6, 4),           # ragged, sliding
    (1, 12, 12, 2, 2, 16, False, 0, 5, 5),          # not causal
    (2, 6, 10, 2, 2, 16, False, 0, 2048, 4),        # cross: a ragged last KV chunk
    (1, 9, 13, 4, 4, 80, False, 0, 4, 8),           # cross at hubert's head dim
    (2, 16, 8, 4, 1, 16, False, 0, 2048, 2048),     # cross, GQA: the smoke VLM's
]
# fp32 on both sides, the same chunked recompute: summation order only
FLASH_GRAD_TOL = 2e-5


@pytest.mark.parametrize("case", FLASH_GRAD_CASES)
def test_flash_gradients_match_jax(case):
    Bq, Sq, T, Hq, Hkv, D, causal, window, qc, kc = case
    rng = np.random.default_rng(Sq)
    q = rng.standard_normal((Bq, Sq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((Bq, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((Bq, T, Hkv, D)).astype(np.float32)
    do = rng.standard_normal((Bq, Sq, Hq, D)).astype(np.float32)
    out, vjp = jax.vjp(lambda q, k, v: sdpa_chunked(
        q, k, v, causal=causal, window=window, q_chunk=qc, kv_chunk=kc),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got_out = FlashAttention.apply(tq, tk, tv, causal, window, qc, kc)
    got = torch.autograd.grad(got_out, (tq, tk, tv), torch.from_numpy(do))
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out),
                               atol=FLASH_GRAD_TOL, rtol=FLASH_GRAD_TOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=FLASH_GRAD_TOL, rtol=FLASH_GRAD_TOL)


class _Plain64(torch.autograd.Function):
    """The plain forward and the plain backward in float64, for gradcheck."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk):
        zero = torch.zeros(q.shape[0], dtype=torch.int32)
        out, lse = sdpa_ref(q, k, v, q_offset=zero, causal=causal,
                            window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.config = (causal, window, chunk)
        return out

    @staticmethod
    def backward(ctx, do):
        causal, window, chunk = ctx.config
        return (*flash_backward(*ctx.saved_tensors, do, causal=causal,
                                window=window, q_chunk=chunk, kv_chunk=chunk),
                None, None, None)


@pytest.mark.parametrize("causal,window,chunk,T", [(True, 0, 2048, 7), (True, 3, 4, 7),
                                                   (False, 0, 3, 7), (False, 0, 3, 5)])
def test_plain_flash_backward_gradcheck(causal, window, chunk, T):
    gen = torch.Generator().manual_seed(0)
    args = [torch.randn(shape, generator=gen, dtype=torch.float64, requires_grad=True)
            for shape in ((1, 7, 4, 8), (1, T, 2, 8), (1, T, 2, 8))]
    assert torch.autograd.gradcheck(
        lambda q, k, v: _Plain64.apply(q, k, v, causal, window, chunk), args)


def test_flash_wrapper_refuses_a_gradient():
    """No fallback: the kernel wrapper never hands back an output silently
    detached from a graph; attention_train goes through FlashAttention."""
    q = torch.randn(1, 4, 2, 16, requires_grad=True)
    kv = torch.randn(1, 4, 2, 16)
    zero = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="FlashAttention"):
        flash_attention(q, kv, kv, zero, causal=True)
    with torch.no_grad():
        flash_attention(q, kv, kv, zero, causal=True)
    out = FlashAttention.apply(q, kv, kv, True, 0, 2048, 2048)
    assert out.grad_fn is not None


def test_embed_lookup_fills_and_sums_without_atomics():
    gen = torch.Generator().manual_seed(0)
    table = torch.randn(10, 3, generator=gen, dtype=torch.float64, requires_grad=True)
    tokens = torch.tensor([[3, -1, 3, 10], [0, 3, -10, -11]], dtype=torch.int32)
    rows = EmbedLookup.apply(table, tokens)
    table32 = table.detach().float()
    want = jnp.take(jnp.asarray(table32.numpy()), jnp.asarray(tokens), axis=0)
    np.testing.assert_array_equal(EmbedLookup.apply(table32, tokens).numpy(),
                                  np.asarray(want))
    grad = torch.randn(rows.shape, generator=gen, dtype=torch.float64)
    (got,) = torch.autograd.grad(rows, table, grad)
    valid = (tokens >= -10) & (tokens < 10)
    idx = torch.remainder(tokens.long(), 10)[valid]
    ref = torch.zeros(10, 3, dtype=torch.float64).index_add_(0, idx, grad[valid])
    assert torch.equal(got, ref)


# --------------------------------------------------------------- train step
def test_param_order_is_the_jax_flatten_order(jax_env):
    for arch in (ARCH, "gemma3-1b"):
        jcfg, cfg = jax_smoke_config(arch), smoke_config(arch)
        from repro.models import build_model
        params = build_model(jcfg).param_shapes()
        want = []
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            keys = tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)
            n = leaf.shape[0] if keys[1:2] == ("periods",) else None
            want += [(keys, c) for c in range(n)] if n else [(keys, None)]
        assert [(path, c) for _, path, c in param_order(cfg)] == want
        names = [name for name, _, _ in param_order(cfg)]
        assert sorted(names) == sorted(n for n, _ in Model(
            cfg, device="meta", seed=None).named_parameters())


def test_train_state_bridge_round_trip(jax_env):
    _, _, _, jstate, _ = jax_env
    cfg = smoke_config(ARCH)
    host = jax.device_get(jstate)
    back = train_state_to_numpy(_port_state(jstate, cfg), cfg)
    want, got = jax.tree_util.tree_leaves(host), jax.tree_util.tree_leaves(back)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(host)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


@over_archs
def test_loss_and_gradients_match_jax(arch):
    jcfg, jmodel, _, jstate, pcfg = _jax_env(arch)
    cfg = _env(arch)[0]
    batch = _jbatch(pcfg, 0)
    jl, jg = jax.value_and_grad(lambda p: jmodel.loss(p, batch)[0])(jstate["params"])
    state = _port_state(jstate, cfg)
    tb = pipeline.make_batch(pcfg, 0, "cpu")
    loss, grads, _ = make_loss_and_grads(cfg)(state["params"], tb)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    want = _flat_from_jax(jax.device_get(jg), cfg, CPU)
    assert list(grads) == list(state["params"])
    for name, g in grads.items():
        scale = want[name].abs().max().item()
        tol = GATE_GRAD_TOL if g.dim() == 0 else GRAD_TOL
        assert (g - want[name]).abs().max().item() <= tol * scale, name
    # the tied embedding gets the unembedding's gradient too (from the live
    # embedding, not the detached fp32 copy): rows of ids the batch never
    # holds have a gradient only through it. An untied one has none there
    # (none at all for the encoder, whose batch holds frame embeddings)
    unseen = torch.ones(cfg.vocab_size, dtype=torch.bool)
    if "tokens" in tb:
        unseen[tb["tokens"].long().reshape(-1)] = False
    if cfg.tie_embeddings:
        assert grads["embed"][unseen].abs().max() > 0
    else:
        assert not grads["embed"][unseen].any()


def _carried(jax_env, n: int):
    """The JAX state after ``n`` clean steps (moments and lr non-zero)."""
    _, _, jstep, jstate, pcfg = jax_env
    for i in range(n):
        jstate, _, _ = jstep(jstate, _jbatch(pcfg, i), jnp.uint32(0))
    return jstate


@over_archs
@pytest.mark.parametrize("inject", INJECTS)
def test_train_step_matches_jax(arch, inject):
    jax_env, env = _jax_env(arch), _env(arch)
    _, _, jstep, _, pcfg = jax_env
    cfg, step_fn, _ = env
    jstate = _carried(jax_env, 6)
    state = _port_state(jstate, cfg)
    before = {k: v.clone() for k, v in state["params"].items()}
    syncs = readback.count
    new, metrics, word = step_fn(state, pipeline.make_batch(pcfg, 6, "cpu"), inject)
    assert readback.count == syncs                 # nothing read back
    jnew, jm, jword = jstep(jstate, _jbatch(pcfg, 6), jnp.uint32(inject))
    assert word.dtype == torch.int32 and int(word) == int(jword)
    if cfg.family == "audio":         # no tokens to corrupt, none probed
        assert not int(word) & ErrorCode.DATA_FAULT
    assert all(torch.equal(before[k], state["params"][k]) for k in before)
    if inject & (faults.INJ_NAN_LOSS | faults.INJ_NAN_GRAD):
        return
    np.testing.assert_allclose(metrics["loss"].item(), float(jm["loss"]), rtol=LOSS_RTOL)
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(metrics[key].item(), float(jm[key]), rtol=1e-5)
    got = train_state_to_numpy(new, cfg)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jax.device_get(jnew))):
        b = np.asarray(b)
        assert np.max(np.abs(a - b)) <= GRAD_TOL * max(np.max(np.abs(b)), 1e-30)


def test_id_past_vocab_gives_the_jax_word(jax_env, env):
    """An id >= vocab reaches no gather: its row is NaN as jnp.take's fill
    gives it, so the loss and gradients are NaN and the word is JAX's."""
    _, _, jstep, jstate, pcfg = jax_env
    cfg, step_fn, _ = env
    tb = pipeline.make_batch(pcfg, 0, "cpu")
    jb = _jbatch(pcfg, 0)
    tb["tokens"][0, 5] = cfg.vocab_size + 3
    jb = {**jb, "tokens": jb["tokens"].at[0, 5].set(cfg.vocab_size + 3)}
    _, metrics, word = step_fn(_port_state(jstate, cfg), tb, 0)
    _, jm, jword = jstep(jstate, jb, jnp.uint32(0))
    assert int(word) == int(jword)
    assert int(word) & ErrorCode.DATA_FAULT and int(word) & ErrorCode.NONFINITE_LOSS
    assert np.isnan(metrics["loss"].item()) and np.isnan(float(jm["loss"]))


def test_training_leaves_the_model_as_it_was():
    cfg = smoke_config(ARCH)
    model = Model(cfg, device="cpu", seed=3)
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    _, step_fn, state, pipe, _ = train_cli.build_train_setup(
        cfg, batch_size=B, seq_len=S, model=model)
    for _ in range(3):
        state, _, word = step_fn(state, next(pipe), 0)
        assert int(word) == 0
    assert all(torch.equal(v, weights[k]) for k, v in model.state_dict().items())
    assert not any(p.requires_grad for p in model.parameters())
    trained = load_train_params(Model(cfg, device="cpu", seed=None), state["params"])
    assert torch.equal(trained.unembed_f32.t(), state["params"]["embed"])
    tokens = next(pipe)["tokens"]
    assert torch.equal(trained(tokens), load_train_params(
        model, train_params(trained))(tokens))


def test_recurrent_stacks_train_every_leaf():
    """Every block kind trains: the recurrent stacks take a clean step
    whose gradient reaches every leaf, their recurrences' parameters
    included (the levers: ``tests/test_torch_train_levers.py``)."""
    for arch, leaf in (("recurrentgemma-2b", "blocks.0.rglru.lam"),
                       ("mamba2-2.7b", "blocks.0.ssd.A_log")):
        cfg = smoke_config(arch)
        _, step_fn, state, pipe, _ = train_cli.build_train_setup(
            cfg, batch_size=B, seq_len=S, device="cpu",
            probe_cfg=ProbeConfig(loss_divergence_threshold=1e3))
        batch = next(pipe)
        _, metrics, word = step_fn(state, batch, 0)
        assert int(word) == 0 and np.isfinite(metrics["loss"].item())
        _, grads, _ = make_loss_and_grads(cfg)(state["params"], batch)
        assert all(torch.isfinite(g).all() for g in grads.values())
        assert grads[leaf].abs().max() > 0


# ----------------------------------------------------------------- executor
def _events(log):
    return [(e.step, e.kind, e.code, e.action) for e in log.events
            if e.kind != "straggler"]


SCENARIOS = {   # name: (steps, {step: kind}, checkpointer)
    "clean": (12, {}, False),
    "nan_grad": (8, {3: "nan_grad"}, False),
    "repeated": (10, {4: "nan_loss", 5: "nan_loss"}, False),
    "spike": (8, {5: "spike_loss"}, False),
    "bad_data": (5, {2: "bad_data"}, False),
    "rollback": (20, {s: "nan_loss" for s in (12, 13, 14, 15, 16)}, True),
}


def _run_both(jax_env, env, steps, plan, tmp_path=None, config=None):
    jcfg, _, jstep, jstate, pcfg = jax_env
    cfg, step_fn, _ = env
    config = config or dict(good_state_interval=5, checkpoint_interval=10)
    jex = JaxExecutor(jstep, policy=JaxPolicy(can_shrink=False),
                      config=JaxExecutorConfig(**config),
                      checkpointer=JaxCheckpointer(tmp_path / "j") if tmp_path else None,
                      reset_opt_fn=jax_reset_fn(jcfg))
    ex = ResilientExecutor(step_fn, policy=RecoveryPolicy(can_shrink=False),
                           config=ExecutorConfig(**config),
                           checkpointer=Checkpointer(tmp_path / "t") if tmp_path else None,
                           reset_opt_fn=make_reset_opt_fn(cfg))
    jfaults_ = JaxSchedule([JaxSpec(step=s, kind=k) for s, k in plan.items()])
    faults_ = FaultSchedule([FaultSpec(step=s, kind=k) for s, k in plan.items()])
    jfinal, jlog = jex.run(jstate, jpipe.DataIterator(jpipe.PipelineConfig(
        **pcfg.__dict__)), steps, faults=jfaults_)
    final, log = ex.run(_port_state(jstate, cfg), pipeline.DataIterator(
        pcfg, device="cpu"), steps, faults=faults_)
    return (jfinal, jlog), (final, log)


@over_archs
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_executor_decides_as_jax(arch, tmp_path, name):
    jax_env, env = _jax_env(arch), _env(arch)
    steps, plan, ckpt = SCENARIOS[name]
    (jfinal, jlog), (final, log) = _run_both(jax_env, env, steps, plan,
                                             tmp_path if ckpt else None)
    assert _events(log) == _events(jlog)
    assert int(final["step"]) == int(jfinal["step"])
    assert float(final["lr_scale"]) == float(jfinal["lr_scale"])
    if ckpt:
        assert "rollback" in [e.action for e in log.faults()]


def test_straggler_watchdog_decides_as_jax():
    """The watchdog on synthetic step times (wall time is unsteady under
    load): the same stragglers flagged, the same EMA."""
    durations = [5.0, 0.1, 0.1, 0.12, 0.1, 0.09, 2.0, 0.1, 0.5, 0.1, 0.1, 0.45]
    ex, jex = ResilientExecutor(None), JaxExecutor(None)
    for step, dt in enumerate(durations):
        ex._watchdog(step, dt)
        jex._watchdog(step, dt)
    got = [(e.step, e.kind, e.code) for e in ex.log.events]
    assert got == [(e.step, e.kind, e.code) for e in jex.log.events]
    assert [s for s, _, _ in got] == [6, 8] and ex._ema_step_time == jex._ema_step_time


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_faulted_run_events_are_the_chip_constant(jax_env, env):
    """chip_smoke.py's train phase holds the card's faulted run to a
    constant; the JAX executor (and the port's) give that list here, so the
    constant ties the card to the reference."""
    chip = _chip_smoke()
    (_, jlog), (_, log) = _run_both(
        jax_env, env, chip.TRAIN_STEPS, dict(chip.TRAIN_FAULTS),
        config=dict(good_state_interval=chip.TRAIN_GOOD_INTERVAL))
    want = [tuple(e) for e in chip.TRAIN_FAULT_EVENTS]
    assert _events(jlog) == want
    assert _events(log) == want


@over_archs
def test_lflr_replay_equals_clean_run_bit_for_bit(arch):
    """nan_grad at 3 (skip) and 8 (restore to the snapshot after step 5):
    the run ends bit-equal, on every leaf, to a clean run over the batches
    its log kept — the chip's run 3, on the CPU."""
    chip = _chip_smoke()
    _, _, _, jstate, pcfg = _jax_env(arch)
    cfg, step_fn, _ = _env(arch)
    ex = ResilientExecutor(step_fn, policy=RecoveryPolicy(can_shrink=False),
                           config=ExecutorConfig(good_state_interval=chip.TRAIN_GOOD_INTERVAL),
                           reset_opt_fn=make_reset_opt_fn(cfg))
    plan = FaultSchedule([FaultSpec(step=s, kind=k) for s, k in chip.TRAIN_LFLR_FAULTS])
    state, log = ex.run(_port_state(jstate, cfg), pipeline.DataIterator(
        pcfg, device="cpu"), chip.TRAIN_STEPS, faults=plan)
    assert [(e.step, e.action) for e in log.faults()] == [
        (3, "skip_batch"), (8, "restore_good")]
    clean = _port_state(jstate, cfg)
    for i in chip.TRAIN_LFLR_KEPT:
        clean, _, word = step_fn(clean, pipeline.make_batch(pcfg, i, "cpu"), 0)
        assert int(word) == 0
    assert len(tree_leaves(state)) == len(tree_leaves(clean))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state), tree_leaves(clean)))


@pytest.mark.parametrize("arch,divergence", [("recurrentgemma-2b", "1000"),
                                               ("mamba2-2.7b", "50")])
def test_train_cli_trains_the_recurrent_stacks(tmp_path, capsys, arch, divergence):
    """The command line trains the RG-LRU and SSD stacks on the CPU: the
    one injected fault skipped, every other step ok (recurrentgemma's smoke
    loss, ~62, needs a divergence threshold above the reference's 50)."""
    rc = train_cli.main(["--device", "cpu", "--arch", arch, "--steps", "8",
                         "--batch", "2", "--seq", "16", "--inject", "3:nan_grad",
                         "--divergence", divergence, "--ckpt-dir", str(tmp_path),
                         "--ckpt-every", "5"])
    out = capsys.readouterr().out
    assert rc == 0 and "ok=7 faults=1" in out and "step 3: code=0x2" in out


def test_train_cli_runs_on_the_cpu(tmp_path, capsys):
    rc = train_cli.main(["--device", "cpu", "--arch", ARCH, "--steps", "12",
                         "--batch", "2", "--seq", "16", "--inject", "3:nan_grad",
                         "--ckpt-dir", str(tmp_path), "--ckpt-every", "5"])
    out = capsys.readouterr().out
    assert rc == 0 and "ok=11 faults=1" in out and "step 3: code=0x2" in out
    assert Checkpointer(tmp_path).list_steps() == [5, 10]
    assert train_cli.parse_inject("1:nan_loss,4:bad_data").inject_word(4) == faults.INJ_BAD_DATA
