"""The port's Mixture-of-Experts block, untied unembedding and router probe
against the JAX package, on the qwen3-moe-30b-a3b smoke config (2 layers,
d_model 64, 8 experts top-2, expert d_ff 128, vocab 512, untied; fp32):

* ``apply_moe`` with ample capacity (nothing dropped) and with tight
  capacity: the same expert choices, the same kept ``(s, k)`` assignments
  and buffer rows, the same dropped fraction and ``load_max``, outputs to
  tolerance;
* the full forward's logits and dropped fraction, the decode steps' logits;
* a window+overlap ``Replica`` against the JAX one: streams, fault records
  (the error words, steps, slots and actions) for injected words and for a
  NaN in a slot's KV cache, recovered by LFLR bit-equal to the clean run;
* ``router_probe`` and ``step_probe(router_dropped=...)`` words, bit-equal
  around the threshold;
* a train step at tight capacity that raises ROUTER_OVERFLOW, and the
  executor deciding CONTINUE on it, as the JAX executor does;
* gradients through the router, the experts and the unembedding, held to
  ``jax.grad``.

Routing near-ties: ``torch.topk`` and ``jax.lax.top_k`` agree on distinct
values, but the fp32 router probabilities of the two packages may differ in
their last bits (~1e-8 here), which could swap the K-th and (K+1)-th expert
where the two are that close. The block test therefore allows a token's
experts to differ only where the reference's gap between its K-th and
(K+1)-th probability is below ``TIE_MARGIN`` (1e-5), and requires such
tokens to be rare (at most 1% of them: one of 128 at the tight seed, its
gap 7.0e-6; the mean gap is 6e-2). A batch row whose choices differ is
left out of the row-wise comparisons (a swap moves every later position
in its expert); every other comparison is exact.

Tolerances: both packages compute in fp32 and differ in reduction order
only — ``TOL`` (1e-4 absolute) on logits of magnitude ~1-5, as the other
model tests; ``MOE_TOL`` (1e-5) on the block's outputs of magnitude ~1;
``GRAD_TOL`` (1e-5 of each leaf's largest) on gradients. Counts and
fractions of kept tokens are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core import ExecutorConfig as JaxExecutorConfig
from repro.core import ResilientExecutor as JaxExecutor
from repro.core import detect as jdetect
from repro.core.recovery import RecoveryPolicy as JaxPolicy
from repro.data import pipeline as jpipe
from repro.launch.train import build_train_setup as jax_build
from repro.models import build_model
from repro.models.moe import _dispatch_row
from repro.models.moe import apply_moe as jax_apply_moe
from repro.models.moe import init_moe
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import Replica as JaxReplica
from repro.serve import Request as JaxRequest
from repro_torch.configs import smoke_config
from repro_torch.core import ExecutorConfig, ResilientExecutor, detect
from repro_torch.core.errors import ErrorCode
from repro_torch.core.recovery import RecoveryPolicy
from repro_torch.data import pipeline
from repro_torch.launch import train as train_cli
from repro_torch.launch.steps import make_loss_and_grads
from repro_torch.models.moe import MoE, apply_moe, capacity, dispatch, route
from repro_torch.serve import OK, EngineConfig, Replica, Request
from repro_torch.weights import (_flat_from_jax, _to_tensor, params_from_jax,
                                 train_state_from_jax)

torch.set_num_threads(2)

ARCH = "qwen3-moe-30b-a3b"
TOL = 1e-4
MOE_TOL = 1e-5
GRAD_TOL = 1e-5
TIE_MARGIN = 1e-5
# capacity factors: ample (C = 8 * S * K / E, never reached) and tight (C
# at its floor of 8 while each expert gets S * K / E = 16 on average)
AMPLE, TIGHT = 8.0, 0.05
ENGINE = dict(window=4, overlap=True, num_slots=3, max_len=48)


def _cfgs(cf=None):
    jcfg, cfg = jax_smoke_config(ARCH), smoke_config(ARCH)
    if cf is not None:
        jcfg = jcfg.replace(expert_capacity_factor=cf)
        cfg = cfg.replace(expert_capacity_factor=cf)
    return jcfg, cfg


_ENV: dict = {}


def _env():
    """(JAX config, port config, JAX model, JAX params, port model), once."""
    if not _ENV:
        jcfg, cfg = _cfgs()
        jmodel = build_model(jcfg)
        params = jmodel.init(jax.random.PRNGKey(0))
        model = params_from_jax(jax.device_get(params), cfg, device="cpu")
        _ENV["env"] = (jcfg, cfg, jmodel, params, model)
    return _ENV["env"]


def _moe_pair(cfg, seed=0):
    """JAX MoE params and the port's MoE module holding the same weights."""
    p = jax.device_get(init_moe(jax.random.PRNGKey(seed), cfg))
    mod = MoE(cfg, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for name, leaf in p.items():
            getattr(mod, name).copy_(_to_tensor(leaf))
    return p, mod


def _near_ties(probs, K):
    """(B, S) mask of the tokens whose K-th and (K+1)-th router
    probabilities (the reference's) are closer than TIE_MARGIN."""
    top = np.sort(np.asarray(probs), axis=-1)[..., ::-1]
    return top[..., K - 1] - top[..., K] < TIE_MARGIN


def _jax_routing(p, x, cfg):
    """The reference's routing and dispatch metadata, step by step."""
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    probs = jax.nn.softmax(jnp.asarray(x) @ p["router"], axis=-1)
    gates, experts = jax.lax.top_k(probs, K)
    C = -(-int(cfg.expert_capacity_factor * x.shape[1] * K / E) // 8) * 8
    _, (buf_idx, _, keep) = jax.vmap(
        lambda xt, ei, gv: _dispatch_row(xt, ei, gv, E, max(8, C)))(
            jnp.asarray(x), experts, gates)
    return probs, np.asarray(experts), np.asarray(buf_idx), np.asarray(keep)


@pytest.mark.parametrize("cf,S", [(AMPLE, 16), (TIGHT, 64)])
def test_apply_moe_matches_jax(cf, S):
    """Ample capacity drops nothing; tight capacity (C = 8 for 16 tokens an
    expert on average) drops about half: the same assignments kept, in the
    same buffer rows, the same fraction and load, outputs to MOE_TOL."""
    _, cfg = _cfgs(cf)
    p, mod = _moe_pair(cfg)
    x = np.random.default_rng(1).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    want, jaux = jax_apply_moe(p, jnp.asarray(x), cfg)
    with torch.no_grad():
        got, aux = apply_moe(mod, torch.from_numpy(x), cfg)
    probs, jexperts, jbuf, jkeep = _jax_routing(p, x, cfg)
    ties = _near_ties(probs, cfg.num_experts_per_tok)
    assert ties.sum() <= max(1, ties.size // 100)
    _, experts = route(mod, torch.from_numpy(x), cfg)
    C = capacity(S, cfg)
    buf_idx, keep = dispatch(experts, cfg.num_experts, C)
    differ = (np.sort(experts.numpy(), -1) != np.sort(jexperts, -1)).any(-1)
    assert not (differ & ~ties).any()
    rows = ~differ.any(-1)                  # batch rows with the same routing
    assert rows.any()
    np.testing.assert_array_equal(experts.numpy()[rows], jexperts[rows])
    np.testing.assert_array_equal(keep.numpy()[rows], jkeep[rows])
    np.testing.assert_array_equal(buf_idx.numpy()[rows], jbuf[rows])
    np.testing.assert_allclose(got.numpy()[rows], np.asarray(want)[rows],
                               rtol=MOE_TOL, atol=MOE_TOL)
    if rows.all():
        assert aux["dropped_fraction"].item() == float(jaux["dropped_fraction"])
        assert aux["load_max"].item() == float(jaux["load_max"])
    if cf == AMPLE:
        assert aux["dropped_fraction"].item() == float(jaux["dropped_fraction"])
    else:
        assert C == 8 and 0.3 < aux["dropped_fraction"].item() < 0.7


def test_capacity_is_the_references():
    for cf in (AMPLE, 1.25, TIGHT):
        jcfg, cfg = _cfgs(cf)
        for S in (1, 7, 16, 64, 1000):
            c = int(cf * S * cfg.num_experts_per_tok / cfg.num_experts)
            assert capacity(S, cfg) == max(8, -(-c // 8) * 8)


@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_forward_logits_and_dropped_fraction_match_jax(cf):
    """The default capacity (no drop at 32 tokens) and a tight one (tokens
    dropped in both layers): logits to TOL, the mean dropped fraction
    exact (each layer's is a count over the kept mask; the mean of two is
    the same in either order)."""
    jcfg, cfg = _cfgs(cf)
    _, _, jmodel, params, _ = _env()
    model = params_from_jax(jax.device_get(params), cfg, device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    want, jaux = build_model(jcfg).forward(params, jnp.asarray(toks), impl="ref")
    with torch.no_grad():
        got, aux = model(torch.from_numpy(toks), with_aux=True)
        assert torch.equal(model(torch.from_numpy(toks)), got)
    assert model.unembed is not None and model.unembed.shape == (cfg.d_model,
                                                                 cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    assert aux["dropped_fraction"].item() == float(jaux["dropped_fraction"])
    assert (aux["dropped_fraction"].item() > 0) == (cf < 1)


def test_decode_steps_match_jax():
    """Ten decode steps from an empty cache, two rows: the logits of each."""
    _, cfg, jmodel, params, model = _env()
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    jcache = jmodel.init_cache(2, 12)
    cache = model.init_cache(2, 12)
    for p in range(10):
        tok = toks[:, p:p + 1]
        want, jcache = jmodel.decode_step(params, jnp.asarray(tok), jcache, p)
        with torch.no_grad():
            got = model.decode_step(torch.from_numpy(tok), cache, p)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


# ------------------------------------------------------------------- serving
def _traffic(n=8, seed=1):
    rng = np.random.default_rng(seed)
    return [(tuple(int(t) for t in rng.integers(1, 500, int(rng.integers(2, 13)))),
             int(rng.integers(3, 15))) for _ in range(n)]


def _serve(rep, request_cls, traffic, inject_at=None):
    """Serve to completion; at cycle ``inject_at`` a NaN goes into the KV
    cache of a decoding slot that stays busy past the in-flight window and
    the next one."""
    for i, (prompt, max_new) in enumerate(traffic):
        assert rep.submit(request_cls(id=i, prompt=prompt,
                                      max_new_tokens=max_new)) is None
    out, cycles, poisoned = {}, 0, None
    while not rep.idle():
        if inject_at is not None and cycles >= inject_at and poisoned is None:
            decoding = [s.idx for s in rep.sched.slots
                        if s.active and s.pending is None and s.generated
                        and s.req.max_new_tokens - len(s.generated) > 2 * rep.window]
            if decoding:
                poisoned = rep.inject_state_fault(decoding[0])
        for resp in rep.step():
            out[resp.id] = resp
        cycles += 1
        assert cycles < 500
    return out, poisoned


def _replicas(**kw):
    jcfg, cfg, _, params, model = _env()
    return (JaxReplica(jcfg, params=params, config=JaxEngineConfig(**ENGINE), **kw),
            Replica(cfg, model, config=EngineConfig(**ENGINE), **kw))


def _records(rep):
    return [(f.step, f.code, f.action, f.slots) for f in rep.metrics.faults]


def _injector(schedule):
    def inject(step, shape):
        if step not in schedule:
            return None
        w = np.zeros(shape, np.uint32)
        for k, s, code in schedule[step]:
            w[k, s] |= np.uint32(code)
        return w
    return inject


def _assert_streams_match(ref, got, traffic):
    """Equal greedy streams, except that a stream may part where the JAX
    reference's top-2 logit gap is below TOL (a near-tie that reduction
    order may flip); past that point the streams are not compared."""
    _, _, jmodel, params, _ = _env()
    for i, (prompt, _) in enumerate(traffic):
        assert ref[i].status == OK and got[i].status == OK
        a, b = ref[i].tokens, got[i].tokens
        if a == b:
            continue
        k = next(j for j in range(min(len(a), len(b))) if a[j] != b[j])
        seq = jnp.asarray([list(prompt) + list(a[:k])], jnp.int32)
        logits, _ = jmodel.forward(params, seq, impl="ref")
        top2 = np.sort(np.asarray(logits[0, -1]))[-2:]
        assert top2[1] - top2[0] < TOL, (i, k, a, b)


def test_replica_serves_and_recovers_as_jax():
    """Clean, the streams of the JAX replica. With a NaN in one decoding
    slot's KV cache: the same fault records in both (the NONFINITE_LOSS word
    on that slot, at the same step, with the same action), the same
    streams, and the port's bit-equal to its own clean run (LFLR)."""
    traffic = _traffic()
    jrep, prep = _replicas()
    ref, _ = _serve(jrep, JaxRequest, traffic)
    clean, _ = _serve(prep, Request, traffic)
    _assert_streams_match(ref, clean, traffic)
    assert not prep.metrics.faults
    jrep, prep = _replicas()
    jgot, jslot = _serve(jrep, JaxRequest, traffic, inject_at=3)
    got, slot = _serve(prep, Request, traffic, inject_at=3)
    assert slot == jslot is not None
    assert prep.metrics.faults[0].code == int(ErrorCode.NONFINITE_LOSS)
    assert prep.metrics.faults[0].slots == (slot,)
    assert _records(prep) == _records(jrep)
    assert {i: r.tokens for i, r in got.items()} == {i: r.tokens for i, r in jgot.items()}
    assert {i: r.tokens for i, r in got.items()} == {i: r.tokens for i, r in clean.items()}
    assert all(r.status == OK for r in got.values())


@pytest.mark.parametrize("schedule", [
    {3: [(2, 1, ErrorCode.NONFINITE_LOSS)]},
    {2: [(0, 0, ErrorCode.ROUTER_OVERFLOW)], 4: [(1, 2, ErrorCode.NONFINITE_LOSS)]},
])
def test_replica_decisions_match_jax(schedule):
    """Injected words (one a ROUTER_OVERFLOW) give the same fault records,
    statuses, retries and streams in both replicas."""
    traffic = _traffic()
    inj = {k: [(a, b, int(c)) for a, b, c in v] for k, v in schedule.items()}
    jrep, prep = _replicas(fault_injector=_injector(inj))
    ref, _ = _serve(jrep, JaxRequest, traffic)
    got, _ = _serve(prep, Request, traffic)
    assert prep.metrics.faults and _records(prep) == _records(jrep)
    assert {i: r.status for i, r in got.items()} == {i: r.status for i, r in ref.items()}
    assert {i: r.retries for i, r in got.items()} == {i: r.retries for i, r in ref.items()}
    for i in ref:
        if ref[i].status == OK:
            assert got[i].tokens == ref[i].tokens


def test_speculation_is_refused_for_moe():
    _, cfg, _, _, model = _env()
    assert not model.supports_speculation()
    with pytest.raises(ValueError, match="non-MoE"):
        Replica(cfg, model, config=EngineConfig(window=4, speculate=True))


# -------------------------------------------------------------------- probes
@pytest.mark.parametrize("threshold", [0.5, 0.25])
def test_router_probe_words_bit_equal(threshold):
    """Fractions below, at and above the threshold: ROUTER_OVERFLOW only
    strictly above it; step_probe ORs it into the loss and gradient words."""
    pc = detect.ProbeConfig(router_drop_threshold=threshold)
    jpc = jdetect.ProbeConfig(router_drop_threshold=threshold)
    assert detect.ProbeConfig().router_drop_threshold == \
        jdetect.ProbeConfig().router_drop_threshold == 0.5
    grads = {"w": np.ones((3, 4), np.float32)}
    for frac in (0.0, threshold - 1e-7, threshold, threshold + 1e-7, 1.0):
        for loss in (1.0, float("nan")):
            f = np.float32(frac)
            got = detect.router_probe(torch.tensor(f), pc)
            want = jdetect.router_probe(jnp.float32(f), jpc)
            assert int(got) == int(want)
            assert int(got) == (int(ErrorCode.ROUTER_OVERFLOW) if f > threshold else 0)
            got = detect.step_probe(torch.tensor(np.float32(loss)),
                                    {k: torch.from_numpy(v) for k, v in grads.items()},
                                    router_dropped=torch.tensor(f), cfg=pc)
            want = jdetect.step_probe(jnp.float32(loss),
                                      {k: jnp.asarray(v) for k, v in grads.items()},
                                      router_dropped=jnp.float32(f), cfg=jpc)
            assert got.dtype == torch.int32 and int(got) == int(want)


# ------------------------------------------------------------------ training
B, S_TRAIN, TOTAL = 2, 128, 40


def test_tight_capacity_train_step_overflows_and_continues():
    """At tight capacity (C = 8 for 32 assignments an expert) the train step
    drops more than half the tokens: its word carries ROUTER_OVERFLOW as the
    JAX step's does, its ``dropped_fraction`` metric is the JAX one, and
    both executors decide CONTINUE on it at every step (which, as in the
    reference's executor, logs the fault and discards the step's update)."""
    jcfg, cfg = _cfgs(TIGHT)
    _, jstep, jstate, jpipe_, _ = jax_build(jcfg, batch_size=B, seq_len=S_TRAIN,
                                            total_steps=TOTAL)
    _, step_fn, _, pipe, _ = train_cli.build_train_setup(
        cfg, batch_size=B, seq_len=S_TRAIN, total_steps=TOTAL, device="cpu")
    state = train_state_from_jax(jax.device_get(jstate), cfg, device="cpu")
    _, metrics, word = step_fn(state, pipeline.make_batch(pipe.cfg, 0, "cpu"), 0)
    _, jm, jword = jstep(jstate, jpipe.make_batch(
        jpipe.PipelineConfig(**pipe.cfg.__dict__), 0), jnp.uint32(0))
    assert int(word) == int(jword) == int(ErrorCode.ROUTER_OVERFLOW)
    assert metrics["dropped_fraction"].item() == float(jm["dropped_fraction"]) > 0.5
    config = dict(good_state_interval=5, checkpoint_interval=10)
    jex = JaxExecutor(jstep, policy=JaxPolicy(can_shrink=False),
                      config=JaxExecutorConfig(**config))
    ex = ResilientExecutor(step_fn, policy=RecoveryPolicy(can_shrink=False),
                           config=ExecutorConfig(**config))
    jfinal, jlog = jex.run(jstate, jpipe.DataIterator(jpipe.PipelineConfig(
        **pipe.cfg.__dict__)), 3)
    final, log = ex.run(state, pipeline.DataIterator(pipe.cfg, device="cpu"), 3)
    events = [(e.step, e.kind, e.code, e.action) for e in log.events
              if e.kind != "straggler"]
    assert events == [(e.step, e.kind, e.code, e.action) for e in jlog.events
                      if e.kind != "straggler"]
    assert [(e.code, e.action) for e in log.faults()] == [
        (int(ErrorCode.ROUTER_OVERFLOW), "continue")] * 3
    assert int(final["step"]) == int(jfinal["step"])


def test_gradients_reach_router_experts_and_unembed():
    """The loss's gradient through the MoE dispatch (plain torch) and the
    untied unembedding: every leaf's gradient within GRAD_TOL of
    ``jax.grad``'s, and the router, expert and unembedding gradients
    finite and non-zero (the reference's ``test_moe_grads_flow``)."""
    jcfg, cfg = _cfgs()
    jmodel, _, jstate, jpipe_, _ = jax_build(jcfg, batch_size=B, seq_len=16,
                                             total_steps=TOTAL)
    batch = jpipe_.cfg
    jb = jpipe.make_batch(batch, 0)
    (jl, jaux), jg = jax.value_and_grad(lambda p: jmodel.loss(p, jb),
                                        has_aux=True)(jstate["params"])
    state = train_state_from_jax(jax.device_get(jstate), cfg, device="cpu")
    tb = pipeline.make_batch(pipeline.PipelineConfig(**batch.__dict__), 0, "cpu")
    loss, grads, aux = make_loss_and_grads(cfg)(state["params"], tb)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    assert aux["dropped_fraction"].item() == float(jaux["dropped_fraction"])
    want = _flat_from_jax(jax.device_get(jg), cfg, torch.device("cpu"))
    assert list(grads) == list(state["params"])
    for name, g in grads.items():
        scale = want[name].abs().max().item()
        assert (g - want[name]).abs().max().item() <= GRAD_TOL * scale, name
    for name in ["unembed"] + [f"blocks.{l}.moe.{w}" for l in range(2)
                               for w in ("router", "wi", "wg", "wo")]:
        assert torch.isfinite(grads[name]).all() and grads[name].abs().sum() > 0, name
