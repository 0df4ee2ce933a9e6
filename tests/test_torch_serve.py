"""The port's window+overlap Replica against the JAX Replica and against its
own contracts, on the smoke configs of qwen3-1.7b, gemma3-1b,
recurrentgemma-2b and mamba2-2.7b (float32, weights bridged from JAX):

* the same requests give the same streams as the JAX engine (except where
  the reference's top-2 logit gap is below the logits tolerance);
* the same injected fault words give the same recovery decisions and the
  same streams;
* ``inject_state_fault`` poisons what the JAX replica poisons, for gemma3
  also where its rings hold ``max_len`` entries;
* an injected KV fault (NaN; qwen3) or recurrent-state fault (NaN in ``h``,
  recurrentgemma; in ``ssm``, mamba2) is detected and recovered by LFLR
  with streams bit-equal
  to the port's clean run — and for the state fault, the poisoned elements,
  the fault records and the streams equal the JAX replica's;
* a slot reused after a request serves the next one exactly as a fresh
  replica does (every cache tensor is reset, not only K/V);
* ``window=1`` is bit-equal to ``window=4``;
* host syncs stay O(windows): at most 2 readbacks per retired window.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import build_model
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import Replica as JaxReplica
from repro.serve import Request as JaxRequest
from repro_torch.configs import smoke_config
from repro_torch.core.device_channel import readback
from repro_torch.core.errors import ErrorCode
from repro_torch.obs import Tracer
from repro_torch.serve import OK, EngineConfig, Replica, Request
from repro_torch.weights import cache_from_jax, params_from_jax

torch.set_num_threads(2)

ARCHS = ["qwen3-1.7b", "gemma3-1b", "recurrentgemma-2b", "mamba2-2.7b"]
LOGIT_TOL = 1e-4          # float32 logits, reduction order only
# max_len 48 > the smoke window 16: the rings of recurrentgemma and gemma3
# wrap in serving (prompts up to 12 tokens plus up to 14 new)
ENGINE = dict(window=4, overlap=True, num_slots=3, max_len=48)


_ENVS: dict = {}


def _env(arch):
    """(JAX config, port config, JAX model, JAX params, port model), built
    once per architecture for the module."""
    if arch not in _ENVS:
        jcfg = jax_smoke_config(arch)
        cfg = smoke_config(arch)
        jmodel = build_model(jcfg)
        params = jmodel.init(jax.random.PRNGKey(0))
        model = params_from_jax(jax.device_get(params), cfg, device="cpu")
        _ENVS[arch] = (jcfg, cfg, jmodel, params, model)
    return _ENVS[arch]


@pytest.fixture(params=ARCHS)
def env(request):
    return _env(request.param)


def _traffic(n=8, seed=1):
    """(prompt, max_new) pairs: 2–12-token prompts (some longer than K, so
    prefill spans windows), 3–14 new tokens."""
    rng = np.random.default_rng(seed)
    return [(tuple(int(t) for t in rng.integers(1, 500, int(rng.integers(2, 13)))),
             int(rng.integers(3, 15))) for _ in range(n)]


def _serve(rep, request_cls, traffic, inject_at=None):
    for i, (prompt, max_new) in enumerate(traffic):
        assert rep.submit(request_cls(id=i, prompt=prompt,
                                      max_new_tokens=max_new)) is None
    out, cycles, poisoned = {}, 0, None
    while not rep.idle():
        if inject_at is not None and cycles >= inject_at and poisoned is None:
            # a decoding slot that stays busy past the in-flight window and
            # the next one, so the poisoned window is its own
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


def _jax_replica(env, max_len=ENGINE["max_len"], **kw):
    jcfg, _, _, params, _ = env
    conf = dict(ENGINE, max_len=max_len)
    return JaxReplica(jcfg, params=params, config=JaxEngineConfig(**conf), **kw)


def _port_replica(env, window=ENGINE["window"], max_len=ENGINE["max_len"], **kw):
    _, cfg, _, _, model = env
    conf = dict(ENGINE, window=window, max_len=max_len)
    return Replica(cfg, model, config=EngineConfig(**conf), **kw)


def _assert_streams_match(env, ref, got, traffic):
    """Equal streams, except that a stream may diverge at a position where
    the JAX reference's top-2 logit gap is below the tolerance (a near-tie
    that float reduction order may flip); past a divergence the stream is
    no longer comparable."""
    _, _, jmodel, params, _ = env
    for i, (prompt, _) in enumerate(traffic):
        assert ref[i].status == OK and got[i].status == OK
        a, b = ref[i].tokens, got[i].tokens
        if a == b:
            continue
        k = next(j for j in range(min(len(a), len(b))) if a[j] != b[j])
        seq = jnp.asarray([list(prompt) + list(a[:k])], jnp.int32)
        logits, _ = jmodel.forward(params, seq, impl="ref")
        top2 = np.sort(np.asarray(logits[0, -1]))[-2:]
        assert top2[1] - top2[0] < LOGIT_TOL, (i, k, a, b)


def test_streams_match_jax_replica(env):
    traffic = _traffic()
    ref, _ = _serve(_jax_replica(env), JaxRequest, traffic)
    got, _ = _serve(_port_replica(env), Request, traffic)
    _assert_streams_match(env, ref, got, traffic)


def _injector(schedule):
    """Fault words OR'd into the (K, slots) history: {dispatch: [(k, s, code)]}."""

    def inject(step, shape):
        if step not in schedule:
            return None
        w = np.zeros(shape, np.uint32)
        for k, s, code in schedule[step]:
            w[k, s] |= np.uint32(code)
        return w

    return inject


@pytest.mark.parametrize("schedule", [
    {3: [(2, 1, ErrorCode.NONFINITE_LOSS)]},
    {2: [(0, 0, ErrorCode.DATA_FAULT)], 4: [(3, 2, ErrorCode.STATE_FAULT)],
     5: [(1, 0, ErrorCode.NONFINITE_LOSS | ErrorCode.OVERFLOW)]},
    {s: [(1, 1, ErrorCode.NONFINITE_LOSS)] for s in range(2, 9)},  # escalates
])
def test_recovery_decisions_match_jax_replica(env, schedule):
    """The same injected words give the same fault records — step, code,
    action, slots — and the same streams and statuses."""
    traffic = _traffic()
    inj = {k: [(a, b, int(c)) for a, b, c in v] for k, v in schedule.items()}
    jrep = _jax_replica(env, fault_injector=_injector(inj))
    ref, _ = _serve(jrep, JaxRequest, traffic)
    prep = _port_replica(env, fault_injector=_injector(inj))
    got, _ = _serve(prep, Request, traffic)
    assert prep.metrics.faults, "the schedule must fault"
    assert ([(f.step, f.code, f.action, f.slots) for f in prep.metrics.faults]
            == [(f.step, f.code, f.action, f.slots) for f in jrep.metrics.faults])
    assert {i: r.status for i, r in got.items()} == {i: r.status for i, r in ref.items()}
    assert {i: r.retries for i, r in got.items()} == {i: r.retries for i, r in ref.items()}
    for i in ref:
        if ref[i].status == OK:
            assert got[i].tokens == ref[i].tokens


def test_kv_fault_recovers_by_lflr_bit_exact():
    """qwen3 (attention only): a NaN in an active slot's KV cache is latched
    by the logits probe as NONFINITE_LOSS on that slot; LFLR re-prefills it,
    and every stream is bit-equal to the port's clean run."""
    env = _env("qwen3-1.7b")
    traffic = _traffic()
    clean, _ = _serve(_port_replica(env), Request, traffic)
    rep = _port_replica(env)
    faulted, slot = _serve(rep, Request, traffic, inject_at=3)
    assert slot is not None
    assert rep.metrics.faults
    first = rep.metrics.faults[0]
    assert first.code == int(ErrorCode.NONFINITE_LOSS) and first.slots == (slot,)
    assert sum(r.retries for r in faulted.values()) == 1
    assert {i: r.tokens for i, r in faulted.items()} == {i: r.tokens for i, r in clean.items()}
    assert all(r.status == OK for r in faulted.values())


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-2.7b"])
def test_state_fault_matches_jax_and_lflr(arch):
    """A NaN in an active slot's recurrent state (``h`` for recurrentgemma,
    ``ssm`` for mamba2; put where the JAX replica puts it) latches the same
    fault records in both replicas (step, code STATE_FAULT |
    NONFINITE_LOSS, action, slot); both serve the same streams, and the
    port's are bit-equal to its clean run."""
    env = _env(arch)
    traffic = _traffic()
    clean, _ = _serve(_port_replica(env), Request, traffic)
    jrep, prep = _jax_replica(env), _port_replica(env)
    ref, jslot = _serve(jrep, JaxRequest, traffic, inject_at=3)
    got, slot = _serve(prep, Request, traffic, inject_at=3)
    assert slot == jslot is not None
    code = int(ErrorCode.STATE_FAULT | ErrorCode.NONFINITE_LOSS)
    assert prep.metrics.faults[0].code == code
    assert prep.metrics.faults[0].slots == (slot,)
    assert ([(f.step, f.code, f.action, f.slots) for f in prep.metrics.faults]
            == [(f.step, f.code, f.action, f.slots) for f in jrep.metrics.faults])
    assert {i: r.tokens for i, r in got.items()} == {i: r.tokens for i, r in ref.items()}
    assert {i: r.tokens for i, r in got.items()} == {i: r.tokens for i, r in clean.items()}
    assert all(r.status == OK for r in got.values())


def _assert_same_poison(env, max_len):
    cfg = env[1]
    jrep, prep = _jax_replica(env, max_len=max_len), _port_replica(env, max_len=max_len)
    assert jrep.inject_state_fault(1) == prep.inject_state_fault(1) == 1
    want = cache_from_jax(jax.device_get(jrep.caches), cfg, slots=True,
                          device="cpu")
    assert set(want) == set(prep.caches)
    for name, t in prep.caches.items():
        assert torch.equal(torch.isnan(t), torch.isnan(want[name])), name
    assert _nan_layers(prep) == prep.state_fault_layers()
    return prep


def _nan_layers(rep):
    """The layers whose cache rows hold a NaN, read back from the caches."""
    from repro_torch.models.model import BLOCK_LEAVES, slot_layer_view
    model = rep.model
    return [l for l, b in enumerate(model.cfg.pattern_layers)
            if any(bool(slot_layer_view(rep.caches, name)[:, model.cache_index[l]]
                        .isnan().any()) for name in BLOCK_LEAVES[b])]


def test_inject_state_fault_poisons_what_jax_poisons(env):
    """The poisoned elements of the port's cache are exactly the JAX
    replica's, mapped through the bridge (recurrentgemma: ``h`` in 4
    layers; mamba2: ``ssm`` in layer 0; qwen3: K at position 0 of layer
    0; gemma3: of layer 5, its first full layer)."""
    cfg = env[1]
    prep = _assert_same_poison(env, ENGINE["max_len"])
    hit = prep.caches[(prep.model.state_leaves or ("k",))[0]]
    assert int(torch.isnan(hit).sum()) == (
        4 if cfg.name == "recurrentgemma-2b" else 1)
    if cfg.name == "gemma3-1b":
        assert torch.isnan(hit[0, 1]).any()          # full layer 0: layer 5


def test_inject_state_fault_poisons_a_ring_where_jax_does():
    """gemma3 with ``max_len`` <= the window (12 <= 16): every ring holds
    ``max_len`` entries, and the JAX replica's first K leaf of that
    capacity is layer 0's ring, a sliding layer. The port poisons the same
    element."""
    prep = _assert_same_poison(_env("gemma3-1b"), 12)
    assert int(torch.isnan(prep.caches["k_ring"]).sum()) == 1
    assert torch.isnan(prep.caches["k_ring"][0, 1]).any()
    assert not torch.isnan(prep.caches["k"]).any()


def test_reused_slot_serves_like_a_fresh_replica(env):
    """One slot: request B after request A on the same slot gives B's
    stream AND leaves every cache tensor bit-equal to a fresh replica that
    served B alone — the fresh-lane reset clears the recurrent state and
    the conv history, not only K/V."""
    _, cfg, _, _, model = env
    conf = dict(ENGINE, num_slots=1)
    a, b = _traffic(n=2, seed=11)
    reused = Replica(cfg, model, config=EngineConfig(**conf))
    first, _ = _serve(reused, Request, [a])
    assert first[0].status == OK
    again, _ = _serve(reused, Request, [b])
    fresh = Replica(cfg, model, config=EngineConfig(**conf))
    alone, _ = _serve(fresh, Request, [b])
    assert again[0].status == alone[0].status == OK
    assert again[0].tokens == alone[0].tokens
    for name, t in fresh.caches.items():
        assert torch.equal(reused.caches[name], t), name


def test_window1_bit_equal_window4(env):
    traffic = _traffic(seed=5)
    w4, _ = _serve(_port_replica(env, window=4), Request, traffic)
    w1, _ = _serve(_port_replica(env, window=1), Request, traffic)
    assert {i: r.tokens for i, r in w1.items()} == {i: r.tokens for i, r in w4.items()}


def test_host_sync_budget(env):
    """≤ 2 readbacks per retired window (the error word with its table, then
    the token block) plus slack — nothing scales with admissions, since
    prefill rides the windows."""
    rep = _port_replica(env)
    readback.count = 0
    out, _ = _serve(rep, Request, _traffic(n=10, seed=7))
    syncs = readback.count
    m = rep.metrics
    assert all(r.status == OK for r in out.values())
    assert m.prefill_chunks >= 10
    assert syncs <= 2 * m.windows + 4, (syncs, m.windows)


def test_unported_modes_raise(env):
    _, cfg, _, _, model = env
    with pytest.raises(NotImplementedError, match="item 11"):
        Replica(cfg, model, config=EngineConfig(window=4, tp=2))
    # tracing is ported (ROADMAP item 9): an explicit tracer is taken
    tracer = Tracer()
    rep = Replica(cfg, model, config=EngineConfig(window=4, trace=True),
                  tracer=tracer)
    assert rep.trace is tracer and rep.queue.tracer is tracer


def test_default_config_serves(env):
    """``EngineConfig()`` is the stepwise engine (window 0), as in the JAX
    package, and it serves."""
    _, cfg, _, _, model = env
    rep = Replica(cfg, model)
    assert rep.config == EngineConfig() == EngineConfig(window=0)
    assert (rep.window, rep.overlap) == (0, False)
    rep.submit(Request(id=0, prompt=(1, 2, 3), max_new_tokens=4))
    (resp,) = rep.run()
    assert resp.status == OK and len(resp.tokens) == 4


def test_injector_words_are_validated(env):
    rep = _port_replica(env, fault_injector=lambda step, shape: np.full(
        shape, int(ErrorCode.RANK_FAILED), np.uint32))
    rep.submit(Request(id=0, prompt=(1, 2), max_new_tokens=3))
    with pytest.raises(ValueError, match="non-injectable"):
        rep.run()


def test_metrics_event_log(env):
    """The fault records and answers export as one wall-ordered EventLog,
    the record the training executor emits."""
    rep = _port_replica(env, fault_injector=_injector(
        {2: [(0, 0, int(ErrorCode.NONFINITE_LOSS))]}))
    out, _ = _serve(rep, Request, _traffic(n=4, seed=3))
    events = rep.metrics.to_event_log().events
    assert [e.t for e in events] == sorted(e.t for e in events)
    faults = [e for e in events if e.kind == "fault" and e.action]
    assert [(e.code, e.action) for e in faults] == [
        (f.code, f.action) for f in rep.metrics.faults]
    assert sum(e.kind == "ok" for e in events) == sum(r.ok for r in out.values())
    summary = rep.metrics.summary()
    assert summary["requests"] == len(out) and summary["windows"] == rep.metrics.windows
