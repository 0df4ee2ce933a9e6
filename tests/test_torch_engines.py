"""The port's stepwise engine (``window=0``) and blocking prefill
(``window=K, overlap=False``) against the JAX replica in the same modes and
against the port's own bit-exact contracts, on the smoke configs of
qwen3-1.7b, gemma3-1b, recurrentgemma-2b and mamba2-2.7b (float32, weights
bridged from JAX):

* the same requests give the same streams as the JAX engine in the same mode
  (except where the reference's top-2 logit gap is below the logits
  tolerance, as in ``test_torch_serve.py``);
* the same injected fault words, and the same faulted prefills, give the
  same recovery decisions — step, code, action, slots — and statuses;
* inside the port, bit for bit: stepwise ≡ ``window=4``, blocking ≡
  overlap, LFLR ≡ the clean run in both modes, a chain of chunked prefills ≡
  one cache prefill, and ``make_decode_window`` ≡ the fused window with no
  chunk;
* a free slot's word is masked out; host syncs stay at 2 per step or window
  plus 2 per blocking prefill;
* ``EngineConfig`` accepts and refuses the same field combinations in both
  packages.

The JAX replicas share their jitted step functions per architecture and
mode, so each compiles once for the module.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.steps import make_cache_prefill as jax_cache_prefill
from repro.launch.steps import make_decode_window as jax_decode_window
from repro.launch.steps import make_slot_decode_step as jax_slot_step
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import Replica as JaxReplica
from repro.serve import Request as JaxRequest
from repro.serve.replica import SERVE_PROBES
from repro_torch.core.device_channel import readback
from repro_torch.core.errors import ErrorCode
from repro_torch.launch.steps import (make_cache_prefill, make_chunked_prefill,
                                      make_decode_step, make_decode_window,
                                      make_prefill_decode_window,
                                      make_slot_decode_step)
from repro_torch.models.model import insert_cache_slot, slot_layer_view
from repro_torch.serve import FAILED, OK, EngineConfig, Replica, Request
from test_torch_serve import (ARCHS, _assert_streams_match, _env, _injector,
                              _serve, _traffic)

torch.set_num_threads(2)

K = 4
# the smoke window is 16: with max_len 48 the rings of gemma3 and
# recurrentgemma wrap while serving
BASE = dict(num_slots=3, max_len=48)
MODES = {"stepwise": dict(window=0), "blocking": dict(window=K, overlap=False),
         "overlap": dict(window=K, overlap=True)}

_JAX_FNS: dict = {}


@pytest.fixture(params=ARCHS)
def env(request):
    return _env(request.param)


def _jax_fns(env, mode):
    """The jitted functions a JAX replica of ``mode`` runs, built once per
    architecture and mode."""
    jcfg = env[0]
    key = (jcfg.name, mode)
    if key not in _JAX_FNS:
        if mode == "stepwise":
            fns = dict(decode_fn=jax.jit(jax_slot_step(jcfg, SERVE_PROBES)),
                       prefill_fn=jax_cache_prefill(jcfg, SERVE_PROBES))
        else:
            fns = dict(window_fn=jax_decode_window(jcfg, SERVE_PROBES, window=K),
                       prefill_fn=jax_cache_prefill(jcfg, SERVE_PROBES, fused=True))
        _JAX_FNS[key] = fns
    return _JAX_FNS[key]


def _jax_replica(env, mode, **kw):
    jcfg, _, _, params, _ = env
    return JaxReplica(jcfg, params=params,
                      config=JaxEngineConfig(**BASE, **MODES[mode]),
                      **_jax_fns(env, mode), **kw)


def _port_replica(env, mode, **kw):
    _, cfg, _, _, model = env
    return Replica(cfg, model, config=EngineConfig(**BASE, **MODES[mode]), **kw)


def _tokens(out):
    return {i: r.tokens for i, r in out.items()}


# ------------------------------------------------------------ against JAX
@pytest.mark.parametrize("mode", ["stepwise", "blocking"])
def test_streams_match_jax_replica(env, mode):
    traffic = _traffic()
    assert max(len(p) + n for p, n in traffic) > 16     # rings wrap
    ref, _ = _serve(_jax_replica(env, mode), JaxRequest, traffic)
    got, _ = _serve(_port_replica(env, mode), Request, traffic)
    _assert_streams_match(env, ref, got, traffic)


# {dispatch: [(slot, code)]} stepwise, {dispatch: [(step, slot, code)]}
# windowed: single faults, two slots at once, and a repeated fault on one
# slot that escalates to ROLLBACK (and, stepwise, fails its request; in
# the window engine every other of those faults lands in a window whose lane
# the recovery invalidated, so the retries spread over the slot's requests)
SCHEDULES = {
    "stepwise": {3: [(1, ErrorCode.NONFINITE_LOSS)],
                 5: [(0, ErrorCode.DATA_FAULT), (2, ErrorCode.STATE_FAULT)],
                 **{s: [(1, ErrorCode.NONFINITE_LOSS)] for s in range(8, 14)}},
    "blocking": {2: [(1, 1, ErrorCode.NONFINITE_LOSS)],
                 3: [(0, 0, ErrorCode.DATA_FAULT), (3, 2, ErrorCode.STATE_FAULT)],
                 **{s: [(1, 1, ErrorCode.NONFINITE_LOSS)] for s in range(5, 11)}},
}


def _step_injector(schedule):
    """Fault words OR'd into the stepwise engine's (slots,) words."""

    def inject(step, shape):
        if step not in schedule:
            return None
        w = np.zeros(shape, np.uint32)
        for s, code in schedule[step]:
            w[s] |= np.uint32(code)
        return w

    return inject


def _records(rep):
    return [(f.step, f.code, f.action, f.slots) for f in rep.metrics.faults]


@pytest.mark.parametrize("mode", ["stepwise", "blocking"])
def test_recovery_decisions_match_jax_replica(env, mode):
    """The same injected words give the same fault records — step, code,
    action, slots (the stepwise engine attributes through the enumeration's
    ``(slot, code)`` pairs, having no window history) — and the same
    statuses, retries and streams."""
    traffic = _traffic()
    sched = {k: [tuple(int(x) for x in e) for e in v]
             for k, v in SCHEDULES[mode].items()}
    make = _step_injector if mode == "stepwise" else _injector
    jrep = _jax_replica(env, mode, fault_injector=make(sched))
    ref, _ = _serve(jrep, JaxRequest, traffic)
    prep = _port_replica(env, mode, fault_injector=make(sched))
    got, _ = _serve(prep, Request, traffic)
    assert len(prep.metrics.faults) >= 3
    assert "rollback" in {f.action for f in prep.metrics.faults}
    assert (FAILED in {r.status for r in got.values()}) == (mode == "stepwise")
    assert _records(prep) == _records(jrep)
    assert {i: r.status for i, r in got.items()} == {i: r.status for i, r in ref.items()}
    assert {i: r.retries for i, r in got.items()} == {i: r.retries for i, r in ref.items()}
    for i in ref:
        if ref[i].status == OK:
            assert got[i].tokens == ref[i].tokens


def _faulty_prefill(prefill, faults, bad):
    """Wrap a replica's prefill so that its first ``faults`` calls return
    the word ``bad`` (a prefill that faults, as a poisoned device would)."""
    calls = {"n": 0}

    def wrapped(*args, **kw):
        logits, cache, word = prefill(*args, **kw)
        calls["n"] += 1
        return logits, cache, word | bad if calls["n"] <= faults else word

    return wrapped


@pytest.mark.parametrize("mode", ["stepwise", "blocking"])
@pytest.mark.parametrize("faults", [2, 3])
def test_faulted_prefill_retries_then_fails_as_jax(mode, faults):
    """A blocking prefill that faults retries; with ``max_request_retries``
    2, two faults are recovered from and the third fails the request. The
    fault records (``prefill_retry``), statuses and streams equal the JAX
    replica's."""
    env = _env("qwen3-1.7b")
    traffic = _traffic(n=4, seed=9)
    nf = int(ErrorCode.NONFINITE_LOSS)
    jrep = _jax_replica(env, mode)
    jrep._prefill = _faulty_prefill(jrep._prefill, faults, jnp.uint32(nf))
    ref, _ = _serve(jrep, JaxRequest, traffic)
    prep = _port_replica(env, mode)
    prep._prefill = _faulty_prefill(prep._prefill, faults, nf)
    got, _ = _serve(prep, Request, traffic)
    assert _records(prep) == _records(jrep)
    assert [f.action for f in prep.metrics.faults] == ["prefill_retry"] * faults
    assert {i: r.status for i, r in got.items()} == {i: r.status for i, r in ref.items()}
    assert (got[0].status == FAILED) == (faults > 2)
    for i in ref:
        if ref[i].status == OK:
            assert got[i].tokens == ref[i].tokens


# ------------------------------------------------------ inside the port
def test_stepwise_bit_equal_window(env):
    traffic = _traffic(seed=5)
    step, _ = _serve(_port_replica(env, "stepwise"), Request, traffic)
    win, _ = _serve(_port_replica(env, "overlap"), Request, traffic)
    assert all(r.status == OK for r in step.values())
    assert _tokens(step) == _tokens(win)


def test_blocking_bit_equal_overlap(env):
    traffic = _traffic(seed=6)
    block, _ = _serve(_port_replica(env, "blocking"), Request, traffic)
    over, _ = _serve(_port_replica(env, "overlap"), Request, traffic)
    assert all(r.status == OK for r in block.values())
    assert _tokens(block) == _tokens(over)


@pytest.mark.parametrize("mode", ["stepwise", "blocking"])
def test_blocking_prefill_builds_the_slot_steps_bits(env, mode):
    """A lane rebuilt by the blocking prefill holds, in every cache tensor,
    the bits the slot step gives when it feeds the same tokens at the same
    positions while the other slots decode other tokens elsewhere — so the
    prefill must run at the slots' batch size (a batch-1 prefill rounds its
    products otherwise) — and its first token is that step's argmax."""
    _, cfg, _, _, model = env
    rng = np.random.default_rng(12)
    seq = tuple(int(t) for t in rng.integers(1, cfg.vocab_size, 9))
    rep = _port_replica(env, mode)
    rep.submit(Request(id=0, prompt=seq, max_new_tokens=4))
    ((slot, _),) = rep.sched.backfill()
    rep._prefill_slot(slot)
    S = BASE["num_slots"]
    caches = model.init_cache(S, BASE["max_len"])
    step = make_slot_decode_step(model)
    for i, t in enumerate(seq):
        toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, S).astype(np.int32))
        pos = torch.from_numpy(rng.integers(0, 30, S).astype(np.int32))
        toks[slot], pos[slot] = t, i
        logits, _ = step(caches, toks, pos)
    for name in caches:
        assert torch.equal(slot_layer_view(rep.caches, name)[slot],
                           slot_layer_view(caches, name)[slot]), name
    assert rep.sched.slots[slot].generated == [int(torch.argmax(logits[slot]))]


@pytest.mark.parametrize("mode", ["stepwise", "blocking"])
def test_lflr_bit_equal_clean(env, mode):
    """A NaN put where the JAX replica puts it (the recurrent state, or K of
    the first full-capacity layer) latches on its slot; the blocking
    re-prefill recovers it and every stream is bit-equal to the clean
    run."""
    traffic = _traffic()
    clean, _ = _serve(_port_replica(env, mode), Request, traffic)
    rep = _port_replica(env, mode)
    faulted, slot = _serve(rep, Request, traffic, inject_at=3)
    assert slot is not None
    first = rep.metrics.faults[0]
    code = (ErrorCode.STATE_FAULT if rep.model.state_leaves
            else ErrorCode.NONFINITE_LOSS)
    assert first.code & int(code) and first.slots == (slot,)
    assert sum(r.retries for r in faulted.values()) == 1
    assert rep.metrics.host_stalls == len(traffic) + 1
    assert all(r.status == OK for r in faulted.values())
    assert _tokens(faulted) == _tokens(clean)


def test_free_slot_words_are_masked():
    """A free slot decodes a dummy token at position 0 every stepwise step;
    a NaN in its recurrent state latches STATE_FAULT in its word, which the
    mask must drop: no fault is recorded."""
    env = _env("recurrentgemma-2b")
    rep = _port_replica(env, "stepwise")
    slot_layer_view(rep.caches, "h")[2] = float("nan")
    rep.submit(Request(id=0, prompt=(3, 4, 5), max_new_tokens=6))
    (resp,) = rep.run()
    assert resp.status == OK and not rep.metrics.faults
    assert torch.isnan(rep.caches["h"][2]).all()


@pytest.mark.parametrize("mode", ["stepwise", "blocking"])
def test_host_sync_budget(env, mode):
    """≤ 2 readbacks per stepwise step or retired window (the word with its
    table, then the tokens) plus 2 per blocking prefill (its word, then its
    token)."""
    rep = _port_replica(env, mode)
    readback.count = 0
    out, _ = _serve(rep, Request, _traffic(n=10, seed=7))
    m = rep.metrics
    assert all(r.status == OK for r in out.values())
    assert m.prefills == m.host_stalls == 10
    units = m.decode_steps if mode == "stepwise" else m.windows
    assert readback.count <= 2 * units + 2 * m.prefills, (readback.count, units)
    summary = m.summary()
    assert summary["prefills"] == 10 and summary["host_stall_s"] >= 0


def test_chunked_prefill_chain_equals_cache_prefill(env):
    """13 tokens as chunks of 4, 4, 4 and 1 (one chunk fed partly) through
    ``make_chunked_prefill`` ≡ one ``make_cache_prefill``: last logits,
    word and every cache tensor, bit for bit; and the last logits meet the
    JAX cache prefill's."""
    jcfg, cfg, jmodel, params, model = env
    toks = np.random.default_rng(8).integers(1, cfg.vocab_size, (2, 13)).astype(np.int32)
    t = torch.from_numpy(toks)
    logits, cache, word = make_cache_prefill(model)(t, 20)
    step = make_chunked_prefill(model, chunk=4)
    chain = model.init_cache(2, 20)
    for lo in range(0, 13, 4):
        part = torch.zeros((2, 4), dtype=torch.int32)
        n = min(4, 13 - lo)
        part[:, :n] = t[:, lo:lo + n]
        got, chain, w = step(chain, part, n, lo)
    assert torch.equal(got, logits) and int(w) == int(word) == 0
    assert chain.keys() == cache.keys()
    for name in cache:
        assert torch.equal(chain[name], cache[name]), name
    want, _, jword = jax_cache_prefill(jcfg)(params, jnp.asarray(toks), 20)
    assert int(jword) == 0
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    # the scratch form: a used cache is zeroed and refilled to the same bits
    again, cache2, _ = make_cache_prefill(model)(t, 20, cache=chain)
    assert cache2 is chain and torch.equal(again, logits)
    for name in cache:
        assert torch.equal(chain[name], cache[name]), name


def test_decode_window_is_the_fused_window_without_chunks(env):
    """``make_decode_window`` ≡ ``make_prefill_decode_window`` with ``rem =
    0``: tokens, words, next token and position, caches."""
    _, cfg, _, _, model = env
    rng = np.random.default_rng(10)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, 3).astype(np.int32))
    pos = torch.tensor([0, 5, 20], dtype=torch.int32)
    a, b = model.init_cache(3, 24), model.init_cache(3, 24)
    out_a = make_decode_window(model, window=K)(a, tokens, pos)
    out_b = make_prefill_decode_window(model, window=K)(
        b, tokens, pos, torch.zeros((K, 3), dtype=torch.int32),
        torch.zeros(3, dtype=torch.int32))
    for x, y in zip(out_a, out_b):
        assert torch.equal(x, y)
    for name in a:
        assert torch.equal(a[name], b[name]), name


def test_decode_step_word_folds_the_batch(env):
    """``make_decode_step``'s one word: NONFINITE_LOSS when any row's logits
    go non-finite (with STATE_FAULT where a recurrent state does too)."""
    _, cfg, _, _, model = env
    step = make_decode_step(model)
    cache = model.init_cache(2, 8)
    tok = torch.tensor([[1], [2]], dtype=torch.int32)
    logits, word = step(cache, tok, 0)
    assert logits.shape == (2, 1, cfg.vocab_size) and int(word) == 0
    leaf = (model.state_leaves or ("k" if "k" in cache else "k_ring",))[0]
    slot_layer_view(cache, leaf)[1] = float("nan")
    _, word = step(cache, tok, 1)
    want = ErrorCode.NONFINITE_LOSS | (ErrorCode.STATE_FAULT if model.state_leaves else 0)
    assert int(word) == int(want)


def test_insert_cache_slot_copies_whole_rows(env):
    """Row ``row`` of every leaf of the rebuilt cache lands in batch row
    ``slot`` of the live caches, over the whole capacity, in both the
    (layer, batch) and the (batch, layer) layouts; other rows are
    untouched."""
    _, cfg, _, _, model = env
    full, one = model.init_cache(3, 20), model.init_cache(3, 20)
    for i, t in enumerate(one.values()):
        t.copy_(torch.arange(t.numel(), dtype=torch.float32).view(t.shape) + i)
    for t in full.values():
        t.fill_(-1.0)
    insert_cache_slot(full, one, 2, 1)
    for name in full:
        got, src = slot_layer_view(full, name), slot_layer_view(one, name)
        assert torch.equal(got[2], src[1].to(got.dtype)), name
        assert (got[:2] == -1).all(), name


# ----------------------------------------------------------- EngineConfig
GRID = [dict(window=w, overlap=o, paged=p, speculate=s, tp=t)
        for w, o, p, s, t in itertools.product((0, 4), (False, True),
                                               (False, True), (False, True), (1, 2))]
GRID += [dict(num_slots=0), dict(max_len=0), dict(max_request_retries=-1),
         dict(window=-1), dict(prefill_budget=0), dict(tp=0)]
# the page fields: their limits, with and without paging and a window
GRID += [dict(paged=p, window=w, **f) for p, w in ((True, 4), (True, 0), (False, 0))
         for f in (dict(page_size=0), dict(page_size=1), dict(page_size=16),
                   dict(page_budget=0), dict(page_budget=1), dict(page_budget=64),
                   dict(page_watermark=-1), dict(page_watermark=0),
                   dict(page_watermark=3))]
PAGE_FIELDS = ("page_size", "page_budget", "page_watermark")
# the draft fields: their limits, with and without speculation and a window
GRID += [dict(speculate=s, window=w, overlap=o, **f)
         for s, w, o in ((True, 4, True), (True, 4, False), (True, 0, True),
                         (False, 0, True))
         for f in (dict(draft_len=0), dict(draft_len=1), dict(draft_len=5),
                   dict(draft_layers=0), dict(draft_layers=1),
                   dict(draft_layers=3), dict(draft_len=2, draft_layers=2))]
DRAFT_FIELDS = ("draft_len", "draft_layers")


@pytest.mark.parametrize("fields", GRID, ids=lambda f: ",".join(
    f"{k}={int(v)}" for k, v in f.items()))
def test_engine_config_parity(fields):
    """Each combination is accepted by both packages, or refused by both
    with ``ValueError`` (the same message for a page or draft field); the
    defaults are the same — ``EngineConfig()`` is the stepwise engine in
    both."""
    def outcome(cls):
        try:
            cls(**fields)
        except ValueError as exc:
            return ("refused", str(exc) if (
                set(fields) & set(PAGE_FIELDS) and "page" in str(exc)
                or set(fields) & set(DRAFT_FIELDS) and "draft" in str(exc))
                else "")
        return ("accepted", "")

    assert outcome(EngineConfig) == outcome(JaxEngineConfig)
    assert EngineConfig().window == JaxEngineConfig().window == 0
    for name in PAGE_FIELDS + DRAFT_FIELDS:
        assert getattr(EngineConfig(), name) == getattr(JaxEngineConfig(), name)
