"""The port's speculative decode windows (``Replica(EngineConfig(window=K,
overlap=True, speculate=True))``) against the JAX package's, on the smoke
qwen3-1.7b (2 layers, d_model 64, 4/2 heads of 16, float32) with the JAX
weights carried over by the bridge, and against the port's own contracts:

* ``attention_verify``, ``verify_step`` and ``draft_chain`` match the JAX
  functions (tolerance 1e-4 absolute, as ``test_torch_model.py``: both
  sides compute in float32 and differ only in reduction order); a verify
  crossing the capacity drops the rows at or past it and leaves the last
  in-range entry as that row wrote it;
* ``verify_step`` row t is bit-equal to the port's ``decode_step`` at
  ``pos + t`` (logits and the K/V it leaves);
* the speculative window's ``(tokens, counts, words, next_pos)`` equal the
  JAX window's, contiguous and paged (the argmaxes are exact: the inputs'
  top-2 logit gaps are far above the 1e-4 the two sides differ by);
* the cases of ``tests/test_serve_spec.py``: the spec replica equals the
  port's overlap replica bit for bit (steady, under LFLR, paged); EOS
  inside an accepted run; a deadline mid-window; the commit accounting;
  DRAFT_REJECT masked from the raising word without cutting the clean
  prefix; no stale draft committed after a real fault; the acceptance
  metrics; the host-sync budget — each also held to a live JAX spec
  replica's streams, fault records and draft counters on the same traffic.

The JAX spec replicas share their jitted window functions per layout, so
each compiles once for the module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.paging import PagedLayout as JaxLayout
from repro.launch.steps import make_speculative_decode_window as jax_spec_window
from repro.models.attention import attention_verify as jax_attention_verify
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import Replica as JaxReplica
from repro.serve import Request as JaxRequest
from repro_torch.configs import smoke_config
from repro_torch.core.device_channel import DeviceFuture, readback
from repro_torch.core.errors import ATTRIBUTION_ONLY, ErrorCode
from repro_torch.kernels.flash_attention import flash_attention, sdpa_ref
from repro_torch.launch.paging import PagedLayout
from repro_torch.launch.steps import make_speculative_decode_window
from repro_torch.models import Model
from repro_torch.serve import (EXPIRED, OK, EngineConfig, Replica, Request,
                               ServeMetrics)
from repro_torch.serve.replica import window_enum
from repro_torch.weights import cache_from_jax, cache_to_numpy
from test_torch_paging import _to_port
from test_torch_serve import _assert_streams_match, _env

torch.set_num_threads(2)

ARCH = "qwen3-1.7b"
TOL = 1e-4
MAX_LEN = 64
D = 3                   # draft_len, as tests/test_serve_spec.py
K = 8
PAGE = 16
REJECT = int(ErrorCode.DRAFT_REJECT)
NF = int(ErrorCode.NONFINITE_LOSS)
CACHE_SCALE = 2.0        # random caches: enough spread that drafts miss



_JAX_FNS: dict = {}


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=TOL, atol=TOL)


def _waited(fn):
    """``fn`` returning once its outputs are computed: on the CPU the JAX
    replica's ``jnp.asarray`` of its host page table aliases the numpy
    array, and a window still running when the host edits the table would
    read the edit (``test_torch_paged_serve.py``)."""
    return lambda *args: jax.block_until_ready(fn(*args))


def _jax_layout(jcfg, jmodel, num_slots=2):
    return JaxLayout(jmodel.init_cache(1, MAX_LEN), MAX_LEN, page_size=PAGE,
                     num_pages=num_slots * MAX_LEN // PAGE)


def _jax_fns(paged: bool) -> dict:
    """The jitted window (and layout) a JAX spec replica of the suite runs,
    built once per layout."""
    if paged not in _JAX_FNS:
        jcfg, _, jmodel, _, _ = _env(ARCH)
        layout = _jax_layout(jcfg, jmodel) if paged else None
        fn = jax_spec_window(jcfg, window=K, draft_len=D, draft_layers=1,
                             paged=layout)
        _JAX_FNS[paged] = (dict(window_fn=_waited(fn), paged_layout=layout)
                           if paged else dict(window_fn=fn))
    return _JAX_FNS[paged]


def _conf(speculate, **kw):
    conf = dict(num_slots=2, max_len=MAX_LEN, max_request_retries=6,
                window=K, overlap=True)
    conf.update(kw)
    if speculate:
        conf.update(speculate=True, draft_len=D, draft_layers=1)
    return conf


def _replica(speculate, **kw):
    _, cfg, _, _, model = _env(ARCH)
    conf = {k: kw.pop(k) for k in list(kw) if k in EngineConfig.__dataclass_fields__}
    return Replica(cfg, model, config=EngineConfig(**_conf(speculate, **conf)), **kw)


def _jax_replica(**kw):
    jcfg, _, _, params, _ = _env(ARCH)
    conf = {k: kw.pop(k) for k in list(kw) if k in JaxEngineConfig.__dataclass_fields__}
    return JaxReplica(jcfg, params=params,
                      config=JaxEngineConfig(**_conf(True, **conf)),
                      **_jax_fns(bool(conf.get("paged"))), **kw)


def _requests(request_cls, n, max_new=16, prompt_len=9):
    return [request_cls(id=i, prompt=tuple(5 + i + j for j in range(prompt_len)),
                        max_new_tokens=max_new) for i in range(n)]


def _serve_all(rep, reqs, inject_first_eligible=False):
    """``tests/test_serve_spec.py``'s serving loop: serve ``reqs``; with
    ``inject_first_eligible``, poison the first decoding lane once."""
    for r in reqs:
        assert rep.submit(r) is None
    out, steps, injected = {}, 0, 0
    while not rep.idle():
        if inject_first_eligible and not injected:
            # a *decoding* lane: a fresh chunk lane's reset would wipe the
            # injection before any window reads it
            eligible = [i for i in rep.sched.active_slots()
                        if rep.sched.slots[i].pending is None]
            if eligible and rep.inject_state_fault(eligible[0]) is not None:
                injected += 1
        for resp in rep.step():
            out[resp.id] = resp
        steps += 1
        assert steps < 2000
    if inject_first_eligible:
        assert injected == 1, "fault injection never found a decoding lane"
    return out


def _tokens(out):
    return {i: r.tokens for i, r in out.items()}


def _records(rep):
    return [(f.step, f.code, f.action, f.slots) for f in rep.metrics.faults]


def _spec_counts(rep):
    m = rep.metrics
    return m.draft_tokens, m.accepted_draft_tokens, dict(m._spec_per_slot)


def _check_against_jax(got, rep, n, *, request_kw=None, inject=False, **kw):
    """A JAX spec replica of the same engine on the same traffic: streams by
    the parity criteria (``test_torch_serve.py``: equal except where the
    reference's top-2 logit gap is below the tolerance), and where the
    streams are equal, so are the schedules: the same fault records,
    statuses, retries and draft counters."""
    request_kw = request_kw or {}
    jrep = _jax_replica(**kw)
    ref = _serve_all(jrep, _requests(JaxRequest, n, **request_kw), inject)
    traffic = [(r.prompt, r.max_new_tokens)
               for r in _requests(Request, n, **request_kw)]
    if all(r.status == OK for r in ref.values()):
        _assert_streams_match(_env(ARCH), ref, got, traffic)
    if _tokens(ref) == _tokens(got):
        assert _records(rep) == _records(jrep)
        assert {i: (r.status, r.retries) for i, r in got.items()} == {
            i: (r.status, r.retries) for i, r in ref.items()}
        assert _spec_counts(rep) == _spec_counts(jrep)
    return jrep


# ------------------------------------------------------------ the functions
def _layer0(params):
    return jax.tree_util.tree_map(lambda a: a[0],
                                  params["stack"]["periods"]["b0"])


@pytest.mark.parametrize("pos", [5, MAX_LEN - 2], ids=["inside", "crossing"])
def test_attention_verify_matches_jax(pos):
    """T = 4 rows over a random cache: outputs and the written cache against
    the JAX ``attention_verify``. Crossing: rows at cap - 2 and cap - 1 are
    written, the two past the capacity dropped, and entry cap - 1 holds the
    row that sits there."""
    from repro_torch.models.attention import attention_verify
    _, cfg, _, params, model = _env(ARCH)
    T, B, hd = 4, 2, cfg.resolved_head_dim
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    kv = {n: rng.standard_normal((B, MAX_LEN, cfg.num_kv_heads, hd)).astype(np.float32)
          for n in ("k", "v")}
    want, jcache = jax_attention_verify(_layer0(params)["attn"], jnp.asarray(x),
                                        {n: jnp.asarray(a) for n, a in kv.items()},
                                        jnp.int32(pos), cfg)
    k, v = (torch.from_numpy(kv[n].copy()) for n in ("k", "v"))
    p = torch.full((B,), pos, dtype=torch.int32)
    ropes = [model._rope((p + t)[:, None]) for t in range(T)]
    out = attention_verify(model.blocks[0].attn,
                           [torch.from_numpy(x[:, t:t + 1]) for t in range(T)],
                           k, v, p, ropes, cfg)
    _close(torch.cat(out, dim=1).numpy(), want)
    _close(k.numpy(), jcache["k"])
    _close(v.numpy(), jcache["v"])
    written = min(T, MAX_LEN - pos)
    untouched = np.ones(MAX_LEN, bool)
    untouched[pos:pos + written] = False
    assert np.array_equal(k.numpy()[:, untouched], kv["k"][:, untouched])
    assert not np.allclose(k.numpy()[:, pos:pos + written], kv["k"][:, pos:pos + written])
    if written < T:
        # the last in-range entry is the row at cap - 1, not a dropped one
        assert written == 2
        row = [torch.from_numpy(x[:, t:t + 1]) for t in range(T)]
        k2, v2 = (torch.from_numpy(kv[n].copy()) for n in ("k", "v"))
        attention_verify(model.blocks[0].attn, row[:2], k2, v2, p, ropes[:2], cfg)
        assert torch.equal(k[:, MAX_LEN - 1], k2[:, MAX_LEN - 1])
        assert torch.equal(v[:, MAX_LEN - 1], v2[:, MAX_LEN - 1])


def _filled_caches(n_pre=6, B=2):
    """JAX and port caches after ``n_pre`` decode steps of the same tokens."""
    jcfg, cfg, jmodel, params, model = _env(ARCH)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (B, n_pre)).astype(np.int32)
    jcache = jmodel.init_cache(B, MAX_LEN)
    for p in range(n_pre):
        _, jcache = jmodel.decode_step(params, jnp.asarray(toks[:, p:p + 1]),
                                       jcache, p)
    return jcache, cache_from_jax(jax.device_get(jcache), cfg, device="cpu")


@pytest.mark.parametrize("pos", [6, MAX_LEN - 2], ids=["inside", "crossing"])
def test_verify_step_matches_jax(pos):
    """fp32 logits (B, T, V) and the cache against the JAX ``verify_step``."""
    _, cfg, jmodel, params, model = _env(ARCH)
    jcache, cache = _filled_caches()
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, D + 1)).astype(np.int32)
    want, jcache = jmodel.verify_step(params, jnp.asarray(toks), jcache, jnp.int32(pos))
    got = model.verify_step(torch.from_numpy(toks), cache, pos)
    assert got.dtype == torch.float32 and got.shape == (2, D + 1, cfg.vocab_size)
    _close(got.numpy(), want)
    for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(jcache)),
                    jax.tree_util.tree_leaves(cache_to_numpy(cache, cfg))):
        _close(b, a)


@pytest.mark.parametrize("forced", [0, 2], ids=["free", "override"])
def test_draft_chain_matches_jax(forced):
    """D proposals from the first layer (and the cache it leaves), free or
    with the first proposals forced from ``override``."""
    _, cfg, jmodel, params, model = _env(ARCH)
    jcache, cache = _filled_caches()
    rng = np.random.default_rng(7)
    tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    override = rng.integers(0, cfg.vocab_size, (D,)).astype(np.int32)
    want, jcache = jmodel.draft_chain(
        params, jnp.asarray(tok), jcache, jnp.int32(6), draft_layers=1,
        draft_len=D, override=jnp.asarray(override), n_forced=jnp.int32(forced))
    got = model.draft_chain(
        torch.from_numpy(tok), cache, 6, draft_layers=1, draft_len=D,
        override=torch.from_numpy(np.stack([override, override])),
        n_forced=torch.full((2,), forced, dtype=torch.int32))
    assert got.dtype == torch.int32
    assert got.numpy().tolist() == np.asarray(want).tolist()
    if forced:
        assert got[:, :forced - 1].tolist() == [list(override[:forced - 1])] * 2
    for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(jcache)),
                    jax.tree_util.tree_leaves(cache_to_numpy(cache, cfg))):
        _close(b, a)


def test_verify_rows_bit_equal_decode():
    """Row t of ``verify_step`` is bit-equal to ``decode_step`` at ``pos +
    t`` after the rows before it, at mixed per-slot positions (the K/V it
    leaves too); slot 2 runs past the capacity, where the verify drops what
    the decode's clamp writes, so only its rows inside it are held."""
    _, cfg, _, _, model = _env(ARCH)
    rng = np.random.default_rng(8)
    S, T = 3, D + 1
    a = model.init_cache(S, MAX_LEN)
    pre = torch.from_numpy(rng.integers(0, cfg.vocab_size, (S, 7)))
    for p in range(7):
        model.decode_step(pre[:, p:p + 1], a, p)
    b = {n: t.clone() for n, t in a.items()}
    pos = torch.tensor([7, 30, MAX_LEN - 2], dtype=torch.int32)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (S, T)))
    got = model.verify_step(toks, a, pos)
    want = torch.cat([model.decode_step(toks[:, t:t + 1], b, pos + t)
                      for t in range(T)], dim=1)
    assert torch.equal(got[:2], want[:2])
    assert torch.equal(got[2, :2], want[2, :2])
    for n in a:
        assert torch.equal(a[n][:, :2], b[n][:, :2]), n
        assert torch.equal(a[n][:, 2, :MAX_LEN - 1], b[n][:, 2, :MAX_LEN - 1]), n


def test_flash_verify_plain_path_rows():
    """On the CPU the verify route is the plain version row by row (its
    einsum rounds otherwise with S rows), within float tolerance of one
    ``sdpa_ref`` over the S rows; a verify with a window is refused."""
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((2, 4, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 20, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 20, 2, 16)).astype(np.float32))
    off = torch.tensor([3, 17], dtype=torch.int32)
    got = flash_attention(q, k, v, off, causal=True, seq_kv=20, verify=True)
    rows = torch.cat([flash_attention(q[:, t:t + 1].contiguous(), k, v, off + t,
                                      causal=True, seq_kv=20) for t in range(4)], dim=1)
    assert torch.equal(got, rows)
    _close(got.numpy(), sdpa_ref(q, k, v, q_offset=off, causal=True, seq_kv=20).numpy())
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, off, causal=True, window=4, verify=True)


def _window_inputs(cfg, rng, S=3):
    toks = rng.integers(0, cfg.vocab_size, S).astype(np.int32)
    pos = np.asarray([0, 21, MAX_LEN - 5], np.int32)[:S]
    chunk = rng.integers(0, cfg.vocab_size, (K, D + 1, S)).astype(np.int32)
    rem = np.asarray([10, 0, 3], np.int32)[:S]      # prompt feed, no feed, flip
    return toks, pos, chunk, rem


def _random_slot_tree(jmodel, rng, S=3):
    shapes = jax.tree_util.tree_map(lambda s: s.shape,
                                    jmodel.cache_shapes(1, MAX_LEN))
    return jax.tree_util.tree_map(
        lambda shape: (CACHE_SCALE * rng.standard_normal((S, *shape))).astype(np.float32),
        shapes, is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_spec_window_matches_jax(paged):
    """One speculative window (K 8, D 3) over random slot caches, with a
    prompt feed across steps, a lane with none, a lane flipping in its first
    step and a lane running past the capacity: ``(tokens, counts, words,
    next_tok, next_pos)`` equal the JAX window's, the caches within the
    tolerance. Paged: one slot's table maps only its first two pages, so
    the page probe latches PAGE_FAULT past them, as in the JAX window."""
    jcfg, cfg, jmodel, params, model = _env(ARCH)
    rng = np.random.default_rng(10)
    toks, pos, chunk, rem = _window_inputs(cfg, rng)
    tree = _random_slot_tree(jmodel, rng)
    args = (jnp.asarray(toks)[:, None, None], jnp.asarray(pos),
            jnp.asarray(chunk), jnp.asarray(rem))
    port_args = tuple(torch.from_numpy(a) for a in (toks, pos, chunk, rem))
    if paged:
        jlayout = _jax_layout(jcfg, jmodel, num_slots=3)
        layout = PagedLayout(model.init_cache(1, MAX_LEN), MAX_LEN, page_size=PAGE,
                             num_pages=3 * MAX_LEN // PAGE)
        jcaches = jax.tree_util.tree_map(
            lambda x: jnp.asarray((CACHE_SCALE * rng.standard_normal(x.shape)).astype(np.float32)),
            jlayout.init_hybrid(jmodel.init_cache(1, MAX_LEN), 3))
        caches = _to_port(jcaches, cfg, layout)
        table = np.arange(3 * layout.max_pages, dtype=np.int32).reshape(3, -1)
        table[1, 2:] = layout.sentinel
        fn = jax_spec_window(jcfg, window=K, draft_len=D, draft_layers=1,
                             donate=False, paged=jlayout)
        want = fn(params, jcaches, *args, jnp.asarray(table))
        got = make_speculative_decode_window(
            model, window=K, draft_len=D, draft_layers=1, paged=layout)(
                caches, *port_args, torch.from_numpy(table))
        want_caches = _to_port(want[5], cfg, layout)
        assert (np.asarray(want[2]) & int(ErrorCode.PAGE_FAULT)).any()
    else:
        jcaches = jax.tree_util.tree_map(jnp.asarray, tree)
        caches = cache_from_jax(tree, cfg, slots=True, device="cpu")
        fn = jax_spec_window(jcfg, window=K, draft_len=D, draft_layers=1,
                             donate=False)
        want = fn(params, jcaches, *args)
        got = make_speculative_decode_window(model, window=K, draft_len=D,
                                             draft_layers=1)(caches, *port_args)
        want_caches = cache_from_jax(jax.device_get(want[5]), cfg, slots=True,
                                     device="cpu")
    g_toks, g_counts, g_words, g_next, g_pos = got
    assert g_toks.shape == (K, 3, D + 1) and g_counts.shape == (K, 3)
    assert g_toks.tolist() == np.asarray(want[0]).tolist()
    assert g_counts.tolist() == np.asarray(want[1]).tolist()
    assert g_words.numpy().astype(np.uint32).tolist() == np.asarray(want[2]).tolist()
    assert g_next.tolist() == np.asarray(want[3])[:, 0, 0].tolist()
    assert g_pos.tolist() == np.asarray(want[4]).tolist()
    # the lane fed past its draft rows, and a miss somewhere: both paths ran
    assert (g_words.numpy() & REJECT).any() and (g_counts.numpy() > 1).any()
    for name in caches:
        got_leaf, want_leaf = caches[name], want_caches[name]
        if paged and layout.is_paged_path(name):
            # the port's zero page stays zeros; its sink (writes through
            # unmapped entries) has no JAX counterpart, which drops them
            assert not got_leaf[:, layout.sentinel].any(), name
            got_leaf = got_leaf[:, :layout.num_pages]
            want_leaf = want_leaf[:, :layout.num_pages]
        _close(got_leaf.numpy(), want_leaf.numpy())


# -------------------------------------------------------------- bit-exactness
def test_spec_bit_exact_steady():
    """Every emitted token is a full-model argmax, so draft and verify are
    invisible in the stream — including the backfill chains of 5 requests
    over 2 slots; the JAX spec replica agrees."""
    base = _serve_all(_replica(False), _requests(Request, 5))
    rep = _replica(True)
    got = _serve_all(rep, _requests(Request, 5))
    assert sorted(got) == sorted(base)
    for i in base:
        assert got[i].status == OK
        assert got[i].tokens == base[i].tokens, i
    assert rep.metrics.host_stalls == 0
    assert rep.metrics.windows > 0
    _check_against_jax(got, rep, 5)


def test_spec_bit_exact_faulted_lflr():
    """A real fault mid-speculation recovers through LFLR bit-exactly: the
    streams equal the overlap engine's under the same injection, and the
    fault surfaces as a real class, never DRAFT_REJECT."""
    base = _serve_all(_replica(False), _requests(Request, 5),
                      inject_first_eligible=True)
    rep = _replica(True)
    got = _serve_all(rep, _requests(Request, 5), inject_first_eligible=True)
    for i in base:
        assert got[i].status == OK
        assert got[i].tokens == base[i].tokens, i
    counts = rep.metrics.fault_counts()
    assert counts, "injected fault was never detected"
    assert "DRAFT_REJECT" not in counts
    _check_against_jax(got, rep, 5, inject=True)


@pytest.mark.parametrize("inject", [False, True], ids=["steady", "faulted"])
def test_spec_paged_bit_exact(inject):
    """Speculation over the page pool: the overlap engine's streams, every
    page back at drain, the ledger consistent; the JAX paged spec replica
    agrees."""
    base = _serve_all(_replica(False), _requests(Request, 5),
                      inject_first_eligible=inject)
    rep = _replica(True, paged=True, page_size=PAGE)
    got = _serve_all(rep, _requests(Request, 5), inject_first_eligible=inject)
    for i in base:
        assert got[i].tokens == base[i].tokens, (inject, i)
    rep.alloc.check()
    assert rep.metrics.pages_allocated == rep.metrics.pages_freed > 0
    jrep = _check_against_jax(got, rep, 5, inject=inject, paged=True,
                              page_size=PAGE)
    jrep.alloc.check()


# --------------------------------------------------------- variable commit
def test_eos_inside_accepted_draft_run():
    """A request whose EOS lands inside an accepted draft run stops at the
    same token as in the plain engine (commit_block checks token by
    token), and the accepts after it are discarded, not committed."""
    probe = _serve_all(_replica(False), _requests(Request, 2, max_new=24))
    stream = probe[0].tokens
    eos = int(stream[min(5, len(stream) - 2)])
    base = _serve_all(_replica(False, eos_id=eos), _requests(Request, 2, max_new=24))
    rep = _replica(True, eos_id=eos)
    got = _serve_all(rep, _requests(Request, 2, max_new=24))
    for i in base:
        assert got[i].tokens == base[i].tokens, i
        assert got[i].status == base[i].status == OK
    assert any(len(r.tokens) < 24 for r in got.values())
    assert rep.metrics.discarded_tokens > 0
    _check_against_jax(got, rep, 2, request_kw=dict(max_new=24), eos_id=eos)


def test_deadline_expiry_mid_window():
    """A deadline passing mid-window evicts the lane at the window boundary;
    its emitted block is discarded, the other lanes are unaffected, and the
    expired request is answered EXPIRED — as in the JAX spec replica."""
    t = {"now": 0.0}
    clock = lambda: t["now"]  # noqa: E731
    rep = _replica(True, clock=clock)
    got = {}
    doomed = Request(id=99, prompt=(7, 8, 9), max_new_tokens=40, deadline=2.0)
    for r in [doomed] + _requests(Request, 2, max_new=40):
        assert rep.submit(r) is None
    steps = 0
    while not rep.idle():
        t["now"] += 1.0
        for resp in rep.step():
            got[resp.id] = resp
        steps += 1
        assert steps < 2000
    assert got[99].status == EXPIRED
    assert "mid-decode" in got[99].detail
    assert len(got[99].tokens) < 40
    assert got[0].status == OK and got[1].status == OK
    assert len(got[0].tokens) == 40 and len(got[1].tokens) == 40
    tj = {"now": 0.0}
    jrep = _jax_replica(clock=lambda: tj["now"])
    ref = {}
    for r in [JaxRequest(id=99, prompt=(7, 8, 9), max_new_tokens=40, deadline=2.0)] + \
            _requests(JaxRequest, 2, max_new=40):
        assert jrep.submit(r) is None
    while not jrep.idle():
        tj["now"] += 1.0
        for resp in jrep.step():
            ref[resp.id] = resp
    assert {i: r.status for i, r in got.items()} == {i: r.status for i, r in ref.items()}
    assert got[99].tokens == ref[99].tokens
    assert _tokens(got) == _tokens(ref)


def test_variable_commit_accounting():
    """Committed tokens equal the sum of the streams, every window step
    counts K steps, and tokens per dispatched step beat the plain engine's
    at the same slot count on the same traffic."""
    plain = _replica(False)
    _serve_all(plain, _requests(Request, 4, max_new=12))
    rep = _replica(True)
    got = _serve_all(rep, _requests(Request, 4, max_new=12))
    m = rep.metrics
    assert m.decode_tokens == sum(len(r.tokens) for r in got.values())
    assert m.decode_steps == m.windows * K
    assert m.discarded_tokens >= 0
    assert m.tokens_per_step() > plain.metrics.tokens_per_step()
    jrep = _check_against_jax(got, rep, 4, request_kw=dict(max_new=12))
    jm = jrep.metrics
    assert (m.decode_tokens, m.decode_steps, m.windows, m.discarded_tokens) == (
        jm.decode_tokens, jm.decode_steps, jm.windows, jm.discarded_tokens)


# ------------------------------------------------- DRAFT_REJECT attribution
def test_draft_reject_is_masked_from_fault_word():
    """A window whose only events are speculation misses waits clean: the
    enumeration strips DRAFT_REJECT from the combined word and the table,
    and the history keeps it for attribution."""
    hist = torch.zeros((K, 2), dtype=torch.int32)
    hist[3, 1] = REJECT
    combined, count, table, out_hist = window_enum(
        hist, torch.ones(2, dtype=torch.int32), REJECT)
    assert int(combined) == 0 and int(count) == 0
    assert int(out_hist[3, 1]) == REJECT
    fut = DeviceFuture(outputs="ok", word=combined, count=count, table=table,
                       history=out_hist)
    assert fut.wait() == "ok"              # never raises: attribution only
    assert list(fut.fault_steps(ignore=int(ATTRIBUTION_ONLY))) == [-1, -1]
    assert list(fut.fault_steps()) == [-1, 3]
    assert int(fut.fault_codes()[1]) == REJECT


def test_draft_reject_does_not_truncate_clean_prefix():
    """A real fault behind rejected drafts: the committable prefix runs up
    to the fault step, not to the first speculation miss."""
    hist = torch.zeros((K, 1), dtype=torch.int32)
    hist[1, 0] = REJECT
    hist[5, 0] = NF | REJECT
    combined, count, table, out_hist = window_enum(
        hist, torch.ones(1, dtype=torch.int32), REJECT)
    assert int(combined) == NF
    fut = DeviceFuture(outputs=None, word=combined, count=count, table=table,
                       history=out_hist)
    assert list(fut.fault_steps(ignore=REJECT)) == [5]
    assert int(fut.fault_codes(ignore=REJECT)[0]) == NF


def test_spec_steady_run_never_recovers():
    """Steady speculative traffic consumes no retry and records no fault:
    rejected drafts are expected events, not errors."""
    rep = _replica(True)
    got = _serve_all(rep, _requests(Request, 4, max_new=16))
    assert rep.metrics.faults == []
    assert sum(r.retries for r in got.values()) == 0
    assert rep.metrics.draft_tokens > rep.metrics.accepted_draft_tokens > 0
    _check_against_jax(got, rep, 4)


def test_real_fault_commits_no_stale_draft_tokens():
    """Tokens from the faulted step on never commit: after LFLR the replayed
    stream is the deterministic greedy one, so every stream equals the clean
    one — a stale draft token would break the equality."""
    clean = _serve_all(_replica(False), _requests(Request, 3))
    rep = _replica(True)
    got = _serve_all(rep, _requests(Request, 3), inject_first_eligible=True)
    for i in clean:
        assert got[i].tokens == clean[i].tokens, i
    assert len(rep.metrics.faults) == 1
    _check_against_jax(got, rep, 3, inject=True)


# ------------------------------------------------------------------- metrics
def test_acceptance_rate_metrics():
    rep = _replica(True)
    got = _serve_all(rep, _requests(Request, 4, max_new=16))
    m = rep.metrics
    assert m.draft_tokens > 0
    assert 0 <= m.accepted_draft_tokens <= m.draft_tokens
    assert 0.0 < m.acceptance_rate() <= 1.0
    assert m.acceptance_rate() == m.accepted_draft_tokens / m.draft_tokens
    per_slot = m.acceptance_rate_per_slot()
    assert per_slot and set(per_slot) <= {0, 1}
    assert all(0.0 <= v <= 1.0 for v in per_slot.values())
    # the global counters equal the per-slot cells they were recorded from
    cells = m._spec_per_slot
    assert m.draft_tokens == sum(d for d, _ in cells.values())
    assert m.accepted_draft_tokens == sum(a for _, a in cells.values())
    assert m.accepted_draft_tokens <= m.decode_tokens + m.discarded_tokens
    s = m.summary()
    for key in ("draft_tokens", "accepted_draft_tokens",
                "rejected_draft_tokens", "acceptance_rate",
                "acceptance_rate_per_slot", "tokens_per_step"):
        assert key in s
    assert s["rejected_draft_tokens"] == m.draft_tokens - m.accepted_draft_tokens
    _check_against_jax(got, rep, 4)
    merged = ServeMetrics.merged([m, rep.metrics])
    assert merged.draft_tokens == 2 * m.draft_tokens
    assert merged.accepted_draft_tokens == 2 * m.accepted_draft_tokens
    assert merged.acceptance_rate() == m.acceptance_rate()
    assert merged.decode_tokens == 2 * m.decode_tokens
    assert len(merged.responses) == 2 * len(m.responses)


# ---------------------------------------------------------- host-sync budget
def test_host_sync_budget():
    """Speculation adds no per-token host traffic: the accepted counts ride
    the one block readback a window, so syncs stay 2 per window plus the
    budget's slack — O(steps / K), not O(tokens)."""
    rep = _replica(True)
    before = readback.count
    out = _serve_all(rep, _requests(Request, 6, max_new=16))
    syncs = readback.count - before
    assert all(r.status == OK for r in out.values())
    m = rep.metrics
    assert m.prefills == 0 and m.host_stalls == 0
    assert syncs <= 2 * m.windows + 4, (syncs, m.windows)
    # multi-token commits: far fewer windows than committed tokens / K
    assert m.windows * K < m.decode_tokens * 0.9


# ------------------------------------------------------------ configuration
def test_spec_validation():
    """The reference's refusals: speculation needs windows, overlap, a pure
    full-attention stack, a drafter shallower than the model and a draft
    length of at least 1."""
    _, cfg, _, _, model = _env(ARCH)
    with pytest.raises(ValueError, match="window"):
        Replica(cfg, model, config=EngineConfig(speculate=True, window=0))
    with pytest.raises(ValueError, match="overlap"):
        Replica(cfg, model, config=EngineConfig(speculate=True, window=8,
                                                overlap=False))
    with pytest.raises(ValueError, match="draft_layers"):
        make_speculative_decode_window(model, window=8, draft_len=2,
                                       draft_layers=cfg.num_layers)
    with pytest.raises(ValueError, match="draft_len"):
        make_speculative_decode_window(model, window=8, draft_len=0,
                                       draft_layers=1)
    for arch in ("recurrentgemma-2b", "gemma3-1b", "mamba2-2.7b"):
        other = Model(smoke_config(arch), device="cpu", seed=0)
        assert not other.supports_speculation()
        with pytest.raises(ValueError, match="full-attention"):
            make_speculative_decode_window(other, window=8, draft_len=2,
                                           draft_layers=1)
        with pytest.raises(ValueError, match="full-attention"):
            Replica(other.cfg, other, config=EngineConfig(window=8, speculate=True))
    assert model.supports_speculation()
