"""The port's paged engine (``Replica(EngineConfig(window=K, paged=True))``)
on the cases of ``tests/test_serve_paged.py``, each beside a live JAX paged
replica on the same smoke config, weights (``params_from_jax``) and
traffic (float32):

* paged ≡ contiguous in the port, bit for bit, steady and with an LFLR
  fault, in both window modes (overlapped and blocking prefill); and the
  port's paged streams, fault records and page ledger agree with the JAX
  paged replica's (streams by ROADMAP's parity criteria: equal except
  where the reference's top-2 logit gap is below the logits tolerance);
* the paged chunked-prefill chain ≡ the contiguous cache prefill;
* LFLR page reclaim leaves the co-slot's pages where they were;
* pool exhaustion preempts the oldest lane and drops no request; the
  scrub survives ids recycled within one window's preparation; the
  watermark gates admission; a pool smaller than ``max_len`` cannot
  livelock; a request larger than the pool is rejected at submit;
* a corrupted page table raises ``PAGE_FAULT`` at the same ``(step,
  slot)`` as in the JAX replica, with a ``page_reclaim`` record;
* mamba2 (nothing to page) degrades to the contiguous engine with an idle
  ledger; gemma3 at ``max_len`` <= its window pages its rings too.

The JAX replicas share their jitted functions per configuration, so each
compiles once for the module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.paging import PagedLayout as JaxLayout
from repro.launch.steps import make_cache_prefill as jax_cache_prefill
from repro.launch.steps import make_chunked_prefill as jax_chunked_prefill
from repro.launch.steps import make_decode_window as jax_decode_window
from repro.launch.steps import make_prefill_decode_window as jax_prefill_window
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import Replica as JaxReplica
from repro.serve import Request as JaxRequest
from repro.serve.replica import SERVE_PROBES
from repro_torch.core.device_channel import readback
from repro_torch.core.errors import ErrorCode
from repro_torch.launch.paging import PagedLayout, pages_for
from repro_torch.launch.steps import make_cache_prefill, make_chunked_prefill
from repro_torch.models.model import slot_layer_view
from repro_torch.serve import OK, REJECTED, EngineConfig, Replica, Request
from test_torch_serve import _assert_streams_match, _env

torch.set_num_threads(2)

K = 4
# the reference cases' engine: 2 slots, max_len 32, pages of 8 (qwen3 smoke:
# pure full attention, every K/V leaf paged)
BASE = dict(num_slots=2, max_len=32, window=K, max_request_retries=4,
            page_size=8)

_JAX_FNS: dict = {}


def _conf(**kw):
    return {**BASE, **kw}


def _waited(fn):
    """``fn`` returning only once its outputs are computed. On the CPU
    ``jnp.asarray`` of the JAX replica's host page table aliases the numpy
    array, so a window still running when the host next edits the table
    (a page freed at retirement, while the next window is queued) would
    read the edit: a spurious PAGE_FAULT, more often under load. Waiting
    for the outputs makes the reference deterministic; the port uploads a
    copy of its table instead."""
    return lambda *args: jax.block_until_ready(fn(*args))


def _jax_fns(env, conf):
    """The layout and jitted functions a JAX paged replica of ``conf`` runs,
    built once per architecture and layout."""
    jcfg, _, jmodel, _, _ = env
    key = (jcfg.name, conf["max_len"], conf["page_size"], conf.get("page_budget"),
           conf["num_slots"], conf["window"], conf.get("overlap", True))
    if key not in _JAX_FNS:
        num_pages = conf.get("page_budget") or (
            conf["num_slots"] * conf["max_len"] // conf["page_size"])
        layout = JaxLayout(jmodel.init_cache(1, conf["max_len"]), conf["max_len"],
                           page_size=conf["page_size"], num_pages=num_pages)
        make = (jax_prefill_window if conf.get("overlap", True)
                else jax_decode_window)
        _JAX_FNS[key] = dict(
            paged_layout=layout,
            window_fn=_waited(make(jcfg, SERVE_PROBES, window=conf["window"],
                                   paged=layout)),
            prefill_fn=_waited(jax_cache_prefill(jcfg, SERVE_PROBES, fused=True,
                                                 paged=layout, donate=True)))
    return _JAX_FNS[key]


def _jax_replica(env, conf, **kw):
    jcfg, _, _, params, _ = env
    return JaxReplica(jcfg, params=params,
                      config=JaxEngineConfig(paged=True, **conf),
                      **_jax_fns(env, conf), **kw)


def _port_replica(env, conf, *, paged=True, **kw):
    _, cfg, _, _, model = env
    if not paged:
        conf = {k: v for k, v in conf.items() if not k.startswith("page")}
    return Replica(cfg, model, config=EngineConfig(paged=paged, **conf), **kw)


def _traffic(n, max_new=8, prompt_len=5):
    """The reference cases' requests: prompts of ``prompt_len`` consecutive
    ids from 10 + i, as (prompt, max_new) pairs."""
    return [(tuple(10 + i + j for j in range(prompt_len)), max_new)
            for i in range(n)]


def _serve(rep, request_cls, traffic, inject_at=None, hook=None):
    """Serve ``traffic``; from cycle ``inject_at`` on, a NaN goes once into
    the first lane that is decoding and busy past the window in flight and
    the next one (``inject_state_fault``), and ``hook(rep, cycle)`` runs
    before every cycle."""
    for i, (prompt, n) in enumerate(traffic):
        assert rep.submit(request_cls(id=i, prompt=prompt, max_new_tokens=n)) is None
    out, cycles, poisoned = {}, 0, None
    while not rep.idle():
        if inject_at is not None and cycles >= inject_at and poisoned is None:
            decoding = [s.idx for s in rep.sched.slots
                        if s.active and s.pending is None and s.generated
                        and s.req.max_new_tokens - len(s.generated) > 2 * rep.window]
            if decoding:
                poisoned = rep.inject_state_fault(decoding[0])
                assert poisoned == decoding[0]
        if hook is not None:
            hook(rep, cycles)
        for resp in rep.step():
            out[resp.id] = resp
        cycles += 1
        assert cycles < 2000
    return out, poisoned


def _tokens(out):
    return {i: r.tokens for i, r in out.items()}


def _records(rep):
    return [(f.step, f.code, f.action, f.slots) for f in rep.metrics.faults]


def _pages(rep):
    m = rep.metrics
    return (m.pages_allocated, m.pages_freed, m.page_evictions, m.peak_pages_in_use)


def _check_against_jax(env, conf, traffic, got, prep, **kw):
    """The JAX paged replica on the same traffic: streams by the parity
    criteria, and — where the streams are equal, so both schedules are too
    — the same fault records, statuses, retries and page counters."""
    jrep = _jax_replica(env, conf)
    ref, _ = _serve(jrep, JaxRequest, traffic, **kw)
    _assert_streams_match(env, ref, got, traffic)
    if _tokens(ref) == _tokens(got):
        assert _records(prep) == _records(jrep)
        assert {i: r.retries for i, r in got.items()} == {
            i: r.retries for i, r in ref.items()}
        assert _pages(prep) == _pages(jrep)
    jrep.alloc.check()
    return jrep


# --------------------------------------------------------------- bit-exactness
@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "blocking"])
@pytest.mark.parametrize("inject_at", [None, 6], ids=["steady", "faulted"])
def test_paged_bit_exact_vs_contiguous(inject_at, overlap):
    """Same traffic, same injection: the port's paged streams equal its
    contiguous engine's exactly, every page is reclaimed at drain, the
    ledger is consistent; and the JAX paged replica agrees. Overlapped,
    no blocking prefill; blocking, one per request and one per fault."""
    env = _env("qwen3-1.7b")
    conf, traffic = _conf(overlap=overlap), _traffic(5, max_new=14)
    base, bslot = _serve(_port_replica(env, conf, paged=False), Request,
                         traffic, inject_at)
    rep = _port_replica(env, conf)
    got, slot = _serve(rep, Request, traffic, inject_at)
    assert slot == bslot
    assert all(r.status == OK for r in got.values())
    assert _tokens(got) == _tokens(base)
    m = rep.metrics.summary()
    faults = 0 if inject_at is None else 1
    assert (slot is None) == (inject_at is None)
    assert len(rep.metrics.faults) == faults
    assert sum(r.retries for r in got.values()) == faults
    assert m["prefills"] == m["host_stalls"] == (0 if overlap else 5 + faults)
    assert m["pages_allocated"] > 0
    assert m["pages_allocated"] == m["pages_freed"]
    rep.alloc.check()
    _check_against_jax(env, conf, traffic, got, rep, inject_at=inject_at)


def test_paged_chunked_prefill_chain_matches_contiguous():
    """Paged chunks of 4 through the pool ≡ the contiguous cache prefill:
    the same logits and word, and the slot's gathered view equals the
    contiguous cache leaf for leaf, in every row of the slots' batch
    (each holding the sequence; the one-row chain too); the logits meet
    the JAX paged chain's."""
    jcfg, cfg, jmodel, params, model = _env("qwen3-1.7b")
    max_len, page, slots, slot = 32, 8, 2, 1
    one = model.init_cache(1, max_len)
    layout = PagedLayout(one, max_len, page_size=page, num_pages=8)
    prompt = tuple(range(3, 14))
    toks = torch.tensor([prompt], dtype=torch.int32)
    table = layout.empty_table(slots)
    n_pages = pages_for(len(prompt) + 1, page)
    table[slot, :n_pages] = np.arange(2, 2 + n_pages)     # arbitrary ids
    row = torch.from_numpy(table[slot])
    chunked = make_chunked_prefill(model, chunk=4, paged=layout)
    for batch in (slots, 1):
        want_logits, want, want_word = make_cache_prefill(model)(
            toks.expand(batch, -1), max_len)
        hybrid = layout.init_hybrid(one, slots)
        for lo in range(0, len(prompt), 4):
            part = torch.zeros((batch, 4), dtype=torch.int32)
            n = min(4, len(prompt) - lo)
            part[:, :n] = toks[:, lo:lo + n]
            logits, hybrid, word = chunked(hybrid, row, slot, part, n, lo)
        assert int(word) == int(want_word) == 0
        assert torch.equal(logits, want_logits)
        view = layout.gather_slot(hybrid, row, slot)
        keep = slot if batch > 1 else 0
        for name in view:
            assert torch.equal(slot_layer_view(view, name)[0],
                               slot_layer_view(want, name)[keep]), name
    # the JAX paged chain on the same pages
    jone = jmodel.init_cache(1, max_len)
    jlayout = JaxLayout(jone, max_len, page_size=page, num_pages=8)
    jchain = jax_chunked_prefill(jcfg, SERVE_PROBES, chunk=4, paged=jlayout)
    jh = jlayout.init_hybrid(jone, slots)
    for lo in range(0, len(prompt), 4):
        part = np.zeros((1, 4), np.int32)
        n = min(4, len(prompt) - lo)
        part[0, :n] = prompt[lo:lo + n]
        jlogits, jh, jword = jchain(params, jh, jnp.asarray(table[slot]),
                                    jnp.int32(slot), part, jnp.int32(n),
                                    jnp.int32(lo))
    assert int(jword) == 0
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)


# ------------------------------------------------------- fault-scoped reclaim
def test_lflr_page_reclaim_leaves_coslot_pages_untouched():
    """A faulted lane frees and re-acquires *its own* pages; the co-batched
    slot's physical pages never move and its stream is bit-exact against an
    undisturbed run. The NaN lands in the pool page the JAX replica
    poisons, and both replicas hold the same page tables throughout."""
    env = _env("qwen3-1.7b")
    conf = _conf()
    traffic = [((3, 5, 7), 24), (tuple(range(20, 26)), 20)]
    clean, _ = _serve(_port_replica(env, conf, paged=False), Request, traffic)
    jrep = _jax_replica(env, conf)
    tables = []

    def hook(r, cycle, snap):
        s0, s1 = r.sched.slots[0], r.sched.slots[1]
        if ("s0" not in snap and cycle >= 3 and s0.active and s0.pending is None
                and s1.active and s1.pending is None):
            snap["s0"] = r.alloc.owned(0)
            assert snap["s0"] and r.alloc.owned(1)
            assert r.inject_state_fault(1) == 1
            snap["page"] = int(r.page_table[1, 0])
        elif "s0" in snap and s0.active and s0.req.id == 0:
            # every cycle through detection and recovery: slot 0's pages
            # never move
            assert r.alloc.owned(0)[:len(snap["s0"])] == snap["s0"]
            assert np.array_equal(r.page_table[0, :len(snap["s0"])], snap["s0"])
            snap["checked"] = True

    psnap, jsnap = {}, {}

    def port_hook(r, cycle):
        hook(r, cycle, psnap)
        tables.append(r.page_table.copy())
        if "page" in psnap and "poison" not in psnap:
            psnap["poison"] = torch.isnan(r.caches["k"]).nonzero().tolist()

    jtables = []

    def jax_hook(r, cycle):
        hook(r, cycle, jsnap)
        jtables.append(r.page_table.copy())
        if "page" in jsnap and "poison" not in jsnap:
            nan = [np.argwhere(np.isnan(np.asarray(leaf)))
                   for leaf in jax.tree_util.tree_leaves(r.caches)]
            jsnap["poison"] = [n.tolist() for n in nan]

    rep = _port_replica(env, conf)
    got, _ = _serve(rep, Request, traffic, hook=port_hook)
    ref, _ = _serve(jrep, JaxRequest, traffic, hook=jax_hook)
    assert psnap.get("checked") and jsnap.get("checked")
    # K of layer 0 at position 0 of the lane's first page, in both
    assert psnap["poison"] == [[0, psnap["page"], 0, 0, 0]]
    assert jsnap["poison"][0] == [[jsnap["page"], 0, 0, 0, 0, 0]]
    assert psnap["page"] == jsnap["page"]
    assert got[1].status == OK and got[1].retries == 1
    assert got[0].status == OK and got[0].retries == 0
    assert _tokens(got) == _tokens(clean)
    assert rep.metrics.summary()["host_stalls"] == 0
    rep.alloc.check()
    _assert_streams_match(env, ref, got, traffic)
    if _tokens(ref) == _tokens(got):
        assert len(tables) == len(jtables)
        assert all(np.array_equal(a, b) for a, b in zip(tables, jtables))
        assert _records(rep) == _records(jrep)


# ------------------------------------------------------ exhaustion / eviction
@pytest.mark.parametrize("case", ["exhaustion", "watermark", "staging", "small_pool"])
def test_pool_pressure(case):
    """Pools too small for the load, each served to completion with every
    request OK and the JAX replica's streams and page counters:

    * exhaustion: 5 pages of 4 for 2 slots of 16 — growth preempts the
      oldest lane back into the queue (evictions > 0, the peak within the
      pool), and the streams equal an unpressured contiguous run;
    * watermark: the same pool keeping one page free — admission waits;
    * staging: 4 slots, window 8, 6 pages — an eviction inside one
      window's preparation recycles ids granted twice, which the scrub
      must dedupe;
    * small_pool: 1 slot of 64, a pool of 48 positions, a request of 44 —
      growth clamps to the pool's capacity, so it completes without an
      eviction (it used to livelock)."""
    env = _env("qwen3-1.7b")
    if case in ("exhaustion", "watermark"):
        conf = _conf(max_len=16, page_size=4, page_budget=5)
        if case == "watermark":
            conf["page_watermark"] = 1
        traffic = _traffic(6 if case == "exhaustion" else 5, max_new=8 if
                           case == "exhaustion" else 6)
    elif case == "staging":
        conf = _conf(num_slots=4, max_len=32, page_size=4, page_budget=6,
                     window=8)
        traffic = _traffic(6, max_new=6)
    else:
        conf = _conf(num_slots=1, max_len=64, page_size=16, page_budget=3)
        traffic = [(tuple(3 + j for j in range(20)), 24)]
    rep = _port_replica(env, conf)
    got, _ = _serve(rep, Request, traffic)
    assert sorted(got) == list(range(len(traffic)))
    assert all(r.status == OK and len(r.tokens) == n
               for r, (_, n) in zip((got[i] for i in sorted(got)), traffic))
    m = rep.metrics.summary()
    if case in ("exhaustion", "staging"):
        assert m["page_evictions"] > 0, "pressure never evicted"
    if case == "small_pool":
        assert m["page_evictions"] == 0
    assert m["peak_pages_in_use"] <= rep.layout.num_pages
    if case == "exhaustion":
        base, _ = _serve(_port_replica(env, conf, paged=False), Request, traffic)
        assert _tokens(got) == _tokens(base)
    rep.alloc.check()
    _check_against_jax(env, conf, traffic, got, rep)


def test_request_larger_than_pool_rejected_at_submit():
    """A request the pool can never hold is REJECTED at admission in both
    packages, not deferred forever by the watermark gate; one that fits
    the pool outright (pages + watermark > pool) is admitted and served."""
    env = _env("qwen3-1.7b")
    conf = _conf(max_len=32, page_size=8, page_budget=2)
    for rep, cls in ((_port_replica(env, conf), Request),
                     (_jax_replica(env, conf), JaxRequest)):
        resp = rep.submit(cls(id=0, prompt=tuple(range(3, 21)), max_new_tokens=8))
        assert resp is not None and resp.status == REJECTED
    conf = _conf(num_slots=1, max_len=64, page_size=16, page_budget=4,
                 page_watermark=1)
    rep = _port_replica(env, conf)
    got, _ = _serve(rep, Request, [(tuple(3 + j for j in range(50)), 8)])
    assert got[0].status == OK and len(got[0].tokens) == 8
    rep.alloc.check()


# --------------------------------------------------------- in-band PAGE_FAULT
@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "blocking"])
def test_page_table_corruption_raises_page_fault_and_recovers(overlap):
    """Unmapping a decoding lane's table row behind the allocator's back:
    the page probe latches PAGE_FAULT on that slot, the wait raises, a
    ``page_reclaim`` record follows, and the LFLR re-queue (free,
    re-acquire, scrub) rebuilds the mapping — the streams equal the
    contiguous run, and the fault records (step, code, action, slot) the
    JAX replica's."""
    env = _env("qwen3-1.7b")
    conf = _conf(overlap=overlap)
    traffic = _traffic(2, max_new=16)
    clean, _ = _serve(_port_replica(env, conf, paged=False), Request, traffic)

    rep = _port_replica(env, conf)
    corrupt, done = _corrupter()
    got, _ = _serve(rep, Request, traffic, hook=corrupt)
    assert done
    assert all(r.status == OK for r in got.values())
    assert _tokens(got) == _tokens(clean)
    page = [f for f in rep.metrics.faults if f.code & int(ErrorCode.PAGE_FAULT)]
    assert page and page[0].slots == (0,)
    assert [f.slots for f in rep.metrics.faults if f.action == "page_reclaim"] == [(0,)]
    assert rep.metrics.fault_counts().get("PAGE_FAULT", 0) >= 1
    rep.alloc.check()
    _check_against_jax(env, conf, traffic, got, rep, hook=_corrupter()[0])


def _corrupter():
    """A hook that unmaps slot 0's table row once, from cycle 4 on, when
    the slot is decoding; the list it returns records that it did."""
    done = []

    def corrupt(r, cycle):
        s0 = r.sched.slots[0]
        if not done and cycle >= 4 and s0.active and s0.pending is None:
            assert r.corrupt_page_table(0)
            done.append(cycle)

    return corrupt, done


def test_preempt_slot_requeues_and_drops_nothing():
    """``preempt_slot`` pulls a decoding lane's request out mid-run and
    requeues it ahead of its class: its pages come back, it recomputes from
    its prompt, every request is answered OK with the contiguous run's
    stream, and the JAX replica's ``preempt_slot`` gives the same page
    counters."""
    env = _env("qwen3-1.7b")
    conf, traffic = _conf(), _traffic(3, max_new=12)
    clean, _ = _serve(_port_replica(env, conf, paged=False), Request, traffic)

    def preempter():
        done = []

        def preempt(r, cycle):
            s0 = r.sched.slots[0]
            if not done and cycle >= 4 and s0.active and s0.pending is None:
                done.append(s0.req.id)
                assert r.preempt_slot(0) and not r.sched.slots[0].active
                assert not r.alloc.owns(0) and (
                    r.page_table[0] == r.layout.sentinel).all()

        return preempt, done

    rep = _port_replica(env, conf)
    hook, done = preempter()
    got, _ = _serve(rep, Request, traffic, hook=hook)
    assert done and rep.preempt_slot(0) is False
    assert all(r.status == OK for r in got.values())
    assert _tokens(got) == _tokens(clean)
    assert not rep.metrics.faults and rep.metrics.page_evictions == 0
    rep.alloc.check()
    _check_against_jax(env, conf, traffic, got, rep, hook=preempter()[0])


def test_table_upload_adds_no_readback():
    """The paged window uploads its table and scrubs its pages without a
    readback: still 2 syncs per retired window, and the paged ledger's
    accounting matches the pages the traffic needs."""
    env = _env("qwen3-1.7b")
    rep = _port_replica(env, _conf())
    readback.count = 0
    got, _ = _serve(rep, Request, _traffic(4))
    assert all(r.status == OK for r in got.values())
    assert readback.count == 2 * rep.metrics.windows
    assert rep.metrics.pages_allocated >= 4 * pages_for(5 + 8, 8)


# ------------------------------------------------------------- architectures
def test_paged_degenerates_cleanly_without_pageable_leaves():
    """mamba2 has nothing to page: paged=True serves bit-identically to the
    contiguous engine with an idle ledger (overlapped) and agrees with the
    JAX paged replica."""
    env = _env("mamba2-2.7b")
    conf, traffic = _conf(), _traffic(3)
    base, _ = _serve(_port_replica(env, conf, paged=False), Request, traffic)
    rep = _port_replica(env, conf)
    got, _ = _serve(rep, Request, traffic)
    assert not rep.layout.has_paged_leaves
    assert all(r.status == OK for r in got.values())
    assert _tokens(got) == _tokens(base)
    assert rep.metrics.summary()["pages_allocated"] == 0
    assert rep.corrupt_page_table(0) is False
    _check_against_jax(env, conf, traffic, got, rep)


@pytest.mark.parametrize("inject_at", [None, 5], ids=["steady", "faulted"])
def test_gemma3_pages_its_rings_at_max_len_within_window(inject_at):
    """gemma3 at ``max_len`` 16 = its window: the rings hold ``max_len``
    entries, so they are paged with the full layers; paged ≡ contiguous,
    the NaN goes into the first paged leaf (layer 0's ring, a pool page),
    and the JAX paged replica agrees."""
    env = _env("gemma3-1b")
    conf, traffic = _conf(max_len=16), _traffic(4, max_new=13, prompt_len=2)
    base, _ = _serve(_port_replica(env, conf, paged=False), Request, traffic,
                     inject_at)
    rep = _port_replica(env, conf)
    assert {n for n in rep.caches if rep.layout.is_paged_path(n)} == {
        "k", "v", "k_ring", "v_ring"}
    got, slot = _serve(rep, Request, traffic, inject_at)
    assert all(r.status == OK for r in got.values())
    assert _tokens(got) == _tokens(base)
    assert len(rep.metrics.faults) == (0 if inject_at is None else 1)
    if inject_at is not None:
        assert slot is not None and rep.state_fault_layers() == [0]
    rep.alloc.check()
    _check_against_jax(env, conf, traffic, got, rep, inject_at=inject_at)
