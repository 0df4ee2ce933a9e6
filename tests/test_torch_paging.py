"""The port's paged KV layout and page allocator against the JAX package's,
on the smoke configs of qwen3-1.7b, gemma3-1b, recurrentgemma-2b and
mamba2-2.7b (float32; the operations are copies, so every comparison is bit
for bit):

* the same seeded pools and tables give the same ``gather`` (an unmapped
  page reads zeros), ``scatter`` (a write through the sentinel is dropped),
  ``gather_slot``, ``scatter_slot``, ``scrub`` and ``reset_slot``, with the
  hybrid caches carried between the layouts by the cache bridge (a pool
  has the slot-stacked layout with pages for slots);
* the same ``probe`` words, positions past ``capacity_tokens`` included;
* the same leaves are paged, with the same ``page_bytes`` and
  ``pool_bytes``, at a ``max_len`` below, equal to and above the sliding
  window (rings of capacity ``max_len`` are paged, as in the JAX layout);
* ``PageAllocator`` gives the same ids, free counts, admissions and errors
  as the JAX package's on seeded operation sequences.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.launch.paging import PagedLayout as JaxLayout
from repro.models import build_model
from repro.serve.scheduler import PageAllocator as JaxAllocator
from repro_torch.configs import smoke_config
from repro_torch.core.errors import ErrorCode
from repro_torch.launch.paging import KV_NAMES, PagedLayout, pages_for
from repro_torch.models import Model
from repro_torch.models.model import BLOCK_LEAVES
from repro_torch.serve.scheduler import PageAllocator, PagePoolExhausted
from repro_torch.weights import cache_from_jax

ARCHS = ["qwen3-1.7b", "gemma3-1b", "recurrentgemma-2b", "mamba2-2.7b"]
PAGE = 4
# the smoke sliding window is 16: below, at and above it
MAX_LENS = [8, 16, 32]
SLOTS = 3

_ENVS: dict = {}


def _env(arch, max_len, num_pages):
    """(port config, JAX layout, port layout, JAX per-slot cache, port
    per-slot cache)."""
    key = (arch, max_len, num_pages)
    if key not in _ENVS:
        jcfg, cfg = jax_smoke_config(arch), smoke_config(arch)
        jone = build_model(jcfg).init_cache(1, max_len)
        one = Model(cfg, device="cpu", seed=None).init_cache(1, max_len)
        _ENVS[key] = (cfg,
                      JaxLayout(jone, max_len, page_size=PAGE, num_pages=num_pages),
                      PagedLayout(one, max_len, page_size=PAGE, num_pages=num_pages),
                      jone, one)
    return _ENVS[key]


def _to_port(tree, cfg, layout, slots=True):
    """A JAX hybrid (or view) tree as the port's dict; a pool gets the zero
    page and the sink appended."""
    out = cache_from_jax(jax.device_get(tree), cfg, slots=slots, device="cpu")
    for name in out:
        if slots and layout.is_paged_path(name):
            pool = out[name]
            out[name] = torch.cat([pool, pool.new_zeros(
                (pool.shape[0], 2, *pool.shape[2:]))], dim=1)
    return out


def _assert_same(port, want, layout):
    """The port's hybrid equals the JAX one's (in the port's layout), and
    its zero page is still zeros."""
    assert port.keys() == want.keys()
    for name in port:
        got = port[name]
        if layout.is_paged_path(name):
            assert not got[:, layout.sentinel].any(), f"{name}: zero page written"
            got = got[:, :layout.num_pages]
            want_leaf = want[name][:, :layout.num_pages]
        else:
            want_leaf = want[name]
        assert torch.equal(got, want_leaf), name


def _random_hybrid(jlayout, jone, rng):
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32)),
        jlayout.init_hybrid(jone, SLOTS))


def _random_table(layout, rng):
    """Distinct physical ids in random entries, the sentinel in the rest
    (and a whole slot unmapped)."""
    n = SLOTS * layout.max_pages
    ids = rng.permutation(max(layout.num_pages, n))[:n]
    table = np.where(ids < layout.num_pages, ids, layout.sentinel)
    table = np.where(rng.random(n) < 0.3, layout.sentinel, table)
    table = table.reshape(SLOTS, layout.max_pages).astype(np.int32)
    table[1] = layout.sentinel
    return table


@pytest.mark.parametrize("max_len", MAX_LENS)
@pytest.mark.parametrize("arch", ARCHS)
def test_gather_scatter_match_jax(arch, max_len):
    """gather, scatter, gather_slot, scatter_slot, scrub and reset_slot on
    the same seeded pools and tables: bit-equal, the gathered leaf in the
    contiguous cache's shape, dtype and memory layout."""
    num_pages = SLOTS * (max_len // PAGE) - 1
    cfg, jlayout, layout, jone, one = _env(arch, max_len, num_pages)
    rng = np.random.default_rng(100 * ARCHS.index(arch) + max_len)
    jh = _random_hybrid(jlayout, jone, rng)
    hybrid = _to_port(jh, cfg, layout)
    table = _random_table(layout, rng)
    t = torch.from_numpy(table)

    jviews = jlayout.gather(jh, jnp.asarray(table))
    views = layout.gather(hybrid, t)
    want = cache_from_jax(jax.device_get(jviews), cfg, slots=True, device="cpu")
    contiguous = Model(cfg, device="cpu", seed=None).init_cache(SLOTS, max_len)
    for name in views:
        assert torch.equal(views[name], want[name]), name
        assert views[name].shape == contiguous[name].shape
        assert views[name].dtype == contiguous[name].dtype
        assert views[name].is_contiguous()

    # scatter of new views: sentinel entries dropped
    new = _random_hybrid(jlayout, jone, rng)
    jnew_views = jlayout.gather(new, jnp.asarray(table))
    jback = jlayout.scatter(jh, jnew_views, jnp.asarray(table))
    new_views = cache_from_jax(jax.device_get(jnew_views), cfg, slots=True,
                               device="cpu")
    layout.scatter(hybrid, new_views, t)
    _assert_same(hybrid, _to_port(jback, cfg, layout), layout)

    # one slot: gather_slot, then scatter_slot of a changed view
    slot = 2
    row = jnp.asarray(table[slot])
    jview = jlayout.gather_slot(jback, row, slot)
    view = layout.gather_slot(hybrid, t[slot], slot)
    jview_port = cache_from_jax(jax.device_get(jview), cfg, device="cpu")
    for name in view:
        assert torch.equal(view[name], jview_port[name]), name
    jview2 = jax.tree_util.tree_map(lambda x: x * 2 + 1, jview)
    jback2 = jlayout.scatter_slot(jback, jview2, row, slot)
    layout.scatter_slot(hybrid, cache_from_jax(jax.device_get(jview2), cfg,
                                               device="cpu"), t[slot], slot)
    _assert_same(hybrid, _to_port(jback2, cfg, layout), layout)

    # scrub (sentinel ids dropped) and reset_slot
    ids = np.asarray([table[0, 0], layout.sentinel, table[2, -1]], np.int32)
    jback3 = jlayout.scrub(jback2, jnp.asarray(ids))
    layout.scrub(hybrid, torch.from_numpy(ids))
    _assert_same(hybrid, _to_port(jback3, cfg, layout), layout)
    fresh = build_model(jax_smoke_config(arch)).init_cache(1, max_len)
    jback4 = jlayout.reset_slot(jback3, fresh, 1)
    layout.reset_slot(hybrid, 1)
    _assert_same(hybrid, _to_port(jback4, cfg, layout), layout)


@pytest.mark.parametrize("max_len", MAX_LENS)
def test_probe_matches_jax(max_len):
    """The PAGE_FAULT words over seeded tables and positions, positions
    past ``max_len`` and past a small pool's ``capacity_tokens`` included,
    bit-equal; a layout without paged leaves gives zeros in both."""
    rng = np.random.default_rng(max_len)
    for arch, num_pages in (("qwen3-1.7b", 3), ("qwen3-1.7b", 40),
                            ("gemma3-1b", 5), ("mamba2-2.7b", 5)):
        _, jlayout, layout, _, _ = _env(arch, max_len, num_pages)
        assert layout.capacity_tokens == jlayout.capacity_tokens
        for _ in range(4):
            table = rng.integers(0, num_pages + 1, (6, layout.max_pages)).astype(np.int32)
            table[rng.random(table.shape) < 0.5] = layout.sentinel
            table[0] = np.arange(layout.max_pages) % num_pages     # all mapped
            pos = rng.integers(0, 2 * max_len + 8, 6).astype(np.int32)
            want = np.asarray(jlayout.probe(jnp.asarray(table), jnp.asarray(pos)))
            got = layout.probe(torch.from_numpy(table), torch.from_numpy(pos))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
            if layout.has_paged_leaves:
                assert int(got[0]) == 0
    _, _, layout, _, _ = _env("qwen3-1.7b", max_len, 40)
    t = torch.full((1, layout.max_pages), layout.sentinel, dtype=torch.int32)
    assert int(layout.probe(t, torch.tensor([0], dtype=torch.int32))[0]) == int(
        ErrorCode.PAGE_FAULT)


def _jax_paged_names(jlayout, jcfg):
    """The port's leaf names of the JAX layout's paged leaves."""
    n_scan = jcfg.num_periods * jcfg.period
    names = set()
    for key in jlayout._specs:
        parts = [p.strip("[]'") for p in key.replace("][", "]|[").split("|")]
        layer = (int(parts[1][1:]) if parts[0] == "periods"
                 else n_scan + int(parts[1]))
        kind = jcfg.pattern_layers[layer]
        inv = {theirs: ours for ours, theirs in BLOCK_LEAVES[kind].items()}
        names.add(inv[parts[-1]])
    return names


@pytest.mark.parametrize("max_len", MAX_LENS)
@pytest.mark.parametrize("arch", ARCHS)
def test_classification_and_bytes_match_jax(arch, max_len):
    """The same leaves paged — full K/V always, the rings only when
    ``max_len <= window``, nothing for mamba2 — with equal page and pool
    bytes; the hybrid's pools lead with the layer axis and hold two pages
    more (the zero page and the sink)."""
    num_pages = 7
    cfg, jlayout, layout, _, one = _env(arch, max_len, num_pages)
    paged = {n for n in one if layout.is_paged_path(n)}
    assert paged == _jax_paged_names(jlayout, jax_smoke_config(arch))
    assert layout.has_paged_leaves == jlayout.has_paged_leaves
    assert layout.page_bytes() == jlayout.page_bytes()
    assert layout.pool_bytes() == jlayout.pool_bytes() == num_pages * layout.page_bytes()
    assert (layout.contiguous_paged_bytes_per_slot()
            == jlayout.contiguous_paged_bytes_per_slot())
    rings = "sliding" in cfg.pattern_layers and max_len <= cfg.sliding_window
    want = ({"k", "v"} if "attn" in cfg.pattern_layers else set()) | (
        {"k_ring", "v_ring"} if rings else set())
    assert paged == want and paged <= KV_NAMES
    hybrid = layout.init_hybrid(one, SLOTS)
    for name, leaf in hybrid.items():
        if name in paged:
            assert leaf.shape[:3] == (one[name].shape[0], num_pages + 2, PAGE)
        else:
            assert leaf.shape[0 if name in ("h", "ssm", "conv") else 1] == SLOTS
    with pytest.raises(ValueError, match="multiple"):
        PagedLayout(one, max_len, page_size=3, num_pages=4)


def _ops(rng, n_slots, num_pages):
    ops = []
    for _ in range(60):
        r = rng.random()
        slot = int(rng.integers(0, n_slots))
        if r < 0.45:
            ops.append(("alloc", slot, int(rng.integers(0, num_pages // 2 + 2))))
        elif r < 0.7:
            ops.append(("free_slot", slot))
        else:
            ops.append(("can_admit", int(rng.integers(0, 3 * num_pages * 4))))
    return ops


def _run(alloc, ops):
    """Each operation's outcome (its value, or the name of its error) with
    the ledger's counts after it; ``check()`` after every operation."""
    trace = []
    for op in ops:
        try:
            got = getattr(alloc, op[0])(*op[1:])
            got = tuple(got) if isinstance(got, list) else got
        except (ValueError, RuntimeError) as exc:
            got = type(exc).__name__
        alloc.check()
        trace.append((op, got, alloc.free_pages, alloc.pages_in_use,
                      tuple(alloc.owned(0)), alloc.owns(1)))
    return trace


@pytest.mark.parametrize("watermark", [0, 2])
@pytest.mark.parametrize("seed", range(3))
def test_page_allocator_matches_jax(seed, watermark):
    """Seeded interleavings of alloc, free_slot and can_admit (with a
    watermark, and a request too large for it): the same ids, counts,
    admissions, exhaustion (``PagePoolExhausted``) and double frees as the
    JAX allocator, and ``check()`` holds throughout."""
    ops = _ops(np.random.default_rng(seed), 4, 9)
    got = _run(PageAllocator(9, 4, watermark=watermark), ops)
    want = _run(JaxAllocator(9, 4, watermark=watermark), ops)
    assert got == want
    assert any(g[1] == "PagePoolExhausted" for g in got)
    assert any(g[1] == "ValueError" for g in got)        # a double free
    # a request of the whole pool: need + watermark > pool waives the
    # headroom, so it is admitted when the pool is empty
    for cls in (PageAllocator, JaxAllocator):
        assert cls(9, 4, watermark=watermark).can_admit(9 * 4)
        assert cls(9, 4, watermark=watermark).can_admit(8 * 4)
    assert pages_for(9, 4) == 3 == PageAllocator(9, 4).pages_for(9)


def test_page_allocator_check_catches_corruption():
    """``check()`` raises on a page owned twice and on a leaked page, in
    both packages."""
    for cls in (PageAllocator, JaxAllocator):
        a = cls(4, 2)
        a.alloc(0, 2)
        a._owned[1] = [a._owned[0][0]]
        with pytest.raises(AssertionError, match="owned"):
            a.check()
        b = cls(4, 2)
        b._free.pop()
        with pytest.raises(AssertionError, match="leaked"):
            b.check()
    assert issubclass(PagePoolExhausted, RuntimeError)
