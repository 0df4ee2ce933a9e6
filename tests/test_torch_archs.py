"""Serving and training parity for the three architectures the port took
with LayerNorm and the partial 2-D rotary — starcoder2-3b (sliding only:
2 layers, window 16, LayerNorm, plain-GeLU MLP), chatglm3-6b (2 full
layers, the interleaved-pair rotary over 8 of 16 head dims) and
phi3.5-moe-42b-a6.6b (2 layers, LayerNorm, 8 experts top-2) — on their
smoke configs in float32, the JAX weights carried over by the bridge with
every layer norm's bias drawn non-zero (``test_torch_model.with_biases``):

* the window+overlap ``Replica`` against the JAX one: greedy streams equal
  (except at a near-tie of the reference's top-2 logits, within the
  logits tolerance 1e-4: ``test_torch_serve._assert_streams_match``), and
  injected error words give the same ``(step, code, action, slots)``
  records, statuses and retries;
* ``inject_state_fault`` poisons what the JAX replica poisons — for
  starcoder2 the first sliding layer's K, at a ``max_len`` (16) its rings
  hold whole — and both replicas latch the same records; the port's LFLR
  streams are bit-equal to its clean run's and equal the JAX replica's;
* the stepwise engine (``window=0``) bit-equal to the window engine; at
  ``max_len`` 48 starcoder2's rings wrap while serving;
* chatglm3: the paged replica bit-equal to the contiguous one, clean and
  under LFLR; the speculative windows bit-equal to the plain overlap
  engine, clean and under LFLR, and ``verify_step``'s rows bit-equal to
  ``decode_step`` (the partial rotary runs in the verify rows);
* starcoder2 and phi3.5-moe: the loss and every gradient leaf — the norm
  biases among them — against ``jax.grad`` of the reference's loss, and
  one whole train step (AdamW over the leaf table with the bias leaves,
  the probe word) against the JAX step, at ``test_torch_train.py``'s
  tolerances: the loss to 1e-6 relative, each leaf to 1e-5 of its largest
  value (fp32 on both sides, other summation orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.data import pipeline as jpipe
from repro.launch.train import build_train_setup as jax_build
from repro.models import build_model
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import Replica as JaxReplica
from repro.serve import Request as JaxRequest
from repro_torch.configs import smoke_config
from repro_torch.core.errors import ErrorCode
from repro_torch.data import pipeline
from repro_torch.launch import train as train_cli
from repro_torch.launch.steps import make_loss_and_grads
from repro_torch.serve import OK, EngineConfig, Replica, Request
from repro_torch.weights import (_flat_from_jax, cache_from_jax, params_from_jax,
                                 train_state_from_jax, train_state_to_numpy)
from test_torch_model import with_biases
from test_torch_serve import _assert_streams_match, _injector, _serve, _traffic

torch.set_num_threads(2)

SC2, GLM, PHI = "starcoder2-3b", "chatglm3-6b", "phi3.5-moe-42b-a6.6b"
ARCHS = [SC2, GLM, PHI]
ENGINE = dict(window=4, overlap=True, num_slots=3, max_len=48)
# starcoder2's fault: K of a ring that holds the whole row (capacity =
# max_len), as the JAX replica requires; prompts of 2-3 and 12-13 new
# tokens fit it, and windows of 2 leave a slot to poison (one decoding
# past the window in flight and the next)
SHORT = dict(max_len=16, window=2)
GRAD_TOL = 1e-5
LOSS_RTOL = 1e-6

_ENVS: dict = {}


def _env(arch):
    """(JAX config, port config, JAX model, JAX params, port model), once
    per architecture for the module; the norm biases drawn non-zero."""
    if arch not in _ENVS:
        jcfg, cfg = jax_smoke_config(arch), smoke_config(arch)
        jmodel = build_model(jcfg)
        params = with_biases(jmodel.init(jax.random.PRNGKey(0)))
        model = params_from_jax(jax.device_get(params), cfg, device="cpu")
        _ENVS[arch] = (jcfg, cfg, jmodel, params, model)
    return _ENVS[arch]


@pytest.fixture(params=ARCHS)
def env(request):
    return _env(request.param)


def _jax_replica(env, fault_injector=None, **conf):
    jcfg, _, _, params, _ = env
    return JaxReplica(jcfg, params=params, fault_injector=fault_injector,
                      config=JaxEngineConfig(**{**ENGINE, **conf}))


def _port_replica(env, fault_injector=None, **conf):
    _, cfg, _, _, model = env
    return Replica(cfg, model, fault_injector=fault_injector,
                   config=EngineConfig(**{**ENGINE, **conf}))


def _tokens(out):
    return {i: r.tokens for i, r in out.items()}


def _records(rep):
    return [(f.step, f.code, f.action, f.slots) for f in rep.metrics.faults]


def _fault_traffic(env):
    """The state-fault cases' traffic and engine fields: for starcoder2 a
    ``max_len`` its rings hold whole."""
    if env[1].name != SC2:
        return _traffic(), {}
    rng = np.random.default_rng(21)
    return [(tuple(int(t) for t in rng.integers(1, 500, int(rng.integers(2, 4)))),
             int(rng.integers(12, 14))) for _ in range(6)], SHORT


# ------------------------------------------------------------ against JAX
def test_streams_match_jax_replica(env):
    traffic = _traffic()
    ref, _ = _serve(_jax_replica(env), JaxRequest, traffic)
    got, _ = _serve(_port_replica(env), Request, traffic)
    _assert_streams_match(env, ref, got, traffic)
    if env[1].name == SC2:          # prompt + answer past the ring of 16
        assert max(len(p) + len(got[i].tokens)
                   for i, (p, _) in enumerate(traffic)) > 16


def test_recovery_decisions_match_jax_replica(env):
    schedule = {2: [(0, 0, int(ErrorCode.DATA_FAULT))],
                4: [(3, 2, int(ErrorCode.STATE_FAULT))],
                5: [(1, 0, int(ErrorCode.NONFINITE_LOSS | ErrorCode.OVERFLOW))]}
    traffic = _traffic()
    jrep = _jax_replica(env, fault_injector=_injector(schedule))
    ref, _ = _serve(jrep, JaxRequest, traffic)
    prep = _port_replica(env, fault_injector=_injector(schedule))
    got, _ = _serve(prep, Request, traffic)
    assert prep.metrics.faults and _records(prep) == _records(jrep)
    assert {i: r.status for i, r in got.items()} == {i: r.status for i, r in ref.items()}
    assert {i: r.retries for i, r in got.items()} == {i: r.retries for i, r in ref.items()}
    for i in ref:
        if ref[i].status == OK:
            assert got[i].tokens == ref[i].tokens


def test_state_fault_matches_jax_and_lflr(env):
    """The poisoned elements are the JAX replica's (mapped through the
    bridge); served with the fault, both replicas latch NONFINITE_LOSS on
    the same slot at the same step with the same action, their streams are
    equal, and the port's are bit-equal to its clean run's."""
    cfg = env[1]
    traffic, conf = _fault_traffic(env)
    jrep, prep = _jax_replica(env, **conf), _port_replica(env, **conf)
    assert jrep.inject_state_fault(1) == prep.inject_state_fault(1) == 1
    want = cache_from_jax(jax.device_get(jrep.caches), cfg, slots=True, device="cpu")
    assert set(want) == set(prep.caches)
    for name, t in prep.caches.items():
        assert torch.equal(torch.isnan(t), torch.isnan(want[name])), name
    leaf = "k_ring" if cfg.name == SC2 else "k"
    assert int(torch.isnan(prep.caches[leaf]).sum()) == 1
    assert prep.state_fault_layers() == [0]

    clean, _ = _serve(_port_replica(env, **conf), Request, traffic)
    jrep, prep = _jax_replica(env, **conf), _port_replica(env, **conf)
    ref, jslot = _serve(jrep, JaxRequest, traffic, inject_at=3)
    got, slot = _serve(prep, Request, traffic, inject_at=3)
    assert slot == jslot is not None
    assert prep.metrics.faults[0].code == int(ErrorCode.NONFINITE_LOSS)
    assert prep.metrics.faults[0].slots == (slot,)
    assert _records(prep) == _records(jrep)
    assert all(r.status == OK for r in got.values())
    assert sum(r.retries for r in got.values()) == 1
    assert _tokens(got) == _tokens(clean)
    _assert_streams_match(env, ref, got, traffic)


# ------------------------------------------------------ inside the port
def test_stepwise_bit_equal_window(env):
    traffic = _traffic(seed=5)
    step, _ = _serve(_port_replica(env, window=0, overlap=False), Request, traffic)
    win, _ = _serve(_port_replica(env), Request, traffic)
    assert all(r.status == OK for r in step.values())
    assert _tokens(step) == _tokens(win)


@pytest.mark.parametrize("inject_at", [None, 2], ids=["steady", "faulted"])
def test_chatglm3_paged_bit_exact_vs_contiguous(inject_at):
    """chatglm3 pages all its layers' K/V (pages of 8): the same streams as
    the contiguous engine, clean and with a NaN in a slot's K (LFLR), and
    every page back at drain."""
    env = _env(GLM)
    traffic = _traffic()
    base, bslot = _serve(_port_replica(env), Request, traffic, inject_at)
    rep = _port_replica(env, paged=True, page_size=8)
    assert rep.layout.has_paged_leaves and rep.layout.is_paged_path("k")
    got, slot = _serve(rep, Request, traffic, inject_at)
    assert slot == bslot and (slot is None) == (inject_at is None)
    assert all(r.status == OK for r in got.values())
    assert _tokens(got) == _tokens(base)
    assert len(rep.metrics.faults) == (0 if inject_at is None else 1)
    m = rep.metrics
    assert m.pages_allocated > 0 and m.pages_allocated == m.pages_freed
    rep.alloc.check()


@pytest.mark.parametrize("inject_at", [None, 2], ids=["steady", "faulted"])
def test_chatglm3_speculative_bit_equal_plain(inject_at):
    """chatglm3 (pure full attention, no MoE) speculates: 3 drafts from its
    first layer, a 4-row verify. Every emitted token is the full model's
    argmax, so the streams equal the overlap engine's, clean and under
    LFLR (the fault never surfaces as DRAFT_REJECT)."""
    env = _env(GLM)
    assert env[4].supports_speculation()
    traffic = _traffic(5, seed=9)
    base, bslot = _serve(_port_replica(env), Request, traffic, inject_at)
    rep = _port_replica(env, speculate=True, draft_len=3, draft_layers=1)
    got, slot = _serve(rep, Request, traffic, inject_at)
    assert all(r.status == OK for r in got.values())
    assert _tokens(got) == _tokens(base)
    assert rep.metrics.draft_tokens > 0
    if inject_at is not None:
        assert slot is not None and rep.metrics.faults
        assert all(not f.code & int(ErrorCode.DRAFT_REJECT) for f in rep.metrics.faults)


def test_chatglm3_verify_rows_bit_equal_decode():
    """Row t of ``verify_step`` is bit-equal to ``decode_step`` at ``pos +
    t`` after the rows before it (logits and the K/V left), at mixed
    per-slot positions, with the partial rotary in every row."""
    _, cfg, _, _, model = _env(GLM)
    rng = np.random.default_rng(8)
    S, T, cap = 3, 4, 48
    a = model.init_cache(S, cap)
    pre = torch.from_numpy(rng.integers(0, cfg.vocab_size, (S, 7)))
    for p in range(7):
        model.decode_step(pre[:, p:p + 1], a, p)
    b = {n: t.clone() for n, t in a.items()}
    pos = torch.tensor([7, 20, 40], dtype=torch.int32)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (S, T)))
    got = model.verify_step(toks, a, pos)
    want = torch.cat([model.decode_step(toks[:, t:t + 1], b, pos + t)
                      for t in range(T)], dim=1)
    assert torch.equal(got, want)
    for n in a:
        assert torch.equal(a[n], b[n]), n


# ---------------------------------------------------------------- training
B, S_TRAIN, TOTAL = 2, 16, 60


def _train_envs(arch):
    """The JAX model, step and state (norm biases drawn non-zero), the
    batch config, and the port's step and state from the same params."""
    jcfg, cfg = jax_smoke_config(arch), smoke_config(arch)
    jmodel, jstep, jstate, jpipe_, _ = jax_build(jcfg, batch_size=B, seq_len=S_TRAIN,
                                                 total_steps=TOTAL)
    jstate = {**jstate, "params": with_biases(jstate["params"])}
    _, step_fn, _, _, _ = train_cli.build_train_setup(
        cfg, batch_size=B, seq_len=S_TRAIN, total_steps=TOTAL, device="cpu")
    state = train_state_from_jax(jax.device_get(jstate), cfg, device="cpu")
    return cfg, jmodel, jstep, jstate, jpipe_.cfg, step_fn, state


@pytest.mark.parametrize("arch", [SC2, PHI])
def test_loss_and_gradients_match_jax(arch):
    cfg, jmodel, _, jstate, pcfg, _, state = _train_envs(arch)
    jb = jpipe.make_batch(pcfg, 0)
    (jl, jaux), jg = jax.value_and_grad(lambda p: jmodel.loss(p, jb),
                                        has_aux=True)(jstate["params"])
    tb = pipeline.make_batch(pipeline.PipelineConfig(**pcfg.__dict__), 0, "cpu")
    loss, grads, aux = make_loss_and_grads(cfg)(state["params"], tb)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    assert aux["dropped_fraction"].item() == float(jaux["dropped_fraction"])
    want = _flat_from_jax(jax.device_get(jg), cfg, torch.device("cpu"))
    assert list(grads) == list(state["params"])
    for name, g in grads.items():
        scale = want[name].abs().max().item()
        assert (g - want[name]).abs().max().item() <= GRAD_TOL * scale, name
    biases = [n for n in grads if n.endswith("_bias")]
    assert len(biases) == 1 + 2 * cfg.num_layers
    for name in biases:
        assert grads[name].abs().sum() > 0, name


@pytest.mark.parametrize("arch", [SC2, PHI])
def test_train_step_matches_jax(arch):
    """One step of each (AdamW over the leaf table with the bias leaves, the
    gradient probe's word) from the same state and batch: the same word,
    the loss, grad norm and lr, and every new leaf."""
    cfg, _, jstep, jstate, pcfg, step_fn, state = _train_envs(arch)
    tb = pipeline.make_batch(pipeline.PipelineConfig(**pcfg.__dict__), 0, "cpu")
    new, metrics, word = step_fn(state, tb, 0)
    jnew, jm, jword = jstep(jstate, jpipe.make_batch(pcfg, 0), jnp.uint32(0))
    assert int(word) == int(jword) == 0
    np.testing.assert_allclose(metrics["loss"].item(), float(jm["loss"]), rtol=LOSS_RTOL)
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(metrics[key].item(), float(jm[key]), rtol=1e-5)
    got = train_state_to_numpy(new, cfg)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(jax.device_get(jnew)))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jax.device_get(jnew))):
        b = np.asarray(b)
        assert np.max(np.abs(a - b)) <= GRAD_TOL * max(np.max(np.abs(b)), 1e-30)
