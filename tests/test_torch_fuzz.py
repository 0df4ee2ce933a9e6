"""The port's fuzz kits (``repro_torch.fuzz``) against the JAX package's, on
the qwen3-1.7b smoke config (float32) with the JAX fuzz kits' weights
carried over by ``params_from_jax`` (``repro.fuzz.runner._env``):

* trajectories round-trip to the reference's JSON byte for byte, and the
  reference's corpus entries load unchanged;
* with the port's eight engines passed to both, ``FaultMutator(seed)``
  proposes the reference's trajectories byte for byte (seeds 0–3, the
  first 16 indices, an empty coverage database);
* ``reachable_cells()`` is the reference's without the ``overlap_tp``
  cells (ROADMAP item 11), whose runs raise; a mutator-drawn ``multihost``
  trajectory (sim-backend worker processes) runs with zero violations;
* every single-engine entry of the reference's corpus replays on the port
  with zero violations (the group entries: ``test_torch_fuzz_group.py``),
  and one entry per engine is held to a live JAX ``run_trajectory`` of the
  same trajectory: equal outcomes ``(id, status, tokens)`` — a token may
  differ only where the reference's top-2 logit gap is below
  ``LOGIT_TOL`` — and equal cells. The stored digests are not used: they
  drift on this tree in the reference's own replays;
* a small campaign covers cells, and a failing trajectory minimizes and is
  written to, and replayed from, a corpus directory under ``tmp_path``.

The reference's paged kits wait for their outputs here: on the CPU the JAX
replica's page table aliases the host array, and a window still running
when the host edits it reads the edit (``test_torch_paged_serve.py``).
"""
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fuzz as jax_fuzz
import repro.fuzz.runner as jax_runner
import repro_torch.fuzz.campaign as campaign
from repro.models import build_model
from repro_torch import fuzz
from repro_torch.configs import smoke_config
from repro_torch.core.errors import ErrorCode
from repro_torch.fuzz import runner
from repro_torch.weights import params_from_jax
from test_torch_serve import LOGIT_TOL

torch.set_num_threads(2)

CORPUS = pathlib.Path(__file__).parent / "fuzz_corpus"
ENTRIES = sorted(CORPUS.glob("*.json"))
SINGLE = [p for p in ENTRIES if not p.stem.startswith("seed_group")]
# one entry per engine, held to a live JAX run
LIVE = ["seed_stepwise_0_01", "seed_window_0_08", "seed_overlap_0_07",
        "seed_overlap_paged_0_03", "seed_spec_0_04", "seed_spec_paged_0_00"]


def _waited(fn):
    return lambda *args: jax.block_until_ready(fn(*args))


@pytest.fixture(scope="module", autouse=True)
def jax_weights():
    """The port's kits over the JAX kits' weights, for the module."""
    cfg, params = jax_runner._env()
    runner.use_model(params_from_jax(jax.device_get(params),
                                     smoke_config(runner.MODEL), device="cpu"))
    yield cfg, params
    runner.use_model(None)


@pytest.fixture
def jax_kits(monkeypatch):
    """The reference's kits, the paged ones waiting for their outputs."""
    original = jax_runner.get_kit

    def get_kit(engine):
        kit = original(engine)
        if kit.layout is None:
            return kit
        return dataclasses.replace(kit, window_fn=_waited(kit.window_fn),
                                   prefill_fn=_waited(kit.prefill_fn))
    monkeypatch.setattr(jax_runner, "get_kit", get_kit)


def assert_outcomes_match(jax_weights, traj, got, ref):
    """Equal ids and statuses; equal tokens but from a position where the
    JAX reference's top-2 logit gap is below ``LOGIT_TOL``."""
    cfg, params = jax_weights
    assert sorted(got.responses) == sorted(ref.responses)
    prompts = traj.prompts()
    for rid, r in ref.responses.items():
        g = got.responses[rid]
        assert g.status == r.status, rid
        a, b = tuple(r.tokens), tuple(g.tokens)
        if a == b:
            continue
        k = next(j for j in range(min(len(a), len(b))) if a[j] != b[j])
        logits, _ = build_model(cfg).forward(
            params, jnp.asarray([list(prompts[rid]) + list(a[:k])], jnp.int32),
            impl="ref")
        top2 = np.sort(np.asarray(logits[0, -1]))[-2:]
        assert top2[1] - top2[0] < LOGIT_TOL, (rid, k, a, b)


def test_trajectory_json_is_the_reference_json():
    for path in ENTRIES:
        d = json.loads(path.read_text())["trajectory"]
        got = fuzz.Trajectory.from_json(d)
        want = jax_fuzz.Trajectory.from_json(d)
        assert got.dumps() == want.dumps()
        # the stored entries predate the ``shard`` field, which defaults
        assert fuzz.Trajectory.loads(got.dumps()) == got
        assert got.to_json()["ops"] == [{"shard": -1, **o} for o in d["ops"]]
        assert got.prompts() == want.prompts() and got.load_key == want.load_key
        entry = fuzz.load_entry(str(path))
        assert entry["trajectory"] == got


@pytest.mark.parametrize("seed", range(4))
def test_mutator_proposes_the_reference_trajectories(seed):
    mine = fuzz.FaultMutator(seed, fuzz.CoverageDB(), engines=fuzz.PORT_ENGINES)
    ref = jax_fuzz.FaultMutator(seed, jax_fuzz.CoverageDB(),
                                engines=fuzz.PORT_ENGINES)
    assert mine.universe == ref.universe
    for i in range(16):
        assert mine.propose(i).dumps() == ref.propose(i).dumps(), (seed, i)
    # the port's default engines are its eight: no TP draws
    default = fuzz.FaultMutator(seed, fuzz.CoverageDB())
    assert default.engines == fuzz.PORT_ENGINES
    assert {default.propose(i).engine for i in range(16)} <= set(fuzz.PORT_ENGINES)


def test_reachable_cells_are_the_reference_cells_the_port_runs():
    want = {c for c in jax_fuzz.reachable_cells() if c[2] != "overlap_tp"}
    assert fuzz.reachable_cells() == want
    assert len(want) < len(jax_fuzz.reachable_cells())
    code = ErrorCode.OVERFLOW
    assert fuzz.action_ladder(code) == jax_fuzz.action_ladder(code)
    with pytest.raises(NotImplementedError, match="item 11"):
        fuzz.run_trajectory(fuzz.Trajectory(seed=0, engine="overlap_tp"))
    # the multihost engine runs: sim-backend worker processes, its oracles
    # (the false-positive guard among them) and its cells
    traj = fuzz.FaultMutator(0, fuzz.CoverageDB(),
                             engines=(fuzz.MULTIHOST_ENGINE,)).propose(0)
    assert traj.engine == fuzz.MULTIHOST_ENGINE and traj.ops
    res = fuzz.run_trajectory(traj)
    assert res.violations == []
    assert res.cells and {c[2] for c in res.cells} == {fuzz.MULTIHOST_ENGINE}
    assert res.cells <= want


@pytest.mark.parametrize("path", SINGLE, ids=lambda p: p.stem)
def test_corpus_entry_replays_on_the_port(path, jax_weights, jax_kits):
    entry = fuzz.load_entry(str(path))
    traj = entry["trajectory"]
    res = fuzz.run_trajectory(traj)
    assert res.violations == []
    assert entry["status"] == "seed"
    if path.stem in LIVE:
        ref = jax_fuzz.run_trajectory(jax_fuzz.Trajectory.from_json(traj.to_json()))
        assert_outcomes_match(jax_weights, traj, res, ref)
        assert res.cells == ref.cells


def test_kits_are_deterministic():
    """A clean run replays bit for bit; an injected ladder stays bit-exact
    with its clean run and covers the ladder's cells."""
    traj = fuzz.Trajectory(seed=1, engine="overlap", n_requests=4,
                           prompt_len=5, max_new=12, max_request_retries=6,
                           ops=[fuzz.Op("word", cycle=2 + k, slot=k % 2, step=1,
                                        code=int(ErrorCode.NONFINITE_LOSS))
                                for k in range(4)])
    a, b = fuzz.run_trajectory(traj), fuzz.run_trajectory(traj)
    assert a.violations == b.violations == [] and a.digest() == b.digest()
    assert {("NONFINITE_LOSS", a_, "overlap")
            for a_ in ("skip_batch", "restore_good", "rollback")} <= a.cells


def test_default_model_is_on_the_card():
    """Without ``use_model`` the kits build on the card, and raise without
    one: like every entry point of the port, they never drop to the CPU."""
    runner.default_model.cache_clear()
    if torch.cuda.is_available():
        assert runner.default_model().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            runner.default_model()


def test_campaign_minimizes_and_writes_under_tmp_path(tmp_path, monkeypatch):
    corpus = tmp_path / "corpus"
    camp = fuzz.FuzzCampaign(seed=0, db=fuzz.CoverageDB(str(tmp_path / "cov.json")),
                             corpus_dir=str(corpus), engines=("overlap",))
    rep = camp.run(3)
    assert rep.ran == 3 and not rep.counterexamples
    assert rep.coverage["covered"] > 0 and (tmp_path / "cov.json").exists()
    for p in camp.promote_seeds(2):
        entry = fuzz.load_entry(p)
        again = fuzz.run_trajectory(entry["trajectory"])
        assert again.violations == [] and again.digest() == entry["digest"]
    # a planted fault: the real runs, failing wherever the culprit rides
    culprit = fuzz.Op("word", cycle=3, slot=1, step=2,
                      code=int(ErrorCode.NONFINITE_LOSS))
    noise = [fuzz.Op("word", cycle=c, slot=0, step=0, code=int(ErrorCode.USER))
             for c in (1, 2, 5)]

    def planted(traj):
        res = runner.run_trajectory(traj)
        if culprit in traj.ops:
            res.violations.append("planted")
        return res

    monkeypatch.setattr(campaign, "run_trajectory", planted)
    traj = fuzz.Trajectory(seed=0, engine="overlap", n_requests=4, prompt_len=7,
                           max_new=12, ops=noise[:2] + [culprit] + noise[2:])
    small, res = fuzz.minimize(traj)
    assert small.ops == (culprit,) and res.violations == ["planted"]
    assert (small.n_requests, small.max_new) == (2, 5)
    path = fuzz.write_entry(str(corpus), "ce", small, status="counterexample",
                            violations=res.violations, cells=res.cells)
    assert pathlib.Path(path).parent == corpus
    assert fuzz.load_entry(path)["trajectory"] == small
    monkeypatch.undo()
    assert fuzz.run_trajectory(small).violations == []
    assert not list(CORPUS.glob("ce*.json"))
