"""The port's group fuzz kit (``repro_torch.fuzz``, engine ``group``): the
reference corpus's group entries — a replica kill with a spare that
rejoins, and the same with a fleet crash replayed from the write-ahead log
— replay on the port's three-replica ``ServeGroup`` with zero violations
(complete, bit-exact against the port's clean group run, the merged
trace's ``validate()`` empty), and ``seed_group_0_11`` is held to a live
JAX ``run_trajectory``: equal outcomes ``(id, status, tokens)``, under the
near-tie exception of ``test_torch_fuzz.py``, and equal cells. Split from
``test_torch_fuzz.py`` so that the two spread over workers.
"""
import pathlib

import pytest
import torch

import repro.fuzz as jax_fuzz
from repro_torch import fuzz
from repro_torch.fuzz import runner
from test_torch_fuzz import assert_outcomes_match, jax_weights  # noqa: F401

torch.set_num_threads(2)

CORPUS = pathlib.Path(__file__).parent / "fuzz_corpus"
GROUP = sorted(CORPUS.glob("seed_group_*.json"))
LIVE = "seed_group_0_11"


@pytest.mark.parametrize("path", GROUP, ids=lambda p: p.stem)
def test_group_entry_replays_on_the_port(path, jax_weights):  # noqa: F811
    traj = fuzz.load_entry(str(path))["trajectory"]
    res = fuzz.run_trajectory(traj)
    assert res.violations == []
    assert ("RANK_FAILED", "reroute", "group") in res.cells
    if traj.ops_of("restart"):
        assert ("RANK_FAILED", "replay", "group") in res.cells
    if path.stem == LIVE:
        ref = jax_fuzz.run_trajectory(jax_fuzz.Trajectory.from_json(traj.to_json()))
        assert_outcomes_match(jax_weights, traj, res, ref)
        assert res.cells == ref.cells
    # the group kit is built once per (retries, ranks) and kept
    assert runner._group_kit.cache_info().currsize >= 1
