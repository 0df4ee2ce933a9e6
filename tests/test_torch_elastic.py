"""The port's elastic trainer (``repro_torch.launch.elastic``) and buddy
store (``repro_torch.checkpoint.BuddyStore``) against the JAX package's, on
the CPU.

The reference's four ``test_elastic.py`` cases — fault-free convergence,
a soft fault every rank skips, a kill and shrink, two kills — run through
both packages: the killed ranks, and each survivor's ``events``,
``steps_done`` and ``world_sizes``, are equal exactly; the weights agree
within rtol 1e-5 (XLA's and torch's fp32 gradients may round apart); and
the reference's own assertions hold on the port. The store keeps a host
copy that a later in-place update of the pushed tensor leaves intact.
"""
import numpy as np
import pytest
import torch

from repro.checkpoint import BuddyStore as JaxBuddyStore
from repro.core.faults import FaultSchedule as JaxFaultSchedule
from repro.core.faults import FaultSpec as JaxFaultSpec
from repro.launch.elastic import elastic_train as jax_elastic_train
from repro_torch.checkpoint import BuddyStore
from repro_torch.core.faults import FaultSchedule, FaultSpec
from repro_torch.launch.elastic import ElasticResult, elastic_train

WEIGHT_RTOL = 1e-5

# name: (ranks, steps, fault specs)
CASES = {
    "fault_free_convergence": (4, 30, []),
    "soft_fault_propagates_and_all_skip": (
        4, 20, [dict(step=5, kind="nan_grad", rank=2)]),
    "hard_fault_shrinks_and_survivors_finish": (
        4, 25, [dict(step=8, kind="kill", rank=1)]),
    "two_kills_two_shrinks": (
        5, 20, [dict(step=6, kind="kill", rank=1), dict(step=14, kind="kill", rank=3)]),
}


def _run_both(nranks, steps, specs):
    ref = jax_elastic_train(nranks, steps=steps, lr=0.2, faults=JaxFaultSchedule(
        [JaxFaultSpec(**s) for s in specs]))
    got = elastic_train(nranks, steps=steps, lr=0.2, device="cpu",
                        faults=FaultSchedule([FaultSpec(**s) for s in specs]))
    return ref, got


@pytest.mark.parametrize("case", list(CASES))
def test_elastic_train_decides_as_the_reference(case):
    nranks, steps, specs = CASES[case]
    ref, got = _run_both(nranks, steps, specs)
    assert [r.killed for r in got] == [r.killed for r in ref]
    killed = {s["rank"] for s in specs if s["kind"] == "kill"}
    assert {r.rank for r in got if r.killed} == killed
    for a, b in zip(ref, got):
        if a.killed:
            continue
        assert a.exception is None and b.exception is None, (a.exception, b.exception)
        u, v = a.value, b.value
        assert isinstance(v, ElasticResult) and v.rank == u.rank
        assert (v.events, v.steps_done, v.world_sizes) == (
            u.events, u.steps_done, u.world_sizes)
        np.testing.assert_allclose(v.weights, u.weights, rtol=WEIGHT_RTOL)
        assert v.weights.dtype == np.float32 and v.weights.shape == (16, 1)
        np.testing.assert_allclose(v.final_loss, u.final_loss, rtol=1e-3, atol=1e-9)
    survivors = [r.value for r in got if not r.killed]
    # the reference's own assertions, on the port
    if case == "fault_free_convergence":
        assert all(v.steps_done == 30 and v.final_loss < 1e-2 for v in survivors)
    elif case == "soft_fault_propagates_and_all_skip":
        for v in survivors:
            ev = [e for e in v.events if e[0] == "propagated"]
            assert len(ev) == 1 and ev[0][2] == [2]
            assert v.final_loss < 1e-2
    elif case == "hard_fault_shrinks_and_survivors_finish":
        for v in survivors:
            ev = [e for e in v.events if e[0] == "shrink"]
            assert len(ev) == 1 and ev[0][2] == 3
            assert v.world_sizes[-1] == 3 and v.final_loss < 5e-2
        for v in survivors[1:]:
            np.testing.assert_allclose(v.weights, survivors[0].weights, rtol=1e-6)
    else:
        assert all(v.world_sizes[-1] == 3 for v in survivors)


def test_elastic_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        elastic_train(2, steps=1)


def test_buddy_store_keeps_a_host_copy():
    for store in (BuddyStore(4), JaxBuddyStore(4)):
        assert [store.buddy_of(r) for r in range(4)] == [1, 2, 3, 0]
        assert store.recover(1) is None and store.ranks_covered() == []
    mine, ref = BuddyStore(4, stride=2), JaxBuddyStore(4, stride=2)
    assert [mine.buddy_of(r) for r in range(4)] == [ref.buddy_of(r) for r in range(4)]
    w = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    tree = {"w": w, "opt": [w * 2, {"b": torch.ones(2)}]}
    mine.push(2, 10, tree)
    ref.push(2, 10, {"w": w.numpy().copy(), "opt": [w.numpy() * 2,
                                                     {"b": np.ones(2, np.float32)}]})
    w.add_(100.0)                                 # an optimizer step, in place
    tree["opt"][1]["b"].mul_(0.0)
    step, got = mine.recover(2)
    assert step == 10 and ref.recover(2)[0] == 10
    np.testing.assert_array_equal(got["w"], np.arange(6, dtype=np.float32).reshape(3, 2))
    np.testing.assert_array_equal(got["opt"][0], ref.recover(2)[1]["opt"][0])
    np.testing.assert_array_equal(got["opt"][1]["b"], np.ones(2, np.float32))
    assert all(isinstance(x, np.ndarray) for x in (got["w"], got["opt"][0]))
    mine.push(0, 5, {"w": torch.zeros(1)})
    ref.push(0, 5, {"w": np.zeros(1)})
    assert mine.ranks_covered() == ref.ranks_covered() == [0, 2]
    mine.drop(2)
    ref.drop(2)
    mine.drop(3)                                  # not covered: a no-op
    assert mine.ranks_covered() == ref.ranks_covered() == [0]
    assert mine.recover(2) is None
