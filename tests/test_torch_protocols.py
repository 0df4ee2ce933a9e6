"""The paper's host protocols in the port (``repro_torch.core``): the
scenarios of ``test_core_blackchannel.py`` (§III-B), ``test_core_ulfm.py``
(§III-C) and ``test_protocol_properties.py`` (P1 agreement, P1/P4 with kills,
the P3 enumeration oracle) run against the port, and one seeded script of
signals and kills runs through both packages' ``run_ranks``: every rank ends
with the same exception class, the same enumerated ``(rank, code)`` list and
the same survivors. The copied fault plan (``core/faults.py``) resolves,
draws and validates as the reference's.

``T`` is the reference's generous protocol timeout: a deadlock fails fast
instead of hanging the suite.
"""
import threading
import time

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core as jax_core
import repro.core.faults as jax_faults
import repro_torch.core as core
import repro_torch.core.faults as faults
from repro_torch.core import (
    CommCorruptedError,
    ErrorCode,
    PropagatedError,
    RevokedError,
    TimeoutError_,
    initialize,
    run_ranks,
)
from repro_torch.core.device_channel import decode_table, enumerate_errors_ref

T = 20.0


def _world(ctx):
    return initialize(ctx, default_timeout=T).comm_world()


def _assert_clean(res):
    for r in res:
        assert r.exception is None, r.exception


# ----------------------------------------------------------- Black-Channel
def test_basic_send_recv():
    def fn(ctx):
        comm = _world(ctx)
        f = comm.send(42, dst=1) if comm.rank == 0 else comm.recv(src=0)
        return f.wait()

    res = run_ranks(2, fn)
    _assert_clean(res)
    assert res[1].value == 42


def test_propagation_releases_waiting_ranks():
    """The paper's core claim: a local exception no longer deadlocks remote
    waits."""
    def fn(ctx):
        comm = _world(ctx)
        if comm.rank == 0:
            try:
                raise ValueError("local failure on rank 0")
            except ValueError:
                with pytest.raises(PropagatedError):
                    comm.signal_error(666)
            return "signalled"
        f = comm.recv(src=0)          # never matched
        with pytest.raises(PropagatedError) as ei:
            f.wait()
        assert [(e.rank, e.code) for e in ei.value.errors] == [(0, 666)]
        return "released"

    res = run_ranks(4, fn)
    _assert_clean(res)
    assert [r.value for r in res] == ["signalled"] + ["released"] * 3


def test_without_channel_deadlocks():
    """Control: the raw transport (no black channel) deadlocks — what the
    paper's technique precludes."""
    def fn(ctx):
        if ctx.rank == 0:
            return "rank0 threw and sent nothing"
        req = ctx.irecv(ctx.world, 0, 0)
        with pytest.raises(TimeoutError_):
            ctx.wait(req, timeout=0.3)
        return "timed out"

    res = run_ranks(2, fn)
    assert res[1].value == "timed out"


@pytest.mark.parametrize("ulfm, nranks, signallers", [
    (False, 6, {0: 100, 1: 101}),            # simultaneous signalling
    (False, 6, {1: 7, 3: 9, 4: 11}),         # enumeration order and codes
    (True, 5, {1: 51, 2: 52}),               # multiple signallers, ULFM
])
def test_every_rank_gets_the_rank_ordered_table(ulfm, nranks, signallers):
    """Several ranks signal at once (why the paper uses ``MPI_Issend``):
    every rank gets the full table, in rank order."""
    def fn(ctx):
        comm = _world(ctx)
        if comm.rank in signallers:
            with pytest.raises(PropagatedError) as ei:
                comm.signal_error(signallers[comm.rank])
        else:
            with pytest.raises(PropagatedError) as ei:
                comm.recv(src=(comm.rank + 1) % comm.size).wait()
        return [(e.rank, e.code) for e in ei.value.errors]

    res = run_ranks(nranks, fn, ulfm=ulfm)
    _assert_clean(res)
    for r in res:
        assert r.value == sorted(signallers.items())


@pytest.mark.parametrize("ulfm", [False, True], ids=["blackchannel", "ulfm"])
def test_corrupted_communicator_on_unwinding(ulfm):
    """An exception escaping the Comm scope ⇒ every other rank throws
    ``CommCorruptedError`` (ULFM: revoke + agree(0))."""
    def fn(ctx):
        inst = initialize(ctx, default_timeout=T)
        if ctx.rank == 0:
            with pytest.raises(RuntimeError):
                with inst.comm_world():
                    raise RuntimeError("unwinding through comm scope")
            return "unwound"
        with inst.comm_world() as comm:
            with pytest.raises(CommCorruptedError):
                comm.recv(src=0).wait()
            return "corrupted observed"

    res = run_ranks(3, fn, ulfm=ulfm)
    _assert_clean(res)
    assert [r.value for r in res] == ["unwound"] + ["corrupted observed"] * 2


def test_channel_reuse_after_propagated_error():
    """A propagated error leaves the communicator usable: no revoke and no
    new communicator needed."""
    def fn(ctx):
        comm = _world(ctx)
        if comm.rank == 0:
            with pytest.raises(PropagatedError):
                comm.signal_error(5)
        else:
            with pytest.raises(PropagatedError):
                comm.recv(src=0).wait()
        if comm.rank == 0:
            comm.send(99, dst=1).wait()
            return "ok"
        if comm.rank == 1:
            return comm.recv(src=0).wait()
        return "ok"

    res = run_ranks(3, fn)
    _assert_clean(res)
    assert res[1].value == 99


def test_wait_sees_error_even_after_own_completion():
    """After the user request completed, a later wait still surfaces an
    error signalled meanwhile."""
    release = threading.Event()

    def fn(ctx):
        comm = _world(ctx)
        if comm.rank == 0:
            comm.send(1, dst=1).wait()
            release.wait(timeout=T)
            with pytest.raises(PropagatedError):
                comm.signal_error(13)
            return "signalled"
        f = comm.recv(src=0)
        while not f.test():
            pass
        release.set()
        f.wait()
        with pytest.raises(PropagatedError):
            comm.recv(src=0).wait()
        return "saw error"

    _assert_clean(run_ranks(2, fn))


def test_cancel_semantics():
    def fn(ctx):
        comm = _world(ctx)
        if comm.rank == 0:
            assert comm.recv(src=1, tag=5).cancel() is True   # unmatched
        comm.barrier()
        return "ok"

    _assert_clean(run_ranks(2, fn))


@pytest.mark.parametrize("nranks", [2, 3, 8, 16])
def test_scales_with_ranks(nranks):
    def fn(ctx):
        comm = _world(ctx)
        if comm.rank == nranks - 1:
            with pytest.raises(PropagatedError) as ei:
                comm.signal_error(1)
        else:
            with pytest.raises(PropagatedError) as ei:
                comm.recv(src=(comm.rank + 1) % comm.size).wait()
        return [(e.rank, e.code) for e in ei.value.errors]

    res = run_ranks(nranks, fn)
    _assert_clean(res)
    assert all(r.value == [(nranks - 1, 1)] for r in res)


# -------------------------------------------------------------------- ULFM
def test_signal_error_via_revoke():
    """signal_error revokes; agree(1); shrink; enumeration — all ranks see
    it, and the shrunk communicator (same members) works."""
    def fn(ctx):
        comm = _world(ctx)
        if comm.rank == 0:
            with pytest.raises(PropagatedError) as ei:
                comm.signal_error(ErrorCode.USER)
        else:
            with pytest.raises(PropagatedError) as ei:
                comm.recv(src=0).wait()
        assert [(e.rank, e.code) for e in ei.value.errors] == [
            (0, int(ErrorCode.USER))]
        assert comm.size == 4
        comm.barrier()
        return "ok"

    res = run_ranks(4, fn, ulfm=True)
    _assert_clean(res)
    assert all(r.value == "ok" for r in res)


def test_hard_fault_detected_and_corrupts():
    """Rank death ⇒ survivors throw ``CommCorruptedError`` (agree = 0)."""
    def fn(ctx):
        comm = _world(ctx)
        if comm.rank == 2:
            ctx.die()
        with pytest.raises(CommCorruptedError):
            comm.recv(src=2).wait()
        return "observed hard fault"

    res = run_ranks(3, fn, ulfm=True)
    assert res[2].killed
    _assert_clean(res[:2])
    assert all(r.value == "observed hard fault" for r in res[:2])


def test_shrink_recovery_after_hard_fault():
    """Use case 1 (LFLR): survivors shrink and go on with fewer ranks."""
    def fn(ctx):
        comm = _world(ctx)
        if comm.rank == 1:
            ctx.die()
        with pytest.raises(CommCorruptedError):
            comm.recv(src=1).wait()
        comm.shrink_to_survivors()
        nxt, prv = (comm.rank + 1) % comm.size, (comm.rank - 1) % comm.size
        fs = comm.send(comm.rank, dst=nxt)
        got = comm.recv(src=prv).wait()
        fs.wait()
        assert got == prv
        return comm.size

    res = run_ranks(4, fn, ulfm=True)
    assert res[1].killed
    for i in (0, 2, 3):
        assert res[i].exception is None, res[i].exception
        assert res[i].value == 3


def test_revoked_error_on_plain_op():
    def fn(ctx):
        if ctx.rank == 0:
            ctx.revoke(ctx.world)
            return "revoked"
        for _ in range(100):
            if ctx.world.revoked:
                break
            time.sleep(0.01)
        with pytest.raises(RevokedError):
            ctx.isend(ctx.world, 0, 0, "x")
        return "saw revoked"

    _assert_clean(run_ranks(2, fn, ulfm=True))


def test_agree_is_fault_tolerant():
    """``agree`` completes among survivors when a rank dies mid-call."""
    def fn(ctx):
        if ctx.rank == 1:
            ctx.die()
        return ctx.agree(ctx.world, 1, timeout=T)

    res = run_ranks(3, fn, ulfm=True)
    assert res[1].killed
    assert res[0].value == 1 and res[2].value == 1


# ------------------------------------------------------------- properties
@settings(max_examples=10, deadline=None)
@given(st.data())
def test_p1_agreement_blackchannel(data):
    nranks = data.draw(st.integers(2, 8), label="nranks")
    signallers = data.draw(
        st.dictionaries(st.integers(0, nranks - 1), st.integers(1, 1000),
                        min_size=1, max_size=nranks), label="signallers")

    def fn(ctx):
        comm = _world(ctx)
        try:
            if comm.rank in signallers:
                comm.signal_error(signallers[comm.rank])
            else:
                comm.recv(src=(comm.rank + 1) % comm.size).wait()
        except PropagatedError as e:
            return [(x.rank, x.code) for x in e.errors]
        return None

    res = run_ranks(nranks, fn, join_timeout=T * 3)
    for r in res:
        assert r.exception is None, (r.rank, r.exception)
        assert r.value == sorted(signallers.items())   # P1


@settings(max_examples=8, deadline=None)
@given(st.data())
def test_p1_p4_ulfm_with_kills(data):
    nranks = data.draw(st.integers(3, 7), label="nranks")
    victim = data.draw(st.integers(1, nranks - 1), label="victim")

    def fn(ctx):
        comm = _world(ctx)
        if comm.rank == victim:
            ctx.die()
        try:
            comm.recv(src=victim).wait()
        except CommCorruptedError:
            comm.shrink_to_survivors()
            return comm.size
        return None

    res = run_ranks(nranks, fn, ulfm=True, join_timeout=T * 3)
    assert res[victim].killed
    assert {r.value for r in res if not r.killed} == {nranks - 1}    # P4
    assert all(r.exception is None for r in res if not r.killed)     # P2


@settings(max_examples=50, deadline=None)
@given(st.lists(st.integers(0, 2**20), min_size=1, max_size=24))
def test_p3_enumeration_oracle(words):
    """The port's device enumeration against straight python."""
    count, table = enumerate_errors_ref(
        torch.tensor(words, dtype=torch.int32), max_errors=8)
    got = [(e.rank, e.code) for e in decode_table(int(count), table.numpy())]
    assert int(count) == sum(1 for w in words if w)
    assert got == [(i, w) for i, w in enumerate(words) if w][:8]


# ------------------------------------------------------ against the JAX package
def _script(seed):
    """A seeded script: ULFM or not, the ranks, two rounds of signallers
    and (ULFM) the ranks killed after them."""
    rng = np.random.default_rng(seed)
    ulfm = bool(seed % 2)
    nranks = int(rng.integers(3, 8))

    def signals():
        who = rng.choice(nranks, size=int(rng.integers(1, nranks)), replace=False)
        return {int(r): int(rng.integers(1, 1 << 16)) for r in who}

    rounds = [signals(), signals()]
    victims = (sorted(int(v) for v in rng.choice(
        np.arange(1, nranks), size=int(rng.integers(1, nranks - 1)),
        replace=False)) if ulfm else [])
    return ulfm, nranks, rounds, victims


def _run_script(pkg, seed):
    """Run :func:`_script` through ``pkg`` (``repro.core`` or
    ``repro_torch.core``): per rank, each round's exception class and
    ``(rank, code)`` list, then the survivors, or ``"killed"``."""
    ulfm, nranks, rounds, victims = _script(seed)

    def fn(ctx):
        comm = pkg.initialize(ctx, default_timeout=T).comm_world()
        out = []
        for signallers in rounds:
            try:
                if comm.rank in signallers:
                    comm.signal_error(signallers[comm.rank])
                else:
                    comm.recv(src=(comm.rank + 1) % comm.size).wait()
                out.append(("none", []))
            except (pkg.PropagatedError, pkg.CommCorruptedError) as e:
                out.append((type(e).__name__,
                            [(x.rank, x.code) for x in e.errors]))
        if victims:
            if ctx.rank in victims:
                ctx.die()
            while not set(victims) <= ctx.t.dead:     # every death landed
                time.sleep(0.001)
            try:
                comm.recv(src=comm.context.local_rank(victims[0])).wait()
                out.append(("none", []))
            except pkg.CommCorruptedError as e:
                out.append((type(e).__name__,
                            [(x.rank, x.code) for x in e.errors]))
                comm.shrink_to_survivors()
        out.append(("survivors", list(comm.context.members)))
        return out

    res = pkg.run_ranks(nranks, fn, ulfm=ulfm, join_timeout=T * 3)
    return ["killed" if r.killed else (r.value if r.exception is None
                                       else type(r.exception).__name__)
            for r in res]


@pytest.mark.parametrize("seed", range(6))
def test_seeded_script_agrees_with_the_reference(seed):
    ulfm, nranks, rounds, victims = _script(seed)
    ref = _run_script(jax_core, seed)
    got = _run_script(core, seed)
    assert got == ref
    survivors = [r for r in range(nranks) if r not in victims]
    for rank, outcome in enumerate(got):
        if rank in victims:
            assert outcome == "killed"
            continue
        assert [o[1] for o in outcome[:2]] == [sorted(s.items()) for s in rounds]
        assert outcome[-1] == ("survivors", survivors)
        if victims:
            assert outcome[2] == ("CommCorruptedError", [])


# ------------------------------------------------------------- the fault plan
def test_fault_plan_matches_the_reference():
    """The copied host half of ``core/faults.py``: the same kinds, the same
    wildcard resolution and per-(rank, step) draws from one seed, the same
    injectable codes, the same host-fault outcomes."""
    assert faults.KNOWN_KINDS == jax_faults.KNOWN_KINDS
    assert faults.INJECTABLE_CODE_MASK == jax_faults.INJECTABLE_CODE_MASK
    kinds = ["kill", "state_nan", "straggle", "code", "shard_kill"]
    specs = [dict(step=s, kind=kinds[s % 5], rank=None if s % 2 else s % 3)
             for s in range(10)]
    for seed in range(4):
        got = faults.FaultSchedule([faults.FaultSpec(**d) for d in specs],
                                   seed=seed).resolve([4, 1, 7])
        want = jax_faults.FaultSchedule(
            [jax_faults.FaultSpec(**d) for d in specs], seed=seed).resolve([4, 1, 7])
        assert [vars(s) for s in got.specs] == [vars(s) for s in want.specs]
        assert [(s.step, s.rank) for s in got.at(3)] == [
            (s.step, s.rank) for s in want.at(3)]
        assert (got.rng_for(1, 3).integers(1 << 30, size=4).tolist()
                == want.rng_for(1, 3).integers(1 << 30, size=4).tolist())
    words = [0, *(1 << b for b in range(32)), 0b11, (1 << 19) | 1, (1 << 24) | 2]
    for w in words:
        try:
            want = jax_faults.validate_injectable_code(w)
        except ValueError:
            with pytest.raises(ValueError):
                faults.validate_injectable_code(w)
        else:
            assert faults.validate_injectable_code(w) == want
    for kind in ("user", "straggle", "kill", "host_kill", "state_nan"):
        spec = dict(step=0, kind=kind, magnitude=0.0)
        try:
            want = jax_faults.apply_host_fault(jax_faults.FaultSpec(**spec))
        except ValueError:
            with pytest.raises(ValueError):
                faults.apply_host_fault(faults.FaultSpec(**spec))
        else:
            assert faults.apply_host_fault(faults.FaultSpec(**spec)) == want
