"""The port's error channel against the JAX package's: the enumeration table,
the window fold, the exceptions ``wait()`` raises and the per-(step, slot)
attribution — all bit-equal on the same numpy-seeded words."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import device_channel as jdc
from repro.core.errors import CommCorruptedError as JaxCommCorrupted
from repro.core.errors import PropagatedError as JaxPropagated
from repro.serve.replica import make_window_enum_fn
from repro_torch.core import device_channel as tdc
from repro_torch.core.errors import CommCorruptedError, ErrorCode, PropagatedError
from repro_torch.serve.replica import window_enum

CODES = [0, 0, 0, int(ErrorCode.NONFINITE_LOSS), int(ErrorCode.STATE_FAULT),
         int(ErrorCode.PAGE_FAULT), int(ErrorCode.USER | ErrorCode.OVERFLOW)]


def _words(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.choice(CODES, size=shape).astype(np.uint32)


@pytest.mark.parametrize("n,max_errors", [(1, 8), (5, 8), (12, 4), (8, 8)])
@pytest.mark.parametrize("seed", range(3))
def test_enumeration_matches_jax(n, max_errors, seed):
    w = _words((n,), seed)
    jc, jt = jdc.enumerate_errors_ref(jnp.asarray(w), max_errors=max_errors)
    tc, tt = tdc.enumerate_errors_ref(torch.from_numpy(w.astype(np.int32)),
                                      max_errors=max_errors)
    assert int(tc) == int(jc)
    np.testing.assert_array_equal(tt.numpy().astype(np.uint32), np.asarray(jt))


@pytest.mark.parametrize("seed", range(4))
def test_window_enum_matches_jax(seed):
    K, S = 4, 5
    hist = _words((K, S), seed)
    mask = np.asarray([1, 1, 0, 1, 1], np.uint32)
    jout = make_window_enum_fn(S)(jnp.asarray(hist), jnp.asarray(mask))
    tout = window_enum(torch.from_numpy(hist.astype(np.int32)),
                       torch.from_numpy(mask.astype(np.int32)))
    for j, t in zip(jout, tout):
        np.testing.assert_array_equal(t.numpy().astype(np.uint32), np.asarray(j))


def test_or_reduce_and_combine():
    w = torch.from_numpy(_words((6, 3), 9).astype(np.int32))
    want = np.bitwise_or.reduce(w.numpy(), axis=0)
    np.testing.assert_array_equal(tdc.or_reduce(w, dim=0).numpy(), want)
    assert int(tdc.combine_words(*w[0])) == int(np.bitwise_or.reduce(w[0].numpy()))
    top = torch.tensor([1 << 25, 1 << 30], dtype=torch.int32)
    assert int(tdc.or_reduce(top, dim=0)) == (1 << 25) | (1 << 30)


@pytest.mark.parametrize("seed", range(3))
def test_future_wait_and_attribution_match_jax(seed):
    """Same words: same exception type and (rank, code) pairs at wait(),
    same first faulting step and per-slot codes; one readback per wait."""
    K, S = 3, 4
    hist = _words((K, S), seed)
    hist[:, 0] = 0
    mask = np.ones(S, np.uint32)
    jc, jn, jt, jh = make_window_enum_fn(S)(jnp.asarray(hist), jnp.asarray(mask))
    jfut = jdc.DeviceFuture(outputs="x", word=jc, count=jn, table=jt, history=jh)
    c, n, t, h = window_enum(torch.from_numpy(hist.astype(np.int32)),
                             torch.from_numpy(mask.astype(np.int32)))
    tfut = tdc.DeviceFuture(outputs="x", word=c, count=n, table=t, history=h)
    try:
        jfut.wait()
        jerr = None
    except JaxPropagated as e:
        jerr = [(x.rank, x.code) for x in e.errors]
    before = tdc.readback.count
    try:
        assert tfut.wait() == "x"
        terr = None
    except PropagatedError as e:
        terr = [(x.rank, x.code) for x in e.errors]
    assert tdc.readback.count == before + 1
    assert terr == jerr
    np.testing.assert_array_equal(tfut.fault_steps(), jfut.fault_steps())
    np.testing.assert_array_equal(tfut.fault_codes(), jfut.fault_codes())
    np.testing.assert_array_equal(
        tfut.fault_codes(ignore=int(ErrorCode.PAGE_FAULT)),
        jfut.fault_codes(ignore=int(ErrorCode.PAGE_FAULT)))


def test_comm_corrupted_word_raises_comm_corrupted():
    word = int(ErrorCode.COMM_CORRUPTED)
    jfut = jdc.DeviceFuture(outputs=None, word=jnp.uint32(word))
    with pytest.raises(JaxCommCorrupted):
        jfut.wait()
    tfut = tdc.DeviceFuture(outputs=None,
                            word=torch.tensor(word, dtype=torch.int32))
    with pytest.raises(CommCorruptedError):
        tfut.wait()
