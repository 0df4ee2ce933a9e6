"""The port's tree probe (``probe_tree``, and ``grad_probe``/``param_probe``
over it) against the JAX package's on the CPU, and the fault-probe kernel's
segment planner (``kernels/fault_probe/ops.py``), which is plain Python.

The trees are made from a numpy seed and handed to both packages with the
same bits (bf16 leaves as their bit patterns). Words are bits, so every
comparison is exact: the port's word against the reference's
``probe_tree`` (``kernels/fault_probe/ops.py``, its plain path on the CPU),
its ``probe_tree_ref`` and, for leaves of k·256·128 elements, its Pallas
``probe_rows`` in interpret mode, OR-ed over the leaves.
"""
import ctypes
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import detect as jdetect
from repro.kernels.fault_probe import kernel as jax_kernel
from repro.kernels.fault_probe import ops as jax_ops
from repro.kernels.fault_probe import ref as jax_ref
from repro_torch.core import detect
from repro_torch.kernels import WRAPPERS, build, launch_counts
from repro_torch.kernels.fault_probe import ops, probe_tree, probe_tree_ref

NF, OV = 1 << 1, 1 << 3          # NONFINITE_GRAD, OVERFLOW (the JAX tests')
TILE = 256 * 128                  # one block of the Pallas kernel
THRESHOLDS = (1e4, 3.5, math.inf, 0.0, -1.0)
UNHELD = 10000.0007               # fp32 holds neither it nor anything
                                  # between it and its rounding, 10000.000977
# (dtype, shape) of each leaf: odd lengths, one element, an empty and an
# integer leaf; the Pallas layout's floating leaves hold k·256·128 elements
LAYOUTS = {
    "mixed": {"a": ("float32", (3, 5)), "b": ("bfloat16", (7,)),
              "c": ("float32", (1,)), "d": ("bfloat16", (0,)),
              "e": ("int32", (4,)), "f": ("float32", (2, 3, 11))},
    "tiles": {"t32": ("float32", (TILE,)), "t16": ("bfloat16", (2, TILE)),
              "e": ("int32", (3,))},
}


def _value(name: str, thr: float, dtype: str) -> float:
    """A fault's value: a special, ±threshold exactly, a subnormal of the
    leaf's dtype, or the fp32 neighbours of an unheld threshold."""
    if name == "subnormal":
        return 1e-44 if dtype == "float32" else 1e-39
    if name == "+thr":
        return thr
    if name == "-thr":
        return -thr
    if name == "rounded":                   # the threshold's fp32 rounding
        return float(np.float32(thr))
    if name == "above":
        return float(np.nextafter(np.float32(thr), np.float32(np.inf)))
    return {"nan": math.nan, "inf": math.inf, "-inf": -math.inf, "-0": -0.0}[name]


def _cases():
    cases = [("mixed", thr, None, None, None) for thr in THRESHOLDS + (UNHELD,)]
    for thr in THRESHOLDS:
        for leaf in ("a", "b", "c"):
            for pos in ("first", "last"):
                for val in ("nan", "inf", "-inf", "-0", "subnormal", "+thr", "-thr"):
                    cases.append(("mixed", thr, leaf, pos, val))
    for leaf in ("a", "c"):
        for pos in ("first", "last"):
            for val in ("rounded", "above"):
                cases.append(("mixed", UNHELD, leaf, pos, val))
    for thr in (1e4, math.inf, 0.0, -1.0, UNHELD):
        cases.append(("tiles", thr, None, None, None))
        for leaf, pos, val in (("t32", "first", "nan"), ("t16", "last", "-inf"),
                               ("t16", "first", "subnormal"), ("t32", "last", "+thr"),
                               ("t32", "first", "rounded"), ("t16", "last", "-0")):
            cases.append(("tiles", thr, leaf, pos, val))
    return cases


def _trees(layout, thr, leaf, pos, val, seed=0):
    """The same tree for both packages: torch tensors and jax arrays."""
    rng = np.random.default_rng(seed)
    port, ref = {}, {}
    for name, (dtype, shape) in LAYOUTS[layout].items():
        if dtype == "int32":
            t = torch.from_numpy(rng.integers(-5, 5, shape).astype(np.int32))
        else:
            # |x| < 1 keeps thresholds 1e4 and 3.5 quiet; at threshold 0 the
            # tree is zeros, so a subnormal's OVERFLOW bit shows
            x = np.zeros(shape, np.float32) if thr == 0 else \
                0.1 * rng.standard_normal(shape).astype(np.float32)
            t = torch.from_numpy(x).to(getattr(torch, dtype))
            if name == leaf:
                i = 0 if pos == "first" else t.numel() - 1
                t.view(-1)[i] = _value(val, thr, dtype)
        port[name] = t
        ref[name] = jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16)
                                if t.dtype == torch.bfloat16 else t.numpy())
    return port, ref


@pytest.mark.parametrize("case", _cases(), ids=lambda c: "-".join(map(str, c)))
def test_probe_tree_matches_jax(case):
    layout, thr, leaf, pos, val = case
    port, ref = _trees(*case)
    got = probe_tree(port, thr, nonfinite_code=NF, overflow_code=OV)
    assert got.dtype == torch.int32 and got.dim() == 0
    want = int(jax_ops.probe_tree(ref, thr, nonfinite_code=NF, overflow_code=OV))
    assert want == int(jax_ref.probe_tree_ref(ref, thr, nonfinite_code=NF,
                                              overflow_code=OV))
    # XLA's CPU backend compares with subnormals flushed to 0 (so does the
    # TPU); the port keeps them, on the CPU and in the kernel: at threshold
    # 0 a subnormal sets OVERFLOW in the port's word only, in a tree of
    # zeros otherwise
    flushed = OV if (val == "subnormal" and thr == 0) else 0
    assert want & flushed == 0
    assert int(got) == want | flushed
    assert int(probe_tree_ref(port, thr, nonfinite_code=NF, overflow_code=OV)) == int(got)
    assert int(detect.probe_tree(port, thr, nonfinite_code=NF, overflow_code=OV)) == int(got)
    if val in ("nan", "inf", "-inf"):
        assert want & NF
    # grad_probe at this threshold, param_probe at its own (inf)
    gw = detect.grad_probe(port, detect.ProbeConfig(overflow_threshold=thr))
    assert int(gw) == int(jdetect.grad_probe(ref, jdetect.ProbeConfig(
        overflow_threshold=thr))) | flushed
    assert int(detect.param_probe(port)) == int(jdetect.param_probe(ref))
    if layout == "tiles":
        pallas = 0
        for x in ref.values():
            if jnp.issubdtype(x.dtype, jnp.floating):
                pallas |= int(jax_kernel.probe_rows(
                    x.reshape(-1, 128), jnp.asarray(thr, jnp.float32),
                    nonfinite_code=NF, overflow_code=OV, block_rows=256,
                    interpret=True))
        assert pallas == want


# ------------------------------------------------------------ segment planner
@pytest.mark.parametrize("ptr, count, code, head, chunks", [
    (0, 1, 0, 0, 1),                   # one element
    (0, 8192, 0, 0, 1),                # one full fp32 chunk (32 KB)
    (0, 8193, 0, 0, 2),                # and one element past it
    (4, 8193, 0, 3, 1),                # misaligned head: 3 scalars + 8190
    (12, 8194, 0, 1, 2),               # head 1, 8193 after it
    (2, 16384, 1, 7, 1),               # bf16: 7 scalars + 16377
    (14, 16386, 1, 1, 2),
    (16, 16385, 1, 0, 2),              # aligned again
    (8, 2, 0, 2, 1),                   # fewer elements than the head
    (6, 3, 1, 3, 1),
])
def test_plan_heads_and_chunks(ptr, count, code, head, chunks):
    assert ops.head_elements(ptr, count, code) == head
    assert ops.leaf_chunks(ptr, count, code) == chunks


def test_plan_tree_offsets_and_prefix_sums():
    segs = [(0, 8193, 0), (4, 1, 0), (2, 40000, 1), (64, 100000, 0)]
    (launch,) = ops.plan_tree(segs)
    assert launch.ptrs == (0, 4, 2, 64)
    assert launch.counts == (8193, 1, 40000, 100000)
    assert launch.dtypes == (0, 0, 1, 0)
    # 2 + 1 + ceil(39993 / 16384) + ceil(100000 / 8192)
    assert launch.chunk_ends == (2, 3, 6, 19)
    ptrs, counts, dtypes, ends = launch.arrays()
    assert list(ends) == [2, 3, 6, 19] and list(dtypes) == [0, 0, 1, 0]
    assert ctypes.sizeof(ptrs) == 4 * 8 and ctypes.sizeof(dtypes) == 4 * 4


def test_plan_tree_splits_past_max_leaves():
    """More leaves than one table holds: several launches into one word,
    each with its own prefix sums."""
    n = 2 * ops.MAX_LEAVES + 3
    segs = [(16 * i, 1 + i % 9, i % 2) for i in range(n)]
    launches = ops.plan_tree(segs)
    assert [len(l.ptrs) for l in launches] == [ops.MAX_LEAVES, ops.MAX_LEAVES, 3]
    for launch in launches:
        assert launch.chunk_ends == tuple(range(1, len(launch.ptrs) + 1))
    assert sum((l.ptrs for l in launches), ()) == tuple(p for p, _, _ in segs)
    assert len(ops.plan_tree(segs[:ops.MAX_LEAVES])) == 1
    assert ops.plan_tree([]) == []


def test_plan_leaf_past_2_31_elements():
    """A bf16 leaf of 2^31 + 5 elements, planned but not allocated: its
    count crosses as 64 bits and its chunks cover every element."""
    n = 2 ** 31 + 5
    leaf = torch.empty(n, dtype=torch.bfloat16, device="meta")
    (seg,) = ops.tree_segments([leaf, torch.empty(0, device="meta")])
    assert seg == (leaf.data_ptr(), n, 1)
    (launch,) = ops.plan_tree([seg])
    per_chunk = ops.CHUNK_BYTES // 2
    head = ops.head_elements(seg[0], n, 1)
    assert launch.chunk_ends == (-(-(n - head) // per_chunk),)
    assert list(launch.arrays()[1]) == [n]


def test_tree_segments_skip_and_refuse():
    f = torch.ones(6)
    segs = ops.tree_segments([f, torch.arange(3), torch.empty(0), f[1:].bfloat16()])
    assert [(c, d) for _, c, d in segs] == [(6, 0), (5, 1)]
    with pytest.raises(TypeError, match="dtype"):
        ops.tree_segments([f.double()])


def test_probe_tree_wrapper_checks():
    """Dtypes the kernel does not take raise on every device, as in
    probe_rows; a tree over two devices raises; a tree off the CPU goes to
    the kernel path, which here raises (no fallback); non-floating and
    empty leaves give 0."""
    with pytest.raises(TypeError, match="dtype"):
        probe_tree({"a": torch.ones(3, dtype=torch.float64)}, 1.0,
                   nonfinite_code=NF, overflow_code=OV)
    with pytest.raises(ValueError, match="several devices"):
        probe_tree([torch.ones(3), torch.ones(3, device="meta")], 1.0,
                   nonfinite_code=NF, overflow_code=OV)
    with pytest.raises(ValueError, match="unsupported device"):
        probe_tree([torch.ones(3, device="meta")], 1.0, nonfinite_code=NF,
                   overflow_code=OV)
    with pytest.raises(ValueError, match="int32"):
        probe_tree([torch.ones(3)], 1.0, nonfinite_code=2 ** 31, overflow_code=OV)
    word = probe_tree({"i": torch.arange(4), "e": torch.empty(0), "t": []}, 0.0,
                      nonfinite_code=NF, overflow_code=OV)
    assert word.dtype == torch.int32 and int(word) == 0
    x = torch.zeros(4, 4)
    x[3, 0] = math.nan
    assert int(probe_tree([x.t()], 1.0, nonfinite_code=NF, overflow_code=OV)) == NF


def test_probe_tree_is_a_counted_wrapper():
    assert probe_tree in WRAPPERS and "probe_tree" in launch_counts()
    L, P = ctypes.c_longlong, ctypes.c_void_p
    sig = build.SIGNATURES["repro_probe_tree"]
    assert sig[:4] == (P,) * 4 and sig[4] is ctypes.c_int
    assert sig[5] is ctypes.c_float and sig[8] is P and sig[10] is P
    assert build.SIGNATURES["repro_probe_rows"][2] is L
