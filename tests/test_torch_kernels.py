"""The port's kernels (plain versions, on the CPU) against the JAX package's
Pallas kernels in interpret mode, on the same numpy-seeded inputs; and the
CUDA wrappers' input checks, which run before any device dispatch."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fault_probe.kernel import probe_rows as jax_probe_rows
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import sdpa_ref as jax_sdpa_ref
from repro_torch.kernels import (build, flash_attention, launch_counts,
                                 probe_rows, rglru_scan, rglru_scan_bwd,
                                 ssd_chunk_bwd, ssd_scan)
from repro_torch.kernels.flash_attention import sdpa_ref
from repro_torch.kernels.flash_attention.ops import (DECODE_TILE, MAX_SPLITS,
                                                     SPLIT_TARGET, plan)
from test_kernels import FLASH_CASES

torch.set_num_threads(2)

NF, OV = 1 << 1, 1 << 3          # NONFINITE_GRAD, OVERFLOW (the JAX tests')


def _inputs(case, dtype_np, seed=0):
    B, S, T, Hq, Hkv, D = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32).astype(dtype_np)
            for shape in ((B, S, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D))]


# ------------------------------------------------------------ flash attention
@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_jax_kernel(case, dtype):
    """The port's flash path on the CPU (its plain version) against the JAX
    Pallas kernel in interpret mode. Tolerances as the JAX kernel tests:
    fp32 2e-5 (reduction order), bf16 3e-2 (one bf16 rounding of the output
    plus bf16 inputs)."""
    B, S, T, Hq, Hkv, D, causal, window, bq, bkv = case
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    q, k, v = (jnp.asarray(a, jdt) for a in _inputs(case, np.float32))
    want = jax_flash(q, k, v, causal=causal, window=window, block_q=bq,
                     block_kv=bkv)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    tq, tk, tv = (torch.from_numpy(np.array(a, np.float32)).to(tdt)
                  for a in (q, k, v))
    got = flash_attention(tq, tk, tv, torch.zeros(B, dtype=torch.int32),
                          causal=causal, window=window)
    tol = 2e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def test_flash_per_slot_offsets_match_sdpa_ref():
    """Per-slot runtime ``q_offset`` (the serving decode form, including a
    position past the capacity) equals the JAX ``sdpa_ref`` run slot by slot
    with that slot's static ``q_offset``. fp32: tolerance 1e-5 for the
    reduction order."""
    B, S, T, Hq, Hkv, D = 4, 1, 40, 4, 2, 16
    q, k, v = _inputs((B, S, T, Hq, Hkv, D), np.float32, seed=3)
    offsets = [0, 7, T - 1, T + 5]
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          torch.tensor(offsets, dtype=torch.int32), causal=True)
    for b, off in enumerate(offsets):
        want = jax_sdpa_ref(jnp.asarray(q[b:b + 1]), jnp.asarray(k[b:b + 1]),
                            jnp.asarray(v[b:b + 1]), causal=True, q_offset=off)
        np.testing.assert_allclose(got[b:b + 1].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_flash_seq_kv_masks_padding():
    """Keys at positions >= seq_kv never contribute (the kernel's padding
    mask): padded K/V give the unpadded answer exactly."""
    q, k, v = (torch.from_numpy(a) for a in _inputs((2, 6, 10, 4, 2, 16),
                                                     np.float32, seed=4))
    off = torch.tensor([0, 3], dtype=torch.int32)
    pad = lambda t: torch.cat([t, torch.full_like(t[:, :5], 1e3)], 1)  # noqa: E731
    got = flash_attention(q, pad(k), pad(v), off, causal=False, seq_kv=10)
    want = flash_attention(q, k, v, off, causal=False)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ------------------------------------------------------------------ the probe
def _probe_stream(rows, faults, seed=0):
    x = np.random.default_rng(seed).uniform(-10, 10, (rows, 128)).astype(np.float32)
    for r, c, val in faults:
        x[r, c] = val
    return x


PROBE_CASES = [
    [],
    [(3, 5, np.nan)],
    [(0, 0, np.inf)],
    [(7, 127, -np.inf)],
    [(4, 64, 2e4)],                          # over the threshold
    [(2, 1, -2e4)],
    [(1, 1, np.nan), (5, 9, 3e4)],           # both bits
    [(6, 2, np.inf), (6, 3, 1e4)],           # exactly at threshold: no OV
]


@pytest.mark.parametrize("faults", PROBE_CASES)
@pytest.mark.parametrize("threshold", [1e4, np.inf])
def test_probe_plain_matches_jax_kernel(faults, threshold):
    """One row holding the whole stream gives the JAX kernel's word; words
    are compared bit for bit."""
    x = _probe_stream(8, faults)
    want = int(jax_probe_rows(jnp.asarray(x), jnp.asarray(threshold),
                              nonfinite_code=NF, overflow_code=OV,
                              block_rows=8, interpret=True))
    got = probe_rows(torch.from_numpy(x).reshape(1, -1), threshold,
                     nonfinite_code=NF, overflow_code=OV)
    assert got.dtype == torch.int32 and got.tolist() == [want]


@pytest.mark.parametrize("cols", [1000, 1024, 129])
def test_probe_rows_per_row_and_padding(cols):
    """Each row's word equals the JAX kernel's word over that row alone,
    zero-padded to its (8k, 128) tile grid (zeros never fire)."""
    rng = np.random.default_rng(cols)
    x = rng.standard_normal((5, cols)).astype(np.float32)
    x[1, cols - 1] = np.nan
    x[2, 0] = 5e4
    x[3, cols // 2] = -np.inf
    x[3, 1] = 5e4
    got = probe_rows(torch.from_numpy(x), 1e4, nonfinite_code=NF,
                     overflow_code=OV).tolist()
    tile = 8 * 128
    want = []
    for row in x:
        padded = np.zeros(-(-cols // tile) * tile, np.float32)
        padded[:cols] = row
        want.append(int(jax_probe_rows(jnp.asarray(padded.reshape(-1, 128)),
                                       jnp.asarray(1e4), nonfinite_code=NF,
                                       overflow_code=OV, block_rows=8,
                                       interpret=True)))
    assert got == want == [0, NF, OV, NF | OV, 0]


def test_probe_bf16_input():
    x = torch.zeros((2, 300), dtype=torch.bfloat16)
    x[1, 299] = float("nan")
    assert probe_rows(x, np.inf, nonfinite_code=NF, overflow_code=OV).tolist() == [0, NF]


# --------------------------------------------------------- wrapper input checks
def _qkv(dtype=torch.float32):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _inputs((2, 3, 5, 4, 2, 16),
                                                              np.float32))
    return q, k, v, torch.zeros(2, dtype=torch.int32)


@pytest.mark.parametrize("bad", [
    lambda q, k, v, o: (q[..., :8], k, v, o),                   # head_dim
    lambda q, k, v, o: (q, k[:1], v[:1], o),                    # batch
    lambda q, k, v, o: (q[:, :, :3], k, v, o),                  # group
    lambda q, k, v, o: (q, k, v[:, :4], o),                     # k vs v
    lambda q, k, v, o: (q[0], k, v, o),                         # rank
    lambda q, k, v, o: (q.transpose(1, 2).contiguous().transpose(1, 2), k, v, o),
    lambda q, k, v, o: (q, k, v, o.long()),                     # offset type
    lambda q, k, v, o: (q, k, v, o[:1]),                        # offset shape
    lambda q, k, v, o: (q.double(), k.double(), v.double(), o),  # dtype
    lambda q, k, v, o: (q, k.bfloat16(), v, o),                 # mixed dtype
    lambda q, k, v, o: (q, k, v, o.to("meta")),                 # two devices
])
def test_flash_wrapper_rejects(bad):
    with pytest.raises((ValueError, TypeError)):
        flash_attention(*bad(*_qkv()), causal=True)


def test_flash_wrapper_rejects_big_head_dim_and_seq_kv():
    q = torch.zeros((1, 1, 2, 512))        # the kernel stops at head_dim 256
    k = torch.zeros((1, 4, 2, 512))
    with pytest.raises(ValueError):
        flash_attention(q, k, k, torch.zeros(1, dtype=torch.int32), causal=True)
    q, k, v, o = _qkv()
    with pytest.raises(ValueError):
        flash_attention(q, k, v, o, causal=True, seq_kv=6)


@pytest.mark.parametrize("x", [
    torch.zeros(10),                                  # not 2-D
    torch.zeros((2, 10), dtype=torch.float64),        # dtype
    torch.zeros((10, 2)).t(),                         # not contiguous
    torch.zeros((0, 4)),                              # empty
])
def test_probe_wrapper_rejects(x):
    with pytest.raises((ValueError, TypeError)):
        probe_rows(x, 1.0, nonfinite_code=NF, overflow_code=OV)


def test_non_cpu_tensors_never_take_the_plain_path():
    """No fallback: a tensor off the CPU goes to the kernel path, which here
    (no CUDA device, an unsupported device) raises instead of computing."""
    q, k, v, o = (t.to("meta") for t in _qkv())
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q, k, v, o, causal=True)
    with pytest.raises(ValueError, match="unsupported device"):
        probe_rows(torch.zeros((2, 4), device="meta"), 1.0,
                   nonfinite_code=NF, overflow_code=OV)


def test_kernel_build_needs_nvcc(monkeypatch):
    """The kernels build only where nvcc is; elsewhere the build raises
    rather than leaving a silent gap."""
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(build.os, "access", lambda *a: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build()


def test_kernel_sources_cover_both_kernels():
    """Every kernel's source is built, flash's three and the SSD scan's two
    among them (the name predates the later kernels); every C entry point
    has a signature; every header a source includes is hashed into the
    library's name."""
    names = sorted(p.name for p in build.sources())
    assert names == ["fault_probe.cu", "flash_decode.cu", "flash_f32.cu",
                     "flash_forward.cu", "rglru_scan.cu", "rglru_scan_bwd.cu",
                     "ssd_chunk_bwd.cu", "ssd_chunk_bwd_tc.cu", "ssd_chunk_tc.cu",
                     "ssd_f32.cu"]
    for fn in (flash_attention, probe_rows, rglru_scan, rglru_scan_bwd, ssd_scan,
               ssd_chunk_bwd):
        assert isinstance(fn.launches, int)
    assert set(launch_counts()) == {"flash_attention", "flash_decode",
                                    "flash_verify", "flash_forward", "flash_f32",
                                    "probe_rows", "probe_tree", "rglru_scan",
                                    "rglru_scan_bwd", "ssd_scan", "ssd_chunk_tc",
                                    "ssd_f32", "ssd_chunk_bwd", "ssd_chunk_bwd_tc",
                                    "ssd_chunk_bwd_f32"}
    exported = set()
    for src in build.sources():
        exported |= set(re.findall(r'extern "C" int (\w+)\(', src.read_text()))
    assert exported == set(build.SIGNATURES)
    hashed = {h.resolve() for h in build.headers()}
    for src in build.sources():
        for inc in re.findall(r'#include "([^"]+)"', src.read_text()):
            assert (src.parent / inc).resolve() in hashed, (src.name, inc)
    assert any(h.name == "mma_helpers.cuh" and h.parent.name == "common"
               for h in hashed)


def test_launch_signatures_are_64_bit_where_they_index():
    """The probe's column count, the scans' sizes and flash's batch and
    sequence lengths cross the C boundary as 64-bit integers (a (B*S, V)
    prefill view may hold > 2^31 values, as may B * S * Hq * D and
    b * S * H * P)."""
    import ctypes
    L = ctypes.c_longlong
    assert build.SIGNATURES["repro_probe_rows"][2] is L
    assert build.SIGNATURES["repro_rglru_scan"][4:8] == (L,) * 4  # B, S, W, T
    assert build.SIGNATURES["repro_rglru_scan_bwd"][7:11] == (L,) * 4
    # the backward's ticket base counts every ticket the scratch issued
    assert build.SIGNATURES["repro_rglru_scan_bwd"][11] is ctypes.c_ulonglong
    for name in ("repro_ssd_chunk_tc", "repro_ssd_f32"):
        assert build.SIGNATURES[name][7:9] == (L, L)                  # b, S
    for name in ("repro_ssd_chunk_bwd_tc", "repro_ssd_chunk_bwd_f32"):
        assert build.SIGNATURES[name][12:14] == (L, L)                # b, S
    # decode: B, T, ..., seq_kv, splits, keys_per_split
    dec = build.SIGNATURES["repro_flash_decode"]
    assert dec[5:7] == (L, L) and dec[12] is L and dec[14] is L
    for name in ("repro_flash_forward", "repro_flash_f32"):
        sig = build.SIGNATURES[name]
        assert sig[5] is ctypes.c_void_p                  # the lse pointer
        assert sig[6:9] == (L,) * 3 and sig[14] is L      # B, S, T; seq_kv


def test_probe_wrapper_refuses_more_rows_than_the_kernel_counts(monkeypatch):
    from repro_torch.kernels.fault_probe import ops
    monkeypatch.setattr(ops, "MAX_ROWS", 4)
    with pytest.raises(ValueError, match="rows"):
        probe_rows(torch.zeros((5, 3)), 1.0, nonfinite_code=NF, overflow_code=OV)


# (B, S, T, Hq, Hkv, D, causal, window, block_q, block_kv): recurrentgemma's
# head_dim 256 and 10 query heads over 1 KV head, full and sliding
FLASH_CASES_256 = [
    (1, 32, 32, 10, 1, 256, True, 0, 16, 16),
    (2, 48, 48, 10, 1, 256, True, 16, 16, 16),
]


@pytest.mark.parametrize("case", FLASH_CASES_256)
def test_flash_plain_matches_jax_kernel_head_dim_256(case):
    """As ``test_flash_plain_matches_jax_kernel`` at head_dim 256 (fp32,
    2e-5 for the reduction order)."""
    B, S, T, Hq, Hkv, D, causal, window, bq, bkv = case
    q, k, v = _inputs(case, np.float32, seed=5)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, window=window, block_q=bq, block_kv=bkv)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          torch.zeros(B, dtype=torch.int32), causal=causal,
                          window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


# (S, seq_kv, Hkv, dtype) -> kernel
PLAN_KERNELS = [
    ((1, 1024, 8, torch.bfloat16), "flash_decode"),
    ((1, 2048, 1, torch.bfloat16), "flash_decode"),
    ((2, 512, 8, torch.bfloat16), "flash_forward"),
    ((4096, 4096, 1, torch.bfloat16), "flash_forward"),
    ((1, 2048, 1, torch.float32), "flash_f32"),
    ((2, 512, 8, torch.float32), "flash_f32"),
]


@pytest.mark.parametrize("shape, kernel", PLAN_KERNELS)
def test_plan_picks_the_kernel_by_shape_and_dtype(shape, kernel):
    """bf16 on the tensor cores, decode (S == 1) or forward; fp32 on the
    CUDA cores: a choice by dtype, not a fallback."""
    assert plan(*shape).kernel == kernel


# (S, seq_kv, Hkv, dtype) of a verify -> kernel
VERIFY_PLANS = [
    ((4, 1024, 8, torch.bfloat16), "flash_verify"),
    ((9, 2048, 1, torch.bfloat16), "flash_verify"),
    ((1, 1024, 8, torch.bfloat16), "flash_decode"),
    ((4, 1024, 8, torch.float32), "flash_f32"),
]


@pytest.mark.parametrize("shape, kernel", VERIFY_PLANS)
def test_plan_verify_takes_the_decode_split(shape, kernel):
    """A verify's rows go to the decode kernel (``flash_verify``; one row is
    the decode itself) with the decode's split, whatever the rows: a row's
    bits are then the decode's at its position. fp32 stays on flash_f32."""
    S, seq_kv, Hkv, dtype = shape
    p = plan(S, seq_kv, Hkv, dtype, verify=True)
    assert p.kernel == kernel
    if kernel != "flash_f32":
        decode = plan(1, seq_kv, Hkv, dtype)
        assert (p.splits, p.keys_per_split) == (decode.splits, decode.keys_per_split)


@pytest.mark.parametrize("dtype, kernel", [(torch.bfloat16, "ssd_chunk_tc"),
                                           (torch.float32, "ssd_f32")])
def test_ssd_plan_picks_the_kernel_by_dtype(dtype, kernel):
    """The SSD wrapper's route: bf16 x, B, C on the tensor cores, fp32 on
    the CUDA cores, from the dtype alone; each route has its counter."""
    from repro_torch.kernels.ssd_scan.ops import KERNELS, plan as ssd_plan
    assert ssd_plan(dtype) == kernel and kernel in KERNELS
    assert set(ssd_scan.kernel_launches) == set(KERNELS)


# (seq_kv, Hkv) -> (splits, keys per split): the serve decode shapes
# (qwen3: 8 KV heads, cap 1024; recurrentgemma's ring: 1 KV head, cap 2048),
# short caches, an empty cache
PLAN_SPLITS = [
    ((1024, 8), (4, 256)),
    ((2048, 1), (8, 256)),
    ((300, 2), (5, 64)),
    ((200, 1), (4, 64)),
    ((40, 1), (1, 64)),
    ((0, 1), (1, 64)),
]


@pytest.mark.parametrize("shape, split", PLAN_SPLITS)
def test_plan_splits_depend_on_the_launch_shape_only(shape, split):
    """The decode split is a pure function of the launch shape (``plan``
    takes no positions): whole tiles per split, every key of ``seq_kv``
    covered, no split past the last tile, at most a cluster's 8 blocks,
    and a slots x KV heads x splits grid near ``SPLIT_TARGET`` blocks per
    slot."""
    seq_kv, Hkv = shape
    p = plan(1, seq_kv, Hkv, torch.bfloat16)
    assert (p.kernel, p.splits, p.keys_per_split) == ("flash_decode", *split)
    assert p.keys_per_split % DECODE_TILE == 0 and p.keys_per_split * p.splits >= seq_kv
    assert (p.splits - 1) * p.keys_per_split < max(seq_kv, 1)
    assert 1 <= p.splits <= MAX_SPLITS and Hkv * p.splits <= max(SPLIT_TARGET, Hkv)
    assert plan(1, seq_kv, Hkv, torch.bfloat16) == p


def test_p_split_holds_the_bf16_tolerance():
    """Why the bf16 forward kernel splits P into a bf16 high and low part
    for its P V product: at recurrentgemma's sliding-window shape (D 256,
    10 heads, rows averaging ~2048 keys, outputs ~0.04), P rounded to bf16
    alone misses the bf16 limit the card checks hold flash to (1e-4 + 2^-6
    |want| per element), while hi + lo stays where fp32 P is. Emulated here
    in fp32 on the CPU: the plain version's output is ``want``."""
    gen = torch.Generator().manual_seed(0)
    D, H, T, W = 256, 10, 4096, 2048
    rows = torch.arange(2048, 2048 + 96)
    q = torch.randn(len(rows), H, D, generator=gen).bfloat16().float()
    k = torch.randn(T, D, generator=gen).bfloat16().float()
    v = torch.randn(T, D, generator=gen).bfloat16().float()
    sc = torch.einsum("shd,td->hst", q, k) / D ** 0.5
    kp = torch.arange(T)
    mask = (kp[None] <= rows[:, None]) & (kp[None] > rows[:, None] - W)
    p = torch.exp(torch.where(mask[None], sc, -1e30) - sc.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    want = (p / l @ v).bfloat16().float()

    def excess(pv):
        got = (pv / l).bfloat16().float()
        return ((got - want).abs() / (1e-4 + 2 ** -6 * want.abs())).max().item()
    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float()
    assert excess(hi @ v) > 1
    assert excess(hi @ v + lo @ v) <= 1 and excess(p @ v) <= 1
