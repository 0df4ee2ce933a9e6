"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` (Hopper, sm_90a) and skips
without one; run them on the card with
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.errors import ErrorCode
from repro_torch.kernels import (flash_attention, probe_rows, probe_tree, rglru_scan,
                                 ssd_scan)
from repro_torch.kernels.fault_probe import probe_rows_ref, probe_tree_ref
from repro_torch.kernels.fault_probe.ops import MAX_LEAVES
from repro_torch.kernels.flash_attention import sdpa_ref
from repro_torch.kernels.flash_attention.ops import plan
from repro_torch.kernels.rglru_scan import rglru_scan_ref
from repro_torch.kernels.ssd_scan import (ssd_intra_chunk, ssd_intra_chunk_ref,
                                          ssd_scan_ref)
from repro_torch.kernels.ssd_scan.ops import plan as ssd_plan

NF, OV = int(ErrorCode.NONFINITE_LOSS), int(ErrorCode.DIVERGENCE)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _randn(rng, shape, dtype, device):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        device=device, dtype=dtype)


# (B, S, T, Hq, Hkv, D, causal, window, offsets)
FLASH_CASES = [
    (1, 16, 16, 2, 2, 128, True, 0, (0,)),
    (2, 32, 32, 4, 2, 128, True, 0, (0, 0)),
    (1, 32, 32, 4, 1, 128, True, 8, (0,)),
    (1, 24, 24, 2, 2, 128, False, 0, (0,)),
    (1, 20, 20, 2, 1, 128, True, 0, (0,)),
    (2, 33, 70, 4, 2, 16, True, 0, (0, 37)),            # smoke head_dim
    (3, 1, 300, 8, 2, 64, True, 0, (0, 150, 299)),      # decode, group 4
    (2, 1, 200, 4, 4, 32, True, 16, (5, 190)),          # decode, window
    (1, 40, 90, 12, 4, 128, True, 0, (7,)),             # group 3, 15 rows
    (8, 1, 1024, 16, 8, 128, True, 0,                   # serving decode
     (0, 1, 31, 32, 500, 1023, 1024, 1500)),
    (1, 512, 512, 16, 8, 128, True, 0, (0,)),           # full-width forward
    (8, 1, 2048, 10, 1, 256, True, 0,                   # recurrentgemma ring
     (0, 1, 700, 2047, 2048, 3000, 4500, 6000)),        # decode, wrapped
    (2, 1024, 1024, 10, 1, 256, True, 256, (0, 0)),     # sliding forward
    (1, 100, 300, 10, 1, 256, True, 64, (150,)),        # window past offset
    (2, 77, 300, 10, 1, 256, True, 0, (0, 150)),        # MQA, S not a multiple
    (3, 45, 200, 10, 1, 256, True, 32, (3, 60, 155)),   # of the tile, offsets
    (2, 70, 70, 4, 2, 16, True, 0, (0, 0)),             # forward at D 16,
    (1, 130, 130, 6, 3, 32, True, 24, (0,)),            # 32 and 64
    (2, 65, 100, 8, 2, 64, False, 0, (0, 35)),
    (8, 1, 1024, 4, 1, 256, True, 0,                    # gemma3 full decode
     (0, 1, 300, 511, 512, 1000, 1023, 1500)),
    (8, 1, 512, 4, 1, 256, True, 0,                     # gemma3 ring decode,
     (0, 1, 511, 512, 600, 1023, 1024, 2000)),          # wrapped
    (2, 1024, 1024, 4, 1, 256, True, 512, (0, 0)),      # gemma3 forward:
    (1, 600, 600, 4, 1, 256, True, 0, (0,)),            # sliding and full
    (8, 1, 4096, 24, 2, 128, True, 0,                   # starcoder2 ring
     (0, 1, 2047, 4095, 4096, 5000, 8191, 9000)),       # decode, group 12
    (8, 1, 1024, 32, 2, 128, True, 0,                   # chatglm3 decode,
     (0, 1, 100, 511, 700, 1022, 1023, 1500)),          # group 16
    (8, 1, 1024, 32, 8, 128, True, 0,                   # phi3.5-moe decode
     (0, 5, 64, 300, 777, 1023, 1024, 2000)),
    (2, 1100, 1100, 24, 2, 128, True, 512, (0, 0)),     # forward, rows
    (1, 700, 700, 32, 2, 128, True, 0, (0,)),           # s * 12 + h, s * 16 + h
    (8, 1, 1601, 32, 8, 128, False, 0, (0,) * 8),       # llama-vision cross
    (2, 300, 1601, 32, 8, 128, False, 0, (0, 0)),       # decode and forward:
    (2, 70, 9, 32, 8, 128, False, 0, (0, 0)),           # no mask, T != S, a
    (4, 1, 100, 8, 8, 80, False, 0, (0,) * 4),          # ragged last tile
    (2, 257, 257, 16, 16, 80, False, 0, (0, 0)),        # hubert: D 80, MHA,
    (3, 1, 300, 16, 16, 80, True, 0, (0, 150, 299)),    # bidirectional; D 80
    (2, 90, 120, 4, 2, 80, True, 16, (0, 30)),          # causal and sliding
]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, case, dtype):
    B, S, T, Hq, Hkv, D, causal, window, offsets = case
    rng = np.random.default_rng(0)
    q = _randn(rng, (B, S, Hq, D), dtype, cuda)
    k = _randn(rng, (B, T, Hkv, D), dtype, cuda)
    v = _randn(rng, (B, T, Hkv, D), dtype, cuda)
    off = torch.tensor(offsets, dtype=torch.int32, device=cuda)
    kernel = plan(S, T, Hkv, dtype).kernel
    before = flash_attention.launches, flash_attention.kernel_launches[kernel]
    got = flash_attention(q, k, v, off, causal=causal, window=window)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.kernel_launches[kernel]) == (
        before[0] + 1, before[1] + 1)
    want = sdpa_ref(q, k, v, q_offset=off, causal=causal, window=window)
    # fp32: summation order differs (online softmax, 32-key tiles);
    # bf16: both round an fp32 result to bf16, so about 1 ulp apart: held to
    # 2 ulps of each element, not of |x| < 2, since outputs averaged over
    # 2048 keys are ~0.05 and one key's weight is below 2 ulp at |x| < 2
    rtol, atol = (2e-5, 2e-5) if dtype == torch.float32 else (2.0 ** -6, 1e-4)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


# decode shapes (T, Hq, Hkv, D): qwen3's serve cache, recurrentgemma's ring,
# gemma3's full cache and ring, starcoder2's ring (group 12: the m16 tile
# three quarters full), chatglm3's cache (group 16 = MAX_GROUP: the tile
# full)
DECODE_SHAPES = [(1024, 16, 8, 128), (2048, 10, 1, 256), (1024, 4, 1, 256),
                 (512, 4, 1, 256), (4096, 24, 2, 128), (1024, 32, 2, 128)]


@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_is_deterministic_per_row(cuda, shape, dtype):
    """A slot's output does not depend on the other slots' data or their
    positions, bit for bit — the LFLR bit-exactness contract rests on it."""
    T, Hq, Hkv, D = shape
    rng = np.random.default_rng(1)
    q = _randn(rng, (4, 1, Hq, D), dtype, cuda)
    k = _randn(rng, (4, T, Hkv, D), dtype, cuda)
    v = _randn(rng, (4, T, Hkv, D), dtype, cuda)
    off = torch.tensor([T // 2 + 5, 100, T - 1, T + 300], dtype=torch.int32,
                       device=cuda)
    a = flash_attention(q, k, v, off, causal=True)
    k2, v2 = k.clone(), v.clone()
    k2[1:] = _randn(rng, (3, T, Hkv, D), dtype, cuda)
    v2[1:] = _randn(rng, (3, T, Hkv, D), dtype, cuda)
    b = flash_attention(q, k2, v2, off, causal=True)
    assert torch.equal(a[0], b[0])
    # the other slots at other positions: one before any split boundary,
    # one past every key, one on a boundary
    off2 = torch.tensor([T // 2 + 5, 0, 3 * T, T // 4], dtype=torch.int32,
                        device=cuda)
    c = flash_attention(q, k2, v2, off2, causal=True)
    assert torch.equal(a[0], c[0])


@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_at_split_boundaries(cuda, shape, dtype):
    """Positions on and either side of every split boundary ``plan`` sets
    for the bf16 decode (fp32 takes its own kernel, which does not split,
    at the same positions), the first and last key, and positions past
    ``seq_kv`` (cut below T here, so keys past it are padding) and past T."""
    T, Hq, Hkv, D = shape
    p = plan(1, T, Hkv, torch.bfloat16)
    assert p.kernel == "flash_decode" and p.splits > 1
    seq_kv = T - 3
    pos = [0, 1, T - 1, seq_kv - 1, seq_kv, seq_kv + 1, T, 2 * T + 7]
    pos += [i * p.keys_per_split + d for i in range(1, p.splits) for d in (-1, 0, 1)]
    B = len(pos)
    rng = np.random.default_rng(6)
    q = _randn(rng, (B, 1, Hq, D), dtype, cuda)
    k = _randn(rng, (B, T, Hkv, D), dtype, cuda)
    v = _randn(rng, (B, T, Hkv, D), dtype, cuda)
    off = torch.tensor(pos, dtype=torch.int32, device=cuda)
    kernel = plan(1, seq_kv, Hkv, dtype).kernel
    before = flash_attention.kernel_launches[kernel]
    got = flash_attention(q, k, v, off, causal=True, seq_kv=seq_kv)
    assert flash_attention.kernel_launches[kernel] == before + 1
    want = sdpa_ref(q, k, v, q_offset=off, causal=True, seq_kv=seq_kv)
    rtol, atol = (2e-5, 2e-5) if dtype == torch.float32 else (2.0 ** -6, 1e-4)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


# one case per kernel: the bf16 decode, the bf16 forward, fp32 (decode and
# forward)
REPEAT_CASES = [((8, 1, 2048, 10, 1, 256), torch.bfloat16, "flash_decode"),
                ((8, 1, 1024, 16, 8, 128), torch.bfloat16, "flash_decode"),
                ((2, 300, 300, 10, 1, 256), torch.bfloat16, "flash_forward"),
                ((8, 1, 1024, 16, 8, 128), torch.float32, "flash_f32"),
                ((2, 300, 300, 10, 1, 256), torch.float32, "flash_f32")]


@pytest.mark.parametrize("case", REPEAT_CASES)
def test_flash_kernel_repeats_bit_for_bit(cuda, case):
    """Two identical launches of each kernel give the same bits."""
    (B, S, T, Hq, Hkv, D), dtype, kernel = case
    rng = np.random.default_rng(7)
    q = _randn(rng, (B, S, Hq, D), dtype, cuda)
    k = _randn(rng, (B, T, Hkv, D), dtype, cuda)
    v = _randn(rng, (B, T, Hkv, D), dtype, cuda)
    off = torch.tensor(rng.integers(0, 2 * T, B), dtype=torch.int32, device=cuda)
    if S > 1:
        off.zero_()
    before = flash_attention.kernel_launches[kernel]
    a = flash_attention(q, k, v, off, causal=True, window=T // 3)
    b = flash_attention(q, k, v, off, causal=True, window=T // 3)
    assert flash_attention.kernel_launches[kernel] == before + 2
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_probe_kernel_matches_plain(cuda, dtype):
    x = torch.zeros((6, 151936), dtype=dtype, device=cuda)
    x[1, 7] = float("nan")
    x[2, 151935] = float("inf")
    x[3, 70000] = float("-inf")
    x[4, 3] = 2e4
    x[5, 9], x[5, 10] = float("nan"), -3e4
    for threshold in (1e4, float("inf")):
        before = probe_rows.launches
        got = probe_rows(x, threshold, nonfinite_code=NF, overflow_code=OV)
        torch.cuda.synchronize()
        assert probe_rows.launches == before + 1
        want = probe_rows_ref(x, threshold, nonfinite_code=NF, overflow_code=OV)
        assert torch.equal(got, want), (got, want)
    assert got.tolist() == [0, NF, NF, NF, 0, NF]


# (B, S, W): smoke width, a ragged width (not a multiple of the block), the
# full recurrentgemma-2b prefill shape; S not a multiple of the kernel's
# 128-step chunk, below one chunk, one step, and a long context (256 chunks)
SCAN_CASES = [(1, 16, 64), (2, 37, 200), (3, 9, 1), (2, 4096, 2560),
              (2, 4100, 256), (1, 100, 64), (2, 1, 300), (1, 32768, 256)]


def _scan_log_a(rng, shape, memory, device):
    """``short``: -softplus(normal), a chunk's decay product 0 in fp32;
    ``long``: -8 softplus(lam) sigmoid(normal) with the Griffin paper's
    a^8 in [0.9, 0.999] over the channels, a chunk's decay product up to
    about 0.94, so later chunks depend on the carry."""
    z = _randn(rng, shape, torch.float32, device)
    if memory == "short":
        return -torch.nn.functional.softplus(z)
    lam = torch.log(torch.expm1(torch.linspace(
        -np.log(0.999) / 8, -np.log(0.9) / 8, shape[-1], device=device)))
    return -8.0 * torch.nn.functional.softplus(lam) * torch.sigmoid(z)


@pytest.mark.parametrize("memory", ["short", "long"])
@pytest.mark.parametrize("shape", SCAN_CASES)
def test_rglru_scan_kernel_matches_plain(cuda, shape, memory):
    """fp32 both sides; exp/sqrt ulps and the kernel's FMA contraction
    compound through the recurrence over ~1/(1-a) steps: tolerance 1e-4
    absolute plus 1e-4 relative."""
    rng = np.random.default_rng(2)
    x_in = _randn(rng, shape, torch.float32, cuda)
    log_a = _scan_log_a(rng, shape, memory, cuda)
    before = rglru_scan.launches
    got = rglru_scan(x_in, log_a)
    torch.cuda.synchronize()
    assert rglru_scan.launches == before + 1
    want = rglru_scan_ref(x_in, log_a)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("memory", ["short", "long"])
def test_rglru_scan_kernel_repeats_bit_for_bit(cuda, memory):
    """Two launches give the same bits, a batch row's output does not
    depend on the other rows' data (the chunk carries combine in a fixed
    order, with no atomics), and a sequence's states are the same bits as
    the first S of a longer sequence's (the chunk does not depend on S)."""
    rng = np.random.default_rng(8)
    shape = (3, 4100, 640)
    x_in = _randn(rng, shape, torch.float32, cuda)
    log_a = _scan_log_a(rng, shape, memory, cuda)
    a, b = rglru_scan(x_in, log_a), rglru_scan(x_in, log_a)
    assert torch.equal(a, b)
    x2, la2 = x_in.clone(), log_a.clone()
    x2[1:] = _randn(rng, (2, *shape[1:]), torch.float32, cuda)
    la2[1:] = _scan_log_a(rng, (2, *shape[1:]), memory, cuda)
    c = rglru_scan(x2, la2)
    assert torch.equal(a[0], c[0])
    assert torch.equal(a[:1], rglru_scan(x_in[:1].contiguous(), log_a[:1].contiguous()))
    assert torch.equal(a[:, :4000], rglru_scan(x_in[:, :4000].contiguous(),
                                               log_a[:, :4000].contiguous()))


def test_probe_kernel_many_rows(cuda):
    """More rows than the grid's y extent (65535): the blocks stride over
    the rows and every row gets its word."""
    x = torch.zeros((70000, 40), device=cuda)
    x[3, 1] = float("nan")
    x[65535, 39] = 2e4
    x[69999, 0] = float("-inf")
    got = probe_rows(x, 1e4, nonfinite_code=NF, overflow_code=OV)
    want = probe_rows_ref(x, 1e4, nonfinite_code=NF, overflow_code=OV)
    assert torch.equal(got, want)
    assert got.nonzero().flatten().tolist() == [3, 65535, 69999]


def test_probe_kernel_row_past_2_31_elements(cuda):
    """One row of 2^31 + 1000 bf16 elements (4.3 GB): the kernel indexes in
    64 bits, so faults past element 2^31 are seen."""
    n = 2 ** 31 + 1000
    x = torch.zeros((1, n), dtype=torch.bfloat16, device=cuda)
    x[0, n - 1] = float("nan")
    assert probe_rows(x, 1e4, nonfinite_code=NF, overflow_code=OV).tolist() == [NF]
    x[0, n - 1] = 0
    x[0, 2 ** 31 + 5] = 3e4
    assert probe_rows(x, 1e4, nonfinite_code=NF, overflow_code=OV).tolist() == [OV]
    x[0, 2 ** 31 + 5] = 0
    assert probe_rows(x, 1e4, nonfinite_code=NF, overflow_code=OV).tolist() == [0]


# (b, s, h, p, g, n, chunk): the full mamba2-2.7b prefill shape, groups over
# heads (G > 1), a sequence shorter than the chunk, ragged tiles (p, n, L
# below the kernel's 64, 128, 128 and not multiples of 4), 12 heads a group
# (a full tile of 8 and one of 4 on the tensor-core route)
SSD_CASES = [(2, 4096, 80, 64, 1, 128, 128), (2, 256, 8, 64, 4, 128, 128),
             (3, 40, 6, 64, 2, 128, 128), (1, 30, 3, 13, 1, 7, 10),
             (1, 256, 24, 64, 2, 128, 128)]


def _ssd_inputs(rng, case, dtype, device):
    """Drawn like the JAX package's SSD test: dt = softplus(normal),
    A = -exp(0.3 normal), B and C half-normal; x, B, C in ``dtype``."""
    b, s, h, p, g, n, _ = case
    x = _randn(rng, (b, s, h, p), dtype, device)
    dt = torch.nn.functional.softplus(_randn(rng, (b, s, h), torch.float32, device))
    A = -torch.exp(0.3 * _randn(rng, (h,), torch.float32, device))
    B = 0.5 * _randn(rng, (b, s, g, n), torch.float32, device)
    C = 0.5 * _randn(rng, (b, s, g, n), torch.float32, device)
    return x, dt, A, B.to(dtype), C.to(dtype)


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_matches_plain(cuda, case, dtype):
    """The intra-chunk kernel (y_diag and the chunk states, fp32 out) and the
    whole scan against their plain versions on the same inputs, through the
    route ``plan`` picks: bf16 to the tensor-core kernel (``ssd_chunk_tc``;
    the first case is mamba2-2.7b's prefill, 80 heads over 1 group, S
    4096), fp32 to ``ssd_f32``. fp32 differs from the plain version in
    summation order only (sums of <= 128 terms); the tensor-core route also
    carries its fp32 operands as bf16 hi + lo (16 bits): 1e-4 of each
    element plus 1e-4 of the largest. The scan's bf16 output rounds one fp32
    result twice, about 1 ulp apart: 2 bf16 ulps of each element (2^-6),
    plus 1e-4 of the largest."""
    rng = np.random.default_rng(3)
    chunk = case[-1]
    x, dt, A, B, C = _ssd_inputs(rng, case, dtype, cuda)
    L = min(chunk, case[1])
    kernel = ssd_plan(dtype)
    assert kernel == ("ssd_chunk_tc" if dtype == torch.bfloat16 else "ssd_f32")
    before = ssd_scan.launches, dict(ssd_scan.kernel_launches)
    y, states = ssd_intra_chunk(x, dt, A, B, C, chunk)
    got = ssd_scan(x, dt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before[0] + 2
    assert {k: n - before[1][k] for k, n in ssd_scan.kernel_launches.items()} == {
        k: 2 if k == kernel else 0 for k in before[1]}
    want_y, want_states = ssd_intra_chunk_ref(x, dt, A, B, C, L)
    for g_, w_ in ((y, want_y), (states, want_states)):
        torch.testing.assert_close(g_, w_, rtol=1e-4,
                                   atol=1e-4 * w_.abs().max().item())
    want = ssd_scan_ref(x, dt, A, B, C, chunk=chunk)
    assert got.dtype == want.dtype == dtype
    rtol = 1e-4 if dtype == torch.float32 else 2.0 ** -6
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=1e-4 * want.float().abs().max().item())


def test_ssd_kernel_is_deterministic_per_block(cuda):
    """A (batch, chunk, head)'s outputs depend on its own inputs only, bit
    for bit, and a second launch repeats the first — LFLR replays rest on
    it."""
    rng = np.random.default_rng(4)
    case = (2, 512, 8, 64, 1, 128, 128)
    x, dt, A, B, C = _ssd_inputs(rng, case, torch.bfloat16, cuda)
    y1, s1 = ssd_intra_chunk(x, dt, A, B, C, 128)
    y2, s2 = ssd_intra_chunk(x, dt, A, B, C, 128)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)
    x2 = x.clone()
    x2[1] = _randn(rng, x2[1].shape, torch.bfloat16, cuda)
    y3, s3 = ssd_intra_chunk(x2, dt, A, B, C, 128)
    assert torch.equal(y1[0], y3[0]) and torch.equal(s1[0], s3[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_head_ignores_the_other_heads_of_its_tile(cuda, dtype):
    """The tensor-core kernel computes C B^T once for a tile of 8 heads of
    one group: a head's outputs stay bit-equal when only the other heads of
    its tile, or of the other group, change (their x, dt and A)."""
    rng = np.random.default_rng(9)
    case = (2, 256, 16, 64, 2, 128, 128)          # 8 heads a group: one tile
    x, dt, A, B, C = _ssd_inputs(rng, case, dtype, cuda)
    y1, s1 = ssd_intra_chunk(x, dt, A, B, C, 128)
    x2, dt2, A2 = x.clone(), dt.clone(), A.clone()
    others = [1, 2, 5, 7, 9, 12]                  # of heads 0-7 and 8-15
    x2[:, :, others] = _randn(rng, x2[:, :, others].shape, dtype, cuda)
    dt2[:, :, others] = 2 * dt2[:, :, others]
    A2[others] = A2[others] / 3
    y2, s2 = ssd_intra_chunk(x2, dt2, A2, B, C, 128)
    for h in (0, 3, 8, 15):
        assert torch.equal(y1[:, :, h], y2[:, :, h])
        assert torch.equal(s1[:, :, h], s2[:, :, h])
    assert not torch.equal(y1[:, :, 1], y2[:, :, 1])


def test_ssd_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    """On the card the wrapper raises where the kernel's tiles end (chunk
    128, head_dim 64, state 128) and on inputs it does not take; it never
    hands a CUDA tensor to the plain version."""
    def inputs(s=16, h=2, p=8, g=1, n=8):
        z = lambda *shape: torch.zeros(shape, device=cuda)  # noqa: E731
        return z(1, s, h, p), z(1, s, h), z(h), z(1, s, g, n), z(1, s, g, n)

    with pytest.raises(ValueError, match="exceeds the kernel"):
        ssd_scan(*inputs(s=256), chunk=256)
    with pytest.raises(ValueError, match="exceeds the kernel"):
        ssd_scan(*inputs(p=128), chunk=8)
    with pytest.raises(ValueError, match="exceeds the kernel"):
        ssd_scan(*inputs(n=256), chunk=8)
    x, dt, A, B, C = inputs()
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, B, C,
                 chunk=8)
    with pytest.raises(TypeError):
        ssd_scan(x.half(), dt, A, B.half(), C.half(), chunk=8)
    with pytest.raises(ValueError, match="several devices"):
        ssd_scan(x, dt, A.cpu(), B, C, chunk=8)


def test_probe_kernel_over_one_slots_ssm_state(cuda):
    """One row of 41 943 040 fp32 elements — one slot's ``ssm`` state over
    mamba2-2.7b's 64 layers (80 heads x 64 x 128 each): a NaN at its last
    element and an inf at its first are seen, and a clean row is 0."""
    n = 64 * 80 * 64 * 128
    sf = int(ErrorCode.STATE_FAULT)
    x = torch.zeros((1, n), device=cuda)
    assert probe_rows(x, float("inf"), nonfinite_code=sf, overflow_code=sf).tolist() == [0]
    x[0, n - 1] = float("nan")
    assert probe_rows(x, float("inf"), nonfinite_code=sf, overflow_code=sf).tolist() == [sf]
    x[0, n - 1] = 0
    x[0, 0] = float("-inf")
    got = probe_rows(x, float("inf"), nonfinite_code=sf, overflow_code=sf)
    assert torch.equal(got, probe_rows_ref(x, float("inf"), nonfinite_code=sf,
                                           overflow_code=sf))
    assert got.tolist() == [sf]


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma3-1b", "recurrentgemma-2b",
                                  "mamba2-2.7b", "qwen3-moe-30b-a3b"])
def test_engines_bit_equal_on_the_card(cuda, arch):
    """The smoke model in bf16 on the card, seeded: the stepwise engine, the
    blocking window engine and the overlapped one serve the same streams,
    token for token — the blocking prefill runs at the slots' batch size,
    so cuBLAS and flash see the slot step's shapes."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import Model
    from repro_torch.serve import OK, EngineConfig, Replica, Request

    cfg = smoke_config(arch).replace(dtype="bfloat16")
    model = Model(cfg, device=cuda, seed=0)
    rng = np.random.default_rng(3)
    traffic = [(tuple(int(t) for t in rng.integers(1, cfg.vocab_size,
                                                   int(rng.integers(2, 30)))),
                int(rng.integers(3, 20))) for _ in range(6)]
    streams = []
    for conf in (dict(window=0), dict(window=4, overlap=False),
                 dict(window=4, overlap=True)):
        rep = Replica(cfg, model, config=EngineConfig(num_slots=3, max_len=64,
                                                      **conf))
        for i, (prompt, n) in enumerate(traffic):
            assert rep.submit(Request(id=i, prompt=prompt, max_new_tokens=n)) is None
        out = rep.run()
        assert all(r.status == OK for r in out)
        streams.append({r.id: r.tokens for r in out})
    assert streams[0] == streams[1] == streams[2]


def test_moe_decode_row_ignores_the_other_slots(cuda):
    """The qwen3-moe smoke model in bf16 on the card, seeded, 8 slots: slot
    3's decode logits and cache rows over 12 steps are bit-equal whether
    the other 7 slots hold slot 3's tokens or others (routed to other
    experts). The capacity buffers and the expert products have the same
    shapes whatever the routing, and the combine adds each token's K
    outputs in a fixed order, so a slot's bits do not depend on its
    neighbours: what LFLR's re-prefill of one slot rests on."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import Model
    from repro_torch.models.model import slot_layer_view

    cfg = smoke_config("qwen3-moe-30b-a3b").replace(dtype="bfloat16")
    model = Model(cfg, device=cuda, seed=0)
    slots, slot, steps = 8, 3, 12
    rng = np.random.default_rng(7)
    seq = rng.integers(0, cfg.vocab_size, steps)
    runs = []
    for toks in (np.tile(seq, (slots, 1)),
                 rng.integers(0, cfg.vocab_size, (slots, steps))):
        toks[slot] = seq
        toks = torch.from_numpy(toks).to(device=cuda, dtype=torch.int32)
        cache = model.init_cache(slots, 64)
        logits = torch.stack([model.decode_step(toks[:, p:p + 1], cache, p)[slot]
                              for p in range(steps)])
        runs.append((logits, {k: slot_layer_view(cache, k)[slot] for k in cache}))
    (same, same_cache), (mixed, mixed_cache) = runs
    assert torch.isfinite(same).all()
    assert torch.equal(same, mixed)
    for name in same_cache:
        assert torch.equal(same_cache[name], mixed_cache[name]), name


@pytest.mark.parametrize("arch,heads", [("starcoder2-3b", (24, 2)),
                                        ("chatglm3-6b", (32, 2))],
                         ids=["group12", "group16"])
def test_wide_group_decode_row_ignores_the_other_slots(cuda, arch, heads):
    """The starcoder2 and chatglm3 smoke models in bf16 on the card, widened
    to the full configs' head layouts (24/2 heads: group 12, the decode's
    m16 tile three quarters full; 32/2: group 16, the tile full), seeded,
    8 slots: slot 3's decode logits and cache rows over 20 steps (past
    starcoder2's 16-entry rings) are bit-equal whether the other slots hold
    slot 3's tokens or others. LFLR's bit-equal replays rest on it."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import Model
    from repro_torch.models.model import slot_layer_view

    Hq, Hkv = heads
    cfg = smoke_config(arch).replace(dtype="bfloat16", num_heads=Hq,
                                     num_kv_heads=Hkv, head_dim=16)
    model = Model(cfg, device=cuda, seed=0)
    slots, slot, steps = 8, 3, 20
    rng = np.random.default_rng(9)
    seq = rng.integers(0, cfg.vocab_size, steps)
    runs = []
    for toks in (np.tile(seq, (slots, 1)),
                 rng.integers(0, cfg.vocab_size, (slots, steps))):
        toks[slot] = seq
        toks = torch.from_numpy(toks).to(device=cuda, dtype=torch.int32)
        cache = model.init_cache(slots, 64)
        before = flash_attention.kernel_launches["flash_decode"]
        logits = torch.stack([model.decode_step(toks[:, p:p + 1], cache, p)[slot]
                              for p in range(steps)])
        assert (flash_attention.kernel_launches["flash_decode"]
                == before + steps * cfg.num_layers)
        runs.append((logits, {k: slot_layer_view(cache, k)[slot] for k in cache}))
    (same, same_cache), (mixed, mixed_cache) = runs
    assert torch.isfinite(same).all()
    assert torch.equal(same, mixed)
    for name in same_cache:
        assert torch.equal(same_cache[name], mixed_cache[name]), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_decode_row_ignores_the_other_slots(cuda, dtype):
    """The non-causal decode over llama-vision's 1601 image keys (32/8
    heads; four splits of 448 keys, the last ragged): a slot's output does
    not depend on the other slots' K/V, bit for bit."""
    rng = np.random.default_rng(11)
    T, Hq, Hkv, D = 1601, 32, 8, 128
    q = _randn(rng, (4, 1, Hq, D), dtype, cuda)
    k = _randn(rng, (4, T, Hkv, D), dtype, cuda)
    v = _randn(rng, (4, T, Hkv, D), dtype, cuda)
    zeros = torch.zeros(4, dtype=torch.int32, device=cuda)
    a = flash_attention(q, k, v, zeros, causal=False)
    k[1:], v[1:] = _randn(rng, (3, T, Hkv, D), dtype, cuda), _randn(rng, (3, T, Hkv, D),
                                                                    dtype, cuda)
    b = flash_attention(q, k, v, zeros, causal=False)
    assert torch.equal(a[0], b[0])


def test_vlm_decode_row_ignores_the_other_slots(cuda):
    """The llama-vision smoke model in bf16 on the card, widened to the
    full config's 32/8 heads, seeded, its cross leaves filled from seeded
    image embeddings through ``precompute_cross_kv`` and its gates drawn
    non-zero, 8 slots: slot 3's decode logits over 12 steps are bit-equal
    whether the other slots hold slot 3's tokens and image or others; each
    step launches flash_decode once per layer, the cross layers' over the
    image keys."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import Model
    from repro_torch.models.attention import precompute_cross_kv

    cfg = smoke_config("llama-3.2-vision-11b").replace(
        dtype="bfloat16", num_heads=32, num_kv_heads=8, head_dim=16, img_tokens=40)
    model = Model(cfg, device=cuda, seed=0)
    gen = torch.Generator(device=cuda).manual_seed(1)
    with torch.no_grad():
        for blk in model.blocks:
            if blk.btype == "cross":
                blk.gate_attn.normal_(generator=gen)
                blk.gate_mlp.normal_(generator=gen)
    slots, slot, steps = 8, 3, 12
    rng = np.random.default_rng(12)
    seq = rng.integers(0, cfg.vocab_size, steps)
    img = _randn(rng, (1, cfg.img_tokens, cfg.d_model), torch.bfloat16, cuda)
    runs = []
    for same in (True, False):
        toks = (np.tile(seq, (slots, 1)) if same
                else rng.integers(0, cfg.vocab_size, (slots, steps)))
        toks[slot] = seq
        toks = torch.from_numpy(toks).to(device=cuda, dtype=torch.int32)
        imgs = (img.expand(slots, -1, -1).contiguous() if same else
                _randn(rng, (slots, cfg.img_tokens, cfg.d_model), torch.bfloat16, cuda))
        imgs[slot] = img[0]
        cache = model.init_cache(slots, 32)
        cross = [b for b in model.blocks if b.btype == "cross"]
        for j, blk in enumerate(cross):
            cache["k_cross"][j], cache["v_cross"][j] = precompute_cross_kv(
                blk.attn, imgs, cfg)
        before = flash_attention.kernel_launches["flash_decode"]
        logits = torch.stack([model.decode_step(toks[:, p:p + 1], cache, p)[slot]
                              for p in range(steps)])
        assert (flash_attention.kernel_launches["flash_decode"]
                == before + steps * cfg.num_layers)
        runs.append(logits)
    assert torch.isfinite(runs[0]).all()
    assert torch.equal(runs[0], runs[1])


def test_cache_prefill_row_ignores_the_other_rows(cuda):
    """qwen3-1.7b at full width, seeded, 8 slots: row 3 of a blocking
    prefill at the slots' batch size (what the replica keeps) has the same
    logits and cache bits whether the other rows hold the same sequence or
    others, so a rebuilt lane does not depend on its neighbours. Prints the
    prefill's ms at batch 1 and at batch 8 and how far row 0's logits at
    batch 1 are from batch 8's (the reason the replica does not rebuild at
    batch 1); run with ``-s`` to see the line."""
    import json
    import time

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_cache_prefill
    from repro_torch.models import Model
    from repro_torch.models.model import slot_layer_view

    slots, slot, max_len = 8, 3, 1024
    cfg = get_config("qwen3-1.7b")
    model = Model(cfg, device=cuda, seed=0)
    prefill = make_cache_prefill(model)
    rng = np.random.default_rng(5)
    seq = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 19))).to(
        device=cuda, dtype=torch.int32)
    mixed = torch.from_numpy(rng.integers(0, cfg.vocab_size, (slots, 19))).to(
        device=cuda, dtype=torch.int32)
    mixed[slot] = seq[0]
    same_logits, same_cache, _ = prefill(seq.expand(slots, -1), max_len)
    mixed_logits, mixed_cache, _ = prefill(mixed, max_len)
    assert torch.equal(same_logits[slot], mixed_logits[slot])
    for name in same_cache:
        assert torch.equal(slot_layer_view(same_cache, name)[slot],
                           slot_layer_view(mixed_cache, name)[slot]), name
    del same_cache, mixed_cache

    ms, last = {}, {}
    for b in (1, slots):
        prefill(seq.expand(b, -1), max_len)                  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _, _ = prefill(seq.expand(b, -1), max_len)
        torch.cuda.synchronize()
        ms[b] = (time.perf_counter() - t0) * 1e3
        last[b] = logits[0, -1]
    print(json.dumps({
        "test": "cache_prefill_batch_cost", "card": torch.cuda.get_device_name(0),
        "prompt": seq.shape[1], "batch_1_ms": ms[1], f"batch_{slots}_ms": ms[slots],
        "row_0_bit_equal": bool(torch.equal(last[1], last[slots])),
        "row_0_max_abs_diff": (last[1] - last[slots]).abs().max().item()}))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma3-1b"])
def test_paged_engines_bit_equal_on_the_card(cuda, arch):
    """The smoke model in bf16 on the card, seeded: the paged window
    engines (overlapped and blocking prefill) serve the contiguous engine's
    streams, token for token, with the host syncs of the contiguous engine
    (2 per window, 2 per blocking prefill: the table upload and the page
    scrubs read nothing back), and every page comes back at drain. gemma3
    at max_len 64 pages its full layers and keeps its 16-entry rings
    dense."""
    from repro_torch.configs import smoke_config
    from repro_torch.core.device_channel import readback
    from repro_torch.models import Model
    from repro_torch.serve import OK, EngineConfig, Replica, Request

    cfg = smoke_config(arch).replace(dtype="bfloat16")
    model = Model(cfg, device=cuda, seed=0)
    rng = np.random.default_rng(4)
    traffic = [(tuple(int(t) for t in rng.integers(1, cfg.vocab_size,
                                                   int(rng.integers(2, 30)))),
                int(rng.integers(3, 20))) for _ in range(6)]
    for overlap in (True, False):
        streams = []
        for paged in (False, True):
            rep = Replica(cfg, model, config=EngineConfig(
                num_slots=3, max_len=64, window=4, overlap=overlap, paged=paged,
                page_size=8))
            for i, (prompt, n) in enumerate(traffic):
                assert rep.submit(Request(id=i, prompt=prompt, max_new_tokens=n)) is None
            readback.count = 0
            out = rep.run()
            m = rep.metrics
            assert all(r.status == OK for r in out) and not m.faults
            assert readback.count == 2 * m.windows + 2 * m.prefills
            streams.append({r.id: r.tokens for r in out})
        assert rep.layout.is_paged_path("k")
        assert not rep.layout.is_paged_path("k_ring")
        assert m.pages_allocated == m.pages_freed > 0
        rep.alloc.check()
        assert streams[0] == streams[1], overlap


def test_paged_window_reaches_flash_decode(cuda):
    """qwen3's smoke model in bf16 on the card: a decode window over pages
    scattered through a shuffled table equals the contiguous window on the
    same cache, bit for bit (tokens, words, next token and position, the
    cache read back through the table); the gathered leaf has the
    contiguous cache's shape, dtype and strides, and every step of the
    paged window launches the decode kernel once per layer, with nothing
    read back."""
    from repro_torch.configs import smoke_config
    from repro_torch.core.device_channel import readback
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.paging import PagedLayout
    from repro_torch.launch.steps import make_decode_window
    from repro_torch.models import Model

    cfg = smoke_config("qwen3-1.7b").replace(dtype="bfloat16")
    model = Model(cfg, device=cuda, seed=0)
    S, max_len, page, K = 3, 64, 8, 4
    layout = PagedLayout(model.init_cache(1, max_len), max_len, page_size=page,
                         num_pages=S * max_len // page)
    rng = np.random.default_rng(6)
    caches = model.init_cache(S, max_len)
    for t in caches.values():
        t.copy_(_randn(rng, tuple(t.shape), t.dtype, cuda))
    table = torch.from_numpy(rng.permutation(layout.num_pages).reshape(
        S, layout.max_pages).astype(np.int32)).to(cuda)
    hybrid = layout.init_hybrid(model.init_cache(1, max_len), S)
    layout.scatter(hybrid, caches, table)
    view = layout.gather(hybrid, table)
    for name, t in caches.items():
        assert torch.equal(view[name], t)
        assert view[name].stride() == t.stride() and view[name].dtype == t.dtype
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, S).astype(np.int32)).to(cuda)
    pos = torch.tensor([0, 17, 55], dtype=torch.int32, device=cuda)
    want = make_decode_window(model, window=K)(caches, tokens, pos)
    reset_launch_counts()
    readback.count = 0
    got = make_decode_window(model, window=K, paged=layout)(hybrid, tokens, pos,
                                                            table)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert readback.count == 0
    assert counts["flash_decode"] == counts["flash_attention"] == K * cfg.num_layers
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    view = layout.gather(hybrid, table)
    for name, t in caches.items():
        assert torch.equal(view[name], t), name


# verify shapes (B, T, cap, Hq, Hkv, D): qwen3's serve verify, T 1..8 and a
# second row tile, caps 64-2048, gemma3's and recurrentgemma's heads
VERIFY_SHAPES = [(8, 4, 1024, 16, 8, 128), (8, 1, 1024, 16, 8, 128),
                 (8, 2, 64, 16, 8, 128), (8, 3, 2048, 16, 8, 128),
                 (8, 5, 1024, 16, 8, 128), (8, 8, 1024, 16, 8, 128),
                 (4, 9, 2048, 16, 8, 128), (8, 4, 1024, 4, 1, 256),
                 (8, 3, 2048, 10, 1, 256), (3, 6, 100, 4, 2, 16),
                 (8, 4, 1024, 32, 2, 128)]


def _verify_positions(B, T, cap, Hkv):
    """Positions at split and tile edges (each row's, not only the
    first's), at the capacity and past it."""
    p = plan(1, cap, Hkv, torch.bfloat16)
    edges = [0, 1, 63, 64, p.keys_per_split - T, p.keys_per_split - 1,
             cap - T, cap - 1, cap + 3, p.keys_per_split * (p.splits - 1) - 2]
    return [max(0, e) for e in edges][:B] + [cap // 3] * max(0, B - len(edges))


@pytest.mark.parametrize("shape", VERIFY_SHAPES)
def test_flash_verify_matches_plain(cuda, shape):
    """The verify route (one launch, T rows per slot) against the plain
    version with S = T over the cache: bf16, held as the decode is (2 ulps
    of each element plus 1e-4)."""
    B, T, cap, Hq, Hkv, D = shape
    rng = np.random.default_rng(11)
    q = _randn(rng, (B, T, Hq, D), torch.bfloat16, cuda)
    k = _randn(rng, (B, cap, Hkv, D), torch.bfloat16, cuda)
    v = _randn(rng, (B, cap, Hkv, D), torch.bfloat16, cuda)
    off = torch.tensor(_verify_positions(B, T, cap, Hkv), dtype=torch.int32,
                       device=cuda)
    kernel = "flash_verify" if T > 1 else "flash_decode"
    before = flash_attention.kernel_launches[kernel]
    got = flash_attention(q, k, v, off, causal=True, seq_kv=cap, verify=True)
    torch.cuda.synchronize()
    assert flash_attention.kernel_launches[kernel] == before + 1
    want = sdpa_ref(q, k, v, q_offset=off, causal=True, seq_kv=cap)
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -6, atol=1e-4)


@pytest.mark.parametrize("shape", VERIFY_SHAPES)
def test_flash_verify_rows_bit_equal_decode(cuda, shape):
    """Row t of the verify is bit-equal to a decode launch (S = 1) at
    ``q_offset + t`` over the same cache — the contract the speculative
    window's bit-exact streams rest on — and two verify launches repeat bit
    for bit."""
    B, T, cap, Hq, Hkv, D = shape
    rng = np.random.default_rng(12)
    q = _randn(rng, (B, T, Hq, D), torch.bfloat16, cuda)
    k = _randn(rng, (B, cap, Hkv, D), torch.bfloat16, cuda)
    v = _randn(rng, (B, cap, Hkv, D), torch.bfloat16, cuda)
    off = torch.tensor(_verify_positions(B, T, cap, Hkv), dtype=torch.int32,
                       device=cuda)
    got = flash_attention(q, k, v, off, causal=True, seq_kv=cap, verify=True)
    again = flash_attention(q, k, v, off, causal=True, seq_kv=cap, verify=True)
    before = flash_attention.kernel_launches["flash_decode"]
    rows = torch.cat([flash_attention(q[:, t:t + 1].contiguous(), k, v, off + t,
                                      causal=True, seq_kv=cap) for t in range(T)],
                     dim=1)
    assert flash_attention.kernel_launches["flash_decode"] == before + T
    assert torch.equal(got, rows)
    assert torch.equal(got, again)


def test_verify_step_rows_bit_equal_decode_on_the_card(cuda):
    """qwen3's smoke model in bf16 on the card: ``verify_step`` row t equals
    ``decode_step`` at ``pos + t`` bit for bit (logits and cache), through
    one flash_verify launch per layer. Prints whether the products of the
    full-width qwen3 step give the same bits at M = slots x T rows as at M =
    slots, and the rms norm and activation too — the reason each verify
    row runs at the decode step's shape; run with ``-s`` to see the line."""
    import json

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import Model
    from repro_torch.models.layers import rms_norm_vec, silu

    cfg = smoke_config("qwen3-1.7b").replace(dtype="bfloat16")
    model = Model(cfg, device=cuda, seed=0)
    S, T, cap = 8, 4, 64
    rng = np.random.default_rng(13)
    a = model.init_cache(S, cap)
    pre = torch.from_numpy(rng.integers(0, cfg.vocab_size, (S, 9))).to(cuda)
    for p in range(9):
        model.decode_step(pre[:, p:p + 1], a, p)
    b = {n: t.clone() for n, t in a.items()}
    pos = torch.tensor([9, 9, 20, 31, 32, 40, 55, 59], dtype=torch.int32, device=cuda)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (S, T))).to(cuda)
    reset_launch_counts()
    got = model.verify_step(toks, a, pos)
    counts = launch_counts()
    want = torch.cat([model.decode_step(toks[:, t:t + 1], b, pos + t)
                      for t in range(T)], dim=1)
    assert counts["flash_verify"] == counts["flash_attention"] == cfg.num_layers
    assert torch.equal(got, want)
    for n in a:
        assert torch.equal(a[n], b[n]), n

    full = get_config("qwen3-1.7b")
    d, ff, hd = full.d_model, full.d_ff, full.resolved_head_dim
    equal = {}
    for name, (din, dout, dtype) in {
            "wq": (d, full.num_heads * hd, torch.bfloat16),
            "wk_wv": (d, full.num_kv_heads * hd, torch.bfloat16),
            "wo": (full.num_heads * hd, d, torch.bfloat16),
            "mlp_wi_wg": (d, ff, torch.bfloat16), "mlp_wo": (ff, d, torch.bfloat16),
            "unembed_fp32": (d, full.vocab_size, torch.float32)}.items():
        w = _randn(rng, (din, dout), dtype, cuda) * 0.02
        x = _randn(rng, (S, T, din), dtype, cuda)
        per_row = torch.cat([x[:, t:t + 1] @ w for t in range(T)], dim=1)
        equal[name] = bool(torch.equal(x @ w, per_row))
    x = _randn(rng, (S, T, d), torch.bfloat16, cuda)
    scale = torch.ones(d, device=cuda)
    equal["rms_norm"] = bool(torch.equal(rms_norm_vec(x, scale), torch.cat(
        [rms_norm_vec(x[:, t:t + 1], scale) for t in range(T)], dim=1)))
    equal["silu"] = bool(torch.equal(silu(x), torch.cat(
        [silu(x[:, t:t + 1]) for t in range(T)], dim=1)))
    print(json.dumps({"test": "verify_products_by_row_count",
                      "card": torch.cuda.get_device_name(0), "slots": S, "T": T,
                      "bits_at_slots_x_T_equal_slots": equal}))


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_spec_engine_bit_equal_on_the_card(cuda, paged):
    """qwen3's smoke model in bf16 on the card, seeded: the speculative
    engine serves the overlap engine's streams token for token, contiguous
    and over the page pool, at 2 host syncs a window, with drafts both
    accepted and rejected; every page back at drain. The embedding is drawn
    at 0.3 of its init scale: at the init scale its term dominates the
    residual stream, the model repeats its input token at every depth and
    no draft misses."""
    from repro_torch.configs import smoke_config
    from repro_torch.core.device_channel import readback
    from repro_torch.models import Model
    from repro_torch.serve import OK, EngineConfig, Replica, Request

    cfg = smoke_config("qwen3-1.7b").replace(dtype="bfloat16")
    model = Model(cfg, device=cuda, seed=0)
    with torch.no_grad():
        model.embed.mul_(0.3)
    model.tie_unembed()
    rng = np.random.default_rng(14)
    traffic = [(tuple(int(t) for t in rng.integers(1, cfg.vocab_size,
                                                   int(rng.integers(2, 30)))),
                int(rng.integers(3, 20))) for _ in range(6)]
    streams = []
    for spec in (False, True):
        rep = Replica(cfg, model, config=EngineConfig(
            num_slots=3, max_len=64, window=4, speculate=spec, draft_len=3,
            draft_layers=1, paged=paged and spec, page_size=8))
        for i, (prompt, n) in enumerate(traffic):
            assert rep.submit(Request(id=i, prompt=prompt, max_new_tokens=n)) is None
        readback.count = 0
        out = rep.run()
        m = rep.metrics
        assert all(r.status == OK for r in out) and not m.faults
        assert readback.count == 2 * m.windows
        streams.append({r.id: r.tokens for r in out})
    assert streams[0] == streams[1]
    assert m.draft_tokens > m.accepted_draft_tokens > 0
    if paged:
        assert m.pages_allocated == m.pages_freed > 0
        rep.alloc.check()


def test_group_survives_a_kill_on_the_card(cuda):
    """A 3-rank fleet of qwen3's smoke model in bf16 on the card (one model
    shared, the overlap engine, the ranks as threads on the default
    stream): rank 1 dies at round 2 with its window queued; the survivors
    shrink once to 2 ranks, re-route its requests and answer every one
    with the stream one replica gives, at most 2 host syncs per retired
    window summed over the ranks, through the flash decode and probe
    kernels."""
    from repro_torch.configs import smoke_config
    from repro_torch.core.device_channel import readback
    from repro_torch.core.faults import FaultSchedule, FaultSpec
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import Model
    from repro_torch.serve import (OK, EngineConfig, Replica, Request,
                                   ServeGroup)

    cfg = smoke_config("qwen3-1.7b").replace(dtype="bfloat16")
    model = Model(cfg, device=cuda, seed=0)
    conf = EngineConfig(num_slots=4, max_len=64, window=4)
    rng = np.random.default_rng(19)
    traffic = [(tuple(int(t) for t in rng.integers(1, cfg.vocab_size,
                                                   int(rng.integers(2, 30)))),
                int(rng.integers(3, 20))) for _ in range(9)]
    reqs = lambda: [Request(id=i, prompt=p, max_new_tokens=n)  # noqa: E731
                    for i, (p, n) in enumerate(traffic)]
    rep = Replica(cfg, model, config=conf)
    for r in reqs():
        assert rep.submit(r) is None
    want = {r.id: r.tokens for r in rep.run()}
    group = ServeGroup(cfg, 3, model=model, config=conf)
    reset_launch_counts()
    readback.count = 0
    res = group.serve(reqs(), faults=FaultSchedule(
        [FaultSpec(step=2, kind="kill", rank=1)]))
    torch.cuda.synchronize()
    assert [rr.rank for rr in res.reports if rr.killed] == [1]
    assert all(rr.exception is None for rr in res.reports)
    for rank in (0, 2):
        assert [e for e in res.report(rank).events if e[0] == "shrink"] == [
            ("shrink", 2, 2)]
    assert res.rerouted
    assert all(r.status == OK for r in res.responses.values())
    assert {r.replica for r in res.responses.values()} <= {0, 2}
    assert {i: r.tokens for i, r in res.responses.items()} == want
    # rank 1 retired at most one window in each of its 2 rounds
    windows = sum(res.report(r).metrics.windows for r in (0, 2)) + 2
    assert readback.count <= 2 * windows
    counts = launch_counts()
    assert counts["flash_decode"] > 0 and counts["probe_rows"] > 0


# ------------------------------------------------------------------ training
def test_wait_timeout_on_the_card(cuda):
    """A future whose step is still running (the device held by a spin)
    raises TimeoutError_ at ``wait(timeout=1e-3)``, then waits normally."""
    from repro_torch.core.device_channel import DeviceFuture, record_event
    from repro_torch.core.errors import TimeoutError_

    torch.cuda.synchronize()
    torch.cuda._sleep(10 ** 9)                        # ~0.5 s of device time
    word = torch.zeros((), dtype=torch.int32, device=cuda)
    fut = DeviceFuture(outputs="x", word=word, event=record_event(cuda))
    with pytest.raises(TimeoutError_):
        fut.wait(timeout=1e-3)
    with pytest.raises(TimeoutError_):
        fut.result(timeout=1e-3)
    assert fut.wait() == "x" and fut.done()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 33, 4, 2, 16, 0), (1, 130, 16, 8, 128, 0),
                                   (2, 64, 4, 1, 64, 24), (1, 1, 4, 2, 32, 0)])
def test_flash_lse_matches_plain(cuda, dtype, shape):
    """The training forward's row lse (flash_forward in bf16, flash_f32 in
    fp32) against the plain one: fp32 sums in another order (1e-5 of
    |lse| + 1e-5); its output bit-equal to the launch without lse."""
    B, S, Hq, Hkv, D, window = shape
    rng = np.random.default_rng(S)
    q = _randn(rng, (B, S, Hq, D), dtype, cuda)
    k, v = (_randn(rng, (B, S, Hkv, D), dtype, cuda) for _ in range(2))
    zero = torch.zeros(B, dtype=torch.int32, device=cuda)
    out, lse = flash_attention(q, k, v, zero, causal=True, window=window, lse=True)
    want_out, want_lse = sdpa_ref(q, k, v, q_offset=zero, causal=True,
                                  window=window, return_lse=True)
    assert lse.shape == (B, S, Hq) and lse.dtype == torch.float32
    assert ((lse - want_lse).abs() <= 1e-5 + 1e-5 * want_lse.abs()).all()
    if S > 1:
        assert torch.equal(out, flash_attention(q, k, v, zero, causal=True,
                                                window=window))
    tol = 2e-5 if dtype == torch.float32 else 1.6e-2
    assert (out.float() - want_out.float()).abs().max().item() <= tol


def test_flash_function_gradients_on_the_card(cuda):
    """FlashAttention (kernel forward, plain recompute backward) against
    autograd through the plain forward in fp32 over the same bf16 inputs,
    at a small training shape: each gradient within 1e-2 of its largest
    value plus 2 bf16 ulps of itself (bf16 outputs of fp32 sums)."""
    from repro_torch.kernels.flash_attention import FlashAttention
    rng = np.random.default_rng(7)
    q = _randn(rng, (2, 96, 8, 64), torch.bfloat16, cuda).requires_grad_()
    k = _randn(rng, (2, 96, 4, 64), torch.bfloat16, cuda).requires_grad_()
    v = _randn(rng, (2, 96, 4, 64), torch.bfloat16, cuda).requires_grad_()
    do = _randn(rng, (2, 96, 8, 64), torch.bfloat16, cuda)
    got = torch.autograd.grad(FlashAttention.apply(q, k, v, True, 0, 2048, 2048),
                              (q, k, v), do)
    f = [t.detach().float().requires_grad_() for t in (q, k, v)]
    zero = torch.zeros(2, dtype=torch.int32, device=cuda)
    want = torch.autograd.grad(sdpa_ref(*f, q_offset=zero, causal=True),
                               f, do.float())
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert ((g.float() - w).abs() <= 1e-2 * w.abs().max() + 2.0 ** -6 * w.abs()).all()


# the encoder's and the VLM's training routes at their train shapes (B 4 x
# S 256): (S, T, Hq, Hkv, D, causal) — hubert's bidirectional self-attention
# at head_dim 80, the VLM's causal self-attention and its cross-attention
# over 1601 image keys (the last tile ragged)
TRAIN_ROUTES = [(256, 256, 16, 16, 80, False), (256, 256, 32, 8, 128, True),
                (256, 1601, 32, 8, 128, False)]


@pytest.mark.parametrize("route", TRAIN_ROUTES)
def test_flash_lse_and_gradients_on_the_train_routes(cuda, route):
    """flash_forward's row lse on the non-causal, T != S and D 80 routes
    against the plain one (1e-5 of |lse| + 1e-5: fp32 sums in another
    order), its output bit-equal to the launch without lse and within 2
    bf16 ulps of the plain one; FlashAttention's gradients against autograd
    through the plain forward in fp32 (1e-2 of the largest value plus 2
    bf16 ulps of each, as at the causal shapes)."""
    from repro_torch.kernels.flash_attention import FlashAttention
    S, T, Hq, Hkv, D, causal = route
    rng = np.random.default_rng(T)
    q = _randn(rng, (4, S, Hq, D), torch.bfloat16, cuda)
    k, v = (_randn(rng, (4, T, Hkv, D), torch.bfloat16, cuda) for _ in range(2))
    do = _randn(rng, (4, S, Hq, D), torch.bfloat16, cuda)
    zero = torch.zeros(4, dtype=torch.int32, device=cuda)
    before = flash_attention.kernel_launches["flash_forward"]
    out, lse = flash_attention(q, k, v, zero, causal=causal, lse=True)
    assert flash_attention.kernel_launches["flash_forward"] == before + 1
    want_out, want_lse = sdpa_ref(q, k, v, q_offset=zero, causal=causal,
                                  return_lse=True)
    assert ((lse - want_lse).abs() <= 1e-5 + 1e-5 * want_lse.abs()).all()
    assert torch.equal(out, flash_attention(q, k, v, zero, causal=causal))
    assert (out.float() - want_out.float()).abs().max().item() <= 1.6e-2
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(FlashAttention.apply(*leaves, causal, 0, 2048, 2048),
                              leaves, do)
    f = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(sdpa_ref(*f, q_offset=zero, causal=causal), f,
                               do.float())
    for g, w in zip(got, want):
        assert ((g.float() - w).abs() <= 1e-2 * w.abs().max() + 2.0 ** -6 * w.abs()).all()


@pytest.mark.parametrize("arch", ["hubert-xlarge", "llama-3.2-vision-11b"])
def test_family_train_lflr_equals_clean_on_the_card(cuda, arch):
    """The smoke encoder (frame embeddings) and VLM (image embeddings, its
    cross gates set to 0.5) trained on the card: flash once per layer a
    step (fp32: the ``flash_f32`` route), one host sync a step; nan_grad
    at 3 (skip) and 8
    (restore), bit-equal on every leaf to a clean run over the kept
    batches."""
    from repro_torch.configs import smoke_config
    from repro_torch.core import (ExecutorConfig, FaultSchedule, FaultSpec,
                                  ResilientExecutor)
    from repro_torch.core.device_channel import readback
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.steps import make_reset_opt_fn
    from repro_torch.launch.train import build_train_setup
    from repro_torch.tree import tree_leaves

    cfg = smoke_config(arch)
    _, step_fn, state0, pipe, _ = build_train_setup(cfg, batch_size=2, seq_len=16,
                                                    device=cuda)
    for name, t in state0["params"].items():
        if name.endswith(("gate_attn", "gate_mlp")):
            t.fill_(0.5)
    ex = ResilientExecutor(step_fn, config=ExecutorConfig(good_state_interval=5),
                           reset_opt_fn=make_reset_opt_fn(cfg))
    before = readback.count
    reset_launch_counts()
    state, log = ex.run(state0, pipe, 12, faults=FaultSchedule(
        [FaultSpec(step=3, kind="nan_grad"), FaultSpec(step=8, kind="nan_grad")]))
    assert launch_counts()["flash_attention"] == 12 * cfg.num_layers
    assert readback.count == before + 12
    assert [(e.step, e.action) for e in log.faults()] == [(3, "skip_batch"),
                                                           (8, "restore_good")]
    clean = state0
    for i in (0, 1, 2, 4, 5, 9, 10, 11):
        clean, _, word = step_fn(clean, make_batch(pipe.cfg, i, cuda), 0)
        assert int(word) == 0
    assert all(a.device.type == "cuda" and torch.equal(a, b)
               for a, b in zip(tree_leaves(state), tree_leaves(clean)))


def test_embed_lookup_backward_is_deterministic_on_the_card(cuda):
    """The embedding gradient (sorted runs, segment sums) repeats bit for
    bit on the card and equals the CPU's sequential index_add_."""
    from repro_torch.models.layers import EmbedLookup
    gen = torch.Generator().manual_seed(0)
    table = torch.randn(300, 64, generator=gen)
    tokens = torch.randint(-300, 310, (4, 256), generator=gen, dtype=torch.int32)
    tokens[0, :50] = 7                                # many repeats of one id
    grad = torch.randn(4, 256, 64, generator=gen)
    outs = []
    for _ in range(3):
        t = table.to(cuda).requires_grad_()
        rows = EmbedLookup.apply(t, tokens.to(cuda))
        outs.append(torch.autograd.grad(rows, t, grad.to(cuda))[0].cpu())
    valid = (tokens >= -300) & (tokens < 300)
    ref = torch.zeros(300, 64).index_add_(
        0, torch.remainder(tokens.long(), 300)[valid], grad[valid])
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    assert torch.equal(outs[0], ref)
    assert torch.isnan(rows.detach()[~valid.to(cuda)]).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_lflr_equals_clean_on_the_card(cuda, dtype):
    """The smoke qwen3 trained on the card: nan_grad at 3 (skip) and 8
    (restore), bit-equal on every leaf to a clean run over the kept
    batches; one host sync a step; an id past the vocabulary gives a NaN
    row, not a device assert."""
    from repro_torch.configs import smoke_config
    from repro_torch.core import (ExecutorConfig, FaultSchedule, FaultSpec,
                                  ResilientExecutor)
    from repro_torch.core.device_channel import readback
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch.steps import make_reset_opt_fn
    from repro_torch.launch.train import build_train_setup
    from repro_torch.tree import tree_leaves

    cfg = smoke_config("qwen3-1.7b").replace(dtype=dtype)
    _, step_fn, state0, pipe, _ = build_train_setup(cfg, batch_size=2, seq_len=16,
                                                    device=cuda)
    ex = ResilientExecutor(step_fn, config=ExecutorConfig(good_state_interval=5),
                           reset_opt_fn=make_reset_opt_fn(cfg))
    before = readback.count
    state, log = ex.run(state0, pipe, 12, faults=FaultSchedule(
        [FaultSpec(step=3, kind="nan_grad"), FaultSpec(step=8, kind="nan_grad")]))
    assert readback.count == before + 12
    assert [(e.step, e.action) for e in log.faults()] == [(3, "skip_batch"),
                                                           (8, "restore_good")]
    clean = state0
    for i in (0, 1, 2, 4, 5, 9, 10, 11):
        clean, _, _ = step_fn(clean, make_batch(pipe.cfg, i, cuda), 0)
    assert all(a.device.type == "cuda" and torch.equal(a, b)
               for a, b in zip(tree_leaves(state), tree_leaves(clean)))
    bad = make_batch(pipe.cfg, 0, cuda)
    bad["tokens"][1, 3] = cfg.vocab_size + 5
    _, metrics, word = step_fn(state0, bad, 0)
    assert int(word) & int(ErrorCode.DATA_FAULT) and torch.isnan(metrics["loss"])


def test_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """A smoke-width bf16 train state on the card saved and restored bit for
    bit, each leaf back on the card; a corrupt newer checkpoint skipped."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import smoke_config
    from repro_torch.launch.train import build_train_setup
    from repro_torch.tree import tree_leaves

    cfg = smoke_config("qwen3-1.7b").replace(dtype="bfloat16")
    _, step_fn, state, pipe, _ = build_train_setup(cfg, batch_size=2, seq_len=16,
                                                   device=cuda)
    state, _, _ = step_fn(state, next(pipe), 0)
    ck = Checkpointer(tmp_path)
    ck.save(1, state, blocking=True)
    newer, _, _ = step_fn(state, next(pipe), 0)
    ck.save(2, newer, blocking=True)
    leaf = tmp_path / "step-0000000002" / "leaf-00000.npy"
    raw = bytearray(leaf.read_bytes())
    raw[-1] ^= 0x40
    leaf.write_bytes(bytes(raw))
    step, got = ck.restore_latest(like=newer)
    assert step == 1
    for a, b in zip(tree_leaves(got), tree_leaves(state)):
        assert a.device.type == "cuda" and a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------- probe_tree
TREE_THRESHOLDS = (1e4, float("inf"), 0.0, -1.0, 10000.0007)


def _tree_word(tree, threshold, launches):
    """probe_tree's word, its launches counted, held to probe_tree_ref."""
    before = probe_tree.launches
    got = probe_tree(tree, threshold, nonfinite_code=NF, overflow_code=OV)
    torch.cuda.synchronize()
    assert probe_tree.launches == before + launches
    want = probe_tree_ref(tree, threshold, nonfinite_code=NF, overflow_code=OV)
    assert got.dtype == torch.int32 and got.dim() == 0 and got.device.type == "cuda"
    assert torch.equal(got, want), (threshold, got, want)
    return int(got)


def _mixed_tree(rng, cuda, n=60):
    """fp32 and bf16 leaves of odd lengths, one-element, empty and integer
    leaves, |x| < 1."""
    tree = {}
    for i in range(n):
        size = int(rng.choice([0, 1, 2, 7, 2048, 8191, 8193, 40001, 300000]))
        dtype = (torch.float32, torch.bfloat16)[i % 2]
        tree[f"l{i}"] = 0.1 * _randn(rng, (size,), dtype, cuda)
    tree["ids"] = torch.arange(7, device=cuda)
    return tree


def test_probe_tree_kernel_matches_plain(cuda):
    """One launch for a tree of at most MAX_LEAVES leaves, at every
    threshold, clean and with faults at leaves' first and last elements."""
    rng = np.random.default_rng(11)
    tree = _mixed_tree(rng, cuda)
    for thr in TREE_THRESHOLDS:
        assert _tree_word(tree, thr, 1) == (OV if thr <= 0 else 0)
    for name, i, val in (("l3", -1, float("nan")), ("l8", 0, float("-inf")),
                         ("l5", 0, 3e4), ("l4", -1, -2e4), ("l8", -1, 10000.0009765625)):
        leaf = tree[name]
        if not leaf.numel():
            continue
        keep = leaf[i].clone()
        leaf[i] = val
        words = [_tree_word(tree, thr, 1) for thr in TREE_THRESHOLDS]
        leaf[i] = keep
        assert any(words)
    # a non-finite element counts as 0 in the threshold test, as in the
    # plain version: at a negative threshold a leaf of NaNs alone sets both
    nans = torch.full((2, 9), float("nan"), device=cuda)
    assert _tree_word([nans[0]], -1.0, 1) == NF | OV
    assert probe_rows(nans, -1.0, nonfinite_code=NF, overflow_code=OV).tolist() == [NF | OV] * 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_probe_tree_views_at_every_offset(cuda, dtype):
    """Views at element offsets 0-7 into one buffer (16-byte heads of every
    length), of lengths around a vector and a chunk: a fault at a view's
    first or last element is seen, and one just outside it is not."""
    buf = torch.zeros(3 * 40000, dtype=dtype, device=cuda)
    for n in (1, 5, 9, 16391, 16393, 40000):
        for off in range(8):
            start = off + 20000
            for i in (start, start + n - 1):
                buf[i] = float("nan")
                assert _tree_word([buf[start:start + n]], 1e4, 1) == NF
                buf[i] = 0
            for i in (start - 1, start + n):
                buf[i] = float("inf")
                assert _tree_word([buf[start:start + n]], 1e4, 1) == 0
                buf[i] = 0


def test_probe_tree_more_leaves_than_one_table(cuda):
    """MAX_LEAVES + 1 leaves: two launches into one word, a fault in the
    first launch's leaves and in the second's seen alike."""
    leaves = [torch.zeros(3 + i % 5, device=cuda) for i in range(MAX_LEAVES + 1)]
    assert _tree_word(leaves, 1e4, 2) == 0
    leaves[-1][2] = float("nan")
    assert _tree_word(leaves, 1e4, 2) == NF
    leaves[-1][2] = 0
    leaves[0][0] = 2e4
    assert _tree_word(leaves, 1e4, 2) == OV
    assert _tree_word(leaves[:MAX_LEAVES], 1e4, 1) == OV


def test_probe_tree_zero_size_leaves(cuda):
    empty = [torch.empty(0, device=cuda), torch.empty((3, 0), dtype=torch.bfloat16,
                                                      device=cuda)]
    assert _tree_word(empty, -1.0, 0) == 0
    x = torch.zeros(5, device=cuda)
    x[4] = float("nan")
    assert _tree_word(empty + [x] + empty, 1e4, 1) == NF


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_probe_subnormals_at_threshold_zero(cuda, dtype):
    """A subnormal is finite and above 0: OVERFLOW at threshold 0 in the
    tree and the row probe alike (the kernel flushes nothing); -0.0 is not."""
    tiny = 1e-44 if dtype == torch.float32 else 1e-39
    x = torch.zeros((2, 9000), dtype=dtype, device=cuda)
    assert 0 < abs(float(torch.tensor(tiny, dtype=dtype))) < torch.finfo(dtype).tiny
    x[1, 8999] = tiny
    x[0, 3] = -0.0
    assert _tree_word([x[0], x[1]], 0.0, 1) == OV
    assert _tree_word([x[0]], 0.0, 1) == 0
    got = probe_rows(x, 0.0, nonfinite_code=NF, overflow_code=OV)
    assert torch.equal(got, probe_rows_ref(x, 0.0, nonfinite_code=NF, overflow_code=OV))
    assert got.tolist() == [0, OV]


def test_probe_tree_leaf_past_2_31_elements(cuda):
    """A bf16 leaf of 2^31 + 1000 elements (4.3 GB) beside a small one:
    faults past element 2^31 are seen."""
    n = 2 ** 31 + 1000
    big = torch.zeros(n, dtype=torch.bfloat16, device=cuda)
    small = torch.zeros(10, device=cuda)
    assert probe_tree([small, big], 1e4, nonfinite_code=NF, overflow_code=OV).item() == 0
    big[n - 1] = float("nan")
    assert probe_tree([small, big], 1e4, nonfinite_code=NF, overflow_code=OV).item() == NF
    big[n - 1] = 0
    big[2 ** 31 + 5] = 3e4
    assert probe_tree([small, big], 1e4, nonfinite_code=NF, overflow_code=OV).item() == OV


def test_probe_tree_from_two_threads_on_two_streams(cuda):
    """The same tree probed from two threads, each on its own stream, many
    times over: every word is the plain version's (no scratch is shared
    between calls)."""
    import threading
    rng = np.random.default_rng(12)
    tree = _mixed_tree(rng, cuda)
    first, second = [t for t in tree.values()
                     if torch.is_floating_point(t) and t.numel()][:2]
    first[0] = float("nan")
    second[-1] = 5e4
    want = probe_tree_ref(tree, 1e4, nonfinite_code=NF, overflow_code=OV)
    torch.cuda.synchronize()
    words, errors = {0: [], 1: []}, []

    def run(k):
        try:
            stream = torch.cuda.Stream(device=cuda)
            with torch.cuda.stream(stream):
                for _ in range(50):
                    words[k].append(probe_tree(tree, 1e4, nonfinite_code=NF,
                                               overflow_code=OV))
            stream.synchronize()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and int(want) == NF | OV
    assert all(torch.equal(w, want) for k in (0, 1) for w in words[k])
    assert len(words[0]) == len(words[1]) == 50


def test_probe_rows_makes_no_fill_launch(cuda):
    """One probe_rows call is one kernel on the device (its words zeroed by
    a memset inside the entry point), and one probe_tree call too: no fill
    kernel beside them."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.zeros((8, 151936), device=cuda)
    tree = [torch.zeros(1000, device=cuda), torch.zeros(77, dtype=torch.bfloat16,
                                                         device=cuda)]
    probe_rows(x, 1e4, nonfinite_code=NF, overflow_code=OV)
    probe_tree(tree, 1e4, nonfinite_code=NF, overflow_code=OV)
    torch.cuda.synchronize()
    for call in (lambda: probe_rows(x, 1e4, nonfinite_code=NF, overflow_code=OV),
                 lambda: probe_tree(tree, 1e4, nonfinite_code=NF, overflow_code=OV)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        kernels = [e.key for e in prof.key_averages()
                   if e.self_device_time_total > 0 and "memset" not in e.key.lower()]
        assert len(kernels) == 1 and "probe_kernel" in kernels[0], kernels


# ------------------------------------------------------------- multi-host
def test_library_builds_once_across_processes_on_the_card(cuda, tmp_path):
    """Two processes build the kernel library with ``nvcc`` into one empty
    build directory at once, and both load it and launch from it."""
    import os
    import subprocess
    import sys
    import textwrap
    script = textwrap.dedent("""
        import sys
        from pathlib import Path
        import torch
        import repro_torch.kernels.build as b
        b.BUILD_DIR = Path(sys.argv[1])
        from repro_torch.kernels import launch_counts, probe_rows
        lib = b.library()
        x = torch.zeros((2, 64), device="cuda")
        x[1, 3] = float("nan")
        w = probe_rows(x, 1e4, nonfinite_code=1, overflow_code=16)
        print(b.build(), w.tolist(), launch_counts()["probe_rows"])
    """)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(sys.path)}
    procs = [subprocess.Popen([sys.executable, "-c", script, str(tmp_path / "build")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for _ in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    lines = [o.split() for o, _ in outs]
    assert lines[0][0] == lines[1][0] and lines[0][0].endswith(".so")
    assert all(line[1:] == ["[0,", "1]", "1"] for line in lines), lines


def test_replica_worker_reports_its_launches_on_the_card(cuda):
    """Two ``replica`` worker processes on the card (qwen3's smoke model,
    fp32, from the seeded init): every answer is the in-process replica's,
    and each worker's ``bye`` carries its flash launches (the fp32 route),
    a multiple of the layers, and its probe launches."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import Model
    from repro_torch.serve import (EngineConfig, MultiHostSupervisor, Replica,
                                   Request)

    arch = "qwen3-1.7b"
    cfg = smoke_config(arch)
    conf = EngineConfig(num_slots=4, max_len=64, window=4)
    reqs = lambda: [Request(id=i, prompt=tuple(3 + i + j for j in range(9)),  # noqa: E731
                            max_new_tokens=12) for i in range(6)]
    rep = Replica(cfg, Model(cfg, device=cuda, seed=0), config=conf)
    for r in reqs():
        assert rep.submit(r) is None
    want = {r.id: r.tokens for r in rep.run()}
    sup = MultiHostSupervisor(2, backend="replica", arch=arch, config=conf,
                              device="cuda", suspect_timeout=2.0, timeout=300.0)
    res = sup.serve(reqs())
    assert {i: r.tokens for i, r in res.responses.items()} == want
    assert res.evicted == () and res.words == {0: 0, 1: 0}
    for rank in (0, 1):
        n = res.launches[rank]
        assert n["flash_f32"] > 0 and n["flash_f32"] % cfg.num_layers == 0
        assert n["flash_attention"] == n["flash_f32"] and n["probe_rows"] > 0


def test_fresh_lane_makes_no_sync_in_the_replica_on_the_card(cuda):
    """Sync debug mode over a clean overlapped run whose lanes start fresh
    (requests outnumber the slots) and a blocking-prefill run: no
    synchronising operation lies in ``serve/replica.py``."""
    import warnings

    from repro_torch.configs import smoke_config
    from repro_torch.models import Model
    from repro_torch.serve import EngineConfig, Replica, Request

    cfg = smoke_config("qwen3-1.7b")
    model = Model(cfg, device=cuda, seed=0)
    for conf in (EngineConfig(num_slots=2, max_len=64, window=4),
                 EngineConfig(num_slots=2, max_len=64, window=4, overlap=False),
                 EngineConfig(num_slots=2, max_len=64, window=4, paged=True)):
        rep = Replica(cfg, model, config=conf)
        rep.warmup()
        for i in range(5):
            assert rep.submit(Request(id=i, prompt=tuple(range(2, 9 + i)),
                                      max_new_tokens=10)) is None
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = rep.run()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        assert len(out) == 5 and all(r.ok for r in out)
        sites = {f"{w.filename}:{w.lineno}" for w in caught
                 if "called a synchronizing CUDA operation" in str(w.message)}
        assert sites and not [s for s in sites if "serve/replica.py" in s], sites


# -------------------------------------------------- the scans' backward kernels
# (B, S, W): one chunk (S <= 128, and exactly 128), across a chunk boundary
# (S 300: three chunks, the last ragged), a ragged width, many chunks, the
# training shape and recurrentgemma-2b's prefill shape
SCAN_BWD_CASES = [(1, 16, 64), (2, 100, 64), (1, 128, 200), (2, 300, 256),
                  (3, 9, 1), (2, 1000, 640), (4, 256, 2560), (2, 4096, 2560)]


def _scan_bwd_inputs(rng, shape, memory, device):
    """x_in, log_a (as the forward's tests draw them), the states h the
    forward gives and a normal dh."""
    x_in = _randn(rng, shape, torch.float32, device)
    log_a = _scan_log_a(rng, shape, memory, device)
    return x_in, log_a, rglru_scan(x_in, log_a), _randn(rng, shape, torch.float32, device)


def _within(got, want, a=1e-4, r=1e-4):
    """Every element within ``a`` of the largest |want| plus ``r`` of its
    own |want|."""
    want = want.float()
    return bool(((got.float() - want).abs()
                 <= a * want.abs().max() + r * want.abs()).all())


@pytest.mark.parametrize("memory", ["short", "long"])
@pytest.mark.parametrize("shape", SCAN_BWD_CASES)
def test_rglru_scan_bwd_kernel_matches_plain(cuda, shape, memory):
    """dx_in and dlog_a against the plain reverse loop on the same inputs.
    fp32 both sides; exp/sqrt ulps, FMA contraction and the chunk carries
    (folded in another order than the loop's) compound through the reverse
    recurrence over ~1/(1-a) steps, and dlog_a subtracts two terms of
    similar size: 1e-4 of the largest |want| plus 1e-4 of each."""
    from repro_torch.kernels.rglru_scan import rglru_scan_backward_ref, rglru_scan_bwd
    rng = np.random.default_rng(12)
    ins = _scan_bwd_inputs(rng, shape, memory, cuda)
    before = rglru_scan_bwd.launches
    got = rglru_scan_bwd(*ins)
    torch.cuda.synchronize()
    assert rglru_scan_bwd.launches == before + 1
    want = rglru_scan_backward_ref(*ins)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _within(g, w)


def test_rglru_scan_bwd_at_the_clamp(cuda):
    """a = 1 exactly (log_a 0) and a within 1e-12 of 1: the clamp holds and
    the x_in a / s term is 0, on the card as in the plain version (1 - a²
    formed from a rounded square on both)."""
    from repro_torch.kernels.rglru_scan import rglru_scan_backward_ref, rglru_scan_bwd
    rng = np.random.default_rng(13)
    shape = (2, 300, 256)
    x_in = _randn(rng, shape, torch.float32, cuda)
    log_a = -torch.nn.functional.softplus(_randn(rng, shape, torch.float32, cuda))
    log_a[:, ::7] = 0.0
    log_a[:, 3::7] = -1e-9
    log_a[:, 5::7] = -1e-7
    ins = (x_in, log_a, rglru_scan(x_in, log_a), _randn(rng, shape, torch.float32, cuda))
    for g, w in zip(rglru_scan_bwd(*ins), rglru_scan_backward_ref(*ins)):
        assert torch.isfinite(g).all() and _within(g, w)


@pytest.mark.parametrize("memory", ["short", "long"])
def test_rglru_scan_bwd_repeats_bit_for_bit(cuda, memory):
    """Two launches give the same bits, and a batch row's gradient does not
    depend on the other rows' data (the carries fold in a fixed order, no
    atomics): what an LFLR replay of a training step rests on."""
    from repro_torch.kernels.rglru_scan import rglru_scan_bwd
    rng = np.random.default_rng(14)
    shape = (3, 4100, 640)
    ins = _scan_bwd_inputs(rng, shape, memory, cuda)
    a, b = rglru_scan_bwd(*ins), rglru_scan_bwd(*ins)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    other = [t.clone() for t in ins]
    for t, new in zip(other, _scan_bwd_inputs(rng, (2, *shape[1:]), memory, cuda)):
        t[1:] = new
    c = rglru_scan_bwd(*other)
    assert all(torch.equal(x[0], y[0]) for x, y in zip(a, c))
    assert not torch.equal(a[0][1], c[0][1])


def _ssd_bwd_inputs(rng, case, dtype, device):
    """The forward's inputs (``_ssd_inputs``) and normal gradients of its two
    outputs."""
    b, s, h, p, g, n, chunk = case
    L = min(chunk, s)
    x, dt, A, B, C = _ssd_inputs(rng, case, dtype, device)
    dy = _randn(rng, (b, s, h, p), torch.float32, device)
    ds = _randn(rng, (b, s // L, h, p, n), torch.float32, device)
    return (x, dt, A, B, C, L, dy, ds)


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_bwd_kernel_matches_plain(cuda, case, dtype):
    """dx, ddt, dA, dB, dC against autograd through the plain intra-chunk
    function (x, B, C widened to fp32 on both sides). fp32 sums of <= 128
    terms (dA and the group sums: of the heads and chunks) in another
    order: 1e-4 of the largest |want| plus 1e-4 of each."""
    from repro_torch.kernels.ssd_scan import ssd_chunk_bwd, ssd_intra_chunk_backward_ref
    rng = np.random.default_rng(15)
    ins = _ssd_bwd_inputs(rng, case, dtype, cuda)
    before = ssd_chunk_bwd.launches
    got = ssd_chunk_bwd(*ins)
    torch.cuda.synchronize()
    assert ssd_chunk_bwd.launches == before + 1
    want = ssd_intra_chunk_backward_ref(*ins)
    for name, g, w, t in zip(("dx", "ddt", "dA", "dB", "dC"), got, want, ins):
        assert g.shape == t.shape and g.dtype == torch.float32, name
        assert _within(g, w), name


def test_ssd_chunk_bwd_repeats_bit_for_bit(cuda):
    """Two launches give the same bits; a batch row's dx, ddt, dB and dC do
    not depend on the other rows' data (dA sums over them, in a fixed
    order)."""
    from repro_torch.kernels.ssd_scan import ssd_chunk_bwd
    rng = np.random.default_rng(16)
    case = (3, 512, 8, 64, 2, 128, 128)
    ins = _ssd_bwd_inputs(rng, case, torch.bfloat16, cuda)
    a, b = ssd_chunk_bwd(*ins), ssd_chunk_bwd(*ins)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    other = list(ins)
    new = _ssd_bwd_inputs(rng, case, torch.bfloat16, cuda)
    for i in (0, 1, 3, 4, 6, 7):                   # x, dt, B, C, dy, dstates
        other[i] = ins[i].clone()
        other[i][1:] = new[i][1:]
    c = ssd_chunk_bwd(*other)
    for i in (0, 1, 3, 4):
        assert torch.equal(a[i][0], c[i][0])
        assert not torch.equal(a[i][1], c[i][1])


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_bwd_takes_the_route_its_dtype_picks(cuda, case, dtype):
    """bf16 x, B, C launch ``ssd_chunk_bwd_tc`` (the tensor cores), fp32
    ones ``ssd_chunk_bwd_f32``, one launch a call and no other kernel; the
    gradients repeat bit for bit."""
    from repro_torch.kernels.ssd_scan import ssd_chunk_bwd
    from repro_torch.kernels.ssd_scan.ops import plan_bwd
    rng = np.random.default_rng(18)
    ins = _ssd_bwd_inputs(rng, case, dtype, cuda)
    before = dict(ssd_chunk_bwd.kernel_launches)
    a = ssd_chunk_bwd(*ins)
    moved = {k: n - before[k] for k, n in ssd_chunk_bwd.kernel_launches.items()
             if n != before[k]}
    assert moved == {plan_bwd(dtype): 1}
    assert all(torch.equal(x, y) for x, y in zip(a, ssd_chunk_bwd(*ins)))


def test_ssd_chunk_bwd_tc_head_ignores_its_tile_and_the_other_rows(cuda):
    """On the tensor-core route a block takes a tile of heads of one group
    (6 of this shape's 12 a group on an H100): a head's dx, ddt and dA do
    not move when every other head of its group (its tile among them)
    changes, and a batch row's dx, ddt, dB, dC do not move when the other
    rows change. What LFLR on ``train_ssm`` rests on."""
    from repro_torch.kernels.ssd_scan import ssd_chunk_bwd
    rng = np.random.default_rng(19)
    case = (2, 2048, 24, 64, 2, 128, 128)
    ins = _ssd_bwd_inputs(rng, case, torch.bfloat16, cuda)
    a = ssd_chunk_bwd(*ins)
    new = _ssd_bwd_inputs(rng, case, torch.bfloat16, cuda)
    heads = list(ins)
    for i, axis in ((0, 2), (1, 2), (6, 2), (7, 2)):    # x, dt, dy, dstates
        heads[i] = ins[i].clone()
        heads[i].narrow(axis, 1, 11).copy_(new[i].narrow(axis, 1, 11))
    heads[2] = ins[2].clone()
    heads[2][1:12] = new[2][1:12]                        # A
    b = ssd_chunk_bwd(*heads)
    assert torch.equal(a[0][:, :, 0], b[0][:, :, 0])
    assert torch.equal(a[1][:, :, 0], b[1][:, :, 0])
    assert torch.equal(a[2][0], b[2][0])
    assert not torch.equal(a[0][:, :, 1], b[0][:, :, 1])
    rows = list(ins)
    for i in (0, 1, 3, 4, 6, 7):
        rows[i] = ins[i].clone()
        rows[i][1:] = new[i][1:]
    c = ssd_chunk_bwd(*rows)
    for i in (0, 1, 3, 4):
        assert torch.equal(a[i][0], c[i][0])
        assert not torch.equal(a[i][1], c[i][1])


@pytest.mark.parametrize("memory", ["short", "long"])
@pytest.mark.parametrize("S", [1, 100, 4100, 32768])
def test_rglru_scan_bwd_one_pass_at_any_length(cuda, S, memory):
    """The one-pass backward (chunks handed on by ticket) from one step to
    the reference's 32k prefill: against the plain reverse loop (1e-4 of the
    largest |want| plus 1e-4 of each), repeating bit for bit, and batch row
    0's gradient unmoved by the other rows."""
    from repro_torch.kernels.rglru_scan import rglru_scan_backward_ref, rglru_scan_bwd
    rng = np.random.default_rng(S)
    shape = (3, S, 96)
    ins = _scan_bwd_inputs(rng, shape, memory, cuda)
    got = rglru_scan_bwd(*ins)
    for g, w in zip(got, rglru_scan_backward_ref(*ins)):
        assert _within(g, w)
    assert all(torch.equal(x, y) for x, y in zip(got, rglru_scan_bwd(*ins)))
    other = [t.clone() for t in ins]
    for t, new in zip(other, _scan_bwd_inputs(rng, (2, S, 96), memory, cuda)):
        t[1:] = new
    assert all(torch.equal(x[0], y[0]) for x, y in zip(got, rglru_scan_bwd(*other)))


def test_rglru_scan_long_memory_error_is_the_chunk_association(cuda):
    """The forward kernel forms 1 - a² from a rounded square, as the plain
    version: on long memory (a^8 in [0.9, 0.999]) at 2 x 4096 x 2560 what
    remains is the chunked carry's association, under a tenth of the limit
    (the fused square read 0.232; tests/test_torch_rglru_error.py splits
    it)."""
    rng = np.random.default_rng(21)
    shape = (2, 4096, 2560)
    x_in = _randn(rng, shape, torch.float32, cuda)
    log_a = _scan_log_a(rng, shape, "long", cuda)
    want = rglru_scan_ref(x_in, log_a)
    err = ((rglru_scan(x_in, log_a) - want).abs() / (1e-4 + 1e-4 * want.abs())).max()
    assert err.item() < 0.1


def test_scan_functions_take_only_the_kernels_on_the_card(cuda, monkeypatch):
    """RGLRUScan and ssd_scan (through SSDIntraChunk) under autograd on CUDA
    tensors reach the backward kernels, with the plain backward versions
    made to raise: no fallback. The raw forward wrappers still refuse a
    tensor that needs a gradient."""
    from repro_torch.kernels.rglru_scan import RGLRUScan, rglru_scan_bwd
    from repro_torch.kernels.rglru_scan import ops as rops
    from repro_torch.kernels.ssd_scan import ssd_chunk_bwd
    from repro_torch.kernels.ssd_scan import ops as sops

    def refuse(*args, **kwargs):
        raise AssertionError("the plain backward ran on the card")

    monkeypatch.setattr(rops, "rglru_scan_backward_ref", refuse)
    monkeypatch.setattr(sops, "ssd_intra_chunk_backward_ref", refuse)
    rng = np.random.default_rng(17)
    x_in, log_a, _, dh = _scan_bwd_inputs(rng, (2, 300, 64), "long", cuda)
    x_in.requires_grad_()
    log_a.requires_grad_()
    before = rglru_scan_bwd.launches
    grads = torch.autograd.grad(RGLRUScan.apply(x_in, log_a), (x_in, log_a), dh)
    assert rglru_scan_bwd.launches == before + 1
    assert all(torch.isfinite(g).all() for g in grads)
    with pytest.raises(RuntimeError, match="RGLRUScan"):
        rglru_scan(x_in, log_a)
    x, dt, A, B, C, L, dy, _ = _ssd_bwd_inputs(
        rng, (2, 256, 8, 64, 2, 128, 128), torch.bfloat16, cuda)
    leaves = [t.requires_grad_() for t in (x, dt, A, B, C)]
    before = ssd_chunk_bwd.launches, ssd_scan.launches
    grads = torch.autograd.grad(ssd_scan(*leaves, chunk=128), leaves, dy.bfloat16())
    assert ssd_chunk_bwd.launches == before[0] + 1
    assert ssd_scan.launches == before[1] + 1
    assert [g.dtype for g in grads] == [t.dtype for t in leaves]
    assert all(torch.isfinite(g).all() for g in grads)
    with pytest.raises(RuntimeError, match="SSDIntraChunk"):
        ssd_intra_chunk(*leaves, 128)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-2.7b"])
def test_recurrent_train_lflr_equals_clean_on_the_card(cuda, arch):
    """The smoke recurrent stacks trained on the card: the scans' backward
    kernels launched once per recurrent layer a step; nan_grad at 3 (skip)
    and 8 (restore), bit-equal on every leaf to a clean run over the kept
    batches; one host sync a step."""
    from repro_torch.configs import smoke_config
    from repro_torch.core import (ExecutorConfig, FaultSchedule, FaultSpec,
                                  ResilientExecutor)
    from repro_torch.core.detect import ProbeConfig
    from repro_torch.core.device_channel import readback
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.steps import make_reset_opt_fn
    from repro_torch.launch.train import build_train_setup
    from repro_torch.tree import tree_leaves

    cfg = smoke_config(arch)
    _, step_fn, state0, pipe, _ = build_train_setup(
        cfg, batch_size=2, seq_len=16, device=cuda,
        probe_cfg=ProbeConfig(loss_divergence_threshold=1e3))
    ex = ResilientExecutor(step_fn, config=ExecutorConfig(good_state_interval=5),
                           reset_opt_fn=make_reset_opt_fn(cfg))
    before = readback.count
    reset_launch_counts()
    state, log = ex.run(state0, pipe, 12, faults=FaultSchedule(
        [FaultSpec(step=3, kind="nan_grad"), FaultSpec(step=8, kind="nan_grad")]))
    counts = launch_counts()
    assert readback.count == before + 12
    assert [(e.step, e.action) for e in log.faults()] == [(3, "skip_batch"),
                                                           (8, "restore_good")]
    kind, bwd = ("rglru", "rglru_scan_bwd") if arch.startswith("recurrent") else (
        "ssd", "ssd_chunk_bwd")
    assert counts[bwd] == 12 * cfg.pattern_layers.count(kind)
    clean = state0
    for i in (0, 1, 2, 4, 5, 9, 10, 11):
        clean, _, word = step_fn(clean, make_batch(pipe.cfg, i, cuda), 0)
        assert int(word) == 0
    assert all(a.device.type == "cuda" and torch.equal(a, b)
               for a, b in zip(tree_leaves(state), tree_leaves(clean)))


@pytest.mark.parametrize("arch,layers", [("recurrentgemma-2b", 3), ("mamba2-2.7b", 1)])
def test_train_levers_on_the_card(cuda, arch, layers):
    """The train step's levers at the train shape (B 4 x S 256) on a
    full-width stack of one period (recurrentgemma: 2 RG-LRU layers, 1
    sliding) or one SSD layer: ``microbatch=4, ce_chunk=64`` against the
    plain step from one state and batch — the loss and each gradient
    within 1% of the leaf's largest plus 2 bf16 ulps (the plain gradients
    are bf16, the levers' fp32 sums of four bf16 slices), word 0; each
    forward and backward kernel launched 4 times the plain step's, the
    probe once."""
    from repro_torch.configs import get_config
    from repro_torch.core.detect import ProbeConfig
    from repro_torch.data.pipeline import PipelineConfig, make_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.steps import (accumulate_grads, make_loss_and_grads,
                                          make_train_step)
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.weights import train_params

    cfg = get_config(arch).replace(num_layers=layers)
    params = train_params(Model(cfg, device=cuda, seed=0))
    batch = make_batch(PipelineConfig(vocab_size=cfg.vocab_size, seq_len=256,
                                      batch_size=4), 0, cuda)
    loss, grads, _ = make_loss_and_grads(cfg)(params, batch)
    lev_loss, lev, _ = accumulate_grads(make_loss_and_grads(cfg, 64), params, batch, 4)

    def excess(got, want):
        want = want.float()
        limit = 1e-2 * want.abs().max() + 2.0 ** -6 * want.abs()
        return ((got.float() - want).abs() / limit).max().item()

    assert excess(lev_loss, loss) <= 1
    assert max(excess(lev[n], grads[n]) for n in grads) <= 1
    state = {"params": params, "opt": init_opt_state(params),
             "step": torch.zeros((), dtype=torch.int32, device=cuda),
             "lr_scale": torch.ones((), device=cuda)}
    counts = {}
    for k, kw in ((1, {}), (4, {"microbatch": 4, "ce_chunk": 64})):
        step = make_train_step(cfg, AdamWConfig(),
                               ProbeConfig(loss_divergence_threshold=1e5), **kw)
        reset_launch_counts()
        _, _, word = step(state, batch, 0)
        counts[k] = launch_counts()
        assert int(word) == 0
    for name in ("flash_forward", "rglru_scan", "rglru_scan_bwd", "ssd_scan",
                 "ssd_chunk_bwd"):
        assert counts[4][name] == 4 * counts[1][name]
    assert counts[1]["rglru_scan_bwd"] + counts[1]["ssd_chunk_bwd"] == (
        cfg.pattern_layers.count("rglru") + cfg.pattern_layers.count("ssd"))
    assert counts[1]["probe_tree"] == counts[4]["probe_tree"] == 1


def test_train_setup_grows_segments_on_the_card(cuda):
    """On the card, ``build_train_setup`` has the caching allocator grow its
    segments in place (``grow_segments``), as ``expandable_segments`` does:
    a tensor allocated after it lies in an expandable segment."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.train import build_train_setup, grow_segments

    try:
        build_train_setup(smoke_config("qwen3-1.7b"), batch_size=2, seq_len=16,
                          device=cuda)
        x = torch.empty((64 << 20,), dtype=torch.uint8, device=cuda)
        seg = [s for s in torch.cuda.memory_snapshot()
               if s["address"] <= x.data_ptr() < s["address"] + s["total_size"]]
        assert len(seg) == 1 and seg[0]["is_expandable"]
    finally:
        grow_segments(False)
