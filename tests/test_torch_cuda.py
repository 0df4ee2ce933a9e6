"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` (Hopper, sm_90a) and skips
without one; run them on the card with
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.errors import ErrorCode
from repro_torch.kernels import flash_attention, probe_rows, rglru_scan, ssd_scan
from repro_torch.kernels.fault_probe import probe_rows_ref
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
# gemma3's full cache and ring
DECODE_SHAPES = [(1024, 16, 8, 128), (2048, 10, 1, 256), (1024, 4, 1, 256),
                 (512, 4, 1, 256)]


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
                                  "mamba2-2.7b"])
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
                 (8, 3, 2048, 10, 1, 256), (3, 6, 100, 4, 2, 16)]


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
