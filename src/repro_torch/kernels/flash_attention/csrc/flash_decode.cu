// Flash-attention decode and verify for Hopper (sm_90a) on the tensor cores,
// bf16: `nq` query rows per slot (decode: 1; the speculative verify: the
// draft length + 1), row t of slot b at position q_offset[b] + t, the slot's
// KV range split across the blocks of a thread-block cluster. Plain C
// interface.
//
// Replaces, for S == 1 in bf16 and for the verify's S == nq rows over a
// cache, the TPU kernel repro/kernels/flash_attention/kernel.py:81
// flash_attention_fwd (pallas_call at :103, body _flash_kernel at :26):
// online-softmax attention with fp32 (acc, m, l) state, causal and sliding
// masks from positions, a kpos < seq_kv padding mask, GQA (query head h
// reads KV head h / group), masked scores set to NEG_INF = -1e30, masked
// tiles skipped, output acc / max(l, 1e-30) in bf16. Serving decode gives
// each slot its own runtime position: q_offset is an int32 DEVICE array (B,).
//
// Layout is the JAX package's public one: q (B, nq, Hq, D), k/v (B, T, Hkv,
// D), out (B, nq, Hq, D), contiguous bf16.
//
// What bounds it on the H100: one query row per slot does 4 * Hq * ctx * D
// flops over 2 * ctx * Hkv * D * 2 bytes of K/V, group flop/byte (2 for
// qwen3, 10 for recurrentgemma's MQA): memory-bound, so the aim is to stream
// each slot's K/V once with enough blocks in flight, and to spend little
// time per tile. The arithmetic is small but not free: on the CUDA cores
// (fp32, q and P read from shared memory, a barrier between scores, softmax
// and P V) it took most of the kernel's time, so it runs on the tensor
// cores, where each warp does its share of a tile with no barrier between
// the phases. The verify's nq rows share each K/V read, so it stays
// memory-bound at nq * group flop/byte (8 for qwen3 at nq 4).
//
// Design:
// - Grid (splits, Hkv * row tiles, B). A block serves ALL group = Hq / Hkv
//   query heads of its KV head for its slot's nq rows, group * nq rows in
//   m16 tiles (row r of the tile is slot row (16 m + r) / group, head (16 m +
//   r) % group; rows past group * nq zero), so each K/V byte is read from
//   device memory once per slot and row tile. The slot's keys [0, seq_kv)
//   are cut into `splits` ranges of keys_per_split (a multiple of the 64-key
//   tile), so slots x KV heads x splits fills the SMs where slots x KV heads
//   alone would not (MQA: 8 slots, one KV head).
// - K/V tiles of 64 keys are double-buffered in dynamic shared memory by
//   cp.async (16 bytes a lane, coalesced), rows padded by 16 bytes so ldmatrix
//   hits 8 bank groups (a padded row is an odd number of 16-byte groups at
//   every D: 176 B, 11 groups, at hubert's D 80). Each of the 4 warps takes 16 keys of a tile: S = Q K^T
//   and O += P V on mma.sync.m16n8k16 (bf16 in, fp32 accumulation), its own
//   online softmax in fp32 registers, P split into bf16 high and low parts
//   (as in flash_forward.cu, for the same tolerance).
// - After its tiles a block merges its 4 warps; then the splits of one
//   (slot, KV head) — one cluster of at most 8 blocks, the portable size —
//   merge through distributed shared memory: every block reads each split's
//   (m, l) once, forms the weights, and writes a share of the outputs from
//   the splits' partials. One launch, no scratch in device memory.
//
// Determinism (the LFLR contract): split boundaries depend only on the launch
// shape (seq_kv and the KV heads, chosen by ops.py::plan), never on the
// other slots' positions nor on nq; a split that lies past the slot's causal
// end (or before its window) runs no tile and leaves m = -inf, which the
// merge weighs 0. Every sum runs in a fixed order (warps, then splits, in
// index order) and nothing is atomic, so a slot's output depends only on its
// own data, its own position and the launch shape: a slot recomputed by LFLR
// in the same window shape reproduces its clean-run values bit for bit.
//
// The verify contract: row t's output is bit-equal to a decode (nq = 1) at
// position q_offset + t. Each row keeps its own causal mask inside the tiles
// (keys <= its position), and a block's key interval runs to the end of its
// last row, so row t also visits tiles that a decode at its position never
// runs. There, every score of row t is masked: where the row already holds a
// key, its max is unchanged, the correction is exp2(0) = 1 and P is exactly
// 0, so (m, l, O) keep their bits; where a warp or a whole split holds no key
// of row t, its max is NEG_INF against the row's real max, so the merge
// weighs it exp2(NEG_INF - max) = 0, as a decode weighs a warp whose keys are
// all past the position. Windows are not taken with nq > 1 (a row whose
// window holds no key would not read 0 as the decode does). The decode
// (kVerify false) is its own instantiation, with the row arithmetic folded
// away: it keeps its registers and its time.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../common/mma_helpers.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;         // 4 warps, 16 keys of a tile each
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;             // one m16 tile: the group's query heads
constexpr int kBN = 64;               // keys per tile
constexpr int kMaxSplits = 8;         // blocks per cluster (the portable limit)
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

template <int D>
struct Cfg {
  static constexpr int kRow = D + 8;               // padded row, bf16 elements
  static constexpr int kCPR = D / 8;               // 16-byte chunks per row
  static constexpr int kDT = D / 8;                // n-tiles of O
  static constexpr int kTileElems = kBN * kRow;    // one of K, V in one stage
  // shared memory: q; the merge's small arrays (warps' and splits' m and l,
  // this split's m, l and the merged denominator); one region holding the
  // two K/V stages during the tiles and the warps' partials after them
  static constexpr int kSmall = 2 * kWarps * kRows + 2 * kMaxSplits * kRows + 3 * kRows;
  static constexpr size_t kRegion = cmax(4 * static_cast<size_t>(kTileElems) * 2,
                                         (kWarps + 1) * kRows * D * sizeof(float));
  static constexpr size_t kSmem = kRows * kRow * 2 + kSmall * sizeof(float) + kRegion;
  static_assert(D % 16 == 0 && kDT % 2 == 0 && kSmall % 4 == 0, "tiles");
};

template <int D, bool kVerify>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ q_offset,
                    bf16* __restrict__ out, long long T_, int Hq, int Hkv, int group,
                    int causal, int window, long long seq_kv, long long keys_per_split,
                    int nq, int row_tiles, float scale_log2) {
  using C = Cfg<D>;
  constexpr int kRow = C::kRow, kCPR = C::kCPR, kDT = C::kDT;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);                   // [kRows][kRow]
  float* mw = reinterpret_cast<float*>(qs + kRows * kRow);    // [kWarps][kRows] m, weight
  float* lw = mw + kWarps * kRows;                            // [kWarps][kRows] l
  float* sw = lw + kWarps * kRows;                            // [kMaxSplits][kRows] m, weight
  float* sl = sw + kMaxSplits * kRows;                        // [kMaxSplits][kRows] l
  float* ms = sl + kMaxSplits * kRows;                        // [kRows] this split's m
  float* ls = ms + kRows;                                     // [kRows] this split's l
  float* den = ls + kRows;                                    // [kRows] merged l
  bf16* kvs = reinterpret_cast<bf16*>(mw + C::kSmall);        // [stage][K, V][kBN][kRow]
  float* ow = mw + C::kSmall;                                 // [kWarps][kRows][D], after
  float* red = ow + kWarps * kRows * D;                       // [kRows][D] this split's O

  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, b = blockIdx.z;
  const int kvh = kVerify ? blockIdx.y / row_tiles : blockIdx.y;
  const int tile0 = kVerify ? (blockIdx.y % row_tiles) * kRows : 0;   // first row
  const int rows = kVerify ? min(kRows, group * nq - tile0) : group;  // in use
  const int nsplit = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long q0 = q_offset[b];
  // row r of the tile: slot row (tile0 + r) / group at q0 + that row, head
  // kvh * group + (tile0 + r) % group; a row past `rows` reads as the last
  auto slot_row = [&](int r) { return kVerify ? (tile0 + min(r, rows - 1)) / group : 0; };
  auto row_offset = [&](int r) {      // element offset of row r in q and out
    const int rr = tile0 + r;
    return ((static_cast<long long>(b) * nq + (kVerify ? rr / group : 0)) * Hq +
            kvh * group + (kVerify ? rr % group : rr)) * D;
  };

  // the block's rows' valid keys lie in one interval [kv_begin, kv_end), to
  // the end of its last row; this split's share of it is [lo, hi)
  long long kv_end = seq_kv;
  if (causal) kv_end = min(kv_end, q0 + slot_row(rows - 1) + 1);
  const long long kv_begin = window ? max(0LL, q0 - window + 1) : 0LL;
  const long long lo = max(kv_begin, split * keys_per_split);
  const long long hi = min(kv_end, (split + 1) * keys_per_split);
  const long long t_first = lo / kBN;
  const long long t_last = lo < hi ? (hi - 1) / kBN : t_first - 1;

  const long long key_stride = static_cast<long long>(Hkv) * D;
  const bf16* kbase = k + (static_cast<long long>(b) * T_ * Hkv + kvh) * D;
  const bf16* vbase = v + (static_cast<long long>(b) * T_ * Hkv + kvh) * D;

  // q of the tile's rows (rows past `rows` zero), with the first tile
  for (int c = tid; c < kRows * kCPR; c += kThreads) {
    const int r = c / kCPR, cc = c % kCPR;
    cp_async16(qs + r * kRow + cc * 8, q + (r < rows ? row_offset(r) + cc * 8 : 0), r < rows);
  }
  auto load_tile = [&](long long t, int st) {
    bf16* ks = kvs + st * 2 * C::kTileElems;
    bf16* vs = ks + C::kTileElems;
    for (int c = tid; c < kBN * kCPR; c += kThreads) {
      const int j = c / kCPR, cc = c % kCPR;
      const long long key = t * kBN + j;
      const bool ok = key < T_;
      const long long o = ok ? key * key_stride + cc * 8 : 0;
      cp_async16(ks + j * kRow + cc * 8, kbase + o, ok);
      cp_async16(vs + j * kRow + cc * 8, vbase + o, ok);
    }
  };
  if (t_first <= t_last) load_tile(t_first, 0);
  cp_async_commit();

  // this thread's rows g and g + 8, keys 2 tq, 2 tq + 1 of each n-tile; each
  // row's keys end after its own position
  const int g = lane >> 2, tq = lane & 3;
  long long row_end[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    row_end[i] = causal ? min(seq_kv, q0 + slot_row(g + 8 * i) + 1) : seq_kv;
  float o[kDT][4];
#pragma unroll
  for (int d = 0; d < kDT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const bf16* qw = qs + (lane & 15) * kRow + (lane >> 4) * 8;
  for (long long t = t_first; t <= t_last; ++t) {
    const int st = static_cast<int>((t - t_first) & 1);
    if (t < t_last) {
      load_tile(t + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = kvs + st * 2 * C::kTileElems + 16 * warp * kRow;   // the warp's keys
    const bf16* vs = ks + C::kTileElems;

    // S = Q K^T over the warp's 16 keys: two n-tiles, even and odd k-steps
    // in separate accumulators (shorter chains), added at the end
    float sa[2][4] = {}, sb[2][4] = {};
    const bf16* kl = ks + ((lane >> 4) * 8 + (lane & 7)) * kRow + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned a[4], bk[4];
      ldmatrix_x4(a, qw + kk * 16);
      ldmatrix_x4(bk, kl + kk * 16);
      float (&s)[2][4] = (kk & 1) ? sb : sa;
      mma(s[0], a, bk[0], bk[1]);
      mma(s[1], a, bk[2], bk[3]);
    }
    // elements 0, 1 hold row g, elements 2, 3 row g + 8
    const long long k0 = t * kBN + 16 * warp;
    float sc[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long key = k0 + n * 8 + 2 * tq + (e & 1);
        const bool valid = key >= kv_begin && key < row_end[e >> 1];
        sc[n][e] = valid ? (sa[n][e] + sb[n][e]) * scale_log2 : kNegInf;
      }

    // online softmax in fp32 (log2 domain); a row's 4 lanes share its max
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = fmaxf(fmaxf(sc[0][2 * i], sc[0][2 * i + 1]),
                       fmaxf(sc[1][2 * i], sc[1][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float corr = exp2f(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        sc[n][2 * i] = exp2f(sc[n][2 * i] - m_new);
        sc[n][2 * i + 1] = exp2f(sc[n][2 * i + 1] - m_new);
        sum += sc[n][2 * i] + sc[n][2 * i + 1];
      }
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int d = 0; d < kDT; ++d) {
        o[d][2 * i] *= corr;
        o[d][2 * i + 1] *= corr;
      }
    }

    // O += P V over the warp's 16 keys, P as bf16 hi + lo
    unsigned hi[4], lo[4];
    hi[0] = pack_hi_lo(sc[0][0], sc[0][1], lo[0]);
    hi[1] = pack_hi_lo(sc[0][2], sc[0][3], lo[1]);
    hi[2] = pack_hi_lo(sc[1][0], sc[1][1], lo[2]);
    hi[3] = pack_hi_lo(sc[1][2], sc[1][3], lo[3]);
    const bf16* vl = vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * kRow + (lane >> 4) * 8;
#pragma unroll
    for (int d2 = 0; d2 < kDT / 2; ++d2) {
      unsigned bv[4];
      ldmatrix_x4_trans(bv, vl + d2 * 16);
      mma(o[2 * d2], hi, bv[0], bv[1]);
      mma(o[2 * d2], lo, bv[0], bv[1]);
      mma(o[2 * d2 + 1], hi, bv[2], bv[3]);
      mma(o[2 * d2 + 1], lo, bv[2], bv[3]);
    }
    __syncthreads();   // the stage is refilled two tiles on
  }
  cp_async_wait<0>();
  __syncthreads();     // the region now takes the warps' partials

  // the warps' partials: (m, l) per row (l summed over the row's 4 lanes), O
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = g + 8 * i;
    if (tq == 0) {
      mw[warp * kRows + r] = m[i];
      lw[warp * kRows + r] = l[i];
    }
    float* orow = ow + (warp * kRows + r) * D + 2 * tq;
#pragma unroll
    for (int d = 0; d < kDT; ++d) {
      orow[d * 8] = o[d][2 * i];
      orow[d * 8 + 1] = o[d][2 * i + 1];
    }
  }
  __syncthreads();
  // this split: its warps' weights, its (m, l), O summed over warps in order
  if (tid < kRows) {
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, mw[w * kRows + tid]);
    float lsum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float m_w = mw[w * kRows + tid];
      const float wgt = m_w == -INFINITY ? 0.f : exp2f(m_w - mx);   // a warp with no tile
      mw[w * kRows + tid] = wgt;
      lsum += wgt * lw[w * kRows + tid];
    }
    ms[tid] = mx;
    ls[tid] = lsum;
  }
  __syncthreads();
  for (int e = tid; e < rows * D; e += kThreads) {
    const int r = e / D, d = e % D;
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += mw[w * kRows + r] * ow[(w * kRows + r) * D + d];
    red[e] = s;
  }
  cluster.sync();

  // merge the cluster's splits in split order: each split's (m, l) read once,
  // the weights exp2(m_s - M) formed once, then a share of the outputs
  for (int e = tid; e < nsplit * kRows; e += kThreads) {
    const int sp = e / kRows, r = e % kRows;
    sw[e] = cluster.map_shared_rank(ms, sp)[r];
    sl[e] = cluster.map_shared_rank(ls, sp)[r];
  }
  __syncthreads();
  if (tid < rows) {
    float mx = -INFINITY;
    for (int sp = 0; sp < nsplit; ++sp) mx = fmaxf(mx, sw[sp * kRows + tid]);
    float lsum = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) {
      const float m_s = sw[sp * kRows + tid];
      // a split that ran no tile weighs 0, as does every split of a row
      // with no valid key (which then reads 0)
      const float wgt = m_s == -INFINITY ? 0.f : exp2f(m_s - mx);
      sw[sp * kRows + tid] = wgt;
      lsum += wgt * sl[sp * kRows + tid];
    }
    den[tid] = fmaxf(lsum, 1e-30f);
  }
  __syncthreads();
  for (int e = split * kThreads + tid; e < rows * D; e += nsplit * kThreads) {
    const int r = e / D, d = e % D;
    float part[kMaxSplits];
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)
      part[sp] = sp < nsplit ? cluster.map_shared_rank(red, sp)[e] : 0.f;
    float acc = 0.f;
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)
      if (sp < nsplit) acc += sw[sp * kRows + r] * part[sp];
    out[row_offset(r) + d] = __float2bfloat16(acc / den[r]);
  }
  cluster.sync();   // no block leaves while another reads its shared memory
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int* q_offset, void* out,
           long long B, long long T_, int Hq, int Hkv, int causal, int window,
           long long seq_kv, int splits, long long keys_per_split, int nq,
           cudaStream_t stream) {
  using C = Cfg<D>;
  auto kernel = nq > 1 ? flash_decode_kernel<D, true> : flash_decode_kernel<D, false>;
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(flash_decode_kernel<D, false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::kSmem));
    cudaFuncSetAttribute(flash_decode_kernel<D, true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::kSmem));
    configured = true;
  }
  const int row_tiles = (Hq / Hkv * nq + kRows - 1) / kRows;
  if (splits < 1 || splits > kMaxSplits || keys_per_split % kBN ||
      keys_per_split * splits < seq_kv || B > 65535 || nq < 1 || (nq > 1 && window) ||
      static_cast<long long>(Hkv) * row_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, Hkv * row_tiles, static_cast<unsigned>(B));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(D));
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), q_offset, static_cast<bf16*>(out), T_, Hq, Hkv,
      Hq / Hkv, causal, window, seq_kv, keys_per_split, nq, row_tiles, scale_log2);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// bf16 only. The Python wrapper has checked shapes (nq query rows per slot:
// 1 for decode, the verify's rows otherwise), types, devices, contiguity
// and 16-byte alignment, 1 <= Hq / Hkv <= 16 and D in {16, 32, 64, 80, 128,
// 256}; `splits` and `keys_per_split` come from ops.py::plan (a multiple of
// the 64-key tile, covering seq_kv), the same for every nq.
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  const void* q_offset, void* out, long long B, long long T,
                                  int Hq, int Hkv, int D, int causal, int window,
                                  long long seq_kv, int splits, long long keys_per_split,
                                  int nq, void* stream) {
  const int* qo = static_cast<const int*>(q_offset);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hkv < 1 || Hq % Hkv || Hq / Hkv > kRows) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 16: return launch<16>(q, k, v, qo, out, B, T, Hq, Hkv, causal, window, seq_kv, splits, keys_per_split, nq, st);
    case 32: return launch<32>(q, k, v, qo, out, B, T, Hq, Hkv, causal, window, seq_kv, splits, keys_per_split, nq, st);
    case 64: return launch<64>(q, k, v, qo, out, B, T, Hq, Hkv, causal, window, seq_kv, splits, keys_per_split, nq, st);
    case 80: return launch<80>(q, k, v, qo, out, B, T, Hq, Hkv, causal, window, seq_kv, splits, keys_per_split, nq, st);
    case 128: return launch<128>(q, k, v, qo, out, B, T, Hq, Hkv, causal, window, seq_kv, splits, keys_per_split, nq, st);
    case 256: return launch<256>(q, k, v, qo, out, B, T, Hq, Hkv, causal, window, seq_kv, splits, keys_per_split, nq, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
