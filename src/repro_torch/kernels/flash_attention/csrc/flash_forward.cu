// Flash-attention forward for Hopper (sm_90a) on the tensor cores, bf16.
// Plain C interface.
//
// Replaces, for S > 1 in bf16, the TPU kernel
// repro/kernels/flash_attention/kernel.py:81 flash_attention_fwd (pallas_call
// at :103, body _flash_kernel at :26): online-softmax attention with fp32
// (acc, m, l) state, causal and sliding masks from positions, a kpos < seq_kv
// padding mask, GQA (query head h reads KV head h / group), masked scores set
// to NEG_INF = -1e30, fully masked KV tiles skipped (kernel.py:44-53), output
// acc / max(l, 1e-30) in bf16. q_offset is an int32 DEVICE array (B,): row s
// of batch b sits at position q_offset[b] + s.
//
// Layout is the JAX package's public one: q (B, S, Hq, D), k/v (B, T, Hkv, D),
// out (B, S, Hq, D), contiguous bf16.
//
// What bounds it on the H100: a forward over S rows and ctx keys does
// 4 * Hq * D * S * ctx flops over (2 S Hq + 2 T Hkv) D bytes — hundreds of
// flops per byte at the prefill shapes, so it is bound by operations. fp32 on
// the CUDA cores (67 TFLOP/s) cannot even reach one PyTorch call at the
// sliding prefill shape; only the tensor cores can (989 TFLOP/s dense bf16
// through wgmma, a third to two thirds of that through mma.sync).
//
// Design:
// - Grid (row tiles, Hkv, B). A block's kBM = 64 rows are (position, query
//   head) pairs of ONE KV head, row r = s * group + head: the group's query
//   heads are packed into the block's rows, so MQA's K/V tile (group 10) is
//   read once for all 10 heads. Four warps, 16 rows each.
// - Q (bf16) stays in shared memory; K/V tiles of kBN keys (64, or 32 at
//   D 256) are double-buffered in dynamic shared memory through cp.async
//   (16 bytes a lane, coalesced), the next tile in flight while this one is
//   computed. Rows are padded by 16 bytes so ldmatrix hits 8 different bank
//   groups (a padded row is an odd number of 16-byte groups at every D: 176
//   B, 11 groups, at hubert's D 80).
// - S = Q K^T and O += P V run on mma.sync.m16n8k16 (bf16 in, fp32
//   accumulation), operands from ldmatrix (V through .trans). The online
//   softmax stays in fp32 registers (exp2 with log2(e) folded into the
//   scale). P is split into a bf16 high part and a bf16 low part, two MMAs
//   per product: bf16 P alone (8 bits) misses the stated bf16 tolerances on
//   outputs averaged over 2048 keys, hi + lo keeps 16 bits.
// - The block's KV range ends at the last key a causal row of the block can
//   reach and starts at the first a sliding window can reach: tiles outside it
//   are never loaded (the TPU kernel's fully-masked-block skip). Tiles wholly
//   inside every row's valid range skip the per-element mask.
// - Offsets are 64-bit: B * S * Hq * D may pass 2^31.
//
// Determinism: each output row is summed by one warp in key order, no split
// across blocks, no atomics: a row depends only on its own data and position
// and the launch shape.
//
// The training forward also writes each row's log-sum-exp in fp32, lse (B, S,
// Hq) = m + log(max(l, 1e-30)) in natural units (the JAX package's
// _flash_fwd_impl, models/attention.py:180), which the recompute backward
// reads. It is a template flag (kLse), so the instantiations without it — the
// prefill's — are compiled as they were; the outputs of the two are the same
// bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../common/mma_helpers.cuh"

namespace {

constexpr int kThreads = 128;   // 4 warps x 16 rows
constexpr int kBM = 64;         // query rows per block
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int kBN = D >= 256 ? 32 : 64;   // keys per tile
  static constexpr int kRow = D + 8;               // padded row, bf16 elements
  static constexpr int kCPR = D / 8;               // 16-byte chunks per row
  static constexpr int kNT = kBN / 8;              // n-tiles of S
  static constexpr int kDT = D / 8;                // n-tiles of O
  static constexpr int kTileElems = kBN * kRow;    // one of K, V in one stage
  static constexpr size_t kSmem = (static_cast<size_t>(kBM) * kRow + 4 * kTileElems) * 2;
  static_assert(D % 16 == 0 && kDT % 2 == 0 && kNT % 2 == 0, "tiles");
};

template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads, 2)
flash_forward_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ q_offset,
                     bf16* __restrict__ out, float* __restrict__ lse, long long S, long long T_, int Hq, int Hkv,
                     int group, int causal, int window, long long seq_kv,
                     float scale_log2) {
  using C = Cfg<D>;
  constexpr int kBN = C::kBN, kRow = C::kRow, kCPR = C::kCPR;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);          // [kBM][kRow]
  bf16* kvs = qs + kBM * kRow;                       // [stage][K, V][kBN][kRow]

  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long rows = S * group;                  // rows of this (b, kvh)
  const long long r0 = static_cast<long long>(blockIdx.x) * kBM;
  const long long off = q_offset[b];
  const long long s_lo = r0 / group;
  const long long s_hi = min(S - 1, (r0 + kBM - 1) / group);

  // KV range any row of the block can reach (block-uniform)
  long long kv_end = seq_kv;                          // exclusive
  if (causal) kv_end = min(kv_end, off + s_hi + 1);
  const long long kv_begin = window ? max(0LL, off + s_lo - window + 1) : 0LL;
  const long long t_first = kv_begin / kBN;
  const long long t_last = kv_begin < kv_end ? (kv_end - 1) / kBN : t_first - 1;

  const long long key_stride = static_cast<long long>(Hkv) * D;
  const bf16* kbase = k + (static_cast<long long>(b) * T_ * Hkv + kvh) * D;
  const bf16* vbase = v + (static_cast<long long>(b) * T_ * Hkv + kvh) * D;

  // Q rows of the block (zero past the last row), in the first group
  for (int c = tid; c < kBM * kCPR; c += kThreads) {
    const int r = c / kCPR, cc = c % kCPR;
    const long long gr = r0 + r;
    const bool ok = gr < rows;
    const long long s = ok ? gr / group : 0, h = ok ? kvh * group + gr % group : 0;
    cp_async16(qs + r * kRow + cc * 8,
               q + ((static_cast<long long>(b) * S + s) * Hq + h) * D + cc * 8, ok);
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

  // this thread's two rows: g and g + 8 of the warp's 16
  const int g = lane >> 2, tq = lane & 3;
  long long qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qpos[i] = off + (r0 + warp * 16 + g + 8 * i) / group;

  float o[C::kDT][4];
#pragma unroll
  for (int d = 0; d < C::kDT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const bf16* qw = qs + (warp * 16 + (lane & 15)) * kRow + (lane >> 4) * 8;
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
    const bf16* ks = kvs + st * 2 * C::kTileElems;
    const bf16* vs = ks + C::kTileElems;

    // S = Q K^T for the warp's 16 rows and the tile's kBN keys
    float sc[C::kNT][4];
#pragma unroll
    for (int n = 0; n < C::kNT; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    const bf16* kl = ks + ((lane >> 4) * 8 + (lane & 7)) * kRow + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned a[4];
      ldmatrix_x4(a, qw + kk * 16);
#pragma unroll
      for (int n2 = 0; n2 < C::kNT / 2; ++n2) {
        unsigned bk[4];
        ldmatrix_x4(bk, kl + n2 * 16 * kRow + kk * 16);
        mma(sc[2 * n2], a, bk[0], bk[1]);
        mma(sc[2 * n2 + 1], a, bk[2], bk[3]);
      }
    }

    // scale, mask (only where some row of the block can see a masked key)
    const long long k0 = t * kBN;
    const bool full = k0 + kBN <= seq_kv && (!causal || k0 + kBN - 1 <= off + s_lo) &&
                      (!window || k0 > off + s_hi - window);
#pragma unroll
    for (int n = 0; n < C::kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[n][e] * scale_log2;
        if (!full) {
          const long long key = k0 + n * 8 + 2 * tq + (e & 1);
          const long long qp = qpos[e >> 1];
          bool valid = key < seq_kv;
          if (causal) valid = valid && key <= qp;
          if (window) valid = valid && key > qp - window;
          if (!valid) x = kNegInf;
        }
        sc[n][e] = x;
      }

    // online softmax in fp32 (log2 domain); a row's 4 lanes share its max
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < C::kNT; ++n) mx = fmaxf(mx, fmaxf(sc[n][2 * i], sc[n][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float corr = exp2f(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < C::kNT; ++n) {
        sc[n][2 * i] = exp2f(sc[n][2 * i] - m_new);
        sc[n][2 * i + 1] = exp2f(sc[n][2 * i + 1] - m_new);
        sum += sc[n][2 * i] + sc[n][2 * i + 1];
      }
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int d = 0; d < C::kDT; ++d) {
        o[d][2 * i] *= corr;
        o[d][2 * i + 1] *= corr;
      }
    }

    // O += P V, P as bf16 hi + lo
    const bf16* vl = vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * kRow + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      unsigned hi[4], lo[4];
      hi[0] = pack_hi_lo(sc[2 * kk][0], sc[2 * kk][1], lo[0]);
      hi[1] = pack_hi_lo(sc[2 * kk][2], sc[2 * kk][3], lo[1]);
      hi[2] = pack_hi_lo(sc[2 * kk + 1][0], sc[2 * kk + 1][1], lo[2]);
      hi[3] = pack_hi_lo(sc[2 * kk + 1][2], sc[2 * kk + 1][3], lo[3]);
#pragma unroll
      for (int d2 = 0; d2 < C::kDT / 2; ++d2) {
        unsigned bv[4];
        ldmatrix_x4_trans(bv, vl + kk * 16 * kRow + d2 * 16);
        mma(o[2 * d2], hi, bv[0], bv[1]);
        mma(o[2 * d2], lo, bv[0], bv[1]);
        mma(o[2 * d2 + 1], hi, bv[2], bv[3]);
        mma(o[2 * d2 + 1], lo, bv[2], bv[3]);
      }
    }
    __syncthreads();   // the stage is refilled two tiles on
  }
  cp_async_wait<0>();

  // out = O / max(l, 1e-30), l summed over the row's 4 lanes
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const long long gr = r0 + warp * 16 + g + 8 * i;
    if (gr >= rows) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    const long long s = gr / group, h = kvh * group + gr % group;
    if (kLse && tq == 0)   // m is in log2 units: m ln 2 is the natural max
      lse[(static_cast<long long>(b) * S + s) * Hq + h] =
          m[i] * 0.6931471805599453f + logf(fmaxf(l[i], 1e-30f));
    bf16* orow = out + ((static_cast<long long>(b) * S + s) * Hq + h) * D + 2 * tq;
#pragma unroll
    for (int d = 0; d < C::kDT; ++d)
      *reinterpret_cast<__nv_bfloat162*>(orow + d * 8) =
          __floats2bfloat162_rn(o[d][2 * i] * inv, o[d][2 * i + 1] * inv);
  }
}

template <int D, bool kLse>
int launch(const void* q, const void* k, const void* v, const int* q_offset, void* out,
           float* lse, long long B, long long S, long long T_, int Hq, int Hkv, int causal,
           int window, long long seq_kv, cudaStream_t stream) {
  using C = Cfg<D>;
  auto kernel = flash_forward_kernel<D, kLse>;
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(C::kSmem));
    configured = true;
  }
  const int group = Hq / Hkv;
  const long long tiles = (S * group + kBM - 1) / kBM;
  if (tiles > 0x7fffffffLL || Hkv > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles), Hkv, static_cast<unsigned>(B));
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(D));
  kernel<<<grid, kThreads, C::kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      q_offset, static_cast<bf16*>(out), lse, S, T_, Hq, Hkv, group, causal, window, seq_kv,
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_lse(const void* q, const void* k, const void* v, const int* q_offset, void* out,
               float* lse, long long B, long long S, long long T_, int Hq, int Hkv, int causal,
               int window, long long seq_kv, cudaStream_t stream) {
  return lse ? launch<D, true>(q, k, v, q_offset, out, lse, B, S, T_, Hq, Hkv, causal, window,
                               seq_kv, stream)
             : launch<D, false>(q, k, v, q_offset, out, lse, B, S, T_, Hq, Hkv, causal, window,
                                seq_kv, stream);
}

}  // namespace

// bf16 only. The Python wrapper has checked shapes, types, devices,
// contiguity and 16-byte alignment, 1 <= Hq / Hkv <= 16 and D in
// {16, 32, 64, 80, 128, 256}. lse is null, or (B, S, Hq) fp32 for the training
// forward.
extern "C" int repro_flash_forward(const void* q, const void* k, const void* v,
                                   const void* q_offset, void* out, void* lse, long long B,
                                   long long S, long long T, int Hq, int Hkv, int D,
                                   int causal, int window, long long seq_kv, void* stream) {
  const int* qo = static_cast<const int*>(q_offset);
  float* ls = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hkv < 1 || Hq % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 16: return launch_lse<16>(q, k, v, qo, out, ls, B, S, T, Hq, Hkv, causal, window, seq_kv, st);
    case 32: return launch_lse<32>(q, k, v, qo, out, ls, B, S, T, Hq, Hkv, causal, window, seq_kv, st);
    case 64: return launch_lse<64>(q, k, v, qo, out, ls, B, S, T, Hq, Hkv, causal, window, seq_kv, st);
    case 80: return launch_lse<80>(q, k, v, qo, out, ls, B, S, T, Hq, Hkv, causal, window, seq_kv, st);
    case 128: return launch_lse<128>(q, k, v, qo, out, ls, B, S, T, Hq, Hkv, causal, window, seq_kv, st);
    case 256: return launch_lse<256>(q, k, v, qo, out, ls, B, S, T, Hq, Hkv, causal, window, seq_kv, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
