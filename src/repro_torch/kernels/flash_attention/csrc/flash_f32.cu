// Flash attention for Hopper (sm_90a) in fp32 on the CUDA cores, decode and
// forward. Plain C interface.
//
// Replaces, for fp32 inputs, the TPU kernel
// repro/kernels/flash_attention/kernel.py:81 flash_attention_fwd (pallas_call
// at :103, body _flash_kernel at :26): online-softmax attention with fp32
// (acc, m, l) state, causal and sliding masks from positions, a kpos < seq_kv
// padding mask, GQA (query head h reads KV head h / group), masked scores set
// to NEG_INF = -1e30, fully masked KV tiles skipped, output acc / max(l,
// 1e-30). bf16 runs on the tensor cores (flash_decode.cu for S == 1,
// flash_forward.cu for S > 1); fp32 stays off them, because TF32 would not
// hold fp32 results to 2e-5, and takes this kernel, the port's first flash
// kernel, by dtype. No main path runs it.
//
// Layout is the JAX package's public one: q (B, S, Hq, D), k/v (B, T, Hkv, D),
// out (B, S, Hq, D), all contiguous fp32. q_offset is an int32 DEVICE array
// (B,): row s of batch b sits at position q_offset[b] + s.
//
// Work split: one thread block per (query tile, KV head, batch row). The
// block serves all group = Hq / Hkv query heads of its KV head, so the KV
// head's keys are fetched by one block (the group's rows hit L1 for each
// other). A block has rows = group * bq query rows and up to 16 warps: warp
// w owns row w % rows and KV partition w / rows, and walks the 32-key tiles
// of its partition (tile t belongs to partition (t - first tile) % parts)
// with a private online softmax: lane j scores key j of the tile (its K row
// read as 16-byte vectors), the warp reduces max and sum with butterfly
// shuffles, and each lane accumulates D / 32 output features (at D 80 four,
// on 20 lanes) from V rows read coalesced. At the end the partitions of a
// row merge through shared memory in partition order. The KV range ends at the last tile a causal row
// of the block can reach (and starts at the first a sliding window can
// reach): the TPU kernel's fully-masked-block skip.
//
// Shared memory is static: qs and accs hold kMaxRows x D floats each, 32 KB
// together at D 256, under the 48 KB limit for static shared memory.
//
// The training forward also writes each row's log-sum-exp in fp32, lse (B, S,
// Hq) = m + log(max(l, 1e-30)) (the JAX package's _flash_fwd_impl), behind the
// template flag kLse: the instantiations without it are compiled as they were.
//
// Determinism: no split across blocks, no atomics. A row's tiles, their
// partition and the merge order depend only on the launch shape and the
// row's own position, never on the other rows' data.
//
// Bound on the H100: at prefill shapes 4 * Hq * D * S * ctx flops at 67
// TFLOP/s in fp32 on the CUDA cores (operations); in decode the K/V bytes.
// The kernel loads K rows per lane, re-reads K/V once per query tile and
// splits no slot's keys across blocks: it is the slow route.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTileKV = 32;    // keys per tile = one per lane
constexpr int kMaxRows = 16;   // query rows per block
constexpr int kMaxWarps = 16;  // rows * KV partitions per block
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

// N contiguous elements at src (aligned to their size in bytes) as floats.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* __restrict__ src, float (&dst)[N]) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src) + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kPer; ++i) dst[c * kPer + i] = to_f32(e[i]);
    }
  } else if constexpr (kBytes == 8) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(src));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = to_f32(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = to_f32(src[i]);
  }
}

// the fewest output features a lane holds such that they divide D and D /
// n lanes (at most 32) hold them all: D / 32 for a multiple of 32, 4 (20
// lanes) at D 80
__host__ __device__ constexpr int features_per_lane(int D) {
  int n = 1;
  while (D % n || D / n > 32) ++n;
  return n;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <typename T, int D, bool kLse>
__global__ void __launch_bounds__(32 * kMaxWarps)
flash_f32_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ q_offset, T* __restrict__ out,
                 float* __restrict__ lse, int S, int T_,
                 int Hq, int Hkv, int group, int bq, int parts, int causal, int window,
                 int seq_kv, float scale) {
  constexpr int kDPL = features_per_lane(D); // output features per lane
  constexpr int kLanesD = D / kDPL;           // lanes that hold features
  constexpr int kChunk = 16 / sizeof(T);      // K elements per 16-byte load
  static_assert(D % kChunk == 0, "head_dim must fill 16-byte loads");

  __shared__ __align__(16) float qs[kMaxRows][D];
  __shared__ float ms[kMaxWarps], ls[kMaxWarps];
  __shared__ float accs[kMaxWarps][D];

  const int qt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = group * bq;
  const int r = warp % rows, part = warp / rows;
  const int s = qt * bq + r / group;
  const int h = kvh * group + r % group;
  const bool live = s < S;
  const int off = q_offset[b];
  const int qpos = off + s;

  if (part == 0)
    for (int d = lane; d < D; d += 32)
      qs[r][d] = live ? to_f32(q[((static_cast<long long>(b) * S + s) * Hq + h) * D + d]) : 0.f;
  __syncthreads();

  // KV range any row of this block can reach (block-uniform)
  const int s_lo = qt * bq;
  const int s_hi = min(S, s_lo + bq) - 1;
  int kv_end = seq_kv;                          // exclusive
  if (causal) kv_end = min(kv_end, off + s_hi + 1);
  const int kv_begin = window ? max(0, off + s_lo - window + 1) : 0;
  const int t_first = kv_begin / kTileKV;
  const int t_last = kv_end > 0 ? (kv_end - 1) / kTileKV : -1;

  const long long key_stride = static_cast<long long>(Hkv) * D;
  const T* kbase = k + (static_cast<long long>(b) * T_ * Hkv + kvh) * D;
  const T* vbase = v + (static_cast<long long>(b) * T_ * Hkv + kvh) * D;

  float m = -INFINITY, l = 0.f;
  float acc[kDPL];
#pragma unroll
  for (int i = 0; i < kDPL; ++i) acc[i] = 0.f;

  for (int t = t_first + part; t <= t_last; t += parts) {
    const int k0 = t * kTileKV;
    const int kpos = k0 + lane;
    float dot = 0.f;
    if (kpos < T_) {
      const T* krow = kbase + kpos * key_stride;
#pragma unroll
      for (int c = 0; c < D / kChunk; ++c) {
        float kc[kChunk];
        load_vec<T, kChunk>(krow + c * kChunk, kc);
#pragma unroll
        for (int i = 0; i < kChunk; ++i) dot += qs[r][c * kChunk + i] * kc[i];
      }
    }
    bool valid = kpos < seq_kv;
    if (causal) valid = valid && kpos <= qpos;
    if (window) valid = valid && kpos > qpos - window;
    const float sc = valid ? dot * scale : kNegInf;
    const float m_new = fmaxf(m, warp_max(sc));
    const float p = expf(sc - m_new);
    const float corr = expf(m - m_new);
    l = l * corr + warp_sum(p);
#pragma unroll
    for (int i = 0; i < kDPL; ++i) acc[i] *= corr;
    const int nkeys = min(kTileKV, T_ - k0);   // keys of the tile that exist
#pragma unroll 8
    for (int j = 0; j < kTileKV; ++j) {
      const float pj = __shfl_sync(kFull, p, j);
      if (j < nkeys && lane < kLanesD) {
        float vv[kDPL];
        load_vec<T, kDPL>(vbase + (k0 + j) * key_stride + lane * kDPL, vv);
#pragma unroll
        for (int i = 0; i < kDPL; ++i) acc[i] += pj * vv[i];
      }
    }
    m = m_new;
  }

  // merge the row's partitions in partition order
  if (lane == 0) {
    ms[warp] = m;
    ls[warp] = l;
  }
  if (lane < kLanesD)
#pragma unroll
    for (int i = 0; i < kDPL; ++i) accs[warp][lane * kDPL + i] = acc[i];
  __syncthreads();
  if (part != 0 || !live || lane >= kLanesD) return;
  float mx = -INFINITY;
  for (int pp = 0; pp < parts; ++pp) mx = fmaxf(mx, ms[r + pp * rows]);
  float lsum = 0.f, res[kDPL];
#pragma unroll
  for (int i = 0; i < kDPL; ++i) res[i] = 0.f;
  for (int pp = 0; pp < parts; ++pp) {
    const int w = r + pp * rows;
    if (ms[w] == -INFINITY) continue;          // partition saw no tile
    const float wgt = expf(ms[w] - mx);
    lsum += ls[w] * wgt;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) res[i] += accs[w][lane * kDPL + i] * wgt;
  }
  const float denom = fmaxf(lsum, 1e-30f);
  if (kLse && lane == 0) lse[(static_cast<long long>(b) * S + s) * Hq + h] = mx + logf(denom);
  T* o = out + ((static_cast<long long>(b) * S + s) * Hq + h) * D + lane * kDPL;
#pragma unroll
  for (int i = 0; i < kDPL; ++i) o[i] = from_f32<T>(res[i] / denom);
}

template <typename T, int D, bool kLse>
int launch(const void* q, const void* k, const void* v, const int* q_offset, void* out,
           float* lse, int B, int S, int T_, int Hq, int Hkv, int causal, int window,
           int seq_kv, cudaStream_t stream) {
  const int group = Hq / Hkv;
  const int bq = max(1, min(S, kMaxRows / group));
  const int rows = group * bq;
  const int parts = max(1, kMaxWarps / rows);
  const dim3 grid((S + bq - 1) / bq, Hkv, B);
  const dim3 block(32 * rows * parts);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  flash_f32_kernel<T, D, kLse><<<grid, block, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      q_offset, static_cast<T*>(out), lse, S, T_, Hq, Hkv, group, bq, parts, causal, window,
      seq_kv, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_lse(const void* q, const void* k, const void* v, const int* q_offset, void* out,
               float* lse, int B, int S, int T_, int Hq, int Hkv, int causal, int window,
               int seq_kv, cudaStream_t st) {
  return lse ? launch<float, D, true>(q, k, v, q_offset, out, lse, B, S, T_, Hq, Hkv, causal,
                                      window, seq_kv, st)
             : launch<float, D, false>(q, k, v, q_offset, out, lse, B, S, T_, Hq, Hkv, causal,
                                       window, seq_kv, st);
}

int launch_d(const void* q, const void* k, const void* v, const int* q_offset, void* out,
             float* lse, int B, int S, int T_, int Hq, int Hkv, int D, int causal, int window,
             int seq_kv, cudaStream_t st) {
  switch (D) {
    case 16: return launch_lse<16>(q, k, v, q_offset, out, lse, B, S, T_, Hq, Hkv, causal, window, seq_kv, st);
    case 32: return launch_lse<32>(q, k, v, q_offset, out, lse, B, S, T_, Hq, Hkv, causal, window, seq_kv, st);
    case 64: return launch_lse<64>(q, k, v, q_offset, out, lse, B, S, T_, Hq, Hkv, causal, window, seq_kv, st);
    case 80: return launch_lse<80>(q, k, v, q_offset, out, lse, B, S, T_, Hq, Hkv, causal, window, seq_kv, st);
    case 128: return launch_lse<128>(q, k, v, q_offset, out, lse, B, S, T_, Hq, Hkv, causal, window, seq_kv, st);
    case 256: return launch_lse<256>(q, k, v, q_offset, out, lse, B, S, T_, Hq, Hkv, causal, window, seq_kv, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// fp32 only. The Python wrapper has checked shapes, types, devices,
// contiguity and 16-byte alignment, 1 <= Hq / Hkv <= 16 and D in
// {16, 32, 64, 80, 128, 256}. lse is null, or (B, S, Hq) fp32 for the training
// forward.
extern "C" int repro_flash_f32(const void* q, const void* k, const void* v,
                               const void* q_offset, void* out, void* lse, long long B,
                               long long S, long long T, int Hq, int Hkv, int D, int causal,
                               int window, long long seq_kv, void* stream) {
  if (B > 65535 || S > 0x7fffffffLL || T > 0x7fffffffLL || Hkv < 1 || Hq % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_d(q, k, v, static_cast<const int*>(q_offset), out, static_cast<float*>(lse),
                  static_cast<int>(B), static_cast<int>(S), static_cast<int>(T), Hq, Hkv, D,
                  causal, window, static_cast<int>(seq_kv), static_cast<cudaStream_t>(stream));
}
