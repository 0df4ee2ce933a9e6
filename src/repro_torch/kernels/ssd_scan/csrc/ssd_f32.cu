// Mamba-2 SSD intra-chunk kernel for Hopper (sm_90a) in fp32 on the CUDA
// cores, plain C interface: the route for fp32 x, B, C (bf16 inputs take
// the tensor-core kernel, ssd_chunk_tc.cu; TF32 would not hold fp32 results
// to the stated tolerance).
//
// Replaces, for fp32 inputs, the TPU kernel repro/kernels/ssd_scan/kernel.py:47
// ssd_intra_chunk (pallas_call at :53, body _ssd_chunk_kernel at :27)
// together with the prologue of its wrapper repro/kernels/ssd_scan/ops.py
// ssd_scan (:25-30). For one (batch, chunk, head), with the chunk's L steps
// j = 0..L-1, x (L, P), dt (L,), A and the head's group's B, C (L, N), all
// fp32:
//   xd_j = x_j dt_j,  cum_i = sum_{j<=i} dt_j A,
//   y_diag_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) xd_j      (L, P)
//   state    = sum_j exp(cum_{L-1} - cum_j) xd_j (x) B_j          (P, N)
// both written out in fp32. The inter-chunk recurrence and the off-diagonal
// term stay in torch (ops.py), as they stay in jnp beside the TPU kernel.
//
// The TPU wrapper materialises xd and repeats B and C to every head before
// the kernel. Here the block reads x, dt and A, and B, C once per GROUP
// (head h reads group h / (H / G)), and forms xd and the decays in shared
// memory.
//
// One block of 256 threads per (head, chunk, batch) -- heads fastest, so the
// 80 heads of one chunk run side by side and share B and C in L2. The block
// stages B, C (L x N), xd (L x P) and cum in fp32 shared memory: about 166
// KB with padded rows, past the 48 KB static limit, so the launcher opts in
// to dynamic shared memory. Then, with register tiles:
//   1. scores C B^T: each thread an 8 x 8 tile (rows ty + 16r, columns
//      tx + 16q), float4 loads along N; rows of B and C are padded by 4
//      floats so a quarter-warp's float4 loads hit distinct banks;
//   2. the decay is applied where i >= j only, and exp is taken only there:
//      above the diagonal the segment sum is positive and exp may overflow,
//      and inf times a zero mask would be NaN on a clean run. The masked
//      product M (L x L) overwrites C's buffer;
//   3. y_diag = M xd (each thread 8 rows x 4 columns) and the state
//      (each thread 4 rows of P x 8 columns of N) from B and the
//      decay-weighted xd.
// Every sum runs in a fixed order inside one thread, with no atomics and no
// split across blocks, so a row's result depends only on its own inputs and
// the launch shape: an LFLR replay is bit-exact.
//
// Bound on the H100: fp32 outside the tensor cores (TF32 stays off). The
// least work the function needs is C B^T once per group and the causal half
// (i >= j) of each L x L product, b nc (G N L (L + 1) + H (P L (L + 1) +
// 2 P L N)) operations: 16.3 GFLOP per launch at the prefill shape (b 2,
// nc 32, L 128, H 80, P 64, G 1, N 128), 0.243 ms at 67 TFLOP/s. This kernel
// computes C B^T per head and the full squares, as the TPU kernel does
// (42.9 GFLOP, 0.64 ms); the bf16 route does neither. fp32 runs on no main
// path (the fp32 forward check only).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kL = 128;          // largest chunk
constexpr int kP = 64;           // largest head dim
constexpr int kN = 128;          // largest state dim
constexpr int kLd = kN + 4;      // padded row of B, C and M (kL == kN)
constexpr int kThreads = 256;    // 16 x 16
static_assert(kL == kN, "M reuses C's buffer");

constexpr int kSmemFloats = 2 * kL * kLd + kL * kP + 3 * kL;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_f32_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm, float* __restrict__ y,
               float* __restrict__ states, long long S, int H, int P, int G, int N,
               int L) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Bs = smem;                    // [kL][kLd]
  float* Cs = Bs + kL * kLd;           // [kL][kLd], then M [kL][kLd]
  float* Xs = Cs + kL * kLd;           // [kL][kP]: xd = x dt
  float* dts = Xs + kL * kP;           // [kL]
  float* cum = dts + kL;               // [kL]
  float* wts = cum + kL;               // [kL]: exp(cum_{L-1} - cum_j)

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int h = blockIdx.x;
  const long long c = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const long long nc = S / L;
  const long long t0 = b * S + c * L;

  // ---- stage the chunk: dt first (x is scaled by it), zeros past L, P, N
  if (tid < kL) dts[tid] = tid < L ? dt[(t0 + tid) * H + h] : 0.f;
  for (int e = tid; e < kL * kN; e += kThreads) {
    const int j = e / kN, k = e % kN;
    float bv = 0.f, cv = 0.f;
    if (j < L && k < N) {
      const long long off = ((t0 + j) * G + g) * N + k;
      bv = Bm[off];
      cv = Cm[off];
    }
    Bs[j * kLd + k] = bv;
    Cs[j * kLd + k] = cv;
  }
  __syncthreads();
  for (int e = tid; e < kL * kP; e += kThreads) {
    const int j = e / kP, q = e % kP;
    Xs[e] = (j < L && q < P) ? x[((t0 + j) * H + h) * P + q] * dts[j] : 0.f;
  }
  if (tid == 0) {
    // sequential, as the reference's cumsum: a fixed order
    const float a = A[h];
    float s = 0.f;
    for (int j = 0; j < kL; ++j) {
      s += __fmul_rn(dts[j], a);
      cum[j] = s;
    }
  }
  __syncthreads();
  if (tid < kL) wts[tid] = tid < L ? expf(cum[L - 1] - cum[tid]) : 0.f;

  // ---- 1. scores C B^T, rows i = ty + 16 r, columns j = tx + 16 q
  const int nk = (N + 3) & ~3, nl = (L + 3) & ~3;
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
  for (int k = 0; k < nk; k += 4) {
    float4 cr[8], br[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      cr[r] = *reinterpret_cast<const float4*>(Cs + (ty + 16 * r) * kLd + k);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      br[q] = *reinterpret_cast<const float4*>(Bs + (tx + 16 * q) * kLd + k);
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r][q] = dot4(cr[r], br[q], acc[r][q]);
  }
  __syncthreads();                     // every read of C is done

  // ---- 2. M = scores * exp(cum_i - cum_j) where i >= j, else 0 (into C's buffer)
  float* Ms = Cs;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = ty + 16 * r;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = tx + 16 * q;
      Ms[i * kLd + j] = (i >= j && i < L) ? acc[r][q] * expf(cum[i] - cum[j]) : 0.f;
    }
  }
  __syncthreads();

  // ---- 3a. y_diag = M xd: rows i = ty + 16 r, columns tx * 4 .. + 3
  {
    float ya[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) ya[r][u] = 0.f;
    for (int j = 0; j < nl; j += 4) {
      float4 xv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        xv[u] = *reinterpret_cast<const float4*>(Xs + (j + u) * kP + tx * 4);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float4 m = *reinterpret_cast<const float4*>(Ms + (ty + 16 * r) * kLd + j);
        const float mv[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          ya[r][0] = fmaf(mv[u], xv[u].x, ya[r][0]);
          ya[r][1] = fmaf(mv[u], xv[u].y, ya[r][1]);
          ya[r][2] = fmaf(mv[u], xv[u].z, ya[r][2]);
          ya[r][3] = fmaf(mv[u], xv[u].w, ya[r][3]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty + 16 * r;
      if (i >= L) continue;
      float* yr = y + ((t0 + i) * H + h) * P;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (tx * 4 + u < P) yr[tx * 4 + u] = ya[r][u];
    }
  }

  // ---- 3b. state (P x N): rows p = ty * 4 + r, columns tx * 4 + u and 64 + tx * 4 + u
  {
    float sa[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < 8; ++u) sa[r][u] = 0.f;
    for (int j = 0; j < L; ++j) {
      const float w = wts[j];
      const float4 xv = *reinterpret_cast<const float4*>(Xs + j * kP + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + j * kLd + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(Bs + j * kLd + 64 + tx * 4);
      const float xw[4] = {xv.x * w, xv.y * w, xv.z * w, xv.w * w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int u = 0; u < 8; ++u) sa[r][u] = fmaf(bv[u], xw[r], sa[r][u]);
    }
    float* st = states + ((b * nc + c) * H + h) * static_cast<long long>(P) * N;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = ty * 4 + r;
      if (p >= P) continue;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int n = (u < 4 ? 0 : 64) + tx * 4 + (u & 3);
        if (n < N) st[static_cast<long long>(p) * N + n] = sa[r][u];
      }
    }
  }
}

}  // namespace

// x (b, S, H, P), B, C (b, S, G, N), dt (b, S, H) and A (H,) fp32; outputs
// y (b, S, H, P) and states (b, S / L, H, P, N) fp32. All contiguous on one
// device; the Python wrapper has checked shapes, types and devices, L <= 128,
// P <= 64, N <= 128, S % L == 0 and H % G == 0.
extern "C" int repro_ssd_f32(const void* x, const void* dt, const void* A, const void* Bm,
                             const void* Cm, void* y, void* states, long long b, long long S,
                             int H, int P, int G, int N, int L, void* stream) {
  if (b < 1 || b > 65535 || L < 1 || L > kL || S % L || S / L > 65535 || P < 1 ||
      P > kP || N < 1 || N > kN || G < 1 || H % G)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const dim3 grid(static_cast<unsigned>(H), static_cast<unsigned>(S / L),
                  static_cast<unsigned>(b));
  ssd_f32_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(y), static_cast<float*>(states), S,
      H, P, G, N, L);
  return static_cast<int>(cudaGetLastError());
}
