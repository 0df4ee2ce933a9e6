// Mamba-2 SSD intra-chunk kernel for Hopper (sm_90a) on the tensor cores:
// x, B, C in bf16. Plain C interface.
//
// Replaces, for bf16 inputs, the TPU kernel repro/kernels/ssd_scan/kernel.py:47
// ssd_intra_chunk (pallas_call at :53, body _ssd_chunk_kernel at :27)
// together with the prologue of its wrapper repro/kernels/ssd_scan/ops.py
// ssd_scan (:25-30); fp32 inputs take ssd_f32.cu. For one (batch, chunk,
// head), with the chunk's L steps j = 0..L-1, x (L, P) bf16, dt (L,) fp32,
// A fp32 and the head's group's B, C (L, N) bf16:
//   cum_i = sum_{j<=i} dt_j A,  S = C B^T  (L, L),
//   y_diag_i = sum_{j<=i} S_ij exp(cum_i - cum_j) dt_j x_j          (L, P)
//   state    = sum_j exp(cum_{L-1} - cum_j) dt_j x_j (x) B_j        (P, N)
// both written in fp32 in the layouts ops.py::ssd_inter_chunk reads (y (b,
// S, H, P), states (b, S / L, H, P, N)).
//
// What bounds it on the H100: bytes. x, B and C are read once in bf16 and
// dt in fp32, y and the states are written in fp32: about 0.43 GB at
// mamba2-2.7b's prefill shape (b 2, S 4096, H 80, P 64, G 1, N 128, L 128),
// 0.127 ms at 3.35 TB/s. The least work the function needs (C B^T once per
// group, the causal half of each L x L product: 16.3 GFLOP) takes 0.016 ms
// at the bf16 tensor-core peak.
//
// Design:
// - One block of 8 warps per (tile of kHeads = 8 heads of one group, chunk,
//   batch): 640 blocks at the prefill shape. S = C B^T depends on the group
//   only, so a block computes it once for its 8 heads, and only its causal
//   16 x 8 tiles (72 of 128).
// - B, C (L x N) and each head's x (L x P) are staged in shared memory by
//   cp.async, 16 bytes a lane (element loads where a row is not a whole
//   number of 16-byte chunks), zero-padded to 128 x 128 and 128 x 64; the
//   next head's x is in flight while this head is computed. Rows are padded
//   by 16 bytes so ldmatrix hits 8 different bank groups.
// - Warp w owns one of the chunk's eight 16-row tiles (w for w < 4, else
//   11 - w: the two warps of SM sub-partition w % 4 hold tiles w % 4 and
//   7 - w % 4, 9 column steps of 16 between them on every sub-partition)
//   and all P columns. It computes the causal 8-column tiles of its rows of
//   S (2 tile + 2 of them) on mma.sync.m16n8k16 into registers (up to 64
//   fp32) and keeps them for all the block's heads: S never goes to shared
//   memory, and no tile of S or of M' is computed twice.
// - Per head, M'_ij = S_ij exp(cum_i - cum_j) dt_j is formed in registers
//   in the A-operand layout (two 16 x 8 accumulator tiles are one 16 x 16
//   A fragment). On a diagonal tile exp is taken where i >= j only: above
//   the diagonal the segment sum is positive and exp may overflow, and inf
//   times a zero mask would be NaN on a clean run. Below it (j's 16-step
//   tile ends at r = j | 15 < i) the decay factors through r:
//   exp(cum_i - cum_r) per row and dt_j exp(cum_r - cum_j) per column, both
//   arguments of the sign of the whole, so neither part overflows where the
//   whole does not: 2 exps a thread a k-step instead of 8. y_diag = M' x
//   runs over the causal k-steps only, x (bf16, exact) through
//   ldmatrix.trans; an accumulator's hi and lo MMAs are issued apart.
// - The state = (x dt w)^T B with w_j = exp(cum_{L-1} - cum_j): warp w takes
//   P rows 16 (w % 4).., N columns 64 (w / 4).. (balanced, unlike y); the scaled x is read
//   transposed by ldmatrix.trans, widened, scaled in fp32, and B (bf16,
//   exact) goes through ldmatrix.trans.
// - Precision: M' and the scaled x are fp32. Each enters the MMA as a bf16
//   high part plus a bf16 low part (pack_hi_lo), two MMAs per product:
//   bf16 alone keeps 8 bits and misses the stated tolerance (1e-4 of each
//   element plus 1e-4 of the largest) by 10-14x, hi + lo keeps 16 bits and
//   stays near 0.03x of it (emulated on the CPU in tests/test_torch_ssd.py).
// - cum: one thread per head (8 in parallel), in step order with each
//   product rounded first, as a sequential cumsum of dt A rounds it; the
//   128 dependent adds run while B and C are in flight, so a parallel scan,
//   which would round otherwise, is not needed.
// - Offsets are 64-bit: b * S * H * P may pass 2^31.
//
// Determinism: every sum runs in a fixed order (k-steps in order, hi before
// lo), with no atomics and nothing split across blocks. Every block of a
// group computes S the same way, so a (batch, chunk, head)'s outputs depend
// only on its own inputs and the launch shape, not on the other heads of its
// tile: an LFLR replay is bit-exact.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "../../common/mma_helpers.cuh"

namespace {

constexpr int kL = 128;          // largest chunk: eight 16-row tiles
constexpr int kP = 64;           // largest head dim
constexpr int kN = 128;          // largest state dim
constexpr int kHeads = 8;        // heads of one group per block
constexpr int kThreads = 256;    // 8 warps
static_assert(kThreads == 32 * kHeads, "cum: one warp per head of the tile");
constexpr int kLdB = kN + 8;     // padded row of B and C, bf16 elements
constexpr int kLdX = kP + 8;     // padded row of x

struct Smem {
  bf16 b[kL * kLdB];
  bf16 c[kL * kLdB];
  bf16 x[2][kL * kLdX];          // this head's x and the next one's
  float dt[kHeads][kL];          // 0 past L and past the tile's last head
  float cum[kHeads][kL];
  float wdt[kHeads][kL];         // dt_j exp(cum_{L-1} - cum_j), 0 past L
  float cdt[kHeads][kL];         // dt_j exp(cum_{j|15} - cum_j), 0 past L:
                                 // the column factor off the diagonal
};

// rows x cols of src (row stride `stride` elements) into dst (row stride
// Ld), zeros up to R x Cap: cp.async where a row is whole 16-byte chunks
template <int R, int Cap, int Ld>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, long long stride, int rows,
                                      int cols, bool vec, int tid) {
  if (vec) {
    constexpr int kChunks = Cap / 8;
    for (int e = tid; e < R * kChunks; e += kThreads) {
      const int r = e / kChunks, ch = e % kChunks;
      const bool ok = r < rows && ch * 8 < cols;
      cp_async16(dst + r * Ld + ch * 8, ok ? src + r * stride + ch * 8 : src, ok);
    }
  } else {
    for (int e = tid; e < R * Cap; e += kThreads) {
      const int r = e / Cap, k = e % Cap;
      dst[r * Ld + k] = (r < rows && k < cols) ? src[r * stride + k] : __float2bfloat16(0.f);
    }
  }
}

// acc[n] += hi b[n] for every n, then acc[n] += lo b[n]: an accumulator's
// two products are kT MMAs apart instead of back to back (the order of each
// accumulator's sums stays hi, then lo)
template <int kT>
__device__ __forceinline__ void mma_hi_lo(float (&acc)[kT][4], const unsigned (&hi)[4],
                                          const unsigned (&lo)[4], const unsigned (&b)[kT][2]) {
#pragma unroll
  for (int n = 0; n < kT; ++n) mma(acc[n], hi, b[n][0], b[n][1]);
#pragma unroll
  for (int n = 0; n < kT; ++n) mma(acc[n], lo, b[n][0], b[n][1]);
}

// columns col, col + 1 of a row of n fp32 values
__device__ __forceinline__ void store2(float* row, int col, int n, float v0, float v1) {
  if (!(n & 1) && col + 1 < n) {
    *reinterpret_cast<float2*>(row + col) = make_float2(v0, v1);
  } else {
    if (col < n) row[col] = v0;
    if (col + 1 < n) row[col + 1] = v1;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const bf16* __restrict__ Bm,
                    const bf16* __restrict__ Cm, float* __restrict__ y,
                    float* __restrict__ states, long long S, int H, int P, int G, int N,
                    int L, int tiles_per_group) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = blockIdx.x / tiles_per_group, hpg = H / G;
  const int h0 = g * hpg + (blockIdx.x % tiles_per_group) * kHeads;
  const int nh = min(kHeads, (g + 1) * hpg - h0);
  const long long c = blockIdx.y, b = blockIdx.z, nc = S / L;
  const long long t0 = b * S + c * L;               // the chunk's first step

  // ---- B and C, then the first head's x: two cp.async groups
  const long long bc = (t0 * G + g) * N, bc_stride = static_cast<long long>(G) * N;
  stage<kL, kN, kLdB>(sm.b, Bm + bc, bc_stride, L, N, N % 8 == 0, tid);
  stage<kL, kN, kLdB>(sm.c, Cm + bc, bc_stride, L, N, N % 8 == 0, tid);
  cp_async_commit();
  auto stage_x = [&](int k) {
    stage<kL, kP, kLdX>(sm.x[k & 1], x + (t0 * H + h0 + k) * P,
                        static_cast<long long>(H) * P, L, P, P % 8 == 0, tid);
  };
  stage_x(0);
  cp_async_commit();

  // ---- dt, cum and the state's weights of the tile's heads
  for (int e = tid; e < kHeads * kL; e += kThreads) {
    const int j = e / kHeads, hh = e % kHeads;
    sm.dt[hh][j] = (j < L && hh < nh) ? dt[(t0 + j) * H + h0 + hh] : 0.f;
  }
  __syncthreads();
  if (lane == 0) {                   // head `warp`, in step order; 0 past nh
    const float a = warp < nh ? A[h0 + warp] : 0.f;
    float s = 0.f;
    for (int j = 0; j < kL; ++j) {
      s += __fmul_rn(sm.dt[warp][j], a);
      sm.cum[warp][j] = s;
    }
  }
  __syncthreads();
  for (int e = tid; e < kHeads * kL; e += kThreads) {
    const int hh = e / kL, j = e % kL;
    sm.wdt[hh][j] = j < L ? sm.dt[hh][j] * expf(sm.cum[hh][L - 1] - sm.cum[hh][j]) : 0.f;
    sm.cdt[hh][j] = j < L ? sm.dt[hh][j] * expf(sm.cum[hh][j | 15] - sm.cum[hh][j]) : 0.f;
  }
  cp_async_wait<1>();                // B and C
  __syncthreads();

  // ---- S = C B^T over the causal tiles of the warp's row tile. SMSP w % 4
  //      runs warps w % 4 and w % 4 + 4: row tiles w % 4 and 7 - w % 4,
  //      9 column steps of 16 between them, on every SMSP
  const int tile = warp < 4 ? warp : 11 - warp;
  const int g4 = lane >> 2, q4 = lane & 3;
  float s[16][4];                    // column tiles 0 .. 2 tile + 1
#pragma unroll
  for (int u = 0; u < 16; ++u) s[u][0] = s[u][1] = s[u][2] = s[u][3] = 0.f;
  {
    const bf16* ca = sm.c + (tile * 16 + (lane & 15)) * kLdB + (lane >> 4) * 8;
    const bf16* bl = sm.b + ((lane >> 4) * 8 + (lane & 7)) * kLdB + ((lane >> 3) & 1) * 8;
    const int nk = (N + 15) / 16;
    for (int kk = 0; kk < nk; ++kk) {
      unsigned fa[4];
      ldmatrix_x4(fa, ca + kk * 16);
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        if (v > tile) break;
        unsigned bk[4];
        ldmatrix_x4(bk, bl + v * 16 * kLdB + kk * 16);
        mma(s[2 * v], fa, bk[0], bk[1]);
        mma(s[2 * v + 1], fa, bk[2], bk[3]);
      }
    }
  }

  // per-lane ldmatrix offsets: x as y's B operand (.trans), x^T as the
  // state's A operand (.trans), B as the state's B operand (.trans)
  const int xl_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * kLdX + (lane >> 4) * 8;
  const int xa_off = ((lane & 7) + (lane >> 4) * 8) * kLdX + ((lane >> 3) & 1) * 8;
  const bf16* bt = sm.b + ((lane & 7) + ((lane >> 3) & 1) * 8) * kLdB + (lane >> 4) * 8;
  const int mt = warp & 3, nhalf = warp >> 2;       // the state's tiles

  for (int k = 0; k < nh; ++k) {
    if (k + 1 < nh) {
      stage_x(k + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int h = h0 + k;
    const bf16* xs = sm.x[k & 1];
    const float* cum = sm.cum[k];
    const float* dtk = sm.dt[k];
    const float* cdtk = sm.cdt[k];

    // ---- y_diag = M' x: the rows of the warp's tile, every P column
    {
      const float ci[2] = {cum[tile * 16 + g4], cum[tile * 16 + g4 + 8]};
      float ya[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) ya[n][0] = ya[n][1] = ya[n][2] = ya[n][3] = 0.f;
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        if (v > tile) break;
        const int i0 = tile * 16 + g4, j0 = v * 16 + 2 * q4;
        // columns j0, j0 + 1 (tile 2v) and j0 + 8, j0 + 9 (tile 2v + 1)
        float m[2][4];
        if (v == tile) {
          const float2 cj0 = *reinterpret_cast<const float2*>(cum + j0);
          const float2 cj1 = *reinterpret_cast<const float2*>(cum + j0 + 8);
          const float2 dj0 = *reinterpret_cast<const float2*>(dtk + j0);
          const float2 dj1 = *reinterpret_cast<const float2*>(dtk + j0 + 8);
          const float cj[4] = {cj0.x, cj0.y, cj1.x, cj1.y};
          const float dj[4] = {dj0.x, dj0.y, dj1.x, dj1.y};
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1, cc = 2 * t + (e & 1);
              const int i = i0 + 8 * r, j = j0 + 8 * t + (e & 1);
              m[t][e] = i >= j ? s[2 * v + t][e] * expf(ci[r] - cj[cc]) * dj[cc] : 0.f;
            }
        } else {
          const float ck = cum[v * 16 + 15];
          const float rf[2] = {expf(ci[0] - ck), expf(ci[1] - ck)};
          const float2 c0 = *reinterpret_cast<const float2*>(cdtk + j0);
          const float2 c1 = *reinterpret_cast<const float2*>(cdtk + j0 + 8);
          const float cf[4] = {c0.x, c0.y, c1.x, c1.y};
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              m[t][e] = s[2 * v + t][e] * rf[e >> 1] * cf[2 * t + (e & 1)];
        }
        unsigned hi[4], lo[4];
        hi[0] = pack_hi_lo(m[0][0], m[0][1], lo[0]);
        hi[1] = pack_hi_lo(m[0][2], m[0][3], lo[1]);
        hi[2] = pack_hi_lo(m[1][0], m[1][1], lo[2]);
        hi[3] = pack_hi_lo(m[1][2], m[1][3], lo[3]);
        unsigned bv[8][2];
#pragma unroll
        for (int d2 = 0; d2 < 4; ++d2) {
          unsigned r[4];
          ldmatrix_x4_trans(r, xs + xl_off + v * 16 * kLdX + d2 * 16);
          bv[2 * d2][0] = r[0], bv[2 * d2][1] = r[1];
          bv[2 * d2 + 1][0] = r[2], bv[2 * d2 + 1][1] = r[3];
        }
        mma_hi_lo(ya, hi, lo, bv);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = tile * 16 + g4 + 8 * r;
        if (i >= L) continue;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          store2(y + ((t0 + i) * H + h) * P, n * 8 + 2 * q4, P, ya[n][2 * r], ya[n][2 * r + 1]);
      }
    }

    // ---- state = (x dt w)^T B: P rows 16 mt .., N columns 64 nhalf ..
    if (mt * 16 < P) {
      const float* wdt = sm.wdt[k];
      float st[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
      const int nl = (L + 15) / 16;
      for (int kk = 0; kk < nl; ++kk) {
        unsigned xr[4];
        ldmatrix_x4_trans(xr, xs + xa_off + kk * 16 * kLdX + mt * 16);
        const int j0 = kk * 16 + 2 * q4;
        const float2 w0 = *reinterpret_cast<const float2*>(wdt + j0);
        const float2 w1 = *reinterpret_cast<const float2*>(wdt + j0 + 8);
        unsigned hi[4], lo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr[r]));
          const float2 w = r < 2 ? w0 : w1;
          hi[r] = pack_hi_lo(xv.x * w.x, xv.y * w.y, lo[r]);
        }
        unsigned bb[8][2];
#pragma unroll
        for (int n2 = 0; n2 < 4; ++n2) {
          unsigned r[4];
          ldmatrix_x4_trans(r, bt + kk * 16 * kLdB + (nhalf * 4 + n2) * 16);
          bb[2 * n2][0] = r[0], bb[2 * n2][1] = r[1];
          bb[2 * n2 + 1][0] = r[2], bb[2 * n2 + 1][1] = r[3];
        }
        mma_hi_lo(st, hi, lo, bb);
      }
      float* sb = states + ((b * nc + c) * H + h) * static_cast<long long>(P) * N;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = mt * 16 + g4 + 8 * r;
        if (p >= P) continue;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          store2(sb + static_cast<long long>(p) * N, nhalf * 64 + n * 8 + 2 * q4, N,
                 st[n][2 * r], st[n][2 * r + 1]);
      }
    }
    __syncthreads();                 // x[k & 1] is refilled for head k + 2
  }
}

}  // namespace

// x (b, S, H, P) and B, C (b, S, G, N) bf16, 16-byte aligned; dt (b, S, H)
// and A (H,) fp32; outputs y (b, S, H, P) and states (b, S / L, H, P, N)
// fp32. All contiguous on one device; the Python wrapper has checked shapes,
// types, devices and alignment, L <= 128, P <= 64, N <= 128, S % L == 0 and
// H % G == 0.
extern "C" int repro_ssd_chunk_tc(const void* x, const void* dt, const void* A, const void* Bm,
                                  const void* Cm, void* y, void* states, long long b,
                                  long long S, int H, int P, int G, int N, int L,
                                  void* stream) {
  if (b < 1 || b > 65535 || L < 1 || L > kL || S % L || S / L > 65535 || P < 1 || P > kP ||
      N < 1 || N > kN || G < 1 || H < G || H % G)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(Smem)));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int tiles = (H / G + kHeads - 1) / kHeads;
  const dim3 grid(static_cast<unsigned>(G * tiles), static_cast<unsigned>(S / L),
                  static_cast<unsigned>(b));
  ssd_chunk_tc_kernel<<<grid, kThreads, sizeof(Smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), static_cast<float*>(y), static_cast<float*>(states), S,
      H, P, G, N, L, tiles);
  return static_cast<int>(cudaGetLastError());
}
