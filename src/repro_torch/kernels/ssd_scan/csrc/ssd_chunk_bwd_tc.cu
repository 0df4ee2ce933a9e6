// Backward of the Mamba-2 SSD intra-chunk function for Hopper (sm_90a) on the
// tensor cores: x, B, C in bf16. Plain C interface.
//
// The gradient of repro/models/ssm.py:89 ssd_chunked (what jax.grad
// differentiates in the JAX package's training step) through its
// intra-chunk part, the TPU kernel at repro/kernels/ssd_scan/kernel.py:53
// (pallas_call of ssd_intra_chunk, which has no backward of its own) and
// the prologue of its wrapper, for the dtype every train step uses; fp32
// x, B, C take ssd_chunk_bwd.cu (ops.py picks the route by dtype). Per
// (batch, chunk, head) over the chunk's L steps, with xd_j = dt_j x_j,
// cum_i = sum_{k<=i} dt_k A, w_j = exp(cum_{L-1} - cum_j),
// E_ij = [i>=j] exp(cum_i - cum_j), G = C B^T and M = G * E, the forward is
// y_diag = M xd, state = sum_j w_j xd_j (x) B_j. From their gradients dy
// (L, P) and dS (P, N), fp32, with D_ij = dt_j (dy_i . x_j) (= dy xd^T),
// Q = D * E and dG = Q * G (= dM * M):
//   dxd = M^T dy + w (B dS^T),           dx = dt dxd,
//   dC  = Q B,                           dB = Q^T C + w dt (x dS),
//   dcum_i = sum_j dG_ij - sum_k dG_ki - w_i wbar_i, plus sum_j w_j wbar_j
//            at L - 1, with wbar_j = dt_j x_j . (B dS^T)_j,
//   dabar = the reverse cumsum of dcum,  ddt = dabar A + x . dxd,
//   dA = sum_k dabar_k dt_k (this block's part).
// dB and dC come out per head (b, S, H, N), dA per (batch, chunk, head);
// ops.py sums them over the heads of a group and into A, in a fixed order.
//
// What bounds it on the H100: at mamba2-2.7b's train shape (b 4, S 256, H
// 80, P 64, G 1, N 128, L 128) bytes, 75.7 MB read and written (x, B, C
// bf16; dt, dy, dS in and the gradients out fp32), 0.0226 ms at 3.35 TB/s;
// the least work (C B^T once per group, the causal half of each L x L
// product, the state gradient's two L x P x N products: 6.76 GFLOP there)
// takes 0.0068 ms at the bf16 tensor-core peak. chip_smoke.py counts both.
//
// Design:
// - One launch. A block of 8 warps takes a tile of heads of one group
//   (1 to kMaxHeads, the launcher's choice: enough blocks to fill the
//   card's SMs), one chunk and one batch row. Warp w owns the chunk's
//   16-row tile `tile` (w for w < 4, else 11 - w: the two warps of an SM
//   sub-partition own tiles t and 7 - t, so every sub-partition has the
//   same work).
// - Products on mma.sync.m16n8k16 (kernels/common/mma_helpers.cuh). x, B
//   and C are exact in bf16 and enter as they are. Every fp32 operand (dy,
//   dS, Q, Q^T, M^T) enters as a bf16 high part plus a bf16 low part,
//   products with an exact operand as hi + lo; M^T dy, whose operands are
//   both fp32, as hi hi + hi lo + lo hi. dt is applied to a row or column
//   after a product, never inside one, so D and the state terms keep one
//   exact operand. bf16 alone misses the stated tolerance (1e-4 of the
//   largest |want| plus 1e-4 of each) by 12-22x on dx, ddt, dB, dC; this
//   split holds it near 0.05x (emulated on the CPU in
//   tests/test_torch_ssd_grad.py).
// - Two phases, each over the block's heads:
//   I  (rows: i in the warp's tile) G's causal tiles, computed once per
//      block into registers; per head D's causal tiles, Q, dC = Q B and
//      dG's row sums;
//   J  (columns: j in the warp's tile) G^T = B C^T over the tiles i >= j,
//      computed once per block straight from B and C in shared memory;
//      per head M^T dy + w (B dS^T) (dx, and x . dxd), D^T = x dy^T and Q^T,
//      dB = w dt (x dS) + Q^T C and dG's column sums.
//   Both sums reach a warp complete: a tile of rows holds every j <= i, a
//   tile of columns every i >= j. D is formed once in each orientation
//   (the rows of Q feed dC, its columns dB, and they live on different
//   warps: moving them across would take 64 KB of shared memory or a
//   cross-warp sum of 128 x 128 partials). No tile above the diagonal is
//   computed.
// - exp only where i >= j: above the diagonal the segment sum is positive
//   and exp may overflow, and inf times a zero mask would be NaN on a clean
//   run. Off the diagonal the decay factors through the 16-step tile's end
//   r (j <= r < i): exp(cum_i - cum_r) exp(cum_r - cum_j), each exponent
//   of the whole's sign.
// - Shared memory (206 KB: one block an SM): B, C and x as bf16 through
//   cp.async, x double-buffered (the next head's in flight); dy and dS
//   split into hi and lo by the staging threads, once per head and phase.
// - cum: one warp per head, one thread in step order with each product
//   rounded first, as the forward and a sequential cumsum. The per-head
//   tail (dcum, its reverse cumsum, ddt, dA) runs on warp k for head k
//   after the last head, through a fixed shuffle tree.
// - Determinism: every sum runs in a fixed order (k-steps in order, hi
//   before lo), with no atomics and nothing split across blocks, and a
//   head's arithmetic does not depend on its place in the tile: a (batch,
//   chunk, head)'s gradients depend only on its own inputs, whatever the
//   tile or the other batch rows. An LFLR replay is bit-exact.
// - Offsets are 64-bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "../../common/mma_helpers.cuh"

namespace {

constexpr int kL = 128;          // largest chunk: eight 16-row tiles
constexpr int kP = 64;           // largest head dim
constexpr int kN = 128;          // largest state dim
constexpr int kMaxHeads = 8;     // heads of one group per block, at most
constexpr int kThreads = 256;    // 8 warps
static_assert(kThreads == 32 * kMaxHeads, "cum and the tails: one warp per head");
constexpr int kLdB = kN + 8;     // padded bf16 row of B, C, dS
constexpr int kLdX = kP + 8;     // padded bf16 row of x, dy

struct Smem {
  bf16 b[kL * kLdB];
  bf16 c[kL * kLdB];
  bf16 x[2][kL * kLdX];          // this head's x and the next one's
  bf16 dyh[kL * kLdX];           // dy as hi + lo
  bf16 dyl[kL * kLdX];
  bf16 dsh[kP * kLdB];           // dS as hi + lo
  bf16 dsl[kP * kLdB];
  float dt[kMaxHeads][kL];       // 0 past L and past the tile's last head
  float cum[kMaxHeads][kL];
  float cf[kMaxHeads][kL];       // exp(cum_{j|15} - cum_j): the row factor
  float w[kMaxHeads][kL];        // exp(cum_{L-1} - cum_j), 0 past L
  float rowsum[kMaxHeads][kL];   // dG's row sums (phase I)
  float colsum[kMaxHeads][kL];   // dG's column sums (phase J)
  float xdot[kMaxHeads][kL];     // x_j . dxd_j
  float wbar[kMaxHeads][kL];     // dt_j x_j . (B dS^T)_j
};

// rows x cols bf16 of src (row stride `stride`) into dst (row stride Ld),
// zeros up to R x Cap: cp.async where a row is whole 16-byte chunks
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

// rows x cols fp32 of src (row stride `stride`) as bf16 hi + lo into hi,
// lo (row stride Ld), zeros up to R x Cap. vec: 16-byte loads (cols % 4 ==
// 0, src 16-byte aligned), all issued before the first is split
template <int R, int Cap, int Ld>
__device__ __forceinline__ void stage_split(bf16* hi, bf16* lo, const float* __restrict__ src,
                                            long long stride, int rows, int cols, bool vec,
                                            int tid) {
  if (vec) {
    constexpr int kQuads = Cap / 4, kIters = R * kQuads / kThreads;
    static_assert(R * kQuads % kThreads == 0, "whole iterations");
    float4 v[kIters];
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int e = tid + it * kThreads, r = e / kQuads, q = e % kQuads;
      v[it] = (r < rows && q * 4 < cols)
                  ? __ldg(reinterpret_cast<const float4*>(src + r * stride + q * 4))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int e = tid + it * kThreads, r = e / kQuads, q = e % kQuads;
      unsigned l0, l1;
      const unsigned h0 = pack_hi_lo(v[it].x, v[it].y, l0);
      const unsigned h1 = pack_hi_lo(v[it].z, v[it].w, l1);
      *reinterpret_cast<uint2*>(hi + r * Ld + q * 4) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(lo + r * Ld + q * 4) = make_uint2(l0, l1);
    }
  } else {
    for (int e = tid; e < R * Cap / 2; e += kThreads) {
      const int r = e / (Cap / 2), k = 2 * (e % (Cap / 2));
      const float v0 = (r < rows && k < cols) ? src[r * stride + k] : 0.f;
      const float v1 = (r < rows && k + 1 < cols) ? src[r * stride + k + 1] : 0.f;
      unsigned l;
      const unsigned h = pack_hi_lo(v0, v1, l);
      *reinterpret_cast<unsigned*>(hi + r * Ld + k) = h;
      *reinterpret_cast<unsigned*>(lo + r * Ld + k) = l;
    }
  }
}

// a 16 x 16 A fragment from two 16 x 8 accumulator tiles, as hi + lo
__device__ __forceinline__ void pack_a(const float (&m)[2][4], unsigned (&hi)[4],
                                       unsigned (&lo)[4]) {
  hi[0] = pack_hi_lo(m[0][0], m[0][1], lo[0]);
  hi[1] = pack_hi_lo(m[0][2], m[0][3], lo[1]);
  hi[2] = pack_hi_lo(m[1][0], m[1][1], lo[2]);
  hi[3] = pack_hi_lo(m[1][2], m[1][3], lo[3]);
}

// acc (16 rows, 16 column tiles of 8) += A (16 x 16, hi + lo) times the
// 16 x 128 bf16 rows of `rows` (row stride kLdB), through ldmatrix.trans;
// in two halves of 8 tiles (fewer live registers), each accumulator's
// order hi, then lo
__device__ __forceinline__ void mma_rows(float (&acc)[16][4], const unsigned (&hi)[4],
                                         const unsigned (&lo)[4], const bf16* rows, int lane) {
  const bf16* bt = rows + ((lane & 7) + ((lane >> 3) & 1) * 8) * kLdB + (lane >> 4) * 8;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    unsigned bb[8][2];
#pragma unroll
    for (int n2 = 0; n2 < 4; ++n2) {
      unsigned r[4];
      ldmatrix_x4_trans(r, bt + (half * 4 + n2) * 16);
      bb[2 * n2][0] = r[0], bb[2 * n2][1] = r[1];
      bb[2 * n2 + 1][0] = r[2], bb[2 * n2 + 1][1] = r[3];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) mma(acc[half * 8 + n], hi, bb[n][0], bb[n][1]);
#pragma unroll
    for (int n = 0; n < 8; ++n) mma(acc[half * 8 + n], lo, bb[n][0], bb[n][1]);
  }
}

// sum over the 4 lanes of a quad (the threads sharing an accumulator row)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
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

// the rows of a 16 x 128 accumulator block (rows r0 + g4, r0 + g4 + 8) to
// out's rows (row stride H N), n < N
__device__ __forceinline__ void store_rows(const float (&acc)[16][4], float* out, long long t0,
                                           int r0, int h, int H, int N, int L, int lane) {
  const int g4 = lane >> 2, q4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r0 + g4 + 8 * r;
    if (i >= L) continue;
    float* row = out + ((t0 + i) * H + h) * static_cast<long long>(N);
#pragma unroll
    for (int n = 0; n < 16; ++n) store2(row, n * 8 + 2 * q4, N, acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_bwd_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                        const float* __restrict__ A, const bf16* __restrict__ Bm,
                        const bf16* __restrict__ Cm, const float* __restrict__ dy,
                        const float* __restrict__ dS, float* __restrict__ dx,
                        float* __restrict__ ddt, float* __restrict__ dA,
                        float* __restrict__ dB, float* __restrict__ dC, long long S, int H,
                        int P, int G, int N, int L, int heads, int tiles_per_group,
                        bool vec_dy, bool vec_ds) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g4 = lane >> 2, q4 = lane & 3;
  const int g = blockIdx.x / tiles_per_group, hpg = H / G;
  const int h0 = g * hpg + (blockIdx.x % tiles_per_group) * heads;
  const int nh = min(heads, (g + 1) * hpg - h0);
  const long long c = blockIdx.y, b = blockIdx.z, nc = S / L;
  const long long t0 = b * S + c * L;               // the chunk's first step
  const long long hp = static_cast<long long>(H) * P;
  const int tile = warp < 4 ? warp : 11 - warp;     // the warp's 16-row tile
  const int nkn = (N + 15) / 16, nkp = (P + 15) / 16;

  // ---- B and C, then x of the first head (staging step 0 of 2 nh: phase
  //      I's heads, then phase J's)
  const long long bc = (t0 * G + g) * N, bc_stride = static_cast<long long>(G) * N;
  stage<kL, kN, kLdB>(sm.b, Bm + bc, bc_stride, L, N, N % 8 == 0, tid);
  stage<kL, kN, kLdB>(sm.c, Cm + bc, bc_stride, L, N, N % 8 == 0, tid);
  cp_async_commit();
  auto stage_x = [&](int s) {        // x of head s % nh into buffer s & 1
    stage<kL, kP, kLdX>(sm.x[s & 1], x + t0 * hp + static_cast<long long>(h0 + s % nh) * P,
                        hp, L, P, P % 8 == 0, tid);
    cp_async_commit();
  };
  stage_x(0);


  // ---- dt, cum, the row factors and the state's weights of the tile's heads
  for (int e = tid; e < kMaxHeads * kL; e += kThreads) {
    const int j = e / kMaxHeads, hh = e % kMaxHeads;
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
  for (int e = tid; e < kMaxHeads * kL; e += kThreads) {
    const int hh = e / kL, j = e % kL;
    const float* cu = sm.cum[hh];
    sm.cf[hh][j] = expf(cu[j | 15] - cu[j]);
    sm.w[hh][j] = j < L ? expf(cu[L - 1] - cu[j]) : 0.f;
  }
  cp_async_wait<1>();                // B and C
  __syncthreads();

  // per-lane ldmatrix offsets: an A fragment of 16 rows from a row-major
  // tile (a_*), and the B operand of two 8-column tiles from the rows of a
  // row-major tile (b_*: rows are the product's columns)
  const int a_b = (tile * 16 + (lane & 15)) * kLdB + (lane >> 4) * 8;
  const int a_x = (tile * 16 + (lane & 15)) * kLdX + (lane >> 4) * 8;
  const int b_b = ((lane >> 4) * 8 + (lane & 7)) * kLdB + ((lane >> 3) & 1) * 8;
  const int b_x = ((lane >> 4) * 8 + (lane & 7)) * kLdX + ((lane >> 3) & 1) * 8;
  const int t_x = ((lane & 7) + ((lane >> 3) & 1) * 8) * kLdX + (lane >> 4) * 8;
  const int t_b = ((lane & 7) + ((lane >> 3) & 1) * 8) * kLdB + (lane >> 4) * 8;
  const int i0 = tile * 16 + g4;     // the thread's rows: i0 and i0 + 8
  float s[16][4];                    // G (phase I) or G^T (phase J) tiles

  // waits for x of staging step `step` (the next one in flight) and for dy
  // and (phase J) dS of its head, staged hi + lo
  auto stage_head = [&](int step, bool with_ds) {
    const int k = step % nh;
    if (step + 1 < 2 * nh) {
      stage_x(step + 1);
    }
    const long long hoff = static_cast<long long>(h0 + k) * P;
    stage_split<kL, kP, kLdX>(sm.dyh, sm.dyl, dy + t0 * hp + hoff, hp, L, P, vec_dy, tid);
    if (with_ds)
      stage_split<kP, kN, kLdB>(sm.dsh, sm.dsl,
                                dS + ((b * nc + c) * H + h0 + k) * static_cast<long long>(P) * N,
                                N, P, N, vec_ds, tid);
    if (step + 1 < 2 * nh)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
  };

  // ======== phase I: rows i in the warp's tile. G = C B^T, causal tiles
#pragma unroll
  for (int u = 0; u < 16; ++u) s[u][0] = s[u][1] = s[u][2] = s[u][3] = 0.f;
  for (int kk = 0; kk < nkn; ++kk) {
    unsigned fa[4];
    ldmatrix_x4(fa, sm.c + a_b + kk * 16);
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      if (v > tile) break;
      unsigned bk[4];
      ldmatrix_x4(bk, sm.b + b_b + v * 16 * kLdB + kk * 16);
      mma(s[2 * v], fa, bk[0], bk[1]);
      mma(s[2 * v + 1], fa, bk[2], bk[3]);
    }
  }
  for (int k = 0; k < nh; ++k) {
    stage_head(k, false);
    const int h = h0 + k;
    const bf16* xs = sm.x[k & 1];
    const float* cum = sm.cum[k];
    const float* dtk = sm.dt[k];
    const float* cfk = sm.cf[k];
    const float ci[2] = {cum[i0], cum[i0 + 8]};
    float acc[16][4];                // dC rows
#pragma unroll
    for (int n = 0; n < 16; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      if (v > tile) break;
      // D = dy x^T over the columns j of tile v (dy hi + lo, x exact), each
      // k-step's products in accumulators of their own, added after in a
      // fixed order: four chains in flight where one would wait on each
      // product (19% of the kernel's time at the train shape)
      float dp[4][2][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[kk][t][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk >= nkp) break;
        unsigned ah[4], al[4], bx[4];
        ldmatrix_x4(ah, sm.dyh + a_x + kk * 16);
        ldmatrix_x4(al, sm.dyl + a_x + kk * 16);
        ldmatrix_x4(bx, xs + b_x + v * 16 * kLdX + kk * 16);
        mma(dp[kk][0], ah, bx[0], bx[1]);
        mma(dp[kk][1], ah, bx[2], bx[3]);
        mma(dp[kk][0], al, bx[0], bx[1]);
        mma(dp[kk][1], al, bx[2], bx[3]);
      }
      float d[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          d[t][e] = (dp[0][t][e] + dp[1][t][e]) + (dp[2][t][e] + dp[3][t][e]);
      // Q = D E dt_j; dG = Q G
      const int j0 = v * 16 + 2 * q4;  // columns j0, j0 + 1 (t 0), + 8, + 9 (t 1)
      float q[2][4];
      if (v == tile) {
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, i = i0 + 8 * r, j = j0 + 8 * t + (e & 1);
            q[t][e] = i >= j ? d[t][e] * expf(ci[r] - cum[j]) * dtk[j] : 0.f;
          }
      } else {
        const float ck = cum[v * 16 + 15];
        const float rf[2] = {expf(ci[0] - ck), expf(ci[1] - ck)};
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = j0 + 8 * t + (e & 1);
            q[t][e] = d[t][e] * rf[e >> 1] * (dtk[j] * cfk[j]);
          }
      }
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) rs[e >> 1] = fmaf(q[t][e], s[2 * v + t][e], rs[e >> 1]);
      // dC += Q B_v
      unsigned hi[4], lo[4];
      pack_a(q, hi, lo);
      mma_rows(acc, hi, lo, sm.b + v * 16 * kLdB, lane);
    }
    store_rows(acc, dC, t0, tile * 16, h, H, N, L, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float v = quad_sum(rs[r]);
      if (q4 == 0) sm.rowsum[k][i0 + 8 * r] = v;
    }
    __syncthreads();                 // dy and x[k & 1] are refilled
  }

  // ======== phase J: columns j in the warp's tile (rows of the transposed
  //          products). G^T = B C^T over the tiles i >= j
#pragma unroll
  for (int u = 0; u < 16; ++u) s[u][0] = s[u][1] = s[u][2] = s[u][3] = 0.f;
  for (int kk = 0; kk < nkn; ++kk) {
    unsigned fa[4];
    ldmatrix_x4(fa, sm.b + a_b + kk * 16);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (tile + u > 7) break;
      unsigned bk[4];
      ldmatrix_x4(bk, sm.c + b_b + (tile + u) * 16 * kLdB + kk * 16);
      mma(s[2 * u], fa, bk[0], bk[1]);
      mma(s[2 * u + 1], fa, bk[2], bk[3]);
    }
  }
  const int r_end = tile * 16 + 15;  // the tile's last step: the factor point
  for (int k = 0; k < nh; ++k) {
    stage_head(nh + k, true);
    const int h = h0 + k;
    const bf16* xs = sm.x[(nh + k) & 1];
    const float* cum = sm.cum[k];
    const float* dtk = sm.dt[k];
    const float cj[2] = {cum[i0], cum[i0 + 8]};
    const float cfj[2] = {sm.cf[k][i0], sm.cf[k][i0 + 8]};
    const float dtj[2] = {dtk[i0], dtk[i0 + 8]};
    const float wj[2] = {sm.w[k][i0], sm.w[k][i0 + 8]};
    const float cr = cum[r_end];
    // E over the columns i of tile `tile + u`, for the thread's rows j
    auto decay = [&](int u, float (&e4)[2][4]) {
      const int c0 = (tile + u) * 16 + 2 * q4;
      if (u == 0) {
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, j = i0 + 8 * r, i = c0 + 8 * t + (e & 1);
            e4[t][e] = i >= j ? expf(cum[i] - cj[r]) : 0.f;
          }
      } else {
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const float ce = expf(cum[c0 + 8 * t + e2] - cr);
            e4[t][e2] = ce * cfj[0];
            e4[t][2 + e2] = ce * cfj[1];
          }
      }
    };

    // -- pass A: dxd = w (B dS^T) + M^T dy over P (8 column tiles)
    {
      float acc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
      const bf16* bsh = sm.dsh + b_b;
      const bf16* bsl = sm.dsl + b_b;
      for (int kk = 0; kk < nkn; ++kk) {
        unsigned fa[4];
        ldmatrix_x4(fa, sm.b + a_b + kk * 16);
#pragma unroll
        for (int p2 = 0; p2 < 4; ++p2) {
          unsigned rh[4], rl[4];
          ldmatrix_x4(rh, bsh + p2 * 16 * kLdB + kk * 16);
          ldmatrix_x4(rl, bsl + p2 * 16 * kLdB + kk * 16);
          mma(acc[2 * p2], fa, rh[0], rh[1]);
          mma(acc[2 * p2 + 1], fa, rh[2], rh[3]);
          mma(acc[2 * p2], fa, rl[0], rl[1]);
          mma(acc[2 * p2 + 1], fa, rl[2], rl[3]);
        }
      }
      // wbar_j = dt_j x_j . (B dS^T)_j; then the rows scaled by w_j
      float xu[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              xs + (i0 + 8 * r) * kLdX + n * 8 + 2 * q4));
          xu[r] = fmaf(xv.x, acc[n][2 * r], xu[r]);
          xu[r] = fmaf(xv.y, acc[n][2 * r + 1], xu[r]);
          acc[n][2 * r] *= wj[r];
          acc[n][2 * r + 1] *= wj[r];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float v = quad_sum(xu[r]);
        if (q4 == 0) sm.wbar[k][i0 + 8 * r] = dtj[r] * v;
      }
      // M^T dy over the tiles i >= j: hi hi + hi lo + lo hi
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (tile + u > 7) break;
        float e4[2][4], m[2][4];
        decay(u, e4);
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) m[t][e] = s[2 * u + t][e] * e4[t][e];
        unsigned hi[4], lo[4];
        pack_a(m, hi, lo);
        const int row = (tile + u) * 16 * kLdX + t_x;
#pragma unroll
        for (int p2 = 0; p2 < 4; ++p2) {
          unsigned yh[4], yl[4];
          ldmatrix_x4_trans(yh, sm.dyh + row + p2 * 16);
          ldmatrix_x4_trans(yl, sm.dyl + row + p2 * 16);
          mma(acc[2 * p2], hi, yh[0], yh[1]);
          mma(acc[2 * p2 + 1], hi, yh[2], yh[3]);
          mma(acc[2 * p2], hi, yl[0], yl[1]);
          mma(acc[2 * p2 + 1], hi, yl[2], yl[3]);
          mma(acc[2 * p2], lo, yh[0], yh[1]);
          mma(acc[2 * p2 + 1], lo, yh[2], yh[3]);
        }
      }
      // dx = dt dxd; x . dxd
      float xd[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = i0 + 8 * r;
        float* row = dx + ((t0 + j) * H + h) * static_cast<long long>(P);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              xs + j * kLdX + n * 8 + 2 * q4));
          xd[r] = fmaf(xv.x, acc[n][2 * r], xd[r]);
          xd[r] = fmaf(xv.y, acc[n][2 * r + 1], xd[r]);
          if (j < L)
            store2(row, n * 8 + 2 * q4, P, dtj[r] * acc[n][2 * r], dtj[r] * acc[n][2 * r + 1]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float v = quad_sum(xd[r]);
        if (q4 == 0) sm.xdot[k][i0 + 8 * r] = v;
      }
    }

    // -- pass B: dB = w dt (x dS) + Q^T C, with Q^T = D^T E dt_j and
    //    D^T = x dy^T; dG's column sums
    {
      unsigned xa[4][4];             // x's rows j as A fragments (exact)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) ldmatrix_x4(xa[kk], xs + a_x + kk * 16);
      float acc[16][4];
#pragma unroll
      for (int n = 0; n < 16; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk >= nkp) break;
#pragma unroll
        for (int part = 0; part < 4; ++part) {   // column halves, then hi, lo
          const bf16* ds = (part & 1) ? sm.dsl : sm.dsh;
          const int half = part >> 1;
          unsigned bb[8][2];
#pragma unroll
          for (int n2 = 0; n2 < 4; ++n2) {
            unsigned r[4];
            ldmatrix_x4_trans(r, ds + kk * 16 * kLdB + t_b + (half * 4 + n2) * 16);
            bb[2 * n2][0] = r[0], bb[2 * n2][1] = r[1];
            bb[2 * n2 + 1][0] = r[2], bb[2 * n2 + 1][1] = r[3];
          }
#pragma unroll
          for (int n = 0; n < 8; ++n) mma(acc[half * 8 + n], xa[kk], bb[n][0], bb[n][1]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float wd = wj[r] * dtj[r];
#pragma unroll
        for (int n = 0; n < 16; ++n) {
          acc[n][2 * r] *= wd;
          acc[n][2 * r + 1] *= wd;
        }
      }
      float cs[2] = {0.f, 0.f};
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (tile + u > 7) break;
        // D^T over the columns i of tile `tile + u` (x exact, dy hi + lo)
        float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        const int row = (tile + u) * 16 * kLdX + b_x;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk >= nkp) break;
          unsigned yh[4], yl[4];
          ldmatrix_x4(yh, sm.dyh + row + kk * 16);
          ldmatrix_x4(yl, sm.dyl + row + kk * 16);
          mma(d[0], xa[kk], yh[0], yh[1]);
          mma(d[1], xa[kk], yh[2], yh[3]);
          mma(d[0], xa[kk], yl[0], yl[1]);
          mma(d[1], xa[kk], yl[2], yl[3]);
        }
        float e4[2][4];
        decay(u, e4);
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            d[t][e] = d[t][e] * e4[t][e] * dtj[e >> 1];
            cs[e >> 1] = fmaf(d[t][e], s[2 * u + t][e], cs[e >> 1]);
          }
        unsigned hi[4], lo[4];
        pack_a(d, hi, lo);
        mma_rows(acc, hi, lo, sm.c + (tile + u) * 16 * kLdB, lane);
      }
      store_rows(acc, dB, t0, tile * 16, h, H, N, L, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float v = quad_sum(cs[r]);
        if (q4 == 0) sm.colsum[k][i0 + 8 * r] = v;
      }
    }
    __syncthreads();                 // dy, dS and x are refilled
  }

  // ======== the tails: warp k takes head k. dcum, then its reverse cumsum
  //          dabar (lane l holds steps 4 l .. 4 l + 3), ddt and dA
  if (warp < nh) {
    const int k = warp, h = h0 + k;
    float ww[4], dc[4], tot = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 4 * lane + e;
      ww[e] = j < L ? sm.w[k][j] * sm.wbar[k][j] : 0.f;
      dc[e] = j < L ? sm.rowsum[k][j] - sm.colsum[k][j] - ww[e] : 0.f;
      tot += ww[e];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) tot += __shfl_xor_sync(0xffffffffu, tot, o);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * lane + e == L - 1) dc[e] += tot;
    float run = 0.f;                 // the lane's own suffix sums
#pragma unroll
    for (int e = 3; e >= 0; --e) {
      run += dc[e];
      dc[e] = run;
    }
    float incl = run;                // suffix sum over lanes >= this one
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_down_sync(0xffffffffu, incl, o);
      if (lane + o < 32) incl += v;
    }
    float after = __shfl_down_sync(0xffffffffu, incl, 1);   // lanes > this one
    if (lane == 31) after = 0.f;
    const float a = A[h];
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 4 * lane + e;
      const float dab = dc[e] + after;
      if (j < L) ddt[(t0 + j) * H + h] = fmaf(dab, a, sm.xdot[k][j]);
      part = fmaf(dab, sm.dt[k][j], part);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) dA[(b * nc + c) * H + h] = part;
  }
}

}  // namespace

// x (b, S, H, P) and B, C (b, S, G, N) bf16, 16-byte aligned; dt (b, S, H),
// A (H,), dy (b, S, H, P) and dS (b, S / L, H, P, N) fp32. Outputs, fp32: dx
// (b, S, H, P), ddt (b, S, H), dA (b, S / L, H), dB and dC (b, S, H, N). All
// contiguous on one device; the Python wrapper has checked shapes, types,
// devices and alignment, L <= 128, P <= 64, N <= 128, S % L == 0 and
// H % G == 0.
extern "C" int repro_ssd_chunk_bwd_tc(const void* x, const void* dt, const void* A,
                                      const void* Bm, const void* Cm, const void* dy,
                                      const void* dS, void* dx, void* ddt, void* dA, void* dB,
                                      void* dC, long long b, long long S, int H, int P, int G,
                                      int N, int L, void* stream) {
  if (b < 1 || b > 65535 || L < 1 || L > kL || S % L || S / L > 65535 || P < 1 || P > kP ||
      N < 1 || N > kN || G < 1 || H < G || H % G)
    return static_cast<int>(cudaErrorInvalidValue);
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_chunk_bwd_tc_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(sizeof(Smem)));
    if (err != cudaSuccess) {
      sms = 0;
      return static_cast<int>(err);
    }
  }
  // the head tile: the fewest heads a block that still gives every SM one
  // block (one block an SM fits), then the group's heads spread evenly over
  // its tiles. A head's arithmetic does not depend on the tile
  const long long hpg = H / G, chunks = b * (S / L);
  const long long per_sm = (chunks * H + sms - 1) / sms;
  const int want = static_cast<int>(per_sm < 1 ? 1 : per_sm > kMaxHeads ? kMaxHeads : per_sm);
  const int tiles = static_cast<int>((hpg + want - 1) / want);
  const int heads = static_cast<int>((hpg + tiles - 1) / tiles);
  const bool vec_dy = P % 4 == 0 && reinterpret_cast<size_t>(dy) % 16 == 0;
  const bool vec_ds = N % 4 == 0 && reinterpret_cast<size_t>(dS) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(G * tiles), static_cast<unsigned>(S / L),
                  static_cast<unsigned>(b));
  ssd_chunk_bwd_tc_kernel<<<grid, kThreads, sizeof(Smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm),
      static_cast<const float*>(dy), static_cast<const float*>(dS), static_cast<float*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(dA), static_cast<float*>(dB),
      static_cast<float*>(dC), S, H, P, G, N, L, heads, tiles, vec_dy, vec_ds);
  return static_cast<int>(cudaGetLastError());
}
