// Backward of the Mamba-2 SSD intra-chunk function for Hopper (sm_90a), in
// fp32 on the CUDA cores, for fp32 x, B, C (bf16 ones take
// ssd_chunk_bwd_tc.cu: ops.py::plan_bwd picks by dtype). Plain C interface.
//
// The gradient of repro/models/ssm.py:89 ssd_chunked (what jax.grad
// differentiates in the JAX package's training step) through its
// intra-chunk part, the TPU kernel at repro/kernels/ssd_scan/kernel.py:53
// (pallas_call of ssd_intra_chunk, which has no backward of its own) and
// the prologue of its wrapper. The forward (ssd_chunk_tc.cu for bf16 x, B,
// C; ssd_f32.cu for fp32) computes, per (batch, chunk, head) over the
// chunk's L steps, with xd_j = dt_j x_j, cum_i = sum_{k<=i} dt_k A,
// w_j = exp(cum_{L-1} - cum_j) and M = tril(C B^T * exp(cum_i - cum_j)):
//   y_diag = M xd  (L, P),   state = sum_j w_j xd_j (x) B_j  (P, N).
// Given their gradients dy (L, P) and dS (P, N), fp32:
//   dxd_j  = sum_{i>=j} M_ij dy_i + w_j dS B_j,
//   dM_ij  = [i>=j] dy_i . xd_j,   dG_ij = dM_ij M_ij (the segment sum's),
//   dC_i   = sum_j dM_ij e^{cum_i-cum_j} B_j,
//   dB_j   = sum_i dM_ij e^{cum_i-cum_j} C_i + w_j dS^T xd_j,
//   dcum   = row sums of dG - column sums of dG, plus sum_j w_j (xd_j . dS
//            B_j) at L - 1 and minus each term at j,
//   dabar  = the reverse cumsum of dcum,
//   ddt_k  = dabar_k A + x_k . dxd_k,  dx_k = dt_k dxd_k,
//   dA     = sum_k dabar_k dt_k (this block's part).
// dB and dC come out per head (b, S, H, N), dA per (batch, chunk, head);
// ops.py sums them over the heads of a group and into A, in a fixed order.
//
// Shared memory: one pass would hold B, C, M, dy, xd, dS and the masked
// dM e^{...} (Q) at once, ~350 KB in fp32 at the largest tile (L 128, P 64,
// N 128), past the 227 KB a block may have. So two launches, one block of
// 256 threads (16 x 16) per (head, chunk, batch), heads fastest as in the
// forward:
//   1. ssd_bwd_dx_kernel (B, C -> M, dy, dS, then xd over B: 215.0 KB):
//      G = C B^T; M over C; dxd = M^T dy + w (B dS^T); writes dx, and the
//      state term of dB; then xd over B and D = dy xd^T, whose product with
//      M gives dG's row and column sums; dcum, its reverse cumsum, ddt and
//      this block's dA.
//   2. ssd_bwd_dbc_kernel (B, C, dy, xd, then Q over dy and xd: 205.8 KB):
//      D again, Q = [i>=j] D e^{cum_i - cum_j}; dC = Q B, and dB += Q^T C
//      (the element launch 1 wrote, read and written by one thread).
// exp is taken only where i >= j, as in the forward: above the diagonal the
// segment sum is positive and exp may overflow, and inf times a zero mask
// would be NaN on a clean run. cum is summed by one thread in step order
// with each product rounded first, as the forward and a sequential cumsum.
// Every sum runs in a fixed order inside one thread (or a fixed shuffle
// tree inside a half-warp), with no atomics and nothing split across
// blocks, so a (batch, chunk, head)'s gradients depend only on its own
// inputs and the launch shape: an LFLR replay is bit-exact.
//
// Bound on the H100: fp32 operations (TF32 stays off). The least work is
// C B^T once per group and the causal half of each L x L product: per
// (batch, chunk) G N L (L + 1) + H (2 P L (L + 1) + 2 N L (L + 1) + 4 L P N)
// operations (chip_smoke.py counts them at each shape). This design computes
// C B^T per head, D twice and the full squares.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kL = 128;          // largest chunk
constexpr int kP = 64;           // largest head dim
constexpr int kN = 128;          // largest state dim
constexpr int kLdN = kN + 4;     // padded row of B, C, dS
constexpr int kLdP = kP + 4;     // padded row of dy, xd
constexpr int kLdL = kL + 4;     // padded row of M, Q
constexpr int kThreads = 256;    // 16 x 16
static_assert(kLdL == kLdN, "M reuses C's buffer");
static_assert(kL * kLdL <= 2 * kL * kLdP, "Q reuses dy's and xd's buffers");
static_assert(kP <= kN, "xd reuses B's buffer");

// launch 1: B, C/M, dy, dS; dt, cum, w, x.dxd, w-bar and the row sums (6
// x kL); the column partials (16 x kL)
constexpr int kSmem1 = 2 * kL * kLdN + kL * kLdP + kP * kLdN + 6 * kL + 16 * kL;
// launch 2: B, C, dy and xd (then Q), dt, cum
constexpr int kSmem2 = 2 * kL * kLdN + 2 * kL * kLdP + 2 * kL;
constexpr size_t kSmem1Bytes = kSmem1 * sizeof(float);
constexpr size_t kSmem2Bytes = kSmem2 * sizeof(float);


__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// sum over the 16 lanes of a half-warp (tx), the same tree in every lane
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Chunk {
  int tid, ty, tx, h, g;
  long long c, b, nc, t0;
};

__device__ __forceinline__ Chunk chunk_of(long long S, int H, int G, int L) {
  Chunk k;
  k.tid = threadIdx.x;
  k.ty = k.tid / 16;
  k.tx = k.tid % 16;
  k.h = blockIdx.x;
  k.c = blockIdx.y;
  k.b = blockIdx.z;
  k.g = k.h / (H / G);
  k.nc = S / L;
  k.t0 = k.b * S + k.c * L;
  return k;
}

// dt, then cum (one thread, step order, each product rounded first); zeros
// past L
__device__ __forceinline__ void stage_decay(const Chunk& k, const float* __restrict__ dt,
                                            const float* __restrict__ A, int H, int L,
                                            float* dts, float* cum) {
  if (k.tid < kL) dts[k.tid] = k.tid < L ? dt[(k.t0 + k.tid) * H + k.h] : 0.f;
  __syncthreads();
  if (k.tid == 0) {
    const float a = A[k.h];
    float s = 0.f;
    for (int j = 0; j < kL; ++j) {
      s += __fmul_rn(dts[j], a);
      cum[j] = s;
    }
  }
}

// the group's B and C rows (ld kLdN), zero-padded to kL x kN
__device__ __forceinline__ void stage_bc(const Chunk& k, const float* __restrict__ Bm,
                                         const float* __restrict__ Cm, int G, int N, int L,
                                         float* Bs, float* Cs) {
  for (int e = k.tid; e < kL * kN; e += kThreads) {
    const int j = e / kN, n = e % kN;
    float bv = 0.f, cv = 0.f;
    if (j < L && n < N) {
      const long long off = ((k.t0 + j) * G + k.g) * N + n;
      bv = (Bm[off]);
      cv = (Cm[off]);
    }
    Bs[j * kLdN + n] = bv;
    Cs[j * kLdN + n] = cv;
  }
}

// the head's dy rows (ld kLdP), zero-padded to kL x kP
__device__ __forceinline__ void stage_dy(const Chunk& k, const float* __restrict__ dy,
                                         int H, int P, int L, float* Ys) {
  for (int e = k.tid; e < kL * kP; e += kThreads) {
    const int j = e / kP, q = e % kP;
    Ys[j * kLdP + q] = (j < L && q < P) ? dy[((k.t0 + j) * H + k.h) * P + q] : 0.f;
  }
}

// xd = x dt (ld kLdP), zero-padded; dts must be staged
__device__ __forceinline__ void stage_xd(const Chunk& k, const float* __restrict__ x, int H,
                                         int P, int L, const float* dts, float* Xs) {
  for (int e = k.tid; e < kL * kP; e += kThreads) {
    const int j = e / kP, q = e % kP;
    Xs[j * kLdP + q] = (j < L && q < P) ? (x[((k.t0 + j) * H + k.h) * P + q]) * dts[j]
                                        : 0.f;
  }
}

// D = dy xd^T: rows i = ty + 16 r, columns j = tx + 16 q
__device__ __forceinline__ void dy_xd(const Chunk& k, const float* Ys, const float* Xs,
                                      int P, float (&acc)[8][8]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
  const int np = (P + 3) & ~3;
  for (int p = 0; p < np; p += 4) {
    float4 yr[8], xr[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      yr[r] = *reinterpret_cast<const float4*>(Ys + (k.ty + 16 * r) * kLdP + p);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      xr[q] = *reinterpret_cast<const float4*>(Xs + (k.tx + 16 * q) * kLdP + p);
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r][q] = dot4(yr[r], xr[q], acc[r][q]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_dx_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const float* __restrict__ Bm,
                  const float* __restrict__ Cm, const float* __restrict__ dy,
                  const float* __restrict__ dS, float* __restrict__ dx,
                  float* __restrict__ ddt, float* __restrict__ dA, float* __restrict__ dB,
                  long long S, int H, int P, int G, int N, int L) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Bs = smem;                    // [kL][kLdN] B, then xd [kL][kLdP]
  float* Cs = Bs + kL * kLdN;          // [kL][kLdN] C, then M [kL][kLdL]
  float* Ys = Cs + kL * kLdN;          // [kL][kLdP] dy
  float* Ss = Ys + kL * kLdP;          // [kP][kLdN] dS
  float* dts = Ss + kP * kLdN;         // [kL]
  float* cum = dts + kL;               // [kL]
  float* wts = cum + kL;               // [kL] exp(cum_{L-1} - cum_j)
  float* xdot = wts + kL;              // [kL] x_j . dxd_j
  float* wbar = xdot + kL;             // [kL] xd_j . dS B_j, then times w_j
  float* colp = wbar + kL;             // [16][kL] column partials of dG
  float* rsum = colp + 16 * kL;        // [kL] row sums of dG, then dcum

  const Chunk k = chunk_of(S, H, G, L);
  const int ty = k.ty, tx = k.tx;

  // ---- stage dt, cum, B, C, dy, dS
  stage_decay(k, dt, A, H, L, dts, cum);
  stage_bc(k, Bm, Cm, G, N, L, Bs, Cs);
  stage_dy(k, dy, H, P, L, Ys);
  const float* dSh = dS + ((k.b * k.nc + k.c) * H + k.h) * static_cast<long long>(P) * N;
  for (int e = k.tid; e < kP * kN; e += kThreads) {
    const int q = e / kN, n = e % kN;
    Ss[q * kLdN + n] = (q < P && n < N) ? dSh[static_cast<long long>(q) * N + n] : 0.f;
  }
  __syncthreads();
  if (k.tid < kL) wts[k.tid] = k.tid < L ? expf(cum[L - 1] - cum[k.tid]) : 0.f;

  // ---- G = C B^T, then M = G exp(cum_i - cum_j) where i >= j, over C
  const int nk = (N + 3) & ~3;
  {
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
    for (int n = 0; n < nk; n += 4) {
      float4 cr[8], br[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        cr[r] = *reinterpret_cast<const float4*>(Cs + (ty + 16 * r) * kLdN + n);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        br[q] = *reinterpret_cast<const float4*>(Bs + (tx + 16 * q) * kLdN + n);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = dot4(cr[r], br[q], acc[r][q]);
    }
    __syncthreads();                   // every read of C is done
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty + 16 * r;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int j = tx + 16 * q;
        Cs[i * kLdL + j] = (i >= j && i < L) ? acc[r][q] * expf(cum[i] - cum[j]) : 0.f;
      }
    }
  }
  __syncthreads();
  const float* Ms = Cs;

  // ---- dxd = M^T dy + w (B dS^T): rows j = ty + 16 r, columns p = tx + 16 u
  {
    float xb[8][4], uu[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) xb[r][u] = uu[r][u] = 0.f;
    for (int i = 0; i < L; ++i) {
      float yv[4], mv[8];
#pragma unroll
      for (int u = 0; u < 4; ++u) yv[u] = Ys[i * kLdP + tx + 16 * u];
#pragma unroll
      for (int r = 0; r < 8; ++r) mv[r] = Ms[i * kLdL + ty + 16 * r];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u) xb[r][u] = fmaf(mv[r], yv[u], xb[r][u]);
    }
    for (int n = 0; n < nk; n += 4) {
      float4 br[8], sr[4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        br[r] = *reinterpret_cast<const float4*>(Bs + (ty + 16 * r) * kLdN + n);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        sr[u] = *reinterpret_cast<const float4*>(Ss + (tx + 16 * u) * kLdN + n);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u) uu[r][u] = dot4(br[r], sr[u], uu[r][u]);
    }
    // dx = dt dxd; x . dxd (for ddt) and xd . (dS B_j) (w-bar) per row
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int j = ty + 16 * r;
      const float w = wts[j], dtj = dts[j];
      float xdt = 0.f, wdt = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int p = tx + 16 * u;
        const bool in = j < L && p < P;
        const long long off = ((k.t0 + j) * H + k.h) * P + p;
        const float xbar = fmaf(w, uu[r][u], xb[r][u]);
        const float xv = in ? (x[off]) : 0.f;
        xdt = fmaf(xv, xbar, xdt);
        wdt = fmaf(xv * dtj, uu[r][u], wdt);
        if (in) dx[off] = dtj * xbar;
      }
      xdt = half_warp_sum(xdt);
      wdt = half_warp_sum(wdt);
      if (tx == 0) {
        xdot[j] = xdt;
        wbar[j] = wdt;
      }
    }
  }
  __syncthreads();                     // every read of B is done

  // ---- xd over B; the state term of dB: w_j dS^T xd_j, rows j = ty + 16 r,
  //      columns n = tx + 16 q
  float* Xs = Bs;
  stage_xd(k, x, H, P, L, dts, Xs);
  __syncthreads();
  {
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
    for (int p = 0; p < P; ++p) {
      float xv[8], sv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) xv[r] = Xs[(ty + 16 * r) * kLdP + p];
#pragma unroll
      for (int q = 0; q < 8; ++q) sv[q] = Ss[p * kLdN + tx + 16 * q];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(xv[r], sv[q], acc[r][q]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int j = ty + 16 * r;
      if (j >= L) continue;
      float* row = dB + ((k.t0 + j) * H + k.h) * N;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int n = tx + 16 * q;
        if (n < N) row[n] = wts[j] * acc[r][q];
      }
    }
  }

  // ---- dG = (dy xd^T) * M: its row sums and column sums
  {
    float acc[8][8];
    dy_xd(k, Ys, Xs, P, acc);
    float cs[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) cs[q] = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty + 16 * r;
      float rs = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float gv = acc[r][q] * Ms[i * kLdL + tx + 16 * q];
        rs += gv;
        cs[q] += gv;
      }
      rs = half_warp_sum(rs);
      if (tx == 0) rsum[i] = rs;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) colp[ty * kL + tx + 16 * q] = cs[q];
  }
  __syncthreads();

  // ---- dcum (but the w-bar sum at L - 1) over rsum, w_j w-bar_j over
  //      wbar; then its reverse cumsum, ddt and this block's part of dA
  if (k.tid < kL) {
    const int j = k.tid;
    float col = 0.f;
    for (int t = 0; t < 16; ++t) col += colp[t * kL + j];
    const float ww = j < L ? wts[j] * wbar[j] : 0.f;
    rsum[j] = j < L ? rsum[j] - col - ww : 0.f;
    wbar[j] = ww;
  }
  __syncthreads();
  if (k.tid == 0) {
    float run = 0.f, part = 0.f;
    for (int j = 0; j < L; ++j) run += wbar[j];   // dcum_{L-1}'s w-bar sum
    const float a = A[k.h];
    for (int j = L - 1; j >= 0; --j) {
      run += rsum[j];
      ddt[(k.t0 + j) * H + k.h] = fmaf(run, a, xdot[j]);
      part = fmaf(run, dts[j], part);
    }
    dA[(k.b * k.nc + k.c) * H + k.h] = part;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_dbc_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const float* __restrict__ Bm,
                   const float* __restrict__ Cm, const float* __restrict__ dy,
                   float* __restrict__ dB, float* __restrict__ dC, long long S, int H,
                   int P, int G, int N, int L) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Bs = smem;                    // [kL][kLdN]
  float* Cs = Bs + kL * kLdN;          // [kL][kLdN]
  float* Ys = Cs + kL * kLdN;          // [kL][kLdP] dy, then Q [kL][kLdL]
  float* Xs = Ys + kL * kLdP;          // [kL][kLdP] xd
  float* dts = Xs + kL * kLdP;         // [kL]
  float* cum = dts + kL;               // [kL]

  const Chunk k = chunk_of(S, H, G, L);
  const int ty = k.ty, tx = k.tx;
  stage_decay(k, dt, A, H, L, dts, cum);
  stage_bc(k, Bm, Cm, G, N, L, Bs, Cs);
  stage_dy(k, dy, H, P, L, Ys);
  stage_xd(k, x, H, P, L, dts, Xs);
  __syncthreads();

  // ---- Q = [i >= j] (dy xd^T) exp(cum_i - cum_j), over dy and xd
  {
    float acc[8][8];
    dy_xd(k, Ys, Xs, P, acc);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty + 16 * r;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int j = tx + 16 * q;
        acc[r][q] = (i >= j && i < L) ? acc[r][q] * expf(cum[i] - cum[j]) : 0.f;
      }
    }
    __syncthreads();                   // every read of dy and xd is done
    float* Qw = Ys;
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) Qw[(ty + 16 * r) * kLdL + tx + 16 * q] = acc[r][q];
  }
  __syncthreads();
  const float* Qs = Ys;

  // ---- dC = Q B: rows i = ty + 16 r, columns n = tx + 16 q
  {
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
    for (int j = 0; j < L; ++j) {
      float qv[8], bv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) qv[r] = Qs[(ty + 16 * r) * kLdL + j];
#pragma unroll
      for (int q = 0; q < 8; ++q) bv[q] = Bs[j * kLdN + tx + 16 * q];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(qv[r], bv[q], acc[r][q]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty + 16 * r;
      if (i >= L) continue;
      float* row = dC + ((k.t0 + i) * H + k.h) * N;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int n = tx + 16 * q;
        if (n < N) row[n] = acc[r][q];
      }
    }
  }

  // ---- dB += Q^T C: rows j = ty + 16 r, columns n = tx + 16 q
  {
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
    for (int i = 0; i < L; ++i) {
      float qv[8], cv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) qv[r] = Qs[i * kLdL + ty + 16 * r];
#pragma unroll
      for (int q = 0; q < 8; ++q) cv[q] = Cs[i * kLdN + tx + 16 * q];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(qv[r], cv[q], acc[r][q]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int j = ty + 16 * r;
      if (j >= L) continue;
      float* row = dB + ((k.t0 + j) * H + k.h) * N;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int n = tx + 16 * q;
        if (n < N) row[n] += acc[r][q];
      }
    }
  }
}

int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           const void* dy, const void* dS, void* dx, void* ddt, void* dA, void* dB,
           void* dC, long long b, long long S, int H, int P, int G, int N, int L,
           cudaStream_t st) {
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(ssd_bwd_dx_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(kSmem1Bytes));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_bwd_dbc_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kSmem2Bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const dim3 grid(static_cast<unsigned>(H), static_cast<unsigned>(S / L),
                  static_cast<unsigned>(b));
  const float* xt = static_cast<const float*>(x);
  const float* Bt = static_cast<const float*>(Bm);
  const float* Ct = static_cast<const float*>(Cm);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* dyf = static_cast<const float*>(dy);
  ssd_bwd_dx_kernel<<<grid, kThreads, kSmem1Bytes, st>>>(
      xt, dtf, Af, Bt, Ct, dyf, static_cast<const float*>(dS), static_cast<float*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(dA), static_cast<float*>(dB), S, H, P,
      G, N, L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dbc_kernel<<<grid, kThreads, kSmem2Bytes, st>>>(
      xt, dtf, Af, Bt, Ct, dyf, static_cast<float*>(dB), static_cast<float*>(dC), S, H, P,
      G, N, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (b, S, H, P), B, C (b, S, G, N), dt (b, S, H), A (H,), dy (b, S, H, P)
// and dS (b, S / L, H, P, N) fp32. Outputs, fp32: dx (b, S, H, P), ddt (b,
// S, H), dA (b, S / L, H), dB and dC (b, S, H, N). All contiguous on one
// device; the Python wrapper has checked shapes, types and devices,
// L <= 128, P <= 64, N <= 128, S % L == 0 and H % G == 0.
extern "C" int repro_ssd_chunk_bwd_f32(const void* x, const void* dt, const void* A,
                                       const void* Bm, const void* Cm, const void* dy,
                                       const void* dS, void* dx, void* ddt, void* dA,
                                       void* dB, void* dC, long long b, long long S, int H,
                                       int P, int G, int N, int L, void* stream) {
  if (b < 1 || b > 65535 || L < 1 || L > kL || S % L || S / L > 65535 || P < 1 ||
      P > kP || N < 1 || N > kN || G < 1 || H % G || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(x, dt, A, Bm, Cm, dy, dS, dx, ddt, dA, dB, dC, b, S, H, P, G, N, L,
                static_cast<cudaStream_t>(stream));
}
