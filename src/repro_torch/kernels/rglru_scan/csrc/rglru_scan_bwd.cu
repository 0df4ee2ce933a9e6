// Backward of the RG-LRU linear recurrence for Hopper (sm_90a), chunked over
// time. Plain C interface.
//
// The gradient of repro/models/rglru.py:82 rglru_scan_assoc (what jax.grad
// differentiates in the JAX package's training step), computed through the
// TPU kernel at repro/kernels/rglru_scan/kernel.py:43 (pallas_call of
// rglru_scan_blocks, which has no backward of its own) and its gating
// prologue. The forward (rglru_scan.cu) is
//   a_t = exp(log_a_t),  s_t = sqrt(max(1 - a_t^2, 1e-12)),
//   h_t = a_t h_{t-1} + s_t x_in_t,  h_{-1} = 0.
// From x_in, log_a, the saved states h and their gradient dh, all (B, S, W)
// fp32, this computes, walking back in time,
//   delta_t = dh_t + a_{t+1} delta_{t+1}   (delta_S = 0: the state's adjoint),
//   dx_in_t = delta_t s_t,
//   da_t    = delta_t h_{t-1} - delta_t x_in_t a_t / s_t   (the second term
//             only where 1 - a_t^2 > 1e-12: jax.grad of jnp.maximum against a
//             constant is 0 where the constant wins),
//   dlog_a_t = da_t a_t,
// and writes dx_in and dlog_a as fp32 (B, S, W).
//
// The forward's three-launch chunked design, run backwards in time. The
// adjoint carried from the steps after a chunk into it is g = a_t delta_t of
// the chunk's successor's first step, and a chunk maps its carry-in c to
// its carry-out as c -> (prod_t a_t) c + e. So, over nc = ceil(S / T)
// chunks of T steps (ops.py::CHUNK, 128):
//   1. rglru_bwd_chunk_kernel, chunks 1 .. nc - 1: the chunk's reverse scan
//      from a zero carry, writing its decay product and its carry-out e to
//      scratch (2, B, nc - 1, W) (chunk 0's carry-out is never needed);
//   2. rglru_bwd_carry_kernel, one thread per (batch, channel): fold the
//      aggregates from the last chunk back, c = prod_k c + e_k, writing each
//      chunk's carry-in over the slot of its successor's e;
//   3. rglru_bwd_scan_kernel, every chunk: the reverse scan from its
//      carry-in (0 for the last chunk), writing dx_in and dlog_a.
// The carries fold in a fixed order (no look-back, no atomics) and every
// thread walks its steps in one order, so a launch repeats bit for bit and
// a batch row's gradient depends only on that row's inputs: an LFLR replay
// is bit-exact. With one chunk (S <= T) only the third launch runs.
//
// 1 - a^2 is formed from a rounded square (__fmul_rn), as the plain version
// forms it: near a = 1 the difference cancels, and a fused multiply-add
// there would move s, and so a / s, by far more than an ulp.
//
// Bound on the H100: the function reads 16 bytes per element (x_in, log_a,
// h, dh) and writes 8 (dx_in, dlog_a), about twenty operations each --
// memory-bound, 24 B S W bytes at 3.35 TB/s. This design reads log_a and dh
// twice: 32 bytes per element, plus the aggregates (about 2/T of that).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kAhead = 8;      // time steps per load group

struct Group {
  float la[kAhead];
  float dh[kAhead];
  float x[kAhead];   // the third launch only
  float hp[kAhead];  // h_{t-1}, the third launch only
};

// steps t, t - 1, ..., t - kAhead + 1 of one channel (pointers at its t = 0),
// zeros below lo
template <bool kFull>
__device__ __forceinline__ void load_back(const float* __restrict__ xp,
                                          const float* __restrict__ ap,
                                          const float* __restrict__ hp,
                                          const float* __restrict__ gp, long long t,
                                          long long lo, long long W, Group& g) {
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    const long long u = t - j;
    const bool in = u >= lo;
    g.la[j] = in ? __ldg(ap + u * W) : 0.f;
    g.dh[j] = in ? __ldg(gp + u * W) : 0.f;
    if (kFull) {
      g.x[j] = in ? __ldg(xp + u * W) : 0.f;
      g.hp[j] = in && u > 0 ? __ldg(hp + (u - 1) * W) : 0.f;
    }
  }
}

// the adjoint through steps [t0, t1) of one channel, walking back from
// t1 - 1 with carry-in g (a_{t1} delta_{t1}); returns the carry-out
// a_{t0} delta_{t0}. kFull: also write dx_in and dlog_a (dxp, dlp at the
// channel's t = 0); else multiply each a_t into *prod.
template <bool kFull>
__device__ __forceinline__ float adjoint_steps(const float* __restrict__ xp,
                                               const float* __restrict__ ap,
                                               const float* __restrict__ hp,
                                               const float* __restrict__ gp,
                                               float* __restrict__ dxp,
                                               float* __restrict__ dlp, long long t0,
                                               long long t1, long long W, float g,
                                               float* prod) {
  Group cur, nxt;
  load_back<kFull>(xp, ap, hp, gp, t1 - 1, t0, W, cur);
  for (long long t = t1 - 1; t >= t0; t -= kAhead) {
    load_back<kFull>(xp, ap, hp, gp, t - kAhead, t0, W, nxt);   // zeros past t0
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const long long u = t - j;
      if (u < t0) break;
      const float a = expf(cur.la[j]);
      const float d = cur.dh[j] + g;
      if (kFull) {
        const float om = 1.f - __fmul_rn(a, a);
        const float s = sqrtf(fmaxf(om, 1e-12f));
        const float ds = om > 1e-12f ? -a / s : 0.f;            // d s / d a
        const float da = d * cur.hp[j] + (d * cur.x[j]) * ds;
        dxp[u * W] = d * s;
        dlp[u * W] = da * a;
      } else {
        *prod *= a;
      }
      g = a * d;
    }
    cur = nxt;
  }
  return g;
}

__global__ void __launch_bounds__(kThreads)
rglru_bwd_chunk_kernel(const float* __restrict__ log_a, const float* __restrict__ dh,
                       float* __restrict__ agg, long long B, long long S, long long W,
                       long long T) {
  const long long c = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= W) return;
  const long long m = blockIdx.y, k = m + 1, b = blockIdx.z, nc1 = gridDim.y;
  const long long base = b * S * W + c;
  float prod = 1.f;
  const float e = adjoint_steps<false>(nullptr, log_a + base, nullptr, dh + base, nullptr,
                                       nullptr, k * T, min(S, (k + 1) * T), W, 0.f, &prod);
  const long long o = (b * nc1 + m) * W + c;
  agg[o] = prod;
  agg[B * nc1 * W + o] = e;
}

// over the aggregates of chunks nc - 1 .. 1 (slot m holds chunk m + 1's):
// c := prod_{m+1} c + e_{m+1}, written over e's slot m -- the carry-in of
// chunk m
__global__ void __launch_bounds__(kThreads)
rglru_bwd_carry_kernel(float* __restrict__ agg, long long B, long long W, long long nc1) {
  const long long c = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= W) return;
  const long long b = blockIdx.y;
  const float* prod = agg + b * nc1 * W + c;
  float* end = agg + (B + b) * nc1 * W + c;
  float g = 0.f;
  for (long long m0 = nc1 - 1; m0 >= 0; m0 -= kAhead) {
    float p[kAhead], e[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const bool in = m0 - j >= 0;
      p[j] = in ? prod[(m0 - j) * W] : 0.f;
      e[j] = in ? end[(m0 - j) * W] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (m0 - j < 0) break;
      g = fmaf(p[j], g, e[j]);
      end[(m0 - j) * W] = g;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
rglru_bwd_scan_kernel(const float* __restrict__ x_in, const float* __restrict__ log_a,
                      const float* __restrict__ h, const float* __restrict__ dh,
                      const float* __restrict__ agg, float* __restrict__ dx_in,
                      float* __restrict__ dlog_a, long long B, long long S, long long W,
                      long long T) {
  const long long c = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= W) return;
  const long long k = blockIdx.y, b = blockIdx.z, nc1 = gridDim.y - 1;
  // carry-in: a delta of the next chunk's first step (0 after the last)
  const float g = k < nc1 ? agg[(B + b) * nc1 * W + k * W + c] : 0.f;
  const long long base = b * S * W + c;
  adjoint_steps<true>(x_in + base, log_a + base, h + base, dh + base, dx_in + base,
                      dlog_a + base, k * T, min(S, (k + 1) * T), W, g, nullptr);
}

}  // namespace

// x_in, log_a, h, dh, dx_in, dlog_a: contiguous fp32 (B, S, W) on one
// device; agg: fp32 scratch of 2 B (nc - 1) W values, nc = ceil(S / T)
// (unused when nc is 1). The Python wrapper has checked shapes, types,
// devices and contiguity.
extern "C" int repro_rglru_scan_bwd(const void* x_in, const void* log_a, const void* h,
                                    const void* dh, void* dx_in, void* dlog_a, void* agg,
                                    long long B, long long S, long long W, long long T,
                                    void* stream) {
  if (B < 1 || S < 1 || W < 1 || T < 1 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const long long nc = (S + T - 1) / T;
  if (nc > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned wb = static_cast<unsigned>((W + kThreads - 1) / kThreads);
  const float* la = static_cast<const float*>(log_a);
  const float* g = static_cast<const float*>(dh);
  float* sc = static_cast<float*>(agg);
  if (nc > 1) {
    rglru_bwd_chunk_kernel<<<dim3(wb, static_cast<unsigned>(nc - 1),
                                  static_cast<unsigned>(B)), kThreads, 0, st>>>(
        la, g, sc, B, S, W, T);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    rglru_bwd_carry_kernel<<<dim3(wb, static_cast<unsigned>(B)), kThreads, 0, st>>>(
        sc, B, W, nc - 1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  rglru_bwd_scan_kernel<<<dim3(wb, static_cast<unsigned>(nc), static_cast<unsigned>(B)),
                          kThreads, 0, st>>>(
      static_cast<const float*>(x_in), la, static_cast<const float*>(h), g, sc,
      static_cast<float*>(dx_in), static_cast<float*>(dlog_a), B, S, W, T);
  return static_cast<int>(cudaGetLastError());
}
