// RG-LRU linear recurrence for Hopper (sm_90a), chunked over time. Plain C
// interface.
//
// Replaces the TPU kernel repro/kernels/rglru_scan/kernel.py:36
// rglru_scan_blocks (pallas_call at :43, body _rglru_kernel at :20) together
// with the gating prologue of its wrapper repro/kernels/rglru_scan/ops.py
// rglru_scan: from x_in and log_a, both (B, S, W) fp32,
//   a_t = exp(log_a_t),  x_t = sqrt(max(1 - a_t^2, 1e-12)) * x_in_t,
//   h_t = a_t * h_{t-1} + x_t,  h_0 = 0,
// state carried in fp32, every h_t written out as fp32 (B, S, W).
//
// The TPU kernel's grid is (batch, width-block) with the width-block's state
// in VMEM scratch and a fori_loop over t. One thread per (batch, channel)
// walking all S steps would keep only B * W threads busy (5120 at B 2,
// W 2560: a few warps per SM), bound by load latency. So the S steps are cut
// into nc = ceil(S / T) chunks of T steps (ops.py::CHUNK, 128, whatever S
// is) and every (batch, chunk, channel) gets a thread, in three launches:
//   1. rglru_chunk_kernel, chunks 0 .. nc - 2: scan the chunk from a zero
//      state and write its decay product prod_t a_t and its end state to
//      scratch (2, B, nc - 1, W);
//   2. rglru_carry_kernel, one thread per (batch, channel): fold the
//      aggregates in chunk order, h = prod_k h + end_k, and write each
//      chunk's carry-out (the state after it) over its end state;
//   3. rglru_scan_kernel, every chunk k: scan the chunk from the carry-out
//      of chunk k - 1 (0 for chunk 0), writing every h_t.
// The carry is combined in a fixed order that does not depend on timing
// (no look-back, no atomics), and every thread's loop runs in step order,
// so a launch repeats bit for bit and a batch row's output depends only on
// its own inputs. The chunk does not depend on S, so h_t rounds alike in a
// sequence and in any extension of it. With one chunk (S <= T) only the
// third launch runs.
//
// 1 - a^2 is formed from a rounded square (__fmul_rn), as the plain version
// forms it: near a = 1 the difference cancels, and the fused multiply-add
// the compiler would make of it moved h on long memory (a^8 in [0.9,
// 0.999]) by 0.19 of the card's limit against the plain version, where the
// rounded square leaves 0.018, the chunked carry's association
// (tests/test_torch_rglru_error.py).
//
// Loads: a warp's 32 lanes are 32 neighbouring channels at one t (one
// 128-byte line), and they do not depend on h, so they are issued kAhead
// steps at a time, one group ahead of the group being computed.
//
// Bound on the H100: the function reads 8 bytes and writes 4 per element,
// about ten operations each -- memory-bound, 12 B S W bytes at 3.35 TB/s
// (0.0751 ms at 2 x 4096 x 2560). This design reads the inputs twice: 20
// bytes per element (0.125 ms there), plus the aggregates (about 2/T of that).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kAhead = 8;      // time steps per load group

struct Group {
  float x[kAhead];
  float la[kAhead];
};

__device__ __forceinline__ void load_group(const float* __restrict__ xp,
                                           const float* __restrict__ ap, long long t,
                                           long long end, long long W, Group& g) {
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    const bool in = t + j < end;
    g.x[j] = in ? __ldg(xp + (t + j) * W) : 0.f;
    g.la[j] = in ? __ldg(ap + (t + j) * W) : 0.f;
  }
}

// h through steps [t0, t1) of one channel (xp, ap, op point at its t = 0);
// writes every h_t when op is set, and multiplies each a_t into *prod when
// prod is set
__device__ __forceinline__ float scan_steps(const float* __restrict__ xp,
                                            const float* __restrict__ ap,
                                            float* __restrict__ op, long long t0,
                                            long long t1, long long W, float h,
                                            float* prod) {
  Group cur, nxt;
  load_group(xp, ap, t0, t1, W, cur);
  for (long long t = t0; t < t1; t += kAhead) {
    load_group(xp, ap, t + kAhead, t1, W, nxt);   // zeros past the end
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (t + j >= t1) break;
      const float a = expf(cur.la[j]);
      const float xg = sqrtf(fmaxf(1.f - __fmul_rn(a, a), 1e-12f)) * cur.x[j];
      h = a * h + xg;
      if (op) op[(t + j) * W] = h;
      if (prod) *prod *= a;
    }
    cur = nxt;
  }
  return h;
}

__global__ void __launch_bounds__(kThreads)
rglru_chunk_kernel(const float* __restrict__ x_in, const float* __restrict__ log_a,
                   float* __restrict__ agg, long long B, long long S, long long W,
                   long long T) {
  const long long c = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= W) return;
  const long long k = blockIdx.y, b = blockIdx.z, nc1 = gridDim.y;   // nc - 1
  const long long base = b * S * W + c;
  float prod = 1.f;
  const float end = scan_steps(x_in + base, log_a + base, nullptr, k * T, (k + 1) * T, W,
                               0.f, &prod);
  const long long o = (b * nc1 + k) * W + c;
  agg[o] = prod;
  agg[B * nc1 * W + o] = end;
}

// over agg's end states, in chunk order: end_k := prod_k carry_{k-1} + end_k,
// the state after chunk k
__global__ void __launch_bounds__(kThreads)
rglru_carry_kernel(float* __restrict__ agg, long long B, long long W, long long nc1) {
  const long long c = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= W) return;
  const long long b = blockIdx.y;
  const float* prod = agg + b * nc1 * W + c;
  float* end = agg + (B + b) * nc1 * W + c;
  float h = 0.f;
  for (long long m0 = 0; m0 < nc1; m0 += kAhead) {
    float p[kAhead], e[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const bool in = m0 + j < nc1;
      p[j] = in ? prod[(m0 + j) * W] : 0.f;
      e[j] = in ? end[(m0 + j) * W] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (m0 + j >= nc1) break;
      h = fmaf(p[j], h, e[j]);
      end[(m0 + j) * W] = h;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ x_in, const float* __restrict__ log_a,
                  const float* __restrict__ agg, float* __restrict__ h_out, long long B,
                  long long S, long long W, long long T) {
  const long long c = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= W) return;
  const long long k = blockIdx.y, b = blockIdx.z, nc1 = gridDim.y - 1;
  // carry-in: the state after chunk k - 1
  const float h = k > 0 ? agg[(B + b) * nc1 * W + (k - 1) * W + c] : 0.f;
  const long long base = b * S * W + c;
  scan_steps(x_in + base, log_a + base, h_out + base, k * T, min(S, (k + 1) * T), W, h,
             nullptr);
}

}  // namespace

// x_in, log_a, h_out: contiguous fp32 (B, S, W) on one device; agg: fp32
// scratch of 2 B (nc - 1) W values, nc = ceil(S / T) (unused when nc is 1).
// The Python wrapper has checked shapes, types, devices and contiguity.
extern "C" int repro_rglru_scan(const void* x_in, const void* log_a, void* h_out, void* agg,
                                long long B, long long S, long long W, long long T,
                                void* stream) {
  if (B < 1 || S < 1 || W < 1 || T < 1 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const long long nc = (S + T - 1) / T;
  if (nc > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned wb = static_cast<unsigned>((W + kThreads - 1) / kThreads);
  const float* x = static_cast<const float*>(x_in);
  const float* la = static_cast<const float*>(log_a);
  float* sc = static_cast<float*>(agg);
  if (nc > 1) {
    rglru_chunk_kernel<<<dim3(wb, static_cast<unsigned>(nc - 1), static_cast<unsigned>(B)),
                         kThreads, 0, st>>>(x, la, sc, B, S, W, T);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    rglru_carry_kernel<<<dim3(wb, static_cast<unsigned>(B)), kThreads, 0, st>>>(sc, B, W,
                                                                               nc - 1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  rglru_scan_kernel<<<dim3(wb, static_cast<unsigned>(nc), static_cast<unsigned>(B)), kThreads,
                      0, st>>>(x, la, sc, static_cast<float*>(h_out), B, S, W, T);
  return static_cast<int>(cudaGetLastError());
}
