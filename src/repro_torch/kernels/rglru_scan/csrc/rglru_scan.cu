// RG-LRU linear recurrence for Hopper (sm_90a), plain C interface.
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
// in VMEM scratch and a fori_loop over t. Channels are independent, so here
// each THREAD owns one (batch, channel) and loops over t with its state in a
// register: grid (ceil(W / kThreads), B), kThreads channels per block. A
// warp's loads at one t are 32 neighbouring floats (one 128-byte line), so
// every load and store is coalesced. The loads do not depend on h, so they
// are issued kAhead steps at a time, one group ahead of the group being
// computed (double buffering in registers), and the gating prologue is fused
// in: the kernel reads x_in and log_a once and writes h once.
//
// Bound on the H100: 8 bytes read and 4 written per element, about ten
// operations per element — memory-bound (12 * B * S * W bytes at 3.35 TB/s).
// This design keeps only B * W threads busy (5120 at B 2, W 2560: a few
// warps per SM), so it is bound by load latency rather than bandwidth; a
// scan that is parallel over time (chunked) is later work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 64;   // channels per block
constexpr int kAhead = 8;      // time steps per load group

struct Group {
  float x[kAhead];
  float la[kAhead];
};

__device__ __forceinline__ void load_group(const float* __restrict__ xp,
                                           const float* __restrict__ ap, long long t,
                                           long long S, long long W, Group& g) {
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    const bool in = t + j < S;
    g.x[j] = in ? __ldg(xp + (t + j) * W) : 0.f;
    g.la[j] = in ? __ldg(ap + (t + j) * W) : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ x_in, const float* __restrict__ log_a,
                  float* __restrict__ h_out, long long S, long long W) {
  const long long c = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= W) return;
  const long long base = static_cast<long long>(blockIdx.y) * S * W + c;
  const float* xp = x_in + base;
  const float* ap = log_a + base;
  float* op = h_out + base;

  float h = 0.f;
  Group cur, nxt;
  load_group(xp, ap, 0, S, W, cur);
  for (long long t = 0; t < S; t += kAhead) {
    load_group(xp, ap, t + kAhead, S, W, nxt);   // zeros past the end
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (t + j >= S) break;
      const float a = expf(cur.la[j]);
      const float xg = sqrtf(fmaxf(1.f - a * a, 1e-12f)) * cur.x[j];
      h = a * h + xg;
      op[(t + j) * W] = h;
    }
    cur = nxt;
  }
}

}  // namespace

// x_in, log_a, h_out: contiguous fp32 (B, S, W) on one device; the Python
// wrapper has checked shapes, types, devices and contiguity.
extern "C" int repro_rglru_scan(const void* x_in, const void* log_a, void* h_out,
                                long long B, long long S, long long W, void* stream) {
  if (B < 1 || S < 1 || W < 1 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((W + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B));
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x_in), static_cast<const float*>(log_a),
      static_cast<float*>(h_out), S, W);
  return static_cast<int>(cudaGetLastError());
}
