// Backward of the RG-LRU linear recurrence for Hopper (sm_90a), chunked over
// time, in one pass. Plain C interface.
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
// Chunks of T steps (ops.py::CHUNK, 128, whatever S is). The adjoint
// carried into a stretch of steps from the steps after it is g = a_t
// delta_t of the next step, and a stretch maps its carry-in c to its
// carry-out as c -> (prod_t a_t) c + e. One block of four warps per (chunk,
// batch row, 32 channels), warp w on the chunk's steps 32 w .. 32 w + 31:
//   1. each warp stages its steps of log_a and dh, then of x_in and
//      h_{t-1}, into shared memory by cp.async (each input read once: 24
//      bytes an element with the writes, the bound's count);
//   2. each warp scans its steps back in time from a zero carry: its decay
//      product prod_w and carry-out e_w (a_t kept in shared memory);
//   3. warp 0 waits for the chunk's carry-in c, which the block of chunk
//      k + 1 publishes (0 for the last chunk), folds c_w = c, then
//      c = fmaf(prod_w, c, e_w) from the last warp to the first -- the
//      fold rglru_scan.cu's carry launch makes forwards -- and publishes
//      the result, chunk k - 1's carry-in;
//   4. each warp re-scans its steps from c_w out of shared memory, writing
//      dx_in and dlog_a.
// Four warps a block, 64 KB of shared memory: three blocks, twelve warps,
// on an SM, where one warp a chunk would leave three to run the
// step-by-step chain.
// Blocks take chunks from the last to the first by a ticket: an atomic
// counter decides only which block takes which (chunk, row, channels), and
// no value is summed by an atomic. A block waits only on the block of the
// chunk after its own, whose ticket is smaller: that block took its ticket,
// so it runs or has run, and it waits on nothing later. So the wait cannot
// deadlock, whatever the card keeps resident. Each carry is one 64-bit word
// of the wrapper's scratch, the call's epoch in its high half and the value
// in its low half, so a word of an earlier call never reads as this one's
// and the scratch needs no reset launch; the counter's base (the tickets of
// earlier calls) comes from the wrapper too. The carries fold in a fixed
// order and every thread walks its steps in one order, so a launch repeats
// bit for bit, and a batch row's gradient depends only on that row's
// inputs: an LFLR replay is bit-exact.
//
// 1 - a^2 is formed from a rounded square (__fmul_rn), as the plain version
// forms it: near a = 1 the difference cancels, and a fused multiply-add
// there would move s, and so a / s, by far more than an ulp.
//
// Bound on the H100: the function reads 16 bytes per element (x_in, log_a,
// h, dh) and writes 8 (dx_in, dlog_a), about twenty operations each --
// memory-bound, 24 B S W bytes at 3.35 TB/s; this design moves that, plus
// one h row per chunk and the carries (8 bytes per chunk and channel).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kLanes = 32;         // channels per block
constexpr int kWarps = 4;          // stretches of a chunk, one per warp
constexpr int kT = 128;            // the chunk (ops.py::CHUNK)
constexpr int kSub = kT / kWarps;  // a warp's steps

struct Smem {
  float a[kT][kLanes];             // log_a, then a = exp(log_a)
  float dh[kT][kLanes];
  float x[kT][kLanes];             // x_in
  float hp[kT][kLanes];            // h_{t-1}
  float prod[kWarps][kLanes];      // each stretch's decay product,
  float e[kWarps][kLanes];         // carry-out from a zero carry-in,
  float cin[kWarps][kLanes];       // and carry-in
  unsigned long long ticket;
};

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ unsigned long long load_word(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_word(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

// rows [j0, j1) of one (B, S, W) input (src at the block's (b, t0, first
// channel)) into dst's rows; rows whose step t0 + j - shift is below 0 and
// channels past W are zeros. vec: 16-byte copies (W % 4 == 0, aligned)
__device__ __forceinline__ void stage(float (*dst)[kLanes], const float* src, int j0, int j1,
                                      long long W, long long ch0, long long t0, int shift,
                                      bool vec, int lane) {
  if (vec) {
    for (int e = lane; e < (j1 - j0) * 8; e += kLanes) {
      const int j = j0 + e / 8, q = 4 * (e % 8);
      const bool ok = ch0 + q < W && t0 + j - shift >= 0;
      cp_async(&dst[j][q], ok ? src + (j - shift) * W + q : src, 16, ok);
    }
  } else {
    for (int j = j0; j < j1; ++j) {
      const bool ok = ch0 + lane < W && t0 + j - shift >= 0;
      cp_async(&dst[j][lane], ok ? src + (j - shift) * W + lane : src, 4, ok);
    }
  }
}

__global__ void __launch_bounds__(kLanes * kWarps)
rglru_bwd_kernel(const float* __restrict__ x_in, const float* __restrict__ log_a,
                 const float* __restrict__ h, const float* __restrict__ dh,
                 float* __restrict__ dx_in, float* __restrict__ dlog_a,
                 unsigned long long* __restrict__ hand, long long B, long long S, long long W,
                 unsigned long long base, unsigned epoch, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  // the ticket: chunks from the last to the first, each over every (batch
  // row, 32 channels)
  if (threadIdx.x == 0) sm.ticket = atomicAdd(hand, 1ULL) - base;
  __syncthreads();
  const long long ticket = static_cast<long long>(sm.ticket);
  const long long nc = (S + kT - 1) / kT, wb = (W + kLanes - 1) / kLanes;
  const long long k = nc - 1 - ticket / (B * wb), rest = ticket % (B * wb);
  const long long b = rest / wb, ch0 = (rest % wb) * kLanes, c = ch0 + lane;
  const bool valid = c < W;
  const long long t0 = k * kT;
  const int n = static_cast<int>(min(S, t0 + kT) - t0);
  const int j0 = min(n, warp * kSub), j1 = min(n, j0 + kSub);   // the warp's steps
  const long long at = b * S * W + t0 * W + ch0;    // (b, t0, the block's channels)

  // ---- 1. stage: log_a and dh (group 0), x_in and h_{t-1} (group 1)
  stage(sm.a, log_a + at, j0, j1, W, ch0, t0, 0, vec, lane);
  stage(sm.dh, dh + at, j0, j1, W, ch0, t0, 0, vec, lane);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  stage(sm.x, x_in + at, j0, j1, W, ch0, t0, 0, vec, lane);
  stage(sm.hp, h + at, j0, j1, W, ch0, t0, 1, vec, lane);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncwarp();

  // ---- 2. the warp's steps from a zero carry: prod and e
  float prod = 1.f, g = 0.f;
#pragma unroll 8
  for (int j = j1 - 1; j >= j0; --j) {
    const float a = expf(sm.a[j][lane]);
    sm.a[j][lane] = a;
    const float d = sm.dh[j][lane] + g;
    prod *= a;
    g = a * d;
  }
  sm.prod[warp][lane] = prod;
  sm.e[warp][lane] = g;
  __syncthreads();

  // ---- 3. the hand-off (warp 0): the chunk's carry-in, each stretch's,
  //      then chunk k - 1's
  if (warp == 0 && valid) {
    unsigned long long* slot = hand + 1 + (b * nc + k) * W + c;   // chunk k's carry-in
    float cin = 0.f;
    if (k + 1 < nc) {
      unsigned long long v;
      do {
        v = load_word(slot);
      } while (static_cast<unsigned>(v >> 32) != epoch);
      cin = __uint_as_float(static_cast<unsigned>(v));
    }
#pragma unroll
    for (int w = kWarps - 1; w >= 0; --w) {
      sm.cin[w][lane] = cin;
      cin = fmaf(sm.prod[w][lane], cin, sm.e[w][lane]);
    }
    if (k > 0)
      store_word(slot - W, (static_cast<unsigned long long>(epoch) << 32) | __float_as_uint(cin));
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // ---- 4. the re-scan from the warp's carry-in
  if (!valid) return;
  g = sm.cin[warp][lane];
  float* dxp = dx_in + at + lane;
  float* dlp = dlog_a + at + lane;
#pragma unroll 8
  for (int j = j1 - 1; j >= j0; --j) {
    const float a = sm.a[j][lane];
    const float d = sm.dh[j][lane] + g;
    const float om = 1.f - __fmul_rn(a, a);
    const float s = sqrtf(fmaxf(om, 1e-12f));
    const float ds = om > 1e-12f ? -a / s : 0.f;            // d s / d a
    const float da = d * sm.hp[j][lane] + (d * sm.x[j][lane]) * ds;
    dxp[j * W] = d * s;
    dlp[j * W] = da * a;
    g = a * d;
  }
}

}  // namespace

// x_in, log_a, h, dh, dx_in, dlog_a: contiguous fp32 (B, S, W) on one
// device; hand: the wrapper's scratch of 1 + B nc W 64-bit words, nc =
// ceil(S / T) (word 0 the ticket counter, at `base` before this call; the
// rest carries, none of them holding `epoch`). The Python wrapper has
// checked shapes, types, devices and contiguity; T must be the kernel's
// chunk, 128.
extern "C" int repro_rglru_scan_bwd(const void* x_in, const void* log_a, const void* h,
                                    const void* dh, void* dx_in, void* dlog_a, void* hand,
                                    long long B, long long S, long long W, long long T,
                                    unsigned long long base, unsigned epoch, void* stream) {
  if (B < 1 || S < 1 || W < 1 || T != kT || epoch == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (S + kT - 1) / kT * B * ((W + kLanes - 1) / kLanes);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        rglru_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(Smem)));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const auto aligned = [](const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; };
  const bool vec = W % 4 == 0 && aligned(x_in) && aligned(log_a) && aligned(h) && aligned(dh);
  rglru_bwd_kernel<<<static_cast<unsigned>(blocks), kLanes * kWarps, sizeof(Smem),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x_in), static_cast<const float*>(log_a),
      static_cast<const float*>(h), static_cast<const float*>(dh),
      static_cast<float*>(dx_in), static_cast<float*>(dlog_a),
      static_cast<unsigned long long*>(hand), B, S, W, base, epoch, vec);
  return static_cast<int>(cudaGetLastError());
}
