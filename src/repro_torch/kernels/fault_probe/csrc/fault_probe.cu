// Fault probe for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/fault_probe/kernel.py:44 probe_rows
// (pallas_call at :53, body _probe_kernel at :29): one pass over a float
// stream down to an error word — any non-finite value sets nonfinite_code,
// any finite value with |x| > threshold sets overflow_code (non-finite values
// never count toward the threshold test).
//
// The TPU kernel folds a whole (rows, 128) stream into ONE word by carrying
// it across its sequential grid. Hopper blocks run in no order, so this
// kernel takes x (R, N) and returns one word PER ROW: grid (blocks, R),
// grid-stride loads along the row, a block-level __syncthreads_or per flag,
// and one atomicOr per block into the row's zeroed word. OR is idempotent
// and commutative, so the word is exact whatever order the blocks finish in.
// With R = 1 it is the TPU kernel's word over the flattened stream; the
// serving step calls it on the (slots, vocab) fp32 logits, one word per slot.
//
// Bound on the H100: it reads each element once (R * N * 4 bytes in fp32)
// and does a handful of operations per element, so it is memory-bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocksPerRow = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void probe_rows_kernel(const T* __restrict__ x, int N, float threshold,
                                  int nonfinite_code, int overflow_code,
                                  int* __restrict__ out) {
  const int row = blockIdx.y;
  const T* xr = x + static_cast<long long>(row) * N;
  int nonfinite = 0, over = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < N; i += gridDim.x * blockDim.x) {
    const float val = to_f32(xr[i]);
    if (!isfinite(val))
      nonfinite = 1;
    else if (fabsf(val) > threshold)
      over = 1;
  }
  nonfinite = __syncthreads_or(nonfinite);
  over = __syncthreads_or(over);
  if (threadIdx.x == 0) {
    const int word = (nonfinite ? nonfinite_code : 0) | (over ? overflow_code : 0);
    if (word) atomicOr(out + row, word);
  }
}

template <typename T>
int launch(const void* x, int rows, int cols, float threshold, int nonfinite_code,
           int overflow_code, int* out, cudaStream_t stream) {
  const int blocks = max(1, min(kMaxBlocksPerRow, (cols + kThreads - 1) / kThreads));
  probe_rows_kernel<T><<<dim3(blocks, rows), kThreads, 0, stream>>>(
      static_cast<const T*>(x), cols, threshold, nonfinite_code, overflow_code, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `out` is a zeroed int32 array of `rows`
// words; the wrapper has checked shapes, types, devices and contiguity.
extern "C" int repro_probe_rows(const void* x, int rows, int cols, int dtype,
                                float threshold, int nonfinite_code, int overflow_code,
                                void* out, void* stream) {
  int* o = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, rows, cols, threshold, nonfinite_code, overflow_code, o, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, rows, cols, threshold, nonfinite_code, overflow_code, o, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
