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
// kernel takes x (R, N) and returns one word PER ROW: grid (blocks, rows),
// grid-stride loads along the row, a block-level __syncthreads_or per flag,
// and one atomicOr per block into the row's zeroed word. OR is idempotent
// and commutative, so the word is exact whatever order the blocks finish in.
// With R = 1 it is the TPU kernel's word over the flattened stream; the
// serving step calls it on the (slots, vocab) fp32 logits and on the
// (slots, layers * width) recurrent state, one word per slot; the prefill
// step on the (B * S, vocab) logits.
//
// Indexing is 64-bit: element and stride arithmetic in long long, so a row
// may hold more than 2^31 elements. The grid's y extent stops at 65535, so
// blocks walk the rows with a stride of gridDim.y (block-uniform, so the
// __syncthreads_or stay convergent) and any row count is covered.
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

constexpr int kMaxGridY = 65535;

template <typename T>
__global__ void probe_rows_kernel(const T* __restrict__ x, int rows, long long N,
                                  float threshold, int nonfinite_code, int overflow_code,
                                  int* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const T* xr = x + static_cast<long long>(row) * N;
    int nonfinite = 0, over = 0;
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < N;
         i += stride) {
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
}

template <typename T>
int launch(const void* x, int rows, long long cols, float threshold, int nonfinite_code,
           int overflow_code, int* out, cudaStream_t stream) {
  const long long per_row = (cols + kThreads - 1) / kThreads;
  const int blocks = per_row < kMaxBlocksPerRow ? static_cast<int>(per_row) : kMaxBlocksPerRow;
  const int grid_y = rows < kMaxGridY ? rows : kMaxGridY;
  probe_rows_kernel<T><<<dim3(blocks, grid_y), kThreads, 0, stream>>>(
      static_cast<const T*>(x), rows, cols, threshold, nonfinite_code, overflow_code, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `out` is a zeroed int32 array of `rows`
// words (1 <= rows < 2^31, cols >= 1); the wrapper has checked shapes,
// types, devices and contiguity.
extern "C" int repro_probe_rows(const void* x, int rows, long long cols, int dtype,
                                float threshold, int nonfinite_code, int overflow_code,
                                void* out, void* stream) {
  int* o = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, rows, cols, threshold, nonfinite_code, overflow_code, o, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, rows, cols, threshold, nonfinite_code, overflow_code, o, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
