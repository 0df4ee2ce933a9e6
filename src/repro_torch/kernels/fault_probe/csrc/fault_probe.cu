// Fault probe for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/fault_probe/kernel.py:44 probe_rows
// (pallas_call at :53, body _probe_kernel at :29): one pass over a float
// stream down to an error word — any non-finite value sets nonfinite_code,
// any finite value with |x| > threshold sets overflow_code. As in the TPU
// kernel, a non-finite value counts as 0 in the threshold test (so with a
// negative threshold every element sets overflow_code), and the test is in
// fp32: a bf16 value widens exactly, the threshold is an fp32 value.
//
// One kernel reads SEGMENTS: a pointer, an element count, a dtype (fp32 or
// bf16) and the index of the output word it ORs into. Two entry points feed
// it:
//   repro_probe_rows  the R rows of one contiguous (R, N) tensor, word r per
//                     row (the serving step's (slots, vocab) logits, the
//                     recurrent state viewed (slots, rest), the prefill
//                     step's (B * S, vocab) logits). The rows are described
//                     by (R, N), not listed: the prefill logits have 8192.
//   repro_probe_tree  a table of up to kMaxLeaves leaves, all folded into
//                     word 0 (the train step's whole gradient tree: 310
//                     leaves of full-width qwen3-1.7b in one launch).
//
// Bound on the H100: it reads each element once and writes one word per
// row, so it is bound by bytes: (elements x 2 or 4 bytes) / 3.35 TB/s, 1.03
// ms for qwen3-1.7b's 1.72 G bf16 gradient elements. What the design does
// about it:
//   * 16-byte vector loads, kVecsPerThread of them issued before any is
//     tested: a thread has 128 bytes in flight, an SM (at the occupancy
//     ptxas allows) over 100 KB, far past the ~20 KB an SM needs to cover
//     HBM's latency at its share of 3.35 TB/s.
//   * The flat space of all segments is cut into chunks of kChunkBytes
//     (32 KB: one load per thread per vector slot). The grid is sized to
//     the card (SMs x resident blocks), not to a row, and blocks walk the
//     chunks with a grid stride, so one 311 M-element leaf and 300 leaves
//     of 2048 share the card alike. A block finds a chunk's segment from
//     the prefix sum of chunk counts in the table: a binary search over a
//     block-uniform index, read from the parameter (constant) bank.
//   * Alignment: a view's data pointer, or a row of odd length, need not be
//     16-byte aligned. Each segment's first elements up to the 16-byte
//     boundary (its head) are read as scalars by its first chunk, and the
//     elements after its last whole vector (its tail) by its last chunk;
//     nothing is read past a segment's end.
//   * The test is integer work on the fp32 bit pattern in registers: an
//     element is non-finite iff its exponent bits are all ones, and for
//     finite non-negative floats the order of the bit patterns is the order
//     of the values (subnormals included, so none is flushed), so
//     |x| > threshold is one integer compare against `lim` (see below).
//   * Fold: each thread ORs its flags, a block folds them with
//     __syncthreads_or when the word it writes changes (once at the end for
//     the tree), and one atomicOr per block and word writes a nonzero word.
//     OR is order-free, so the words are bit-exact whatever order the
//     blocks finish in (and LFLR replays stay bit-exact).
//   * No fill launch: the entry points zero their own output words with
//     cudaMemsetAsync on the stream before the kernel, and keep no scratch
//     across calls (a serve group's rank threads launch concurrently).
//   * The tree's table is passed by value as a __grid_constant__ kernel
//     parameter (CUDA 12.1+ allows 32764 bytes): kMaxLeaves = 1024 leaves,
//     25,600 bytes of table (pointer, count and chunk end, 24 bytes each,
//     and a one-byte dtype) plus a 16-byte header. No copy from the host
//     to the device, no sync. A tree with more leaves is cut by the wrapper
//     into several launches into the same word (the first one zeroes it).
//   * Indexing is 64-bit: a segment may hold more than 2^31 elements.
//
// Build: no --use_fast_math and no -ftz (the integer test would not care,
// but nothing here may flush a subnormal). `nvcc -Xptxas -v` for sm_90a
// (CUDA 12.8, chip_smoke.py's ptxas line): 80 registers, no stack, no
// spills, in both instantiations, with __launch_bounds__(256, 3); with
// (256) alone the tree's took 64 registers and spilled 4 bytes.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecsPerThread = 8;                        // 16-byte loads in flight
constexpr int kChunkVecs = kThreads * kVecsPerThread;   // 2048 vectors
constexpr long long kChunkBytes = kChunkVecs * 16LL;    // 32 KB a chunk
constexpr int kMaxLeaves = 1024;
constexpr int kMinBlocksPerSm = 3;                     // <= 85 registers a thread
constexpr int kFallbackGrid = 132 * 4;

// A chunk's segment, as the kernel sees it.
struct Seg {
  const char* ptr;       // first element
  long long n;           // elements
  long long k;           // the chunk's index within the segment
  long long nchunks;     // the segment's chunks
  long long word;        // output word
  int esize;             // 4 (fp32) or 2 (bf16)
};

// The rows of one (rows, cols) tensor: chunk c is chunk c % per_row of row
// c / per_row. per_row = max(1, ceil(cols / elements per chunk)) covers the
// chunks of any row whatever its head, so a row's last chunk may hold no
// whole vector (only its tail).
struct RowTable {
  const char* x;
  long long cols;
  long long per_row;
  long long chunks;
  int esize;

  __device__ Seg locate(long long c) const {
    const long long row = c / per_row;
    return {x + row * cols * esize, cols, c - row * per_row, per_row, row, esize};
  }
};

// Up to kMaxLeaves leaves into word 0: chunk_end is the inclusive prefix
// sum of the leaves' chunk counts (the wrapper's plan), so leaf s holds
// chunks [chunk_end[s - 1], chunk_end[s]).
struct TreeTable {
  long long chunks;
  int leaves;
  int pad;
  const void* ptr[kMaxLeaves];
  long long count[kMaxLeaves];
  long long chunk_end[kMaxLeaves];
  unsigned char dtype[kMaxLeaves];

  __device__ Seg locate(long long c) const {
    int lo = 0, hi = leaves - 1;             // first s with chunk_end[s] > c
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (chunk_end[mid] > c) hi = mid; else lo = mid + 1;
    }
    const long long begin = lo ? chunk_end[lo - 1] : 0;
    return {static_cast<const char*>(ptr[lo]), count[lo], c - begin,
            chunk_end[lo] - begin, 0, dtype[lo] ? 2 : 4};
  }
};
static_assert(sizeof(TreeTable) <= 32764, "kernel parameters stop at 32764 bytes");

// One fp32 bit pattern (a bf16 one shifted up 16 bits). lim encodes the
// threshold (lim_of): over iff the value, taken as 0 when non-finite, has
// |x| > threshold.
__device__ __forceinline__ void test_bits(uint32_t u, int lim, int& nf, int& ov) {
  const uint32_t a = u & 0x7fffffffu;
  const bool bad = a >= 0x7f800000u;        // exponent all ones: NaN or ±inf
  nf |= bad;
  ov |= static_cast<int>(bad ? 0u : a) > lim;
}

__device__ __forceinline__ void test_vec(const uint4& v, int esize, int lim, int& nf,
                                         int& ov) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  if (esize == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) test_bits(w[i], lim, nf, ov);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      test_bits(w[i] << 16, lim, nf, ov);
      test_bits(w[i] & 0xffff0000u, lim, nf, ov);
    }
  }
}

__device__ __forceinline__ uint32_t scalar_bits(const char* p, long long i, int esize) {
  if (esize == 4) return __ldg(reinterpret_cast<const uint32_t*>(p) + i);
  return static_cast<uint32_t>(__ldg(reinterpret_cast<const unsigned short*>(p) + i)) << 16;
}

// Chunk s.k of a segment: its whole vectors, and its head (first chunk)
// and tail (last chunk) as scalars.
__device__ __forceinline__ void probe_chunk(const Seg& s, int lim, int& nf, int& ov) {
  const int per_vec = 16 / s.esize;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(s.ptr);
  long long head = static_cast<long long>((16 - (addr & 15)) & 15) / s.esize;
  if (head > s.n) head = s.n;
  const long long nvec = (s.n - head) / per_vec;
  const uint4* vec = reinterpret_cast<const uint4*>(s.ptr + head * s.esize);
  const long long v0 = s.k * kChunkVecs + threadIdx.x;
  uint4 buf[kVecsPerThread];
#pragma unroll
  for (int j = 0; j < kVecsPerThread; ++j) {
    const long long i = v0 + static_cast<long long>(j) * kThreads;
    if (i < nvec) buf[j] = __ldg(vec + i);
  }
#pragma unroll
  for (int j = 0; j < kVecsPerThread; ++j) {
    const long long i = v0 + static_cast<long long>(j) * kThreads;
    if (i < nvec) test_vec(buf[j], s.esize, lim, nf, ov);
  }
  if (s.k == 0 && threadIdx.x < head) test_bits(scalar_bits(s.ptr, threadIdx.x, s.esize), lim, nf, ov);
  if (s.k == s.nchunks - 1) {
    const long long t = head + nvec * per_vec + threadIdx.x;
    if (t < s.n) test_bits(scalar_bits(s.ptr, t, s.esize), lim, nf, ov);
  }
}

// Block fold of the flags into word `word` (block-uniform; -1: none yet).
__device__ __forceinline__ void flush(long long word, int nonfinite_code, int overflow_code,
                                      int& nf, int& ov, int* __restrict__ out) {
  nf = __syncthreads_or(nf);
  ov = __syncthreads_or(ov);
  if (threadIdx.x == 0 && word >= 0) {
    const int w = (nf ? nonfinite_code : 0) | (ov ? overflow_code : 0);
    if (w) atomicOr(out + word, w);
  }
  nf = ov = 0;
}

template <class Table>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
probe_kernel(const __grid_constant__ Table t, int lim, int nonfinite_code,
             int overflow_code, int* __restrict__ out) {
  int nf = 0, ov = 0;
  long long word = -1;
  for (long long c = blockIdx.x; c < t.chunks; c += gridDim.x) {
    const Seg s = t.locate(c);
    if (s.word != word) {
      flush(word, nonfinite_code, overflow_code, nf, ov, out);
      word = s.word;
    }
    probe_chunk(s, lim, nf, ov);
  }
  flush(word, nonfinite_code, overflow_code, nf, ov, out);
}

// The threshold as an int against a finite |x|'s bit pattern (taken as a
// signed int, non-finite values as 0): a negative threshold -> -1 (every
// element is over, as 0 > threshold); NaN -> INT_MAX (none is); otherwise
// the bits of |threshold| (-0.0 as +0).
int lim_of(float threshold) {
  if (isnan(threshold)) return 0x7fffffff;
  if (threshold < 0.0f) return -1;
  const float a = fabsf(threshold);
  int bits;
  memcpy(&bits, &a, sizeof bits);
  return bits;
}

// SMs x resident blocks of this kernel on the current device, once per
// instantiation (a process drives one card).
template <class Table>
int grid_cap() {
  static const int cap = [] {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, probe_kernel<Table>,
                                                      kThreads, 0) != cudaSuccess ||
        sms * per_sm <= 0) {
      cudaGetLastError();
      return kFallbackGrid;
    }
    return sms * per_sm;
  }();
  return cap;
}

template <class Table>
int launch(const Table& t, float threshold, int nonfinite_code, int overflow_code, int* out,
           cudaStream_t stream) {
  const long long cap = grid_cap<Table>();
  const int blocks = static_cast<int>(t.chunks < cap ? t.chunks : cap);
  probe_kernel<Table><<<blocks, kThreads, 0, stream>>>(t, lim_of(threshold), nonfinite_code,
                                                        overflow_code, out);
  return static_cast<int>(cudaGetLastError());
}

int esize_of(int dtype) { return dtype == 0 ? 4 : dtype == 1 ? 2 : 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `out` holds `rows` int32 words, zeroed
// here on the stream (1 <= rows < 2^31, cols >= 1); the wrapper has checked
// shapes, types, devices and contiguity.
extern "C" int repro_probe_rows(const void* x, int rows, long long cols, int dtype,
                                float threshold, int nonfinite_code, int overflow_code,
                                void* out, void* stream) {
  const int esize = esize_of(dtype);
  if (!esize || rows < 1 || cols < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t rc = cudaMemsetAsync(out, 0, sizeof(int) * static_cast<size_t>(rows), st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long per_chunk = kChunkBytes / esize;
  RowTable t;
  t.x = static_cast<const char*>(x);
  t.cols = cols;
  t.per_row = (cols + per_chunk - 1) / per_chunk;
  t.chunks = rows * t.per_row;
  t.esize = esize;
  return launch(t, threshold, nonfinite_code, overflow_code, static_cast<int*>(out), st);
}

// One launch over `leaves` (1..kMaxLeaves) segments into the int32 word at
// `out`: ptrs, counts and chunk_ends are long long arrays, dtypes an int
// array, all on the host (the wrapper's plan: each count >= 1, chunk_ends
// the inclusive prefix sum of the leaves' chunk counts). `zero_out` zeroes
// the word on the stream first (the first launch of a tree).
extern "C" int repro_probe_tree(const void* ptrs, const void* counts, const void* dtypes,
                                const void* chunk_ends, int leaves, float threshold,
                                int nonfinite_code, int overflow_code, void* out,
                                int zero_out, void* stream) {
  if (leaves < 1 || leaves > kMaxLeaves) return static_cast<int>(cudaErrorInvalidValue);
  TreeTable t;
  const long long* p = static_cast<const long long*>(ptrs);
  const long long* n = static_cast<const long long*>(counts);
  const int* d = static_cast<const int*>(dtypes);
  const long long* e = static_cast<const long long*>(chunk_ends);
  long long prev = 0;
  for (int s = 0; s < leaves; ++s) {
    if (!esize_of(d[s]) || n[s] < 1 || e[s] <= prev)
      return static_cast<int>(cudaErrorInvalidValue);
    t.ptr[s] = reinterpret_cast<const void*>(p[s]);
    t.count[s] = n[s];
    t.chunk_end[s] = e[s];
    t.dtype[s] = static_cast<unsigned char>(d[s]);
    prev = e[s];
  }
  t.leaves = leaves;
  t.chunks = prev;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (zero_out) {
    const cudaError_t rc = cudaMemsetAsync(out, 0, sizeof(int), st);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return launch(t, threshold, nonfinite_code, overflow_code, static_cast<int*>(out), st);
}
