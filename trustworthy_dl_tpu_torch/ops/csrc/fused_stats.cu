// Detector moment battery for Hopper (sm_90a): B1.
//
// Replaces trustworthy_dl_tpu/ops/fused_stats.py:_moments_kernel (pallas_call
// in _fused_tile_moments_impl).  For every f32 segment of a list (every
// gradient leaf of every node, or every node's monitored features) it
// returns the eight raw moments of the detector battery in one read of the
// data: (sum x, sum x^2, sum x^3, sum x^4, min, max, sum |x|, max |x|).
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (trustworthy_dl_tpu_torch/ops/__init__.py).  The entry point
// launches on the caller's stream, allocates nothing (the Python wrapper
// allocates the partials scratch and the output with torch.empty) and
// returns cudaGetLastError().
//
// What bounds it on this card: bytes.  Each element is read once and costs
// about a dozen f32 operations, far under the ~20 flop/byte ridge of the
// CUDA cores; the gradient batteries of one GPT-2-small step read
// 4 nodes x 124.4M f32 = 1.99 GB, ~0.59 ms at 3.35 TB/s.  The design:
//   * the segments' pointers and lengths ride in the kernel's parameter
//     block (no host-to-device copy, no sync), at most MAX_SEGMENTS a launch;
//   * pass 1: the segments are cut into fixed chunks of `chunk` elements;
//     one CTA per chunk streams it with 16-byte loads (scalar loads for a
//     misaligned segment and the ragged tail), keeps the eight moments in
//     f32 registers per thread, and reduces them across the CTA by warp
//     shuffles into one row of partials [chunks, 8];
//   * pass 2: one CTA per segment folds that segment's chunk rows in a
//     fixed tree order into out [segments, 8].
// There are no float atomics, so a given input gives the same bits on
// every run, and with them the same verdicts.  min/max propagate NaN like
// jnp.min/jnp.max; an empty segment reports (0, 0, 0, 0, +inf, -inf, 0, 0).

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

// 128 segments keep the parameter block (~2.6 KB) under the classic 4 KB
// kernel-parameter limit.
constexpr int MAX_SEGMENTS = 128;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

struct Segments {
  const float* ptr[MAX_SEGMENTS];
  long long len[MAX_SEGMENTS];
  int first_chunk[MAX_SEGMENTS + 1];  // prefix sum of chunks per segment
  int count;
};

struct Moments {
  float s1, s2, s3, s4, mn, mx, l1, linf;
};

// NaN-propagating min/max (fminf/fmaxf would drop a NaN operand).
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

__device__ __forceinline__ Moments empty_moments() {
  return Moments{0.f, 0.f, 0.f, 0.f, INFINITY, -INFINITY, 0.f, 0.f};
}

__device__ __forceinline__ void push(Moments& m, float x) {
  const float x2 = x * x;
  m.s1 += x;
  m.s2 += x2;
  m.s3 += x2 * x;
  m.s4 += x2 * x2;
  m.mn = nan_min(m.mn, x);
  m.mx = nan_max(m.mx, x);
  m.l1 += fabsf(x);
  m.linf = nan_max(m.linf, fabsf(x));
}

__device__ __forceinline__ Moments merge(const Moments& a, const Moments& b) {
  return Moments{a.s1 + b.s1, a.s2 + b.s2, a.s3 + b.s3, a.s4 + b.s4,
                 nan_min(a.mn, b.mn), nan_max(a.mx, b.mx), a.l1 + b.l1,
                 nan_max(a.linf, b.linf)};
}

__device__ __forceinline__ Moments warp_merge(Moments m) {
  for (int off = 16; off > 0; off >>= 1) {
    Moments o;
    o.s1 = __shfl_xor_sync(0xffffffffu, m.s1, off);
    o.s2 = __shfl_xor_sync(0xffffffffu, m.s2, off);
    o.s3 = __shfl_xor_sync(0xffffffffu, m.s3, off);
    o.s4 = __shfl_xor_sync(0xffffffffu, m.s4, off);
    o.mn = __shfl_xor_sync(0xffffffffu, m.mn, off);
    o.mx = __shfl_xor_sync(0xffffffffu, m.mx, off);
    o.l1 = __shfl_xor_sync(0xffffffffu, m.l1, off);
    o.linf = __shfl_xor_sync(0xffffffffu, m.linf, off);
    m = merge(m, o);
  }
  return m;
}

// CTA-wide merge in a fixed order; the result is valid in thread 0.
__device__ __forceinline__ Moments block_merge(Moments m) {
  __shared__ Moments warp_acc[WARPS];
  m = warp_merge(m);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_acc[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < WARPS ? warp_acc[lane] : empty_moments();
    m = warp_merge(m);
  }
  return m;
}

__device__ __forceinline__ void store(float* row, const Moments& m) {
  row[0] = m.s1;
  row[1] = m.s2;
  row[2] = m.s3;
  row[3] = m.s4;
  row[4] = m.mn;
  row[5] = m.mx;
  row[6] = m.l1;
  row[7] = m.linf;
}

// Pass 1: one CTA per chunk -> one row of partials.
__global__ void __launch_bounds__(THREADS)
    moments_chunk_kernel(const Segments segs, long long chunk,
                         float* __restrict__ partials) {
  const int c = blockIdx.x;
  int s = 0;
  while (s + 1 < segs.count && segs.first_chunk[s + 1] <= c) ++s;
  const long long start = (long long)(c - segs.first_chunk[s]) * chunk;
  const long long n = min(chunk, segs.len[s] - start);
  const float* x = segs.ptr[s] + start;

  Moments m = empty_moments();
  long long done = 0;
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const long long n4 = n / 4;
    for (long long i = threadIdx.x; i < n4; i += THREADS) {
      const float4 v = x4[i];
      push(m, v.x);
      push(m, v.y);
      push(m, v.z);
      push(m, v.w);
    }
    done = n4 * 4;
  }
  for (long long i = done + threadIdx.x; i < n; i += THREADS) push(m, x[i]);

  m = block_merge(m);
  if (threadIdx.x == 0) store(partials + (size_t)c * 8, m);
}

// Pass 2: one CTA per segment folds its chunks' rows.
__global__ void __launch_bounds__(THREADS)
    moments_combine_kernel(const Segments segs,
                           const float* __restrict__ partials,
                           float* __restrict__ out) {
  const int s = blockIdx.x;
  const int c0 = segs.first_chunk[s];
  const int c1 = segs.first_chunk[s + 1];
  Moments m = empty_moments();
  for (int c = c0 + threadIdx.x; c < c1; c += THREADS) {
    const float* r = partials + (size_t)c * 8;
    m = merge(m, Moments{r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7]});
  }
  m = block_merge(m);
  if (threadIdx.x == 0) store(out + (size_t)s * 8, m);
}

}  // namespace

extern "C" {

// B1: `count` f32 segments (device pointers, lengths) -> out [count, 8].
// `partials` holds sum(ceil(len / chunk)) rows of 8 floats.
int tddl_fused_moments(const void* const* ptrs, const long long* lens,
                       int count, long long chunk, void* partials, void* out,
                       void* stream) {
  if (count < 1 || count > MAX_SEGMENTS || chunk < 4 || chunk % 4 != 0)
    return (int)cudaErrorInvalidValue;
  Segments segs;
  segs.count = count;
  long long chunks = 0;
  for (int s = 0; s < count; ++s) {
    if (lens[s] < 0) return (int)cudaErrorInvalidValue;
    segs.ptr[s] = static_cast<const float*>(ptrs[s]);
    segs.len[s] = lens[s];
    segs.first_chunk[s] = (int)chunks;
    chunks += (lens[s] + chunk - 1) / chunk;
  }
  if (chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  segs.first_chunk[count] = (int)chunks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunks > 0) {
    moments_chunk_kernel<<<(unsigned)chunks, THREADS, 0, s>>>(
        segs, chunk, static_cast<float*>(partials));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  moments_combine_kernel<<<count, THREADS, 0, s>>>(
      segs, static_cast<const float*>(partials), static_cast<float*>(out));
  return (int)cudaGetLastError();
}

const char* tddl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
