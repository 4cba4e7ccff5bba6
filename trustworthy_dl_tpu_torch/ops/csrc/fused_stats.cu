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
// allocates the scratch and the output with torch.empty) and returns
// cudaGetLastError().
//
// What bounds it on this card: bytes.  Each element is read once and costs
// nine f32 operations, far under the ~20 flop/byte ridge of the CUDA cores;
// the gradient batteries of one GPT-2-small step read 4 nodes x 124.4M f32
// = 1.99 GB, ~0.59 ms at 3.35 TB/s.  The design:
//   * one launch a call.  The segments' pointers, their chunk prefix sums
//     and the length of each one's last chunk ride in the kernel's
//     parameter block (no host-to-device copy, no sync): 16 bytes a
//     segment, MAX_SEGMENTS (2,000) in a 32 KB block (CUDA 12.1's large
//     kernel parameters);
//   * the segments are cut into fixed chunks of `chunk` elements (an empty
//     segment is one chunk of none); one CTA per chunk finds its segment by
//     binary search over the prefix sums, streams the chunk in 16-byte
//     loads (a segment that starts off a 16-byte boundary peels up to
//     three elements first), keeps the eight moments in f32 registers and
//     reduces them across the CTA by warp shuffles in a fixed order;
//   * a segment of one chunk is written to out by its CTA.  The CTAs of a
//     longer segment write one row of partials each and count themselves
//     on the segment's ticket (__threadfence, then an integer atomicInc);
//     the last to arrive folds the segment's rows in a fixed index order
//     into out.  The tickets sit after the partial rows in the call's own
//     scratch and are zeroed by one memset on the stream before the launch
//     (atomicInc's wrap also leaves each at 0 after its segment's last
//     arrival).  No float atomics: a given input gives the same bits on
//     every run, whichever CTA is last, and with them the same verdicts;
//   * min, max and max |x| take one FMNMX each (fminf / fmaxf, which drop a
//     NaN operand); the NaN comes back at the final store: sum x^2 is NaN
//     exactly when the segment holds a NaN (x^2 is >= 0 or +inf, and a sum
//     of such terms is never NaN), and then min, max and max |x| are NaN,
//     as jnp.min / jnp.max give.  An empty segment reports (0, 0, 0, 0,
//     +inf, -inf, 0, 0).
//
// TDDL_B1_DIAG, for utils/moments_ab's diagnostic variants (the port
// builds 0): 1 loads and xors the bits, 2 loads and sums x.  Both give
// wrong results; they say what the read stream alone costs.

#include <cuda_runtime.h>

#include <limits.h>
#include <math.h>
#include <stdint.h>

#ifndef TDDL_B1_DIAG
#define TDDL_B1_DIAG 0
#endif

namespace {

constexpr int MAX_SEGMENTS = 2000;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// The most parameter bytes a launch may take (CUDA 12.1 and later, sm_70+).
constexpr size_t PARAM_LIMIT = 32764;

// One launch's segment table, passed by value.
struct Table {
  const float* ptr[MAX_SEGMENTS];
  float* partials;        // [chunks, 8], then `count` tickets
  float* out;             // [count, 8]
  int first_chunk[MAX_SEGMENTS + 1];  // prefix sum of chunks per segment
  int tail[MAX_SEGMENTS];  // elements in the segment's last chunk
  int count;
  int chunk;
};
static_assert(sizeof(Table) <= PARAM_LIMIT,
              "the segment table must fit one launch's parameters");

struct Moments {
  float s1, s2, s3, s4, mn, mx, l1, linf;
};

__device__ __forceinline__ Moments empty_moments() {
  return Moments{0.f, 0.f, 0.f, 0.f, INFINITY, -INFINITY, 0.f, 0.f};
}

__device__ __forceinline__ void push(Moments& m, float x) {
#if TDDL_B1_DIAG == 1
  (void)m;
  (void)x;
#elif TDDL_B1_DIAG == 2
  m.s1 += x;
#else
  const float x2 = x * x;
  m.s1 += x;
  m.s2 += x2;
  m.s3 = fmaf(x2, x, m.s3);
  m.s4 = fmaf(x2, x2, m.s4);
  m.mn = fminf(m.mn, x);
  m.mx = fmaxf(m.mx, x);
  m.l1 += fabsf(x);
  m.linf = fmaxf(m.linf, fabsf(x));
#endif
}

__device__ __forceinline__ void push4(Moments& m, const float4& v) {
#if TDDL_B1_DIAG == 1
  // Two 3-input XORs keep the load live.
  m.s1 = __uint_as_float(__float_as_uint(m.s1) ^ __float_as_uint(v.x) ^
                         __float_as_uint(v.y) ^ __float_as_uint(v.z) ^
                         __float_as_uint(v.w));
#else
  push(m, v.x);
  push(m, v.y);
  push(m, v.z);
  push(m, v.w);
#endif
}

// NaN-dropping merge; the final store puts NaN back (see the note above).
__device__ __forceinline__ Moments merge(const Moments& a, const Moments& b) {
  return Moments{a.s1 + b.s1, a.s2 + b.s2, a.s3 + b.s3, a.s4 + b.s4,
                 fminf(a.mn, b.mn), fmaxf(a.mx, b.mx), a.l1 + b.l1,
                 fmaxf(a.linf, b.linf)};
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

// CTA-wide merge in a fixed order; the result is valid in thread 0.  The
// caller puts a barrier between two calls (warp 0 reads warp_acc last).
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

__device__ __forceinline__ void store_row(float* row, const Moments& m) {
  reinterpret_cast<float4*>(row)[0] = make_float4(m.s1, m.s2, m.s3, m.s4);
  reinterpret_cast<float4*>(row)[1] = make_float4(m.mn, m.mx, m.l1, m.linf);
}

__device__ __forceinline__ Moments load_row(const float* row) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(row));
  const float4 b = __ldcg(reinterpret_cast<const float4*>(row) + 1);
  return Moments{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
}

// A segment's row: its extrema are NaN where it holds a NaN.
__device__ __forceinline__ void store_final(float* row, Moments m) {
  if (isnan(m.s2)) m.mn = m.mx = m.linf = NAN;
  store_row(row, m);
}

// This thread's moments of the chunk x[0, n): a scalar head up to the
// first 16-byte boundary, the float4s, then a scalar tail.  The order
// depends on n and the address only.
__device__ __forceinline__ Moments chunk_moments(const float* __restrict__ x,
                                                 int n) {
  Moments m = empty_moments();
  const int head = min(
      n, (int)(((16u - (unsigned)(reinterpret_cast<uintptr_t>(x) & 15u)) &
                15u) >> 2));
  if ((int)threadIdx.x < head) push(m, x[threadIdx.x]);
  const float4* x4 = reinterpret_cast<const float4*>(x + head);
  const int n4 = (n - head) >> 2;
  for (int i = threadIdx.x; i < n4; i += THREADS) push4(m, x4[i]);
  for (int j = head + 4 * n4 + threadIdx.x; j < n; j += THREADS)
    push(m, x[j]);
  return m;
}

__global__ void __launch_bounds__(THREADS)
    moments_kernel(const __grid_constant__ Table t) {
  const int c = blockIdx.x;
  // The segment s with first_chunk[s] <= c < first_chunk[s + 1] (every
  // segment has at least one chunk, so the sums rise strictly).
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first_chunk[mid] <= c) lo = mid; else hi = mid - 1;
  }
  const int s = lo;
  const int c0 = t.first_chunk[s];
  const int c1 = t.first_chunk[s + 1];
  const int n = c + 1 < c1 ? t.chunk : t.tail[s];
  Moments m = chunk_moments(t.ptr[s] + (size_t)(c - c0) * t.chunk, n);
  m = block_merge(m);
  if (c1 - c0 == 1) {
    if (threadIdx.x == 0) store_final(t.out + (size_t)s * 8, m);
    return;
  }

  // Thread 0 stores the CTA's row, fences it and counts the CTA; the CTA
  // whose count closes the segment folds its rows.
  unsigned int* tickets = reinterpret_cast<unsigned int*>(
      t.partials + (size_t)8 * t.first_chunk[t.count]);
  bool last = false;
  if (threadIdx.x == 0) {
    store_row(t.partials + (size_t)c * 8, m);
    __threadfence();
    const unsigned int k = (unsigned int)(c1 - c0) - 1u;
    last = atomicInc(tickets + s, k) == k;
  }
  if (!__syncthreads_or(last)) return;
  __threadfence();
  Moments f = empty_moments();
  for (int r = c0 + threadIdx.x; r < c1; r += THREADS)
    f = merge(f, load_row(t.partials + (size_t)r * 8));
  f = block_merge(f);
  if (threadIdx.x == 0) store_final(t.out + (size_t)s * 8, f);
}

}  // namespace

extern "C" {

// B1: `count` f32 segments (device pointers, lengths) -> out [count, 8].
// `scratch` holds sum(max(1, ceil(len / chunk))) rows of 8 floats, then
// `count` 4-byte tickets; 16-byte aligned.
int tddl_fused_moments(const void* const* ptrs, const long long* lens,
                       int count, long long chunk, void* scratch, void* out,
                       void* stream) {
  if (count < 1 || count > MAX_SEGMENTS || chunk < 4 || chunk % 4 != 0 ||
      chunk > INT_MAX)
    return (int)cudaErrorInvalidValue;
  Table t;
  t.partials = static_cast<float*>(scratch);
  t.out = static_cast<float*>(out);
  t.count = count;
  t.chunk = (int)chunk;
  long long chunks = 0;
  bool multi = false;
  for (int s = 0; s < count; ++s) {
    const long long n = lens[s];
    if (n < 0) return (int)cudaErrorInvalidValue;
    const long long k = n > 0 ? (n + chunk - 1) / chunk : 1;
    t.ptr[s] = static_cast<const float*>(ptrs[s]);
    t.first_chunk[s] = (int)chunks;
    t.tail[s] = (int)(n - (k - 1) * chunk);
    multi = multi || k > 1;
    chunks += k;
    if (chunks > INT_MAX) return (int)cudaErrorInvalidValue;
  }
  t.first_chunk[count] = (int)chunks;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (multi) {
    const cudaError_t err = cudaMemsetAsync(
        t.partials + (size_t)8 * chunks, 0, sizeof(unsigned int) * count, st);
    if (err != cudaSuccess) return (int)err;
  }
  moments_kernel<<<(unsigned)chunks, THREADS, 0, st>>>(t);
  return (int)cudaGetLastError();
}

const char* tddl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
