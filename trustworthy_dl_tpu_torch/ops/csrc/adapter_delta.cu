// Paged per-tenant low-rank adapter delta for Hopper (sm_90a): B9.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (trustworthy_dl_tpu_torch/ops/__init__.py).  The entry point
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError(), which the Python wrapper raises on.
//
// Replaces trustworthy_dl_tpu/ops/paged_attention.py:_adapter_delta_kernel
// (pallas_call in _adapter_delta_call).  For each row i of x [R, T, D] with
// p = pages[i]:
//     h   = (x[i] @ A[p]) * sa[p]          A[p] [D, r], f32 accumulation
//     out = (h @ B[p]) * sb[p]             B[p] [r, D], out f32 [R, T, D]
// The a_scale multiplies h between the two contractions, not the output:
// the JAX order, which keeps the f32 rounding of the plain twin.  A and B
// are one site of one layer of the adapter pool, [P+1, 2, D, r] per layer:
// the kernel takes the page stride and never needs a contiguous copy of
// the site (that copy would move every page on every layer of every tick,
// the gather this kernel exists to remove).  Pages are bf16, or int8
// widened on read with per-page f32 scales (sa/sb null: scale 1.0, a
// bitwise identity).
//
// What bounds it on this card: bytes, far below what it takes.  A decode
// launch (R = 8, T = 1, D = 768, r = 16) reads at most 8 distinct bf16
// pages of 2 x 24.6 KB and does 0.4 MFLOP: ~0.1 us of HBM time.  What it
// does take is on-chip latency (a short chain of dependent steps with little
// parallelism per step) and the launch itself, about the same with the
// L2 cold or warm.  The design keeps every intermediate on chip and
// spreads each step over as many threads as the shapes give:
//   * one CTA (8 warps) per (row, tile of 8 positions of T, 256 output
//     columns): each CTA computes the whole h of its tile, and each thread
//     one output column;
//   * the x tile is staged in shared memory as f32 and the row's A page
//     transposed and widened to f32 with a padded pitch (conflict-free
//     reads in the h loop), both by 16-byte vector loads (hence D % 16 ==
//     0 and 16-byte aligned pages), all of a thread's loads issued before
//     the first is used;
//   * h: one warp per position, lanes split D, r accumulators a lane,
//     butterfly shuffles to sum; h * sa goes to shared memory;
//   * out: each thread reads its B column once (coalesced across the CTA)
//     and produces every position of the tile; the sb scale multiplies
//     last.
// A ZERO page (all zeros) gives exactly +0.0, so adapterless rows add an
// exact zero.  CUDA cores only: r is tiny, no tensor-core tile pays here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int TT = 8;             // positions of T per CTA
constexpr int THREADS = 256;      // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int VEC = 8;            // bf16 per 16-byte x load
constexpr int UNROLL = 8;         // 16-byte loads in flight per thread

__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(int8_t v) { return (float)v; }

// One 16-byte vector of a pool page, widened to f32 and scattered into the
// transposed A stage: element e of the page is A[d][k] with e = d * r + k.
template <typename P>
__device__ __forceinline__ void scatter_a(const uint4& v, int e, int r,
                                          int dp, float* a_s) {
  constexpr int EPV = 16 / sizeof(P);
  const P* el = reinterpret_cast<const P*>(&v);
  int d = e / r;
  int k = e - d * r;
#pragma unroll
  for (int j = 0; j < EPV; ++j) {
    a_s[k * dp + d] = widen(el[j]);
    if (++k == r) {
      k = 0;
      ++d;
    }
  }
}

template <typename P, int RPAD>
__global__ void __launch_bounds__(THREADS) adapter_delta_kernel(
    const __nv_bfloat16* __restrict__ x, const P* __restrict__ a,
    const P* __restrict__ b, const float* __restrict__ sa,
    const float* __restrict__ sb, const int* __restrict__ pages,
    float* __restrict__ out, long long a_stride, long long b_stride,
    long long s_stride, int T, int D, int r, int num_pages) {
  constexpr int EPV = 16 / sizeof(P);   // page elements per 16-byte load
  extern __shared__ float smem[];
  const int dp = D + 1;                 // padded pitch of the A stage
  float* x_s = smem;                    // [TT][D]
  float* a_s = x_s + TT * D;            // [r][D + 1]: A transposed
  float* h_s = a_s + r * dp;            // [TT][RPAD]

  const int row = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int tn = min(TT, T - t0);
  const int tid = threadIdx.x;
  const int n = blockIdx.z * THREADS + tid;   // this thread's output column
  const int page = pages[row];
  float* o = out + ((size_t)row * T + t0) * D;
  if (page < 0 || page >= num_pages) {
    // The host validates every page row it builds; an index that gets
    // here anyway must not read outside the pool: NaN rows show it.
    for (int t = 0; t < tn && n < D; ++t)
      o[(size_t)t * D + n] = __int_as_float(0x7fc00000);
    return;
  }

  // Every load that needs only the page (the scales, the x tile, the A
  // page: up to 8 16-byte vectors of each a thread) goes out before any is
  // used.
  const float scale_a = sa != nullptr ? sa[(size_t)page * s_stride] : 1.f;
  const float scale_b = sb != nullptr ? sb[(size_t)page * s_stride] : 1.f;
  const uint4* xvec = reinterpret_cast<const uint4*>(
      x + ((size_t)row * T + t0) * D);
  const uint4* avec =
      reinterpret_cast<const uint4*>(a + (size_t)page * a_stride);
  const int nx = tn * D / VEC;
  const int na = D * r / EPV;
  for (int base = tid; base < max(nx, na); base += THREADS * UNROLL) {
    uint4 xr[UNROLL], ar[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + u * THREADS;
      if (i < nx) xr[u] = xvec[i];
      if (i < na) ar[u] = avec[i];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + u * THREADS;
      if (i < nx) {
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&xr[u]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) x_s[i * VEC + j] = __bfloat162float(e[j]);
      }
      if (i < na) scatter_a<P>(ar[u], i * EPV, r, dp, a_s);
    }
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int t = warp; t < tn; t += WARPS) {
    float acc[RPAD];
#pragma unroll
    for (int k = 0; k < RPAD; ++k) acc[k] = 0.f;
    const float* xt = x_s + t * D;
    for (int d = lane; d < D; d += 32) {
      const float xv = xt[d];
#pragma unroll
      for (int k = 0; k < RPAD; ++k)
        if (k < r) acc[k] = fmaf(xv, a_s[k * dp + d], acc[k]);
    }
#pragma unroll
    for (int k = 0; k < RPAD; ++k) {
      float v = acc[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0 && k < r) h_s[t * RPAD + k] = v * scale_a;
    }
  }
  __syncthreads();

  if (n >= D) return;
  const P* bp = b + (size_t)page * b_stride;
  float bcol[RPAD];
#pragma unroll
  for (int k = 0; k < RPAD; ++k)
    bcol[k] = k < r ? widen(bp[(size_t)k * D + n]) : 0.f;
  for (int t = 0; t < tn; ++t) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < RPAD; ++k)
      if (k < r) acc = fmaf(h_s[t * RPAD + k], bcol[k], acc);
    o[(size_t)t * D + n] = acc * scale_b;
  }
}

template <typename P, int RPAD>
int launch(const void* x, const void* a, const void* b, const void* sa,
           const void* sb, const void* pages, void* out, long long a_stride,
           long long b_stride, long long s_stride, int R, int T, int D, int r,
           int num_pages, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)TT * D + (size_t)r * (D + 1) + TT * RPAD);
  // Raised once per instance to the largest stage asked for so far.
  static size_t granted = 48 * 1024;
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        adapter_delta_kernel<P, RPAD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    granted = smem;
  }
  dim3 grid((T + TT - 1) / TT, R, (D + THREADS - 1) / THREADS);
  adapter_delta_kernel<P, RPAD><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const P*>(a),
      static_cast<const P*>(b), static_cast<const float*>(sa),
      static_cast<const float*>(sb), static_cast<const int*>(pages),
      static_cast<float*>(out), a_stride, b_stride, s_stride, T, D, r,
      num_pages);
  return (int)cudaGetLastError();
}

template <typename P>
int dispatch_rank(const void* x, const void* a, const void* b,
                  const void* sa, const void* sb, const void* pages,
                  void* out, long long a_stride, long long b_stride,
                  long long s_stride, int R, int T, int D, int r,
                  int num_pages, cudaStream_t stream) {
  if (r <= 16)
    return launch<P, 16>(x, a, b, sa, sb, pages, out, a_stride, b_stride,
                         s_stride, R, T, D, r, num_pages, stream);
  if (r <= 32)
    return launch<P, 32>(x, a, b, sa, sb, pages, out, a_stride, b_stride,
                         s_stride, R, T, D, r, num_pages, stream);
  return launch<P, 64>(x, a, b, sa, sb, pages, out, a_stride, b_stride,
                       s_stride, R, T, D, r, num_pages, stream);
}

}  // namespace

extern "C" {

// B9: x bf16 [R, T, D] (D % 16 == 0), pool pages A [D, r] / B [r, D] at
// a + p * a_stride / b + p * b_stride (pool_code 1: bf16, 2: int8), scales
// f32 at sa/sb + p * s_stride or null, pages i32 [R] in [0, num_pages) ->
// out f32 [R, T, D]; 1 <= r <= 64.
int tddl_adapter_delta(const void* x, const void* a, const void* b,
                       const void* sa, const void* sb, const void* pages,
                       void* out, long long a_stride, long long b_stride,
                       long long s_stride, int R, int T, int D, int r,
                       int num_pages, int pool_code, void* stream) {
  if (R < 1 || T < 1 || D < 16 || D % 16 || r < 1 || r > 64 ||
      num_pages < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pool_code == 1)
    return dispatch_rank<__nv_bfloat16>(x, a, b, sa, sb, pages, out,
                                        a_stride, b_stride, s_stride, R, T,
                                        D, r, num_pages, s);
  if (pool_code == 2)
    return dispatch_rank<int8_t>(x, a, b, sa, sb, pages, out, a_stride,
                                 b_stride, s_stride, R, T, D, r, num_pages,
                                 s);
  return (int)cudaErrorInvalidValue;
}

const char* tddl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
