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
// does take is the launch and a chain of dependent steps, so the design
// shortens the chain and spreads every step over all the CTA's threads:
//   * one CTA (8 warps) per (row, tile of T, 256 output columns), the
//     tile one position when T = 1 and TT = 8 positions otherwise; the
//     few CTAs of a row each compute the whole h of their tile (the page
//     comes from L2 after the first);
//   * every load that needs only the page goes out before the first is
//     used: the x tile and this CTA's B columns by 16-byte cp.async into
//     shared memory (x first, it needs no page), the two scales, and the
//     A page read in place from its natural [D, r] layout into registers,
//     16-byte (bf16) or 8-byte (int8) vectors of one d and KV = 8
//     consecutive k, the next round of UNROLL vectors in flight while
//     this one is used.  So a launch makes one dependent trip to memory
//     after the page index, then the store;
//   * h: the contraction over D is split over every thread of the CTA,
//     whatever T (thread (d-row, k-group): GP = RPAD / KV lanes a d), each
//     keeping TT x KV partial sums in registers; lanes of a warp that hold
//     the same k-group fold them by a butterfly reduce-scatter of
//     shuffles (each step halves the values a lane keeps, so a lane sends
//     about TT x KV values in all, not TT x KV per step), the warps
//     through a small shared array [WARPS][TT][RPAD] summed in warp order
//     and scaled by sa: a fixed order, no atomics, the same bits on every
//     launch;
//   * out: each thread one output column of the CTA's 256, every position
//     of the tile, r f32 FMAs on its staged B column and the broadcast h,
//     the sb scale last.  CUDA cores only: r <= 64 is far below a tensor
//     core tile's worth, and h may not be rounded to bf16.
// Shared memory is the x tile, the B columns, the partials and h (no
// copy of A): 10.3 KB for a decode launch at r = 16, D = 768.
// A ZERO page (all zeros) gives exactly +0.0, so adapterless rows add an
// exact zero; a page index outside [0, num_pages) gives NaN rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>
#include <string.h>

#include "mma_sm90.cuh"

namespace {

using mma_sm90::cp_async16;
using mma_sm90::cp_async_commit;
using mma_sm90::cp_async_wait;

constexpr int THREADS = 256;      // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int NCOL = THREADS;     // output columns per CTA, one a thread
constexpr int KV = 8;             // k values of one A vector
constexpr int TT_CHUNK = 8;       // positions of T per CTA when T > 1

// One A vector: KV consecutive k of one d, raw.
template <typename P>
struct AVec;
template <>
struct AVec<__nv_bfloat16> {
  using type = uint4;
  using raw = uint16_t;
};
template <>
struct AVec<int8_t> {
  using type = uint2;
  using raw = uint8_t;
};

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// int8 to f32 in two ALU operations, not a conversion (a quarter of the
// FMA rate): the byte with its sign bit flipped is v + 128 in [0, 255];
// under the exponent of 2^23 it reads as 2^23 + v + 128, exactly.
constexpr float I8_BIAS = 8388736.f;   // 2^23 + 128
__device__ __forceinline__ float widen(int8_t v) {
  return __uint_as_float(0x4B000000u | ((uint32_t)(uint8_t)v ^ 0x80u)) -
         I8_BIAS;
}

__device__ __forceinline__ void widen_vec(const uint4& v, float (&a)[KV]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[2 * i] = bf16_lo(w[i]);
    a[2 * i + 1] = bf16_hi(w[i]);
  }
}
__device__ __forceinline__ void widen_vec(const uint2& v, float (&a)[KV]) {
  const uint32_t w[2] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)   // bytes [v_j + 128, 0, 0, 0x4B]
      a[4 * i + j] =
          __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7540u | j)) -
          I8_BIAS;
}

// Thread (d, g)'s A vector: k in [g KV, g KV + KV) of row d, zero past r.
// With r % KV == 0 (the page 16-byte aligned, D % 16 == 0) one aligned
// vector load; otherwise a row's k straddle vectors and go one by one.
template <typename P>
__device__ __forceinline__ typename AVec<P>::type load_a(const P* ap, int d,
                                                         int g, int r,
                                                         bool vec) {
  using V = typename AVec<P>::type;
  using Raw = typename AVec<P>::raw;
  const int k0 = g * KV;
  if (vec)
    return k0 < r ? *reinterpret_cast<const V*>(ap + (size_t)d * r + k0)
                  : V{};
  const Raw* row = reinterpret_cast<const Raw*>(ap) + (size_t)d * r;
  Raw e[KV];
#pragma unroll
  for (int j = 0; j < KV; ++j) e[j] = k0 + j < r ? row[k0 + j] : Raw{0};
  V v;
  memcpy(&v, e, sizeof(V));
  return v;
}

// Reduce-scatter of V values over the lane bits M, M/2, ..., LOW: while a
// lane holds more than one value, each step sends half of them to the
// partner and keeps the other half summed (a lane with bit M set keeps the
// upper half); once it holds one, a step is a plain butterfly add.  a + b
// is the same bits as b + a, so both partners keep identical sums.
template <int V, int C, int M, int LOW>
__device__ __forceinline__ void reduce_scatter(float (&v)[V], int lane) {
  if constexpr (M >= LOW) {
    if constexpr (C > 1) {
      const bool up = (lane & M) != 0;
#pragma unroll
      for (int i = 0; i < C / 2; ++i) {
        const float send = up ? v[i] : v[i + C / 2];
        const float keep = up ? v[i + C / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
      }
      reduce_scatter<V, C / 2, M / 2, LOW>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], M);
      reduce_scatter<V, 1, M / 2, LOW>(v, lane);
    }
  }
}

// Bytes of dynamic shared memory of one CTA: partials [WARPS][TT][RPAD]
// f32, h [RPAD][TT] f32, the x tile [TT][D] bf16, B's columns [r][NCOL].
template <typename P, int RPAD, int TT>
size_t smem_bytes(int D, int r) {
  return sizeof(float) * ((size_t)WARPS * TT * RPAD + (size_t)RPAD * TT) +
         sizeof(__nv_bfloat16) * (size_t)TT * D + sizeof(P) * (size_t)r * NCOL;
}

template <typename P, int RPAD, int TT>
__global__ void __launch_bounds__(THREADS) adapter_delta_kernel(
    const __nv_bfloat16* __restrict__ x, const P* __restrict__ a,
    const P* __restrict__ b, const float* __restrict__ sa,
    const float* __restrict__ sb, const int* __restrict__ pages,
    float* __restrict__ out, long long a_stride, long long b_stride,
    long long s_stride, int T, int D, int r, int num_pages) {
  using V = typename AVec<P>::type;
  constexpr int GP = RPAD / KV;            // lanes (k-groups) a d row
  constexpr int NRP = THREADS / GP;        // d rows a pass of the CTA
  constexpr int NV = TT * KV;              // partial sums a thread
  constexpr int UNROLL = TT == 1 ? 8 : 4;  // A vectors a round, in flight
  constexpr int EPC = 16 / sizeof(P);      // B elements a 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* part = reinterpret_cast<float*>(smem_raw);   // [WARPS][TT][RPAD]
  float* h_s = part + WARPS * TT * RPAD;              // [RPAD][TT]
  __nv_bfloat16* x_s =
      reinterpret_cast<__nv_bfloat16*>(h_s + RPAD * TT);  // [TT][D]
  P* b_s = reinterpret_cast<P*>(x_s + TT * D);        // [r][NCOL]

  const int tid = threadIdx.x;
  const int row = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int tn = min(TT, T - t0);
  const int c0 = blockIdx.z * NCOL;
  const int ncol = min(NCOL, D - c0);
  const int page = pages[row];

  // The x tile first: it needs no page.  Positions past T are zeros.
  {
    const __nv_bfloat16* xg = x + ((size_t)row * T + t0) * D;
    const int chunks = TT * D / 8;
    for (int i = tid; i < chunks; i += THREADS) {
      if (i * 8 < tn * D)
        cp_async16(x_s + i * 8, xg + i * 8);
      else
        *reinterpret_cast<uint4*>(x_s + i * 8) = make_uint4(0, 0, 0, 0);
    }
    cp_async_commit();
  }
  float* o = out + ((size_t)row * T + t0) * D + c0;
  if (page < 0 || page >= num_pages) {
    // The host validates every page row it builds; an index that gets
    // here anyway must not read outside the pool: NaN rows show it.
    cp_async_wait<0>();
    if (tid < ncol)
      for (int t = 0; t < tn; ++t)
        o[(size_t)t * D + tid] = __int_as_float(0x7fc00000);
    return;
  }

  // Everything else the page gives, before any of it is used: B's
  // columns (cp.async), the scales, the first round of A vectors.
  {
    const P* bg = b + (size_t)page * b_stride + c0;
    const int per_row = ncol / EPC;
    for (int i = tid; i < r * per_row; i += THREADS) {
      const int k = i / per_row;
      const int c = (i - k * per_row) * EPC;
      cp_async16(b_s + k * NCOL + c, bg + (size_t)k * D + c);
    }
    cp_async_commit();
  }
  const float scale_a = sa != nullptr ? sa[(size_t)page * s_stride] : 1.f;
  const float scale_b = sb != nullptr ? sb[(size_t)page * s_stride] : 1.f;
  const P* ap = a + (size_t)page * a_stride;
  const bool vec = r % KV == 0;
  const int g = tid % GP;
  const int dr = tid / GP;
  const int nd = dr < D ? (D - dr + NRP - 1) / NRP : 0;   // d rows of mine

  V buf[2][UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u)
    buf[0][u] = u < nd ? load_a<P>(ap, dr + u * NRP, g, r, vec) : V{};

  float acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = 0.f;

  cp_async_wait<1>();   // the x tile (B may still be in flight)
  __syncthreads();

  // h partials: the next round's loads go out before this round is used.
  for (int base = 0; base < nd; base += 2 * UNROLL) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int cur = base + half * UNROLL;
      if (cur >= nd) break;
      const int nxt = cur + UNROLL;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (nxt + u < nd)
          buf[half ^ 1][u] = load_a<P>(ap, dr + (nxt + u) * NRP, g, r, vec);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (cur + u < nd) {
          const int d = dr + (cur + u) * NRP;
          float av[KV];
          widen_vec(buf[half][u], av);
#pragma unroll
          for (int t = 0; t < TT; ++t) {
            const float xv = widen(x_s[t * D + d]);
#pragma unroll
            for (int j = 0; j < KV; ++j)
              acc[t * KV + j] = fmaf(xv, av[j], acc[t * KV + j]);
          }
        }
      }
    }
  }

  // Fold the lanes of a warp that hold the same k-group, then the warps.
  const int lane = tid & 31;
  const int warp = tid >> 5;
  reduce_scatter<NV, NV, 16, GP>(acc, lane);
  // Lane's values after the fold: CF sums of consecutive indices from
  // off; a lane whose partner holds the same sums does not write.
  constexpr int CF = NV * GP >= 32 ? NV * GP / 32 : 1;
  int off = 0, count = NV;
  bool writer = true;
#pragma unroll
  for (int m = 16; m >= GP; m >>= 1) {
    if (count > 1) {
      count /= 2;
      if (lane & m) off += count;
    } else if (lane & m) {
      writer = false;
    }
  }
  if (writer) {
#pragma unroll
    for (int i = 0; i < CF; ++i) {
      const int idx = off + i;
      const int t = idx / KV;
      const int k = g * KV + idx % KV;
      part[(warp * TT + t) * RPAD + k] = acc[i];
    }
  }
  __syncthreads();
  for (int e = tid; e < TT * RPAD; e += THREADS) {
    const int t = e / RPAD;
    const int k = e - t * RPAD;
    if (k < r) {
      float s = part[t * RPAD + k];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) s += part[(w * TT + t) * RPAD + k];
      h_s[k * TT + t] = s * scale_a;
    }
  }
  cp_async_wait<0>();   // B's columns
  __syncthreads();

  if (tid >= ncol) return;
  float acc_o[TT];
#pragma unroll
  for (int t = 0; t < TT; ++t) acc_o[t] = 0.f;
#pragma unroll
  for (int k = 0; k < RPAD; ++k) {
    if (k < r) {
      const float bv = widen(b_s[k * NCOL + tid]);
#pragma unroll
      for (int t = 0; t < TT; ++t)
        acc_o[t] = fmaf(h_s[k * TT + t], bv, acc_o[t]);
    }
  }
#pragma unroll
  for (int t = 0; t < TT; ++t)
    if (t < tn) o[(size_t)t * D + tid] = acc_o[t] * scale_b;
}

template <typename P, int RPAD, int TT>
int launch(const void* x, const void* a, const void* b, const void* sa,
           const void* sb, const void* pages, void* out, long long a_stride,
           long long b_stride, long long s_stride, int R, int T, int D, int r,
           int num_pages, cudaStream_t stream) {
  const size_t smem = smem_bytes<P, RPAD, TT>(D, r);
  // Raised once per instance to the largest stage asked for so far.
  static size_t granted = 48 * 1024;
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        adapter_delta_kernel<P, RPAD, TT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    granted = smem;
  }
  dim3 grid((T + TT - 1) / TT, R, (D + NCOL - 1) / NCOL);
  adapter_delta_kernel<P, RPAD, TT><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const P*>(a),
      static_cast<const P*>(b), static_cast<const float*>(sa),
      static_cast<const float*>(sb), static_cast<const int*>(pages),
      static_cast<float*>(out), a_stride, b_stride, s_stride, T, D, r,
      num_pages);
  return (int)cudaGetLastError();
}

template <typename P, int RPAD>
int dispatch_tile(const void* x, const void* a, const void* b,
                  const void* sa, const void* sb, const void* pages,
                  void* out, long long a_stride, long long b_stride,
                  long long s_stride, int R, int T, int D, int r,
                  int num_pages, cudaStream_t stream) {
  if (T == 1)
    return launch<P, RPAD, 1>(x, a, b, sa, sb, pages, out, a_stride,
                              b_stride, s_stride, R, T, D, r, num_pages,
                              stream);
  return launch<P, RPAD, TT_CHUNK>(x, a, b, sa, sb, pages, out, a_stride,
                                   b_stride, s_stride, R, T, D, r,
                                   num_pages, stream);
}

template <typename P>
int dispatch_rank(const void* x, const void* a, const void* b,
                  const void* sa, const void* sb, const void* pages,
                  void* out, long long a_stride, long long b_stride,
                  long long s_stride, int R, int T, int D, int r,
                  int num_pages, cudaStream_t stream) {
  if (r <= 8)
    return dispatch_tile<P, 8>(x, a, b, sa, sb, pages, out, a_stride,
                               b_stride, s_stride, R, T, D, r, num_pages,
                               stream);
  if (r <= 16)
    return dispatch_tile<P, 16>(x, a, b, sa, sb, pages, out, a_stride,
                                b_stride, s_stride, R, T, D, r, num_pages,
                                stream);
  if (r <= 32)
    return dispatch_tile<P, 32>(x, a, b, sa, sb, pages, out, a_stride,
                                b_stride, s_stride, R, T, D, r, num_pages,
                                stream);
  return dispatch_tile<P, 64>(x, a, b, sa, sb, pages, out, a_stride,
                              b_stride, s_stride, R, T, D, r, num_pages,
                              stream);
}

}  // namespace

extern "C" {

// B9: x bf16 [R, T, D] (D % 16 == 0), pool pages A [D, r] / B [r, D] at
// a + p * a_stride / b + p * b_stride (pool_code 1: bf16, 2: int8; both
// 16-byte aligned), scales f32 at sa/sb + p * s_stride or null, pages i32
// [R] in [0, num_pages) -> out f32 [R, T, D]; 1 <= r <= 64.
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
