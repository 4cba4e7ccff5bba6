// Weight-only int8 dequant matmul for Hopper (sm_90a): B4.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (trustworthy_dl_tpu_torch/ops/__init__.py).  The entry point
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError(), which the Python wrapper raises on.
//
// Replaces trustworthy_dl_tpu/ops/fused_dequant_matmul.py:_dq_matmul_kernel
// (pallas_call in _dq_matmul_pallas): out[M, N] = (x[M, K] @ w_q[K, N]) *
// scale[N], f32 accumulation, w_q int8 with per-output-column f32 scales.
//
// What bounds it on this card: bytes.  On the serving path M is the decode
// batch (8) or a prefill chunk (<= a few hundred rows), K and N are 768 or
// 3072 wide: a launch reads 0.59-2.36 MB of int8 weight and does 2*M*K*N
// flops, ~16 flops per weight byte at M = 8, far under the ~295 flop/byte
// ridge of the bf16 tensor cores.  The design therefore reads each weight
// byte once, as int8 (half the bytes of bf16), and never writes a widened
// copy to device memory:
//   * one CTA (4 warps) per (64-column N tile, 64-row M tile); M is ragged
//     (rows past M are zero-filled in shared memory and their fragments
//     skipped), N and K must be multiples of 64 (the wrapper checks);
//   * K is walked in 64-deep chunks: the x chunk is staged as bf16, the
//     int8 weight chunk is loaded 16 bytes a thread and widened to bf16 in
//     shared memory (int8 values are exact in bf16);
//   * WMMA 16x16x16 bf16 products accumulate in f32 registers: bf16 x times
//     an int8 value is exact in f32, so this is the JAX package's f32
//     product x.astype(f32) @ w.astype(f32) up to summation order;
//   * the column scales multiply the accumulator once, before the store.
// At M = 8 a launch is a handful of CTAs and launch latency dominates; no
// split-K, no cp.async/TMA pipeline yet (later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int TM = 64;       // rows of x per CTA
constexpr int TN = 64;       // output columns per CTA
constexpr int KC = 64;       // K chunk
constexpr int THREADS = 128;  // 4 warps, each owns 16 output columns
constexpr int LDX = KC + 8;   // bf16 row pitch of the x chunk
constexpr int LDW = TN + 8;   // bf16 row pitch of the widened weight chunk
constexpr int LDS = TN + 4;   // f32 row pitch of the output stage

__global__ void __launch_bounds__(THREADS) dq_matmul_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ wq,
    const float* __restrict__ scale, float* __restrict__ out, int M, int K,
    int N) {
  __shared__ __align__(128) __nv_bfloat16 x_s[TM * LDX];
  __shared__ __align__(128) __nv_bfloat16 w_s[KC * LDW];
  __shared__ __align__(128) float st[TM * LDS];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * TN;
  const int m0 = blockIdx.y * TM;
  const int rows = min(TM, M - m0);
  const int nfr = (rows + 15) / 16;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[TM / 16];
#pragma unroll
  for (int f = 0; f < TM / 16; ++f) wmma::fill_fragment(acc[f], 0.f);

  for (int k0 = 0; k0 < K; k0 += KC) {
    // x chunk [TM, KC] bf16: 8 x 16-byte vectors per row.
    for (int i = tid; i < TM * (KC / 8); i += THREADS) {
      const int r = i / (KC / 8);
      const int c = (i % (KC / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows)
        v = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + k0 + c);
      *reinterpret_cast<uint4*>(x_s + r * LDX + c) = v;
    }
    // Weight chunk [KC, TN] int8: 4 x 16-byte vectors per row, widened.
    for (int i = tid; i < KC * (TN / 16); i += THREADS) {
      const int kr = i / (TN / 16);
      const int c = (i % (TN / 16)) * 16;
      const int4 raw =
          *reinterpret_cast<const int4*>(wq + (size_t)(k0 + kr) * N + n0 + c);
      const signed char* b = reinterpret_cast<const signed char*>(&raw);
      uint32_t packed[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat162 pair =
            __floats2bfloat162_rn((float)b[2 * j], (float)b[2 * j + 1]);
        packed[j] = *reinterpret_cast<const uint32_t*>(&pair);
      }
      uint4* dst = reinterpret_cast<uint4*>(w_s + kr * LDW + c);
      dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> bf;
      wmma::load_matrix_sync(bf, w_s + kk * LDW + warp * 16, LDW);
#pragma unroll
      for (int f = 0; f < TM / 16; ++f) {
        if (f < nfr) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> af;
          wmma::load_matrix_sync(af, x_s + f * 16 * LDX + kk, LDX);
          wmma::mma_sync(acc[f], af, bf, acc[f]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int f = 0; f < TM / 16; ++f)
    if (f < nfr)
      wmma::store_matrix_sync(st + f * 16 * LDS + warp * 16, acc[f], LDS,
                              wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < rows * TN; i += THREADS) {
    const int r = i / TN;
    const int c = i % TN;
    out[(size_t)(m0 + r) * N + n0 + c] = st[r * LDS + c] * scale[n0 + c];
  }
}

}  // namespace

extern "C" {

// B4: x bf16 [M, K], w_q int8 [K, N], scale f32 [N] -> out f32 [M, N];
// K % 64 == 0, N % 64 == 0.
int tddl_dequant_matmul(const void* x, const void* wq, const void* scale,
                        void* out, int M, int K, int N, void* stream) {
  if (M < 1 || K < KC || N < TN || K % KC || N % TN)
    return (int)cudaErrorInvalidValue;
  dim3 grid(N / TN, (M + TM - 1) / TM);
  dq_matmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<float*>(out), M, K, N);
  return (int)cudaGetLastError();
}

const char* tddl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
