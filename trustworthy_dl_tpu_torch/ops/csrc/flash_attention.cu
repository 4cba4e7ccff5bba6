// Causal flash attention for Hopper (sm_90a): forward (B2) and backward
// (B3, as a dq kernel and a dk/dv kernel).
//
// Replaces trustworthy_dl_tpu/ops/flash_attention.py: _fwd_kernel
// (pallas_call in _flash_fwd) and _dq_kernel / _dkv_kernel (the two
// pallas_calls in _flash_bwd).  Layout [BH, T, D] bf16, as the JAX wrapper
// merges batch and heads.  The forward writes o (bf16) and the row
// logsumexp lse (f32); the backward rebuilds P = exp(S - lse) from them and
// takes Delta = sum(dO * O) per row from the caller (a plain reduction, as
// the JAX package leaves it to XLA).  Scores are scaled by 1/sqrt(D) and
// masked causally with the finite NEG_INF of the TPU kernels.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (trustworthy_dl_tpu_torch/ops/__init__.py).  Every entry point
// launches on the caller's stream, allocates nothing (the Python wrapper
// allocates the outputs with torch.empty) and returns cudaGetLastError().
//
// What bounds them: at GPT-2 small's [96, 1024, 64] the forward moves
// ~50.7 MB (15.1 us at 3.35 TB/s) and does ~12.9 GFLOP of causal work
// (13.0 us at the 989 TFLOP/s bf16 tensor-core peak), so both limits sit
// close together and the kernels have to use the tensor cores and read
// each tile once.  Tiles wholly above the diagonal are never loaded (the
// TPU kernels' causal skip); the diagonal tile is masked elementwise.
//
// The forward (B2) is FlashAttention-2's shape, written out by hand:
//   * one CTA of four warps per (64-row query tile, batch*head), query
//     tiles longest-first so the causal triangle balances over the SMs;
//     each warp owns 16 query rows for the whole K loop;
//   * Q's A-fragments are loaded once with ldmatrix and stay in registers;
//     S = Q.K^T and O += P.V run as mma.sync m16n8k16 (bf16 in, f32
//     accumulate), K's B-fragments from ldmatrix, V's from ldmatrix.trans;
//   * the O accumulator and the running (max, sum) of its two rows stay in
//     registers; the row max takes two quad shuffles (the four lanes of a
//     row), the row sum stays per lane until the end; exp2 with
//     scale * log2(e) folded in, lse = (m2 + log2 l) * ln 2 at the end;
//   * P never touches shared memory: two m16n8 C tiles of S, rounded to
//     bf16 pairs, are the A layout of one m16k16 tile of P.V (the plain
//     twin rounds P to bf16 before the product too; l sums unrounded P);
//   * K/V tiles come through a 2-stage ring of cp.async copies (16 bytes
//     a thread), tile j+1 in flight while tile j's products run; rows are
//     padded by 16 bytes so that ldmatrix's eight row addresses hit eight
//     distinct 16-byte bank groups;
//   * one barrier per K/V tile: tile j + 1's copy is issued after the
//     barrier that closes tile j - 1, into the stage j - 1 used;
//   * shared memory: Q plus 2 x (K, V) = 46,080 bytes at D = 64 (87,040 at
//     D = 128); the epilogue stages each warp's bf16 rows in its own rows
//     of the Q tile and writes them with 16-byte coalesced stores;
//   * registers (ptxas, sm_90a, CUDA 12.8): 84 / 104 / 128 / 228 a thread
//     at D = 16 / 32 / 64 / 128, 0 spill bytes at every D; at D <= 64 the
//     launch bounds ask for 4 CTAs (16 warps) an SM, at D = 128 for 2.
//   128-row CTAs of 8 warps and a 3-stage ring measured slower in device
//   time on the H100 (PERF.md, B2's redesign), so the forward keeps these.
// dq and dk/dv (B3) keep the first port's design: 64-row tiles staged in
// shared memory with 16-byte loads, WMMA products (bf16 in, f32 out), the
// score strips in f32 shared memory, their sums in WMMA accumulators
// across the whole loop; no atomics: dq and dk/dv are separate kernels,
// each writing only its own rows, so results are the same on every run.
// TMA, wgmma and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;
using namespace mma_sm90;

constexpr float NEG_INF = -1e30f;
constexpr int TILE = 64;        // query and key tile rows
constexpr int WARPS = 4;        // 16 rows each
constexpr int THREADS = WARPS * 32;
constexpr int LDS = TILE + 4;   // f32 [64 x 64] score row stride
constexpr int LDP = TILE + 8;   // bf16 [64 x 64] probability row stride

template <int D>
struct Dims {
  static constexpr int LDB = D + 8;  // bf16 [64 x D] tile row stride
  static constexpr int LDO = D + 4;  // f32 [64 x D] accumulator row stride
  static constexpr size_t TILE_BYTES = sizeof(bf16) * TILE * LDB;
  static constexpr size_t SCORE_BYTES = sizeof(float) * TILE * LDS;
  static constexpr size_t PROB_BYTES = sizeof(bf16) * TILE * LDP;
  static constexpr size_t ROW_BYTES = sizeof(float) * TILE;
  static constexpr size_t FWD_SMEM = 5 * TILE_BYTES;  // Q + 2 x (K, V)
  static constexpr size_t BWD_SMEM =
      4 * TILE_BYTES + 2 * SCORE_BYTES + 2 * PROB_BYTES + 2 * ROW_BYTES;
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol =
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragBRow =
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// [64, D] rows of a [*, D] global array -> shared tile with row stride LDB.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src) {
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < TILE * VPR; i += THREADS) {
    const int r = i / VPR;
    const int c = i % VPR;
    *reinterpret_cast<uint4*>(dst + r * Dims<D>::LDB + c * 8) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * D + c * 8);
  }
}

// out[16 x 64] (f32, stride LDS) = A[16 x D] . B[64 x D]^T, A and B row-major
// bf16 tiles with stride LDB: one warp's strip of a score-shaped product.
template <int D>
__device__ __forceinline__ void strip_abt(float* out, const bf16* a,
                                          const bf16* b) {
  constexpr int LDB = Dims<D>::LDB;
#pragma unroll
  for (int j = 0; j < TILE / 16; ++j) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA fa;
      FragBCol fb;
      wmma::load_matrix_sync(fa, a + kk * 16, LDB);
      wmma::load_matrix_sync(fb, b + (j * 16) * LDB + kk * 16, LDB);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out + j * 16, acc, LDS, wmma::mem_row_major);
  }
}

// acc[j] += P[16 x 64] (bf16, stride LDP) . M[64 x D] (bf16, stride LDB).
template <int D>
__device__ __forceinline__ void strip_pm(FragC* acc, const bf16* p,
                                         const bf16* m) {
  constexpr int LDB = Dims<D>::LDB;
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      FragA fa;
      FragBRow fb;
      wmma::load_matrix_sync(fa, p + kk * 16, LDP);
      wmma::load_matrix_sync(fb, m + (kk * 16) * LDB + j * 16, LDB);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
}

// ---------------------------------------------------------------------------
// B2: forward.  grid (T/64, BH); query tiles run longest-first.
// ---------------------------------------------------------------------------
// [64, D] rows of a [*, D] global array -> shared tile with row stride LDB,
// 16 bytes a thread per cp.async.
template <int D>
__device__ __forceinline__ void copy_tile_async(bf16* dst, const bf16* src) {
  constexpr int VPR = D / 8;
#pragma unroll
  for (int it = 0; it < TILE * VPR / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / VPR;
    const int c = i % VPR;
    cp_async16(dst + r * Dims<D>::LDB + c * 8, src + (size_t)r * D + c * 8);
  }
}

// At D <= 64, four CTAs (16 warps) per SM: at most 128 registers a thread.
template <int D>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 4 : 2)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int T, float scale_log2) {
  constexpr int LD = Dims<D>::LDB;
  constexpr int KD = D / 16;  // k16 steps over D, and n16 pairs over D
  constexpr int ND = D / 8;   // n8 tiles of the output
  constexpr float LN2 = 0.69314718055994531f;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* kv_s = q_s + TILE * LD;  // stage s: K at 2s, V at 2s + 1 tiles

  const int nq = T / TILE;
  const int qi = nq - 1 - blockIdx.x;
  const size_t head = (size_t)blockIdx.y * T * D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * 16;
  const int g = lane >> 2;          // fragment row (and row + 8)
  const int c2 = (lane & 3) * 2;    // fragment column pair
  // ldmatrix row-address roles of this lane: row within an 8x8 matrix and
  // which of the four matrices (bit 0 and bit 1 of lane / 8).
  const int lrow = lane & 7;
  const int lm0 = (lane >> 3) & 1;
  const int lm1 = lane >> 4;

  copy_tile_async<D>(q_s, q + head + (size_t)qi * TILE * D);
  copy_tile_async<D>(kv_s, k + head);
  copy_tile_async<D>(kv_s + TILE * LD, v + head);
  cp_async_commit();

  uint32_t qf[KD][4];
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF;  // running max, scaled log2 units
  float l0 = 0.f, l1 = 0.f;          // this lane's share of the row sums

  for (int kj = 0; kj <= qi; ++kj) {
    cp_async_wait<0>();  // this thread's copies of tile kj have landed
    __syncthreads();     // everyone's have, and every warp is done with kj - 1
    if (kj < qi) {       // tile kj + 1 into the stage kj - 1 used
      bf16* nk = kv_s + ((kj + 1) & 1) * 2 * TILE * LD;
      copy_tile_async<D>(nk, k + head + (size_t)(kj + 1) * TILE * D);
      copy_tile_async<D>(nk + TILE * LD,
                         v + head + (size_t)(kj + 1) * TILE * D);
      cp_async_commit();
    }
    const bf16* k_s = kv_s + (kj & 1) * 2 * TILE * LD;
    const bf16* v_s = k_s + TILE * LD;
    if (kj == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldsm_x4(qf[kk], q_s + (r0 + lrow + lm0 * 8) * LD + kk * 16 + lm1 * 8);
    }

    // S = Q . K^T over this tile's 64 keys: 8 n8 tiles, two per ldmatrix.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t b[4];
        ldsm_x4(b, k_s + (jj * 16 + lrow + lm1 * 8) * LD + kk * 16 + lm0 * 8);
        mma_bf16(s[2 * jj], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * jj + 1], qf[kk], b[2], b[3]);
      }
    }

    // Online softmax in registers.  Only the diagonal tile is masked.
    if (kj == qi) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j * 8 + c2 + (e & 1) > r0 + g + (e >> 1) * 8) s[j][e] = NEG_INF;
    }
    float mx0 = s[0][0], mx1 = s[0][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // The running max in scaled log2 units (scale > 0 commutes with max).
    // m starts at the finite NEG_INF, so the first tile's correction is
    // exp2(-huge) = 0, never NaN; every row sees its diagonal key, so the
    // tile's max is a real score.
    mx0 = fmaxf(m0, mx0 * scale_log2);
    mx1 = fmaxf(m1, mx1 * scale_log2);
    const float corr0 = ex2(m0 - mx0);
    const float corr1 = ex2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= corr0;
    l1 *= corr1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= corr0;
      acc[n][1] *= corr0;
      acc[n][2] *= corr1;
      acc[n][3] *= corr1;
    }
    // P = exp2(s * scale_log2 - m), one FFMA and one ex2 each, as bf16
    // A-fragments: S tiles 2kk and 2kk + 1 are P.V's k16 step kk.
    uint32_t pf[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = ex2(fmaf(s[j][0], scale_log2, -mx0));
      const float p1 = ex2(fmaf(s[j][1], scale_log2, -mx0));
      const float p2 = ex2(fmaf(s[j][2], scale_log2, -mx1));
      const float p3 = ex2(fmaf(s[j][3], scale_log2, -mx1));
      l0 += p0 + p1;
      l1 += p2 + p3;
      pf[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P . V: V's B-fragments through ldmatrix.trans, two n8 tiles each.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int nn = 0; nn < KD; ++nn) {
        uint32_t b[4];
        ldsm_x4_trans(b, v_s + (kk * 16 + lrow + lm0 * 8) * LD + nn * 16 +
                             lm1 * 8);
        mma_bf16(acc[2 * nn], pf[kk], b[0], b[1]);
        mma_bf16(acc[2 * nn + 1], pf[kk], b[2], b[3]);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;

  // Epilogue: this warp's rows of the Q tile (read only by this warp, at
  // kj == 0) stage the bf16 output for 16-byte coalesced stores.
  bf16* stage = q_s + r0 * LD;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    *reinterpret_cast<uint32_t*>(stage + g * LD + n * 8 + c2) =
        pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * LD + n * 8 + c2) =
        pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
  __syncwarp();
  constexpr int VPR = D / 8;
  bf16* out = o + head + (size_t)(qi * TILE + r0) * D;
#pragma unroll
  for (int it = 0; it < 16 * VPR / 32; ++it) {
    const int i = lane + it * 32;
    const int r = i / VPR;
    const int c = i % VPR;
    *reinterpret_cast<uint4*>(out + (size_t)r * D + c * 8) =
        *reinterpret_cast<const uint4*>(stage + r * LD + c * 8);
  }
  if ((lane & 3) == 0) {
    float* lrow_out = lse + (size_t)blockIdx.y * T + qi * TILE + r0;
    lrow_out[g] = (m0 + log2f(l0)) * LN2;
    lrow_out[g + 8] = (m1 + log2f(l1)) * LN2;
  }
}

// Writes a warp's 16 x D f32 accumulator rows, times `mul`, as bf16 rows of
// a [*, D] global array, staging them through `stage` (stride LDO).
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, FragC* acc, float mul,
                                           float* stage) {
  using Dm = Dims<D>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    for (int i = 0; i < acc[j].num_elements; ++i) acc[j].x[i] *= mul;
    wmma::store_matrix_sync(stage + j * 16, acc[j], Dm::LDO,
                            wmma::mem_row_major);
  }
  __syncwarp();
  for (int r = 0; r < 16; ++r)
    for (int d = lane; d < D; d += 32)
      dst[(size_t)r * D + d] = __float2bfloat16(stage[r * Dm::LDO + d]);
  __syncwarp();
}

// ---------------------------------------------------------------------------
// B3, dq: grid (T/64, BH).  dQ = scale * (P o (dO.V^T - Delta)) . K.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int T, float scale) {
  using Dm = Dims<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + TILE * Dm::LDB;
  bf16* k_s = do_s + TILE * Dm::LDB;
  bf16* v_s = k_s + TILE * Dm::LDB;
  float* s_s = reinterpret_cast<float*>(v_s + TILE * Dm::LDB);
  float* dp_s = s_s + TILE * LDS;
  bf16* ds_s = reinterpret_cast<bf16*>(dp_s + TILE * LDS);
  float* lse_s = reinterpret_cast<float*>(ds_s + 2 * TILE * LDP);
  float* delta_s = lse_s + TILE;

  const int nq = T / TILE;
  const int qi = nq - 1 - blockIdx.x;
  const size_t head = (size_t)blockIdx.y * T * D;
  const size_t rows = (size_t)blockIdx.y * T + qi * TILE;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * 16;

  load_tile<D>(q_s, q + head + (size_t)qi * TILE * D);
  load_tile<D>(do_s, dout + head + (size_t)qi * TILE * D);
  for (int i = threadIdx.x; i < TILE; i += THREADS) {
    lse_s[i] = lse[rows + i];
    delta_s[i] = delta[rows + i];
  }
  FragC acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int kj = 0; kj <= qi; ++kj) {
    __syncthreads();
    load_tile<D>(k_s, k + head + (size_t)kj * TILE * D);
    load_tile<D>(v_s, v + head + (size_t)kj * TILE * D);
    __syncthreads();

    strip_abt<D>(s_s + r0 * LDS, q_s + r0 * Dm::LDB, k_s);
    strip_abt<D>(dp_s + r0 * LDS, do_s + r0 * Dm::LDB, v_s);
    __syncwarp();
    for (int r = 0; r < 16; ++r) {
      const int row = r0 + r;
      const int qpos = qi * TILE + row;
      for (int c = lane; c < TILE; c += 32) {
        float p = 0.f;
        if (!(kj == qi && kj * TILE + c > qpos))
          p = expf(s_s[row * LDS + c] * scale - lse_s[row]);
        const float ds = p * (dp_s[row * LDS + c] - delta_s[row]);
        ds_s[row * LDP + c] = __float2bfloat16(ds);
      }
    }
    __syncwarp();
    strip_pm<D>(acc, ds_s + r0 * LDP, k_s);
  }
  __syncthreads();  // s_s/dp_s become the output staging area
  store_rows<D>(dq + head + (size_t)(qi * TILE + r0) * D, acc, scale,
                s_s + r0 * Dm::LDO);
}

// ---------------------------------------------------------------------------
// B3, dk/dv: grid (T/64, BH), one key tile each, walking the query tiles at
// and below the diagonal.  dV = P^T . dO, dK = scale * dS^T . Q.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int T, float scale) {
  using Dm = Dims<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + TILE * Dm::LDB;
  bf16* q_s = v_s + TILE * Dm::LDB;
  bf16* do_s = q_s + TILE * Dm::LDB;
  float* st_s = reinterpret_cast<float*>(do_s + TILE * Dm::LDB);
  float* dpt_s = st_s + TILE * LDS;
  bf16* pt_s = reinterpret_cast<bf16*>(dpt_s + TILE * LDS);
  bf16* dst_s = pt_s + TILE * LDP;
  float* lse_s = reinterpret_cast<float*>(dst_s + TILE * LDP);
  float* delta_s = lse_s + TILE;

  const int nq = T / TILE;
  const int kj = blockIdx.x;
  const size_t head = (size_t)blockIdx.y * T * D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * 16;

  load_tile<D>(k_s, k + head + (size_t)kj * TILE * D);
  load_tile<D>(v_s, v + head + (size_t)kj * TILE * D);
  FragC dk_acc[D / 16];
  FragC dv_acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::fill_fragment(dk_acc[j], 0.f);
    wmma::fill_fragment(dv_acc[j], 0.f);
  }

  for (int qi = kj; qi < nq; ++qi) {
    __syncthreads();
    load_tile<D>(q_s, q + head + (size_t)qi * TILE * D);
    load_tile<D>(do_s, dout + head + (size_t)qi * TILE * D);
    const size_t rows = (size_t)blockIdx.y * T + qi * TILE;
    for (int i = threadIdx.x; i < TILE; i += THREADS) {
      lse_s[i] = lse[rows + i];
      delta_s[i] = delta[rows + i];
    }
    __syncthreads();

    // S^T and dP^T strips: this warp's 16 keys against the 64 queries.
    strip_abt<D>(st_s + r0 * LDS, k_s + r0 * Dm::LDB, q_s);
    strip_abt<D>(dpt_s + r0 * LDS, v_s + r0 * Dm::LDB, do_s);
    __syncwarp();
    for (int r = 0; r < 16; ++r) {
      const int row = r0 + r;
      const int kpos = kj * TILE + row;
      for (int c = lane; c < TILE; c += 32) {
        float p = 0.f;
        if (!(qi == kj && kpos > qi * TILE + c))
          p = expf(st_s[row * LDS + c] * scale - lse_s[c]);
        const float ds = p * (dpt_s[row * LDS + c] - delta_s[c]);
        pt_s[row * LDP + c] = __float2bfloat16(p);
        dst_s[row * LDP + c] = __float2bfloat16(ds);
      }
    }
    __syncwarp();
    strip_pm<D>(dv_acc, pt_s + r0 * LDP, do_s);
    strip_pm<D>(dk_acc, dst_s + r0 * LDP, q_s);
  }
  __syncthreads();
  const size_t out = head + (size_t)(kj * TILE + r0) * D;
  store_rows<D>(dv + out, dv_acc, 1.f, st_s + r0 * Dm::LDO);
  store_rows<D>(dk + out, dk_acc, scale, st_s + r0 * Dm::LDO);
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
int launch(int which, const void* q, const void* k, const void* v,
           const void* o_or_do, const void* lse, const void* delta, void* out0,
           void* out1, int BH, int T, cudaStream_t stream) {
  using Dm = Dims<D>;
  const dim3 grid(T / TILE, BH);
  const float scale = (float)(1.0 / sqrt((double)D));
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  int err;
  if (which == 0) {
    if ((err = prepare(flash_fwd_kernel<D>, Dm::FWD_SMEM))) return err;
    flash_fwd_kernel<D><<<grid, THREADS, Dm::FWD_SMEM, stream>>>(
        qb, kb, vb, static_cast<bf16*>(out0), static_cast<float*>(out1), T,
        scale * 1.4426950408889634f);
  } else if (which == 1) {
    if ((err = prepare(flash_dq_kernel<D>, Dm::BWD_SMEM))) return err;
    flash_dq_kernel<D><<<grid, THREADS, Dm::BWD_SMEM, stream>>>(
        qb, kb, vb, static_cast<const bf16*>(o_or_do),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(out0), T, scale);
  } else {
    if ((err = prepare(flash_dkv_kernel<D>, Dm::BWD_SMEM))) return err;
    flash_dkv_kernel<D><<<grid, THREADS, Dm::BWD_SMEM, stream>>>(
        qb, kb, vb, static_cast<const bf16*>(o_or_do),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(out0), static_cast<bf16*>(out1), T, scale);
  }
  return (int)cudaGetLastError();
}

int dispatch(int which, const void* q, const void* k, const void* v,
             const void* o_or_do, const void* lse, const void* delta,
             void* out0, void* out1, int BH, int T, int D, void* stream) {
  if (BH < 1 || BH > 65535 || T < TILE || T % TILE != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(which, q, k, v, o_or_do, lse, delta, out0, out1, BH, T,
                        s);
    case 32:
      return launch<32>(which, q, k, v, o_or_do, lse, delta, out0, out1, BH, T,
                        s);
    case 64:
      return launch<64>(which, q, k, v, o_or_do, lse, delta, out0, out1, BH, T,
                        s);
    case 128:
      return launch<128>(which, q, k, v, o_or_do, lse, delta, out0, out1, BH,
                         T, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// B2: q, k, v [BH, T, D] bf16 -> o [BH, T, D] bf16, lse [BH, T] f32.
int tddl_flash_fwd(const void* q, const void* k, const void* v, void* o,
                   void* lse, int BH, int T, int D, void* stream) {
  return dispatch(0, q, k, v, nullptr, nullptr, nullptr, o, lse, BH, T, D,
                  stream);
}

// B3 (dq): + dO [BH, T, D] bf16, lse and Delta [BH, T] f32 -> dq.
int tddl_flash_bwd_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int BH, int T, int D, void* stream) {
  return dispatch(1, q, k, v, dout, lse, delta, dq, nullptr, BH, T, D, stream);
}

// B3 (dk/dv): same inputs -> dk, dv.
int tddl_flash_bwd_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int BH, int T, int D,
                       void* stream) {
  return dispatch(2, q, k, v, dout, lse, delta, dk, dv, BH, T, D, stream);
}

const char* tddl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
