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
// each tile once.  The design, kept simple for a first port:
//   * 64-row tiles, one CTA of four warps per (query tile, batch*head) for
//     the forward and dq, per (key tile, batch*head) for dk/dv; each warp
//     owns 16 rows, so the per-row softmax work needs no CTA barrier;
//   * Q/K/V/dO tiles are staged in shared memory with 16-byte loads; the
//     products run on the tensor cores through WMMA (bf16 in, f32 out);
//   * tiles wholly above the diagonal are never loaded (the TPU kernels'
//     causal skip), the diagonal tile is masked elementwise;
//   * the forward keeps (m, l) per row and the output accumulator in f32 in
//     shared memory (WMMA fragments hide their row mapping, so the online
//     rescale runs on the staged copy); dq and dk/dv keep their sums in
//     f32 WMMA accumulators across the whole loop;
//   * no atomics: dq and dk/dv are separate kernels, each writing only its
//     own rows, so results are the same on every run.
// TMA, wgmma and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

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
  static constexpr size_t ACC_BYTES = sizeof(float) * TILE * LDO;
  static constexpr size_t ROW_BYTES = sizeof(float) * TILE;
  static constexpr size_t FWD_SMEM =
      3 * TILE_BYTES + SCORE_BYTES + PROB_BYTES + ACC_BYTES + 2 * ROW_BYTES;
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

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// B2: forward.  grid (T/64, BH); query tiles run longest-first.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int T, float scale) {
  using Dm = Dims<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + TILE * Dm::LDB;
  bf16* v_s = k_s + TILE * Dm::LDB;
  float* s_s = reinterpret_cast<float*>(v_s + TILE * Dm::LDB);
  bf16* p_s = reinterpret_cast<bf16*>(s_s + TILE * LDS);
  float* o_s = reinterpret_cast<float*>(p_s + TILE * LDP);
  float* m_s = o_s + TILE * Dm::LDO;
  float* l_s = m_s + TILE;

  const int nq = T / TILE;
  const int qi = nq - 1 - blockIdx.x;
  const size_t head = (size_t)blockIdx.y * T * D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * 16;

  load_tile<D>(q_s, q + head + (size_t)qi * TILE * D);
  for (int i = threadIdx.x; i < TILE * Dm::LDO; i += THREADS) o_s[i] = 0.f;
  for (int i = threadIdx.x; i < TILE; i += THREADS) {
    m_s[i] = NEG_INF;
    l_s[i] = 0.f;
  }

  for (int kj = 0; kj <= qi; ++kj) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(k_s, k + head + (size_t)kj * TILE * D);
    load_tile<D>(v_s, v + head + (size_t)kj * TILE * D);
    __syncthreads();

    strip_abt<D>(s_s + r0 * LDS, q_s + r0 * Dm::LDB, k_s);
    __syncwarp();

    // Online softmax over this warp's 16 rows; each lane holds 2 columns.
    for (int r = 0; r < 16; ++r) {
      const int row = r0 + r;
      const int qpos = qi * TILE + row;
      float s0 = s_s[row * LDS + lane] * scale;
      float s1 = s_s[row * LDS + lane + 32] * scale;
      if (kj == qi) {
        if (kj * TILE + lane > qpos) s0 = NEG_INF;
        if (kj * TILE + lane + 32 > qpos) s1 = NEG_INF;
      }
      const float m_prev = m_s[row];
      const float m_cur = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_cur);
      const float p1 = expf(s1 - m_cur);
      const float sum = warp_sum(p0 + p1);
      const float corr = expf(m_prev - m_cur);
      p_s[row * LDP + lane] = __float2bfloat16(p0);
      p_s[row * LDP + lane + 32] = __float2bfloat16(p1);
      for (int d = lane; d < D; d += 32) o_s[row * Dm::LDO + d] *= corr;
      if (lane == 0) {
        m_s[row] = m_cur;
        l_s[row] = l_s[row] * corr + sum;
      }
    }
    __syncwarp();

    FragC acc[D / 16];
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      wmma::load_matrix_sync(acc[j], o_s + r0 * Dm::LDO + j * 16, Dm::LDO,
                             wmma::mem_row_major);
    strip_pm<D>(acc, p_s + r0 * LDP, v_s);
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      wmma::store_matrix_sync(o_s + r0 * Dm::LDO + j * 16, acc[j], Dm::LDO,
                              wmma::mem_row_major);
  }
  __syncwarp();

  for (int r = 0; r < 16; ++r) {
    const int row = r0 + r;
    const float l = fmaxf(l_s[row], 1e-30f);
    const size_t out_row = head + (size_t)(qi * TILE + row) * D;
    for (int d = lane; d < D; d += 32)
      o[out_row + d] = __float2bfloat16(o_s[row * Dm::LDO + d] / l);
    if (lane == 0) lse[(size_t)blockIdx.y * T + qi * TILE + row] =
        m_s[row] + logf(l);
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
        scale);
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
