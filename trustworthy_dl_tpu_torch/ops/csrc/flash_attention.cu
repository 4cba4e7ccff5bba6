// Flash attention for Hopper (sm_90a): forward (B2) and backward (B3, as a
// dq kernel and a dk/dv kernel), causal and not.
//
// Replaces trustworthy_dl_tpu/ops/flash_attention.py: _fwd_kernel
// (pallas_call in _flash_fwd) and _dq_kernel / _dkv_kernel (the two
// pallas_calls in _flash_bwd), at causal=True through tddl_flash_fwd,
// tddl_flash_bwd_dq and tddl_flash_bwd_dkv, and at causal=False through
// tddl_flash_fwd_full, tddl_flash_bwd_dq_full and tddl_flash_bwd_dkv_full
// (the ring attention's chunks below the diagonal, and flash_chunk's).
// Each kernel is a template over CAUSAL: the non-causal instance walks every
// key tile (forward, dq) or every query tile (dk/dv) and masks nothing; at
// D = 64 and 128 the non-causal forward and backward are kernels of their
// own, on wgmma (below).  Layout [BH, T, D] bf16, as the JAX wrapper merges
// batch and heads.  The forward writes o (bf16) and the row logsumexp lse
// (f32); the backward rebuilds P = exp(S - lse) from them.  The causal
// backward takes Delta = sum(dO * O) per row from the caller (a plain
// reduction, as the JAX package leaves it to XLA; flash_chunk's caller
// subtracts the lse cotangent from it).  The non-causal dq computes Delta -
// dlse itself for its 64 rows, in f32 from dO and o (dlse the lse
// cotangent, or none), and writes it for dk/dv, which runs after it on the
// same stream: the non-causal backward is two launches.  Scores are scaled
// by 1/sqrt(D) and, in the causal instance, masked with the finite NEG_INF
// of the TPU kernels.
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
// The non-causal instance does the whole score matrix: at the ring's chunk
// [96, 256, 64] the forward moves 12.7 MB (3.79 us) for 1.61 GFLOP (1.63
// us), dq, reading o for Delta and writing Delta, ~19.2 MB (5.7 us) for
// 2.42 GFLOP and dk/dv ~19.1 MB (5.7 us) for 3.22 GFLOP, so bytes bound all
// three; at [96, 1024, 64] the products do: 25.8 / 38.7 / 51.5 GFLOP, 26.1
// / 39.1 / 52.1 us.  Its query tiles all walk the same number of key
// tiles, so the forward's longest-first order has nothing to balance there
// and is kept as it is.  At D = 64 the forward's exponentials weigh as much
// as its products (one ex2 a score on 16 SFU lanes an SM against 2 x 64
// multiply-adds a score on the tensor cores), so they have to run under
// the products, of another tile or another CTA.
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
// dq and dk/dv (B3) are two kernels of the same shape, as the TPU package
// splits them: no atomics, each writes only its own rows, so results are
// the same bit for bit on every run.  Both recompute S and dP (7 products
// against a fused backward's 5).  At [96, 1024, 64] the products bound them:
// ~19.4 us (dq, 3 products) and ~25.9 us (dk/dv, 4) at 989 TFLOP/s.
//   * dq: one CTA of four warps per (64-row query tile, batch*head), tiles
//     longest-first; each warp's Q and dO A-fragments, and its two rows'
//     lse (log2 units) and Delta, stay in registers; K and V come through
//     the 2-stage cp.async ring.  S = Q.K^T and dP = dO.V^T on mma.sync
//     (K's and V's B-fragments by ldmatrix); P = exp2(fma(s, scale log2 e,
//     -lse log2 e)) and dS = P o (dP - Delta) in registers; dS's C tiles,
//     rounded to bf16 pairs, are the A-fragments of dQ += dS.K (K by
//     ldmatrix.trans).  dq stays in f32 registers and is scaled once.
//   * dk/dv: one CTA per (64-row key tile, batch*head), key tile 0 (the
//     longest walk) first; K and V A-fragments in registers; Q, dO and
//     the query tile's 64 lse and 64 Delta values through the ring.  The
//     scores are transposed (S^T = K.Q^T, dP^T = V.dO^T), so a lane reads
//     lse and Delta for its fragment columns as float2 from the staged
//     rows, and the diagonal tile masks key row > query column.  P^T
//     (rounded to bf16, as the plain twin rounds P before P^T.dO) and
//     dS^T are the A-fragments of dV += P^T.dO and dK += dS^T.Q (dO and Q
//     by ldmatrix.trans); both accumulators stay in f32 registers.
//   * D = 128 does not fit that in 255 registers: there the fixed
//     fragments are read again from their tile each step, and dk/dv runs
//     a tile's 64 queries as two groups of 32 (Bwd below; PERF.md has
//     ptxas's registers and spills for every instance).
//   * both epilogues stage bf16 rows in the warp's own rows of a tile it
//     alone reads and write 16-byte coalesced rows.
//   That is the causal pair, and the non-causal one at D = 16 and 32 (its
//   dq adds Delta).
// The non-causal forward and pair at D = 64 and 128 (Wg below) run their
// products on wgmma, which alone reaches the card's full tensor-core rate.
// The C entry picks them by D, never by a failure; D = 16 and 32 stay on
// mma.sync, as their 32- and 64-byte rows would need narrower swizzles
// and no model of the port runs them.
//   * one warpgroup (the CTA's four warps) owns a 64-row tile, so m64nNk16
//     fits the grid as it was: the forward and dq per query tile, dk/dv
//     per key tile;
//   * every operand tile sits in shared memory in the 128-byte-swizzled
//     layout wgmma reads (wgmma_sm90.cuh), written there by hand-swizzled
//     16-byte cp.async copies; no tensor maps, so nothing is encoded on
//     the host per launch;
//   * the streamed tiles (K, V for the forward and dq; Q, dO and the lse
//     and Delta rows for dk/dv) come through a ring tracked by cp.async
//     groups, 3 stages (4 in D = 128's dk/dv): step i copies tile i +
//     STAGES - 2 into the stage tile i - 2 used, whose products every warp
//     has waited for before step i's barrier, so the next products issue
//     without waiting on the last ones' stage (the forward's prologue
//     copies all 3 stages' tiles at once);
//   * forward: S_j = Q.K_j^T (m64n64, both K-major, Q from its swizzled
//     tile) and O += P_{j-1}.V_{j-1} (m64nD, P's bf16 pairs as the register
//     A operand, V MN-major) issue as two commit groups; the online
//     softmax of S_j (flash_fwd_kernel's: quad shuffles, one FFMA and one
//     ex2 a score, l over the unrounded P) runs on the accumulator while
//     P_{j-1}.V_{j-1} is in flight, and only then is O rescaled and P_j
//     packed, so no product in flight has its registers rewritten.  Its o
//     and lse are bit for bit the mma.sync instance's (utils/flash_ab);
//   * dq: S = Q.K^T and dP = dO.V^T as two commit groups of m64n64 with
//     both operands K-major; P = exp2(.) as soon as S lands, while dP
//     runs; dS = P o (dP - Delta) rounded to bf16 pairs is already the
//     register A operand of dQ += dS.K (m64nD), which reads the same K
//     tile MN-major through its descriptor; dQ_j stays in flight under
//     step j + 1's S and dP;
//   * dk/dv: S^T = K.Q^T and dP^T = V.dO^T (m64n64, m64n32 at D = 128,
//     whose two accumulators of 64 f32 leave no room for wider scores); P^T
//     as bf16 pairs feeds dV += P^T.dO while dP^T lands, dS^T feeds dK +=
//     dS^T.Q, dO and Q read MN-major;
//   * the Delta prologue: two lanes a row over alternate 16-byte chunks of
//     dO and o from global memory while the first tiles copy, one shuffle,
//     then each lane takes its fragment rows' values by shuffle;
//   * registers (ptxas, sm_90a, CUDA 12.8): the forward 109 / 160, dq 144
//     / 212 and dk/dv 167 / 224 at D = 64 / 128, 0 spill bytes but for
//     dk/dv's 16 at D = 64; the forward's launch bounds ask for 3 CTAs an
//     SM at D = 64 and 2 at D = 128 (Q and 3 stages: 57 and 113 KB), the
//     pair's for 3 CTAs an SM at D = 64 (dk/dv needs 189
//     registers unbounded; at 2 CTAs an SM it took 1.18x as long at the
//     ring's chunk), 1 at D = 128 (the ring's 128-166 KB of shared
//     memory).  D = 128's dk/dv shares its score registers
//     between its two query groups (declared per group, ptxas serialised
//     its products: C7515), and at one CTA an SM needs its fourth stage:
//     with three it took 1.6x as long (PERF.md has the designs tried,
//     B3-nc).
//   On the H100 the forward at [96, 1024, 64] takes 1.08-1.15x SDPA's device
//   time: with its softmax taken out it still takes 0.95x SDPA's whole
//   forward, so the 64-row tile's products and copies bound it, not the
//   SFU.  A 4-stage ring, Q in registers at 4 CTAs an SM, two warpgroups
//   sharing each K/V tile, 128-key steps and, at D = 128, 2 stages all
//   measured no faster (PERF.md and CHANGES.md, B2-nc).
// Left for later: wgmma for the causal kernels (forward and backward), and
// TMA with a producer warp (setmaxnreg) and mbarriers in place of the
// CTA-wide barrier a tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace mma_sm90;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int TILE = 64;        // query and key tile rows
constexpr int WARPS = 4;        // 16 rows each
constexpr int THREADS = WARPS * 32;

template <int D>
struct Dims {
  static constexpr int LDB = D + 8;  // bf16 [64 x D] tile row stride
  static constexpr size_t TILE_BYTES = sizeof(bf16) * TILE * LDB;
  static constexpr size_t ROW_BYTES = sizeof(float) * TILE;
  static constexpr size_t FWD_SMEM = 5 * TILE_BYTES;  // Q + 2 x (K, V)
};

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

// Writes 16 rows of bf16 staged at `stage` (row stride D + 8) to a [*, D]
// global array with 16-byte coalesced stores; one warp.
template <int D>
__device__ __forceinline__ void store_staged(bf16* dst, const bf16* stage,
                                             int lane) {
  constexpr int VPR = D / 8;
#pragma unroll
  for (int it = 0; it < 16 * VPR / 32; ++it) {
    const int i = lane + it * 32;
    const int r = i / VPR;
    const int c = i % VPR;
    *reinterpret_cast<uint4*>(dst + (size_t)r * D + c * 8) =
        *reinterpret_cast<const uint4*>(stage + r * Dims<D>::LDB + c * 8);
  }
}

// At D <= 64, four CTAs (16 warps) per SM: at most 128 registers a thread.
template <int D, bool CAUSAL>
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
  const int nk = CAUSAL ? qi + 1 : nq;  // key tiles this query tile attends
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

  for (int kj = 0; kj < nk; ++kj) {
    cp_async_wait<0>();  // this thread's copies of tile kj have landed
    __syncthreads();     // everyone's have, and every warp is done with kj - 1
    if (kj + 1 < nk) {   // tile kj + 1 into the stage kj - 1 used
      bf16* nxt = kv_s + ((kj + 1) & 1) * 2 * TILE * LD;
      copy_tile_async<D>(nxt, k + head + (size_t)(kj + 1) * TILE * D);
      copy_tile_async<D>(nxt + TILE * LD,
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

    // Online softmax in registers.  Only the causal diagonal tile is masked.
    if (CAUSAL && kj == qi) {
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
    // exp2(-huge) = 0, never NaN; every row sees its diagonal key (every key
    // when not causal), so the tile's max is a real score.
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
  store_staged<D>(o + head + (size_t)(qi * TILE + r0) * D, stage, lane);
  if ((lane & 3) == 0) {
    float* lrow_out = lse + (size_t)blockIdx.y * T + qi * TILE + r0;
    lrow_out[g] = (m0 + log2f(l0)) * LN2;
    lrow_out[g + 8] = (m1 + log2f(l1)) * LN2;
  }
}

// ---------------------------------------------------------------------------
// B3: backward, as two kernels of B2's shape.  Each warp owns 16 rows for
// the whole loop; its fixed A-fragments (Q and dO in dq, K and V in dk/dv)
// sit in registers where they fit (Bwd::HOLD) and are read again from their
// shared tile each step where they do not; the streamed operand comes
// through a 2-stage cp.async ring with one barrier a tile.
// ---------------------------------------------------------------------------
template <int D>
struct Bwd {
  // D = 128's accumulators alone are 64 (dq) or 128 (dk/dv) f32 a thread:
  // its fixed fragments are reloaded by ldmatrix each step, and dk/dv runs
  // the tile's 64 queries as two groups of 32 to halve its live scores.
  // ptxas (CUDA 12.8): dq 114 / 128 / 166 / 242 and dk/dv 132 / 158 / 242
  // / 255 registers at D = 16 / 32 / 64 / 128, 0 spill bytes (the
  // non-causal instances at D = 16 / 32, dq with its Delta prologue: dq
  // 88 / 128, dk/dv 106 / 163, 0 spill bytes).  On the
  // H100, dq at D = 64 with 2 CTAs an SM (224 registers) took 9% longer,
  // and dk/dv with K and V reloaded at 3 CTAs 5% longer (PERF.md, B3).
  static constexpr bool HOLD = D <= 64;
  static constexpr int DKV_GROUPS = D == 128 ? 2 : 1;
  static constexpr int DQ_MINB = D <= 32 ? 4 : (D == 64 ? 3 : 2);
  static constexpr int DKV_MINB = D <= 32 ? 3 : 2;
  // dq: Q + dO + 2 x (K, V); dk/dv: K + V + 2 x (Q, dO, lse and Delta).
  static constexpr size_t DQ_SMEM = 6 * Dims<D>::TILE_BYTES;
  static constexpr size_t DKV_SMEM =
      6 * Dims<D>::TILE_BYTES + 4 * Dims<D>::ROW_BYTES;
};

// acc[n] x `mul` as bf16 into this warp's 16 staged rows (C-tile layout).
template <int D>
__device__ __forceinline__ void stage_rows(bf16* stage, float (*acc)[4],
                                           float mul, int g, int c2) {
  constexpr int LD = Dims<D>::LDB;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(stage + g * LD + n * 8 + c2) =
        pack_bf16(acc[n][0] * mul, acc[n][1] * mul);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * LD + n * 8 + c2) =
        pack_bf16(acc[n][2] * mul, acc[n][3] * mul);
  }
}

// Delta = sum_d dO o O - dlse (dlse may be null) over this warp's 16 rows
// from `row0` (an index into [BH * T]), in f32: two lanes a row, each
// over alternate 16-byte chunks, then one shuffle.  The even lane writes
// the row to delta_out; returns this lane's rows g and g + 8 (the
// fragment rows of mma.sync and of wgmma's accumulator alike).
template <int D>
__device__ __forceinline__ void warp_delta(const bf16* __restrict__ dout,
                                           const bf16* __restrict__ o,
                                           const float* __restrict__ dlse,
                                           float* __restrict__ delta_out,
                                           size_t row0, int lane, float& dl0,
                                           float& dl1) {
  const int r = lane >> 1;
  const int h = lane & 1;
  const bf16* a = dout + (row0 + r) * D;
  const bf16* b = o + (row0 + r) * D;
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    const int c = (2 * i + h) * 8;
    const uint4 x = *reinterpret_cast<const uint4*>(a + c);
    const uint4 y = *reinterpret_cast<const uint4*>(b + c);
    const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 xf = __bfloat1622float2(xp[e]);
      const float2 yf = __bfloat1622float2(yp[e]);
      sum = fmaf(xf.x, yf.x, sum);
      sum = fmaf(xf.y, yf.y, sum);
    }
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  if (dlse != nullptr) sum -= dlse[row0 + r];
  if (h == 0) delta_out[row0 + r] = sum;
  const int g = lane >> 2;
  dl0 = __shfl_sync(0xffffffffu, sum, 2 * g);
  dl1 = __shfl_sync(0xffffffffu, sum, 2 * (g + 8));
}

// ---------------------------------------------------------------------------
// B3, dq: grid (T/64, BH), query tiles longest-first.
// dQ = scale * (P o (dO.V^T - Delta)) . K over the key tiles at and below
// the diagonal (every key tile when not causal); K and V through the ring.
// ---------------------------------------------------------------------------
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, Bwd<D>::DQ_MINB)
    flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int T, float scale, const bf16* __restrict__ o,
                    const float* __restrict__ dlse,
                    float* __restrict__ delta_out) {
  constexpr int LD = Dims<D>::LDB;
  constexpr int KD = D / 16;
  constexpr int ND = D / 8;
  constexpr bool HOLD = Bwd<D>::HOLD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + TILE * LD;
  bf16* kv_s = do_s + TILE * LD;  // stage s: K at 2s, V at 2s + 1 tiles

  const int nq = T / TILE;
  const int qi = nq - 1 - blockIdx.x;
  const int nk = CAUSAL ? qi + 1 : nq;
  const size_t head = (size_t)blockIdx.y * T * D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * 16;
  const int g = lane >> 2;
  const int c2 = (lane & 3) * 2;
  const int lrow = lane & 7;
  const int lm0 = (lane >> 3) & 1;
  const int lm1 = lane >> 4;

  copy_tile_async<D>(q_s, q + head + (size_t)qi * TILE * D);
  copy_tile_async<D>(do_s, dout + head + (size_t)qi * TILE * D);
  copy_tile_async<D>(kv_s, k + head);
  copy_tile_async<D>(kv_s + TILE * LD, v + head);
  cp_async_commit();

  // This lane's two rows (g, g + 8): lse in log2 units, and Delta (the
  // caller's when causal; computed here, and written out, when not).
  const size_t row = (size_t)blockIdx.y * T + qi * TILE + r0 + g;
  const float nl0 = -lse[row] * LOG2E, nl1 = -lse[row + 8] * LOG2E;
  float dl0, dl1;
  if constexpr (CAUSAL) {
    dl0 = delta[row];
    dl1 = delta[row + 8];
  } else {
    warp_delta<D>(dout, o, dlse, delta_out, row - g, lane, dl0, dl1);
  }
  const float scale_log2 = scale * LOG2E;
  // The A-fragment row address of this lane in the warp's rows.
  const int arow = (r0 + lrow + lm0 * 8) * LD + lm1 * 8;

  uint32_t qf[HOLD ? KD : 1][4], dof[HOLD ? KD : 1][4];
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kj = 0; kj < nk; ++kj) {
    cp_async_wait<0>();
    __syncthreads();
    if (kj + 1 < nk) {
      bf16* nxt = kv_s + ((kj + 1) & 1) * 2 * TILE * LD;
      copy_tile_async<D>(nxt, k + head + (size_t)(kj + 1) * TILE * D);
      copy_tile_async<D>(nxt + TILE * LD,
                         v + head + (size_t)(kj + 1) * TILE * D);
      cp_async_commit();
    }
    const bf16* k_s = kv_s + (kj & 1) * 2 * TILE * LD;
    const bf16* v_s = k_s + TILE * LD;
    if constexpr (HOLD) {
      if (kj == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          ldsm_x4(qf[kk], q_s + arow + kk * 16);
          ldsm_x4(dof[kk], do_s + arow + kk * 16);
        }
      }
    }

    // S = Q.K^T and dP = dO.V^T over this tile's 64 keys (8 n8 tiles).
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], da[4];
      if constexpr (HOLD) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qa[i] = qf[kk][i];
          da[i] = dof[kk][i];
        }
      } else {
        ldsm_x4(qa, q_s + arow + kk * 16);
        ldsm_x4(da, do_s + arow + kk * 16);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int boff = (jj * 16 + lrow + lm1 * 8) * LD + kk * 16 + lm0 * 8;
        uint32_t b[4];
        ldsm_x4(b, k_s + boff);
        mma_bf16(s[2 * jj], qa, b[0], b[1]);
        mma_bf16(s[2 * jj + 1], qa, b[2], b[3]);
        ldsm_x4(b, v_s + boff);
        mma_bf16(dp[2 * jj], da, b[0], b[1]);
        mma_bf16(dp[2 * jj + 1], da, b[2], b[3]);
      }
    }

    // P = exp2(s * scale log2 e - lse log2 e), masked to 0 above the
    // diagonal when causal; dS = P o (dP - Delta), packed to bf16 pairs: n8
    // tiles 2kk and 2kk + 1 are dS.K's k16 step kk.
    const bool diag = CAUSAL && kj == qi;
    uint32_t dsf[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(s[j][e], scale_log2, e < 2 ? nl0 : nl1));
        if (diag && j * 8 + c2 + (e & 1) > r0 + g + (e >> 1) * 8) p = 0.f;
        ds[e] = p * (dp[j][e] - (e < 2 ? dl0 : dl1));
      }
      dsf[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
      dsf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dQ += dS . K: K's B-fragments through ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int nn = 0; nn < KD; ++nn) {
        uint32_t b[4];
        ldsm_x4_trans(b, k_s + (kk * 16 + lrow + lm0 * 8) * LD + nn * 16 +
                             lm1 * 8);
        mma_bf16(acc[2 * nn], dsf[kk], b[0], b[1]);
        mma_bf16(acc[2 * nn + 1], dsf[kk], b[2], b[3]);
      }
    }
  }

  // Epilogue: this warp's rows of the Q tile (read only by this warp)
  // stage the bf16 rows for 16-byte coalesced stores.
  bf16* stage = q_s + r0 * LD;
  __syncwarp();
  stage_rows<D>(stage, acc, scale, g, c2);
  __syncwarp();
  store_staged<D>(dq + head + (size_t)(qi * TILE + r0) * D, stage, lane);
}

// ---------------------------------------------------------------------------
// B3, dk/dv: grid (T/64, BH), one key tile each (tile 0, the longest walk,
// first), walking the query tiles at and below the diagonal (every query
// tile when not causal).
// dV = P^T . dO, dK = scale * dS^T . Q; Q, dO and the tile's lse and Delta
// through the ring.  The scores are transposed (keys are the warp's rows,
// queries its columns), so a lane reads lse and Delta for its columns.
// ---------------------------------------------------------------------------
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, Bwd<D>::DKV_MINB)
    flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int T, float scale) {
  constexpr int LD = Dims<D>::LDB;
  constexpr int KD = D / 16;
  constexpr int ND = D / 8;
  constexpr bool HOLD = Bwd<D>::HOLD;
  constexpr int NJ = 8 / Bwd<D>::DKV_GROUPS;  // n8 query tiles a group
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + TILE * LD;
  bf16* ring = v_s + TILE * LD;  // stage s: Q at 2s, dO at 2s + 1 tiles
  // stage s: lse at 2s, Delta at 2s + 1 rows of 64.
  float* rows_s = reinterpret_cast<float*>(ring + 4 * TILE * LD);

  const int nq = T / TILE;
  const int kj = blockIdx.x;
  const int q0 = CAUSAL ? kj : 0;  // the first query tile this key tile meets
  const size_t head = (size_t)blockIdx.y * T * D;
  const size_t head_rows = (size_t)blockIdx.y * T;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * 16;
  const int g = lane >> 2;
  const int c2 = (lane & 3) * 2;
  const int lrow = lane & 7;
  const int lm0 = (lane >> 3) & 1;
  const int lm1 = lane >> 4;

  // Query tile qi's Q, dO, lse and Delta into ring stage st; the rows are
  // 16 copies of 16 bytes each, by the first warp.
  auto copy_stage = [&](int st, int qi) {
    bf16* dst = ring + st * 2 * TILE * LD;
    copy_tile_async<D>(dst, q + head + (size_t)qi * TILE * D);
    copy_tile_async<D>(dst + TILE * LD, dout + head + (size_t)qi * TILE * D);
    if (threadIdx.x < 32) {
      const int i = (threadIdx.x & 15) * 4;
      const float* src = threadIdx.x < 16 ? lse : delta;
      cp_async16(rows_s + (2 * st + (threadIdx.x >> 4)) * TILE + i,
                 src + head_rows + qi * TILE + i);
    }
  };

  copy_tile_async<D>(k_s, k + head + (size_t)kj * TILE * D);
  copy_tile_async<D>(v_s, v + head + (size_t)kj * TILE * D);
  copy_stage(0, q0);
  cp_async_commit();

  const float scale_log2 = scale * LOG2E;
  const int arow = (r0 + lrow + lm0 * 8) * LD + lm1 * 8;
  uint32_t kf[HOLD ? KD : 1][4], vf[HOLD ? KD : 1][4];
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int qi = q0; qi < nq; ++qi) {
    const int st = (qi - q0) & 1;
    cp_async_wait<0>();
    __syncthreads();
    if (qi + 1 < nq) {
      copy_stage(st ^ 1, qi + 1);
      cp_async_commit();
    }
    const bf16* q_s = ring + st * 2 * TILE * LD;
    const bf16* do_s = q_s + TILE * LD;
    const float* lse_s = rows_s + 2 * st * TILE;
    const float* dl_s = lse_s + TILE;
    if constexpr (HOLD) {
      if (qi == q0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          ldsm_x4(kf[kk], k_s + arow + kk * 16);
          ldsm_x4(vf[kk], v_s + arow + kk * 16);
        }
      }
    }
    const bool diag = CAUSAL && qi == kj;

#pragma unroll
    for (int grp = 0; grp < Bwd<D>::DKV_GROUPS; ++grp) {
      const int col0 = grp * NJ * 8;  // the group's first query column
      // S^T = K.Q^T and dP^T = V.dO^T over the group's queries.
      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ka[4], va[4];
        if constexpr (HOLD) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ka[i] = kf[kk][i];
            va[i] = vf[kk][i];
          }
        } else {
          ldsm_x4(ka, k_s + arow + kk * 16);
          ldsm_x4(va, v_s + arow + kk * 16);
        }
#pragma unroll
        for (int jj = 0; jj < NJ / 2; ++jj) {
          const int boff = (col0 + jj * 16 + lrow + lm1 * 8) * LD + kk * 16 +
                           lm0 * 8;
          uint32_t b[4];
          ldsm_x4(b, q_s + boff);
          mma_bf16(s[2 * jj], ka, b[0], b[1]);
          mma_bf16(s[2 * jj + 1], ka, b[2], b[3]);
          ldsm_x4(b, do_s + boff);
          mma_bf16(dp[2 * jj], va, b[0], b[1]);
          mma_bf16(dp[2 * jj + 1], va, b[2], b[3]);
        }
      }

      // P^T and dS^T, packed to bf16 pairs as A-fragments (k over queries).
      uint32_t pf[NJ / 2][4], dsf[NJ / 2][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = col0 + j * 8 + c2;
        const float2 l = *reinterpret_cast<const float2*>(lse_s + col);
        const float2 dl = *reinterpret_cast<const float2*>(dl_s + col);
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lc = (e & 1) ? l.y : l.x;
          p[e] = ex2(fmaf(s[j][e], scale_log2, -lc * LOG2E));
          if (diag && r0 + g + (e >> 1) * 8 > col + (e & 1)) p[e] = 0.f;
          ds[e] = p[e] * (dp[j][e] - ((e & 1) ? dl.y : dl.x));
        }
        pf[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
        pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
        dsf[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
        dsf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }

      // dV += P^T . dO and dK += dS^T . Q: dO's and Q's B-fragments
      // through ldmatrix.trans.
#pragma unroll
      for (int kk = 0; kk < NJ / 2; ++kk) {
#pragma unroll
        for (int nn = 0; nn < KD; ++nn) {
          const int boff = (col0 + kk * 16 + lrow + lm0 * 8) * LD + nn * 16 +
                           lm1 * 8;
          uint32_t b[4];
          ldsm_x4_trans(b, do_s + boff);
          mma_bf16(dva[2 * nn], pf[kk], b[0], b[1]);
          mma_bf16(dva[2 * nn + 1], pf[kk], b[2], b[3]);
          ldsm_x4_trans(b, q_s + boff);
          mma_bf16(dka[2 * nn], dsf[kk], b[0], b[1]);
          mma_bf16(dka[2 * nn + 1], dsf[kk], b[2], b[3]);
        }
      }
    }
  }

  // Epilogue: dV stages in this warp's rows of the K tile, dK in its rows
  // of the V tile (each read only by this warp).
  const size_t out = head + (size_t)(kj * TILE + r0) * D;
  __syncwarp();
  stage_rows<D>(k_s + r0 * LD, dva, 1.f, g, c2);
  stage_rows<D>(v_s + r0 * LD, dka, scale, g, c2);
  __syncwarp();
  store_staged<D>(dv + out, k_s + r0 * LD, lane);
  store_staged<D>(dk + out, v_s + r0 * LD, lane);
}

// ---------------------------------------------------------------------------
// B3 at causal=False, D = 64 and 128: dq (with Delta) and dk/dv on wgmma.
// One warpgroup (the CTA's four warps) owns a 64-row tile; every operand
// tile sits in shared memory in the 128-byte-swizzled layout wgmma reads
// (wgmma_sm90.cuh), copied there by hand-swizzled cp.async.  The streamed
// tiles come through a ring of STAGES stages tracked by cp.async groups:
// step i copies tile i + STAGES - 2 into the stage tile i - 2 used, whose
// products every warp has waited for before step i's barrier, so one
// stage drains while one is read and the rest fill.
// ---------------------------------------------------------------------------
template <int D>
struct Wg {
  static constexpr uint32_t BLOCK_BYTES = TILE * wgmma_sm90::SW128_ROW;
  static constexpr uint32_t TILE_BYTES = (D / 64) * BLOCK_BYTES;
  // Ring stages (of K and V in dq, of Q and dO in dk/dv): 3, so three
  // CTAs fit an SM at D = 64; D = 128's dk/dv, one CTA an SM, takes 4 and
  // keeps two tiles ahead.
  static constexpr int DQ_STAGES = 3;
  static constexpr int DKV_STAGES = D == 64 ? 3 : 4;
  // dk/dv's queries a group: D = 128's two accumulators are 128 f32 a
  // thread, so its scores go 32 queries at a time (m64n32).
  static constexpr int NQ = D == 128 ? 32 : 64;
  // dq: Q, dO and the ring's (K, V); dk/dv: K, V and the ring's (Q, dO)
  // and (lse, Delta) rows; 1024 bytes to align the base.
  static constexpr size_t DQ_SMEM = (2 + 2 * DQ_STAGES) * TILE_BYTES + 1024;
  static constexpr size_t DKV_SMEM = (2 + 2 * DKV_STAGES) * TILE_BYTES +
                                     DKV_STAGES * 2 * Dims<D>::ROW_BYTES +
                                     1024;
  static constexpr int MIN_BLOCKS = D == 64 ? 3 : 1;  // CTAs an SM
  // The forward: Q and the ring's (K, V).  3 stages keep 3 CTAs an SM at
  // D = 64 and 2 at D = 128 (2 x 114,688 bytes with the base's and the
  // runtime's 1 KB each: the SM's 228 KB).
  static constexpr int FWD_STAGES = 3;
  static constexpr size_t FWD_SMEM = (1 + 2 * FWD_STAGES) * TILE_BYTES + 1024;
  static constexpr int FWD_MIN_BLOCKS = D == 64 ? 3 : 2;
};

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// [64, D] rows of a [*, D] bf16 array into a swizzled tile, 16 bytes a
// thread per cp.async: row r's chunk c to column block c / 8, chunk
// (c % 8) ^ (r % 8).
template <int D>
__device__ __forceinline__ void copy_tile_sw128(unsigned char* dst,
                                                const bf16* src) {
  constexpr int VPR = D / 8;
#pragma unroll
  for (int it = 0; it < TILE * VPR / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / VPR;
    const int c = i % VPR;
    cp_async16(dst + (c >> 3) * Wg<D>::BLOCK_BYTES +
                   r * wgmma_sm90::SW128_ROW + (((c & 7) ^ (r & 7)) << 4),
               src + (size_t)r * D + c * 8);
  }
}

// acc (+)= A . B over one k16 step: m64nN with A and B K-major.
template <int N>
__device__ __forceinline__ void wg_ss(float (&acc)[N / 8][4], uint64_t da,
                                      uint64_t db, int scale_d) {
  if constexpr (N == 64)
    wgmma_sm90::ss_n64(acc, da, db, scale_d);
  else
    wgmma_sm90::ss_n32(acc, da, db, scale_d);
}

// acc += A . B over one k16 step: m64nD, A from registers, B MN-major.
template <int D>
__device__ __forceinline__ void wg_rs(float (&acc)[D / 8][4],
                                      const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 64)
    wgmma_sm90::rs_n64(acc, a, db, 1);
  else
    wgmma_sm90::rs_n128(acc, a, db, 1);
}

// ---------------------------------------------------------------------------
// B2 at causal=False, D = 64 and 128: grid (T/64, BH).  Q fixed; K and V
// through the ring, whose prologue copies the first FWD_STAGES tiles (so
// at the ring's chunk, 4 key tiles, most are in flight from the start);
// step j >= 2 then copies tile j + FWD_STAGES - 2 into the stage tile j - 2
// used.  Per key tile j: S_j = Q.K_j^T (m64n64, K-major) and O +=
// P_{j-1}.V_{j-1} (m64nD, P from registers, V read MN-major) issue as two
// commit groups; the online softmax of S_j runs while P_{j-1}.V_{j-1} is
// in flight, and O is rescaled, and P_j packed, once it has landed.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS, Wg<D>::FWD_MIN_BLOCKS)
    flash_fwd_wgmma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o,
                           float* __restrict__ lse, int T, float scale_log2) {
  namespace wg = wgmma_sm90;
  using W = Wg<D>;
  constexpr int S = W::FWD_STAGES;
  constexpr uint32_t TB = W::TILE_BYTES;
  constexpr uint32_t BB = W::BLOCK_BYTES;
  constexpr int LD = Dims<D>::LDB;
  constexpr float LN2 = 0.69314718055994531f;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* kv_s = smem + TB;  // stage s: K at 2s, V at 2s + 1

  const int nk = T / TILE;
  const int qi = blockIdx.x;
  const size_t head = (size_t)blockIdx.y * T * D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c2 = (lane & 3) * 2;

  auto copy_kv = [&](int kj) {  // one cp.async group, empty past the end
    if (kj < nk) {
      unsigned char* dst = kv_s + (kj % S) * 2 * TB;
      copy_tile_sw128<D>(dst, k + head + (size_t)kj * TILE * D);
      copy_tile_sw128<D>(dst + TB, v + head + (size_t)kj * TILE * D);
    }
    cp_async_commit();
  };
  copy_tile_sw128<D>(smem, q + head + (size_t)qi * TILE * D);
#pragma unroll
  for (int j = 0; j < S; ++j) copy_kv(j);  // Q rides in tile 0's group

  // Group j holds tile j: S groups in the prologue, one a step from step 2.
  auto tile_landed = [&](int kj) {
    if (kj == 0)
      cp_async_wait<S - 1>();
    else if (kj == 1)
      cp_async_wait<S - 2>();
    else
      cp_async_wait<S - 3>();
    wg::fence_proxy_async();
    __syncthreads();  // everyone's copies; tile kj - 2's products are done
    if (kj >= 2) copy_kv(kj + S - 2);
  };

  const uint32_t q_a = smem_u32(smem);
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float s[8][4];
  uint32_t pf[4][4];  // P of the last tile as bf16 A-fragments
  float m0 = NEG_INF, m1 = NEG_INF;  // running max, scaled log2 units
  float l0 = 0.f, l1 = 0.f;          // this lane's share of the row sums
  float corr0, corr1;

  auto scores = [&](int kj) {  // S = Q.K_kj^T, one commit group
    const uint32_t k_a = smem_u32(kv_s + (kj % S) * 2 * TB);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg_ss<64>(s, wg::desc_kmajor(q_a, kk, BB), wg::desc_kmajor(k_a, kk, BB),
                kk > 0);
    wg::commit();
  };
  auto pv = [&](int kj) {  // O += P.V_kj, one commit group
    const uint32_t v_a = smem_u32(kv_s + (kj % S) * 2 * TB + TB);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg_rs<D>(acc, pf[kk], wg::desc_mnmajor(v_a, kk, BB));
    wg::commit();
  };
  // The online softmax of S in place, as flash_fwd_kernel's: the running
  // max takes S's (two quad shuffles a row), P = exp2(s * scale_log2 - m)
  // with one FFMA and one ex2 each, l sums the unrounded P; corr is the
  // factor of the rows' earlier sums (0 at the first tile: m starts at
  // the finite NEG_INF).
  auto softmax = [&]() {
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
    mx0 = fmaxf(m0, mx0 * scale_log2);
    mx1 = fmaxf(m1, mx1 * scale_log2);
    corr0 = ex2(m0 - mx0);
    corr1 = ex2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= corr0;
    l1 *= corr1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = ex2(fmaf(s[j][0], scale_log2, -mx0));
      s[j][1] = ex2(fmaf(s[j][1], scale_log2, -mx0));
      s[j][2] = ex2(fmaf(s[j][2], scale_log2, -mx1));
      s[j][3] = ex2(fmaf(s[j][3], scale_log2, -mx1));
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }
  };
  // P's n8 tiles 2kk and 2kk + 1, rounded to bf16 pairs, are P.V's k16
  // step kk.
  auto pack_p = [&]() {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      pf[j >> 1][(j & 1) * 2] = pack_bf16(s[j][0], s[j][1]);
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(s[j][2], s[j][3]);
    }
  };

  tile_landed(0);
  wg::fence();
  scores(0);
  wg::wait<0>();
  wg::fence_regs(s);
  softmax();  // O is still 0: nothing to rescale
  pack_p();
  for (int kj = 1; kj < nk; ++kj) {
    tile_landed(kj);
    wg::fence();
    scores(kj);
    pv(kj - 1);
    wg::wait<1>();  // S has landed; P.V may still run
    wg::fence_regs(s);
    softmax();
    wg::wait<0>();  // P.V has landed: O and P's registers are free
    wg::fence_regs(acc);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= corr0;
      acc[n][1] *= corr0;
      acc[n][2] *= corr1;
      acc[n][3] *= corr1;
    }
    pack_p();
  }
  wg::fence();
  pv(nk - 1);
  wg::wait<0>();
  wg::fence_regs(acc);

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;

  // Epilogue: the Q tile and the ring, free once every warp's products
  // are done, stage the bf16 rows for 16-byte coalesced stores.
  __syncthreads();
  bf16* stage = reinterpret_cast<bf16*>(smem) + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(stage + g * LD + n * 8 + c2) =
        pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * LD + n * 8 + c2) =
        pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
  __syncwarp();
  store_staged<D>(o + head + (size_t)(qi * TILE + warp * 16) * D, stage,
                  lane);
  if ((lane & 3) == 0) {
    float* lrow_out = lse + (size_t)blockIdx.y * T + qi * TILE + warp * 16;
    lrow_out[g] = (m0 + log2f(l0)) * LN2;
    lrow_out[g + 8] = (m1 + log2f(l1)) * LN2;
  }
}

// ---------------------------------------------------------------------------
// dq: grid (T/64, BH).  Q and dO fixed; K and V through the ring.  Per key
// tile: S = Q.K^T and dP = dO.V^T (m64n64, K-major), P = exp2(.) once S
// has landed while dP runs, dS = P o (dP - Delta) rounded to bf16 pairs as
// the A registers of dQ += dS.K (m64nD, K read MN-major from the same
// tile).  dQ_j stays in flight under step j + 1's S and dP.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS, Wg<D>::MIN_BLOCKS)
    flash_dq_wgmma_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const bf16* __restrict__ o,
                          const float* __restrict__ lse,
                          const float* __restrict__ dlse,
                          float* __restrict__ delta, bf16* __restrict__ dq,
                          int T, float scale) {
  namespace wg = wgmma_sm90;
  using W = Wg<D>;
  constexpr int S = W::DQ_STAGES;
  constexpr uint32_t TB = W::TILE_BYTES;
  constexpr uint32_t BB = W::BLOCK_BYTES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* q_s = smem;
  unsigned char* do_s = smem + TB;
  unsigned char* kv_s = smem + 2 * TB;  // stage s: K at 2s, V at 2s + 1

  const int nq = T / TILE;
  const int qi = blockIdx.x;
  const size_t head = (size_t)blockIdx.y * T * D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c2 = (lane & 3) * 2;

  auto copy_kv = [&](int kj) {  // one cp.async group, empty past the end
    if (kj < nq) {
      unsigned char* dst = kv_s + (kj % S) * 2 * TB;
      copy_tile_sw128<D>(dst, k + head + (size_t)kj * TILE * D);
      copy_tile_sw128<D>(dst + TB, v + head + (size_t)kj * TILE * D);
    }
    cp_async_commit();
  };
  copy_tile_sw128<D>(q_s, q + head + (size_t)qi * TILE * D);
  copy_tile_sw128<D>(do_s, dout + head + (size_t)qi * TILE * D);
  copy_kv(0);
#pragma unroll
  for (int j = 1; j < S - 2; ++j) copy_kv(j);

  // Delta of the warp's rows while the copies fly; lse in log2 units.
  const size_t row0 = (size_t)blockIdx.y * T + qi * TILE + warp * 16;
  float dl0, dl1;
  warp_delta<D>(dout, o, dlse, delta, row0, lane, dl0, dl1);
  const float nl0 = -lse[row0 + g] * LOG2E;
  const float nl1 = -lse[row0 + g + 8] * LOG2E;
  const float scale_log2 = scale * LOG2E;
  const uint32_t q_a = smem_u32(q_s);
  const uint32_t do_a = smem_u32(do_s);

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kj = 0; kj < nq; ++kj) {
    cp_async_wait<S - 3>();  // this thread's copies of tile kj have landed
    wg::fence_proxy_async();
    __syncthreads();  // everyone's have; tile kj - 2's products are done
    copy_kv(kj + S - 2);
    const uint32_t k_a = smem_u32(kv_s + (kj % S) * 2 * TB);
    const uint32_t v_a = k_a + TB;

    float s[8][4], dp[8][4];
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg_ss<64>(s, wg::desc_kmajor(q_a, kk, BB), wg::desc_kmajor(k_a, kk, BB),
                kk > 0);
    wg::commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg_ss<64>(dp, wg::desc_kmajor(do_a, kk, BB),
                wg::desc_kmajor(v_a, kk, BB), kk > 0);
    wg::commit();

    wg::wait<1>();  // S (and dQ of the step before) have landed
    wg::fence_regs(s);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = ex2(fmaf(s[j][e], scale_log2, e < 2 ? nl0 : nl1));
    wg::wait<0>();
    wg::fence_regs(dp);
    // dS's n8 tiles 2kk and 2kk + 1 are dQ's k16 step kk.
    uint32_t dsf[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[e] = s[j][e] * (dp[j][e] - (e < 2 ? dl0 : dl1));
      dsf[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
      dsf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg_rs<D>(acc, dsf[kk], wg::desc_mnmajor(k_a, kk, BB));
    wg::commit();
  }
  wg::wait<0>();
  wg::fence_regs(acc);

  // Epilogue: the Q and dO tiles, free once every warp's products are
  // done, stage the bf16 rows for 16-byte coalesced stores.
  __syncthreads();
  bf16* stage = reinterpret_cast<bf16*>(smem) + warp * 16 * Dims<D>::LDB;
  stage_rows<D>(stage, acc, scale, g, c2);
  __syncwarp();
  store_staged<D>(dq + head + (size_t)(qi * TILE + warp * 16) * D, stage,
                  lane);
}

// ---------------------------------------------------------------------------
// dk/dv: grid (T/64, BH), one key tile each.  K and V fixed; Q, dO and the
// query tile's lse and Delta rows through the ring.  Per query tile, in
// groups of NQ queries: S^T = K.Q^T and dP^T = V.dO^T (m64nNQ, K-major);
// P^T = exp2(.) from the staged lse of its columns, rounded to bf16 pairs
// as the A registers of dV += P^T.dO (issued while dP^T lands); dS^T = P^T
// o (dP^T - Delta) as those of dK += dS^T.Q (dO and Q read MN-major).
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS, Wg<D>::MIN_BLOCKS)
    flash_dkv_wgmma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int T, float scale) {
  namespace wg = wgmma_sm90;
  using W = Wg<D>;
  constexpr int S = W::DKV_STAGES;
  constexpr int NQ = W::NQ;
  constexpr int NJ = NQ / 8;  // n8 query tiles a group
  constexpr uint32_t TB = W::TILE_BYTES;
  constexpr uint32_t BB = W::BLOCK_BYTES;
  constexpr int LD = Dims<D>::LDB;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* ring = smem + 2 * TB;  // stage s: Q at 2s, dO at 2s + 1
  // stage s: lse at 2s, Delta at 2s + 1 rows of 64.
  float* rows_s = reinterpret_cast<float*>(ring + 2 * S * TB);

  const int nq = T / TILE;
  const int kj = blockIdx.x;
  const size_t head = (size_t)blockIdx.y * T * D;
  const size_t head_rows = (size_t)blockIdx.y * T;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * 16;
  const int g = lane >> 2;
  const int c2 = (lane & 3) * 2;

  auto copy_stage = [&](int qi) {  // one cp.async group, empty past the end
    if (qi < nq) {
      const int st = qi % S;
      unsigned char* dst = ring + st * 2 * TB;
      copy_tile_sw128<D>(dst, q + head + (size_t)qi * TILE * D);
      copy_tile_sw128<D>(dst + TB, dout + head + (size_t)qi * TILE * D);
      if (threadIdx.x < 32) {
        const int i = (threadIdx.x & 15) * 4;
        const float* src = threadIdx.x < 16 ? lse : delta;
        cp_async16(rows_s + (2 * st + (threadIdx.x >> 4)) * TILE + i,
                   src + head_rows + qi * TILE + i);
      }
    }
    cp_async_commit();
  };
  copy_tile_sw128<D>(smem, k + head + (size_t)kj * TILE * D);
  copy_tile_sw128<D>(smem + TB, v + head + (size_t)kj * TILE * D);
  copy_stage(0);
#pragma unroll
  for (int j = 1; j < S - 2; ++j) copy_stage(j);

  const float scale_log2 = scale * LOG2E;
  const uint32_t k_a = smem_u32(smem);
  const uint32_t v_a = k_a + TB;
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  float s[NJ][4], dp[NJ][4];
  for (int qi = 0; qi < nq; ++qi) {
    cp_async_wait<S - 3>();
    wg::fence_proxy_async();
    __syncthreads();
    copy_stage(qi + S - 2);
    const int st = qi % S;
    const uint32_t q_a = smem_u32(ring + st * 2 * TB);
    const uint32_t do_a = q_a + TB;
    const float* lse_s = rows_s + 2 * st * TILE;
    const float* dl_s = lse_s + TILE;

#pragma unroll
    for (int grp = 0; grp < TILE / NQ; ++grp) {
      const int col0 = grp * NQ;  // the group's first query
      const uint32_t qg_a = q_a + col0 * wg::SW128_ROW;
      const uint32_t dog_a = do_a + col0 * wg::SW128_ROW;
      // The groups share s and dp: a group's products overwrite the last
      // group's values in place (scale_d = 0), with no copy between.
      wg::fence_regs(s);
      wg::fence_regs(dp);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wg_ss<NQ>(s, wg::desc_kmajor(k_a, kk, BB),
                  wg::desc_kmajor(qg_a, kk, BB), kk > 0);
      wg::commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wg_ss<NQ>(dp, wg::desc_kmajor(v_a, kk, BB),
                  wg::desc_kmajor(dog_a, kk, BB), kk > 0);
      wg::commit();

      wg::wait<1>();  // S^T (and every product before dP^T) have landed
      wg::fence_regs(s);
      // P^T in place of S^T, and as bf16 A-fragments (k over queries).
      uint32_t pf[NJ / 2][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float2 l =
            *reinterpret_cast<const float2*>(lse_s + col0 + j * 8 + c2);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = ex2(fmaf(s[j][e], scale_log2,
                             -((e & 1) ? l.y : l.x) * LOG2E));
        pf[j >> 1][(j & 1) * 2] = pack_bf16(s[j][0], s[j][1]);
        pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(s[j][2], s[j][3]);
      }
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < NJ / 2; ++kk)
        wg_rs<D>(dva, pf[kk], wg::desc_mnmajor(dog_a, kk, BB));
      wg::commit();

      wg::wait<1>();  // dP^T has landed; dV may still run
      wg::fence_regs(dp);
      uint32_t dsf[NJ / 2][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float2 dl =
            *reinterpret_cast<const float2*>(dl_s + col0 + j * 8 + c2);
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[e] = s[j][e] * (dp[j][e] - ((e & 1) ? dl.y : dl.x));
        dsf[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
        dsf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < NJ / 2; ++kk)
        wg_rs<D>(dka, dsf[kk], wg::desc_mnmajor(qg_a, kk, BB));
      wg::commit();
    }
  }
  wg::wait<0>();
  wg::fence_regs(dka);
  wg::fence_regs(dva);

  // Epilogue: the ring, free once every warp's products are done, stages
  // dV's rows and then dK's.
  __syncthreads();
  bf16* stage_v = reinterpret_cast<bf16*>(ring) + r0 * LD;
  bf16* stage_k = stage_v + TILE * LD;
  stage_rows<D>(stage_v, dva, 1.f, g, c2);
  stage_rows<D>(stage_k, dka, scale, g, c2);
  __syncwarp();
  const size_t out = head + (size_t)(kj * TILE + r0) * D;
  store_staged<D>(dv + out, stage_v, lane);
  store_staged<D>(dk + out, stage_k, lane);
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// One entry's arrays: Delta is read by dk/dv and by the causal dq, and
// written by the non-causal dq, which also reads o and dlse (null where no
// lse cotangent is folded in).
struct Ptrs {
  const void *q, *k, *v, *dout, *o, *lse, *dlse;
  void *delta, *out0, *out1;
};

template <int D, bool CAUSAL>
int launch(int which, const Ptrs& p, int BH, int T, cudaStream_t stream) {
  using Dm = Dims<D>;
  const dim3 grid(T / TILE, BH);
  const float scale = (float)(1.0 / sqrt((double)D));
  const bf16* qb = static_cast<const bf16*>(p.q);
  const bf16* kb = static_cast<const bf16*>(p.k);
  const bf16* vb = static_cast<const bf16*>(p.v);
  const bf16* dob = static_cast<const bf16*>(p.dout);
  const float* lse = static_cast<const float*>(p.lse);
  float* delta = static_cast<float*>(p.delta);
  // Non-causal B2 and B3 at D = 64 and 128 run on wgmma; at D = 16 and 32
  // (a product of K = 16 or 32, too short to feed wgmma) on mma.sync.
  constexpr bool WG = !CAUSAL && D >= 64;
  int err;
  if (which == 0) {
    if constexpr (WG) {
      if ((err = prepare(flash_fwd_wgmma_kernel<D>, Wg<D>::FWD_SMEM)))
        return err;
      flash_fwd_wgmma_kernel<D><<<grid, THREADS, Wg<D>::FWD_SMEM, stream>>>(
          qb, kb, vb, static_cast<bf16*>(p.out0),
          static_cast<float*>(p.out1), T, scale * LOG2E);
    } else {
      if ((err = prepare(flash_fwd_kernel<D, CAUSAL>, Dm::FWD_SMEM)))
        return err;
      flash_fwd_kernel<D, CAUSAL><<<grid, THREADS, Dm::FWD_SMEM, stream>>>(
          qb, kb, vb, static_cast<bf16*>(p.out0),
          static_cast<float*>(p.out1), T, scale * LOG2E);
    }
  } else if constexpr (WG) {
    if (which == 1) {
      if ((err = prepare(flash_dq_wgmma_kernel<D>, Wg<D>::DQ_SMEM)))
        return err;
      flash_dq_wgmma_kernel<D><<<grid, THREADS, Wg<D>::DQ_SMEM, stream>>>(
          qb, kb, vb, dob, static_cast<const bf16*>(p.o), lse,
          static_cast<const float*>(p.dlse), delta,
          static_cast<bf16*>(p.out0), T, scale);
    } else {
      if ((err = prepare(flash_dkv_wgmma_kernel<D>, Wg<D>::DKV_SMEM)))
        return err;
      flash_dkv_wgmma_kernel<D><<<grid, THREADS, Wg<D>::DKV_SMEM, stream>>>(
          qb, kb, vb, dob, lse, delta, static_cast<bf16*>(p.out0),
          static_cast<bf16*>(p.out1), T, scale);
    }
  } else if (which == 1) {
    if ((err = prepare(flash_dq_kernel<D, CAUSAL>, Bwd<D>::DQ_SMEM)))
      return err;
    flash_dq_kernel<D, CAUSAL><<<grid, THREADS, Bwd<D>::DQ_SMEM, stream>>>(
        qb, kb, vb, dob, lse, delta, static_cast<bf16*>(p.out0), T, scale,
        static_cast<const bf16*>(p.o), static_cast<const float*>(p.dlse),
        delta);
  } else {
    if ((err = prepare(flash_dkv_kernel<D, CAUSAL>, Bwd<D>::DKV_SMEM)))
      return err;
    flash_dkv_kernel<D, CAUSAL><<<grid, THREADS, Bwd<D>::DKV_SMEM, stream>>>(
        qb, kb, vb, dob, lse, delta, static_cast<bf16*>(p.out0),
        static_cast<bf16*>(p.out1), T, scale);
  }
  return (int)cudaGetLastError();
}

template <bool CAUSAL>
int dispatch(int which, const Ptrs& p, int BH, int T, int D, void* stream) {
  if (BH < 1 || BH > 65535 || T < TILE || T % TILE != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16, CAUSAL>(which, p, BH, T, s);
    case 32:
      return launch<32, CAUSAL>(which, p, BH, T, s);
    case 64:
      return launch<64, CAUSAL>(which, p, BH, T, s);
    case 128:
      return launch<128, CAUSAL>(which, p, BH, T, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// B2: q, k, v [BH, T, D] bf16 -> o [BH, T, D] bf16, lse [BH, T] f32.
int tddl_flash_fwd(const void* q, const void* k, const void* v, void* o,
                   void* lse, int BH, int T, int D, void* stream) {
  return dispatch<true>(
      0, {q, k, v, nullptr, nullptr, nullptr, nullptr, nullptr, o, lse}, BH,
      T, D, stream);
}

// B3 (dq): + dO [BH, T, D] bf16, lse and Delta [BH, T] f32 -> dq.
int tddl_flash_bwd_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int BH, int T, int D, void* stream) {
  return dispatch<true>(1,
                        {q, k, v, dout, nullptr, lse, nullptr,
                         const_cast<void*>(delta), dq, nullptr},
                        BH, T, D, stream);
}

// B3 (dk/dv): same inputs -> dk, dv.
int tddl_flash_bwd_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int BH, int T, int D,
                       void* stream) {
  return dispatch<true>(2,
                        {q, k, v, dout, nullptr, lse, nullptr,
                         const_cast<void*>(delta), dk, dv},
                        BH, T, D, stream);
}

// The same three at causal=False: every query attends every key.
int tddl_flash_fwd_full(const void* q, const void* k, const void* v, void* o,
                        void* lse, int BH, int T, int D, void* stream) {
  return dispatch<false>(
      0, {q, k, v, nullptr, nullptr, nullptr, nullptr, nullptr, o, lse}, BH,
      T, D, stream);
}

// Non-causal dq computes Delta itself: + o [BH, T, D] bf16 and dlse [BH, T]
// f32 (or null) -> delta [BH, T] f32 (sum(dO * O) - dlse, for dk/dv) and
// dq.
int tddl_flash_bwd_dq_full(const void* q, const void* k, const void* v,
                           const void* dout, const void* o, const void* lse,
                           const void* dlse, void* delta, void* dq, int BH,
                           int T, int D, void* stream) {
  return dispatch<false>(1, {q, k, v, dout, o, lse, dlse, delta, dq, nullptr},
                         BH, T, D, stream);
}

// dk/dv at causal=False, from the Delta that tddl_flash_bwd_dq_full wrote.
int tddl_flash_bwd_dkv_full(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int BH,
                            int T, int D, void* stream) {
  return dispatch<false>(2,
                         {q, k, v, dout, nullptr, lse, nullptr,
                          const_cast<void*>(delta), dk, dv},
                         BH, T, D, stream);
}

const char* tddl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
