// Serving kernels for Hopper (sm_90a): ragged paged-decode attention (B5),
// query-tiled chunked-prefill attention (B6), each over a model-dtype or an
// int8 pool, the trust epilogue (B7) and the fused speculative-verify tail
// (B8).
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (trustworthy_dl_tpu_torch/ops/__init__.py).  Every entry point
// launches on the caller's stream, allocates nothing (the Python wrapper
// allocates the outputs with torch.empty) and returns cudaGetLastError(),
// which the wrapper raises on.
//
// B5 replaces trustworthy_dl_tpu/ops/paged_attention.py:_paged_attn_kernel
// (pallas_call in _paged_attn_call); B6 replaces _paged_prefill_kernel
// (_paged_prefill_call).  Both compute, for each (row r, head h, query t),
// softmax(q . k / sqrt(Dh)) v over the cache positions kpos <= start[r] + t,
// reading K/V straight out of the block pool [NB, H, BLOCK, Dh] through the
// row's block table, with f32 (m, l, acc) online-softmax accumulators and
// masked scores set to NEG_INF, exactly as the TPU kernels do.
//
// What bounds them on this card: bytes.  A decode step reads every cached
// K and V position of every (row, head) once, ~2 * len * Dh * 2 bytes in
// bf16 against 4 * len * Dh flops per query - about 4 flops a K/V byte at
// T <= 8, far under the ~295 flop/byte ridge.  The int8 branches (the
// quantized=True instances of the same two TPU kernels) read int8 K/V and
// f32 per-(head, position) scales [NB, H, BLOCK] through the same table
// walk: the K scale multiplies the score after the dot (it is constant
// along the contracted Dh axis), the V scale multiplies the probability
// before the PV contraction, and the running sum l keeps the unscaled
// probabilities - the algebra of paged_attention_reference.  Their bound
// is bytes again: half the bf16 pool's K/V bytes plus 8 bytes of scales
// per (head, position).
//
// B5 with bf16 queries (every decode launch of the serving path, over the
// bf16 and the int8 pool) is decode_split_kernel: flash-decoding over a
// thread-block cluster.  A decode launch is tiny (the serve drive's: 96
// (row, head) windows of up to 512 keys, 6.3 MB of bf16 K/V), so what
// bounds it in practice is latency: how many dependent trips to device
// memory the longest window takes, and how few SMs walk it.  The design:
//   * one cluster of 8 CTAs (the portable maximum) per (row, head) at
//     T = 1, of 4 at T > 1; CTA rank c takes a contiguous span of the row's
//     window [0, min(start + T, table end)), so the longest row is read by
//     8 SMs at once instead of walked by one (768 CTAs of 4 warps at the
//     serve shape, at most 64 keys each, one wave: see DcRows);
//   * every lane holds 8 head dims of a key row - one 16-byte load (bf16)
//     or 8-byte load (int8) - so a key row is D / 8 lanes (padded to a
//     power of two) and a warp load covers 32 / that many consecutive keys,
//     gathered by key row through the table (key kpos is row kpos % BLOCK
//     of block table[kpos / BLOCK]: any block size works); all of a pass's
//     K and V loads (DcRows::nk rows a lane) and scales are issued before
//     any arithmetic, and q is staged in shared memory (f32) while they fly;
//   * scores, the partial softmax and P.V run on the CUDA cores in f32: at
//     4 flops a byte the tensor cores would idle.  The key lanes' partial
//     dots meet by shuffle-xor; scale, then the K scale, then the mask;
//     masked p is exactly 0 (a span past a query's position has m =
//     NEG_INF, where 2^(s - m) would be 1); l sums p, P.V takes p *
//     v_scale; the CTA folds its key rows by shuffles and its warps in
//     shared memory into one partial (m, l, acc) a query;
//   * the CTAs' partials meet in distributed shared memory: cluster.sync(),
//     then each rank folds its share of the output's 8-dim chunks from all
//     the cluster's partials (M = max m_c, out = sum 2^(m_c - M) acc_c /
//     sum 2^(m_c - M) l_c, an empty partial weighing 0) and writes bf16; a
//     second cluster.sync() keeps every CTA's shared memory alive until its
//     peers have read it.  One launch, no workspace.
// Issuing the next pass's loads before this pass's arithmetic measured
// slower (the extra registers spill under the one-wave bounds).
// f32 queries keep paged_attn_kernel below (the choice is by dtype).
//
// paged_attn_kernel (B5 and B6 with f32 queries, over an f32 or an int8
// pool) aims only at reading each needed byte once:
//   * one CTA per (row, head) [B5] or (row, head, query tile) [B6]; the CTA
//     reads its own table row and start (the TPU's scalar prefetch) and
//     stops at its last useful logical block jmax - no block past the
//     causal window is read, per query tile for B6 (the flash causal skip
//     across tiles of a paged table);
//   * the K/V tiles of up to 64 keys are staged in shared memory as f32
//     with coalesced loads (one block of one head is BLOCK * Dh contiguous
//     elements), the K tile padded by one column so the per-key dot
//     products hit distinct banks;
//   * q stays resident in shared memory; scores, probabilities and the
//     accumulator never leave the SM.
// Dot products run on the CUDA cores in f32: with at most 8 query rows per
// CTA the tensor cores would idle on a 64-row tile, and the work is
// memory-bound either way.  Its 48 KB of shared memory hold at least one
// whole block a stage (attn_smem_bytes at q_tile rows): past that (Dh =
// 64 and blocks above 80 positions at 8 rows, say) the launch is refused,
// and the Python side reads the same bytes before it launches.
//
// B6 with bf16 queries (every prefill launch of the serving path, over the
// bf16 and the int8 pool) is prefill_mma_kernel<D, QUANT>, one kernel body
// for both pools.  It replaces trustworthy_dl_tpu/ops/paged_attention.py:
// _paged_prefill_kernel (pallas_call in _paged_prefill_call; QUANT is its
// quantized branch, lines 556-576).  Under int8 KV a prompt is one
// max_seq-row chunk, up to 512 query rows against up to 512 keys: at GPT-2
// small's [1, 12, 512, 64] from position 128 that is 0.58 GFLOP of causal
// work (0.59 us at 989 TFLOP/s) against 2.4 MB of q, out, int8 K/V and
// scales (0.72 us at 3.35 TB/s).  Over the bf16 pool the serve path's
// chunks are 64 rows: [1, 12, 64, 64] from 128 is 0.79 MB (0.24 us)
// against 32 MFLOP.  Both are bound by bytes, and the CUDA-core kernel
// above re-reads every K/V stage for each 8-row tile.  The design is B2's
// (flash_attention.cu) over the paged pool:
//   * one CTA of PF_WARPS (4) warps per (row, head, 16 * PF_WARPS-row
//     query tile), tiles longest-first; Q's A-fragments come once by
//     ldmatrix and stay in registers; S = Q.K^T and O += P.V are mma.sync
//     m16n8k16 (bf16 in, f32 accumulate); the online softmax, O and P stay
//     in registers;
//   * the K/V walk gathers by key row, 64 keys a stage: key kpos is row
//     kpos % BLOCK of block table[kpos / BLOCK], Dh contiguous pool
//     elements, so any block size works; the rows (and the int8 pool's f32
//     scales) arrive by cp.async (16 and 4 bytes) in a PF_STAGES (3)-deep
//     ring, the next stages in flight while stage st computes;
//   * bf16 pool: the rows land in ring slots padded by 16 bytes a row,
//     which ldmatrix (K) and ldmatrix.trans (V) read in place: one barrier
//     a stage.  int8 pool: half the bytes, and one pass a stage widens the
//     rows into bf16 tiles (exact) laid out the same way: two barriers a
//     stage (rows landed; tiles widened);
//   * scales in the reference's order, in f32 registers: each S column
//     times scale (times k_scale[key] over the int8 pool), then the mask;
//     l sums the unscaled p; P.V takes x = p (times v_scale[key]) in bf16
//     - the one rounding the f32 twin does not make.  One bf16 copy of x
//     (B2's P is rounded so) put errors of a few output steps on peaked
//     rows, past the bf16 tolerance, over either pool, so x goes in as two
//     bf16 terms, hi = bf16(x) and lo = bf16(x - hi): twice P.V's
//     products, and x carried to ~2^-17;
//   * the causal and ragged bounds are per tile in absolute positions:
//     the tile stops at kend = min(last query position, table end), so no
//     table entry past nbps is read and rows past the table see the whole
//     table and stay finite; only a stage that crosses the diagonal band
//     or kend is masked, and a warp whose rows all precede a stage skips
//     its products;
//   * registers (ptxas, sm_90a, CUDA 12.8): 152 a thread at Dh = 64 and
//     209 at 128 over the int8 pool, 149 and 207 over the bf16 pool, 0
//     spill bytes at every Dh; shared memory at Dh = 64 53,760 bytes
//     (int8) and 64,512 (bf16: 9 KB of Q, 55 KB of ring), one CTA an SM.
// What bounds it in practice is one warp a scheduler walking up to eight
// dependent stages; 32-row CTAs, a 2-stage ring, widening stage st + 1
// between stage st's products (one barrier a stage) and reading the table
// a stage ahead measured no faster on the H100 for the int8 pool (PERF.md,
// B6-int8's redesign).  Split-K over the key axis is later work.
//
// B7 replaces _trust_stats_kernel (_trust_stats_call): for each row of
// f32 logits [B, V] it returns the softmax entropy logZ - sum(x p) and the
// top-1 margin top1 - top2 in one read of the row.  Bound: bytes (one read
// of B * V * 4: 1.6 MB, 0.48 us at B = 8).  The serve path launches it at
// B = 8 (a decode tick) and B = 1 (a prompt's last chunk), so one CTA a
// row would leave the card idle and walk each row in dependent steps;
// what bounds a launch in practice is latency.  trust_cluster_kernel<C>:
//   * one cluster of C CTAs a row (C = 16, non-portable, at B <= 4; 8
//     past it: 8 measured faster at B = 8, 16 at B = 1 and 4); rank c
//     reads a contiguous, even share of the row's 16-byte vectors.  Row r
//     starts at byte 4 r V and V = 50257 is odd, so every other row is
//     misaligned: the (at most 3) floats before the row's first 16-byte
//     boundary go to rank 0 as scalars and those after its last to rank
//     C - 1; nothing is padded.  An empty share (V < C vectors) is the
//     empty accumulator;
//   * each thread issues all of a round's 16-byte loads (8 a thread) into
//     registers before any arithmetic, takes their max first, then one
//     e^{x - m} a value - no running rescale, no dependent chain - and
//     keeps top-2 with max/min only (a duplicated maximum gives top2 ==
//     top1, margin 0, bit-exact against top-k).  Any V loops over rounds
//     (GPT-2's is one), so there is no vocab limit;
//   * (m = top1, top2, sum e^{x-m}, sum x e^{x-m}) merge by fixed shuffle
//     trees, then warps in shared memory, then ranks: each rank writes its
//     partial into rank 0's shared memory (distributed shared memory,
//     after a cluster barrier split around the loads), and rank 0 merges
//     them in rank order and writes.  One launch, no atomics, no global
//     scratch: the same bits every launch.
//
// B8 replaces _verify_tail_kernel (_verify_tail_call, _trust_update):
// logits [B, V] f32 = normed [B, D] bf16 @ head [V, D]^T, rounded through
// bf16 (the tail's matmul runs in the compute dtype and upcasts after
// it), plus B7's entropy and margin of every row, folded in the same
// pass.  Bound: bytes - the head (V * D * 2 = 77.2 MB for GPT-2 small)
// read once plus the [B, V] f32 logits written once (8.0 MB at B = 40):
// 25.5 us; the products are 3.1 GFLOP at B = 40, ~3 us at 989 TFLOP/s.
// So the head has to stream at the card's memory rate with every SM
// busy to the end.  verify_stream_kernel<MT, KC>:
//   * one persistent CTA of 8 warps an SM; CTA i takes an even,
//     contiguous share of the vocab's 16-column groups (23 or 24 of 3142
//     for GPT-2 on 132 SMs) and walks it in 128-column tiles, warp w on
//     group w, so no SM takes more than one group over another's share;
//   * normed [B <= 96, D] stays resident in shared memory (rows padded to
//     16 with zeros); its rows arrive K chunk by K chunk with the first
//     tile's stages, so the first products wait for one chunk of it.  The
//     head's rows stream through a 3-stage ring of KC-deep K chunks by
//     16-byte cp.async: KC = 128 (34 KB stages) wherever the ring fits
//     beside normed, else 64; two stages in flight while one multiplies,
//     across tile boundaries too.  Half the stages of 64-deep ones halve
//     the per-stage bookkeeping, which measured as costly as the products;
//   * logits = normed . head^T by mma.sync m16n8k16 (bf16 in, f32
//     accumulate), normed's MT = ceil(B / 16) m16 tiles the A operand, the
//     warp's 16 head rows the two n8 B tiles, both by ldmatrix;
//   * the epilogue works on the fragments: each accumulator rounded
//     through bf16 and stored, then folded into the lane's running
//     (top1, top2, sum 2^x, sum x 2^x) of its row - the tile's top-2 by
//     max/min, one rescale and one 2^x a value against the new max - so
//     no shuffle runs until the CTA's columns are done.  Columns at or
//     past V stay out of the reductions, never counted as 0; no f32 tile
//     is staged;
//   * the fold is in the same launch: a row's 4 lanes merge by shuffles,
//     the 8 warps in order through shared memory; each CTA writes one
//     partial a row, each thread fences its stores, a barrier, then one
//     thread counts the CTA on the call's own arrival word (in its
//     scratch, after the partials, zeroed on the stream before the
//     launch); the last CTA to arrive folds every row's partials in CTA
//     order (8 lanes a row: the max first, then one 2^{m_c - M} a partial,
//     fixed xor trees).  No atomics touch the values, so the bits repeat,
//     and the margin equals top-k over the kernel's own logits bit for
//     bit.
// What bounds it in practice (PERF.md, row B8): the stream's cp.async
// (LDGSTS) issue rate and, at 40 rows, products and epilogue that do not
// all hide under it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using namespace mma_sm90;

constexpr float NEG_INF = -1e30f;
constexpr int ATTN_THREADS = 128;
// Keys staged per iteration of the attention loop (whole blocks).
constexpr int STAGE_KEYS = 64;
constexpr size_t STATIC_SMEM_LIMIT = 48 * 1024;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

// One CTA = (row r, head h, query tile ti).  Decode is the one-tile case.
// f32 q and out; KV is float (model-dtype pool) or int8_t (QUANT: scales
// [NB, H, BLOCK]).
template <typename KV, bool QUANT>
__global__ void __launch_bounds__(ATTN_THREADS) paged_attn_kernel(
    const float* __restrict__ q, const KV* __restrict__ pool_k,
    const KV* __restrict__ pool_v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int32_t* __restrict__ table,
    const int32_t* __restrict__ start, float* __restrict__ out, int H, int Tq,
    int Dh, int bsz, int nbps, int q_tile, int n_tiles, int stage_blocks,
    float scale) {
  const int tid = threadIdx.x;
  const int ti = blockIdx.x % n_tiles;
  const int rh = blockIdx.x / n_tiles;
  const int h = rh % H;
  const int r = rh / H;
  const int t0 = ti * q_tile;
  const int rows = min(q_tile, Tq - t0);
  const int qpos0 = start[r] + t0;
  // Last useful logical block of this tile, clipped into the table: a
  // padded prefill chunk can run past the slot's allocation (those query
  // rows are discarded by the caller; the mask keeps them finite).
  const int jmax = max(0, min((qpos0 + rows - 1) / bsz, nbps - 1));

  const int kt = stage_blocks * bsz;
  const int ldk = Dh + 1;
  extern __shared__ float smem[];
  float* q_s = smem;                 // [q_tile][Dh]
  float* k_s = q_s + q_tile * Dh;    // [kt][Dh + 1]
  float* v_s = k_s + kt * ldk;       // [kt][Dh]
  float* p_s = v_s + kt * Dh;        // [q_tile][kt]
  float* acc = p_s + q_tile * kt;    // [q_tile][Dh]
  float* m_s = acc + q_tile * Dh;    // [q_tile]
  float* l_s = m_s + q_tile;         // [q_tile]
  float* c_s = l_s + q_tile;         // [q_tile]
  float* ks_s = c_s + q_tile;        // [kt] (QUANT)
  float* vs_s = ks_s + kt;           // [kt] (QUANT)

  const size_t head_row = (size_t)(r * H + h) * Tq + t0;
  const float* q_rows = q + head_row * Dh;
  for (int i = tid; i < rows * Dh; i += blockDim.x) {
    q_s[i] = q_rows[i];
    acc[i] = 0.f;
  }
  for (int t = tid; t < rows; t += blockDim.x) {
    m_s[t] = NEG_INF;
    l_s[t] = 0.f;
  }
  __syncthreads();

  const int32_t* trow = table + (size_t)r * nbps;
  const int blk_elems = bsz * Dh;
  for (int j0 = 0; j0 <= jmax; j0 += stage_blocks) {
    const int nblk = min(stage_blocks, jmax + 1 - j0);
    const int nkeys = nblk * bsz;
    for (int b = 0; b < nblk; ++b) {
      const size_t base = ((size_t)trow[j0 + b] * H + h) * blk_elems;
      const KV* kb = pool_k + base;
      const KV* vb = pool_v + base;
      for (int i = tid; i < blk_elems; i += blockDim.x) {
        const int key = b * bsz + i / Dh;
        const int d = i % Dh;
        k_s[key * ldk + d] = to_f(kb[i]);
        v_s[key * Dh + d] = to_f(vb[i]);
      }
      if (QUANT) {
        const size_t sbase = ((size_t)trow[j0 + b] * H + h) * bsz;
        for (int i = tid; i < bsz; i += blockDim.x) {
          ks_s[b * bsz + i] = k_scale[sbase + i];
          vs_s[b * bsz + i] = v_scale[sbase + i];
        }
      }
    }
    __syncthreads();

    // Scores with the causal + ragged mask in absolute positions.
    const int kpos0 = j0 * bsz;
    for (int p = tid; p < rows * nkeys; p += blockDim.x) {
      const int t = p / nkeys;
      const int key = p % nkeys;
      const float* qr = q_s + t * Dh;
      const float* kr = k_s + key * ldk;
      float dot = 0.f;
      for (int d = 0; d < Dh; ++d) dot = fmaf(qr[d], kr[d], dot);
      float sc = dot * scale;
      if (QUANT) sc *= ks_s[key];   // K scale after the dot
      p_s[t * kt + key] = (kpos0 + key <= qpos0 + t) ? sc : NEG_INF;
    }
    __syncthreads();

    // Online softmax, one thread per query row.  The first staged tile
    // always holds kpos 0 <= qpos, so m is finite from then on and masked
    // scores flush to exactly 0.
    for (int t = tid; t < rows; t += blockDim.x) {
      float* pr = p_s + t * kt;
      float mx = NEG_INF;
      for (int key = 0; key < nkeys; ++key) mx = fmaxf(mx, pr[key]);
      const float m_prev = m_s[t];
      const float m_cur = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int key = 0; key < nkeys; ++key) {
        const float e = expf(pr[key] - m_cur);
        // V scale folds into the probability (l sums the unscaled ones).
        pr[key] = QUANT ? e * vs_s[key] : e;
        sum += e;
      }
      const float corr = expf(m_prev - m_cur);
      l_s[t] = l_s[t] * corr + sum;
      m_s[t] = m_cur;
      c_s[t] = corr;
    }
    __syncthreads();

    for (int i = tid; i < rows * Dh; i += blockDim.x) {
      const int t = i / Dh;
      const int d = i % Dh;
      const float* pr = p_s + t * kt;
      float a = acc[i] * c_s[t];
      for (int key = 0; key < nkeys; ++key) a = fmaf(pr[key], v_s[key * Dh + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  float* o_rows = out + head_row * Dh;
  for (int i = tid; i < rows * Dh; i += blockDim.x) {
    o_rows[i] = acc[i] / fmaxf(l_s[i / Dh], 1e-30f);
  }
}

size_t attn_smem_bytes(int q_tile, int Dh, int kt) {
  return sizeof(float) * ((size_t)2 * q_tile * Dh + (size_t)kt * (Dh + 1) +
                          (size_t)kt * Dh + (size_t)q_tile * kt + 3 * q_tile +
                          2 * (size_t)kt);
}

template <typename KV, bool QUANT>
int launch_attn(const void* q, const void* pool_k, const void* pool_v,
                const void* k_scale, const void* v_scale, const void* table,
                const void* start, void* out, int R, int H, int Tq, int Dh,
                int bsz, int nbps, int q_tile, cudaStream_t stream) {
  if (R < 1 || H < 1 || Tq < 1 || Dh < 1 || bsz < 1 || nbps < 1 || q_tile < 1)
    return (int)cudaErrorInvalidValue;
  int stage_blocks = STAGE_KEYS / bsz > 0 ? STAGE_KEYS / bsz : 1;
  while (stage_blocks > 1 &&
         attn_smem_bytes(q_tile, Dh, stage_blocks * bsz) > STATIC_SMEM_LIMIT)
    --stage_blocks;
  const size_t smem = attn_smem_bytes(q_tile, Dh, stage_blocks * bsz);
  if (smem > STATIC_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const int n_tiles = (Tq + q_tile - 1) / q_tile;
  const float scale = (float)(1.0 / sqrt((double)Dh));
  paged_attn_kernel<KV, QUANT>
      <<<R * H * n_tiles, ATTN_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const KV*>(pool_k),
      static_cast<const KV*>(pool_v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(start), static_cast<float*>(out), H, Tq, Dh,
      bsz, nbps, q_tile, n_tiles, stage_blocks, scale);
  return (int)cudaGetLastError();
}

// f32 q only (dtype 0): bf16 q runs decode_split_kernel (B5) and
// prefill_mma_kernel (B6) over either pool.  k_scale == nullptr: f32
// pool; else int8 pool.
int dispatch_attn(int dtype, const void* q, const void* pool_k,
                  const void* pool_v, const void* k_scale,
                  const void* v_scale, const void* table, const void* start,
                  void* out, int R, int H, int Tq, int Dh, int bsz, int nbps,
                  int q_tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool quant = k_scale != nullptr;
  if (dtype != 0 || (quant && v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!quant)
    return launch_attn<float, false>(q, pool_k, pool_v, k_scale, v_scale,
                                     table, start, out, R, H, Tq, Dh, bsz,
                                     nbps, q_tile, s);
  return launch_attn<int8_t, true>(q, pool_k, pool_v, k_scale, v_scale,
                                   table, start, out, R, H, Tq, Dh, bsz, nbps,
                                   q_tile, s);
}

// ---------------------------------------------------------------------------
// B5 with bf16 queries: split-K paged decode over a thread-block cluster
// (see the note at the top).  One cluster of DcRows::cluster CTAs per
// (row, head); CTA rank c walks a contiguous span of the row's window.
// ---------------------------------------------------------------------------
constexpr int DC_WARPS = 4;
constexpr int DC_THREADS = DC_WARPS * 32;
constexpr int DC_MAX_DH = 128;

// Per query-row instance (T <= TQ): CTAs a cluster, key rows a lane loads
// a pass, and the CTAs an SM the register budget is set for.  A cluster's
// CTAs share one GPC (16-18 SMs), so the serve shape's 96 clusters of 8
// make one wave only with room for 7 CTAs an SM: at most 72 registers at
// T = 1.  Past one query row the scores and accumulators take more
// registers, 3 CTAs an SM, and clusters of 4 keep the launch one wave.
template <int TQ>
struct DcRows {
  static constexpr int cluster = TQ > 1 ? 4 : 8;
  static constexpr int nk = TQ > 4 ? 2 : 4;
  static constexpr int min_blocks = TQ > 1 ? 3 : 7;
};

// 8 head dims of one key row, as one load: 16 bytes of bf16, 8 of int8.
template <typename KV>
struct Row8;
template <>
struct Row8<__nv_bfloat16> {
  using raw = uint4;
};
template <>
struct Row8<int8_t> {
  using raw = uint2;
};

__device__ __forceinline__ void unpack8(const uint4& w, float (&f)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack8(const uint2& w, float (&f)[8]) {
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    f[b] = (float)((int32_t)(w.x << (24 - 8 * b)) >> 24);
    f[4 + b] = (float)((int32_t)(w.y << (24 - 8 * b)) >> 24);
  }
}

// P: lanes a key row takes (D / 8 rounded up to a power of two; lanes
// past D / 8 hold zeros).  TQ: query rows the registers are sized for
// (T <= TQ; rows past T compute on zeros and are never stored).
template <typename KV, bool QUANT, int P, int TQ>
__global__ void __cluster_dims__(DcRows<TQ>::cluster, 1, 1)
    __launch_bounds__(DC_THREADS, DcRows<TQ>::min_blocks) decode_split_kernel(
        const __nv_bfloat16* __restrict__ q, const KV* __restrict__ pool_k,
        const KV* __restrict__ pool_v, const float* __restrict__ k_scale,
        const float* __restrict__ v_scale, const int32_t* __restrict__ table,
        const int32_t* __restrict__ start, __nv_bfloat16* __restrict__ out,
        int H, int Tq, int D, int bsz, int nbps, float scale_log2) {
  namespace cg = cooperative_groups;
  using Raw = typename Row8<KV>::raw;
  constexpr int C = DcRows<TQ>::cluster;
  constexpr int NK = DcRows<TQ>::nk;
  constexpr int KPW = 32 / P;            // key rows a warp load covers
  constexpr int SLOTS = DC_WARPS * KPW;  // key rows a CTA load covers
  constexpr int PASS = NK * SLOTS;       // key rows a pass
  __shared__ __align__(16) float q_s[TQ][DC_MAX_DH];
  // Each warp's folded acc; after the CTA's fold, row 0 is the partial
  // the cluster reads.
  __shared__ __align__(16) float acc_s[DC_WARPS][TQ][DC_MAX_DH];
  __shared__ float max_s[2][DC_WARPS][TQ];
  __shared__ float l_s[DC_WARPS][TQ];
  __shared__ float m_s[TQ];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int rh = blockIdx.x / C;
  const int h = rh % H;
  const int r = rh / H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int slice = lane % P;                // this lane's 8 dims
  const int slot = warp * KPW + lane / P;    // this lane's key row
  const bool dims = slice * 8 < D;

  // The row's window, clipped into the table: rows past the table see the
  // whole table (and stay finite); no table entry past it is read.
  const int qpos0 = start[r];
  const int len = min(qpos0 + Tq, nbps * bsz);
  int span = (len + C - 1) / C;
  span = (span + KPW - 1) / KPW * KPW;
  const int kbeg = min(rank * span, len);
  const int kend = min(kbeg + span, len);
  const int32_t* trow = table + (size_t)r * nbps;

  Raw kr[NK], vr[NK];
  float ksc[NK], vsc[NK];
  // Key rows k0 + n * SLOTS + slot of a pass; rows past the span are
  // zeros with zero scales (and masked).
  auto issue = [&](int k0) {
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      const int kpos = k0 + n * SLOTS + slot;
      kr[n] = Raw{};
      vr[n] = Raw{};
      ksc[n] = 0.f;
      vsc[n] = 0.f;
      if (kpos < kend) {
        const size_t row =
            ((size_t)trow[kpos / bsz] * H + h) * bsz + kpos % bsz;
        if (dims) {
          kr[n] = __ldg(reinterpret_cast<const Raw*>(pool_k + row * D) +
                        slice);
          vr[n] = __ldg(reinterpret_cast<const Raw*>(pool_v + row * D) +
                        slice);
        }
        if (QUANT) {
          ksc[n] = __ldg(k_scale + row);
          vsc[n] = __ldg(v_scale + row);
        }
      }
    }
  };
  if (kbeg < kend) issue(kbeg);

  // q in f32, zero past T and past D up to the lanes' padded width.
  const __nv_bfloat16* qh = q + (size_t)rh * Tq * D;
  for (int i = tid; i < TQ * P * 8; i += DC_THREADS) {
    const int t = i / (P * 8);
    const int d = i % (P * 8);
    q_s[t][d] = (t < Tq && d < D) ? __bfloat162float(qh[t * D + d]) : 0.f;
  }
  __syncthreads();

  float m_run[TQ], l_run[TQ], acc[TQ][8];
#pragma unroll
  for (int t = 0; t < TQ; ++t) {
    m_run[t] = NEG_INF;
    l_run[t] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[t][e] = 0.f;
  }

  int pass = 0;
  for (int k0 = kbeg; k0 < kend; k0 += PASS, ++pass) {
    if (k0 != kbeg) issue(k0);
    // Scores: this lane's 8-dim slice of each key row, then the sum over
    // the row's P lanes.
    float s[NK][TQ];
#pragma unroll
    for (int t = 0; t < TQ; ++t) {
      const float4 qa = *reinterpret_cast<const float4*>(&q_s[t][slice * 8]);
      const float4 qb =
          *reinterpret_cast<const float4*>(&q_s[t][slice * 8 + 4]);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        float kf[8];
        unpack8(kr[n], kf);
        float dot = qa.x * kf[0];
        dot = fmaf(qa.y, kf[1], dot);
        dot = fmaf(qa.z, kf[2], dot);
        dot = fmaf(qa.w, kf[3], dot);
        dot = fmaf(qb.x, kf[4], dot);
        dot = fmaf(qb.y, kf[5], dot);
        dot = fmaf(qb.z, kf[6], dot);
        dot = fmaf(qb.w, kf[7], dot);
        s[n][t] = dot;
      }
    }
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int t = 0; t < TQ; ++t)
#pragma unroll
        for (int off = 1; off < P; off <<= 1)
          s[n][t] += __shfl_xor_sync(0xffffffffu, s[n][t], off);

    // Scale (log2 units), then the K scale, then the causal mask; the
    // pass's maximum of each query over the CTA.
    float mx[TQ];
#pragma unroll
    for (int t = 0; t < TQ; ++t) mx[t] = NEG_INF;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      const int kpos = k0 + n * SLOTS + slot;
      const float f = QUANT ? scale_log2 * ksc[n] : scale_log2;
#pragma unroll
      for (int t = 0; t < TQ; ++t) {
        const bool seen = kpos < kend && kpos <= qpos0 + t;
        s[n][t] = seen ? s[n][t] * f : NEG_INF;
        mx[t] = fmaxf(mx[t], s[n][t]);
      }
    }
#pragma unroll
    for (int t = 0; t < TQ; ++t) {
#pragma unroll
      for (int off = P; off < 32; off <<= 1)
        mx[t] = fmaxf(mx[t], __shfl_xor_sync(0xffffffffu, mx[t], off));
      if (lane == 0) max_s[pass & 1][warp][t] = mx[t];
    }
    __syncthreads();  // max_s is double-buffered by pass: one barrier a pass
#pragma unroll
    for (int t = 0; t < TQ; ++t) {
      float m_new = m_run[t];
#pragma unroll
      for (int w = 0; w < DC_WARPS; ++w)
        m_new = fmaxf(m_new, max_s[pass & 1][w][t]);
      const float corr = ex2(m_run[t] - m_new);
      m_run[t] = m_new;
      l_run[t] *= corr;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[t][e] *= corr;
    }
    // p exactly 0 where masked (m may still be NEG_INF here); l sums the
    // unscaled p; P.V takes p * v_scale.
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      float vf[8];
      unpack8(vr[n], vf);
#pragma unroll
      for (int t = 0; t < TQ; ++t) {
        const float p = s[n][t] <= NEG_INF ? 0.f : ex2(s[n][t] - m_run[t]);
        l_run[t] += p;
        const float pv = QUANT ? p * vsc[n] : p;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[t][e] = fmaf(pv, vf[e], acc[t][e]);
      }
    }
  }

  // The CTA's partial: key rows of a warp by shuffles (m is CTA-uniform),
  // then the warps in shared memory.
#pragma unroll
  for (int t = 0; t < TQ; ++t) {
#pragma unroll
    for (int off = P; off < 32; off <<= 1) {
      l_run[t] += __shfl_xor_sync(0xffffffffu, l_run[t], off);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[t][e] += __shfl_xor_sync(0xffffffffu, acc[t][e], off);
    }
  }
  if (lane < P && dims) {
#pragma unroll
    for (int t = 0; t < TQ; ++t) {
      float* dst = &acc_s[warp][t][slice * 8];
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(acc[t][4], acc[t][5], acc[t][6], acc[t][7]);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int t = 0; t < TQ; ++t) l_s[warp][t] = l_run[t];
  }
  if (tid == 0) {
#pragma unroll
    for (int t = 0; t < TQ; ++t) m_s[t] = m_run[t];
  }
  __syncthreads();
  for (int i = tid; i < TQ * D; i += DC_THREADS) {
    const int t = i / D;
    const int d = i % D;
    float a = acc_s[0][t][d];
#pragma unroll
    for (int w = 1; w < DC_WARPS; ++w) a += acc_s[w][t][d];
    acc_s[0][t][d] = a;
  }
  if (tid < TQ) {
    float l = l_s[0][tid];
#pragma unroll
    for (int w = 1; w < DC_WARPS; ++w) l += l_s[w][tid];
    l_s[0][tid] = l;
  }
  cluster.sync();  // every CTA's partial is in its shared memory

  // Fold the cluster's partials: output chunk i (8 dims of one query) is
  // rank i % C's; an empty partial (m = NEG_INF) weighs 0.
  const int chunks = D / 8;
  for (int i = tid * C + rank; i < Tq * chunks; i += C * DC_THREADS) {
    const int t = i / chunks;
    const int c8 = i % chunks;
    float mc[C];
    float M = NEG_INF;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      mc[c] = *cluster.map_shared_rank(&m_s[t], c);
      M = fmaxf(M, mc[c]);
    }
    float lsum = 0.f;
    float o[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float w = mc[c] <= NEG_INF ? 0.f : ex2(mc[c] - M);
      lsum = fmaf(w, *cluster.map_shared_rank(&l_s[0][t], c), lsum);
      const float4* a = reinterpret_cast<const float4*>(
          cluster.map_shared_rank(&acc_s[0][t][c8 * 8], c));
      const float4 a0 = a[0];
      const float4 a1 = a[1];
      o[0] = fmaf(w, a0.x, o[0]);
      o[1] = fmaf(w, a0.y, o[1]);
      o[2] = fmaf(w, a0.z, o[2]);
      o[3] = fmaf(w, a0.w, o[3]);
      o[4] = fmaf(w, a1.x, o[4]);
      o[5] = fmaf(w, a1.y, o[5]);
      o[6] = fmaf(w, a1.z, o[6]);
      o[7] = fmaf(w, a1.w, o[7]);
    }
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
    *reinterpret_cast<uint4*>(out + ((size_t)rh * Tq + t) * D + c8 * 8) =
        make_uint4(pack_bf16(o[0] * inv, o[1] * inv),
                   pack_bf16(o[2] * inv, o[3] * inv),
                   pack_bf16(o[4] * inv, o[5] * inv),
                   pack_bf16(o[6] * inv, o[7] * inv));
  }
  cluster.sync();  // no CTA leaves while a peer may still read its partial
}

template <typename KV, bool QUANT, int P, int TQ>
int launch_decode_split(const void* q, const void* pool_k, const void* pool_v,
                        const void* k_scale, const void* v_scale,
                        const void* table, const void* start, void* out,
                        int R, int H, int Tq, int D, int bsz, int nbps,
                        cudaStream_t stream) {
  const long long grid = (long long)R * H * DcRows<TQ>::cluster;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float scale_log2 =
      (float)(1.0 / sqrt((double)D) * 1.4426950408889634);
  decode_split_kernel<KV, QUANT, P, TQ>
      <<<(unsigned)grid, DC_THREADS, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(pool_k),
          static_cast<const KV*>(pool_v), static_cast<const float*>(k_scale),
          static_cast<const float*>(v_scale),
          static_cast<const int32_t*>(table),
          static_cast<const int32_t*>(start),
          static_cast<__nv_bfloat16*>(out), H, Tq, D, bsz, nbps, scale_log2);
  return (int)cudaGetLastError();
}

template <typename KV, bool QUANT, int P>
int launch_decode_split_rows(const void* q, const void* pool_k,
                             const void* pool_v, const void* k_scale,
                             const void* v_scale, const void* table,
                             const void* start, void* out, int R, int H,
                             int Tq, int D, int bsz, int nbps,
                             cudaStream_t s) {
#define DC_ROWS(TQ)                                                        \
  return launch_decode_split<KV, QUANT, P, TQ>(q, pool_k, pool_v, k_scale, \
                                               v_scale, table, start, out, \
                                               R, H, Tq, D, bsz, nbps, s)
  if (Tq <= 1) DC_ROWS(1);
  if (Tq <= 4) DC_ROWS(4);
  DC_ROWS(8);
#undef DC_ROWS
}

// bf16 q, T <= 8, Dh a multiple of 16 up to 128, any block size; q and the
// pools 16-byte aligned.  KV: bf16 pool, or int8 pool with scales.
template <typename KV, bool QUANT>
int dispatch_decode_split(const void* q, const void* pool_k,
                          const void* pool_v, const void* k_scale,
                          const void* v_scale, const void* table,
                          const void* start, void* out, int R, int H, int Tq,
                          int D, int bsz, int nbps, void* stream) {
  if (R < 1 || H < 1 || Tq < 1 || Tq > 8 || bsz < 1 || nbps < 1 || D < 16 ||
      D > DC_MAX_DH || D % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int lanes = D / 8;
#define DC_LANES(P)                                                         \
  return launch_decode_split_rows<KV, QUANT, P>(q, pool_k, pool_v, k_scale, \
                                                v_scale, table, start, out, \
                                                R, H, Tq, D, bsz, nbps, s)
  if (lanes <= 2) DC_LANES(2);
  if (lanes <= 4) DC_LANES(4);
  if (lanes <= 8) DC_LANES(8);
  DC_LANES(16);
#undef DC_LANES
}

// ---------------------------------------------------------------------------
// B6 with bf16 queries, over either pool: chunked prefill on the tensor
// cores (see the note at the top).  One CTA of PF_WARPS warps per (row,
// head, PF_WARPS * 16-row query tile); each warp owns 16 query rows.
// ---------------------------------------------------------------------------
constexpr int PF_WARPS = 4;   // warps a CTA, 16 query rows each
constexpr int PF_STAGES = 3;  // depth of the K/V ring
constexpr int PF_KEYS = 64;   // keys a stage of the K/V walk
constexpr int PF_THREADS = PF_WARPS * 32;
constexpr int PF_QT = PF_WARPS * 16;

// The pool's element type: int8 with f32 scales (QUANT), else bf16.
template <bool QUANT>
struct PfPool {
  using kv = __nv_bfloat16;
};
template <>
struct PfPool<true> {
  using kv = int8_t;
};

// Shared memory of one CTA at head width D; bf16 tile rows are padded by
// 16 bytes.  QUANT: the Q tile and the widened K and V tiles (bf16), a
// PF_STAGES-deep ring of int8 K and V rows and of their f32 scales.  Else:
// the Q tile and a PF_STAGES-deep ring of bf16 K and V tiles.
template <int D, bool QUANT>
constexpr size_t pf_smem_bytes() {
  return QUANT ? sizeof(__nv_bfloat16) * (size_t)(PF_QT + 2 * PF_KEYS) *
                         (D + 8) +
                     (size_t)PF_STAGES * 2 * PF_KEYS * (D + sizeof(float))
               : sizeof(__nv_bfloat16) *
                     (size_t)(PF_QT + PF_STAGES * 2 * PF_KEYS) * (D + 8);
}

// Bytes b and b + 1 of w (signed) as a bf16 pair: exact, an int8 value
// has at most 8 significant bits.
__device__ __forceinline__ uint32_t widen2(uint32_t w, int b) {
  return pack_bf16((float)((int32_t)(w << (24 - 8 * b)) >> 24),
                   (float)((int32_t)(w << (16 - 8 * b)) >> 24));
}

// 16 int8 values -> 16 bf16, one 16-byte read and two 16-byte writes.
__device__ __forceinline__ void widen16(__nv_bfloat16* dst,
                                        const int8_t* src) {
  const uint4 w = *reinterpret_cast<const uint4*>(src);
  *reinterpret_cast<uint4*>(dst) = make_uint4(
      widen2(w.x, 0), widen2(w.x, 2), widen2(w.y, 0), widen2(w.y, 2));
  *reinterpret_cast<uint4*>(dst + 8) = make_uint4(
      widen2(w.z, 0), widen2(w.z, 2), widen2(w.w, 0), widen2(w.w, 2));
}

// (a, b) as the bf16 pairs hi = bf16(a, b) and lo = bf16((a, b) - hi):
// hi + lo carries each value to about 2^-17 relative.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - __low2float(h), b - __high2float(h));
}

template <int D, bool QUANT>
__global__ void __launch_bounds__(PF_THREADS, 1) prefill_mma_kernel(
    const __nv_bfloat16* __restrict__ q,
    const typename PfPool<QUANT>::kv* __restrict__ pool_k,
    const typename PfPool<QUANT>::kv* __restrict__ pool_v,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int32_t* __restrict__ table, const int32_t* __restrict__ start,
    __nv_bfloat16* __restrict__ out, int RH, int H, int Tq, int bsz,
    int nbps, int n_tiles, float scale_log2) {
  using bf16 = __nv_bfloat16;
  using KV = typename PfPool<QUANT>::kv;
  constexpr int LD = D + 8;   // bf16 tile row stride
  constexpr int KD = D / 16;  // k16 steps over D, and n16 pairs over D
  constexpr int ND = D / 8;   // n8 tiles of the output
  constexpr int EPC = 16 / (int)sizeof(KV);  // pool elements a 16 bytes
  constexpr int CPR = D / EPC;               // 16-byte chunks a key row
  constexpr int RLD = QUANT ? D : LD;        // ring row stride, elements
  constexpr int VPR = D / 8;  // 16-byte bf16 chunks a query row
  extern __shared__ __align__(128) unsigned char pf_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(pf_smem);
  // QUANT: the widened tiles k_s and v_s, then the int8 ring and its
  // scales.  Else the bf16 ring starts where k_s would.
  bf16* k_s = q_s + PF_QT * LD;
  bf16* v_s = k_s + PF_KEYS * LD;
  KV* ring = reinterpret_cast<KV*>(QUANT ? v_s + PF_KEYS * LD : k_s);
  float* sc_ring =
      reinterpret_cast<float*>(ring + PF_STAGES * 2 * PF_KEYS * RLD);

  const int tid = threadIdx.x;
  const int ti = n_tiles - 1 - (int)(blockIdx.x / RH);  // longest first
  const int rh = blockIdx.x % RH;
  const int h = rh % H;
  const int r = rh / H;
  const int t0 = ti * PF_QT;
  const int rows = min(PF_QT, Tq - t0);
  const int qpos0 = start[r] + t0;
  // Last key any row of the tile reads, clipped into the table: a padded
  // chunk's rows past the slot's allocation see the whole table and stay
  // finite (the engine drops them); no table entry past nbps is read.
  const int kend = min(qpos0 + rows - 1, nbps * bsz - 1);
  const int n_stages = kend / PF_KEYS + 1;
  const int32_t* trow = table + (size_t)r * nbps;

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r0 = warp * 16;
  const int g = lane >> 2;        // fragment row (and row + 8)
  const int c2 = (lane & 3) * 2;  // fragment column pair
  const int lrow = lane & 7;
  const int lm0 = (lane >> 3) & 1;
  const int lm1 = lane >> 4;
  const bool live = r0 < rows;    // the warp holds a real query row
  const int warp_qlast = qpos0 + min(r0 + 15, rows - 1);

  // Q rows of the tile; rows past T load as zeros (never stored).
  const bf16* q_rows = q + ((size_t)rh * Tq + t0) * D;
  for (int i = tid; i < PF_QT * VPR; i += PF_THREADS) {
    const int row = i / VPR;
    const int c = i % VPR;
    bf16* dst = q_s + row * LD + c * 8;
    if (row < rows)
      cp_async16(dst, q_rows + (size_t)row * D + c * 8);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }

  // Stage st's 64 keys [st * 64, st * 64 + 63] into ring slot
  // st % PF_STAGES: key kpos is row kpos % bsz of physical block
  // table[kpos / bsz], D contiguous pool elements, so any block size
  // works.  Keys past kend are zero rows (with zero scales).
  auto issue = [&](int st) {
    const int k0 = st * PF_KEYS;
    KV* kd0 = ring + (st % PF_STAGES) * 2 * PF_KEYS * RLD;
    KV* vd0 = kd0 + PF_KEYS * RLD;
    for (int i = tid; i < PF_KEYS * CPR; i += PF_THREADS) {
      const int key = i / CPR;
      const int c = i % CPR;
      const int kpos = k0 + key;
      KV* kd = kd0 + key * RLD + c * EPC;
      KV* vd = vd0 + key * RLD + c * EPC;
      if (kpos <= kend) {
        const size_t row =
            ((size_t)trow[kpos / bsz] * H + h) * bsz + kpos % bsz;
        cp_async16(kd, pool_k + row * D + c * EPC);
        cp_async16(vd, pool_v + row * D + c * EPC);
      } else {
        *reinterpret_cast<int4*>(kd) = make_int4(0, 0, 0, 0);
        *reinterpret_cast<int4*>(vd) = make_int4(0, 0, 0, 0);
      }
    }
    if constexpr (QUANT) {
      float* sc = sc_ring + (st % PF_STAGES) * 2 * PF_KEYS;  // [K | V][64]
      for (int i = tid; i < 2 * PF_KEYS; i += PF_THREADS) {
        const int kpos = k0 + i % PF_KEYS;
        if (kpos <= kend) {
          const size_t row =
              ((size_t)trow[kpos / bsz] * H + h) * bsz + kpos % bsz;
          cp_async4(sc + i, (i < PF_KEYS ? k_scale : v_scale) + row);
        } else {
          sc[i] = 0.f;
        }
      }
    }
  };

  // One commit group a stage (empty past the last): group st is stage st.
  issue(0);
  cp_async_commit();  // group 0: Q and stage 0
#pragma unroll
  for (int st = 1; st < PF_STAGES - 1; ++st) {
    if (st < n_stages) issue(st);
    cp_async_commit();
  }

  uint32_t qf[KD][4];
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF;  // running max, scaled log2 units
  float l0 = 0.f, l1 = 0.f;          // this lane's share of the row sums
  const int qa = qpos0 + r0 + g;     // absolute positions of the two rows
  const int qb = qa + 8;

  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<PF_STAGES - 2>();  // this thread's stage st has landed
    __syncthreads();  // everyone's, and every warp is done with st - 1
    // Stage st + PF_STAGES - 1 into the ring slot stage st - 1 used.
    if (st + PF_STAGES - 1 < n_stages) issue(st + PF_STAGES - 1);
    cp_async_commit();
    // The bf16 K and V tiles ldmatrix reads: the ring slot itself (bf16
    // pool), or the slot's int8 rows widened (int8 pool, a second
    // barrier).
    const KV* kr = ring + (st % PF_STAGES) * 2 * PF_KEYS * RLD;
    const bf16* kt;
    const bf16* vt;
    if constexpr (QUANT) {
      const int8_t* vr = kr + PF_KEYS * D;
      for (int i = tid; i < PF_KEYS * CPR; i += PF_THREADS) {
        const int key = i / CPR;
        const int c = i % CPR;
        widen16(k_s + key * LD + c * 16, kr + key * D + c * 16);
        widen16(v_s + key * LD + c * 16, vr + key * D + c * 16);
      }
      __syncthreads();
      kt = k_s;
      vt = v_s;
    } else {
      kt = kr;
      vt = kr + PF_KEYS * LD;
    }
    if (st == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldsm_x4(qf[kk], q_s + (r0 + lrow + lm0 * 8) * LD + kk * 16 + lm1 * 8);
    }
    const int k0 = st * PF_KEYS;
    // A warp whose rows all precede this stage (or that holds no real
    // row) has nothing to add: every key here is masked for it.
    if (!live || k0 > warp_qlast) continue;
    const float* ksc = sc_ring + (st % PF_STAGES) * 2 * PF_KEYS;
    const float* vsc = ksc + PF_KEYS;

    // S = Q . K^T over the stage's 64 keys: 8 n8 tiles, two per ldmatrix.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t b[4];
        ldsm_x4(b, kt + (jj * 16 + lrow + lm1 * 8) * LD + kk * 16 + lm0 * 8);
        mma_bf16(s[2 * jj], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * jj + 1], qf[kk], b[2], b[3]);
      }
    }

    // Scale each column by scale (times k_scale[key] over the int8 pool;
    // log2 units), then mask: key k0 + col is visible to a row at qpos
    // iff k0 + col <= min(qpos, kend).  Only a stage that reaches past
    // the warp's first row or past kend needs the mask.
    const bool masked = k0 + PF_KEYS - 1 > min(qpos0 + r0, kend);
    const int lim0 = min(qa, kend) - k0;
    const int lim1 = min(qb, kend) - k0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float f0 = scale_log2, f1 = scale_log2;
      if constexpr (QUANT) {
        const float2 ks = *reinterpret_cast<const float2*>(ksc + j * 8 + c2);
        f0 = ks.x * scale_log2;
        f1 = ks.y * scale_log2;
      }
      s[j][0] *= f0;
      s[j][1] *= f1;
      s[j][2] *= f0;
      s[j][3] *= f1;
      if (masked) {
        const int col = j * 8 + c2;
        if (col > lim0) s[j][0] = NEG_INF;
        if (col + 1 > lim0) s[j][1] = NEG_INF;
        if (col > lim1) s[j][2] = NEG_INF;
        if (col + 1 > lim1) s[j][3] = NEG_INF;
      }
    }

    // Online softmax in registers (B2's): the row max over the quad's
    // four lanes; the first stage always holds key 0 <= qpos, so m is a
    // real score from then on and masked keys give exactly 0.
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
    mx0 = fmaxf(m0, mx0);
    mx1 = fmaxf(m1, mx1);
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
    // l sums the unscaled p.  P.V takes x = p (times v_scale[key] over
    // the int8 pool) as two bf16 A-fragments, hi = bf16(x) and lo =
    // bf16(x - hi), so the product carries x to about 2^-17 relative
    // where one bf16 copy would carry it to 2^-9 (a few output steps on a
    // peaked row).  S tiles 2kk and 2kk + 1 are P.V's k16 step kk.
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = ex2(s[j][0] - mx0);
      const float p1 = ex2(s[j][1] - mx0);
      const float p2 = ex2(s[j][2] - mx1);
      const float p3 = ex2(s[j][3] - mx1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      float x0 = p0, x1 = p1, x2 = p2, x3 = p3;
      if constexpr (QUANT) {
        const float2 vs = *reinterpret_cast<const float2*>(vsc + j * 8 + c2);
        x0 = p0 * vs.x;
        x1 = p1 * vs.y;
        x2 = p2 * vs.x;
        x3 = p3 * vs.y;
      }
      split_bf16(x0, x1, ph[j >> 1][(j & 1) * 2], pl[j >> 1][(j & 1) * 2]);
      split_bf16(x2, x3, ph[j >> 1][(j & 1) * 2 + 1],
                 pl[j >> 1][(j & 1) * 2 + 1]);
    }

    // O += P . V: V's B-fragments through ldmatrix.trans, two n8 tiles
    // each, times both halves of P.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int nn = 0; nn < KD; ++nn) {
        uint32_t b[4];
        ldsm_x4_trans(b, vt + (kk * 16 + lrow + lm0 * 8) * LD + nn * 16 +
                             lm1 * 8);
        mma_bf16(acc[2 * nn], ph[kk], b[0], b[1]);
        mma_bf16(acc[2 * nn + 1], ph[kk], b[2], b[3]);
        mma_bf16(acc[2 * nn], pl[kk], b[0], b[1]);
        mma_bf16(acc[2 * nn + 1], pl[kk], b[2], b[3]);
      }
    }
  }
  if (!live) return;

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);

  // Epilogue: this warp's rows of the Q tile (read only by this warp, at
  // stage 0) stage the bf16 output for 16-byte coalesced stores of the
  // rows inside T.
  bf16* stage = q_s + r0 * LD;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    *reinterpret_cast<uint32_t*>(stage + g * LD + n * 8 + c2) =
        pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * LD + n * 8 + c2) =
        pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
  __syncwarp();
  bf16* o_rows = out + ((size_t)rh * Tq + t0 + r0) * D;
#pragma unroll
  for (int it = 0; it < 16 * VPR / 32; ++it) {
    const int i = lane + it * 32;
    const int row = i / VPR;
    const int c = i % VPR;
    if (r0 + row < rows)
      *reinterpret_cast<uint4*>(o_rows + (size_t)row * D + c * 8) =
          *reinterpret_cast<const uint4*>(stage + row * LD + c * 8);
  }
}

template <int D, bool QUANT>
int launch_prefill_mma(const void* q, const void* pool_k, const void* pool_v,
                       const void* k_scale, const void* v_scale,
                       const void* table, const void* start, void* out,
                       int R, int H, int Tq, int bsz, int nbps,
                       cudaStream_t stream) {
  using KV = typename PfPool<QUANT>::kv;
  constexpr size_t smem = pf_smem_bytes<D, QUANT>();
  cudaError_t err = cudaFuncSetAttribute(
      prefill_mma_kernel<D, QUANT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (Tq + PF_QT - 1) / PF_QT;
  const long long grid = (long long)R * H * n_tiles;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float scale_log2 =
      (float)(1.0 / sqrt((double)D) * 1.4426950408889634);
  prefill_mma_kernel<D, QUANT><<<(unsigned)grid, PF_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(pool_k),
      static_cast<const KV*>(pool_v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(start), static_cast<__nv_bfloat16*>(out),
      R * H, H, Tq, bsz, nbps, n_tiles, scale_log2);
  return (int)cudaGetLastError();
}

// Head widths the kernel is built for: multiples of 16 up to 128.
template <bool QUANT>
int dispatch_prefill_mma(const void* q, const void* pool_k,
                         const void* pool_v, const void* k_scale,
                         const void* v_scale, const void* table,
                         const void* start, void* out, int R, int H, int Tq,
                         int Dh, int bsz, int nbps, void* stream) {
  if (R < 1 || H < 1 || Tq < 1 || bsz < 1 || nbps < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PF_CASE(DV)                                                      \
  case DV:                                                               \
    return launch_prefill_mma<DV, QUANT>(q, pool_k, pool_v, k_scale,     \
                                         v_scale, table, start, out, R, \
                                         H, Tq, bsz, nbps, s);
  switch (Dh) {
    PF_CASE(16)
    PF_CASE(32)
    PF_CASE(48)
    PF_CASE(64)
    PF_CASE(80)
    PF_CASE(96)
    PF_CASE(112)
    PF_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PF_CASE
}

// Trust accumulators of B7 and B8: over some values x of a row, their
// maximum m (which is also the top-1), the runner-up t2 (a duplicated
// maximum gives t2 == m), s = sum e^{x - m} and w = sum x e^{x - m}.  The
// empty set is (NEG_INF, NEG_INF, 0, 0); e^{NEG_INF - m} flushes to 0, so
// it weighs nothing in a merge.
struct TrustAcc {
  float m, t2, s, w;
};

__device__ __forceinline__ TrustAcc trust_empty() {
  return TrustAcc{NEG_INF, NEG_INF, 0.f, 0.f};
}

// max/min only, so a margin is bit-exact against top-k of the same values.
__device__ __forceinline__ void top2_push(float& t1, float& t2, float x) {
  t2 = fmaxf(t2, fminf(t1, x));
  t1 = fmaxf(t1, x);
}

__device__ __forceinline__ TrustAcc trust_merge(const TrustAcc& a,
                                                const TrustAcc& b) {
  TrustAcc o;
  o.m = fmaxf(a.m, b.m);
  o.t2 = fmaxf(fminf(a.m, b.m), fmaxf(a.t2, b.t2));
  const float ca = expf(a.m - o.m);
  const float cb = expf(b.m - o.m);
  o.s = a.s * ca + b.s * cb;
  o.w = a.w * ca + b.w * cb;
  return o;
}

// The fixed xor tree over a warp's lanes: every lane ends with the merge.
__device__ __forceinline__ TrustAcc trust_warp_merge(TrustAcc a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    TrustAcc b;
    b.m = __shfl_xor_sync(0xffffffffu, a.m, off);
    b.t2 = __shfl_xor_sync(0xffffffffu, a.t2, off);
    b.s = __shfl_xor_sync(0xffffffffu, a.s, off);
    b.w = __shfl_xor_sync(0xffffffffu, a.w, off);
    a = trust_merge(a, b);
  }
  return a;
}

// entropy = -sum p log p = logZ - sum p x, p = e^{x - m} / s; margin =
// top1 - top2.
__device__ __forceinline__ void trust_write(const TrustAcc& a, float* ent,
                                            float* mar) {
  const float s = fmaxf(a.s, 1e-30f);
  *ent = (a.m + logf(s)) - a.w / s;
  *mar = a.m - a.t2;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// B7: the trust epilogue, one row over a thread-block cluster.
// ---------------------------------------------------------------------------

constexpr int TS_THREADS = 256;
constexpr int TS_WARPS = TS_THREADS / 32;
constexpr int TS_VECS = 8;  // 16-byte loads a thread holds a round
constexpr int TS_MAX_CLUSTER = 16;
// Rows up to which a row takes TS_MAX_CLUSTER CTAs; past it, 8.
constexpr int TS_WIDE_ROWS = 4;
constexpr int MAX_DEVICES = 64;

// One CTA of row blockIdx.x / C: cluster rank c reads the row's aligned
// float4s [c n4 / C, (c + 1) n4 / C); rank 0 also the (at most 3) floats
// before the first 16-byte boundary and rank C - 1 those after the last.
template <int C>
__global__ void __launch_bounds__(TS_THREADS) trust_cluster_kernel(
    const float* __restrict__ logits, float* __restrict__ entropy,
    float* __restrict__ margin, int V) {
  namespace cg = cooperative_groups;
  __shared__ TrustAcc warp_acc[TS_WARPS];
  __shared__ TrustAcc rank_acc[C];
  cg::cluster_group cluster = cg::this_cluster();
  // Arrive now, wait before rank 0's shared memory is written: the peers
  // have started by then, and the barrier costs nothing meanwhile.
  cluster_arrive_relaxed();
  const int rank = (int)cluster.block_rank();
  const int row = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const float* x = logits + (size_t)row * V;
  // Row r starts at byte 4 r V: with V odd, every other row is not
  // 16-byte aligned.  No padding: a scalar head and tail.
  const int head =
      min(V, (int)(((16u - ((unsigned)(uintptr_t)x & 15u)) & 15u) >> 2));
  const int n4 = (V - head) >> 2;
  const int tail0 = head + 4 * n4;
  const int v0 = (int)((long long)rank * n4 / C);
  const int v1 = (int)((long long)(rank + 1) * n4 / C);
  const float4* xv = reinterpret_cast<const float4*>(x + head);

  float sx = 0.f;
  bool sok = false;
  if (rank == 0 && tid < head) {
    sx = x[tid];
    sok = true;
  } else if (rank == C - 1 && tid >= 4 && tid - 4 < V - tail0) {
    sx = x[tail0 + tid - 4];
    sok = true;
  }

  // Rounds of TS_VECS float4s a thread: every load of a round is issued
  // before any arithmetic; the round's max first, then one e^{x - m} a
  // value (no running rescale), then one merge.  GPT-2's 50257 columns are
  // one round at C >= 8; any V loops.
  TrustAcc a = trust_empty();
  for (int base = v0; base < v1; base += TS_VECS * TS_THREADS) {
    float4 buf[TS_VECS];
#pragma unroll
    for (int k = 0; k < TS_VECS; ++k) {
      const int i = base + k * TS_THREADS + tid;
      buf[k] = i < v1 ? __ldg(xv + i)
                      : make_float4(NEG_INF, NEG_INF, NEG_INF, NEG_INF);
    }
    float t1 = NEG_INF, t2 = NEG_INF;
#pragma unroll
    for (int k = 0; k < TS_VECS; ++k) {
      top2_push(t1, t2, buf[k].x);
      top2_push(t1, t2, buf[k].y);
      top2_push(t1, t2, buf[k].z);
      top2_push(t1, t2, buf[k].w);
    }
    float s = 0.f, w = 0.f;
#pragma unroll
    for (int k = 0; k < TS_VECS; ++k) {
      if (base + k * TS_THREADS + tid < v1) {
        const float e0 = expf(buf[k].x - t1);
        const float e1 = expf(buf[k].y - t1);
        const float e2 = expf(buf[k].z - t1);
        const float e3 = expf(buf[k].w - t1);
        s += (e0 + e1) + (e2 + e3);
        w += (buf[k].x * e0 + buf[k].y * e1) + (buf[k].z * e2 + buf[k].w * e3);
      }
    }
    a = trust_merge(a, TrustAcc{t1, t2, s, w});
  }
  if (sok) a = trust_merge(a, TrustAcc{sx, NEG_INF, 1.f, sx});

  // Lanes, then warps, then ranks, each in a fixed order: the same bits
  // every launch.
  a = trust_warp_merge(a);
  if (lane == 0) warp_acc[warp] = a;
  __syncthreads();
  if (warp == 0) {
    a = lane < TS_WARPS ? warp_acc[lane] : trust_empty();
    a = trust_warp_merge(a);
  }
  cluster_wait();
  if (tid == 0) *cluster.map_shared_rank(&rank_acc[rank], 0) = a;
  cluster.sync();  // every rank's partial is in rank 0's shared memory
  if (rank == 0 && warp == 0) {
    a = lane < C ? rank_acc[lane] : trust_empty();
    a = trust_warp_merge(a);
    if (lane == 0) trust_write(a, entropy + row, margin + row);
  }
}

template <int C>
int launch_trust(const float* logits, float* entropy, float* margin, int B,
                 int V, cudaStream_t stream) {
  // The non-portable cluster size's opt-in, once a device.
  static bool ready[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (C > 8 && !ready[dev]) {
    err = cudaFuncSetAttribute(trust_cluster_kernel<C>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(C * B), 1, 1);
  cfg.blockDim = dim3(TS_THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, trust_cluster_kernel<C>, logits, entropy,
                           margin, V);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B8: fused speculative-verify tail.
// ---------------------------------------------------------------------------

constexpr int VT_WARPS = 8;
constexpr int VT_THREADS = VT_WARPS * 32;
// Vocab columns a tile: a 16-column group (two n8 tiles) a warp.
constexpr int VT_COLS = 16 * VT_WARPS;
constexpr int VT_MAX_MT = 6;     // m16 tiles of rows: B <= 96
// The ring's depth: two stages in flight while one multiplies (3 and 7
// measured the same: the cp.async issue, not the depth, limits it).
constexpr int VT_STAGES = 3;
constexpr int VT_SMEM_LIMIT = 232448;  // the H100's 227 KB a block
// The fold: 8 lanes a row, VT_FOLD partials a lane, so a launch may take
// up to 8 VT_FOLD CTAs (one an SM).
constexpr int VT_FOLD = 20;
constexpr int VT_MAX_CTAS = 8 * VT_FOLD;
constexpr float LOG2E = 1.4426950408889634f;

// normed's rows padded to 16 ([rows16, D + 8] bf16) and the ring.
// A ring stage is [VT_COLS, KC] of the head (K depth KC, 128 or 64), its
// rows padded by 16 bytes for ldmatrix.
size_t vt_smem_bytes(int rows16, int D, int kc) {
  return (size_t)rows16 * (D + 8) * 2 +
         (size_t)VT_STAGES * VT_COLS * (kc + 8) * 2;
}

// One persistent CTA (one an SM): columns [16 g0, 16 g1) of the vocab, an
// even share of its 16-column groups, walked in 128-column tiles, warp w
// on group w of a tile.  Products: logits = normed . head^T with mma.sync
// m16n8k16, normed rows the A operand (MT m16 tiles), the warp's 16 head
// rows the B operand (two n8 tiles).  C fragment element e of m16 tile i
// and n8 tile n is row 16 i + g + 8 (e >> 1) and column 8 n + 2 t + (e &
// 1) of the warp's group, g = lane / 4, t = lane % 4: a lane holds 4
// columns of each of its 2 MT rows a tile.
template <int MT, int KC>
__global__ void __launch_bounds__(VT_THREADS, 1) verify_stream_kernel(
    const __nv_bfloat16* __restrict__ normed,
    const __nv_bfloat16* __restrict__ head, float* __restrict__ logits,
    float4* __restrict__ part, float* __restrict__ entropy,
    float* __restrict__ margin, unsigned int* __restrict__ arrivals, int B,
    int D, int V) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char vt_smem[];
  const int ldx = D + 8;
  bf16* x_s = reinterpret_cast<bf16*>(vt_smem);
  bf16* ring = reinterpret_cast<bf16*>(vt_smem + (size_t)MT * 16 * ldx * 2);

  const int G = (int)gridDim.x;
  const int cta = blockIdx.x;
  const int ngroups = (V + 15) / 16;
  const int g0 = (int)((long long)cta * ngroups / G);
  const int g1 = (int)((long long)(cta + 1) * ngroups / G);
  constexpr int WP = KC + 8;  // bf16 pitch of a stage's head row
  const int nkc = (D + KC - 1) / KC;
  const int nq = (g1 - g0 + VT_WARPS - 1) / VT_WARPS * nkc;  // ring stages
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int lrow = lane & 7;
  const int lm0 = (lane >> 3) & 1;
  const int lm1 = lane >> 4;

  // normed's padding rows are zeros; its rows arrive a K chunk at a time
  // with the first tile's stages, so the first products wait for one
  // chunk of normed, not all of it.
  for (int i = tid; i < (16 * MT - B) * (D / 8); i += VT_THREADS) {
    const int r = B + i / (D / 8);
    *reinterpret_cast<uint4*>(x_s + r * ldx + (i % (D / 8)) * 8) =
        make_uint4(0u, 0u, 0u, 0u);
  }

  // Thread tid copies 16-byte vector tid % VPR of stage rows tid / VPR +
  // RSTEP j.
  constexpr int VPR = KC / 8;
  constexpr int RSTEP = VT_THREADS / VPR;
  const int lr = tid / VPR;
  const int lv = (tid % VPR) * 8;
  // Stage (tile ti, K chunk kc) into ring slot `slot`: the tile's head
  // rows inside [16 g0, 16 g1) (whole groups; rows at or past V are
  // zeros), K columns [k0, k0 + kw); in the first tile also normed's rows
  // of the same K columns.
  auto load = [&](int ti, int kc, int slot) {
    const int k0 = kc * KC;
    const int kw = min(KC, D - k0);
    const int col0 = (g0 + VT_WARPS * ti) * 16;
    const int rows = min(VT_WARPS, g1 - g0 - VT_WARPS * ti) * 16;
    bf16* ws = ring + (size_t)slot * VT_COLS * WP + lr * WP + lv;
    const bf16* src = head + (size_t)(col0 + lr) * D + k0 + lv;
    if (lv < kw) {
#pragma unroll
      for (int j = 0; j < VT_COLS / RSTEP; ++j) {
        const int r = lr + RSTEP * j;
        if (r < rows) {
          if (col0 + r < V)
            cp_async16(ws + RSTEP * j * WP, src + (size_t)RSTEP * j * D);
          else
            *reinterpret_cast<uint4*>(ws + RSTEP * j * WP) =
                make_uint4(0u, 0u, 0u, 0u);
        }
      }
      if (ti == 0)
        for (int r = lr; r < B; r += RSTEP)
          cp_async16(x_s + r * ldx + k0 + lv,
                     normed + (size_t)r * D + k0 + lv);
    }
  };

  float acc[MT][2][4];
  // The lane's running statistics of its rows 16 i + g + 8 h over every
  // column it has held: no shuffle until the CTA's columns are done.
  TrustAcc run[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) run[i][0] = run[i][1] = trust_empty();

  // The stage being loaded: (tile, chunk, slot), advanced without
  // division.
  int lti = 0, lkc = 0, lslot = 0;
  auto advance = [&]() {
    if (++lkc == nkc) {
      lkc = 0;
      ++lti;
    }
    if (++lslot == VT_STAGES) lslot = 0;
  };
  for (int s = 0; s < VT_STAGES - 1; ++s) {
    if (s < nq) {
      load(lti, lkc, lslot);
      advance();
    }
    cp_async_commit();
  }
  int ti = 0, kc = 0, slot = 0;
  for (int q = 0; q < nq; ++q) {
    cp_async_wait<VT_STAGES - 2>();
    __syncthreads();  // stage q landed; the slot before it is free
    if (q + VT_STAGES - 1 < nq) {
      load(lti, lkc, lslot);
      advance();
    }
    cp_async_commit();

    const int gw = g0 + VT_WARPS * ti + warp;  // the warp's group
    if (gw < g1) {
      if (kc == 0) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int n = 0; n < 2; ++n)
            acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;
      }
      const bf16* ws = ring + (size_t)slot * VT_COLS * WP;
      const int k0 = kc * KC;
      const int kb = min(KC, D - k0) / 16;
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        if (kk < kb) {
          uint32_t b[4];
          ldsm_x4(b, ws + (16 * warp + lrow + lm1 * 8) * WP + kk * 16 +
                         lm0 * 8);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            uint32_t af[4];
            ldsm_x4(af, x_s + (16 * i + lrow + lm0 * 8) * ldx + k0 +
                            kk * 16 + lm1 * 8);
            mma_bf16(acc[i][0], af, b[0], b[1]);
            mma_bf16(acc[i][1], af, b[2], b[3]);
          }
        }
      }
      if (kc == nkc - 1) {
        // The tile's epilogue, from the fragments: round through bf16
        // (the compute-dtype matmul's output), store, and fold into the
        // lane's running statistics - the tile's top-2 by max/min, then
        // one 2^x a value against the new max.  Columns at or past V stay
        // out.
        const int colw = gw * 16 + 2 * t;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = 16 * i + g + 8 * h;
            float xv[4];
            bool ok[4];
            float t1 = NEG_INF, t2 = NEG_INF;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = colw + 8 * (e >> 1) + (e & 1);
              ok[e] = col < V;
              xv[e] = __bfloat162float(
                  __float2bfloat16(acc[i][e >> 1][2 * h + (e & 1)]));
              if (ok[e]) {
                if (row < B) logits[(size_t)row * V + col] = xv[e];
                top2_push(t1, t2, xv[e]);
              }
            }
            TrustAcc& r = run[i][h];
            const float m = fmaxf(r.m, t1);
            const float ml = m * LOG2E;
            const float corr = ex2(fmaf(r.m, LOG2E, -ml));
            float s = 0.f, w = 0.f;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (ok[e]) {
                const float ex = ex2(fmaf(xv[e], LOG2E, -ml));
                s += ex;
                w += xv[e] * ex;
              }
            }
            r.t2 = fmaxf(fminf(r.m, t1), fmaxf(r.t2, t2));
            r.s = r.s * corr + s;
            r.w = r.w * corr + w;
            r.m = m;
          }
        }
      }
    }
    if (++kc == nkc) {
      kc = 0;
      ++ti;
    }
    if (++slot == VT_STAGES) slot = 0;
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is drained: it holds the warps' rows now

  // A row's 4 lanes (xor 1, 2), then its warps in order: the CTA's
  // partial of every row.
  TrustAcc* red = reinterpret_cast<TrustAcc*>(ring);  // [VT_WARPS][16 MT]
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      TrustAcc a = run[i][h];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        TrustAcc b;
        b.m = __shfl_xor_sync(0xffffffffu, a.m, off);
        b.t2 = __shfl_xor_sync(0xffffffffu, a.t2, off);
        b.s = __shfl_xor_sync(0xffffffffu, a.s, off);
        b.w = __shfl_xor_sync(0xffffffffu, a.w, off);
        a = trust_merge(a, b);
      }
      if (t == 0) red[warp * 16 * MT + 16 * i + g + 8 * h] = a;
    }
  __syncthreads();
  for (int r = tid; r < B; r += VT_THREADS) {
    TrustAcc a = red[r];
#pragma unroll
    for (int w = 1; w < VT_WARPS; ++w) a = trust_merge(a, red[w * 16 * MT + r]);
    part[(size_t)r * G + cta] = make_float4(a.m, a.t2, a.s, a.w);
  }
  // Every thread's partials are visible before the count says so: each
  // thread fences its own stores, the barrier waits for all of them, and
  // only then does one thread count the CTA.
  __threadfence();
  __syncthreads();
  unsigned int done = 0;
  if (tid == 0) done = atomicAdd(arrivals, 1u);
  if (!__syncthreads_or(tid == 0 && done == (unsigned)G - 1)) return;

  // The last CTA folds every row: 8 lanes a row, so 32 rows at a time;
  // lane u of a row holds the partials of CTAs u, u + 8, ... (in L2, just
  // written).  The row's max first, then one 2^{m_c - M} a partial, then
  // fixed xor trees: the same bits every launch, whichever CTA is last.
  __threadfence();
  const int u = lane & 7;
  for (int r = tid >> 3; r - (tid >> 3) < B; r += VT_THREADS / 8) {
    float4 p[VT_FOLD];
#pragma unroll
    for (int k = 0; k < VT_FOLD; ++k) {
      const int c = u + 8 * k;
      p[k] = r < B && c < G ? __ldcg(part + (size_t)r * G + c)
                            : make_float4(NEG_INF, NEG_INF, 0.f, 0.f);
    }
    float t1 = NEG_INF, t2 = NEG_INF;
#pragma unroll
    for (int k = 0; k < VT_FOLD; ++k) {
      t2 = fmaxf(fminf(t1, p[k].x), fmaxf(t2, p[k].y));
      t1 = fmaxf(t1, p[k].x);
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      const float o1 = __shfl_xor_sync(0xffffffffu, t1, off);
      const float o2 = __shfl_xor_sync(0xffffffffu, t2, off);
      t2 = fmaxf(fminf(t1, o1), fmaxf(t2, o2));
      t1 = fmaxf(t1, o1);
    }
    const float ml = t1 * LOG2E;
    float s = 0.f, w = 0.f;
#pragma unroll
    for (int k = 0; k < VT_FOLD; ++k) {
      const float c = ex2(fmaf(p[k].x, LOG2E, -ml));
      s += p[k].z * c;
      w += p[k].w * c;
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      w += __shfl_xor_sync(0xffffffffu, w, off);
    }
    if (u == 0 && r < B)
      trust_write(TrustAcc{t1, t2, s, w}, entropy + r, margin + r);
  }
}

template <int MT, int KC>
int launch_verify(const void* normed, const void* head, void* logits,
                  void* part, void* entropy, void* margin,
                  unsigned int* arrivals, int B, int D, int V,
                  cudaStream_t stream) {
  // The instance's shared-memory opt-in and the card's SM count, once a
  // device (0 until then; a race sets the same values twice).
  static int sms_of[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (sms_of[dev] == 0) {
    int sms = 0;
    err = cudaFuncSetAttribute(verify_stream_kernel<MT, KC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               VT_SMEM_LIMIT);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    sms_of[dev] = sms;
  }
  const int tiles = (V + VT_COLS - 1) / VT_COLS;
  const int grid = min(min(sms_of[dev], VT_MAX_CTAS), tiles);
  verify_stream_kernel<MT, KC>
      <<<grid, VT_THREADS, vt_smem_bytes(16 * MT, D, KC), stream>>>(
          static_cast<const __nv_bfloat16*>(normed),
          static_cast<const __nv_bfloat16*>(head), static_cast<float*>(logits),
          static_cast<float4*>(part), static_cast<float*>(entropy),
          static_cast<float*>(margin), arrivals, B, D, V);
  return (int)cudaGetLastError();
}

// 128-deep stages (half the stages, and their bookkeeping, of 64-deep
// ones) wherever the ring of them fits beside normed, else 64-deep ones.
// The launch's arrival count is the word after its partials, zeroed on
// the stream before the launch: each call counts on a word of its own.
template <int MT>
int dispatch_verify(const void* normed, const void* head, void* logits,
                    void* part, void* entropy, void* margin, int B, int D,
                    int V, cudaStream_t stream) {
  unsigned int* arrivals = reinterpret_cast<unsigned int*>(
      static_cast<float4*>(part) + (size_t)B * ((V + VT_COLS - 1) / VT_COLS));
  const bool deep = vt_smem_bytes(16 * MT, D, 128) <= (size_t)VT_SMEM_LIMIT;
  if (!deep && vt_smem_bytes(16 * MT, D, 64) > (size_t)VT_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaMemsetAsync(arrivals, 0, sizeof(unsigned int), stream);
  if (err != cudaSuccess) return (int)err;
  if (deep)
    return launch_verify<MT, 128>(normed, head, logits, part, entropy,
                                  margin, arrivals, B, D, V, stream);
  return launch_verify<MT, 64>(normed, head, logits, part, entropy, margin,
                               arrivals, B, D, V, stream);
}

}  // namespace

extern "C" {

// B5: q [R, H, T, Dh] (T <= 8).  bf16 q runs the split-K cluster kernel
// (Dh a multiple of 16, at most 128; q and pools 16-byte aligned); f32 q
// the CUDA-core kernel, one query tile per (row, head).
int tddl_paged_decode(const void* q, const void* pool_k, const void* pool_v,
                      const void* table, const void* start, void* out, int R,
                      int H, int T, int Dh, int bsz, int nbps, int dtype,
                      void* stream) {
  if (dtype == 1)
    return dispatch_decode_split<__nv_bfloat16, false>(
        q, pool_k, pool_v, nullptr, nullptr, table, start, out, R, H, T, Dh,
        bsz, nbps, stream);
  return dispatch_attn(dtype, q, pool_k, pool_v, nullptr, nullptr, table,
                       start, out, R, H, T, Dh, bsz, nbps, T, stream);
}

// B5, int8 pool: pool_k/pool_v int8 [NB, H, BLOCK, Dh], scales f32
// [NB, H, BLOCK]; kernels chosen by q's dtype as tddl_paged_decode's.
int tddl_paged_decode_int8(const void* q, const void* pool_k,
                           const void* pool_v, const void* k_scale,
                           const void* v_scale, const void* table,
                           const void* start, void* out, int R, int H, int T,
                           int Dh, int bsz, int nbps, int dtype,
                           void* stream) {
  if (k_scale == nullptr || v_scale == nullptr)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return dispatch_decode_split<int8_t, true>(q, pool_k, pool_v, k_scale,
                                               v_scale, table, start, out, R,
                                               H, T, Dh, bsz, nbps, stream);
  return dispatch_attn(dtype, q, pool_k, pool_v, k_scale, v_scale, table,
                       start, out, R, H, T, Dh, bsz, nbps, T, stream);
}

// B6: q [R, H, T, Dh].  bf16 q runs the tensor-core kernel (64-row query
// tiles, q_tile unused; Dh a multiple of 16, at most 128, any block size;
// q, pools and out 16-byte aligned); f32 q the CUDA-core kernel with
// q_tile-row tiles.
int tddl_paged_prefill(const void* q, const void* pool_k, const void* pool_v,
                       const void* table, const void* start, void* out, int R,
                       int H, int T, int Dh, int bsz, int nbps, int q_tile,
                       int dtype, void* stream) {
  if (dtype == 1)
    return dispatch_prefill_mma<false>(q, pool_k, pool_v, nullptr, nullptr,
                                       table, start, out, R, H, T, Dh, bsz,
                                       nbps, stream);
  return dispatch_attn(dtype, q, pool_k, pool_v, nullptr, nullptr, table,
                       start, out, R, H, T, Dh, bsz, nbps, q_tile, stream);
}

// B6, int8 pool (layouts as tddl_paged_decode_int8).  bf16 q runs the
// tensor-core kernel (Dh a multiple of 16, at most 128; q, pools and out
// 16-byte aligned); f32 q the CUDA-core kernel with q_tile-row tiles.
int tddl_paged_prefill_int8(const void* q, const void* pool_k,
                            const void* pool_v, const void* k_scale,
                            const void* v_scale, const void* table,
                            const void* start, void* out, int R, int H,
                            int T, int Dh, int bsz, int nbps, int q_tile,
                            int dtype, void* stream) {
  if (k_scale == nullptr || v_scale == nullptr)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)  // bf16 q: the tensor-core kernel (q_tile unused)
    return dispatch_prefill_mma<true>(q, pool_k, pool_v, k_scale, v_scale,
                                      table, start, out, R, H, T, Dh, bsz,
                                      nbps, stream);
  return dispatch_attn(dtype, q, pool_k, pool_v, k_scale, v_scale, table,
                       start, out, R, H, T, Dh, bsz, nbps, q_tile, stream);
}

// B7: f32 logits [B, V] -> entropy [B], margin [B]; any B >= 1, V >= 1,
// logits 4-byte aligned (a row need not be 16-byte aligned).
int tddl_trust_stats(const void* logits, void* entropy, void* margin, int B,
                     int V, void* stream) {
  if (B < 1 || V < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(logits);
  float* ent = static_cast<float*>(entropy);
  float* mar = static_cast<float*>(margin);
  if (B <= TS_WIDE_ROWS)
    return launch_trust<TS_MAX_CLUSTER>(x, ent, mar, B, V, s);
  return launch_trust<8>(x, ent, mar, B, V, s);
}

// B8: normed bf16 [B, D] x head bf16 [V, D] -> logits f32 [B, V] (rounded
// through bf16), entropy [B], margin [B], in one launch.  B <= 96, D % 16
// == 0, normed and head 16-byte aligned; partials is scratch of
// B x ceil(V / 128) float4s, 16-byte aligned, then the launch's 4-byte
// arrival count.
int tddl_verify_tail(const void* normed, const void* head, void* logits,
                     void* partials, void* entropy, void* margin, int B,
                     int D, int V, void* stream) {
  if (B < 1 || B > 16 * VT_MAX_MT || D < 16 || D % 16 || V < 1 ||
      reinterpret_cast<uintptr_t>(partials) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VT_CASE(MT)                                                       \
  case MT:                                                                \
    return dispatch_verify<MT>(normed, head, logits, partials, entropy,   \
                               margin, B, D, V, s);
  switch ((B + 15) / 16) {
    VT_CASE(1)
    VT_CASE(2)
    VT_CASE(3)
    VT_CASE(4)
    VT_CASE(5)
    VT_CASE(6)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VT_CASE
}

const char* tddl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
