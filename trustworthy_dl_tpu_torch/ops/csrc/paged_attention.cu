// Serving kernels for Hopper (sm_90a): ragged paged-decode attention (B5),
// query-tiled chunked-prefill attention (B6) and the trust epilogue (B7).
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
// bf16 against 4 * len * Dh flops - far under the ~295 flop/byte ridge.
// The design therefore aims only at reading each needed byte once:
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
// Dot products run on the CUDA cores in f32 (no wgmma/TMA yet): with at
// most 8 query rows per CTA the tensor cores would idle on a 64-row tile,
// and the work is memory-bound either way.  Faster staging (cp.async/TMA,
// split-K over long caches) is later work.
//
// B7 replaces _trust_stats_kernel (_trust_stats_call): for each row of
// f32 logits [B, V] it returns the softmax entropy logZ - sum(x p) and the
// top-1 margin top1 - top2 in one read of the row.  Bound: bytes (one read
// of B * V * 4).  One CTA per row; each thread strides over V keeping the
// online (m, sum e^{x-m}, sum x e^{x-m}) and an exact top-2 pair, then
// warps merge by shuffles and warp 0 merges the warps.  The top-2 merge
// keeps a duplicated maximum (top2 == top1, margin 0) and uses only
// max/min, so the margin is bit-exact against top-k of the same values.
// The row is bounds-checked against V instead of being padded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int ATTN_THREADS = 128;
constexpr int TRUST_THREADS = 1024;
// Keys staged per iteration of the attention loop (whole blocks).
constexpr int STAGE_KEYS = 64;
constexpr size_t STATIC_SMEM_LIMIT = 48 * 1024;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One CTA = (row r, head h, query tile ti).  Decode is the one-tile case.
template <typename T>
__global__ void __launch_bounds__(ATTN_THREADS) paged_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ pool_k,
    const T* __restrict__ pool_v, const int32_t* __restrict__ table,
    const int32_t* __restrict__ start, T* __restrict__ out, int H, int Tq,
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

  const size_t head_row = (size_t)(r * H + h) * Tq + t0;
  const T* q_rows = q + head_row * Dh;
  for (int i = tid; i < rows * Dh; i += blockDim.x) {
    q_s[i] = to_f(q_rows[i]);
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
      const T* kb = pool_k + base;
      const T* vb = pool_v + base;
      for (int i = tid; i < blk_elems; i += blockDim.x) {
        const int key = b * bsz + i / Dh;
        const int d = i % Dh;
        k_s[key * ldk + d] = to_f(kb[i]);
        v_s[key * Dh + d] = to_f(vb[i]);
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
      p_s[t * kt + key] = (kpos0 + key <= qpos0 + t) ? dot * scale : NEG_INF;
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
        pr[key] = e;
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

  T* o_rows = out + head_row * Dh;
  for (int i = tid; i < rows * Dh; i += blockDim.x) {
    o_rows[i] = from_f<T>(acc[i] / fmaxf(l_s[i / Dh], 1e-30f));
  }
}

size_t attn_smem_bytes(int q_tile, int Dh, int kt) {
  return sizeof(float) * ((size_t)2 * q_tile * Dh + (size_t)kt * (Dh + 1) +
                          (size_t)kt * Dh + (size_t)q_tile * kt + 3 * q_tile);
}

template <typename T>
int launch_attn(const void* q, const void* pool_k, const void* pool_v,
                const void* table, const void* start, void* out, int R, int H,
                int Tq, int Dh, int bsz, int nbps, int q_tile,
                cudaStream_t stream) {
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
  paged_attn_kernel<T><<<R * H * n_tiles, ATTN_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool_k),
      static_cast<const T*>(pool_v), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(start), static_cast<T*>(out), H, Tq, Dh, bsz,
      nbps, q_tile, n_tiles, stage_blocks, scale);
  return (int)cudaGetLastError();
}

int dispatch_attn(int dtype, const void* q, const void* pool_k,
                  const void* pool_v, const void* table, const void* start,
                  void* out, int R, int H, int Tq, int Dh, int bsz, int nbps,
                  int q_tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_attn<float>(q, pool_k, pool_v, table, start, out, R, H, Tq,
                              Dh, bsz, nbps, q_tile, s);
  if (dtype == 1)
    return launch_attn<__nv_bfloat16>(q, pool_k, pool_v, table, start, out, R,
                                      H, Tq, Dh, bsz, nbps, q_tile, s);
  return (int)cudaErrorInvalidValue;
}

struct TrustAcc {
  float m, s, w, t1, t2;
};

__device__ __forceinline__ TrustAcc trust_empty() {
  return TrustAcc{NEG_INF, 0.f, 0.f, NEG_INF, NEG_INF};
}

__device__ __forceinline__ void trust_push(TrustAcc& a, float x) {
  if (x > a.m) {
    const float c = expf(a.m - x);
    a.s = a.s * c + 1.f;
    a.w = a.w * c + x;
    a.m = x;
  } else {
    const float e = expf(x - a.m);
    a.s += e;
    a.w += x * e;
  }
  if (x > a.t1) {
    a.t2 = a.t1;
    a.t1 = x;
  } else if (x > a.t2) {
    a.t2 = x;  // a duplicated maximum lands here: top2 == top1
  }
}

__device__ __forceinline__ TrustAcc trust_merge(const TrustAcc& a,
                                                const TrustAcc& b) {
  TrustAcc o;
  o.m = fmaxf(a.m, b.m);
  const float ca = expf(a.m - o.m);
  const float cb = expf(b.m - o.m);
  o.s = a.s * ca + b.s * cb;
  o.w = a.w * ca + b.w * cb;
  o.t1 = fmaxf(a.t1, b.t1);
  o.t2 = fmaxf(fminf(a.t1, b.t1), fmaxf(a.t2, b.t2));
  return o;
}

__device__ __forceinline__ TrustAcc trust_warp_merge(TrustAcc a) {
  for (int off = 16; off > 0; off >>= 1) {
    TrustAcc b;
    b.m = __shfl_xor_sync(0xffffffffu, a.m, off);
    b.s = __shfl_xor_sync(0xffffffffu, a.s, off);
    b.w = __shfl_xor_sync(0xffffffffu, a.w, off);
    b.t1 = __shfl_xor_sync(0xffffffffu, a.t1, off);
    b.t2 = __shfl_xor_sync(0xffffffffu, a.t2, off);
    a = trust_merge(a, b);
  }
  return a;
}

__global__ void __launch_bounds__(TRUST_THREADS)
    trust_stats_kernel(const float* __restrict__ logits,
                       float* __restrict__ entropy, float* __restrict__ margin,
                       int V) {
  __shared__ TrustAcc warp_acc[TRUST_THREADS / 32];
  const float* x = logits + (size_t)blockIdx.x * V;
  TrustAcc a = trust_empty();
  for (int i = threadIdx.x; i < V; i += blockDim.x) trust_push(a, x[i]);
  a = trust_warp_merge(a);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_acc[warp] = a;
  __syncthreads();
  if (warp == 0) {
    a = lane < (int)(blockDim.x >> 5) ? warp_acc[lane] : trust_empty();
    a = trust_warp_merge(a);
    if (lane == 0) {
      const float s = fmaxf(a.s, 1e-30f);
      // entropy = -sum p log p = logZ - sum p x, with p = e^{x-m} / s.
      entropy[blockIdx.x] = (a.m + logf(s)) - a.w / s;
      margin[blockIdx.x] = a.t1 - a.t2;
    }
  }
}

}  // namespace

extern "C" {

// B5: q [R, H, T, Dh] (T <= 8), one query tile per (row, head).
int tddl_paged_decode(const void* q, const void* pool_k, const void* pool_v,
                      const void* table, const void* start, void* out, int R,
                      int H, int T, int Dh, int bsz, int nbps, int dtype,
                      void* stream) {
  return dispatch_attn(dtype, q, pool_k, pool_v, table, start, out, R, H, T,
                       Dh, bsz, nbps, T, stream);
}

// B6: q [R, H, T, Dh] split into ceil(T / q_tile) query tiles per (row, head).
int tddl_paged_prefill(const void* q, const void* pool_k, const void* pool_v,
                       const void* table, const void* start, void* out, int R,
                       int H, int T, int Dh, int bsz, int nbps, int q_tile,
                       int dtype, void* stream) {
  return dispatch_attn(dtype, q, pool_k, pool_v, table, start, out, R, H, T,
                       Dh, bsz, nbps, q_tile, stream);
}

// B7: f32 logits [B, V] -> entropy [B], margin [B].
int tddl_trust_stats(const void* logits, void* entropy, void* margin, int B,
                     int V, void* stream) {
  if (B < 1 || V < 1) return (int)cudaErrorInvalidValue;
  trust_stats_kernel<<<B, TRUST_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<float*>(entropy),
      static_cast<float*>(margin), V);
  return (int)cudaGetLastError();
}

const char* tddl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
