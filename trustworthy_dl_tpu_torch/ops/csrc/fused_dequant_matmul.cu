// Weight-only int8 dequant matmul for Hopper (sm_90a): B4.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (trustworthy_dl_tpu_torch/ops/__init__.py).  The entry point
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError(), which the Python wrapper raises on.
//
// Replaces trustworthy_dl_tpu/ops/fused_dequant_matmul.py:_dq_matmul_kernel
// (pallas_call in _dq_matmul_pallas): out[M, N] = (x[M, K] @ w_q[K, N]) *
// scale[N], f32 accumulation, w_q int8 in its [K, N] layout with
// per-output-column f32 scales.
//
// What bounds it on this card: bytes.  On the serving path M is a decode
// batch or a draft step (<= 16 rows), a prefill chunk (64) or a local
// prefill (a few hundred rows); K and N are 768 to 3072 wide.  A launch
// reads 0.59-2.36 MB of int8 weight and does 2 M flops a weight byte,
// 16 at M = 8, far under the ~295 flop/byte ridge of the bf16 tensor
// cores: the weight has to stream at the card's memory rate, which takes
// many bytes in flight on every SM.  The design:
//   * split-K over a thread-block cluster: a cluster of S CTAs (S <= 8,
//     the portable maximum) per N tile and M tile, rank c walking a
//     contiguous span of K.  S is chosen per launch as the smallest power
//     of two that puts a CTA on every SM (GPT-2 small at M <= 64: 144-192
//     CTAs; mlp_proj's 24 N tiles x 8 at M <= 32);
//   * an asynchronous ring: 16-byte cp.async fills 4 stages of [128, TN]
//     int8 weight rows and the matching [8 NT, 128] bf16 x rows, three
//     stages in flight ahead of the one being multiplied (12 KB of weight
//     a CTA at M <= 32: a GPT-2 span of 384 rows is in flight whole from
//     the start), one barrier a stage;
//   * tensor cores on the swapped product out^T = w_q^T x^T with
//     mma.sync.m16n8k16 (bf16 in, f32 accumulate): the weight is the
//     16-row A operand (a warp's 32 N columns = two A tiles), x the 8-wide
//     B operand (M = 8 is one n8 tile, M = 64 eight from the same A
//     fragments).  At M <= 32 a CTA is one 32-column N tile (TN = 32), its
//     4 warps each a quarter of every stage's k16 blocks; past 32 rows
//     (NT = 8) two warps sit side by side along N (TN = 64: half the x
//     traffic a weight byte) and two along K.  An A fragment wants
//     (k, k + 1) pairs of one column, bytes a row apart in [K, N]: each
//     lane reads four 32-bit words (rows 2t, 2t + 1, 2t + 8, 2t + 9 of its
//     k16 block, columns 4g..4g+3 of its warp's 32) and the N order is
//     permuted so that those four columns are the lane's own rows of both
//     A tiles (column 4g + j is tile j / 2, row g + 8 (j % 2)); the
//     epilogue undoes it.  Nothing widened is written to shared or device
//     memory: each byte becomes an f32 in registers (byte ^ 0x80 into the
//     low bits of 2^23, minus 2^23 + 128, exact), two of them one bf16x2
//     word (the high halves: every int8 value is exact in bf16).  bf16 x
//     times an int8 value is exact in f32, so the result is the JAX
//     package's f32 product up to summation order;
//   * the partials meet in fixed order, so the result is the same bits
//     every call: the warps along K in shared memory, the first first;
//     then, between two cluster.sync()s, each rank folds its share of the
//     tile, four columns a thread, from every rank's partial through
//     distributed shared memory in rank order (every peer's float4 loaded
//     before any is added, so the trips overlap), multiplies by the column
//     scales and stores.  One launch, no workspace, no atomics.
// K and N are multiples of 16 (an N tile's last 16 columns and a span's
// last stage may be partial); M is any size >= 1, tiled by the grid.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using namespace mma_sm90;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int KC = 128;       // K rows a stage: 8 k16 blocks
constexpr int ST = 4;         // ring stages
constexpr int XP = KC + 8;    // bf16 row pitch of an x stage
constexpr int MAX_CLUSTER = 8;
// The split aims at this many CTAs an SM (a wave at 1).
constexpr int CTAS_PER_SM = 1;
constexpr int MAX_DEVICES = 64;

// An instance: NT n8 tiles of x rows (an M tile of 8 NT rows), WN warps
// side by side along N (each owns 32 columns: two m16 A tiles) and the
// other WARPS / WN warps along K (each multiplies every WK-th k16 block
// of a stage).
template <int NT, int WN>
struct Cfg {
  static constexpr int mt = 8 * NT;
  static constexpr int tn = 32 * WN;            // output columns a CTA
  static constexpr int wk = WARPS / WN;
  static constexpr int kb = KC / 16 / wk;       // k16 blocks a warp a stage
  // int8 row pitch of a weight stage: tn + 16 bytes, so that a warp's
  // row-2t word loads (rows 24t or 8t words apart mod 32, 8 columns
  // each) hit 32 distinct banks.
  static constexpr int wp = tn + 16;
  static constexpr int rp = tn + 4;             // f32 pitch of a partial
  static constexpr int w_bytes = KC * wp;
  static constexpr int x_bytes = mt * XP * 2;
  static constexpr int stage = w_bytes + x_bytes;
  static constexpr int smem = ST * stage;
  static constexpr int red_bytes = wk * mt * rp * 4;
  static_assert(WARPS % WN == 0 && KC % (16 * wk) == 0, "warp split");
  static_assert(red_bytes <= smem, "partials must fit in the ring");
  static_assert(w_bytes % 16 == 0 && stage % 16 == 0, "16-byte stages");
};

// Bytes J of u0 and u1 (rows k and k + 1 of one column, each byte already
// biased by 128) as the bf16x2 word (lo = row k, hi = row k + 1) of an A
// fragment.
template <int J>
__device__ __forceinline__ uint32_t pair(uint32_t u0, uint32_t u1) {
  constexpr uint32_t MAGIC = 0x4B000000u;   // 2^23
  constexpr uint32_t SEL = 0x7540u | J;     // byte J, then MAGIC's top byte
  const float f0 = __uint_as_float(__byte_perm(u0, MAGIC, SEL)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u1, MAGIC, SEL)) - 8388736.f;
  // Both are exact in bf16: the high halves of their f32 bits.
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

// The lane's A fragments of both A tiles from its four weight words (rows
// 2t, 2t + 1, 2t + 8, 2t + 9 of the k16 block, permuted columns 4g..4g+3).
__device__ __forceinline__ void widen(uint32_t lo0, uint32_t lo1, uint32_t hi0,
                                      uint32_t hi1, uint32_t (&a)[2][4]) {
  lo0 ^= 0x80808080u;   // int8 b -> unsigned b + 128
  lo1 ^= 0x80808080u;
  hi0 ^= 0x80808080u;
  hi1 ^= 0x80808080u;
  a[0][0] = pair<0>(lo0, lo1);
  a[0][1] = pair<1>(lo0, lo1);
  a[0][2] = pair<0>(hi0, hi1);
  a[0][3] = pair<1>(hi0, hi1);
  a[1][0] = pair<2>(lo0, lo1);
  a[1][1] = pair<3>(lo0, lo1);
  a[1][2] = pair<2>(hi0, hi1);
  a[1][3] = pair<3>(hi0, hi1);
}

// One CTA of the split: N tile blockIdx.y, M tile blockIdx.z, K span of
// cluster rank blockIdx.x (span rows, a multiple of 16).
template <int NT, int WN>
__global__ void __launch_bounds__(THREADS) dq_split_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ wq,
    const float* __restrict__ scale, float* __restrict__ out, int M, int K,
    int N, int span) {
  namespace cg = cooperative_groups;
  using C = Cfg<NT, WN>;
  constexpr int MT = C::mt;
  constexpr int TN = C::tn;
  constexpr int WP = C::wp;
  constexpr int RP = C::rp;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int S = (int)cluster.num_blocks();
  const int n0 = blockIdx.y * TN;
  const int m0 = blockIdx.z * MT;
  const int kbeg = min(rank * span, K);
  const int kend = min(kbeg + span, K);
  const int nst = (kend - kbeg + KC - 1) / KC;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wn = warp % WN;     // the warp's 32 columns
  const int wk = warp / WN;     // its k16 blocks: wk, wk + WK, ...
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  // Stage c of the span into ring slot s: weight rows [k0, k0 + KC) of
  // the tile's TN columns, x rows [m0, m0 + MT) of the same K rows; what
  // lies past the span, N or M is zeros.
  auto load = [&](int c, int s) {
    const int k0 = kbeg + c * KC;
    int8_t* ws = reinterpret_cast<int8_t*>(smem + s * C::stage);
    __nv_bfloat16* xs =
        reinterpret_cast<__nv_bfloat16*>(smem + s * C::stage + C::w_bytes);
    for (int i = tid; i < KC * (TN / 16); i += THREADS) {
      const int r = i / (TN / 16);
      const int col = (i % (TN / 16)) * 16;
      int8_t* dst = ws + r * WP + col;
      if (k0 + r < kend && n0 + col < N)
        cp_async16(dst, wq + (size_t)(k0 + r) * N + n0 + col);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    for (int i = tid; i < MT * (KC / 8); i += THREADS) {
      const int r = i / (KC / 8);
      const int col = (i % (KC / 8)) * 8;
      __nv_bfloat16* dst = xs + r * XP + col;
      if (m0 + r < M && k0 + col < kend)
        cp_async16(dst, x + (size_t)(m0 + r) * K + k0 + col);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nst) load(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < nst; ++c) {
    cp_async_wait<ST - 2>();
    __syncthreads();  // stage c landed; slot (c - 1) % ST is free
    if (c + ST - 1 < nst) load(c + ST - 1, (c + ST - 1) % ST);
    cp_async_commit();
    const int s = c % ST;
    const int8_t* ws = reinterpret_cast<const int8_t*>(smem + s * C::stage);
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(
        smem + s * C::stage + C::w_bytes);
    const int blocks = min(KC, kend - (kbeg + c * KC)) / 16;
#pragma unroll
    for (int i = 0; i < C::kb; ++i) {
      const int b = wk + C::wk * i;
      if (b < blocks) {
        const uint32_t* w = reinterpret_cast<const uint32_t*>(
                                ws + (b * 16 + 2 * t) * WP) + 8 * wn + g;
        uint32_t a[2][4];
        widen(w[0], w[WP / 4], w[8 * WP / 4], w[9 * WP / 4], a);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint32_t* xr = reinterpret_cast<const uint32_t*>(
              xs + (8 * j + g) * XP + b * 16 + 2 * t);
          const uint32_t b0 = xr[0];
          const uint32_t b1 = xr[4];
          mma_bf16(acc[0][j], a[0], b0, b1);
          mma_bf16(acc[1][j], a[1], b0, b1);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is drained: its bytes become the partials

  // Partials [WK][MT][RP] in tile order: C row g (+ 8) of A tile a is
  // tile column 32 wn + 4g + 2a (+ 1); C column 2t (+ 1) of n8 tile j is
  // x row 8j + 2t (+ 1).
  float* red = reinterpret_cast<float*>(smem);
  float* mine = red + wk * MT * RP;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int p = 32 * wn + 4 * g + 2 * a;
      const int m = 8 * j + 2 * t;
      mine[m * RP + p] = acc[a][j][0];
      mine[(m + 1) * RP + p] = acc[a][j][1];
      mine[m * RP + p + 1] = acc[a][j][2];
      mine[(m + 1) * RP + p + 1] = acc[a][j][3];
    }
  __syncthreads();
  // Four columns a thread at a time from here on (TN and RP are multiples
  // of 4, so a float4 never straddles a row).
  if (C::wk > 1) {
    for (int e = 4 * tid; e < MT * TN; e += 4 * THREADS) {
      float4* at = reinterpret_cast<float4*>(red + (e / TN) * RP + e % TN);
      float4 v = *at;
#pragma unroll
      for (int w = 1; w < C::wk; ++w) {
        const float4 u = at[w * MT * RP / 4];
        v.x += u.x;
        v.y += u.y;
        v.z += u.z;
        v.w += u.w;
      }
      *at = v;
    }
  }
  cluster.sync();  // every rank's partial is in its shared memory

  // Rank order, whichever rank folds: the same bits every call.  Every
  // rank's float4 is loaded before any is added, so the trips to the
  // peers' shared memory overlap.
  for (int e = 4 * (rank * THREADS + tid); e < MT * TN;
       e += 4 * S * THREADS) {
    const int m = e / TN;
    const int p = e % TN;
    if (m0 + m >= M || n0 + p >= N) continue;  // N % 16 == 0: all 4 or none
    float* at = red + m * RP + p;
    float4 part[MAX_CLUSTER];
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c)
      if (c < S)
        part[c] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(at, c));
    float4 v = part[0];
#pragma unroll
    for (int c = 1; c < MAX_CLUSTER; ++c)
      if (c < S) {
        v.x += part[c].x;
        v.y += part[c].y;
        v.z += part[c].z;
        v.w += part[c].w;
      }
    const float4 sc = *reinterpret_cast<const float4*>(scale + n0 + p);
    *reinterpret_cast<float4*>(out + (size_t)(m0 + m) * N + n0 + p) =
        make_float4(v.x * sc.x, v.y * sc.y, v.z * sc.z, v.w * sc.w);
  }
  cluster.sync();  // no CTA leaves while a peer may still read its partial
}

template <int NT, int WN>
int launch(const void* x, const void* wq, const void* scale, void* out,
           int M, int K, int N, cudaStream_t stream) {
  using C = Cfg<NT, WN>;
  const long long ntiles = (N + C::tn - 1) / C::tn;
  const long long mtiles = (M + C::mt - 1) / C::mt;
  if (ntiles > 65535 || mtiles > 65535) return (int)cudaErrorInvalidValue;
  // The instance's shared-memory opt-in and the card's SM count, once a
  // device (0 until then; a race sets the same values twice).
  static int sms_of[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (sms_of[dev] == 0) {
    int sms = 0;
    err = cudaFuncSetAttribute(dq_split_kernel<NT, WN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    sms_of[dev] = sms;
  }
  // The smallest split that gives every SM CTAS_PER_SM CTAs, each rank at
  // least one k16 block.
  const int blocks = K / 16;
  int S = 1;
  while (S < MAX_CLUSTER && ntiles * mtiles * S < CTAS_PER_SM * sms_of[dev] &&
         2 * S <= blocks)
    S *= 2;
  const int span = (blocks + S - 1) / S * 16;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)S, (unsigned)ntiles, (unsigned)mtiles);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = C::smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, dq_split_kernel<NT, WN>,
                           static_cast<const __nv_bfloat16*>(x),
                           static_cast<const int8_t*>(wq),
                           static_cast<const float*>(scale),
                           static_cast<float*>(out), M, K, N, span);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// B4: x bf16 [M, K], w_q int8 [K, N], scale f32 [N] -> out f32 [M, N];
// M >= 1, K % 16 == 0, N % 16 == 0; x, w_q, scale and out 16-byte
// aligned.
int tddl_dequant_matmul(const void* x, const void* wq, const void* scale,
                        void* out, int M, int K, int N, void* stream) {
  if (M < 1 || K < 16 || N < 16 || K % 16 || N % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Instances by M: <n8 tiles, warps along N>.
  if (M <= 8) return launch<1, 1>(x, wq, scale, out, M, K, N, s);
  if (M <= 16) return launch<2, 1>(x, wq, scale, out, M, K, N, s);
  if (M <= 32) return launch<4, 1>(x, wq, scale, out, M, K, N, s);
  return launch<8, 2>(x, wq, scale, out, M, K, N, s);
}

const char* tddl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
