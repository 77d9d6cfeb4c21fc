// Flash-attention forward: online softmax over K/V tiles, with the
// log-sum-exp of every query row for the backward.
//
// Replaces repro/kernels/flash_attention/kernel.py::_flash_kernel (called
// by flash_attention_kernel at :94).  It computes what that kernel
// computes, step by step:
//   s = (q . k) * scale in f32 straight from the operands; softcap as
//   tanh(s / cap) * cap; masked scores set to -1e30 (causal: q_pos >=
//   k_pos; window: q_pos - k_pos < window); m_new = max(m, rowmax(s));
//   alpha = exp(m - m_new); p = exp(s - m_new), zeroed where masked;
//   l = l * alpha + rowsum(p) with p in f32; acc = acc * alpha +
//   round_to_v_dtype(p) . v; at the end o = acc / max(l, 1e-30) and
//   lse = m + log(max(l, 1e-30)).  GQA: query head h reads KV head
//   h / (H / KV); hd_v may differ from hd.
//
// On the TPU the grid walks the K blocks of one q block in order and
// carries (acc, m, l) in VMEM scratch.  Here one CTA owns one (batch, head,
// q block of 64 or 128 rows) and walks its K/V tiles in a loop, with (acc,
// m, l) in registers.  Causal q blocks are issued heaviest first.
//
// A K tile that the causal or window mask hides entirely from every row
// of the block is skipped.  That is exact: in such a tile every score is
// -1e30, so m_new = m, alpha = exp(0) = 1 and every p is zeroed, which
// leaves m, l and acc bit for bit as they were.
//
// Three kernels, one route each, picked from (dtype, hd, hd_v) alone
// (ops.flash_route; flash_attention_fwd_launch takes the route and checks
// it).  The two tensor-core kernels are templates over the 16-bit operand
// type T, bf16 or f16: this file builds as two libraries, one a type
// (kernels/_build.py VARIANTS: bf16 by default, f16 where H2PIPE_HALF is
// defined, each its own nvcc, started together), so each type's instances
// build beside the other's.  The f16 instances round p to f16 where the
// bf16 ones round it to bf16, as the reference rounds p to v's dtype; f16
// keeps 11 significant bits where bf16 keeps 8, over a narrower range
// (p and o stay inside it: p <= 1, o is a convex combination of v).
//   flash_fwd_wgmma<T, HD>  hd = hd_v in {64, 128} (Phi-4-mini's
//     128; 64 in the ATTN_CASES).  One CTA owns a 128-row q block: a
//     producer warp loads Q once and the K/V tiles of 64 keys through a
//     ring of two stages by TMA (cp.async.bulk.tensor, 128-byte swizzle,
//     rows past S zero-filled), each stage with a full mbarrier counting
//     the transaction bytes and an empty one that both consumer
//     warpgroups release; each of the two warpgroups owns 64 rows and
//     runs S = QK^T as wgmma m64n64k16 with Q and K from shared memory
//     (K-major), the softmax steps above in registers, and O += T(P) V
//     as wgmma with P from registers (the S accumulator is laid out as the
//     A fragment) and V read MN-major through the transpose bit.  Its
//     exponentials are exp2f with the scores' factor (scale * log2(e), or
//     log2(e) after the softcap) folded into one FFMA a score, m kept in
//     base-2 units and turned back for the lse: the same steps as above
//     up to f32 rounding, within every limit the checks hold it to
//     (PERF.md).  The tensor maps carry the operands' strides, so the
//     model layout goes in without a copy; the wrapper refuses a base or
//     stride TMA cannot take (not 16-byte aligned).
//   flash_fwd_16<T, HD, HDV>  the other 16-bit pairs (the first port's).  Four
//     warps, 16 query rows each.  The Q tile (64 rows) stays in shared
//     memory; K/V tiles of 64 keys pass through a ring of two shared-memory
//     buffers filled with cp.async, so tile kt+1 is in flight while tile
//     kt is consumed.  Rows are padded by 8 elements so that ldmatrix hits
//     distinct banks.  QK^T and PV run on the tensor cores as mma.sync
//     m16n8k16 (T in, f32 accumulate), their operands loaded with
//     ldmatrix (.trans for V).  p goes from registers to the tensor cores
//     rounded to T, without shared memory.  Head dims: any multiple of
//     8 from 8 to 256 (hd and hd_v each), run at the narrowest width the
//     kernel is built at that holds it (width(): hd 32, 64, 128, 192, 256;
//     hd_v 32, 64, 128, 256).  The copies zero-fill the columns past hd in
//     Q and K and past hd_v in V (their products add 0) and read nothing
//     past a row's hd or hd_v; only hd_v columns of o are written; the
//     scale is the true 1/sqrt(hd), which the wrapper passes.
//   flash_fwd_f32  f32 operands, for tight tests: the same tiles and
//     steps on the CUDA cores with fmaf, scores and acc in shared memory,
//     at the true head dims (built into the bf16 library only).
// In both 16-bit kernels the softcap and the mask run as separate loops
// behind branches that are uniform over the warpgroup or CTA, and only
// the tiles on the causal diagonal or the window's edge evaluate the mask.
//
// What bounds it on an H100: at the Phi-4-mini prefill shape (B=4, H=24,
// KV=8, S=512, hd=128, causal) the call moves 33.7 MB (q, k, v, o, lse
// once) against 6.4 GFLOP, so bytes bound it (about 10 us at 3.35 TB/s;
// the FLOPs alone take 6.5 us at 989 TFLOP/s).  At S = 2048 the FLOPs
// bound it (103 GFLOP, 104 us).  The mma.sync kernel was held back by
// the per-element work between the two products on the same warps; the
// wgmma route issues each product as a few asynchronous warpgroup
// instructions and keeps two warpgroups per SM at work on 128 rows of one
// K/V tile.  PERF.md has its times against the bound and the library's
// attention.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "wgmma.cuh"  // mbarriers, TMA and wgmma

namespace {

using namespace h2pipe_mma;
using namespace h2pipe_wgmma;

// The 16-bit operand type of this library, its element code in
// flash_attention_fwd_launch (ops._DTYPES) and its TMA data type (the
// operand types of its wgmma instructions: WG_AB, wgmma.cuh).
#ifdef H2PIPE_HALF
using T16 = f16;
constexpr int ELEM16 = 2;
constexpr CUtensorMapDataType TMA_T16 = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
#else
using T16 = bf16;
constexpr int ELEM16 = 0;
constexpr CUtensorMapDataType TMA_T16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
#endif

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int BQ = 64;     // query rows per CTA
constexpr int BK = 64;     // keys per K/V tile, 16-bit kernel
constexpr int NT = 128;    // threads, 16-bit kernel: 4 warps x 16 rows
constexpr int BK32 = 32;   // keys per K/V tile, f32 kernel
constexpr int NT32 = 256;  // threads, f32 kernel

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, H, Sq], contiguous
  // element strides over (batch, head, seq); the head dim is contiguous
  long long qs_b, qs_h, qs_s, ks_b, ks_h, ks_s, vs_b, vs_h, vs_s;
  long long os_b, os_h, os_s;
  int B, H, KV, Sq, Sk, hd, hdv, causal, window;
  float softcap, scale;
};

__device__ __forceinline__ bool visible(const FlashArgs& a, int row,
                                        int col) {
  return col < a.Sk && (!a.causal || row >= col) &&
         (a.window == 0 || row - col < a.window);
}

__device__ __forceinline__ float score(const FlashArgs& a, float dot) {
  float s = dot * a.scale;
  if (a.softcap != 0.0f) s = tanhf(s / a.softcap) * a.softcap;
  return s;
}

// The K tiles of `bk` keys that some row of the q block [q0, q0 + bq)
// can see; the others are skipped (exact, see the header).
__device__ __forceinline__ void k_tiles(const FlashArgs& a, int q0, int bq,
                                        int bk, int* lo, int* hi) {
  int nkb = (a.Sk + bk - 1) / bk;
  int q_last = min(q0 + bq, a.Sq) - 1;
  *hi = a.causal ? min(nkb - 1, q_last / bk) : nkb - 1;
  *lo = a.window > 0 ? max(0, q0 - a.window + 1) / bk : 0;
}

// ---------------------------------------------------------------------------
// 16-bit operands: tensor cores through mma.sync
// ---------------------------------------------------------------------------

// pack2, cp.async, ldmatrix, mma16 and load_tile: mma_bf16.cuh

template <int HD, int HDV>
size_t smem_16() {
  return ((size_t)BQ * (HD + 8) +
          2 * ((size_t)BK * (HD + 8) + (size_t)BK * (HDV + 8))) *
         sizeof(T16);
}

template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(NT) flash_fwd_16(FlashArgs a) {
  constexpr int LQ = HD + 8, LV = HDV + 8;  // padded row strides
  extern __shared__ __align__(16) unsigned char smem_16_raw[];
  T* Qs = reinterpret_cast<T*>(smem_16_raw);  // [BQ][LQ]
  T* Ks = Qs + BQ * LQ;                            // 2 x [BK][LQ]
  T* Vs = Ks + 2 * BK * LQ;                        // 2 x [BK][LV]

  const int nqb = (a.Sq + BQ - 1) / BQ;
  const int q0 = (nqb - 1 - (int)blockIdx.x) * BQ;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const T* q = static_cast<const T*>(a.q) + b * a.qs_b + h * a.qs_h;
  const T* k = static_cast<const T*>(a.k) + b * a.ks_b + kvh * a.ks_h;
  const T* v = static_cast<const T*>(a.v) + b * a.vs_b + kvh * a.vs_h;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // fragment row / column pair
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  // ldmatrix row addresses: A (Q) and V^T fragments take matrices in the
  // order (rows 0-7, 8-15) x (cols 0-7, 8-15); K takes (keys j, j+1) x
  // (dims 0-7, 8-15)
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = (lane >> 4) * 8;
  const int kr = (lane & 7) + (lane >> 4) * 8, kc = ((lane >> 3) & 1) * 8;

  float o[HDV / 8][4];
#pragma unroll
  for (int n = 0; n < HDV / 8; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f;

  int lo, hi;
  k_tiles(a, q0, BQ, BK, &lo, &hi);
  // the K/V tiles go through a ring of two buffers: tile kt+1 is copied
  // (cp.async) while tile kt is consumed
  load_tile<HD, NT>(Qs, LQ, q, a.qs_s, q0, a.Sq, BQ, a.hd);
  if (lo <= hi) {
    load_tile<HD, NT>(Ks, LQ, k, a.ks_s, lo * BK, a.Sk, BK, a.hd);
    load_tile<HDV, NT>(Vs, LV, v, a.vs_s, lo * BK, a.Sk, BK, a.hdv);
  }
  cp_async_commit();
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * BK, buf = (kt - lo) & 1;
    if (kt < hi) {
      load_tile<HD, NT>(Ks + (buf ^ 1) * BK * LQ, LQ, k, a.ks_s, k0 + BK,
                        a.Sk, BK, a.hd);
      load_tile<HDV, NT>(Vs + (buf ^ 1) * BK * LV, LV, v, a.vs_s, k0 + BK,
                         a.Sk, BK, a.hdv);
    }
    cp_async_commit();
    cp_async_wait1();  // Q and tile kt have landed
    __syncthreads();
    const T* Kb = Ks + buf * BK * LQ;
    const T* Vb = Vs + buf * BK * LV;

    // s = q . k^T for this warp's 16 rows x 64 keys (8 n-tiles of 8)
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t af[4];
      ldsm_x4(af, Qs + (warp * 16 + lr) * LQ + kk * 16 + lc);
#pragma unroll
      for (int j = 0; j < BK / 8; j += 2) {
        uint32_t bf[4];
        ldsm_x4(bf, Kb + (j * 8 + kr) * LQ + kk * 16 + kc);
        mma16<T>(s[j], af, bf[0], bf[1]);
        mma16<T>(s[j + 1], af, bf[2], bf[3]);
      }
    }

    // scale, softcap, mask; row maxima over the quad that shares a row.
    // Each step is one loop behind a branch that is uniform over the CTA,
    // so no element pays for the softcap or the mask it does not need; a
    // tile that every row sees whole takes no mask.
    const bool whole = k0 + BK <= a.Sk &&
                       (!a.causal || k0 + BK - 1 <= q0) &&
                       (a.window == 0 || q0 + BQ - 1 - k0 < a.window);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= a.scale;
    if (a.softcap != 0.0f) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = tanhf(s[j][e] / a.softcap) * a.softcap;
    }
    if (!whole) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(a, e < 2 ? row0 : row1, k0 + j * 8 + 2 * t + (e & 1)))
            s[j][e] = NEG_INF;
    }
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = expf(s[j][0] - mn0);
      s[j][1] = expf(s[j][1] - mn0);
      s[j][2] = expf(s[j][2] - mn1);
      s[j][3] = expf(s[j][3] - mn1);
    }
    if (!whole) {  // masked p is zero, also where the whole row is masked
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(a, e < 2 ? row0 : row1, k0 + j * 8 + 2 * t + (e & 1)))
            s[j][e] = 0.0f;
    }
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, w);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, w);
    }
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
#pragma unroll
    for (int n = 0; n < HDV / 8; ++n) {
      o[n][0] *= al0; o[n][1] *= al0;
      o[n][2] *= al1; o[n][3] *= al1;
    }

    // acc += T(p) . v: n-tiles 2kk and 2kk+1 of s are the A fragment
    // of keys 16kk .. 16kk+15
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pf[4] = {pack2<T>(s[2 * kk][0], s[2 * kk][1]),
                              pack2<T>(s[2 * kk][2], s[2 * kk][3]),
                              pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < HDV / 8; n += 2) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, Vb + (kk * 16 + lr) * LV + n * 8 + lc);
        mma16<T>(o[n], pf, vf[0], vf[1]);
        mma16<T>(o[n + 1], pf, vf[2], vf[3]);
      }
    }
    m0 = mn0;
    m1 = mn1;
    __syncthreads();  // every warp is done with buffer `buf`
  }

  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  T* out = static_cast<T*>(a.o) + b * a.os_b + h * a.os_h;
#pragma unroll
  for (int n = 0; n < HDV / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (n * 8 >= a.hdv) break;  // the padding columns are not written
    if (row0 < a.Sq)
      *reinterpret_cast<uint32_t*>(out + row0 * a.os_s + col) =
          pack2<T>(o[n][0] / d0, o[n][1] / d0);
    if (row1 < a.Sq)
      *reinterpret_cast<uint32_t*>(out + row1 * a.os_s + col) =
          pack2<T>(o[n][2] / d1, o[n][3] / d1);
  }
  if (t == 0) {
    float* L = a.lse + ((long long)b * a.H + h) * a.Sq;
    if (row0 < a.Sq) L[row0] = m0 + logf(d0);
    if (row1 < a.Sq) L[row1] = m1 + logf(d1);
  }
}

// ---------------------------------------------------------------------------
// 16-bit, hd = hd_v in {64, 128}: wgmma fed by TMA
// ---------------------------------------------------------------------------

constexpr int WQ = 128;         // query rows per CTA: two warpgroups of 64
constexpr int WK = 64;          // keys per K/V tile
constexpr int WSTAGES = 2;      // K/V tiles in flight
constexpr int WCONSUMERS = 256; // the two consumer warpgroups
constexpr int WTHREADS = WCONSUMERS + 32;  // and one producer warp
constexpr int SWZ_ROW = 128;    // bytes of one swizzled row: 64 T

// Shared memory of one CTA: Q as HD/64 panels of [WQ rows][128 B], then
// WSTAGES stages of K and V, each HD/64 panels of [WK rows][128 B].  Every
// panel starts on a 1024-byte boundary, where the 128-byte swizzle repeats.
template <int HD>
struct WgLayout {
  static constexpr int PANELS = HD / 64;
  static constexpr int Q_PANEL = WQ * SWZ_ROW;
  static constexpr int KV_PANEL = WK * SWZ_ROW;
  static constexpr int Q_BYTES = PANELS * Q_PANEL;
  static constexpr int K_BYTES = PANELS * KV_PANEL;
  static constexpr int STAGE = 2 * K_BYTES;  // K, then V (hd_v = hd)
  static constexpr int SMEM = Q_BYTES + WSTAGES * STAGE + 1024;  // + align
};


// One CTA owns one (batch, head, 128-row q block).  Warp 8's lane 0 is
// the producer: it loads the Q block once and keeps the K/V tiles of the
// block's visible range in flight through a WSTAGES-deep ring, each stage
// with a full mbarrier (the TMA's transaction bytes) and an empty one (an
// arrive from each of the 256 consumer threads): a stage is refilled only
// after both warpgroups have released it.  Warpgroup w (warps 4w..4w+3)
// owns rows q0 + 64w .. +63 and computes, per tile, S = Q K^T with wgmma
// from shared memory (both K-major), the softmax steps of the header in
// registers (the S accumulator's layout is the mma.sync layout per warp,
// so the row maxima and sums are quad shuffles as in flash_fwd_16), and
// O += T(P) V with P from registers and V read MN-major through the
// transpose bit.  A tile no row of the warpgroup sees is released
// unread (exact, see the header).
template <typename T, int HD>
__global__ void __launch_bounds__(WTHREADS, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, FlashArgs a) {
  using L = WgLayout<HD>;
  extern __shared__ unsigned char wg_smem[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * WSTAGES];
  const uint32_t qs = (smem_addr(wg_smem) + 1023u) & ~1023u;
  const uint32_t kvs = qs + L::Q_BYTES;
  const uint32_t qbar = smem_addr(bars);
  const uint32_t full = qbar + 8, empty = qbar + 8 * (1 + WSTAGES);

  const int nqb = (a.Sq + WQ - 1) / WQ;
  const int q0 = (nqb - 1 - (int)blockIdx.x) * WQ;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  int lo, hi;
  k_tiles(a, q0, WQ, WK, &lo, &hi);

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < WSTAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, WCONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == WCONSUMERS / 32) {  // the producer
    if (lane == 0) {
      mbar_expect_tx(qbar, L::Q_BYTES);
      for (int p = 0; p < L::PANELS; ++p)
        tma_load(qs + p * L::Q_PANEL, &qmap, qbar, 64 * p, q0, h, b);
      for (int kt = lo, i = 0; kt <= hi; ++kt, ++i) {
        const int s = i % WSTAGES;
        mbar_wait(empty + 8 * s, ((i / WSTAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, L::STAGE);
        const uint32_t st = kvs + s * L::STAGE;
        for (int p = 0; p < L::PANELS; ++p) {
          tma_load(st + p * L::KV_PANEL, &kmap, full + 8 * s, 64 * p,
                   kt * WK, kvh, b);
          tma_load(st + L::K_BYTES + p * L::KV_PANEL, &vmap, full + 8 * s,
                   64 * p, kt * WK, kvh, b);
        }
      }
    }
    return;
  }

  const int wg = warp / 4, g = lane >> 2, t = lane & 3;
  const int qw = q0 + 64 * wg;  // this warpgroup's first row
  const int row0 = qw + (warp % 4) * 16 + g, row1 = row0 + 8;
  int lo_w, hi_w;
  k_tiles(a, qw, 64, WK, &lo_w, &hi_w);

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f;

  mbar_wait(qbar, 0);
  for (int kt = lo, i = 0; kt <= hi; ++kt, ++i) {
    const int s = i % WSTAGES;
    mbar_wait(full + 8 * s, (i / WSTAGES) & 1);
    if (kt < lo_w || kt > hi_w) {  // hidden from every row of this group
      mbar_arrive(empty + 8 * s);
      continue;
    }
    const int k0 = kt * WK;
    const uint32_t st = kvs + s * L::STAGE;

    // s = q . k^T: this warpgroup's 64 rows x WK keys
    float sc[WK / 8][4];
#pragma unroll
    for (int j = 0; j < WK / 8; ++j)
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 16 columns within the row
      wgmma_ss(sc,
               sw128_desc(qs + (kk / 4) * L::Q_PANEL + wg * 64 * SWZ_ROW + off,
                          16, 1024),
               sw128_desc(st + (kk / 4) * L::KV_PANEL + off, 16, 1024));
    }
    wgmma_commit_wait();
    fence_acc(sc);

    // softcap and mask as flash_fwd_16 does; the exponentials in base 2,
    // with the scores' factor (scale * log2(e), or log2(e) after the
    // softcap) folded into one FFMA a score: p = 2^(t * c2 - m), m in
    // base-2 units
    const bool whole = k0 + WK <= a.Sk &&
                       (!a.causal || k0 + WK - 1 <= qw) &&
                       (a.window == 0 || qw + 63 - k0 < a.window);
    float c2 = a.scale * LOG2E;
    if (a.softcap != 0.0f) {
#pragma unroll
      for (int j = 0; j < WK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[j][e] = tanhf(sc[j][e] * a.scale / a.softcap) * a.softcap;
      c2 = LOG2E;
    }
    if (!whole) {
#pragma unroll
      for (int j = 0; j < WK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(a, e < 2 ? row0 : row1, k0 + j * 8 + 2 * t + (e & 1)))
            sc[j][e] = NEG_INF;
    }
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < WK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
    }
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
    }
    // a row the whole tile hides keeps the -1e30 of the reference
    const float mn0 = fmaxf(m0, mx0 == NEG_INF ? NEG_INF : mx0 * c2);
    const float mn1 = fmaxf(m1, mx1 == NEG_INF ? NEG_INF : mx1 * c2);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
#pragma unroll
    for (int j = 0; j < WK / 8; ++j) {
      sc[j][0] = exp2f(fmaf(sc[j][0], c2, -mn0));
      sc[j][1] = exp2f(fmaf(sc[j][1], c2, -mn0));
      sc[j][2] = exp2f(fmaf(sc[j][2], c2, -mn1));
      sc[j][3] = exp2f(fmaf(sc[j][3], c2, -mn1));
    }
    if (!whole) {  // masked p is zero, also where the whole row is masked
#pragma unroll
      for (int j = 0; j < WK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(a, e < 2 ? row0 : row1, k0 + j * 8 + 2 * t + (e & 1)))
            sc[j][e] = 0.0f;
    }
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < WK / 8; ++j) {
      sum0 += sc[j][0] + sc[j][1];
      sum1 += sc[j][2] + sc[j][3];
    }
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, w);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, w);
    }
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= al0; o[n][1] *= al0;
      o[n][2] *= al1; o[n][3] *= al1;
    }

    // acc += T(p) . v: n-tiles 2kk and 2kk+1 of s are the A fragment of
    // keys 16kk .. 16kk+15; V's rows 16kk.. start 16 * 128 B apart, its
    // 64-column panels L::KV_PANEL apart
    fence_acc(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk) {
      const uint32_t pf[4] = {pack2<T>(sc[2 * kk][0], sc[2 * kk][1]),
                              pack2<T>(sc[2 * kk][2], sc[2 * kk][3]),
                              pack2<T>(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack2<T>(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
      wgmma_rs(o, pf,
               sw128_desc(st + L::K_BYTES + kk * 16 * SWZ_ROW, L::KV_PANEL,
                          1024));
    }
    wgmma_commit_wait();
    fence_acc(o);
    mbar_arrive(empty + 8 * s);  // this thread is done with stage s
    m0 = mn0;
    m1 = mn1;
  }

  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  T* out = static_cast<T*>(a.o) + b * a.os_b + h * a.os_h;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (row0 < a.Sq)
      *reinterpret_cast<uint32_t*>(out + row0 * a.os_s + col) =
          pack2<T>(o[n][0] / d0, o[n][1] / d0);
    if (row1 < a.Sq)
      *reinterpret_cast<uint32_t*>(out + row1 * a.os_s + col) =
          pack2<T>(o[n][2] / d1, o[n][3] / d1);
  }
  if (t == 0) {  // lse = m + log(l), m back in natural units
    float* L_ = a.lse + ((long long)b * a.H + h) * a.Sq;
    if (row0 < a.Sq) L_[row0] = (m0 == NEG_INF ? NEG_INF : m0 * LN2) +
                                logf(d0);
    if (row1 < a.Sq) L_[row1] = (m1 == NEG_INF ? NEG_INF : m1 * LN2) +
                                logf(d1);
  }
}

#ifndef H2PIPE_HALF  // f32 operands: in the bf16 library only
// ---------------------------------------------------------------------------
// f32: the same steps on the CUDA cores
// ---------------------------------------------------------------------------

size_t smem_f32(int hd, int hdv) {
  return ((size_t)BQ * hd + (size_t)BK32 * (hd + 1) + (size_t)BK32 * hdv +
          (size_t)BQ * (BK32 + 1) + (size_t)BQ * hdv + 3 * BQ) *
         sizeof(float);
}

__global__ void __launch_bounds__(NT32) flash_fwd_f32(FlashArgs a) {
  extern __shared__ float smem_f32_raw[];
  const int HD = a.hd, HDV = a.hdv, LK = HD + 1, LS = BK32 + 1;
  float* Qs = smem_f32_raw;          // [BQ][HD]
  float* Ks = Qs + BQ * HD;          // [BK32][HD + 1]
  float* Vs = Ks + BK32 * LK;        // [BK32][HDV]
  float* Ss = Vs + BK32 * HDV;       // [BQ][BK32 + 1]: s, then p
  float* acc = Ss + BQ * LS;         // [BQ][HDV]
  float* m = acc + BQ * HDV;         // [BQ]
  float* l = m + BQ;                 // [BQ]
  float* alpha = l + BQ;             // [BQ]
  const int tid = threadIdx.x;

  const int nqb = (a.Sq + BQ - 1) / BQ;
  const int q0 = (nqb - 1 - (int)blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const float* q = static_cast<const float*>(a.q) + b * a.qs_b + h * a.qs_h;
  const float* k = static_cast<const float*>(a.k) + b * a.ks_b + kvh * a.ks_h;
  const float* v = static_cast<const float*>(a.v) + b * a.vs_b + kvh * a.vs_h;

  for (int idx = tid; idx < BQ * HD; idx += NT32) {
    int r = idx / HD, c = idx % HD;
    Qs[idx] = q0 + r < a.Sq ? q[(q0 + r) * a.qs_s + c] : 0.0f;
  }
  for (int idx = tid; idx < BQ * HDV; idx += NT32) acc[idx] = 0.0f;
  if (tid < BQ) {
    m[tid] = NEG_INF;
    l[tid] = 0.0f;
  }

  int lo, hi;
  k_tiles(a, q0, BQ, BK32, &lo, &hi);
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * BK32;
    __syncthreads();
    for (int idx = tid; idx < BK32 * HD; idx += NT32) {
      int r = idx / HD, c = idx % HD;
      Ks[r * LK + c] = k0 + r < a.Sk ? k[(k0 + r) * a.ks_s + c] : 0.0f;
    }
    for (int idx = tid; idx < BK32 * HDV; idx += NT32) {
      int r = idx / HDV, c = idx % HDV;
      Vs[idx] = k0 + r < a.Sk ? v[(k0 + r) * a.vs_s + c] : 0.0f;
    }
    __syncthreads();
    {  // scores: a warp takes one row, its lanes the 32 keys
      const int c = tid % BK32;
      for (int r = tid / BK32; r < BQ; r += NT32 / BK32) {
        const float* qr = Qs + r * HD;
        const float* kr = Ks + c * LK;
        float d = 0.0f;
        for (int x = 0; x < HD; ++x) d = fmaf(qr[x], kr[x], d);
        Ss[r * LS + c] =
            visible(a, q0 + r, k0 + c) ? score(a, d) : NEG_INF;
      }
    }
    __syncthreads();
    if (tid < BQ) {  // online softmax, one thread per row
      const int row = q0 + tid;
      float* sr = Ss + tid * LS;
      float mx = NEG_INF;
      for (int c = 0; c < BK32; ++c) mx = fmaxf(mx, sr[c]);
      const float mn = fmaxf(m[tid], mx);
      const float al = expf(m[tid] - mn);
      float sum = 0.0f;
      for (int c = 0; c < BK32; ++c) {
        const float p = visible(a, row, k0 + c) ? expf(sr[c] - mn) : 0.0f;
        sr[c] = p;
        sum += p;
      }
      l[tid] = l[tid] * al + sum;
      m[tid] = mn;
      alpha[tid] = al;
    }
    __syncthreads();
    for (int idx = tid; idx < BQ * HDV; idx += NT32) {
      const int r = idx / HDV, c = idx % HDV;
      const float* pr = Ss + r * LS;
      float d = 0.0f;
      for (int x = 0; x < BK32; ++x) d = fmaf(pr[x], Vs[x * HDV + c], d);
      acc[idx] = acc[idx] * alpha[r] + d;
    }
  }
  __syncthreads();
  float* out = static_cast<float*>(a.o) + b * a.os_b + h * a.os_h;
  for (int idx = tid; idx < BQ * HDV; idx += NT32) {
    const int r = idx / HDV, c = idx % HDV;
    if (q0 + r < a.Sq)
      out[(q0 + r) * a.os_s + c] = acc[idx] / fmaxf(l[r], 1e-30f);
  }
  if (tid < BQ && q0 + tid < a.Sq)
    a.lse[((long long)b * a.H + h) * a.Sq + q0 + tid] =
        m[tid] + logf(fmaxf(l[tid], 1e-30f));
}

#endif

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int HD, int HDV>
cudaError_t launch_16(const FlashArgs& a, dim3 grid, cudaStream_t stream) {
  const size_t smem = smem_16<HD, HDV>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_16<T16, HD, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  flash_fwd_16<T16, HD, HDV><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_wgmma(const FlashArgs& a, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  cudaError_t err = tensor_map(&qm, TMA_T16, a.q, a.B, a.H, a.Sq, HD, a.qs_b,
                               a.qs_h, a.qs_s, WQ);
  if (err == cudaSuccess)
    err = tensor_map(&km, TMA_T16, a.k, a.B, a.KV, a.Sk, HD, a.ks_b, a.ks_h,
                     a.ks_s, WK);
  if (err == cudaSuccess)
    err = tensor_map(&vm, TMA_T16, a.v, a.B, a.KV, a.Sk, HD, a.vs_b, a.vs_h,
                     a.vs_s, WK);
  if (err != cudaSuccess) return err;
  const int smem = WgLayout<HD>::SMEM;
  err = cudaFuncSetAttribute(flash_fwd_wgmma<T16, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sq + WQ - 1) / WQ, a.H, a.B);
  flash_fwd_wgmma<T16, HD><<<grid, WTHREADS, smem, stream>>>(qm, km, vm, a);
  return cudaGetLastError();
}

// flash_fwd_16<T16, HD, HDV> at the widths of width() (mma_bf16.cuh)
template <int HD>
cudaError_t launch_16_hdv(const FlashArgs& a, dim3 grid,
                            cudaStream_t stream) {
  switch (width(a.hdv, WIDTHS_HDV)) {
    case 32: return launch_16<HD, 32>(a, grid, stream);
    case 64: return launch_16<HD, 64>(a, grid, stream);
    case 128: return launch_16<HD, 128>(a, grid, stream);
    case 256: return launch_16<HD, 256>(a, grid, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [B,H,Sq,hd], k [B,KV,Sk,hd], v [B,KV,Sk,hd_v], o [B,H,Sq,hd_v] given
// by their element strides over (batch, head, seq) in `strides` (q, k, v,
// o in turn; the last dim contiguous); lse [B,H,Sq] f32, contiguous.
// hd and hd_v: multiples of 8 from 8 to 256.  elem: the operands' type,
// 0 bf16, 1 f32, 2 f16 (ops._DTYPES), which must be this library's
// (ELEM16; f32 in the bf16 library).  route 0: the 16-bit operands on
// mma.sync, at the widths of width(); 1: f32; 2: the 16-bit operands on
// wgmma and TMA, for hd = hd_v in {64, 128} only, which route 0 refuses
// (ops.flash_route picks it from (dtype, hd, hd_v)).  Returns a
// cudaError_t.
int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               void* o, float* lse, int route, int elem,
                               int B, int H, int KV, int Sq, int Sk, int hd,
                               int hd_v, const long long* strides,
                               int causal, int window, float softcap,
                               float scale, cudaStream_t stream) {
  if (KV < 1 || H % KV != 0 || window < 0 || !head_dim_ok(hd) ||
      !head_dim_ok(hd_v) || (route == 1) != (elem == 1) ||
      (elem != 1 && elem != ELEM16))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || Sq == 0) return (int)cudaSuccess;
  FlashArgs a{q, k, v, o, lse,
              strides[0], strides[1], strides[2], strides[3], strides[4],
              strides[5], strides[6], strides[7], strides[8], strides[9],
              strides[10], strides[11],
              B, H, KV, Sq, Sk, hd, hd_v, causal, window, softcap, scale};
  if (route == 2) {
    if (hd != hd_v) return (int)cudaErrorInvalidValue;
    if (hd == 64) return (int)launch_wgmma<64>(a, stream);
    if (hd == 128) return (int)launch_wgmma<128>(a, stream);
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  if (route == 1) {
#ifdef H2PIPE_HALF
    return (int)cudaErrorInvalidValue;  // f32: the bf16 library's
#else
    const size_t smem = smem_f32(hd, hd_v);
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_f32<<<grid, NT32, smem, stream>>>(a);
    return (int)cudaGetLastError();
#endif
  }
  if (route != 0 || (hd == hd_v && (hd == 64 || hd == 128)))
    return (int)cudaErrorInvalidValue;
  switch (width(hd, WIDTHS_HD)) {
    case 32: return (int)launch_16_hdv<32>(a, grid, stream);
    case 64: return (int)launch_16_hdv<64>(a, grid, stream);
    case 128: return (int)launch_16_hdv<128>(a, grid, stream);
    case 192: return (int)launch_16_hdv<192>(a, grid, stream);
    case 256: return (int)launch_16_hdv<256>(a, grid, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
