// Flash-attention backward: dq (K10) and dk, dv (K11), recomputing the
// block scores from q, k and the forward's log-sum-exp.
//
// Replaces repro/kernels/flash_attention/kernel.py::_flash_bwd_dq_kernel
// (called by flash_attention_bwd at :236) and ::_flash_bwd_dkv_kernel
// (called at :257).  Both compute what those kernels compute:
//   s = (q . k) * scale in f32; with a softcap s = tanh(s / cap) * cap and
//   dcap = 1 - (s / cap)^2, taken before masking; masked (causal: q_pos >=
//   k_pos; window: q_pos - k_pos < window) elements get p = 0, otherwise
//   p = exp(s - lse); dp = do . v; ds = p * (dp - delta) (* dcap), with
//   delta = rowsum(do * o) computed by the wrapper, as the JAX wrapper
//   does outside its kernels; dq = sum_k ds . k * scale, dk = sum_q ds^T .
//   q * scale, dv = sum_q p^T . do.  GQA: query head h reads KV head
//   h / (H / KV); dk and dv are written per query head, and the wrapper
//   sums the H / KV heads of each group.
//
// Rounding.  The reference keeps p and ds in f32 in the three accumulating
// products (ds . k, ds^T . q, p^T . do).  ds takes the scale once per
// element here, not once per tile product as in the reference: an f32
// rounding (a relative 2^-24 per term), far inside the tests' tolerances.
// The wgmma route takes p as 2^(s * scale * log2(e) - lse * log2(e)), the
// factor folded into one FFMA as K9's wgmma forward does: the same steps
// up to f32 rounding, within every limit the checks hold it to.
//
// Three routes, picked from the operands' dtype and the padded head dims
// alone (ops.flash_bwd_route; flash_attention_bwd_launch takes the route
// and refuses a pairing it does not run):
//
//   wgmma (bf16, hd = hd_v in {64, 128}; the training path of Phi-4-mini,
//   Qwen2-MoE, SeamlessM4T, InternVL2 and Qwen2-72B):
//   flash_bwd_dq_wgmma<HD> and flash_bwd_dkv_wgmma<HD>.  One CTA owns
//   128 rows (query rows for dq, keys for dk/dv) as two consumer
//   warpgroups of 64, and a producer warpgroup that gives up its
//   registers (setmaxnreg: 24 a thread, the consumers 240).  The
//   producer's first thread loads the owned operands once (dq: Q and dO;
//   dk/dv: K and V) and keeps the streamed tiles of 64 rows (K and V; or
//   Q, dO, and the rows' lse and delta by a bulk copy) in flight through a
//   ring of two stages by TMA (128-byte swizzle, rows past S zero-filled),
//   each stage with a full mbarrier counting the bytes and an empty one
//   every consumer thread releases.  Every product is a wgmma: the two
//   score products (dq: S = Q K^T, dP = dO V^T; dk/dv: S^T = K Q^T,
//   dP^T = V dO^T, keys the M dimension) from shared memory, K-major on
//   both sides; the accumulating ones (dQ
//   += dS K; dV += P^T dO, dK += dS^T Q) with A from registers, the score
//   accumulator's layout being the A fragment's, and B read MN-major
//   through the descriptor (K, dO and Q as TMA laid them: the same tiles
//   serve both forms).  p and ds are split exactly into three bf16 parts
//   (split_pair, two values at a time), the three wgmma of a k-slice on
//   one B descriptor, smallest first.  A tile's accumulating products stay
//   in flight while the next tile's score products are
//   issued: one wait covers both, and the stage is released after it.
//   The elementwise steps run as whole-tile loops behind branches uniform
//   over the CTA (softcap or not, masked or whole), so the compiler can
//   interleave the elements.  The sums are written as the 16-bit route's
//   are.  No instance spills (chip_smoke.py's build report checks it).
//
//   mma_sync (the other 16-bit launches: f16 at every head dim, bf16 at
//   the other widths; and bf16 at 64 and 128 on request, to hold the two
//   routes against each other): flash_bwd_dq_tc<T, HD, HDV> and
//   flash_bwd_dkv_tc<T, HD, HDV>, every product on the tensor cores as
//   mma.sync (f32 sums).  This file builds as two libraries, one a
//   type T (kernels/_build.py VARIANTS: bf16 by default, f16 where
//   H2PIPE_HALF is defined, each its own nvcc, started together).  What
//   follows is the bf16 instances'; the f16 ones differ in the three
//   accumulating products only (see below).  One CTA owns 64 rows (query
//   rows for dq, keys for dk/dv), four warps of 16, and walks the other
//   axis in tiles of 64.  The owned tile (Q and dO, or K and V) is loaded
//   once; the streamed tile (K and V, or Q, dO, lse and delta) passes
//   through a ring of two shared-memory buffers filled with cp.async, so
//   tile t+1 is in flight while tile t is consumed.  Rows are padded by 8
//   elements for ldmatrix.  The two score products (dq: S = Q K^T and
//   dP = dO V^T; dk/dv: S^T = K Q^T and dP^T = V dO^T, so that keys are
//   the M dimension) take bf16 operands as they are: each product is exact
//   in f32.  p and ds come out of the accumulator fragments in registers,
//   by grad_score's f32 steps.  For the accumulating products each f32 p
//   or ds is split exactly into three bf16 values (split3: hi = bf16(x),
//   mid = bf16(x - hi), lo = x - hi - mid; f32 has 24 significant bits,
//   the residuals at most 16 and 8), and each product runs as three
//   mma.sync on the parts, the smallest first.  Each bf16 x bf16 product is
//   exact in f32, so the three give p . do (or ds . k) exactly, and the
//   only difference from f32 FMAs is the order of the f32 additions.  The
//   m16n8 accumulator layout is the A-operand layout of the next
//   m16n8k16, as K9 uses it for PV, so p and ds never go through shared
//   memory; K, Q and dO reach the B operand through ldmatrix.trans.  dk/dv
//   handles its query tile in halves of 32 rows, which keeps the dk and dv
//   accumulators (16 x 128 f32 each a warp at hd = 128), the score
//   fragments and the split parts inside 255 registers.  Wide heads (hd or
//   hd_v > 128) give every 16 owned rows two warps, each accumulating half
//   of the head-dim columns (both compute the same scores).  The sums are
//   written once, rounded to bf16 (dtype 0) or as the f32 sums themselves
//   (dtype 2, the check that can see below bf16's precision); no atomics,
//   so both kernels are deterministic.  Head dims: any multiple of 8 from 8
//   to 256 (hd and hd_v each), run at the narrowest width the kernels are
//   built at that holds it (width(): hd 32, 64, 128, 192, 256; hd_v 32, 64,
//   128, 256; a wide head is one whose width is above 128).  The copies
//   zero-fill the columns past hd in Q and K and past hd_v in V and dO,
//   and read nothing past a row's hd or hd_v: the padded products add 0,
//   the padded columns of dq, dk and dv come out 0 and are not written.
//   The scale is the true 1/sqrt(hd), which the wrapper passes.
//
//   The f16 instances take the two score products as mma.sync m16n8k16
//   on f16 operands (exact in f32, as bf16's).  For the three
//   accumulating products p and ds cannot be split into f16 parts: f16's
//   range ends at 6.1e-5 (subnormals from there down to 6e-8), and a p
//   or ds below it, or a part of one, would be lost where the reference
//   keeps it in f32.  So they run on tf32 (mma.sync m16n8k8): each f32 p
//   or ds splits exactly into three tf32 values by truncation (split3_tf32:
//   11 significant bits each, with f32's exponent range), the f16 operand
//   converts to tf32 exactly (its 11 bits), and each m16n8k16 of the bf16
//   route becomes two m16n8k8 over the even and the odd keys of its 16
//   (a lane's A and B fragments hold the same keys: split_product).  Every
//   product is exact in f32 again; the f16 route issues twice the bf16
//   route's tensor-core work for these products.
//
//   f32 (dtype 1, the check path of the f32 card tests, as flash_fwd_f32
//   is for K9): flash_bwd_dq_f32 and flash_bwd_dkv_f32, every
//   operand in f32 in shared memory and every product an f32 FMA on the
//   CUDA cores; eight warps of 8 rows, K/V (or Q/dO) tiles of 32; a lane
//   owns the columns lane + 32c below the true head dim.
//
// Tiles the mask hides entirely are skipped on both routes, which is exact
// (p and ds are zero there); tiles every element of which is visible skip
// the mask.
//
// What bounds it on an H100: at the Phi-4-mini training shape (B=4, H=24,
// KV=8, S=512, hd=128, causal) dq needs 3 and dk/dv 4 products of
// B*H*S^2*hd FMAs, halved by the causal mask (9.7 and 12.9 GFLOP), against
// 46.5 and 59.1 MB moved, so bytes bound both (14 and 18 us at 3.35 TB/s);
// at S = 2048 operations do.  The split makes the tensor cores do 5 (dq)
// and 8 (dk/dv) products' work (16 and 26 us at 989 TFLOP/s), and between
// the products each element takes an exponential, the mask, the softcap
// and a three-way split on the same warps.  The mma.sync route issues
// both synchronously on four warps; the wgmma route issues the products
// asynchronously as warpgroup instructions, fed by TMA without a thread's
// registers or instructions, so that one warpgroup's elementwise work runs
// beside the other's products.  PERF.md has the times of both routes
// against the bound and the library's attention backward.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"
#include "wgmma.cuh"  // mbarriers, TMA and wgmma

namespace {

using namespace h2pipe_mma;
using namespace h2pipe_wgmma;

// The 16-bit operand type of this library and its dtype codes in
// flash_attention_bwd_launch: the grads in T, and the f32 sums.
#ifdef H2PIPE_HALF
using T16 = f16;
constexpr int DTYPE16 = 3, DTYPE16_F32 = 4;
#else
using T16 = bf16;
constexpr int DTYPE16 = 0, DTYPE16_F32 = 2;
#endif

// f32 route (SIMT)
constexpr int NT = 256;     // threads: 8 warps
constexpr int ROWS = 8;     // rows (dq: query rows; dk/dv: keys) per warp
constexpr int BQ10 = 64;    // query rows per CTA, dq kernel
constexpr int BK10 = 32;    // keys per tile, dq kernel
constexpr int BK11 = 64;    // keys per CTA, dk/dv kernel
constexpr int BQ11 = 32;    // query rows per tile, dk/dv kernel
constexpr int PAD = 4;      // row padding in floats (keeps float4 alignment)

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, Sq], contiguous
  const float* delta;  // [B, H, Sq], contiguous
  void* dq;
  void* dk;            // per query head
  void* dv;            // per query head
  // element strides over (batch, head, seq) of q, k, v, do, dq, dk, dv;
  // the head dim is contiguous
  long long s[21];
  int B, H, KV, Sq, Sk, hd, hdv, causal, window;
  float softcap, scale;
  int f32_out;         // 16-bit routes: write the f32 sums, not T
  int ls;              // row stride of lse and delta (Sq; the wgmma
                       // route's rows padded to a multiple of WG_TILE)
};

enum { Q_ = 0, K_ = 3, V_ = 6, DO_ = 9, DQ_ = 12, DK_ = 15, DV_ = 18 };


__device__ __forceinline__ bool visible(const BwdArgs& a, int row, int col) {
  return row < a.Sq && col < a.Sk && (!a.causal || row >= col) &&
         (a.window == 0 || row - col < a.window);
}

// ds * scale for one visible element, and its p.
__device__ __forceinline__ float grad_score(const BwdArgs& a, float dot,
                                            float dp, float lse, float delta,
                                            float* p_out) {
  float s = dot * a.scale;
  float dcap = 1.0f;
  if (a.softcap != 0.0f) {
    s = tanhf(s / a.softcap) * a.softcap;
    const float t = s / a.softcap;
    dcap = 1.0f - t * t;
  }
  const float p = expf(s - lse);
  *p_out = p;
  float ds = p * (dp - delta);
  if (a.softcap != 0.0f) ds *= dcap;
  return ds * a.scale;
}

// rows [row0, row0 + rows) of a [S, D] operand (row stride `stride`) into
// shared memory as f32 with row stride `ld`; rows at or past S are zeros.
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          long long stride, int row0, int S,
                                          int rows, int D) {
  for (int idx = threadIdx.x; idx < rows * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    dst[r * ld + c] =
        row0 + r < S ? src[(long long)(row0 + r) * stride + c] : 0.0f;
  }
}

// out[i] += A[i] . b over D (a multiple of 4) for the warp's ROWS rows of
// A (row stride lda; the same address in every lane: a broadcast) and the
// lane's own row b.
__device__ __forceinline__ void dots(float* out, const float* A, int lda,
                                     const float* b, int D) {
  for (int d = 0; d < D; d += 4) {
    const float4 bv = *reinterpret_cast<const float4*>(b + d);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const float4 av = *reinterpret_cast<const float4*>(A + i * lda + d);
      out[i] = fmaf(av.x, bv.x, out[i]);
      out[i] = fmaf(av.y, bv.y, out[i]);
      out[i] = fmaf(av.z, bv.z, out[i]);
      out[i] = fmaf(av.w, bv.w, out[i]);
    }
  }
}

// acc[i][c] += sum_j W[i][j] X[j][lane + 32c] over J (a multiple of 4)
// columns of the warp's ROWS rows of W (row stride ldw, broadcast) and
// rows of X (row stride ldx), for the columns lane + 32c < D.
template <int MAXC>
__device__ __forceinline__ void accumulate(float (*acc)[MAXC], const float* W,
                                           int ldw, const float* X, int ldx,
                                           int J, int D, int lane) {
  for (int j = 0; j < J; j += 4) {
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (lane + 32 * c < D) {
        const float* x = X + j * ldx + lane + 32 * c;
        const float x0 = x[0], x1 = x[ldx], x2 = x[2 * ldx], x3 = x[3 * ldx];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const float4 w = *reinterpret_cast<const float4*>(W + i * ldw + j);
          float t = acc[i][c];
          t = fmaf(w.x, x0, t);
          t = fmaf(w.y, x1, t);
          t = fmaf(w.z, x2, t);
          t = fmaf(w.w, x3, t);
          acc[i][c] = t;
        }
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ const T* head_ptr(const void* base,
                                             const long long* s, int b,
                                             int h) {
  return static_cast<const T*>(base) + b * s[0] + h * s[1];
}

#ifndef H2PIPE_HALF  // f32 operands: in the bf16 library only
// ---------------------------------------------------------------------------
// K10: dq
// ---------------------------------------------------------------------------

size_t smem_dq(int hd, int hdv) {
  return ((size_t)(BQ10 + BK10) * (hd + PAD + hdv + PAD) +
          (size_t)BQ10 * (BK10 + PAD)) *
         sizeof(float);
}

template <int MAXC>
__global__ void __launch_bounds__(NT) flash_bwd_dq_f32(BwdArgs a) {
  extern __shared__ __align__(16) float smem_dq_raw[];
  const int LQ = a.hd + PAD, LV = a.hdv + PAD, LD = BK10 + PAD;
  float* Qs = smem_dq_raw;     // [BQ10][LQ]
  float* Os = Qs + BQ10 * LQ;  // dO, [BQ10][LV]
  float* Ks = Os + BQ10 * LV;  // [BK10][LQ]
  float* Vs = Ks + BK10 * LQ;  // [BK10][LV]
  float* Ds = Vs + BK10 * LV;  // ds * scale, [BQ10][LD]

  const int nqb = (a.Sq + BQ10 - 1) / BQ10;
  const int q0 = (nqb - 1 - (int)blockIdx.x) * BQ10;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const float* q = head_ptr<float>(a.q, a.s + Q_, b, h);
  const float* k = head_ptr<float>(a.k, a.s + K_, b, kvh);
  const float* v = head_ptr<float>(a.v, a.s + V_, b, kvh);
  const float* dout = head_ptr<float>(a.dout, a.s + DO_, b, h);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * ROWS;  // the warp's first row in the block

  load_rows(Qs, LQ, q, a.s[Q_ + 2], q0, a.Sq, BQ10, a.hd);
  load_rows(Os, LV, dout, a.s[DO_ + 2], q0, a.Sq, BQ10, a.hdv);
  float lse[ROWS], delta[ROWS];
  const long long bh = ((long long)b * a.H + h) * a.Sq;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q0 + r0 + i;
    lse[i] = row < a.Sq ? a.lse[bh + row] : 0.0f;
    delta[i] = row < a.Sq ? a.delta[bh + row] : 0.0f;
  }
  float acc[ROWS][MAXC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int c = 0; c < MAXC; ++c) acc[i][c] = 0.0f;

  // the key tiles some row of the block can see
  const int nkt = (a.Sk + BK10 - 1) / BK10;
  const int q_last = min(q0 + BQ10, a.Sq) - 1;
  const int hi = a.causal ? min(nkt - 1, q_last / BK10) : nkt - 1;
  const int lo = a.window > 0 ? max(0, q0 - a.window + 1) / BK10 : 0;
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * BK10;
    __syncthreads();  // every warp is done with the previous tile
    load_rows(Ks, LQ, k, a.s[K_ + 2], k0, a.Sk, BK10, a.hd);
    load_rows(Vs, LV, v, a.s[V_ + 2], k0, a.Sk, BK10, a.hdv);
    __syncthreads();
    float s[ROWS], dp[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) s[i] = dp[i] = 0.0f;
    dots(s, Qs + r0 * LQ, LQ, Ks + lane * LQ, a.hd);
    dots(dp, Os + r0 * LV, LV, Vs + lane * LV, a.hdv);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      float p, ds = 0.0f;
      if (visible(a, q0 + r0 + i, k0 + lane))
        ds = grad_score(a, s[i], dp[i], lse[i], delta[i], &p);
      Ds[(r0 + i) * LD + lane] = ds;
    }
    __syncwarp();  // a warp reads back only its own rows of Ds
    accumulate<MAXC>(acc, Ds + r0 * LD, LD, Ks, LQ, BK10, a.hd, lane);
    __syncwarp();
  }

  float* dq = static_cast<float*>(a.dq) + b * a.s[DQ_] + h * a.s[DQ_ + 1];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q0 + r0 + i;
    if (row >= a.Sq) continue;
#pragma unroll
    for (int c = 0; c < MAXC; ++c)
      if (lane + 32 * c < a.hd)
        dq[row * a.s[DQ_ + 2] + lane + 32 * c] = acc[i][c];
  }
}

// ---------------------------------------------------------------------------
// K11: dk, dv
// ---------------------------------------------------------------------------

size_t smem_dkv(int hd, int hdv) {
  return ((size_t)(BK11 + BQ11) * (hd + PAD + hdv + PAD) +
          2 * (size_t)BK11 * (BQ11 + PAD) + 2 * BQ11) *
         sizeof(float);
}

template <int MAXC>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_f32(BwdArgs a) {
  extern __shared__ __align__(16) float smem_dkv_raw[];
  const int LQ = a.hd + PAD, LV = a.hdv + PAD, LP = BQ11 + PAD;
  float* Ks = smem_dkv_raw;    // [BK11][LQ]
  float* Vs = Ks + BK11 * LQ;  // [BK11][LV]
  float* Qs = Vs + BK11 * LV;  // [BQ11][LQ]
  float* Os = Qs + BQ11 * LQ;  // dO, [BQ11][LV]
  float* Ps = Os + BQ11 * LV;  // p^T, [BK11][LP]
  float* Ds = Ps + BK11 * LP;  // ds^T * scale, [BK11][LP]
  float* Ls = Ds + BK11 * LP;  // lse of the tile's rows, [BQ11]
  float* Dl = Ls + BQ11;       // delta of the tile's rows, [BQ11]

  const int k0 = blockIdx.x * BK11;  // causal: the first keys see most rows
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const float* q = head_ptr<float>(a.q, a.s + Q_, b, h);
  const float* k = head_ptr<float>(a.k, a.s + K_, b, kvh);
  const float* v = head_ptr<float>(a.v, a.s + V_, b, kvh);
  const float* dout = head_ptr<float>(a.dout, a.s + DO_, b, h);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * ROWS;  // the warp's first key in the block
  const long long bh = ((long long)b * a.H + h) * a.Sq;

  load_rows(Ks, LQ, k, a.s[K_ + 2], k0, a.Sk, BK11, a.hd);
  load_rows(Vs, LV, v, a.s[V_ + 2], k0, a.Sk, BK11, a.hdv);
  float dk[ROWS][MAXC], dv[ROWS][MAXC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int c = 0; c < MAXC; ++c) dk[i][c] = dv[i][c] = 0.0f;

  // the query tiles some key of the block is visible to
  const int nqt = (a.Sq + BQ11 - 1) / BQ11;
  const int k_last = min(k0 + BK11, a.Sk) - 1;
  const int lo = a.causal ? min(nqt, k0 / BQ11) : 0;
  const int hi = a.window > 0
                     ? min(nqt - 1, (k_last + a.window - 1) / BQ11)
                     : nqt - 1;
  for (int qt = lo; qt <= hi; ++qt) {
    const int q0 = qt * BQ11;
    __syncthreads();  // every warp is done with the previous tile
    load_rows(Qs, LQ, q, a.s[Q_ + 2], q0, a.Sq, BQ11, a.hd);
    load_rows(Os, LV, dout, a.s[DO_ + 2], q0, a.Sq, BQ11, a.hdv);
    if (threadIdx.x < BQ11) {
      const int row = q0 + threadIdx.x;
      Ls[threadIdx.x] = row < a.Sq ? a.lse[bh + row] : 0.0f;
      Dl[threadIdx.x] = row < a.Sq ? a.delta[bh + row] : 0.0f;
    }
    __syncthreads();
    float s[ROWS], dp[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) s[i] = dp[i] = 0.0f;
    dots(s, Ks + r0 * LQ, LQ, Qs + lane * LQ, a.hd);    // s^T: keys x rows
    dots(dp, Vs + r0 * LV, LV, Os + lane * LV, a.hdv);  // dp^T
    const float lse = Ls[lane], delta = Dl[lane];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      float p = 0.0f, ds = 0.0f;
      if (visible(a, q0 + lane, k0 + r0 + i))
        ds = grad_score(a, s[i], dp[i], lse, delta, &p);
      Ps[(r0 + i) * LP + lane] = p;
      Ds[(r0 + i) * LP + lane] = ds;
    }
    __syncwarp();  // a warp reads back only its own rows of Ps and Ds
    accumulate<MAXC>(dv, Ps + r0 * LP, LP, Os, LV, BQ11, a.hdv, lane);
    accumulate<MAXC>(dk, Ds + r0 * LP, LP, Qs, LQ, BQ11, a.hd, lane);
    __syncwarp();
  }

  float* gk = static_cast<float*>(a.dk) + b * a.s[DK_] + h * a.s[DK_ + 1];
  float* gv = static_cast<float*>(a.dv) + b * a.s[DV_] + h * a.s[DV_ + 1];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int key = k0 + r0 + i;
    if (key >= a.Sk) continue;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (lane + 32 * c < a.hd)
        gk[key * a.s[DK_ + 2] + lane + 32 * c] = dk[i][c];
      if (lane + 32 * c < a.hdv)
        gv[key * a.s[DV_ + 2] + lane + 32 * c] = dv[i][c];
    }
  }
}

#endif

// ---------------------------------------------------------------------------
// 16-bit route: tensor cores through mma.sync
// ---------------------------------------------------------------------------

constexpr int TC_BM = 64;   // owned rows per CTA: 4 row groups of 16
constexpr int TC_BN = 64;   // rows of a streamed tile
constexpr int TC_SUB = 32;  // dk/dv: query rows handled at once

// Warps per 16 owned rows: wide heads split the accumulators' head-dim
// columns between two warps.
template <int HD, int HDV>
__host__ __device__ constexpr int col_split() {
  return HD > 128 || HDV > 128 ? 2 : 1;
}

// 4-byte global -> shared copy, zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// x == hi + mid + lo exactly, each part a bf16 value: f32 has 24
// significant bits, x - hi at most 16 and x - hi - mid at most 8.
__device__ __forceinline__ void split3(float x, float& hi, float& mid,
                                       float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(x));
  const float r = x - hi;
  mid = __bfloat162float(__float2bfloat16_rn(r));
  lo = r - mid;
}

// The A fragments lo (f[0]), mid (f[1]) and hi (f[2]) of one k-slice of
// 16 from the two m16n8 accumulator fragments c[0], c[1] that cover it:
// the accumulator layout is the A layout, so a0..a3 are (c[0][0], c[0][1]),
// (c[0][2], c[0][3]), (c[1][0], c[1][1]), (c[1][2], c[1][3]).
__device__ __forceinline__ void split_frag(const float (*c)[4],
                                           uint32_t (*f)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float h0, m0, l0, h1, m1, l1;
    split3(c[r >> 1][2 * (r & 1)], h0, m0, l0);
    split3(c[r >> 1][2 * (r & 1) + 1], h1, m1, l1);
    f[0][r] = pack_bf16(l0, l1);
    f[1][r] = pack_bf16(m0, m1);
    f[2][r] = pack_bf16(h0, h1);
  }
}

// acc[n], acc[n + 1] += the three parts f, smallest first, times the B
// fragments of n-tiles n (b[0], b[1]) and n + 1 (b[2], b[3]).
__device__ __forceinline__ void mma_split(float (*acc)[4], uint32_t (*f)[4],
                                          const uint32_t* b) {
#pragma unroll
  for (int part = 0; part < 3; ++part) {
    mma_bf16(acc[0], f[part], b[0], b[1]);
    mma_bf16(acc[1], f[part], b[2], b[3]);
  }
}

// x == hi + mid + lo exactly, each part a tf32 value (11 significant
// bits; the low 13 bits of its f32 pattern zero): truncations, so x - hi
// keeps at most 13 significant bits and x - hi - mid at most 2.
__device__ __forceinline__ void split3_tf32(float x, float& hi, float& mid,
                                            float& lo) {
  hi = __uint_as_float(__float_as_uint(x) & 0xffffe000u);
  const float r = x - hi;
  mid = __uint_as_float(__float_as_uint(r) & 0xffffe000u);
  lo = r - mid;
}

// The f16 route's A fragments of one k-slice of 16 keys for the keys of
// parity e: c[0], c[1] are the two m16n8 accumulator fragments that cover
// it (a lane's registers e = 0, 1 hold keys 2t and 2t+1 of each 8), and
// the m16n8k8 takes the keys 2t+e and 8+2t+e as its k-indices t and t+4
// (a0, a1: rows g and g+8 at key 2t+e; a2, a3: at key 8+2t+e).  Each
// value splits into its three tf32 parts, lo (part[0]), mid, hi.
__device__ __forceinline__ void split_frag_tf32(const float (*c)[4], int e,
                                                uint32_t (*part)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float hi, mid, lo;
    split3_tf32(c[r >> 1][(r & 1) * 2 + e], hi, mid, lo);
    part[0][r] = __float_as_uint(lo);
    part[1][r] = __float_as_uint(mid);
    part[2][r] = __float_as_uint(hi);
  }
}

// acc[0], acc[1] += the three parts, smallest first, times the B
// fragments of the keys of parity e of n-tiles n and n + 1: the
// ldmatrix.trans fragments xf (xf[0] keys 2t, 2t+1 of tile n, xf[1] keys
// 8+2t, 9+2t; xf[2], xf[3] tile n + 1) converted from f16 to tf32 exactly.
__device__ __forceinline__ void mma_split_tf32(float (*acc)[4],
                                               uint32_t (*part)[4],
                                               const uint32_t* xf, int e) {
#pragma unroll
  for (int tile = 0; tile < 2; ++tile) {
    const __half2 k0 = *reinterpret_cast<const __half2*>(&xf[2 * tile]);
    const __half2 k8 = *reinterpret_cast<const __half2*>(&xf[2 * tile + 1]);
    const uint32_t b0 =
        __float_as_uint(e ? __high2float(k0) : __low2float(k0));
    const uint32_t b1 =
        __float_as_uint(e ? __high2float(k8) : __low2float(k8));
#pragma unroll
    for (int p = 0; p < 3; ++p) mma_tf32(acc[tile], part[p], b0, b1);
  }
}

// Outputs (row, col) and (row, col + 1) of a gradient given by its base
// and strides s (batch, head, seq): rounded to T, or the f32 sums.
template <typename T>
__device__ __forceinline__ void store_pair(void* base, const long long* s,
                                           int b, int h, int row, int col,
                                           float x0, float x1, bool f32) {
  const long long off = b * s[0] + h * s[1] + row * s[2] + col;
  if (f32)
    *reinterpret_cast<float2*>(static_cast<float*>(base) + off) =
        make_float2(x0, x1);
  else
    *reinterpret_cast<uint32_t*>(static_cast<T*>(base) + off) =
        pack2<T>(x0, x1);
}

// acc[j] += A . B^T for one warp: A is the warp's 16 rows of an [., D]
// tile (row stride la), B the first 8 NJ rows of another (row stride lb);
// both of type T in shared memory, sums in f32.
template <int D, int NJ, typename T>
__device__ __forceinline__ void score_product(float (*acc)[4], const T* A,
                                              int la, const T* B, int lb,
                                              int lane) {
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = (lane >> 4) * 8;
  const int kr = (lane & 7) + (lane >> 4) * 8, kc = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, A + lr * la + kk * 16 + lc);
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      uint32_t bf[4];
      ldsm_x4(bf, B + (j * 8 + kr) * lb + kk * 16 + kc);
      mma16<T>(acc[j], af, bf[0], bf[1]);
      mma16<T>(acc[j + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[n] += split(c) . X for the NC / 8 n-tiles of columns [c0, c0 + NC)
// of the rows [0, 16 NK) of X (type T, row stride lx), where c holds 2 NK
// m16n8 accumulator fragments: the three-part product of one warp, on
// bf16 parts (bf16 X) or tf32 parts (f16 X).
template <int NK, int NC, typename T>
__device__ __forceinline__ void split_product(float (*acc)[4],
                                              const float (*c)[4],
                                              const T* X, int lx, int c0,
                                              int lane) {
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    if constexpr (std::is_same<T, f16>::value) {
      // the even keys, then the odd ones: 12 parts live, not 24
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        uint32_t part[3][4];
        split_frag_tf32(c + 2 * kk, e, part);
#pragma unroll
        for (int n = 0; n < NC / 8; n += 2) {
          uint32_t xf[4];
          ldsm_x4_trans(xf, X + (kk * 16 + lr) * lx + c0 + n * 8 + lc);
          mma_split_tf32(acc + n, part, xf, e);
        }
      }
    } else {
      uint32_t f[3][4];
      split_frag(c + 2 * kk, f);
#pragma unroll
      for (int n = 0; n < NC / 8; n += 2) {
        uint32_t xf[4];
        ldsm_x4_trans(xf, X + (kk * 16 + lr) * lx + c0 + n * 8 + lc);
        mma_split(acc + n, f, xf);
      }
    }
  }
}

template <int HD, int HDV>
size_t smem_tc(bool stats) {
  return (size_t)(TC_BM + 2 * TC_BN) * (HD + 8 + HDV + 8) * sizeof(T16) +
         (stats ? 2 * 2 * TC_BN * sizeof(float) : 0);
}

// K10: dq for 64 query rows of one (batch, head).
template <typename T, int HD, int HDV, int NTC = 128 * col_split<HD, HDV>()>
__global__ void __launch_bounds__(NTC) flash_bwd_dq_tc(BwdArgs a) {
  constexpr int CS = NTC / 128;
  constexpr int LQ = HD + 8, LV = HDV + 8, DC = HD / CS;
  extern __shared__ __align__(16) unsigned char smem_dq_tc_raw[];
  T* Qs = reinterpret_cast<T*>(smem_dq_tc_raw);  // [BM][LQ]
  T* Os = Qs + TC_BM * LQ;                          // dO, [BM][LV]
  T* Ks = Os + TC_BM * LV;                          // 2 x [BN][LQ]
  T* Vs = Ks + 2 * TC_BN * LQ;                      // 2 x [BN][LV]

  const int nqb = (a.Sq + TC_BM - 1) / TC_BM;
  const int q0 = (nqb - 1 - (int)blockIdx.x) * TC_BM;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const T* q = head_ptr<T>(a.q, a.s + Q_, b, h);
  const T* k = head_ptr<T>(a.k, a.s + K_, b, kvh);
  const T* v = head_ptr<T>(a.v, a.s + V_, b, kvh);
  const T* dout = head_ptr<T>(a.dout, a.s + DO_, b, h);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp % 4, wc = warp / 4;  // row group, column half
  const int g = lane >> 2, t = lane & 3;   // fragment row / column pair
  const int row0 = q0 + wr * 16 + g, row1 = row0 + 8;
  const long long bh = ((long long)b * a.H + h) * a.Sq;
  const float lse0 = row0 < a.Sq ? a.lse[bh + row0] : 0.0f;
  const float lse1 = row1 < a.Sq ? a.lse[bh + row1] : 0.0f;
  const float dl0 = row0 < a.Sq ? a.delta[bh + row0] : 0.0f;
  const float dl1 = row1 < a.Sq ? a.delta[bh + row1] : 0.0f;

  float acc[DC / 8][4];
#pragma unroll
  for (int n = 0; n < DC / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  // the key tiles some row of the block can see
  const int nkt = (a.Sk + TC_BN - 1) / TC_BN;
  const int q_last = min(q0 + TC_BM, a.Sq) - 1;
  const int hi = a.causal ? min(nkt - 1, q_last / TC_BN) : nkt - 1;
  const int lo = a.window > 0 ? max(0, q0 - a.window + 1) / TC_BN : 0;
  if (lo <= hi) {
    load_tile<HD, NTC>(Qs, LQ, q, a.s[Q_ + 2], q0, a.Sq, TC_BM, a.hd);
    load_tile<HDV, NTC>(Os, LV, dout, a.s[DO_ + 2], q0, a.Sq, TC_BM, a.hdv);
    load_tile<HD, NTC>(Ks, LQ, k, a.s[K_ + 2], lo * TC_BN, a.Sk, TC_BN,
                       a.hd);
    load_tile<HDV, NTC>(Vs, LV, v, a.s[V_ + 2], lo * TC_BN, a.Sk, TC_BN,
                        a.hdv);
  }
  cp_async_commit();
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * TC_BN, buf = (kt - lo) & 1;
    if (kt < hi) {
      load_tile<HD, NTC>(Ks + (buf ^ 1) * TC_BN * LQ, LQ, k, a.s[K_ + 2],
                         k0 + TC_BN, a.Sk, TC_BN, a.hd);
      load_tile<HDV, NTC>(Vs + (buf ^ 1) * TC_BN * LV, LV, v, a.s[V_ + 2],
                          k0 + TC_BN, a.Sk, TC_BN, a.hdv);
    }
    cp_async_commit();
    cp_async_wait1();  // Q, dO and tile kt have landed
    __syncthreads();
    const T* Kb = Ks + buf * TC_BN * LQ;
    const T* Vb = Vs + buf * TC_BN * LV;

    // s = q . k^T and dp = do . v^T: the warp's 16 rows x 64 keys
    float s[TC_BN / 8][4], dp[TC_BN / 8][4];
#pragma unroll
    for (int j = 0; j < TC_BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
    score_product<HD, TC_BN / 8>(s, Qs + wr * 16 * LQ, LQ, Kb, LQ, lane);
    score_product<HDV, TC_BN / 8>(dp, Os + wr * 16 * LV, LV, Vb, LV, lane);

    // ds * scale in place of s; zero where masked
#pragma unroll
    for (int j = 0; j < TC_BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p;
        s[j][e] = grad_score(a, s[j][e], dp[j][e], e < 2 ? lse0 : lse1,
                             e < 2 ? dl0 : dl1, &p);
      }
    const bool whole = q0 + TC_BM <= a.Sq && k0 + TC_BN <= a.Sk &&
                       (!a.causal || k0 + TC_BN - 1 <= q0) &&
                       (a.window == 0 || q0 + TC_BM - 1 - k0 < a.window);
    if (!whole) {
#pragma unroll
      for (int j = 0; j < TC_BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(a, e < 2 ? row0 : row1, k0 + j * 8 + 2 * t + (e & 1)))
            s[j][e] = 0.0f;
    }

    // dq += ds . k, ds in three parts
    split_product<TC_BN / 16, DC>(acc, s, Kb, LQ, wc * DC, lane);
    __syncthreads();  // every warp is done with buffer `buf`
  }

#pragma unroll
  for (int n = 0; n < DC / 8; ++n) {
    const int col = wc * DC + n * 8 + 2 * t;
    if (wc * DC + n * 8 >= a.hd) break;  // the padding columns
    if (row0 < a.Sq)
      store_pair<T>(a.dq, a.s + DQ_, b, h, row0, col, acc[n][0], acc[n][1],
                 a.f32_out);
    if (row1 < a.Sq)
      store_pair<T>(a.dq, a.s + DQ_, b, h, row1, col, acc[n][2], acc[n][3],
                 a.f32_out);
  }
}

// K11: dk and dv for 64 keys of one (batch, query head).
template <typename T, int HD, int HDV, int NTC = 128 * col_split<HD, HDV>()>
__global__ void __launch_bounds__(NTC) flash_bwd_dkv_tc(BwdArgs a) {
  constexpr int CS = NTC / 128;
  constexpr int LQ = HD + 8, LV = HDV + 8, DKC = HD / CS, DVC = HDV / CS;
  extern __shared__ __align__(16) unsigned char smem_dkv_tc_raw[];
  T* Ks = reinterpret_cast<T*>(smem_dkv_tc_raw);  // [BM][LQ]
  T* Vs = Ks + TC_BM * LQ;                           // [BM][LV]
  T* Qs = Vs + TC_BM * LV;                           // 2 x [BN][LQ]
  T* Os = Qs + 2 * TC_BN * LQ;                       // dO, 2 x [BN][LV]
  float* Ls = reinterpret_cast<float*>(Os + 2 * TC_BN * LV);  // 2 x [BN]
  float* Dl = Ls + 2 * TC_BN;                                 // 2 x [BN]

  const int k0 = blockIdx.x * TC_BM;  // causal: the first keys see most rows
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const T* q = head_ptr<T>(a.q, a.s + Q_, b, h);
  const T* k = head_ptr<T>(a.k, a.s + K_, b, kvh);
  const T* v = head_ptr<T>(a.v, a.s + V_, b, kvh);
  const T* dout = head_ptr<T>(a.dout, a.s + DO_, b, h);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp % 4, wc = warp / 4;  // row group, column half
  const int g = lane >> 2, t = lane & 3;
  const int key0 = k0 + wr * 16 + g, key1 = key0 + 8;
  const long long bh = ((long long)b * a.H + h) * a.Sq;

  float dk[DKC / 8][4], dv[DVC / 8][4];
#pragma unroll
  for (int n = 0; n < DKC / 8; ++n)
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.0f;
#pragma unroll
  for (int n = 0; n < DVC / 8; ++n)
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.0f;

  // Q, dO, lse and delta of query rows [q0, q0 + BN) into buffer `buf`
  auto load_q = [&](int buf, int q0) {
    load_tile<HD, NTC>(Qs + buf * TC_BN * LQ, LQ, q, a.s[Q_ + 2], q0, a.Sq,
                       TC_BN, a.hd);
    load_tile<HDV, NTC>(Os + buf * TC_BN * LV, LV, dout, a.s[DO_ + 2], q0,
                        a.Sq, TC_BN, a.hdv);
    if (threadIdx.x < 2 * TC_BN) {
      const int i = threadIdx.x % TC_BN, row = q0 + i;
      const bool d = threadIdx.x >= TC_BN, valid = row < a.Sq;
      cp_async4((d ? Dl : Ls) + buf * TC_BN + i,
                (d ? a.delta : a.lse) + bh + (valid ? row : 0), valid);
    }
  };

  // the query tiles some key of the block is visible to
  const int nqt = (a.Sq + TC_BN - 1) / TC_BN;
  const int k_last = min(k0 + TC_BM, a.Sk) - 1;
  const int lo = a.causal ? min(nqt, k0 / TC_BN) : 0;
  const int hi = a.window > 0
                     ? min(nqt - 1, (k_last + a.window - 1) / TC_BN)
                     : nqt - 1;
  if (lo <= hi) {
    load_tile<HD, NTC>(Ks, LQ, k, a.s[K_ + 2], k0, a.Sk, TC_BM, a.hd);
    load_tile<HDV, NTC>(Vs, LV, v, a.s[V_ + 2], k0, a.Sk, TC_BM, a.hdv);
    load_q(0, lo * TC_BN);
  }
  cp_async_commit();
  for (int qt = lo; qt <= hi; ++qt) {
    const int q0 = qt * TC_BN, buf = (qt - lo) & 1;
    if (qt < hi) load_q(buf ^ 1, q0 + TC_BN);
    cp_async_commit();
    cp_async_wait1();  // K, V and tile qt have landed
    __syncthreads();
    const T* Qb = Qs + buf * TC_BN * LQ;
    const T* Ob = Os + buf * TC_BN * LV;
    const float* Lb = Ls + buf * TC_BN;
    const float* Db = Dl + buf * TC_BN;
    const bool whole = q0 + TC_BN <= a.Sq && k0 + TC_BM <= a.Sk &&
                       (!a.causal || k0 + TC_BM - 1 <= q0) &&
                       (a.window == 0 || q0 + TC_BN - 1 - k0 < a.window);

    // the tile in halves of TC_SUB query rows
#pragma unroll 1
    for (int r0 = 0; r0 < TC_BN; r0 += TC_SUB) {
      // s^T = k . q^T and dp^T = v . do^T: the warp's 16 keys x TC_SUB rows
      float st[TC_SUB / 8][4], dpt[TC_SUB / 8][4];
#pragma unroll
      for (int j = 0; j < TC_SUB / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.0f;
      score_product<HD, TC_SUB / 8>(st, Ks + wr * 16 * LQ, LQ,
                                    Qb + r0 * LQ, LQ, lane);
      score_product<HDV, TC_SUB / 8>(dpt, Vs + wr * 16 * LV, LV,
                                     Ob + r0 * LV, LV, lane);

      // p^T in place of s^T and ds^T * scale in place of dp^T
#pragma unroll
      for (int j = 0; j < TC_SUB / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = r0 + j * 8 + 2 * t + (e & 1);
          float p;
          dpt[j][e] = grad_score(a, st[j][e], dpt[j][e], Lb[c], Db[c], &p);
          st[j][e] = p;
        }
      if (!whole) {
#pragma unroll
        for (int j = 0; j < TC_SUB / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!visible(a, q0 + r0 + j * 8 + 2 * t + (e & 1),
                         e < 2 ? key0 : key1))
              st[j][e] = dpt[j][e] = 0.0f;
      }

      // dv += p^T . do and dk += ds^T . q, p and ds in three parts
      split_product<TC_SUB / 16, DVC>(dv, st, Ob + r0 * LV, LV, wc * DVC,
                                      lane);
      split_product<TC_SUB / 16, DKC>(dk, dpt, Qb + r0 * LQ, LQ, wc * DKC,
                                      lane);
    }
    __syncthreads();  // every warp is done with buffer `buf`
  }

#pragma unroll
  for (int n = 0; n < DKC / 8; ++n) {
    const int col = wc * DKC + n * 8 + 2 * t;
    if (wc * DKC + n * 8 >= a.hd) break;  // the padding columns
    if (key0 < a.Sk)
      store_pair<T>(a.dk, a.s + DK_, b, h, key0, col, dk[n][0], dk[n][1],
                 a.f32_out);
    if (key1 < a.Sk)
      store_pair<T>(a.dk, a.s + DK_, b, h, key1, col, dk[n][2], dk[n][3],
                 a.f32_out);
  }
#pragma unroll
  for (int n = 0; n < DVC / 8; ++n) {
    const int col = wc * DVC + n * 8 + 2 * t;
    if (wc * DVC + n * 8 >= a.hdv) break;  // the padding columns
    if (key0 < a.Sk)
      store_pair<T>(a.dv, a.s + DV_, b, h, key0, col, dv[n][0], dv[n][1],
                 a.f32_out);
    if (key1 < a.Sk)
      store_pair<T>(a.dv, a.s + DV_, b, h, key1, col, dv[n][2], dv[n][3],
                 a.f32_out);
  }
}

#ifndef H2PIPE_HALF  // the wgmma route: bf16 operands, in the bf16 library
// ---------------------------------------------------------------------------
// bf16, hd = hd_v in {64, 128}: wgmma fed by TMA
// ---------------------------------------------------------------------------

constexpr int WG_OWN = 128;        // owned rows a CTA: two warpgroups of 64
constexpr int WG_TILE = 64;        // rows of a streamed tile
constexpr int WG_STAGES = 2;       // streamed tiles in flight
constexpr int WG_CONSUMERS = 256;  // the two consumer warpgroups
constexpr int WG_THREADS = WG_CONSUMERS + 128;  // and the producer's
constexpr int WG_ROW = 128;        // bytes of one swizzled row: 64 bf16
// registers a thread after setmaxnreg: 128 x 24 + 256 x 240 <= 65,536
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

// Shared memory of one CTA (1024-byte aligned; every panel starts on a
// 1024-byte boundary, where the 128-byte swizzle repeats): the two owned
// operands (dq: Q and dO; dk/dv: K and V), each HD/64 panels of [WG_OWN
// rows][128 B]; then WG_STAGES stages of the two streamed ones (dq: K and
// V; dk/dv: Q and dO), each HD/64 panels of [WG_TILE rows][128 B], and
// for dk/dv the tile's lse and delta (WG_TILE f32 each, in a 1024-byte
// slot).  ops.bwd_wgmma_smem computes the same bytes.
template <int HD>
struct BwdLayout {
  static constexpr int PANELS = HD / 64;
  static constexpr int OWN_PANEL = WG_OWN * WG_ROW;
  static constexpr int TILE_PANEL = WG_TILE * WG_ROW;
  static constexpr int OWN_BYTES = PANELS * OWN_PANEL;    // one operand
  static constexpr int TILE_BYTES = PANELS * TILE_PANEL;  // one operand
  static constexpr int STATS_BYTES = 2 * WG_TILE * 4;     // lse, delta
  static constexpr int STAGE_DQ = 2 * TILE_BYTES;
  static constexpr int STAGE_DKV = 2 * TILE_BYTES + 1024;
  static constexpr int SMEM_DQ = 2 * OWN_BYTES + WG_STAGES * STAGE_DQ + 1024;
  static constexpr int SMEM_DKV =
      2 * OWN_BYTES + WG_STAGES * STAGE_DKV + 1024;
};

// The key tiles of WG_TILE keys some row of [q0, q0 + rows) can see; none
// (lo > hi) where q0 is past Sq.
__device__ __forceinline__ void key_tiles(const BwdArgs& a, int q0, int rows,
                                          int* lo, int* hi) {
  const int nkt = (a.Sk + WG_TILE - 1) / WG_TILE;
  const int q_last = min(q0 + rows, a.Sq) - 1;
  *hi = a.causal ? min(nkt - 1, q_last / WG_TILE) : nkt - 1;
  *lo = a.window > 0 ? max(0, q0 - a.window + 1) / WG_TILE : 0;
  if (q0 >= a.Sq) *lo = *hi + 1;
}

// The query tiles of WG_TILE rows some key of [k0, k0 + keys) is visible
// to; none where k0 is past Sk.
__device__ __forceinline__ void query_tiles(const BwdArgs& a, int k0,
                                            int keys, int* lo, int* hi) {
  const int nqt = (a.Sq + WG_TILE - 1) / WG_TILE;
  const int k_last = min(k0 + keys, a.Sk) - 1;
  *lo = a.causal ? min(nqt, k0 / WG_TILE) : 0;
  *hi = a.window > 0 ? min(nqt - 1, (k_last + a.window - 1) / WG_TILE)
                     : nqt - 1;
  if (k0 >= a.Sk) *lo = *hi + 1;
}

constexpr float LOG2E = 1.4426950408889634f;

// split3 of two values at once, packed (x0 in the low half): the parts
// lo, mid and hi of each, by two-wide conversions.
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& lo,
                                           uint32_t& mid, uint32_t& hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(r0 - mf.x, r1 - mf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The three bf16 parts (lo, mid, hi, as split_frag lays them out) of each
// k-slice of 16 of a [64 x 16 NK] accumulator, as the A fragments of the
// next wgmma.
template <int NK>
__device__ __forceinline__ void split_slices(const float (*c)[4],
                                             uint32_t (*f)[3][4]) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float* x = c[2 * kk + (r >> 1)] + 2 * (r & 1);
      split_pair(x[0], x[1], f[kk][0][r], f[kk][1][r], f[kk][2][r]);
    }
}

// p and ds * scale of one element (grad_score's steps) from its score's
// dot product s, dp, and its row's lse in base 2 (l2 = lse * log2(e)) and
// delta: p = 2^(s * c2 - l2), the scores' factor c2 = scale * log2(e)
// folded into one FFMA.  grad_soft: the same after the softcap.  Each
// kernel runs one or the other over a whole tile, behind a branch that is
// uniform over the CTA, so no element pays for a softcap it does not need.
__device__ __forceinline__ float grad_plain(const BwdArgs& a, float c2,
                                            float s, float dp, float l2,
                                            float delta, float* p_out) {
  const float p = exp2f(fmaf(s, c2, -l2));
  *p_out = p;
  return p * (dp - delta) * a.scale;
}

__device__ __forceinline__ float grad_soft(const BwdArgs& a, float s,
                                           float dp, float l2, float delta,
                                           float* p_out) {
  s = tanhf(s * a.scale / a.softcap) * a.softcap;
  const float u = s / a.softcap;
  const float p = exp2f(fmaf(s, LOG2E, -l2));
  *p_out = p;
  return p * (dp - delta) * (1.0f - u * u) * a.scale;
}

// acc += split(c) . X for the NK k-slices of 16 rows of X, a streamed
// tile at shared address `xs`: X read MN-major, its 64-column panels
// `panel` bytes apart; each slice's three parts, smallest first, on one B
// descriptor.  The parts stay live until the caller's wait.
template <int NK, int N>
__device__ __forceinline__ void split_wgmma(float (&acc)[N][4],
                                            uint32_t (*f)[3][4], uint32_t xs,
                                            int panel) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const uint64_t db = sw128_desc(xs + 16 * kk * WG_ROW, panel, 1024);
#pragma unroll
    for (int part = 0; part < 3; ++part) wgmma_rs(acc, f[kk][part], db);
  }
}

template <int NK>
__device__ __forceinline__ void keep_parts(uint32_t (*f)[3][4]) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
#pragma unroll
    for (int part = 0; part < 3; ++part)
#pragma unroll
      for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(f[kk][part][r]));
}

// K10 on wgmma: dq for one (batch, head, 128-row q block).  The producer
// warpgroup gives up its registers (setmaxnreg) and its first thread
// loads Q and dO of the block once and keeps the K/V tiles of the block's
// visible range in flight through a WG_STAGES-deep ring (a full mbarrier
// counting the TMA's bytes, an empty one that every consumer thread
// releases).  Consumer warpgroup w owns rows q0 + 64w .. +63 and, per
// tile, computes S = Q K^T and dP = dO V^T as wgmma from shared memory
// (K-major on both sides), ds * scale in registers (grad_score), and
// dQ += dS K with dS from registers (the accumulator's layout is the A
// fragment) in three bf16 parts and K read MN-major.  A tile no row of
// the warpgroup sees is released unread.
template <int HD>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap omap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, BwdArgs a) {
  using L = BwdLayout<HD>;
  extern __shared__ unsigned char dq_wg_smem[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * WG_STAGES];
  const uint32_t qs = (smem_addr(dq_wg_smem) + 1023u) & ~1023u;
  const uint32_t os = qs + L::OWN_BYTES;   // dO
  const uint32_t ring = os + L::OWN_BYTES;
  const uint32_t own = smem_addr(bars);
  const uint32_t full = own + 8, empty = own + 8 * (1 + WG_STAGES);

  const int nqb = (a.Sq + WG_OWN - 1) / WG_OWN;
  const int q0 = (nqb - 1 - (int)blockIdx.x) * WG_OWN;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  int lo, hi;
  key_tiles(a, q0, WG_OWN, &lo, &hi);

  if (threadIdx.x == 0) {
    mbar_init(own, 1);
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, WG_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= WG_CONSUMERS / 32) {  // the producer warpgroup
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == WG_CONSUMERS / 32 && lane == 0) {
      mbar_expect_tx(own, 2 * L::OWN_BYTES);
      for (int p = 0; p < L::PANELS; ++p) {
        tma_load(qs + p * L::OWN_PANEL, &qmap, own, 64 * p, q0, h, b);
        tma_load(os + p * L::OWN_PANEL, &omap, own, 64 * p, q0, h, b);
      }
      for (int kt = lo, i = 0; kt <= hi; ++kt, ++i) {
        const int s = i % WG_STAGES;
        mbar_wait(empty + 8 * s, ((i / WG_STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, L::STAGE_DQ);
        const uint32_t st = ring + s * L::STAGE_DQ;
        for (int p = 0; p < L::PANELS; ++p) {
          tma_load(st + p * L::TILE_PANEL, &kmap, full + 8 * s, 64 * p,
                   kt * WG_TILE, kvh, b);
          tma_load(st + L::TILE_BYTES + p * L::TILE_PANEL, &vmap,
                   full + 8 * s, 64 * p, kt * WG_TILE, kvh, b);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();

  const int wg = warp / 4, g = lane >> 2, t = lane & 3;
  const int qw = q0 + 64 * wg;  // this warpgroup's first row
  const int row0 = qw + (warp % 4) * 16 + g, row1 = row0 + 8;
  int lo_w, hi_w;
  key_tiles(a, qw, 64, &lo_w, &hi_w);
  const long long bh = ((long long)b * a.H + h) * a.ls;
  const float l2_0 = row0 < a.Sq ? a.lse[bh + row0] * LOG2E : 0.0f;
  const float l2_1 = row1 < a.Sq ? a.lse[bh + row1] * LOG2E : 0.0f;
  const float dl0 = row0 < a.Sq ? a.delta[bh + row0] : 0.0f;
  const float dl1 = row1 < a.Sq ? a.delta[bh + row1] : 0.0f;
  const float c2 = a.scale * LOG2E;

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  // The dQ product of a tile stays in flight while the next tile's
  // scores are issued; one wait then covers both, and the tile's stage
  // (pend) is released after it.
  uint32_t f[WG_TILE / 16][3][4];  // dS's parts, live until that wait
  int pend = -1;
  auto settle = [&]() {
    wgmma_wait_all();
    keep_parts<WG_TILE / 16>(f);
    fence_acc(acc);
    if (pend >= 0) mbar_arrive(empty + 8 * pend);
    pend = -1;
  };
  mbar_wait(own, 0);
  for (int kt = lo, i = 0; kt <= hi; ++kt, ++i) {
    const int s = i % WG_STAGES;
    mbar_wait(full + 8 * s, (i / WG_STAGES) & 1);
    if (kt < lo_w || kt > hi_w) {  // hidden from every row of this group
      if (pend >= 0) settle();
      mbar_arrive(empty + 8 * s);
      continue;
    }
    const int k0 = kt * WG_TILE;
    const uint32_t ks = ring + s * L::STAGE_DQ, vs = ks + L::TILE_BYTES;

    // s = q . k^T and dp = do . v^T: this warpgroup's 64 rows x 64 keys
    float sc[WG_TILE / 8][4], dp[WG_TILE / 8][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk / 4) * L::OWN_PANEL + wg * 64 * WG_ROW +
                           (kk % 4) * 32;
      const uint32_t toff = (kk / 4) * L::TILE_PANEL + (kk % 4) * 32;
      wgmma_ss(sc, sw128_desc(qs + off, 16, 1024),
               sw128_desc(ks + toff, 16, 1024), kk);
      wgmma_ss(dp, sw128_desc(os + off, 16, 1024),
               sw128_desc(vs + toff, 16, 1024), kk);
    }
    wgmma_commit();
    settle();
    fence_acc(sc);
    fence_acc(dp);

    // ds * scale in place of s; zero where masked
    float p;
    if (a.softcap == 0.0f) {
#pragma unroll
      for (int j = 0; j < WG_TILE / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[j][e] = grad_plain(a, c2, sc[j][e], dp[j][e],
                                e < 2 ? l2_0 : l2_1, e < 2 ? dl0 : dl1, &p);
    } else {
#pragma unroll
      for (int j = 0; j < WG_TILE / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[j][e] = grad_soft(a, sc[j][e], dp[j][e], e < 2 ? l2_0 : l2_1,
                               e < 2 ? dl0 : dl1, &p);
    }
    const bool whole = qw + 64 <= a.Sq && k0 + WG_TILE <= a.Sk &&
                       (!a.causal || k0 + WG_TILE - 1 <= qw) &&
                       (a.window == 0 || qw + 63 - k0 < a.window);
    if (!whole) {
#pragma unroll
      for (int j = 0; j < WG_TILE / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(a, e < 2 ? row0 : row1, k0 + j * 8 + 2 * t + (e & 1)))
            sc[j][e] = 0.0f;
    }

    // dq += ds . k, ds in three parts a k-slice, K read MN-major; left
    // in flight
    split_slices<WG_TILE / 16>(sc, f);
    fence_acc(acc);
    wgmma_fence();
    split_wgmma<WG_TILE / 16>(acc, f, ks, L::TILE_PANEL);
    wgmma_commit();
    pend = s;
  }
  settle();

#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (row0 < a.Sq)
      store_pair<bf16>(a.dq, a.s + DQ_, b, h, row0, col, acc[n][0],
                       acc[n][1], a.f32_out);
    if (row1 < a.Sq)
      store_pair<bf16>(a.dq, a.s + DQ_, b, h, row1, col, acc[n][2],
                       acc[n][3], a.f32_out);
  }
}

// K11 on wgmma: dk and dv for 128 keys of one (batch, query head).  The
// producer loads K and V of the block once and keeps the query tiles of
// the block's visible range (Q, dO, and the rows' lse and delta by a bulk
// copy) in flight through the ring.  Consumer warpgroup w owns keys k0 +
// 64w .. +63 and, per tile of 64 query rows, computes S^T = K Q^T and dP^T = V dO^T as wgmma from shared memory (keys are the
// M dimension, K-major on both sides), p^T and ds^T * scale in registers,
// then dV += P^T dO and dK += dS^T Q with P^T and dS^T from registers in
// three bf16 parts and dO and Q read MN-major.
template <int HD>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap omap, BwdArgs a) {
  using L = BwdLayout<HD>;
  extern __shared__ unsigned char dkv_wg_smem[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * WG_STAGES];
  const uint32_t base = smem_addr(dkv_wg_smem);
  const uint32_t ks = (base + 1023u) & ~1023u;
  const uint32_t vs = ks + L::OWN_BYTES;
  const uint32_t ring = vs + L::OWN_BYTES;
  const uint32_t own = smem_addr(bars);
  const uint32_t full = own + 8, empty = own + 8 * (1 + WG_STAGES);

  const int k0 = blockIdx.x * WG_OWN;  // causal: the first keys see most rows
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const long long bh = ((long long)b * a.H + h) * a.ls;
  int lo, hi;
  query_tiles(a, k0, WG_OWN, &lo, &hi);

  if (threadIdx.x == 0) {
    mbar_init(own, 1);
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, WG_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= WG_CONSUMERS / 32) {  // the producer warpgroup
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == WG_CONSUMERS / 32 && lane == 0) {
      mbar_expect_tx(own, 2 * L::OWN_BYTES);
      for (int p = 0; p < L::PANELS; ++p) {
        tma_load(ks + p * L::OWN_PANEL, &kmap, own, 64 * p, k0, kvh, b);
        tma_load(vs + p * L::OWN_PANEL, &vmap, own, 64 * p, k0, kvh, b);
      }
      for (int qt = lo, i = 0; qt <= hi; ++qt, ++i) {
        const int s = i % WG_STAGES;
        mbar_wait(empty + 8 * s, ((i / WG_STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * L::TILE_BYTES + L::STATS_BYTES);
        const uint32_t st = ring + s * L::STAGE_DKV;
        for (int p = 0; p < L::PANELS; ++p) {
          tma_load(st + p * L::TILE_PANEL, &qmap, full + 8 * s, 64 * p,
                   qt * WG_TILE, h, b);
          tma_load(st + L::TILE_BYTES + p * L::TILE_PANEL, &omap,
                   full + 8 * s, 64 * p, qt * WG_TILE, h, b);
        }
        // lse and delta rows are padded to a multiple of WG_TILE (a.ls)
        const uint32_t stats = st + 2 * L::TILE_BYTES;
        bulk_load(stats, a.lse + bh + qt * WG_TILE, WG_TILE * 4,
                  full + 8 * s);
        bulk_load(stats + WG_TILE * 4, a.delta + bh + qt * WG_TILE,
                  WG_TILE * 4, full + 8 * s);
      }
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();

  const int wg = warp / 4, g = lane >> 2, t = lane & 3;
  const int kw = k0 + 64 * wg;  // this warpgroup's first key
  const int key0 = kw + (warp % 4) * 16 + g, key1 = key0 + 8;
  const float c2 = a.scale * LOG2E;
  int lo_w, hi_w;
  query_tiles(a, kw, 64, &lo_w, &hi_w);

  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;

  // A tile's dV and dK products stay in flight while the next tile's
  // scores are issued; one wait then covers both, and the tile's stage
  // (pend) is released after it.
  constexpr int NK = WG_TILE / 16;  // k-slices of a tile's query rows
  uint32_t fp[NK][3][4], fd[NK][3][4];  // live until that wait
  int pend = -1;
  auto settle = [&]() {
    wgmma_wait_all();
    keep_parts<NK>(fp);
    keep_parts<NK>(fd);
    fence_acc(dv);
    fence_acc(dk);
    if (pend >= 0) mbar_arrive(empty + 8 * pend);
    pend = -1;
  };
  mbar_wait(own, 0);
  for (int qt = lo, i = 0; qt <= hi; ++qt, ++i) {
    const int s = i % WG_STAGES;
    mbar_wait(full + 8 * s, (i / WG_STAGES) & 1);
    if (qt < lo_w || qt > hi_w) {  // hidden from every key of this group
      if (pend >= 0) settle();
      mbar_arrive(empty + 8 * s);
      continue;
    }
    const int q0 = qt * WG_TILE;
    const uint32_t qs = ring + s * L::STAGE_DKV, os = qs + L::TILE_BYTES;
    const float* Lb = reinterpret_cast<const float*>(
        dkv_wg_smem + (os + L::TILE_BYTES - base));
    const float* Db = Lb + WG_TILE;

    // s^T = k . q^T and dp^T = v . do^T: 64 keys x 64 query rows
    float st[WG_TILE / 8][4], dpt[WG_TILE / 8][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk / 4) * L::OWN_PANEL + wg * 64 * WG_ROW +
                           (kk % 4) * 32;
      const uint32_t toff = (kk / 4) * L::TILE_PANEL + (kk % 4) * 32;
      wgmma_ss(st, sw128_desc(ks + off, 16, 1024),
               sw128_desc(qs + toff, 16, 1024), kk);
      wgmma_ss(dpt, sw128_desc(vs + off, 16, 1024),
               sw128_desc(os + toff, 16, 1024), kk);
    }
    wgmma_commit();
    settle();
    fence_acc(st);
    fence_acc(dpt);

    // p^T in place of s^T and ds^T * scale in place of dp^T
    if (a.softcap == 0.0f) {
#pragma unroll
      for (int j = 0; j < WG_TILE / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t + (e & 1);
          dpt[j][e] = grad_plain(a, c2, st[j][e], dpt[j][e], Lb[c] * LOG2E,
                                 Db[c], &st[j][e]);
        }
    } else {
#pragma unroll
      for (int j = 0; j < WG_TILE / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t + (e & 1);
          dpt[j][e] = grad_soft(a, st[j][e], dpt[j][e], Lb[c] * LOG2E,
                                Db[c], &st[j][e]);
        }
    }
    const bool whole = q0 + WG_TILE <= a.Sq && kw + 64 <= a.Sk &&
                       (!a.causal || kw + 63 <= q0) &&
                       (a.window == 0 || q0 + WG_TILE - 1 - kw < a.window);
    if (!whole) {
#pragma unroll
      for (int j = 0; j < WG_TILE / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(a, q0 + j * 8 + 2 * t + (e & 1), e < 2 ? key0 : key1))
            st[j][e] = dpt[j][e] = 0.0f;
    }

    // dv += p^T . do, then dk += ds^T . q: three parts a k-slice, do and q
    // read MN-major; left in flight
    split_slices<NK>(st, fp);
    fence_acc(dv);
    fence_acc(dk);
    wgmma_fence();
    split_wgmma<NK>(dv, fp, os, L::TILE_PANEL);
    split_slices<NK>(dpt, fd);
    wgmma_fence();
    split_wgmma<NK>(dk, fd, qs, L::TILE_PANEL);
    wgmma_commit();
    pend = s;
  }
  settle();

#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (key0 < a.Sk) {
      store_pair<bf16>(a.dk, a.s + DK_, b, h, key0, col, dk[n][0], dk[n][1],
                       a.f32_out);
      store_pair<bf16>(a.dv, a.s + DV_, b, h, key0, col, dv[n][0], dv[n][1],
                       a.f32_out);
    }
    if (key1 < a.Sk) {
      store_pair<bf16>(a.dk, a.s + DK_, b, h, key1, col, dk[n][2], dk[n][3],
                       a.f32_out);
      store_pair<bf16>(a.dv, a.s + DV_, b, h, key1, col, dv[n][2], dv[n][3],
                       a.f32_out);
    }
  }
}
#endif  // H2PIPE_HALF

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kern>
cudaError_t launch(Kern kern, size_t smem, dim3 grid, int threads,
                   const BwdArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

#ifndef H2PIPE_HALF
// f32 route; which 0: dq; 1: dk and dv
cudaError_t launch_f32(const BwdArgs& a, int which, cudaStream_t stream) {
  const bool wide = a.hd > 128 || a.hdv > 128;
  if (which == 0) {
    dim3 grid((a.Sq + BQ10 - 1) / BQ10, a.H, a.B);
    const size_t smem = smem_dq(a.hd, a.hdv);
    return wide ? launch(flash_bwd_dq_f32<8>, smem, grid, NT, a, stream)
                : launch(flash_bwd_dq_f32<4>, smem, grid, NT, a, stream);
  }
  dim3 grid((a.Sk + BK11 - 1) / BK11, a.H, a.B);
  const size_t smem = smem_dkv(a.hd, a.hdv);
  return wide ? launch(flash_bwd_dkv_f32<8>, smem, grid, NT, a, stream)
              : launch(flash_bwd_dkv_f32<4>, smem, grid, NT, a, stream);
}
#endif

// 16-bit route
template <int HD, int HDV>
cudaError_t launch_tc(const BwdArgs& a, int which, cudaStream_t stream) {
  constexpr int threads = 128 * col_split<HD, HDV>();
  if (which == 0) {
    dim3 grid((a.Sq + TC_BM - 1) / TC_BM, a.H, a.B);
    return launch(flash_bwd_dq_tc<T16, HD, HDV>, smem_tc<HD, HDV>(false),
                  grid, threads, a, stream);
  }
  dim3 grid((a.Sk + TC_BM - 1) / TC_BM, a.H, a.B);
  return launch(flash_bwd_dkv_tc<T16, HD, HDV>, smem_tc<HD, HDV>(true), grid,
                threads, a, stream);
}

// the tensor-core kernels at the widths of width() (mma_bf16.cuh); only
// the true columns of dq, dk and dv are written
template <int HD>
cudaError_t launch_tc_hdv(const BwdArgs& a, int which, cudaStream_t stream) {
  switch (width(a.hdv, WIDTHS_HDV)) {
    case 32: return launch_tc<HD, 32>(a, which, stream);
    case 64: return launch_tc<HD, 64>(a, which, stream);
    case 128: return launch_tc<HD, 128>(a, which, stream);
    case 256: return launch_tc<HD, 256>(a, which, stream);
    default: return cudaErrorInvalidValue;
  }
}

#ifndef H2PIPE_HALF
// The wgmma route; which 0: dq; 1: dk and dv.  The owned operands' boxes
// hold WG_OWN rows, the streamed ones' WG_TILE.
template <int HD>
cudaError_t launch_wgmma(const BwdArgs& a, int which, cudaStream_t stream) {
  using L = BwdLayout<HD>;
  const CUtensorMapDataType ty = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const long long* s = a.s;
  const int qrows = which == 0 ? WG_OWN : WG_TILE;
  const int krows = which == 0 ? WG_TILE : WG_OWN;
  CUtensorMap qm, om, km, vm;
  cudaError_t err = tensor_map(&qm, ty, a.q, a.B, a.H, a.Sq, HD, s[Q_],
                               s[Q_ + 1], s[Q_ + 2], qrows);
  if (err == cudaSuccess)
    err = tensor_map(&om, ty, a.dout, a.B, a.H, a.Sq, HD, s[DO_], s[DO_ + 1],
                     s[DO_ + 2], qrows);
  if (err == cudaSuccess)
    err = tensor_map(&km, ty, a.k, a.B, a.KV, a.Sk, HD, s[K_], s[K_ + 1],
                     s[K_ + 2], krows);
  if (err == cudaSuccess)
    err = tensor_map(&vm, ty, a.v, a.B, a.KV, a.Sk, HD, s[V_], s[V_ + 1],
                     s[V_ + 2], krows);
  if (err != cudaSuccess) return err;
  if (which == 0) {
    err = cudaFuncSetAttribute(flash_bwd_dq_wgmma<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::SMEM_DQ);
    if (err != cudaSuccess) return err;
    dim3 grid((a.Sq + WG_OWN - 1) / WG_OWN, a.H, a.B);
    flash_bwd_dq_wgmma<HD><<<grid, WG_THREADS, L::SMEM_DQ, stream>>>(
        qm, om, km, vm, a);
    return cudaGetLastError();
  }
  auto kern = flash_bwd_dkv_wgmma<HD>;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM_DKV);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sk + WG_OWN - 1) / WG_OWN, a.H, a.B);
  kern<<<grid, WG_THREADS, L::SMEM_DKV, stream>>>(km, vm, qm, om, a);
  return cudaGetLastError();
}
#endif

cudaError_t launch_16(const BwdArgs& a, int which, cudaStream_t stream) {
  switch (width(a.hd, WIDTHS_HD)) {
    case 32: return launch_tc_hdv<32>(a, which, stream);
    case 64: return launch_tc_hdv<64>(a, which, stream);
    case 128: return launch_tc_hdv<128>(a, which, stream);
    case 192: return launch_tc_hdv<192>(a, which, stream);
    case 256: return launch_tc_hdv<256>(a, which, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [B,H,Sq,hd], k [B,KV,Sk,hd], v [B,KV,Sk,hd_v], do [B,H,Sq,hd_v],
// dq [B,H,Sq,hd], dk [B,H,Sk,hd] and dv [B,H,Sk,hd_v] (per query head),
// given by their element strides over (batch, head, seq) in `strides` (q,
// k, v, do, dq, dk, dv in turn; the last dim contiguous); lse and delta
// [B,H,Sq] f32, contiguous (route 2: [B,H,Sqp], Sqp = Sq rounded up to a
// multiple of 64, past Sq never read as a row's own).  which 0 launches
// K10 (writes dq), 1 launches K11 (writes dk and dv).  dtype 0: bf16
// operands and outputs; 1: f32 operands and outputs; 2: bf16 operands,
// f32 outputs (the tensor-core kernels' sums before their rounding); 3
// and 4: f16 operands, f16 and f32 outputs.  Codes 0-2 run in the bf16
// library, 3 and 4 in the f16 one (DTYPE16).  route (ops._BWD_ROUTES, as
// ops.flash_bwd_route picks it): 0 the 16-bit operands on mma.sync, at
// the widths of width() (hd and hd_v: multiples of 8 from 8 to 256); 1
// f32 on the CUDA cores (dtype 1 only); 2 bf16 operands on wgmma and TMA
// (dtype 0 or 2, hd = hd_v in {64, 128}; the bf16 library only).  Any
// other pairing is refused.  Returns a cudaError_t.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, void* dq, void* dk,
                               void* dv, int which, int dtype, int route,
                               int B, int H, int KV, int Sq, int Sk, int hd,
                               int hd_v, const long long* strides,
                               int causal, int window, float softcap,
                               float scale, cudaStream_t stream) {
  const bool t16 = dtype == DTYPE16 || dtype == DTYPE16_F32;
  if (KV < 1 || H % KV != 0 || window < 0 || !head_dim_ok(hd) ||
      !head_dim_ok(hd_v) || (which != 0 && which != 1) ||
      (route == 0 && !t16) || (route == 1 && dtype != 1) ||
      (route == 2 && (!t16 || hd != hd_v || (hd != 64 && hd != 128))) ||
      route < 0 || route > 2)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || Sq == 0 || Sk == 0) return (int)cudaSuccess;
  BwdArgs a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  a.dq = dq; a.dk = dk; a.dv = dv;
  for (int i = 0; i < 21; ++i) a.s[i] = strides[i];
  a.B = B; a.H = H; a.KV = KV; a.Sq = Sq; a.Sk = Sk; a.hd = hd;
  a.hdv = hd_v; a.causal = causal; a.window = window;
  a.softcap = softcap; a.scale = scale;
  a.f32_out = dtype == DTYPE16_F32;
  a.ls = Sq;
  if (route == 0) return (int)launch_16(a, which, stream);
#ifndef H2PIPE_HALF
  if (route == 1) return (int)launch_f32(a, which, stream);
  a.ls = (Sq + WG_TILE - 1) / WG_TILE * WG_TILE;
  return (int)(hd == 64 ? launch_wgmma<64>(a, which, stream)
                        : launch_wgmma<128>(a, which, stream));
#else
  return (int)cudaErrorInvalidValue;  // f32 and wgmma: the bf16 library's
#endif
}

// The dynamic shared memory a wgmma-route launch asks for (which 0: dq,
// 1: dk and dv) at hd = hd_v in {64, 128}, or -1: ops.bwd_wgmma_smem's
// bytes, which the card tests hold to these.
int flash_attention_bwd_wgmma_smem(int which, int hd) {
#ifndef H2PIPE_HALF
  if (hd == 64) return which == 0 ? BwdLayout<64>::SMEM_DQ
                                  : BwdLayout<64>::SMEM_DKV;
  if (hd == 128) return which == 0 ? BwdLayout<128>::SMEM_DQ
                                   : BwdLayout<128>::SMEM_DKV;
#endif
  return -1;
}

}  // extern "C"
