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
// 64-row q block) and walks its K/V tiles in a loop, with (acc, m, l) in
// registers.  Causal q blocks are issued heaviest first.
//
// A K tile that the causal or window mask hides entirely from every row
// of the block is skipped.  That is exact: in such a tile every score is
// -1e30, so m_new = m, alpha = exp(0) = 1 and every p is zeroed, which
// leaves m, l and acc bit for bit as they were.
//
// Two kernels:
//   flash_fwd_bf16<HD, HDV>  the main path.  Four warps, 16 query rows
//     each.  The Q tile (64 rows) stays in shared memory; K/V tiles of 64
//     keys pass through a ring of two shared-memory buffers filled with
//     cp.async, so tile kt+1 is in flight while tile kt is consumed.  Rows
//     are padded by 8 elements so that ldmatrix hits distinct banks.  QK^T
//     and PV run on the tensor cores as mma.sync m16n8k16 (bf16 in, f32
//     accumulate), their operands loaded with ldmatrix (.trans for V).
//     The score accumulator of QK^T is laid out as the A operand of PV, so
//     p goes from registers to the tensor cores rounded to bf16, without
//     shared memory.  Tiles that every row sees whole skip the mask.
//   flash_fwd_f32  f32 operands, for tight tests: the same tiles and
//     steps on the CUDA cores with fmaf, scores and acc in shared memory.
//
// What bounds it on an H100: at the Phi-4-mini prefill shape (B=4, H=24,
// KV=8, S=512, hd=128, causal) the call moves 33.7 MB (q, k, v, o, lse
// once) against 6.4 GFLOP, so bytes bound it (about 10 us at 3.35 TB/s;
// the FLOPs alone take 6.5 us at 989 TFLOP/s).  At S = 2048 the FLOPs
// bound it (103 GFLOP, 104 us).  Neither the tensor cores nor the loads
// hold this kernel back: the per-element work between the two products
// (scale, softcap, mask, expf, row sums) on the same warps does.  So the
// softcap and the mask run as separate loops behind branches that are
// uniform over the CTA, and only the tiles on the causal diagonal or the
// window's edge evaluate the mask.  It issues mma.sync, not wgmma; PERF.md
// has its times against the bound and against the library's attention.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace h2pipe_mma;

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;     // query rows per CTA
constexpr int BK = 64;     // keys per K/V tile, bf16 kernel
constexpr int NT = 128;    // threads, bf16 kernel: 4 warps x 16 rows
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

// The K tiles of `bk` keys that some row of the q block [q0, q0 + BQ)
// can see; the others are skipped (exact, see the header).
__device__ __forceinline__ void k_tiles(const FlashArgs& a, int q0, int bk,
                                        int* lo, int* hi) {
  int nkb = (a.Sk + bk - 1) / bk;
  int q_last = min(q0 + BQ, a.Sq) - 1;
  *hi = a.causal ? min(nkb - 1, q_last / bk) : nkb - 1;
  *lo = a.window > 0 ? max(0, q0 - a.window + 1) / bk : 0;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

// pack_bf16, cp.async, ldmatrix, mma_bf16 and load_tile: mma_bf16.cuh

template <int HD, int HDV>
size_t smem_bf16() {
  return ((size_t)BQ * (HD + 8) +
          2 * ((size_t)BK * (HD + 8) + (size_t)BK * (HDV + 8))) *
         sizeof(bf16);
}

template <int HD, int HDV>
__global__ void __launch_bounds__(NT) flash_fwd_bf16(FlashArgs a) {
  constexpr int LQ = HD + 8, LV = HDV + 8;  // padded row strides
  extern __shared__ __align__(16) unsigned char smem_bf16_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_bf16_raw);  // [BQ][LQ]
  bf16* Ks = Qs + BQ * LQ;                            // 2 x [BK][LQ]
  bf16* Vs = Ks + 2 * BK * LQ;                        // 2 x [BK][LV]

  const int nqb = (a.Sq + BQ - 1) / BQ;
  const int q0 = (nqb - 1 - (int)blockIdx.x) * BQ;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.qs_b + h * a.qs_h;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.ks_b + kvh * a.ks_h;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.vs_b + kvh * a.vs_h;

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
  k_tiles(a, q0, BK, &lo, &hi);
  // the K/V tiles go through a ring of two buffers: tile kt+1 is copied
  // (cp.async) while tile kt is consumed
  load_tile<HD, NT>(Qs, LQ, q, a.qs_s, q0, a.Sq, BQ);
  if (lo <= hi) {
    load_tile<HD, NT>(Ks, LQ, k, a.ks_s, lo * BK, a.Sk, BK);
    load_tile<HDV, NT>(Vs, LV, v, a.vs_s, lo * BK, a.Sk, BK);
  }
  cp_async_commit();
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * BK, buf = (kt - lo) & 1;
    if (kt < hi) {
      load_tile<HD, NT>(Ks + (buf ^ 1) * BK * LQ, LQ, k, a.ks_s, k0 + BK,
                        a.Sk, BK);
      load_tile<HDV, NT>(Vs + (buf ^ 1) * BK * LV, LV, v, a.vs_s, k0 + BK,
                         a.Sk, BK);
    }
    cp_async_commit();
    cp_async_wait1();  // Q and tile kt have landed
    __syncthreads();
    const bf16* Kb = Ks + buf * BK * LQ;
    const bf16* Vb = Vs + buf * BK * LV;

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
        mma_bf16(s[j], af, bf[0], bf[1]);
        mma_bf16(s[j + 1], af, bf[2], bf[3]);
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

    // acc += bf16(p) . v: n-tiles 2kk and 2kk+1 of s are the A fragment
    // of keys 16kk .. 16kk+15
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pf[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < HDV / 8; n += 2) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, Vb + (kk * 16 + lr) * LV + n * 8 + lc);
        mma_bf16(o[n], pf, vf[0], vf[1]);
        mma_bf16(o[n + 1], pf, vf[2], vf[3]);
      }
    }
    m0 = mn0;
    m1 = mn1;
    __syncthreads();  // every warp is done with buffer `buf`
  }

  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  bf16* out = static_cast<bf16*>(a.o) + b * a.os_b + h * a.os_h;
#pragma unroll
  for (int n = 0; n < HDV / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (row0 < a.Sq)
      *reinterpret_cast<uint32_t*>(out + row0 * a.os_s + col) =
          pack_bf16(o[n][0] / d0, o[n][1] / d0);
    if (row1 < a.Sq)
      *reinterpret_cast<uint32_t*>(out + row1 * a.os_s + col) =
          pack_bf16(o[n][2] / d1, o[n][3] / d1);
  }
  if (t == 0) {
    float* L = a.lse + ((long long)b * a.H + h) * a.Sq;
    if (row0 < a.Sq) L[row0] = m0 + logf(d0);
    if (row1 < a.Sq) L[row1] = m1 + logf(d1);
  }
}

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
  k_tiles(a, q0, BK32, &lo, &hi);
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

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int HD, int HDV>
cudaError_t launch_bf16(const FlashArgs& a, dim3 grid, cudaStream_t stream) {
  const size_t smem = smem_bf16<HD, HDV>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<HD, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  flash_fwd_bf16<HD, HDV><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bf16_hdv(const FlashArgs& a, dim3 grid,
                            cudaStream_t stream) {
  switch (a.hdv) {
    case 32: return launch_bf16<HD, 32>(a, grid, stream);
    case 64: return launch_bf16<HD, 64>(a, grid, stream);
    case 128: return launch_bf16<HD, 128>(a, grid, stream);
    case 256: return launch_bf16<HD, 256>(a, grid, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [B,H,Sq,hd], k [B,KV,Sk,hd], v [B,KV,Sk,hd_v], o [B,H,Sq,hd_v] given
// by their element strides over (batch, head, seq) in `strides` (q, k, v,
// o in turn; the last dim contiguous); lse [B,H,Sq] f32, contiguous.
// dtype 0: bf16 operands and o; 1: f32.  Returns a cudaError_t.
int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               void* o, float* lse, int dtype, int B, int H,
                               int KV, int Sq, int Sk, int hd, int hd_v,
                               const long long* strides, int causal,
                               int window, float softcap, float scale,
                               cudaStream_t stream) {
  if (KV < 1 || H % KV != 0 || window < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || Sq == 0) return (int)cudaSuccess;
  FlashArgs a{q, k, v, o, lse,
              strides[0], strides[1], strides[2], strides[3], strides[4],
              strides[5], strides[6], strides[7], strides[8], strides[9],
              strides[10], strides[11],
              B, H, KV, Sq, Sk, hd, hd_v, causal, window, softcap, scale};
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  if (dtype == 1) {
    const size_t smem = smem_f32(hd, hd_v);
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_f32<<<grid, NT32, smem, stream>>>(a);
    return (int)cudaGetLastError();
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32: return (int)launch_bf16_hdv<32>(a, grid, stream);
    case 64: return (int)launch_bf16_hdv<64>(a, grid, stream);
    case 128: return (int)launch_bf16_hdv<128>(a, grid, stream);
    case 192: return (int)launch_bf16_hdv<192>(a, grid, stream);
    case 256: return (int)launch_bf16_hdv<256>(a, grid, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
