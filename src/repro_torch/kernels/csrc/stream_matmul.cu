// int8 matmul with the weight K-blocks streamed through a ring, requant
// epilogue fused: the 1x1 fc heads.
//
// Replaces the Pallas kernels of repro/kernels/stream_matmul/kernel.py:
//   _mm_kernel         ("pinned": one K block; "stream": K blocks, depth 2)
//   _mm_manual_kernel  ("fifo": an explicit n_buffers-deep ring)
// as ONE kernel whose ring depth and K-block size are parameters.
//
// One CTA covers an 8-row x 32-column output tile.  Its 8 rows of x stay in
// shared memory for the whole K loop (as the TPU kernel keeps the (bm, K)
// x block resident).  W's [bk, 32] K-blocks arrive through a ring of
// n_buffers shared-memory slots filled with cp.async; a slot is refilled
// with block k + n_buffers only after every thread has consumed block k
// (the credit rule of section V-A).  "pinned" is a single block holding
// all of K, so the whole W slice is resident.  The TPU block sizes of the
// engine table are accounting only; this kernel masks the ragged N and K
// edges itself.
//
// What bounds it on an H100: at the fc heads (batch 8, K <= 2048,
// N = 1000) it reads 2 MB of weights for 16 M multiply-adds, so the bytes
// bound it (about 0.6 us at 3.35 TB/s); with only ceil(N/32) = 32 CTAs and
// 4-byte copies it is further limited by the copy rate of those SMs and
// by launch latency.  Each thread does one output with scalar int32
// multiply-adds: the arithmetic is negligible at this size.
#include "common.cuh"

namespace {

using h2pipe::cp_async4;
using h2pipe::cp_async_commit;
using h2pipe::cp_async_wait;

constexpr int TN = 32;   // output columns per CTA
constexpr int TM = 8;    // output rows per CTA
constexpr int NT = TM * TN;
constexpr int QUADS = TN / 4;

struct MmArgs {
  const int8_t* x;
  const int8_t* w;
  const float* w_scale;
  const float* bias;
  float act_scale, inv_act;
  int8_t* out_q;
  float* out_f;
  int32_t* out_i32;
  int M, K, N, bk, n_buffers, relu;
};

// Copy W's K-block kb, columns n0..n0+31, into a [bk][32] slot: 4-byte
// cp.async copies when the rows are word-aligned (N % 4 == 0), plain byte
// copies otherwise (e.g. a 10-class head).  Either way the slot is read
// only after the next wait + barrier.
__device__ __forceinline__ void fill_block(const MmArgs& a, int kb, int n0,
                                           int* slot) {
  if (a.N & 3) {
    int8_t* sb = reinterpret_cast<int8_t*>(slot);
    for (int idx = threadIdx.x; idx < a.bk * TN; idx += NT) {
      int k = kb * a.bk + idx / TN, n = n0 + idx % TN;
      sb[idx] = (k < a.K && n < a.N) ? a.w[(size_t)k * a.N + n] : (int8_t)0;
    }
    return;
  }
  const int words = a.bk * QUADS;
  for (int idx = threadIdx.x; idx < words; idx += NT) {
    int kk = idx / QUADS, q = idx % QUADS;
    int k = kb * a.bk + kk, n = n0 + 4 * q;
    bool valid = k < a.K && n < a.N;
    const int8_t* src = valid ? a.w + (size_t)k * a.N + n : a.w;
    cp_async4(slot + idx, src, valid);
  }
}

__global__ void __launch_bounds__(NT) mm_kernel(MmArgs a) {
  extern __shared__ int smem[];
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM;
  const int mi = threadIdx.x / TN, ni = threadIdx.x % TN;
  const int nk = (a.K + a.bk - 1) / a.bk;
  const int nb = min(a.n_buffers, nk);
  const int slot_bytes = a.bk * TN;
  int8_t* xs = reinterpret_cast<int8_t*>(smem);          // [TM][K]
  int* ring = smem + (TM * a.K + 3) / 4;                  // [nb][bk][TN]

  for (int idx = threadIdx.x; idx < TM * a.K; idx += NT) {
    int m = idx / a.K, k = idx % a.K;
    xs[idx] = m0 + m < a.M ? a.x[(size_t)(m0 + m) * a.K + k] : (int8_t)0;
  }
  // warm-up: fill the prefetch window (one commit group per slot)
  for (int s = 0; s < nb; ++s) {
    fill_block(a, s, n0, ring + s * (slot_bytes / 4));
    cp_async_commit();
  }
  int acc = 0;
  const int8_t* xrow = xs + mi * a.K;
  for (int kb = 0; kb < nk; ++kb) {
    cp_async_wait(nb - 1);              // block kb has landed
    __syncthreads();
    int* slot = ring + (kb % nb) * (slot_bytes / 4);
    const int8_t* wb = reinterpret_cast<const int8_t*>(slot);
    int kend = min(a.bk, a.K - kb * a.bk);
    const int8_t* xk = xrow + kb * a.bk;
    for (int kk = 0; kk < kend; ++kk)
      acc += (int)xk[kk] * (int)wb[kk * TN + ni];
    __syncthreads();                    // slot consumed: its credit returns
    if (kb + nb < nk) fill_block(a, kb + nb, n0, slot);
    cp_async_commit();
  }
  int m = m0 + mi, n = n0 + ni;
  if (m >= a.M || n >= a.N) return;
  size_t off = (size_t)m * a.N + n;
  if (a.out_i32) {
    a.out_i32[off] = acc;
    return;
  }
  int8_t q;
  float y = h2pipe::requant(acc, a.w_scale[n], a.bias[n], a.act_scale,
                            a.inv_act, a.relu != 0, &q);
  a.out_q[off] = q;
  if (a.out_f) a.out_f[off] = y;
}

// Shared-memory bytes one CTA claims (ops.smem_bytes mirrors this).
long smem_bytes(int K, int bk, int n_buffers) {
  int nk = (K + bk - 1) / bk;
  int nb = n_buffers < nk ? n_buffers : nk;
  return (long)((TM * K + 3) / 4) * 4 + (long)nb * bk * TN;
}

}  // namespace

extern "C" {

// x: [M, K] int8 @ w: [K, N] int8, W's K-blocks of `bk` rows
// through an `n_buffers`-deep ring.  Exactly one of out_q (int8, fused
// requant; out_f optional) and out_i32 (raw sums) is set.
int stream_matmul_int8_launch(const int8_t* x, const int8_t* w,
                              const float* w_scale, const float* bias,
                              float act_scale, float inv_act, int8_t* out_q,
                              float* out_f, int32_t* out_i32, int M, int K,
                              int N, int bk,
                              int n_buffers, int relu, cudaStream_t stream) {
  if (bk < 1 || n_buffers < 1) return (int)cudaErrorInvalidValue;
  MmArgs a{x, w, w_scale, bias, act_scale, inv_act, out_q, out_f, out_i32,
           M, K, N, bk, n_buffers, relu};
  size_t smem = (size_t)smem_bytes(K, bk, n_buffers);
  cudaError_t err = cudaFuncSetAttribute(
      (void*)mm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
  mm_kernel<<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
