// int8 matmul with the weight K-blocks streamed through a ring, requant
// epilogue fused: the 1x1 fc heads.
//
// Replaces the Pallas kernels of repro/kernels/stream_matmul/kernel.py:
//   _mm_kernel         ("pinned": one K block; "stream": K blocks, depth 2)
//   _mm_manual_kernel  ("fifo": an explicit n_buffers-deep ring)
// as ONE kernel whose ring depth and K-block size are parameters.
//
// What bounds it on an H100.  At the fc heads (batch 8, K in 512..4096,
// N in 1000..4096) the weights are the work: 0.5 to 16.8 MB for 4 to 134 M
// multiply-adds, 0.15 to 5 us at 3.35 TB/s.  So the design spreads the
// weight stream over the whole card and keeps it in flight:
//  * Work split.  A CTA covers a tile of tn in {32, 64} output columns, a
//    range of K and a tile of 8 rows of x; ops.mm_plan picks tn and the K
//    split (1..8) so that every fc head of the six CNN configs launches a
//    wave of 132 SMs or more (N = 1000: 32 x 8 CTAs).  The K split runs
//    over a thread-block cluster (cudaLaunchKernelEx with a cluster
//    dimension): each CTA sums its K range into int32, then adds its sums
//    into the leader's (rank 0) shared memory through distributed shared
//    memory (atomics on cluster.map_shared_rank), and the leader runs the
//    requant epilogue.  Integer sums are exact in any order; no workspace,
//    one launch.  The cluster barrier that makes the leader's zeroed sums
//    visible is split: arrive at the start, wait just before the adds.
//  * The ring.  Four producer warps stream the CTA's K range in K-blocks of
//    kblk rows x tn columns through nb slots with cp.async (16 bytes where
//    N % 16 == 0, 8 where N % 8 == 0 as at N = 1000, 4, or byte loads where
//    N % 4 != 0, as for a 10-class head): "pinned" is one block, so the
//    CTA's whole slice is resident; "stream" depth 2; "fifo" n_buffers.  A
//    slot has a full mbarrier (the producer's copies landed) and an empty
//    one (every consumer warp has read it); a slot is refilled only after
//    its empty barrier completes: the credit rule of section V-A.  The x
//    rows of the CTA's K range come with the first block (16-byte copies
//    where K % 16 == 0).
//  * The MACs.  128 consumer threads (64 for a short K range) each own 4
//    columns and a share of the
//    block's K words: per 4 K rows they transpose the 4x4 weight bytes with
//    byte permutes and take one dp4a per row of x and column; the shares
//    are summed by warp shuffles, then across warps in shared memory.
//    About 2.5 MACs an instruction: at 134 M MACs (VGG-16's fc1) about
//    2 us on 132 SMs, below the bytes.
// The TPU block sizes of the engine table are accounting only; the kernel
// masks the ragged M, N and K edges itself.
//
// The float modes are mm_float<TX, TW, TN>: every operand pair over f32,
// bf16, f16 and int8 but int8 x int8 (mm_kernel's), f32 sums as the
// reference's _acc_dtype takes them, the result in the type
// jnp.promote_types gives (Promoted below: f16 x f16 -> f16, f16 x bf16
// -> f32, int8 x bf16 -> bf16, int8 x f16 -> f16, any with f32 -> f32),
// with the same work split, ring and credit rule as mm_kernel and a plan
// of their own (ops.mm_float_plan, layout mm_float_layout below):
//  * A slot holds a K block of the weights [kblk][tn] and of x [TM][kblk];
//    both stream through the ring (cp.async of 16, 8 or 4 bytes, or plain
//    copies of one element where a row of bf16, f16 or int8 values is not
//    a multiple of 4 bytes), zeros past M, N and the rank's K range.
//  * The products are FFMA on the CUDA cores, never TF32: each of 128
//    consumer threads owns 4 columns x TM rows and a share of the block's
//    K rows, 4 at a time (a bf16, f16 or int8 value widens to f32 exactly
//    as it is read from its slot, so every product is exact in f32 before
//    its one rounding, as in the reference).  Shares are summed by
//    shuffles, then across warps in shared memory; the leader of the
//    cluster reads every rank's sums through distributed shared memory in
//    rank order (deterministic) and writes the result in its type.
//  * What bounds it: the weights' bytes at the fc-head shapes.  At M = 8
//    a weight element takes 16 FLOP: 8 a byte in bf16 and 4 in f32,
//    below the 20 a byte that 67 TFLOP/s FP32 over 3.35 TB/s would need.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <type_traits>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int TM = 8;            // rows of x a CTA
constexpr int NPROD = 128;       // producer threads, after the consumers'
// consumer threads: 128 (warps 0..3), or 64 where a CTA's K range is at
// most SHORT_RANGE rows (ops.mm_consumers): the sum of the shares, not
// the MACs, takes the time there
constexpr int SHORT_RANGE = 256;
__host__ __device__ constexpr int consumers(int kr) {
  return kr <= SHORT_RANGE ? 64 : 128;
}
constexpr int MAX_SPLIT = 8;     // CTAs a cluster, at most (portable)

struct MmArgs {
  const int8_t* x;
  const int8_t* w;
  const float* w_scale;
  const float* bias;
  float act_scale, inv_act;
  int8_t* out_q;
  float* out_f;
  int32_t* out_i32;
  int M, K, N, relu;
  int tn, kr, kblk, nb, vec, xvec;   // the plan (ops.mm_plan)
  int xr, srow;                      // the layout (mm_layout() below)
};

struct MmLayout {
  int xr;     // bytes of one row of the x tile: kr rounded up to 16
  int srow;   // bytes of one slot row: tn + 16 (a gap for the banks)
  long smem;
};

// ops.mm_layout mirrors this.  Shared memory of one CTA: the full and empty
// mbarriers of the nb slots, the x tile [TM][xr], the slots [nb][kblk]
// [srow], the consumer warps' sums [warps][TM][tn] int32 and the
// cluster's sums [TM][tn] int32 (the leader's are the result).
MmLayout mm_layout(int tn, int kr, int kblk, int nb) {
  MmLayout L;
  L.xr = (kr + 15) / 16 * 16;
  L.srow = tn + 16;
  L.smem = 16L * nb + (long)TM * L.xr + (long)nb * kblk * L.srow +
           (long)(consumers(kr) / 32 + 1) * TM * tn * 4;
  return L;
}

// The cluster barrier in its two halves: arrive (release) early, wait
// (acquire) where the other CTAs' shared memory is next touched.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The producer warps: the x rows of the K range [k0, k1), then block by
// block the weight rows of the range, columns n0 .. n0 + tn, into the
// ring; zeros past M, past N and outside the range.
template <int NCONS>
__device__ __forceinline__ void mm_produce(const MmArgs& a, int m0, int n0,
                                           int k0, int k1, int nkb,
                                           uint64_t* full, uint64_t* empty,
                                           int8_t* xs, unsigned char* ring) {
  const int pt = threadIdx.x - NCONS;
  // x's rows, then the blocks; byte loads (N or K not a multiple of 4)
  // are plain stores, released by a plain arrive once this thread's
  // copies have landed
  const bool plain = a.vec == 1 || a.xvec == 1;
  {
    const int per_row = a.xr / a.xvec;
    for (int idx = pt; idx < TM * per_row; idx += NPROD) {
      const int m = idx / per_row, k = k0 + (idx - m * per_row) * a.xvec;
      const bool ok = m0 + m < a.M && k < k1;
      int8_t* dst = xs + m * a.xr + (k - k0);
      const int8_t* src = ok ? a.x + (size_t)(m0 + m) * a.K + k : a.x;
      if (a.xvec == 16)
        h2pipe::cp_async16(dst, src, ok);
      else if (a.xvec == 4)
        h2pipe::cp_async4(dst, src, ok);
      else
        *dst = ok ? *src : (int8_t)0;
    }
  }
  h2pipe::RingPos pos;
  // copies a row: tn / vec, a power of two
  const int row_shift = __ffs(a.tn / a.vec) - 1;
  const int row_mask = a.tn / a.vec - 1;
  for (int kb = 0; kb < nkb; ++kb) {
    h2pipe::mbar_wait(empty + pos.slot, pos.phase ^ 1);
    unsigned char* slot = ring + (size_t)pos.slot * a.kblk * a.srow;
    const int kbase = k0 + kb * a.kblk;
    for (int idx = pt; idx < a.kblk << row_shift; idx += NPROD) {
      const int r = idx >> row_shift, c = (idx & row_mask) * a.vec;
      const int k = kbase + r, n = n0 + c;
      const bool ok = k < k1 && n < a.N;
      unsigned char* dst = slot + r * a.srow + c;
      const int8_t* src = ok ? a.w + (size_t)k * a.N + n : a.w;
      if (a.vec == 16)
        h2pipe::cp_async16(dst, src, ok);
      else if (a.vec == 8)
        h2pipe::cp_async8(dst, src, ok);
      else if (a.vec == 4)
        h2pipe::cp_async4(dst, src, ok);
      else
        *dst = ok ? (unsigned char)*src : 0;
    }
    if (plain) {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      h2pipe::mbar_arrive(full + pos.slot);
    } else {
      h2pipe::cp_async_mbar_arrive(full + pos.slot);
    }
    pos.next(a.nb);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A CTA: (tile of TN columns, rank in the K split, tile of TM rows).
template <int TN, int NCONS>
__global__ void __launch_bounds__(NCONS + NPROD) mm_kernel(MmArgs a) {
  constexpr int NT = NCONS + NPROD, NWARPS = NCONS / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + a.nb;
  int8_t* xs = reinterpret_cast<int8_t*>(smem + 16 * a.nb);
  unsigned char* ring = smem + 16 * a.nb + TM * a.xr;
  int* red = reinterpret_cast<int*>(ring + (size_t)a.nb * a.kblk * a.srow);
  int* part = red + NWARPS * TM * TN;                // [TM][TN]

  const int n0 = blockIdx.x * TN, m0 = blockIdx.z * TM;
  const int k0 = min(a.K, rank * a.kr), k1 = min(a.K, k0 + a.kr);
  const int nkb = (k1 - k0 + a.kblk - 1) / a.kblk;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < a.nb; ++s) {
      h2pipe::mbar_init(full + s, NPROD);            // every producer thread
      h2pipe::mbar_init(empty + s, NCONS / 32);      // every consumer warp
    }
    h2pipe::mbar_init_fence();
  }
  for (int o = tid; o < TM * TN; o += NT) part[o] = 0;
  __syncthreads();
  // the leader's sums are zero before any rank adds into them; the wait
  // comes just before the adds
  cluster_arrive();

  constexpr int quads = TN / 4, ways = NCONS / quads;
  const int quad = tid % quads, way = tid / quads;
  if (tid >= NCONS) {
    mm_produce<NCONS>(a, m0, n0, k0, k1, nkb, full, empty, xs, ring);
  } else {
    int acc[TM][4];
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[m][n] = 0;
    h2pipe::RingPos pos;
    for (int kb = 0; kb < nkb; ++kb) {
      h2pipe::mbar_wait(full + pos.slot, pos.phase);
      const unsigned char* slot = ring + (size_t)pos.slot * a.kblk * a.srow;
      const int rows = min(a.kblk, k1 - k0 - kb * a.kblk);
      const int8_t* xk = xs + kb * a.kblk;
      for (int k4 = way; 4 * k4 < rows; k4 += ways) {
        const unsigned char* wp = slot + 4 * k4 * a.srow + 4 * quad;
        uint32_t in[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          in[e] = *reinterpret_cast<const uint32_t*>(wp + e * a.srow);
        // rows are K, bytes columns: word n of the transpose holds the 4 K
        // bytes of column 4 * quad + n
        const uint32_t t0 = __byte_perm(in[0], in[1], 0x5140);
        const uint32_t t1 = __byte_perm(in[2], in[3], 0x5140);
        const uint32_t t2 = __byte_perm(in[0], in[1], 0x7362);
        const uint32_t t3 = __byte_perm(in[2], in[3], 0x7362);
        const int bw[4] = {(int)__byte_perm(t0, t1, 0x5410),
                           (int)__byte_perm(t0, t1, 0x7632),
                           (int)__byte_perm(t2, t3, 0x5410),
                           (int)__byte_perm(t2, t3, 0x7632)};
#pragma unroll
        for (int m = 0; m < TM; ++m) {
          const int xv = *reinterpret_cast<const int*>(xk + m * a.xr + 4 * k4);
#pragma unroll
          for (int n = 0; n < 4; ++n) acc[m][n] = __dp4a(xv, bw[n], acc[m][n]);
        }
      }
      __syncwarp();
      if ((tid & 31) == 0) h2pipe::mbar_arrive(empty + pos.slot);
      pos.next(a.nb);
    }
    // the shares of K words: over the ways of a warp by shuffles, then
    // over the warps in shared memory, then into the leader's sums
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int off = quads; off < 32; off <<= 1)
          acc[m][n] += __shfl_xor_sync(0xffffffffu, acc[m][n], off);
    const int lane = tid & 31, warp = tid >> 5;
    if (lane < quads)
#pragma unroll
      for (int m = 0; m < TM; ++m)
        *reinterpret_cast<int4*>(red + (warp * TM + m) * TN + 4 * lane) =
            make_int4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    asm volatile("bar.sync 1, %0;\n" ::"r"(NCONS) : "memory");
    cluster_wait();
    int* lead = cluster.map_shared_rank(part, 0);
    for (int o = tid; o < TM * TN; o += NCONS) {
      int s = 0;
#pragma unroll
      for (int wp = 0; wp < NWARPS; ++wp) s += red[wp * TM * TN + o];
      atomicAdd(lead + o, s);
    }
  }
  if (tid >= NCONS) cluster_wait();
  cluster.sync();  // every rank's sums are in the leader's
  if (rank != 0 || tid >= NCONS) return;
  for (int o = tid; o < TM * TN; o += NCONS) {
    const int m = o / TN, c = o - m * TN;
    const int row = m0 + m, n = n0 + c;
    if (row >= a.M || n >= a.N) continue;
    const size_t off = (size_t)row * a.N + n;
    if (a.out_i32) {
      a.out_i32[off] = part[o];
      continue;
    }
    int8_t q;
    const float y = h2pipe::requant(part[o], a.w_scale[n], a.bias[n],
                                    a.act_scale, a.inv_act, a.relu != 0, &q);
    a.out_q[off] = q;
    if (a.out_f) a.out_f[off] = y;
  }
}


// ---------------------------------------------------------------------------
// The float modes: mm_float<TX, TW, TN>
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int FCONS = 128;       // consumer threads (warps 0..3)

// Four consecutive values of type T at p (16 bytes of f32, 8 of bf16 or
// f16, 4 of int8), widened to f32 exactly.
template <typename T>
__device__ __forceinline__ void load4(const unsigned char* p, float v[4]) {
  if constexpr (std::is_same<T, float>::value) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else if constexpr (std::is_same<T, bf16>::value) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(u.x << 16);
    v[1] = __uint_as_float(u.x & 0xffff0000u);
    v[2] = __uint_as_float(u.y << 16);
    v[3] = __uint_as_float(u.y & 0xffff0000u);
  } else if constexpr (std::is_same<T, __half>::value) {
    const __half2* h = reinterpret_cast<const __half2*>(p);
    const float2 lo = __half22float2(h[0]), hi = __half22float2(h[1]);
    v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
  } else {
    static_assert(std::is_same<T, int8_t>::value, "f32, bf16, f16 or int8");
    const char4 c = *reinterpret_cast<const char4*>(p);
    v[0] = (float)c.x, v[1] = (float)c.y, v[2] = (float)c.z;
    v[3] = (float)c.w;
  }
}

// The result type of TX x TW, as jnp.promote_types gives it (int8 x int8
// is mm_kernel's): bf16 or f16 where both operands are that type or one
// of them is int8, else f32.
template <typename TX, typename TW>
struct Promoted {
  using type = float;
};
template <typename T>
struct Promoted<T, T> {
  using type = T;
};
template <>
struct Promoted<bf16, int8_t> {
  using type = bf16;
};
template <>
struct Promoted<int8_t, bf16> {
  using type = bf16;
};
template <>
struct Promoted<__half, int8_t> {
  using type = __half;
};
template <>
struct Promoted<int8_t, __half> {
  using type = __half;
};

// An f32 sum rounded once to the result type.
__device__ __forceinline__ void store_out(float* p, float s) { *p = s; }
__device__ __forceinline__ void store_out(bf16* p, float s) {
  *p = __float2bfloat16_rn(s);
}
__device__ __forceinline__ void store_out(__half* p, float s) {
  *p = __float2half_rn(s);
}

struct MmFloatArgs {
  const unsigned char* x;
  const unsigned char* w;
  void* out;
  int M, K, N;
  int kr, kblk, nb, wvec, xvec;   // the plan (ops.mm_float_plan)
  int srow, xrow, slot;           // the layout (mm_float_layout() below)
};

struct MmFloatLayout {
  int srow;   // bytes of a weight row of a slot: tn * w_bytes + 16
  int xrow;   // bytes of an x row of a slot: kblk * x_bytes + 16
  int slot;   // bytes of a slot: kblk weight rows, then TM x rows
  long smem;
};

// ops.mm_float_layout mirrors this.  Shared memory of one CTA: the full
// and empty mbarriers of the nb slots, the slots [nb][slot], the consumer
// warps' sums [FCONS / 32][TM][tn] f32 and the CTA's sums [TM][tn] f32,
// which the cluster's leader reads.
MmFloatLayout mm_float_layout(int tn, int kblk, int nb, int x_bytes,
                              int w_bytes) {
  MmFloatLayout L;
  L.srow = tn * w_bytes + 16;
  L.xrow = kblk * x_bytes + 16;
  L.slot = kblk * L.srow + TM * L.xrow;
  L.smem = 16L * nb + (long)nb * L.slot +
           (long)(FCONS / 32 + 1) * TM * tn * 4;
  return L;
}

// One copy of `vec` bytes of an operand of ES-byte elements (16, 8 or 4
// by cp.async, zero-filled where !ok; else one element by a plain copy).
// The one-byte copy exists only in the int8 operands' instances: a fifth
// case in the producer's loop made the f32 and bf16 instances 5-18%
// slower on an H100 (probe_stream.py).
template <int ES>
__device__ __forceinline__ void copy_chunk(int vec, unsigned char* dst,
                                           const unsigned char* src,
                                           bool ok) {
  if (vec == 16)
    h2pipe::cp_async16(dst, src, ok);
  else if (vec == 8)
    h2pipe::cp_async8(dst, src, ok);
  else if (vec == 4)
    h2pipe::cp_async4(dst, src, ok);
  else if constexpr (ES == 1)
    *dst = ok ? *src : (unsigned char)0;
  else
    *reinterpret_cast<uint16_t*>(dst) =
        ok ? *reinterpret_cast<const uint16_t*>(src) : (uint16_t)0;
}

// The producer warps: block by block, the weight rows of the rank's range
// [k0, k1) (columns n0 .. n0 + tn) and x's rows m0 .. m0 + TM of the same
// K rows into the ring; a slot is refilled only after its empty barrier
// completes (the credit rule).
template <int TN, int xb, int wb>
__device__ __forceinline__ void mm_float_produce(
    const MmFloatArgs& a, int m0, int n0, int k0, int k1, int nkb,
    uint64_t* full, uint64_t* empty, unsigned char* ring) {
  const int pt = threadIdx.x - FCONS;
  const bool plain = a.wvec <= 2 || a.xvec <= 2;
  const int per_wrow = TN * wb / a.wvec, per_xrow = a.kblk * xb / a.xvec;
  h2pipe::RingPos pos;
  for (int kb = 0; kb < nkb; ++kb) {
    h2pipe::mbar_wait(empty + pos.slot, pos.phase ^ 1);
    unsigned char* slot = ring + (size_t)pos.slot * a.slot;
    unsigned char* xs = slot + (size_t)a.kblk * a.srow;
    const int kbase = k0 + kb * a.kblk;
    for (int idx = pt; idx < a.kblk * per_wrow; idx += NPROD) {
      const int r = idx / per_wrow, cb = (idx - r * per_wrow) * a.wvec;
      const int k = kbase + r, n = n0 + cb / wb;
      const bool ok = k < k1 && n < a.N;
      copy_chunk<wb>(a.wvec, slot + r * a.srow + cb,
                 ok ? a.w + ((size_t)k * a.N + n) * wb : a.w, ok);
    }
    for (int idx = pt; idx < TM * per_xrow; idx += NPROD) {
      const int m = idx / per_xrow, cb = (idx - m * per_xrow) * a.xvec;
      const int k = kbase + cb / xb;
      const bool ok = m0 + m < a.M && k < k1;
      copy_chunk<xb>(a.xvec, xs + m * a.xrow + cb,
                 ok ? a.x + ((size_t)(m0 + m) * a.K + k) * xb : a.x, ok);
    }
    if (plain) {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      h2pipe::mbar_arrive(full + pos.slot);
    } else {
      h2pipe::cp_async_mbar_arrive(full + pos.slot);
    }
    pos.next(a.nb);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A CTA: (tile of TN columns, rank in the K split, tile of TM rows).
template <typename TX, typename TW, int TN>
__global__ void __launch_bounds__(FCONS + NPROD) mm_float(MmFloatArgs a) {
  constexpr int NWARPS = FCONS / 32;
  constexpr int XB = sizeof(TX), WB = sizeof(TW);
  using TO = typename Promoted<TX, TW>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + a.nb;
  unsigned char* ring = smem + 16 * a.nb;
  float* red = reinterpret_cast<float*>(ring + (size_t)a.nb * a.slot);
  float* part = red + NWARPS * TM * TN;              // [TM][TN]

  const int n0 = blockIdx.x * TN, m0 = blockIdx.z * TM;
  const int k0 = min(a.K, rank * a.kr), k1 = min(a.K, k0 + a.kr);
  const int nkb = (k1 - k0 + a.kblk - 1) / a.kblk;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < a.nb; ++s) {
      h2pipe::mbar_init(full + s, NPROD);            // every producer thread
      h2pipe::mbar_init(empty + s, NWARPS);          // every consumer warp
    }
    h2pipe::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= FCONS) {
    mm_float_produce<TN, XB, WB>(a, m0, n0, k0, k1, nkb, full, empty, ring);
  } else {
    constexpr int quads = TN / 4, ways = FCONS / quads;
    const int quad = tid % quads, way = tid / quads;
    float acc[TM][4];
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[m][n] = 0.0f;
    h2pipe::RingPos pos;
    for (int kb = 0; kb < nkb; ++kb) {
      h2pipe::mbar_wait(full + pos.slot, pos.phase);
      const unsigned char* slot = ring + (size_t)pos.slot * a.slot;
      const unsigned char* xs = slot + (size_t)a.kblk * a.srow;
      const int rows = min(a.kblk, k1 - k0 - kb * a.kblk);
      // 4 K rows at a time; the rows past the range are zeros
      for (int k4 = way; 4 * k4 < rows; k4 += ways) {
        float wv[4][4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          load4<TW>(slot + (4 * k4 + e) * a.srow + 4 * quad * WB, wv[e]);
#pragma unroll
        for (int m = 0; m < TM; ++m) {
          float xv[4];
          load4<TX>(xs + m * a.xrow + 4 * k4 * XB, xv);
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int n = 0; n < 4; ++n)
              acc[m][n] = __fmaf_rn(xv[e], wv[e][n], acc[m][n]);
        }
      }
      __syncwarp();
      if ((tid & 31) == 0) h2pipe::mbar_arrive(empty + pos.slot);
      pos.next(a.nb);
    }
    // the shares: over the ways of a warp by shuffles, then over the warps
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int off = quads; off < 32; off <<= 1)
          acc[m][n] += __shfl_xor_sync(0xffffffffu, acc[m][n], off);
    const int lane = tid & 31, warp = tid >> 5;
    if (lane < quads)
#pragma unroll
      for (int m = 0; m < TM; ++m)
        *reinterpret_cast<float4*>(red + (warp * TM + m) * TN + 4 * lane) =
            make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    asm volatile("bar.sync 1, %0;\n" ::"r"(FCONS) : "memory");
    for (int o = tid; o < TM * TN; o += FCONS) {
      float s = 0.0f;
#pragma unroll
      for (int wp = 0; wp < NWARPS; ++wp) s += red[wp * TM * TN + o];
      part[o] = s;
    }
  }
  cluster.sync();  // every rank's sums are in its shared memory
  if (rank == 0 && tid < FCONS) {
    const int split = (int)cluster.num_blocks();
    TO* out = reinterpret_cast<TO*>(a.out);
    for (int o = tid; o < TM * TN; o += FCONS) {
      const int m = o / TN, c = o - m * TN;
      const int row = m0 + m, n = n0 + c;
      if (row >= a.M || n >= a.N) continue;
      float s = 0.0f;
      for (int r = 0; r < split; ++r) s += cluster.map_shared_rank(part, r)[o];
      store_out(out + (size_t)row * a.N + n, s);
    }
  }
  cluster.sync();  // the leader has read every rank's sums
}

// The element types of the float modes, by their codes in
// ops.FLOAT_TYPE_CODES, and their bytes.
enum { T_F32 = 0, T_BF16 = 1, T_F16 = 2, T_I8 = 3 };
constexpr int TYPE_BYTES[4] = {4, 2, 2, 1};

using FloatKernel = void (*)(MmFloatArgs);

// mm_float<TX, TW, TN> for the type code of TW
template <typename TX, int TN>
FloatKernel float_kernel_w(int w_type) {
  switch (w_type) {
    case T_F32: return mm_float<TX, float, TN>;
    case T_BF16: return mm_float<TX, bf16, TN>;
    case T_F16: return mm_float<TX, __half, TN>;
    default:
      if constexpr (std::is_same<TX, int8_t>::value)
        return nullptr;  // int8 x int8 is mm_kernel's
      else
        return mm_float<TX, int8_t, TN>;
  }
}

// mm_float<TX, TW, TN> for the type codes of TX and TW
template <int TN>
FloatKernel float_kernel(int x_type, int w_type) {
  switch (x_type) {
    case T_F32: return float_kernel_w<float, TN>(w_type);
    case T_BF16: return float_kernel_w<bf16, TN>(w_type);
    case T_F16: return float_kernel_w<__half, TN>(w_type);
    default: return float_kernel_w<int8_t, TN>(w_type);
  }
}

}  // namespace

extern "C" {

// x: [M, K] int8 @ w: [K, N] int8 with the plan of ops.mm_plan: tiles of
// tn columns, a K split of `split` ranges of kr rows over a cluster, K
// blocks of kblk rows through an nb-slot ring, copies of vec (w) and xvec
// (x) bytes; smem: the bytes of its layout, which mm_layout() must
// reproduce.  Exactly one of out_q (int8, fused requant; out_f optional)
// and out_i32 (raw sums) is set.  Returns cudaGetLastError() after the
// launch.
int stream_matmul_int8_launch(const int8_t* x, const int8_t* w,
                              const float* w_scale, const float* bias,
                              float act_scale, float inv_act, int8_t* out_q,
                              float* out_f, int32_t* out_i32, int M, int K,
                              int N, int relu, int tn, int split, int kr,
                              int kblk, int nb, int vec, int xvec, int smem,
                              cudaStream_t stream) {
  if ((tn != 32 && tn != 64) || split < 1 || split > MAX_SPLIT ||
      kr < 16 || kr % 16 != 0 || (long)split * kr < K ||
      (long)(split - 1) * kr >= K || kblk < 4 || kblk % 4 != 0 ||
      nb < 1 || (vec != 1 && vec != 4 && vec != 8 && vec != 16) ||
      N % vec != 0 || (xvec != 1 && xvec != 4 && xvec != 16) ||
      K % xvec != 0)
    return (int)cudaErrorInvalidValue;
  MmLayout L = mm_layout(tn, kr, kblk, nb);
  if (L.smem != smem) return (int)cudaErrorInvalidValue;
  const bool few = consumers(kr) == 64;
  void (*fn)(MmArgs) =
      tn == 32 ? (few ? mm_kernel<32, 64> : mm_kernel<32, 128>)
               : (few ? mm_kernel<64, 64> : mm_kernel<64, 128>);
  MmArgs a{x, w, w_scale, bias, act_scale, inv_act, out_q, out_f, out_i32,
           M, K, N, relu, tn, kr, kblk, nb, vec, xvec, L.xr, L.srow};
  cudaError_t err = cudaFuncSetAttribute(
      (void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + tn - 1) / tn, split, (M + TM - 1) / TM);
  cfg.blockDim = dim3(consumers(kr) + NPROD);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fn, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// x: [M, K] @ w: [K, N] of the element types x_type and w_type (T_F32,
// T_BF16, T_F16, T_I8; not both int8), with the plan of
// ops.mm_float_plan: tiles of tn columns, a K split of `split` ranges of
// kr rows over a cluster, K blocks of kblk rows of w and x (a multiple of
// 16 where x is int8, else of 8) through an nb-slot ring, copies of wvec
// (w) and xvec (x) bytes; smem: the bytes of its layout, which
// mm_float_layout() must reproduce.  out: [M, N] of the promoted type
// (Promoted).  Returns cudaGetLastError() after the launch.
int stream_matmul_float_launch(const void* x, const void* w, void* out,
                               int x_type, int w_type, int M, int K, int N,
                               int tn, int split, int kr, int kblk, int nb,
                               int wvec, int xvec, int smem,
                               cudaStream_t stream) {
  auto vec_ok = [](int vec, int es, long row_bytes) {
    return (vec == 16 || vec == 8 || vec == 4 || (vec == es && es <= 2)) &&
           row_bytes % vec == 0;
  };
  if (x_type < 0 || x_type > 3 || w_type < 0 || w_type > 3 ||
      (x_type == T_I8 && w_type == T_I8))
    return (int)cudaErrorInvalidValue;
  const int x_bytes = TYPE_BYTES[x_type], w_bytes = TYPE_BYTES[w_type];
  const int kstep = x_bytes == 1 ? 16 : 8;
  if (M < 1 || K < 1 || N < 1 || (tn != 32 && tn != 64) || split < 1 ||
      split > MAX_SPLIT || kr < 16 || kr % 16 != 0 ||
      (long)split * kr < K || (long)(split - 1) * kr >= K || kblk < kstep ||
      kblk % kstep != 0 || kblk > kr || nb < 1 ||
      !vec_ok(wvec, w_bytes, (long)N * w_bytes) ||
      !vec_ok(xvec, x_bytes, (long)K * x_bytes))
    return (int)cudaErrorInvalidValue;
  MmFloatLayout L = mm_float_layout(tn, kblk, nb, x_bytes, w_bytes);
  if (L.smem != smem) return (int)cudaErrorInvalidValue;
  FloatKernel fn = tn == 64 ? float_kernel<64>(x_type, w_type)
                            : float_kernel<32>(x_type, w_type);
  MmFloatArgs a{static_cast<const unsigned char*>(x),
                static_cast<const unsigned char*>(w), out, M, K, N, kr,
                kblk, nb, wvec, xvec, L.srow, L.xrow, L.slot};
  cudaError_t err = cudaFuncSetAttribute(
      (void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + tn - 1) / tn, split, (M + TM - 1) / TM);
  cfg.blockDim = dim3(FCONS + NPROD);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fn, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
