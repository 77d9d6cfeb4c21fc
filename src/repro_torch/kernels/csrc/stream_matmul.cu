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
// The float modes: every operand pair over f32, bf16, f16 and int8 but
// int8 x int8 (mm_kernel's), f32 sums as the reference's _acc_dtype takes
// them, the result in the type jnp.promote_types gives (Promoted below:
// f16 x f16 -> f16, f16 x bf16 -> f32, int8 x bf16 -> bf16, int8 x f16 ->
// f16, any with f32 -> f32), with the same work split, ring and credit rule
// as mm_kernel and a plan of their own (ops.mm_float_plan, layout
// mm_float_layout below).  A slot holds a K block of the weights
// [kblk][tn] and of x [TM][kblk], zeros past M, N and the rank's K range.
// The leader of the cluster reads every rank's sums through distributed
// shared memory in rank order (deterministic) and writes the result in its
// type.  Two bodies, by one rule (float_tensor_cores below, mirrored by
// ops.mm_float_tensor_cores): the tensor cores take every pair whose
// weights are not f32, FFMA the four whose weights are.
//  * mm_float_tc<TX, TW, TN>, the eleven pairs with bf16, f16 or int8
//    weights, on the tensor cores (mma.sync, f32 sums).  The operands are
//    swapped, out^T[N, M] = w^T[N, K] . x^T[K, M]: the weights fill mma's
//    16-row side and the TM = 8 rows of x its n = 8, so no row is padded
//    at M = 8.  Each of 8 consumer warps owns 16 columns (tn = 128; at 64
//    and 32 two and four warps share a group, unit by unit) and takes the
//    block's K rows 32 at a time (a unit: two k16 halves, one accumulator
//    each).  A fragments come from the weight slot by ldmatrix.trans (an
//    int8 slot by the same ldmatrix, as byte pairs: a lane's register
//    holds two K rows of two columns, mma rows i and i + 8 taking columns
//    2i and 2i + 1), B fragments from x's slot rows by ldmatrix (int8 x:
//    one 4-byte load a k16 half).  A lane's A and B fragments hold the
//    same K rows (unit_row), which is all a sum needs.  bf16 x bf16 and
//    f16 x f16 run m16n8k16 in their type; int8 against bf16 or f16
//    widens exactly to the other's type in registers (widen_i8x2), so an
//    int8 weight still crosses HBM as one byte; bf16 x f16 and f16 x bf16
//    widen both to f32 bit patterns, exact in tf32 (8 and 11 significand
//    bits, f16's exponents inside), and run m16n8k8 tf32.  An f32 x splits
//    exactly into three bf16 parts (split3: 8 + 8 + 8 significand bits,
//    truncated, never rounded), each taking the same A fragments: f32 x
//    bf16 and f32 x int8 (widened to bf16 once) three m16n8k16 bf16
//    products, f32 x f16 three m16n8k8 tf32 ones (a part widened as a bf16
//    x is); x0's products sum apart from x1's and x2's.  At tiles of 64 and
//    128 columns the 256 consumer threads split a slot's x once into rows
//    of shared memory that the units read as a bf16 x's (x_split_shared:
//    split in every warp's registers, each value eight times at tn = 128,
//    the consumers alone took 95 us at fc0 against 61 so); at 32, where
//    only two warps split a value, each warp splits in registers and the
//    latency-bound heads skip the slot's barrier.  Every product is exact
//    before its sum, as in the reference.
//    The slots come by TMA (mm_float_produce_tma: one thread, one 2-d box
//    of 128-byte rows a tensor map and 128 bytes of columns, the 128-byte
//    swizzle, one arrival with the boxes' bytes on the full barrier) where
//    w's and x's rows are a multiple of 16 bytes and a column tile is one
//    or two boxes; else (ragged N such as 1000 int8 or 10, tiles of 32
//    columns) by 128 producer threads' cp.async (16, 8 or 4 bytes, or one
//    element), into rows padded by 16 bytes.
//  * mm_float<TX, TW, TN>, the four pairs with f32 weights, FFMA on the
//    CUDA cores, never TF32, which would round the f32 operand: each of 128
//    consumer threads owns 4 columns x TM rows and a share of the block's K
//    rows, 4 at a time, a narrower value widened to f32 exactly as it is
//    read; shares summed by shuffles, then across warps in shared memory;
//    slots by cp.async.
// What bounds them.  At M = 8 a weight element takes 16 FLOP: 8 a byte in
// bf16, 4 in f32, 16 in int8.  On the tensor cores (989 TFLOP/s bf16 and
// f16, 495 tf32) the products take 30 to 120 times less than the bytes
// (10 to 40 times with an f32 x's three parts), so the weight stream at
// 3.35 TB/s is the bound, and the ring has to keep it in flight: about
// 3.35 TB/s x 1 us of latency over 132 SMs, 25 KB of weights an SM.  fc0
// (25088 x 4096, bf16) runs 32 column tiles of 128 x a K split of 8, 256
// CTAs of 3136 K rows, each two slots of 64 rows x 256 bytes (16 KB) in
// flight, 1.9 CTAs an SM: up to 62 KB an SM.  Small slots and many CTAs
// an SM won on an H100 (probe_stream.py): a CTA's ring is bound by its
// slots' round trips, so the card is filled by more rings, not deeper
// ones; TMA's one request a box beat 128 threads' 16-byte cp.async.  The
// int8 weights' widening and an f32 x's split are consumer work that the
// weight stream does not hide at fc0 (f32 x f16's twelve tf32 products a
// unit the most).  The body is built for three CTAs an SM (TC_CTAS): fc0's
// and 4096 x 4096's 256 CTAs in clusters of 8 take one wave only so.
// FFMA's 67 TFLOP/s would need 20 FLOP a byte to pass the bytes: on FFMA a
// 2-byte weight (8) did not reach them, the loop running at about a fifth
// of that peak, which is why only the f32 weights (4 FLOP a byte) stay
// there, at about half of their bound.  Times: probe_stream.py, one H100
// 80GB HBM3 at 700 W.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <type_traits>

#include "common.cuh"
#include "mma_bf16.cuh"
#include "tma.cuh"

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
// The float modes: mm_float<TX, TW, TN> (FFMA) and mm_float_tc<TX, TW, TN>
// (tensor cores)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int FCONS = 128;       // consumer threads on FFMA (warps 0..3)
constexpr int TC_CONS = 256;     // on the tensor cores (warps 0..7)
constexpr int TC_UNIT = 32;      // K rows a tensor-core warp takes at once
// CTAs an SM the tensor-core body is built for (its registers, at most 56
// a thread): the path's grids of 256 CTAs, clusters of 8, take one wave
// only at three an SM (built for two, the f32-x pairs ran 1.1-1.6x slower
// at fc0 and 1.46x at the 32-column heads: probe_stream.py --float-only,
// H100 80GB HBM3 at 700 W)
constexpr int TC_CTAS = 3;

// Whether a pair of x_bytes and w_bytes elements runs on the tensor cores
// (mm_float_tc): its weights are not f32, and it is not int8 x int8
// (mm_kernel's); ops.mm_float_tensor_cores mirrors it.  The rest, the
// f32 weights, run mm_float on FFMA.
__host__ __device__ constexpr bool float_tensor_cores(int x_bytes,
                                                      int w_bytes) {
  return w_bytes <= 2 && !(x_bytes == 1 && w_bytes == 1);
}

// The consumer threads of a body
__host__ __device__ constexpr int float_consumers(bool tc) {
  return tc ? TC_CONS : FCONS;
}

// The consumers' shares of a column: every warp's on FFMA; on the tensor
// cores the warps of a column group of 16 (one at tn = 128)
__host__ __device__ constexpr int float_shares(int tn, bool tc) {
  return tc ? TC_CONS / 32 / (tn / 16) : FCONS / 32;
}

// An f32 x on the tensor cores (mm_float_tc) is split once a slot into
// shared memory where more than two column groups of 16 read it (tiles of
// 64 and 128 columns); at 32 each warp splits its own units' values in
// registers, each value twice (once a group), which spares the 32-column
// heads, bound by their few slots' latency, the slot's barrier.
__host__ __device__ constexpr bool x_split_shared(int tn) { return tn > 32; }

// Its parts there: two buffers, each the three bf16 parts of a slot's x,
// [3][TM] rows of kblk bf16 padded by 16 bytes (ldmatrix's eight rows on
// distinct banks, as x's rows on the cp.async route); ops.mm_float_parts
// mirrors it.
__host__ __device__ constexpr int x_part_row(int kblk) { return kblk * 2 + 16; }
__host__ __device__ constexpr long x_parts_bytes(int kblk) {
  return 2L * 3 * TM * x_part_row(kblk);
}

template <typename T>
constexpr bool is_i8 = std::is_same<T, int8_t>::value;
template <typename T>
constexpr bool is_f32 = std::is_same<T, float>::value;

// Four consecutive values of type T at p (16 bytes of f32, 8 of bf16 or
// f16, 4 of int8), widened to f32 exactly.
template <typename T>
__device__ __forceinline__ void load4(const unsigned char* p, float v[4]) {
  if constexpr (is_f32<T>) {
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
    static_assert(is_i8<T>, "f32, bf16, f16 or int8");
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

// The mma operand type of a tensor-core pair: the pair's type where both
// share it or one is int8 (int8 widens exactly to bf16 and to f16), bf16
// for an f32 x's parts against bf16 or int8 weights, else (bf16 with f16,
// an f32 x's parts with f16) tf32, which holds both exactly.
struct Tf32 {};
template <typename TX, typename TW>
struct MmaType {
  using type = Tf32;
};
template <typename T>
struct MmaType<T, T> {
  using type = T;
};
template <>
struct MmaType<int8_t, bf16> {
  using type = bf16;
};
template <>
struct MmaType<bf16, int8_t> {
  using type = bf16;
};
template <>
struct MmaType<int8_t, __half> {
  using type = __half;
};
template <>
struct MmaType<__half, int8_t> {
  using type = __half;
};
template <>
struct MmaType<float, bf16> {
  using type = bf16;
};
template <>
struct MmaType<float, int8_t> {
  using type = bf16;
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
  int kr, kblk, nb, wvec, xvec, tma;   // the plan (ops.mm_float_plan)
  int srow, xrow, slot, prow;          // the layout (mm_float_layout())
};

// The TMA route's tensor maps (unset on the cp.async route).
struct FloatMaps {
  CUtensorMap w, x;
};

struct MmFloatLayout {
  int srow;   // bytes of a weight row of a slot: tn * w_bytes (+ 16)
  int xrow;   // bytes of an x row of a slot: kblk * x_bytes + 16 (TMA: 128)
  int slot;   // bytes of a slot: kblk weight rows, then TM x rows
  int prow;   // bytes of a row of an f32 x's parts (x_part_row)
  long smem;
};

// ops.mm_float_layout mirrors this.  Shared memory of one CTA: the full
// and empty mbarriers of the nb slots, the slots [nb][slot], the consumers'
// shares [float_shares][TM][tn] f32 and the CTA's sums [TM][tn] f32,
// which the cluster's leader reads; on the tensor cores with an f32 x,
// at tiles of 64 and 128 columns, then x's parts (x_parts_bytes).  On the
// cp.async route a row's 16 extra bytes make eight rows that ldmatrix
// reads together fall on
// distinct banks wherever a row is an odd number of 16-byte chunks: weight
// rows of 32, 64 or 128 columns of 1 or 2 bytes, x rows of a K block of a
// multiple of 32 (the tensor-core plans' blocks).  On the TMA route a
// slot is boxes of 128-byte rows as the 128-byte swizzle lays them out
// (tile_at): the weights tn * w_bytes / 128 boxes of kblk rows, then x
// kblk * x_bytes / 128 boxes of TM rows; the ring starts at the first
// 1024-byte boundary after the mbarriers (1024 bytes kept for it).
MmFloatLayout mm_float_layout(int tn, int kblk, int nb, int x_bytes,
                              int w_bytes, bool tma) {
  MmFloatLayout L;
  L.srow = tn * w_bytes + (tma ? 0 : 16);
  L.xrow = tma ? 128 : kblk * x_bytes + 16;
  L.slot = kblk * L.srow + TM * (tma ? kblk * x_bytes : L.xrow);
  L.prow = x_part_row(kblk);
  const bool tc = float_tensor_cores(x_bytes, w_bytes);
  L.smem = 16L * nb + (tma ? 1024 : 0) + (long)nb * L.slot +
           (long)(float_shares(tn, tc) + 1) * TM * tn * 4 +
           (tc && x_bytes == 4 && x_split_shared(tn) ? x_parts_bytes(kblk)
                                                     : 0);
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
template <int TN, int xb, int wb, int NCONS>
__device__ __forceinline__ void mm_float_produce(
    const MmFloatArgs& a, int m0, int n0, int k0, int k1, int nkb,
    uint64_t* full, uint64_t* empty, unsigned char* ring) {
  const int pt = threadIdx.x - NCONS;
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

// What both float bodies share: a CTA is (tile of TN columns, rank in the
// K split, tile of TM rows); its mbarriers, set up here, and its arrays.
struct FloatCta {
  uint64_t* full;
  uint64_t* empty;
  unsigned char* ring;
  float* red;    // the consumers' shares [shares][TM][TN]
  float* part;   // the CTA's sums [TM][TN], which the leader reads
  int n0, m0, k0, k1, nkb;
};

template <int TN, int SHARES, int NCONS>
__device__ __forceinline__ FloatCta float_cta(const MmFloatArgs& a,
                                              unsigned char* smem,
                                              int rank) {
  FloatCta c;
  c.full = reinterpret_cast<uint64_t*>(smem);
  c.empty = c.full + a.nb;
  c.ring = smem + 16 * a.nb;
  if (a.tma)   // the 128-byte swizzle repeats every 1024 bytes
    c.ring += (1024 - h2pipe::smem_addr(c.ring) % 1024) % 1024;
  c.red = reinterpret_cast<float*>(c.ring + (size_t)a.nb * a.slot);
  c.part = c.red + SHARES * TM * TN;
  c.n0 = blockIdx.x * TN;
  c.m0 = blockIdx.z * TM;
  c.k0 = min(a.K, rank * a.kr);
  c.k1 = min(a.K, c.k0 + a.kr);
  c.nkb = (c.k1 - c.k0 + a.kblk - 1) / a.kblk;
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.nb; ++s) {
      // every producer thread, or the one that issues the TMA loads
      h2pipe::mbar_init(c.full + s, a.tma ? 1 : NPROD);
      h2pipe::mbar_init(c.empty + s, NCONS / 32);    // every consumer warp
    }
    h2pipe::mbar_init_fence();
  }
  __syncthreads();
  return c;
}

// After the ring: the consumers add the SHARES shares of red in order into
// the CTA's sums; the leader of the cluster adds every rank's sums in rank
// order and writes them, rounded once to TO.
template <typename TO, int TN, int SHARES, int NCONS>
__device__ __forceinline__ void float_finish(const MmFloatArgs& a,
                                             const FloatCta& c,
                                             cg::cluster_group& cluster,
                                             int rank) {
  const int tid = threadIdx.x;
  if (tid < NCONS) {
    asm volatile("bar.sync 1, %0;\n" ::"r"(NCONS) : "memory");
    for (int o = tid; o < TM * TN; o += NCONS) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < SHARES; ++w) s += c.red[w * TM * TN + o];
      c.part[o] = s;
    }
  }
  cluster.sync();  // every rank's sums are in its shared memory
  if (rank == 0 && tid < NCONS) {
    const int split = (int)cluster.num_blocks();
    TO* out = reinterpret_cast<TO*>(a.out);
    for (int o = tid; o < TM * TN; o += NCONS) {
      const int m = o / TN, col = o - m * TN;
      const int row = c.m0 + m, n = c.n0 + col;
      if (row >= a.M || n >= a.N) continue;
      float s = 0.0f;
      for (int r = 0; r < split; ++r)
        s += cluster.map_shared_rank(c.part, r)[o];
      store_out(out + (size_t)row * a.N + n, s);
    }
  }
  cluster.sync();  // the leader has read every rank's sums
}

// The FFMA body: the pairs with f32 weights.
template <typename TX, typename TW, int TN>
__global__ void __launch_bounds__(FCONS + NPROD) mm_float(MmFloatArgs a) {
  constexpr int XB = sizeof(TX), WB = sizeof(TW);
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const FloatCta c = float_cta<TN, FCONS / 32, FCONS>(a, smem, rank);
  const int tid = threadIdx.x;
  if (tid >= FCONS) {
    mm_float_produce<TN, XB, WB, FCONS>(a, c.m0, c.n0, c.k0, c.k1, c.nkb,
                                        c.full, c.empty, c.ring);
  } else {
    constexpr int quads = TN / 4, ways = FCONS / quads;
    const int quad = tid % quads, way = tid / quads;
    float acc[TM][4];
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[m][n] = 0.0f;
    h2pipe::RingPos pos;
    for (int kb = 0; kb < c.nkb; ++kb) {
      h2pipe::mbar_wait(c.full + pos.slot, pos.phase);
      const unsigned char* slot = c.ring + (size_t)pos.slot * a.slot;
      const unsigned char* xs = slot + (size_t)a.kblk * a.srow;
      const int rows = min(a.kblk, c.k1 - c.k0 - kb * a.kblk);
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
      if ((tid & 31) == 0) h2pipe::mbar_arrive(c.empty + pos.slot);
      pos.next(a.nb);
    }
    // the shares: over the ways of a warp by shuffles, then a row of red
    // a warp
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
        *reinterpret_cast<float4*>(c.red + (warp * TM + m) * TN + 4 * lane) =
            make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  }
  float_finish<typename Promoted<TX, TW>::type, TN, FCONS / 32, FCONS>(
      a, c, cluster, rank);
}

// A 4-byte shared-memory load at a shared-memory address.
__device__ __forceinline__ uint32_t lds32(unsigned addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// The int8 values in the low bytes of the two 16-bit halves of v, widened
// exactly to a pair of T (bf16 or f16): the magic m (128 in bf16, 1024 in
// f16, where the last mantissa bit is worth 1) with the value's low 7 bits
// as its mantissa, less m with the sign bit there, worth 128.
template <typename T>
__device__ __forceinline__ uint32_t widen_i8x2(uint32_t v) {
  constexpr bool BF = std::is_same<T, bf16>::value;
  constexpr uint32_t m = BF ? 0x43004300u : 0x64006400u;
  const uint32_t low = (v & 0x007f007fu) | m, sign = (v & 0x00800080u) | m;
  uint32_t r;
  if constexpr (BF) {
    const __nv_bfloat162 d =
        __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&low),
                *reinterpret_cast<const __nv_bfloat162*>(&sign));
    r = *reinterpret_cast<const uint32_t*>(&d);
  } else {
    const __half2 d = __hsub2(*reinterpret_cast<const __half2*>(&low),
                              *reinterpret_cast<const __half2*>(&sign));
    r = *reinterpret_cast<const uint32_t*>(&d);
  }
  return r;
}

// The two 16-bit values of v (T: bf16 or f16) as f32 bit patterns, exact
// (and so exact tf32): the low half into lo, the high half into hi.
template <typename T>
__device__ __forceinline__ void widen_16x2(uint32_t v, uint32_t& lo,
                                           uint32_t& hi) {
  if constexpr (std::is_same<T, bf16>::value) {
    lo = v << 16;
    hi = v & 0xffff0000u;
  } else {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&v));
    lo = __float_as_uint(f.x);
    hi = __float_as_uint(f.y);
  }
}

// x's layouts in a unit's B fragments: 16-bit values (an f32 x's parts in
// shared memory), int8 words, f32 values split in registers.
enum { X16 = 0, X8 = 1, X32 = 2 };

// The unit's K row that row r of its ldmatrix matrix (j, h) reads: half j,
// the first (h = 0) or second fragment register of the half.  A lane takes
// rows 2t and 2t + 1 of each matrix (t = lane % 4), so its A fragments
// hold the K rows its B fragments hold, by x's layout XL: 16 bits, by
// ldmatrix, rows 16j + 8h + 2t, +1; int8, by one 4-byte load of rows 16j +
// 4t .. 4t + 3, whose even bytes (widen_i8x2 of the word) are h = 0 and
// odd bytes (of the word >> 8) h = 1; f32, by ldmatrix of four 16-byte
// matrices i as b16 pairs, one f32 a lane, rows 16j + 4i + t: (i = 0, 1)
// are h = 0 and (2, 3) h = 1.
template <int XL>
__device__ __forceinline__ int unit_row(int j, int h, int r) {
  if constexpr (XL == X8) return 16 * j + 4 * (r >> 1) + 2 * (r & 1) + h;
  if constexpr (XL == X16) return 16 * j + 8 * h + r;
  return 16 * j + 8 * h + (r >> 1) + 4 * (r & 1);
}

// An f32 value v (bits) split into three parts, v = p[0] + p[1] + p[2],
// each an f32 bit pattern whose low 16 bits are zero: a bf16 value (its
// high half) and a tf32 one.  p[0] is v truncated to its high 16 bits,
// never rounded (round to nearest makes every finite v above bf16's
// largest, about 3.3895e38, an inf, and inf - inf NaN); r = v - p[0] is
// exact; p[1] is r truncated the same way, p[2] = r - p[1] (exact)
// truncated.  The sum is v exactly for |v| >= 2^-110 (v's last bit is then
// a multiple of bf16's least subnormal, 2^-133), for every finite v within
// 2^-133.  A non-finite v: p[0] = v (a NaN as the quiet NaN, whatever its
// payload's bits), p[1] = p[2] = 0.  A zero part against a weight of +-inf
// gives NaN (0 x inf) where FFMA would give +-inf.
__device__ __forceinline__ void split3(uint32_t v, uint32_t p[3]) {
  const uint32_t hi = v & 0xffff0000u;
  const float r = __fsub_rn(__uint_as_float(v), __uint_as_float(hi));
  const uint32_t mid = __float_as_uint(r) & 0xffff0000u;
  const uint32_t lo =
      __float_as_uint(__fsub_rn(r, __uint_as_float(mid))) & 0xffff0000u;
  const bool finite = (v & 0x7f800000u) != 0x7f800000u;
  p[0] = finite || (v & 0x007fffffu) == 0 ? hi : 0x7fc00000u;
  p[1] = finite ? mid : 0u;
  p[2] = finite ? lo : 0u;
}

// Two f32 bit patterns' high halves as a pair of bf16: lo's low, hi's high.
__device__ __forceinline__ uint32_t pack_hi16(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x7632);
}

// threadIdx.x, read afresh where it is used (no value kept across a loop)
__device__ __forceinline__ int tid_x() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  return t;
}

// An 8-byte and a 4-byte shared-memory access at a shared-memory address.
__device__ __forceinline__ uint2 lds64(unsigned addr) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts32(unsigned addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// Byte b of row r of an operand's tile in a slot, from the tile's start:
// rows of `pitch` bytes (the cp.async route), or (TMA) boxes of
// `box_rows` rows of 128 bytes side by side, the 16-byte chunks of row r
// at chunk ^ (r % 8) (the 128-byte swizzle, ldmatrix's rows on distinct
// banks).  A shift of 8 rows leaves the swizzle as it was.
__device__ __forceinline__ unsigned tile_at(bool tma, int r, int b,
                                            int pitch, int box_rows) {
  if (!tma) return r * pitch + b;
  return (b >> 7) * (box_rows << 7) + (r << 7) +
         ((((b >> 4) & 7) ^ (r & 7)) << 4) + (b & 15);
}

// One box of a 2-d tensor map (coordinates innermost first) into shared
// memory at dst, completing its bytes on the mbarrier bar.
__device__ __forceinline__ void tma_load_2d(unsigned dst,
                                            const CUtensorMap* map,
                                            unsigned bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// MM_FLOAT_PROBE takes a part of the tensor-core body out, for
// probe_stream.py --float-variants alone (the build leaves it 0): 1, the
// TMA producer arrives on each slot without loading it (the consumers
// alone); 2, the consumers take no unit of a slot (the ring alone).
#ifndef MM_FLOAT_PROBE
#define MM_FLOAT_PROBE 0
#endif

// The TMA route's producer: one thread, a slot a K block: the weights'
// boxes (128 bytes of columns x kblk rows) and x's (128 bytes of K x TM
// rows), each box's bytes on the slot's full barrier; the tensor maps
// read zeros past N, K and M.  Rows of the next rank that a range's last
// block holds lie in units the consumers do not take (ranges and blocks
// are a multiple of TC_UNIT rows).  The credit rule as on the cp.async
// route: a slot is refilled only after its empty barrier completes.
template <int TN, int XB, int WB>
__device__ __forceinline__ void mm_float_produce_tma(const MmFloatArgs& a,
                                                     const FloatMaps& maps,
                                                     const FloatCta& c) {
  if (threadIdx.x != TC_CONS) return;
  const unsigned ring = h2pipe::smem_addr(c.ring);
  h2pipe::RingPos pos;
  for (int kb = 0; kb < c.nkb; ++kb) {
    h2pipe::mbar_wait(c.empty + pos.slot, pos.phase ^ 1);
    if constexpr (MM_FLOAT_PROBE == 1) {
      h2pipe::mbar_arrive(c.full + pos.slot);
      pos.next(a.nb);
      continue;
    }
    h2pipe::mbar_arrive_expect_tx(c.full + pos.slot, a.slot);
    const unsigned bar = h2pipe::smem_addr(c.full + pos.slot);
    const unsigned ws = ring + pos.slot * a.slot, xs = ws + a.kblk * a.srow;
    const int kbase = c.k0 + kb * a.kblk;
#pragma unroll
    for (int b = 0; b < TN * WB / 128; ++b)
      tma_load_2d(ws + b * a.kblk * 128, &maps.w, bar, c.n0 + b * 128 / WB,
                  kbase);
    for (int b = 0; b < a.kblk * XB / 128; ++b)
      tma_load_2d(xs + b * TM * 128, &maps.x, bar, kbase + b * 128 / XB,
                  c.m0);
    pos.next(a.nb);
  }
}

// The tensor-core body: the pairs with bf16, f16 or int8 weights.  Each
// of its 8 consumer warps owns a column group of 16, alone (tn = 128) or
// with SHARES - 1 other warps (tn = 64: 2, tn = 32: 4).  An f32 x gives
// three bf16 parts, a product each: split once a slot by all the
// consumers into rows (x_split_shared) that the units read as a bf16 x's,
// or by each warp in registers as its units read x.
template <typename TX, typename TW, int TN>
__global__ void __launch_bounds__(TC_CONS + NPROD, TC_CTAS)
    mm_float_tc(MmFloatArgs a, const __grid_constant__ FloatMaps maps) {
  constexpr int GROUPS = TN / 16, SHARES = float_shares(TN, true);
  constexpr int XB = sizeof(TX), WB = sizeof(TW);
  constexpr bool XI8 = is_i8<TX>, XF32 = is_f32<TX>, WI8 = is_i8<TW>;
  constexpr int PARTS = XF32 ? 3 : 1;
  constexpr bool XSMEM = XF32 && x_split_shared(TN);
  constexpr int XL = XI8 ? X8 : XF32 && !XSMEM ? X32 : X16;
  using MT = typename MmaType<TX, TW>::type;
  using XT = std::conditional_t<XF32, bf16, TX>;   // x's B fragments' type
  constexpr bool TF32 = std::is_same<MT, Tf32>::value;
  static_assert(float_tensor_cores(XB, WB),
                "bf16, f16 or int8 weights, not int8 x int8");
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const FloatCta c = float_cta<TN, SHARES, TC_CONS>(a, smem, rank);
  const int tid = threadIdx.x;
  const bool tma = a.tma != 0;
  if (tid >= TC_CONS) {
    if (tma)
      mm_float_produce_tma<TN, XB, WB>(a, maps, c);
    else
      mm_float_produce<TN, XB, WB, TC_CONS>(a, c.m0, c.n0, c.k0, c.k1, c.nkb,
                                            c.full, c.empty, c.ring);
  } else {
    const int lane = tid & 31, warp = tid >> 5;
    const int grp = warp % GROUPS, share = warp / GROUPS;
    const int g = lane >> 2, t = lane & 3, mi = lane >> 3, r = lane & 7;
    // this lane's ldmatrix row in a unit's weights: int8 w, matrix mi =
    // (j, h) = (mi >> 1, mi & 1), the group's 16 columns (both halves in
    // one load); 16-bit w, a half j at a time, matrix mi = (h, 8 columns)
    // = (mi >> 1, mi & 1), half 1 16 rows (half a unit) after half 0
    const unsigned w_at =
        WI8 ? tile_at(tma, unit_row<XL>(mi >> 1, mi & 1, r), grp * 16, a.srow,
                      a.kblk)
            : tile_at(tma, unit_row<XL>(0, mi >> 1, r),
                      (grp * 16 + (mi & 1) * 8) * 2, a.srow, a.kblk);
    const unsigned ring = h2pipe_mma::smem_addr(c.ring);
    const unsigned w_unit = TC_UNIT * (tma ? 128 : a.srow);
    // an f32 x's parts in shared memory: buffer kb & 1, part q's rows at
    // q * prow * TM
    const unsigned x_parts = h2pipe_mma::smem_addr(c.part + TM * TN);
    // the k16 halves; an f32 x: x0's products in acc, x1's and x2's (at
    // most 2^-8 of x0's) in acc_lo
    float acc[2][4] = {}, acc_lo[2][4] = {};
    h2pipe::RingPos pos;
    for (int kb = 0; kb < c.nkb; ++kb) {
      h2pipe::mbar_wait(c.full + pos.slot, pos.phase);
      const unsigned ws = ring + pos.slot * a.slot;
      const unsigned xs = ws + a.kblk * a.srow;
      const unsigned pb = x_parts + (kb & 1) * 3 * TM * a.prow;
      if constexpr (XSMEM && MM_FLOAT_PROBE != 2) {
        // the slot's x split once, two values a thread a step, into buffer
        // kb & 1; a slower warp may still read the other buffer, which no
        // warp writes before every warp has passed this slot's barrier
        const int pairs = a.kblk / 2;
        for (int i = tid; i < TM * pairs; i += TC_CONS) {
          const int m = i / pairs, k = 2 * (i - m * pairs);
          const uint2 v = lds64(xs + tile_at(tma, m, k * 4, a.xrow, TM));
          uint32_t p0[3], p1[3];
          split3(v.x, p0);
          split3(v.y, p1);
#pragma unroll
          for (int q = 0; q < 3; ++q)
            sts32(pb + (q * TM + m) * a.prow + k * 2,
                  pack_hi16(p0[q], p1[q]));
        }
        asm volatile("bar.sync 2, %0;\n" ::"r"(TC_CONS) : "memory");
      }
      // the units that hold rows of the range; their rows past it are zeros
      const int units =
          MM_FLOAT_PROBE == 2
              ? 0
              : (min(a.kblk, c.k1 - c.k0 - kb * a.kblk) + TC_UNIT - 1) /
                    TC_UNIT;
      // two units in flight; an f32 x's one (its three B fragment sets)
#pragma unroll(XF32 ? 1 : 2)
      for (int u = share; u < units; u += SHARES) {
        const unsigned wu = ws + u * w_unit;
        uint32_t b[PARTS][4];   // B fragment registers (j, h) at 2j + h
        if constexpr (XI8) {
          // x row g, K rows 4t .. 4t + 3 of each half
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const uint32_t v = lds32(
                xs + tile_at(tma, g, u * TC_UNIT + 16 * j + 4 * t, a.xrow, TM));
            b[0][2 * j] = widen_i8x2<MT>(v);
            b[0][2 * j + 1] = widen_i8x2<MT>(v >> 8);
          }
        } else if constexpr (XF32 && !XSMEM) {
          // ldmatrix row r of x, half j's matrix mi the unit's K rows 16j
          // + 4 mi .. + 3 (a lane's f32: 16j + 4 mi + t), split in three
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            uint32_t v[4], p[4][3];
            h2pipe_mma::ldsm_x4_at(
                v, xs + tile_at(tma, r, (u * TC_UNIT + 16 * j + 4 * mi) * 4,
                                a.xrow, TM));
#pragma unroll
            for (int i = 0; i < 4; ++i) split3(v[i], p[i]);
#pragma unroll
            for (int q = 0; q < 3; ++q) {
              b[q][2 * j] = pack_hi16(p[0][q], p[1][q]);
              b[q][2 * j + 1] = pack_hi16(p[2][q], p[3][q]);
            }
          }
        } else if constexpr (!XSMEM) {
          // ldmatrix row r of x, the unit's K rows 8 mi .. 8 mi + 7
          // (fragment (j, h) = mi)
          h2pipe_mma::ldsm_x4_at(
              b[0], xs + tile_at(tma, r, (u * TC_UNIT + 8 * mi) * 2, a.xrow,
                                 TM));
        }
        uint32_t af[2][4];   // A fragments of the two halves
        if constexpr (WI8) {
          uint32_t v[4];
          h2pipe_mma::ldsm_x4_trans_at(v, wu + w_at);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            af[j][0] = widen_i8x2<MT>(v[2 * j]);          // rows i: 2i
            af[j][1] = widen_i8x2<MT>(v[2 * j] >> 8);     // i + 8: 2i + 1
            af[j][2] = widen_i8x2<MT>(v[2 * j + 1]);
            af[j][3] = widen_i8x2<MT>(v[2 * j + 1] >> 8);
          }
        } else {
#pragma unroll
          for (int j = 0; j < 2; ++j)
            h2pipe_mma::ldsm_x4_trans_at(af[j], wu + w_at + j * w_unit / 2);
        }
        // part q's products on both halves (x0's, or x's, into acc, x1's
        // and x2's into acc_lo)
        auto products = [&](int q, const uint32_t* bq) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float* d = q ? acc_lo[j] : acc[j];
            if constexpr (TF32) {
              // k8 steps h = 0, 1: a lane's K rows of fragment register h
              // (the f16 weights widened for each part: held for all three,
              // they spilled at 56 registers)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                uint32_t at[4], b0, b1;
                widen_16x2<TW>(af[j][2 * h], at[0], at[2]);
                widen_16x2<TW>(af[j][2 * h + 1], at[1], at[3]);
                widen_16x2<XT>(bq[2 * j + h], b0, b1);
                h2pipe_mma::mma_tf32(d, at, b0, b1);
              }
            } else if constexpr (std::is_same<MT, bf16>::value) {
              h2pipe_mma::mma_bf16(d, af[j], bq[2 * j], bq[2 * j + 1]);
            } else {
              h2pipe_mma::mma_f16(d, af[j], bq[2 * j], bq[2 * j + 1]);
            }
          }
        };
        if constexpr (XSMEM) {
          // ldmatrix row r of part q, the unit's K rows 8 mi .. 8 mi + 7,
          // a part at a time
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            uint32_t bq[4];
            h2pipe_mma::ldsm_x4_at(bq, pb + (q * TM + r) * a.prow +
                                           (u * TC_UNIT + 8 * mi) * 2);
            products(q, bq);
          }
        } else {
#pragma unroll
          for (int q = 0; q < PARTS; ++q) products(q, b[q]);
        }
      }
      __syncwarp();
      if (lane == 0) h2pipe::mbar_arrive(c.empty + pos.slot);
      pos.next(a.nb);
    }
    // the warp's sums into red's row of its share: mma row i is column
    // 16 * grp + i (int8 w: 2i, and 2(i - 8) + 1 for i >= 8), its column
    // j the row j of x; the halves added, then (f32 x) the low parts'.  The
    // lane's indices read again: kept across the ring, one spilled in the
    // f32 x f16 instances at 56 registers
    float sum[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sum[e] = acc[0][e] + acc[1][e];
      if constexpr (XF32) sum[e] += acc_lo[0][e] + acc_lo[1][e];
    }
    const int et = tid_x(), ew = et >> 5, eg = (et & 31) >> 2;
    const int e2t = 2 * (et & 3);
    float* dst = c.red + ew / GROUPS * TM * TN;
    const int lo = ew % GROUPS * 16 + (WI8 ? 2 * eg : eg);
    const int hi = ew % GROUPS * 16 + (WI8 ? 2 * eg + 1 : eg + 8);
    dst[e2t * TN + lo] = sum[0];
    dst[(e2t + 1) * TN + lo] = sum[1];
    dst[e2t * TN + hi] = sum[2];
    dst[(e2t + 1) * TN + hi] = sum[3];
  }
  float_finish<typename Promoted<TX, TW>::type, TN, SHARES, TC_CONS>(
      a, c, cluster, rank);
}

// The element types of the float modes, by their codes in
// ops.FLOAT_TYPE_CODES, and their bytes.
enum { T_F32 = 0, T_BF16 = 1, T_F16 = 2, T_I8 = 3 };
constexpr int TYPE_BYTES[4] = {4, 2, 2, 1};

// An instance of a pair: the tensor-core body, which takes the TMA
// route's tensor maps, or the FFMA body, which takes none; at most one set.
struct FloatKernel {
  void (*tc)(MmFloatArgs, FloatMaps);
  void (*ffma)(MmFloatArgs);
};

// The instance of a pair: the tensor cores where float_tensor_cores
// (tiles of 32, 64 and 128 columns), else FFMA (32 and 64)
template <typename TX, typename TW, int TN>
FloatKernel float_instance() {
  if constexpr (float_tensor_cores(sizeof(TX), sizeof(TW)))
    return {mm_float_tc<TX, TW, TN>, nullptr};
  else if constexpr (TN == 128)
    return {};
  else
    return {nullptr, mm_float<TX, TW, TN>};
}

// the instance for the type code of TW
template <typename TX, int TN>
FloatKernel float_kernel_w(int w_type) {
  switch (w_type) {
    case T_F32: return float_instance<TX, float, TN>();
    case T_BF16: return float_instance<TX, bf16, TN>();
    case T_F16: return float_instance<TX, __half, TN>();
    default:
      if constexpr (is_i8<TX>)
        return {};  // int8 x int8 is mm_kernel's
      else
        return float_instance<TX, int8_t, TN>();
  }
}

// the instance for the type codes of TX and TW
template <int TN>
FloatKernel float_kernel(int x_type, int w_type) {
  switch (x_type) {
    case T_F32: return float_kernel_w<float, TN>(w_type);
    case T_BF16: return float_kernel_w<bf16, TN>(w_type);
    case T_F16: return float_kernel_w<__half, TN>(w_type);
    default: return float_kernel_w<int8_t, TN>(w_type);
  }
}

// The tensor map of a [rows, cols] operand of the type code `type`, rows
// contiguous, dims and box in elements: boxes of box_cols x box_rows, the
// 128-byte swizzle, zeros past the tensor.
cudaError_t float_map(CUtensorMap* map, const void* base, int type, int rows,
                      int cols, int box_cols, int box_rows) {
  h2pipe_tma::EncodeTiled fn = h2pipe_tma::encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const CUtensorMapDataType dt =
      type == T_F32    ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
      : type == T_BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
      : type == T_F16  ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                       : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)cols * TYPE_BYTES[type]};
  cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  cuuint32_t unit[2] = {1, 1};
  CUresult r = fn(map, dt, 2, const_cast<void*>(base), dims, strides, box,
                  unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
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
// kr rows over a cluster, K blocks of kblk rows of w and x through an
// nb-slot ring, copies of wvec (w) and xvec (x) bytes, or (tma) TMA boxes
// of 128 bytes; smem: the bytes of its layout, which mm_float_layout()
// must reproduce.  A pair with bf16, f16 or int8 weights
// (float_tensor_cores) runs mm_float_tc, its kr and kblk a multiple of
// TC_UNIT (tma: kblk a multiple of 128 bytes of x, at most 256 rows; w's
// and x's rows a multiple of 16 bytes, tn * w_bytes 128 or 256); a pair
// with f32 weights mm_float, kr a multiple of 16 and kblk of 16 where x is
// int8, else of 8.  A pair the tensor cores take launches mm_float_tc or
// returns an error, never mm_float.  out: [M, N] of the promoted type
// (Promoted).
// Returns cudaGetLastError() after the launch.
int stream_matmul_float_launch(const void* x, const void* w, void* out,
                               int x_type, int w_type, int M, int K, int N,
                               int tn, int split, int kr, int kblk, int nb,
                               int wvec, int xvec, int tma, int smem,
                               cudaStream_t stream) {
  auto vec_ok = [](int vec, int es, long row_bytes) {
    return (vec == 16 || vec == 8 || vec == 4 || (vec == es && es <= 2)) &&
           row_bytes % vec == 0;
  };
  if (x_type < 0 || x_type > 3 || w_type < 0 || w_type > 3 ||
      (x_type == T_I8 && w_type == T_I8))
    return (int)cudaErrorInvalidValue;
  const int x_bytes = TYPE_BYTES[x_type], w_bytes = TYPE_BYTES[w_type];
  const bool tc = float_tensor_cores(x_bytes, w_bytes);
  const int kstep = tc ? TC_UNIT : x_bytes == 1 ? 16 : 8;
  const int rstep = tc ? TC_UNIT : 16;
  if (M < 1 || K < 1 || N < 1 || (tn != 32 && tn != 64 && tn != 128) ||
      split < 1 ||
      split > MAX_SPLIT || kr < rstep || kr % rstep != 0 ||
      (long)split * kr < K || (long)(split - 1) * kr >= K || kblk < kstep ||
      kblk % kstep != 0 || kblk > kr || nb < 1 ||
      !vec_ok(wvec, w_bytes, (long)N * w_bytes) ||
      !vec_ok(xvec, x_bytes, (long)K * x_bytes))
    return (int)cudaErrorInvalidValue;
  if (tma && (!tc || (long)N * w_bytes % 16 != 0 ||
              (long)K * x_bytes % 16 != 0 ||
              (tn * w_bytes != 128 && tn * w_bytes != 256) ||
              kblk * x_bytes % 128 != 0 || kblk > 256))
    return (int)cudaErrorInvalidValue;
  MmFloatLayout L = mm_float_layout(tn, kblk, nb, x_bytes, w_bytes, tma);
  if (L.smem != smem) return (int)cudaErrorInvalidValue;
  FloatMaps maps = {};
  if (tma) {
    cudaError_t err =
        float_map(&maps.w, w, w_type, K, N, 128 / w_bytes, kblk);
    if (err == cudaSuccess)
      err = float_map(&maps.x, x, x_type, M, K, 128 / x_bytes, TM);
    if (err != cudaSuccess) return (int)err;
  }
  const FloatKernel fn = tn == 128  ? float_kernel<128>(x_type, w_type)
                         : tn == 64 ? float_kernel<64>(x_type, w_type)
                                    : float_kernel<32>(x_type, w_type);
  void* entry = tc ? (void*)fn.tc : (void*)fn.ffma;
  if (entry == nullptr) return (int)cudaErrorInvalidValue;
  MmFloatArgs a{static_cast<const unsigned char*>(x),
                static_cast<const unsigned char*>(w), out, M, K, N, kr,
                kblk, nb, wvec, xvec, tma, L.srow, L.xrow, L.slot, L.prow};
  cudaError_t err = cudaFuncSetAttribute(
      entry, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + tn - 1) / tn, split, (M + TM - 1) / TM);
  cfg.blockDim = dim3(float_consumers(tc) + NPROD);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = tc ? cudaLaunchKernelEx(&cfg, fn.tc, a, maps)
           : cudaLaunchKernelEx(&cfg, fn.ffma, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
