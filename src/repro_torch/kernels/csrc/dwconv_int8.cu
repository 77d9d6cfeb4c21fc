// int8 depthwise SAME conv with the requant epilogue fused: the MobileNet
// layer engine (groups == C, weights [k, k, 1, C]).
//
// Replaces the Pallas kernels of repro/kernels/conv2d_int8/kernel.py:
//   _dwconv_kernel         (pinned taps)        -> dw_kernel<false, K, S, NC>
//   _dwconv_stream_kernel  (HBM-streamed taps)  -> dw_kernel<true, K, S, NC>
//
// What bounds it on an H100.  A depthwise conv sums over taps only, never
// over channels, so the tensor cores do not apply.  At batch 8 the 17 dw
// layers of MobileNetV2 move 48.4 MB, a 14.5 us byte bound at 3.35 TB/s,
// and do 0.166 G int8 MACs: about 5.6 us at one instruction a MAC on 132
// SMs at 1.76 GHz.  The first version of this kernel took 238.8 us over
// them pinned and 297.5 streamed (NVIDIA H100 80GB HBM3, 700.00 W): each
// CTA ran 1-3 output rows as a serial chain (row loads through registers
// by 32-128 threads, a barrier, 9 taps of MACs, a store) with nothing in
// flight while it computed, and spent about 3 instructions a MAC
// extracting and sign-extending bytes.  So what bounds it is latency and
// the instructions a MAC (the requant epilogue costs about as many again),
// not the bytes, and the design goes after both.
//
// The design.
//  * A CTA walks a band of output rows of one (channel tile, image).  Its
//    input rows enter a ring of k + 2*stride row slots in shared memory by
//    cp.async (16 bytes where C % 16 == 0, else 8 or 4), spread over all
//    its compute threads; zero-fill (src-size 0) stands in for the SAME
//    padding and the rows outside the map.  While output row r computes,
//    the rows of r+1 and r+2 are in flight (one commit group per output
//    row, cp.async.wait_group 2).  An input byte is fetched once per band;
//    only the band's halo rows twice.
//  * A thread owns one quad of channels (a 32-bit word) and NC consecutive
//    output columns (8; 4 at stride 2 where 8 leaves few warps).  Per
//    kernel row it loads the words its windows read once, transposes each
//    group of four columns into one word per channel (8 byte permutes),
//    and then every output takes one byte permute for its window and one
//    dp4a for up to 4 taps of the row (two for k = 5, 7).  The MAC block
//    of the 3x3 stride-1 instance is 1.24 instructions a MAC in its sm_90a
//    SASS, against about 3.  dp4a sums int8 x int8 exactly into int32 (at
//    most 49 * 127 * 127 in magnitude), the window's bytes beyond the k
//    taps meet zero weight bytes, so the epilogue sees the same integers.
//  * The epilogue (requant_dw) is h2pipe::requant with the scale product
//    hoisted and the clip folded into cvt.rni.sat.s8: the same f32 and
//    int8 values in fewer instructions.
//  * ops.dw_plan picks the tile (any multiple of the copy width, so C =
//    144 or 200 leave no idle quads), the column groups (quads x groups
//    threads, whole warps, at most 256) and the band length (about 512
//    compute threads per SM pinned, 1024 streamed); layout() below mirrors
//    ops.dw_layout.  A gap of padw words after every NC*S columns of a
//    ring row puts the column groups of a warp on consecutive banks.
//    Registers (-Xptxas -v: 62-168, no spills) allow the pinned tier's aim
//    at 3x3 (101 at NC = 8: five 128-thread CTAs an SM) but cap the
//    streamed tier below its aim (96 at 3x3 stride 1: four 160-thread
//    CTAs); its shorter bands still give each SM as many rings as fit.
//
// Weight tiers.
//   pinned:   each thread reads its quad's k*k taps from device memory
//             once per CTA and keeps them, packed for dp4a, in registers.
//   streamed: the [1, C_tile] taps are fetched again for every output row
//             (Eq. 2) by a producer warp, through a min(n_buffers, k*k)-
//             slot ring in shared memory.  A slot has a full mbarrier (the
//             producer's cp.async arrives on it when the copy lands) and an
//             empty one (every compute warp arrives once it has read the
//             slot); the producer refills a slot only after its empty
//             barrier completes (the credit rule of section V-A).  The
//             compute threads read a kernel row's taps just before its
//             MACs, so the fetches of the next taps, and across rows of the
//             band, overlap them; every fetch of a tap serves one output
//             row, and the ring is never deeper than n_buffers.
#include <type_traits>

#include "common.cuh"

namespace {

using h2pipe::cp_async16;
using h2pipe::cp_async4;
using h2pipe::cp_async8;
using h2pipe::cp_async_commit;
using h2pipe::cp_async_wait;

constexpr int MAX_THREADS = 256;  // compute threads of a CTA, at most
constexpr int PREFETCH = 2;    // output rows whose input rows are in flight
constexpr int MAX_SMEM = 232448;

struct DwArgs {
  const int8_t* x;
  const int8_t* w;
  const float* w_scale;
  const float* bias;
  float act_scale, inv_act;
  int8_t* out_q;
  float* out_f;
  int32_t* out_i32;
  int B, H, W, C, Ho, Wo, pad_t, pad_l;
  int quads, groups, rows_per_band, n_buffers, relu;
  int threads;    // compute threads: quads * groups, rounded up to a warp
  int vec;        // words per row copy: 4, 2 or 1, as C allows
  int row_words;  // words of a ring row, bank gaps included
  int padw;       // words of bank gap after every NC*S columns
  int chunks;     // ceil(Wo / NC), NC the columns a thread owns
  int Wp;         // columns the outputs read: (Wo - 1) * S + K
};

// ---- mbarriers (the streamed tier's tap ring) ---------------------------

__device__ __forceinline__ unsigned saddr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::
          "r"(saddr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(saddr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Arrive on `bar` when this thread's earlier cp.asyncs have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(saddr(bar))
               : "memory");
}

// ---- the pieces of dw_kernel -------------------------------------------

// Word offset of ring column wp within a row: bank gaps after every
// P = NC*S columns.
template <int S, int NC>
__device__ __forceinline__ int col_word(const DwArgs& a, int wp) {
  return wp * a.quads + wp / (NC * S) * a.padw;
}

// Where a thread's row copies fall: copy idx = tid, tid + threads, ...
// is (column, vector) = (idx / vpc, idx % vpc), vpc = quads / VEC copies
// a column; computed once, then stepped without a division.
struct CopySteps {
  int vpc, iw0, v0, step_iw, step_v;
};

// Copy padded input row ih of image b, channel tile c0, into ring row
// `dst`: every column the outputs read (0 .. Wp-1), VEC words a copy;
// zero-fill (src-size 0) for the SAME padding and rows outside the map.
template <int S, int NC, int VEC>
__device__ __forceinline__ void load_row(const DwArgs& a, const CopySteps& cs,
                                         int b, int c0, int ih, int* dst) {
  const bool row_in = ih >= 0 && ih < a.H;
  const int8_t* src = a.x + ((size_t)b * a.H + (row_in ? ih : 0)) * a.W *
                                a.C;
  int wp = cs.iw0, v = cs.v0;
  while (wp < a.Wp) {
    const int iw = wp - a.pad_l, c = c0 + 4 * VEC * v;
    const bool ok = row_in && iw >= 0 && iw < a.W && c < a.C;
    int* d = dst + col_word<S, NC>(a, wp) + v * VEC;
    const int8_t* s = ok ? src + (size_t)iw * a.C + c : a.x;
    if (VEC == 4)
      cp_async16(d, s, ok);
    else if (VEC == 2)
      cp_async8(d, s, ok);
    else
      cp_async4(d, s, ok);
    wp += cs.step_iw;
    v += cs.step_v;
    if (v >= cs.vpc) {
      v -= cs.vpc;
      ++wp;
    }
  }
}

template <int S, int NC>
__device__ __forceinline__ void load_rows(const DwArgs& a,
                                          const CopySteps& cs, int b, int c0,
                                          int lo, int hi, int ring_rows,
                                          int* ring, int& slot) {
  for (int ih = lo; ih <= hi; ++ih) {
    int* dst = ring + slot * a.row_words;
    if (a.vec == 4)
      load_row<S, NC, 4>(a, cs, b, c0, ih, dst);
    else if (a.vec == 2)
      load_row<S, NC, 2>(a, cs, b, c0, ih, dst);
    else
      load_row<S, NC, 1>(a, cs, b, c0, ih, dst);
    if (++slot == ring_rows) slot = 0;
  }
}

// Put byte m of `word` at byte position p of `dst` (one byte permute).
template <int M, int P>
__device__ __forceinline__ int put_byte(int dst, int word) {
  constexpr unsigned sel = ((P == 0 ? 4 + M : 0) << 0) |
                           ((P == 1 ? 4 + M : 1) << 4) |
                           ((P == 2 ? 4 + M : 2) << 8) |
                           ((P == 3 ? 4 + M : 3) << 12);
  return (int)__byte_perm((unsigned)dst, (unsigned)word, sel);
}

// Tap word `word` (channels m = 0..3 of this quad) of kernel row I, column
// J goes into the dp4a operands: pw[I][m][J / 4], byte J % 4.
template <int K, int NDP, int I, int J>
__device__ __forceinline__ void pack_tap(int (&pw)[K][4][NDP], int word) {
  pw[I][0][J / 4] = put_byte<0, J % 4>(pw[I][0][J / 4], word);
  pw[I][1][J / 4] = put_byte<1, J % 4>(pw[I][1][J / 4], word);
  pw[I][2][J / 4] = put_byte<2, J % 4>(pw[I][2][J / 4], word);
  pw[I][3][J / 4] = put_byte<3, J % 4>(pw[I][3][J / 4], word);
}

// 4x4 byte transpose: x[k] holds channels 0..3 of column k; t[m] gets
// columns 0..3 of channel m.
__device__ __forceinline__ void transpose4(const int (&x)[4], int& t0,
                                           int& t1, int& t2, int& t3) {
  unsigned a = __byte_perm(x[0], x[1], 0x5140);  // c0:k0 k1, c1:k0 k1
  unsigned b = __byte_perm(x[2], x[3], 0x5140);  // c0:k2 k3, c1:k2 k3
  unsigned c = __byte_perm(x[0], x[1], 0x7362);  // c2:k0 k1, c3:k0 k1
  unsigned d = __byte_perm(x[2], x[3], 0x7362);
  t0 = (int)__byte_perm(a, b, 0x5410);
  t1 = (int)__byte_perm(a, b, 0x7632);
  t2 = (int)__byte_perm(c, d, 0x5410);
  t3 = (int)__byte_perm(c, d, 0x7632);
}

// Bytes o..o+3 of a channel's transposed columns (o is a constant once
// the caller's loops are unrolled; the NT4 words cover every window).
template <int NT4>
__device__ __forceinline__ int window(const int (&t)[NT4], int o) {
  const int w = o >> 2;
  const unsigned s = o & 3;
  if (s == 0) return t[w];
  return (int)__byte_perm((unsigned)t[w], (unsigned)t[w + 1],
                          s | ((s + 1) << 4) | ((s + 2) << 8) |
                              ((s + 3) << 12));
}

// acc[m][n] += sum_j x[row, (ow0 + n) * S + j, m] * w[row, j, m] for one
// kernel row, whose ring row starts at `src` (this thread's quad and its
// chunk's first column already added).
template <int K, int S, int NC, int NDP, int NT4, int I>
__device__ __forceinline__ void mac_row(const DwArgs& a, const int* src,
                                        const int (&pw)[K][4][NDP],
                                        int (&acc)[4][NC]) {
  int t[4][NT4];
#pragma unroll
  for (int g = 0; g < NT4; ++g) {
    int x[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = src[col_word<S, NC>(a, 4 * g + k)];
    transpose4(x, t[0][g], t[1][g], t[2][g], t[3][g]);
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      acc[m][n] = __dp4a(window(t[m], n * S), pw[I][m][0], acc[m][n]);
      if (NDP > 1)
        acc[m][n] = __dp4a(window(t[m], n * S + 4), pw[I][m][NDP - 1],
                           acc[m][n]);
    }
  }
}

// Kernel rows I..K-1, from ring slot `slot` on; before each row,
// pre(integral_constant<I>) (the streamed tier gathers its taps there),
// and the MACs only where this thread has a chunk (`work`).
template <int K, int S, int NC, int NDP, int NT4, int I, typename Pre>
__device__ __forceinline__ void mac_rows(const DwArgs& a, const int* ring,
                                         int slot, int ring_rows, int off,
                                         bool work, Pre& pre,
                                         int (&pw)[K][4][NDP],
                                         int (&acc)[4][NC]) {
  if constexpr (I < K) {
    pre(std::integral_constant<int, I>{});
    if (work)
      mac_row<K, S, NC, NDP, NT4, I>(a, ring + slot * a.row_words + off, pw,
                                     acc);
    if (++slot == ring_rows) slot = 0;
    mac_rows<K, S, NC, NDP, NT4, I + 1>(a, ring, slot, ring_rows, off, work,
                                        pre, pw, acc);
  }
}

// Taps J..K-1 of kernel row I, each word from next(), into pw[I].
template <int K, int NDP, int I, int J, typename F>
__device__ __forceinline__ void pack_row(int (&pw)[K][4][NDP], F& next) {
  if constexpr (J < K) {
    pack_tap<K, NDP, I, J>(pw, next());
    pack_row<K, NDP, I, J + 1>(pw, next);
  }
}

// Kernel rows I..K-1, every tap from next(), into pw.
template <int K, int NDP, int I, typename F>
__device__ __forceinline__ void pack_rows(int (&pw)[K][4][NDP], F& next) {
  if constexpr (I < K) {
    pack_row<K, NDP, I, 0>(pw, next);
    pack_rows<K, NDP, I + 1>(pw, next);
  }
}

// h2pipe::requant with the scale product (w_scale * act_scale, rounded
// once) taken out of the loop and the clip to +-127 folded into a
// saturating conversion: rint(max(v, -127)) == max(rint(v), -127), and
// cvt.rni.sat.s8 rounds half to even and clips at 127.  The same f32
// value and the same int8 as h2pipe::requant.
__device__ __forceinline__ float requant_dw(int acc, float scale, float bias,
                                            float inv_act, bool relu,
                                            int* q) {
  float y = __fmaf_rn(__int2float_rn(acc), scale, bias);
  if (relu) y = fmaxf(y, 0.0f);
  const float v = fmaxf(__fmul_rn(y, inv_act), -127.0f);
  asm("cvt.rni.sat.s8.f32 %0, %1;\n" : "=r"(*q) : "f"(v));
  return y;
}

template <int NC>
__device__ __forceinline__ void store_chunk(const DwArgs& a, int b, int r,
                                            int c, int ow0,
                                            const float (&sc)[4],
                                            const float (&bi)[4],
                                            const int (&acc)[4][NC]) {
  if (c >= a.C) return;
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    const int ow = ow0 + n;
    if (ow >= a.Wo) break;
    size_t off = (((size_t)b * a.Ho + r) * a.Wo + ow) * a.C + c;
    if (a.out_i32) {
      *reinterpret_cast<int4*>(a.out_i32 + off) =
          make_int4(acc[0][n], acc[1][n], acc[2][n], acc[3][n]);
      continue;
    }
    int qv[4];
    float yf[4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
      yf[m] = requant_dw(acc[m][n], sc[m], bi[m], a.inv_act, a.relu != 0,
                         &qv[m]);
    *reinterpret_cast<unsigned*>(a.out_q + off) =
        __byte_perm(__byte_perm(qv[0], qv[1], 0x0040),
                    __byte_perm(qv[2], qv[3], 0x0040), 0x5410);
    if (a.out_f)
      *reinterpret_cast<float4*>(a.out_f + off) =
          make_float4(yf[0], yf[1], yf[2], yf[3]);
  }
}

// The compute threads' barrier: all of them, not the producer warp.
template <bool STREAM>
__device__ __forceinline__ void consumers_sync(int threads) {
  if (STREAM)
    asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
  else
    __syncthreads();
}

// The streamed tier's producer warp: n tap fetches (k*k per output row, in
// the order the compute warps read them) through the nb-slot ring.
__device__ __forceinline__ void produce_taps(const DwArgs& a, int c0, int kk,
                                             int n, int nb, uint64_t* full,
                                             uint64_t* empty, int* slots) {
  const int lane = threadIdx.x & 31;
  int slot = 0, phase = 0, t = 0;
  for (int i = 0; i < n; ++i) {
    mbar_wait(empty + slot, phase ^ 1);   // every reader is done with it
    int* dst = slots + slot * a.quads;
    for (int q = lane; q < a.quads; q += 32) {
      const int c = c0 + 4 * q;
      const bool ok = c < a.C;
      cp_async4(dst + q, ok ? a.w + (size_t)t * a.C + c : a.w, ok);
    }
    cp_async_arrive(full + slot);
    if (++t == kk) t = 0;
    if (++slot == nb) {
      slot = 0;
      phase ^= 1;
    }
  }
  cp_async_wait(0);
}

template <bool STREAM, int K, int S, int NC>
__global__ void __launch_bounds__(STREAM ? MAX_THREADS + 32 : MAX_THREADS)
    dw_kernel(DwArgs a) {
  constexpr int NDP = (K + 3) / 4;                   // dp4a words a row
  constexpr int NT4 = ((NC - 1) * S + 4 * NDP + 3) / 4;
  constexpr int RING = K + PREFETCH * S;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = STREAM ? min(a.n_buffers, K * K) : 0;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + nb;
  int* tap_slots = reinterpret_cast<int*>(smem + 16 * nb);
  int* ring = tap_slots + nb * a.quads;

  const int c0 = blockIdx.x * 4 * a.quads;
  const int r0 = blockIdx.y * a.rows_per_band;
  const int r1 = min(a.Ho, r0 + a.rows_per_band);
  const int b = blockIdx.z;
  const int tid = threadIdx.x;

  if (STREAM) {
    if (tid == 0) {
      for (int s = 0; s < nb; ++s) {
        mbar_init(full + s, 32);             // the producer's 32 lanes
        mbar_init(empty + s, a.threads / 32);  // one arrive a compute warp
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid >= a.threads) {
      produce_taps(a, c0, K * K, (r1 - r0) * K * K, nb, full, empty,
                   tap_slots);
      return;
    }
  }

  CopySteps cs;
  cs.vpc = a.quads / a.vec;
  cs.iw0 = tid / cs.vpc;
  cs.v0 = tid - cs.iw0 * cs.vpc;
  cs.step_iw = a.threads / cs.vpc;
  cs.step_v = a.threads - cs.step_iw * cs.vpc;

  // The first PREFETCH output rows' input rows, one commit group each.
  int load_slot = 0;
  int next = r0 * S - a.pad_t;              // next input row to copy
  const int last = (r1 - 1) * S - a.pad_t + K - 1;
#pragma unroll
  for (int p = 0; p < PREFETCH; ++p) {
    const int hi = min(last, (r0 + p) * S - a.pad_t + K - 1);
    load_rows<S, NC>(a, cs, b, c0, next, hi, RING, ring, load_slot);
    next = max(next, hi + 1);
    cp_async_commit();
  }

  const int group = tid / a.quads;          // >= groups: no columns
  const int q = tid - group * a.quads;
  const bool active = group < a.groups;
  const int c = c0 + 4 * q;
  float sc[4] = {0.f, 0.f, 0.f, 0.f}, bi[4] = {0.f, 0.f, 0.f, 0.f};
  if (!a.out_i32 && c < a.C) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      sc[m] = __fmul_rn(a.w_scale[c + m], a.act_scale);   // the scale
      bi[m] = a.bias[c + m];
    }
  }
  int pw[K][4][NDP];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int d = 0; d < NDP; ++d) pw[i][m][d] = 0;
  if (!STREAM) {                            // the pinned tier: once a CTA
    const int* wq = reinterpret_cast<const int*>(a.w + c);
    const size_t tap_words = a.C / 4;
    int t = 0;
    auto next_w = [&]() {
      int v = c < a.C ? __ldg(wq + (size_t)t * tap_words) : 0;
      ++t;
      return v;
    };
    pack_rows<K, NDP, 0>(pw, next_w);
  }

  int tap_slot = 0, tap_phase = 0;
  int top_slot = 0;                         // ring slot of row r*S - pad_t
  for (int r = r0; r < r1; ++r) {
    consumers_sync<STREAM>(a.threads);               // row r-1 is done with the ring
    const int hi = min(last, (r + PREFETCH) * S - a.pad_t + K - 1);
    load_rows<S, NC>(a, cs, b, c0, next, hi, RING, ring, load_slot);
    next = max(next, hi + 1);
    cp_async_commit();
    cp_async_wait(PREFETCH);                // row r's input rows landed
    consumers_sync<STREAM>(a.threads);
    // The streamed tier reads this row's k*k taps kernel row by kernel
    // row, each just before its MACs, so that the producer's next fetches
    // overlap them; every compute thread reads every tap once (threads
    // without a chunk too: the empty barriers count every warp).
    const int lane = tid & 31;
    auto next_tap = [&]() {
      mbar_wait(full + tap_slot, tap_phase);
      const int v = tap_slots[tap_slot * a.quads + q];
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + tap_slot);     // credit returns
      if (++tap_slot == nb) {
        tap_slot = 0;
        tap_phase ^= 1;
      }
      return v;
    };
    bool gather = STREAM;
    for (int ch = group; gather || (active && ch < a.chunks);
         ch += a.groups) {
      const bool work = active && ch < a.chunks;
      auto pre = [&](auto row) {
        constexpr int I = decltype(row)::value;
        if (STREAM && gather) {
#pragma unroll
          for (int m = 0; m < 4; ++m)
#pragma unroll
            for (int d = 0; d < NDP; ++d) pw[I][m][d] = 0;
          pack_row<K, NDP, I, 0>(pw, next_tap);
        }
      };
      int acc[4][NC];
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < NC; ++n) acc[m][n] = 0;
      const int off = col_word<S, NC>(a, ch * NC * S) + q;
      mac_rows<K, S, NC, NDP, NT4, 0>(a, ring, top_slot, RING, off, work,
                                      pre, pw, acc);
      if (work) store_chunk<NC>(a, b, r, c, ch * NC, sc, bi, acc);
      gather = false;
    }
    top_slot += S;
    if (top_slot >= RING) top_slot -= RING;
  }
}

// Ring layout of one CTA (ops.dw_layout mirrors this).
struct Layout {
  int cols, row_words, padw, ring_rows, tap_slots;
  long smem;
};

Layout layout(int Wo, int k, int s, int nc, int quads, int stream,
              int n_buffers) {
  Layout L;
  const int period = nc * s;
  const int chunks = (Wo + nc - 1) / nc;
  const int ndp = (k + 3) / 4;
  const int nt4 = ((nc - 1) * s + 4 * ndp + 3) / 4;
  L.cols = (chunks - 1) * period + 4 * nt4;
  if (L.cols < (Wo - 1) * s + k) L.cols = (Wo - 1) * s + k;
  // the gap that puts the next column group's first word on the bank after
  // this group's last: a warp's lanes then read 32 consecutive banks
  L.padw = ((quads * (1 - period)) % 32 + 32) % 32;
  L.row_words = L.cols * quads + L.padw * ((L.cols - 1) / period);
  L.ring_rows = k + PREFETCH * s;
  L.tap_slots = stream ? (n_buffers < k * k ? n_buffers : k * k) : 0;
  L.smem = (long)L.tap_slots * (quads * 4 + 16) +
           (long)L.ring_rows * L.row_words * 4;
  return L;
}

template <bool STREAM, int K, int S>
void* pick_nc(int nc) {
  return nc == 4 ? (void*)dw_kernel<STREAM, K, S, 4>
                 : (void*)dw_kernel<STREAM, K, S, 8>;
}

template <bool STREAM, int K>
void* pick_s(int s, int nc) {
  return s == 1 ? pick_nc<STREAM, K, 1>(nc) : pick_nc<STREAM, K, 2>(nc);
}

template <bool STREAM>
void* pick(int k, int s, int nc) {
  switch (k) {
    case 1: return pick_s<STREAM, 1>(s, nc);
    case 3: return pick_s<STREAM, 3>(s, nc);
    case 5: return pick_s<STREAM, 5>(s, nc);
    default: return pick_s<STREAM, 7>(s, nc);
  }
}

// Whether each instance has been allowed the largest dynamic shared memory
// (set once, on its first launch).
bool smem_set[2][8][2][2];

}  // namespace

extern "C" {

// Launches on `stream`.  Exactly one of out_q (int8, fused requant; out_f
// optional f32 pre-quant values) and out_i32 (raw int32 sums) is set.
// `quads` is the channel tile in groups of four channels, `cols` (4 or 8)
// the consecutive output columns a thread owns, `groups` the column groups
// that share a CTA and `rows_per_band` the output rows a CTA walks, all
// from ops.dw_plan; a CTA has quads * groups compute threads, rounded up
// to a warp, at most 256.  k_h == k_w in {1, 3, 5, 7}, stride in {1, 2}.
// Returns cudaGetLastError() after the launch.
int dwconv_int8_launch(const int8_t* x, const int8_t* w, const float* w_scale,
                       const float* bias, float act_scale, float inv_act,
                       int8_t* out_q, float* out_f, int32_t* out_i32, int B,
                       int H, int W, int C, int Ho, int Wo, int kh, int kw,
                       int stride, int pad_t, int pad_l, int quads, int cols,
                       int groups, int rows_per_band, int streamed,
                       int n_buffers, int relu, cudaStream_t stream) {
  const int vec = (C & 15) == 0 ? 4 : (C & 7) == 0 ? 2 : 1;
  const int threads = (quads * groups + 31) / 32 * 32;
  if ((C & 3) != 0 || n_buffers < 1 || kh != kw ||
      (kh != 1 && kh != 3 && kh != 5 && kh != 7) ||
      (stride != 1 && stride != 2) || quads < 1 || quads % vec != 0 ||
      (cols != 4 && cols != 8) || groups < 1 || threads > MAX_THREADS ||
      rows_per_band < 1)
    return (int)cudaErrorInvalidValue;
  Layout L = layout(Wo, kh, stride, cols, quads, streamed, n_buffers);
  if (L.smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  DwArgs a{x, w, w_scale, bias, act_scale, inv_act, out_q, out_f, out_i32,
           B, H, W, C, Ho, Wo, pad_t, pad_l,
           quads, groups, rows_per_band, n_buffers, relu, threads, vec,
           L.row_words, L.padw, (Wo + cols - 1) / cols,
           (Wo - 1) * stride + kh};

  void* fn = streamed ? pick<true>(kh, stride, cols)
                      : pick<false>(kh, stride, cols);
  bool& set = smem_set[streamed ? 1 : 0][kh][stride - 1][cols == 8];
  if (!set) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    set = true;
  }
  const int c_tiles = (C / 4 + quads - 1) / quads;
  const int bands = (Ho + rows_per_band - 1) / rows_per_band;
  dim3 grid(c_tiles, bands, B);
  void* args[] = {&a};
  cudaError_t err = cudaLaunchKernel(
      fn, grid, dim3(streamed ? threads + 32 : threads), args,
      (size_t)L.smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
