// int8 SAME conv with the requant epilogue fused: the HPIPE layer engine.
//
// Replaces the Pallas kernels of repro/kernels/conv2d_int8/kernel.py:
//   _conv_kernel         (pinned weights)   -> conv_mma<..>
//   _conv_stream_kernel  (HBM-streamed)     -> conv_stream<..>
//
// conv_mma: the pinned tier on the int8 tensor cores, as an implicit GEMM:
// M is output pixels, N output channels, K input channels, summed over the
// k_h x k_w taps with mma.sync m16n8k32 (s8 x s8 -> s32).  The int32 sums
// are exact, so the result is bit-identical to the plain path in any
// order; the epilogue is h2pipe::requant (ROADMAP F1).
//   Work split.  A CTA covers (C_out tile of NTILE in {16, 32, 64}
//     channels, band of output rows, image), with 4 warps.  It walks the
//     band's output pixels, flattened row by row, in chunks of MT = 64 (a
//     chunk spans several rows at the 28x28 and smaller maps, so the MMA
//     stays full); a warp owns MT/WM pixels x NTILE/WN channels.
//   Weights.  The CTA loads its C_out slice of every tap into shared memory
//     once and reuses it for every chunk of its band (the on-chip M20K
//     weight buffer).  The fill transposes the HWIO slice into K-contiguous
//     [tap][C_out][C] rows (a 4x4 byte transpose per word) with a 16-byte
//     gap a row, so the B fragments come by ldmatrix without conflicts;
//     each thread keeps several 16-byte (or 4-byte) loads in flight.
//   Line buffer.  A ring of input rows, each row its SAME-padded pixels at
//     a pixel stride of round32(C) + 16 bytes (the gap puts the 8 rows of
//     an ldmatrix in distinct banks), filled with 16-, 8- or 4-byte
//     cp.async copies that zero-fill the padding.  At stride s the row's
//     pixels are stored by phase (pixel p at (p % s) * Q + p / s), so the
//     pixels (ow * s + j) of consecutive ow are consecutive; the ring
//     keeps only the rows and phases some output reads (a 1x1 at stride 2
//     reads one in four).  The rows of chunk q + 1 are in flight while
//     chunk q is computed; the ring slides by the rows a chunk adds and
//     never reloads a row.  A fragments come by ldmatrix with one address
//     per lane: pixel (ow * s + j) of the ring row of input row r * s + i,
//     so a tap's shift and the stride cost no copy.
//   The stem (C < 16, or C not a multiple of 4: the 7x7 and 3x3 stems at
//     C = 3).  K packs the whole (k_h x k_w x C) patch, in HWIO order, into
//     one tap: per chunk the CTA gathers each pixel's patch from a ring of
//     raw padded rows into an [MT][K] tile (a k32 step is then not 90%
//     padding: 147 of 160 bytes at 7x7x3).  ops.stem_k_index names the
//     packing.
//   Plan.  ops.conv_plan picks the instance, rows a band and layout per shape
//     (pure and cached); layout() below mirrors ops.conv_layout, and the
//     launch refuses a plan whose shared-memory bytes it does not match.
//
// conv_stream: the HBM-streamed tier, on the same int8 tensor cores and
// with the same exact sums and epilogue.  The weights are fetched again
// for every output row (Eq. 2), so the weight stream, not the MMA rate,
// is the work.
//   Work split.  A CTA covers a C_out tile (16, 32 or 64 channels), g
//     images and seg output columns of a band of output rows: its M is the
//     g * seg <= MT pixels of a row, the batch riding M as the TPU
//     kernel's W_out rides its lanes (batch 8 at 7x7: 56 pixels; VGG-16's
//     fc0: 8, where all four MMA warps split N).  Warps 0-3 run the MMAs,
//     warps 4-6 stream the weights, warp 7 the input rows.
//   The weight ring.  For each output row every (tap, K block) slice of kb
//     input channels x n_tile passes once through min(n_buffers, slices a
//     row) slots, shared by the CTA's g images.  The HWIO rows of a slice
//     are C_out-contiguous, the MMA's B operand K-contiguous: the raw rows
//     arrive by cp.async in STAGING staging slots (three slices in flight,
//     16-byte chunks XOR-swizzled so the reads below are conflict-free),
//     then the weight warps transpose them in registers (4x4 byte
//     transposes) into the slot's [n_tile][kb + 16] rows, which ldmatrix
//     reads without conflicts.  A slot has a full and an empty mbarrier;
//     it is refilled only after every MMA warp has arrived on its empty
//     barrier (the credit rule of section V-A).  No second copy of the
//     weights is kept in device memory.
//   The input rows.  Per output row, stage by stage (kernel row i, K block
//     kk), the g images' input row under it, SAME-padded, by stride phase
//     as in conv_mma, into a 2-stage ring on mbarriers; warp 7 fills them
//     with one bulk copy (the copy engine) per pixel where C % 16 == 0, so
//     a stage's copies never hold up the weights.  An input row is read
//     once per (output row, kernel row, K block) of a CTA.
//   What a launch reads from global memory: each (image group, column
//     segment) reads the whole weight tensor once per output row, groups
//     * nseg / B of the Eq. 2 words (ExecutionReport counts B a row); each
//     C_out tile reads about k_h / s times the input (ops.stream_bytes_read).
//   Plan.  ops.stream_plan picks the tile, g, seg, the band, kb and the
//     layout per shape (pure and cached); stream_layout() below mirrors
//     ops.stream_layout, and the launch refuses a plan whose
//     shared-memory bytes it does not match.
//
// What bounds it on an H100.  A layer's bound is a microsecond or two (a
// ResNet 3x3 layer's 1.85 GOP take about 1 us at 1,979 TOP/s, its
// activations about as long at 3.35 TB/s), so fills, the line buffer, the
// epilogue and occupancy set conv_mma's time, not the MMA rate: that is
// why it issues mma.sync (half of wgmma's rate is still far from the
// bound) and keeps the shifted-pixel gather, which no canonical wgmma
// shared-memory layout describes.  conv_stream re-reads its weights for
// every output row: from the L2 at ResNet-50's shapes, from HBM at VGG-16's
// fc0 (102.8 MB), where its rate stays below what a plain reader of the
// same 32-byte column pieces gets.  PERF.md has the times, and what was
// learned of where they go.
#include "common.cuh"

namespace {

using h2pipe::cp_async4;
using h2pipe::cp_async_commit;
using h2pipe::cp_async_wait;

// ---------------------------------------------------------------------------
// conv_mma: the pinned tier on the int8 tensor cores
// ---------------------------------------------------------------------------

constexpr int MT = 64;     // output pixels a chunk
constexpr int NT1 = 128;   // threads: 4 warps
constexpr int WBATCH = 8;  // weight words a thread has in flight per batch

struct MmaArgs {
  const int8_t* x;
  const int8_t* w;
  const float* w_scale;
  const float* bias;
  float act_scale, inv_act;
  int8_t* out_q;
  float* out_f;
  int32_t* out_i32;
  int B, H, W, C, Ho, Wo, Co, kh, kw, stride, pad_t, pad_l, relu;
  int rows_per_band;
  // the layout (layout() below)
  int taps;   // taps a K group: k_h * k_w, or 1 for the packed stem
  int ceff;   // K rows a tap: C, or k_h * k_w * C for the packed stem
  int kp;     // ceff rounded up to 32
  int wrow;   // bytes of one weight row: kp + 16
  int wpad;   // padded input columns the outputs read: (Wo - 1) * s + kw
  int rs;     // ring rows a stride step: min(s, kh)
  int q;      // pixel slots a stride phase: ceil(wpad / s)
  int pix;    // bytes a pixel slot: kp + 16 (packed: C)
  int rowb;   // bytes of one ring row
  int ring;   // ring rows
  int arow;   // packed: bytes of one row of the [MT][kp] patch tile
  int vec;    // bytes a cp.async of the line buffer: 16, 8 or 4
};

struct Layout {
  int taps, ceff, kp, wrow, wpad, rs, q, pix, rowb, ring, arow;
  long smem;
};

// ops.conv_layout mirrors this.  Shared memory of one CTA: the weights
// [taps][ntile][wrow], the ring [ring][rowb], and for the packed stem the
// patch tile [MT][arow].  The ring keeps only the input rows and stride
// phases some output reads (rs = min(s, kh) rows and min(s, kw) phases a
// stride step: at a 1x1 stride-2 conv one in four), and holds every row
// that two consecutive chunks read (the rows of chunk q + 1 are fetched
// while chunk q is computed), and no more than the band reads.
Layout layout(int C, int Wo, int kh, int kw, int s, int rows_per_band,
              int packed, int ntile) {
  Layout L;
  L.taps = packed ? 1 : kh * kw;
  L.ceff = packed ? kh * kw * C : C;
  L.kp = (L.ceff + 31) / 32 * 32;
  L.wrow = L.kp + 16;
  L.wpad = (Wo - 1) * s + kw;
  L.rs = s < kh ? s : kh;
  if (packed) {
    L.q = L.wpad;
    L.pix = C;
    L.rowb = (L.wpad * C + 15) / 16 * 16;
    L.arow = L.kp + 16;
  } else {
    L.q = (L.wpad + s - 1) / s;
    L.pix = L.kp + 16;
    L.rowb = (s < kw ? s : kw) * L.q * L.pix;
    L.arow = 0;
  }
  int two_chunks = ((2 * MT - 1) / Wo + 1) * L.rs + kh;
  int band = (rows_per_band - 1) * L.rs + kh;
  L.ring = two_chunks < band ? two_chunks : band;
  L.smem = (long)L.taps * ntile * L.wrow + (long)L.ring * L.rowb +
           (packed ? (long)MT * L.arow : 0);
  return L;
}

__device__ __forceinline__ unsigned saddr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices (8 rows of 16 bytes each) from shared memory;
// lanes 8i..8i+7 give the row addresses of matrix i, register i holds
// bytes 4 (lane % 4) .. +3 of row lane / 4 of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(saddr(p)));
}

// Two of them (lanes 0-15 give the row addresses): registers 0 and 1.
__device__ __forceinline__ void ldsm_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(saddr(p)));
}

// c[16x8] += a[16x32] (row-major) . b[32x8] (column-major), s8 -> s32.
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The CTA's C_out slice of every tap, HWIO [taps][ceff][Co] in device
// memory, into K-contiguous rows [taps][NTILE][wrow]: each word of 4
// output channels x 4 input channels is transposed in registers.  K rows
// past ceff and channels past Co are zeros.  A thread loads the words of
// several items before it stores any, so the loads are in flight together
// (fill_weights16 is the same with 16-byte loads).
// 4 words of rows c .. c + 3 (4 output channels each) -> 4 words of
// output channels m = 0 .. 3 (4 input channels each)
__device__ __forceinline__ void transpose4x4(const uint32_t (&in)[4],
                                             uint32_t (&out)[4]) {
  const uint32_t t0 = __byte_perm(in[0], in[1], 0x5140);
  const uint32_t t1 = __byte_perm(in[2], in[3], 0x5140);
  const uint32_t t2 = __byte_perm(in[0], in[1], 0x7362);
  const uint32_t t3 = __byte_perm(in[2], in[3], 0x7362);
  out[0] = __byte_perm(t0, t1, 0x5410);
  out[1] = __byte_perm(t0, t1, 0x7632);
  out[2] = __byte_perm(t2, t3, 0x5410);
  out[3] = __byte_perm(t2, t3, 0x7632);
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// fill_weights where C_out is a multiple of 16: an item is 4 rows x 16
// output channels, one 16-byte load a row.
template <int NTILE>
__device__ __forceinline__ void fill_weights16(const MmaArgs& a, int co0,
                                               unsigned char* ws) {
  constexpr int NQ = NTILE / 16;
  constexpr int B16 = WBATCH / 2;
  const int c4s = a.kp / 4;
  const int items = a.taps * c4s * NQ;
  for (int first = threadIdx.x; first < items; first += B16 * NT1) {
    uint4 in[B16][4];
#pragma unroll
    for (int bt = 0; bt < B16; ++bt) {
      const int idx = first + bt * NT1;
      const int cq = idx % NQ, rest = idx / NQ;
      const int c4 = rest % c4s, t = rest / c4s;
      const int co = co0 + 16 * cq;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * c4 + e;
        in[bt][e] = idx < items && c < a.ceff && co < a.Co
                        ? __ldg(reinterpret_cast<const uint4*>(
                              a.w + ((size_t)t * a.ceff + c) * a.Co + co))
                        : make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int bt = 0; bt < B16; ++bt) {
      const int idx = first + bt * NT1;
      if (idx >= items) break;
      const int cq = idx % NQ, rest = idx / NQ;
      const int c4 = rest % c4s, t = rest / c4s;
#pragma unroll
      for (int mg = 0; mg < 4; ++mg) {
        const uint32_t col[4] = {word_of(in[bt][0], mg),
                                 word_of(in[bt][1], mg),
                                 word_of(in[bt][2], mg),
                                 word_of(in[bt][3], mg)};
        uint32_t out[4];
        transpose4x4(col, out);
#pragma unroll
        for (int m = 0; m < 4; ++m)
          *reinterpret_cast<uint32_t*>(
              ws + (size_t)(t * NTILE + 16 * cq + 4 * mg + m) * a.wrow +
              4 * c4) = out[m];
      }
    }
  }
}

template <int NTILE>
__device__ __forceinline__ void fill_weights(const MmaArgs& a, int co0,
                                             unsigned char* ws) {
  if (a.Co % 16 == 0) {
    fill_weights16<NTILE>(a, co0, ws);
    return;
  }
  constexpr int NQ = NTILE / 4;
  const int c4s = a.kp / 4;
  const int items = a.taps * c4s * NQ;
  for (int first = threadIdx.x; first < items; first += WBATCH * NT1) {
    uint32_t in[WBATCH][4];
#pragma unroll
    for (int bt = 0; bt < WBATCH; ++bt) {
      const int idx = first + bt * NT1;
      const int coq = idx % NQ, rest = idx / NQ;
      const int c4 = rest % c4s, t = rest / c4s;
      const int co = co0 + 4 * coq;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * c4 + e;
        in[bt][e] = idx < items && c < a.ceff && co < a.Co
                        ? __ldg(reinterpret_cast<const unsigned*>(
                              a.w + ((size_t)t * a.ceff + c) * a.Co + co))
                        : 0u;
      }
    }
#pragma unroll
    for (int bt = 0; bt < WBATCH; ++bt) {
      const int idx = first + bt * NT1;
      if (idx >= items) break;
      const int coq = idx % NQ, rest = idx / NQ;
      const int c4 = rest % c4s, t = rest / c4s;
      // rows are input channels, bytes output channels: word m of the
      // transpose holds the four input channels of output channel co + m
      uint32_t out[4];
      transpose4x4(in[bt], out);
#pragma unroll
      for (int m = 0; m < 4; ++m)
        *reinterpret_cast<uint32_t*>(
            ws + (size_t)(t * NTILE + 4 * coq + m) * a.wrow + 4 * c4) =
            out[m];
    }
  }
}

// Input row u (0-based from the band's first) of ring row v: the ring keeps
// the rs rows of each stride step that an output reads.
__device__ __forceinline__ int ring_input_row(const MmaArgs& a, int v) {
  return (v / a.rs) * a.stride + v % a.rs;
}

// The ring rows [0, hi) that chunks 0 .. q read (P: the band's pixels).
__device__ __forceinline__ int ring_rows_upto(const MmaArgs& a, int P,
                                              int q) {
  return ((min(P, (q + 1) * MT) - 1) / a.Wo) * a.rs + a.kh;
}

// Start copying ring rows va .. vb - 1 (input row u0 + ring_input_row(v))
// into the ring, pixel p of a row at slot (p % s) * q + p / s; zero-filled
// where the SAME padding lies.  Phases no output reads (p % s >= kw) are
// skipped.
__device__ __forceinline__ void fill_rows(const MmaArgs& a, int b, int u0,
                                          int va, int vb,
                                          unsigned char* ring) {
  const int ch = a.C / a.vec;
  const int per_row = a.wpad * ch;
  for (int v = va; v < vb; ++v) {
    const int ih = u0 + ring_input_row(a, v);
    const bool rv = ih >= 0 && ih < a.H;
    unsigned char* row = ring + (v % a.ring) * a.rowb;
    const int8_t* src_row = a.x + ((size_t)b * a.H + (rv ? ih : 0)) *
                                      a.W * a.C;
    for (int idx = threadIdx.x; idx < per_row; idx += NT1) {
      const int p = idx / ch, cc = idx - p * ch;
      const int ph = p % a.stride;
      if (ph >= a.kw) continue;
      const int iw = p - a.pad_l;
      const bool ok = rv && iw >= 0 && iw < a.W;
      unsigned char* dst =
          row + (ph * a.q + p / a.stride) * a.pix + cc * a.vec;
      const int8_t* src = ok ? src_row + (size_t)iw * a.C + cc * a.vec : a.x;
      if (a.vec == 16)
        h2pipe::cp_async16(dst, src, ok);
      else if (a.vec == 8)
        h2pipe::cp_async8(dst, src, ok);
      else
        cp_async4(dst, src, ok);
    }
  }
}

// The packed stem: ring rows va .. vb - 1 as raw padded bytes (wpad * C),
// zeros in the padding, with plain loads (the rows are short and not
// aligned), each thread's loads of a row in flight together.
__device__ __forceinline__ void fill_raw_rows(const MmaArgs& a, int b,
                                              int u0, int va, int vb,
                                              unsigned char* ring) {
  const int n = a.wpad * a.C, lead = a.pad_l * a.C, inner = a.W * a.C;
  for (int v = va; v < vb; ++v) {
    const int ih = u0 + ring_input_row(a, v);
    const bool rv = ih >= 0 && ih < a.H;
    unsigned char* row = ring + (v % a.ring) * a.rowb;
    const int8_t* src_row = a.x + ((size_t)b * a.H + (rv ? ih : 0)) * inner;
    for (int first = threadIdx.x; first < n; first += WBATCH * NT1) {
      unsigned char val[WBATCH];
#pragma unroll
      for (int bt = 0; bt < WBATCH; ++bt) {
        const int off = first + bt * NT1 - lead;
        val[bt] = rv && off >= 0 && off < inner
                      ? (unsigned char)__ldg(src_row + off)
                      : 0;
      }
#pragma unroll
      for (int bt = 0; bt < WBATCH; ++bt)
        if (first + bt * NT1 < n) row[first + bt * NT1] = val[bt];
    }
  }
}

// The plan counts on up to CTAS_PER_SM blocks a SM (ops.CONV_CTAS_PER_SM):
// the launch bounds hold each thread to the 128 registers that leaves it.
// (Without a minimum, ptxas holds some instances near 72 registers and
// spills; above 128 the 1x1 layers' CTAs no longer fit one wave.)
constexpr int CTAS_PER_SM = 4;
template <bool PACKED, int WN, int NF>
__global__ void __launch_bounds__(NT1, CTAS_PER_SM) conv_mma(MmaArgs a) {
  constexpr int WM = 4 / WN;           // warps along M
  constexpr int MF = MT / (16 * WM);   // m16 fragments a warp
  constexpr int NTILE = 8 * NF * WN;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  unsigned char* ws = smem_mma;                            // weights
  unsigned char* ring = ws + (size_t)a.taps * NTILE * a.wrow;
  unsigned char* tile = ring + (size_t)a.ring * a.rowb;    // packed only

  const int co0 = blockIdx.x * NTILE;
  const int r0 = blockIdx.y * a.rows_per_band;
  const int r1 = min(a.Ho, r0 + a.rows_per_band);
  const int b = blockIdx.z;
  const int P = (r1 - r0) * a.Wo;         // the band's output pixels
  const int nchunks = (P + MT - 1) / MT;
  const int u0 = r0 * a.stride - a.pad_t; // input row of the band's row 0

  if (PACKED) {
    // the patch tile's K padding [ceff, kp) stays zero
    const int pad = a.kp - a.ceff;
    for (int idx = threadIdx.x; idx < MT * pad; idx += NT1)
      tile[(idx / pad) * a.arow + a.ceff + idx % pad] = 0;
  } else {  // the first two chunks' rows, in flight during the weight fill
    fill_rows(a, b, u0, 0, ring_rows_upto(a, P, 0), ring);
    cp_async_commit();
    if (nchunks > 1)
      fill_rows(a, b, u0, ring_rows_upto(a, P, 0), ring_rows_upto(a, P, 1),
                ring);
    cp_async_commit();
  }
  fill_weights<NTILE>(a, co0, ws);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, t = lane & 3;
  const int mrow = wm * 16 * MF;                   // the warp's first pixel
  const int akoff = (lane >> 4) * 16;              // ldmatrix A: k offset
  const int bco = wn * 8 * NF + (lane & 7) + ((lane >> 4) << 3);
  const int bkoff = ((lane >> 3) & 1) * 16;        // ldmatrix B: k offset
  float sc[NF][2], bi[NF][2];
#pragma unroll
  for (int nf = 0; nf < NF; ++nf)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = co0 + wn * 8 * NF + nf * 8 + 2 * t + e;
      const bool ok = !a.out_i32 && co < a.Co;
      sc[nf][e] = ok ? a.w_scale[co] : 0.0f;
      bi[nf][e] = ok ? a.bias[co] : 0.0f;
    }

  for (int q = 0; q < nchunks; ++q) {
    if (PACKED) {
      __syncthreads();  // the previous chunk is done with ring and tile
      fill_raw_rows(a, b, u0, q == 0 ? 0 : ring_rows_upto(a, P, q - 1),
                    ring_rows_upto(a, P, q), ring);
      __syncthreads();
      // each pixel's patch, K packed as (i, j, c): kernel row i's k_w * C
      // bytes lie contiguous in the raw row at byte (ow * s) * C
      const int rowk = a.kw * a.C;
      for (int item = threadIdx.x; item < MT * a.kh; item += NT1) {
        const int m = item / a.kh, i = item - m * a.kh;
        const int pm = min(q * MT + m, P - 1);
        const int rr = pm / a.Wo, ow = pm - rr * a.Wo;
        const unsigned char* src = ring +
                                   ((rr * a.rs + i) % a.ring) * a.rowb +
                                   ow * a.stride * a.C;
        unsigned char* dst = tile + m * a.arow + i * rowk;
        for (int e = 0; e < rowk; ++e) dst[e] = src[e];
      }
      __syncthreads();
    } else {
      cp_async_wait(1);  // the rows of chunk q have landed
      __syncthreads();
    }

    int acc[MF][NF][4];
#pragma unroll
    for (int f = 0; f < MF; ++f)
#pragma unroll
      for (int nf = 0; nf < NF; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[f][nf][e] = 0;

    if (PACKED) {
      for (int kc = 0; kc < a.kp / 32; ++kc) {
        uint32_t af[MF][4], bf[NF / 2][4];
#pragma unroll
        for (int f = 0; f < MF; ++f)
          ldsm_x4(af[f], tile + (mrow + f * 16 + (lane & 15)) * a.arow +
                             kc * 32 + akoff);
#pragma unroll
        for (int nb = 0; nb < NF / 2; ++nb)
          ldsm_x4(bf[nb], ws + (bco + nb * 16) * a.wrow + kc * 32 + bkoff);
#pragma unroll
        for (int f = 0; f < MF; ++f)
#pragma unroll
          for (int nf = 0; nf < NF; ++nf)
            mma_s8(acc[f][nf], af[f], bf[nf / 2][2 * (nf & 1)],
                   bf[nf / 2][2 * (nf & 1) + 1]);
      }
    } else {
      // the lane's pixel of each fragment: ring row (rr * rs + i), slot of
      // pixel (ow * s + j)
      int vb[MF], cb[MF];
#pragma unroll
      for (int f = 0; f < MF; ++f) {
        const int pm = min(q * MT + mrow + f * 16 + (lane & 15), P - 1);
        const int rr = pm / a.Wo, ow = pm - rr * a.Wo;
        vb[f] = rr * a.rs;
        cb[f] = ow * a.pix + akoff;
      }
      for (int i = 0; i < a.kh; ++i) {
        int arow[MF];
#pragma unroll
        for (int f = 0; f < MF; ++f)
          arow[f] = ((vb[f] + i) % a.ring) * a.rowb + cb[f];
        for (int j = 0; j < a.kw; ++j) {
          const int joff = ((j % a.stride) * a.q + j / a.stride) * a.pix;
          const unsigned char* wt =
              ws + ((i * a.kw + j) * NTILE + bco) * a.wrow + bkoff;
          for (int kc = 0; kc < a.kp / 32; ++kc) {
            uint32_t af[MF][4], bf[NF / 2][4];
#pragma unroll
            for (int f = 0; f < MF; ++f)
              ldsm_x4(af[f], ring + arow[f] + joff + kc * 32);
#pragma unroll
            for (int nb = 0; nb < NF / 2; ++nb)
              ldsm_x4(bf[nb], wt + nb * 16 * a.wrow + kc * 32);
#pragma unroll
            for (int f = 0; f < MF; ++f)
#pragma unroll
              for (int nf = 0; nf < NF; ++nf)
                mma_s8(acc[f][nf], af[f], bf[nf / 2][2 * (nf & 1)],
                       bf[nf / 2][2 * (nf & 1) + 1]);
          }
        }
      }
    }

    // epilogue: rows g and g + 8 of each fragment, channels 2t and 2t + 1
    // of each n8 tile
#pragma unroll
    for (int f = 0; f < MF; ++f)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int pm = q * MT + mrow + f * 16 + g + 8 * hf;
        if (pm >= P) continue;
        const int rr = pm / a.Wo, ow = pm - rr * a.Wo;
        const size_t pix_off =
            (((size_t)b * a.Ho + r0 + rr) * a.Wo + ow) * a.Co;
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) {
          const int co = co0 + wn * 8 * NF + nf * 8 + 2 * t;
          if (co >= a.Co) continue;
          const int v0 = acc[f][nf][2 * hf], v1 = acc[f][nf][2 * hf + 1];
          const size_t off = pix_off + co;
          if (a.out_i32) {
            *reinterpret_cast<int2*>(a.out_i32 + off) = make_int2(v0, v1);
            continue;
          }
          int8_t q0, q1;
          const float y0 = h2pipe::requant(v0, sc[nf][0], bi[nf][0],
                                           a.act_scale, a.inv_act,
                                           a.relu != 0, &q0);
          const float y1 = h2pipe::requant(v1, sc[nf][1], bi[nf][1],
                                           a.act_scale, a.inv_act,
                                           a.relu != 0, &q1);
          *reinterpret_cast<uint16_t*>(a.out_q + off) =
              (uint16_t)((uint8_t)q0 | ((uint16_t)(uint8_t)q1 << 8));
          if (a.out_f)
            *reinterpret_cast<float2*>(a.out_f + off) = make_float2(y0, y1);
        }
      }
    if (!PACKED) {
      __syncthreads();  // every warp is done with the rows chunk q + 2 reuses
      if (q + 2 < nchunks)
        fill_rows(a, b, u0, ring_rows_upto(a, P, q + 1),
                  ring_rows_upto(a, P, q + 2), ring);
      cp_async_commit();
    }
  }
}

// The instance the plan names (ops.CONV_INSTANCES), or nullptr.
template <bool PACKED>
void* pick_mma(int wn, int nf) {
  if (wn == 2 && nf == 4) return (void*)conv_mma<PACKED, 2, 4>;
  if (wn == 1 && nf == 4) return (void*)conv_mma<PACKED, 1, 4>;
  if (wn == 1 && nf == 2) return (void*)conv_mma<PACKED, 1, 2>;
  return nullptr;
}

// ---------------------------------------------------------------------------
// conv_stream: the HBM-streamed tier on the int8 tensor cores
// ---------------------------------------------------------------------------

constexpr int SP = 128;          // producer threads: warps 4..7
constexpr int SPW = 96;          // of them the weights' (warps 4..6)
constexpr int SPA = 32;          // and the input stages' (warp 7)
constexpr int SC = 128;          // consumer (MMA) threads: warps 0..3
constexpr int A_STAGES = 2;      // input stages (ops.STREAM_A_STAGES)
constexpr int SLICE_MAX = 16384; // kb * n_tile, at most
constexpr int STAGING = 4;       // raw weight slices (ops.STREAM_STAGING)
constexpr int STREAM_CTAS_PER_SM = 2;  // ops.STREAM_CTAS_PER_SM

struct StreamArgs {
  const int8_t* x;
  const int8_t* w;
  const float* w_scale;
  const float* bias;
  float act_scale, inv_act;
  int8_t* out_q;
  float* out_f;
  int32_t* out_i32;
  int B, H, W, C, Ho, Wo, Co, kh, kw, stride, pad_t, pad_l, relu;
  // the plan (ops.stream_plan)
  int g, groups, seg, rows_per_band, kb, nkb, nb, veca;
  // the layout (stream_layout() below)
  int wpad;   // padded input columns the segment reads: (seg - 1) * s + kw
  int q;      // pixel slots a stride phase: ceil(wpad / s)
  int pix;    // bytes a pixel slot and a weight row: kb + 16
  int rowb;   // bytes of one image's input row in a stage
};

struct StreamLayout {
  int wpad, q, pix, rowb;
  long smem;
};

// ops.stream_layout mirrors this.  Shared memory of one CTA: the full and
// empty mbarriers of the nb weight slots and of the A_STAGES input stages,
// the slots [nb][ntile][kb + 16], the stages [A_STAGES][g][rowb], and the
// staging of raw HWIO slices [STAGING][kb][ntile].
StreamLayout stream_layout(int kb, int g, int seg, int kh, int kw, int s,
                           int nb, int ntile) {
  StreamLayout L;
  L.wpad = (seg - 1) * s + kw;
  L.q = (L.wpad + s - 1) / s;
  L.pix = kb + 16;
  L.rowb = (s < kw ? s : kw) * L.q * L.pix;
  L.smem = 16L * (nb + A_STAGES) + (long)nb * ntile * L.pix +
           (long)A_STAGES * g * L.rowb + (long)STAGING * kb * ntile;
  return L;
}

// A staged slice holds its kb rows of NTILE bytes as chunks of VEC bytes,
// row-major, chunk q at q ^ ((q >> SH) & (W - 1)) with W chunks a 128-byte
// line and 4 rows' chunks below bit SH: the transposing reads (rows
// 4 c4 + e of consecutive c4) then fall in distinct banks.
template <int NTILE, int VEC>
__device__ __forceinline__ int staged_chunk(int q) {
  constexpr int CPR = NTILE / VEC;
  constexpr int SH = CPR == 1 ? 2 : CPR == 2 ? 3 : CPR == 4 ? 4 : CPR == 8
                                                                  ? 5 : 6;
  constexpr int W = 128 / VEC;
  return q ^ ((q >> SH) & (W - 1));
}

template <int VEC>
__device__ __forceinline__ void cp_async_vec(void* dst, const void* src,
                                             bool ok) {
  if constexpr (VEC == 16)
    h2pipe::cp_async16(dst, src, ok);
  else if constexpr (VEC == 8)
    h2pipe::cp_async8(dst, src, ok);
  else
    h2pipe::cp_async4(dst, src, ok);
}

// Start copying the weight slice (tap, kk) of the CTA's C_out tile into a
// staging slot: rows kk * kb .. of the HWIO tap, zero-filled past C and
// C_out.  Spread over the producer threads, no registers held.
template <int NTILE, int VEC>
__device__ __forceinline__ void copy_slice(const StreamArgs& a, int co0,
                                           int tap, int kk, int p,
                                           unsigned char* stg) {
  constexpr int CPR = NTILE / VEC;
  for (int q = p; q < a.kb * CPR; q += SPW) {
    const int r = q / CPR, c = q % CPR;
    const int k = kk * a.kb + r, co = co0 + c * VEC;
    const bool ok = k < a.C && co < a.Co;
    cp_async_vec<VEC>(stg + staged_chunk<NTILE, VEC>(q) * VEC,
                      ok ? a.w + ((size_t)tap * a.C + k) * a.Co + co : a.w,
                      ok);
  }
}

// Transpose a staged slice into a slot's K-contiguous rows: a thread's
// unit is 4 K rows x VEC output channels, read as 4 chunks, transposed in
// registers (a 4x4 byte transpose per word) and stored as VEC words at
// output channel n's row (slot + n * pix), bytes 4 c4 .. 4 c4 + 3.
// Consecutive threads take consecutive c4, so the stores hit consecutive
// banks.
template <int NTILE, int VEC>
__device__ __forceinline__ void transpose_slice(const StreamArgs& a, int p,
                                                const unsigned char* stg,
                                                unsigned char* slot) {
  // units a thread, at most: a slice of SLICE_MAX bytes over SPW threads
  constexpr int U = (SLICE_MAX / (4 * VEC) + SPW - 1) / SPW;
  constexpr int NV = VEC / 4;
  constexpr int CPR = NTILE / VEC;
  const int c4s = a.kb >> 2;
  const int units = c4s * CPR;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int idx = p + u * SPW;
    if (idx >= units) break;
    const int cv = idx / c4s, c4 = idx - cv * c4s;
    uint32_t v[4][NV];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const unsigned char* src =
          stg + staged_chunk<NTILE, VEC>((4 * c4 + e) * CPR + cv) * VEC;
      if constexpr (VEC == 16) {
        const uint4 t = *reinterpret_cast<const uint4*>(src);
        v[e][0] = t.x; v[e][1] = t.y; v[e][2] = t.z; v[e][3] = t.w;
      } else if constexpr (VEC == 8) {
        const uint2 t = *reinterpret_cast<const uint2*>(src);
        v[e][0] = t.x; v[e][1] = t.y;
      } else {
        v[e][0] = *reinterpret_cast<const uint32_t*>(src);
      }
    }
#pragma unroll
    for (int mg = 0; mg < NV; ++mg) {
      const uint32_t col[4] = {v[0][mg], v[1][mg], v[2][mg], v[3][mg]};
      uint32_t out[4];
      transpose4x4(col, out);
#pragma unroll
      for (int m = 0; m < 4; ++m)
        *reinterpret_cast<uint32_t*>(
            slot + (size_t)(cv * VEC + 4 * mg + m) * a.pix + 4 * c4) = out[m];
    }
  }
}

// One input stage: for each of the g images, input row r * s - pad_t + i,
// the segment's padded columns, channels [kk * kb, kk * kb + kb) of C, into
// [g][rowb], pixel p of a row at slot (p % s) * q + p / s; zeros where the
// SAME padding lies and for images past B; phases no output reads are
// skipped.  Run by warp 7 (lane p).  Where C % 16 == 0 it asks the copy
// engine for each pixel's run of channels (one bulk copy, completing on
// `full`'s transaction count); else its lanes issue cp.async copies of
// veca bytes, arriving on `full` as they land, or plain byte loads where
// C % 4 != 0 (the stems).
__device__ __forceinline__ void fill_stage(const StreamArgs& a, int b0,
                                           int ow0, int r, int i, int kk,
                                           int p, unsigned char* st,
                                           uint64_t* full) {
  const int cbase = kk * a.kb;
  const int cvalid = min(a.kb, a.C - cbase);
  const int ih = r * a.stride - a.pad_t + i;
  const bool row_ok = ih >= 0 && ih < a.H;
  const int iw0 = ow0 * a.stride - a.pad_l;
  if (a.veca == 16) {
    // lane l takes pixels l, l + 32, ... of the g * wpad; lane 0 arrives
    // with the bytes the copies will bring, after the padding's zeros
    unsigned bytes = 0;
    for (int pp = p; pp < a.g * a.wpad; pp += 32) {
      const int gi = pp / a.wpad, px = pp - gi * a.wpad;
      const int ph = px % a.stride;
      if (ph >= a.kw) continue;
      const int b = b0 + gi, iw = iw0 + px;
      uint4* dst = reinterpret_cast<uint4*>(
          st + gi * a.rowb + (ph * a.q + px / a.stride) * a.pix);
      if (row_ok && b < a.B && iw >= 0 && iw < a.W)
        bytes += cvalid;
      else
        for (int c = 0; c < cvalid / 16; ++c) dst[c] = make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      bytes += __shfl_xor_sync(0xffffffffu, bytes, off);
    // the zeros are ordered before any later copy-engine write there
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (p == 0) h2pipe::mbar_arrive_expect_tx(full, bytes);
    __syncwarp();
    for (int pp = p; pp < a.g * a.wpad; pp += 32) {
      const int gi = pp / a.wpad, px = pp - gi * a.wpad;
      const int ph = px % a.stride;
      const int b = b0 + gi, iw = iw0 + px;
      if (ph >= a.kw || !(row_ok && b < a.B && iw >= 0 && iw < a.W))
        continue;
      h2pipe::bulk_copy_g2s(
          st + gi * a.rowb + (ph * a.q + px / a.stride) * a.pix,
          a.x + (((size_t)b * a.H + ih) * a.W + iw) * a.C + cbase, cvalid,
          full);
    }
    return;
  }
  const int ch = cvalid / a.veca;
  const int per_img = a.wpad * ch;
  for (int idx = p; idx < a.g * per_img; idx += SPA) {
    const int gi = idx / per_img, rem = idx - gi * per_img;
    const int px = rem / ch, cc = rem - px * ch;
    const int pq = px / a.stride, ph = px - pq * a.stride;
    if (ph >= a.kw) continue;
    const int b = b0 + gi, iw = iw0 + px;
    const bool ok = row_ok && b < a.B && iw >= 0 && iw < a.W;
    unsigned char* dst = st + gi * a.rowb + (ph * a.q + pq) * a.pix +
                         cc * a.veca;
    const int8_t* src =
        ok ? a.x + (((size_t)b * a.H + ih) * a.W + iw) * a.C + cbase +
                 cc * a.veca
           : a.x;
    if (a.veca == 8)
      h2pipe::cp_async8(dst, src, ok);
    else if (a.veca == 4)
      cp_async4(dst, src, ok);
    else
      *dst = ok ? (unsigned char)*src : 0;
  }
  if (a.veca == 1)
    h2pipe::mbar_arrive(full);
  else
    h2pipe::cp_async_mbar_arrive(full);
}

// The producer warps.  Warps 4-6 stream the weights: slices run row by
// row; within a row stage (i, kk) by stage (kernel row i, K block kk),
// each stage's k_w taps (i, j).  The raw HWIO rows of STAGING - 1 slices
// are in flight by cp.async (no registers held) while slice x is
// transposed into its ring slot.  Each slice waits for its slot's empty
// barrier (every consumer warp has read the slot's last contents: the
// credit rule of section V-A) and arrives on its full barrier once
// stored.  Warp 7 fills the input stages in the same order, each once the
// consumers are done with the stage that held its slot: on its own, a
// stage's copies never hold up the weights' ring.
template <int NTILE, int VEC>
__device__ __forceinline__ void stream_produce(
    const StreamArgs& a, int co0, int b0, int ow0, int r0, int r1,
    uint64_t* full_w, uint64_t* empty_w, uint64_t* full_a, uint64_t* empty_a,
    unsigned char* wring, unsigned char* aring, unsigned char* staging) {
  const int p = threadIdx.x - SC;
  const int spr = a.kh * a.nkb;             // stages a row
  const int n_stages = (r1 - r0) * spr;
  if (p >= SPW) {
    const size_t stage_bytes = (size_t)a.g * a.rowb;
    h2pipe::RingPos apos;
    for (int s = 0; s < n_stages; ++s) {
      h2pipe::mbar_wait(empty_a + apos.slot, apos.phase ^ 1);
      const int rr = s / spr, sir = s - rr * spr, i = sir / a.nkb;
      fill_stage(a, b0, ow0, r0 + rr, i, sir - i * a.nkb, p - SPW,
                 aring + apos.slot * stage_bytes, full_a + apos.slot);
      apos.next(A_STAGES);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }
  const int n = n_stages * a.kw;            // slices
  const size_t slot_bytes = (size_t)NTILE * a.pix;
  const size_t staged_bytes = (size_t)a.kb * NTILE;
  // start the copies of slice x (its tap and K block) into its staging slot
  auto stage_slice = [&](int x) {
    const int st = x / a.kw, j = x - st * a.kw;
    const int sir = st % spr, i = sir / a.nkb;
    copy_slice<NTILE, VEC>(a, co0, i * a.kw + j, sir - i * a.nkb, p,
                           staging + (x % STAGING) * staged_bytes);
  };
  for (int x = 0; x < STAGING - 1; ++x) {
    if (x < n) stage_slice(x);
    h2pipe::cp_async_commit();
  }
  h2pipe::RingPos wpos;
  for (int x = 0; x < n; ++x) {
    // slice x has landed for every weight producer, and every one is done
    // with the staging slot that slice x + STAGING - 1 takes
    h2pipe::cp_async_wait(STAGING - 2);
    asm volatile("bar.sync 1, %0;\n" ::"r"(SPW) : "memory");
    if (x + STAGING - 1 < n) stage_slice(x + STAGING - 1);
    h2pipe::cp_async_commit();
    h2pipe::mbar_wait(empty_w + wpos.slot, wpos.phase ^ 1);
    transpose_slice<NTILE, VEC>(a, p, staging + (x % STAGING) * staged_bytes,
                                wring + wpos.slot * slot_bytes);
    h2pipe::mbar_arrive(full_w + wpos.slot);
    wpos.next(a.nb);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The MMA warps: per output row, every stage's k_w slices into the int32
// sums of the CTA's g * seg pixels x NTILE channels, then the epilogue.
// Pixel m is image m / seg, column m % seg of the segment; its A rows come
// by ldmatrix from the stage (slot of padded column cw * s + j), its B rows
// from the slot.  A warp whose pixels all lie past g * seg (VGG-16's fc0:
// M = 8) only keeps the barriers' counts.
template <int WN, int NF>
__device__ __forceinline__ void stream_consume(
    const StreamArgs& a, int co0, int b0, int ow0, int r0, int r1,
    uint64_t* full_w, uint64_t* empty_w, uint64_t* full_a, uint64_t* empty_a,
    const unsigned char* wring, const unsigned char* aring) {
  constexpr int WM = 4 / WN;           // warps along M
  // m16 fragments a warp (all four warps along N: the CTA's at most 16
  // pixels)
  constexpr int MF = WN == 4 ? 1 : MT / (16 * WM);
  constexpr int NTILE = 8 * NF * WN;
  // Sets of sums a warp keeps, K step kc going to set kc % S: mma.sync's
  // latency, not its rate, bounds a chain of dependent steps, and fewer
  // fragments a warp leave fewer chains to overlap.
  constexpr int S = MF * NF >= 8 ? 1 : MF * NF >= 2 ? 2 : 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / WN, wn = warp % WN;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int M = a.g * a.seg;
  const int mrow = wm * 16 * MF;
  const int akoff = (lane >> 4) * 16;
  // B rows by ldmatrix: .x4 covers two 8-channel columns, .x2 (NF = 1)
  // one, its lanes 16-31 repeating lanes 0-15
  const int bco = wn * 8 * NF + (lane & 7) + (NF > 1 ? (lane >> 4) << 3 : 0);
  const int bkoff = ((lane >> 3) & 1) * 16;
  const size_t slot_bytes = (size_t)NTILE * a.pix;
  const size_t stage_bytes = (size_t)a.g * a.rowb;
  int aoff[MF];
#pragma unroll
  for (int f = 0; f < MF; ++f) {
    const int m = min(mrow + f * 16 + (lane & 15), M - 1);
    const int gi = m / a.seg;
    aoff[f] = gi * a.rowb + (m - gi * a.seg) * a.pix + akoff;
  }
  h2pipe::RingPos wpos, apos;
  for (int r = r0; r < r1; ++r) {
    int acc[S][MF][NF][4];
#pragma unroll
    for (int t = 0; t < S; ++t)
#pragma unroll
      for (int f = 0; f < MF; ++f)
#pragma unroll
        for (int nf = 0; nf < NF; ++nf)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[t][f][nf][e] = 0;
    for (int i = 0; i < a.kh; ++i)
      for (int kk = 0; kk < a.nkb; ++kk) {
        h2pipe::mbar_wait(full_a + apos.slot, apos.phase);
        const unsigned char* st = aring + apos.slot * stage_bytes;
        const int kcs = (min(a.kb, a.C - kk * a.kb) + 31) >> 5;
        for (int j = 0; j < a.kw; ++j) {
          h2pipe::mbar_wait(full_w + wpos.slot, wpos.phase);
          const unsigned char* at = st +
              ((j % a.stride) * a.q + j / a.stride) * a.pix;
          const unsigned char* wt =
              wring + wpos.slot * slot_bytes + bco * a.pix + bkoff;
          for (int kc0 = 0; kc0 < kcs; kc0 += S)
#pragma unroll
            for (int t = 0; t < S; ++t) {
              const int kc = kc0 + t;
              if (kc >= kcs || mrow >= M) break;
              uint32_t af[MF][4], bf[(NF + 1) / 2][4];
#pragma unroll
              for (int f = 0; f < MF; ++f)
                if (mrow + f * 16 < M)
                  ldsm_x4(af[f], at + aoff[f] + kc * 32);
              if constexpr (NF == 1) {
                ldsm_x2(bf[0], wt + kc * 32);
              } else {
#pragma unroll
                for (int nb = 0; nb < NF / 2; ++nb)
                  ldsm_x4(bf[nb], wt + nb * 16 * a.pix + kc * 32);
              }
#pragma unroll
              for (int f = 0; f < MF; ++f)
                if (mrow + f * 16 < M)
#pragma unroll
                  for (int nf = 0; nf < NF; ++nf)
                    mma_s8(acc[t][f][nf], af[f], bf[nf / 2][2 * (nf & 1)],
                           bf[nf / 2][2 * (nf & 1) + 1]);
            }
          __syncwarp();
          if (lane == 0) h2pipe::mbar_arrive(empty_w + wpos.slot);
          wpos.next(a.nb);
        }
        __syncwarp();
        if (lane == 0) h2pipe::mbar_arrive(empty_a + apos.slot);
        apos.next(A_STAGES);
      }

    // epilogue: rows g8 and g8 + 8 of each fragment, channels 2t4, 2t4 + 1
    // (the scales are read here, not held through the K loop: registers)
    float sc[NF][2], bi[NF][2];
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = co0 + wn * 8 * NF + nf * 8 + 2 * t4 + e;
        const bool ok = !a.out_i32 && co < a.Co;
        sc[nf][e] = ok ? a.w_scale[co] : 0.0f;
        bi[nf][e] = ok ? a.bias[co] : 0.0f;
      }
#pragma unroll
    for (int f = 0; f < MF; ++f)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = mrow + f * 16 + g8 + 8 * hf;
        if (m >= M) continue;
        const int gi = m / a.seg;
        const int b = b0 + gi, ow = ow0 + m - gi * a.seg;
        if (b >= a.B || ow >= a.Wo) continue;
        const size_t pix_off = (((size_t)b * a.Ho + r) * a.Wo + ow) * a.Co;
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) {
          const int co = co0 + wn * 8 * NF + nf * 8 + 2 * t4;
          if (co >= a.Co) continue;
          int v0 = 0, v1 = 0;
#pragma unroll
          for (int t = 0; t < S; ++t) {
            v0 += acc[t][f][nf][2 * hf];
            v1 += acc[t][f][nf][2 * hf + 1];
          }
          const size_t off = pix_off + co;
          if (a.out_i32) {
            *reinterpret_cast<int2*>(a.out_i32 + off) = make_int2(v0, v1);
            continue;
          }
          int8_t q0, q1;
          const float y0 = h2pipe::requant(v0, sc[nf][0], bi[nf][0],
                                           a.act_scale, a.inv_act,
                                           a.relu != 0, &q0);
          const float y1 = h2pipe::requant(v1, sc[nf][1], bi[nf][1],
                                           a.act_scale, a.inv_act,
                                           a.relu != 0, &q1);
          *reinterpret_cast<uint16_t*>(a.out_q + off) =
              (uint16_t)((uint8_t)q0 | ((uint16_t)(uint8_t)q1 << 8));
          if (a.out_f)
            *reinterpret_cast<float2*>(a.out_f + off) = make_float2(y0, y1);
        }
      }
  }
}

// A CTA: (image group and column segment, C_out tile, band of rows); warps
// 0-3 run the MMAs and the epilogue, warps 4-7 fill the rings.
template <int WN, int NF, int VEC>
__global__ void __launch_bounds__(SP + SC, STREAM_CTAS_PER_SM)
    conv_stream(StreamArgs a) {
  constexpr int NTILE = 8 * NF * WN;
  extern __shared__ __align__(16) unsigned char smem_st[];
  uint64_t* full_w = reinterpret_cast<uint64_t*>(smem_st);
  uint64_t* empty_w = full_w + a.nb;
  uint64_t* full_a = empty_w + a.nb;
  uint64_t* empty_a = full_a + A_STAGES;
  unsigned char* wring = smem_st + 16 * (a.nb + A_STAGES);
  unsigned char* aring = wring + (size_t)a.nb * NTILE * a.pix;
  unsigned char* staging = aring + (size_t)A_STAGES * a.g * a.rowb;

  const int grp = blockIdx.x % a.groups, sg = blockIdx.x / a.groups;
  const int co0 = blockIdx.y * NTILE;
  const int r0 = blockIdx.z * a.rows_per_band;
  const int r1 = min(a.Ho, r0 + a.rows_per_band);
  const int b0 = grp * a.g, ow0 = sg * a.seg;
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.nb; ++s) {
      h2pipe::mbar_init(full_w + s, SPW);        // every weight producer
      h2pipe::mbar_init(empty_w + s, SC / 32);   // every consumer warp
    }
    for (int s = 0; s < A_STAGES; ++s) {
      // one arrival with the bulk copies' bytes, or each of warp 7's
      h2pipe::mbar_init(full_a + s, a.veca == 16 ? 1 : SPA);
      h2pipe::mbar_init(empty_a + s, SC / 32);
    }
    h2pipe::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= SC)
    stream_produce<NTILE, VEC>(a, co0, b0, ow0, r0, r1, full_w, empty_w,
                               full_a, empty_a, wring, aring, staging);
  else
    stream_consume<WN, NF>(a, co0, b0, ow0, r0, r1, full_w, empty_w, full_a,
                           empty_a, wring, aring);
}

// The instance the plan names (ops.stream_instance), or nullptr: warps
// along N and 8-channel MMA columns a warp of a C_out tile, and the
// weight-load width.  A CTA of at most 16 pixels (VGG-16's fc0: 8) puts
// all four warps along N, since warps along M would have no pixels.
template <int VEC>
void* pick_stream_vec(int wn, int nf) {
  if (wn == 2 && nf == 4) return (void*)conv_stream<2, 4, VEC>;
  if (wn == 1 && nf == 4) return (void*)conv_stream<1, 4, VEC>;
  if (wn == 1 && nf == 2) return (void*)conv_stream<1, 2, VEC>;
  return nullptr;
}

void* pick_stream(int ntile, int vec, int m) {
  if (m <= 16 && ntile == 32 && vec == 16)
    return (void*)conv_stream<4, 1, 16>;
  const int wn = ntile == 64 ? 2 : 1, nf = ntile == 16 ? 2 : 4;
  if (vec == 16) return pick_stream_vec<16>(wn, nf);
  if (vec == 8) return pick_stream_vec<8>(wn, nf);
  if (vec == 4) return pick_stream_vec<4>(wn, nf);
  return nullptr;
}

}  // namespace

extern "C" {

// The pinned tier.  Launches on `stream`.  Exactly one of out_q (int8,
// fused requant; out_f optional f32 pre-quant values) and out_i32 (raw
// int32 sums) is set.  The plan is ops.conv_plan's (wn, nf: the conv_mma
// instance, whose C_out tile is 8 * wn * nf; rows_per_band, packed, smem:
// the bytes of its layout, which layout() must reproduce).  Returns
// cudaGetLastError() after the launch.
int conv2d_int8_launch(const int8_t* x, const int8_t* w, const float* w_scale,
                       const float* bias, float act_scale, float inv_act,
                       int8_t* out_q, float* out_f, int32_t* out_i32, int B,
                       int H, int W, int C, int Ho, int Wo, int Co, int kh,
                       int kw, int stride, int pad_t, int pad_l, int relu,
                       int wn, int nf, int rows_per_band, int packed,
                       int smem, cudaStream_t stream) {
  if ((Co & 3) != 0 || rows_per_band < 1 || (!packed && (C & 3) != 0))
    return (int)cudaErrorInvalidValue;
  const int ntile = 8 * wn * nf;
  Layout L = layout(C, Wo, kh, kw, stride, rows_per_band, packed, ntile);
  void* fn = packed ? pick_mma<true>(wn, nf) : pick_mma<false>(wn, nf);
  if (!fn || L.smem != smem) return (int)cudaErrorInvalidValue;
  MmaArgs a{x, w, w_scale, bias, act_scale, inv_act, out_q, out_f,
            out_i32, B, H, W, C, Ho, Wo, Co, kh, kw, stride, pad_t, pad_l,
            relu, rows_per_band, L.taps, L.ceff, L.kp, L.wrow, L.wpad,
            L.rs, L.q, L.pix, L.rowb, L.ring, L.arow,
            C % 16 == 0 ? 16 : C % 8 == 0 ? 8 : 4};
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Co + ntile - 1) / ntile, (Ho + rows_per_band - 1) /
            rows_per_band, B);
  void* args[] = {&a};
  err = cudaLaunchKernel(fn, grid, dim3(NT1), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The streamed tier, with the plan of ops.stream_plan (n_tile and vec: the
// conv_stream instance; the rest as StreamPlan names them; smem: the bytes
// of its layout, which stream_layout() must reproduce).  Refuses a plan
// that does not cover the output or that the instance cannot take.
int conv2d_int8_stream_launch(
    const int8_t* x, const int8_t* w, const float* w_scale, const float* bias,
    float act_scale, float inv_act, int8_t* out_q, float* out_f,
    int32_t* out_i32, int B, int H, int W, int C, int Ho, int Wo, int Co,
    int kh, int kw, int stride, int pad_t, int pad_l, int relu, int n_tile,
    int vec, int veca, int kb, int nkb, int nb, int g, int groups, int seg,
    int nseg, int rows_per_band, int smem, cudaStream_t stream) {
  void* fn = pick_stream(n_tile, vec, g * seg);
  if (!fn || Co % vec != 0 || (veca != 1 && veca != 4 && veca != 8 &&
                               veca != 16) || C % veca != 0 ||
      kb < 32 || kb % 32 != 0 || kb * n_tile > SLICE_MAX ||
      nkb != (C + kb - 1) / kb || nb < 1 || nb > kh * kw * nkb ||
      g < 1 || g * seg > MT || groups * g < B || nseg * seg < Wo ||
      rows_per_band < 1)
    return (int)cudaErrorInvalidValue;
  StreamLayout L = stream_layout(kb, g, seg, kh, kw, stride, nb, n_tile);
  if (L.smem != smem) return (int)cudaErrorInvalidValue;
  StreamArgs a{x, w, w_scale, bias, act_scale, inv_act, out_q, out_f,
               out_i32, B, H, W, C, Ho, Wo, Co, kh, kw, stride, pad_t, pad_l,
               relu, g, groups, seg, rows_per_band, kb, nkb, nb, veca,
               L.wpad, L.q, L.pix, L.rowb};
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(groups * nseg, (Co + n_tile - 1) / n_tile,
            (Ho + rows_per_band - 1) / rows_per_band);
  void* args[] = {&a};
  err = cudaLaunchKernel(fn, grid, dim3(SP + SC), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
