// int8 SAME conv with the requant epilogue fused: the HPIPE layer engine.
//
// Replaces the Pallas kernels of repro/kernels/conv2d_int8/kernel.py:
//   _conv_kernel         (pinned weights)   -> conv_mma<..>
//   _conv_stream_kernel  (HBM-streamed)     -> conv_stream_kernel<..>
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
// conv_stream_kernel: the HBM-streamed tier (still on dp4a, on the CUDA
// cores).  One CTA covers (image, band of output rows, 32-channel C_out
// tile).  For each output row it fills a line buffer of the k_h padded
// input rows in shared memory (zeros stand in for the SAME padding: pad//2
// at the top/left, the odd pixel at the bottom/right), then sums the
// k_h*k_w taps with dp4a (int8 x int8 -> int32).  A thread owns one quad
// of output channels and up to MAXI pairs of output columns; the four
// weight words of a (tap, 4 input channels, channel quad) are transposed
// in registers with byte permutes so that one dp4a consumes four input
// channels of one output channel.  The taps of the C_out slice pass
// through an n_buffers-deep ring of shared-memory slots filled with
// cp.async, and are fetched again for every output row (Eq. 2).  A slot is
// refilled only after every thread has consumed its tap (the credit rule
// of section V-A); the ring depth is min(n_buffers, k_h*k_w), as on the
// TPU.
//
// What bounds it on an H100.  A layer's bound is a microsecond or two (a
// ResNet 3x3 layer's 1.85 GOP take about 1 us at 1,979 TOP/s, its
// activations about as long at 3.35 TB/s), so fills, the line buffer, the
// epilogue and occupancy set conv_mma's time, not the MMA rate: that is
// why it issues mma.sync (half of wgmma's rate is still far from the
// bound) and keeps the shifted-pixel gather, which no canonical wgmma
// shared-memory layout describes.  The streamed tier still runs on the
// CUDA cores.  PERF.md has the times, and a dissection of where
// conv_mma's go.
#include "common.cuh"

namespace {

using h2pipe::cp_async4;
using h2pipe::cp_async_commit;
using h2pipe::cp_async_wait;

constexpr int TCO = 32;  // output channels per CTA
constexpr int OWB = 2;   // output columns per thread item
constexpr int NT = 128;  // threads per CTA
constexpr int QUADS = TCO / 4;

struct ConvArgs {
  const int8_t* x;
  const int8_t* w;
  const float* w_scale;
  const float* bias;
  float act_scale, inv_act;
  int8_t* out_q;
  float* out_f;
  int32_t* out_i32;
  int B, H, W, C, Ho, Wo, Co, kh, kw, stride, pad_t, pad_l;
  int rows_per_band, n_buffers, relu;
  int Cp, Cw, Wp, PS;  // padded channels, words per pixel, line width, stride
};

// Copy tap t's [C, 32] slice of the C_out tile into a [Cp][32] slot.
__device__ __forceinline__ void fill_tap(const ConvArgs& a, int t, int co0,
                                         int* slot) {
  const int words = a.Cp * QUADS;
  for (int idx = threadIdx.x; idx < words; idx += NT) {
    int c = idx / QUADS, q = idx % QUADS;
    int co = co0 + 4 * q;
    bool valid = c < a.C && co < a.Co;
    const int8_t* src =
        valid ? a.w + ((size_t)t * a.C + c) * a.Co + co : a.w;
    cp_async4(slot + idx, src, valid);
  }
}

// The k_h input rows under output row r, zero-padded, as [kh][Wp][PS] words.
__device__ __forceinline__ void fill_line_buffer(const ConvArgs& a, int b,
                                                 int r, int* lb) {
  const int per_row = a.Wp * a.Cw;
  const int words = a.kh * per_row;
  for (int idx = threadIdx.x; idx < words; idx += NT) {
    int i = idx / per_row, rem = idx % per_row;
    int wp = rem / a.Cw, c4 = rem % a.Cw;
    int ih = r * a.stride - a.pad_t + i;
    int iw = wp - a.pad_l;
    int v = 0;
    if (ih >= 0 && ih < a.H && iw >= 0 && iw < a.W) {
      const int8_t* p =
          a.x + (((size_t)b * a.H + ih) * a.W + iw) * a.C + 4 * c4;
      if ((a.C & 3) == 0) {
        v = *reinterpret_cast<const int*>(p);
      } else {
        for (int k = 0; k < 4; ++k)
          if (4 * c4 + k < a.C) v |= (int)(uint8_t)p[k] << (8 * k);
      }
    }
    lb[(i * a.Wp + wp) * a.PS + c4] = v;
  }
}

// acc[item][col][m] += the tap (i, j) contribution, from weight slot ws.
template <int MAXI>
__device__ __forceinline__ void mac_tap(const ConvArgs& a, const int* lb,
                                        const int* ws, int i, int j,
                                        int (&acc)[MAXI][OWB][4]) {
  const int q = threadIdx.x % QUADS;
  const int n_items = ((a.Wo + OWB - 1) / OWB) * QUADS;
  const int* xrow = lb + i * a.Wp * a.PS;
  int col[MAXI][OWB];
#pragma unroll
  for (int k = 0; k < MAXI; ++k) {
    int ow0 = ((threadIdx.x + k * NT) / QUADS) * OWB;
#pragma unroll
    for (int o = 0; o < OWB; ++o) {
      int ow = min(ow0 + o, a.Wo - 1);  // clamped columns are discarded
      col[k][o] = (ow * a.stride + j) * a.PS;
    }
  }
  for (int c4 = 0; c4 < a.Cw; ++c4) {
    const int* wq = ws + (4 * c4) * QUADS + q;
    int a0 = wq[0], a1 = wq[QUADS], a2 = wq[2 * QUADS], a3 = wq[3 * QUADS];
    // rows are input channels, bytes are output channels: transpose so
    // that word m holds the four input channels of output channel m
    int t0 = __byte_perm(a0, a1, 0x5140), t1 = __byte_perm(a2, a3, 0x5140);
    int t2 = __byte_perm(a0, a1, 0x7362), t3 = __byte_perm(a2, a3, 0x7362);
    int bw[4] = {__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
                 __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632)};
#pragma unroll
    for (int k = 0; k < MAXI; ++k) {
      if (threadIdx.x + k * NT >= n_items) break;
#pragma unroll
      for (int o = 0; o < OWB; ++o) {
        int xv = xrow[col[k][o] + c4];
#pragma unroll
        for (int m = 0; m < 4; ++m)
          acc[k][o][m] = __dp4a(xv, bw[m], acc[k][o][m]);
      }
    }
  }
}

template <int MAXI>
__device__ __forceinline__ void store_row(const ConvArgs& a, int b, int r,
                                          int co0, int (&acc)[MAXI][OWB][4]) {
  const int q = threadIdx.x % QUADS;
  const int n_items = ((a.Wo + OWB - 1) / OWB) * QUADS;
  const int co = co0 + 4 * q;
  if (co >= a.Co) return;
  float sc[4], bi[4];
  if (!a.out_i32) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      sc[m] = a.w_scale[co + m];
      bi[m] = a.bias[co + m];
    }
  }
#pragma unroll
  for (int k = 0; k < MAXI; ++k) {
    int item = threadIdx.x + k * NT;
    if (item >= n_items) break;
    int ow0 = (item / QUADS) * OWB;
#pragma unroll
    for (int o = 0; o < OWB; ++o) {
      int ow = ow0 + o;
      if (ow >= a.Wo) break;
      size_t off = (((size_t)b * a.Ho + r) * a.Wo + ow) * a.Co + co;
      if (a.out_i32) {
        *reinterpret_cast<int4*>(a.out_i32 + off) =
            make_int4(acc[k][o][0], acc[k][o][1], acc[k][o][2], acc[k][o][3]);
        continue;
      }
      int8_t qv[4];
      float yf[4];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        yf[m] = h2pipe::requant(acc[k][o][m], sc[m], bi[m], a.act_scale,
                                a.inv_act, a.relu != 0, &qv[m]);
      int packed = (int)(uint8_t)qv[0] | ((int)(uint8_t)qv[1] << 8) |
                   ((int)(uint8_t)qv[2] << 16) | ((int)(uint8_t)qv[3] << 24);
      *reinterpret_cast<int*>(a.out_q + off) = packed;
      if (a.out_f)
        *reinterpret_cast<float4*>(a.out_f + off) =
            make_float4(yf[0], yf[1], yf[2], yf[3]);
    }
  }
}

template <int MAXI>
__global__ void __launch_bounds__(NT) conv_stream_kernel(ConvArgs a) {
  extern __shared__ int smem[];
  const int co0 = blockIdx.x * TCO;
  const int r0 = blockIdx.y * a.rows_per_band;
  const int r1 = min(a.Ho, r0 + a.rows_per_band);
  const int b = blockIdx.z;
  const int taps = a.kh * a.kw;
  const int slot_words = a.Cp * QUADS;
  const int nb = min(a.n_buffers, taps);
  int* ws = smem;                      // the streamed tap ring
  int* lb = smem + nb * slot_words;    // line buffer

  for (int r = r0; r < r1; ++r) {
    __syncthreads();                   // previous row done with lb / ring
    fill_line_buffer(a, b, r, lb);
    int acc[MAXI][OWB][4];
#pragma unroll
    for (int k = 0; k < MAXI; ++k)
#pragma unroll
      for (int o = 0; o < OWB; ++o)
#pragma unroll
        for (int m = 0; m < 4; ++m) acc[k][o][m] = 0;

    // warm-up: fill the ring (one commit group per slot, even if empty)
    for (int s = 0; s < nb; ++s) {
      fill_tap(a, s, co0, ws + s * slot_words);
      cp_async_commit();
    }
    for (int t = 0; t < taps; ++t) {
      cp_async_wait(nb - 1);         // tap t has landed
      __syncthreads();
      int* slot = ws + (t % nb) * slot_words;
      mac_tap<MAXI>(a, lb, slot, t / a.kw, t % a.kw, acc);
      __syncthreads();               // slot consumed: its credit returns
      if (t + nb < taps) fill_tap(a, t + nb, co0, slot);
      cp_async_commit();
    }
    store_row<MAXI>(a, b, r, co0, acc);
  }
}

void* pick_stream(int maxi) {
  switch (maxi) {
    case 1: return (void*)conv_stream_kernel<1>;
    case 2: return (void*)conv_stream_kernel<2>;
    case 4: return (void*)conv_stream_kernel<4>;
    default: return (void*)conv_stream_kernel<8>;
  }
}

// Shared-memory bytes one CTA of the streamed tier claims
// (ops.smem_bytes mirrors this).
long stream_smem_bytes(int C, int Wo, int kh, int kw, int stride,
                       int n_buffers) {
  int Cp = (C + 3) & ~3;
  int Wp = (Wo - 1) * stride + kw;
  int taps = kh * kw;
  int nb = n_buffers < taps ? n_buffers : taps;
  long slots = (long)nb * Cp * TCO;
  long line = (long)kh * Wp * (Cp / 4 + 1) * 4;
  return slots + line;
}

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

}  // namespace

extern "C" {

// Launches on `stream`.  Exactly one of out_q (int8, fused requant; out_f
// optional f32 pre-quant values) and out_i32 (raw int32 sums) is set.
// The pinned tier takes its plan from ops.conv_plan (wn, nf: the
// conv_mma instance, whose C_out tile is 8 * wn * nf; rows_per_band,
// packed, smem: the bytes of its layout, which layout() must reproduce);
// the streamed tier ignores those.  Returns cudaGetLastError() after the
// launch.
int conv2d_int8_launch(const int8_t* x, const int8_t* w, const float* w_scale,
                       const float* bias, float act_scale, float inv_act,
                       int8_t* out_q, float* out_f, int32_t* out_i32, int B,
                       int H, int W,
                       int C, int Ho, int Wo, int Co, int kh, int kw,
                       int stride, int pad_t, int pad_l, int streamed,
                       int n_buffers, int relu, int wn, int nf,
                       int rows_per_band, int packed, int smem,
                       cudaStream_t stream) {
  if ((Co & 3) != 0) return (int)cudaErrorInvalidValue;
  if (!streamed) {
    if (rows_per_band < 1 || (!packed && (C & 3) != 0))
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

  ConvArgs a{x, w, w_scale, bias, act_scale, inv_act, out_q, out_f, out_i32,
             B, H, W, C, Ho, Wo, Co, kh, kw, stride, pad_t, pad_l,
             0, n_buffers, relu, 0, 0, 0, 0};
  a.Cp = (C + 3) & ~3;
  a.Cw = a.Cp / 4;
  a.Wp = (Wo - 1) * stride + kw;
  a.PS = a.Cw + 1;
  int items = ((Wo + OWB - 1) / OWB) * QUADS;
  int maxi = (items + NT - 1) / NT;
  if (maxi > 8 || n_buffers < 1) return (int)cudaErrorInvalidValue;
  maxi = maxi <= 1 ? 1 : maxi <= 2 ? 2 : maxi <= 4 ? 4 : 8;

  int co_tiles = (Co + TCO - 1) / TCO;
  int want = 2 * h2pipe::sm_count();
  int bands = (want + co_tiles * B - 1) / (co_tiles * B);
  bands = bands < 1 ? 1 : (bands > Ho ? Ho : bands);
  a.rows_per_band = (Ho + bands - 1) / bands;
  bands = (Ho + a.rows_per_band - 1) / a.rows_per_band;

  size_t smem_s = (size_t)stream_smem_bytes(C, Wo, kh, kw, stride,
                                            n_buffers);
  void* fn = pick_stream(maxi);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_s);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(co_tiles, bands, B);
  void* args[] = {&a};
  err = cudaLaunchKernel(fn, grid, dim3(NT), args, smem_s, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
