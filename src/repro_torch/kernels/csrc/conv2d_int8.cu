// int8 SAME conv with the requant epilogue fused: the HPIPE layer engine.
//
// Replaces the Pallas kernels of repro/kernels/conv2d_int8/kernel.py:
//   _conv_kernel         (pinned weights)   -> conv_kernel<false, ..>
//   _conv_stream_kernel  (HBM-streamed)     -> conv_kernel<true, ..>
//
// Work split.  One CTA covers (image, band of output rows, 32-channel C_out
// tile).  For each output row it fills a line buffer of the k_h padded
// input rows in shared memory (zeros stand in for the SAME padding: pad//2
// at the top/left, the odd pixel at the bottom/right), then sums the
// k_h*k_w taps with dp4a (int8 x int8 -> int32).  A thread owns one
// quad of output channels and up to MAXI pairs of output columns; the
// four weight words of a (tap, 4 input channels, channel quad) are
// transposed in registers with byte permutes so that one dp4a consumes
// four input channels of one output channel.
//
// Weight tiers.
//   pinned:   the CTA copies its C_out slice of ALL taps into shared memory
//             once and reuses it for every row of its band (the on-chip
//             M20K weight buffer).  9 taps x 512 ch x 32 = 147 KB fits the
//             227 KB a block may hold; a wider tile would not.
//   streamed: the taps of the C_out slice pass through an n_buffers-deep
//             ring of shared-memory slots filled with cp.async, and are
//             fetched again for every output row (Eq. 2).  A slot is
//             refilled only after every thread has consumed its tap (the
//             credit rule of section V-A); the ring depth is
//             min(n_buffers, k_h*k_w), as on the TPU.
//
// What bounds it on an H100.  At the ResNet shapes the int8 operations
// bound the work (1,979 TOP/s on the tensor cores against 3.35 TB/s), but
// this first version runs on the CUDA cores through dp4a and re-reads the
// k_h input rows for every output row, so it reaches a small share of the
// tensor-core peak.  The shared-memory strides are padded by one word per
// pixel so the warp's column reads fall in distinct banks; the weight reads
// are broadcast.  wgmma/TMA tiles are the next step.
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

template <bool STREAM, int MAXI>
__global__ void __launch_bounds__(NT) conv_kernel(ConvArgs a) {
  extern __shared__ int smem[];
  const int co0 = blockIdx.x * TCO;
  const int r0 = blockIdx.y * a.rows_per_band;
  const int r1 = min(a.Ho, r0 + a.rows_per_band);
  const int b = blockIdx.z;
  const int taps = a.kh * a.kw;
  const int slot_words = a.Cp * QUADS;
  const int nb = STREAM ? min(a.n_buffers, taps) : taps;
  int* ws = smem;                      // pinned taps, or the streamed ring
  int* lb = smem + nb * slot_words;    // line buffer

  if (!STREAM) {                       // the pinned tier: load once
    for (int t = 0; t < taps; ++t) fill_tap(a, t, co0, ws + t * slot_words);
    cp_async_commit();
  }

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

    if (!STREAM) {
      cp_async_wait(0);
      __syncthreads();
      for (int t = 0; t < taps; ++t)
        mac_tap<MAXI>(a, lb, ws + t * slot_words, t / a.kw, t % a.kw, acc);
    } else {
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
    }
    store_row<MAXI>(a, b, r, co0, acc);
  }
}

template <bool STREAM>
void* pick(int maxi) {
  switch (maxi) {
    case 1: return (void*)conv_kernel<STREAM, 1>;
    case 2: return (void*)conv_kernel<STREAM, 2>;
    case 4: return (void*)conv_kernel<STREAM, 4>;
    default: return (void*)conv_kernel<STREAM, 8>;
  }
}

// Shared-memory bytes one CTA claims (ops.smem_bytes mirrors this).
long smem_bytes(int C, int Wo, int kh, int kw, int stride, int stream,
                int n_buffers) {
  int Cp = (C + 3) & ~3;
  int Wp = (Wo - 1) * stride + kw;
  int taps = kh * kw;
  int nb = stream ? (n_buffers < taps ? n_buffers : taps) : taps;
  long slots = (long)nb * Cp * TCO;
  long line = (long)kh * Wp * (Cp / 4 + 1) * 4;
  return slots + line;
}

}  // namespace

extern "C" {

// Launches on `stream`.  Exactly one of out_q (int8, fused requant; out_f
// optional f32 pre-quant values) and out_i32 (raw int32 sums) is set.
// Returns cudaGetLastError() after the launch.
int conv2d_int8_launch(const int8_t* x, const int8_t* w, const float* w_scale,
                       const float* bias, float act_scale, float inv_act,
                       int8_t* out_q, float* out_f, int32_t* out_i32, int B,
                       int H, int W,
                       int C, int Ho, int Wo, int Co, int kh, int kw,
                       int stride, int pad_t, int pad_l, int streamed,
                       int n_buffers, int relu, cudaStream_t stream) {
  ConvArgs a{x, w, w_scale, bias, act_scale, inv_act, out_q, out_f, out_i32,
             B, H, W, C, Ho, Wo, Co, kh, kw, stride, pad_t, pad_l,
             0, n_buffers, relu, 0, 0, 0, 0};
  a.Cp = (C + 3) & ~3;
  a.Cw = a.Cp / 4;
  a.Wp = (Wo - 1) * stride + kw;
  a.PS = a.Cw + 1;
  int items = ((Wo + OWB - 1) / OWB) * QUADS;
  int maxi = (items + NT - 1) / NT;
  if (maxi > 8 || (Co & 3) != 0 || n_buffers < 1)
    return (int)cudaErrorInvalidValue;
  maxi = maxi <= 1 ? 1 : maxi <= 2 ? 2 : maxi <= 4 ? 4 : 8;

  int co_tiles = (Co + TCO - 1) / TCO;
  int want = 2 * h2pipe::sm_count();
  int bands = (want + co_tiles * B - 1) / (co_tiles * B);
  bands = bands < 1 ? 1 : (bands > Ho ? Ho : bands);
  a.rows_per_band = (Ho + bands - 1) / bands;
  bands = (Ho + a.rows_per_band - 1) / a.rows_per_band;

  size_t smem = (size_t)smem_bytes(C, Wo, kh, kw, stride, streamed,
                                  n_buffers);
  void* fn = streamed ? pick<true>(maxi) : pick<false>(maxi);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(co_tiles, bands, B);
  void* args[] = {&a};
  err = cudaLaunchKernel(fn, grid, dim3(NT), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
