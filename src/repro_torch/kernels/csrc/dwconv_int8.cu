// int8 depthwise SAME conv with the requant epilogue fused: the MobileNet
// layer engine (groups == C, weights [k_h, k_w, 1, C]).
//
// Replaces the Pallas kernels of repro/kernels/conv2d_int8/kernel.py:
//   _dwconv_kernel         (pinned taps)        -> dw_kernel<false, ..>
//   _dwconv_stream_kernel  (HBM-streamed taps)  -> dw_kernel<true, ..>
//
// What bounds it on an H100.  A depthwise conv sums over taps only, never
// over channels, so dp4a and the tensor cores do not apply: each output is
// k_h*k_w int8 x int8 -> int32 multiply-adds on the CUDA cores, about
// 2*9 = 18 operations per byte of input.  At batch 8 the 17 dw layers of
// MobileNetV2 move 48.4 MB and do 0.33 G operations, so the bytes (3.35
// TB/s) bound it, not the arithmetic.
//
// What the design does about that.  Every input byte is read from device
// memory about once per band: one CTA covers (channel tile, band of output
// rows, image) and keeps a ring of the k_h padded input rows of its channel
// tile in shared memory; moving to the next output row loads only the
// `stride` new rows, so a row is fetched once per band (plus the k_h - 1
// halo rows where bands meet) instead of once per tap.  Zeros stand in for
// the SAME padding: pad//2 at the top/left, the odd pixel at the
// bottom/right.  Rows are loaded 16 bytes a thread where C allows (8 or
// 4 where it does not), and the grid asks for about eight CTAs per SM, so
// that enough loads are in flight to cover the latency of device memory.
// In the MACs a thread owns one quad of channels (a char4 word) and up to
// MAXC output columns; the channel tile (quads = 8, 16 or 32) is chosen by
// the wrapper so that narrow late layers (7x7, C = 960) still fill the
// CTA's lanes.
//
// Weight tiers.
//   pinned:   the CTA's k_h*k_w*4*quads weight bytes are copied into shared
//             memory once and reused for every row of its band.
//   streamed: the [1, C_tile] taps pass through a min(n_buffers, k_h*k_w)-
//             deep ring of shared-memory slots filled with cp.async, and
//             are fetched again for every output row (Eq. 2).  A slot is
//             refilled only after every thread has consumed its tap (the
//             credit rule of section V-A, as in conv2d_int8.cu).
//
// Sums are exact int32 (at most 25 * 127 * 127 = 403,225 in magnitude), so
// the f32 epilogue (h2pipe::requant) sees exact integers.
#include <type_traits>

#include "common.cuh"

namespace {

using h2pipe::cp_async4;
using h2pipe::cp_async_commit;
using h2pipe::cp_async_wait;

constexpr int NT = 128;  // threads per CTA

struct DwArgs {
  const int8_t* x;
  const int8_t* w;
  const float* w_scale;
  const float* bias;
  float act_scale, inv_act;
  int8_t* out_q;
  float* out_f;
  int32_t* out_i32;
  int B, H, W, C, Ho, Wo, kh, kw, stride, pad_t, pad_l;
  int quads, qshift, rows_per_band, n_buffers, relu;
  int Wp;   // padded line width, (Wo - 1) * stride + kw
  int vec;  // words per line-buffer load: 4, 2 or 1, as C allows
};

// Copy tap t's [1, 4*quads] channel slice into a slot of `quads` words.
__device__ __forceinline__ void fill_tap(const DwArgs& a, int t, int c0,
                                         int* slot) {
  for (int q = threadIdx.x; q < a.quads; q += NT) {
    int c = c0 + 4 * q;
    bool valid = c < a.C;
    cp_async4(slot + q, valid ? a.w + (size_t)t * a.C + c : a.w, valid);
  }
}

// Ring slot of padded input row ih (ih may be negative: the top padding).
__device__ __forceinline__ int ring_row(const DwArgs& a, int ih) {
  int s = ih % a.kh;
  return s < 0 ? s + a.kh : s;
}

// Load input rows lo..hi of image b, channel tile c0, zero-padded, into
// their ring slots: lb is [kh][Wp][quads] words.  VEC words (4*VEC
// channels) per load; C % (4*VEC) == 0, so a load is wholly in or out.
template <int VEC>
__device__ __forceinline__ void fill_rows(const DwArgs& a, int b, int c0,
                                          int lo, int hi, int* lb) {
  using V = typename std::conditional<
      VEC == 4, int4, typename std::conditional<VEC == 2, int2, int>::type
      >::type;
  const int per_row = a.Wp * a.quads;
  for (int ih = lo; ih <= hi; ++ih) {
    int* dst = lb + ring_row(a, ih) * per_row;
    const bool row_in = ih >= 0 && ih < a.H;
    const int8_t* src = a.x + ((size_t)b * a.H + (row_in ? ih : 0)) * a.W *
                                  a.C;
    for (int word = threadIdx.x * VEC; word < per_row; word += NT * VEC) {
      int wp = word >> a.qshift, q = word & (a.quads - 1);
      int iw = wp - a.pad_l, c = c0 + 4 * q;
      V v{};
      if (row_in && iw >= 0 && iw < a.W && c < a.C)
        v = __ldg(reinterpret_cast<const V*>(src + (size_t)iw * a.C + c));
      *reinterpret_cast<V*>(dst + word) = v;
    }
  }
}

// acc[k][m] += x[row, col_k * stride + j, channel m] * w[tap, channel m]
// for this thread's quad and its columns col_k = lane + k * lanes.
template <int MAXC>
__device__ __forceinline__ void mac_tap(const DwArgs& a, const int* row,
                                        int j, int wv, int q, int lane,
                                        int (&acc)[MAXC][4]) {
  const int lanes = NT >> a.qshift;
  int wb[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) wb[m] = (int)(int8_t)(wv >> (8 * m));
#pragma unroll
  for (int k = 0; k < MAXC; ++k) {
    int ow = lane + k * lanes;
    if (ow >= a.Wo) break;
    int xv = row[((ow * a.stride + j) << a.qshift) + q];
#pragma unroll
    for (int m = 0; m < 4; ++m)
      acc[k][m] += (int)(int8_t)(xv >> (8 * m)) * wb[m];
  }
}

template <int MAXC>
__device__ __forceinline__ void store_row(const DwArgs& a, int b, int r,
                                          int c, int lane,
                                          const float (&sc)[4],
                                          const float (&bi)[4],
                                          int (&acc)[MAXC][4]) {
  const int lanes = NT >> a.qshift;
  if (c >= a.C) return;
#pragma unroll
  for (int k = 0; k < MAXC; ++k) {
    int ow = lane + k * lanes;
    if (ow >= a.Wo) break;
    size_t off = (((size_t)b * a.Ho + r) * a.Wo + ow) * a.C + c;
    if (a.out_i32) {
      *reinterpret_cast<int4*>(a.out_i32 + off) =
          make_int4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
      continue;
    }
    int8_t qv[4];
    float yf[4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
      yf[m] = h2pipe::requant(acc[k][m], sc[m], bi[m], a.act_scale,
                              a.inv_act, a.relu != 0, &qv[m]);
    *reinterpret_cast<int*>(a.out_q + off) =
        (int)(uint8_t)qv[0] | ((int)(uint8_t)qv[1] << 8) |
        ((int)(uint8_t)qv[2] << 16) | ((int)(uint8_t)qv[3] << 24);
    if (a.out_f)
      *reinterpret_cast<float4*>(a.out_f + off) =
          make_float4(yf[0], yf[1], yf[2], yf[3]);
  }
}

template <bool STREAM, int MAXC>
__global__ void __launch_bounds__(NT) dw_kernel(DwArgs a) {
  extern __shared__ int smem[];
  const int c0 = blockIdx.x * 4 * a.quads;
  const int r0 = blockIdx.y * a.rows_per_band;
  const int r1 = min(a.Ho, r0 + a.rows_per_band);
  const int b = blockIdx.z;
  const int taps = a.kh * a.kw;
  const int nb = STREAM ? min(a.n_buffers, taps) : taps;
  const int q = threadIdx.x & (a.quads - 1), lane = threadIdx.x >> a.qshift;
  const int c = c0 + 4 * q;
  int* ws = smem;                       // pinned taps, or the streamed ring
  int* lb = smem + nb * a.quads;        // ring of k_h input rows

  if (!STREAM) {                        // the pinned tier: load once
    for (int t = 0; t < taps; ++t) fill_tap(a, t, c0, ws + t * a.quads);
    cp_async_commit();
  }
  float sc[4] = {0.f, 0.f, 0.f, 0.f}, bi[4] = {0.f, 0.f, 0.f, 0.f};
  if (!a.out_i32 && c < a.C) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      sc[m] = a.w_scale[c + m];
      bi[m] = a.bias[c + m];
    }
  }

  int next = r0 * a.stride - a.pad_t;   // first input row not yet loaded
  for (int r = r0; r < r1; ++r) {
    const int top = r * a.stride - a.pad_t;
    __syncthreads();                    // previous row done with lb / ring
    if (a.vec == 4)
      fill_rows<4>(a, b, c0, max(next, top), top + a.kh - 1, lb);
    else if (a.vec == 2)
      fill_rows<2>(a, b, c0, max(next, top), top + a.kh - 1, lb);
    else
      fill_rows<1>(a, b, c0, max(next, top), top + a.kh - 1, lb);
    next = top + a.kh;
    int acc[MAXC][4];
#pragma unroll
    for (int k = 0; k < MAXC; ++k)
#pragma unroll
      for (int m = 0; m < 4; ++m) acc[k][m] = 0;

    if (!STREAM) {
      cp_async_wait(0);
      __syncthreads();
      for (int t = 0; t < taps; ++t) {
        int i = t / a.kw;
        mac_tap<MAXC>(a, lb + ring_row(a, top + i) * a.Wp * a.quads,
                      t - i * a.kw, ws[t * a.quads + q], q, lane, acc);
      }
    } else {
      // warm-up: fill the ring (one commit group per slot, even if empty)
      for (int s = 0; s < nb; ++s) {
        fill_tap(a, s, c0, ws + s * a.quads);
        cp_async_commit();
      }
      for (int t = 0; t < taps; ++t) {
        cp_async_wait(nb - 1);          // tap t has landed
        __syncthreads();
        int* slot = ws + (t % nb) * a.quads;
        int i = t / a.kw;
        mac_tap<MAXC>(a, lb + ring_row(a, top + i) * a.Wp * a.quads,
                      t - i * a.kw, slot[q], q, lane, acc);
        __syncthreads();                // slot consumed: its credit returns
        if (t + nb < taps) fill_tap(a, t + nb, c0, slot);
        cp_async_commit();
      }
    }
    store_row<MAXC>(a, b, r, c, lane, sc, bi, acc);
  }
}

template <bool STREAM>
void* pick(int maxc) {
  switch (maxc) {
    case 1: return (void*)dw_kernel<STREAM, 1>;
    case 2: return (void*)dw_kernel<STREAM, 2>;
    case 4: return (void*)dw_kernel<STREAM, 4>;
    case 8: return (void*)dw_kernel<STREAM, 8>;
    default: return (void*)dw_kernel<STREAM, 16>;
  }
}

// Shared-memory bytes one CTA claims (ops.dw_smem_bytes mirrors this).
long smem_bytes(int Wo, int kh, int kw, int stride, int quads, int stream,
                int n_buffers) {
  int Wp = (Wo - 1) * stride + kw;
  int taps = kh * kw;
  int nb = stream ? (n_buffers < taps ? n_buffers : taps) : taps;
  return (long)(nb + kh * Wp) * quads * 4;
}

}  // namespace

extern "C" {

// Launches on `stream`.  Exactly one of out_q (int8, fused requant; out_f
// optional f32 pre-quant values) and out_i32 (raw int32 sums) is set.
// `quads` (8, 16 or 32) is the channel tile in groups of four channels.
// Returns cudaGetLastError() after the launch.
int dwconv_int8_launch(const int8_t* x, const int8_t* w, const float* w_scale,
                       const float* bias, float act_scale, float inv_act,
                       int8_t* out_q, float* out_f, int32_t* out_i32, int B,
                       int H, int W, int C, int Ho, int Wo, int kh, int kw,
                       int stride, int pad_t, int pad_l, int quads,
                       int streamed, int n_buffers, int relu,
                       cudaStream_t stream) {
  if ((C & 3) != 0 || n_buffers < 1 ||
      (quads != 8 && quads != 16 && quads != 32))
    return (int)cudaErrorInvalidValue;
  int lanes = NT / quads;
  int maxc = (Wo + lanes - 1) / lanes;
  if (maxc > 16) return (int)cudaErrorInvalidValue;
  maxc = maxc <= 1 ? 1 : maxc <= 2 ? 2 : maxc <= 4 ? 4 : maxc <= 8 ? 8 : 16;
  DwArgs a{x, w, w_scale, bias, act_scale, inv_act, out_q, out_f, out_i32,
           B, H, W, C, Ho, Wo, kh, kw, stride, pad_t, pad_l,
           quads, quads == 8 ? 3 : quads == 16 ? 4 : 5, 0, n_buffers, relu,
           (Wo - 1) * stride + kw,
           (C & 15) == 0 ? 4 : (C & 7) == 0 ? 2 : 1};

  // enough CTAs for about eight per SM (loads in flight hide the
  // latency of device memory); a band shares its halo rows
  int c_tiles = (C / 4 + quads - 1) / quads;
  int want = 8 * h2pipe::sm_count();
  int bands = (want + c_tiles * B - 1) / (c_tiles * B);
  bands = bands < 1 ? 1 : (bands > Ho ? Ho : bands);
  a.rows_per_band = (Ho + bands - 1) / bands;
  bands = (Ho + a.rows_per_band - 1) / a.rows_per_band;

  size_t smem = (size_t)smem_bytes(Wo, kh, kw, stride, quads, streamed,
                                  n_buffers);
  void* fn = streamed ? pick<true>(maxc) : pick<false>(maxc);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(c_tiles, bands, B);
  void* args[] = {&a};
  err = cudaLaunchKernel(fn, grid, dim3(NT), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
