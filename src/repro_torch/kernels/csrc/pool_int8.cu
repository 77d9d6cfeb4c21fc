// The pooling topology engines: SAME maxpool and global average pool.
//
// Replaces the Pallas kernels of repro/kernels/pool_int8/kernel.py:
//   _maxpool_kernel  -> maxpool_kernel
//   _gap_kernel      -> gap_kernel
//
// maxpool: one thread per output pixel and group of four channels.  The
// k x k window's words are read straight from global memory (neighbouring
// threads read neighbouring words, and overlapping windows hit L1/L2) and
// reduced with the per-byte signed max __vmaxs4.  Taps that fall in the
// SAME padding read -128 in every byte, as the reference pads with -128.
// GAP: one thread per (image, channel) sums H*W int8 values exactly in
// int32, multiplies by f32(1)/f32(H*W) and then by f32(1)/f32(act_scale)
// (XLA's rewrite of the reference's divides by constants), rounds half to
// even and clips to +-127.
//
// What bounds them on an H100: both move bytes and do almost no
// arithmetic, so the bound is the input read once and the output written
// once at 3.35 TB/s.  At the main path's sizes (6.4 MB into the stem pool,
// 0.8 MB into GAP at batch 8) launch latency is of the same order.
#include "common.cuh"

namespace {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
maxpool_kernel(const int* x, int* out, int B, int H, int W, int Cw, int Ho,
               int Wo, int k, int stride, int pad_t, int pad_l) {
  size_t total = (size_t)B * Ho * Wo * Cw;
  for (size_t idx = blockIdx.x * (size_t)NT + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * NT) {
    int c4 = idx % Cw;
    size_t pix = idx / Cw;
    int ow = pix % Wo;
    int oh = (pix / Wo) % Ho;
    int b = pix / ((size_t)Wo * Ho);
    unsigned acc = 0x80808080u;
    for (int i = 0; i < k; ++i) {
      int ih = oh * stride - pad_t + i;
      for (int j = 0; j < k; ++j) {
        int iw = ow * stride - pad_l + j;
        unsigned v = 0x80808080u;                 // the -128 padding
        if (ih >= 0 && ih < H && iw >= 0 && iw < W)
          v = (unsigned)x[(((size_t)b * H + ih) * W + iw) * Cw + c4];
        acc = __vmaxs4(acc, v);
      }
    }
    out[idx] = (int)acc;
  }
}

__global__ void __launch_bounds__(NT)
gap_kernel(const int8_t* x, int8_t* out, int HW, int C, float inv_hw,
           float inv_act) {
  int c = blockIdx.x * NT + threadIdx.x;
  int b = blockIdx.y;
  if (c >= C) return;
  const int8_t* p = x + (size_t)b * HW * C + c;
  int s = 0;
  for (int i = 0; i < HW; ++i) s += p[(size_t)i * C];
  float m = __fmul_rn(__int2float_rn(s), inv_hw);
  float r = rintf(__fmul_rn(m, inv_act));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  out[(size_t)b * C + c] = static_cast<int8_t>(static_cast<int>(r));
}

}  // namespace

extern "C" {

// x: [B, H, W, C] int8 with C % 4 == 0 -> out [B, Ho, Wo, C] int8.
int maxpool_int8_launch(const int8_t* x, int8_t* out, int B, int H, int W,
                        int C, int Ho, int Wo, int k, int stride, int pad_t,
                        int pad_l, cudaStream_t stream) {
  if ((C & 3) != 0) return (int)cudaErrorInvalidValue;
  int Cw = C / 4;
  size_t total = (size_t)B * Ho * Wo * Cw;
  size_t blocks = (total + NT - 1) / NT;
  size_t cap = (size_t)h2pipe::sm_count() * 16;
  maxpool_kernel<<<(unsigned)(blocks < cap ? blocks : cap), NT, 0, stream>>>(
      reinterpret_cast<const int*>(x), reinterpret_cast<int*>(out), B, H, W,
      Cw, Ho, Wo, k, stride, pad_t, pad_l);
  return (int)cudaGetLastError();
}

// x: [B, H, W, C] int8 -> out [B, 1, 1, C] int8; inv_hw = f32(1)/f32(H*W),
// inv_act = f32(1)/f32(act_scale).
int global_avgpool_int8_launch(const int8_t* x, int8_t* out, int B, int H,
                               int W, int C, float inv_hw, float inv_act,
                               cudaStream_t stream) {
  dim3 grid((C + NT - 1) / NT, B);
  gap_kernel<<<grid, NT, 0, stream>>>(x, out, H * W, C, inv_hw, inv_act);
  return (int)cudaGetLastError();
}

}  // extern "C"
