// The pooling topology engines: SAME maxpool and global average pool.
//
// Replaces the Pallas kernels of repro/kernels/pool_int8/kernel.py:
//   _maxpool_kernel  -> maxpool_band<K, S, VEC, NC>
//   _gap_kernel      -> gap_chunk<VEC>
//
// What bounds them on an H100: both move bytes and do almost no
// arithmetic, so the bound is the input read once and the output written
// once at 3.35 TB/s: 77 MB over the seven maxpool launches of a slice run
// (VGG-16's 224x224x64 pool alone reads 25.7 MB at batch 8), 0.8 MB into
// the largest GAP.  The GAP launches are near the launch floor.
//
// maxpool: a CTA per (band of `rows` output rows x segment of `seg`
// output columns, chunk of `cc` channels, image), from the plan of
// ops.pool_plan, which aims at four waves of small CTAs, so that while
// some of an SM's CTAs reduce, others' copies are in flight.  It stages
// the input rows and columns its windows cover in shared memory by
// cp.async (16-byte chunks where C % 16 == 0, else 4), the JAX kernel's
// line buffer: where windows overlap (3x3 stride 2) a band holds two or
// more output rows, so the rows they share are read once from device
// memory.  A thread takes `NC` adjacent output columns
// of one 16- or 4-byte channel group: per window row it reads the
// (NC - 1) * S + K columns under them once into registers and reduces
// with the per-byte signed max __vmaxs4, so the columns that neighbouring
// windows share are reused from registers.  Taps off the map (the SAME
// padding, which the reference fills with -128, the identity of max) are
// skipped; every window holds a real element, and a window of nothing but
// padding would give -128 all the same.  Instances: (K, S) = (3, 2) with
// 4 columns a thread, (2, 2) with 2, and a generic one (K = 0: k and s at
// run time, one column a thread).
//
// GAP: a CTA per (chunk of `cc` channels, image), from ops.gap_plan.
// cc / VEC lanes each load VEC channels of a pixel (16-byte loads where
// C % 16 == 0), and the groups of lanes of the CTA's warps share the H*W
// pixels, four loads in flight a thread: at 7x7 one or two warps, each
// thread at most four pixels, so a launch costs about one round trip to
// device memory.  The groups of a warp add their int32 sums by shuffles,
// the warps theirs in shared memory (integer sums are exact in any
// order), and the first lanes write VEC bytes each.  The epilogue is the
// reference's: the sum as f32, times f32(1)/f32(H*W), times
// f32(1)/f32(act_scale) (XLA's rewrite of the reference's divides by
// constants), rounded half to even, clipped to +-127.
#include "common.cuh"

namespace {

constexpr int POOL_THREADS = 256;   // ops.POOL_THREADS
constexpr int GAP_THREADS = 256;    // ops.GAP_THREADS
constexpr int GAP_PIX = 4;          // ops.GAP_PIX
constexpr unsigned NEG = 0x80808080u;  // -128 in every byte

template <int VEC>
struct Vec;

template <>
struct Vec<16> {
  using T = uint4;
  static __device__ __forceinline__ T ident() {
    return make_uint4(NEG, NEG, NEG, NEG);
  }
  static __device__ __forceinline__ T vmax(T a, T b) {
    return make_uint4(__vmaxs4(a.x, b.x), __vmaxs4(a.y, b.y),
                      __vmaxs4(a.z, b.z), __vmaxs4(a.w, b.w));
  }
};

template <>
struct Vec<4> {
  using T = unsigned;
  static __device__ __forceinline__ T ident() { return NEG; }
  static __device__ __forceinline__ T vmax(T a, T b) {
    return __vmaxs4(a, b);
  }
};

struct PoolArgs {
  const int8_t* x;
  int8_t* out;
  int H, W, C, Ho, Wo, k, s, pad_t, pad_l;
  int rows, seg, segs, cc;     // the plan (ops.pool_plan)
  int scols;                   // the layout (pool_layout() below)
};

struct PoolLayout {
  int srows, scols;
  long smem;
};

// ops.pool_layout mirrors this: the staged input rows and columns of one
// CTA, cc bytes a pixel, row-major.
PoolLayout pool_layout(int rows, int seg, int cc, int k, int s) {
  PoolLayout L;
  L.srows = (rows - 1) * s + k;
  L.scols = (seg - 1) * s + k;
  L.smem = (long)L.srows * L.scols * cc;
  return L;
}

template <int K, int S, int VEC, int NC>
__global__ void __launch_bounds__(POOL_THREADS) maxpool_band(PoolArgs a) {
  using V = Vec<VEC>;
  using T = typename V::T;
  extern __shared__ __align__(16) unsigned char stage[];
  const int k = K ? K : a.k, s = K ? S : a.s;
  const int band = blockIdx.x / a.segs, sg = blockIdx.x - band * a.segs;
  const int c0 = blockIdx.y * a.cc, b = blockIdx.z;
  const int oh0 = band * a.rows, ow0 = sg * a.seg;
  const int nr = min(a.rows, a.Ho - oh0), nw = min(a.seg, a.Wo - ow0);
  const int ih0 = oh0 * s - a.pad_t, iw0 = ow0 * s - a.pad_l;
  const int cv = a.cc / VEC;                   // vectors a pixel
  const int srows = (nr - 1) * s + k, scols = (nw - 1) * s + k;
  const int rowb = a.scols * a.cc;             // bytes a staged row
  // the input rows and columns under this CTA's windows that lie on the map
  for (int idx = threadIdx.x; idx < srows * scols * cv; idx += blockDim.x) {
    const int v = idx % cv, rest = idx / cv;
    const int cl = rest % scols, r = rest / scols;
    const int ih = ih0 + r, iw = iw0 + cl;
    if (ih < 0 || ih >= a.H || iw < 0 || iw >= a.W) continue;
    unsigned char* dst = stage + r * rowb + cl * a.cc + v * VEC;
    const int8_t* src =
        a.x + (((size_t)b * a.H + ih) * a.W + iw) * a.C + c0 + v * VEC;
    if (VEC == 16)
      h2pipe::cp_async16(dst, src, true);
    else
      h2pipe::cp_async4(dst, src, true);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int chunks = (nw + NC - 1) / NC;
  for (int item = threadIdx.x; item < nr * chunks * cv; item += blockDim.x) {
    const int v = item % cv, rest = item / cv;
    const int ch = rest % chunks, r = rest / chunks;
    const int oc = ch * NC;                    // first column, in the segment
    T acc[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[j] = V::ident();
    if constexpr (K > 0) {
      constexpr int NIN = (NC - 1) * S + K;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int rr = r * S + i, ih = ih0 + rr;
        if (ih < 0 || ih >= a.H) continue;
        const unsigned char* row = stage + rr * rowb + v * VEC;
        T in[NIN];
#pragma unroll
        for (int t = 0; t < NIN; ++t) {
          const int cl = oc * S + t, iw = iw0 + cl;
          in[t] = cl < scols && iw >= 0 && iw < a.W
                      ? *reinterpret_cast<const T*>(row + cl * a.cc)
                      : V::ident();
        }
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int jj = 0; jj < K; ++jj)
            acc[j] = V::vmax(acc[j], in[j * S + jj]);
      }
    } else {
      for (int i = 0; i < k; ++i) {
        const int rr = r * s + i, ih = ih0 + rr;
        if (ih < 0 || ih >= a.H) continue;
        const unsigned char* row = stage + rr * rowb + v * VEC;
        for (int jj = 0; jj < k; ++jj) {
          const int cl = oc * s + jj, iw = iw0 + cl;
          if (iw >= 0 && iw < a.W)
            acc[0] = V::vmax(acc[0],
                            *reinterpret_cast<const T*>(row + cl * a.cc));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      if (oc + j >= nw) break;
      const size_t off =
          (((size_t)b * a.Ho + oh0 + r) * a.Wo + ow0 + oc + j) * a.C + c0 +
          v * VEC;
      *reinterpret_cast<T*>(a.out + off) = acc[j];
    }
  }
}

struct GapArgs {
  const int8_t* x;
  int8_t* out;
  int HW, C, cc, groups, warps;   // the plan (ops.gap_plan)
  float inv_hw, inv_act;
};

// VEC channels of one pixel: a load, and its bytes added (signed) into s.
template <int VEC>
struct Pix;

template <>
struct Pix<16> {
  using T = uint4;
  static __device__ __forceinline__ T zero() { return make_uint4(0, 0, 0, 0); }
  static __device__ __forceinline__ T at(const int8_t* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  static __device__ __forceinline__ void add(T v, int s[16]) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * q + e] += (int)(signed char)(w[q] >> (8 * e));
  }
  static __device__ __forceinline__ void store(int8_t* p, const int8_t q[16]) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (unsigned)(uint8_t)q[4 * i] |
             (unsigned)(uint8_t)q[4 * i + 1] << 8 |
             (unsigned)(uint8_t)q[4 * i + 2] << 16 |
             (unsigned)(uint8_t)q[4 * i + 3] << 24;
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Pix<4> {
  using T = unsigned;
  static __device__ __forceinline__ T zero() { return 0u; }
  static __device__ __forceinline__ T at(const int8_t* p) {
    return *reinterpret_cast<const unsigned*>(p);
  }
  static __device__ __forceinline__ void add(T v, int s[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[e] += (int)(signed char)(v >> (8 * e));
  }
  static __device__ __forceinline__ void store(int8_t* p, const int8_t q[4]) {
    *reinterpret_cast<unsigned*>(p) =
        (unsigned)(uint8_t)q[0] | (unsigned)(uint8_t)q[1] << 8 |
        (unsigned)(uint8_t)q[2] << 16 | (unsigned)(uint8_t)q[3] << 24;
  }
};

template <>
struct Pix<1> {
  using T = int8_t;
  static __device__ __forceinline__ T zero() { return 0; }
  static __device__ __forceinline__ T at(const int8_t* p) { return *p; }
  static __device__ __forceinline__ void add(T v, int s[1]) { s[0] += v; }
  static __device__ __forceinline__ void store(int8_t* p, const int8_t q[1]) {
    *p = q[0];
  }
};

template <int VEC>
__global__ void __launch_bounds__(GAP_THREADS) gap_chunk(GapArgs a) {
  using P = Pix<VEC>;
  extern __shared__ __align__(16) int part[];   // [warps][cc], warps > 1
  const int lanes = a.cc / VEC;                 // a power of two, <= 32
  const int tid = threadIdx.x, lane = tid & (lanes - 1);
  const int grp = tid >> (__ffs(lanes) - 1);
  const int c0 = blockIdx.x * a.cc, b = blockIdx.y, c = c0 + lane * VEC;
  const bool valid = c < a.C;
  const int8_t* p = a.x + (size_t)b * a.HW * a.C + c;
  int s[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) s[e] = 0;
  // group grp takes pixels grp, grp + groups, ...; GAP_PIX loads in flight
  for (int p0 = grp; p0 < a.HW; p0 += a.groups * GAP_PIX) {
    typename P::T v[GAP_PIX];
#pragma unroll
    for (int i = 0; i < GAP_PIX; ++i) {
      const int px = p0 + i * a.groups;
      v[i] = valid && px < a.HW ? P::at(p + (size_t)px * a.C) : P::zero();
    }
#pragma unroll
    for (int i = 0; i < GAP_PIX; ++i) P::add(v[i], s);
  }
  // the groups of a warp: lanes tid, tid ^ lanes, ... hold one channel
  // set; the VEC sums of a step are independent, so they overlap
  for (int off = lanes; off < 32; off <<= 1)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      s[e] += __shfl_xor_sync(0xffffffffu, s[e], off);
  if (a.warps > 1) {                            // the warps: shared memory
    const int warp = tid >> 5;
    if ((tid & 31) < lanes)
#pragma unroll
      for (int e = 0; e < VEC; ++e) part[warp * a.cc + lane * VEC + e] = s[e];
    __syncthreads();
    if (tid >= lanes) return;
#pragma unroll
    for (int e = 0; e < VEC; ++e) s[e] = 0;
    for (int w = 0; w < a.warps; ++w)
#pragma unroll
      for (int e = 0; e < VEC; ++e) s[e] += part[w * a.cc + lane * VEC + e];
  } else if (tid >= lanes) {
    return;
  }
  if (!valid) return;
  int8_t q[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    float m = __fmul_rn(__int2float_rn(s[e]), a.inv_hw);
    float r = rintf(__fmul_rn(m, a.inv_act));
    r = fminf(fmaxf(r, -127.0f), 127.0f);
    q[e] = static_cast<int8_t>(static_cast<int>(r));
  }
  P::store(a.out + (size_t)b * a.C + c, q);
}

template <int VEC>
void (*maxpool_instance(int k, int s))(PoolArgs) {
  if (k == 3 && s == 2) return maxpool_band<3, 2, VEC, 4>;
  if (k == 2 && s == 2) return maxpool_band<2, 2, VEC, 2>;
  return maxpool_band<0, 0, VEC, 1>;
}

}  // namespace

extern "C" {

// x: [B, H, W, C] int8 with C % 4 == 0 -> out [B, Ho, Wo, C] int8, with
// the plan of ops.pool_plan: bands of `rows` output rows, segments of
// `seg` output columns, chunks of `cc` channels, vec-byte copies, `cols`
// output columns a thread (4 for k = 3 stride 2, 2 for k = 2 stride 2,
// else 1), `threads` a CTA; smem: the bytes of its layout, which
// pool_layout() must reproduce.  Returns cudaGetLastError() after the
// launch.
int maxpool_int8_launch(const int8_t* x, int8_t* out, int B, int H, int W,
                        int C, int Ho, int Wo, int k, int stride, int pad_t,
                        int pad_l, int rows, int bands, int seg, int segs,
                        int cc, int c_tiles, int vec, int cols, int threads,
                        int smem, cudaStream_t stream) {
  const int want_cols = k == 3 && stride == 2 ? 4 : k == 2 && stride == 2 ? 2
                                                                          : 1;
  if (B < 1 || k < 1 || stride < 1 || (vec != 16 && vec != 4) ||
      C % vec != 0 || cc < vec || cc % vec != 0 || C % cc != 0 ||
      c_tiles != C / cc || rows < 1 || bands != (Ho + rows - 1) / rows ||
      seg < 1 || segs != (Wo + seg - 1) / seg || cols != want_cols ||
      threads < 32 || threads > POOL_THREADS || threads % 32 != 0 ||
      pad_t < 0 || pad_l < 0)
    return (int)cudaErrorInvalidValue;
  PoolLayout L = pool_layout(rows, seg, cc, k, stride);
  if (L.smem != smem) return (int)cudaErrorInvalidValue;
  void (*fn)(PoolArgs) = vec == 16 ? maxpool_instance<16>(k, stride)
                                   : maxpool_instance<4>(k, stride);
  cudaError_t err = cudaFuncSetAttribute(
      (void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  PoolArgs a{x, out, H, W, C, Ho, Wo, k, stride, pad_t, pad_l,
             rows, seg, segs, cc, L.scols};
  fn<<<dim3(bands * segs, c_tiles, B), threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// x: [B, H, W, C] int8 -> out [B, 1, 1, C] int8, with the plan of
// ops.gap_plan: chunks of cc channels (cc / vec lanes, which divide 32),
// `groups` groups of lanes sharing the pixels in `warps` warps; smem: the
// warps' sums, warps * cc int32 (0 for one warp).  inv_hw =
// f32(1)/f32(H*W), inv_act = f32(1)/f32(act_scale).
int global_avgpool_int8_launch(const int8_t* x, int8_t* out, int B, int H,
                               int W, int C, int vec, int cc, int c_tiles,
                               int groups, int warps, int smem,
                               float inv_hw, float inv_act,
                               cudaStream_t stream) {
  const int lanes = vec > 0 ? cc / vec : 0;
  if (B < 1 || H * W < 1 || (vec != 16 && vec != 4 && vec != 1) ||
      C % vec != 0 || cc % vec != 0 || lanes < 1 || 32 % lanes != 0 ||
      c_tiles != (C + cc - 1) / cc || warps < 1 ||
      32 * warps > GAP_THREADS || groups != warps * (32 / lanes) ||
      smem != (warps > 1 ? warps * cc * 4 : 0))
    return (int)cudaErrorInvalidValue;
  void (*fn)(GapArgs) =
      vec == 16 ? gap_chunk<16> : vec == 4 ? gap_chunk<4> : gap_chunk<1>;
  GapArgs a{x, out, H * W, C, cc, groups, warps, inv_hw, inv_act};
  fn<<<dim3(c_tiles, B), 32 * warps, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
