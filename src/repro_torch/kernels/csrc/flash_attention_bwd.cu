// Flash-attention backward: dq (K10) and dk, dv (K11), recomputing the
// block scores from q, k and the forward's log-sum-exp.
//
// Replaces repro/kernels/flash_attention/kernel.py::_flash_bwd_dq_kernel
// (called by flash_attention_bwd at :236) and ::_flash_bwd_dkv_kernel
// (called at :257).  Both compute what those kernels compute:
//   s = (q . k) * scale in f32; with a softcap s = tanh(s / cap) * cap and
//   dcap = 1 - (s / cap)^2, taken before masking; masked (causal: q_pos >=
//   k_pos; window: q_pos - k_pos < window) elements get p = 0, otherwise
//   p = exp(s - lse); dp = do . v; ds = p * (dp - delta) (* dcap), with
//   delta = rowsum(do * o) computed by the wrapper, as the JAX wrapper
//   does outside its kernels; dq = sum_k ds . k * scale, dk = sum_q ds^T .
//   q * scale, dv = sum_q p^T . do.  GQA: query head h reads KV head
//   h / (H / KV); dk and dv are written per query head, rounded to k's
//   and v's dtype, and the wrapper sums the H / KV heads of each group.
//
// Rounding.  Every operand is converted to f32 and every product is an f32
// FMA on the CUDA cores: p and ds are never rounded to bf16, as the
// reference keeps them f32 in all five products.  The reference multiplies
// each tile's ds . k (and ds^T . q) by scale before adding it to the
// accumulator; here ds is multiplied by scale once per element and the
// products go straight into the accumulator.  The two differ by f32
// roundings only (a relative 2^-24 per term and the order of summation),
// far inside the tests' tolerances.
//
// On the TPU the grid walks the k blocks of a q block (dq) or the q blocks
// of a k block (dk, dv) in order, carrying the sums in VMEM scratch.  Here
// one CTA owns one (batch, head, block of rows) and loops over the other
// axis, with the sums in registers:
//   flash_bwd_dq<T>   one CTA per 64 query rows; K/V tiles of 32 keys.
//   flash_bwd_dkv<T>  one CTA per 64 keys; Q/dO tiles of 32 query rows.
// Eight warps of 8 rows each.  In the score products each lane takes one
// column (a key for dq, a query row for dk/dv) and reads its operand row
// as float4 while the warp's 8 rows are broadcast; in the accumulating
// products each lane takes the columns lane, lane + 32, ... of the head
// dim.  Tiles the mask hides entirely are skipped, which is exact (p and
// ds are zero there).
//
// What bounds it on an H100: at the Phi-4-mini training shape (B=4, H=24,
// KV=8, S=512, hd=128, causal) dq does 3 and dk/dv 4 products of
// B*H*S^2*hd FMAs, halved by the causal mask: 4.8 and 6.4 GFLOP against
// about 40 MB moved, so operations bound both (4.9 and 6.5 us at the
// tensor cores' 989 TFLOP/s).  This first version runs them on the CUDA
// cores (67 TFLOP/s f32 at most) for the f32 products the reference
// demands, so it sits far above that bound; mma.sync or wgmma for the two
// score products (bf16 in, f32 out, exact) and an exact three-way bf16
// split of p and ds for the other three are the way down.  PERF.md has its
// times against the bound and against the library's attention backward.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;     // threads: 8 warps
constexpr int ROWS = 8;     // rows (dq: query rows; dk/dv: keys) per warp
constexpr int BQ10 = 64;    // query rows per CTA, dq kernel
constexpr int BK10 = 32;    // keys per tile, dq kernel
constexpr int BK11 = 64;    // keys per CTA, dk/dv kernel
constexpr int BQ11 = 32;    // query rows per tile, dk/dv kernel
constexpr int PAD = 4;      // row padding in floats (keeps float4 alignment)

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, Sq], contiguous
  const float* delta;  // [B, H, Sq], contiguous
  void* dq;
  void* dk;            // per query head
  void* dv;            // per query head
  // element strides over (batch, head, seq) of q, k, v, do, dq, dk, dv;
  // the head dim is contiguous
  long long s[21];
  int B, H, KV, Sq, Sk, hd, hdv, causal, window;
  float softcap, scale;
};

enum { Q_ = 0, K_ = 3, V_ = 6, DO_ = 9, DQ_ = 12, DK_ = 15, DV_ = 18 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ bool visible(const BwdArgs& a, int row, int col) {
  return row < a.Sq && col < a.Sk && (!a.causal || row >= col) &&
         (a.window == 0 || row - col < a.window);
}

// ds * scale for one visible element, and its p.
__device__ __forceinline__ float grad_score(const BwdArgs& a, float dot,
                                            float dp, float lse, float delta,
                                            float* p_out) {
  float s = dot * a.scale;
  float dcap = 1.0f;
  if (a.softcap != 0.0f) {
    s = tanhf(s / a.softcap) * a.softcap;
    const float t = s / a.softcap;
    dcap = 1.0f - t * t;
  }
  const float p = expf(s - lse);
  *p_out = p;
  float ds = p * (dp - delta);
  if (a.softcap != 0.0f) ds *= dcap;
  return ds * a.scale;
}

// rows [row0, row0 + rows) of a [S, D] operand (row stride `stride`) into
// shared memory as f32 with row stride `ld`; rows at or past S are zeros.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          long long stride, int row0, int S,
                                          int rows, int D) {
  for (int idx = threadIdx.x; idx < rows * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    dst[r * ld + c] =
        row0 + r < S ? to_f32(src[(long long)(row0 + r) * stride + c]) : 0.0f;
  }
}

// out[i] += A[i] . b over D (a multiple of 4) for the warp's ROWS rows of
// A (row stride lda; the same address in every lane: a broadcast) and the
// lane's own row b.
__device__ __forceinline__ void dots(float* out, const float* A, int lda,
                                     const float* b, int D) {
  for (int d = 0; d < D; d += 4) {
    const float4 bv = *reinterpret_cast<const float4*>(b + d);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const float4 av = *reinterpret_cast<const float4*>(A + i * lda + d);
      out[i] = fmaf(av.x, bv.x, out[i]);
      out[i] = fmaf(av.y, bv.y, out[i]);
      out[i] = fmaf(av.z, bv.z, out[i]);
      out[i] = fmaf(av.w, bv.w, out[i]);
    }
  }
}

// acc[i][c] += sum_j W[i][j] X[j][lane + 32c] over J (a multiple of 4)
// columns of the warp's ROWS rows of W (row stride ldw, broadcast) and
// rows of X (row stride ldx), for c < nc.
template <int MAXC>
__device__ __forceinline__ void accumulate(float (*acc)[MAXC], const float* W,
                                           int ldw, const float* X, int ldx,
                                           int J, int nc, int lane) {
  for (int j = 0; j < J; j += 4) {
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c < nc) {
        const float* x = X + j * ldx + lane + 32 * c;
        const float x0 = x[0], x1 = x[ldx], x2 = x[2 * ldx], x3 = x[3 * ldx];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const float4 w = *reinterpret_cast<const float4*>(W + i * ldw + j);
          float t = acc[i][c];
          t = fmaf(w.x, x0, t);
          t = fmaf(w.y, x1, t);
          t = fmaf(w.z, x2, t);
          t = fmaf(w.w, x3, t);
          acc[i][c] = t;
        }
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ const T* head_ptr(const void* base,
                                             const long long* s, int b,
                                             int h) {
  return static_cast<const T*>(base) + b * s[0] + h * s[1];
}

// ---------------------------------------------------------------------------
// K10: dq
// ---------------------------------------------------------------------------

size_t smem_dq(int hd, int hdv) {
  return ((size_t)(BQ10 + BK10) * (hd + PAD + hdv + PAD) +
          (size_t)BQ10 * (BK10 + PAD)) *
         sizeof(float);
}

template <typename T, int MAXC>
__global__ void __launch_bounds__(NT) flash_bwd_dq(BwdArgs a) {
  extern __shared__ __align__(16) float smem_dq_raw[];
  const int LQ = a.hd + PAD, LV = a.hdv + PAD, LD = BK10 + PAD;
  float* Qs = smem_dq_raw;     // [BQ10][LQ]
  float* Os = Qs + BQ10 * LQ;  // dO, [BQ10][LV]
  float* Ks = Os + BQ10 * LV;  // [BK10][LQ]
  float* Vs = Ks + BK10 * LQ;  // [BK10][LV]
  float* Ds = Vs + BK10 * LV;  // ds * scale, [BQ10][LD]

  const int nqb = (a.Sq + BQ10 - 1) / BQ10;
  const int q0 = (nqb - 1 - (int)blockIdx.x) * BQ10;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const T* q = head_ptr<T>(a.q, a.s + Q_, b, h);
  const T* k = head_ptr<T>(a.k, a.s + K_, b, kvh);
  const T* v = head_ptr<T>(a.v, a.s + V_, b, kvh);
  const T* dout = head_ptr<T>(a.dout, a.s + DO_, b, h);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * ROWS;  // the warp's first row in the block

  load_rows(Qs, LQ, q, a.s[Q_ + 2], q0, a.Sq, BQ10, a.hd);
  load_rows(Os, LV, dout, a.s[DO_ + 2], q0, a.Sq, BQ10, a.hdv);
  float lse[ROWS], delta[ROWS];
  const long long bh = ((long long)b * a.H + h) * a.Sq;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q0 + r0 + i;
    lse[i] = row < a.Sq ? a.lse[bh + row] : 0.0f;
    delta[i] = row < a.Sq ? a.delta[bh + row] : 0.0f;
  }
  float acc[ROWS][MAXC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int c = 0; c < MAXC; ++c) acc[i][c] = 0.0f;

  // the key tiles some row of the block can see
  const int nkt = (a.Sk + BK10 - 1) / BK10;
  const int q_last = min(q0 + BQ10, a.Sq) - 1;
  const int hi = a.causal ? min(nkt - 1, q_last / BK10) : nkt - 1;
  const int lo = a.window > 0 ? max(0, q0 - a.window + 1) / BK10 : 0;
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * BK10;
    __syncthreads();  // every warp is done with the previous tile
    load_rows(Ks, LQ, k, a.s[K_ + 2], k0, a.Sk, BK10, a.hd);
    load_rows(Vs, LV, v, a.s[V_ + 2], k0, a.Sk, BK10, a.hdv);
    __syncthreads();
    float s[ROWS], dp[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) s[i] = dp[i] = 0.0f;
    dots(s, Qs + r0 * LQ, LQ, Ks + lane * LQ, a.hd);
    dots(dp, Os + r0 * LV, LV, Vs + lane * LV, a.hdv);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      float p, ds = 0.0f;
      if (visible(a, q0 + r0 + i, k0 + lane))
        ds = grad_score(a, s[i], dp[i], lse[i], delta[i], &p);
      Ds[(r0 + i) * LD + lane] = ds;
    }
    __syncwarp();  // a warp reads back only its own rows of Ds
    accumulate<MAXC>(acc, Ds + r0 * LD, LD, Ks, LQ, BK10, a.hd / 32, lane);
    __syncwarp();
  }

  T* dq = static_cast<T*>(a.dq) + b * a.s[DQ_] + h * a.s[DQ_ + 1];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q0 + r0 + i;
    if (row >= a.Sq) continue;
#pragma unroll
    for (int c = 0; c < MAXC; ++c)
      if (c < a.hd / 32)
        dq[row * a.s[DQ_ + 2] + lane + 32 * c] = from_f32<T>(acc[i][c]);
  }
}

// ---------------------------------------------------------------------------
// K11: dk, dv
// ---------------------------------------------------------------------------

size_t smem_dkv(int hd, int hdv) {
  return ((size_t)(BK11 + BQ11) * (hd + PAD + hdv + PAD) +
          2 * (size_t)BK11 * (BQ11 + PAD) + 2 * BQ11) *
         sizeof(float);
}

template <typename T, int MAXC>
__global__ void __launch_bounds__(NT) flash_bwd_dkv(BwdArgs a) {
  extern __shared__ __align__(16) float smem_dkv_raw[];
  const int LQ = a.hd + PAD, LV = a.hdv + PAD, LP = BQ11 + PAD;
  float* Ks = smem_dkv_raw;    // [BK11][LQ]
  float* Vs = Ks + BK11 * LQ;  // [BK11][LV]
  float* Qs = Vs + BK11 * LV;  // [BQ11][LQ]
  float* Os = Qs + BQ11 * LQ;  // dO, [BQ11][LV]
  float* Ps = Os + BQ11 * LV;  // p^T, [BK11][LP]
  float* Ds = Ps + BK11 * LP;  // ds^T * scale, [BK11][LP]
  float* Ls = Ds + BK11 * LP;  // lse of the tile's rows, [BQ11]
  float* Dl = Ls + BQ11;       // delta of the tile's rows, [BQ11]

  const int k0 = blockIdx.x * BK11;  // causal: the first keys see most rows
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const T* q = head_ptr<T>(a.q, a.s + Q_, b, h);
  const T* k = head_ptr<T>(a.k, a.s + K_, b, kvh);
  const T* v = head_ptr<T>(a.v, a.s + V_, b, kvh);
  const T* dout = head_ptr<T>(a.dout, a.s + DO_, b, h);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * ROWS;  // the warp's first key in the block
  const long long bh = ((long long)b * a.H + h) * a.Sq;

  load_rows(Ks, LQ, k, a.s[K_ + 2], k0, a.Sk, BK11, a.hd);
  load_rows(Vs, LV, v, a.s[V_ + 2], k0, a.Sk, BK11, a.hdv);
  float dk[ROWS][MAXC], dv[ROWS][MAXC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int c = 0; c < MAXC; ++c) dk[i][c] = dv[i][c] = 0.0f;

  // the query tiles some key of the block is visible to
  const int nqt = (a.Sq + BQ11 - 1) / BQ11;
  const int k_last = min(k0 + BK11, a.Sk) - 1;
  const int lo = a.causal ? min(nqt, k0 / BQ11) : 0;
  const int hi = a.window > 0
                     ? min(nqt - 1, (k_last + a.window - 1) / BQ11)
                     : nqt - 1;
  for (int qt = lo; qt <= hi; ++qt) {
    const int q0 = qt * BQ11;
    __syncthreads();  // every warp is done with the previous tile
    load_rows(Qs, LQ, q, a.s[Q_ + 2], q0, a.Sq, BQ11, a.hd);
    load_rows(Os, LV, dout, a.s[DO_ + 2], q0, a.Sq, BQ11, a.hdv);
    if (threadIdx.x < BQ11) {
      const int row = q0 + threadIdx.x;
      Ls[threadIdx.x] = row < a.Sq ? a.lse[bh + row] : 0.0f;
      Dl[threadIdx.x] = row < a.Sq ? a.delta[bh + row] : 0.0f;
    }
    __syncthreads();
    float s[ROWS], dp[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) s[i] = dp[i] = 0.0f;
    dots(s, Ks + r0 * LQ, LQ, Qs + lane * LQ, a.hd);    // s^T: keys x rows
    dots(dp, Vs + r0 * LV, LV, Os + lane * LV, a.hdv);  // dp^T
    const float lse = Ls[lane], delta = Dl[lane];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      float p = 0.0f, ds = 0.0f;
      if (visible(a, q0 + lane, k0 + r0 + i))
        ds = grad_score(a, s[i], dp[i], lse, delta, &p);
      Ps[(r0 + i) * LP + lane] = p;
      Ds[(r0 + i) * LP + lane] = ds;
    }
    __syncwarp();  // a warp reads back only its own rows of Ps and Ds
    accumulate<MAXC>(dv, Ps + r0 * LP, LP, Os, LV, BQ11, a.hdv / 32, lane);
    accumulate<MAXC>(dk, Ds + r0 * LP, LP, Qs, LQ, BQ11, a.hd / 32, lane);
    __syncwarp();
  }

  T* gk = static_cast<T*>(a.dk) + b * a.s[DK_] + h * a.s[DK_ + 1];
  T* gv = static_cast<T*>(a.dv) + b * a.s[DV_] + h * a.s[DV_ + 1];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int key = k0 + r0 + i;
    if (key >= a.Sk) continue;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c < a.hd / 32)
        gk[key * a.s[DK_ + 2] + lane + 32 * c] = from_f32<T>(dk[i][c]);
      if (c < a.hdv / 32)
        gv[key * a.s[DV_ + 2] + lane + 32 * c] = from_f32<T>(dv[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kern>
cudaError_t launch(Kern kern, size_t smem, dim3 grid, const BwdArgs& a,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

// which 0: dq; 1: dk and dv
template <typename T>
cudaError_t launch_typed(const BwdArgs& a, int which, cudaStream_t stream) {
  const bool wide = a.hd > 128 || a.hdv > 128;
  if (which == 0) {
    dim3 grid((a.Sq + BQ10 - 1) / BQ10, a.H, a.B);
    const size_t smem = smem_dq(a.hd, a.hdv);
    return wide ? launch(flash_bwd_dq<T, 8>, smem, grid, a, stream)
                : launch(flash_bwd_dq<T, 4>, smem, grid, a, stream);
  }
  dim3 grid((a.Sk + BK11 - 1) / BK11, a.H, a.B);
  const size_t smem = smem_dkv(a.hd, a.hdv);
  return wide ? launch(flash_bwd_dkv<T, 8>, smem, grid, a, stream)
              : launch(flash_bwd_dkv<T, 4>, smem, grid, a, stream);
}

bool head_dim_ok(int d) { return d % 32 == 0 && d >= 32 && d <= 256; }

}  // namespace

extern "C" {

// q [B,H,Sq,hd], k [B,KV,Sk,hd], v [B,KV,Sk,hd_v], do [B,H,Sq,hd_v],
// dq [B,H,Sq,hd], dk [B,H,Sk,hd] and dv [B,H,Sk,hd_v] (per query head),
// given by their element strides over (batch, head, seq) in `strides` (q,
// k, v, do, dq, dk, dv in turn; the last dim contiguous); lse and delta
// [B,H,Sq] f32, contiguous.  which 0 launches K10 (writes dq), 1 launches
// K11 (writes dk and dv).  dtype 0: bf16 operands and outputs; 1: f32.
// Returns a cudaError_t.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, void* dq, void* dk,
                               void* dv, int which, int dtype, int B, int H,
                               int KV, int Sq, int Sk, int hd, int hd_v,
                               const long long* strides, int causal,
                               int window, float softcap, float scale,
                               cudaStream_t stream) {
  if (KV < 1 || H % KV != 0 || window < 0 || !head_dim_ok(hd) ||
      !head_dim_ok(hd_v) || (which != 0 && which != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || Sq == 0 || Sk == 0) return (int)cudaSuccess;
  BwdArgs a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  a.dq = dq; a.dk = dk; a.dv = dv;
  for (int i = 0; i < 21; ++i) a.s[i] = strides[i];
  a.B = B; a.H = H; a.KV = KV; a.Sq = Sq; a.Sk = Sk; a.hd = hd;
  a.hdv = hd_v; a.causal = causal; a.window = window;
  a.softcap = softcap; a.scale = scale;
  if (dtype == 0) return (int)launch_typed<bf16>(a, which, stream);
  if (dtype == 1) return (int)launch_typed<float>(a, which, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
