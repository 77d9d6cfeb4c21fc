// Tensor-core helpers shared by the flash-attention kernels (K9 in
// flash_attention.cu, K10/K11 in flash_attention_bwd.cu) and the float
// matmul's tensor-core instances (mm_float_tc in stream_matmul.cu):
// cp.async tile copies into padded shared-memory rows, ldmatrix fragment
// loads of any 16-bit (or, as pairs, 8-bit) data, mma.sync m16n8k16 with
// bf16 or f16 operands and m16n8k8 with tf32 operands, f32 sums, and the
// head-dim widths the attention kernels are built at.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace h2pipe_mma {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; when !valid nothing is read and the
// destination is zero-filled (src-size 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Four 8x8 b16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i.  Register i holds, in each lane, row lane/4 and
// columns 2(lane%4), +1 of matrix i (with .trans: rows 2(lane%4), +1 of
// column lane/4) — the mma.sync fragment layouts.
// The _at forms take the row's shared-memory address.
__device__ __forceinline__ void ldsm_x4_at(uint32_t* r, unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans_at(uint32_t* r,
                                                 unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  ldsm_x4_at(r, smem_addr(p));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  ldsm_x4_trans_at(r, smem_addr(p));
}

// c[16x8] += a[16x16] (row-major) . b[16x8] (column-major), f32 sums.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The same with f16 operands.
__device__ __forceinline__ void mma_f16(float* c, const uint32_t* a,
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[16x8] += a[16x8] . b[8x8], tf32 operands (f32 bit patterns; an operand
// whose low 13 bits are zero is taken exactly), f32 sums.  Register a0
// holds row lane/4, column lane%4; a1 row +8; a2 column +4; a3 both; b0
// row lane%4, column lane/4; b1 row +4.
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Start copying rows [row0, row0 + rows) of a [S, cols] operand (row
// stride `stride`) into D columns of shared memory with row stride `ld`,
// NT threads sharing the work; rows at or past S and columns at or past
// `cols` (a multiple of 8, at most D: a head dim padded to the kernel's
// width) arrive as zeros, and nothing past a row's `cols` is read.
template <int D, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          long long stride, int row0, int S,
                                          int rows, int cols) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < rows * CH; idx += NT) {
    const int r = idx / CH, c = idx % CH;
    const bool valid = row0 + r < S && 8 * c < cols;
    cp_async16(dst + r * ld + c * 8,
               valid ? src + (row0 + r) * stride + c * 8 : src, valid);
  }
}

// The widths (hd, hd_v) the bf16 kernels of both files are built at
// (ops.KERNEL_HD, KERNEL_HD_V): a head dim runs at the narrowest that
// holds it (width()), its columns past hd (hd_v) zero in shared memory
// (load_tile) and never written.
constexpr int WIDTHS_HD[] = {32, 64, 128, 192, 256};
constexpr int WIDTHS_HDV[] = {32, 64, 128, 256};

template <int N>
inline int width(int d, const int (&widths)[N]) {
  for (int w : widths)
    if (d <= w) return w;
  return 0;
}

// the head dims the kernels take: every multiple of 8 from 8 to 256
inline bool head_dim_ok(int d) { return d % 8 == 0 && d >= 8 && d <= 256; }

}  // namespace h2pipe_mma
