// Helpers shared by the int8 kernels: cp.async copies, a wait on a
// run-time number of outstanding copy groups, and the requant epilogue.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace h2pipe {

// 4-byte global -> shared copy; when !valid nothing is read and the
// destination word is zero-filled (src-size 0).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int src_bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

// 8- and 16-byte copies, zero-filled in the same way when !valid.  Both
// addresses must be aligned to the copy's size.
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem,
                                          bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int src_bytes = valid ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most n committed groups are still in flight.  A larger n
// than 7 waits for "at most 7", which is stricter and therefore safe.
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::); break;
  }
}

// The requant epilogue of kernels/quant.py, rounded as the JAX reference
// rounds it: f32 scale product, one fused multiply-add, relu, a multiply by
// inv_act = f32(1)/f32(act_scale) (XLA's rewrite of the divide by a
// constant), round half to even, clip to +-127.  Returns the pre-quant
// f32 value.
__device__ __forceinline__ float requant(int acc, float w_scale, float bias,
                                         float act_scale, float inv_act,
                                         bool relu, int8_t* q) {
  float scale = __fmul_rn(w_scale, act_scale);
  float y = __fmaf_rn(__int2float_rn(acc), scale, bias);
  if (relu) y = fmaxf(y, 0.0f);
  float r = rintf(__fmul_rn(y, inv_act));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  *q = static_cast<int8_t>(static_cast<int>(r));
  return y;
}

inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

}  // namespace h2pipe
