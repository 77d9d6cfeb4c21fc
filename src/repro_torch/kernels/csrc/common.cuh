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

// mbarriers in shared memory: init with an arrival count, arrive (release),
// wait for a phase by parity (acquire), and an arrival that fires when
// this thread's earlier cp.asyncs have landed (counted in the init count:
// .noinc).  A ring's producer waits on a slot's empty barrier with parity
// phase ^ 1, so that the first pass over a fresh barrier does not block.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::
          "r"(smem_addr(bar))
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
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(smem_addr(bar))
               : "memory");
}

// Arrive on `bar` and add `bytes` to the transaction count its phase
// waits for (the bulk copies below complete it).
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// A bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from global to this CTA's shared memory by the copy engine,
// completing `bytes` of the transaction count of `bar`.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              unsigned bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A ring position: slot and the parity of its current phase.
struct RingPos {
  int slot = 0, phase = 0;
  __device__ __forceinline__ void next(int slots) {
    if (++slot == slots) {
      slot = 0;
      phase ^= 1;
    }
  }
};

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
