// cp.async helpers shared by the chunk kernels that stage partner positions
// in shared memory while they compute (fused_dense_chunk.cu,
// fused_pencil_width_chunk.cu).
//
// cp.async.cg copies 16 bytes from global to shared memory through L2 only
// (never L1), so a copy made after a grid barrier sees what other blocks
// wrote before it. Copies are per thread: a thread waits for its own groups
// (cp_async_wait), then a __syncthreads() makes every thread's landed copies
// visible to the block.
#pragma once

#include <cuda_runtime.h>

namespace ljmd {

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's newest groups are in flight
// (the immediate operand of cp.async.wait_group is a constant, so larger
// counts wait for more than they must: still correct).
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// Copy rows k < `rows` of columns [col0, col0 + cols) to dst + k * ld_dst:
// rows 0..2 from hi + k * ld_src, rows 3..5 from lo + (k - 3) * ld_src
// (cols * sizeof(T) a multiple of 16, every row start 16-byte aligned), the
// block's threads taking the 16-byte pieces in turn. Does not commit.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld_dst, const T* hi, const T* lo,
                                           size_t ld_src, int rows, size_t col0, int cols,
                                           int tid, int n_threads) {
  constexpr int kPer = 16 / sizeof(T);
  const int per_row = cols / kPer;
  for (int u = tid; u < rows * per_row; u += n_threads) {
    const int k = u / per_row;
    const int e = (u - k * per_row) * kPer;
    const T* src = k < 3 ? hi + k * ld_src : lo + (k - 3) * ld_src;
    cp_async16(dst + k * ld_dst + e, src + col0 + e);
  }
}

}  // namespace ljmd
