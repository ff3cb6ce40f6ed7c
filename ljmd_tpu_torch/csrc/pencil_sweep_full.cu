// Kernel 11: the full 9-neighbour pencil sweep, with and without the
// observables (the cell-pair engine's half_shell=False mode).
//
// Replaces: ljmd_tpu/ops/pallas_pencil.py:309 `pallas_pencil_sweep` (its
// Pallas body `_pencil_kernel`, :73). Contract: `pos` is the (8, ns) slot
// matrix (x/y/z in rows 0..2, the validity in row 3); tbl (n_pencils * 9) is
// the xy-neighbour table with the pencil itself at k = 4, shf (n_pencils * 18)
// the static xy image shifts in units of L, counts the per-pencil
// populations. Each slot sums, over its pencil and its 8 xy-neighbours, the
// pairs with r^2 < rc^2, gi != gj and v_i * v_j > 0.5 (the partners' x / y
// shifted, only z taking the round): rows 0..2 the force without the 24
// prefactor, rows 3..5 (want_obs) e / du / ddu, each pair counted twice
// (prefactors 2 / 12). Invalid slots come out exactly 0 from the mask, with
// no multiply by the validity row afterwards; rows 6, 7 and the 128-slot
// i-slices at or past a pencil's count stay as the wrapper zeroed them (the
// TPU kernel skips those slices too).
//
// What bounds it on the H100: the candidate arithmetic, the live slots of 9
// pencils a valid slot, ~1.2% of them inside the cutoff at config 5. The
// earlier port ran 32-slot blocks (four staged the same partners), swept
// each partner pencil at full capacity, staged synchronously and paid the
// LJ algebra (an IEEE divide) on every candidate.
//
// What the design does about that (kernel 12's, pencil_sweep_zband.cu):
// - One block is one 128-slot i-slice, 128 x 4 threads, thread (slot,
//   slice) taking partners slice, slice + 4, ... of each stage. Blocks are
//   ordered block-major (the first 128-slot slice of every pencil, then the
//   second, ...), so the live slices, at the front, spread over the SMs; a
//   slice at or past its pencil's count returns.
// - An exact stage plan, built once a block in static shared memory: for
//   each neighbour k = 0..8, the 128-rank stages of the partner pencil whose
//   first rank is below its count. Slots are packed rank-first, so a stage
//   past the count holds only invalid slots, which the validity test masks
//   (ops/pencil_sweep.py `full_stage_plan` is the same rule as plain torch).
// - Stages are copied with cp.async into a ring of three buffers as plain
//   rows (x, y, z, validity), one __syncthreads() a stage; the image shift is
//   added when a candidate is formed.
// - The culled loop (pencil_cull.cuh `cull_stage_full`): displacement, z
//   round and r^2 for every candidate, the LJ algebra and the observables
//   only where a lane of the warp holds the mask. Each stage takes its form
//   (`FullForm`, block-uniform): the gi != gj test only on the slot's own
//   pencil, the x / y shift only where the neighbour's is not zero.
// - The earlier port's partner order (each slot: k = 0..8, stages in rank
//   order, partners slice, slice + 4, ...) and its fixed-order sum of the 4
//   partial sums are kept, so the output is its bit for bit: a skipped stage
//   or a culled pair added an exact +-0 to a sum that starts at +0. No
//   atomics: deterministic.
#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "pencil_cull.cuh"
#include "pencil_pairs.cuh"

namespace ljmd {

constexpr int kFullSlices = 4;   // threads a slot
constexpr int kFullRing = 3;     // staging buffers
constexpr int kFullMaxSub = 16;  // 128-slot stages a pencil (capacity <= 2048)

template <typename T, bool OBS>
__global__ void __launch_bounds__(kPenGran * kFullSlices)
pencil_sweep_full_kernel(const T* __restrict__ pos, T* __restrict__ out,
                         const int* __restrict__ tbl, const int* __restrict__ counts,
                         const int* __restrict__ shf, int n_pencils, int cap, T box, T inv_box,
                         T rc2) {
  constexpr int kRows = 4;  // x, y, z, validity
  constexpr int kThreads = kPenGran * kFullSlices;
  constexpr int kOut = OBS ? 6 : 3;
  __shared__ __align__(16) T stage[kFullRing][kRows][kPenGran];
  __shared__ T red[kFullSlices][kOut][kPenGran];
  __shared__ int nb_j[9], nb_live[9], nb_shx[9], nb_shy[9];
  __shared__ int st_q0[9 * kFullMaxSub];
  __shared__ unsigned char st_k[9 * kFullMaxSub];
  __shared__ int n_st;
  const int n_sub = cap / kPenGran;
  // Block-major: block i is 128-slot slice i / n_pencils of pencil i % n_pencils.
  const int q = blockIdx.x % n_pencils;
  const int b = blockIdx.x / n_pencils;
  if (b * kPenGran >= counts[q]) return;  // nothing valid here (block-uniform)
  const size_t ns = static_cast<size_t>(n_pencils) * cap;
  const int tx = threadIdx.x;
  const int tid = threadIdx.y * kPenGran + tx;

  // The block's stage plan: per neighbour k its partner pencil, image shift
  // and live stages (those whose first rank is below the partner's count).
  if (tid < 9) {
    const int e = q * 9 + tid;
    const int j = tbl[e];
    nb_j[tid] = j;
    nb_live[tid] = min(n_sub, (counts[j] + kPenGran - 1) / kPenGran);
    nb_shx[tid] = shf[2 * e];
    nb_shy[tid] = shf[2 * e + 1];
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int k = 0; k < 9; ++k) {
      for (int c = 0; c < nb_live[k]; ++c) {
        st_q0[n] = nb_j[k] * cap + c * kPenGran;
        st_k[n] = static_cast<unsigned char>(k);
        ++n;
      }
    }
    n_st = n;
  }
  __syncthreads();

  const int g = q * cap + b * kPenGran + tx;
  const T xi = pos[g], yi = pos[ns + g], zi = pos[2 * ns + g], vi = pos[3 * ns + g];
  PenAcc<T> acc = {T(0), T(0), T(0), T(0), T(0), T(0)};
  const int n = n_st;  // >= 1: the pencil itself (k = 4) is live
  stage_rows(&stage[0][0][0], kPenGran, pos, pos + 3 * ns, ns, kRows,
             static_cast<size_t>(st_q0[0]), kPenGran, tid, kThreads);
  cp_async_commit();
  for (int c = 0; c < n; ++c) {
    if (c + 1 < n) {
      stage_rows(&stage[(c + 1) % kFullRing][0][0], kPenGran, pos, pos + 3 * ns, ns, kRows,
                 static_cast<size_t>(st_q0[c + 1]), kPenGran, tid, kThreads);
      cp_async_commit();
      cp_async_wait(1);
    } else {
      cp_async_wait(0);
    }
    // Stage c has landed for every thread; the buffer stage c + 1 is copied
    // into was last read at stage c - 2, before the previous barrier.
    __syncthreads();
    const T(*sb)[kPenGran] = stage[c % kFullRing];
    const int k = st_k[c];
    const T offx = mul_rn(static_cast<T>(nb_shx[k]), box);
    const T offy = mul_rn(static_cast<T>(nb_shy[k]), box);
    // Block-uniform: the stage's form (pencil_cull.cuh FullForm).
    if (nb_j[k] == q) {
      cull_stage_full<T, OBS, kFullSlices, kFullOwn>(sb[0], sb[1], sb[2], sb[3], g, xi, yi, zi,
                                                     vi, st_q0[c], offx, offy, box, inv_box, rc2,
                                                     acc);
    } else if (nb_shx[k] != 0 || nb_shy[k] != 0) {
      cull_stage_full<T, OBS, kFullSlices, kFullShifted>(sb[0], sb[1], sb[2], sb[3], g, xi, yi,
                                                         zi, vi, st_q0[c], offx, offy, box,
                                                         inv_box, rc2, acc);
    } else {
      cull_stage_full<T, OBS, kFullSlices, kFullUnshifted>(sb[0], sb[1], sb[2], sb[3], g, xi, yi,
                                                           zi, vi, st_q0[c], offx, offy, box,
                                                           inv_box, rc2, acc);
    }
  }

  const T parts[6] = {acc.fx, acc.fy, acc.fz, acc.e, acc.du, acc.ddu};
#pragma unroll
  for (int c = 0; c < kOut; ++c) red[threadIdx.y][c][tx] = parts[c];
  __syncthreads();
  if (threadIdx.y == 0) {
#pragma unroll
    for (int c = 0; c < kOut; ++c) {
      T f = red[0][c][tx];
#pragma unroll
      for (int s = 1; s < kFullSlices; ++s) f = add_rn(f, red[s][c][tx]);
      out[c * ns + g] = f;
    }
  }
}

template <typename T, bool OBS>
int full_occupancy(int* out) {
  const void* fn = reinterpret_cast<const void*>(pencil_sweep_full_kernel<T, OBS>);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kPenGran * kFullSlices, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = per_sm;
  out[1] = sms;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

template <typename T>
int launch_sweep_full(const T* pos, T* out, const int* tbl, const int* counts, const int* shf,
                      int n_pencils, int cap, T box, T inv_box, T rc2, int want_obs,
                      void* stream) {
  if (cap % kPenGran != 0 || cap / kPenGran > kFullMaxSub) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(kPenGran, kFullSlices);
  const dim3 grid(n_pencils * (cap / kPenGran));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (want_obs) {
    pencil_sweep_full_kernel<T, true><<<grid, block, 0, s>>>(pos, out, tbl, counts, shf,
                                                             n_pencils, cap, box, inv_box, rc2);
  } else {
    pencil_sweep_full_kernel<T, false><<<grid, block, 0, s>>>(pos, out, tbl, counts, shf,
                                                              n_pencils, cap, box, inv_box, rc2);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ljmd

extern "C" {

// Launch shape of kernel 11: out[0..3] = resident blocks an SM, SMs,
// registers a thread, local (spill) bytes a thread.
int ljmd_full_occupancy(int dtype_bytes, int want_obs, int* out) {
  using ljmd::full_occupancy;
  if (dtype_bytes == 4) {
    return want_obs ? full_occupancy<float, true>(out) : full_occupancy<float, false>(out);
  }
  return want_obs ? full_occupancy<double, true>(out) : full_occupancy<double, false>(out);
}

// The block threads and the largest capacity / 128 the kernel takes.
int ljmd_full_block_threads() { return ljmd::kPenGran * ljmd::kFullSlices; }
int ljmd_full_max_sub() { return ljmd::kFullMaxSub; }

int ljmd_pencil_sweep_full_f32(const float* pos, float* out, const int* tbl, const int* counts,
                               const int* shf, int n_pencils, int cap, float box, float inv_box,
                               float rc2, int want_obs, void* stream) {
  return ljmd::launch_sweep_full<float>(pos, out, tbl, counts, shf, n_pencils, cap, box,
                                        inv_box, rc2, want_obs, stream);
}

int ljmd_pencil_sweep_full_f64(const double* pos, double* out, const int* tbl,
                               const int* counts, const int* shf, int n_pencils, int cap,
                               double box, double inv_box, double rc2, int want_obs,
                               void* stream) {
  return ljmd::launch_sweep_full<double>(pos, out, tbl, counts, shf, n_pencils, cap, box,
                                         inv_box, rc2, want_obs, stream);
}

}  // extern "C"
