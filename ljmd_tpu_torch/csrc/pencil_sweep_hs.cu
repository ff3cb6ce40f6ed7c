// Kernels 13 and 14: the half-shell pencil sweep, with and without the
// observables.
//
// Replaces: ljmd_tpu/ops/pallas_pencil2.py:187 `pallas_pencil_sweep_hs` (its
// Pallas body `_pencil_hs_kernel`, :78) and :394 `pallas_pencil_sweep_mono`
// (`_pencil_mono_kernel`, :295). The two compute one function (the mono form
// is the TPU's single-program VMEM variant, the x-strip plan a VMEM budget), so
// on Hopper they are one kernel. Contract: `pos` is the (8, ns) slot matrix
// with sentinels in empty slots and the validity in row 3; tbl / counts / shf
// are the half-shell tables and the per-pencil counts. Output rows 0..2: the
// force of each slot without the 24 prefactor; rows 3..5 (want_obs): the
// e/du/ddu partials of the pairs of which the slot is the i side (the TPU
// kernel's pair set: its own pencil's slots above it and its 4 upper
// neighbours); every row multiplied by the validity row here (the TPU kernel
// leaves that multiply to its caller). Output rows 6, 7 and the 128-slot
// blocks at or past a pencil's count stay as the wrapper zeroed them.
//
// The mono kernel's `n_pencils_i` (a strip of a sharded run plus one halo
// column, ljmd_tpu/parallel/spatial_pencil.py) is part of the contract: the
// slot matrix holds n_pencils pencils, the tables hold rows for the first
// n_pencils_i of them (the i pencils, whose partners may be any pencil), and
// `counts` covers all n_pencils (the halo's counts travel with the halo). A
// pencil past n_pencils_i has no self or forward pairs: its blocks sum only
// the reactions of the i pencils whose upper neighbour it is. Without a strip
// n_pencils_i == n_pencils and nothing changes.
//
// What bounds it on the H100: the candidate arithmetic. Pair-twice, a valid
// slot meets the live slots of 9 pencils (its own, 4 forward, 4 backward),
// ~1.6% of them inside the cutoff at config 5; the bound counts 13
// operations a candidate and 17 (27 with the observables) a pair inside. The
// earlier port ran 32-slot blocks (four staged the same partners of a
// 128-slot granule), staged each 128-partner stage synchronously with two
// barriers, swept every partner pencil at full capacity, rescanned the whole
// table in every block for its backward pencils, and paid the LJ algebra (an
// IEEE divide and the r^-6 products) on every candidate.
//
// What the design does about that (the building blocks of kernel 15,
// fused_pencil_chunk.cu, for one step):
// - A block is one 128-slot block of a pencil (a work item), 128 x S
//   threads (S = 4: two 512-thread blocks an SM; one 1024-thread block at
//   S = 8 ran 5-12% slower on the H100), thread (slot, slice) taking
//   partners slice, slice + S, ... of each stage, so each staged stage
//   serves 128 slots. Blocks are ordered
//   block-major (the first 128-slot block of every pencil, then the
//   second, ...), so the live items, at the front, spread over the SMs. An
//   item whose first rank is at or past its pencil's count returns at once.
// - Backward pencils come from `lower`, the inverse table the wrapper builds
//   once per table (ops/fused_pencil.py half_shell_lower, over all n_pencils
//   for a strip); no block scans the table.
// - Exact stage skips: slots are packed rank-first, so a partner stage whose
//   first rank is at or past counts[j] holds only sentinels, which no valid
//   slot reaches: it is not swept (ops/pencil_sweep.py `hs_stage_plan` is the
//   same rule as plain torch).
// - Stages are copied with cp.async into a ring of three buffers, stage
//   c + 1 in flight while stage c is computed, one __syncthreads() a stage.
// - The culled loop (pencil_cull.cuh): displacement, z round and r^2 for
//   every candidate, the LJ algebra and the observables only where a lane
//   of the warp holds the mask.
// - The partner order of the earlier port (own pencil, forward k = 0..3,
//   backward k = 0..3, stages in rank order, partners slice, slice + S, ...)
//   and its fixed-order sum of the 4 partial sums are kept: the output is
//   the earlier port's bit for bit (a skipped stage or a culled
//   pair added an exact +-0 to a sum that starts at +0). Pair-twice with no
//   atomics: deterministic.
#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "pencil_cull.cuh"
#include "pencil_pairs.cuh"

namespace ljmd {

constexpr int kSwSlices = 4;   // threads a slot (an S = 8 build was slower: PERF.md)
constexpr int kSwRing = 3;     // staging buffers
constexpr int kSwSegs = 9;     // own pencil, 4 forward, 4 backward
constexpr int kSwMaxSub = 16;  // 128-slot stages a pencil (capacity <= 2048)

template <typename T, bool OBS, int S>
__global__ void __launch_bounds__(kPenGran * S)
pencil_sweep_hs_kernel(const T* __restrict__ pos, T* __restrict__ out, const int* __restrict__ tbl,
                       const int* __restrict__ counts, const int* __restrict__ shf,
                       const int* __restrict__ lower, int n_pencils_i, int n_pencils, int cap,
                       T box, T inv_box, T rc2) {
  constexpr int kRows = 3;  // x, y, z
  constexpr int kThreads = kPenGran * S;
  __shared__ __align__(16) T stage[kSwRing][kRows][kPenGran];
  __shared__ T red[S][3][kPenGran];
  __shared__ int seg_pencil[kSwSegs], seg_live[kSwSegs], seg_shx[kSwSegs], seg_shy[kSwSegs];
  __shared__ int st_q0[kSwSegs * kSwMaxSub];
  __shared__ unsigned char st_seg[kSwSegs * kSwMaxSub];
  __shared__ int n_st;
  const int n_sub = cap / kPenGran;
  // Block-major: block i is 128-slot block i / n_pencils of pencil i % n_pencils.
  const int q = blockIdx.x % n_pencils;
  const int b = blockIdx.x / n_pencils;
  if (b * kPenGran >= counts[q]) return;  // nothing valid here (block-uniform)
  const size_t ns = static_cast<size_t>(n_pencils) * cap;
  const int tx = threadIdx.x;
  const int tid = threadIdx.y * kPenGran + tx;

  // The item's stage plan: per segment its partner pencil, image shift and
  // live stages (those whose first rank is below the partner's count).
  if (tid < kSwSegs) {
    int j = -1, sx = 0, sy = 0;
    if (tid == 0) {
      if (q < n_pencils_i) j = q;
    } else if (tid <= 4) {
      if (q < n_pencils_i) {
        const int e = q * 4 + tid - 1;
        j = tbl[e];
        sx = shf[2 * e];
        sy = shf[2 * e + 1];
      }
    } else {
      const int k = tid - 5;
      j = lower[q * 4 + k];
      if (j >= 0) {
        sx = shf[2 * (j * 4 + k)];
        sy = shf[2 * (j * 4 + k) + 1];
      }
    }
    seg_pencil[tid] = j;
    seg_live[tid] = j >= 0 ? min(n_sub, (counts[j] + kPenGran - 1) / kPenGran) : 0;
    seg_shx[tid] = sx;
    seg_shy[tid] = sy;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int s = 0; s < kSwSegs; ++s) {
      for (int c = 0; c < seg_live[s]; ++c) {
        st_q0[n] = seg_pencil[s] * cap + c * kPenGran;
        st_seg[n] = static_cast<unsigned char>(s);
        ++n;
      }
    }
    n_st = n;
  }
  __syncthreads();

  const int g = q * cap + b * kPenGran + tx;
  const PenSlot<T> me{g, pos[g], pos[ns + g], pos[2 * ns + g], T(0), T(0), T(0)};
  PenAcc<T> acc = {T(0), T(0), T(0), T(0), T(0), T(0)};
  const int n = n_st;  // 0 only for a halo pencil that no live i pencil reaches
  if (n > 0) {
    stage_rows(&stage[0][0][0], kPenGran, pos, pos, ns, kRows, static_cast<size_t>(st_q0[0]),
               kPenGran, tid, kThreads);
    cp_async_commit();
  }
  for (int c = 0; c < n; ++c) {
    if (c + 1 < n) {
      stage_rows(&stage[(c + 1) % kSwRing][0][0], kPenGran, pos, pos, ns, kRows,
                 static_cast<size_t>(st_q0[c + 1]), kPenGran, tid, kThreads);
      cp_async_commit();
      cp_async_wait(1);
    } else {
      cp_async_wait(0);
    }
    // Stage c has landed for every thread; the buffer stage c + 1 is copied
    // into was last read at stage c - 2, before the previous barrier.
    __syncthreads();
    const T(*sb)[kPenGran] = stage[c % kSwRing];
    const int sg = st_seg[c];
    const int q0 = st_q0[c];
    const T offx = mul_rn(static_cast<T>(seg_shx[sg]), box);
    const T offy = mul_rn(static_cast<T>(seg_shy[sg]), box);
    if (sg == 0) {
      cull_stage_hs<T, false, OBS, kHsSelf, S>(sb[0], sb[1], sb[2], nullptr, nullptr, nullptr,
                                               me, q0, offx, offy, box, inv_box, rc2, acc);
    } else if (sg <= 4) {
      cull_stage_hs<T, false, OBS, kHsForward, S>(sb[0], sb[1], sb[2], nullptr, nullptr,
                                                  nullptr, me, q0, offx, offy, box, inv_box,
                                                  rc2, acc);
    } else {
      cull_stage_hs<T, false, false, kHsBackward, S>(sb[0], sb[1], sb[2], nullptr, nullptr,
                                                     nullptr, me, q0, offx, offy, box, inv_box,
                                                     rc2, acc);
    }
  }

  // The S partial sums of each slot in a fixed order (rows 0..2, then the
  // observables through the same buffer), times the validity.
  const T valid = pos[3 * ns + g];
  const T parts[6] = {acc.fx, acc.fy, acc.fz, acc.e, acc.du, acc.ddu};
#pragma unroll
  for (int half = 0; half < (OBS ? 2 : 1); ++half) {
    if (half) __syncthreads();  // the first half's sums have been read
#pragma unroll
    for (int c = 0; c < 3; ++c) red[threadIdx.y][c][tx] = parts[3 * half + c];
    __syncthreads();
    if (threadIdx.y == 0) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        T f = red[0][c][tx];
#pragma unroll
        for (int s = 1; s < S; ++s) f = add_rn(f, red[s][c][tx]);
        out[(3 * half + c) * ns + g] = mul_rn(f, valid);
      }
    }
  }
}

template <typename T, bool OBS>
int sweep_hs_occupancy(int* out) {
  const void* fn = reinterpret_cast<const void*>(pencil_sweep_hs_kernel<T, OBS, kSwSlices>);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kPenGran * kSwSlices, 0);
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
int launch_sweep(const T* pos, T* out, const int* tbl, const int* counts, const int* shf,
                 const int* lower, int n_pencils_i, int n_pencils, int cap, T box, T inv_box,
                 T rc2, int want_obs, void* stream) {
  if (cap % kPenGran != 0 || cap / kPenGran > kSwMaxSub) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(kPenGran, kSwSlices);
  const dim3 grid(n_pencils * (cap / kPenGran));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (want_obs) {
    pencil_sweep_hs_kernel<T, true, kSwSlices><<<grid, block, 0, s>>>(
        pos, out, tbl, counts, shf, lower, n_pencils_i, n_pencils, cap, box, inv_box, rc2);
  } else {
    pencil_sweep_hs_kernel<T, false, kSwSlices><<<grid, block, 0, s>>>(
        pos, out, tbl, counts, shf, lower, n_pencils_i, n_pencils, cap, box, inv_box, rc2);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ljmd

extern "C" {

// Launch shape of the sweep: out[0..3] = resident blocks an SM, SMs,
// registers a thread, local (spill) bytes a thread.
int ljmd_sweep_hs_occupancy(int dtype_bytes, int want_obs, int* out) {
  using ljmd::sweep_hs_occupancy;
  if (dtype_bytes == 4) {
    return want_obs ? sweep_hs_occupancy<float, true>(out) : sweep_hs_occupancy<float, false>(out);
  }
  return want_obs ? sweep_hs_occupancy<double, true>(out) : sweep_hs_occupancy<double, false>(out);
}

// Threads a slot, and the largest capacity / 128 the kernel takes.
int ljmd_sweep_hs_slices() { return ljmd::kSwSlices; }
int ljmd_sweep_hs_max_sub() { return ljmd::kSwMaxSub; }

// `lower`: ops/pencil_sweep.py half_shell_lower of `tbl` over n_pencils
// pencils ((n_pencils * 4,), -1 where no i pencil's upper neighbour is).
int ljmd_pencil_sweep_hs_f32(const float* pos, float* out, const int* tbl, const int* counts,
                             const int* shf, const int* lower, int n_pencils_i, int n_pencils,
                             int cap, float box, float inv_box, float rc2, int want_obs,
                             void* stream) {
  return ljmd::launch_sweep<float>(pos, out, tbl, counts, shf, lower, n_pencils_i, n_pencils,
                                   cap, box, inv_box, rc2, want_obs, stream);
}

int ljmd_pencil_sweep_hs_f64(const double* pos, double* out, const int* tbl, const int* counts,
                             const int* shf, const int* lower, int n_pencils_i, int n_pencils,
                             int cap, double box, double inv_box, double rc2, int want_obs,
                             void* stream) {
  return ljmd::launch_sweep<double>(pos, out, tbl, counts, shf, lower, n_pencils_i, n_pencils,
                                    cap, box, inv_box, rc2, want_obs, stream);
}

}  // extern "C"
