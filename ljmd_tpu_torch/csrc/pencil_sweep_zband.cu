// Kernel 12: the z-banded pencil sweep, with and without the observables
// (the cell-pair engine's z_band=True mode).
//
// Replaces: ljmd_tpu/ops/pallas_pencil.py:256 `pallas_pencil_sweep_zband`
// (its Pallas body `_pencil_zband_kernel`, :160). Contract: `pos` is the
// (8, ns) slot matrix, ranks z-sorted in each pencil, row 3 the validity;
// tbl (n_pencils * 9) the xy-neighbour table; start_a, start_b, use_b one
// entry per (128-slot i-slice, neighbour k) from `compute_z_windows`. Each
// slot sums, for every non-empty neighbour pencil j, the pairs with the
// `window` ranks from start_a and, under use_b, those from start_b that
// window A does not hold, with the full minimum image in x, y and z and the
// mask r^2 < rc^2, gi != gj, v_i * v_j > 0.5. Output rows as kernel 11 (the
// force without the 24, e / du / ddu; each pair counted twice).
//
// What bounds it on the H100: the candidate arithmetic, 9 * window (+ B)
// candidates a slot with three minimum-image rounds each, ~1.6% of them
// inside the cutoff at config 5. The earlier port ran 32-slot blocks (four
// staged the same partners of a 128-slot slice), staged synchronously, swept
// stages that the dedupe or the count masks entirely, and paid the LJ
// algebra on every candidate.
//
// What the design does about that:
// - One block is one 128-slot i-slice (whose slots share one row of the
//   window tables), 128 x 4 threads, thread (slot, slice) taking partners
//   slice, slice + 4, ... of each stage. Slices at or past the pencil's
//   count return; the wrapper zeroed their output.
// - Exact stage skips, both block-uniform: windows start on 128-slot
//   boundaries and are multiples of 128 (ops/pencil_sweep.py checks the
//   width; `compute_z_windows` aligns the starts), so a window stage either
//   lies wholly inside window A or misses it. A stage whose first rank is at
//   or past counts[j] holds only invalid slots (v_i * v_j > 0.5 fails); a
//   window-B stage inside window A is what the rank dedupe masks. The stages
//   left are swept with no dedupe test (ops/pencil_sweep.py
//   `zband_stage_plan` is the same rule as plain torch).
// - Stages are copied with cp.async into a ring of three buffers, one
//   __syncthreads() a stage.
// - The culled loop (pencil_cull.cuh): the three rounds and r^2 for every
//   candidate, the LJ algebra and the observables only where a lane of the
//   warp holds the mask.
// - The partner order of the earlier port (each slot: neighbours k = 0..8,
//   window A's stages then B's, partners slice, slice + 4, ...) and its
//   fixed-order sum of the 4 partial sums are kept, so the output is its
//   bit for bit: a skipped stage or a culled pair added an exact +-0 to a
//   sum that starts at +0.
#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "pencil_cull.cuh"
#include "pencil_pairs.cuh"

namespace ljmd {

constexpr int kZbSlices = 4;      // threads a slot
constexpr int kZbRing = 3;        // staging buffers
constexpr int kZbMaxWin = 16;     // 128-slot stages a window (window <= 2048)

template <typename T, bool OBS>
__global__ void __launch_bounds__(kPenGran * kZbSlices)
pencil_sweep_zband_kernel(const T* __restrict__ pos, T* __restrict__ out,
                          const int* __restrict__ tbl, const int* __restrict__ counts,
                          const int* __restrict__ start_a, const int* __restrict__ start_b,
                          const int* __restrict__ use_b, int n_pencils, int cap, int window,
                          T box, T inv_box, T rc2) {
  constexpr int kRows = 4;  // x, y, z, validity
  constexpr int kThreads = kPenGran * kZbSlices;
  constexpr int kOut = OBS ? 6 : 3;
  __shared__ __align__(16) T stage[kZbRing][kRows][kPenGran];
  __shared__ T red[kZbSlices][kOut][kPenGran];
  __shared__ int nb_j[9], nb_cnt[9], nb_a[9], nb_b[9], nb_ub[9];
  __shared__ int st_q0[9 * 2 * kZbMaxWin];
  __shared__ int n_st;
  const int n_sub = cap / kPenGran;
  const int t = blockIdx.x;  // the 128-slot i-slice
  const int q = t / n_sub;
  if ((t - q * n_sub) * kPenGran >= counts[q]) return;  // nothing valid here (block-uniform)
  const size_t ns = static_cast<size_t>(n_pencils) * cap;
  const int tx = threadIdx.x;
  const int tid = threadIdx.y * kPenGran + tx;

  // The block's stage plan: per neighbour k, window A's stages then B's,
  // without the stages past the partner's count or (B) inside window A.
  if (tid < 9) {
    const int j = tbl[q * 9 + tid];
    nb_j[tid] = j;
    nb_cnt[tid] = counts[j];
    nb_a[tid] = start_a[t * 9 + tid];
    nb_b[tid] = start_b[t * 9 + tid];
    nb_ub[tid] = use_b[t * 9 + tid];
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int k = 0; k < 9; ++k) {
      const int cj = nb_cnt[k];
      if (cj == 0) continue;
      const int a0 = nb_a[k];
      for (int s = a0; s < a0 + window && s < cj; s += kPenGran) {
        st_q0[n++] = nb_j[k] * cap + s;
      }
      if (nb_ub[k] > 0) {
        for (int s = nb_b[k]; s < nb_b[k] + window && s < cj; s += kPenGran) {
          if (s >= a0 && s < a0 + window) continue;  // deduped against window A
          st_q0[n++] = nb_j[k] * cap + s;
        }
      }
    }
    n_st = n;
  }
  __syncthreads();

  const int g = t * kPenGran + tx;
  const T xi = pos[g], yi = pos[ns + g], zi = pos[2 * ns + g], vi = pos[3 * ns + g];
  PenAcc<T> acc = {T(0), T(0), T(0), T(0), T(0), T(0)};
  const int n = n_st;
  if (n > 0) {
    stage_rows(&stage[0][0][0], kPenGran, pos, pos + 3 * ns, ns, kRows,
               static_cast<size_t>(st_q0[0]), kPenGran, tid, kThreads);
    cp_async_commit();
  }
  for (int c = 0; c < n; ++c) {
    if (c + 1 < n) {
      stage_rows(&stage[(c + 1) % kZbRing][0][0], kPenGran, pos, pos + 3 * ns, ns, kRows,
                 static_cast<size_t>(st_q0[c + 1]), kPenGran, tid, kThreads);
      cp_async_commit();
      cp_async_wait(1);
    } else {
      cp_async_wait(0);
    }
    // Stage c has landed for every thread; the buffer stage c + 1 is
    // copied into was last read at stage c - 2, before the previous barrier.
    __syncthreads();
    const T(*sb)[kPenGran] = stage[c % kZbRing];
    cull_stage_full<T, OBS, kZbSlices, kFullMinImage>(sb[0], sb[1], sb[2], sb[3], g, xi, yi, zi,
                                                      vi, st_q0[c], T(0), T(0), box, inv_box,
                                                      rc2, acc);
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
      for (int s = 1; s < kZbSlices; ++s) f = add_rn(f, red[s][c][tx]);
      out[c * ns + g] = f;
    }
  }
}

template <typename T, bool OBS>
int zband_occupancy(int* out) {
  const void* fn = reinterpret_cast<const void*>(pencil_sweep_zband_kernel<T, OBS>);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kPenGran * kZbSlices, 0);
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
int launch_sweep_zband(const T* pos, T* out, const int* tbl, const int* counts,
                       const int* start_a, const int* start_b, const int* use_b, int n_pencils,
                       int cap, int window, T box, T inv_box, T rc2, int want_obs,
                       void* stream) {
  if (cap % kPenGran != 0 || window % kPenGran != 0 || window > cap ||
      window / kPenGran > kZbMaxWin) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(kPenGran, kZbSlices);
  const dim3 grid(n_pencils * (cap / kPenGran));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (want_obs) {
    pencil_sweep_zband_kernel<T, true><<<grid, block, 0, s>>>(
        pos, out, tbl, counts, start_a, start_b, use_b, n_pencils, cap, window, box, inv_box,
        rc2);
  } else {
    pencil_sweep_zband_kernel<T, false><<<grid, block, 0, s>>>(
        pos, out, tbl, counts, start_a, start_b, use_b, n_pencils, cap, window, box, inv_box,
        rc2);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ljmd

extern "C" {

// Launch shape of kernel 12: out[0..3] = resident blocks an SM, SMs,
// registers a thread, local (spill) bytes a thread.
int ljmd_zband_occupancy(int dtype_bytes, int want_obs, int* out) {
  using ljmd::zband_occupancy;
  if (dtype_bytes == 4) {
    return want_obs ? zband_occupancy<float, true>(out) : zband_occupancy<float, false>(out);
  }
  return want_obs ? zband_occupancy<double, true>(out) : zband_occupancy<double, false>(out);
}

// The block threads and the largest window / 128 the kernel takes.
int ljmd_zband_block_threads() { return ljmd::kPenGran * ljmd::kZbSlices; }
int ljmd_zband_max_window_stages() { return ljmd::kZbMaxWin; }

int ljmd_pencil_sweep_zband_f32(const float* pos, float* out, const int* tbl, const int* counts,
                                const int* start_a, const int* start_b, const int* use_b,
                                int n_pencils, int cap, int window, float box, float inv_box,
                                float rc2, int want_obs, void* stream) {
  return ljmd::launch_sweep_zband<float>(pos, out, tbl, counts, start_a, start_b, use_b,
                                         n_pencils, cap, window, box, inv_box, rc2, want_obs,
                                         stream);
}

int ljmd_pencil_sweep_zband_f64(const double* pos, double* out, const int* tbl,
                                const int* counts, const int* start_a, const int* start_b,
                                const int* use_b, int n_pencils, int cap, int window,
                                double box, double inv_box, double rc2, int want_obs,
                                void* stream) {
  return ljmd::launch_sweep_zband<double>(pos, out, tbl, counts, start_a, start_b, use_b,
                                          n_pencils, cap, window, box, inv_box, rc2, want_obs,
                                          stream);
}

}  // extern "C"
