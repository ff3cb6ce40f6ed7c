// Kernel 12: the z-banded pencil sweep, with and without the observables
// (the cell-pair engine's z_band=True mode).
//
// Replaces: ljmd_tpu/ops/pallas_pencil.py:256 `pallas_pencil_sweep_zband`
// (its Pallas body `_pencil_zband_kernel`, :160). Contract: `pos` is the
// (8, ns) slot matrix with z-sorted ranks in each pencil (x/y/z in rows 0..2,
// the validity in row 3); tbl (n_pencils * 9) the xy-neighbour table; the
// window tables start_a, start_b, use_b are (T * 9,) with T = ns / 128, one
// entry per (128-slot i-slice, neighbour k), from `compute_z_windows`
// (ops/cell_list.py). Each slot of slice t sums, for every neighbour pencil j
// with a particle, the pairs with the `window` ranks from start_a, and under
// use_b those from start_b that window A does not hold (deduped by rank), with
// the full minimum image in x, y AND z (this sweep takes no shift table) and
// the mask r^2 < rc^2, gi != gj, v_i * v_j > 0.5. Output rows as kernel 11:
// 0..2 the force without the 24, 3..5 (want_obs) e / du / ddu, each pair
// counted twice; invalid slots exactly 0, rows 6, 7 and the tiles past a
// pencil's count as the wrapper zeroed them.
//
// What bounds it on the H100: the pair arithmetic, 9 * window (+ window B
// near the z faces) candidate pairs per slot instead of kernel 11's 9 * cap,
// each with three rounds instead of one.
//
// What the design does about that: kernel 11's block layout (32 slots x 4
// partner slices per (pencil, 32-slot tile), i side only, no atomics). The
// tables are per 128-slot slice, so a block reads the entry of the slice that
// holds it, t = (pencil * cap + rank0) / 128. Windows start on 128-slot
// boundaries and fit the pencil (start <= cap - window), so each is whole
// shared-memory stages of 128 partners.
#include <cuda_runtime.h>

#include "pencil_pairs.cuh"

namespace ljmd {

template <typename T, bool OBS>
__global__ void __launch_bounds__(kPenStage)
pencil_sweep_zband_kernel(const T* __restrict__ pos, T* __restrict__ out,
                          const int* __restrict__ tbl, const int* __restrict__ counts,
                          const int* __restrict__ start_a, const int* __restrict__ start_b,
                          const int* __restrict__ use_b, int n_pencils, int cap, int window,
                          T box, T inv_box, T rc2) {
  __shared__ PenStageV<T> sh;
  __shared__ T red[kPenSlices][OBS ? 6 : 3][kPenTile];
  const int tiles = cap / kPenTile;
  const int q = blockIdx.x / tiles;
  const int rank0 = (blockIdx.x % tiles) * kPenTile;
  if (rank0 >= counts[q]) return;  // the whole block: nothing valid here
  const size_t ns = static_cast<size_t>(n_pencils) * cap;
  const PenGeom<T> p{pos, nullptr, ns, n_pencils, cap, box, inv_box, rc2};
  const int g = q * cap + rank0 + threadIdx.x;
  const int t = (q * cap + rank0) / kPenGran;  // this block's 128-slot i-slice
  const T xi = pos[g], yi = pos[ns + g], zi = pos[2 * ns + g], vi = pos[3 * ns + g];
  PenAcc<T> acc = {T(0), T(0), T(0), T(0), T(0), T(0)};
#pragma unroll 1
  for (int k = 0; k < 9; ++k) {
    const int j = tbl[q * 9 + k];
    if (counts[j] == 0) continue;  // block-uniform: the barriers stay matched
    const int a0 = j * cap + start_a[t * 9 + k];
    pen_i_segment<T, OBS, true>(p, sh, g, xi, yi, zi, vi, a0, window, T(0), T(0), 0, 0, acc);
    if (use_b[t * 9 + k] > 0) {
      pen_i_segment<T, OBS, true>(p, sh, g, xi, yi, zi, vi, j * cap + start_b[t * 9 + k],
                                  window, T(0), T(0), a0, a0 + window, acc);
    }
  }
  pen_reduce<T, OBS ? 6 : 3>(red, acc);
  if (threadIdx.y == 0) {
#pragma unroll
    for (int c = 0; c < (OBS ? 6 : 3); ++c) out[c * ns + g] = pen_sum<T, OBS ? 6 : 3>(red, c);
  }
}

template <typename T>
int launch_sweep_zband(const T* pos, T* out, const int* tbl, const int* counts,
                       const int* start_a, const int* start_b, const int* use_b, int n_pencils,
                       int cap, int window, T box, T inv_box, T rc2, int want_obs,
                       void* stream) {
  const dim3 block(kPenTile, kPenSlices);
  const dim3 grid(n_pencils * (cap / kPenTile));
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
