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
// no multiply by the validity row afterwards; rows 6, 7 and the 32-slot tiles
// at or past a pencil's count stay as the wrapper zeroed them (the TPU kernel
// skips 128-slot i-slices there, and every slot of such a tile is invalid).
//
// What bounds it on the H100: the pair arithmetic. Each valid slot meets 9
// pencils of `cap` slots (the static capacity, as on the TPU): 9 * cap
// candidate pairs per slot, one IEEE divide each, the same count as the
// half-shell sweep's pair-twice evaluation (kernel 13).
//
// What the design does about that: the TPU kernel already evaluates every
// pair from both sides, so there are no reactions to place: one block of 32
// slots x 4 partner slices per (pencil, 32-slot tile), each slot summing its
// own pairs (pen_i_segment, pencil_pairs.cuh). Tiles at or past the pencil's
// count exit at once and empty partner pencils are skipped; partners are
// staged 128 at a time in shared memory; the four partial sums of a slot are
// added in a fixed order, so the sweep is deterministic.
#include <cuda_runtime.h>

#include "pencil_pairs.cuh"

namespace ljmd {

template <typename T, bool OBS>
__global__ void __launch_bounds__(kPenStage)
pencil_sweep_full_kernel(const T* __restrict__ pos, T* __restrict__ out,
                         const int* __restrict__ tbl, const int* __restrict__ counts,
                         const int* __restrict__ shf, int n_pencils, int cap, T box, T inv_box,
                         T rc2) {
  __shared__ PenStageV<T> sh;
  __shared__ T red[kPenSlices][OBS ? 6 : 3][kPenTile];
  const int tiles = cap / kPenTile;
  const int q = blockIdx.x / tiles;
  const int rank0 = (blockIdx.x % tiles) * kPenTile;
  if (rank0 >= counts[q]) return;  // the whole block: nothing valid here
  const size_t ns = static_cast<size_t>(n_pencils) * cap;
  const PenGeom<T> p{pos, nullptr, ns, n_pencils, cap, box, inv_box, rc2};
  const int g = q * cap + rank0 + threadIdx.x;
  const T xi = pos[g], yi = pos[ns + g], zi = pos[2 * ns + g], vi = pos[3 * ns + g];
  PenAcc<T> acc = {T(0), T(0), T(0), T(0), T(0), T(0)};
#pragma unroll 1
  for (int k = 0; k < 9; ++k) {
    const int j = tbl[q * 9 + k];
    if (counts[j] == 0) continue;  // block-uniform: the barriers stay matched
    const T offx = mul_rn(static_cast<T>(shf[(q * 9 + k) * 2]), box);
    const T offy = mul_rn(static_cast<T>(shf[(q * 9 + k) * 2 + 1]), box);
    pen_i_segment<T, OBS, false>(p, sh, g, xi, yi, zi, vi, j * cap, cap, offx, offy, 0, 0, acc);
  }
  pen_reduce<T, OBS ? 6 : 3>(red, acc);
  if (threadIdx.y == 0) {
#pragma unroll
    for (int c = 0; c < (OBS ? 6 : 3); ++c) out[c * ns + g] = pen_sum<T, OBS ? 6 : 3>(red, c);
  }
}

template <typename T>
int launch_sweep_full(const T* pos, T* out, const int* tbl, const int* counts, const int* shf,
                      int n_pencils, int cap, T box, T inv_box, T rc2, int want_obs,
                      void* stream) {
  const dim3 block(kPenTile, kPenSlices);
  const dim3 grid(n_pencils * (cap / kPenTile));
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
