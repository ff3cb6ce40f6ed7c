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
// leaves that multiply to its caller). Output rows 6, 7 and the tiles at or
// past a pencil's count stay as the wrapper zeroed them.
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
// What bounds it on the H100: the pair arithmetic. Each valid slot meets
// 9 pencils of `cap` slots (the TPU kernel's static capacity), evaluated from
// both sides (pencil_pairs.cuh): about 2 * 4.5 * cap candidate pairs per slot,
// one IEEE divide each.
//
// What the design does about that: one block of 32 slots x 4 partner slices
// per (pencil, 32-slot tile); tiles at or past the pencil's count exit at
// once, as the TPU kernel skips those i-slices, and empty partner pencils are
// skipped. Partners are staged 128 at a time in shared memory. Pair-twice
// with no atomics keeps the sweep deterministic; the 2x pair work is the price
// (atomics on the j side would halve it, at the cost of run-to-run
// reproducibility).
#include <cuda_runtime.h>

#include "pencil_pairs.cuh"

namespace ljmd {

template <typename T, bool OBS>
__global__ void __launch_bounds__(kPenStage)
pencil_sweep_kernel(const T* __restrict__ pos, T* __restrict__ out, const int* __restrict__ tbl,
                    const int* __restrict__ counts, const int* __restrict__ shf,
                    int n_pencils_i, int n_pencils, int cap, T box, T inv_box, T rc2) {
  __shared__ PenStage<T, false> sh;
  __shared__ T red[kPenSlices][OBS ? 6 : 3][kPenTile];
  __shared__ int lower[4];
  const int tiles = cap / kPenTile;
  const int q = blockIdx.x / tiles;
  const int rank0 = (blockIdx.x % tiles) * kPenTile;
  if (rank0 >= counts[q]) return;  // the whole block: nothing valid here
  const size_t ns = static_cast<size_t>(n_pencils) * cap;
  const PenGeom<T> p{pos, nullptr, ns, n_pencils, cap, box, inv_box, rc2};
  if (threadIdx.y == 0 && threadIdx.x < 4) lower[threadIdx.x] = -1;
  __syncthreads();
  pen_lower(tbl, n_pencils_i, q, lower);
  __syncthreads();
  const int g = q * cap + rank0 + threadIdx.x;
  const PenSlot<T> me{g, pos[g], pos[ns + g], pos[2 * ns + g], T(0), T(0), T(0)};
  PenAcc<T> acc = {T(0), T(0), T(0), T(0), T(0), T(0)};
  pen_table_pairs<T, false, OBS>(p, sh, me, q, q < n_pencils_i, lower, tbl, shf, counts, acc);
  pen_reduce<T, OBS ? 6 : 3>(red, acc);
  if (threadIdx.y == 0) {
    const T valid = pos[3 * ns + g];
#pragma unroll
    for (int c = 0; c < (OBS ? 6 : 3); ++c) {
      out[c * ns + g] = mul_rn(pen_sum<T, OBS ? 6 : 3>(red, c), valid);
    }
  }
}

template <typename T>
int launch_sweep(const T* pos, T* out, const int* tbl, const int* counts, const int* shf,
                 int n_pencils_i, int n_pencils, int cap, T box, T inv_box, T rc2, int want_obs,
                 void* stream) {
  const dim3 block(kPenTile, kPenSlices);
  const dim3 grid(n_pencils * (cap / kPenTile));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (want_obs) {
    pencil_sweep_kernel<T, true><<<grid, block, 0, s>>>(pos, out, tbl, counts, shf, n_pencils_i,
                                                        n_pencils, cap, box, inv_box, rc2);
  } else {
    pencil_sweep_kernel<T, false><<<grid, block, 0, s>>>(pos, out, tbl, counts, shf,
                                                         n_pencils_i, n_pencils, cap, box,
                                                         inv_box, rc2);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ljmd

extern "C" {

int ljmd_pencil_sweep_hs_f32(const float* pos, float* out, const int* tbl, const int* counts,
                             const int* shf, int n_pencils_i, int n_pencils, int cap, float box,
                             float inv_box, float rc2, int want_obs, void* stream) {
  return ljmd::launch_sweep<float>(pos, out, tbl, counts, shf, n_pencils_i, n_pencils, cap, box,
                                   inv_box, rc2, want_obs, stream);
}

int ljmd_pencil_sweep_hs_f64(const double* pos, double* out, const int* tbl, const int* counts,
                             const int* shf, int n_pencils_i, int n_pencils, int cap,
                             double box, double inv_box, double rc2, int want_obs,
                             void* stream) {
  return ljmd::launch_sweep<double>(pos, out, tbl, counts, shf, n_pencils_i, n_pencils, cap,
                                    box, inv_box, rc2, want_obs, stream);
}

}  // extern "C"
