// Kernel 5: the ordered N x N pair sweep of the force API (backend "pallas"),
// the flagship step and the rows engine's triangular=False mode.
//
// Replaces: ljmd_tpu/ops/pallas_lj.py:103 `pallas_pair_sweep` (Pallas body
// `_lj_tile_kernel`, :48). Output contract, column for column: on the
// (8, n_pad) row matrix, rows 0..2 hold the force on particle i without the
// 24 prefactor, summed over every j != i inside the cutoff; rows 3..5 hold
// e / du / ddu summed over EVERY j != i (each pair counted twice, so the
// caller restores the prefactors 2 / 12); masks come from global indices
// (gi != gj, gj < n, gi < n), so rows 6..7 and every column >= n are exactly
// 0. The TPU kernel's approximate reciprocal is not ported: 1/r^2 is one IEEE
// divide, as in every sweep of this package.
//
// What bounds it on the H100: the pair arithmetic (~30 instructions and one
// IEEE divide a pair, O(n^2) pairs), and at n = 4000 the few particles per
// SM; the (8, n_pad) input stays in L2.
//
// What the design does about that: the tri sweep's body (kernel 2), shared in
// pair_rows.cuh with its OBS_ALL_J flag set: the TPU kernel already evaluates
// every pair from both sides, so on Hopper the two sweeps differ only in which
// pairs rows 3..5 sum. 32 i x 4 j slices a block over a shared-memory j tile,
// a fixed-order reduction: deterministic, no atomics.
#include <cuda_runtime.h>

#include "pair_rows.cuh"

extern "C" {

int ljmd_pair_sweep_f32(const float* pos, float* out, int n, int n_pad, float box,
                        float inv_box, float rc2, int want_obs, void* stream) {
  return ljmd::launch_pair_rows<float, true>(pos, out, n, n_pad, box, inv_box, rc2, want_obs,
                                             stream);
}

int ljmd_pair_sweep_f64(const double* pos, double* out, int n, int n_pad, double box,
                        double inv_box, double rc2, int want_obs, void* stream) {
  return ljmd::launch_pair_rows<double, true>(pos, out, n, n_pad, box, inv_box, rc2, want_obs,
                                              stream);
}

}  // extern "C"
