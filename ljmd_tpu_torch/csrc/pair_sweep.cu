// Kernel 5: the ordered N x N pair sweep of the force API (backend "pallas"),
// the flagship step and the rows engine's triangular=False mode.
//
// Replaces: ljmd_tpu/ops/pallas_lj.py:103 `pallas_pair_sweep` (Pallas body
// `_lj_tile_kernel`, :48). Contract, column for column: on the (8, n_pad) row
// matrix, rows 0..2 hold the force on particle i without the 24 prefactor,
// summed over every j != i inside the cutoff; rows 3..5 hold e / du / ddu
// summed over every j != i (each pair counted twice, so the caller restores
// the prefactors 2 / 12); masks come from indices, so rows 6..7 and every
// column >= n are exactly 0. 1/r^2 is one IEEE divide (the TPU kernel's
// approximate reciprocal is not ported).
//
// What bounds it on the H100: the pair arithmetic (a displacement and r^2 a
// candidate, ~30 instructions and one IEEE divide a pair inside the cutoff,
// n^2 candidates), and at the main path's sizes (500 to 4000 rows) the few
// rows an SM; the (8, n_pad) input stays in L2.
//
// What the design does about that: it is the ring's rect sweep (kernel 6)
// with A = B = pos, n_a = n_b = n and offsets 0, so it launches
// rows_sweep.cuh's single-role kernel (which explains it) with UPPER off:
// S threads a row from the occupancy API (N=4000: S = 16, 250 blocks;
// N=864: 64; N=500: 128), cp.async staging, the warp-vote cull, fixed-order
// sums; deterministic, no atomics. UPPER gates only rows 3..5, so at the
// same S rows 0..2 are the tri sweep's (kernel 2) bit for bit, and the rows
// engine's two modes follow one trajectory.
#include <cuda_runtime.h>

#include "rows_sweep.cuh"

extern "C" {

int ljmd_pair_sweep_f32(const float* pos, float* out, int n, int n_pad, float box,
                        float inv_box, float rc2, int want_obs, void* stream) {
  return ljmd::launch_rows_sweep<float, false>(pos, pos, out, n, n_pad, n, n_pad, 0, 0, box,
                                               inv_box, rc2, want_obs, stream);
}

int ljmd_pair_sweep_f64(const double* pos, double* out, int n, int n_pad, double box,
                        double inv_box, double rc2, int want_obs, void* stream) {
  return ljmd::launch_rows_sweep<double, false>(pos, pos, out, n, n_pad, n, n_pad, 0, 0, box,
                                                inv_box, rc2, want_obs, stream);
}

}  // extern "C"
