// Kernels 6 and 7: the rect sweeps of the particle-sharded (multi-device)
// path, one rank's i rows against a visiting j block.
//
// Replaces: ljmd_tpu/ops/pallas_lj.py:364 `pallas_pair_sweep_rect` (Pallas
// body `_lj_rect_kernel`, :301; the `comm="ring"` hops) and :533
// `pallas_pair_sweep_rect_newton` (`_lj_rect_newton_kernel`, :433; the
// `comm="half_ring"` hops). Contract, column for column:
//
// - rect: out (8, ni_pad); rows 0..2 the force on each i row without the 24
//   prefactor, rows 3..5 e / du / ddu, both summed over every j of the block
//   inside the cutoff with gi0 + li != gj0 + lj (ordered pairs: the caller
//   restores the prefactors 2 / 12 after the cross-rank sum); masks li < n_i,
//   lj < n_j; rows 6..7 and columns >= n_i exactly 0.
// - rect-Newton: each pair of the active range [i_lo, n_i) x [0, j_hi) once.
//   out_i (8, ni_pad): rows 0..2 the i-side forces, rows 3..5 the pair-once
//   e / du / ddu (prefactors 4 / 24, no halving); out_j (8, nj_pad): rows
//   0..2 the j-side reactions, rows 3..7 exactly 0 (the caller adds out_j
//   into its accumulator rows wholesale). Pairs outside the range, padding
//   and gi == gj are masked.
//
// What bounds it on the H100: the pair arithmetic (~30 instructions and one
// IEEE divide a pair; ni x nj pairs a hop, 1000 x 1000 at N=4000 over four
// ranks); the rows (32 KB each) stay in L2.
//
// What the design does about that: the dense sweeps' body (pair_rows.cuh),
// generalised to distinct i / j matrices with global offsets and active
// ranges, so nothing of it is written twice. The TPU keeps the j reactions
// resident in VMEM across its sequential grid; Hopper's blocks run in no
// order, so rect-Newton stays pair-twice with no atomics: one launch holds
// i-role blocks (each i row sums its pairs with the active j range) and j-role
// blocks (each j row sums the negated pair force over the active i range).
// fl(xi - xj) == -fl(xj - xi) makes the two sides exact negations, as the
// header of pair_rows.cuh explains; the j side pays the pair work a second
// time, which keeps the sweep deterministic. Tiles wholly outside the range
// are skipped (the Pallas kernel's compute gate), so the gated half hop costs
// half a full hop on either rank.
#include <cuda_runtime.h>

#include "pair_rows.cuh"

namespace ljmd {

template <typename T>
int launch_rect(const T* pos_i, const T* pos_j, T* out, int n_i, int ni_pad, int n_j,
                int nj_pad, int gi0, int gj0, T box, T inv_box, T rc2, int want_obs,
                void* stream) {
  const RowsProblem<T> p = rows_problem<T>(pos_i, pos_j, out, n_i, ni_pad, 0, n_i, n_j, nj_pad,
                                           0, n_j, gi0, gj0, 1);
  return launch_rows_problems<T, true>(p, nullptr, want_obs, box, inv_box, rc2, stream);
}

template <typename T>
int launch_rect_newton(const T* pos_i, const T* pos_j, T* out_i, T* out_j, int n_i, int ni_pad,
                       int n_j, int nj_pad, int gi0, int gj0, int i_lo, int j_hi, T box,
                       T inv_box, T rc2, int want_obs, void* stream) {
  const RowsProblem<T> ir = rows_problem<T>(pos_i, pos_j, out_i, n_i, ni_pad, i_lo, n_i, n_j,
                                            nj_pad, 0, j_hi, gi0, gj0, 1);
  const RowsProblem<T> jr = rows_problem<T>(pos_j, pos_i, out_j, n_j, nj_pad, 0, j_hi, n_i,
                                            ni_pad, i_lo, n_i, gj0, gi0, 0);
  return launch_rows_problems<T, true>(ir, &jr, want_obs, box, inv_box, rc2, stream);
}

}  // namespace ljmd

extern "C" {

int ljmd_pair_sweep_rect_f32(const float* pos_i, const float* pos_j, float* out, int n_i,
                             int ni_pad, int n_j, int nj_pad, int gi0, int gj0, float box,
                             float inv_box, float rc2, int want_obs, void* stream) {
  return ljmd::launch_rect<float>(pos_i, pos_j, out, n_i, ni_pad, n_j, nj_pad, gi0, gj0, box,
                                  inv_box, rc2, want_obs, stream);
}

int ljmd_pair_sweep_rect_f64(const double* pos_i, const double* pos_j, double* out, int n_i,
                             int ni_pad, int n_j, int nj_pad, int gi0, int gj0, double box,
                             double inv_box, double rc2, int want_obs, void* stream) {
  return ljmd::launch_rect<double>(pos_i, pos_j, out, n_i, ni_pad, n_j, nj_pad, gi0, gj0, box,
                                   inv_box, rc2, want_obs, stream);
}

int ljmd_pair_sweep_rect_newton_f32(const float* pos_i, const float* pos_j, float* out_i,
                                    float* out_j, int n_i, int ni_pad, int n_j, int nj_pad,
                                    int gi0, int gj0, int i_lo, int j_hi, float box,
                                    float inv_box, float rc2, int want_obs, void* stream) {
  return ljmd::launch_rect_newton<float>(pos_i, pos_j, out_i, out_j, n_i, ni_pad, n_j, nj_pad,
                                         gi0, gj0, i_lo, j_hi, box, inv_box, rc2, want_obs,
                                         stream);
}

int ljmd_pair_sweep_rect_newton_f64(const double* pos_i, const double* pos_j, double* out_i,
                                    double* out_j, int n_i, int ni_pad, int n_j, int nj_pad,
                                    int gi0, int gj0, int i_lo, int j_hi, double box,
                                    double inv_box, double rc2, int want_obs, void* stream) {
  return ljmd::launch_rect_newton<double>(pos_i, pos_j, out_i, out_j, n_i, ni_pad, n_j, nj_pad,
                                          gi0, gj0, i_lo, j_hi, box, inv_box, rc2, want_obs,
                                          stream);
}

}  // extern "C"
