// Device code shared by the dense row sweeps: the tri sweep (pair_sweep_tri.cu,
// kernel 2), the ordered sweep (pair_sweep.cu, kernel 5) and the two rect
// sweeps of the multi-device path (pair_sweep_rect.cu, kernels 6 and 7). One
// kernel template: a block owns 32 particles of a row matrix A and sums, for
// each, its pairs with a range of the particles of a row matrix B.
//
// Layout: (8, ld) row matrices, x/y/z in rows 0..2. A "problem" names A (its
// first n_a columns are particles, those in [a_lo, a_hi) are active), B (n_b
// particles, [b_lo, b_hi) active) and the global index of their first columns
// (ga0, gb0). Output rows 0..2 hold the force on each active particle of A
// without the 24 prefactor, summed over the active partners of B inside the
// cutoff with gb != ga; rows 3..5 (observables) sum e / du / ddu over the same
// pairs (OBS_ALL_J: the ordered and rect sweeps) or over those with gb > ga
// (the tri sweep: each pair once, prefactors 4 / 24); rows 6..7 and every
// column outside the active range are exactly 0. Padding is masked by index,
// never by position, as the Pallas kernels' global-index masks do. The dense
// sweeps pass A = B with the full ranges and offsets 0.
//
// One launch may hold two problems, block ranges one after the other: the
// rect-Newton sweep's i role (A = the i rows, observables on) and its j role
// (A = the j rows, B = the i rows, no observables: its rows 3..7 are 0).
//
// What bounds it on the H100: arithmetic and instruction throughput, not
// memory. The inputs are at most a few hundred KB and stay in L2; each call
// evaluates O(n_a * n_b) pairs of ~30 instructions each (plus one IEEE
// divide). At the main path's sizes (n = 500 and 4000, 1000 a rank) there are
// few particles per SM, so latency and occupancy matter as much as the count.
//
// What the design does about that: pair-twice without atomics. A block owns
// 32 particles (threadIdx.x) and splits the partner range four ways
// (threadIdx.y), so each particle gets four threads and n = 4000 fills 125
// blocks. Positions of a 128-wide partner tile are staged once in shared
// memory and read by all 32 lanes as broadcasts; tiles wholly outside the
// partner range are not visited and blocks wholly outside the active range
// only write zeros (the Pallas kernels' compute gates). The four partial sums
// of a particle are added in shared memory in a fixed order, so the result is
// deterministic run to run. Because fl(xi - xj) == -fl(xj - xi) and the
// minimum image rounds half to even (symmetric), the pair force computed from
// the j side is the exact negation of the i side's: pair-twice gives the same
// per-pair values as the TPU's pair-once reactions, summed in another order.
#pragma once

#include <cuda_runtime.h>

#include "lj_pair_terms.cuh"

namespace ljmd {

constexpr int kTileI = 32;               // particles i per block
constexpr int kSlicesJ = 4;              // threads per particle (j slices)
constexpr int kTileJ = kTileI * kSlicesJ;  // j tile staged in shared memory

template <typename T>
struct RowsProblem {
  const T* a;   // (8, lda) rows whose forces are summed
  const T* b;   // (8, ldb) partner rows
  T* out;       // (8, lda)
  int n_a, lda, a_lo, a_hi;
  int n_b, ldb, b_lo, b_hi;
  int ga0, gb0;
  int obs;      // sum rows 3..5 (only where the template's OBS is set)
  int blocks;   // lda / kTileI
};

template <typename T, bool OBS, bool OBS_ALL_J>
__global__ void __launch_bounds__(kTileI * kSlicesJ)
pair_rows_kernel(RowsProblem<T> p0, RowsProblem<T> p1, T box, T inv_box, T rc2) {
  __shared__ T sx[kTileJ], sy[kTileJ], sz[kTileJ];
  __shared__ T red[kSlicesJ][6][kTileI];

  const bool second = blockIdx.x >= p0.blocks;
  const RowsProblem<T> p = second ? p1 : p0;
  const int blk = second ? blockIdx.x - p0.blocks : blockIdx.x;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int i = blk * kTileI + tx;
  const int a_end = min(p.a_hi, p.n_a);
  const int b_end = min(p.b_hi, p.n_b);
  if (blk * kTileI >= a_end || blk * kTileI + kTileI <= p.a_lo || p.b_lo >= b_end) {
    if (ty == 0) {
#pragma unroll
      for (int k = 0; k < 8; ++k) p.out[k * p.lda + i] = T(0);
    }
    return;  // the whole block: no active pair
  }
  const bool live_i = i >= p.a_lo && i < a_end;
  const bool obs = OBS && p.obs;
  const int gi = p.ga0 + i;
  const T xi = live_i ? p.a[i] : T(0);
  const T yi = live_i ? p.a[p.lda + i] : T(0);
  const T zi = live_i ? p.a[2 * p.lda + i] : T(0);

  T acc[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
  for (int j0 = (p.b_lo / kTileJ) * kTileJ; j0 < b_end; j0 += kTileJ) {
    const int t = ty * kTileI + tx;
    const int jl = j0 + t;
    __syncthreads();  // previous tile fully consumed
    sx[t] = jl < b_end ? p.b[jl] : T(0);
    sy[t] = jl < b_end ? p.b[p.ldb + jl] : T(0);
    sz[t] = jl < b_end ? p.b[2 * p.ldb + jl] : T(0);
    __syncthreads();
    const int jend = min(kTileJ, b_end - j0);
    for (int jj = ty; jj < jend; jj += kSlicesJ) {
      const int j = j0 + jj;
      const int gj = p.gb0 + j;
      const T dx = min_image(sub_rn(xi, sx[jj]), box, inv_box);
      const T dy = min_image(sub_rn(yi, sy[jj]), box, inv_box);
      const T dz = min_image(sub_rn(zi, sz[jj]), box, inv_box);
      const T r2 = add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz));
      const bool mask = live_i && (j >= p.b_lo) && (gj != gi) && (r2 < rc2);
      const PairTerms<T> pt = lj_pair_terms<T, OBS>(r2, mask);
      acc[0] = add_rn(acc[0], mul_rn(pt.coef, dx));
      acc[1] = add_rn(acc[1], mul_rn(pt.coef, dy));
      acc[2] = add_rn(acc[2], mul_rn(pt.coef, dz));
      if (obs && (OBS_ALL_J || gj > gi)) {
        acc[3] = add_rn(acc[3], pt.e);
        acc[4] = add_rn(acc[4], pt.du);
        acc[5] = add_rn(acc[5], pt.ddu);
      }
    }
  }

#pragma unroll
  for (int k = 0; k < 6; ++k) red[ty][k][tx] = acc[k];
  __syncthreads();
  if (ty == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      T s = red[0][k][tx];
#pragma unroll
      for (int q = 1; q < kSlicesJ; ++q) s = add_rn(s, red[q][k][tx]);
      p.out[k * p.lda + i] = live_i ? s : T(0);
    }
    p.out[6 * p.lda + i] = T(0);
    p.out[7 * p.lda + i] = T(0);
  }
}

template <typename T>
RowsProblem<T> rows_problem(const T* a, const T* b, T* out, int n_a, int lda, int a_lo,
                            int a_hi, int n_b, int ldb, int b_lo, int b_hi, int ga0, int gb0,
                            int obs) {
  return RowsProblem<T>{a, b, out, n_a, lda, a_lo, a_hi, n_b, ldb, b_lo, b_hi, ga0, gb0, obs,
                        lda / kTileI};
}

// One launch over one problem (p1 == nullptr) or two, back to back.
template <typename T, bool OBS_ALL_J>
int launch_rows_problems(const RowsProblem<T>& p0, const RowsProblem<T>* p1, int want_obs,
                         T box, T inv_box, T rc2, void* stream) {
  const dim3 block(kTileI, kSlicesJ);
  const RowsProblem<T> second = p1 ? *p1 : p0;
  const dim3 grid(p0.blocks + (p1 ? p1->blocks : 0));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (want_obs) {
    pair_rows_kernel<T, true, OBS_ALL_J><<<grid, block, 0, s>>>(p0, second, box, inv_box, rc2);
  } else {
    pair_rows_kernel<T, false, OBS_ALL_J><<<grid, block, 0, s>>>(p0, second, box, inv_box, rc2);
  }
  return static_cast<int>(cudaGetLastError());
}

// The dense sweeps: A = B = pos, every particle active, offsets 0.
template <typename T, bool OBS_ALL_J>
int launch_pair_rows(const T* pos, T* out, int n, int n_pad, T box, T inv_box, T rc2,
                     int want_obs, void* stream) {
  const RowsProblem<T> p = rows_problem<T>(pos, pos, out, n, n_pad, 0, n, n, n_pad, 0, n, 0, 0,
                                           1);
  return launch_rows_problems<T, OBS_ALL_J>(p, nullptr, want_obs, box, inv_box, rc2, stream);
}

}  // namespace ljmd
