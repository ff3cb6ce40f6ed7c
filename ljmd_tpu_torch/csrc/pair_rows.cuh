// Device code shared by the two dense row sweeps (pair_sweep_tri.cu, kernel 2,
// and pair_sweep.cu, kernel 5): one kernel template whose OBS_ALL_J flag picks
// which pairs the e/du/ddu rows sum.
//
// Layout: (8, n_pad) row matrices, x/y/z in rows 0..2. Output rows 0..2 hold
// the TOTAL force on particle i without the 24 prefactor (sum over every
// j != i inside the cutoff); rows 3..5 sum e / du / ddu over j > i (the tri
// sweep: each pair once, prefactors 4 / 24) or over every j != i (OBS_ALL_J,
// the ordered sweep: each pair twice, prefactors 2 / 12); rows 6..7 and every
// column >= n are exactly 0. Padding is masked by index (j < n, i < n), never
// by position, as the Pallas kernels' global-index masks do.
//
// What bounds it on the H100: arithmetic and instruction throughput, not
// memory. The (8, n_pad) input is at most a few hundred KB and stays in L2;
// each call evaluates O(n^2) pairs of ~30 instructions each (plus one IEEE
// divide). At the main path's sizes (n = 500 and 4000) there are few particles
// per SM, so latency and occupancy matter as much as the instruction count.
//
// What the design does about that: pair-twice without atomics. A block owns
// 32 particles i (threadIdx.x) and splits the j range four ways (threadIdx.y),
// so each i gets four threads and n = 4000 fills 125 blocks. Positions of a
// 128-wide j tile are staged once in shared memory and read by all 32 i lanes
// as broadcasts. The four partial sums of an i are added in shared memory in a
// fixed order, so the result is deterministic run to run. Because
// fl(xi - xj) == -fl(xj - xi) and the minimum image rounds half to even
// (symmetric), the pair force computed from the j side is the exact negation
// of the i side's: pair-twice gives the same per-pair values as the TPU's
// pair-once reactions, summed in another order.
#pragma once

#include <cuda_runtime.h>

#include "lj_pair_terms.cuh"

namespace ljmd {

constexpr int kTileI = 32;               // particles i per block
constexpr int kSlicesJ = 4;              // threads per particle (j slices)
constexpr int kTileJ = kTileI * kSlicesJ;  // j tile staged in shared memory

template <typename T, bool OBS, bool OBS_ALL_J>
__global__ void __launch_bounds__(kTileI * kSlicesJ)
pair_rows_kernel(const T* __restrict__ pos, T* __restrict__ out, int n, int n_pad, T box,
                 T inv_box, T rc2) {
  __shared__ T sx[kTileJ], sy[kTileJ], sz[kTileJ];
  __shared__ T red[kSlicesJ][6][kTileI];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int i = blockIdx.x * kTileI + tx;
  const bool live_i = i < n;
  const T xi = live_i ? pos[i] : T(0);
  const T yi = live_i ? pos[n_pad + i] : T(0);
  const T zi = live_i ? pos[2 * n_pad + i] : T(0);

  T acc[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
  for (int j0 = 0; j0 < n; j0 += kTileJ) {
    const int t = ty * kTileI + tx;
    const int jl = j0 + t;
    __syncthreads();  // previous tile fully consumed
    sx[t] = jl < n ? pos[jl] : T(0);
    sy[t] = jl < n ? pos[n_pad + jl] : T(0);
    sz[t] = jl < n ? pos[2 * n_pad + jl] : T(0);
    __syncthreads();
    const int jend = min(kTileJ, n - j0);
    for (int jj = ty; jj < jend; jj += kSlicesJ) {
      const int j = j0 + jj;
      const T dx = min_image(sub_rn(xi, sx[jj]), box, inv_box);
      const T dy = min_image(sub_rn(yi, sy[jj]), box, inv_box);
      const T dz = min_image(sub_rn(zi, sz[jj]), box, inv_box);
      const T r2 = add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz));
      const bool mask = live_i && (j != i) && (r2 < rc2);
      const PairTerms<T> p = lj_pair_terms<T, OBS>(r2, mask);
      acc[0] = add_rn(acc[0], mul_rn(p.coef, dx));
      acc[1] = add_rn(acc[1], mul_rn(p.coef, dy));
      acc[2] = add_rn(acc[2], mul_rn(p.coef, dz));
      if (OBS && (OBS_ALL_J || j > i)) {
        acc[3] = add_rn(acc[3], p.e);
        acc[4] = add_rn(acc[4], p.du);
        acc[5] = add_rn(acc[5], p.ddu);
      }
    }
  }

#pragma unroll
  for (int k = 0; k < 6; ++k) red[ty][k][tx] = acc[k];
  __syncthreads();
  if (ty == 0 && i < n_pad) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      T s = red[0][k][tx];
#pragma unroll
      for (int q = 1; q < kSlicesJ; ++q) s = add_rn(s, red[q][k][tx]);
      out[k * n_pad + i] = live_i ? s : T(0);
    }
    out[6 * n_pad + i] = T(0);
    out[7 * n_pad + i] = T(0);
  }
}

template <typename T, bool OBS_ALL_J>
int launch_pair_rows(const T* pos, T* out, int n, int n_pad, T box, T inv_box, T rc2,
                     int want_obs, void* stream) {
  const dim3 block(kTileI, kSlicesJ);
  const dim3 grid(n_pad / kTileI);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (want_obs) {
    pair_rows_kernel<T, true, OBS_ALL_J><<<grid, block, 0, s>>>(pos, out, n, n_pad, box,
                                                                inv_box, rc2);
  } else {
    pair_rows_kernel<T, false, OBS_ALL_J><<<grid, block, 0, s>>>(pos, out, n, n_pad, box,
                                                                 inv_box, rc2);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ljmd
