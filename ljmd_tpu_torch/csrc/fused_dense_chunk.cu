// Kernels 3, 4 and 8: n_steps of velocity Verlet in ONE launch.
//
// Replaces: ljmd_tpu/ops/pallas_fused.py:537 `fused_dense_chunk`, :465
// `fused_dense_chunk_ext` and :384 `fused_dense_chunk_flags` (one Pallas
// body, `_fused_dense_kernel`, :82, with `extended` and `use_flags`).
// Contract: r, v, a (and r_lo, vc when extended) are (8, n_pad) row
// matrices, rows 3..7 and columns >= n zero; `a` holds real (24-prefactored)
// accelerations consistent with r. Positions are NOT wrapped inside the
// chunk: the caller wraps once afterwards. Extended mode carries two-float
// positions (r + r_lo) and Neumaier-compensated velocities (v + vc), and
// corrects every pair displacement by (lo_i - lo_j), as pallas_fused.py:
// 136-152, 191-197, 259-263 do.
//
// What bounds it on the H100: the same O(n^2) pair arithmetic per step as
// pair_sweep_tri.cu (with flags: the active tiles' pairs), plus one grid-wide
// barrier per step. At n = 500 a step is only ~250k pair evaluations, so the
// barrier and the launch-free step loop are what the fusion buys: no
// per-step kernel launches or host work.
//
// What the design does about that: a cooperative launch of a PERSISTENT
// grid, min(n_pad / 32, the blocks the card keeps resident) blocks of 4 x 32
// threads (4 threads per particle, as in pair_sweep_tri.cu), each taking the
// 32-particle tiles w = blockIdx.x, blockIdx.x + gridDim.x, ... in the same
// order in both phases of a step. Each step is
//   phase 1: drift + first half-kick of the block's particles, writing the
//            NEW positions into the other half of a double buffer;
//   grid barrier (cooperative_groups::this_grid().sync());
//   phase 2: for each of the block's tiles, forces from the new positions
//            of every particle, then the second half-kick.
// Positions are double-buffered: step s reads plane s & 1 and writes the
// other, so a block that runs ahead into the next step's phase 1 (which
// writes the plane of the PREVIOUS step, s & 1) never overwrites positions
// that a slower block still reads in this step's phase 2 (plane (s+1) & 1),
// and it cannot run two steps ahead past the next barrier: one barrier per
// step suffices, however many tiles a block holds. v, a and vc of a particle
// are only ever touched by the one thread that owns it in both phases.
// Forces are summed pair-twice over all j != i with no atomics, in the same
// order at any grid size, so the chunk is deterministic and a capped grid is
// bit-identical to a full one. The two-sums are written with the _rn
// intrinsics (nvcc may not contract or reorder them) and the build never
// uses --use_fast_math. The host wrapper sizes the grid from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor, since a grid barrier over
// blocks that are not co-resident would hang.
//
// Flags (kernel 8): with a non-null `flags`, an (n_pad / tile_i) x
// (n_pad / tile_j) int32 matrix, the pair {i, j} counts only where the
// tile the TPU kernel computes it in is active: flags[it(i) * n_j + jt(j)]
// > 0 for i < j (the TPU kernel is pair-once over the upper triangle), so
// flags[it(j) * n_j + jt(i)] for i > j. Both sides of a pair read the same
// flag, so the forces keep Newton's third law. Any flag > 0 runs the full
// minimum-image body (bits 2 and 4 are ignored, as on the TPU). A block
// skips a staged 128-column chunk none of whose pairs is gated on (the
// decision is block-uniform, so the __syncthreads() stay uniform). The
// flagged kernels are a separate instantiation: the unflagged ones
// (kernels 3 and 4) have no gate in their pair loop.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "lj_pair_terms.cuh"

namespace cg = cooperative_groups;

namespace ljmd {

constexpr int kFusedTileI = 32;
constexpr int kFusedSlicesJ = 4;
constexpr int kFusedTileJ = kFusedTileI * kFusedSlicesJ;

// Neumaier-compensated x += delta (engine.py:176-185, pallas_fused.py:136-144):
// c accumulates the rounding remainder so x + c tracks the exact sum.
template <typename T>
__device__ __forceinline__ void comp_add(T& x, T& c, T delta) {
  const T y = add_rn(delta, c);
  const T t = add_rn(x, y);
  c = abs_(x) >= abs_(y) ? add_rn(sub_rn(x, t), y) : add_rn(sub_rn(y, t), x);
  x = t;
}

template <typename T, bool EXT, bool FLAGS>
__global__ void __launch_bounds__(kFusedTileI * kFusedSlicesJ)
fused_dense_kernel(T* rbuf, T* lobuf, T* v, T* vc, T* a, int n, int n_pad,
                   T box, T inv_box, T rc2, T dt, T half_dt, T half_dt_sq,
                   int n_steps, const int* flags, int tile_i, int tile_j) {
  // rbuf / lobuf hold two (8, n_pad) planes: step s reads plane s & 1 and
  // writes plane (s + 1) & 1. They are written by other blocks during the
  // launch, so they are read through plain (coherent) loads, never __ldg.
  __shared__ T sx[kFusedTileJ], sy[kFusedTileJ], sz[kFusedTileJ];
  __shared__ T slx[EXT ? kFusedTileJ : 1], sly[EXT ? kFusedTileJ : 1],
      slz[EXT ? kFusedTileJ : 1];
  __shared__ T red[kFusedSlicesJ][3][kFusedTileI];

  cg::grid_group grid = cg::this_grid();
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int n_tiles = n_pad / kFusedTileI;
  const int n_j = FLAGS ? n_pad / tile_j : 0;
  const size_t plane = static_cast<size_t>(8) * n_pad;

  for (int s = 0; s < n_steps; ++s) {
    const T* r_cur = rbuf + (s & 1) * plane;
    T* r_new = rbuf + ((s + 1) & 1) * plane;
    const T* lo_cur = EXT ? lobuf + (s & 1) * plane : nullptr;
    T* lo_new = EXT ? lobuf + ((s + 1) & 1) * plane : nullptr;

    // Phase 1: position update + first half-kick (verlet.f90:58-74).
    for (int w = blockIdx.x; w < n_tiles; w += gridDim.x) {
      const int i = w * kFusedTileI + tx;
      if (i >= n || ty != 0) continue;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int k = c * n_pad + i;
        if (EXT) {
          const T delta = add_rn(mul_rn(add_rn(v[k], vc[k]), dt), mul_rn(a[k], half_dt_sq));
          T x = r_cur[k];
          T lo = lo_cur[k];
          comp_add(x, lo, delta);
          r_new[k] = x;
          lo_new[k] = lo;
          T vk = v[k];
          T ck = vc[k];
          comp_add(vk, ck, mul_rn(a[k], half_dt));
          v[k] = vk;
          vc[k] = ck;
        } else {
          r_new[k] = add_rn(add_rn(r_cur[k], mul_rn(v[k], dt)), mul_rn(a[k], half_dt_sq));
          v[k] = add_rn(v[k], mul_rn(a[k], half_dt));
        }
      }
    }
    grid.sync();

    // Phase 2: forces at the new positions (all j != i), pair-twice.
    for (int w = blockIdx.x; w < n_tiles; w += gridDim.x) {
      const int i0 = w * kFusedTileI;
      const int i = i0 + tx;
      const bool live_i = i < n;
      const T xi = live_i ? r_new[i] : T(0);
      const T yi = live_i ? r_new[n_pad + i] : T(0);
      const T zi = live_i ? r_new[2 * n_pad + i] : T(0);
      T xli = T(0), yli = T(0), zli = T(0);
      if (EXT && live_i) {
        xli = lo_new[i];
        yli = lo_new[n_pad + i];
        zli = lo_new[2 * n_pad + i];
      }
      T fx = T(0), fy = T(0), fz = T(0);
      for (int j0 = 0; j0 < n; j0 += kFusedTileJ) {
        // The TPU tile of the pair: (it(i), jt(j)) forward (j > i), (it(j),
        // jt(i)) backward (j < i); one value each over the 32 x 128 chunk
        // (32 and 128 divide tile_i and tile_j). A chunk none of whose pairs
        // is gated on is skipped whole, staging included: the decision is
        // the same for every thread of the block, so the __syncthreads()
        // below stay uniform.
        bool fwd = true, bwd = true;
        if (FLAGS) {
          fwd = j0 + kFusedTileJ - 1 > i0 && flags[(i0 / tile_i) * n_j + j0 / tile_j] > 0;
          bwd = j0 < i0 + kFusedTileI - 1 && flags[(j0 / tile_i) * n_j + i0 / tile_j] > 0;
          if (!fwd && !bwd) continue;
        }
        const int t = ty * kFusedTileI + tx;
        const int jl = j0 + t;
        __syncthreads();
        sx[t] = jl < n ? r_new[jl] : T(0);
        sy[t] = jl < n ? r_new[n_pad + jl] : T(0);
        sz[t] = jl < n ? r_new[2 * n_pad + jl] : T(0);
        if (EXT) {
          slx[t] = jl < n ? lo_new[jl] : T(0);
          sly[t] = jl < n ? lo_new[n_pad + jl] : T(0);
          slz[t] = jl < n ? lo_new[2 * n_pad + jl] : T(0);
        }
        __syncthreads();
        const int jend = min(kFusedTileJ, n - j0);
        for (int jj = ty; jj < jend; jj += kFusedSlicesJ) {
          const int j = j0 + jj;
          T dx = sub_rn(xi, sx[jj]);
          T dy = sub_rn(yi, sy[jj]);
          T dz = sub_rn(zi, sz[jj]);
          if (EXT) {
            dx = add_rn(dx, sub_rn(xli, slx[jj]));
            dy = add_rn(dy, sub_rn(yli, sly[jj]));
            dz = add_rn(dz, sub_rn(zli, slz[jj]));
          }
          dx = min_image(dx, box, inv_box);
          dy = min_image(dy, box, inv_box);
          dz = min_image(dz, box, inv_box);
          const T r2 = add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz));
          bool mask = live_i && (j != i) && (r2 < rc2);
          if (FLAGS) mask = mask && (j > i ? fwd : bwd);
          const PairTerms<T> p = lj_pair_terms<T, false>(r2, mask);
          fx = add_rn(fx, mul_rn(p.coef, dx));
          fy = add_rn(fy, mul_rn(p.coef, dy));
          fz = add_rn(fz, mul_rn(p.coef, dz));
        }
      }
      __syncthreads();  // the previous tile's owners have read `red`
      red[ty][0][tx] = fx;
      red[ty][1][tx] = fy;
      red[ty][2][tx] = fz;
      __syncthreads();

      // a = 24 * raw sweep (lj_potential_energy.f90:192) + second half-kick.
      if (live_i && ty == 0) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          T f = red[0][c][tx];
#pragma unroll
          for (int q = 1; q < kFusedSlicesJ; ++q) f = add_rn(f, red[q][c][tx]);
          const int k = c * n_pad + i;
          const T ak = mul_rn(T(24), f);
          a[k] = ak;
          if (EXT) {
            T vk = v[k];
            T ck = vc[k];
            comp_add(vk, ck, mul_rn(ak, half_dt));
            v[k] = vk;
            vc[k] = ck;
          } else {
            v[k] = add_rn(v[k], mul_rn(ak, half_dt));
          }
        }
      }
    }
    // The next step's phase 1 touches only this thread's own v / a and the
    // other position plane; the shared tiles are guarded by the
    // __syncthreads() at the top of the j loop.
  }
}

template <typename T, bool EXT, bool FLAGS>
int max_coresident_blocks(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_dense_kernel<T, EXT, FLAGS>, kFusedTileI * kFusedSlicesJ, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *out = per_sm * sms;
  return 0;
}

template <typename T, bool EXT>
int launch_fused(T* rbuf, T* lobuf, T* v, T* vc, T* a, int n, int n_pad, T box,
                 T inv_box, T rc2, T dt, T half_dt, T half_dt_sq, int n_steps,
                 const int* flags, int tile_i, int tile_j, int blocks,
                 void* stream) {
  void* args[] = {&rbuf,       &lobuf,   &v,     &vc,     &a,      &n,
                  &n_pad,      &box,     &inv_box, &rc2,  &dt,     &half_dt,
                  &half_dt_sq, &n_steps, &flags, &tile_i, &tile_j};
  const dim3 block(kFusedTileI, kFusedSlicesJ);
  const dim3 grid(blocks);
  const void* fn = flags ? reinterpret_cast<const void*>(fused_dense_kernel<T, EXT, true>)
                         : reinterpret_cast<const void*>(fused_dense_kernel<T, EXT, false>);
  cudaError_t err = cudaLaunchCooperativeKernel(fn, grid, block, args, 0,
                                                static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the sticky launch error
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ljmd

extern "C" {

int ljmd_fused_tile_cols() { return ljmd::kFusedTileI; }

// Largest grid (in blocks) that can be co-resident for the given variant.
int ljmd_fused_max_blocks(int dtype_bytes, int extended, int flagged, int* out) {
  using ljmd::max_coresident_blocks;
  if (dtype_bytes == 4) {
    if (flagged) {
      return extended ? max_coresident_blocks<float, true, true>(out)
                      : max_coresident_blocks<float, false, true>(out);
    }
    return extended ? max_coresident_blocks<float, true, false>(out)
                    : max_coresident_blocks<float, false, false>(out);
  }
  if (flagged) {
    return extended ? max_coresident_blocks<double, true, true>(out)
                    : max_coresident_blocks<double, false, true>(out);
  }
  return extended ? max_coresident_blocks<double, true, false>(out)
                  : max_coresident_blocks<double, false, false>(out);
}

// `blocks` (1 .. n_pad / 32, at most ljmd_fused_max_blocks) is the
// persistent grid; `flags` null runs every pair (kernels 3 and 4).
int ljmd_fused_dense_chunk_f32(float* rbuf, float* lobuf, float* v, float* vc,
                               float* a, int n, int n_pad, float box,
                               float inv_box, float rc2, float dt,
                               float half_dt, float half_dt_sq, int n_steps,
                               int extended, const int* flags, int tile_i,
                               int tile_j, int blocks, void* stream) {
  return extended
             ? ljmd::launch_fused<float, true>(rbuf, lobuf, v, vc, a, n, n_pad, box, inv_box, rc2, dt, half_dt, half_dt_sq, n_steps, flags, tile_i, tile_j, blocks, stream)
             : ljmd::launch_fused<float, false>(rbuf, lobuf, v, vc, a, n, n_pad, box, inv_box, rc2, dt, half_dt, half_dt_sq, n_steps, flags, tile_i, tile_j, blocks, stream);
}

int ljmd_fused_dense_chunk_f64(double* rbuf, double* lobuf, double* v,
                               double* vc, double* a, int n, int n_pad,
                               double box, double inv_box, double rc2,
                               double dt, double half_dt, double half_dt_sq,
                               int n_steps, int extended, const int* flags,
                               int tile_i, int tile_j, int blocks,
                               void* stream) {
  return extended
             ? ljmd::launch_fused<double, true>(rbuf, lobuf, v, vc, a, n, n_pad, box, inv_box, rc2, dt, half_dt, half_dt_sq, n_steps, flags, tile_i, tile_j, blocks, stream)
             : ljmd::launch_fused<double, false>(rbuf, lobuf, v, vc, a, n, n_pad, box, inv_box, rc2, dt, half_dt, half_dt_sq, n_steps, flags, tile_i, tile_j, blocks, stream);
}

}  // extern "C"
