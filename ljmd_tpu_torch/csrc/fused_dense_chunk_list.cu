// Kernel 10: n_steps of velocity Verlet over the window visit lists, in ONE
// launch.
//
// Replaces: ljmd_tpu/ops/pallas_fused.py:1383 `fused_dense_chunk_list` (its
// Pallas body `_fused_dense_list_kernel`, :1023) under the window contract
// the zsort engine uses (j_granule = tile_i = 128, four categories, per-width
// tail lists, jmin prefix mask), in its plain, extended (r_lo / vc) and
// obs_last modes. Contract: r, v, a (and r_lo, vc when extended) are
// (8, n_pad) row matrices in sorted column order, rows 3..7 and columns >= n
// zero, `a` 24-prefactored and consistent with r; no wrap inside the chunk.
// A pair contributes iff some visit covers it un-masked:
//   category 0 "free"   mask-free, no x and no z minimum-image round;
//   category 1 "x-only" mask-free, no z round;
//   category 2 "full"   mask-free, all three rounds;
//   category 3 "masked" all rounds, gj > gi, gj < n, gi < n, gj >= jmin*128;
//   tails (width w*128) all rounds, gj > gi, gj < n, gi < n.
// obs_last: the last step also sums the pair-once e/du/ddu partials of each
// visit's i side into rows 3..5 of `obs` (the caller restores 4 / 24).
//
// What bounds it on the H100: the pair arithmetic of the listed windows
// (about 4.5M pair-once candidates per step at N = 4000, against the dense
// kernel's 8M), plus one grid barrier per step.
//
// What the design does about that: a cooperative launch of a persistent
// grid, min(n_pad / 32, the blocks the card keeps resident) blocks of 4 x 32
// threads, each taking the 32-particle tiles w = blockIdx.x, blockIdx.x +
// gridDim.x, ... in the same order in both phases of a step (4 threads per
// particle, one per j-slice), as in fused_dense_chunk.cu. The TPU kernel scatters each visit's j-side reactions
// into an accumulator that one sequential program owns; CUDA blocks run in
// parallel, so here every listed window is evaluated from both sides
// instead: a block walks all visits (the counts are read on the device) and
// takes each visit whose i-block is its own block ("forward": partners are
// the visit's j columns) and each visit whose j columns contain its block
// ("backward": partners are the visit's 128 i-rows, with the masks read from
// the other side). Forces are summed pair-twice, observables forward only,
// with no atomics, so the chunk is deterministic and only one grid barrier
// per step is needed: v, a and the forces of a particle are only ever
// written by its own thread. fl(xi - xj) = -fl(xj - xi) and rint is
// symmetric, so both sides see the same pair values as the TPU kernel; only
// the summation order differs, and it does not depend on the grid size.
// Positions are double-buffered as in fused_dense_chunk.cu; the wrapper sizes
// the grid from the occupancy API.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "lj_pair_terms.cuh"

namespace cg = cooperative_groups;

namespace ljmd {

constexpr int kListTileI = 32;    // particles of one block
constexpr int kListSlices = 4;    // j-slices (threads) per particle
constexpr int kListStage = kListTileI * kListSlices;  // partners staged at once
constexpr int kListGran = 128;    // block granule of the lists (tile_i)

template <typename T, bool EXT>
struct ListArgs {
  T* rbuf;
  T* lobuf;
  T* v;
  T* vc;
  T* a;
  T* obs;
  const int* tiles;
  const int* tcounts;
  int max_t;
  int n_tails;
  int span;
  int n;
  int n_pad;
  T box;
  T inv_box;
  T rc2;
  T dt;
  T half_dt;
  T half_dt_sq;
  int n_steps;
  int obs_last;
};

template <typename T, bool EXT>
struct Shared {
  T x[kListStage], y[kListStage], z[kListStage];
  T lx[EXT ? kListStage : 1], ly[EXT ? kListStage : 1], lz[EXT ? kListStage : 1];
  T red[kListSlices][6][kListTileI];
};

template <typename T>
struct Acc {
  T fx, fy, fz, e, du, ddu;
};

// Partners [q0, q0 + len) of particle gi (this thread's), staged 128 at a
// time. FORWARD: gi is the visit's i side (partner q its j column);
// otherwise gi is the j side. The masks are the visit's, read from gi's side.
template <typename T, bool EXT, bool OBS>
__device__ void visit_segment(const ListArgs<T, EXT>& p, Shared<T, EXT>& sh,
                              const T* r_new, const T* lo_new, int gi, T xi,
                              T yi, T zi, T xli, T yli, T zli, int q0, int len,
                              bool forward, bool masked, int jmin_col,
                              bool mic_x, bool mic_z, Acc<T>& acc) {
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int t = ty * kListTileI + tx;
  const size_t n_pad = p.n_pad;
  for (int c0 = q0; c0 < q0 + len; c0 += kListStage) {
    __syncthreads();
    const int q = c0 + t;  // < n_pad: visits lie inside [0, n_pad)
    sh.x[t] = r_new[q];
    sh.y[t] = r_new[n_pad + q];
    sh.z[t] = r_new[2 * n_pad + q];
    if (EXT) {
      sh.lx[t] = lo_new[q];
      sh.ly[t] = lo_new[n_pad + q];
      sh.lz[t] = lo_new[2 * n_pad + q];
    }
    __syncthreads();
    for (int jj = ty; jj < kListStage; jj += kListSlices) {
      const int gq = c0 + jj;
      T dx = sub_rn(xi, sh.x[jj]);
      T dy = sub_rn(yi, sh.y[jj]);
      T dz = sub_rn(zi, sh.z[jj]);
      if (EXT) {
        dx = add_rn(dx, sub_rn(xli, sh.lx[jj]));
        dy = add_rn(dy, sub_rn(yli, sh.ly[jj]));
        dz = add_rn(dz, sub_rn(zli, sh.lz[jj]));
      }
      if (mic_x) dx = min_image(dx, p.box, p.inv_box);
      dy = min_image(dy, p.box, p.inv_box);
      if (mic_z) dz = min_image(dz, p.box, p.inv_box);
      const T r2 = add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz));
      bool m = r2 < p.rc2;
      if (masked) {
        // (row side, column side) = (gi, gq) forward, (gq, gi) backward.
        const int gr = forward ? gi : gq;
        const int gc = forward ? gq : gi;
        m = m && (gc > gr) && (gc < p.n) && (gr < p.n) && (gc >= jmin_col);
      }
      const PairTerms<T> pt = lj_pair_terms<T, OBS>(r2, m);
      acc.fx = add_rn(acc.fx, mul_rn(pt.coef, dx));
      acc.fy = add_rn(acc.fy, mul_rn(pt.coef, dy));
      acc.fz = add_rn(acc.fz, mul_rn(pt.coef, dz));
      if (OBS && forward) {
        acc.e = add_rn(acc.e, pt.e);
        acc.du = add_rn(acc.du, pt.du);
        acc.ddu = add_rn(acc.ddu, pt.ddu);
      }
    }
  }
}

// Every visit that touches this block's 32 particles, both sides.
template <typename T, bool EXT, bool OBS>
__device__ void list_forces(const ListArgs<T, EXT>& p, Shared<T, EXT>& sh,
                            const T* r_new, const T* lo_new, int w, int gi, T xi,
                            T yi, T zi, T xli, T yli, T zli, Acc<T>& acc) {
  const int my_blk = (w * kListTileI) / kListGran;
  const int n_cats = 4 + p.n_tails;
  for (int cat = 0; cat < n_cats; ++cat) {
    const int cnt = p.tcounts[cat];
    const int lrow = cat < 4 ? 2 * cat : 9 + 2 * (cat - 4);
    const int wb = cat < 4 ? p.span : cat - 3;  // width in blocks
    const bool masked = cat >= 3;
    const bool mic_x = cat != 0;
    const bool mic_z = cat >= 2;
    for (int t = 0; t < cnt; ++t) {
      const int ib = p.tiles[static_cast<size_t>(lrow) * p.max_t + t];
      const int jb = p.tiles[static_cast<size_t>(lrow + 1) * p.max_t + t];
      const int jmin_col = cat == 3 ? p.tiles[static_cast<size_t>(8) * p.max_t + t] * kListGran : 0;
      if (ib == my_blk) {
        visit_segment<T, EXT, OBS>(p, sh, r_new, lo_new, gi, xi, yi, zi, xli, yli, zli,
                                   jb * kListGran, wb * kListGran, true, masked,
                                   jmin_col, mic_x, mic_z, acc);
      }
      if (my_blk >= jb && my_blk < jb + wb) {
        visit_segment<T, EXT, OBS>(p, sh, r_new, lo_new, gi, xi, yi, zi, xli, yli, zli,
                                   ib * kListGran, kListGran, false, masked,
                                   jmin_col, mic_x, mic_z, acc);
      }
    }
  }
}

// Neumaier-compensated x += delta (as fused_dense_chunk.cu).
template <typename T>
__device__ __forceinline__ void comp_add_list(T& x, T& c, T delta) {
  const T y = add_rn(delta, c);
  const T t = add_rn(x, y);
  c = abs_(x) >= abs_(y) ? add_rn(sub_rn(x, t), y) : add_rn(sub_rn(y, t), x);
  x = t;
}

template <typename T, bool EXT>
__global__ void __launch_bounds__(kListTileI * kListSlices)
fused_list_kernel(ListArgs<T, EXT> p) {
  // rbuf / lobuf hold two (8, n_pad) planes: step s reads plane s & 1 and
  // writes plane (s + 1) & 1; other blocks write them during the launch, so
  // they are read through plain loads, never __ldg.
  __shared__ Shared<T, EXT> sh;
  cg::grid_group grid = cg::this_grid();
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int n_tiles = p.n_pad / kListTileI;
  const size_t n_pad = p.n_pad;
  const size_t plane = 8 * n_pad;

  for (int s = 0; s < p.n_steps; ++s) {
    const T* r_cur = p.rbuf + (s & 1) * plane;
    T* r_new = p.rbuf + ((s + 1) & 1) * plane;
    const T* lo_cur = EXT ? p.lobuf + (s & 1) * plane : nullptr;
    T* lo_new = EXT ? p.lobuf + ((s + 1) & 1) * plane : nullptr;

    // Phase 1: drift + first half-kick of the block's own particles.
    for (int w = blockIdx.x; w < n_tiles; w += gridDim.x) {
      const int i = w * kListTileI + tx;
      if (i >= p.n || ty != 0) continue;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const size_t k = c * n_pad + i;
        if (EXT) {
          const T delta = add_rn(mul_rn(add_rn(p.v[k], p.vc[k]), p.dt), mul_rn(p.a[k], p.half_dt_sq));
          T x = r_cur[k];
          T lo = lo_cur[k];
          comp_add_list(x, lo, delta);
          r_new[k] = x;
          lo_new[k] = lo;
          T vk = p.v[k];
          T ck = p.vc[k];
          comp_add_list(vk, ck, mul_rn(p.a[k], p.half_dt));
          p.v[k] = vk;
          p.vc[k] = ck;
        } else {
          r_new[k] = add_rn(add_rn(r_cur[k], mul_rn(p.v[k], p.dt)), mul_rn(p.a[k], p.half_dt_sq));
          p.v[k] = add_rn(p.v[k], mul_rn(p.a[k], p.half_dt));
        }
      }
    }
    grid.sync();

    // Phase 2: forces over the visit lists at the new positions.
    const bool want_obs = p.obs_last && s == p.n_steps - 1;
    for (int w = blockIdx.x; w < n_tiles; w += gridDim.x) {
      const int i = w * kListTileI + tx;
      const bool owner = i < p.n && ty == 0;
      const T xi = r_new[i];
      const T yi = r_new[n_pad + i];
      const T zi = r_new[2 * n_pad + i];
      T xli = T(0), yli = T(0), zli = T(0);
      if (EXT) {
        xli = lo_new[i];
        yli = lo_new[n_pad + i];
        zli = lo_new[2 * n_pad + i];
      }
      Acc<T> acc = {T(0), T(0), T(0), T(0), T(0), T(0)};
      if (want_obs) {
        list_forces<T, EXT, true>(p, sh, r_new, lo_new, w, i, xi, yi, zi, xli, yli, zli, acc);
      } else {
        list_forces<T, EXT, false>(p, sh, r_new, lo_new, w, i, xi, yi, zi, xli, yli, zli, acc);
      }
      __syncthreads();
      sh.red[ty][0][tx] = acc.fx;
      sh.red[ty][1][tx] = acc.fy;
      sh.red[ty][2][tx] = acc.fz;
      sh.red[ty][3][tx] = acc.e;
      sh.red[ty][4][tx] = acc.du;
      sh.red[ty][5][tx] = acc.ddu;
      __syncthreads();

      // a = 24 * raw sweep + second half-kick; obs rows 3..5 on the last step.
      if (owner) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          T f = sh.red[0][c][tx];
#pragma unroll
          for (int q = 1; q < kListSlices; ++q) f = add_rn(f, sh.red[q][c][tx]);
          const size_t k = c * n_pad + i;
          const T ak = mul_rn(T(24), f);
          p.a[k] = ak;
          if (EXT) {
            T vk = p.v[k];
            T ck = p.vc[k];
            comp_add_list(vk, ck, mul_rn(ak, p.half_dt));
            p.v[k] = vk;
            p.vc[k] = ck;
          } else {
            p.v[k] = add_rn(p.v[k], mul_rn(ak, p.half_dt));
          }
          if (want_obs) {
            T o = sh.red[0][3 + c][tx];
#pragma unroll
            for (int q = 1; q < kListSlices; ++q) o = add_rn(o, sh.red[q][3 + c][tx]);
            p.obs[(3 + c) * n_pad + i] = o;
          }
        }
      }
      __syncthreads();  // the owners have read sh.red before the next tile
    }
  }
}

template <typename T, bool EXT>
int max_coresident_list_blocks(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_list_kernel<T, EXT>, kListTileI * kListSlices, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *out = per_sm * sms;
  return 0;
}

template <typename T, bool EXT>
int launch_list(T* rbuf, T* lobuf, T* v, T* vc, T* a, T* obs, const int* tiles,
                const int* tcounts, int max_t, int n_tails, int span, int n,
                int n_pad, T box, T inv_box, T rc2, T dt, T half_dt,
                T half_dt_sq, int n_steps, int obs_last, int blocks, void* stream) {
  ListArgs<T, EXT> p{rbuf, lobuf, v, vc, a, obs, tiles, tcounts, max_t, n_tails,
                     span, n, n_pad, box, inv_box, rc2, dt, half_dt, half_dt_sq,
                     n_steps, obs_last};
  void* args[] = {&p};
  const dim3 block(kListTileI, kListSlices);
  const dim3 grid(blocks);
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fused_list_kernel<T, EXT>), grid, block,
      args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the launch error
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ljmd

extern "C" {

int ljmd_list_tile_cols() { return ljmd::kListTileI; }

int ljmd_list_max_blocks(int dtype_bytes, int extended, int* out) {
  if (dtype_bytes == 4) {
    return extended ? ljmd::max_coresident_list_blocks<float, true>(out)
                    : ljmd::max_coresident_list_blocks<float, false>(out);
  }
  return extended ? ljmd::max_coresident_list_blocks<double, true>(out)
                  : ljmd::max_coresident_list_blocks<double, false>(out);
}

int ljmd_fused_dense_chunk_list_f32(float* rbuf, float* lobuf, float* v,
                                    float* vc, float* a, float* obs,
                                    const int* tiles, const int* tcounts,
                                    int max_t, int n_tails, int span, int n,
                                    int n_pad, float box, float inv_box,
                                    float rc2, float dt, float half_dt,
                                    float half_dt_sq, int n_steps, int obs_last,
                                    int extended, int blocks, void* stream) {
  return extended
             ? ljmd::launch_list<float, true>(rbuf, lobuf, v, vc, a, obs, tiles, tcounts, max_t, n_tails, span, n, n_pad, box, inv_box, rc2, dt, half_dt, half_dt_sq, n_steps, obs_last, blocks, stream)
             : ljmd::launch_list<float, false>(rbuf, lobuf, v, vc, a, obs, tiles, tcounts, max_t, n_tails, span, n, n_pad, box, inv_box, rc2, dt, half_dt, half_dt_sq, n_steps, obs_last, blocks, stream);
}

int ljmd_fused_dense_chunk_list_f64(double* rbuf, double* lobuf, double* v,
                                    double* vc, double* a, double* obs,
                                    const int* tiles, const int* tcounts,
                                    int max_t, int n_tails, int span, int n,
                                    int n_pad, double box, double inv_box,
                                    double rc2, double dt, double half_dt,
                                    double half_dt_sq, int n_steps,
                                    int obs_last, int extended, int blocks,
                                    void* stream) {
  return extended
             ? ljmd::launch_list<double, true>(rbuf, lobuf, v, vc, a, obs, tiles, tcounts, max_t, n_tails, span, n, n_pad, box, inv_box, rc2, dt, half_dt, half_dt_sq, n_steps, obs_last, blocks, stream)
             : ljmd::launch_list<double, false>(rbuf, lobuf, v, vc, a, obs, tiles, tcounts, max_t, n_tails, span, n, n_pad, box, inv_box, rc2, dt, half_dt, half_dt_sq, n_steps, obs_last, blocks, stream);
}

}  // extern "C"
