// Kernels 15 and 16: n_steps of velocity Verlet over the half-shell pencil
// pairs in ONE launch, every pencil at full capacity (from the tables) or
// every visit at its pencils' active width (from the width lists), each in
// its plain and its extended (two-float r / r_lo, Neumaier v / vc) mode.
//
// Replaces: ljmd_tpu/ops/pallas_pencil_fused.py:277 `fused_pencil_chunk` (its
// Pallas body `_pencil_fused_kernel`, :85) and :609 `fused_pencil_width_chunk`
// (`_pencil_width_kernel`, :451). Contract: r, v, a (and r_lo, vc) are
// (8, ns) slot matrices, row 3 of r the validity, row 4 the ids, v = a = 0
// (and r_lo = vc = 0) on the sentinel slots, `a` 24-prefactored and
// consistent with r; no wrap inside the chunk. Each step: drift and first
// half-kick (r + v dt + a dt^2/2 in the TPU kernel's order; extended: the
// two-float position update with (v + vc) dt), the half-shell forces at the
// new positions, a = (24 f) * validity (so sentinels never move), second
// half-kick. Extended pairs are corrected by lo_i - lo_j, the image shift
// applied to the hi part only.
//
// What bounds it on the H100: the pair arithmetic (pencil_pairs.cuh: every
// pair evaluated from both sides; full capacity: 2 * 4.5 * cap candidates per
// slot and step, width lists: the active widths instead), plus one grid
// barrier per step.
//
// What the design does about that: a cooperative launch of a PERSISTENT grid,
// as many 128-thread blocks as the card keeps resident (the wrapper asks the
// occupancy API; 3136 blocks of one 32-slot tile each would not fit at
// N = 62500), each looping over the 32-slot work items w = blockIdx.x,
// blockIdx.x + gridDim.x, ... in the same order in both phases of a step.
// So a slot's v and a are written (phase 2) and read (phase 1 of the next
// step) by one thread, and one grid barrier per step suffices: positions are
// double-buffered, step s reading plane s & 1 and writing the other (rows
// 3..7 sit in both planes). Tiles whose first slot is empty (slots are packed
// rank-first) skip the force phase. The width lists are read on the device:
// a work item walks every list and takes the visits that touch its 128-slot
// block from either side. Pair-twice with no atomics keeps the chunk
// deterministic.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "pencil_pairs.cuh"

namespace cg = cooperative_groups;

namespace ljmd {

template <typename T>
struct PenChunkArgs {
  T* rbuf;   // (2, 8, ns): position planes
  T* lobuf;  // (2, 8, ns): remainder planes (extended)
  T* v;
  T* vc;
  T* a;
  const int* tbl;
  const int* shf;
  PenLists wl;
  int n_pencils;
  int cap;
  T box;
  T inv_box;
  T rc2;
  T dt;
  T half_dt;
  T half_dt_sq;
  int n_steps;
};

// Neumaier-compensated x += delta (as fused_dense_chunk.cu).
template <typename T>
__device__ __forceinline__ void pen_comp_add(T& x, T& c, T delta) {
  const T y = add_rn(delta, c);
  const T t = add_rn(x, y);
  c = abs_(x) >= abs_(y) ? add_rn(sub_rn(x, t), y) : add_rn(sub_rn(y, t), x);
  x = t;
}

template <typename T, bool EXT, bool WIDTH>
__global__ void __launch_bounds__(kPenStage) fused_pencil_kernel(PenChunkArgs<T> p) {
  __shared__ PenStage<T, EXT> sh;
  __shared__ T red[kPenSlices][3][kPenTile];
  __shared__ int lower[4];
  cg::grid_group grid = cg::this_grid();
  const size_t ns = static_cast<size_t>(p.n_pencils) * p.cap;
  const size_t plane = 8 * ns;
  const int n_work = static_cast<int>(ns / kPenTile);
  const bool owner = threadIdx.y == 0;

  for (int s = 0; s < p.n_steps; ++s) {
    const T* r_cur = p.rbuf + (s & 1) * plane;
    T* r_new = p.rbuf + ((s + 1) & 1) * plane;
    const T* lo_cur = EXT ? p.lobuf + (s & 1) * plane : nullptr;
    T* lo_new = EXT ? p.lobuf + ((s + 1) & 1) * plane : nullptr;

    // Phase 1: drift + first half-kick of every slot of the block's items.
    if (owner) {
      for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
        const size_t g = static_cast<size_t>(w) * kPenTile + threadIdx.x;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const size_t k = c * ns + g;
          if (EXT) {
            const T delta = add_rn(mul_rn(add_rn(p.v[k], p.vc[k]), p.dt),
                                   mul_rn(p.a[k], p.half_dt_sq));
            T x = r_cur[k];
            T lo = lo_cur[k];
            pen_comp_add(x, lo, delta);
            r_new[k] = x;
            lo_new[k] = lo;
            T vk = p.v[k];
            T ck = p.vc[k];
            pen_comp_add(vk, ck, mul_rn(p.a[k], p.half_dt));
            p.v[k] = vk;
            p.vc[k] = ck;
          } else {
            r_new[k] = add_rn(add_rn(r_cur[k], mul_rn(p.v[k], p.dt)),
                              mul_rn(p.a[k], p.half_dt_sq));
            p.v[k] = add_rn(p.v[k], mul_rn(p.a[k], p.half_dt));
          }
        }
      }
    }
    grid.sync();

    // Phase 2: forces at the new positions, a = 24 f * valid, second kick.
    const PenGeom<T> geo{r_new, lo_new, ns, p.n_pencils, p.cap, p.box, p.inv_box, p.rc2};
    for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
      const int s0 = w * kPenTile;
      if (r_new[3 * ns + s0] == T(0)) continue;  // the whole tile is empty
      const int g = s0 + threadIdx.x;
      PenSlot<T> me{g, r_new[g], r_new[ns + g], r_new[2 * ns + g], T(0), T(0), T(0)};
      if (EXT) {
        me.lx = lo_new[g];
        me.ly = lo_new[ns + g];
        me.lz = lo_new[2 * ns + g];
      }
      PenAcc<T> acc = {T(0), T(0), T(0), T(0), T(0), T(0)};
      if (WIDTH) {
        pen_width_pairs<T, EXT>(geo, sh, me, s0 / kPenGran, p.wl, acc);
      } else {
        const int q = s0 / p.cap;
        pen_lower(p.tbl, p.n_pencils, q, lower);
        __syncthreads();
        pen_table_pairs<T, EXT, false>(geo, sh, me, q, true, lower, p.tbl, p.shf, nullptr,
                                               acc);
      }
      pen_reduce<T, 3>(red, acc);
      if (owner) {
        const T valid = r_new[3 * ns + g];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const size_t k = c * ns + g;
          const T ak = mul_rn(mul_rn(T(24), pen_sum<T, 3>(red, c)), valid);
          p.a[k] = ak;
          if (EXT) {
            T vk = p.v[k];
            T ck = p.vc[k];
            pen_comp_add(vk, ck, mul_rn(ak, p.half_dt));
            p.v[k] = vk;
            p.vc[k] = ck;
          } else {
            p.v[k] = add_rn(p.v[k], mul_rn(ak, p.half_dt));
          }
        }
      }
    }
  }
}

template <typename T, bool EXT, bool WIDTH>
int pencil_max_blocks(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_pencil_kernel<T, EXT, WIDTH>,
                                                      kPenStage, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *out = per_sm * sms;
  return 0;
}

template <typename T, bool EXT, bool WIDTH>
int launch_chunk(const PenChunkArgs<T>& p, int grid_blocks, void* stream) {
  PenChunkArgs<T> args = p;
  void* kargs[] = {&args};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fused_pencil_kernel<T, EXT, WIDTH>), dim3(grid_blocks),
      dim3(kPenTile, kPenSlices), kargs, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the launch error
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_chunk_any(T* rbuf, T* lobuf, T* v, T* vc, T* a, const int* tbl, const int* shf,
                     const int* wls, const int* wlc, const int* wni, const int* wnj,
                     const int* wno, int width, int n_pencils, int cap, T box, T inv_box, T rc2,
                     T dt, T half_dt, T half_dt_sq, int n_steps, int extended, int grid_blocks,
                     void* stream) {
  const PenChunkArgs<T> p{rbuf, lobuf, v, vc, a, tbl, shf, PenLists{wls, wlc, wni, wnj, wno},
                          n_pencils, cap, box, inv_box, rc2, dt, half_dt, half_dt_sq, n_steps};
  if (width) {
    return extended ? launch_chunk<T, true, true>(p, grid_blocks, stream)
                    : launch_chunk<T, false, true>(p, grid_blocks, stream);
  }
  return extended ? launch_chunk<T, true, false>(p, grid_blocks, stream)
                  : launch_chunk<T, false, false>(p, grid_blocks, stream);
}

}  // namespace ljmd

extern "C" {

int ljmd_pencil_tile_slots() { return ljmd::kPenTile; }

int ljmd_pencil_max_blocks(int dtype_bytes, int extended, int width, int* out) {
  using ljmd::pencil_max_blocks;
  if (dtype_bytes == 4) {
    if (width) {
      return extended ? pencil_max_blocks<float, true, true>(out)
                      : pencil_max_blocks<float, false, true>(out);
    }
    return extended ? pencil_max_blocks<float, true, false>(out)
                    : pencil_max_blocks<float, false, false>(out);
  }
  if (width) {
    return extended ? pencil_max_blocks<double, true, true>(out)
                    : pencil_max_blocks<double, false, true>(out);
  }
  return extended ? pencil_max_blocks<double, true, false>(out)
                  : pencil_max_blocks<double, false, false>(out);
}

int ljmd_fused_pencil_chunk_f32(float* rbuf, float* lobuf, float* v, float* vc, float* a,
                                const int* tbl, const int* shf, const int* wls, const int* wlc,
                                const int* wni, const int* wnj, const int* wno, int width,
                                int n_pencils, int cap, float box, float inv_box, float rc2,
                                float dt, float half_dt, float half_dt_sq, int n_steps,
                                int extended, int grid_blocks, void* stream) {
  return ljmd::launch_chunk_any<float>(rbuf, lobuf, v, vc, a, tbl, shf, wls, wlc, wni, wnj, wno,
                                       width, n_pencils, cap, box, inv_box, rc2, dt, half_dt,
                                       half_dt_sq, n_steps, extended, grid_blocks, stream);
}

int ljmd_fused_pencil_chunk_f64(double* rbuf, double* lobuf, double* v, double* vc, double* a,
                                const int* tbl, const int* shf, const int* wls, const int* wlc,
                                const int* wni, const int* wnj, const int* wno, int width,
                                int n_pencils, int cap, double box, double inv_box, double rc2,
                                double dt, double half_dt, double half_dt_sq, int n_steps,
                                int extended, int grid_blocks, void* stream) {
  return ljmd::launch_chunk_any<double>(rbuf, lobuf, v, vc, a, tbl, shf, wls, wlc, wni, wnj,
                                        wno, width, n_pencils, cap, box, inv_box, rc2, dt,
                                        half_dt, half_dt_sq, n_steps, extended, grid_blocks,
                                        stream);
}

}  // extern "C"
