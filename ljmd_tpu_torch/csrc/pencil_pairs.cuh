// Device code shared by the cell-pair kernels: the slot, accumulator and
// geometry types; the i-side segment of the full 9-neighbour sweep
// (pencil_sweep_full.cu); the fused chunks' per-slot Verlet updates
// (fused_pencil_chunk.cu, fused_pencil_width_chunk.cu). The culled stage
// loops of the half-shell kernels and the z-band are in pencil_cull.cuh.
//
// Slot layout: (8, ns) row planes, ns = n_pencils * cap, x/y/z in rows 0..2,
// row 3 the validity (1/0); pencil p owns slots [p*cap, (p+1)*cap), valid
// slots packed rank-first; empty slots hold sentinels far from everything.
//
// The TPU kernels evaluate each pair once, from its i side (a slot of the
// pencil that owns the visit), and scatter the reaction onto the j side. CUDA
// blocks run in parallel, so here every pair is evaluated from BOTH sides
// ("pair-twice"): a block owns a tile of slots and sums, for each, every
// pair it is in. No atomics, so every result is deterministic and a slot's
// force is only ever written by its own thread. The pair values are the TPU
// kernel's bit for bit: seen from the j side, the displacement is the exact
// negation of the i side's, because each side forms it the same way:
//   forward  (j side is the partner): dx = x_i - (x_j + shift)   (TPU form);
//   backward (i side is the partner): dx = (x_j + shift) - x_i
//            = -(x_i - (x_j + shift)), the shift still added to the j side;
// fl(a - b) = -fl(b - a), rint is odd, and r^2 sums the same squares in the
// same order. Only the order of each slot's force sum differs. The e/du/ddu
// partials are summed on the i side only, so per-slot observables equal the
// TPU kernel's up to summation order too.
#pragma once

#include <cuda_runtime.h>

#include "lj_pair_terms.cuh"

namespace ljmd {

constexpr int kPenTile = 32;                      // slots of one work item
constexpr int kPenSlices = 4;                     // threads per slot
constexpr int kPenStage = kPenTile * kPenSlices;  // partners staged at once
constexpr int kPenGran = 128;                     // pencil and visit granule

template <typename T>
struct PenAcc {
  T fx, fy, fz, e, du, ddu;
};

// The thread's slot: its index and (possibly shifted) coordinates.
template <typename T>
struct PenSlot {
  int g;
  T x, y, z, lx, ly, lz;
};

template <typename T>
struct PenGeom {
  const T* r;   // row 0 of the position plane
  const T* lo;  // row 0 of the remainder plane (EXT only)
  size_t ns;
  int n_pencils;
  int cap;
  T box;
  T inv_box;
  T rc2;
};

// Partners staged by pen_i_segment: coordinates (x / y shifted where the
// sweep shifts them) and the validity row.
template <typename T>
struct PenStageV {
  T x[kPenStage], y[kPenStage], z[kPenStage], v[kPenStage];
};

// Pairs of slot g at (xi, yi, zi), validity vi, with the partner slots
// [q0, q0 + len), len a multiple of kPenStage, from the i side only: the
// full 9-neighbour sweeps (pencil_sweep_full.cu, pencil_sweep_zband.cu)
// visit every pair from both of its slots, so nothing is scattered. The mask
// is the TPU kernels': r^2 < rc^2, gi != gj, vi * vj > 0.5, and no partner in
// [ex0, ex1) (the z-band's window B deduped against window A; an empty range
// otherwise). FULL_MIC takes the minimum image in x, y and z (the z-banded
// sweep has no shift table); else the partners' x / y are shifted by
// (offx, offy) and only z takes the round. e/du/ddu of every pair are summed.
// Every thread of the block calls it with the same segment.
template <typename T, bool OBS, bool FULL_MIC>
__device__ void pen_i_segment(const PenGeom<T>& p, PenStageV<T>& sh, int g, T xi, T yi, T zi,
                              T vi, int q0, int len, T offx, T offy, int ex0, int ex1,
                              PenAcc<T>& acc) {
  const int t = threadIdx.y * kPenTile + threadIdx.x;
  const size_t ns = p.ns;
  for (int c0 = q0; c0 < q0 + len; c0 += kPenStage) {
    __syncthreads();
    const size_t q = static_cast<size_t>(c0) + t;
    T xq = p.r[q];
    T yq = p.r[ns + q];
    if (!FULL_MIC) {
      xq = add_rn(xq, offx);
      yq = add_rn(yq, offy);
    }
    sh.x[t] = xq;
    sh.y[t] = yq;
    sh.z[t] = p.r[2 * ns + q];
    sh.v[t] = p.r[3 * ns + q];
    __syncthreads();
    for (int jj = threadIdx.y; jj < kPenStage; jj += kPenSlices) {
      const int gq = c0 + jj;
      T dx = sub_rn(xi, sh.x[jj]);
      T dy = sub_rn(yi, sh.y[jj]);
      T dz = sub_rn(zi, sh.z[jj]);
      if (FULL_MIC) {
        dx = min_image(dx, p.box, p.inv_box);
        dy = min_image(dy, p.box, p.inv_box);
      }
      dz = min_image(dz, p.box, p.inv_box);
      const T r2 = add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz));
      const bool m = (r2 < p.rc2) && (gq != g) && (mul_rn(vi, sh.v[jj]) > T(0.5)) &&
                     !(gq >= ex0 && gq < ex1);
      const PairTerms<T> pt = lj_pair_terms<T, OBS>(r2, m);
      acc.fx = add_rn(acc.fx, mul_rn(pt.coef, dx));
      acc.fy = add_rn(acc.fy, mul_rn(pt.coef, dy));
      acc.fz = add_rn(acc.fz, mul_rn(pt.coef, dz));
      if (OBS) {
        acc.e = add_rn(acc.e, pt.e);
        acc.du = add_rn(acc.du, pt.du);
        acc.ddu = add_rn(acc.ddu, pt.ddu);
      }
    }
  }
}

// Sum the kPenSlices partial accumulators of each slot (red is shared).
template <typename T, int ROWS>
__device__ __forceinline__ void pen_reduce(T (&red)[kPenSlices][ROWS][kPenTile],
                                           const PenAcc<T>& acc) {
  __syncthreads();
  const T parts[6] = {acc.fx, acc.fy, acc.fz, acc.e, acc.du, acc.ddu};
#pragma unroll
  for (int c = 0; c < ROWS; ++c) red[threadIdx.y][c][threadIdx.x] = parts[c];
  __syncthreads();
}

template <typename T, int ROWS>
__device__ __forceinline__ T pen_sum(const T (&red)[kPenSlices][ROWS][kPenTile], int c) {
  T f = red[0][c][threadIdx.x];
#pragma unroll
  for (int q = 1; q < kPenSlices; ++q) f = add_rn(f, red[q][c][threadIdx.x]);
  return f;
}

// Neumaier-compensated x += delta (as fused_dense_chunk.cu).
template <typename T>
__device__ __forceinline__ void pen_comp_add(T& x, T& c, T delta) {
  const T y = add_rn(delta, c);
  const T t = add_rn(x, y);
  c = abs_(x) >= abs_(y) ? add_rn(sub_rn(x, t), y) : add_rn(sub_rn(y, t), x);
  x = t;
}

// The fused chunks' phase 1 at element k of the slot planes: drift (r + v dt
// + a dt^2/2 in the TPU kernel's order; extended: the two-float position
// update with (v + vc) dt) into the new plane, and the first half-kick.
template <typename T, bool EXT>
__device__ __forceinline__ void pen_drift(size_t k, const T* r_cur, T* r_new, const T* lo_cur,
                                          T* lo_new, T* v, T* vc, const T* a, T dt, T half_dt,
                                          T half_dt_sq) {
  if (EXT) {
    const T delta = add_rn(mul_rn(add_rn(v[k], vc[k]), dt), mul_rn(a[k], half_dt_sq));
    T x = r_cur[k];
    T lo = lo_cur[k];
    pen_comp_add(x, lo, delta);
    r_new[k] = x;
    lo_new[k] = lo;
    T vk = v[k];
    T ck = vc[k];
    pen_comp_add(vk, ck, mul_rn(a[k], half_dt));
    v[k] = vk;
    vc[k] = ck;
  } else {
    r_new[k] = add_rn(add_rn(r_cur[k], mul_rn(v[k], dt)), mul_rn(a[k], half_dt_sq));
    v[k] = add_rn(v[k], mul_rn(a[k], half_dt));
  }
}

// The fused chunks' second half-kick at element k with the new acceleration.
template <typename T, bool EXT>
__device__ __forceinline__ void pen_kick(size_t k, T ak, T* v, T* vc, T* a, T half_dt) {
  a[k] = ak;
  if (EXT) {
    T vk = v[k];
    T ck = vc[k];
    pen_comp_add(vk, ck, mul_rn(ak, half_dt));
    v[k] = vk;
    vc[k] = ck;
  } else {
    v[k] = add_rn(v[k], mul_rn(ak, half_dt));
  }
}

}  // namespace ljmd
