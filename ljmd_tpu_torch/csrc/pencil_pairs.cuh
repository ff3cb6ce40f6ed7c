// Device code shared by the cell-pair kernels: the slot and accumulator
// types and the fused chunks' per-slot Verlet updates (fused_pencil_chunk.cu,
// fused_pencil_width_chunk.cu). The culled stage loops of the sweeps and
// chunks are in pencil_cull.cuh.
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

constexpr int kPenGran = 128;  // pencil and visit granule

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
