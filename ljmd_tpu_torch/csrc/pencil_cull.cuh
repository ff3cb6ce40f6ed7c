// The culled pair loop of one staged 128-partner stage, shared by the
// redesigned static pencil chunk (fused_pencil_chunk.cu, kernel 15), the
// half-shell sweep (pencil_sweep_hs.cu, kernels 13 / 14) and the z-banded
// sweep (pencil_sweep_zband.cu, kernel 12).
//
// A block holds 128 slots x S partner slices: thread (slot tx, slice ty)
// takes the partners jj = ty, ty + S, ... of the stage (the order of the
// kernels these replace, so each slot's sum keeps its order). For every
// candidate it forms the displacement (the TPU kernel's form: see
// pencil_pairs.cuh), the minimum image and r^2, and the mask; then the warp
// (32 consecutive slots facing one partner) votes, and the LJ algebra (an
// IEEE divide and the r^-6 products) and the accumulates run only where a
// lane holds the mask. A pair outside the mask adds an exact -0 or +0 to a
// sum that starts at +0, so the lanes outside add nothing, and leaving the
// warp's body out where no lane holds changes no bit. (A per-lane bitmask of
// a stage's hits, each lane then running its own bodies, was measured beside
// the vote on the H100 and was slower; PERF.md has the times.)
#pragma once

#include <cuda_runtime.h>

#include "pencil_pairs.cuh"

namespace ljmd {

// Roles of a stage of the half-shell partner stream (kernels 15, 13 / 14): the slot's own pencil
// (every partner but the slot itself), a forward neighbour (partners'
// x / y shifted by the image shift) or a backward one (the slot shifted).
enum HsRole { kHsSelf = 0, kHsForward = 1, kHsBackward = 2 };

template <typename T>
struct CullDisp {
  T dx, dy, dz, r2;
};

// The culled loop over the thread's partners of one stage. cand(jj, m)
// returns the candidate's displacement and sets its mask; body(d, m, jj)
// accumulates it (a lane with m false adds exact zeros).
template <int S, typename Cand, typename Body>
__device__ __forceinline__ void cull_loop(Cand cand, Body body) {
  const int ty = threadIdx.y;
#pragma unroll 4
  for (int jj = ty; jj < kPenGran; jj += S) {
    bool m;
    const auto d = cand(jj, m);
    if (__any_sync(0xffffffffu, m)) body(d, m, jj);
  }
}

// Kernels 15 and 13 / 14: pairs of `me` with one staged stage (rows x, y, z
// and, EXT, the remainders) of partner slots [q0, q0 + 128) in role ROLE.
// OBS sums e / du / ddu of the pairs of which `me` is the i side: every
// forward pair, and the self stage's partners above `me` (the TPU kernel's
// pair-once set; pass OBS false for a backward stage).
template <typename T, bool EXT, bool OBS, int ROLE, int S>
__device__ __forceinline__ void cull_stage_hs(const T* sx, const T* sy, const T* sz,
                                              const T* slx, const T* sly, const T* slz,
                                              const PenSlot<T>& me, int q0, T offx, T offy,
                                              T box, T inv_box, T rc2, PenAcc<T>& acc) {
  T mx = me.x, my = me.y;
  if (ROLE == kHsBackward) {
    mx = add_rn(me.x, offx);
    my = add_rn(me.y, offy);
  }
  auto cand = [&](int jj, bool& m) {
    T px = sx[jj], py = sy[jj];
    if (ROLE == kHsForward) {
      px = add_rn(px, offx);
      py = add_rn(py, offy);
    }
    CullDisp<T> d;
    d.dx = sub_rn(mx, px);
    d.dy = sub_rn(my, py);
    d.dz = sub_rn(me.z, sz[jj]);
    if (EXT) {
      d.dx = add_rn(d.dx, sub_rn(me.lx, slx[jj]));
      d.dy = add_rn(d.dy, sub_rn(me.ly, sly[jj]));
      d.dz = add_rn(d.dz, sub_rn(me.lz, slz[jj]));
    }
    d.dz = min_image(d.dz, box, inv_box);
    d.r2 = add_rn(add_rn(mul_rn(d.dx, d.dx), mul_rn(d.dy, d.dy)), mul_rn(d.dz, d.dz));
    m = d.r2 < rc2;
    if (ROLE == kHsSelf) m = m && (q0 + jj != me.g);
    return d;
  };
  auto body = [&](const CullDisp<T>& d, bool m, int jj) {
    const PairTerms<T> pt = lj_pair_terms<T, OBS>(d.r2, m);
    acc.fx = add_rn(acc.fx, mul_rn(pt.coef, d.dx));
    acc.fy = add_rn(acc.fy, mul_rn(pt.coef, d.dy));
    acc.fz = add_rn(acc.fz, mul_rn(pt.coef, d.dz));
    if (OBS && (ROLE == kHsForward || q0 + jj > me.g)) {
      acc.e = add_rn(acc.e, pt.e);
      acc.du = add_rn(acc.du, pt.du);
      acc.ddu = add_rn(acc.ddu, pt.ddu);
    }
  };
  cull_loop<S>(cand, body);
}

// Kernel 12: i-side pairs of slot g at (xi, yi, zi), validity vi, with one
// staged stage (rows x, y, z, validity) of partner slots [q0, q0 + 128):
// the full minimum image in x, y and z, the mask r^2 < rc^2, gi != gj,
// vi * vj > 0.5; e / du / ddu of every pair with OBS.
template <typename T, bool OBS, int S>
__device__ __forceinline__ void cull_stage_full(const T* sx, const T* sy, const T* sz,
                                                const T* sv, int g, T xi, T yi, T zi, T vi,
                                                int q0, T box, T inv_box, T rc2,
                                                PenAcc<T>& acc) {
  auto cand = [&](int jj, bool& m) {
    CullDisp<T> d;
    d.dx = min_image(sub_rn(xi, sx[jj]), box, inv_box);
    d.dy = min_image(sub_rn(yi, sy[jj]), box, inv_box);
    d.dz = min_image(sub_rn(zi, sz[jj]), box, inv_box);
    d.r2 = add_rn(add_rn(mul_rn(d.dx, d.dx), mul_rn(d.dy, d.dy)), mul_rn(d.dz, d.dz));
    m = (d.r2 < rc2) && (q0 + jj != g) && (mul_rn(vi, sv[jj]) > T(0.5));
    return d;
  };
  auto body = [&](const CullDisp<T>& d, bool m, int) {
    const PairTerms<T> pt = lj_pair_terms<T, OBS>(d.r2, m);
    acc.fx = add_rn(acc.fx, mul_rn(pt.coef, d.dx));
    acc.fy = add_rn(acc.fy, mul_rn(pt.coef, d.dy));
    acc.fz = add_rn(acc.fz, mul_rn(pt.coef, d.dz));
    if (OBS) {
      acc.e = add_rn(acc.e, pt.e);
      acc.du = add_rn(acc.du, pt.du);
      acc.ddu = add_rn(acc.ddu, pt.ddu);
    }
  };
  cull_loop<S>(cand, body);
}

}  // namespace ljmd
