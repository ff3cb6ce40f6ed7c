// The culled pair loop of one staged 128-partner stage, shared by the
// redesigned static pencil chunk (fused_pencil_chunk.cu, kernel 15), the
// half-shell sweep (pencil_sweep_hs.cu, kernels 13 / 14), the z-banded
// sweep (pencil_sweep_zband.cu, kernel 12) and the full 9-neighbour sweep
// (pencil_sweep_full.cu, kernel 11).
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

// How a stage of the full sweeps forms its candidates: kernel 12's full
// minimum image; kernel 11's partners shifted by (offx, offy) with only z
// rounded, dx = x_i - (x_j + offx) as the earlier port's staging formed it,
// on the slot's own pencil (the gi != gj test), on another pencil with a
// nonzero shift, or on another pencil with none (x_j + 0 = x_j up to the
// sign of a zero, which changes no sum: the same bits).
enum FullForm { kFullMinImage = 0, kFullOwn = 1, kFullShifted = 2, kFullUnshifted = 3 };

// Kernels 12 and 11: i-side pairs of slot g at (xi, yi, zi), validity vi,
// with one staged stage (rows x, y, z, validity) of partner slots [q0, q0 +
// 128), the mask r^2 < rc^2, gi != gj, vi * vj > 0.5 (gi != gj tested only
// where the stage can hold g: forms kFullMinImage and kFullOwn); e / du /
// ddu of every pair with OBS.
template <typename T, bool OBS, int S, int FORM>
__device__ __forceinline__ void cull_stage_full(const T* sx, const T* sy, const T* sz,
                                                const T* sv, int g, T xi, T yi, T zi, T vi,
                                                int q0, T offx, T offy, T box, T inv_box,
                                                T rc2, PenAcc<T>& acc) {
  auto cand = [&](int jj, bool& m) {
    CullDisp<T> d;
    if (FORM == kFullMinImage) {
      d.dx = min_image(sub_rn(xi, sx[jj]), box, inv_box);
      d.dy = min_image(sub_rn(yi, sy[jj]), box, inv_box);
    } else if (FORM == kFullUnshifted) {
      d.dx = sub_rn(xi, sx[jj]);
      d.dy = sub_rn(yi, sy[jj]);
    } else {
      d.dx = sub_rn(xi, add_rn(sx[jj], offx));
      d.dy = sub_rn(yi, add_rn(sy[jj], offy));
    }
    d.dz = min_image(sub_rn(zi, sz[jj]), box, inv_box);
    d.r2 = add_rn(add_rn(mul_rn(d.dx, d.dx), mul_rn(d.dy, d.dy)), mul_rn(d.dz, d.dz));
    m = (d.r2 < rc2) && (mul_rn(vi, sv[jj]) > T(0.5));
    if (FORM == kFullMinImage || FORM == kFullOwn) m = m && (q0 + jj != g);
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
