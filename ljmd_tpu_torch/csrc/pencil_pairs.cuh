// Device code shared by the cell-pair kernels (pencil_sweep_hs.cu,
// fused_pencil_chunk.cu, pencil_sweep_full.cu, pencil_sweep_zband.cu): the
// pair loop of one segment of partner slots and the half-shell neighbourhood
// of a slot, from the tables or from the width lists; the i-side segment of
// the full 9-neighbour sweeps.
//
// Slot layout: (8, ns) row planes, ns = n_pencils * cap, x/y/z in rows 0..2,
// row 3 the validity (1/0); pencil p owns slots [p*cap, (p+1)*cap), valid
// slots packed rank-first; empty slots hold sentinels far from everything.
//
// The TPU kernels evaluate each pair once, from its i side (a slot of the
// pencil that owns the visit), and scatter the reaction onto the j side. CUDA
// blocks run in parallel, so here every pair is evaluated from BOTH sides
// ("pair-twice"): a block owns 32 slots and sums, for each, every pair it is
// in. No atomics, so every result is deterministic and a slot's force is only
// ever written by its own thread. The pair values are the TPU kernel's bit
// for bit: seen from the j side, the displacement is the exact negation of the
// i side's, because each side forms it the same way:
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

// Which partners of a same-pencil segment count: every other slot, those
// above the thread's slot, or those below it (neighbour segments: all).
enum PenMask { kPenAll = 0, kPenNotSelf = 1, kPenAbove = 2, kPenBelow = 3 };

template <typename T, bool EXT>
struct PenStage {
  T x[kPenStage], y[kPenStage], z[kPenStage];
  T lx[EXT ? kPenStage : 1], ly[EXT ? kPenStage : 1], lz[EXT ? kPenStage : 1];
};

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

// Pairs of `me` with the partner slots [q0, q0 + len), len a multiple of
// kPenStage, summed into acc. Every thread of the block calls it with the
// same segment (it stages partners in shared memory between barriers).
// shift_partner adds (offx, offy) to the partners' x/y (a forward neighbour
// segment); a backward segment passes `me` already shifted instead. `obs_all`
// sums e/du/ddu of every pair (forward neighbour: `me` is the i side); same-
// pencil segments sum those of the partners above `me`.
template <typename T, bool EXT, bool OBS>
__device__ void pen_segment(const PenGeom<T>& p, PenStage<T, EXT>& sh, const PenSlot<T>& me,
                            int q0, int len, bool shift_partner, T offx, T offy, int mask,
                            bool obs_all, PenAcc<T>& acc) {
  const int t = threadIdx.y * kPenTile + threadIdx.x;
  const size_t ns = p.ns;
  for (int c0 = q0; c0 < q0 + len; c0 += kPenStage) {
    __syncthreads();
    const size_t q = static_cast<size_t>(c0) + t;
    T xq = p.r[q];
    T yq = p.r[ns + q];
    if (shift_partner) {
      xq = add_rn(xq, offx);
      yq = add_rn(yq, offy);
    }
    sh.x[t] = xq;
    sh.y[t] = yq;
    sh.z[t] = p.r[2 * ns + q];
    if (EXT) {
      sh.lx[t] = p.lo[q];
      sh.ly[t] = p.lo[ns + q];
      sh.lz[t] = p.lo[2 * ns + q];
    }
    __syncthreads();
    for (int jj = threadIdx.y; jj < kPenStage; jj += kPenSlices) {
      const int gq = c0 + jj;
      T dx = sub_rn(me.x, sh.x[jj]);
      T dy = sub_rn(me.y, sh.y[jj]);
      T dz = sub_rn(me.z, sh.z[jj]);
      if (EXT) {
        dx = add_rn(dx, sub_rn(me.lx, sh.lx[jj]));
        dy = add_rn(dy, sub_rn(me.ly, sh.ly[jj]));
        dz = add_rn(dz, sub_rn(me.lz, sh.lz[jj]));
      }
      dz = min_image(dz, p.box, p.inv_box);
      const T r2 = add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz));
      bool m = r2 < p.rc2;
      bool obs_pair = obs_all;
      if (mask != kPenAll) {
        const bool above = gq > me.g;
        const bool below = gq < me.g;
        m = m && (mask == kPenNotSelf ? (above || below) : (mask == kPenAbove ? above : below));
        obs_pair = above;
      }
      const PairTerms<T> pt = lj_pair_terms<T, OBS>(r2, m);
      acc.fx = add_rn(acc.fx, mul_rn(pt.coef, dx));
      acc.fy = add_rn(acc.fy, mul_rn(pt.coef, dy));
      acc.fz = add_rn(acc.fz, mul_rn(pt.coef, dz));
      if (OBS && obs_pair) {
        acc.e = add_rn(acc.e, pt.e);
        acc.du = add_rn(acc.du, pt.du);
        acc.ddu = add_rn(acc.ddu, pt.ddu);
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ PenSlot<T> pen_shifted(const PenSlot<T>& me, T offx, T offy) {
  PenSlot<T> s = me;
  s.x = add_rn(me.x, offx);
  s.y = add_rn(me.y, offy);
  return s;
}

// lower[k] = the pencil whose k-th upper neighbour is q (over the first
// n_pencils pencils' table rows; a full grid's table is a bijection per k, a
// strip's leaves lower[k] as the caller set it where no row points at q).
// Every thread of the block calls it; a barrier must follow.
__device__ __forceinline__ void pen_lower(const int* tbl, int n_pencils, int q, int* lower) {
  const int t = threadIdx.y * kPenTile + threadIdx.x;
  for (int e = t; e < 4 * n_pencils; e += kPenStage) {
    if (tbl[e] == q) lower[e & 3] = e >> 2;
  }
}

// All pairs of `me` (pencil q) over the half-shell tables, every partner
// pencil at full capacity: its own pencil, its 4 upper neighbours (forward)
// and the 4 pencils whose upper neighbour it is (backward). `i_side` false
// (a halo pencil of a strip, which has no table row) keeps the backward
// pairs only; lower[k] < 0 (no row points at q) skips that backward pencil.
// With `counts`, partner pencils that are empty are skipped (the TPU grid
// kernel's gate).
template <typename T, bool EXT, bool OBS>
__device__ void pen_table_pairs(const PenGeom<T>& p, PenStage<T, EXT>& sh, const PenSlot<T>& me,
                                int q, bool i_side, const int* lower, const int* tbl,
                                const int* shf, const int* counts, PenAcc<T>& acc) {
  const int cap = p.cap;
  if (i_side) {
    pen_segment<T, EXT, OBS>(p, sh, me, q * cap, cap, false, T(0), T(0), kPenNotSelf, false,
                             acc);
#pragma unroll 1
    for (int k = 0; k < 4; ++k) {
      const int j = tbl[q * 4 + k];
      if (counts != nullptr && counts[j] == 0) continue;
      const T offx = mul_rn(static_cast<T>(shf[(q * 4 + k) * 2]), p.box);
      const T offy = mul_rn(static_cast<T>(shf[(q * 4 + k) * 2 + 1]), p.box);
      pen_segment<T, EXT, OBS>(p, sh, me, j * cap, cap, true, offx, offy, kPenAll, true, acc);
    }
  }
#pragma unroll 1
  for (int k = 0; k < 4; ++k) {
    const int lp = lower[k];
    if (lp < 0 || (counts != nullptr && counts[lp] == 0)) continue;
    const T offx = mul_rn(static_cast<T>(shf[(lp * 4 + k) * 2]), p.box);
    const T offy = mul_rn(static_cast<T>(shf[(lp * 4 + k) * 2 + 1]), p.box);
    pen_segment<T, EXT, OBS>(p, sh, pen_shifted(me, offx, offy), lp * cap, cap, false, T(0),
                             T(0), kPenAll, false, acc);
  }
}

// The five width lists (ops/fused_pencil.py build_width_lists), read on the
// device.
struct PenLists {
  const int* self;      // (n_sub * P,) self-visit i blocks, class u at (u-1)*P
  const int* self_cnt;  // (n_sub,)
  const int* nbr_i;     // (P * n_sub * 4,) neighbour-visit i blocks
  const int* nbr_j;     // packed (j_block << 4) | (shx+1) << 2 | (shy+1)
  const int* nbr_off;   // (n_sub + 1,) class offsets
};

// All pairs of `me` (in 128-slot block blk) over the width lists: every
// visit whose i block is blk (forward: its j range) and every visit whose j
// range holds blk (backward: its 128 i slots). Self visits (class u: i block
// ib, j blocks [ib, ib + u), triangular) give the partners above `me` in the
// forward direction and those below it in the backward one.
template <typename T, bool EXT>
__device__ void pen_width_pairs(const PenGeom<T>& p, PenStage<T, EXT>& sh, const PenSlot<T>& me,
                                int blk, const PenLists& wl, PenAcc<T>& acc) {
  const int n_sub = p.cap / kPenGran;
  const int P = p.n_pencils;
#pragma unroll 1
  for (int u = 1; u <= n_sub; ++u) {
    const int cnt = wl.self_cnt[u - 1];
#pragma unroll 1
    for (int t = 0; t < cnt; ++t) {
      const int ib = wl.self[(u - 1) * P + t];
      if (blk < ib || blk >= ib + u) continue;
      pen_segment<T, EXT, false>(p, sh, me, ib * kPenGran, kPenGran, false, T(0), T(0),
                                 kPenBelow, false, acc);
      if (ib == blk) {
        pen_segment<T, EXT, false>(p, sh, me, ib * kPenGran, u * kPenGran, false, T(0), T(0),
                                   kPenAbove, false, acc);
      }
    }
  }
#pragma unroll 1
  for (int w = 1; w <= n_sub; ++w) {
    const int end = wl.nbr_off[w];
#pragma unroll 1
    for (int t = wl.nbr_off[w - 1]; t < end; ++t) {
      const int ib = wl.nbr_i[t];
      const int pk = wl.nbr_j[t];
      const int jb = pk >> 4;
      const bool fwd = ib == blk;
      const bool bwd = blk >= jb && blk < jb + w;
      if (!fwd && !bwd) continue;
      const T offx = mul_rn(static_cast<T>(((pk >> 2) & 3) - 1), p.box);
      const T offy = mul_rn(static_cast<T>((pk & 3) - 1), p.box);
      if (fwd) {
        pen_segment<T, EXT, false>(p, sh, me, jb * kPenGran, w * kPenGran, true, offx, offy,
                                   kPenAll, false, acc);
      }
      if (bwd) {
        pen_segment<T, EXT, false>(p, sh, pen_shifted(me, offx, offy), ib * kPenGran, kPenGran,
                                   false, T(0), T(0), kPenAll, false, acc);
      }
    }
  }
}

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

}  // namespace ljmd
