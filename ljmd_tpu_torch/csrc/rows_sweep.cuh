// The row-sweep kernel of the tri sweep (kernel 2, pair_sweep_tri.cu), the
// ring's rect sweep (kernel 6, pair_sweep_rect.cu) and the ordered sweep
// (kernel 5, pair_sweep.cu: the rect sweep with A = B), with its launch
// rule; the rect-Newton hop (kernel 7, pair_sweep_rect.cu) writes the same
// body out for its two roles and shares the rule's host code.
//
// Replaces: ljmd_tpu/ops/pallas_lj.py's `_lj_tri_kernel` (:160),
// `_lj_rect_kernel` (:301) and `_lj_tile_kernel` (:48); each source's header
// gives its contract.
//
// What bounds it on the H100: the pair arithmetic (~30 instructions and one
// IEEE divide a pair inside the cutoff, a displacement and r^2 for every
// candidate); the (8, ld) rows stay in L2. At the main path's sizes (250 to
// 4000 rows) there are few rows an SM, so the latency of a thread's partner
// loop and the occupancy matter as much as the count.
//
// What the design does about that (one role: the rows [a_lo, a_hi) of A,
// each against the partners [b_lo, b_hi) of B):
// - Pair-twice with no atomics: a row's pairs are summed by the threads of
//   that row alone.
// - A block is 256 threads: tile = 256 / S rows, S threads a row taking
//   partners slice, slice + S, ... S (a power of two, 4..128) comes from the
//   occupancy API (rows_slices): the largest S whose live blocks all run in
//   one wave of at most 3 blocks an SM, each thread keeping a partner. The
//   S partial sums of a row are added by warp shuffles, then for S > 32 in
//   shared memory warp by warp: a fixed order, the same result every run.
// - The block stages its partner rows once, by cp.async through a ring of
//   three 512-column buffers, one __syncthreads() a chunk.
// - The warp-vote cull: displacement, minimum image and r^2 for every
//   candidate; the LJ algebra and the sums only where a lane of the warp
//   holds the mask (~1.4% of candidates lie inside rc = 2.5 at rho* = 0.844).
// - Blocks wholly outside the active rows, or with no partner, only write
//   zeros (the Pallas kernels' compute gates).
// Because fl(xi - xj) == -fl(xj - xi) and the minimum image rounds half to
// even (symmetric), the pair force computed from the j side is the exact
// negation of the i side's: pair-twice gives the TPU kernels' per-pair values
// bit for bit (the _rn intrinsics of lj_pair_terms.cuh), summed in another
// order.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

#include "async_copy.cuh"
#include "lj_pair_terms.cuh"

namespace ljmd {

constexpr int kRowsThreads = 256;   // threads of a block (8 warps)
constexpr int kRowsWarps = kRowsThreads / 32;
constexpr int kRowsChunk = 512;     // partner columns a staged chunk
constexpr int kRowsRing = 3;        // staging buffers
constexpr int kRowsAlign = 32;      // staged column granule (16-byte pieces, both types)
constexpr int kRowsMinSlices = 4;
constexpr int kRowsMaxSlices = 128;
constexpr int kRowsBlocksPerSm = 3;  // live blocks an SM at most (the S rule)

// One role: the active rows [a_lo, a_hi) of A against the active partners
// [b_lo, b_hi) of B.
template <typename T>
struct RowsRole {
  const T* a;  // (8, lda) rows whose forces are summed
  const T* b;  // (8, ldb) partner rows
  T* out;      // (8, lda)
  int lda, a_lo, a_hi;
  int ldb, b_lo, b_hi;
  int ga0, gb0;
  int obs;     // sum rows 3..5 (where the template's OBS is set)
  int blocks;  // lda / tile
};

template <typename T>
RowsRole<T> rows_role(const T* a, const T* b, T* out, int lda, int a_lo, int a_hi, int ldb,
                      int b_lo, int b_hi, int ga0, int gb0, int obs, int tile) {
  return RowsRole<T>{a, b, out, lda, a_lo, a_hi, ldb, b_lo, b_hi, ga0, gb0, obs, lda / tile};
}

// Block `blk` of role p: out rows 0..2 the force on each active row without
// the 24 prefactor, summed over the active partners inside the cutoff with
// gb0 + j != ga0 + i; rows 3..5 (OBS and p.obs) e / du / ddu over the same
// pairs, or (UPPER) over those with gb0 + j > ga0 + i only; rows 6..7 and
// inactive rows exactly 0.
template <typename T, bool OBS, bool UPPER>
__device__ __forceinline__ void rows_sweep_block(const RowsRole<T>& p, int blk, int S, T box,
                                                 T inv_box, T rc2) {
  __shared__ __align__(16) T ring[kRowsRing][3][kRowsChunk];
  __shared__ T red[kRowsWarps][6];
  const int tid = threadIdx.x;
  const int tile = kRowsThreads / S;
  const int slice = tid & (S - 1);
  const int i0 = blk * tile;
  const int i = i0 + tid / S;
  if (i0 >= p.a_hi || i0 + tile <= p.a_lo || p.b_lo >= p.b_hi) {
    if (slice == 0) {
#pragma unroll
      for (int k = 0; k < 8; ++k) p.out[k * p.lda + i] = T(0);
    }
    return;  // the whole block: no active pair
  }
  const bool live = i >= p.a_lo && i < p.a_hi;
  const bool obs = OBS && p.obs;
  const int gi = p.ga0 + i;
  const T xi = live ? p.a[i] : T(0);
  const T yi = live ? p.a[p.lda + i] : T(0);
  const T zi = live ? p.a[2 * p.lda + i] : T(0);

  // Partner columns [c_lo, b_hi) in chunks of kRowsChunk, each staged as its
  // kRowsAlign-rounded columns (within ldb, a multiple of 128).
  const int c_lo = p.b_lo / kRowsAlign * kRowsAlign;
  const int c_end = (p.b_hi + kRowsAlign - 1) / kRowsAlign * kRowsAlign;
  const int n_chunks = (p.b_hi - c_lo + kRowsChunk - 1) / kRowsChunk;
  T acc[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
  stage_rows(&ring[0][0][0], kRowsChunk, p.b, p.b, p.ldb, 3, static_cast<size_t>(c_lo),
             min(kRowsChunk, c_end - c_lo), tid, kRowsThreads);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    const int j0 = c_lo + c * kRowsChunk;
    if (c + 1 < n_chunks) {
      stage_rows(&ring[(c + 1) % kRowsRing][0][0], kRowsChunk, p.b, p.b, p.ldb, 3,
                 static_cast<size_t>(j0 + kRowsChunk), min(kRowsChunk, c_end - j0 - kRowsChunk),
                 tid, kRowsThreads);
      cp_async_commit();
      cp_async_wait(1);
    } else {
      cp_async_wait(0);
    }
    // Chunk c has landed for every thread; the buffer chunk c + 1 is copied
    // into was last read at chunk c - 2, before the previous barrier.
    __syncthreads();
    const T(*s)[kRowsChunk] = ring[c % kRowsRing];
    // The same trip count on every lane (the vote needs the whole warp);
    // columns past b_hi are masked by index and their values never used.
    const int span = (min(kRowsChunk, p.b_hi - j0) + S - 1) / S * S;
#pragma unroll 2
    for (int jj = slice; jj < span; jj += S) {
      const int j = j0 + jj;
      const T dx = min_image(sub_rn(xi, s[0][jj]), box, inv_box);
      const T dy = min_image(sub_rn(yi, s[1][jj]), box, inv_box);
      const T dz = min_image(sub_rn(zi, s[2][jj]), box, inv_box);
      const T r2 = add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz));
      const bool m = live && j >= p.b_lo && j < p.b_hi && p.gb0 + j != gi && r2 < rc2;
      if (__any_sync(0xffffffffu, m)) {
        const PairTerms<T> pt = lj_pair_terms<T, OBS>(r2, m);
        if (m) {
          acc[0] = add_rn(acc[0], mul_rn(pt.coef, dx));
          acc[1] = add_rn(acc[1], mul_rn(pt.coef, dy));
          acc[2] = add_rn(acc[2], mul_rn(pt.coef, dz));
          if (obs && (!UPPER || p.gb0 + j > gi)) {
            acc[3] = add_rn(acc[3], pt.e);
            acc[4] = add_rn(acc[4], pt.du);
            acc[5] = add_rn(acc[5], pt.ddu);
          }
        }
      }
    }
  }

  // The S partial sums of the row, in a fixed order.
  const int rows = obs ? 6 : 3;
  const int width = S < 32 ? S : 32;
  for (int off = width >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      if (k < rows) acc[k] = add_rn(acc[k], __shfl_down_sync(0xffffffffu, acc[k], off, width));
    }
  }
  if (S > 32) {
    const int warp = tid >> 5;
    if ((tid & 31) == 0) {
#pragma unroll
      for (int k = 0; k < 6; ++k) red[warp][k] = acc[k];
    }
    __syncthreads();
    if (slice == 0) {
      for (int q = 1; q < S / 32; ++q) {
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          if (k < rows) acc[k] = add_rn(acc[k], red[warp + q][k]);
        }
      }
    }
  }
  if (slice == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) p.out[k * p.lda + i] = (live && k < rows) ? acc[k] : T(0);
  }
}

// The single-role kernel of the tri (UPPER) and rect sweeps.
template <typename T, bool OBS, bool UPPER>
__global__ void __launch_bounds__(kRowsThreads)
rows_sweep_kernel(RowsRole<T> p, int S, T box, T inv_box, T rc2) {
  rows_sweep_block<T, OBS, UPPER>(p, blockIdx.x, S, box, inv_box, rc2);
}

// Blocks of `tile` rows that meet the active rows [a_lo, a_hi) while the
// partner range [b_lo, b_hi) is not empty (the block's gate).
inline int rows_live_blocks(int a_lo, int a_hi, int b_lo, int b_hi, int tile) {
  if (a_lo >= a_hi || b_lo >= b_hi) return 0;
  return (a_hi - 1) / tile - a_lo / tile + 1;
}

// The occupancy facts of one kernel on one device.
struct RowsOccupancy {
  int per_sm, sms, regs, spill;
};

// Asked once a kernel and device (a sweep launches every step; the ranks of
// a thread mesh launch at once).
inline int rows_occupancy(const void* fn, RowsOccupancy* occ) {
  constexpr int kMaxEntries = 256;
  static std::mutex lock;
  static const void* fns[kMaxEntries];
  static int devs[kMaxEntries];
  static RowsOccupancy known[kMaxEntries];
  static int count = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::lock_guard<std::mutex> guard(lock);
  for (int e = 0; e < count; ++e) {
    if (fns[e] == fn && devs[e] == dev) {
      *occ = known[e];
      return 0;
    }
  }
  if (count == kMaxEntries) return static_cast<int>(cudaErrorInvalidDevice);
  RowsOccupancy o{};
  err = cudaDeviceGetAttribute(&o.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o.per_sm, fn, kRowsThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  o.regs = attr.numRegs;
  o.spill = static_cast<int>(attr.localSizeBytes);
  fns[count] = fn;
  devs[count] = dev;
  known[count++] = o;
  *occ = o;
  return 0;
}

// The S rule: the largest S whose live(S) blocks all run at once, at most
// kRowsBlocksPerSm of them an SM, with at least one of `cols` partners a
// thread; else (rows far larger than the card) the smallest. An S sweep of
// kernel 7 on the H100 put the best time there, or within 0.0001 ms of it,
// at 19 of the main path's 20 hops: more blocks an SM restage the partners
// more often than their shorter loops save. S = 256 would need >= 512 live
// blocks: more than one such wave on any card of fewer than 171 SMs.
template <typename LiveFn>
int rows_slices(LiveFn live, int cols, const RowsOccupancy& occ) {
  const long long wave = static_cast<long long>(min(occ.per_sm, kRowsBlocksPerSm)) * occ.sms;
  int slices = kRowsMinSlices;
  for (int s = kRowsMinSlices; s <= kRowsMaxSlices; s *= 2) {
    if (live(s) <= wave && cols >= s) slices = s;
  }
  return slices;
}

// out = {S, tile, live blocks, grid blocks, resident blocks an SM, SMs,
// registers a thread, spill bytes a thread}.
inline void rows_plan_out(int slices, int live, int grid, const RowsOccupancy& occ, int* out) {
  out[0] = slices;
  out[1] = kRowsThreads / slices;
  out[2] = live;
  out[3] = grid;
  out[4] = occ.per_sm;
  out[5] = occ.sms;
  out[6] = occ.regs;
  out[7] = occ.spill;
}

// The single-role launch shape: rows [0, n_a) of an (8, lda) matrix against
// partners [0, n_b).
template <typename T, bool OBS, bool UPPER>
int rows_plan(int n_a, int lda, int n_b, int* out) {
  RowsOccupancy occ;
  const int err =
      rows_occupancy(reinterpret_cast<const void*>(rows_sweep_kernel<T, OBS, UPPER>), &occ);
  if (err != 0) return err;
  auto live = [&](int s) { return rows_live_blocks(0, n_a, 0, n_b, kRowsThreads / s); };
  const int slices = rows_slices(live, n_b, occ);
  rows_plan_out(slices, live(slices), lda / (kRowsThreads / slices), occ, out);
  return 0;
}

template <typename T, bool UPPER>
int rows_plan_any(int want_obs, int n_a, int lda, int n_b, int* out) {
  return want_obs ? rows_plan<T, true, UPPER>(n_a, lda, n_b, out)
                  : rows_plan<T, false, UPPER>(n_a, lda, n_b, out);
}

// One single-role sweep: the rows [0, n_a) of A (global index ga0 + i)
// against the partners [0, n_b) of B (gb0 + j). lda and ldb are multiples
// of 128 and every row starts on a 16-byte boundary (cp.async).
template <typename T, bool UPPER>
int launch_rows_sweep(const T* a, const T* b, T* out, int n_a, int lda, int n_b, int ldb,
                      int ga0, int gb0, T box, T inv_box, T rc2, int want_obs, void* stream) {
  if (lda % 128 || ldb % 128 || n_a < 0 || n_a > lda || n_b < 0 || n_b > ldb) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int plan[8];
  const int err = rows_plan_any<T, UPPER>(want_obs, n_a, lda, n_b, plan);
  if (err != 0) return err;
  const RowsRole<T> p = rows_role<T>(a, b, out, lda, 0, n_a, ldb, 0, n_b, ga0, gb0, 1, plan[1]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (want_obs) {
    rows_sweep_kernel<T, true, UPPER><<<p.blocks, kRowsThreads, 0, s>>>(p, plan[0], box, inv_box,
                                                                        rc2);
  } else {
    rows_sweep_kernel<T, false, UPPER><<<p.blocks, kRowsThreads, 0, s>>>(p, plan[0], box, inv_box,
                                                                         rc2);
  }
  return static_cast<int>(cudaGetLastError());
}

// The tri sweep's launch shape (defined in pair_sweep_tri.cu, which
// instantiates its kernel), for ljmd_rows_sweep_plan.
int tri_rows_plan(int dtype_bytes, int want_obs, int n, int n_pad, int* out);

}  // namespace ljmd
