// Kernels 3, 4 and 8: n_steps of velocity Verlet in ONE launch, for one
// system or (kernels 3 and 4) for R independent replicas at once.
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
// What bounds it on the H100: the O(n^2) pair arithmetic of every step (~30
// instructions and one IEEE divide a pair, evaluated from both sides), plus
// one grid-wide barrier per step. The inputs are a few hundred KB; memory
// is not the limit. At the main path's small N (500 and 4000) the limit is
// latency: a step holds only 0.25M / 16M pair evaluations, and the earlier
// layout (32 particles x 4 threads a block, n_pad / 32 blocks) put one
// 4-warp block on each SM at N=4000 (1.6e11 pairs/s against 3.8e11 at
// N=62500, where 8 blocks share an SM) and left 116 of the 132 SMs idle at
// N=500.
//
// What the design does about that:
// - A block is 256 threads: TI = 256 / S particles, each with S threads
//   ("slices") that split its j range (thread `slice` takes j = slice,
//   slice + S, ...). S (a power of two, 4..256) is chosen by the host from
//   the occupancy API (ljmd_fused_plan): where the n_pad / TI work items
//   can all run at once on the blocks the card keeps resident, the largest
//   such S that leaves a thread >= 8 columns (N=4000: S = 16, 256 blocks,
//   ~2 an SM; N=500: S = 64, 128 blocks of 4 particles); else (N=62500) the
//   S <= 8 whose rounds of items waste the fewest block slots (float32: S =
//   8, 1956 items in 5 rounds of 396). A sweep of S on the card
//   (experiments/chunk_timing.py --sweep) put the best time at these S. The
//   S partial sums of a particle are added by warp
//   shuffles (shfl_down within groups of min(S, 32) lanes), then for S > 32
//   in shared memory, warp by warp: a fixed order, no atomics, so the sum
//   does not depend on the grid and a capped grid is bit-identical.
// - Positions are staged once per step: where the position plane (3 rows,
//   6 extended) fits in shared memory with two blocks an SM (N=4000: 48 KB
//   float32, 96 KB float64 or extended), every block copies it right after
//   the grid barrier with cp.async in 512-column groups, and its first work
//   item starts on the first group while the rest land; later items read it
//   as it stands. Above that (N=62500) each work item streams the plane
//   through a ring of three 512-column buffers, copying chunk c + 1 while
//   computing chunk c (one __syncthreads() a chunk). Dynamic shared memory,
//   above 48 KB where needed (cudaFuncSetAttribute), sized the same for the
//   occupancy query and the launch.
// - A cooperative launch of a PERSISTENT grid, min(n_pad / TI, the blocks
//   the card keeps resident) blocks, each taking the work items w =
//   blockIdx.x, blockIdx.x + gridDim.x, ... in the same order in both
//   phases of a step:
//     phase 1: drift + first half-kick of the block's particles, writing
//              the NEW positions into the other half of a double buffer;
//     grid barrier (cooperative_groups::this_grid().sync());
//     phase 2: stage the new plane, then for each work item the forces
//              from every particle and the second half-kick.
//   Positions are double-buffered: step s reads plane s & 1 and writes the
//   other, so a block that runs ahead into the next step's phase 1 never
//   overwrites positions that a slower block still reads in this step's
//   phase 2, and one barrier per step suffices. v, a and vc of a particle
//   are only ever touched by its owner thread (slice 0) in both phases.
//   Pair-twice sums with no atomics; the two-sums are written with the _rn
//   intrinsics (nvcc may not contract or reorder them) and the build never
//   uses --use_fast_math.
// - No tensor cores: the pair body is not a product. Each pair has its own
//   minimum image, cutoff mask and IEEE divide, and float64 has no fast
//   tensor-core route, so wgmma does not serve this kernel.
//
// Flags (kernel 8): with a non-null `flags`, an (n_pad / tile_i) x
// (n_pad / tile_j) int32 matrix, the pair {i, j} counts only where the
// tile the TPU kernel computes it in is active: flags[it(i) * n_j + jt(j)]
// > 0 for i < j (the TPU kernel is pair-once over the upper triangle), so
// flags[it(j) * n_j + jt(i)] for i > j. Both sides of a pair read the same
// flag, so the forces keep Newton's third law. Any flag > 0 runs the full
// minimum-image body (bits 2 and 4 are ignored, as on the TPU). The gate is
// decided per work item and staged 128-column granule (block-uniform: TI
// divides 128, which divides tile_i and tile_j) and a granule none of whose
// pairs is gated on is skipped. The flagged kernels are a separate
// instantiation: the unflagged ones (kernels 3 and 4) have no gate in their
// pair loop. A thread visits its j in the same increasing order with and
// without flags, so all-active flags give the unflagged chunk bit for bit.
//
// Replicas (kernels 3 and 4 on (R, 8, n_pad) stacks, the ensemble's rows
// engine; the JAX package vmaps the Pallas kernel): fused_replicas_kernel,
// its own kernel so that the one-system kernel keeps its code and registers.
// The work items of all R replicas form one list, replica q's at q * (n_pad
// / TI) ..., and each block takes a contiguous run of them (so its items
// mostly share a replica, and it restages a resident plane only when the
// replica changes). A work item never mixes replicas and S is the
// one-replica plan's, so a particle's sums run in the order of a launch of
// its replica alone: replica q equals that launch bit for bit, under any
// grid, and a replica that blows up touches no other replica's planes. The
// grid barrier is shared.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "lj_pair_terms.cuh"

namespace cg = cooperative_groups;

namespace ljmd {

constexpr int kDenseThreads = 256;        // threads of a block (8 warps)
constexpr int kDenseWarps = kDenseThreads / 32;
constexpr int kDenseChunk = 512;          // columns of a staged chunk
constexpr int kDenseRing = 3;             // streaming buffers
constexpr int kFlagCols = 128;            // the flag gate's column granule
constexpr int kMinSlices = 4;
constexpr int kMaxSlices = kDenseThreads;
constexpr int kMinCols = 8;               // columns a thread at least (one round)

template <typename T>
struct DenseArgs {
  T* rbuf;   // (2, 8, n_pad) position planes
  T* lobuf;  // (2, 8, n_pad) remainder planes (extended)
  T* v;
  T* vc;
  T* a;
  int n;
  int n_pad;
  T box;
  T inv_box;
  T rc2;
  T dt;
  T half_dt;
  T half_dt_sq;
  int n_steps;
  const int* flags;
  int tile_i;
  int tile_j;
  int slices;    // threads per particle, a power of two in [4, 256]
  int resident;  // 1: the whole position plane is staged once per step
};

// Shared memory: the cross-warp partial sums, then the staged positions
// (resident: rows x n_pad; streaming: kDenseRing buffers of rows x
// kDenseChunk).
template <typename T, bool EXT>
size_t dense_smem_bytes(int resident, int n_pad) {
  const size_t rows = EXT ? 6 : 3;
  const size_t cols = resident ? static_cast<size_t>(n_pad) : kDenseRing * kDenseChunk;
  return (kDenseWarps * 3 + rows * cols) * sizeof(T);
}

// Neumaier-compensated x += delta (engine.py:176-185, pallas_fused.py:136-144):
// c accumulates the rounding remainder so x + c tracks the exact sum.
template <typename T>
__device__ __forceinline__ void comp_add(T& x, T& c, T delta) {
  const T y = add_rn(delta, c);
  const T t = add_rn(x, y);
  c = abs_(x) >= abs_(y) ? add_rn(sub_rn(x, t), y) : add_rn(sub_rn(y, t), x);
  x = t;
}

// The particle a thread sums for (its position, remainder and partial sums).
template <typename T>
struct DenseMe {
  int i;
  bool live;
  T x, y, z, lx, ly, lz;
  T fx, fy, fz;
};

// Pairs of `me` with the staged columns [c0, c1), column c0 at s[0] and row
// k at s + k * ld. The thread takes j = c0 + ((slice - c0) mod S), then
// every S-th column: the same increasing order whatever the chunking.
template <typename T, bool EXT, bool GATE>
__device__ __forceinline__ void dense_range(const DenseArgs<T>& p, DenseMe<T>& me, const T* s,
                                            int ld, int c0, int c1, int first_j, bool fwd,
                                            bool bwd) {
  const int S = p.slices;
  // Unrolled by 2 rather than as the compiler chooses: faster on the H100 at
  // N=4000 and N=62500 in both precisions, and float64 then fits 3 blocks an
  // SM (fewer registers).
#pragma unroll 2
  for (int j = first_j; j < c1; j += S) {
    const int jj = j - c0;
    T dx = sub_rn(me.x, s[jj]);
    T dy = sub_rn(me.y, s[ld + jj]);
    T dz = sub_rn(me.z, s[2 * ld + jj]);
    if (EXT) {
      dx = add_rn(dx, sub_rn(me.lx, s[3 * ld + jj]));
      dy = add_rn(dy, sub_rn(me.ly, s[4 * ld + jj]));
      dz = add_rn(dz, sub_rn(me.lz, s[5 * ld + jj]));
    }
    dx = min_image(dx, p.box, p.inv_box);
    dy = min_image(dy, p.box, p.inv_box);
    dz = min_image(dz, p.box, p.inv_box);
    const T r2 = add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz));
    bool mask = me.live && (j != me.i) && (r2 < p.rc2);
    if (GATE) mask = mask && (j > me.i ? fwd : bwd);
    const PairTerms<T> pt = lj_pair_terms<T, false>(r2, mask);
    me.fx = add_rn(me.fx, mul_rn(pt.coef, dx));
    me.fy = add_rn(me.fy, mul_rn(pt.coef, dy));
    me.fz = add_rn(me.fz, mul_rn(pt.coef, dz));
  }
}

// Pairs with a staged chunk [c0, c1) of the work item starting at i0;
// flagged: granule by granule of kFlagCols columns, each gated for the item
// as a whole (a granule with no gated-on pair is skipped).
template <typename T, bool EXT, bool FLAGS>
__device__ __forceinline__ void dense_chunk(const DenseArgs<T>& p, DenseMe<T>& me, const T* s,
                                            int ld, int c0, int c1, int i0, int ti, int slice) {
  const int S = p.slices;
  if (!FLAGS) {
    dense_range<T, EXT, false>(p, me, s, ld, c0, c1, c0 + ((slice - c0) & (S - 1)), true, true);
    return;
  }
  const int n_j = p.n_pad / p.tile_j;
  for (int g0 = c0; g0 < c1; g0 += kFlagCols) {
    const int g1 = min(g0 + kFlagCols, c1);
    // The TPU tile of the pair: (it(i), jt(j)) forward (j > i), (it(j),
    // jt(i)) backward (j < i); one value each over the item and granule.
    const bool fwd = g1 - 1 > i0 && p.flags[(i0 / p.tile_i) * n_j + g0 / p.tile_j] > 0;
    const bool bwd = g0 < i0 + ti - 1 && p.flags[(g0 / p.tile_i) * n_j + i0 / p.tile_j] > 0;
    if (!fwd && !bwd) continue;
    dense_range<T, EXT, true>(p, me, s + (g0 - c0), ld, g0, g1, g0 + ((slice - g0) & (S - 1)),
                              fwd, bwd);
  }
}

template <typename T, bool EXT, bool FLAGS>
__global__ void __launch_bounds__(kDenseThreads, 2) fused_dense_kernel(DenseArgs<T> p) {
  // rbuf / lobuf hold two (8, n_pad) planes: step s reads plane s & 1 and
  // writes plane (s + 1) & 1. They are written by other blocks during the
  // launch, so they are read through plain (coherent) loads or cp.async.cg
  // (through L2), never __ldg.
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* red = reinterpret_cast<T*>(smem_raw);
  T* planes = red + kDenseWarps * 3;
  constexpr int kRows = EXT ? 6 : 3;

  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int S = p.slices;
  const int ti = kDenseThreads / S;
  const int slice = tid & (S - 1);
  const int pl = tid / S;
  const bool owner = slice == 0;
  const int n_items = p.n_pad / ti;
  const int n = p.n;
  const size_t plane = static_cast<size_t>(8) * p.n_pad;
  // Staged columns: [0, n) rounded up to the 128-column granule (<= n_pad,
  // every chunk a multiple of 16 bytes).
  const int n_cols = (n + kFlagCols - 1) / kFlagCols * kFlagCols;
  const int n_chunks = (n_cols + kDenseChunk - 1) / kDenseChunk;
  const int width = S < 32 ? S : 32;

  for (int s = 0; s < p.n_steps; ++s) {
    const T* r_cur = p.rbuf + (s & 1) * plane;
    T* r_new = p.rbuf + ((s + 1) & 1) * plane;
    const T* lo_cur = EXT ? p.lobuf + (s & 1) * plane : nullptr;
    T* lo_new = EXT ? p.lobuf + ((s + 1) & 1) * plane : nullptr;

    // Phase 1: position update + first half-kick (verlet.f90:58-74).
    if (owner) {
      for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
        const int i = w * ti + pl;
        if (i >= n) continue;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int k = c * p.n_pad + i;
          if (EXT) {
            const T delta = add_rn(mul_rn(add_rn(p.v[k], p.vc[k]), p.dt),
                                   mul_rn(p.a[k], p.half_dt_sq));
            T x = r_cur[k];
            T lo = lo_cur[k];
            comp_add(x, lo, delta);
            r_new[k] = x;
            lo_new[k] = lo;
            T vk = p.v[k];
            T ck = p.vc[k];
            comp_add(vk, ck, mul_rn(p.a[k], p.half_dt));
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

    // Phase 2: stage the new plane (resident: all of it, one commit group
    // per chunk), then forces at the new positions (all j != i) item by item.
    if (p.resident) {
      for (int c = 0; c < n_chunks; ++c) {
        const int c0 = c * kDenseChunk;
        stage_rows(planes + c0, p.n_pad, r_new, lo_new, p.n_pad, kRows, c0,
                   min(kDenseChunk, n_cols - c0), tid, kDenseThreads);
        cp_async_commit();
      }
    }
    bool first = true;
    for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
      const int i0 = w * ti;
      DenseMe<T> me;
      me.i = i0 + pl;
      me.live = me.i < n;
      me.x = me.live ? r_new[me.i] : T(0);
      me.y = me.live ? r_new[p.n_pad + me.i] : T(0);
      me.z = me.live ? r_new[2 * p.n_pad + me.i] : T(0);
      me.lx = me.ly = me.lz = T(0);
      if (EXT && me.live) {
        me.lx = lo_new[me.i];
        me.ly = lo_new[p.n_pad + me.i];
        me.lz = lo_new[2 * p.n_pad + me.i];
      }
      me.fx = me.fy = me.fz = T(0);
      if (p.resident) {
        for (int c = 0; c < n_chunks; ++c) {
          if (first) {  // block-uniform: the first item waits chunk by chunk
            cp_async_wait(n_chunks - 1 - c);
            __syncthreads();
          }
          const int c0 = c * kDenseChunk;
          dense_chunk<T, EXT, FLAGS>(p, me, planes + c0, p.n_pad, c0, min(c0 + kDenseChunk, n),
                                     i0, ti, slice);
        }
        first = false;
      } else {
        const int ld = kDenseChunk;
        const int buf = kRows * kDenseChunk;
        if (n_chunks > 0) {
          stage_rows(planes, ld, r_new, lo_new, p.n_pad, kRows, 0, min(kDenseChunk, n_cols), tid,
                     kDenseThreads);
          cp_async_commit();
        }
        for (int c = 0; c < n_chunks; ++c) {
          if (c + 1 < n_chunks) {
            const int c0n = (c + 1) * kDenseChunk;
            stage_rows(planes + ((c + 1) % kDenseRing) * buf, ld, r_new, lo_new, p.n_pad, kRows,
                       c0n, min(kDenseChunk, n_cols - c0n), tid, kDenseThreads);
            cp_async_commit();
            cp_async_wait(1);
          } else {
            cp_async_wait(0);
          }
          // Chunk c has landed for every thread; the buffer chunk c + 2 will
          // use was last read two chunks ago, before this barrier's previous
          // pass.
          __syncthreads();
          const int c0 = c * kDenseChunk;
          dense_chunk<T, EXT, FLAGS>(p, me, planes + (c % kDenseRing) * buf, ld, c0,
                                     min(c0 + kDenseChunk, n), i0, ti, slice);
        }
      }

      // The S partial sums of the particle, in a fixed order.
      for (int off = width >> 1; off > 0; off >>= 1) {
        me.fx = add_rn(me.fx, __shfl_down_sync(0xffffffffu, me.fx, off, width));
        me.fy = add_rn(me.fy, __shfl_down_sync(0xffffffffu, me.fy, off, width));
        me.fz = add_rn(me.fz, __shfl_down_sync(0xffffffffu, me.fz, off, width));
      }
      if (S > 32) {
        const int warp = tid >> 5;
        if ((tid & 31) == 0) {
          red[warp * 3] = me.fx;
          red[warp * 3 + 1] = me.fy;
          red[warp * 3 + 2] = me.fz;
        }
        __syncthreads();
        if (owner) {
          for (int q = 1; q < S / 32; ++q) {
            me.fx = add_rn(me.fx, red[(warp + q) * 3]);
            me.fy = add_rn(me.fy, red[(warp + q) * 3 + 1]);
            me.fz = add_rn(me.fz, red[(warp + q) * 3 + 2]);
          }
        }
      }

      // a = 24 * raw sweep (lj_potential_energy.f90:192) + second half-kick.
      if (owner && me.live) {
        const T f[3] = {me.fx, me.fy, me.fz};
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int k = c * p.n_pad + me.i;
          const T ak = mul_rn(T(24), f[c]);
          p.a[k] = ak;
          if (EXT) {
            T vk = p.v[k];
            T ck = p.vc[k];
            comp_add(vk, ck, mul_rn(ak, p.half_dt));
            p.v[k] = vk;
            p.vc[k] = ck;
          } else {
            p.v[k] = add_rn(p.v[k], mul_rn(ak, p.half_dt));
          }
        }
      }
      __syncthreads();  // `red` and the ring buffers are reused by the next item
    }
    // The next step's phase 1 touches only the owners' own v / a and the
    // other position plane; the staged plane is rewritten only after the
    // next grid barrier.
  }
}

// R replicas (header): rbuf / lobuf hold two sets of R (8, n_pad) planes
// (step s reads set s & 1 and writes set (s + 1) & 1), v / vc / a R planes;
// replica q's plane at q * 8 * n_pad of each.
template <typename T, bool EXT>
__global__ void __launch_bounds__(kDenseThreads, 2)
fused_replicas_kernel(DenseArgs<T> p, int replicas) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* red = reinterpret_cast<T*>(smem_raw);
  T* planes = red + kDenseWarps * 3;
  constexpr int kRows = EXT ? 6 : 3;

  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int S = p.slices;
  const int ti = kDenseThreads / S;
  const int slice = tid & (S - 1);
  const int pl = tid / S;
  const bool owner = slice == 0;
  const int n_items = p.n_pad / ti;  // a replica's
  const int n = p.n;
  const size_t plane = static_cast<size_t>(8) * p.n_pad;
  const size_t set = plane * replicas;
  // This block's work items, the same in both phases of every step (the
  // owner thread of a particle alone touches its v, a and vc).
  const int all_items = n_items * replicas;
  const int per = (all_items + gridDim.x - 1) / gridDim.x;
  const int w_first = blockIdx.x * per;
  const int w_end = min(all_items, w_first + per);
  const int n_cols = (n + kFlagCols - 1) / kFlagCols * kFlagCols;
  const int n_chunks = (n_cols + kDenseChunk - 1) / kDenseChunk;
  const int width = S < 32 ? S : 32;

  for (int s = 0; s < p.n_steps; ++s) {
    const T* r_cur0 = p.rbuf + (s & 1) * set;
    T* r_new0 = p.rbuf + ((s + 1) & 1) * set;
    const T* lo_cur0 = EXT ? p.lobuf + (s & 1) * set : nullptr;
    T* lo_new0 = EXT ? p.lobuf + ((s + 1) & 1) * set : nullptr;

    // Phase 1: position update + first half-kick (verlet.f90:58-74).
    if (owner) {
      for (int w = w_first; w < w_end; ++w) {
        const int q = w / n_items;
        const int i = (w - q * n_items) * ti + pl;
        if (i >= n) continue;
        const size_t off = q * plane;
        const T* r_cur = r_cur0 + off;
        T* r_new = r_new0 + off;
        T* v = p.v + off;
        T* a = p.a + off;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int k = c * p.n_pad + i;
          if (EXT) {
            T* vc = p.vc + off;
            const T delta = add_rn(mul_rn(add_rn(v[k], vc[k]), p.dt), mul_rn(a[k], p.half_dt_sq));
            T x = r_cur[k];
            T lo = lo_cur0[off + k];
            comp_add(x, lo, delta);
            r_new[k] = x;
            lo_new0[off + k] = lo;
            T vk = v[k];
            T ck = vc[k];
            comp_add(vk, ck, mul_rn(a[k], p.half_dt));
            v[k] = vk;
            vc[k] = ck;
          } else {
            r_new[k] = add_rn(add_rn(r_cur[k], mul_rn(v[k], p.dt)), mul_rn(a[k], p.half_dt_sq));
            v[k] = add_rn(v[k], mul_rn(a[k], p.half_dt));
          }
        }
      }
    }
    grid.sync();

    // Phase 2: forces at the new positions (all j != i) item by item;
    // resident, the item's replica plane is staged (all of it, one commit
    // group per chunk) where the block has not staged it yet this step.
    bool first = true;
    int staged = -1;
    for (int w = w_first; w < w_end; ++w) {
      const int q = w / n_items;
      const int i0 = (w - q * n_items) * ti;
      const size_t off = q * plane;
      const T* r_new = r_new0 + off;
      const T* lo_new = EXT ? lo_new0 + off : nullptr;
      if (p.resident && q != staged) {
        // The previous item (or step) ended in a barrier: no thread still
        // reads the staged plane.
        for (int c = 0; c < n_chunks; ++c) {
          const int c0 = c * kDenseChunk;
          stage_rows(planes + c0, p.n_pad, r_new, lo_new, p.n_pad, kRows, c0,
                     min(kDenseChunk, n_cols - c0), tid, kDenseThreads);
          cp_async_commit();
        }
        staged = q;
        first = true;
      }
      DenseMe<T> me;
      me.i = i0 + pl;
      me.live = me.i < n;
      me.x = me.live ? r_new[me.i] : T(0);
      me.y = me.live ? r_new[p.n_pad + me.i] : T(0);
      me.z = me.live ? r_new[2 * p.n_pad + me.i] : T(0);
      me.lx = me.ly = me.lz = T(0);
      if (EXT && me.live) {
        me.lx = lo_new[me.i];
        me.ly = lo_new[p.n_pad + me.i];
        me.lz = lo_new[2 * p.n_pad + me.i];
      }
      me.fx = me.fy = me.fz = T(0);
      if (p.resident) {
        for (int c = 0; c < n_chunks; ++c) {
          if (first) {  // block-uniform: the first item of a plane waits chunk by chunk
            cp_async_wait(n_chunks - 1 - c);
            __syncthreads();
          }
          const int c0 = c * kDenseChunk;
          dense_chunk<T, EXT, false>(p, me, planes + c0, p.n_pad, c0, min(c0 + kDenseChunk, n),
                                     i0, ti, slice);
        }
        first = false;
      } else {
        const int ld = kDenseChunk;
        const int buf = kRows * kDenseChunk;
        if (n_chunks > 0) {
          stage_rows(planes, ld, r_new, lo_new, p.n_pad, kRows, 0, min(kDenseChunk, n_cols), tid,
                     kDenseThreads);
          cp_async_commit();
        }
        for (int c = 0; c < n_chunks; ++c) {
          if (c + 1 < n_chunks) {
            const int c0n = (c + 1) * kDenseChunk;
            stage_rows(planes + ((c + 1) % kDenseRing) * buf, ld, r_new, lo_new, p.n_pad, kRows,
                       c0n, min(kDenseChunk, n_cols - c0n), tid, kDenseThreads);
            cp_async_commit();
            cp_async_wait(1);
          } else {
            cp_async_wait(0);
          }
          __syncthreads();
          const int c0 = c * kDenseChunk;
          dense_chunk<T, EXT, false>(p, me, planes + (c % kDenseRing) * buf, ld, c0,
                                     min(c0 + kDenseChunk, n), i0, ti, slice);
        }
      }

      // The S partial sums of the particle, in a fixed order.
      for (int o = width >> 1; o > 0; o >>= 1) {
        me.fx = add_rn(me.fx, __shfl_down_sync(0xffffffffu, me.fx, o, width));
        me.fy = add_rn(me.fy, __shfl_down_sync(0xffffffffu, me.fy, o, width));
        me.fz = add_rn(me.fz, __shfl_down_sync(0xffffffffu, me.fz, o, width));
      }
      if (S > 32) {
        const int warp = tid >> 5;
        if ((tid & 31) == 0) {
          red[warp * 3] = me.fx;
          red[warp * 3 + 1] = me.fy;
          red[warp * 3 + 2] = me.fz;
        }
        __syncthreads();
        if (owner) {
          for (int qq = 1; qq < S / 32; ++qq) {
            me.fx = add_rn(me.fx, red[(warp + qq) * 3]);
            me.fy = add_rn(me.fy, red[(warp + qq) * 3 + 1]);
            me.fz = add_rn(me.fz, red[(warp + qq) * 3 + 2]);
          }
        }
      }

      // a = 24 * raw sweep + second half-kick.
      if (owner && me.live) {
        const T f[3] = {me.fx, me.fy, me.fz};
        T* v = p.v + off;
        T* a = p.a + off;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int k = c * p.n_pad + me.i;
          const T ak = mul_rn(T(24), f[c]);
          a[k] = ak;
          if (EXT) {
            T* vc = p.vc + off;
            T vk = v[k];
            T ck = vc[k];
            comp_add(vk, ck, mul_rn(ak, p.half_dt));
            v[k] = vk;
            vc[k] = ck;
          } else {
            v[k] = add_rn(v[k], mul_rn(ak, p.half_dt));
          }
        }
      }
      __syncthreads();  // `red` and the staged planes are reused by the next item
    }
  }
}

// BATCH: the replica kernel's (FLAGS false).
template <typename T, bool EXT, bool FLAGS, bool BATCH>
int dense_plan(int n_pad, int slices, int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, optin = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* fn = BATCH ? reinterpret_cast<const void*>(fused_replicas_kernel<T, EXT>)
                        : reinterpret_cast<const void*>(fused_dense_kernel<T, EXT, FLAGS>);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Resident where the whole plane fits with two blocks an SM.
  int resident = 0, per_sm = 0;
  const size_t res_bytes = dense_smem_bytes<T, EXT>(1, n_pad);
  if (res_bytes <= static_cast<size_t>(optin)) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kDenseThreads, res_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = per_sm >= 2;
  }
  const size_t bytes = dense_smem_bytes<T, EXT>(resident, n_pad);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kDenseThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);  // no grid barrier
  if (slices <= 0) {
    // One round where one fits: the largest S whose work items all run at
    // once on the resident blocks, with at least kMinCols columns a thread.
    // Else (large N) the S whose rounds waste the fewest block slots, the
    // smallest on a tie, at most 8 (a streamed column feeds >= 32 particles:
    // each work item streams the whole plane through L2).
    const long long resident_blocks = static_cast<long long>(per_sm) * sms;
    const int s_max = resident ? kMaxSlices : 8;
    slices = 0;
    for (int s = kMinSlices; s <= s_max; s *= 2) {
      const long long items = static_cast<long long>(n_pad) * s / kDenseThreads;
      if (items <= resident_blocks && n_pad / s >= kMinCols) slices = s;
    }
    if (slices == 0) {
      double best = 0.0;
      for (int s = kMinSlices; s <= s_max; s *= 2) {
        const long long items = static_cast<long long>(n_pad) * s / kDenseThreads;
        const long long rounds = (items + resident_blocks - 1) / resident_blocks;
        const double waste = static_cast<double>(rounds * resident_blocks) / items;
        if (slices == 0 || waste < best - 1e-9) {
          best = waste;
          slices = s;
        }
      }
    }
  } else if (slices < kMinSlices || slices > kMaxSlices || (slices & (slices - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  out[0] = slices;
  out[1] = resident;
  out[2] = per_sm;
  out[3] = sms;
  out[4] = static_cast<int>(bytes);
  return 0;
}

template <typename T, bool EXT>
int launch_fused(DenseArgs<T> p, int replicas, int blocks, void* stream) {
  void* args[] = {&p, &replicas};
  const void* fn =
      replicas > 1 ? reinterpret_cast<const void*>(fused_replicas_kernel<T, EXT>)
      : p.flags    ? reinterpret_cast<const void*>(fused_dense_kernel<T, EXT, true>)
                   : reinterpret_cast<const void*>(fused_dense_kernel<T, EXT, false>);
  cudaError_t err = cudaLaunchCooperativeKernel(
      fn, dim3(blocks), dim3(kDenseThreads), args, dense_smem_bytes<T, EXT>(p.resident, p.n_pad),
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the sticky launch error
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fused_any(T* rbuf, T* lobuf, T* v, T* vc, T* a, int n, int n_pad, int replicas, T box,
                     T inv_box, T rc2, T dt, T half_dt, T half_dt_sq, int n_steps, int extended,
                     const int* flags, int tile_i, int tile_j, int slices, int resident,
                     int blocks, void* stream) {
  if (replicas < 1 || (flags && replicas > 1)) return static_cast<int>(cudaErrorInvalidValue);
  const DenseArgs<T> p{rbuf, lobuf, v, vc, a, n, n_pad, box, inv_box, rc2, dt, half_dt,
                       half_dt_sq, n_steps, flags, tile_i, tile_j, slices, resident};
  return extended ? launch_fused<T, true>(p, replicas, blocks, stream)
                  : launch_fused<T, false>(p, replicas, blocks, stream);
}

}  // namespace ljmd

extern "C" {

int ljmd_fused_block_threads() { return ljmd::kDenseThreads; }

// The launch shape of a variant at n_pad: out = {slices, resident, blocks an
// SM can hold (occupancy API, at the shared memory the launch will use),
// SMs, dynamic shared memory bytes}. `slices` > 0 asks for that S (a power
// of two in [4, 256]); 0 lets the occupancy rule choose. `batched`: the
// replica kernel's (R > 1; ask with the one-replica plan's S). Sets the
// kernel's dynamic shared memory limit to the card's opt-in maximum.
int ljmd_fused_plan(int dtype_bytes, int extended, int flagged, int batched, int n_pad,
                    int slices, int* out) {
  using ljmd::dense_plan;
  if (flagged && batched) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype_bytes == 4) {
    if (flagged) {
      return extended ? dense_plan<float, true, true, false>(n_pad, slices, out)
                      : dense_plan<float, false, true, false>(n_pad, slices, out);
    }
    if (batched) {
      return extended ? dense_plan<float, true, false, true>(n_pad, slices, out)
                      : dense_plan<float, false, false, true>(n_pad, slices, out);
    }
    return extended ? dense_plan<float, true, false, false>(n_pad, slices, out)
                    : dense_plan<float, false, false, false>(n_pad, slices, out);
  }
  if (flagged) {
    return extended ? dense_plan<double, true, true, false>(n_pad, slices, out)
                    : dense_plan<double, false, true, false>(n_pad, slices, out);
  }
  if (batched) {
    return extended ? dense_plan<double, true, false, true>(n_pad, slices, out)
                    : dense_plan<double, false, false, true>(n_pad, slices, out);
  }
  return extended ? dense_plan<double, true, false, false>(n_pad, slices, out)
                  : dense_plan<double, false, false, false>(n_pad, slices, out);
}

// `replicas` R >= 1: rbuf / lobuf are (2, R, 8, n_pad), v / vc / a (R, 8,
// n_pad); R > 1 launches the replica kernel (no flags). `blocks` (1 .. R *
// n_pad * slices / 256, at most the plan's blocks an SM x SMs) is the
// persistent grid; `slices` and `resident` as the plan gave them (the plan
// must have run for this variant); `flags` null runs every pair (kernels 3
// and 4).
int ljmd_fused_dense_chunk_f32(float* rbuf, float* lobuf, float* v, float* vc, float* a, int n,
                               int n_pad, int replicas, float box, float inv_box, float rc2,
                               float dt, float half_dt, float half_dt_sq, int n_steps,
                               int extended, const int* flags, int tile_i, int tile_j,
                               int slices, int resident, int blocks, void* stream) {
  return ljmd::launch_fused_any<float>(rbuf, lobuf, v, vc, a, n, n_pad, replicas, box, inv_box,
                                       rc2, dt, half_dt, half_dt_sq, n_steps, extended, flags,
                                       tile_i, tile_j, slices, resident, blocks, stream);
}

int ljmd_fused_dense_chunk_f64(double* rbuf, double* lobuf, double* v, double* vc, double* a,
                               int n, int n_pad, int replicas, double box, double inv_box,
                               double rc2, double dt, double half_dt, double half_dt_sq,
                               int n_steps, int extended, const int* flags, int tile_i,
                               int tile_j, int slices, int resident, int blocks, void* stream) {
  return ljmd::launch_fused_any<double>(rbuf, lobuf, v, vc, a, n, n_pad, replicas, box, inv_box,
                                        rc2, dt, half_dt, half_dt_sq, n_steps, extended, flags,
                                        tile_i, tile_j, slices, resident, blocks, stream);
}

}  // extern "C"
