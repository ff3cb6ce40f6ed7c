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
// (about 3.5M pair-once candidates a step at N = 4000 on a jittered
// lattice, evaluated from both sides: less than half of what the dense
// chunk runs), with one grid barrier a step. The earlier port ran 32 particles x 4
// threads a block (4 warps an SM at N = 4000; 28 blocks on 132 SMs at N =
// 864), walked every visit of every category on every step in every block,
// had the four 32-particle blocks of a 128-column granule stage the same
// partners each, synchronously with two barriers a stage, and paid the LJ
// algebra on every candidate.
//
// What the design does about that (kernel 3's layout, fused_dense_chunk.cu):
// - A block is 256 threads: TI = 256 / S particles, S threads each taking
//   the partners slice, slice + S, ... of each 128-column stage. S (a power
//   of two, 4..64) comes from the occupancy API (ljmd_list_plan): the
//   largest S whose n_pad / TI work items all run at once on the blocks the
//   card keeps resident (N = 4000: S = 16; N = 864: S = 64), else the S <= 8
//   whose rounds waste the fewest block slots. The S partial sums of a
//   particle are added by warp shuffles, then for S > 32 in shared memory,
//   in a fixed order with no atomics: the sum does not depend on the grid,
//   and a capped grid is bit-identical.
// - The position plane (3 rows, 6 extended) is copied into shared memory
//   once a step, right after the grid barrier, with cp.async, where it fits
//   with two blocks an SM (N = 4000: 48 KB float32, 96 KB float64 or
//   extended); above that (the slab-sorted geometry at N >= 10000) each
//   work item streams its stages through a ring of three 128-column
//   buffers, stage c + 1 in flight while stage c is computed.
// - A visit plan, built once per launch: the lists do not change inside a
//   chunk, so at the start of the launch the blocks gather, for every
//   128-column granule, the stages of the visits that touch it (a
//   block-wide scan over the visits, in list order) into a scratch the
//   wrapper allocates, and the grid waits once: a visit whose i-block is
//   the granule gives its j columns, 128 at a time ("forward", with its
//   category's x / z rounds and mask); a visit whose j columns hold the
//   granule gives its 128 i rows ("backward", the mask read from the other
//   side). A granule has at most 3 n_b + span such stages (a row's visits
//   start >= span blocks apart, and at most two of them hold a given
//   block), which sizes the scratch (ops/fused_list.py `list_plan_stages`
//   is the same rule as plain torch). Each step a work item reads its
//   granule's entries (a few dozen, from L1). No device operation is added
//   to the resort. (A plan kept in dynamic shared memory beside the plane
//   lost its entry counts in the float64 and extended builds on the H100:
//   PERF.md §6.)
// - Every listed window is evaluated from both sides (pair-twice): a
//   particle's v, a and forces are only ever written by its own thread, and
//   one grid barrier a step suffices (positions double-buffered: step s
//   reads plane s & 1 and writes the other). Observables are summed on the
//   forward stages only. fl(xi - xj) = -fl(xj - xi) and rint is odd, so both
//   sides see the TPU kernel's pair values; only the summation order
//   differs.
// - The warp votes on its lanes' masks and runs the LJ algebra only where
//   one holds (the cull of pencil_cull.cuh): ~45% of warp iterations run
//   the body at N = 4000 (z-sorted columns give a warp less locality than
//   a pencil's slots); the cull still beat the plain loop by 3-10% on the
//   H100 at N = 4000 and 864 in both precisions (PERF.md §6), so it is the
//   only build.
//
// Replicas (the batched zsort engine; the JAX package vmaps the Pallas
// kernel): the REPLICAS instantiation of the same kernel, whose offsets fold
// away in the one-system one (that one keeps its code and registers). Each
// replica has its own lists and counts, and its own visit plans in the
// global scratch (R x n_b granules, gathered by the grid at the start of the
// launch). The work items of all R replicas form one list, replica q's at q
// * (n_pad / TI) ..., and each block takes a contiguous run of them, so it
// restages a resident plane only when the replica changes. A work item never
// mixes replicas and S is the one-replica plan's, so a particle's sums run
// in the order of a launch of its replica alone: replica q equals that launch
// bit for bit, under any grid. The grid barrier is shared.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "lj_pair_terms.cuh"

namespace cg = cooperative_groups;

namespace ljmd {

constexpr int kListThreads = 256;  // threads of a block (8 warps)
constexpr int kListWarps = kListThreads / 32;
constexpr int kListGran = 128;     // block granule of the lists (tile_i) and stage width
constexpr int kListRing = 3;       // streaming buffers
constexpr int kListMaxCats = 11;   // 4 categories + at most 7 tails
constexpr int kListMinSlices = 4;
constexpr int kListMaxSlices = 64;
constexpr int kListMinCols = 2;    // stage columns a thread at least

template <typename T>
struct ListArgs {
  T* rbuf;   // (2, 8, n_pad) position planes
  T* lobuf;  // (2, 8, n_pad) remainder planes (extended)
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
  int slices;       // threads a particle, a power of two in [4, 64]
  int resident;     // 1: the whole position plane is staged once a step
  int2* plan;       // (n_b, plan_stride) scratch: each granule's plan entries
  int* plan_n;      // (n_b,) scratch: each granule's entry count
  int plan_stride;  // stages a granule's plan holds (3 n_b + span)
};

// A plan entry: the first column of a 128-column stage and its meta word
// (bit 0 forward, 1 masked, 2 x round, 3 z round, bits 4.. the jmin block).
constexpr int kFwd = 1, kMasked = 2, kMicX = 4, kMicZ = 8;

// Dynamic shared memory: the cross-warp partial sums, then the staged
// positions (resident: rows x n_pad; streaming: kListRing buffers of rows x
// 128).
template <typename T, bool EXT>
size_t list_smem_bytes(int resident, int n_pad) {
  const size_t rows = EXT ? 6 : 3;
  const size_t cols = resident ? static_cast<size_t>(n_pad) : kListRing * kListGran;
  return (kListWarps + rows * cols) * sizeof(T);
}

// Neumaier-compensated x += delta (as fused_dense_chunk.cu).
template <typename T>
__device__ __forceinline__ void comp_add_list(T& x, T& c, T delta) {
  const T y = add_rn(delta, c);
  const T t = add_rn(x, y);
  c = abs_(x) >= abs_(y) ? add_rn(sub_rn(x, t), y) : add_rn(sub_rn(y, t), x);
  x = t;
}

// The particle a thread sums for.
template <typename T>
struct ListMe {
  int i;
  T x, y, z, lx, ly, lz;
  T fx, fy, fz, e, du, ddu;
};

// Gather the stages of the visits touching granule g into dst (at most cap
// entries; the bound above keeps a pack kernel's lists within it), in list
// order, each visit's forward stages before its backward one; returns the
// count. Every thread of the block calls it.
template <typename T>
__device__ __forceinline__ int gather_plan(const ListArgs<T>& p, const int* cat_start, int n_cats, int g,
                           int2* dst, int cap, int* scan) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_vis = cat_start[n_cats];
  int base = 0;
  for (int v0 = 0; v0 < n_vis; v0 += kListThreads) {
    const int v = v0 + tid;
    int ib = 0, jb = 0, nf = 0, nb = 0, meta = 0;
    if (v < n_vis) {
      int cat = 0;
      while (v >= cat_start[cat + 1]) ++cat;
      const int t = v - cat_start[cat];
      const int lrow = cat < 4 ? 2 * cat : 9 + 2 * (cat - 4);
      ib = p.tiles[static_cast<size_t>(lrow) * p.max_t + t];
      jb = p.tiles[static_cast<size_t>(lrow + 1) * p.max_t + t];
      const int wb = cat < 4 ? p.span : cat - 3;  // width in blocks
      const int jmin = cat == 3 ? p.tiles[static_cast<size_t>(8) * p.max_t + t] : 0;
      meta = (cat >= 3 ? kMasked : 0) | (cat != 0 ? kMicX : 0) | (cat >= 2 ? kMicZ : 0) |
             (jmin << 4);
      nf = ib == g ? wb : 0;
      nb = (g >= jb && g < jb + wb) ? 1 : 0;
    }
    const int c = nf + nb;
    int incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    if (lane == 31) scan[warp] = incl;
    __syncthreads();
    if (tid == 0) {
      int run = 0;
      for (int w = 0; w < kListWarps; ++w) {
        const int x = scan[w];
        scan[w] = run;
        run += x;
      }
      scan[kListWarps] = run;
    }
    __syncthreads();
    const int at = base + scan[warp] + incl - c;
    for (int d = 0; d < nf; ++d) {
      if (at + d < cap) dst[at + d] = make_int2((jb + d) * kListGran, meta | kFwd);
    }
    if (nb && at + nf < cap) dst[at + nf] = make_int2(ib * kListGran, meta);
    base += scan[kListWarps];
    __syncthreads();  // `scan` is rewritten by the next pass
  }
  return min(base, cap);
}

// Pairs of `me` with one staged 128-column stage (column col0 at s[0], row
// k at s + k * ld) of plan entry meta; the thread takes the columns slice,
// slice + S, ... The mask is read from me's side: (row, column) = (me,
// partner) forward, (partner, me) backward.
template <typename T, bool EXT, bool OBS>
__device__ __forceinline__ void list_stage(const ListArgs<T>& p, ListMe<T>& me, const T* s,
                                           int ld, int col0, int meta, int slice) {
  const int S = p.slices;
  const bool fwd = meta & kFwd;
  const bool masked = meta & kMasked;
  const bool mic_x = meta & kMicX;
  const bool mic_z = meta & kMicZ;
  const int jmin_col = (meta >> 4) * kListGran;
  for (int jj = slice; jj < kListGran; jj += S) {
    const int gq = col0 + jj;
    T dx = sub_rn(me.x, s[jj]);
    T dy = sub_rn(me.y, s[ld + jj]);
    T dz = sub_rn(me.z, s[2 * ld + jj]);
    if (EXT) {
      dx = add_rn(dx, sub_rn(me.lx, s[3 * ld + jj]));
      dy = add_rn(dy, sub_rn(me.ly, s[4 * ld + jj]));
      dz = add_rn(dz, sub_rn(me.lz, s[5 * ld + jj]));
    }
    if (mic_x) dx = min_image(dx, p.box, p.inv_box);
    dy = min_image(dy, p.box, p.inv_box);
    if (mic_z) dz = min_image(dz, p.box, p.inv_box);
    const T r2 = add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz));
    bool m = r2 < p.rc2;
    if (masked) {
      const int gr = fwd ? me.i : gq;
      const int gc = fwd ? gq : me.i;
      m = m && (gc > gr) && (gc < p.n) && (gr < p.n) && (gc >= jmin_col);
    }
    // A masked pair adds exact +-0 to sums that start at +0: a warp none of
    // whose lanes holds the mask skips the body and changes no bit.
    if (!__any_sync(0xffffffffu, m)) continue;
    const PairTerms<T> pt = lj_pair_terms<T, OBS>(r2, m);
    me.fx = add_rn(me.fx, mul_rn(pt.coef, dx));
    me.fy = add_rn(me.fy, mul_rn(pt.coef, dy));
    me.fz = add_rn(me.fz, mul_rn(pt.coef, dz));
    if (OBS && fwd) {
      me.e = add_rn(me.e, pt.e);
      me.du = add_rn(me.du, pt.du);
      me.ddu = add_rn(me.ddu, pt.ddu);
    }
  }
}

// Forces (and observables) of one work item over its plan entries.
template <typename T, bool EXT, bool OBS>
__device__ __forceinline__ void list_item(const ListArgs<T>& p, ListMe<T>& me, const int2* ent, int n_ent,
                          T* planes, const T* r_new, const T* lo_new, int slice) {
  constexpr int kRows = EXT ? 6 : 3;
  const int tid = threadIdx.x;
  if (p.resident) {
    for (int e = 0; e < n_ent; ++e) {
      const int2 en = ent[e];
      list_stage<T, EXT, OBS>(p, me, planes + en.x, p.n_pad, en.x, en.y, slice);
    }
    return;
  }
  const int buf = kRows * kListGran;
  if (n_ent > 0) {
    stage_rows(planes, kListGran, r_new, lo_new, p.n_pad, kRows, ent[0].x, kListGran, tid,
               kListThreads);
    cp_async_commit();
  }
  for (int e = 0; e < n_ent; ++e) {
    if (e + 1 < n_ent) {
      stage_rows(planes + ((e + 1) % kListRing) * buf, kListGran, r_new, lo_new, p.n_pad, kRows,
                 ent[e + 1].x, kListGran, tid, kListThreads);
      cp_async_commit();
      cp_async_wait(1);
    } else {
      cp_async_wait(0);
    }
    // Stage e has landed for every thread; the buffer stage e + 1 is copied
    // into was last read at stage e - 2, before the previous barrier.
    __syncthreads();
    list_stage<T, EXT, OBS>(p, me, planes + (e % kListRing) * buf, kListGran, ent[e].x,
                                  ent[e].y, slice);
  }
}

// The S partial sums of x over a particle's threads, in a fixed order:
// shuffles within groups of width = min(S, 32) lanes, then for S > 32 the
// warps' sums through red (shared). The particle's slice-0 thread holds the
// total. Every thread of the block calls it.
template <typename T>
__device__ __forceinline__ T slice_sum(T x, int S, int width, T* red, int tid) {
  for (int off = width >> 1; off > 0; off >>= 1) {
    x = add_rn(x, __shfl_down_sync(0xffffffffu, x, off, width));
  }
  if (S > 32) {
    const int warp = tid >> 5;
    __syncthreads();  // red's previous values have been read
    if ((tid & 31) == 0) red[warp] = x;
    __syncthreads();
    if ((tid & (S - 1)) == 0) {
      for (int q = 1; q < S / 32; ++q) x = add_rn(x, red[warp + q]);
    }
  }
  return x;
}

// One system, or (REPLICAS) the R replicas of a stack in one launch: rbuf /
// lobuf then hold two sets of R (8, n_pad) planes (step s reads set s & 1
// and writes set (s + 1) & 1), v / vc / a / obs R planes, replica q's plane
// at q * 8 * n_pad of each; tiles holds R lists at q * tiles_stride, tcounts
// R counts at q * (4 + n_tails); plan / plan_n hold the plans of the R x n_b
// granules, replica q's at q * n_b. In the one-system instantiation
// `replicas` and `tiles_stride` are unused and every replica offset folds
// to 0, so its code and registers are the kernel's as it was before it had
// replicas.
template <typename T, bool EXT, bool REPLICAS>
__global__ void __launch_bounds__(kListThreads, 2)
fused_list_kernel(ListArgs<T> p, int replicas, int tiles_stride) {
  // rbuf / lobuf: other blocks write them during the launch, so they are
  // read through plain loads or cp.async.cg (through L2), never __ldg.
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kRows = EXT ? 6 : 3;
  T* red = reinterpret_cast<T*>(smem_raw);
  T* planes = red + kListWarps;
  __shared__ int cat_start[kListMaxCats + 1];
  __shared__ int scan[kListWarps + 1];

  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int S = p.slices;
  const int ti = kListThreads / S;
  const int slice = tid & (S - 1);
  const int pl = tid / S;
  const bool owner = slice == 0;
  const int n_items = p.n_pad / ti;  // a replica's
  const size_t n_pad = p.n_pad;
  const size_t plane = 8 * n_pad;
  const size_t set = REPLICAS ? plane * replicas : plane;
  const int width = S < 32 ? S : 32;

  // The visit plan of every granule (of every replica's), once per launch:
  // block b gathers the plans of granules b, b + G, ... into the scratch,
  // each from its replica's lists, then the grid waits.
  const int n_cats = 4 + p.n_tails;
  const int n_b = p.n_pad / kListGran;
  if constexpr (REPLICAS) {
    int cats_of = -1;
    for (int gq = blockIdx.x; gq < replicas * n_b; gq += gridDim.x) {
      const int q = gq / n_b;
      if (q != cats_of) {
        __syncthreads();  // cat_start's previous values have been read
        if (tid == 0) {
          int run = 0;
          for (int c = 0; c < n_cats; ++c) {
            cat_start[c] = run;
            run += p.tcounts[q * n_cats + c];
          }
          cat_start[n_cats] = run;
        }
        __syncthreads();
        cats_of = q;
      }
      ListArgs<T> pq = p;
      pq.tiles = p.tiles + static_cast<size_t>(q) * tiles_stride;
      const int cnt = gather_plan(pq, cat_start, n_cats, gq - q * n_b,
                                  p.plan + static_cast<size_t>(gq) * p.plan_stride,
                                  p.plan_stride, scan);
      if (tid == 0) p.plan_n[gq] = cnt;
    }
  } else {
    if (tid == 0) {
      int run = 0;
      for (int c = 0; c < n_cats; ++c) {
        cat_start[c] = run;
        run += p.tcounts[c];
      }
      cat_start[n_cats] = run;
    }
    __syncthreads();
    for (int g = blockIdx.x; g < n_b; g += gridDim.x) {
      const int cnt = gather_plan(p, cat_start, n_cats, g,
                                  p.plan + static_cast<size_t>(g) * p.plan_stride,
                                  p.plan_stride, scan);
      if (tid == 0) p.plan_n[g] = cnt;
    }
  }
  grid.sync();

  // This block's work items, the same in both phases of every step (the
  // owner thread of a particle alone touches its v, a and vc): items
  // blockIdx.x, + G, ... of one system; with REPLICAS a contiguous run of
  // the R replicas' items (replica q's at q * n_items ...), so that a block
  // restages a resident plane only when the replica changes.
  int w_first = 0, w_end = 0;
  if constexpr (REPLICAS) {
    const int all_items = n_items * replicas;
    const int per = (all_items + gridDim.x - 1) / gridDim.x;
    w_first = blockIdx.x * per;
    w_end = min(all_items, w_first + per);
  }
  for (int s = 0; s < p.n_steps; ++s) {
    const T* r_cur0 = p.rbuf + (s & 1) * set;
    T* r_new0 = p.rbuf + ((s + 1) & 1) * set;
    const T* lo_cur0 = EXT ? p.lobuf + (s & 1) * set : nullptr;
    T* lo_new0 = EXT ? p.lobuf + ((s + 1) & 1) * set : nullptr;

    // Phase 1: drift + first half-kick of the block's own particles.
    if (owner) {
      for (int w = REPLICAS ? w_first : blockIdx.x; w < (REPLICAS ? w_end : n_items);
           w += REPLICAS ? 1 : gridDim.x) {
        const int q = REPLICAS ? w / n_items : 0;
        const int i = (w - q * n_items) * ti + pl;
        if (i >= p.n) continue;
        const size_t off = REPLICAS ? q * plane : 0;
        const T* r_cur = r_cur0 + off;
        T* r_new = r_new0 + off;
        T* v = p.v + off;
        T* a = p.a + off;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const size_t k = c * n_pad + i;
          if (EXT) {
            T* vc = p.vc + off;
            const T delta =
                add_rn(mul_rn(add_rn(v[k], vc[k]), p.dt), mul_rn(a[k], p.half_dt_sq));
            T x = r_cur[k];
            T lo = lo_cur0[off + k];
            comp_add_list(x, lo, delta);
            r_new[k] = x;
            lo_new0[off + k] = lo;
            T vk = v[k];
            T ck = vc[k];
            comp_add_list(vk, ck, mul_rn(a[k], p.half_dt));
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

    // Phase 2: stage the new plane (resident; with REPLICAS item by item,
    // where the block has not staged the item's replica yet this step), then
    // forces over each work item's plan at the new positions.
    if constexpr (!REPLICAS) {
      if (p.resident) {
        stage_rows(planes, p.n_pad, r_new0, lo_new0, n_pad, kRows, 0, p.n_pad, tid,
                   kListThreads);
        cp_async_commit();
        cp_async_wait(0);
        __syncthreads();
      }
    }
    const bool want_obs = p.obs_last && s == p.n_steps - 1;
    int staged = -1;
    for (int w = REPLICAS ? w_first : blockIdx.x; w < (REPLICAS ? w_end : n_items);
         w += REPLICAS ? 1 : gridDim.x) {
      const int q = REPLICAS ? w / n_items : 0;
      const int i0 = (w - q * n_items) * ti;
      const size_t off = REPLICAS ? q * plane : 0;
      const T* r_new = r_new0 + off;
      const T* lo_new = EXT ? lo_new0 + off : nullptr;
      if constexpr (REPLICAS) {
        if (p.resident && q != staged) {
          // The previous item (or step) ended in a barrier: no thread still
          // reads the staged plane.
          stage_rows(planes, p.n_pad, r_new, lo_new, n_pad, kRows, 0, p.n_pad, tid,
                     kListThreads);
          cp_async_commit();
          cp_async_wait(0);
          __syncthreads();
          staged = q;
        }
      }
      ListMe<T> me;
      me.i = i0 + pl;
      me.x = r_new[me.i];
      me.y = r_new[n_pad + me.i];
      me.z = r_new[2 * n_pad + me.i];
      me.lx = me.ly = me.lz = T(0);
      if (EXT) {
        me.lx = lo_new[me.i];
        me.ly = lo_new[n_pad + me.i];
        me.lz = lo_new[2 * n_pad + me.i];
      }
      me.fx = me.fy = me.fz = me.e = me.du = me.ddu = T(0);
      const int g = (REPLICAS ? q * n_b : 0) + i0 / kListGran;
      const int2* ent = p.plan + static_cast<size_t>(g) * p.plan_stride;
      const int n_ent = p.plan_n[g];
      if (want_obs) {
        list_item<T, EXT, true>(p, me, ent, n_ent, planes, r_new, lo_new, slice);
      } else {
        list_item<T, EXT, false>(p, me, ent, n_ent, planes, r_new, lo_new, slice);
      }

      // The S partial sums of the particle, in a fixed order.
      const T fx = slice_sum(me.fx, S, width, red, tid);
      const T fy = slice_sum(me.fy, S, width, red, tid);
      const T fz = slice_sum(me.fz, S, width, red, tid);
      T e = T(0), du = T(0), ddu = T(0);
      if (want_obs) {
        e = slice_sum(me.e, S, width, red, tid);
        du = slice_sum(me.du, S, width, red, tid);
        ddu = slice_sum(me.ddu, S, width, red, tid);
      }

      // a = 24 * raw sweep + second half-kick; obs rows 3..5 on the last step.
      if (owner && me.i < p.n) {
        const T f[3] = {fx, fy, fz};
        const T o[3] = {e, du, ddu};
        T* v = p.v + off;
        T* a = p.a + off;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const size_t k2 = c * n_pad + me.i;
          const T ak = mul_rn(T(24), f[c]);
          a[k2] = ak;
          if (EXT) {
            T* vc = p.vc + off;
            T vk = v[k2];
            T ck = vc[k2];
            comp_add_list(vk, ck, mul_rn(ak, p.half_dt));
            v[k2] = vk;
            vc[k2] = ck;
          } else {
            v[k2] = add_rn(v[k2], mul_rn(ak, p.half_dt));
          }
          if (want_obs) p.obs[off + (3 + c) * n_pad + me.i] = o[c];
        }
      }
      __syncthreads();  // `red` and the staged planes are reused by the next item
    }
    // The next step's phase 1 touches only the owners' own v / a and the
    // other position plane; the staged plane is rewritten only after the
    // next grid barrier.
  }
}

// BATCH: the replica instantiation.
template <typename T, bool EXT, bool BATCH = false>
const void* list_kernel() {
  return reinterpret_cast<const void*>(fused_list_kernel<T, EXT, BATCH>);
}

// Blocks an SM at `bytes` of dynamic shared memory (the kernel's limit set
// first to what the card lets a block opt in to, less its static shared
// memory).
template <typename T, bool EXT, bool BATCH>
cudaError_t list_per_sm(size_t bytes, int optin, int* per_sm) {
  const void* fn = list_kernel<T, EXT, BATCH>();
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  const int limit = optin - static_cast<int>(attr.sharedSizeBytes);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  if (err != cudaSuccess) return err;
  *per_sm = 0;
  if (bytes > static_cast<size_t>(limit)) return cudaSuccess;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, kListThreads, bytes);
}

// The launch shape (see ljmd_list_plan; BATCH: the replica kernel's for
// `replicas` replicas, at the given S).
template <typename T, bool EXT, bool BATCH>
int list_plan(int n_pad, int slices, int grid_cap, int* out, int replicas = 1) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, optin = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((slices > 0 && (slices < kListMinSlices || slices > kListMaxSlices ||
                      (slices & (slices - 1)))) || (BATCH && slices <= 0) || replicas < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Resident where the whole plane fits with two blocks an SM.
  int per_sm = 0;
  err = list_per_sm<T, EXT, BATCH>(list_smem_bytes<T, EXT>(1, n_pad), optin, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int resident = per_sm >= 2;
  err = list_per_sm<T, EXT, BATCH>(list_smem_bytes<T, EXT>(resident, n_pad), optin, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);  // no grid barrier
  const long long resident_blocks = static_cast<long long>(per_sm) * sms;
  if (slices <= 0) {
    // One round where one fits: the largest S whose work items all run at
    // once on the resident blocks, with at least kListMinCols columns of a
    // stage a thread. Else the S <= 8 whose rounds waste the fewest block
    // slots, the smallest on a tie.
    slices = 0;
    for (int s = kListMinSlices; s <= kListMaxSlices; s *= 2) {
      const long long items = static_cast<long long>(n_pad) * s / kListThreads;
      if (items <= resident_blocks && kListGran / s >= kListMinCols) slices = s;
    }
    if (slices == 0) {
      double best = 0.0;
      for (int s = kListMinSlices; s <= 8; s *= 2) {
        const long long items = static_cast<long long>(n_pad) * s / kListThreads;
        const long long rounds = (items + resident_blocks - 1) / resident_blocks;
        const double waste = static_cast<double>(rounds * resident_blocks) / items;
        if (slices == 0 || waste < best - 1e-9) {
          best = waste;
          slices = s;
        }
      }
    }
  }
  const long long items = static_cast<long long>(n_pad) * slices / kListThreads * replicas;
  int blocks = static_cast<int>(items < resident_blocks ? items : resident_blocks);
  if (grid_cap > 0 && grid_cap < blocks) blocks = grid_cap;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, list_kernel<T, EXT, BATCH>());
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = slices;
  out[1] = resident;
  out[2] = per_sm;
  out[3] = sms;
  out[4] = static_cast<int>(list_smem_bytes<T, EXT>(resident, n_pad));
  out[5] = blocks;
  out[6] = attr.numRegs;
  out[7] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

template <typename T, bool EXT>
int launch_list(ListArgs<T> p, int blocks, void* stream, int replicas, int tiles_stride) {
  void* args[] = {&p, &replicas, &tiles_stride};
  cudaError_t err = cudaLaunchCooperativeKernel(
      replicas > 0 ? list_kernel<T, EXT, true>() : list_kernel<T, EXT, false>(), dim3(blocks),
      dim3(kListThreads), args, list_smem_bytes<T, EXT>(p.resident, p.n_pad),
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the launch error
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_list_any(T* rbuf, T* lobuf, T* v, T* vc, T* a, T* obs, const int* tiles,
                    const int* tcounts, int max_t, int n_tails, int span, int n, int n_pad, T box,
                    T inv_box, T rc2, T dt, T half_dt, T half_dt_sq, int n_steps, int obs_last,
                    int extended, int slices, int resident, int* plan, int* plan_n,
                    int plan_stride, int blocks, void* stream, int replicas = 0,
                    int tiles_stride = 0) {
  if (4 + n_tails > kListMaxCats || replicas < 0) return static_cast<int>(cudaErrorInvalidValue);
  const ListArgs<T> p{rbuf,    lobuf,    v,
                      vc,      a,        obs,
                      tiles,   tcounts,  max_t,
                      n_tails, span,     n,
                      n_pad,   box,      inv_box,
                      rc2,     dt,       half_dt,
                      half_dt_sq, n_steps, obs_last,
                      slices,  resident, reinterpret_cast<int2*>(plan),
                      plan_n,  plan_stride};
  return extended ? launch_list<T, true>(p, blocks, stream, replicas, tiles_stride)
                  : launch_list<T, false>(p, blocks, stream, replicas, tiles_stride);
}

}  // namespace ljmd

extern "C" {

int ljmd_list_block_threads() { return ljmd::kListThreads; }

// The launch shape of a variant at n_pad: out = {slices, resident, blocks an
// SM (occupancy API, at the shared memory the launch will use), SMs,
// dynamic shared memory bytes, the persistent grid, registers a thread,
// local (spill) bytes a thread}. `slices` > 0 asks for that S (a power of
// two in [4, 64]), 0 lets the occupancy rule choose; `grid_cap` > 0 caps
// the grid (tests and measurements). Sets the kernel's dynamic shared memory limit to the
// card's opt-in maximum.
int ljmd_list_plan(int dtype_bytes, int extended, int n_pad, int slices, int grid_cap,
                   int* out) {
  if (dtype_bytes == 4) {
    return extended ? ljmd::list_plan<float, true, false>(n_pad, slices, grid_cap, out)
                    : ljmd::list_plan<float, false, false>(n_pad, slices, grid_cap, out);
  }
  return extended ? ljmd::list_plan<double, true, false>(n_pad, slices, grid_cap, out)
                  : ljmd::list_plan<double, false, false>(n_pad, slices, grid_cap, out);
}

// The replica kernel's launch shape for `replicas` replicas at S = `slices`
// (the one-replica plan's; > 0): out as ljmd_list_plan's, the grid over all
// R replicas' work items.
int ljmd_list_replicas_plan(int dtype_bytes, int extended, int n_pad, int slices, int replicas,
                            int grid_cap, int* out) {
  if (dtype_bytes == 4) {
    return extended
               ? ljmd::list_plan<float, true, true>(n_pad, slices, grid_cap, out, replicas)
               : ljmd::list_plan<float, false, true>(n_pad, slices, grid_cap, out, replicas);
  }
  return extended
             ? ljmd::list_plan<double, true, true>(n_pad, slices, grid_cap, out, replicas)
             : ljmd::list_plan<double, false, true>(n_pad, slices, grid_cap, out, replicas);
}

// `slices`, `resident`, `blocks` as ljmd_list_plan gave them for the same
// variant; `plan` ((n_b * plan_stride * 2,)
// int32, plan_stride = 3 n_b + span) and `plan_n` ((n_b,) int32) are
// scratch the launch writes.
int ljmd_fused_dense_chunk_list_f32(float* rbuf, float* lobuf, float* v, float* vc, float* a,
                                    float* obs, const int* tiles, const int* tcounts, int max_t,
                                    int n_tails, int span, int n, int n_pad, float box,
                                    float inv_box, float rc2, float dt, float half_dt,
                                    float half_dt_sq, int n_steps, int obs_last, int extended,
                                    int slices, int resident, int* plan, int* plan_n,
                                    int plan_stride, int blocks, void* stream) {
  return ljmd::launch_list_any<float>(rbuf, lobuf, v, vc, a, obs, tiles, tcounts, max_t, n_tails,
                                      span, n, n_pad, box, inv_box, rc2, dt, half_dt, half_dt_sq,
                                      n_steps, obs_last, extended, slices, resident, plan, plan_n,
                                      plan_stride, blocks, stream);
}

int ljmd_fused_dense_chunk_list_f64(double* rbuf, double* lobuf, double* v, double* vc,
                                    double* a, double* obs, const int* tiles, const int* tcounts,
                                    int max_t, int n_tails, int span, int n, int n_pad,
                                    double box, double inv_box, double rc2, double dt,
                                    double half_dt, double half_dt_sq, int n_steps, int obs_last,
                                    int extended, int slices, int resident, int* plan,
                                    int* plan_n, int plan_stride, int blocks, void* stream) {
  return ljmd::launch_list_any<double>(rbuf, lobuf, v, vc, a, obs, tiles, tcounts, max_t,
                                       n_tails, span, n, n_pad, box, inv_box, rc2, dt, half_dt,
                                       half_dt_sq, n_steps, obs_last, extended, slices, resident,
                                       plan, plan_n, plan_stride, blocks, stream);
}

// R replicas in one launch (the replica kernel): rbuf / lobuf (2, R, 8,
// n_pad), v / vc / a / obs (R, 8, n_pad), tiles (R, 9 + 2 n_tails, max_t),
// tcounts (R, 4 + n_tails); `slices`, `resident`, `blocks` as
// ljmd_list_replicas_plan gave them; plan (R * n_b * plan_stride * 2,) and
// plan_n (R * n_b,) int32 scratch.
int ljmd_fused_dense_chunk_list_replicas_f32(
    float* rbuf, float* lobuf, float* v, float* vc, float* a, float* obs, const int* tiles,
    const int* tcounts, int max_t, int n_tails, int span, int n, int n_pad, int replicas,
    float box, float inv_box, float rc2, float dt, float half_dt, float half_dt_sq, int n_steps,
    int obs_last, int extended, int slices, int resident, int* plan, int* plan_n,
    int plan_stride, int blocks, void* stream) {
  if (replicas < 1) return static_cast<int>(cudaErrorInvalidValue);
  return ljmd::launch_list_any<float>(rbuf, lobuf, v, vc, a, obs, tiles, tcounts, max_t, n_tails,
                                      span, n, n_pad, box, inv_box, rc2, dt, half_dt, half_dt_sq,
                                      n_steps, obs_last, extended, slices, resident, plan, plan_n,
                                      plan_stride, blocks, stream, replicas,
                                      (9 + 2 * n_tails) * max_t);
}

int ljmd_fused_dense_chunk_list_replicas_f64(
    double* rbuf, double* lobuf, double* v, double* vc, double* a, double* obs, const int* tiles,
    const int* tcounts, int max_t, int n_tails, int span, int n, int n_pad, int replicas,
    double box, double inv_box, double rc2, double dt, double half_dt, double half_dt_sq,
    int n_steps, int obs_last, int extended, int slices, int resident, int* plan, int* plan_n,
    int plan_stride, int blocks, void* stream) {
  if (replicas < 1) return static_cast<int>(cudaErrorInvalidValue);
  return ljmd::launch_list_any<double>(rbuf, lobuf, v, vc, a, obs, tiles, tcounts, max_t,
                                       n_tails, span, n, n_pad, box, inv_box, rc2, dt, half_dt,
                                       half_dt_sq, n_steps, obs_last, extended, slices, resident,
                                       plan, plan_n, plan_stride, blocks, stream, replicas,
                                       (9 + 2 * n_tails) * max_t);
}

}  // extern "C"
