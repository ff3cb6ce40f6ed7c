// Kernel 10: n_steps of velocity Verlet over the window visit lists, in ONE
// launch.
//
// Replaces: ljmd_tpu/ops/pallas_fused.py:1383 `fused_dense_chunk_list` (its
// Pallas body `_fused_dense_list_kernel`, :1023) under the zsort engine's
// window contract (128-column granules, four categories, per-width tails,
// jmin prefix mask) in its plain, extended (r_lo / vc) and obs_last modes;
// the contract in full below.
//
// What bounds it on the H100: the candidates. The windows list every column
// whose granule's z interval lies within rc + skin, with no cull in x or y:
// ~1,925 ordered candidates a particle-step at N = 4000 against ~54 inside
// rc. The box test below leaves a warp ~34% of its runs at N = 4000 (the
// card counts 0.66 of the tested runs skipped, S = 16); nearly every run
// left runs the LJ body for a few of its 32 lanes, and those bodies now
// take most of the time.
//
// What the design does about that (the layout of kernel 3,
// fused_dense_chunk.cu, and a skip of far partners a warp at a time):
// - xy order: where the plane is resident and a warp takes at least
//   kListMinRuns runs of a stage (S <= 32; the SLOTS instantiation), each
//   granule's columns are ordered at the start of the launch by their cell
//   of a c x c grid in x and y (rows of cells in snake order, then z; c from
//   L and rc, ops/fused_list.py `list_cells`), a stable counting order of
//   the launch's positions. Work items, the staged plane and the runs follow
//   that order (slots); between steps the planes hold slot order, the
//   launch's input and output column order. Every stage is still one
//   granule, so the plan and its masks hold as they are: a mask reads the
//   partner's sorted column (own granule: from its slot; elsewhere the
//   slot's granule and its place among the real columns, which come first,
//   decide alike).
// - The box test: after each staging, the box (centre, half-width) of every
//   run of 16 slots (32 with S = 32) and, per work item, each warp's box of
//   its real particles. Per 32 stages a lane tests one stage's runs of the
//   warp; a run is skipped where per axis max(0, |mi(c_i - c_j)| - h_i - h_j
//   - 2^-19 L) (2^-48 L in float64), squared and summed, reaches rc^2 (1 +
//   2^-18) (float64: 1 + 2^-47): a lower bound of every pair's float r^2 whatever
//   the stage's rounds (minimum image only lowers a distance; the margins
//   cover the rounding of the boxes, the differences and the two-float
//   remainders), so a skipped run holds only pairs the mask drops, which
//   add exact +-0. A box holding a NaN or an infinity never skips. The
//   warps count the runs tested and skipped into a device counter (a block
//   adds its counts at the end of the launch and, with REPLICAS, each time
//   its items move to another replica: at most twice a step for a block
//   whose items straddle two; ops/fused_list.py `list_skip_counts` is the
//   same count in plain torch). With S = 64 (two runs a stage) the test
//   cost more than it saved on the H100, the streamed plane keeps the
//   column order, and so does a plane whose boxes would leave fewer than
//   two blocks an SM: all run the plain instantiation, sized alone (the
//   plan takes the blocks an SM of the instantiation it launches).
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
//   once a step, right after the grid barrier, with cp.async (the last
//   step's gathered through the order), where it fits with two blocks an
//   SM (N = 4000: 48 KB float32, 96 KB float64 or extended, beside 6 KB /
//   12 KB of boxes); above that (the slab-sorted geometry at N >= 10000)
//   each work item streams its stages through a ring of three 128-column
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
//   one holds (the cull of pencil_cull.cuh). A queue that gathered the
//   pairs inside rc, 32 a body, ran slower on the H100 than the vote.
//
// Contract: r, v, a (and r_lo, vc when extended) are (8, n_pad) row
// matrices in sorted column order, rows 3..7 and columns >= n zero, `a`
// 24-prefactored and consistent with r; no wrap inside the chunk. A pair
// contributes iff some visit covers it un-masked:
//   category 0 "free"   mask-free, no x and no z minimum-image round;
//   category 1 "x-only" mask-free, no z round;
//   category 2 "full"   mask-free, all three rounds;
//   category 3 "masked" all rounds, gj > gi, gj < n, gi < n, gj >= jmin*128;
//   tails (width w*128) all rounds, gj > gi, gj < n, gi < n.
// obs_last: the last step also sums the pair-once e/du/ddu partials of each
// visit's i side into rows 3..5 of `obs` (the caller restores 4 / 24).
//
// Replicas (the batched zsort engine; the JAX package vmaps the Pallas
// kernel): the REPLICAS instantiation of the same kernel. Each replica has
// its own lists and counts, its own visit plans and xy orders in the global
// scratch (R x n_b granules, made by the grid at the start of the launch).
// The work items of all R replicas form one list, replica q's at q *
// (n_pad / TI) ..., and each block takes a contiguous run of them, so it
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
constexpr int kListBoxCols = 16;   // the narrowest run of columns a box covers
constexpr int kListMinRuns = 4;    // runs a warp takes of a stage, at least, for the box test

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
  int resident;     // kPlane*: streamed, resident, resident with the xy order
  int2* plan;       // (n_b, plan_stride) scratch: each granule's plan entries
  int* plan_n;      // (n_b,) scratch: each granule's entry count
  int plan_stride;  // stages a granule's plan holds (3 n_b + span)
  int* perm;        // (n_pad,) scratch (SLOTS): the column at each slot of the xy order
  unsigned long long* skips;  // (2,) runs tested and skipped, added to; may be null
  int cells;        // c of the c x c xy grid of the order
  T cell_scale;     // c / L
};

// A plan entry: the first column of a 128-column stage and its meta word
// (bit 0 forward, 1 masked, 2 x round, 3 z round, bits 4.. the jmin block).
constexpr int kFwd = 1, kMasked = 2, kMicX = 4, kMicZ = 8;

// The position plane of a launch (`resident`, from the plan): streamed
// through a ring, resident in shared memory, or resident with the xy order
// and the box test (the SLOTS instantiation).
constexpr int kPlaneStreamed = 0, kPlaneResident = 1, kPlaneSlots = 2;

// Dynamic shared memory: the cross-warp partial sums, then the staged
// positions (resident: rows x n_pad; with the xy order also 6 values a box
// of n_pad / kListBoxCols runs at most and of each warp's particles;
// streamed: kListRing buffers of rows x 128).
template <typename T, bool EXT>
size_t list_smem_bytes(int plane, int n_pad) {
  const size_t rows = EXT ? 6 : 3;
  const size_t cols = plane != kPlaneStreamed ? static_cast<size_t>(n_pad)
                                              : kListRing * kListGran;
  const size_t boxes =
      plane == kPlaneSlots ? 6 * static_cast<size_t>(n_pad / kListBoxCols + kListWarps) : 0;
  return (kListWarps + rows * cols + boxes) * sizeof(T);
}

// The margins of the box test: eps_rel x L off every axis's gap (the
// rounding of the centres, half-widths, differences and two-float remainders
// is a few ulps of L) and rc^2 x (1 + rc2_rel) as the bar (the rounding of
// three squares and two sums, relative).
template <typename T>
struct BoxMargins;
template <>
struct BoxMargins<float> {
  static constexpr float eps_rel = 1.9073486328125e-06f;  // 2^-19 = 16 ulp(1)
  static constexpr float rc2_rel = 3.814697265625e-06f;   // 2^-18
};
template <>
struct BoxMargins<double> {
  static constexpr double eps_rel = 3.552713678800501e-15;  // 2^-48
  static constexpr double rc2_rel = 7.105427357601002e-15;  // 2^-47
};

// The cell of coordinate x along one axis of the c x c grid (NaN: cell 0).
template <typename T>
__device__ __forceinline__ int cell_coord(T x, T scale, int c) {
  const T f = mul_rn(x, scale);
  return f >= T(c - 1) ? c - 1 : (f >= T(1) ? static_cast<int>(f) : 0);
}

// Granule g's slots in xy order: the columns keyed by their xy cell (rows
// of cells in snake order; padding columns last), in a stable counting
// order, so that the order depends on the positions alone. r0 is the
// replica's plane at the start of the launch; perm gets the column of each
// slot. Every thread of the block calls it.
template <typename T>
__device__ __forceinline__ void granule_order(const ListArgs<T>& p, const T* r0, int g, int* perm,
                                              int* keys) {
  const int tid = threadIdx.x;
  const int col = g * kListGran + tid;
  const int c = p.cells;
  if (tid < kListGran) {
    int key = c * c;
    if (col < p.n) {
      const int cx = cell_coord(r0[col], p.cell_scale, c);
      const int cy = cell_coord(r0[p.n_pad + col], p.cell_scale, c);
      key = cy * c + ((cy & 1) ? c - 1 - cx : cx);
    }
    keys[tid] = key;
  }
  __syncthreads();
  if (tid < kListGran) {
    const int mine = keys[tid];
    int rank = 0;
    for (int j = 0; j < kListGran; ++j) {
      const int kj = keys[j];
      rank += (kj < mine || (kj == mine && j < tid)) ? 1 : 0;
    }
    perm[g * kListGran + rank] = col;
  }
  __syncthreads();  // `keys` is rewritten by the next granule
}

// Stage the replica's plane at the step's positions in slot order (rows 0..2
// from r, 3..5 from lo): copied as it lies where the positions are already
// in slot order (perm null), else gathered through perm (the last step's,
// which phase 1 writes in column order); then, where boxes is not null, the
// box of every run of wb slots: rows 0..2 the centres, 3..5 the
// half-widths, n_pad / wb runs each.
// A run holding a NaN or an infinity gets a NaN centre, which no test
// skips. Loads through L2: other blocks wrote the positions and the order.
template <typename T, bool EXT>
__device__ __forceinline__ void stage_slots(T* planes, T* boxes, const T* r, const T* lo,
                                            const int* perm, int n_pad, int wb, int tid) {
  constexpr int kRows = EXT ? 6 : 3;
  constexpr int kBatch = 8;  // columns a thread gathers at once
  if (perm == nullptr) {
    stage_rows(planes, n_pad, r, lo, static_cast<size_t>(n_pad), kRows, 0, n_pad, tid,
               kListThreads);
    cp_async_commit();
    cp_async_wait(0);
  } else {
    for (int c0 = 0; c0 < n_pad; c0 += kBatch * kListThreads) {
      int src[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int col = c0 + b * kListThreads + tid;
        src[b] = col < n_pad ? __ldcg(perm + col) : 0;
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const T* from = k < 3 ? r + k * static_cast<size_t>(n_pad)
                              : lo + (k - 3) * static_cast<size_t>(n_pad);
        T x[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) x[b] = __ldcg(from + src[b]);
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int col = c0 + b * kListThreads + tid;
          if (col < n_pad) planes[k * n_pad + col] = x[b];
        }
      }
    }
  }
  __syncthreads();
  if (boxes == nullptr) return;
  const int n_runs = n_pad / wb;
  for (int run = tid; run < n_runs; run += kListThreads) {
    // Each thread starts its run at its own offset, so that a warp's reads
    // fall in distinct banks.
    const int rot = (run * wb) >> 5;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const T* s = planes + a * n_pad + run * wb;
      T lo_a = s[rot & (wb - 1)];
      T hi_a = lo_a;
      T bad = T(0);
      for (int j = 0; j < wb; ++j) {
        const T x = s[(j + rot) & (wb - 1)];
        lo_a = fmin(lo_a, x);
        hi_a = fmax(hi_a, x);
        bad = add_rn(bad, sub_rn(x, x));
      }
      boxes[a * n_runs + run] = add_rn(mul_rn(add_rn(lo_a, hi_a), T(0.5)), bad);
      boxes[(3 + a) * n_runs + run] = mul_rn(sub_rn(hi_a, lo_a), T(0.5));
    }
  }
  __syncthreads();
}

// The box test of a warp (S <= 32): the run boxes of the staged plane
// (n_runs of 2^wb_shift slots: centres, then half-widths) and the box of the
// warp's real particles (mine: 3 centres, 3 half-widths), the margins, and
// the warp's runs of a stage.
template <typename T>
struct BoxTest {
  const T* boxes;
  const T* mine;
  T eps, bar;
  int n_runs, wb_shift;
  int nk;          // runs a warp takes of a stage: 128 / S
  unsigned all;    // the mask of all nk runs
};

// A lower bound of the minimum-image distance squared between any point of
// the warp's box and any point of run `run`'s box, in the float arithmetic
// of the pair loop (NaN where a box holds a NaN).
template <typename T>
__device__ __forceinline__ T box_gap2(const BoxTest<T>& bt, int run, T box, T inv_box) {
  T g2 = T(0);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const T d = abs_(min_image(sub_rn(bt.mine[a], bt.boxes[a * bt.n_runs + run]), box, inv_box));
    T g = sub_rn(sub_rn(d, add_rn(bt.mine[3 + a], bt.boxes[(3 + a) * bt.n_runs + run])), bt.eps);
    g = g < T(0) ? T(0) : g;
    g2 = a == 0 ? mul_rn(g, g) : add_rn(g2, mul_rn(g, g));
  }
  return g2;
}

// The box test of the calling warp: the run boxes follow the staged plane
// (rows x n_pad), the warps' boxes follow them.
template <typename T, bool EXT>
__device__ __forceinline__ BoxTest<T> box_test(const ListArgs<T>& p, const T* planes) {
  constexpr int kRows = EXT ? 6 : 3;
  const int S = p.slices;
  BoxTest<T> bt;
  bt.boxes = planes + kRows * p.n_pad;
  bt.mine = bt.boxes + 6 * (p.n_pad / kListBoxCols) + 6 * (threadIdx.x >> 5);
  bt.eps = mul_rn(p.box, BoxMargins<T>::eps_rel);
  bt.bar = mul_rn(p.rc2, add_rn(T(1), BoxMargins<T>::rc2_rel));
  bt.wb_shift = S == 32 ? 5 : 4;
  bt.n_runs = p.n_pad >> bt.wb_shift;
  bt.nk = kListGran / S;
  bt.all = bt.nk >= 32 ? 0xffffffffu : (1u << bt.nk) - 1u;
  return bt;
}

// The keep masks of stages e0 .. e0 + 31 of a work item's plan: lane j
// returns that of stage e0 + j (bit k: the warp's k-th run of the stage, its
// S columns k S ..., is kept), clear where the warp's box lies at least rc
// from the run's box. The warp counts
// the runs it tested and skipped. Every lane of the warp calls it.
template <typename T, bool EXT>
__device__ __forceinline__ unsigned chunk_keep(const ListArgs<T>& p, const T* planes,
                                               const int2* ent, int n_ent, int e0,
                                               unsigned& tested, unsigned& skipped) {
  const BoxTest<T> bt = box_test<T, EXT>(p, planes);
  const int e = e0 + (threadIdx.x & 31);
  unsigned keep = bt.all;
  if (e < n_ent) {
    const int col0 = ent[e].x;
    for (int k = 0; k < bt.nk; ++k) {
      const int run = (col0 + k * p.slices) >> bt.wb_shift;
      if (box_gap2(bt, run, p.box, p.inv_box) >= bt.bar) keep &= ~(1u << k);
    }
  }
  const int stages = n_ent - e0 < 32 ? n_ent - e0 : 32;
  tested += stages * bt.nk;
  skipped += __reduce_add_sync(0xffffffffu, static_cast<unsigned>(__popc(bt.all & ~keep)));
  return keep;
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

// The stage's rounds and mask (plan entry meta, first column col0).
struct ListStageMeta {
  bool fwd, masked, mic_x, mic_z;
  int col0, jmin_col;
};

// The pair of `me` with the stage's column jj (row k at s[k * ld + jj]).
// The mask is read from me's side: (row, column) = (me, partner) forward,
// (partner, me) backward, on sorted columns: a partner in me's own granule
// is own[its slot] (own is null where the stage is another granule, or the
// slots are the columns), elsewhere its slot's granule and place among the
// real columns decide every test alike.
template <typename T, bool EXT, bool OBS>
__device__ __forceinline__ void list_pair(const ListArgs<T>& p, ListMe<T>& me, const T* s, int ld,
                                          const ListStageMeta& st, const int* own, int jj) {
  T dx = sub_rn(me.x, s[jj]);
  T dy = sub_rn(me.y, s[ld + jj]);
  T dz = sub_rn(me.z, s[2 * ld + jj]);
  if (EXT) {
    dx = add_rn(dx, sub_rn(me.lx, s[3 * ld + jj]));
    dy = add_rn(dy, sub_rn(me.ly, s[4 * ld + jj]));
    dz = add_rn(dz, sub_rn(me.lz, s[5 * ld + jj]));
  }
  if (st.mic_x) dx = min_image(dx, p.box, p.inv_box);
  dy = min_image(dy, p.box, p.inv_box);
  if (st.mic_z) dz = min_image(dz, p.box, p.inv_box);
  const T r2 = add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz));
  bool m = r2 < p.rc2;
  if (st.masked) {
    const int gq = st.col0 + (own ? own[jj] : jj);
    const int gr = st.fwd ? me.i : gq;
    const int gc = st.fwd ? gq : me.i;
    m = m && (gc > gr) && (gc < p.n) && (gr < p.n) && (gc >= st.jmin_col);
  }
  // A masked pair adds exact +-0 to sums that start at +0: a warp none of
  // whose lanes holds the mask skips the body and changes no bit.
  if (!__any_sync(0xffffffffu, m)) return;
  const PairTerms<T> pt = lj_pair_terms<T, OBS>(r2, m);
  me.fx = add_rn(me.fx, mul_rn(pt.coef, dx));
  me.fy = add_rn(me.fy, mul_rn(pt.coef, dy));
  me.fz = add_rn(me.fz, mul_rn(pt.coef, dz));
  if (OBS && st.fwd) {
    me.e = add_rn(me.e, pt.e);
    me.du = add_rn(me.du, pt.du);
    me.ddu = add_rn(me.ddu, pt.ddu);
  }
}

// Pairs of `me` with one staged 128-column stage (column col0 at s[0], row
// k at s + k * ld) of plan entry meta; the thread takes the columns slice,
// slice + S, ... (SLOTS: of the runs in `keep`, bit k: columns k S +
// slice).
template <typename T, bool EXT, bool OBS, bool SLOTS>
__device__ __forceinline__ void list_stage(const ListArgs<T>& p, ListMe<T>& me, const T* s,
                                           int ld, int col0, int meta, int slice, unsigned keep,
                                           const int* own) {
  const int S = p.slices;
  const ListStageMeta st{(meta & kFwd) != 0, (meta & kMasked) != 0, (meta & kMicX) != 0,
                         (meta & kMicZ) != 0, col0, (meta >> 4) * kListGran};
  if constexpr (SLOTS) {
    for (; keep; keep &= keep - 1u) {
      list_pair<T, EXT, OBS>(p, me, s, ld, st, own, (__ffs(keep) - 1) * S + slice);
    }
  } else {
    for (int jj = slice; jj < kListGran; jj += S) {
      list_pair<T, EXT, OBS>(p, me, s, ld, st, nullptr, jj);
    }
  }
}

// Forces (and observables) of one work item over its plan entries; `own`
// (resident) the local column of each slot of the item's granule, whose
// first column is own_col0.
// `test` (resident, with slots): the warp's runs are tested (bt) 32 stages
// at a time, a stage's keep mask held by one lane; `live`: the warp holds a
// real particle (else it takes no run).
template <typename T, bool EXT, bool OBS, bool SLOTS>
__device__ __forceinline__ void list_item(const ListArgs<T>& p, ListMe<T>& me, const int2* ent, int n_ent,
                          T* planes, const T* r_new, const T* lo_new, int slice,
                          bool live, const int* own, int own_col0, unsigned& tested,
                          unsigned& skipped) {
  constexpr int kRows = EXT ? 6 : 3;
  const int tid = threadIdx.x;
  if constexpr (SLOTS) {
    unsigned keeps = 0u;
    for (int e = 0; e < n_ent; ++e) {
      if ((e & 31) == 0) {
        keeps = live ? chunk_keep<T, EXT>(p, planes, ent, n_ent, e, tested, skipped) : 0u;
      }
      const unsigned keep = __shfl_sync(0xffffffffu, keeps, e & 31);
      const int2 en = ent[e];
      list_stage<T, EXT, OBS, true>(p, me, planes + en.x, p.n_pad, en.x, en.y, slice, keep,
                                    en.x == own_col0 ? own : nullptr);
    }
    return;
  }
  if (p.resident) {
    for (int e = 0; e < n_ent; ++e) {
      const int2 en = ent[e];
      list_stage<T, EXT, OBS, false>(p, me, planes + en.x, p.n_pad, en.x, en.y, slice, 0u,
                                     nullptr);
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
    list_stage<T, EXT, OBS, false>(p, me, planes + (e % kListRing) * buf, kListGran, ent[e].x,
                                   ent[e].y, slice, 0u, nullptr);
  }
}

// Replica q's counts of runs tested and skipped, or null.
template <typename T>
__device__ __forceinline__ unsigned long long* skips_of(const ListArgs<T>& p, int q) {
  return p.skips ? p.skips + 2 * q : nullptr;
}

// Add the block's runs tested and skipped (each warp's, in its lanes) to
// dst[0] and dst[1] (where dst is not null), and zero them. Every thread of
// the block calls it.
__device__ __forceinline__ void flush_skips(unsigned long long* dst, unsigned& tested,
                                            unsigned& skipped, unsigned* cnt) {
  const int tid = threadIdx.x;
  if ((tid & 31) == 0) {
    cnt[tid >> 5] = tested;
    cnt[kListWarps + (tid >> 5)] = skipped;
  }
  __syncthreads();
  if (tid == 0 && dst) {
    unsigned long long t = 0, k = 0;
    for (int w = 0; w < kListWarps; ++w) {
      t += cnt[w];
      k += cnt[kListWarps + w];
    }
    atomicAdd(dst, t);
    atomicAdd(dst + 1, k);
  }
  tested = skipped = 0u;
  __syncthreads();  // `cnt` is rewritten by the next flush
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
template <typename T, bool EXT, bool REPLICAS, bool SLOTS>
__global__ void __launch_bounds__(kListThreads, 2)
fused_list_kernel(ListArgs<T> p, int replicas, int tiles_stride) {
  // rbuf / lobuf / perm: other blocks write them during the launch, so they
  // are read through plain loads, __ldcg or cp.async.cg (through L2), never
  // __ldg.
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kRows = EXT ? 6 : 3;
  T* red = reinterpret_cast<T*>(smem_raw);
  T* planes = red + kListWarps;
  T* boxes = planes + kRows * p.n_pad;  // resident only
  __shared__ int cat_start[kListMaxCats + 1];
  __shared__ int scan[kListWarps + 1];
  __shared__ int order[kListGran];  // sort keys (start), then the item's granule's columns
  __shared__ unsigned cnt[2 * kListWarps];

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
  // SLOTS (resident, at least kListMinRuns runs a warp a stage: the box
  // test): the work items, the staged plane and the runs follow each
  // granule's xy order (slots); else the slots are the columns, and none of
  // the order, the boxes or the test is compiled in.
  constexpr bool slots = SLOTS;
  const int box_cols = S == 32 ? 32 : kListBoxCols;

  // The visit plan of every granule (of every replica's), and its xy order,
  // once per launch: block b gathers the plans of granules b, b + G, ...
  // into the scratch, each from its replica's lists, then the grid waits.
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
      const int cnt_g = gather_plan(pq, cat_start, n_cats, gq - q * n_b,
                                    p.plan + static_cast<size_t>(gq) * p.plan_stride,
                                    p.plan_stride, scan);
      if (tid == 0) p.plan_n[gq] = cnt_g;
      if (slots) granule_order(p, p.rbuf + q * plane, gq - q * n_b, p.perm + q * n_pad, order);
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
      const int cnt_g = gather_plan(p, cat_start, n_cats, g,
                                    p.plan + static_cast<size_t>(g) * p.plan_stride,
                                    p.plan_stride, scan);
      if (tid == 0) p.plan_n[g] = cnt_g;
      if (slots) granule_order(p, p.rbuf, g, p.perm, order);
    }
  }
  grid.sync();

  // This block's work items, the same in both phases of every step (the
  // owner thread of a particle alone touches its v, a and vc): items
  // blockIdx.x, + G, ... of one system; with REPLICAS a contiguous run of
  // the R replicas' items (replica q's at q * n_items ...), so that a block
  // restages a resident plane only when the replica changes. Item w takes
  // slots (w - q n_items) ti ... of its replica.
  int w_first = 0, w_end = 0;
  if constexpr (REPLICAS) {
    const int all_items = n_items * replicas;
    const int per = (all_items + gridDim.x - 1) / gridDim.x;
    w_first = blockIdx.x * per;
    w_end = min(all_items, w_first + per);
  }
  unsigned tested = 0u, skipped = 0u;
  int counted = REPLICAS ? -1 : 0;  // the replica the warps' counts belong to
  int own_g = -1;                   // the granule whose columns `order` holds
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
        const int slot = (w - q * n_items) * ti + pl;
        if (slot >= p.n) continue;  // padding slots come last
        const int i = slots ? __ldcg(p.perm + q * n_pad + slot) : slot;
        // With slots the position planes hold slot order between steps: the
        // launch's input and its last step's output are in column order.
        const size_t src = slots && s > 0 ? slot : i;
        const size_t dst = slots && s + 1 < p.n_steps ? slot : i;
        const size_t off = REPLICAS ? q * plane : 0;
        const T* r_cur = r_cur0 + off;
        T* r_new = r_new0 + off;
        T* v = p.v + off;
        T* a = p.a + off;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const size_t k = c * n_pad + i;
          const size_t ks = c * n_pad + src;
          const size_t kd = c * n_pad + dst;
          if (EXT) {
            T* vc = p.vc + off;
            const T delta =
                add_rn(mul_rn(add_rn(v[k], vc[k]), p.dt), mul_rn(a[k], p.half_dt_sq));
            T x = r_cur[ks];
            T lo = lo_cur0[off + ks];
            comp_add_list(x, lo, delta);
            r_new[kd] = x;
            lo_new0[off + kd] = lo;
            T vk = v[k];
            T ck = vc[k];
            comp_add_list(vk, ck, mul_rn(a[k], p.half_dt));
            v[k] = vk;
            vc[k] = ck;
          } else {
            r_new[kd] = add_rn(add_rn(r_cur[ks], mul_rn(v[k], p.dt)), mul_rn(a[k], p.half_dt_sq));
            v[k] = add_rn(v[k], mul_rn(a[k], p.half_dt));
          }
        }
      }
    }
    grid.sync();

    // Phase 2: stage the new plane in slot order with its run boxes
    // (resident; with REPLICAS item by item, where the block has not staged
    // the item's replica yet this step), then forces over each work item's
    // plan at the new positions.
    const bool last = s == p.n_steps - 1;
    if constexpr (!REPLICAS) {
      if (p.resident) {
        stage_slots<T, EXT>(planes, slots ? boxes : nullptr, r_new0, lo_new0,
                            slots && last ? p.perm : nullptr, p.n_pad, box_cols, tid);
      }
    }
    const bool want_obs = p.obs_last && last;
    int staged = -1;
    for (int w = REPLICAS ? w_first : blockIdx.x; w < (REPLICAS ? w_end : n_items);
         w += REPLICAS ? 1 : gridDim.x) {
      const int q = REPLICAS ? w / n_items : 0;
      const int i0 = (w - q * n_items) * ti;
      const size_t off = REPLICAS ? q * plane : 0;
      const T* r_new = r_new0 + off;
      const T* lo_new = EXT ? lo_new0 + off : nullptr;
      const int g = (REPLICAS ? q * n_b : 0) + i0 / kListGran;
      if constexpr (REPLICAS) {
        if (slots && q != counted) {
          if (counted >= 0) flush_skips(skips_of(p, counted), tested, skipped, cnt);
          counted = q;
        }
        if (p.resident && q != staged) {
          // The previous item (or step) ended in a barrier: no thread still
          // reads the staged plane.
          stage_slots<T, EXT>(planes, slots ? boxes : nullptr, r_new, lo_new,
                              slots && last ? p.perm + q * n_pad : nullptr, p.n_pad, box_cols,
                              tid);
          staged = q;
        }
      }
      const int own_col0 = (i0 / kListGran) * kListGran;  // the item's granule, in its replica
      if (slots && g != own_g) {
        // The previous item ended in a barrier: no thread still reads `order`.
        if (tid < kListGran) order[tid] = __ldcg(p.perm + g * kListGran + tid) - own_col0;
        __syncthreads();
        own_g = g;
      }
      ListMe<T> me;
      const int slot = i0 + pl;
      me.i = slots ? own_col0 + order[slot - own_col0] : slot;
      if (slots) {
        me.x = planes[slot];
        me.y = planes[n_pad + slot];
        me.z = planes[2 * n_pad + slot];
      } else {
        me.x = r_new[me.i];
        me.y = r_new[n_pad + me.i];
        me.z = r_new[2 * n_pad + me.i];
      }
      me.lx = me.ly = me.lz = T(0);
      if (EXT) {
        if (slots) {
          me.lx = planes[3 * n_pad + slot];
          me.ly = planes[4 * n_pad + slot];
          me.lz = planes[5 * n_pad + slot];
        } else {
          me.lx = lo_new[me.i];
          me.ly = lo_new[n_pad + me.i];
          me.lz = lo_new[2 * n_pad + me.i];
        }
      }
      me.fx = me.fy = me.fz = me.e = me.du = me.ddu = T(0);
      bool live = true;
      if (slots) {
        // The warp's box: its real particles (slots < n), over its lanes.
        const bool real = slot < p.n;
        const T inf = T(INFINITY);
        const T xyz[3] = {me.x, me.y, me.z};
        T bad = T(0);
        T c[3], h[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          T lo_a = real ? xyz[a] : inf;
          T hi_a = real ? xyz[a] : -inf;
          if (real) bad = add_rn(bad, sub_rn(xyz[a], xyz[a]));
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            lo_a = fmin(lo_a, __shfl_xor_sync(0xffffffffu, lo_a, o));
            hi_a = fmax(hi_a, __shfl_xor_sync(0xffffffffu, hi_a, o));
          }
          c[a] = mul_rn(add_rn(lo_a, hi_a), T(0.5));
          h[a] = mul_rn(sub_rn(hi_a, lo_a), T(0.5));
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) bad = add_rn(bad, __shfl_xor_sync(0xffffffffu, bad, o));
        live = __any_sync(0xffffffffu, real);
        if ((tid & 31) == 0) {
          T* mine = boxes + 6 * (p.n_pad / kListBoxCols) + 6 * (tid >> 5);
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            mine[a] = add_rn(c[a], bad);
            mine[3 + a] = h[a];
          }
        }
        __syncwarp();
      }
      const int2* ent = p.plan + static_cast<size_t>(g) * p.plan_stride;
      const int n_ent = p.plan_n[g];
      if (want_obs) {
        list_item<T, EXT, true, SLOTS>(p, me, ent, n_ent, planes, r_new, lo_new, slice, live,
                                       order, own_col0, tested, skipped);
      } else {
        list_item<T, EXT, false, SLOTS>(p, me, ent, n_ent, planes, r_new, lo_new, slice, live,
                                        order, own_col0, tested, skipped);
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
      __syncthreads();  // `red`, `order` and the staged planes are reused by the next item
    }
    // The next step's phase 1 touches only the owners' own v / a and the
    // other position plane; the staged plane is rewritten only after the
    // next grid barrier.
  }
  if (slots && counted >= 0) flush_skips(skips_of(p, counted), tested, skipped, cnt);
}

// BATCH: the replica instantiation; SLOTS: the one with the xy order and
// the box test, which a launch takes where its plan gives kPlaneSlots.
template <typename T, bool EXT, bool BATCH, bool SLOTS>
const void* list_kernel() {
  return reinterpret_cast<const void*>(fused_list_kernel<T, EXT, BATCH, SLOTS>);
}

// A warp takes at least kListMinRuns runs of a stage at S = `slices`.
inline bool list_runs(int slices) { return kListGran / slices >= kListMinRuns; }

// Blocks an SM at `bytes` of dynamic shared memory of one instantiation (its
// limit set first to what the card lets a block opt in to, less its static
// shared memory).
inline cudaError_t list_fn_per_sm(const void* fn, size_t bytes, int optin, int* per_sm) {
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

// Blocks an SM of the SLOTS instantiation at the plane with its boxes: the
// fewer of the one-system and replica builds, so that both take the xy
// order at the same sizes (replica q equals its one-replica launch).
template <typename T, bool EXT>
cudaError_t list_slots_per_sm(int n_pad, int optin, int* per_sm) {
  const size_t bytes = list_smem_bytes<T, EXT>(kPlaneSlots, n_pad);
  int a = 0, b = 0;
  cudaError_t err = list_fn_per_sm(list_kernel<T, EXT, false, true>(), bytes, optin, &a);
  if (err != cudaSuccess) return err;
  err = list_fn_per_sm(list_kernel<T, EXT, true, true>(), bytes, optin, &b);
  *per_sm = a < b ? a : b;
  return err;
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
  // Resident where the whole plane fits the plain instantiation with two
  // blocks an SM; the xy order where the plane and its boxes also fit the
  // SLOTS instantiation so, and a warp takes at least kListMinRuns runs of
  // a stage. Each S is sized by the blocks an SM of the instantiation it
  // would launch.
  const void* plain_fn = list_kernel<T, EXT, BATCH, false>();
  int per_sm_plain = 0, per_sm_slots = 0;
  err = list_fn_per_sm(plain_fn, list_smem_bytes<T, EXT>(kPlaneResident, n_pad), optin,
                       &per_sm_plain);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool resident = per_sm_plain >= 2;
  if (!resident) {
    err = list_fn_per_sm(plain_fn, list_smem_bytes<T, EXT>(kPlaneStreamed, n_pad), optin,
                         &per_sm_plain);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = list_slots_per_sm<T, EXT>(n_pad, optin, &per_sm_slots);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm_slots >= 2) {  // this launch's own blocks an SM (the rule took the fewer)
    err = list_fn_per_sm(list_kernel<T, EXT, BATCH, true>(),
                         list_smem_bytes<T, EXT>(kPlaneSlots, n_pad), optin, &per_sm_slots);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    per_sm_slots = 0;
  }
  if (per_sm_plain < 1) return static_cast<int>(cudaErrorInvalidConfiguration);  // no barrier
  auto slots_at = [&](int s) { return per_sm_slots >= 2 && list_runs(s); };
  auto blocks_at = [&](int s) {
    return static_cast<long long>(slots_at(s) ? per_sm_slots : per_sm_plain) * sms;
  };
  if (slices <= 0) {
    // One round where one fits: the largest S whose work items all run at
    // once on the resident blocks, with at least kListMinCols columns of a
    // stage a thread. Else the S <= 8 whose rounds waste the fewest block
    // slots, the smallest on a tie.
    slices = 0;
    for (int s = kListMinSlices; s <= kListMaxSlices; s *= 2) {
      const long long items = static_cast<long long>(n_pad) * s / kListThreads;
      if (items <= blocks_at(s) && kListGran / s >= kListMinCols) slices = s;
    }
    if (slices == 0) {
      double best = 0.0;
      for (int s = kListMinSlices; s <= 8; s *= 2) {
        const long long items = static_cast<long long>(n_pad) * s / kListThreads;
        const long long rounds = (items + blocks_at(s) - 1) / blocks_at(s);
        const double waste = static_cast<double>(rounds * blocks_at(s)) / items;
        if (slices == 0 || waste < best - 1e-9) {
          best = waste;
          slices = s;
        }
      }
    }
  }
  const bool slots = slots_at(slices);
  const int plane = slots ? kPlaneSlots : (resident ? kPlaneResident : kPlaneStreamed);
  const long long items = static_cast<long long>(n_pad) * slices / kListThreads * replicas;
  const long long live = blocks_at(slices);
  int blocks = static_cast<int>(items < live ? items : live);
  if (grid_cap > 0 && grid_cap < blocks) blocks = grid_cap;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, slots ? list_kernel<T, EXT, BATCH, true>() : plain_fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = slices;
  out[1] = plane;
  out[2] = slots ? per_sm_slots : per_sm_plain;
  out[3] = sms;
  out[4] = static_cast<int>(list_smem_bytes<T, EXT>(plane, n_pad));
  out[5] = blocks;
  out[6] = attr.numRegs;
  out[7] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

template <typename T, bool EXT>
int launch_list(ListArgs<T> p, int blocks, void* stream, int replicas, int tiles_stride) {
  void* args[] = {&p, &replicas, &tiles_stride};
  const bool slots = p.resident == kPlaneSlots;
  const void* fn =
      replicas > 0
          ? (slots ? list_kernel<T, EXT, true, true>() : list_kernel<T, EXT, true, false>())
          : (slots ? list_kernel<T, EXT, false, true>() : list_kernel<T, EXT, false, false>());
  cudaError_t err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kListThreads), args,
                                                list_smem_bytes<T, EXT>(p.resident, p.n_pad),
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
                    int plan_stride, int* perm, unsigned long long* skips, int cells,
                    T cell_scale, int blocks, void* stream, int replicas = 0,
                    int tiles_stride = 0) {
  if (4 + n_tails > kListMaxCats || replicas < 0 || cells < 1 || resident < kPlaneStreamed ||
      resident > kPlaneSlots || (resident == kPlaneSlots && !list_runs(slices))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ListArgs<T> p{rbuf,    lobuf,    v,
                      vc,      a,        obs,
                      tiles,   tcounts,  max_t,
                      n_tails, span,     n,
                      n_pad,   box,      inv_box,
                      rc2,     dt,       half_dt,
                      half_dt_sq, n_steps, obs_last,
                      slices,  resident, reinterpret_cast<int2*>(plan),
                      plan_n,  plan_stride, perm,
                      skips,   cells,    cell_scale};
  return extended ? launch_list<T, true>(p, blocks, stream, replicas, tiles_stride)
                  : launch_list<T, false>(p, blocks, stream, replicas, tiles_stride);
}

}  // namespace ljmd

extern "C" {

int ljmd_list_block_threads() { return ljmd::kListThreads; }

// The launch shape of a variant at n_pad: out = {slices, the plane
// (kPlaneStreamed 0, kPlaneResident 1, kPlaneSlots 2: resident with the xy
// order), blocks an SM (occupancy API, of the instantiation the launch takes
// at the shared memory it will use), SMs,
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

// `slices`, `resident` (the plane), `blocks` as ljmd_list_plan gave them for the same
// variant; `plan` ((n_b * plan_stride * 2,) int32, plan_stride = 3 n_b +
// span), `plan_n` ((n_b,) int32) and `perm` ((n_pad,) int32) are scratch
// the launch writes; `skips` (2,) uint64 (or null) gets the runs tested and
// skipped added; `cells` the c of the xy order's c x c grid, `cell_scale`
// c / L.
int ljmd_fused_dense_chunk_list_f32(float* rbuf, float* lobuf, float* v, float* vc, float* a,
                                    float* obs, const int* tiles, const int* tcounts, int max_t,
                                    int n_tails, int span, int n, int n_pad, float box,
                                    float inv_box, float rc2, float dt, float half_dt,
                                    float half_dt_sq, int n_steps, int obs_last, int extended,
                                    int slices, int resident, int* plan, int* plan_n,
                                    int plan_stride, int* perm, unsigned long long* skips,
                                    int cells, float cell_scale, int blocks, void* stream) {
  return ljmd::launch_list_any<float>(rbuf, lobuf, v, vc, a, obs, tiles, tcounts, max_t, n_tails,
                                      span, n, n_pad, box, inv_box, rc2, dt, half_dt, half_dt_sq,
                                      n_steps, obs_last, extended, slices, resident, plan, plan_n,
                                      plan_stride, perm, skips, cells, cell_scale, blocks, stream);
}

int ljmd_fused_dense_chunk_list_f64(double* rbuf, double* lobuf, double* v, double* vc,
                                    double* a, double* obs, const int* tiles, const int* tcounts,
                                    int max_t, int n_tails, int span, int n, int n_pad,
                                    double box, double inv_box, double rc2, double dt,
                                    double half_dt, double half_dt_sq, int n_steps, int obs_last,
                                    int extended, int slices, int resident, int* plan,
                                    int* plan_n, int plan_stride, int* perm,
                                    unsigned long long* skips, int cells, double cell_scale,
                                    int blocks, void* stream) {
  return ljmd::launch_list_any<double>(rbuf, lobuf, v, vc, a, obs, tiles, tcounts, max_t,
                                       n_tails, span, n, n_pad, box, inv_box, rc2, dt, half_dt,
                                       half_dt_sq, n_steps, obs_last, extended, slices, resident,
                                       plan, plan_n, plan_stride, perm, skips, cells, cell_scale,
                                       blocks, stream);
}

// R replicas in one launch (the replica kernel): rbuf / lobuf (2, R, 8,
// n_pad), v / vc / a / obs (R, 8, n_pad), tiles (R, 9 + 2 n_tails, max_t),
// tcounts (R, 4 + n_tails); `slices`, `resident`, `blocks` as
// ljmd_list_replicas_plan gave them; plan (R * n_b * plan_stride * 2,),
// plan_n (R * n_b,) and perm (R * n_pad,) int32 scratch; skips (R, 2) uint64
// (or null), replica q's counts at 2 q.
int ljmd_fused_dense_chunk_list_replicas_f32(
    float* rbuf, float* lobuf, float* v, float* vc, float* a, float* obs, const int* tiles,
    const int* tcounts, int max_t, int n_tails, int span, int n, int n_pad, int replicas,
    float box, float inv_box, float rc2, float dt, float half_dt, float half_dt_sq, int n_steps,
    int obs_last, int extended, int slices, int resident, int* plan, int* plan_n,
    int plan_stride, int* perm, unsigned long long* skips, int cells, float cell_scale,
    int blocks, void* stream) {
  if (replicas < 1) return static_cast<int>(cudaErrorInvalidValue);
  return ljmd::launch_list_any<float>(rbuf, lobuf, v, vc, a, obs, tiles, tcounts, max_t, n_tails,
                                      span, n, n_pad, box, inv_box, rc2, dt, half_dt, half_dt_sq,
                                      n_steps, obs_last, extended, slices, resident, plan, plan_n,
                                      plan_stride, perm, skips, cells, cell_scale, blocks, stream,
                                      replicas, (9 + 2 * n_tails) * max_t);
}

int ljmd_fused_dense_chunk_list_replicas_f64(
    double* rbuf, double* lobuf, double* v, double* vc, double* a, double* obs, const int* tiles,
    const int* tcounts, int max_t, int n_tails, int span, int n, int n_pad, int replicas,
    double box, double inv_box, double rc2, double dt, double half_dt, double half_dt_sq,
    int n_steps, int obs_last, int extended, int slices, int resident, int* plan, int* plan_n,
    int plan_stride, int* perm, unsigned long long* skips, int cells, double cell_scale,
    int blocks, void* stream) {
  if (replicas < 1) return static_cast<int>(cudaErrorInvalidValue);
  return ljmd::launch_list_any<double>(rbuf, lobuf, v, vc, a, obs, tiles, tcounts, max_t,
                                       n_tails, span, n, n_pad, box, inv_box, rc2, dt, half_dt,
                                       half_dt_sq, n_steps, obs_last, extended, slices, resident,
                                       plan, plan_n, plan_stride, perm, skips, cells, cell_scale,
                                       blocks, stream, replicas, (9 + 2 * n_tails) * max_t);
}

}  // extern "C"
