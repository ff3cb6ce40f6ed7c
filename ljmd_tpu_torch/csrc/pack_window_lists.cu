// Kernel 9: the visit-list pack of the z-sorted window-list engine.
//
// Replaces: ljmd_tpu/ops/pallas_fused.py:803 `build_window_lists_pallas`
// (its Pallas body `_pack_window_kernel`, :676, and the row bands its
// wrapper computes in jnp, :834-845).
//
// What bounds it on the H100: one launch's latency. It reads n_b * n_b int32
// flags (4 KB at N = 4000, n_b = 32) and writes a few hundred ints; bytes
// and operations take well under a microsecond, and a pack that is a chain
// of small device operations pays a launch for each.
//
// What the design does about that: one launch of one block is the whole pack
// (the row bands included), and each step of the block is short:
// - a warp per block-row reads the row 32 flags a load (consecutive lanes,
//   consecutive flags) and turns them into three bitmasks by __ballot_sync
//   (active, z round, x round), staged in shared memory where they fit, so
//   the flags are read once (above that, pass 2 reads them again, coalesced);
// - the greedy cover walks the active mask with __ffs, one step a visit
//   (the span's z / x needs and tail width are bits of the same masks);
// - pass 1 counts each row's visits per category, an exclusive scan over
//   the rows (a warp a category: each lane sums its run of rows, warp
//   shuffles scan the lane totals) turns them into offsets in row order, and
//   pass 2 walks again and writes each visit at its offset: the sequential
//   kernel's order, no atomics.
//
// Replicas (the batched zsort engine): one launch packs R replicas' lists,
// block q replica q's, each block the one-system block on its replica's
// flags, lists and counts (the REPLICAS instantiation; its offsets fold away
// in the one-system one, whose code and registers stay as they were).
//
// Flags from intervals (the zsort engine's resort, csrc/zsort_resort.cu):
// the same kernel with its flag source swapped. Instead of reading the n_b x
// n_b flags of ops/window_lists.py compute_tile_flags, each lane works out
// its flag from the two tiles' [lo, hi] intervals of sorted z (and x with
// slabs) that the resort's sort kernel wrote: compute_tile_flags' direct and
// wrapped gaps, face hazards and bits, operation for operation in the
// tensor's precision (the _rn intrinsics, NaN-propagating max / min as
// torch.maximum / minimum / clamp), so the lists are the torch chain's.
//
// Contract: flags (n_b * n_b,) int32 of compute_tile_flags (bit 0 active,
// bit 1 z round, bit 2 x round, > 0 visited) at tile_i x tile_i. Out: tiles
// (9 + 2 * n_tails, max_t) and tcounts (4 + n_tails,), element for element
// the lists of the sequential Pallas kernel on the count prefix (the same
// row-major order within each category, the same jmin row 8, the same tail
// rows). Entries past the counts are not written.
#include <cuda_runtime.h>

#include "lj_pair_terms.cuh"

namespace ljmd {

constexpr int kPackMaxRows = 1024;  // n_b at most: a row's mask word a lane
constexpr int kPackMaxSpan = 8;     // tile_j / tile_i
constexpr int kPackMaxWarps = 32;
// Dynamic shared memory without an opt-in: the counts (n_cats x n_b ints,
// 44 KB at n_b = 1024) always, the masks (3 x n_b x words) where they fit.
constexpr int kPackSmemBytes = 48 * 1024;

struct PackArgs {
  int* tiles;
  int* tcounts;
  int n, n_b, g, tile_j, span, n_tails, n_cats, max_t, words, staged;
};

// Word w of a row mask held a word a lane (0 past the row). Warp-uniform.
__device__ __forceinline__ unsigned mask_word(unsigned m, int w, int words) {
  const unsigned v = __shfl_sync(0xffffffffu, m, w & 31);
  return w < words ? v : 0u;
}

// Bits [b, b + span) of a row mask (span <= 8). Warp-uniform.
__device__ __forceinline__ unsigned mask_window(unsigned m, int b, int span, int words) {
  const unsigned long long two =
      (static_cast<unsigned long long>(mask_word(m, (b >> 5) + 1, words)) << 32) |
      mask_word(m, b >> 5, words);
  return static_cast<unsigned>(two >> (b & 31)) & ((1u << span) - 1u);
}

// The first set bit at or past pos of a row mask, or -1. Warp-uniform.
__device__ __forceinline__ int next_active(unsigned act, int pos, int words) {
  const int lane = threadIdx.x & 31;
  const int w0 = pos >> 5;
  unsigned mine = (lane < words && lane >= w0) ? act : 0u;
  if (lane == w0) mine &= ~0u << (pos & 31);
  const unsigned any = __ballot_sync(0xffffffffu, mine != 0u);
  if (any == 0u) return -1;
  const int w = __ffs(any) - 1;
  return 32 * w + __ffs(__shfl_sync(0xffffffffu, mine, w)) - 1;
}

// The flag source of kernel 9's own entry: the flags array.
struct FlagArray {
  const int* flags;
  int n_b;
  __device__ __forceinline__ void replica(size_t q) { flags += q * n_b * n_b; }
  __device__ __forceinline__ int operator()(int row, int col) const {
    return flags[static_cast<size_t>(row) * n_b + col];
  }
};

template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return a != a ? a : (b != b ? b : (b < a ? b : a));
}

// compute_tile_flags' gap: clamp(maximum(b_lo - a_hi, a_lo - b_hi), min=0).
template <typename T>
__device__ __forceinline__ T tile_gap(T a_lo, T a_hi, T b_lo, T b_hi) {
  return nan_max(nan_max(sub_rn(b_lo, a_hi), sub_rn(a_lo, b_hi)), T(0));
}

// The flag source of the resort: compute_tile_flags at tile_i = tile_j from
// the tiles' intervals. ivl holds (4, n_b): z lo, z hi, x lo, x hi over each
// tile's columns < n (lo +inf / hi -inf where it has none; hi over finite
// values only). The scalars are the Python ones rounded to T as torch rounds
// a scalar against a T tensor: box - cross and box - face are worked out in
// double first, as the Python expressions are.
template <typename T, bool SLAB>
struct FlagIntervals {
  const T* ivl;
  int n_b;
  T win_z, win_x, box, cross, box_cross, face, box_face;
  __device__ __forceinline__ void replica(size_t q) { ivl += q * 4 * n_b; }
  // One axis: (active, round needed) of tiles i and j.
  __device__ __forceinline__ void axis(const T* lo, const T* hi, int i, int j, T win, bool* act,
                                       bool* rnd) const {
    const T a_lo = lo[i], a_hi = hi[i], b_lo = lo[j], b_hi = hi[j];
    const bool finite = isfinite(a_hi) && isfinite(b_hi);
    const bool direct = tile_gap(a_lo, a_hi, b_lo, b_hi) < win && finite;
    const bool wrapped = nan_min(tile_gap(a_lo, a_hi, sub_rn(b_lo, box), sub_rn(b_hi, box)),
                                 tile_gap(a_lo, a_hi, add_rn(b_lo, box), add_rn(b_hi, box))) <
                             win && finite;
    const bool hazard = ((a_lo < cross) && (b_lo < face)) || ((a_lo < face) && (b_lo < cross)) ||
                        ((a_hi > box_cross) && (b_hi > box_face)) ||
                        ((a_hi > box_face) && (b_hi > box_cross));
    *act = direct || wrapped;
    *rnd = wrapped || (direct && hazard);
  }
  __device__ __forceinline__ int operator()(int row, int col) const {
    bool act, rz, rx;
    axis(ivl, ivl + n_b, row, col, win_z, &act, &rz);
    if (SLAB) {
      bool act_x;
      axis(ivl + 2 * n_b, ivl + 3 * n_b, row, col, win_x, &act_x, &rx);
      act = act && act_x;
    } else {
      rx = act;
    }
    return act ? 1 + 2 * rz + 4 * rx : 0;
  }
};

// Row `row`'s three masks, word `lane` in each lane: from the flag source,
// 32 a step (and into the stage), or from the stage.
template <typename Src>
__device__ __forceinline__ void row_masks(const PackArgs& a, const Src& src, unsigned* stage,
                                          int row, bool from_stage, unsigned* act, unsigned* zr,
                                          unsigned* xr) {
  const int lane = threadIdx.x & 31;
  unsigned* s = stage + static_cast<size_t>(row) * a.words;
  const size_t plane = static_cast<size_t>(a.n_b) * a.words;
  if (from_stage) {
    *act = lane < a.words ? s[lane] : 0u;
    *zr = lane < a.words ? s[plane + lane] : 0u;
    *xr = lane < a.words ? s[2 * plane + lane] : 0u;
    return;
  }
  *act = *zr = *xr = 0u;
  for (int w = 0; w < a.words; ++w) {
    const int col = 32 * w + lane;
    const int fl = col < a.n_b ? src(row, col) : 0;
    const unsigned m0 = __ballot_sync(0xffffffffu, fl > 0);
    const unsigned m1 = __ballot_sync(0xffffffffu, (fl & 2) != 0);
    const unsigned m2 = __ballot_sync(0xffffffffu, (fl & 4) != 0);
    if (lane == w) {
      *act = m0;
      *zr = m1;
      *xr = m2;
    }
  }
  if (a.staged && lane < a.words) {
    s[lane] = *act;
    s[plane + lane] = *zr;
    s[2 * plane + lane] = *xr;
  }
}

// Row `row`'s greedy cover: calls emit(category, list row, j block, jmin)
// for each visit, in the order of the Pallas kernel. Warp-uniform.
template <typename Emit>
__device__ __forceinline__ void cover_row(const PackArgs& a, int row, unsigned act, unsigned zr,
                                          unsigned xr, Emit emit) {
  const int max_start = a.n_b - a.span;
  const int g = a.g;
  for (int b = next_active(act, row, a.words); b >= 0;
       b = next_active(act, b + a.span, a.words)) {
    const int s = min(b, max_start);
    const bool zneed = mask_window(zr, b, a.span, a.words) != 0u;
    const bool xneed = mask_window(xr, b, a.span, a.words) != 0u;
    // Tails: the exact active width of the window (bit 0, b, is set).
    const int width = a.n_tails ? 32 - __clz(mask_window(act, b, a.span, a.words)) : a.span;
    if (width < a.span) {
      emit(4 + width - 1, 9 + 2 * (width - 1), b, -1);  // starts AT b, never clamped
    } else {
      const bool needs_mask = (s * g < row * g + g) || (s * g + a.tile_j > a.n) ||
                              (row * g + g > a.n) || (b > s);
      const int cat = needs_mask ? 3 : (zneed ? 2 : (xneed ? 1 : 0));
      emit(cat, 2 * cat, s, cat == 3 ? (b > s ? b : 0) : -1);
    }
  }
}

// One block (REPLICAS: block q packs replica q, whose flags, lists and counts
// lie at q times their sizes): minBlocks = 1 lets ptxas use up to 64
// registers a thread (aiming at two 1024-thread blocks an SM, it spilled the
// scan's state at 32).
template <bool REPLICAS, typename Src>
__global__ void __launch_bounds__(kPackMaxWarps * 32, 1) pack_window_kernel(PackArgs a, Src src) {
  if (REPLICAS) {
    const size_t q = blockIdx.x;
    src.replica(q);
    a.tiles += q * (9 + 2 * a.n_tails) * static_cast<size_t>(a.max_t);
    a.tcounts += q * a.n_cats;
  }
  extern __shared__ int smem[];
  int* offs = smem;  // [n_cats][n_b]: counts, then offsets
  unsigned* stage = reinterpret_cast<unsigned*>(smem + a.n_cats * a.n_b);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  // Pass 1: a warp a row, the row's visits counted per category (lane c
  // holds category c's count).
  for (int row = warp; row < a.n_b; row += n_warps) {
    unsigned act, zr, xr;
    row_masks(a, src, stage, row, false, &act, &zr, &xr);
    int cnt = 0;
    cover_row(a, row, act, zr, xr, [&](int cat, int, int, int) { cnt += lane == cat; });
    if (lane < a.n_cats) offs[lane * a.n_b + row] = cnt;
  }
  __syncthreads();

  // Exclusive scan over rows, a warp a category (warps c, c + n_warps, ...):
  // lane l sums its q rows [l q, l q + q) in order, the warp scans the lane
  // totals by shuffles, and lane l writes its rows' offsets; the grand total
  // is tcounts[c].
  const int q = (a.n_b + 31) / 32;
  for (int c = warp; c < a.n_cats; c += n_warps) {
    int* oc = offs + c * a.n_b;
    const int r0 = min(lane * q, a.n_b);
    const int r1 = min(r0 + q, a.n_b);
    int own = 0;
    for (int r = r0; r < r1; ++r) own += oc[r];
    int x = own;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    int acc = x - own;
    for (int r = r0; r < r1; ++r) {
      const int k = oc[r];
      oc[r] = acc;
      acc += k;
    }
    if (lane == 31) a.tcounts[c] = x;
  }
  __syncthreads();

  // Pass 2: the same walk, each visit written at its offset (lane c holds
  // category c's next slot; lane 0 writes).
  for (int row = warp; row < a.n_b; row += n_warps) {
    unsigned act, zr, xr;
    row_masks(a, src, stage, row, a.staged != 0, &act, &zr, &xr);
    int pos = lane < a.n_cats ? offs[lane * a.n_b + row] : 0;
    cover_row(a, row, act, zr, xr, [&](int cat, int list_row, int j_blk, int jmin) {
      const int k = __shfl_sync(0xffffffffu, pos, cat);
      if (lane == 0) {
        a.tiles[static_cast<size_t>(list_row) * a.max_t + k] = row;
        a.tiles[static_cast<size_t>(list_row + 1) * a.max_t + k] = j_blk;
        if (jmin >= 0) a.tiles[static_cast<size_t>(8) * a.max_t + k] = jmin;
      }
      pos += lane == cat;
    });
  }
}

// Checks the geometry, fills the arguments and launches one block a replica
// (replicas 0: the one-system kernel).
template <typename Src>
int launch_pack(Src src, int* tiles, int* tcounts, int n, int n_b, int tile_i, int tile_j,
                int n_tails, int max_t, int replicas, cudaStream_t s) {
  const int span = tile_i > 0 ? tile_j / tile_i : 0;
  if (n_b < 1 || n_b > kPackMaxRows || span < 1 || span > kPackMaxSpan || span > n_b ||
      (n_tails != 0 && n_tails != span - 1) || replicas < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PackArgs a{tiles, tcounts, n, n_b, tile_i, tile_j, span, n_tails, 4 + n_tails, max_t,
             (n_b + 31) / 32, 0};
  const size_t counts = sizeof(int) * a.n_cats * n_b;
  const size_t masks = sizeof(unsigned) * 3 * static_cast<size_t>(n_b) * a.words;
  a.staged = counts + masks <= kPackSmemBytes;
  const int threads = 32 * (n_b < kPackMaxWarps ? n_b : kPackMaxWarps);
  const size_t smem = counts + (a.staged ? masks : 0);
  if (replicas > 0) {
    pack_window_kernel<true><<<replicas, threads, smem, s>>>(a, src);
  } else {
    pack_window_kernel<false><<<1, threads, smem, s>>>(a, src);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int pack_intervals_entry(const T* ivl, int* tiles, int* tcounts, int n, int n_b, int tile_i,
                         int tile_j, int n_tails, int max_t, int replicas, int slab, T win_z,
                         T win_x, T box, T cross, T box_cross, T face, T box_face, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slab) {
    const FlagIntervals<T, true> src{ivl, n_b, win_z, win_x, box, cross, box_cross, face,
                                     box_face};
    return launch_pack(src, tiles, tcounts, n, n_b, tile_i, tile_j, n_tails, max_t, replicas, s);
  }
  const FlagIntervals<T, false> src{ivl, n_b, win_z, win_x, box, cross, box_cross, face,
                                    box_face};
  return launch_pack(src, tiles, tcounts, n, n_b, tile_i, tile_j, n_tails, max_t, replicas, s);
}

}  // namespace ljmd

extern "C" {

int ljmd_pack_max_rows() { return ljmd::kPackMaxRows; }

// `replicas` 0: one system; R >= 1: flags (R, n_b * n_b), tiles (R, 9 + 2
// n_tails, max_t), tcounts (R, 4 + n_tails), packed by the replica kernel (R
// blocks).
int ljmd_pack_window_lists(const int* flags, int* tiles, int* tcounts, int n, int n_b,
                           int tile_i, int tile_j, int n_tails, int max_t, int replicas,
                           void* stream) {
  return ljmd::launch_pack(ljmd::FlagArray{flags, n_b}, tiles, tcounts, n, n_b, tile_i, tile_j,
                           n_tails, max_t, replicas, static_cast<cudaStream_t>(stream));
}

// The resort's pack (csrc/zsort_resort.cu calls it): the flags worked out
// from ivl, (R, 4, n_b) tile intervals ((4, n_b) with replicas 0), at tile_i
// x tile_i; `slab` adds the x axis (window win_x).
int ljmd_pack_window_lists_intervals_f32(const float* ivl, int* tiles, int* tcounts, int n,
                                         int n_b, int tile_i, int tile_j, int n_tails, int max_t,
                                         int replicas, int slab, float win_z, float win_x,
                                         float box, float cross, float box_cross, float face,
                                         float box_face, void* stream) {
  return ljmd::pack_intervals_entry<float>(ivl, tiles, tcounts, n, n_b, tile_i, tile_j, n_tails,
                                           max_t, replicas, slab, win_z, win_x, box, cross,
                                           box_cross, face, box_face, stream);
}

int ljmd_pack_window_lists_intervals_f64(const double* ivl, int* tiles, int* tcounts, int n,
                                         int n_b, int tile_i, int tile_j, int n_tails, int max_t,
                                         int replicas, int slab, double win_z, double win_x,
                                         double box, double cross, double box_cross, double face,
                                         double box_face, void* stream) {
  return ljmd::pack_intervals_entry<double>(ivl, tiles, tcounts, n, n_b, tile_i, tile_j, n_tails,
                                            max_t, replicas, slab, win_z, win_x, box, cross,
                                            box_cross, face, box_face, stream);
}

}  // extern "C"
