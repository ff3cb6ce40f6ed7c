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
// Contract: flags (n_b * n_b,) int32 of compute_tile_flags (bit 0 active,
// bit 1 z round, bit 2 x round, > 0 visited) at tile_i x tile_i. Out: tiles
// (9 + 2 * n_tails, max_t) and tcounts (4 + n_tails,), element for element
// the lists of the sequential Pallas kernel on the count prefix (the same
// row-major order within each category, the same jmin row 8, the same tail
// rows). Entries past the counts are not written.
#include <cuda_runtime.h>

namespace ljmd {

constexpr int kPackMaxRows = 1024;  // n_b at most: a row's mask word a lane
constexpr int kPackMaxSpan = 8;     // tile_j / tile_i
constexpr int kPackMaxWarps = 32;
// Dynamic shared memory without an opt-in: the counts (n_cats x n_b ints,
// 44 KB at n_b = 1024) always, the masks (3 x n_b x words) where they fit.
constexpr int kPackSmemBytes = 48 * 1024;

struct PackArgs {
  const int* flags;
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

// Row `row`'s three masks, word `lane` in each lane: from the flags, 32 a
// load (and into the stage), or from the stage.
__device__ __forceinline__ void row_masks(const PackArgs& a, unsigned* stage, int row,
                                          bool from_stage, unsigned* act, unsigned* zr,
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
  const int* f = a.flags + static_cast<size_t>(row) * a.n_b;
  *act = *zr = *xr = 0u;
  for (int w = 0; w < a.words; ++w) {
    const int col = 32 * w + lane;
    const int fl = col < a.n_b ? f[col] : 0;
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
template <bool REPLICAS>
__global__ void __launch_bounds__(kPackMaxWarps * 32, 1) pack_window_kernel(PackArgs a) {
  if (REPLICAS) {
    const size_t q = blockIdx.x;
    a.flags += q * a.n_b * a.n_b;
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
    row_masks(a, stage, row, false, &act, &zr, &xr);
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
    row_masks(a, stage, row, a.staged != 0, &act, &zr, &xr);
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

}  // namespace ljmd

extern "C" {

int ljmd_pack_max_rows() { return ljmd::kPackMaxRows; }

// `replicas` 0: one system; R >= 1: flags (R, n_b * n_b), tiles (R, 9 + 2
// n_tails, max_t), tcounts (R, 4 + n_tails), packed by the replica kernel (R
// blocks).
int ljmd_pack_window_lists(const int* flags, int* tiles, int* tcounts, int n, int n_b,
                           int tile_i, int tile_j, int n_tails, int max_t, int replicas,
                           void* stream) {
  const int span = tile_i > 0 ? tile_j / tile_i : 0;
  if (n_b < 1 || n_b > ljmd::kPackMaxRows || span < 1 || span > ljmd::kPackMaxSpan ||
      span > n_b || (n_tails != 0 && n_tails != span - 1) || replicas < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ljmd::PackArgs a{flags, tiles, tcounts, n, n_b, tile_i, tile_j, span, n_tails,
                   4 + n_tails, max_t, (n_b + 31) / 32, 0};
  const size_t counts = sizeof(int) * a.n_cats * n_b;
  const size_t masks = sizeof(unsigned) * 3 * static_cast<size_t>(n_b) * a.words;
  a.staged = counts + masks <= ljmd::kPackSmemBytes;
  const int threads = 32 * (n_b < ljmd::kPackMaxWarps ? n_b : ljmd::kPackMaxWarps);
  const size_t smem = counts + (a.staged ? masks : 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (replicas > 0) {
    ljmd::pack_window_kernel<true><<<replicas, threads, smem, s>>>(a);
  } else {
    ljmd::pack_window_kernel<false><<<1, threads, smem, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
