// Kernel 9: the visit-list pack of the z-sorted window-list engine.
//
// Replaces: ljmd_tpu/ops/pallas_fused.py:803 `build_window_lists_pallas`
// (its Pallas body `_pack_window_kernel`, :676). Contract: flags are the
// (n_b * n_b,) int32 block-pair flags of compute_tile_flags (bit 0 active,
// bit 1 z round, bit 2 x round) at tile_i x tile_i granularity, rowspan the
// (2, n_b) per-row active band [first, last + 1). Out: tiles
// (9 + 2 * n_tails, max_t) and tcounts (4 + n_tails,), element for element the
// lists of the sequential Pallas kernel on the count prefix (the same
// row-major emission order within each category, the same jmin row 8, the
// same tail rows). Entries past the counts are not written.
//
// What bounds it on the H100: nothing arithmetic. It is integer control flow
// over at most a few thousand flags (n_b = 32 at N = 4000), so it is one
// launch's latency; the TPU version is a single scalar loop for the same
// reason (per-op dispatch of the jnp version cost more than the work).
//
// What the design does about that: one block, one thread per i-row. Each
// row's greedy cover is independent of the others; only the category
// counters are shared. So pass 1 runs every row's cover and counts its
// emissions per category, an exclusive scan over rows (one thread per
// category) turns the counts into offsets, and pass 2 runs the cover again
// and writes each emission at its offset. That reproduces the sequential
// kernel's order exactly, with no atomics; the counts never leave the device.
#include <cuda_runtime.h>

namespace ljmd {

constexpr int kPackMaxRows = 1024;  // threads of the one block
constexpr int kPackMaxSpan = 8;     // tile_j / tile_i
constexpr int kPackMaxCats = 4 + kPackMaxSpan - 1;

// One row's greedy cover. Calls emit(category, list row, i-block, j-block,
// jmin) for each visit, in the order of the Pallas kernel.
template <typename Emit>
__device__ void cover_row(const int* flags, int row, int b_begin, int b_end,
                          int n, int n_b, int g, int tile_j, int span,
                          int n_tails, Emit emit) {
  const int max_start = n_b - span;
  const int* f = flags + static_cast<size_t>(row) * n_b;
  int covered = 0;
  for (int b = b_begin; b < b_end; ++b) {
    const int fb = f[b];
    if (!(fb > 0 && b >= row && b >= covered)) continue;
    const int s = min(b, max_start);
    bool zneed = (fb & 2) != 0;
    bool xneed = (fb & 4) != 0;
    int width = 1;
    for (int k = 1; k < span; ++k) {
      const int cb = b + k;
      if (cb < n_b) {
        const int fz = f[cb];
        zneed = zneed || ((fz & 2) != 0);
        xneed = xneed || ((fz & 4) != 0);
        if (n_tails && fz > 0) width = k + 1;
      }
    }
    if (n_tails && width < span) {
      // Tail: exact active width, starts AT the block (never clamped).
      emit(4 + width - 1, 9 + 2 * (width - 1), row, b, -1);
    } else {
      const bool needs_mask = (s * g < row * g + g) || (s * g + tile_j > n) ||
                              (row * g + g > n) || (b > s);
      const int cat = needs_mask ? 3 : (zneed ? 2 : (xneed ? 1 : 0));
      emit(cat, 2 * cat, row, s, cat == 3 ? (b > s ? b : 0) : -1);
    }
    covered = b + span;
  }
}

__global__ void pack_window_kernel(const int* __restrict__ flags,
                                   const int* __restrict__ rowspan,
                                   int* __restrict__ tiles,
                                   int* __restrict__ tcounts, int n, int n_b,
                                   int g, int tile_j, int n_tails, int max_t) {
  __shared__ int offs[kPackMaxCats][kPackMaxRows];
  const int span = tile_j / g;
  const int n_cats = 4 + n_tails;
  const int row = threadIdx.x;
  const bool live = row < n_b;
  const int b_begin = live ? max(rowspan[row], row) : 0;
  const int b_end = live ? rowspan[n_b + row] : 0;

  // Pass 1: this row's emissions per category.
  int cnt[kPackMaxCats];
#pragma unroll
  for (int c = 0; c < kPackMaxCats; ++c) cnt[c] = 0;
  if (live) {
    cover_row(flags, row, b_begin, b_end, n, n_b, g, tile_j, span, n_tails,
              [&](int cat, int, int, int, int) { cnt[cat] += 1; });
  }
#pragma unroll
  for (int c = 0; c < kPackMaxCats; ++c) {
    if (c < n_cats && live) offs[c][row] = cnt[c];
  }
  __syncthreads();

  // Exclusive scan over rows, one thread per category; totals -> tcounts.
  if (row < n_cats) {
    int acc = 0;
    for (int r = 0; r < n_b; ++r) {
      const int k = offs[row][r];
      offs[row][r] = acc;
      acc += k;
    }
    tcounts[row] = acc;
  }
  __syncthreads();

  // Pass 2: the same cover, writing each emission at its offset.
  if (live) {
    int pos[kPackMaxCats];
#pragma unroll
    for (int c = 0; c < kPackMaxCats; ++c) pos[c] = c < n_cats ? offs[c][row] : 0;
    cover_row(flags, row, b_begin, b_end, n, n_b, g, tile_j, span, n_tails,
              [&](int cat, int list_row, int i_blk, int j_blk, int jmin) {
                const int k = pos[cat]++;
                tiles[static_cast<size_t>(list_row) * max_t + k] = i_blk;
                tiles[static_cast<size_t>(list_row + 1) * max_t + k] = j_blk;
                if (jmin >= 0) tiles[static_cast<size_t>(8) * max_t + k] = jmin;
              });
  }
}

}  // namespace ljmd

extern "C" {

int ljmd_pack_max_rows() { return ljmd::kPackMaxRows; }

int ljmd_pack_window_lists(const int* flags, const int* rowspan, int* tiles,
                           int* tcounts, int n, int n_b, int tile_i,
                           int tile_j, int n_tails, int max_t, void* stream) {
  if (n_b < 1 || n_b > ljmd::kPackMaxRows || tile_j / tile_i > ljmd::kPackMaxSpan) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = ((n_b + 31) / 32) * 32;
  ljmd::pack_window_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      flags, rowspan, tiles, tcounts, n, n_b, tile_i, tile_j, n_tails, max_t);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
