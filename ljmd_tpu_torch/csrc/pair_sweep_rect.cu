// Kernels 6 and 7: the rect sweeps of the particle-sharded (multi-device)
// path, one rank's i rows against a visiting j block.
//
// Replaces: ljmd_tpu/ops/pallas_lj.py:364 `pallas_pair_sweep_rect` (Pallas
// body `_lj_rect_kernel`, :301; the `comm="ring"` hops) and :533
// `pallas_pair_sweep_rect_newton` (`_lj_rect_newton_kernel`, :433; the
// `comm="half_ring"` hops). Contract, column for column:
//
// - rect: out (8, ni_pad); rows 0..2 the force on each i row without the 24
//   prefactor, rows 3..5 e / du / ddu, both summed over every j of the block
//   inside the cutoff with gi0 + li != gj0 + lj (ordered pairs: the caller
//   restores the prefactors 2 / 12 after the cross-rank sum); masks li < n_i,
//   lj < n_j; rows 6..7 and columns >= n_i exactly 0.
// - rect-Newton: each pair of the active range [i_lo, n_i) x [0, j_hi) once.
//   out_i (8, ni_pad): rows 0..2 the i-side forces, rows 3..5 the pair-once
//   e / du / ddu (prefactors 4 / 24, no halving); out_j (8, nj_pad): rows
//   0..2 the j-side reactions, rows 3..7 exactly 0 (the caller adds out_j
//   into its accumulator rows wholesale). Pairs outside the range, padding
//   and gi == gj are masked.
//
// What bounds it on the H100: the pair arithmetic (~30 instructions and one
// IEEE divide a pair; ni x nj candidates a hop, 1000 x 1000 at N=4000 over
// four ranks); the rows (32 KB each) stay in L2. At these shapes the launch
// is short and latency matters as much as the count.
//
// Kernel 6 runs the dense sweeps' body (pair_rows.cuh), generalised to
// distinct i / j matrices with global offsets, so nothing of it is written
// twice.
//
// Kernel 7 has a kernel of its own. The earlier port ran the dense body
// here too: 32 i rows a block x 4 partner slices, lda / 32 blocks a role, so
// the 1000 x 1000 hop was 64 blocks of 4 warps on 132 SMs, each thread
// walking ~250 partners one after another with the full LJ algebra on every
// one. What the design does about that:
// - Pair-twice with no atomics, both roles in one launch: the TPU keeps the
//   j reactions resident in VMEM across its sequential grid, but Hopper's
//   blocks run in no order, so i-role blocks sum each active i row's pairs
//   with the active j range and j-role blocks each active j row's negated
//   pair forces over the active i range. fl(xi - xj) == -fl(xj - xi) and the
//   round is odd, so the two sides are exact negations (pair_rows.cuh).
// - A block is 256 threads: tile = 256 / S rows, S threads a row taking
//   partners slice, slice + S, ... S (a power of two, 4..128) comes from the
//   occupancy API (rect_newton_plan): the largest S whose live blocks all
//   run in one wave of at most 3 blocks an SM, each thread keeping a partner
//   (1000 x 1000: S = 32, 250 blocks; the d=4 half hop S = 64, 375; N=500's
//   half hop S = 64, 95). S = 256 would need both roles' ranges >= 256
//   rows, so >= 512 live blocks: more than one such wave on any card of
//   fewer than 171 SMs. The S partial sums of a row are added by warp
//   shuffles, then for S > 32 in shared memory warp by warp: a fixed order.
// - The block stages its partner rows once, by cp.async through a ring of
//   three 512-column buffers (the 1000-partner hop: both chunks in flight
//   from the start), one __syncthreads() a chunk.
// - The warp-vote cull: displacement, minimum image and r^2 for every
//   candidate; the LJ algebra and the sums only where a lane of the warp
//   holds the mask. In production a rank's rows are contiguous particle
//   indices, so on an ordered lattice blocks that lie apart skip every body.
// - Blocks wholly outside the active range only write zeros (the Pallas
//   kernel's compute gate), so the gated half hop costs half a full hop.
#include <cuda_runtime.h>

#include <mutex>

#include "async_copy.cuh"
#include "pair_rows.cuh"

namespace ljmd {

constexpr int kRnThreads = 256;   // threads of a block (8 warps)
constexpr int kRnWarps = kRnThreads / 32;
constexpr int kRnChunk = 512;     // partner columns a staged chunk
constexpr int kRnRing = 3;        // staging buffers
constexpr int kRnAlign = 32;      // staged column granule (16-byte pieces, both types)
constexpr int kRnMinSlices = 4;
constexpr int kRnMaxSlices = 128;
constexpr int kRnBlocksPerSm = 3;  // live blocks an SM at most (the S rule)

template <typename T>
int launch_rect(const T* pos_i, const T* pos_j, T* out, int n_i, int ni_pad, int n_j,
                int nj_pad, int gi0, int gj0, T box, T inv_box, T rc2, int want_obs,
                void* stream) {
  const RowsProblem<T> p = rows_problem<T>(pos_i, pos_j, out, n_i, ni_pad, 0, n_i, n_j, nj_pad,
                                           0, n_j, gi0, gj0, 1);
  return launch_rows_problems<T, true>(p, nullptr, want_obs, box, inv_box, rc2, stream);
}

// One role of the rect-Newton launch: the active rows [a_lo, a_hi) of A
// against the active partners [b_lo, b_hi) of B.
template <typename T>
struct RnRole {
  const T* a;  // (8, lda) rows whose forces are summed
  const T* b;  // (8, ldb) partner rows
  T* out;      // (8, lda)
  int lda, a_lo, a_hi;
  int ldb, b_lo, b_hi;
  int ga0, gb0;
  int obs;     // sum rows 3..5 (the i role, where the template's OBS is set)
  int blocks;  // lda / tile
};

template <typename T, bool OBS>
__global__ void __launch_bounds__(kRnThreads)
rect_newton_kernel(RnRole<T> r0, RnRole<T> r1, int S, T box, T inv_box, T rc2) {
  __shared__ __align__(16) T ring[kRnRing][3][kRnChunk];
  __shared__ T red[kRnWarps][6];
  const bool second = static_cast<int>(blockIdx.x) >= r0.blocks;
  const RnRole<T> p = second ? r1 : r0;
  const int blk = second ? blockIdx.x - r0.blocks : blockIdx.x;
  const int tid = threadIdx.x;
  const int tile = kRnThreads / S;
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

  // Partner columns [c_lo, b_hi) in chunks of kRnChunk, each staged as its
  // kRnAlign-rounded columns (within ldb, a multiple of 128).
  const int c_lo = p.b_lo / kRnAlign * kRnAlign;
  const int c_end = (p.b_hi + kRnAlign - 1) / kRnAlign * kRnAlign;
  const int n_chunks = (p.b_hi - c_lo + kRnChunk - 1) / kRnChunk;
  T acc[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
  stage_rows(&ring[0][0][0], kRnChunk, p.b, p.b, p.ldb, 3, static_cast<size_t>(c_lo),
             min(kRnChunk, c_end - c_lo), tid, kRnThreads);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    const int j0 = c_lo + c * kRnChunk;
    if (c + 1 < n_chunks) {
      stage_rows(&ring[(c + 1) % kRnRing][0][0], kRnChunk, p.b, p.b, p.ldb, 3,
                 static_cast<size_t>(j0 + kRnChunk), min(kRnChunk, c_end - j0 - kRnChunk), tid,
                 kRnThreads);
      cp_async_commit();
      cp_async_wait(1);
    } else {
      cp_async_wait(0);
    }
    // Chunk c has landed for every thread; the buffer chunk c + 1 is copied
    // into was last read at chunk c - 2, before the previous barrier.
    __syncthreads();
    const T(*s)[kRnChunk] = ring[c % kRnRing];
    // The same trip count on every lane (the vote needs the whole warp);
    // columns past b_hi are masked by index and their values never used.
    const int span = (min(kRnChunk, p.b_hi - j0) + S - 1) / S * S;
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
          if (obs) {
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

template <typename T>
RnRole<T> rn_role(const T* a, const T* b, T* out, int lda, int a_lo, int a_hi, int ldb,
                  int b_lo, int b_hi, int ga0, int gb0, int obs, int tile) {
  return RnRole<T>{a, b, out, lda, a_lo, a_hi, ldb, b_lo, b_hi, ga0, gb0, obs, lda / tile};
}

// Blocks of `tile` rows of a role that meet its active rows [a_lo, a_hi)
// while its partner range [b_lo, b_hi) is not empty (the kernel's gate).
inline int rn_live_blocks(int a_lo, int a_hi, int b_lo, int b_hi, int tile) {
  if (a_lo >= a_hi || b_lo >= b_hi) return 0;
  return (a_hi - 1) / tile - a_lo / tile + 1;
}

// The occupancy facts of one instantiation on one device, asked once (the
// kernel launches on every hop; the ranks of a thread mesh launch at once).
struct RnOccupancy {
  int per_sm, sms, regs, spill;
};

template <typename T, bool OBS>
int rn_occupancy(RnOccupancy* occ) {
  constexpr int kMaxDevices = 64;
  static std::mutex lock;
  static RnOccupancy cache[kMaxDevices];
  static bool known[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  std::lock_guard<std::mutex> guard(lock);
  if (!known[dev]) {
    const void* fn = reinterpret_cast<const void*>(rect_newton_kernel<T, OBS>);
    RnOccupancy o{};
    err = cudaDeviceGetAttribute(&o.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o.per_sm, fn, kRnThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return static_cast<int>(err);
    o.regs = attr.numRegs;
    o.spill = static_cast<int>(attr.localSizeBytes);
    cache[dev] = o;
    known[dev] = true;
  }
  *occ = cache[dev];
  return 0;
}

// The launch shape at these ranges: out = {S, tile, live blocks, grid
// blocks, resident blocks an SM, SMs, registers a thread, spill bytes a
// thread}.
template <typename T, bool OBS>
int rn_plan(int ni_pad, int nj_pad, int n_i, int i_lo, int j_hi, int* out) {
  RnOccupancy occ;
  const int err = rn_occupancy<T, OBS>(&occ);
  if (err != 0) return err;
  // i role: rows [i_lo, n_i) against [0, j_hi); j role: rows [0, j_hi)
  // against [i_lo, n_i).
  auto live = [&](int s) {
    const int tile = kRnThreads / s;
    return rn_live_blocks(i_lo, n_i, 0, j_hi, tile) + rn_live_blocks(0, j_hi, i_lo, n_i, tile);
  };
  // The largest S whose live blocks all run at once, at most kRnBlocksPerSm
  // of them an SM, with at least one partner a thread on both roles; else
  // (ranks far larger than the card) the smallest. An S sweep on the H100
  // put the best time there, or within 0.0001 ms of it, at 19 of the main
  // path's 20 hops: more blocks an SM restage the partners more often than
  // their shorter loops save.
  const long long wave = static_cast<long long>(min(occ.per_sm, kRnBlocksPerSm)) * occ.sms;
  const int cols = min(j_hi, n_i - i_lo);
  int slices = kRnMinSlices;
  for (int s = kRnMinSlices; s <= kRnMaxSlices; s *= 2) {
    if (live(s) <= wave && cols >= s) slices = s;
  }
  const int tile = kRnThreads / slices;
  out[0] = slices;
  out[1] = tile;
  out[2] = live(slices);
  out[3] = ni_pad / tile + nj_pad / tile;
  out[4] = occ.per_sm;
  out[5] = occ.sms;
  out[6] = occ.regs;
  out[7] = occ.spill;
  return 0;
}

template <typename T>
int rn_plan_any(int want_obs, int ni_pad, int nj_pad, int n_i, int i_lo, int j_hi, int* out) {
  return want_obs ? rn_plan<T, true>(ni_pad, nj_pad, n_i, i_lo, j_hi, out)
                  : rn_plan<T, false>(ni_pad, nj_pad, n_i, i_lo, j_hi, out);
}

template <typename T>
int launch_rect_newton(const T* pos_i, const T* pos_j, T* out_i, T* out_j, int n_i, int ni_pad,
                       int n_j, int nj_pad, int gi0, int gj0, int i_lo, int j_hi, T box,
                       T inv_box, T rc2, int want_obs, void* stream) {
  if (ni_pad % 128 || nj_pad % 128 || i_lo < 0 || i_lo > n_i || n_i > ni_pad || j_hi < 0 ||
      j_hi > n_j || n_j > nj_pad) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int plan[8];
  const int err = rn_plan_any<T>(want_obs, ni_pad, nj_pad, n_i, i_lo, j_hi, plan);
  if (err != 0) return err;
  const int S = plan[0];
  const int tile = plan[1];
  const RnRole<T> ir = rn_role<T>(pos_i, pos_j, out_i, ni_pad, i_lo, n_i, nj_pad, 0, j_hi, gi0,
                                  gj0, 1, tile);
  const RnRole<T> jr = rn_role<T>(pos_j, pos_i, out_j, nj_pad, 0, j_hi, ni_pad, i_lo, n_i, gj0,
                                  gi0, 0, tile);
  const dim3 grid(ir.blocks + jr.blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (want_obs) {
    rect_newton_kernel<T, true><<<grid, kRnThreads, 0, s>>>(ir, jr, S, box, inv_box, rc2);
  } else {
    rect_newton_kernel<T, false><<<grid, kRnThreads, 0, s>>>(ir, jr, S, box, inv_box, rc2);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ljmd

extern "C" {

int ljmd_pair_sweep_rect_f32(const float* pos_i, const float* pos_j, float* out, int n_i,
                             int ni_pad, int n_j, int nj_pad, int gi0, int gj0, float box,
                             float inv_box, float rc2, int want_obs, void* stream) {
  return ljmd::launch_rect<float>(pos_i, pos_j, out, n_i, ni_pad, n_j, nj_pad, gi0, gj0, box,
                                  inv_box, rc2, want_obs, stream);
}

int ljmd_pair_sweep_rect_f64(const double* pos_i, const double* pos_j, double* out, int n_i,
                             int ni_pad, int n_j, int nj_pad, int gi0, int gj0, double box,
                             double inv_box, double rc2, int want_obs, void* stream) {
  return ljmd::launch_rect<double>(pos_i, pos_j, out, n_i, ni_pad, n_j, nj_pad, gi0, gj0, box,
                                   inv_box, rc2, want_obs, stream);
}

int ljmd_pair_sweep_rect_newton_f32(const float* pos_i, const float* pos_j, float* out_i,
                                    float* out_j, int n_i, int ni_pad, int n_j, int nj_pad,
                                    int gi0, int gj0, int i_lo, int j_hi, float box,
                                    float inv_box, float rc2, int want_obs, void* stream) {
  return ljmd::launch_rect_newton<float>(pos_i, pos_j, out_i, out_j, n_i, ni_pad, n_j, nj_pad,
                                         gi0, gj0, i_lo, j_hi, box, inv_box, rc2, want_obs,
                                         stream);
}

int ljmd_pair_sweep_rect_newton_f64(const double* pos_i, const double* pos_j, double* out_i,
                                    double* out_j, int n_i, int ni_pad, int n_j, int nj_pad,
                                    int gi0, int gj0, int i_lo, int j_hi, double box,
                                    double inv_box, double rc2, int want_obs, void* stream) {
  return ljmd::launch_rect_newton<double>(pos_i, pos_j, out_i, out_j, n_i, ni_pad, n_j, nj_pad,
                                          gi0, gj0, i_lo, j_hi, box, inv_box, rc2, want_obs,
                                          stream);
}

// Kernel 7's launch shape (ljmd::rn_plan): out[0..7] = S, tile, live
// blocks, grid blocks, resident blocks an SM, SMs, registers, spill bytes.
int ljmd_rect_newton_plan(int dtype_bytes, int want_obs, int ni_pad, int nj_pad, int n_i,
                          int i_lo, int j_hi, int* out) {
  if (dtype_bytes == 4) {
    return ljmd::rn_plan_any<float>(want_obs, ni_pad, nj_pad, n_i, i_lo, j_hi, out);
  }
  return ljmd::rn_plan_any<double>(want_obs, ni_pad, nj_pad, n_i, i_lo, j_hi, out);
}

}  // extern "C"
