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
// What the design does about that: kernel 6 is the single-role kernel of
// rows_sweep.cuh, which explains it: 256-thread blocks of 256 / S rows, S
// threads a row from the occupancy API (2000 x 2000: S = 32, 250 blocks;
// 1000 x 1000: S = 64), partners staged by cp.async, a warp-vote cull and
// fixed-order sums.
//
// Kernel 7 has the same design with both roles in one launch: the TPU keeps
// the j reactions resident in VMEM across its sequential grid, but Hopper's
// blocks run in no order, so i-role blocks sum each active i row's pairs
// with the active j range and j-role blocks each active j row's negated pair
// forces over the active i range (the exact negation: rows_sweep.cuh). Its
// S rule counts both roles' live blocks (1000 x 1000: S = 32, 250 blocks;
// the d=4 half hop S = 64, 375; N=500's half hop S = 64, 95). Blocks wholly
// outside the active range only write zeros, so the gated half hop costs
// half a full hop; in production a rank's rows are contiguous particle
// indices, so on an ordered lattice blocks that lie apart skip every body.
// Its kernel writes rows_sweep_block's body out: called through that device
// function, nvcc allotted it other registers (float64 56 / 58 -> 48 / 52)
// and it ran 3-10% slower in float64 on the H100, bit for bit the same.
//
// Replicas (the replica x particle step: a rank's R_local replicas, their
// rows (R, 8, ld) stacks): one launch each, blockIdx.y the replica, at the
// one-replica launch's S and grid, so replica q's outputs equal a launch on
// replica q's rows bit for bit and never read another replica's. Kernel 6's
// is its own kernel around rows_sweep_block; kernel 7's is the REPLICAS
// instantiation of its written-out kernel, whose replica offsets fold away in
// the one-system instantiation (its code and registers stay as they were).
#include <cuda_runtime.h>

#include "rows_sweep.cuh"

namespace ljmd {

// Kernel 7: rows_sweep_block's body written out with both roles (the header
// says why).
// Role p of replica q: its rows at q * 8 * ld of each stack.
template <typename T>
__device__ __forceinline__ RowsRole<T> replica_role(RowsRole<T> p, size_t q) {
  p.a += q * 8 * p.lda;
  p.b += q * 8 * p.ldb;
  p.out += q * 8 * p.lda;
  return p;
}

template <typename T, bool OBS, bool REPLICAS = false>
__global__ void __launch_bounds__(kRowsThreads)
rect_newton_kernel(RowsRole<T> r0, RowsRole<T> r1, int S, T box, T inv_box, T rc2) {
  __shared__ __align__(16) T ring[kRowsRing][3][kRowsChunk];
  __shared__ T red[kRowsWarps][6];
  const bool second = static_cast<int>(blockIdx.x) >= r0.blocks;
  const RowsRole<T> p =
      REPLICAS ? replica_role(second ? r1 : r0, blockIdx.y) : (second ? r1 : r0);
  const int blk = second ? blockIdx.x - r0.blocks : blockIdx.x;
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
                 static_cast<size_t>(j0 + kRowsChunk), min(kRowsChunk, c_end - j0 - kRowsChunk), tid,
                 kRowsThreads);
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

// Kernel 6's replica launch: blockIdx.y the replica.
template <typename T, bool OBS>
__global__ void __launch_bounds__(kRowsThreads)
rect_replicas_kernel(RowsRole<T> p, int S, T box, T inv_box, T rc2) {
  rows_sweep_block<T, OBS, false>(replica_role(p, blockIdx.y), blockIdx.x, S, box, inv_box,
                                  rc2);
}

// R rect sweeps, replica q's rows [0, n_i) of its (8, ni_pad) matrix against
// the partners [0, n_j) of its (8, nj_pad) one, in one launch of (ni_pad /
// tile, R) blocks at the one-replica plan's S.
template <typename T>
int launch_rect_replicas(const T* pos_i, const T* pos_j, T* out, int n_i, int ni_pad, int n_j,
                         int nj_pad, int replicas, int gi0, int gj0, T box, T inv_box, T rc2,
                         int want_obs, void* stream) {
  if (ni_pad % 128 || nj_pad % 128 || n_i < 0 || n_i > ni_pad || n_j < 0 || n_j > nj_pad ||
      replicas < 1 || replicas > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int plan[8];
  const int err = rows_plan_any<T, false>(want_obs, n_i, ni_pad, n_j, plan);
  if (err != 0) return err;
  const RowsRole<T> p =
      rows_role<T>(pos_i, pos_j, out, ni_pad, 0, n_i, nj_pad, 0, n_j, gi0, gj0, 1, plan[1]);
  const dim3 grid(p.blocks, replicas);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (want_obs) {
    rect_replicas_kernel<T, true><<<grid, kRowsThreads, 0, s>>>(p, plan[0], box, inv_box, rc2);
  } else {
    rect_replicas_kernel<T, false><<<grid, kRowsThreads, 0, s>>>(p, plan[0], box, inv_box, rc2);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel 7's launch shape at these ranges (rows_plan_out's fields).
template <typename T, bool OBS>
int rn_plan(int ni_pad, int nj_pad, int n_i, int i_lo, int j_hi, int* out) {
  RowsOccupancy occ;
  const int err =
      rows_occupancy(reinterpret_cast<const void*>(rect_newton_kernel<T, OBS>), &occ);
  if (err != 0) return err;
  // i role: rows [i_lo, n_i) against [0, j_hi); j role: rows [0, j_hi)
  // against [i_lo, n_i).
  auto live = [&](int s) {
    const int tile = kRowsThreads / s;
    return rows_live_blocks(i_lo, n_i, 0, j_hi, tile) + rows_live_blocks(0, j_hi, i_lo, n_i, tile);
  };
  const int slices = rows_slices(live, min(j_hi, n_i - i_lo), occ);
  const int tile = kRowsThreads / slices;
  rows_plan_out(slices, live(slices), ni_pad / tile + nj_pad / tile, occ, out);
  return 0;
}

template <typename T>
int rn_plan_any(int want_obs, int ni_pad, int nj_pad, int n_i, int i_lo, int j_hi, int* out) {
  return want_obs ? rn_plan<T, true>(ni_pad, nj_pad, n_i, i_lo, j_hi, out)
                  : rn_plan<T, false>(ni_pad, nj_pad, n_i, i_lo, j_hi, out);
}

// One hop, or (replicas > 0) the hop of each of R replicas' (8, ld) rows in
// one launch of (one-replica grid, R) blocks at the one-replica plan's S.
template <typename T>
int launch_rect_newton(const T* pos_i, const T* pos_j, T* out_i, T* out_j, int n_i, int ni_pad,
                       int n_j, int nj_pad, int gi0, int gj0, int i_lo, int j_hi, T box,
                       T inv_box, T rc2, int want_obs, void* stream, int replicas = 0) {
  if (ni_pad % 128 || nj_pad % 128 || i_lo < 0 || i_lo > n_i || n_i > ni_pad || j_hi < 0 ||
      j_hi > n_j || n_j > nj_pad || replicas < 0 || replicas > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int plan[8];
  const int err = rn_plan_any<T>(want_obs, ni_pad, nj_pad, n_i, i_lo, j_hi, plan);
  if (err != 0) return err;
  const int S = plan[0];
  const int tile = plan[1];
  const RowsRole<T> ir = rows_role<T>(pos_i, pos_j, out_i, ni_pad, i_lo, n_i, nj_pad, 0, j_hi,
                                      gi0, gj0, 1, tile);
  const RowsRole<T> jr = rows_role<T>(pos_j, pos_i, out_j, nj_pad, 0, j_hi, ni_pad, i_lo, n_i,
                                      gj0, gi0, 0, tile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (replicas > 0) {
    const dim3 grid(ir.blocks + jr.blocks, replicas);
    if (want_obs) {
      rect_newton_kernel<T, true, true><<<grid, kRowsThreads, 0, s>>>(ir, jr, S, box, inv_box,
                                                                      rc2);
    } else {
      rect_newton_kernel<T, false, true><<<grid, kRowsThreads, 0, s>>>(ir, jr, S, box, inv_box,
                                                                       rc2);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid(ir.blocks + jr.blocks);
  if (want_obs) {
    rect_newton_kernel<T, true><<<grid, kRowsThreads, 0, s>>>(ir, jr, S, box, inv_box, rc2);
  } else {
    rect_newton_kernel<T, false><<<grid, kRowsThreads, 0, s>>>(ir, jr, S, box, inv_box, rc2);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ljmd

extern "C" {

int ljmd_pair_sweep_rect_f32(const float* pos_i, const float* pos_j, float* out, int n_i,
                             int ni_pad, int n_j, int nj_pad, int gi0, int gj0, float box,
                             float inv_box, float rc2, int want_obs, void* stream) {
  return ljmd::launch_rows_sweep<float, false>(pos_i, pos_j, out, n_i, ni_pad, n_j, nj_pad, gi0,
                                               gj0, box, inv_box, rc2, want_obs, stream);
}

int ljmd_pair_sweep_rect_f64(const double* pos_i, const double* pos_j, double* out, int n_i,
                             int ni_pad, int n_j, int nj_pad, int gi0, int gj0, double box,
                             double inv_box, double rc2, int want_obs, void* stream) {
  return ljmd::launch_rows_sweep<double, false>(pos_i, pos_j, out, n_i, ni_pad, n_j, nj_pad, gi0,
                                                gj0, box, inv_box, rc2, want_obs, stream);
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

// pos_i / out (and out_i) are (R, 8, ni_pad), pos_j (and out_j) (R, 8,
// nj_pad): replica q's sweep as the one-replica entry's on its rows.
int ljmd_pair_sweep_rect_replicas_f32(const float* pos_i, const float* pos_j, float* out,
                                      int n_i, int ni_pad, int n_j, int nj_pad, int replicas,
                                      int gi0, int gj0, float box, float inv_box, float rc2,
                                      int want_obs, void* stream) {
  return ljmd::launch_rect_replicas<float>(pos_i, pos_j, out, n_i, ni_pad, n_j, nj_pad, replicas,
                                           gi0, gj0, box, inv_box, rc2, want_obs, stream);
}

int ljmd_pair_sweep_rect_replicas_f64(const double* pos_i, const double* pos_j, double* out,
                                      int n_i, int ni_pad, int n_j, int nj_pad, int replicas,
                                      int gi0, int gj0, double box, double inv_box, double rc2,
                                      int want_obs, void* stream) {
  return ljmd::launch_rect_replicas<double>(pos_i, pos_j, out, n_i, ni_pad, n_j, nj_pad,
                                            replicas, gi0, gj0, box, inv_box, rc2, want_obs,
                                            stream);
}

int ljmd_pair_sweep_rect_newton_replicas_f32(const float* pos_i, const float* pos_j,
                                             float* out_i, float* out_j, int n_i, int ni_pad,
                                             int n_j, int nj_pad, int replicas, int gi0, int gj0,
                                             int i_lo, int j_hi, float box, float inv_box,
                                             float rc2, int want_obs, void* stream) {
  if (replicas < 1) return static_cast<int>(cudaErrorInvalidValue);
  return ljmd::launch_rect_newton<float>(pos_i, pos_j, out_i, out_j, n_i, ni_pad, n_j, nj_pad,
                                         gi0, gj0, i_lo, j_hi, box, inv_box, rc2, want_obs,
                                         stream, replicas);
}

int ljmd_pair_sweep_rect_newton_replicas_f64(const double* pos_i, const double* pos_j,
                                             double* out_i, double* out_j, int n_i, int ni_pad,
                                             int n_j, int nj_pad, int replicas, int gi0, int gj0,
                                             int i_lo, int j_hi, double box, double inv_box,
                                             double rc2, int want_obs, void* stream) {
  if (replicas < 1) return static_cast<int>(cudaErrorInvalidValue);
  return ljmd::launch_rect_newton<double>(pos_i, pos_j, out_i, out_j, n_i, ni_pad, n_j, nj_pad,
                                          gi0, gj0, i_lo, j_hi, box, inv_box, rc2, want_obs,
                                          stream, replicas);
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

// Kernels 2 and 6's launch shape (ljmd::rows_plan): the tri sweep (upper)
// over rows [0, n_i) of an (8, ld_i) matrix, or the rect sweep of those rows
// against n_j partners; out[0..7] as ljmd_rect_newton_plan's.
int ljmd_rows_sweep_plan(int dtype_bytes, int want_obs, int upper, int n_i, int ld_i, int n_j,
                         int* out) {
  if (upper) return ljmd::tri_rows_plan(dtype_bytes, want_obs, n_i, ld_i, out);
  return dtype_bytes == 4 ? ljmd::rows_plan_any<float, false>(want_obs, n_i, ld_i, n_j, out)
                          : ljmd::rows_plan_any<double, false>(want_obs, n_i, ld_i, n_j, out);
}

}  // extern "C"
