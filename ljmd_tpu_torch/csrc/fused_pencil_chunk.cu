// Kernel 15: n_steps of velocity Verlet over the half-shell pencil pairs in
// ONE launch, every pencil at full capacity (from the tables), in its plain
// and its extended (two-float r / r_lo, Neumaier v / vc) mode. Kernel 16,
// the width-listed chunk, is fused_pencil_width_chunk.cu.
//
// Replaces: ljmd_tpu/ops/pallas_pencil_fused.py:277 `fused_pencil_chunk` (its
// Pallas body `_pencil_fused_kernel`, :85). Contract: r, v, a (and r_lo, vc)
// are (8, ns) slot matrices, row 3 of r the validity, row 4 the ids, v = a =
// 0 (and r_lo = vc = 0) on the sentinel slots, `a` 24-prefactored and
// consistent with r; no wrap inside the chunk. Each step: drift and first
// half-kick (r + v dt + a dt^2/2 in the TPU kernel's order; extended: the
// two-float position update with (v + vc) dt), the half-shell forces at the
// new positions, a = (24 f) * validity (so sentinels never move), second
// half-kick. Extended pairs are corrected by lo_i - lo_j, the image shift
// applied to the hi part only.
//
// What bounds it on the H100: the candidate arithmetic. Pair-twice, a slot
// meets 9 x capacity candidates a step (its pencil, 4 forward and 4 backward
// neighbours), of which ~1.6% lie inside the cutoff at config 5; the bound
// counts 13 operations a candidate and 17 more a pair inside. The earlier
// port paid the LJ algebra (an IEEE divide, the r^-6 products, three
// accumulates) on every candidate, swept stages that hold no valid slot,
// staged each 128-partner stage for 32 slots only (32-slot work items
// against a 128-slot granule) with two barriers and no copy in flight, and
// rescanned the table for its backward pencils in every work item.
//
// What the design does about that:
// - A work item is one 128-slot block of a pencil, 128 x 8 threads (8
//   threads a slot: one 1024-thread block an SM, which spreads the items
//   most evenly over the SMs; 4 a slot ran slower on the H100, PERF.md),
//   thread (slot, slice) taking partners slice, slice + 8, ... of each
//   staged stage, so each stage serves 128 slots. The wrapper reads the
//   blocks an SM from the occupancy API.
// - Its partner stream follows from the half-shell tables alone: the
//   stages of its own pencil, of its 4 upper neighbours (partners shifted)
//   and of the 4 pencils whose upper neighbour it is (its slots shifted;
//   `lower`, the inverse table, built once per grid by the wrapper). Slots
//   are packed rank-first and validity does not change inside a chunk, so a
//   stage whose first slot is invalid holds no partner and is skipped, and
//   an item whose first slot is invalid has nothing to compute. No index is
//   built per rebin.
// - Stages are copied with cp.async into a ring of three buffers, stage
//   c + 1 in flight while stage c is computed, one __syncthreads() a stage.
// - The culled loop (pencil_cull.cuh): displacement, z round and r^2 for
//   every candidate, the LJ algebra only for pairs inside the cutoff.
// - A cooperative launch of a PERSISTENT grid (as many blocks as the card
//   keeps resident), block b taking the items at positions b, b + G, ... of
//   a block-major order (the first 128-slot block of every pencil, then the
//   second, ...: the live items, at the front, spread evenly over the
//   blocks), the same in both phases of a step, so a slot's v, a and vc are
//   written (phase 2) and read (phase 1 of the next step) by its one owner
//   thread (slice 0), and one grid barrier
//   per step suffices: positions are double-buffered, step s reading plane
//   s & 1 and writing the other (rows 3..7 sit in both). The 8 partial sums
//   of a slot are added in shared memory in a fixed order; pair-twice with
//   no atomics, so the chunk is deterministic and a capped grid gives the
//   same bits.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "pencil_cull.cuh"
#include "pencil_pairs.cuh"

namespace cg = cooperative_groups;

namespace ljmd {

constexpr int kHsRing = 3;          // staging buffers
constexpr int kHsSegs = 9;          // own pencil, 4 forward, 4 backward
constexpr int kHsMaxSub = 16;       // 128-slot stages a pencil (capacity <= 2048)
constexpr int kHsSlices = 8;        // threads a slot

template <typename T>
struct HsChunkArgs {
  T* rbuf;   // (2, 8, ns): position planes
  T* lobuf;  // (2, 8, ns): remainder planes (extended)
  T* v;
  T* vc;
  T* a;
  const int* tbl;    // (n_pencils * 4,) upper neighbours
  const int* shf;    // (n_pencils * 4 * 2,) their image shifts
  const int* lower;  // (n_pencils * 4,) the pencil whose k-th upper neighbour this is
  int n_pencils;
  int cap;
  T box;
  T inv_box;
  T rc2;
  T dt;
  T half_dt;
  T half_dt_sq;
  int n_steps;
};

// The stages of one work item (pencil q): segment s's partner pencil, its
// live stages (leading stages whose first slot is valid) and image shift;
// then the flat stream, stage by stage.
struct HsPlan {
  int pencil[kHsSegs];
  int live[kHsSegs];
  int shx[kHsSegs];
  int shy[kHsSegs];
  int q0[kHsSegs * kHsMaxSub];
  unsigned char seg[kHsSegs * kHsMaxSub];
  int n;
};

template <typename T>
__device__ void hs_plan(const HsChunkArgs<T>& p, const T* valid, int q, int tid, HsPlan& pl) {
  const int n_sub = p.cap / kPenGran;
  if (tid < kHsSegs) {
    int j = q, sx = 0, sy = 0;
    if (tid >= 1 && tid <= 4) {
      const int e = q * 4 + tid - 1;
      j = p.tbl[e];
      sx = p.shf[2 * e];
      sy = p.shf[2 * e + 1];
    } else if (tid >= 5) {
      const int k = tid - 5;
      j = p.lower[q * 4 + k];
      if (j >= 0) {
        sx = p.shf[2 * (j * 4 + k)];
        sy = p.shf[2 * (j * 4 + k) + 1];
      }
    }
    int live = 0;
    if (j >= 0) {
      while (live < n_sub && valid[static_cast<size_t>(j) * p.cap + live * kPenGran] != T(0)) {
        ++live;
      }
    }
    pl.pencil[tid] = j;
    pl.live[tid] = live;
    pl.shx[tid] = sx;
    pl.shy[tid] = sy;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int s = 0; s < kHsSegs; ++s) {
      for (int b = 0; b < pl.live[s]; ++b) {
        pl.q0[n] = pl.pencil[s] * p.cap + b * kPenGran;
        pl.seg[n] = static_cast<unsigned char>(s);
        ++n;
      }
    }
    pl.n = n;
  }
  __syncthreads();
}

// The work item at position i of the block-major order.
__device__ __forceinline__ int hs_item(int i, int n_pencils, int n_sub) {
  return (i % n_pencils) * n_sub + i / n_pencils;
}

template <typename T, bool EXT>
__global__ void __launch_bounds__(kPenGran * kHsSlices) fused_pencil_kernel(HsChunkArgs<T> p) {
  constexpr int S = kHsSlices;
  constexpr int kRows = EXT ? 6 : 3;
  constexpr int kThreads = kPenGran * S;
  __shared__ __align__(16) T stage[kHsRing][kRows][kPenGran];
  __shared__ T red[S][3][kPenGran];
  __shared__ HsPlan plan;
  cg::grid_group grid = cg::this_grid();
  const size_t ns = static_cast<size_t>(p.n_pencils) * p.cap;
  const size_t plane = 8 * ns;
  const int n_items = static_cast<int>(ns / kPenGran);
  const int n_sub = p.cap / kPenGran;
  const int tx = threadIdx.x;
  const int tid = threadIdx.y * kPenGran + tx;
  const bool owner = threadIdx.y == 0;

  for (int s = 0; s < p.n_steps; ++s) {
    const T* r_cur = p.rbuf + (s & 1) * plane;
    T* r_new = p.rbuf + ((s + 1) & 1) * plane;
    const T* lo_cur = EXT ? p.lobuf + (s & 1) * plane : nullptr;
    T* lo_new = EXT ? p.lobuf + ((s + 1) & 1) * plane : nullptr;

    // Phase 1: drift + first half-kick of every slot of the block's items.
    if (owner) {
      for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
        const size_t g = static_cast<size_t>(hs_item(i, p.n_pencils, n_sub)) * kPenGran + tx;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          pen_drift<T, EXT>(c * ns + g, r_cur, r_new, lo_cur, lo_new, p.v, p.vc, p.a, p.dt,
                            p.half_dt, p.half_dt_sq);
        }
      }
    }
    grid.sync();

    // Phase 2: forces at the new positions, a = 24 f * valid, second kick.
    const T* valid = r_new + 3 * ns;
    for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
      const int w = hs_item(i, p.n_pencils, n_sub);
      const size_t s0 = static_cast<size_t>(w) * kPenGran;
      if (valid[s0] == T(0)) continue;  // the whole item is empty (block-uniform)
      hs_plan(p, valid, w / n_sub, tid, plan);
      const size_t g = s0 + tx;
      PenSlot<T> me{static_cast<int>(g), r_new[g], r_new[ns + g], r_new[2 * ns + g],
                    T(0), T(0), T(0)};
      if (EXT) {
        me.lx = lo_new[g];
        me.ly = lo_new[ns + g];
        me.lz = lo_new[2 * ns + g];
      }
      PenAcc<T> acc = {T(0), T(0), T(0), T(0), T(0), T(0)};
      const int n_st = plan.n;  // >= 1: the item's own stage is live
      stage_rows(&stage[0][0][0], kPenGran, r_new, lo_new, ns, kRows,
                 static_cast<size_t>(plan.q0[0]), kPenGran, tid, kThreads);
      cp_async_commit();
      for (int c = 0; c < n_st; ++c) {
        if (c + 1 < n_st) {
          stage_rows(&stage[(c + 1) % kHsRing][0][0], kPenGran, r_new, lo_new, ns, kRows,
                     static_cast<size_t>(plan.q0[c + 1]), kPenGran, tid, kThreads);
          cp_async_commit();
          cp_async_wait(1);
        } else {
          cp_async_wait(0);
        }
        // Stage c has landed for every thread; the buffer stage c + 1 is
        // copied into was last read at stage c - 2, before the previous
        // barrier.
        __syncthreads();
        const T(*sb)[kPenGran] = stage[c % kHsRing];
        const int sg = plan.seg[c];
        const int q0 = plan.q0[c];
        const T offx = mul_rn(static_cast<T>(plan.shx[sg]), p.box);
        const T offy = mul_rn(static_cast<T>(plan.shy[sg]), p.box);
        const T* lx = EXT ? sb[3] : nullptr;
        const T* ly = EXT ? sb[4] : nullptr;
        const T* lz = EXT ? sb[5] : nullptr;
        if (sg == 0) {
          cull_stage_hs<T, EXT, false, kHsSelf, S>(sb[0], sb[1], sb[2], lx, ly, lz, me, q0,
                                                   offx, offy, p.box, p.inv_box, p.rc2, acc);
        } else if (sg <= 4) {
          cull_stage_hs<T, EXT, false, kHsForward, S>(sb[0], sb[1], sb[2], lx, ly, lz, me, q0,
                                                      offx, offy, p.box, p.inv_box, p.rc2, acc);
        } else {
          cull_stage_hs<T, EXT, false, kHsBackward, S>(sb[0], sb[1], sb[2], lx, ly, lz, me, q0,
                                                       offx, offy, p.box, p.inv_box, p.rc2,
                                                       acc);
        }
      }

      red[threadIdx.y][0][tx] = acc.fx;
      red[threadIdx.y][1][tx] = acc.fy;
      red[threadIdx.y][2][tx] = acc.fz;
      __syncthreads();
      if (owner) {
        const T vld = valid[g];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          T f = red[0][c][tx];
#pragma unroll
          for (int q = 1; q < S; ++q) f = add_rn(f, red[q][c][tx]);
          pen_kick<T, EXT>(c * ns + g, mul_rn(mul_rn(T(24), f), vld), p.v, p.vc, p.a,
                           p.half_dt);
        }
      }
      __syncthreads();  // `red`, the plan and the ring are reused by the next item
    }
  }
}

template <typename T, bool EXT>
int hs_occupancy(int* out) {
  const void* fn = reinterpret_cast<const void*>(fused_pencil_kernel<T, EXT>);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kPenGran * kHsSlices, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = per_sm;
  out[1] = sms;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

template <typename T, bool EXT>
int hs_launch(HsChunkArgs<T> p, int grid_blocks, void* stream) {
  void* kargs[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fused_pencil_kernel<T, EXT>), dim3(grid_blocks),
      dim3(kPenGran, kHsSlices), kargs, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the launch error
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int hs_chunk_any(T* rbuf, T* lobuf, T* v, T* vc, T* a, const int* tbl, const int* shf,
                 const int* lower, int n_pencils, int cap, T box, T inv_box, T rc2, T dt,
                 T half_dt, T half_dt_sq, int n_steps, int extended, int grid_blocks,
                 void* stream) {
  if (cap % kPenGran != 0 || cap / kPenGran > kHsMaxSub) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const HsChunkArgs<T> p{rbuf, lobuf, v,  vc,      a,          tbl,    shf, lower, n_pencils,
                         cap,  box,   inv_box, rc2, dt, half_dt, half_dt_sq, n_steps};
  return extended ? hs_launch<T, true>(p, grid_blocks, stream)
                  : hs_launch<T, false>(p, grid_blocks, stream);
}

}  // namespace ljmd

extern "C" {

// Launch shape of kernel 15: out[0..3] = resident blocks an SM, SMs,
// registers a thread, local (spill) bytes a thread.
int ljmd_pencil_chunk_occupancy(int dtype_bytes, int extended, int* out) {
  if (dtype_bytes == 4) {
    return extended ? ljmd::hs_occupancy<float, true>(out) : ljmd::hs_occupancy<float, false>(out);
  }
  return extended ? ljmd::hs_occupancy<double, true>(out) : ljmd::hs_occupancy<double, false>(out);
}

// Threads a slot.
int ljmd_pencil_chunk_slices() { return ljmd::kHsSlices; }

// The largest capacity / 128 the kernel takes.
int ljmd_pencil_chunk_max_sub() { return ljmd::kHsMaxSub; }

// `lower`: ops/fused_pencil.py half_shell_lower of `tbl`; `grid_blocks` at
// most the resident blocks of ljmd_pencil_chunk_occupancy.
int ljmd_fused_pencil_chunk_f32(float* rbuf, float* lobuf, float* v, float* vc, float* a,
                                const int* tbl, const int* shf, const int* lower, int n_pencils,
                                int cap, float box, float inv_box, float rc2, float dt,
                                float half_dt, float half_dt_sq, int n_steps, int extended,
                                int grid_blocks, void* stream) {
  return ljmd::hs_chunk_any<float>(rbuf, lobuf, v, vc, a, tbl, shf, lower, n_pencils, cap, box,
                                   inv_box, rc2, dt, half_dt, half_dt_sq, n_steps, extended,
                                   grid_blocks, stream);
}

int ljmd_fused_pencil_chunk_f64(double* rbuf, double* lobuf, double* v, double* vc, double* a,
                                const int* tbl, const int* shf, const int* lower, int n_pencils,
                                int cap, double box, double inv_box, double rc2, double dt,
                                double half_dt, double half_dt_sq, int n_steps, int extended,
                                int grid_blocks, void* stream) {
  return ljmd::hs_chunk_any<double>(rbuf, lobuf, v, vc, a, tbl, shf, lower, n_pencils, cap,
                                    box, inv_box, rc2, dt, half_dt, half_dt_sq, n_steps,
                                    extended, grid_blocks, stream);
}

}  // extern "C"
