// Kernel 16: n_steps of velocity Verlet over the half-shell pencil pairs in
// ONE launch, every visit at its pencils' active width (the width lists), in
// its plain and its extended (two-float r / r_lo, Neumaier v / vc) mode.
//
// Replaces: ljmd_tpu/ops/pallas_pencil_fused.py:609 `fused_pencil_width_chunk`
// (its Pallas body `_pencil_width_kernel`, :451). Contract: r, v, a (and
// r_lo, vc) are (8, ns) slot matrices, row 3 of r the validity, row 4 the
// ids, v = a = 0 (and r_lo = vc = 0) on the sentinel slots, `a`
// 24-prefactored and consistent with r; no wrap inside the chunk. Each step:
// drift and first half-kick (r + v dt + a dt^2/2 in the TPU kernel's order;
// extended: the two-float position update with (v + vc) dt), the half-shell
// forces at the new positions over the visits of the lists, a = (24 f) *
// validity (so sentinels never move), second half-kick. Extended pairs are
// corrected by lo_i - lo_j, the image shift applied to the hi part only.
//
// What bounds it on the H100: the pair arithmetic (pencil_pairs.cuh: every
// pair evaluated from both sides, each visit at its pencils' active widths),
// plus one grid barrier per step. The earlier port of this kernel lost 3.3x
// against the static chunk on three things: every 32-slot work item walked
// every visit list every step (up to n_sub * P self and P * n_sub * 4
// neighbour entries, to keep the few dozen that touch its block), each
// staged partner segment served 32 slots while the visit granule is 128, and
// staging was synchronous (two __syncthreads() per 128 partners, no copy in
// flight during the arithmetic).
//
// What the design does about that:
// - A per-block visit index (ops/fused_pencil.py `width_index`, built on the
//   device from the lists once per list build): a CSR offset array over the
//   128-slot blocks and packed entries, so a work item reads only the visits
//   of its own block. Entry word: (start << 12) | (blocks << 6) | (role << 4)
//   | (shx + 1) << 2 | (shy + 1): the partner blocks [start, start + blocks)
//   and the role: self-below (the block `start` of a self visit below this
//   one: every partner counts), self-diagonal (this block and the blocks
//   above it in the visit: every partner but the slot itself), forward (a
//   neighbour visit from this block: partners shifted by the image shift)
//   or backward (a neighbour visit whose j range holds this block: this
//   block's slots shifted instead). A third array orders the blocks by their
//   partner count, longest first.
// - A work item is one 128-slot block, 128 x 4 threads (one block an SM at
//   ~100 registers; 8 threads a slot, at 64 registers and 1024 threads,
//   spilled and ran slower on the H100), thread (slot, slice) taking
//   partners slice, slice + 4, ... of each staged 128-slot chunk, so each
//   staged chunk serves 128 slots.
// - Partner chunks are staged with cp.async into a ring of three buffers,
//   chunk c + 1 copied while chunk c is computed, one __syncthreads() a
//   chunk; the chunks of all the block's entries form one stream.
// - A cooperative launch of a PERSISTENT grid (as many blocks as the card
//   keeps resident), block b taking the ordered work items b, 2G - 1 - b,
//   2G + b, ... (G blocks; a snake over the longest-first order), the same
//   in both phases, so a slot's v, a and vc are written (phase 2) and read
//   (phase 1 of the next step) by its one owner thread (slice 0), and one
//   grid barrier per step suffices: positions are double-buffered, step s
//   reading plane s & 1 and writing the other (rows 3..7 sit in both).
//   Blocks whose first slot is empty (slots are packed rank-first) skip the
//   force phase. The 4 partial sums of a slot are added in shared memory in
//   a fixed order; pair-twice with no atomics, so the chunk is deterministic
//   and a capped grid gives the same bits. Static shared memory (below 48
//   KB), which the occupancy query counts.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "pencil_pairs.cuh"

namespace cg = cooperative_groups;

namespace ljmd {

constexpr int kWidthRing = 3;  // staging buffers
enum WidthRole { kSelfBelow = 0, kSelfDiag = 1, kForward = 2, kBackward = 3 };

constexpr int kWidthSlices = 4;  // threads a slot

template <typename T>
struct WidthArgs {
  T* rbuf;   // (2, 8, ns): position planes
  T* lobuf;  // (2, 8, ns): remainder planes (extended)
  T* v;
  T* vc;
  T* a;
  const int* off;    // (n_blocks + 1,) CSR offsets of the entries
  const int* ent;    // packed entries, block by block
  const int* order;  // (n_blocks,) the blocks, most partners first
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

// A position in the chunk stream of a block: entry e (word w) and block b of
// its partner range.
struct WidthCursor {
  int e;
  int b;
  int w;
  __device__ __forceinline__ void advance(const int* ent, int e_end) {
    if (++b >= ((w >> 6) & 63)) {
      ++e;
      b = 0;
      w = e < e_end ? ent[e] : 0;
    }
  }
};

// Pairs of the thread's slot with one staged chunk of 128 partner slots
// starting at slot q0 (MODE: the role's mask and shift).
template <typename T, bool EXT, int MODE>
__device__ __forceinline__ void width_chunk(const T* sx, const T* sy, const T* sz, const T* slx,
                                            const T* sly, const T* slz, const PenSlot<T>& me,
                                            int q0, T offx, T offy, T box, T inv_box, T rc2,
                                            PenAcc<T>& acc) {
  T mx = me.x, my = me.y;
  if (MODE == kBackward) {
    mx = add_rn(me.x, offx);
    my = add_rn(me.y, offy);
  }
#pragma unroll 4
  for (int jj = threadIdx.y; jj < kPenGran; jj += kWidthSlices) {
    T px = sx[jj], py = sy[jj];
    if (MODE == kForward) {
      px = add_rn(px, offx);
      py = add_rn(py, offy);
    }
    T dx = sub_rn(mx, px);
    T dy = sub_rn(my, py);
    T dz = sub_rn(me.z, sz[jj]);
    if (EXT) {
      dx = add_rn(dx, sub_rn(me.lx, slx[jj]));
      dy = add_rn(dy, sub_rn(me.ly, sly[jj]));
      dz = add_rn(dz, sub_rn(me.lz, slz[jj]));
    }
    dz = min_image(dz, box, inv_box);
    const T r2 = add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz));
    bool m = r2 < rc2;
    if (MODE == kSelfDiag) m = m && (q0 + jj != me.g);
    const PairTerms<T> pt = lj_pair_terms<T, false>(r2, m);
    acc.fx = add_rn(acc.fx, mul_rn(pt.coef, dx));
    acc.fy = add_rn(acc.fy, mul_rn(pt.coef, dy));
    acc.fz = add_rn(acc.fz, mul_rn(pt.coef, dz));
  }
}

template <typename T, bool EXT>
__global__ void __launch_bounds__(kPenGran * kWidthSlices)
fused_pencil_width_kernel(WidthArgs<T> p) {
  constexpr int kRows = EXT ? 6 : 3;
  constexpr int kThreads = kPenGran * kWidthSlices;
  __shared__ __align__(16) T stage[kWidthRing][kRows][kPenGran];
  __shared__ T red[kWidthSlices][3][kPenGran];
  cg::grid_group grid = cg::this_grid();
  const size_t ns = static_cast<size_t>(p.n_pencils) * p.cap;
  const size_t plane = 8 * ns;
  const int n_items = static_cast<int>(ns / kPenGran);
  const int tx = threadIdx.x;
  const int tid = threadIdx.y * kPenGran + tx;
  const bool owner = threadIdx.y == 0;
  const int G = gridDim.x;

  for (int s = 0; s < p.n_steps; ++s) {
    const T* r_cur = p.rbuf + (s & 1) * plane;
    T* r_new = p.rbuf + ((s + 1) & 1) * plane;
    const T* lo_cur = EXT ? p.lobuf + (s & 1) * plane : nullptr;
    T* lo_new = EXT ? p.lobuf + ((s + 1) & 1) * plane : nullptr;

    // Phase 1: drift + first half-kick of every slot of the block's items.
    if (owner) {
      for (int base = 0, k = 0; base < n_items; base += G, ++k) {
        const int pos = base + ((k & 1) ? G - 1 - blockIdx.x : blockIdx.x);
        if (pos >= n_items) continue;
        const size_t g = static_cast<size_t>(p.order[pos]) * kPenGran + tx;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          pen_drift<T, EXT>(c * ns + g, r_cur, r_new, lo_cur, lo_new, p.v, p.vc, p.a, p.dt,
                            p.half_dt, p.half_dt_sq);
        }
      }
    }
    grid.sync();

    // Phase 2: forces at the new positions, a = 24 f * valid, second kick.
    for (int base = 0, k = 0; base < n_items; base += G, ++k) {
      const int pos = base + ((k & 1) ? G - 1 - blockIdx.x : blockIdx.x);
      if (pos >= n_items) continue;
      const int w = p.order[pos];
      const size_t s0 = static_cast<size_t>(w) * kPenGran;
      if (r_new[3 * ns + s0] == T(0)) continue;  // the whole block is empty
      const size_t g = s0 + tx;
      PenSlot<T> me{static_cast<int>(g), r_new[g], r_new[ns + g], r_new[2 * ns + g],
                    T(0), T(0), T(0)};
      if (EXT) {
        me.lx = lo_new[g];
        me.ly = lo_new[ns + g];
        me.lz = lo_new[2 * ns + g];
      }
      PenAcc<T> acc = {T(0), T(0), T(0), T(0), T(0), T(0)};
      const int e0 = p.off[w];
      const int e1 = p.off[w + 1];
      WidthCursor pre{e0, 0, e0 < e1 ? p.ent[e0] : 0};
      WidthCursor cur = pre;
      if (pre.e < e1) {
        stage_rows(&stage[0][0][0], kPenGran, r_new, lo_new, ns, kRows,
                   static_cast<size_t>((pre.w >> 12) + pre.b) * kPenGran, kPenGran, tid,
                   kThreads);
        cp_async_commit();
        pre.advance(p.ent, e1);
      }
      for (int c = 0; cur.e < e1; ++c) {
        if (pre.e < e1) {
          stage_rows(&stage[(c + 1) % kWidthRing][0][0], kPenGran, r_new, lo_new, ns, kRows,
                     static_cast<size_t>((pre.w >> 12) + pre.b) * kPenGran, kPenGran, tid,
                     kThreads);
          cp_async_commit();
          pre.advance(p.ent, e1);
          cp_async_wait(1);
        } else {
          cp_async_wait(0);
        }
        // Chunk c has landed for every thread; the buffer chunk c + 2 will
        // use was last read two chunks ago, before this barrier's previous
        // pass.
        __syncthreads();
        const T(*sb)[kPenGran] = stage[c % kWidthRing];
        const int role = (cur.w >> 4) & 3;
        const int q0 = ((cur.w >> 12) + cur.b) * kPenGran;
        const T offx = mul_rn(static_cast<T>(((cur.w >> 2) & 3) - 1), p.box);
        const T offy = mul_rn(static_cast<T>((cur.w & 3) - 1), p.box);
        const T* lx = EXT ? sb[3] : nullptr;
        const T* ly = EXT ? sb[4] : nullptr;
        const T* lz = EXT ? sb[5] : nullptr;
        if (role == kForward) {
          width_chunk<T, EXT, kForward>(sb[0], sb[1], sb[2], lx, ly, lz, me, q0, offx, offy,
                                            p.box, p.inv_box, p.rc2, acc);
        } else if (role == kBackward) {
          width_chunk<T, EXT, kBackward>(sb[0], sb[1], sb[2], lx, ly, lz, me, q0, offx,
                                             offy, p.box, p.inv_box, p.rc2, acc);
        } else if (role == kSelfDiag) {
          width_chunk<T, EXT, kSelfDiag>(sb[0], sb[1], sb[2], lx, ly, lz, me, q0, offx,
                                             offy, p.box, p.inv_box, p.rc2, acc);
        } else {
          width_chunk<T, EXT, kSelfBelow>(sb[0], sb[1], sb[2], lx, ly, lz, me, q0, offx,
                                              offy, p.box, p.inv_box, p.rc2, acc);
        }
        cur.advance(p.ent, e1);
      }

      red[threadIdx.y][0][tx] = acc.fx;
      red[threadIdx.y][1][tx] = acc.fy;
      red[threadIdx.y][2][tx] = acc.fz;
      __syncthreads();
      if (owner) {
        const T valid = r_new[3 * ns + g];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          T f = red[0][c][tx];
#pragma unroll
          for (int q = 1; q < kWidthSlices; ++q) f = add_rn(f, red[q][c][tx]);
          pen_kick<T, EXT>(c * ns + g, mul_rn(mul_rn(T(24), f), valid), p.v, p.vc, p.a,
                           p.half_dt);
        }
      }
      __syncthreads();  // `red` and the staging ring are reused by the next item
    }
  }
}

template <typename T, bool EXT>
int width_max_blocks(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_pencil_width_kernel<T, EXT>, kPenGran * kWidthSlices, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *out = per_sm * sms;
  return 0;
}

template <typename T, bool EXT>
int launch_width(WidthArgs<T> p, int grid_blocks, void* stream) {
  void* kargs[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fused_pencil_width_kernel<T, EXT>), dim3(grid_blocks),
      dim3(kPenGran, kWidthSlices), kargs, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the launch error
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_width_any(T* rbuf, T* lobuf, T* v, T* vc, T* a, const int* off, const int* ent,
                     const int* order, int n_pencils, int cap, T box, T inv_box, T rc2, T dt,
                     T half_dt, T half_dt_sq, int n_steps, int extended, int grid_blocks,
                     void* stream) {
  const WidthArgs<T> p{rbuf,      lobuf, v,       vc,      a,   off,     ent,
                       order,     n_pencils, cap, box,     inv_box, rc2, dt,
                       half_dt,   half_dt_sq, n_steps};
  return extended ? launch_width<T, true>(p, grid_blocks, stream)
                  : launch_width<T, false>(p, grid_blocks, stream);
}

}  // namespace ljmd

extern "C" {

// Threads of a block (128 slots x kWidthSlices).
int ljmd_width_block_threads() { return ljmd::kPenGran * ljmd::kWidthSlices; }

int ljmd_width_max_blocks(int dtype_bytes, int extended, int* out) {
  using ljmd::width_max_blocks;
  if (dtype_bytes == 4) {
    return extended ? width_max_blocks<float, true>(out) : width_max_blocks<float, false>(out);
  }
  return extended ? width_max_blocks<double, true>(out) : width_max_blocks<double, false>(out);
}

// `off`, `ent`, `order`: the width index (ops/fused_pencil.py width_index);
// `grid_blocks` at most ljmd_width_max_blocks.
int ljmd_fused_pencil_width_chunk_f32(float* rbuf, float* lobuf, float* v, float* vc, float* a,
                                      const int* off, const int* ent, const int* order,
                                      int n_pencils, int cap, float box, float inv_box,
                                      float rc2, float dt, float half_dt, float half_dt_sq,
                                      int n_steps, int extended, int grid_blocks, void* stream) {
  return ljmd::launch_width_any<float>(rbuf, lobuf, v, vc, a, off, ent, order, n_pencils, cap,
                                       box, inv_box, rc2, dt, half_dt, half_dt_sq, n_steps,
                                       extended, grid_blocks, stream);
}

int ljmd_fused_pencil_width_chunk_f64(double* rbuf, double* lobuf, double* v, double* vc,
                                      double* a, const int* off, const int* ent,
                                      const int* order, int n_pencils, int cap, double box,
                                      double inv_box, double rc2, double dt, double half_dt,
                                      double half_dt_sq, int n_steps, int extended,
                                      int grid_blocks, void* stream) {
  return ljmd::launch_width_any<double>(rbuf, lobuf, v, vc, a, off, ent, order, n_pencils, cap,
                                        box, inv_box, rc2, dt, half_dt, half_dt_sq, n_steps,
                                        extended, grid_blocks, stream);
}

}  // extern "C"
