// The cell-pair engine's rebin: a key pass and a gather, two launches.
//
// Replaces: ljmd_tpu/ops/cell_list.py:356 `rebin_gather` (:307
// `rebin_gather_parts`) with the engine's wrap, gathers and sentinels around
// it (ljmd_tpu/models/engine.py:1253 `_permute_rebin`, :1410-1415). JAX has no
// Pallas kernel for it: XLA fuses the jnp chain into a few fusions. In eager
// PyTorch the same chain is ~95 device operations, each its own host launch,
// and the host's ~3 ms of launches a rebin paced the card (PERF.md §5).
//
// What bounds it on the H100: bytes. A rebin reads the key rows of every
// slot and each particle's rows once, and writes every slot of the new carry
// (8 rows of r and of each carried field): ~15 MB at config 5 (75,264 slots,
// r / ru / v / a, the drift check on), ~4.5 us at 3.35 TB/s.
//
// What the design does about that: a stable counting sort in two launches,
// no library sort and no host read.
// - Key pass (a block per 512-slot tile of each replica): wraps rows 0..2
//   into [0, L) as ops/geometry.py wrap_positions does, keys each valid
//   slot by its pencil (ops/cell_list.py _pencil_ids; -1 if invalid), counts
//   the tile's keys in a histogram row of its own (in shared memory, written
//   out whole, up to 12,288 pencils; past that by atomics in the global row,
//   which the block zeroes first: any grid size, no limit), and,
//   with `check`, folds the drift check of the `always` trigger (minimum
//   image xy drift against r_ref, times validity, against the threshold;
//   NaN-propagating as torch.max) into a flag a tile and, with a running
//   max to update, the tile's largest squared drift.
// - Gather (a block per (pencil, replica)): an exclusive scan of its pencil's
//   tile counts gives each tile's first rank; each warp then takes a tile
//   holding the pencil's particles and scans its keys 128 a step (an int4 a
//   lane, four ballots), ranks in old slot order, so the order is the stable
//   sort's. It stops once the tile's count is found. A particle of rank j <
//   cap lands in slot pencil * cap + j with its rows (r: the wrapped
//   coordinates, validity 1, id; the others: rows 0..2), rows past them zero;
//   the empty slots get the sentinel x = SENT_BASE (1 + pencil) + rank,
//   rounded once from double, and zeros. It writes the count (capped) and
//   raises the replica's overflow flag when the count passes capacity, and
//   block (0, q) raises it for the drift flags and writes the replica's
//   running max of the squared drift (torch.maximum of the old one and
//   torch.max of the drifts: NaN where either is).
// Every operation is IEEE-rounded as its torch counterpart (the _rn
// intrinsics: no contraction, no fast math), so the outputs are the torch
// chain's bits (tests/test_torch_cuda.py).
#include <cuda_runtime.h>

#include "lj_pair_terms.cuh"

namespace ljmd {

constexpr int kRebinThreads = 256;
constexpr int kRebinWarps = kRebinThreads / 32;
constexpr int kRebinMaxOthers = 5;
// The key pass keeps its histogram in shared memory up to 48 KB of ints (a
// block's default); larger grids count in the global row.
constexpr int kRebinSharedPencils = 12 * 1024;

template <typename T>
struct RebinArgs {
  const T* r;    // (8, NS): rows 0..2 positions (unwrapped with `wrap`), 3 validity, 4 ids
  const T* ref;  // (8, NS) positions of the last rebin (`check`), else null
  const T* in[kRebinMaxOthers];
  T* r_out;
  T* out[kRebinMaxOthers];
  const unsigned char* ovf_in;  // (R,) bool
  unsigned char* ovf_out;
  int* keys;    // (NS,) pencil of each slot, -1 where invalid
  int* hist;    // (R, n_tiles, n_pencils)
  int* flags;   // (R, n_tiles): bit 0 drift past the threshold, bit 1 NaN drift
  T* tile_max;  // (R, n_tiles) largest squared drift of a tile (`check` with dmax_in)
  const T* dmax_in;  // (R,) running max of the squared drift, or null
  T* dmax_out;
  int* counts;  // (R * n_pencils,)
  long long NS;  // R * ns
  int ns, n_pencils, m_xy, cap, tile, n_tiles, n_others, wrap, check;
  int hist_shared;  // n_pencils <= kRebinSharedPencils
  T box, inv_box, inv_w, thresh;
  double sent_base;
};

__device__ __forceinline__ float quiet_nan(float) { return __int_as_float(0x7fc00000); }
__device__ __forceinline__ double quiet_nan(double) {
  return __longlong_as_double(0x7ff8000000000000LL);
}
__device__ __forceinline__ float floor_(float x) { return floorf(x); }
__device__ __forceinline__ double floor_(double x) { return floor(x); }

// ops/geometry.py wrap_positions, operation for operation.
template <typename T>
__device__ __forceinline__ T wrap_coord(T x, T box, T inv_box) {
  T w = sub_rn(x, mul_rn(box, floor_(mul_rn(x, inv_box))));
  if (w >= box) w = sub_rn(w, box);
  if (w < T(0)) w = add_rn(w, box);
  return (w < T(0) || w >= box) ? T(0) : w;
}

template <typename T>
__device__ __forceinline__ T coord(const RebinArgs<T>& a, long long s) {
  return a.wrap ? wrap_coord(a.r[s], a.box, a.inv_box) : a.r[s];
}

// The block's largest `x` (every thread's, NaN-free), returned to every
// thread; `s` holds a warp's each.
template <typename T>
__device__ __forceinline__ T block_max(T x, T* s) {
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = x;
  __syncthreads();
  x = s[0];
  for (int w = 1; w < kRebinWarps; ++w) x = max(x, s[w]);
  __syncthreads();
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kRebinThreads) rebin_keys_kernel(RebinArgs<T> a) {
  extern __shared__ int s_hist[];
  __shared__ T s_max[kRebinWarps];
  const int t = blockIdx.x, q = blockIdx.y;
  int* h = a.hist + (static_cast<long long>(q) * a.n_tiles + t) * a.n_pencils;
  // Past the shared size the block counts in its own global row: zeroed
  // here, its atomics visible to the block after the barrier.
  int* hh = a.hist_shared ? s_hist : h;
  for (int i = threadIdx.x; i < a.n_pencils; i += blockDim.x) hh[i] = 0;
  __syncthreads();
  const long long base = static_cast<long long>(q) * a.ns;
  const int lo = t * a.tile, hi = min(lo + a.tile, a.ns);
  const long long NS = a.NS;
  int gt = 0, nan = 0;
  T mx = T(0);
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const long long s = base + i;
    const T valid = a.r[3 * NS + s];
    int key = -1;
    if (valid > T(0.5)) {
      // ops/cell_list.py _pencil_ids: truncation, then the clamp.
      const int ix = min(max(static_cast<int>(mul_rn(coord(a, s), a.inv_w)), 0), a.m_xy - 1);
      const int iy = min(max(static_cast<int>(mul_rn(coord(a, NS + s), a.inv_w)), 0), a.m_xy - 1);
      key = ix * a.m_xy + iy;
      atomicAdd(&hh[key], 1);
    }
    a.keys[s] = key;
    if (a.check) {
      const T dx = min_image(sub_rn(a.r[s], a.ref[s]), a.box, a.inv_box);
      const T dy = min_image(sub_rn(a.r[NS + s], a.ref[NS + s]), a.box, a.inv_box);
      const T m2 = mul_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), valid);
      gt |= m2 > a.thresh;
      nan |= m2 != m2;
      if (m2 > mx) mx = m2;
    }
  }
  gt = __syncthreads_or(gt);
  nan = __syncthreads_or(nan);
  if (a.check && a.dmax_in != nullptr) {
    mx = block_max(mx, s_max);
    if (threadIdx.x == 0) a.tile_max[q * a.n_tiles + t] = mx;
  }
  if (a.hist_shared) {
    for (int i = threadIdx.x; i < a.n_pencils; i += blockDim.x) h[i] = s_hist[i];
  }
  if (threadIdx.x == 0) {
    a.flags[q * a.n_tiles + t] = (gt ? 1 : 0) | (nan ? 2 : 0);
    // Stream order puts this before every write of the gather.
    if (t == 0) a.ovf_out[q] = a.ovf_in[q];
  }
}

// Old slot s to new slot d (rank < cap): r's wrapped coordinates, validity
// and id, the others' rows 0..2, zeros past them.
template <typename T>
__device__ __forceinline__ void put(const RebinArgs<T>& a, long long s, long long d) {
  const long long NS = a.NS;
  T* o = a.r_out;
  o[d] = coord(a, s);
  o[NS + d] = coord(a, NS + s);
  o[2 * NS + d] = coord(a, 2 * NS + s);
  o[3 * NS + d] = T(1);
  o[4 * NS + d] = a.r[4 * NS + s];
  for (int row = 5; row < 8; ++row) o[row * NS + d] = T(0);
  for (int k = 0; k < a.n_others; ++k) {
    const T* src = a.in[k];
    T* dst = a.out[k];
    for (int row = 0; row < 3; ++row) dst[row * NS + d] = src[row * NS + s];
    for (int row = 3; row < 8; ++row) dst[row * NS + d] = T(0);
  }
}

// Empty slot d (rank j of local pencil p): ops/pencil_sweep.py sentinel_fill.
template <typename T>
__device__ __forceinline__ void fill(const RebinArgs<T>& a, long long d, int p, int j) {
  const long long NS = a.NS;
  T* o = a.r_out;
  o[d] = static_cast<T>(__dadd_rn(__dmul_rn(a.sent_base, __dadd_rn(1.0, static_cast<double>(p))),
                                  static_cast<double>(j)));
  for (int row = 1; row < 8; ++row) o[row * NS + d] = T(0);
  for (int k = 0; k < a.n_others; ++k) {
    for (int row = 0; row < 8; ++row) a.out[k][row * NS + d] = T(0);
  }
}

// One warp: the `want` slots of key p in [s0, s0 + len), in slot order, to
// ranks rank0, rank0 + 1, ... of the pencil starting at new slot d0. len and
// s0 are multiples of 128 (capacities and tiles are), so an int4 a lane
// stays inside the tile and aligned.
template <typename T>
__device__ __forceinline__ void scan_tile(const RebinArgs<T>& a, long long s0, int len, int p,
                                          int rank0, int want, long long d0) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  int found = 0;
  for (int i0 = 0; i0 < len && found < want; i0 += 128) {
    const long long s = s0 + i0 + 4 * lane;
    const int4 k = *reinterpret_cast<const int4*>(a.keys + s);
    const bool m[4] = {k.x == p, k.y == p, k.z == p, k.w == p};
    unsigned b[4];
    int rank = rank0 + found;
    for (int e = 0; e < 4; ++e) {
      b[e] = __ballot_sync(0xffffffffu, m[e]);
      rank += __popc(b[e] & lt);
    }
    for (int e = 0; e < 4; ++e) {
      if (m[e]) {
        if (rank < a.cap) put(a, s + e, d0 + rank);
        ++rank;
      }
    }
    for (int e = 0; e < 4; ++e) found += __popc(b[e]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kRebinThreads) rebin_gather_kernel(RebinArgs<T> a) {
  __shared__ int s_cnt[kRebinThreads], s_first[kRebinThreads], s_warp[kRebinWarps];
  const int p = blockIdx.x, q = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = static_cast<long long>(q) * a.ns;
  const long long d0 = base + static_cast<long long>(p) * a.cap;
  const int* hist = a.hist + static_cast<long long>(q) * a.n_tiles * a.n_pencils;
  int total = 0;
  for (int t0 = 0; t0 < a.n_tiles; t0 += kRebinThreads) {
    const int t = t0 + threadIdx.x;
    const int h = t < a.n_tiles ? hist[static_cast<long long>(t) * a.n_pencils + p] : 0;
    int incl = h;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int before = 0, chunk = 0;
    for (int w = 0; w < kRebinWarps; ++w) {
      const int v = s_warp[w];
      if (w < warp) before += v;
      chunk += v;
    }
    s_cnt[threadIdx.x] = h;
    s_first[threadIdx.x] = total + before + incl - h;
    __syncthreads();
    const int n_here = min(kRebinThreads, a.n_tiles - t0);
    for (int e = warp; e < n_here; e += kRebinWarps) {
      if (s_cnt[e] == 0) continue;
      const int lo = (t0 + e) * a.tile;
      scan_tile(a, base + lo, min(a.tile, a.ns - lo), p, s_first[e], s_cnt[e], d0);
    }
    total += chunk;
    __syncthreads();
  }
  const int n_valid = min(total, a.cap);
  for (int j = n_valid + threadIdx.x; j < a.cap; j += blockDim.x) fill(a, d0 + j, p, j);
  if (threadIdx.x == 0) {
    a.counts[q * a.n_pencils + p] = n_valid;
    if (total > a.cap) a.ovf_out[q] = 1;
  }
  if (a.check && p == 0) {
    // torch.max(moved2) > thresh: some drift past it and none NaN.
    int gt = 0, nan = 0;
    T mx = T(0);
    for (int t = threadIdx.x; t < a.n_tiles; t += blockDim.x) {
      const int f = a.flags[q * a.n_tiles + t];
      gt |= f & 1;
      nan |= f & 2;
      if (a.dmax_in != nullptr) mx = max(mx, a.tile_max[q * a.n_tiles + t]);
    }
    gt = __syncthreads_or(gt);
    nan = __syncthreads_or(nan);
    if (threadIdx.x == 0 && gt && !nan) a.ovf_out[q] = 1;
    if (a.dmax_in != nullptr) {
      __shared__ T s_max[kRebinWarps];
      mx = block_max(mx, s_max);
      if (threadIdx.x == 0) {
        const T old = a.dmax_in[q];
        a.dmax_out[q] = (nan || old != old) ? (nan ? quiet_nan(old) : old) : max(old, mx);
      }
    }
  }
}

template <typename T>
int launch_rebin(RebinArgs<T> a, int replicas, void* stream) {
  if (replicas < 1 || replicas > 65535 || a.n_pencils < 1 ||
      a.cap < 128 || a.cap % 128 != 0 || a.tile < 128 || a.tile % 128 != 0 ||
      a.ns != a.n_pencils * a.cap || a.n_others < 0 || a.n_others > kRebinMaxOthers ||
      (a.check && a.ref == nullptr) || (a.dmax_in != nullptr && !a.check)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.NS = static_cast<long long>(replicas) * a.ns;
  a.n_tiles = (a.ns + a.tile - 1) / a.tile;
  a.hist_shared = a.n_pencils <= kRebinSharedPencils;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rebin_keys_kernel<T><<<dim3(a.n_tiles, replicas), kRebinThreads,
                         a.hist_shared ? a.n_pencils * sizeof(int) : 0, s>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rebin_gather_kernel<T><<<dim3(a.n_pencils, replicas), kRebinThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int rebin_entry(const T* r, const T* ref, const T* in0, const T* in1, const T* in2,
                const T* in3, const T* in4, int n_others, T* r_out, T* out0, T* out1, T* out2,
                T* out3, T* out4, const unsigned char* ovf_in, unsigned char* ovf_out,
                int* keys, int* hist, int* flags, int* counts, T* tile_max, const T* dmax_in,
                T* dmax_out, int ns, int replicas, int m_xy, int cap, int tile, int wrap,
                int check, T box, T inv_box, T inv_w, T thresh, double sent_base,
                void* stream) {
  RebinArgs<T> a{};
  a.r = r;
  a.ref = ref;
  const T* ins[kRebinMaxOthers] = {in0, in1, in2, in3, in4};
  T* outs[kRebinMaxOthers] = {out0, out1, out2, out3, out4};
  for (int k = 0; k < kRebinMaxOthers; ++k) {
    a.in[k] = ins[k];
    a.out[k] = outs[k];
  }
  a.r_out = r_out;
  a.ovf_in = ovf_in;
  a.ovf_out = ovf_out;
  a.keys = keys;
  a.hist = hist;
  a.flags = flags;
  a.counts = counts;
  a.tile_max = tile_max;
  a.dmax_in = dmax_in;
  a.dmax_out = dmax_out;
  a.ns = ns;
  a.n_pencils = m_xy * m_xy;
  a.m_xy = m_xy;
  a.cap = cap;
  a.tile = tile;
  a.n_others = n_others;
  a.wrap = wrap;
  a.check = check;
  a.box = box;
  a.inv_box = inv_box;
  a.inv_w = inv_w;
  a.thresh = thresh;
  a.sent_base = sent_base;
  return launch_rebin(a, replicas, stream);
}

}  // namespace ljmd

extern "C" {

// `r` and the `n_others` carried fields in0.. (8, R * ns); their rebinned
// copies r_out, out0..; ovf_in / ovf_out (R,) bool; scratch keys (R * ns),
// hist (R * n_tiles * m_xy^2), flags (R * n_tiles) int32, n_tiles = ceil(ns
// / tile); counts (R * m_xy^2) int32; with `check`, dmax_in (R,) the running
// max of the squared drift (or null: none kept), dmax_out its update and
// tile_max (R * n_tiles) scratch. Two launches on `stream`.
int ljmd_pencil_rebin_f32(const float* r, const float* ref, const float* in0, const float* in1,
                          const float* in2, const float* in3, const float* in4, int n_others,
                          float* r_out, float* out0, float* out1, float* out2, float* out3,
                          float* out4, const unsigned char* ovf_in, unsigned char* ovf_out,
                          int* keys, int* hist, int* flags, int* counts, float* tile_max,
                          const float* dmax_in, float* dmax_out, int ns, int replicas,
                          int m_xy, int cap, int tile, int wrap, int check, float box,
                          float inv_box, float inv_w, float thresh, double sent_base,
                          void* stream) {
  return ljmd::rebin_entry<float>(r, ref, in0, in1, in2, in3, in4, n_others, r_out, out0, out1,
                                  out2, out3, out4, ovf_in, ovf_out, keys, hist, flags, counts,
                                  tile_max, dmax_in, dmax_out, ns, replicas, m_xy, cap, tile,
                                  wrap, check, box, inv_box, inv_w, thresh, sent_base, stream);
}

int ljmd_pencil_rebin_f64(const double* r, const double* ref, const double* in0,
                          const double* in1, const double* in2, const double* in3,
                          const double* in4, int n_others, double* r_out, double* out0,
                          double* out1, double* out2, double* out3, double* out4,
                          const unsigned char* ovf_in, unsigned char* ovf_out, int* keys,
                          int* hist, int* flags, int* counts, double* tile_max,
                          const double* dmax_in, double* dmax_out, int ns, int replicas,
                          int m_xy, int cap, int tile, int wrap, int check, double box,
                          double inv_box, double inv_w, double thresh, double sent_base,
                          void* stream) {
  return ljmd::rebin_entry<double>(r, ref, in0, in1, in2, in3, in4, n_others, r_out, out0, out1,
                                   out2, out3, out4, ovf_in, ovf_out, keys, hist, flags, counts,
                                   tile_max, dmax_in, dmax_out, ns, replicas, m_xy, cap, tile,
                                   wrap, check, box, inv_box, inv_w, thresh, sent_base, stream);
}

}  // extern "C"
