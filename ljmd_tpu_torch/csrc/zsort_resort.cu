// The zsort engine's resort: a sort-and-gather kernel and kernel 9's pack,
// two launches.
//
// Replaces: ljmd_tpu/ops/pallas_fused.py:269 `compute_tile_flags` with the
// JAX engine's `_sort` and `_lists` around it (ljmd_tpu/models/engine.py:686,
// :632) and, under `always`, the travel check before it. JAX has no Pallas
// kernel for them: XLA fuses the jnp chain. In eager PyTorch it is ~101
// device operations and the check 13 more, each its own host launch: at
// N=4000 ~3.2 ms of host launches a resort, four a sample cycle, kept the
// card idle most of the time (PERF.md §5).
//
// What bounds it on the H100: at N=4000 a resort moves ~0.8 MB (~0.25 us at
// 3.35 TB/s); the sort of 4096 keys and the 1024 tile pairs are a few
// thousand operations. What is left is a block's barrier-separated steps.
//
// What the design does about that: one block a replica (blockIdx.x), so a
// stack of R is one launch whose blocks run side by side:
// - keys: each column's packed unique int32 key, as the engine's torch
//   chain builds it (ops/zsort_resort.py zsort_resort_plain): z scaled and
//   truncated to zq_bits, clamped; with slabs the x-slab above it; padding
//   (ids < 0) the top key; the column index in the low bits_pad bits. With
//   `check` (the `always` trigger) the same pass reads r_ref and folds in
//   the travel check: the largest minimum-image dz^2 (max(dx^2, dz^2) with
//   slabs) over valid columns, NaN-propagating as torch.max, into the
//   sticky flag and the running travel2;
// - sort: a bitonic sort of the keys (the next power of two, padded with
//   INT_MAX) in shared memory up to kResortSharedKeys keys (128 KB; every
//   fused-viable n_pad, <= 23,168, is under it), past that in a global
//   scratch row of the replica's (only `init` sorts at such sizes). The keys
//   are unique, so the order is torch.sort's;
// - gather: a warp a 128-column tile, 32 columns a step (coalesced writes):
//   rows 0..2 of each field from the column the key names, rows 3..7 zero,
//   the ids; and the tile's interval of sorted z (x with slabs) over columns
//   < n for the pack;
// - pack: kernel 9 (csrc/pack_window_lists.cu) with its flags worked out
//   from those intervals, one block a replica.
// Every operation is IEEE-rounded as its torch counterpart (the _rn
// intrinsics, truncating conversions, no fast math), so the outputs are the
// torch chain's bits (tests/test_torch_cuda.py).
#include <climits>

#include <cuda_runtime.h>

#include "lj_pair_terms.cuh"

extern "C" {
int ljmd_pack_window_lists_intervals_f32(const float* ivl, int* tiles, int* tcounts, int n,
                                         int n_b, int tile_i, int tile_j, int n_tails, int max_t,
                                         int replicas, int slab, float win_z, float win_x,
                                         float box, float cross, float box_cross, float face,
                                         float box_face, void* stream);
int ljmd_pack_window_lists_intervals_f64(const double* ivl, int* tiles, int* tcounts, int n,
                                         int n_b, int tile_i, int tile_j, int n_tails, int max_t,
                                         int replicas, int slab, double win_z, double win_x,
                                         double box, double cross, double box_cross, double face,
                                         double box_face, void* stream);
}

namespace ljmd {

constexpr int kResortThreads = 1024;
constexpr int kResortWarps = kResortThreads / 32;
constexpr int kResortTile = 128;
constexpr int kResortMaxFields = 6;
// Keys sorted in shared memory: 32,768 ints, 128 KB of the 227 KB a block
// may opt into.
constexpr int kResortSharedKeys = 32 * 1024;

template <typename T>
struct ResortArgs {
  const T* in[kResortMaxFields];  // r, ru, v, a (rlo, vc extended): (R, 8, n_pad)
  T* out[kResortMaxFields];
  const int* ids;   // (R, n_pad)
  int* ids_out;
  const int* resorts;  // (R,) or null
  int* resorts_out;
  const T* ref;  // (R, 8, n_pad) r_ref with `check`, else null
  const unsigned char* invalid;  // (R,) bool
  unsigned char* invalid_out;
  const T* travel2;  // (R,)
  T* travel2_out;
  T* ivl;  // (R, 4, n_b) tile intervals for the pack
  int* keys;  // (R, p2) global scratch past kResortSharedKeys, else null
  int n_fields, n, n_pad, n_b, p2, zq_bits, bits_pad, n_slabs, slab, check;
  T zscale, xscale, box, inv_box, thresh;
};

template <typename T>
__device__ __forceinline__ T nan_max_(T a, T b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}
template <typename T>
__device__ __forceinline__ T nan_min_(T a, T b) {
  return a != a ? a : (b != b ? b : (b < a ? b : a));
}

__device__ __forceinline__ float inf_of(float) { return __int_as_float(0x7f800000); }
__device__ __forceinline__ double inf_of(double) {
  return __longlong_as_double(0x7ff0000000000000LL);
}

template <typename T>
__device__ __forceinline__ int quantize(T x, T scale, int top) {
  // (x * scale).to(torch.int32) (truncation; cvt saturates, NaN -> 0), then
  // torch.clamp(., 0, top).
  return min(max(static_cast<int>(mul_rn(x, scale)), 0), top);
}

template <typename T>
__global__ void __launch_bounds__(kResortThreads, 1) zsort_sort_kernel(ResortArgs<T> a) {
  extern __shared__ int s_keys[];
  __shared__ T s_red[kResortWarps];
  const size_t q = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_pad = a.n_pad;
  const size_t field = static_cast<size_t>(8) * n_pad;  // one replica's rows
  const T* r = a.in[0] + q * field;
  const int* ids = a.ids + q * n_pad;
  int* keys = a.keys ? a.keys + q * a.p2 : s_keys;

  // Keys, and the travel check of the `always` trigger.
  const int zmax = (1 << a.zq_bits) - 1;
  const int top = (1 << (30 - a.bits_pad)) - 1;
  T m2 = T(0);
  for (int c = tid; c < a.p2; c += kResortThreads) {
    int key = INT_MAX;
    if (c < n_pad) {
      const T z = r[2 * n_pad + c];
      int kq = quantize(z, a.zscale, zmax);
      if (a.slab) kq = (quantize(r[c], a.xscale, a.n_slabs - 1) << a.zq_bits) | kq;
      const bool valid = ids[c] >= 0;
      key = ((valid ? kq : top) << a.bits_pad) | c;
      if (a.check) {
        const T* ref = a.ref + q * field;
        const T dz = min_image(sub_rn(z, ref[2 * n_pad + c]), a.box, a.inv_box);
        T m = mul_rn(dz, dz);
        if (a.slab) {
          const T dx = min_image(sub_rn(r[c], ref[c]), a.box, a.inv_box);
          m = nan_max_(mul_rn(dx, dx), m);
        }
        m2 = nan_max_(m2, mul_rn(m, valid ? T(1) : T(0)));
      }
    }
    keys[c] = key;
  }
  if (a.check) {
    for (int o = 16; o > 0; o >>= 1) m2 = nan_max_(m2, __shfl_xor_sync(0xffffffffu, m2, o));
    if (lane == 0) s_red[warp] = m2;
  }
  __syncthreads();
  if (a.check && tid == 0) {
    T m = s_red[0];
    for (int w = 1; w < kResortWarps; ++w) m = nan_max_(m, s_red[w]);
    // invalid | (moved2 > thresh); torch.maximum(travel2, moved2).
    a.invalid_out[q] = a.invalid[q] | (m > a.thresh ? 1 : 0);
    a.travel2_out[q] = nan_max_(a.travel2[q], m);
  }
  if (a.resorts && tid == 0) a.resorts_out[q] = a.resorts[q] + 1;

  // Bitonic sort, ascending: pair t of a step compares i and i + j, where i
  // is t with a zero bit inserted at j.
  for (int k = 2; k <= a.p2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = tid; t < a.p2 / 2; t += kResortThreads) {
        const int i = 2 * t - (t & (j - 1));
        const int x = keys[i], y = keys[i + j];
        if ((x > y) == ((i & k) == 0)) {
          keys[i] = y;
          keys[i + j] = x;
        }
      }
      __syncthreads();
    }
  }

  // Gather, a warp a tile, and the tile's intervals over columns < n.
  const int mask = (1 << a.bits_pad) - 1;
  const T inf = inf_of(T(0));
  T* ivl = a.ivl + q * 4 * a.n_b;
  for (int t = warp; t < a.n_b; t += kResortWarps) {
    T zlo = inf, zhi = -inf, xlo = inf, xhi = -inf;
    for (int s = 0; s < kResortTile; s += 32) {
      const int j = t * kResortTile + s + lane;
      const int src = keys[j] & mask;
      for (int f = 0; f < a.n_fields; ++f) {
        const T* in = a.in[f] + q * field;
        T* out = a.out[f] + q * field;
        for (int row = 0; row < 3; ++row) out[row * n_pad + j] = in[row * n_pad + src];
        for (int row = 3; row < 8; ++row) out[row * n_pad + j] = T(0);
      }
      a.ids_out[q * n_pad + j] = ids[src];
      if (j < a.n) {
        const T z = r[2 * n_pad + src];
        zlo = nan_min_(zlo, z);
        if (isfinite(z)) zhi = max(zhi, z);
        if (a.slab) {
          const T x = r[src];
          xlo = nan_min_(xlo, x);
          if (isfinite(x)) xhi = max(xhi, x);
        }
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      zlo = nan_min_(zlo, __shfl_xor_sync(0xffffffffu, zlo, o));
      zhi = max(zhi, __shfl_xor_sync(0xffffffffu, zhi, o));
      xlo = nan_min_(xlo, __shfl_xor_sync(0xffffffffu, xlo, o));
      xhi = max(xhi, __shfl_xor_sync(0xffffffffu, xhi, o));
    }
    if (lane == 0) {
      ivl[t] = zlo;
      ivl[a.n_b + t] = zhi;
      ivl[2 * a.n_b + t] = xlo;
      ivl[3 * a.n_b + t] = xhi;
    }
  }
}

int pack_intervals(const float* ivl, int* tiles, int* tcounts, int n, int n_b, int tile_j,
                   int n_tails, int max_t, int replicas, int slab, float win, float box,
                   float cross, float box_cross, float box_face, void* stream) {
  return ljmd_pack_window_lists_intervals_f32(ivl, tiles, tcounts, n, n_b, kResortTile, tile_j,
                                              n_tails, max_t, replicas, slab, win, win, box,
                                              cross, box_cross, win, box_face, stream);
}

int pack_intervals(const double* ivl, int* tiles, int* tcounts, int n, int n_b, int tile_j,
                   int n_tails, int max_t, int replicas, int slab, double win, double box,
                   double cross, double box_cross, double box_face, void* stream) {
  return ljmd_pack_window_lists_intervals_f64(ivl, tiles, tcounts, n, n_b, kResortTile, tile_j,
                                              n_tails, max_t, replicas, slab, win, win, box,
                                              cross, box_cross, win, box_face, stream);
}

template <typename T>
int resort_call(const T* const* in, T* const* out, int n_fields, const int* ids, int* ids_out,
                const int* resorts, int* resorts_out, const T* ref,
                const unsigned char* invalid, unsigned char* invalid_out, const T* travel2,
                T* travel2_out, T* ivl, int* keys, int* tiles, int* tcounts, int n, int n_pad,
                int replicas, int stacked, int zq_bits, int bits_pad, int n_slabs, int slab,
                int check, int tile_j, int n_tails, int max_t, T zscale, T xscale, T box,
                T inv_box, T thresh, T win, T cross, T box_cross, T box_face, void* stream) {
  if (replicas < 1 || replicas > 65535 || (!stacked && replicas != 1) || n_pad < kResortTile ||
      n_pad % kResortTile || n < 0 || n > n_pad || n_fields < 1 ||
      n_fields > kResortMaxFields || bits_pad < 1 || zq_bits < 1 || zq_bits + bits_pad > 30 ||
      (1 << bits_pad) < n_pad || (slab && n_slabs < 1) || ivl == nullptr ||
      (check && (ref == nullptr || invalid == nullptr || travel2 == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ResortArgs<T> a{};
  for (int f = 0; f < n_fields; ++f) {
    a.in[f] = in[f];
    a.out[f] = out[f];
  }
  a.ids = ids;
  a.ids_out = ids_out;
  a.resorts = resorts;
  a.resorts_out = resorts_out;
  a.ref = ref;
  a.invalid = invalid;
  a.invalid_out = invalid_out;
  a.travel2 = travel2;
  a.travel2_out = travel2_out;
  a.ivl = ivl;
  a.n_fields = n_fields;
  a.n = n;
  a.n_pad = n_pad;
  a.n_b = n_pad / kResortTile;
  a.zq_bits = zq_bits;
  a.bits_pad = bits_pad;
  a.n_slabs = n_slabs;
  a.slab = slab;
  a.check = check;
  a.zscale = zscale;
  a.xscale = xscale;
  a.box = box;
  a.inv_box = inv_box;
  a.thresh = thresh;
  a.p2 = kResortTile;
  while (a.p2 < n_pad) a.p2 <<= 1;
  const bool shared = a.p2 <= kResortSharedKeys;
  if (!shared && keys == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  a.keys = shared ? nullptr : keys;
  const size_t smem = shared ? sizeof(int) * a.p2 : 0;
  if (smem > 48 * 1024) {  // past a block's default: opt in (on the current device)
    const cudaError_t err = cudaFuncSetAttribute(
        zsort_sort_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  zsort_sort_kernel<T><<<replicas, kResortThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // The pack's one-system kernel for a single system, its replica kernel
  // (block q replica q) for a stack.
  return pack_intervals(ivl, tiles, tcounts, n, a.n_b, tile_j, n_tails, max_t,
                        stacked ? replicas : 0, slab, win, box, cross, box_cross, box_face,
                        stream);
}

}  // namespace ljmd

extern "C" {

int ljmd_zsort_sort_shared_keys() { return ljmd::kResortSharedKeys; }

// in / out: n_fields pointers each (r, ru, v, a, then rlo, vc when
// extended), (R, 8, n_pad) (or (8, n_pad)); ids / ids_out (R, n_pad) int32;
// resorts / resorts_out (R,) int32 or null; with `check`, ref (R, 8, n_pad),
// invalid / invalid_out (R,) bool, travel2 / travel2_out (R,); ivl (R, 4,
// n_pad / 128) scratch; keys (R, p2) int32 scratch where p2, the power of two
// at or above n_pad, passes ljmd_zsort_sort_shared_keys(), else null; tiles
// / tcounts the lists' layout (ops/window_lists.py list_layout), (R, ...)
// with `stacked`. Two launches on `stream`.
int ljmd_zsort_resort_f32(const float* const* in, float* const* out, int n_fields,
                          const int* ids, int* ids_out, const int* resorts, int* resorts_out,
                          const float* ref, const unsigned char* invalid,
                          unsigned char* invalid_out, const float* travel2, float* travel2_out,
                          float* ivl, int* keys, int* tiles, int* tcounts, int n, int n_pad,
                          int replicas, int stacked, int zq_bits, int bits_pad, int n_slabs,
                          int slab, int check, int tile_j, int n_tails, int max_t, float zscale,
                          float xscale, float box, float inv_box, float thresh, float win,
                          float cross, float box_cross, float box_face, void* stream) {
  return ljmd::resort_call<float>(in, out, n_fields, ids, ids_out, resorts, resorts_out, ref,
                                  invalid, invalid_out, travel2, travel2_out, ivl, keys, tiles,
                                  tcounts, n, n_pad, replicas, stacked, zq_bits, bits_pad,
                                  n_slabs, slab, check, tile_j, n_tails, max_t, zscale, xscale,
                                  box, inv_box, thresh, win, cross, box_cross, box_face, stream);
}

int ljmd_zsort_resort_f64(const double* const* in, double* const* out, int n_fields,
                          const int* ids, int* ids_out, const int* resorts, int* resorts_out,
                          const double* ref, const unsigned char* invalid,
                          unsigned char* invalid_out, const double* travel2,
                          double* travel2_out, double* ivl, int* keys, int* tiles, int* tcounts,
                          int n, int n_pad, int replicas, int stacked, int zq_bits, int bits_pad,
                          int n_slabs, int slab, int check, int tile_j, int n_tails, int max_t,
                          double zscale, double xscale, double box, double inv_box,
                          double thresh, double win, double cross, double box_cross,
                          double box_face, void* stream) {
  return ljmd::resort_call<double>(in, out, n_fields, ids, ids_out, resorts, resorts_out, ref,
                                   invalid, invalid_out, travel2, travel2_out, ivl, keys, tiles,
                                   tcounts, n, n_pad, replicas, stacked, zq_bits, bits_pad,
                                   n_slabs, slab, check, tile_j, n_tails, max_t, zscale, xscale,
                                   box, inv_box, thresh, win, cross, box_cross, box_face,
                                   stream);
}

}  // extern "C"
