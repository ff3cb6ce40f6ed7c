// Kernel 18: the pair-tile layout bodies, STEPS steps over a visit list in
// ONE launch each.
//
// Replaces: scripts/exp_layout.py:127-700, the Pallas bodies k1 (:127), k2b
// (:184), k2 (:246), k3 (:417), k4 and k4z (:639), k5a/b/c (:495), k6 (:590).
//
// What bounds it on the H100: per visit 128 * tj_w candidate pairs (65536
// at tj_w = 512) of ~13 float32 operations to the cutoff test, and ~1.4% of
// them (the experiment's box) inside the cutoff with ~17 more and a
// reduction of the force to both sides. Its parent design ran one visit on
// one 128-thread block (at 32 visits, 4 warps on 32 SMs), reduced every
// pair's j reaction over the warp with three shuffle trees, took three
// __syncthreads and 384 atomics a 128-column stage, and ran the force body
// for every candidate: it timed one SM's latency, not a layout.
//
// What the design does about that: a visit splits into 32 x 32 sub-tiles
// (4 i groups x tj_w / 32 column slices), each a warp's work item, over a
// persistent cooperative grid of 8-warp blocks sized from the occupancy API
// (experiments/layout.py's layout_plan): at 32 visits and 512 columns, 2048
// items. At step k of an item lane l pairs its i row (position and sums in
// registers) with column (l + k) mod 32, so each column has one owner a
// step: its reaction rides in a register rotated by one shuffle a
// component, and only on steps with a hit; no per-pair reduction.
// The j positions are staged by cp.async, double-buffered across a warp's
// items; a warp vote skips the force body where no lane is inside the
// cutoff. Sums go to f / fT by atomicAdd once per item, only from rows and
// columns that met a pair (the sums reach r only through f[1] * 1e-9; the
// order of atomics changes from run to run). PURE keeps a (g, s) sub-tile's
// 32 accumulators a lane in registers over a chunk of the visits and
// flushes them once. The three grid barriers a step stay.
//
// Each step of a body:
//   r[0, :] += 1e-6; the accumulators are zeroed;
//   for each visit t (an (i-tile, j-tile) pair, 128 rows x tj_w columns),
//     the LJ pair-tile forces of the 128 i rows against the tj_w columns,
//     onto the i rows and, as reactions, onto the j columns;
//   r[1, :] += f[1, :] * 1e-9.
// Float32, minimum image on x, y (and z unless MIC_Z is false), the pair
// terms of lj_pair_terms.cuh (an IEEE divide where the TPU takes its fast
// reciprocal and a Newton step). (The glue probes `transpose_cost`, :308,
// and `dot_transpose_cost`, :324, are transposes: mosaic_probes.cu's
// transpose kernel with its scaling op.)
//
// The variants (compile-time switches):
//   LAYOUT 0 "rows"        i and j positions from the (8, n) rows; both
//                          sides into f (k1, k4, k4z, k5);
//   LAYOUT 1 "trans_i"     i positions from the transposed (n, 8) copy rT,
//                          i sums into the transposed fT, j reactions into
//                          f (k2b, k3);
//   LAYOUT 2 "trans_tile"  the tile transposed: tj_w j rows from rT at an
//                          8-granular offset (tj * 8), d = x_j - x_i, i sums
//                          subtracted into f, j sums into fT (k2);
//   DUAL     visits alternate between two accumulators (k3, k4, k5), and
//            r[1] takes f + f2;
//   DYN / TAIL / SECOND (k5)  the visit count read from the device, an odd
//            tail visit, and a second, masked (gj > gi, gj < n, gi < n) loop
//            whose count (0 in the experiment) is read from the device too
//            (its items follow the first loop's; their sub-tiles run an
//            instantiation of their own, so the mask costs no branch a step);
//   PURE     (k6) no reductions: coef*dx + coef*dy + coef*dz added element
//            by element into a (128, tj_w) accumulator at a fixed place.
// The rT / fT copies are never updated from r (as in the TPU bodies).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "lj_pair_terms.cuh"

namespace cg = cooperative_groups;

namespace ljmd {

constexpr int kLayoutRows = 128;  // i rows of a visit
constexpr int kSub = 32;          // rows and columns of a warp's sub-tile
constexpr int kLayoutWarps = 8;   // warps a block
constexpr int kLayoutThreads = 32 * kLayoutWarps;
constexpr int kJBuf = 4 * kSub;   // floats of one staged j buffer
constexpr unsigned kFull = 0xffffffffu;

struct LayoutArgs {
  float* r;          // (8, n_pad): the state, updated in place
  const float* rT;   // (n_pad, 8): the transposed copy (layouts 1, 2)
  float* f;          // (8, n_pad) accumulators
  float* f2;
  float* fT;         // (n_pad, 8) transposed accumulators
  float* fT2;
  float* acc;        // (128, n_pad): PURE's accumulator
  const int* ti;     // visits: i tile (x 128)
  const int* tj;     // j tile (x tj_w; layout 2: x 8)
  const int* cnt;    // DYN: [main count, masked count]
  int v;             // visit count (static variants)
  int n_pad;
  int tj_w;
  int steps;
  float box;
  float inv_box;
  float rc2;
  int n_vc;          // PURE: visit chunks (a warp item takes visits vc, vc + n_vc, ...)
};

// The j positions of columns [j0, j0 + 32) into buf: rows x, y, z of 32
// floats each from r, or (LAYOUT 2) 32 rows of 4 floats from rT. Not
// committed.
template <int LAYOUT>
__device__ __forceinline__ void stage_j(float* buf, const LayoutArgs& p, int j0, int lane) {
  if (LAYOUT == 2) {
    cp_async16(buf + lane * 4, p.rT + static_cast<size_t>(j0 + lane) * 8);
  } else if (lane < 24) {
    const int c = lane >> 3;
    const int e = (lane & 7) * 4;
    cp_async16(buf + c * kSub + e, p.r + static_cast<size_t>(c) * p.n_pad + j0 + e);
  }
}

template <int LAYOUT>
__device__ __forceinline__ void j_pos(const float* buf, int m, float& x, float& y, float& z) {
  if (LAYOUT == 2) {
    const float4 q = *reinterpret_cast<const float4*>(buf + m * 4);
    x = q.x;
    y = q.y;
    z = q.z;
  } else {
    x = buf[m];
    y = buf[kSub + m];
    z = buf[2 * kSub + m];
  }
}

// Row i's position: from rT (LAYOUT 1, never written) or from r through L2
// (r changes between the grid barriers).
template <int LAYOUT>
__device__ __forceinline__ float3 i_pos(const LayoutArgs& p, int i) {
  if (LAYOUT == 1) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p.rT + static_cast<size_t>(i) * 8));
    return make_float3(q.x, q.y, q.z);
  }
  return make_float3(__ldcg(p.r + i), __ldcg(p.r + p.n_pad + i),
                     __ldcg(p.r + 2 * static_cast<size_t>(p.n_pad) + i));
}

// d (minimum image) and r^2 of a pair; LAYOUT 2 takes d = x_j - x_i.
template <int LAYOUT, bool MIC_Z>
__device__ __forceinline__ float pair_r2(const LayoutArgs& p, float3 xi, float xj, float yj,
                                         float zj, float& dx, float& dy, float& dz) {
  if (LAYOUT == 2) {
    dx = sub_rn(xj, xi.x);
    dy = sub_rn(yj, xi.y);
    dz = sub_rn(zj, xi.z);
  } else {
    dx = sub_rn(xi.x, xj);
    dy = sub_rn(xi.y, yj);
    dz = sub_rn(xi.z, zj);
  }
  dx = min_image(dx, p.box, p.inv_box);
  dy = min_image(dy, p.box, p.inv_box);
  if (MIC_Z) dz = min_image(dz, p.box, p.inv_box);
  return add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz));
}

// A work item's visit and place: item it of a step (pass 0's items, then
// pass 1's), g = it % 4 its i group, s = (it / 4) % n_sl its column slice,
// t = it / (4 n_sl) its visit.
struct Item {
  int pass;
  int t;
  int i;   // this lane's i row
  int j0;  // the sub-tile's first column (LAYOUT 2: rT row)
};

template <int LAYOUT>
__device__ __forceinline__ Item decode_item(const LayoutArgs& p, int it, int items0, int n_sl,
                                            int lane) {
  Item x;
  x.pass = it >= items0 ? 1 : 0;
  const int local = it - (x.pass ? items0 : 0);
  const int g = local & 3;
  const int s = (local >> 2) % n_sl;
  x.t = (local >> 2) / n_sl;
  const int tj = __ldg(p.tj + x.t);
  x.j0 = (LAYOUT == 2 ? tj * 8 : tj * p.tj_w) + s * kSub;
  x.i = __ldg(p.ti + x.t) * kLayoutRows + g * kSub + lane;
  return x;
}

// A sub-tile's 32 steps: at step k lane l pairs its row i with column m =
// (l + k) mod 32 of the staged j positions sj. The row sums stay with the
// lane; the column sums travel in registers, lane l holding column (l + ko)
// mod 32's, rotated to step k's owners only on a step with a hit and back to
// column l at the end. imask / jmask: rows / columns that met a pair.
struct SubtileSums {
  float3 fi;
  float3 fj;
  unsigned imask;
  unsigned jmask;
};

template <int LAYOUT, bool MIC_Z, bool MASKED>
__device__ __forceinline__ SubtileSums subtile_pairs(const LayoutArgs& p, const float* sj,
                                                     float3 xi, int i, int j0, int lane) {
  float fix = 0.0f, fiy = 0.0f, fiz = 0.0f;
  float fjx = 0.0f, fjy = 0.0f, fjz = 0.0f;
  int ko = 0;
  unsigned imask = 0u, jmask = 0u;
#pragma unroll 4
  for (int k = 0; k < kSub; ++k) {
    const int m = (lane + k) & (kSub - 1);
    float xj, yj, zj, dx, dy, dz;
    j_pos<LAYOUT>(sj, m, xj, yj, zj);
    const float r2 = pair_r2<LAYOUT, MIC_Z>(p, xi, xj, yj, zj, dx, dy, dz);
    bool hit = r2 < p.rc2;
    if (MASKED) {
      const int gj = j0 + m;
      hit = hit && gj > i && gj < p.n_pad && i < p.n_pad;
    }
    const unsigned ball = __ballot_sync(kFull, hit);
    if (ball) {
      const float coef = lj_pair_terms<float, false>(r2, hit).coef;
      const float fx = mul_rn(coef, dx);
      const float fy = mul_rn(coef, dy);
      const float fz = mul_rn(coef, dz);
      fix = add_rn(fix, fx);
      fiy = add_rn(fiy, fy);
      fiz = add_rn(fiz, fz);
      const int src = (lane + k - ko) & (kSub - 1);
      fjx = __shfl_sync(kFull, fjx, src);
      fjy = __shfl_sync(kFull, fjy, src);
      fjz = __shfl_sync(kFull, fjz, src);
      ko = k;
      if (hit) {
        fjx = add_rn(fjx, fx);
        fjy = add_rn(fjy, fy);
        fjz = add_rn(fjz, fz);
      }
      imask |= ball;
      jmask |= __funnelshift_l(ball, ball, k);  // lane l -> column (l + k) mod 32
    }
  }
  const int src = (lane - ko) & (kSub - 1);
  return {make_float3(fix, fiy, fiz),
          make_float3(__shfl_sync(kFull, fjx, src), __shfl_sync(kFull, fjy, src),
                      __shfl_sync(kFull, fjz, src)),
          imask, jmask};
}

template <int LAYOUT, bool DUAL, bool MIC_Z, bool DYN, bool TAIL, bool SECOND>
__device__ void visit_items(const LayoutArgs& p, float* jbuf) {
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * kLayoutWarps + (threadIdx.x >> 5);
  const int nw = gridDim.x * kLayoutWarps;
  const int n_pad = p.n_pad;
  const int n_sl = p.tj_w / kSub;
  int works[2] = {0, 0};
#pragma unroll
  for (int pass = 0; pass < (SECOND ? 2 : 1); ++pass) {
    const int cnt = DYN ? p.cnt[pass] : p.v;
    int n = DUAL ? 2 * (cnt / 2) : cnt;
    if (TAIL && (cnt & 1)) n = cnt;
    works[pass] = n;
  }
  const int items0 = works[0] * 4 * n_sl;
  const int items = items0 + works[1] * 4 * n_sl;

  int it = gw;
  Item cur{0, 0, 0, 0};
  float3 xi = make_float3(0.0f, 0.0f, 0.0f);
  if (it < items) {
    cur = decode_item<LAYOUT>(p, it, items0, n_sl, lane);
    stage_j<LAYOUT>(jbuf, p, cur.j0, lane);
    xi = i_pos<LAYOUT>(p, cur.i);
  }
  cp_async_commit();
  int buf = 0;
  while (it < items) {
    // Stage the next item's columns and load its row while this one runs.
    const int nxt = it + nw;
    Item next = cur;
    float3 nxi = xi;
    if (nxt < items) {
      next = decode_item<LAYOUT>(p, nxt, items0, n_sl, lane);
      stage_j<LAYOUT>(jbuf + (buf ^ 1) * kJBuf, p, next.j0, lane);
      nxi = i_pos<LAYOUT>(p, next.i);
    }
    cp_async_commit();
    cp_async_wait(1);
    __syncwarp();
    // The masked loop is its own instantiation: one branch an item, none a
    // step.
    const SubtileSums a =
        SECOND && cur.pass == 1
            ? subtile_pairs<LAYOUT, MIC_Z, true>(p, jbuf + buf * kJBuf, xi, cur.i, cur.j0, lane)
            : subtile_pairs<LAYOUT, MIC_Z, false>(p, jbuf + buf * kJBuf, xi, cur.i, cur.j0, lane);
    const bool second = DUAL && (cur.t & 1);
    float* fa = second ? p.f2 : p.f;
    float* fta = second ? p.fT2 : p.fT;
    if ((a.imask >> lane) & 1u) {
      const int i = cur.i;
      if (LAYOUT == 0) {
        atomicAdd(fa + i, a.fi.x);
        atomicAdd(fa + n_pad + i, a.fi.y);
        atomicAdd(fa + 2 * n_pad + i, a.fi.z);
      } else if (LAYOUT == 1) {
        atomicAdd(fta + i * 8 + 0, a.fi.x);
        atomicAdd(fta + i * 8 + 1, a.fi.y);
        atomicAdd(fta + i * 8 + 2, a.fi.z);
      } else {  // f[:, isl] -= sum over j
        atomicAdd(fa + i, -a.fi.x);
        atomicAdd(fa + n_pad + i, -a.fi.y);
        atomicAdd(fa + 2 * n_pad + i, -a.fi.z);
      }
    }
    if ((a.jmask >> lane) & 1u) {
      const int j = cur.j0 + lane;
      if (LAYOUT == 2) {  // fT[jsl] += sum over i
        atomicAdd(fta + j * 8 + 0, a.fj.x);
        atomicAdd(fta + j * 8 + 1, a.fj.y);
        atomicAdd(fta + j * 8 + 2, a.fj.z);
      } else {  // f[:, jsl] -= sum over i
        atomicAdd(fa + j, -a.fj.x);
        atomicAdd(fa + n_pad + j, -a.fj.y);
        atomicAdd(fa + 2 * n_pad + j, -a.fj.z);
      }
    }
    __syncwarp();
    buf ^= 1;
    it = nxt;
    cur = next;
    xi = nxi;
  }
  cp_async_wait(0);
}

// PURE: warp item w takes sub-tile (g, s) = (grp % 4, grp / 4), grp = w %
// (4 n_sl), of the visits w / (4 n_sl), + n_vc, ...; lane l's accumulator k
// is element (g * 32 + l, s * 32 + (l + k) mod 32) of acc.
__device__ void pure_items(const LayoutArgs& p, float* jbuf) {
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * kLayoutWarps + (threadIdx.x >> 5);
  const int nw = gridDim.x * kLayoutWarps;
  const int n_pad = p.n_pad;
  const int groups = 4 * (p.tj_w / kSub);
  const int n_vc = max(1, min(p.n_vc, p.v));
  const int items = p.v > 0 ? groups * n_vc : 0;
  auto j_start = [&](int w, int t) {
    return __ldg(p.tj + t) * p.tj_w + ((w % groups) >> 2) * kSub;
  };
  auto i_row = [&](int w, int t) {
    return __ldg(p.ti + t) * kLayoutRows + ((w % groups) & 3) * kSub + lane;
  };
  int w = gw;
  int t = gw / groups;
  float3 xi = make_float3(0.0f, 0.0f, 0.0f);
  if (w < items) {
    stage_j<0>(jbuf, p, j_start(w, t), lane);
    xi = i_pos<0>(p, i_row(w, t));
  }
  cp_async_commit();
  float acc[kSub];
#pragma unroll
  for (int k = 0; k < kSub; ++k) acc[k] = 0.0f;
  int buf = 0;
  while (w < items) {
    int nw_ = w;
    int nt = t + n_vc;
    if (nt >= p.v) {
      nw_ = w + nw;
      nt = nw_ / groups;
    }
    float3 nxi = xi;
    if (nw_ < items) {
      stage_j<0>(jbuf + (buf ^ 1) * kJBuf, p, j_start(nw_, nt), lane);
      nxi = i_pos<0>(p, i_row(nw_, nt));
    }
    cp_async_commit();
    cp_async_wait(1);
    __syncwarp();
    const float* sj = jbuf + buf * kJBuf;
#pragma unroll
    for (int k = 0; k < kSub; ++k) {
      const int m = (lane + k) & (kSub - 1);
      float xj, yj, zj, dx, dy, dz;
      j_pos<0>(sj, m, xj, yj, zj);
      const float r2 = pair_r2<0, true>(p, xi, xj, yj, zj, dx, dy, dz);
      const bool hit = r2 < p.rc2;
      if (__any_sync(kFull, hit)) {
        const float coef = lj_pair_terms<float, false>(r2, hit).coef;
        const float val = add_rn(add_rn(mul_rn(coef, dx), mul_rn(coef, dy)), mul_rn(coef, dz));
        acc[k] = add_rn(acc[k], val);
      }
    }
    __syncwarp();
    if (nw_ != w) {  // the item's last visit: flush its sub-tile
      const int grp = w % groups;
      float* row = p.acc + static_cast<size_t>((grp & 3) * kSub + lane) * n_pad + (grp >> 2) * kSub;
#pragma unroll
      for (int k = 0; k < kSub; ++k) {
        if (acc[k] != 0.0f) atomicAdd(row + ((lane + k) & (kSub - 1)), acc[k]);
        acc[k] = 0.0f;
      }
    }
    buf ^= 1;
    w = nw_;
    t = nt;
    xi = nxi;
  }
  cp_async_wait(0);
}

template <int LAYOUT, bool DUAL, bool MIC_Z, bool DYN, bool TAIL, bool SECOND, bool PURE>
__global__ void __launch_bounds__(kLayoutThreads, 2) layout_kernel(LayoutArgs p) {
  __shared__ __align__(16) float jbuf[kLayoutWarps][2 * kJBuf];
  cg::grid_group grid = cg::this_grid();
  const int warp = threadIdx.x >> 5;
  const int n_pad = p.n_pad;
  const int g0 = blockIdx.x * blockDim.x + threadIdx.x;
  const int gs = gridDim.x * blockDim.x;
  for (int s = 0; s < p.steps; ++s) {
    // Phase 1: drift row 0, zero the accumulators.
    for (int c = g0; c < n_pad; c += gs) {
      p.r[c] = add_rn(p.r[c], 1e-6f);
      if (PURE) continue;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        p.f[k * n_pad + c] = 0.0f;
        p.fT[c * 8 + k] = 0.0f;
        if (DUAL) {
          p.f2[k * n_pad + c] = 0.0f;
          p.fT2[c * 8 + k] = 0.0f;
        }
      }
    }
    if (PURE) {
      for (int e = g0; e < kLayoutRows * p.tj_w; e += gs) {
        p.acc[static_cast<size_t>(e / p.tj_w) * n_pad + e % p.tj_w] = 0.0f;
      }
    }
    grid.sync();

    // Phase 2: the visits.
    if (PURE) {
      pure_items(p, jbuf[warp]);
    } else {
      visit_items<LAYOUT, DUAL, MIC_Z, DYN, TAIL, SECOND>(p, jbuf[warp]);
    }
    grid.sync();

    // Phase 3: kick row 1 by the accumulated y force.
    for (int c = g0; c < n_pad; c += gs) {
      float fy = PURE ? p.acc[n_pad + c] : p.f[n_pad + c];
      if (DUAL) fy = add_rn(fy, p.f2[n_pad + c]);
      p.r[n_pad + c] = add_rn(p.r[n_pad + c], mul_rn(fy, 1e-9f));
      if (LAYOUT == 1 && DUAL) {
        p.r[2 * n_pad + c] = add_rn(p.r[2 * n_pad + c], mul_rn(add_rn(p.fT[0], p.fT2[0]), 0.0f));
      }
    }
    grid.sync();
  }
}

using KernelFn = void (*)(LayoutArgs);

// The variants by name, in the experiment's order.
KernelFn variant_kernel(int variant) {
  switch (variant) {
    case 0: return layout_kernel<0, false, true, false, false, false, false>;   // k1
    case 1: return layout_kernel<1, false, true, false, false, false, false>;   // k2b
    case 2: return layout_kernel<2, false, true, false, false, false, false>;   // k2
    case 3: return layout_kernel<1, true, true, false, false, false, false>;    // k3
    case 4: return layout_kernel<0, true, true, false, false, false, false>;    // k4
    case 5: return layout_kernel<0, true, false, false, false, false, false>;   // k4z
    case 6: return layout_kernel<0, true, true, true, false, false, false>;     // k5a
    case 7: return layout_kernel<0, true, true, true, true, false, false>;      // k5b
    case 8: return layout_kernel<0, true, true, true, true, true, false>;       // k5c
    case 9: return layout_kernel<0, false, true, false, false, false, true>;    // k6
    default: return nullptr;
  }
}

}  // namespace ljmd

extern "C" {

// Blocks of `variant` that fit on the card at once.
int ljmd_layout_max_blocks(int variant, int* out) {
  ljmd::KernelFn fn = ljmd::variant_kernel(variant);
  if (!fn) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, reinterpret_cast<const void*>(fn), ljmd::kLayoutThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *out = per_sm * sms;
  return 0;
}

int ljmd_layout_body(int variant, float* r, const float* rT, float* f, float* f2, float* fT,
                     float* fT2, float* acc, const int* ti, const int* tj, const int* cnt,
                     int v, int n_pad, int tj_w, int steps, float box, float inv_box,
                     float rc2, int n_vc, int blocks, void* stream) {
  ljmd::KernelFn fn = ljmd::variant_kernel(variant);
  if (!fn || tj_w % ljmd::kSub || n_pad % ljmd::kLayoutRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ljmd::LayoutArgs p{r, rT, f, f2, fT, fT2, acc, ti, tj, cnt, v, n_pad, tj_w, steps,
                     box, inv_box, rc2, n_vc};
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fn),
                                                dim3(blocks), dim3(ljmd::kLayoutThreads), args,
                                                0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
