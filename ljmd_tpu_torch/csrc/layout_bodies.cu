// Kernel 18: the pair-tile layout bodies, STEPS steps over a visit list in
// ONE launch each.
//
// Replaces: scripts/exp_layout.py:127-700, the Pallas bodies k1 (:127), k2b
// (:184), k2 (:246), k3 (:417), k4 and k4z (:639, `mic_z`), k5a/b/c (:495)
// and k6 (:590). (The glue probes `transpose_cost`, :308, and
// `dot_transpose_cost`, :324, are transposes: mosaic_probes.cu's transpose
// kernel with its scaling op.) Each step of a body:
//   r[0, :] += 1e-6; the accumulators are zeroed;
//   for each visit t (an (i-tile, j-tile) pair, 128 rows x tj_w columns),
//     the LJ pair-tile forces of the 128 i rows against the tj_w columns,
//     onto the i rows and, as reactions, onto the j columns;
//   r[1, :] += f[1, :] * 1e-9.
// Float32, minimum image on x, y (and z unless MIC_Z is false), the pair
// terms of lj_pair_terms.cuh (an IEEE divide where the TPU takes its fast
// reciprocal and a Newton step).
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
//            whose count (0 in the experiment) is read from the device too;
//   PURE     (k6) no reductions: coef*dx + coef*dy + coef*dz added element
//            by element into a (128, tj_w) accumulator at a fixed place.
// The rT / fT copies are never updated from r (as in the TPU bodies).
//
// What bounds it on the H100: per visit 128 * tj_w pairs (65536 at tj_w =
// 512) of ~30 float32 operations and the reductions of each pair's force to
// both sides; the experiment times the slope between 32 and 128 visits, so
// only the per-visit cost counts, not the launch.
//
// What the design does about that: a cooperative launch of a persistent
// grid of 128-thread blocks (one i row per thread), one grid barrier after
// each of the step's three phases (drift; visits; kick). A visit stages its
// j columns through shared memory 128 at a time; each thread keeps its i
// row's sum in registers, and the j reactions of a 128-column chunk are
// summed over each warp with shuffles, then over the 4 warps in shared
// memory. Random visit lists repeat tiles, so several blocks add onto the
// same i rows and j columns: those sums go to the accumulators with float
// atomicAdd, whose order changes from run to run. They reach r only through
// f[1] * 1e-9, far below float32's resolution of r. PURE gives each block
// one 32-column slice of the tile and a register accumulator per element
// across all the visits it takes, flushed by atomicAdd once per step.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "lj_pair_terms.cuh"

namespace cg = cooperative_groups;

namespace ljmd {

constexpr int kLayoutRows = 128;   // i rows of a visit = threads of a block
constexpr int kLayoutStage = 128;  // j columns staged at once
constexpr int kPureSlice = 32;     // columns of a PURE work item

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
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = add_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int LAYOUT, bool MIC_Z>
__device__ void visit_body(const LayoutArgs& p, int t, bool masked, float* fa, float* fta,
                           float (*sj)[kLayoutStage], float (*red)[kLayoutStage][3]) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_pad = p.n_pad;
  const int i = p.ti[t] * kLayoutRows + tid;
  const int j_lo = LAYOUT == 2 ? p.tj[t] * 8 : p.tj[t] * p.tj_w;
  float xi, yi, zi;
  if (LAYOUT == 1) {
    xi = p.rT[i * 8 + 0];
    yi = p.rT[i * 8 + 1];
    zi = p.rT[i * 8 + 2];
  } else {
    xi = p.r[i];
    yi = p.r[n_pad + i];
    zi = p.r[2 * n_pad + i];
  }
  float fix = 0.0f, fiy = 0.0f, fiz = 0.0f;
  for (int j0 = 0; j0 < p.tj_w; j0 += kLayoutStage) {
    const int jl = j_lo + j0 + tid;
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      sj[c][tid] = LAYOUT == 2 ? p.rT[jl * 8 + c] : p.r[c * n_pad + jl];
    }
    __syncthreads();
    for (int jj = 0; jj < kLayoutStage; ++jj) {
      float dx, dy, dz;
      if (LAYOUT == 2) {
        dx = sub_rn(sj[0][jj], xi);
        dy = sub_rn(sj[1][jj], yi);
        dz = sub_rn(sj[2][jj], zi);
      } else {
        dx = sub_rn(xi, sj[0][jj]);
        dy = sub_rn(yi, sj[1][jj]);
        dz = sub_rn(zi, sj[2][jj]);
      }
      dx = min_image(dx, p.box, p.inv_box);
      dy = min_image(dy, p.box, p.inv_box);
      if (MIC_Z) dz = min_image(dz, p.box, p.inv_box);
      const float r2 = add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz));
      bool m = r2 < p.rc2;
      if (masked) {
        const int gj = j_lo + j0 + jj;
        m = m && gj > i && gj < n_pad && i < n_pad;
      }
      const float coef = lj_pair_terms<float, false>(r2, m).coef;
      const float fx = mul_rn(coef, dx);
      const float fy = mul_rn(coef, dy);
      const float fz = mul_rn(coef, dz);
      fix = add_rn(fix, fx);
      fiy = add_rn(fiy, fy);
      fiz = add_rn(fiz, fz);
      const float sx = warp_sum(fx);
      const float sy = warp_sum(fy);
      const float sz = warp_sum(fz);
      if (lane == 0) {
        red[warp][jj][0] = sx;
        red[warp][jj][1] = sy;
        red[warp][jj][2] = sz;
      }
    }
    __syncthreads();
    // The chunk's column sums: thread tid takes column j_lo + j0 + tid.
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float s = red[0][tid][c];
#pragma unroll
      for (int w = 1; w < kLayoutRows / 32; ++w) s = add_rn(s, red[w][tid][c]);
      if (LAYOUT == 2) {
        atomicAdd(&fta[jl * 8 + c], s);        // fT[jsl] += sum over i
      } else {
        atomicAdd(&fa[c * n_pad + jl], -s);    // f[:, jsl] -= sum over i
      }
    }
  }
  if (LAYOUT == 0) {
    atomicAdd(&fa[i], fix);
    atomicAdd(&fa[n_pad + i], fiy);
    atomicAdd(&fa[2 * n_pad + i], fiz);
  } else if (LAYOUT == 1) {
    atomicAdd(&fta[i * 8 + 0], fix);
    atomicAdd(&fta[i * 8 + 1], fiy);
    atomicAdd(&fta[i * 8 + 2], fiz);
  } else {
    atomicAdd(&fa[i], -fix);                   // f[:, isl] -= sum over j
    atomicAdd(&fa[n_pad + i], -fiy);
    atomicAdd(&fa[2 * n_pad + i], -fiz);
  }
}

// PURE: block b takes column slice b % n_sl of the visits b / n_sl, b / n_sl
// + gridDim.x / n_sl, ...; gridDim.x is a multiple of n_sl.
__device__ void pure_visits(const LayoutArgs& p, float (*sj)[kLayoutStage]) {
  const int tid = threadIdx.x;
  const int n_pad = p.n_pad;
  const int n_sl = p.tj_w / kPureSlice;
  const int sl = blockIdx.x % n_sl;
  float acc[kPureSlice];
#pragma unroll
  for (int k = 0; k < kPureSlice; ++k) acc[k] = 0.0f;
  for (int t = blockIdx.x / n_sl; t < p.v; t += gridDim.x / n_sl) {
    const int i = p.ti[t] * kLayoutRows + tid;
    const int jb = p.tj[t] * p.tj_w + sl * kPureSlice;
    const float xi = p.r[i];
    const float yi = p.r[n_pad + i];
    const float zi = p.r[2 * n_pad + i];
    __syncthreads();
    if (tid < kPureSlice) {
#pragma unroll
      for (int c = 0; c < 3; ++c) sj[c][tid] = p.r[c * n_pad + jb + tid];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPureSlice; ++k) {
      float dx = sub_rn(xi, sj[0][k]);
      float dy = sub_rn(yi, sj[1][k]);
      float dz = sub_rn(zi, sj[2][k]);
      dx = min_image(dx, p.box, p.inv_box);
      dy = min_image(dy, p.box, p.inv_box);
      dz = min_image(dz, p.box, p.inv_box);
      const float r2 = add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz));
      const float coef = lj_pair_terms<float, false>(r2, r2 < p.rc2).coef;
      const float val = add_rn(add_rn(mul_rn(coef, dx), mul_rn(coef, dy)), mul_rn(coef, dz));
      acc[k] = add_rn(acc[k], val);
    }
  }
  if (blockIdx.x / n_sl < p.v) {
#pragma unroll
    for (int k = 0; k < kPureSlice; ++k) {
      atomicAdd(&p.acc[static_cast<size_t>(tid) * n_pad + sl * kPureSlice + k], acc[k]);
    }
  }
}

template <int LAYOUT, bool DUAL, bool MIC_Z, bool DYN, bool TAIL, bool SECOND, bool PURE>
__global__ void __launch_bounds__(kLayoutRows) layout_kernel(LayoutArgs p) {
  __shared__ float sj[3][kLayoutStage];
  __shared__ float red[kLayoutRows / 32][kLayoutStage][3];
  cg::grid_group grid = cg::this_grid();
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
      pure_visits(p, sj);
    } else {
      for (int pass = 0; pass < (SECOND ? 2 : 1); ++pass) {
        const int cnt = DYN ? p.cnt[pass] : p.v;
        int n_work = DUAL ? 2 * (cnt / 2) : cnt;
        if (TAIL && (cnt & 1)) n_work = cnt;
        for (int t = blockIdx.x; t < n_work; t += gridDim.x) {
          const bool second = DUAL && (t & 1);
          visit_body<LAYOUT, MIC_Z>(p, t, pass == 1, second ? p.f2 : p.f,
                                    second ? p.fT2 : p.fT, sj, red);
        }
      }
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
      &per_sm, reinterpret_cast<const void*>(fn), ljmd::kLayoutRows, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *out = per_sm * sms;
  return 0;
}

int ljmd_layout_body(int variant, float* r, const float* rT, float* f, float* f2, float* fT,
                     float* fT2, float* acc, const int* ti, const int* tj, const int* cnt,
                     int v, int n_pad, int tj_w, int steps, float box, float inv_box,
                     float rc2, int blocks, void* stream) {
  ljmd::KernelFn fn = ljmd::variant_kernel(variant);
  if (!fn) return static_cast<int>(cudaErrorInvalidValue);
  ljmd::LayoutArgs p{r, rT, f, f2, fT, fT2, acc, ti, tj, cnt, v, n_pad, tj_w, steps,
                     box, inv_box, rc2};
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fn),
                                                dim3(blocks), dim3(ljmd::kLayoutRows), args,
                                                0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
