// Kernel 2: the per-step pair sweep of the rows engine, with observables,
// for one system or for R replicas in one launch.
//
// Replaces: ljmd_tpu/ops/pallas_lj.py:240 `pallas_pair_sweep_tri` (Pallas
// body `_lj_tri_kernel`, :160). Output contract, column for column: on the
// (8, n_pad) row matrix, rows 0..2 hold the TOTAL force on particle i without
// the 24 prefactor (sum over every j != i, i.e. including the reactions the
// TPU kernel scatters), rows 3..5 hold sum_{j > i} of e / du / ddu (each pair
// counted once, so the caller restores the 4 / 24 prefactors), and rows 6..7
// and every column >= n are exactly 0.
//
// What bounds it on the H100: the pair arithmetic (a displacement and r^2 a
// candidate, ~30 instructions and one IEEE divide a pair inside the cutoff,
// n^2 candidates), and at the main path's sizes (250 to 4000 rows) the few
// rows an SM; the (8, n_pad) input stays in L2.
//
// What the design does about that: the row-sweep body of rows_sweep.cuh
// (which explains it) with its UPPER flag set, so rows 3..5 sum gj > gi:
// 256-thread blocks of 256 / S rows, S threads a row from the occupancy API
// (N=4000: S = 16, 250 blocks; a 1000-row self block S = 64; 250 rows
// S = 128), partners staged by cp.async, a warp-vote cull and fixed-order
// sums: pair-twice, no atomics, deterministic, the TPU kernel's per-pair
// values bit for bit. The replica launch (the ensemble's rows engine) runs
// the same body with blockIdx.y as the replica, at the single-replica
// launch's S, so replica q's output equals a launch on replica q's rows bit
// for bit and never reads another replica's. The element-wise check of
// kernel 1 (lj_pair_terms.cuh) lives here too.
#include <cuda_runtime.h>

#include "rows_sweep.cuh"

namespace ljmd {

// Element-wise evaluation of lj_pair_terms over a flat r^2 array: the
// device function's own check against its plain twin (it has no launch of
// its own on the main path, where kernels 2-4 inline it).
template <typename T, bool OBS>
__global__ void pair_terms_eval_kernel(const T* __restrict__ r2,
                                       const unsigned char* __restrict__ mask,
                                       T* __restrict__ coef, T* __restrict__ du,
                                       T* __restrict__ e, T* __restrict__ ddu,
                                       long long count) {
  const long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (k >= count) return;
  const PairTerms<T> p = lj_pair_terms<T, OBS>(r2[k], mask[k] != 0);
  coef[k] = p.coef;
  if (OBS) {
    du[k] = p.du;
    e[k] = p.e;
    ddu[k] = p.ddu;
  }
}

template <typename T>
int launch_pair_terms_eval(const T* r2, const unsigned char* mask, T* coef,
                           T* du, T* e, T* ddu, long long count, int want_obs,
                           void* stream) {
  const int threads = 256;
  const long long blocks = (count + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (want_obs) {
    pair_terms_eval_kernel<T, true><<<blocks, threads, 0, s>>>(r2, mask, coef, du, e, ddu, count);
  } else {
    pair_terms_eval_kernel<T, false><<<blocks, threads, 0, s>>>(r2, mask, coef, du, e, ddu, count);
  }
  return static_cast<int>(cudaGetLastError());
}

// The replica launch's kernel: blockIdx.y is the replica, whose (8, n_pad)
// rows lie at blockIdx.y * 8 * n_pad in the input and the output.
template <typename T, bool OBS>
__global__ void __launch_bounds__(kRowsThreads)
tri_replicas_kernel(RowsRole<T> p, int S, T box, T inv_box, T rc2) {
  const size_t off = static_cast<size_t>(blockIdx.y) * 8 * p.lda;
  p.a += off;
  p.b += off;
  p.out += off;
  rows_sweep_block<T, OBS, true>(p, blockIdx.x, S, box, inv_box, rc2);
}

// R tri sweeps, each of the rows [0, n) of its (8, n_pad) matrix, in one
// launch of (n_pad / tile, R) blocks at the single-replica plan's S.
template <typename T>
int launch_tri_replicas(const T* pos, T* out, int n, int n_pad, int replicas, T box, T inv_box,
                        T rc2, int want_obs, void* stream) {
  if (n_pad % 128 || n < 0 || n > n_pad || replicas < 1 || replicas > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int plan[8];
  const int err = rows_plan_any<T, true>(want_obs, n, n_pad, n, plan);
  if (err != 0) return err;
  const RowsRole<T> p = rows_role<T>(pos, pos, out, n_pad, 0, n, n_pad, 0, n, 0, 0, 1, plan[1]);
  const dim3 grid(p.blocks, replicas);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (want_obs) {
    tri_replicas_kernel<T, true><<<grid, kRowsThreads, 0, s>>>(p, plan[0], box, inv_box, rc2);
  } else {
    tri_replicas_kernel<T, false><<<grid, kRowsThreads, 0, s>>>(p, plan[0], box, inv_box, rc2);
  }
  return static_cast<int>(cudaGetLastError());
}

int tri_rows_plan(int dtype_bytes, int want_obs, int n, int n_pad, int* out) {
  return dtype_bytes == 4 ? rows_plan_any<float, true>(want_obs, n, n_pad, n, out)
                          : rows_plan_any<double, true>(want_obs, n, n_pad, n, out);
}

}  // namespace ljmd

extern "C" {

int ljmd_pair_sweep_tri_f32(const float* pos, float* out, int n, int n_pad,
                            float box, float inv_box, float rc2, int want_obs,
                            void* stream) {
  return ljmd::launch_rows_sweep<float, true>(pos, pos, out, n, n_pad, n, n_pad, 0, 0, box,
                                              inv_box, rc2, want_obs, stream);
}

int ljmd_pair_sweep_tri_f64(const double* pos, double* out, int n, int n_pad,
                            double box, double inv_box, double rc2, int want_obs,
                            void* stream) {
  return ljmd::launch_rows_sweep<double, true>(pos, pos, out, n, n_pad, n, n_pad, 0, 0, box,
                                               inv_box, rc2, want_obs, stream);
}

// pos and out are (R, 8, n_pad).
int ljmd_pair_sweep_tri_replicas_f32(const float* pos, float* out, int n, int n_pad,
                                     int replicas, float box, float inv_box, float rc2,
                                     int want_obs, void* stream) {
  return ljmd::launch_tri_replicas<float>(pos, out, n, n_pad, replicas, box, inv_box, rc2,
                                          want_obs, stream);
}

int ljmd_pair_sweep_tri_replicas_f64(const double* pos, double* out, int n, int n_pad,
                                     int replicas, double box, double inv_box, double rc2,
                                     int want_obs, void* stream) {
  return ljmd::launch_tri_replicas<double>(pos, out, n, n_pad, replicas, box, inv_box, rc2,
                                           want_obs, stream);
}

int ljmd_pair_terms_f32(const float* r2, const unsigned char* mask, float* coef,
                        float* du, float* e, float* ddu, long long count,
                        int want_obs, void* stream) {
  return ljmd::launch_pair_terms_eval<float>(r2, mask, coef, du, e, ddu, count, want_obs, stream);
}

int ljmd_pair_terms_f64(const double* r2, const unsigned char* mask, double* coef,
                        double* du, double* e, double* ddu, long long count,
                        int want_obs, void* stream) {
  return ljmd::launch_pair_terms_eval<double>(r2, mask, coef, du, e, ddu, count, want_obs, stream);
}

const char* ljmd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
