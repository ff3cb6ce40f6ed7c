// Kernel 2: the per-step pair sweep of the rows engine, with observables.
//
// Replaces: ljmd_tpu/ops/pallas_lj.py:240 `pallas_pair_sweep_tri` (Pallas
// body `_lj_tri_kernel`, :160). Output contract, column for column: on the
// (8, n_pad) row matrix, rows 0..2 hold the TOTAL force on particle i without
// the 24 prefactor (sum over every j != i, i.e. including the reactions the
// TPU kernel scatters), rows 3..5 hold sum_{j > i} of e / du / ddu (each pair
// counted once, so the caller restores the 4 / 24 prefactors), and rows 6..7
// and every column >= n are exactly 0.
//
// What bounds it on the H100: the pair arithmetic (~30 instructions and one
// IEEE divide a pair, O(n^2) pairs), and at n = 500 and 4000 the few
// particles per SM; the (8, n_pad) input stays in L2.
//
// What the design does about that: pair-twice without atomics, 32 particles
// i x 4 j slices a block over a shared-memory j tile, a fixed-order
// reduction: deterministic, and the per-pair values are the TPU kernel's bit
// for bit, summed in another order. The body is shared with the ordered sweep
// (kernel 5, pair_sweep.cu) in pair_rows.cuh, which explains it; here its
// e/du/ddu rows sum j > i.
#include <cuda_runtime.h>

#include "pair_rows.cuh"

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

}  // namespace ljmd

extern "C" {

int ljmd_pair_sweep_tri_f32(const float* pos, float* out, int n, int n_pad,
                            float box, float inv_box, float rc2, int want_obs,
                            void* stream) {
  return ljmd::launch_pair_rows<float, false>(pos, out, n, n_pad, box, inv_box, rc2, want_obs, stream);
}

int ljmd_pair_sweep_tri_f64(const double* pos, double* out, int n, int n_pad,
                            double box, double inv_box, double rc2, int want_obs,
                            void* stream) {
  return ljmd::launch_pair_rows<double, false>(pos, out, n, n_pad, box, inv_box, rc2, want_obs, stream);
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
