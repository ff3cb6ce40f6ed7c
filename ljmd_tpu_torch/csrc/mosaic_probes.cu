// Kernel 17: the feature probes, each an ITERS-long loop in ONE launch.
//
// Replaces: scripts/exp_mosaic_support.py:65-217, the nine Pallas probes
// `build_t8n`, `build_t128`, `build_lane_unaligned`, `build_lane_aligned`,
// `build_sublane8`, `build_sublane_any`, `build_roll`, `build_rowsum` and
// `build_rowsum_store` (pl.pallas_call at :72 ... :212), float32:
//   transpose   out = x^T + it (probe) or x^T * (1 + 1e-9 it) (the layout
//               script's transpose_cost), rewritten every iteration;
//   window      out[row 0 or the whole window] += x[offs[it] * scale ...]
//               (a 512-lane window of row 0 of an (8, N) matrix, or a
//               256-row window of an (N, 128) matrix);
//   roll        out += roll(x, offs[it], axis=1) (numpy's direction, which
//               is pltpu.roll's);
//   row sum     acc += sum_j x[r, j] * (1 + it), kept in a register and
//               written once, or added each iteration into row
//               (it % 32) * 128 + r, column 0, of an (N, 8) output.
// The outputs the TPU probes accumulate into without initialising them are
// zero-filled by the wrappers.
//
// What bounds it on the H100: each probe moves a few to a few hundred KB per
// iteration through L1/L2 (the inputs stay cached across iterations), so the
// launch and the per-iteration latency of the loop, not HBM bytes or flops,
// set its time.
//
// What the design does about that: nothing beyond the obvious mapping; the
// probes exist to time what a layout operation costs on this card. Transposes
// stage 32 x 32 tiles through shared memory (padded against bank conflicts)
// with a __syncthreads() per iteration, so no iteration's stores can be
// dropped; windows and rolls give one thread each output element, which keeps
// its running sum in a register in the TPU probe's order; row sums reduce one
// row per block through warp shuffles in a fixed order.
#include <cuda_runtime.h>

namespace ljmd {

constexpr int kTransTile = 32;
constexpr int kTransRows = 8;

template <int OP>
__global__ void probe_transpose_kernel(const float* x, float* out, int rows, int cols,
                                       int iters) {
  __shared__ float tile[kTransTile][kTransTile + 1];
  const int c0 = blockIdx.x * kTransTile;
  const int r0 = blockIdx.y * kTransTile;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  for (int it = 0; it < iters; ++it) {
    for (int k = ty; k < kTransTile; k += kTransRows) {
      const int r = r0 + k;
      const int c = c0 + tx;
      if (r < rows && c < cols) tile[k][tx] = x[static_cast<size_t>(r) * cols + c];
    }
    __syncthreads();
    const float f = OP == 0 ? static_cast<float>(it)
                            : __fadd_rn(1.0f, __fmul_rn(1e-9f, static_cast<float>(it)));
    for (int k = ty; k < kTransTile; k += kTransRows) {
      const int oc = c0 + k;  // output row = input column
      const int orr = r0 + tx;
      if (oc < cols && orr < rows) {
        const float val = tile[tx][k];
        out[static_cast<size_t>(oc) * rows + orr] = OP == 0 ? __fadd_rn(val, f) : __fmul_rn(val, f);
      }
    }
    __syncthreads();
  }
}

// out[e] += x[offs[it] * scale * ld + e] for e < count (a window of `count`
// contiguous elements at a runtime offset: lanes of row 0 with ld = 1, or
// whole 128-wide rows with ld = 128).
__global__ void probe_window_kernel(const int* offs, const float* x, float* out, int iters,
                                    int scale, int ld, int count) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float acc = out[e];
  for (int it = 0; it < iters; ++it) {
    acc = __fadd_rn(acc, x[static_cast<size_t>(offs[it]) * scale * ld + e]);
  }
  out[e] = acc;
}

// out[r, c] += x[r, (c - offs[it]) mod width] over an (rows, width) matrix.
__global__ void probe_roll_kernel(const int* offs, const float* x, float* out, int iters,
                                  int rows, int width) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= rows * width) return;
  const int r = e / width;
  const int c = e % width;
  float acc = out[e];
  for (int it = 0; it < iters; ++it) {
    int src = (c - offs[it]) % width;
    if (src < 0) src += width;
    acc = __fadd_rn(acc, x[r * width + src]);
  }
  out[e] = acc;
}

constexpr int kRowThreads = 128;

// One block per row r of the (rows, width) input. STORE: each iteration adds
// the row sum into out[((it % 32) * rows + r) * 8] of an (N, 8) output;
// otherwise the sums add up in a register and out[r] is written once.
template <bool STORE>
__global__ void __launch_bounds__(kRowThreads)
probe_rowsum_kernel(const float* x, float* out, int rows, int width, int iters) {
  __shared__ float warp_sum[kRowThreads / 32];
  const int r = blockIdx.x;
  const int t = threadIdx.x;
  const float* row = x + static_cast<size_t>(r) * width;
  float acc = 0.0f;
  for (int it = 0; it < iters; ++it) {
    const float f = __fadd_rn(1.0f, static_cast<float>(it));
    float s = 0.0f;
    for (int c = t; c < width; c += kRowThreads) s = __fadd_rn(s, __fmul_rn(row[c], f));
    for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    if ((t & 31) == 0) warp_sum[t >> 5] = s;
    __syncthreads();
    if (t == 0) {
      float tot = warp_sum[0];
      for (int w = 1; w < kRowThreads / 32; ++w) tot = __fadd_rn(tot, warp_sum[w]);
      if (STORE) {
        float* dst = out + (static_cast<size_t>(it % 32) * rows + r) * 8;
        *dst = __fadd_rn(*dst, tot);
      } else {
        acc = __fadd_rn(acc, tot);
      }
    }
    __syncthreads();
  }
  if (!STORE && t == 0) out[r] = acc;
}

}  // namespace ljmd

extern "C" {

// op 0: out = x^T + it; op 1: out = x^T * (1 + 1e-9 it). x is (rows, cols).
int ljmd_probe_transpose(const float* x, float* out, int rows, int cols, int iters, int op,
                         void* stream) {
  const dim3 block(ljmd::kTransTile, ljmd::kTransRows);
  const dim3 grid((cols + ljmd::kTransTile - 1) / ljmd::kTransTile,
                  (rows + ljmd::kTransTile - 1) / ljmd::kTransTile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (op == 0) {
    ljmd::probe_transpose_kernel<0><<<grid, block, 0, s>>>(x, out, rows, cols, iters);
  } else {
    ljmd::probe_transpose_kernel<1><<<grid, block, 0, s>>>(x, out, rows, cols, iters);
  }
  return static_cast<int>(cudaGetLastError());
}

int ljmd_probe_window(const int* offs, const float* x, float* out, int iters, int scale,
                      int ld, int count, void* stream) {
  const int threads = 256;
  ljmd::probe_window_kernel<<<(count + threads - 1) / threads, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(offs, x, out, iters, scale,
                                                                   ld, count);
  return static_cast<int>(cudaGetLastError());
}

int ljmd_probe_roll(const int* offs, const float* x, float* out, int iters, int rows,
                    int width, void* stream) {
  const int threads = 256;
  ljmd::probe_roll_kernel<<<(rows * width + threads - 1) / threads, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(offs, x, out, iters, rows,
                                                                 width);
  return static_cast<int>(cudaGetLastError());
}

int ljmd_probe_rowsum(const float* x, float* out, int rows, int width, int iters, int store,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (store) {
    ljmd::probe_rowsum_kernel<true><<<rows, ljmd::kRowThreads, 0, s>>>(x, out, rows, width,
                                                                        iters);
  } else {
    ljmd::probe_rowsum_kernel<false><<<rows, ljmd::kRowThreads, 0, s>>>(x, out, rows, width,
                                                                         iters);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
