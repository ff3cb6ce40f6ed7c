// Kernel 17: the feature probes, each an ITERS-long loop in ONE launch.
//
// Replaces: scripts/exp_mosaic_support.py:65-217, the nine Pallas probes
// (transposes, lane / sublane windows, roll, row sums; contract below).
//
// What bounds it on the H100: a probe reads its input once and writes its
// output once (a few KB to 2 MB), so its bound is well under a microsecond;
// what it times is ITERS repetitions of one layout operation on data held
// on chip. Its parent design timed the loop's latency instead: two block
// barriers an iteration (transposes, row sums), a dependent global load of
// offs[it] before every element (windows, roll), an integer % (roll), a
// quarter of the transposing threads storing, one row a 128-thread block.
//
// What the design does about that: each block copies the slice of the input
// its outputs can read into shared memory once (the TPU probe's VMEM block)
// and offs[] into shared memory in chunks (its SMEM scalar prefetch); the
// iteration loop has no barrier, is unrolled so that several iterations'
// loads are in flight while the adds keep the probe's order, and the result
// is written back once. Transposes read their input tile column-wise and
// rewrite their output tile in shared memory every iteration through
// volatile PTX loads and stores (the compiler may neither hoist the reads
// nor drop the overwritten stores), every thread one float4 of an output
// row. Windows and roll give each thread outputs in consecutive banks; roll
// wraps by compare-and-add. Row sums hold a row in a warp's registers and
// interleave 8 independent iterations; rowsum_store's 32 slots are the
// lanes' registers (slot it % 32 is lane it % 32).
//
// The probes, float32 (launch plans: experiments/mosaic_support.py):
//   transpose   out = x^T + it (probe) or x^T * (1 + 1e-9 it) (the layout
//               script's transpose_cost), rewritten every iteration;
//   gather      out[j] += x[offs[it] * scale + j] (a 512-lane window of row
//               0 of an (8, N) matrix, or a 256-row window of an (N, 128)
//               matrix, a block per column), or out[r, c] += x[r, (c -
//               offs[it]) mod width] (roll, numpy's direction, which is
//               pltpu.roll's);
//   row sum     acc += sum_j x[r, j] * (1 + it), kept in a register and
//               written once, or added each iteration into row
//               (it % 32) * 128 + r, column 0, of an (N, 8) output.
// The outputs the TPU probes accumulate into without initialising them are
// zero-filled by the wrappers.
#include <cuda_runtime.h>

#include <cstdint>

namespace ljmd {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Shared-memory accesses that are issued every time they are written: the
// transposes' reads of an unchanging tile and stores that the next
// iteration overwrites would otherwise be hoisted or dropped.
__device__ __forceinline__ float ld_volatile_shared(const float* p) {
  float v;
  asm volatile("ld.volatile.shared.f32 %0, [%1];" : "=f"(v) : "r"(smem_addr(p)) : "memory");
  return v;
}

__device__ __forceinline__ void st_volatile_shared4(float* p, float a, float b, float c,
                                                    float d) {
  asm volatile("st.volatile.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(smem_addr(p)),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

// ---------------------------------------------------------------- transposes
// A block holds a tr x tc tile of x (rows r0.., columns c0..), padded to
// tc + pad floats a row so that the column-wise reads hit distinct banks, and
// a tc x tr output tile; thread t = oc * (tr / 4) + q makes output row c0 +
// oc, columns r0 + 4q .. r0 + 4q + 3 (x rows) as one float4. Tiles: rows <= 8:
// rows x 32 (pad 4); cols <= 8: 32 x cols (pad 1); else 16 x 16 (pad 2): at
// most 288 tile floats and 64 threads.
constexpr int kTransTileFloats = 288;
constexpr int kTransOutFloats = 256;
constexpr int kTransThreads = 64;
constexpr int kTransUnroll = 4;

template <int OP>
__device__ __forceinline__ float trans_factor(int it) {
  return OP == 0 ? static_cast<float>(it)
                 : __fadd_rn(1.0f, __fmul_rn(1e-9f, static_cast<float>(it)));
}

template <int OP>
__device__ __forceinline__ float trans_apply(float v, float f) {
  return OP == 0 ? __fadd_rn(v, f) : __fmul_rn(v, f);
}

template <int OP>
__global__ void __launch_bounds__(kTransThreads)
probe_transpose_kernel(const float* __restrict__ x, float* __restrict__ out, int rows,
                       int cols, int iters, int tr, int tc, int pad) {
  __shared__ float xs[kTransTileFloats];
  __shared__ __align__(16) float os[kTransOutFloats];
  const int c0 = blockIdx.x * tc;
  const int r0 = blockIdx.y * tr;
  const int ld = tc + pad;
  const int t = threadIdx.x;
  for (int e = t; e < tr * tc; e += blockDim.x) {
    const int k = e / tc;
    const int cc = e - k * tc;
    const int r = r0 + k;
    const int c = c0 + cc;
    xs[k * ld + cc] = (r < rows && c < cols) ? x[static_cast<size_t>(r) * cols + c] : 0.0f;
  }
  __syncthreads();
  const int qn = tr / 4;
  const int oc = t / qn;
  const int q = t - oc * qn;
  const float* src = xs + 4 * q * ld + oc;
  float* dst = os + oc * tr + 4 * q;
  float o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int it = 0;
  for (; it + kTransUnroll <= iters; it += kTransUnroll) {
    float v[kTransUnroll][4];
#pragma unroll
    for (int u = 0; u < kTransUnroll; ++u) {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[u][k] = ld_volatile_shared(src + k * ld);
    }
#pragma unroll
    for (int u = 0; u < kTransUnroll; ++u) {
      const float f = trans_factor<OP>(it + u);
#pragma unroll
      for (int k = 0; k < 4; ++k) o[k] = trans_apply<OP>(v[u][k], f);
      st_volatile_shared4(dst, o[0], o[1], o[2], o[3]);
    }
  }
  for (; it < iters; ++it) {
    const float f = trans_factor<OP>(it);
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = trans_apply<OP>(ld_volatile_shared(src + k * ld), f);
    st_volatile_shared4(dst, o[0], o[1], o[2], o[3]);
  }
  if (iters > 0 && c0 + oc < cols && r0 + 4 * q < rows) {
    *reinterpret_cast<float4*>(out + static_cast<size_t>(c0 + oc) * rows + r0 + 4 * q) =
        make_float4(o[0], o[1], o[2], o[3]);
  }
}

// ---------------------------------------------------------------- gathers
// Block b takes slice sl = b / n_jb (x and out offset sl * sl_stride) and
// outputs j = (b % n_jb) * 128 * EPT + u * 128 + t (u < EPT, j < count) at
// sl * sl_stride + j * ld; it holds x[sl * sl_stride + k * ld], k < len, in
// shared memory. Windows read staged element offs[it] * scale + j, roll (j -
// offs[it]) mod len.
constexpr int kGatherThreads = 128;
constexpr int kOffsChunk = 1024;
constexpr int kGatherUnroll = 8;

template <bool ROLL>
__device__ __forceinline__ int gather_src(int j, int o, int scale, int len) {
  if (ROLL) {
    const int s = j - o;  // 0 <= j, o < len
    return s < 0 ? s + len : s;
  }
  return o * scale + j;
}

template <bool ROLL, int EPT>
__global__ void __launch_bounds__(kGatherThreads)
probe_gather_kernel(const int* __restrict__ offs, const float* __restrict__ x,
                    float* __restrict__ out, int iters, int scale, int n_jb, int sl_stride,
                    int ld, int len, int count) {
  extern __shared__ __align__(16) float xs[];
  __shared__ int os[kOffsChunk];
  const int sl = blockIdx.x / n_jb;
  const int jb = blockIdx.x - sl * n_jb;
  const int t = threadIdx.x;
  const size_t base = static_cast<size_t>(sl) * sl_stride;
  if (ld == 1 && len % 4 == 0 && reinterpret_cast<uintptr_t>(x + base) % 16 == 0) {
    const float4* src = reinterpret_cast<const float4*>(x + base);
    for (int k = t; k < len / 4; k += kGatherThreads) reinterpret_cast<float4*>(xs)[k] = src[k];
  } else {
    for (int k = t; k < len; k += kGatherThreads) xs[k] = x[base + static_cast<size_t>(k) * ld];
  }
  int j[EPT];
  bool live[EPT];
  float acc[EPT];
#pragma unroll
  for (int u = 0; u < EPT; ++u) {
    const int jj = jb * kGatherThreads * EPT + u * kGatherThreads + t;
    live[u] = jj < count;
    j[u] = live[u] ? jj : 0;  // a dead output reads in range and is not written
    acc[u] = live[u] ? out[base + static_cast<size_t>(jj) * ld] : 0.0f;
  }
  for (int c0 = 0; c0 < iters; c0 += kOffsChunk) {
    const int n = min(kOffsChunk, iters - c0);
    __syncthreads();
    for (int e = t; e < n; e += kGatherThreads) os[e] = offs[c0 + e];
    __syncthreads();
    int e = 0;
    for (; e + kGatherUnroll <= n; e += kGatherUnroll) {
      float v[kGatherUnroll][EPT];
#pragma unroll
      for (int w = 0; w < kGatherUnroll; ++w) {
        const int o = os[e + w];
#pragma unroll
        for (int u = 0; u < EPT; ++u) v[w][u] = xs[gather_src<ROLL>(j[u], o, scale, len)];
      }
#pragma unroll
      for (int w = 0; w < kGatherUnroll; ++w) {
#pragma unroll
        for (int u = 0; u < EPT; ++u) acc[u] = __fadd_rn(acc[u], v[w][u]);
      }
    }
    for (; e < n; ++e) {
      const int o = os[e];
#pragma unroll
      for (int u = 0; u < EPT; ++u) {
        acc[u] = __fadd_rn(acc[u], xs[gather_src<ROLL>(j[u], o, scale, len)]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < EPT; ++u) {
    if (live[u]) out[base + static_cast<size_t>(j[u]) * ld] = acc[u];
  }
}

// ---------------------------------------------------------------- row sums
// Block r (one warp) holds row r of the (rows, width) input in registers,
// lane l elements l, l + 32, ... (width <= 32 * kRowPerLane). Each iteration's
// row sum: the lane's elements in order, then a butterfly over the lanes
// (every lane ends with the same total). STORE: lane s keeps the slot of
// iterations it % 32 == s and writes out[(s * rows + r) * 8] once; otherwise
// the sums add up in order and lane 0 writes out[r].
constexpr int kRowPerLane = 16;
constexpr int kRowUnroll = 8;

template <bool STORE>
__global__ void __launch_bounds__(32)
probe_rowsum_kernel(const float* __restrict__ x, float* __restrict__ out, int rows, int width,
                    int iters) {
  const int r = blockIdx.x;
  const int lane = threadIdx.x;
  const int per_lane = width / 32;
  float xr[kRowPerLane];
#pragma unroll
  for (int m = 0; m < kRowPerLane; ++m) {
    xr[m] = m < per_lane ? x[static_cast<size_t>(r) * width + m * 32 + lane] : 0.0f;
  }
  float* slot_ptr = out + (static_cast<size_t>(lane) * rows + r) * 8;
  float slot = STORE ? *slot_ptr : 0.0f;
  float acc = 0.0f;
  int it = 0;
  for (; it + kRowUnroll <= iters; it += kRowUnroll) {
    float s[kRowUnroll];
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      const float f = __fadd_rn(1.0f, static_cast<float>(it + u));
      s[u] = 0.0f;
#pragma unroll
      for (int m = 0; m < kRowPerLane; ++m) s[u] = __fadd_rn(s[u], __fmul_rn(xr[m], f));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        s[u] = __fadd_rn(s[u], __shfl_xor_sync(0xffffffffu, s[u], o));
      }
    }
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      if (STORE) {
        if (lane == ((it + u) & 31)) slot = __fadd_rn(slot, s[u]);
      } else {
        acc = __fadd_rn(acc, s[u]);
      }
    }
  }
  for (; it < iters; ++it) {
    const float f = __fadd_rn(1.0f, static_cast<float>(it));
    float s = 0.0f;
#pragma unroll
    for (int m = 0; m < kRowPerLane; ++m) s = __fadd_rn(s, __fmul_rn(xr[m], f));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    if (STORE) {
      if (lane == (it & 31)) slot = __fadd_rn(slot, s);
    } else {
      acc = __fadd_rn(acc, s);
    }
  }
  if (STORE) {
    *slot_ptr = slot;
  } else if (lane == 0) {
    out[r] = acc;
  }
}

}  // namespace ljmd

extern "C" {

// op 0: out = x^T + it; op 1: out = x^T * (1 + 1e-9 it). x is (rows, cols),
// rows a multiple of 4; the tile (tr, tc, pad) from mosaic_support.py's
// transpose_plan.
int ljmd_probe_transpose(const float* x, float* out, int rows, int cols, int iters, int op,
                         int tr, int tc, int pad, void* stream) {
  if (rows % 4 || tr % 4 || tr * (tc + pad) > ljmd::kTransTileFloats ||
      tr * tc > ljmd::kTransOutFloats || tr * tc / 4 > ljmd::kTransThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((cols + tc - 1) / tc, (rows + tr - 1) / tr);
  const int threads = tr * tc / 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (op == 0) {
    ljmd::probe_transpose_kernel<0><<<grid, threads, 0, s>>>(x, out, rows, cols, iters, tr, tc,
                                                             pad);
  } else {
    ljmd::probe_transpose_kernel<1><<<grid, threads, 0, s>>>(x, out, rows, cols, iters, tr, tc,
                                                             pad);
  }
  return static_cast<int>(cudaGetLastError());
}

// Windows (roll = 0) and roll (roll = 1): the plan from mosaic_support.py's
// gather_plan, EPT (outputs a thread) 1 or 2.
int ljmd_probe_gather(const int* offs, const float* x, float* out, int iters, int scale,
                      int roll, int n_sl, int sl_stride, int ld, int len, int count, int ept,
                      void* stream) {
  using KernelFn = void (*)(const int*, const float*, float*, int, int, int, int, int, int, int);
  KernelFn fn = nullptr;
  if (roll && ept == 1) fn = ljmd::probe_gather_kernel<true, 1>;
  if (!roll && ept == 1) fn = ljmd::probe_gather_kernel<false, 1>;
  if (!roll && ept == 2) fn = ljmd::probe_gather_kernel<false, 2>;
  if (!fn || len < 1 || count < 1 || n_sl < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(len) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(fn),
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int per_block = ljmd::kGatherThreads * ept;
  const int n_jb = (count + per_block - 1) / per_block;
  fn<<<n_sl * n_jb, ljmd::kGatherThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      offs, x, out, iters, scale, n_jb, sl_stride, ld, len, count);
  return static_cast<int>(cudaGetLastError());
}

int ljmd_probe_rowsum(const float* x, float* out, int rows, int width, int iters, int store,
                      void* stream) {
  if (width % 32 || width > 32 * ljmd::kRowPerLane) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (store) {
    ljmd::probe_rowsum_kernel<true><<<rows, 32, 0, s>>>(x, out, rows, width, iters);
  } else {
    ljmd::probe_rowsum_kernel<false><<<rows, 32, 0, s>>>(x, out, rows, width, iters);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
