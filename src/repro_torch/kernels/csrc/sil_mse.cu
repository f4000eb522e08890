// Hand-written CUDA fused SIL-MSE loss and activation gradient for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel in src/repro/kernels/sil_mse/kernel.py:
//   sil_mse_rows + sil_mse_finish  <-  sil_mse_fwd_tpu (_sil_kernel, :61 -> :108)
//
// It computes, in one pass over act (T, d):
//   loss       = sum_t sum_i (act[t, i] - SIL[i, y_t])^2 / (T * d)     (fp32)
//   grad[t, i] = 2 / (T * d) * (act[t, i] - SIL[i, y_t])    (act's dtype)
// The gathered (T, d) target is never written to memory: each row reads the
// SIL column its label selects, straight from the table.
//
// What bounds it on an H100, and what the design does about it:
// * bytes.  Per element it reads act and one SIL value and writes the grad,
//   with three flops, far below the card's balance point.  Each warp owns one
//   row of T (a block holds ROWS rows); its lanes walk the d columns, so act,
//   grad and -- when the table is laid out (M, d), as the trainer holds it --
//   the target row are read and written by neighbouring threads at
//   neighbouring addresses.  The table is read through its two strides, so
//   the natural (d, M) layout works too, uncoalesced.
// * no padding copy: rows >= T are never started and columns >= d never
//   touched, so T and d need not be multiples of anything (the Pallas
//   wrapper pads both, kernel.py:93-96).
// * a deterministic loss.  Blocks run in no order, so each block writes the
//   sum of its rows (warp shuffles, then a fixed loop over its warps) to a
//   partial buffer, and a second one-block kernel sums the partials in a
//   fixed order and divides by T * d.  No float atomicAdd: the same inputs
//   give the same bits every run.
// * the label index is guarded on the card (the wrapper never syncs to
//   check it): a label outside [0, M) reads nothing and gives a NaN grad row
//   and a NaN loss, so the fault shows instead of reading out of bounds.
//
// Differencing and accumulation are fp32 whatever act's dtype.  The entry
// point returns cudaGetLastError() after its launches; the Python wrapper
// raises on anything nonzero, since a refused launch never runs.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 8;               // rows (warps) per block
constexpr int THREADS = 32 * ROWS;
constexpr int FINISH_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

template <typename T, typename L>
__global__ void __launch_bounds__(THREADS)
sil_mse_rows(const T* __restrict__ act, long long s_act,
             const float* __restrict__ sil, long long s_d, long long s_m,
             const L* __restrict__ labels, T* __restrict__ grad,
             float* __restrict__ partial, int n_rows, int d, int m,
             float scale) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS + warp;
  float acc = 0.f;
  if (row < n_rows) {
    const long long y = static_cast<long long>(labels[row]);
    const T* a = act + static_cast<long long>(row) * s_act;
    T* g = grad + static_cast<long long>(row) * d;
    if (y < 0 || y >= m) {
      const float nan = __int_as_float(0x7fc00000);
      for (int i = lane; i < d; i += 32) g[i] = from_float<T>(nan);
      acc = nan;
    } else {
      const float* tgt = sil + y * s_m;
      for (int i = lane; i < d; i += 32) {
        const float diff = to_float(a[i]) - tgt[i * s_d];
        acc = fmaf(diff, diff, acc);
        g[i] = from_float<T>(scale * diff);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
  __shared__ float per_warp[ROWS];
  if (lane == 0) per_warp[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < ROWS; ++w) s += per_warp[w];
    partial[blockIdx.x] = s;
  }
}

// One block: thread t sums partials t, t + 1024, ... in order, then a fixed
// tree over the block; loss = total / (T * d).
__global__ void __launch_bounds__(FINISH_THREADS)
sil_mse_finish(const float* __restrict__ partial, int n, float denom,
               float* __restrict__ loss) {
  __shared__ float sh[FINISH_THREADS];
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += FINISH_THREADS) s += partial[i];
  sh[threadIdx.x] = s;
  __syncthreads();
  for (int w = FINISH_THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) sh[threadIdx.x] += sh[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) loss[0] = sh[0] / denom;
}

template <typename T, typename L>
int launch(const void* act, long long s_act, const float* sil, long long s_d,
           long long s_m, const void* labels, void* grad, float* partial,
           float* loss, int n_rows, int d, int m, cudaStream_t stream) {
  const int blocks = (n_rows + ROWS - 1) / ROWS;
  const float denom = static_cast<float>(static_cast<double>(n_rows) * d);
  sil_mse_rows<T, L><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(act), s_act, sil, s_d, s_m,
      static_cast<const L*>(labels), static_cast<T*>(grad), partial, n_rows,
      d, m, 2.0f / denom);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sil_mse_finish<<<1, FINISH_THREADS, 0, stream>>>(partial, blocks, denom,
                                                    loss);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The number of floats the partial buffer must hold for T rows.
int repro_sil_mse_blocks(int n_rows) { return (n_rows + ROWS - 1) / ROWS; }

// act: (T, d) rows with stride s_act (columns contiguous), dtype 0 fp32 /
// 1 bf16; sil: fp32, element (i, j) at sil[i * s_d + j * s_m]; labels: (T,)
// contiguous int32 (label_bytes 4) or int64 (8); grad: contiguous (T, d) in
// act's dtype; partial: repro_sil_mse_blocks(T) floats; loss: one float.
int repro_sil_mse(const void* act, long long s_act, const void* sil,
                  long long s_d, long long s_m, const void* labels,
                  int label_bytes, void* grad, void* partial, void* loss,
                  int dtype, int n_rows, int d, int m, void* stream) {
  const float* s = static_cast<const float*>(sil);
  float* p = static_cast<float*>(partial);
  float* l = static_cast<float*>(loss);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && label_bytes == 4)
    return launch<float, int32_t>(act, s_act, s, s_d, s_m, labels, grad, p, l,
                                  n_rows, d, m, st);
  if (dtype == 0 && label_bytes == 8)
    return launch<float, int64_t>(act, s_act, s, s_d, s_m, labels, grad, p, l,
                                  n_rows, d, m, st);
  if (dtype == 1 && label_bytes == 4)
    return launch<__nv_bfloat16, int32_t>(act, s_act, s, s_d, s_m, labels,
                                          grad, p, l, n_rows, d, m, st);
  if (dtype == 1 && label_bytes == 8)
    return launch<__nv_bfloat16, int64_t>(act, s_act, s, s_d, s_m, labels,
                                          grad, p, l, n_rows, d, m, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
