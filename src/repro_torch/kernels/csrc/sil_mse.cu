// Hand-written CUDA fused SIL-MSE loss and activation gradient for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel in src/repro/kernels/sil_mse/kernel.py:
//   sil_mse_kernel  <-  sil_mse_fwd_tpu (_sil_kernel, :61 -> :108)
//
// It computes, in one pass over act (T, d) and in one launch:
//   loss       = sum_t sum_i (act[t, i] - SIL[i, y_t])^2 / (T * d)     (fp32)
//   grad[t, i] = 2 / (T * d) * (act[t, i] - SIL[i, y_t])    (act's dtype)
// The gathered (T, d) target is never written to memory: each row reads the
// SIL column its label selects, straight from the table.
//
// What bounds it on an H100, and what the design does about it:
// * bytes.  Per element it reads act and one SIL value and writes the grad,
//   with three flops, far below the card's balance point.  A row is split
//   over `lanes` neighbouring lanes (a power of two up to a warp, as many as
//   the row has units), so act, grad and -- when the table is laid out
//   (M, d), as the trainer holds it -- the target row are moved by
//   neighbouring threads at neighbouring addresses.  Where the tensors allow
//   it (the wrapper's vector_loads: 16-byte aligned act rows and table rows,
//   d a multiple of the unit) a unit is 16 bytes of act (4 fp32 or 8 bf16),
//   the 16 or 32 bytes of table under it and 16 bytes of grad; each lane
//   issues up to UNITS units' loads before their first use, so that a row's
//   bytes are all in flight at once.  Otherwise a unit is one column and the
//   table is read through its two strides, so the natural (d, M) layout and
//   unaligned or odd-width views work too, at a lower rate.
// * one launch for a deterministic loss.  A fixed grid (the wrapper's
//   sil_plan: at most a few blocks an SM) strides over the rows in an order
//   that depends only on T and the plan.  Each block writes the sum of its
//   threads' sums (a fixed tree) to its partial, fences, and draws a ticket;
//   the block that draws the last one fences again (acquire), sums the
//   partials in a fixed order after a barrier, writes the loss and puts the
//   ticket counter back to zero for the next launch.  No float atomicAdd: the same inputs give the same bits on the
//   same card.  The counter and the partials live in a workspace the wrapper
//   keeps per (device, stream), so launches on two streams never share one.
// * no padding copy: rows >= T are never started and columns >= d never
//   touched (the Pallas wrapper pads both, kernel.py:93-96).
// * the label index is guarded on the card (the wrapper never syncs to
//   check it): a label outside [0, M) reads no table and gives a NaN grad
//   row and a NaN loss, so the fault shows instead of reading out of bounds.
//
// Differencing and accumulation are fp32 whatever act's dtype.  The entry
// point returns cudaGetLastError() after its launch; the Python wrapper
// raises on anything nonzero, since a refused launch never runs.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;          // a block
constexpr int UNITS = 8;              // units a lane loads before their use
constexpr int WS_HEAD = 4;            // workspace words before the partials
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// 16 bytes of act as floats, and floats back to 16 bytes of grad
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x); f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z); f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ float2 bf2(unsigned w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
  const float2 a = bf2(r.x), b = bf2(r.y), c = bf2(r.z), d = bf2(r.w);
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
  f[4] = c.x; f[5] = c.y; f[6] = d.x; f[7] = d.y;
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ unsigned bf2w(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(bf2w(f[0], f[1]), bf2w(f[2], f[3]), bf2w(f[4], f[5]),
                    bf2w(f[6], f[7]));
}

// One lane's share of a row on the 16-byte path: units lane, lane + lanes,
// ... of nu, UNITS at a time, every load of a chunk issued before the first
// use.  tgt == nullptr marks an out-of-range label: NaN in place of the
// table.
template <typename T>
__device__ __forceinline__ void row_vec(const T* x, const float* tgt, T* g,
                                        int nu, int lane, int lanes,
                                        float scale, float& acc) {
  constexpr int C = 16 / sizeof(T);          // columns a unit
  constexpr int TV = C / 4;                  // 16-byte table loads a unit
  const float nan = __int_as_float(0x7fc00000);
  for (int u0 = lane; u0 < nu; u0 += UNITS * lanes) {
    uint4 ra[UNITS];
    float4 rt[UNITS][TV];
#pragma unroll
    for (int k = 0; k < UNITS; ++k) {
      const int u = u0 + k * lanes;
      if (u < nu) ra[k] = __ldg(reinterpret_cast<const uint4*>(x) + u);
    }
#pragma unroll
    for (int k = 0; k < UNITS; ++k) {
      const int u = u0 + k * lanes;
#pragma unroll
      for (int j = 0; j < TV; ++j)
        rt[k][j] = (u < nu && tgt != nullptr)
            ? __ldg(reinterpret_cast<const float4*>(tgt) + u * TV + j)
            : make_float4(nan, nan, nan, nan);
    }
#pragma unroll
    for (int k = 0; k < UNITS; ++k) {
      const int u = u0 + k * lanes;
      if (u < nu) {
        float a[C], o[C];
        unpack(ra[k], a);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float4& t4 = rt[k][c / 4];
          const float t = (c % 4 == 0) ? t4.x : (c % 4 == 1) ? t4.y
                          : (c % 4 == 2) ? t4.z : t4.w;
          const float diff = a[c] - t;
          acc = fmaf(diff, diff, acc);
          o[c] = scale * diff;
        }
        reinterpret_cast<uint4*>(g)[u] = pack(o);
      }
    }
  }
}

// The same a column at a time, the table read through its strides.
template <typename T>
__device__ __forceinline__ void row_scalar(const T* x, const float* tgt,
                                           long long s_d, T* g, int d,
                                           int lane, int lanes, float scale,
                                           float& acc) {
  const float nan = __int_as_float(0x7fc00000);
  for (int u0 = lane; u0 < d; u0 += UNITS * lanes) {
    T ra[UNITS];
    float rt[UNITS];
#pragma unroll
    for (int k = 0; k < UNITS; ++k) {
      const int u = u0 + k * lanes;
      if (u < d) ra[k] = x[u];
    }
#pragma unroll
    for (int k = 0; k < UNITS; ++k) {
      const int u = u0 + k * lanes;
      rt[k] = (u < d && tgt != nullptr) ? tgt[u * s_d] : nan;
    }
#pragma unroll
    for (int k = 0; k < UNITS; ++k) {
      const int u = u0 + k * lanes;
      if (u < d) {
        const float diff = to_float(ra[k]) - rt[k];
        acc = fmaf(diff, diff, acc);
        g[u] = from_float<T>(scale * diff);
      }
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The block's sum of v in a fixed order: a shuffle tree in each warp, then
// the warps in order.  Every thread of the block must call it.
__device__ __forceinline__ float block_sum(float v, float* per_warp) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) per_warp[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += per_warp[w];
  __syncthreads();                  // per_warp may be written again
  return s;
}

// Thread i of block b holds column lanes i % lanes of row
// (b + k * gridDim.x) * (THREADS / lanes) + i / lanes, k = 0, 1, ...
template <typename T, typename L, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
sil_mse_kernel(const T* __restrict__ act, long long s_act,
               const float* __restrict__ sil, long long s_d, long long s_m,
               const L* __restrict__ labels, T* __restrict__ grad,
               float* __restrict__ loss, unsigned* __restrict__ ws,
               int n_rows, int d, int m, int lane_shift, float scale,
               float denom) {
  __shared__ float per_warp[WARPS];
  __shared__ bool last;
  unsigned* counter = ws;
  float* partial = reinterpret_cast<float*>(ws + WS_HEAD);
  const int lanes = 1 << lane_shift;
  const int lane = threadIdx.x & (lanes - 1);
  const long long rows = THREADS >> lane_shift;
  float acc = 0.f;
  for (long long row = blockIdx.x * rows + (threadIdx.x >> lane_shift);
       row < n_rows; row += gridDim.x * rows) {
    const long long y = static_cast<long long>(labels[row]);
    const float* tgt = (y < 0 || y >= m) ? nullptr : sil + y * s_m;
    const T* x = act + row * s_act;
    T* g = grad + row * d;
    if constexpr (VEC)
      row_vec<T>(x, tgt, g, d / (16 / static_cast<int>(sizeof(T))), lane,
                 lanes, scale, acc);
    else
      row_scalar<T>(x, tgt, s_d, g, d, lane, lanes, scale, acc);
  }

  const float s = block_sum(acc, per_warp);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = s;
    __threadfence();                // the partial is out before the ticket
    const bool is_last = atomicAdd(counter, 1u) == gridDim.x - 1;
    if (is_last) __threadfence();   // and every other block's is in, for
    last = is_last;                 // the whole block past the barrier
  }
  __syncthreads();
  if (!last) return;
  float t = 0.f;
  for (int i = threadIdx.x; i < gridDim.x; i += THREADS)
    t += __ldcg(partial + i);
  t = block_sum(t, per_warp);
  if (threadIdx.x == 0) {
    loss[0] = t / denom;
    *counter = 0u;                  // ready for the next launch
  }
}

template <typename T, typename L, bool VEC>
int launch(const void* act, long long s_act, const float* sil, long long s_d,
           long long s_m, const void* labels, void* grad, float* loss,
           unsigned* ws, int n_rows, int d, int m, int lane_shift,
           int blocks, cudaStream_t stream) {
  const float denom = static_cast<float>(static_cast<double>(n_rows) * d);
  sil_mse_kernel<T, L, VEC><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(act), s_act, sil, s_d, s_m,
      static_cast<const L*>(labels), static_cast<T*>(grad), loss, ws, n_rows,
      d, m, lane_shift, 2.0f / denom, denom);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename L>
int launch_path(int vec, const void* act, long long s_act, const float* sil,
                long long s_d, long long s_m, const void* labels, void* grad,
                float* loss, unsigned* ws, int n_rows, int d, int m,
                int lane_shift, int blocks, cudaStream_t stream) {
  return vec ? launch<T, L, true>(act, s_act, sil, s_d, s_m, labels, grad,
                                  loss, ws, n_rows, d, m, lane_shift, blocks,
                                  stream)
             : launch<T, L, false>(act, s_act, sil, s_d, s_m, labels, grad,
                                   loss, ws, n_rows, d, m, lane_shift, blocks,
                                   stream);
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// act: (T, d) rows with stride s_act (columns contiguous); sil: fp32,
// element (i, j) at sil[i * s_d + j * s_m]; labels: (T,) contiguous; grad:
// contiguous (T, d) in act's dtype; loss: one float; ws: WS_HEAD words (the
// ticket counter first, zero between launches) then `blocks` partials.
// variant: bit 0 act bf16 (else fp32), bit 1 int64 labels (else int32),
// bit 2 the 16-byte path.  lane_shift: log2 of the lanes a row; blocks: the
// grid (sil_plan).
int repro_sil_mse(const void* act, long long s_act, const void* sil,
                  long long s_d, long long s_m, const void* labels,
                  void* grad, void* loss, void* ws, int variant, int n_rows,
                  int d, int m, int lane_shift, int blocks, void* stream) {
  const float* s = static_cast<const float*>(sil);
  float* l = static_cast<float*>(loss);
  unsigned* w = static_cast<unsigned*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = (variant >> 2) & 1;
  switch (variant & 3) {
    case 0:
      return launch_path<float, int32_t>(vec, act, s_act, s, s_d, s_m, labels,
                                         grad, l, w, n_rows, d, m, lane_shift,
                                         blocks, st);
    case 2:
      return launch_path<float, int64_t>(vec, act, s_act, s, s_d, s_m, labels,
                                         grad, l, w, n_rows, d, m, lane_shift,
                                         blocks, st);
    case 1:
      return launch_path<__nv_bfloat16, int32_t>(vec, act, s_act, s, s_d, s_m,
                                                 labels, grad, l, w, n_rows,
                                                 d, m, lane_shift, blocks, st);
    default:
      return launch_path<__nv_bfloat16, int64_t>(vec, act, s_act, s, s_d, s_m,
                                                 labels, grad, l, w, n_rows,
                                                 d, m, lane_shift, blocks, st);
  }
}

// An empty kernel of `blocks` x `threads`: the floor any launch of that grid
// shows in a profile, timed beside the SIL-MSE kernel by chip_smoke.py.
int repro_empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
