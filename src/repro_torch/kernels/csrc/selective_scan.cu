// Hand-written CUDA selective scan (the Mamba-1 recurrence) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel in src/repro/kernels/selective_scan/kernel.py:
//   scan_kernel  <-  selective_scan_tpu (:99; _scan_kernel :65, pallas_call :130)
//
// For every batch row b and channel d of d_inner, over time t:
//   h_t[n] = exp(dt_t * A[d, n]) * h_{t-1}[n] + (dt_t * u_t) * B_t[n]
//   y_t    = sum_n C_t[n] * h_t[n] + D[d] * u_t
// from h_{-1} = h0 (or zeros); it returns y (Ba, S, Di) in u's dtype and the
// last state h_last (Ba, Di, N) in fp32.  The state is fp32 throughout.
//
// Design.  The TPU kernel walks a (batch, Di/BD, S/CHUNK) grid in order and
// carries the (BD, N) state in VMEM scratch from one time chunk to the next.
// Blocks on the card run in no order, so nothing may carry between them:
// here one thread owns one (b, d) channel for the whole sequence and keeps
// its N states (and its row of A) in registers.  A block holds CHANNELS
// consecutive channels of one batch row, grid (ceil(Di / CHANNELS), Ba).  The
// block walks time in tiles of TILE steps: it stages the tile's B_t and C_t
// (N fp32 each, shared by every channel of the row) in shared memory, where
// every thread reads the same word (a broadcast); each thread holds the
// tile's u and dt of its channel in registers, loaded one tile ahead so the
// loads of the next tile are in flight while this one is computed.  u, dt
// and y are read and written by neighbouring threads at neighbouring
// addresses.  The ragged edges are masked, not padded: channels >= Di never
// load or store, steps >= S are never computed (the TPU wrapper pads both,
// kernel.py:116-128).  h0 starts the registers, so a resumed scan needs no
// detour to a plain version (the TPU wrapper takes one, kernel.py:107-109).
//
// What bounds it on an H100.  Per (b, t, d) it reads u and dt and writes y
// (10 bytes with bf16 u), and computes N exponentials and about 4N
// multiplies and adds.  At the serving shape (Ba 2, S 512, Di 16384, N 16)
// that is ~138 MB (41 us at 3.35 TB/s) against 268 M exponentials (64 us
// at 16 a clock on each of 132 SMs, 1.98 GHz): the exponentials bound it,
// then the bytes.  This first design has Ba * Di threads (32 K at Ba 2) and a
// sequential dependency per step; splitting time in two passes to fill the
// card is later work.
//
// The entry point returns cudaGetLastError() after its launch; the Python
// wrapper raises on anything nonzero, since a refused launch never runs.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int CHANNELS = 128;   // channels (threads) per block
constexpr int TILE = 16;        // time steps per staged tile

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

struct ScanArgs {
  const void* u; long long u_sb, u_st;      // (Ba, S, Di), Di contiguous
  const float* dt; long long dt_sb, dt_st;  // (Ba, S, Di), Di contiguous
  const float* A;                           // (Di, N) contiguous
  const float* B; long long b_sb, b_st;     // (Ba, S, N), N contiguous
  const float* C; long long c_sb, c_st;     // (Ba, S, N), N contiguous
  const float* D;                           // (Di,)
  const float* h0;                          // (Ba, Di, N) contiguous, or null
  void* y;                                  // (Ba, S, Di) contiguous
  float* h_last;                            // (Ba, Di, N) contiguous
  int S, Di;
};

// The u and dt of one channel for steps t0 .. t0 + TILE - 1 (zero past S).
template <typename T>
__device__ __forceinline__ void load_tile(const T* u, long long u_st,
                                          const float* dt, long long dt_st,
                                          int t0, int S, bool live,
                                          float (&ur)[TILE],
                                          float (&dr)[TILE]) {
#pragma unroll
  for (int j = 0; j < TILE; ++j) {
    const int t = t0 + j;
    const bool in = live && t < S;
    ur[j] = in ? to_float(u[t * u_st]) : 0.f;
    dr[j] = in ? dt[t * dt_st] : 0.f;
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(CHANNELS)
scan_kernel(ScanArgs a) {
  __shared__ float Bs[TILE][N];
  __shared__ float Cs[TILE][N];
  const int b = blockIdx.y;
  const int d = blockIdx.x * CHANNELS + threadIdx.x;
  const bool live = d < a.Di;
  const long long dl = live ? d : 0;        // never dereferenced when dead
  const T* u = static_cast<const T*>(a.u) + b * a.u_sb + dl;
  const float* dt = a.dt + b * a.dt_sb + dl;
  const float* Bp = a.B + b * a.b_sb;
  const float* Cp = a.C + b * a.c_sb;
  T* y = static_cast<T*>(a.y) + static_cast<long long>(b) * a.S * a.Di + dl;
  const long long hrow = (static_cast<long long>(b) * a.Di + dl) * N;

  float A[N], h[N];
  float Dv = 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    A[n] = live ? a.A[dl * N + n] : 0.f;
    h[n] = (live && a.h0 != nullptr) ? a.h0[hrow + n] : 0.f;
  }
  if (live) Dv = a.D[dl];

  float ur[TILE], dr[TILE];
  load_tile(u, a.u_st, dt, a.dt_st, 0, a.S, live, ur, dr);
  for (int t0 = 0; t0 < a.S; t0 += TILE) {
    __syncthreads();                         // the last tile's readers are done
    for (int i = threadIdx.x; i < TILE * N; i += CHANNELS) {
      const int j = i / N, n = i % N, t = t0 + j;
      Bs[j][n] = t < a.S ? Bp[t * a.b_st + n] : 0.f;
      Cs[j][n] = t < a.S ? Cp[t * a.c_st + n] : 0.f;
    }
    __syncthreads();
    float un[TILE], dn[TILE];                // the next tile, in flight
    load_tile(u, a.u_st, dt, a.dt_st, t0 + TILE, a.S, live, un, dn);
    if (live) {
#pragma unroll
      for (int j = 0; j < TILE; ++j) {
        if (t0 + j < a.S) {
          const float dtv = dr[j];
          const float du = dtv * ur[j];
          float acc = 0.f;
#pragma unroll
          for (int n = 0; n < N; ++n) {
            h[n] = expf(dtv * A[n]) * h[n] + du * Bs[j][n];
            acc = fmaf(h[n], Cs[j][n], acc);
          }
          y[static_cast<long long>(t0 + j) * a.Di] =
              from_float<T>(acc + ur[j] * Dv);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      ur[j] = un[j];
      dr[j] = dn[j];
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) a.h_last[hrow + n] = h[n];
  }
}

template <typename T, int N>
int launch(const ScanArgs& a, int ba, cudaStream_t stream) {
  const dim3 grid((a.Di + CHANNELS - 1) / CHANNELS, ba);
  scan_kernel<T, N><<<grid, CHANNELS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_n(const ScanArgs& a, int ba, int n, cudaStream_t stream) {
  switch (n) {
    case 4: return launch<T, 4>(a, ba, stream);
    case 8: return launch<T, 8>(a, ba, stream);
    case 16: return launch<T, 16>(a, ba, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// u: (Ba, S, Di) with strides (u_sb, u_st, 1), dtype 0 fp32 / 1 bf16; dt:
// fp32 with strides (dt_sb, dt_st, 1); A: (Di, N) contiguous fp32; B, C:
// (Ba, S, N) fp32 with strides (sb, st, 1); D: (Di,) fp32; h0: contiguous
// (Ba, Di, N) fp32 or null (zeros); y: contiguous (Ba, S, Di) in u's dtype;
// h_last: contiguous (Ba, Di, N) fp32.  N is 4, 8 or 16.
int repro_selective_scan(const void* u, long long u_sb, long long u_st,
                         int u_dtype, const void* dt, long long dt_sb,
                         long long dt_st, const void* A, const void* B,
                         long long b_sb, long long b_st, const void* C,
                         long long c_sb, long long c_st, const void* D,
                         const void* h0, void* y, void* h_last, int ba,
                         int s, int di, int n, void* stream) {
  ScanArgs a;
  a.u = u; a.u_sb = u_sb; a.u_st = u_st;
  a.dt = static_cast<const float*>(dt); a.dt_sb = dt_sb; a.dt_st = dt_st;
  a.A = static_cast<const float*>(A);
  a.B = static_cast<const float*>(B); a.b_sb = b_sb; a.b_st = b_st;
  a.C = static_cast<const float*>(C); a.c_sb = c_sb; a.c_st = c_st;
  a.D = static_cast<const float*>(D);
  a.h0 = static_cast<const float*>(h0);
  a.y = y;
  a.h_last = static_cast<float*>(h_last);
  a.S = s; a.Di = di;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (u_dtype == 0) return launch_n<float>(a, ba, n, st);
  if (u_dtype == 1) return launch_n<__nv_bfloat16>(a, ba, n, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
