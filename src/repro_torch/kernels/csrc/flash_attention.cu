// Hand-written CUDA attention kernels for Hopper (sm_90a): prefill flash
// attention, single-token decode over a contiguous (possibly ring) cache,
// and single-token decode over a block-paged cache.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/flash_attention/kernel.py:
//   prefill_kernel  <- flash_attention_tpu        (_flash_kernel, :152 -> :223)
//   decode_kernel   <- decode_attention_tpu       (_decode_kernel, :236 -> :304)
//                   <- paged_decode_attention_tpu (_paged_decode_kernel, :316 -> :366)
//
// Semantics follow repro/kernels/flash_attention/ref.py, not the Pallas
// causal mask: queries are aligned to the END of the keys (qpos = i + Sk - Sq),
// a row whose every key is masked returns 0 (never NaN), Q is scaled by D^-0.5
// before Q.K^T, and softmax state (m, l, acc) and P.V accumulate in fp32.
//
// What bounds them on an H100, and what the design does about it:
// * prefill: operations for long prompts (4*S^2*H*D/2 causal FLOPs against
//   B*S*(H+2KV)*D bytes).  This first version runs the products on the CUDA
//   cores in fp32 (no wgmma yet): each 128-thread block owns a 64-row query
//   tile of one (b, head), keeps Q and the current 64-key K/V tile in dynamic
//   shared memory (115 KB at D=128, above the 48 KB static limit, hence
//   cudaFuncSetAttribute), holds a 4x8 score tile and a 4x(D/8) output tile
//   per thread in registers, and skips key tiles wholly past the causal edge
//   or wholly before the sliding window.  Strides are read from the caller,
//   so the (B, S, H, D) layout needs no transpose or pad.
// * decode and paged decode: bytes (the K/V cache is read once per step and
//   reused by all G query heads of its KV head, so one block per (b, kv head)
//   carries all G heads).  Both walk the cache in 16-slot tiles; the only
//   difference is where a tile lives (b * s_b + t * 16 * s_l contiguous,
//   block_tables[b, t] * s_page paged, the table read by the block itself).
//   The float operations therefore run in the same order and paged equals
//   contiguous bitwise.  Tiles past pos are wholly masked and skipped (their
//   online-softmax update is the identity).
//
// Every entry point returns cudaGetLastError() after its launch; the Python
// wrapper raises on anything nonzero, since a refused launch never runs.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) { return __float2bfloat16(x); }
template <> __device__ __forceinline__ __half from_float<__half>(float x) { return __float2half(x); }

constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------------------
// prefill
// ---------------------------------------------------------------------------

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // keys per shared-memory tile
constexpr int PNT = 128;  // threads: 16 row groups (4 rows) x 8 column lanes

template <int D>
constexpr size_t prefill_smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(PNT) prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Sq, int Sk, int H, int KV,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh,
    int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                  // BQ x (D+1), pre-scaled
  float* Ks = Qs + BQ * (D + 1);     // BK x (D+1)
  float* Vs = Ks + BK * (D + 1);     // BK x D
  float* Ps = Vs + BK * D;           // BQ x (BK+1)

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8;
  const int off = Sk - Sq;           // queries aligned to the end of the keys
  const int q0 = qt * BQ;
  constexpr int DJ = D / 8;          // output columns per thread

  const T* qb = q + (long long)b * qsb + (long long)h * qsh;
  const T* kb = k + (long long)b * ksb + (long long)kvh * ksh;
  const T* vb = v + (long long)b * vsb + (long long)kvh * vsh;

  for (int i = tid; i < BQ * D; i += PNT) {
    const int r = i / D, d = i % D, qr = q0 + r;
    Qs[r * (D + 1) + d] = qr < Sq ? to_float(qb[(long long)qr * qss + d]) * scale : 0.f;
  }

  int kt_end = (Sk + BK - 1) / BK;
  if (causal) {
    const int maxq = min(q0 + BQ, Sq) - 1 + off;   // last key any row may see
    kt_end = maxq < 0 ? 0 : min(kt_end, maxq / BK + 1);
  }
  int kt_begin = 0;
  if (window) {
    const int lo = q0 + off - window + 1;          // first key the top row may see
    kt_begin = lo > 0 ? lo / BK : 0;
  }

  float m_r[4], l_r[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_r[i] = -INFINITY;
    l_r[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    __syncthreads();
    for (int i = tid; i < BK * D; i += PNT) {
      const int c = i / D, d = i % D, kr = kt * BK + c;
      const bool ok = kr < Sk;
      Ks[c * (D + 1) + d] = ok ? to_float(kb[(long long)kr * kss + d]) : 0.f;
      Vs[c * D + d] = ok ? to_float(vb[(long long)kr * vss + d]) : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Ks[(tx + 8 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i;
      const int qpos = q0 + row + off;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = kt * BK + tx + 8 * j;
        bool valid = kpos < Sk;
        if (causal) valid = valid && kpos <= qpos;
        if (window) valid = valid && kpos > qpos - window;
        if (!valid) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 4; w >= 1; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, w, 8));
      const float m_new = fmaxf(m_r[i], mx);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_safe);
        Ps[row * (BK + 1) + tx + 8 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int w = 4; w >= 1; w >>= 1) sum += __shfl_xor_sync(FULL, sum, w, 8);
      const float corr = m_r[i] == -INFINITY ? 0.f : expf(m_r[i] - m_safe);
      l_r[i] = l_r[i] * corr + sum;
      m_r[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = Vs[c * D + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  T* ob = o + (long long)b * osb + (long long)h * osh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Sq) continue;
    const float inv_l = 1.f / fmaxf(l_r[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      ob[(long long)r * oss + tx + 8 * j] = from_float<T>(acc[i][j] * inv_l);
  }
}

template <typename T, int D>
cudaError_t launch_prefill(const void* q, const void* k, const void* v, void* o,
                           int B, int Sq, int Sk, int H, int KV,
                           const long long* st, int causal, int window,
                           float scale, cudaStream_t stream) {
  const size_t smem = prefill_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      prefill_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  prefill_kernel<T, D><<<grid, PNT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Sq, Sk, H, KV,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], causal, window, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// decode (contiguous and paged share one body)
// ---------------------------------------------------------------------------

constexpr int TILE = 16;  // cache slots per tile == the paged block size
constexpr int MAXG = 8;   // query heads per KV head
constexpr int DNT = 128;

template <typename T, int D>
__global__ void __launch_bounds__(DNT) decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, const int* __restrict__ pos,
    const int* __restrict__ block_tables, int H, int KV, int lc, int nb,
    long long s_b, long long s_page, long long s_l, long long s_kv, float scale) {
  __shared__ float Qs[MAXG][D];
  __shared__ float Ks[TILE][D + 1];
  __shared__ float Vs[TILE][D];
  __shared__ float Ps[MAXG][TILE];
  __shared__ float Cs[MAXG];
  __shared__ float Ls[MAXG];
  constexpr int CPT = (D + DNT - 1) / DNT;

  const int kvh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int G = H / KV;
  const T* qb = q + ((long long)b * H + (long long)kvh * G) * D;   // (B, 1, H, D)
  for (int i = tid; i < G * D; i += DNT) Qs[i / D][i % D] = to_float(qb[i]) * scale;

  const int p = pos[b];
  const int ntiles = (lc + TILE - 1) / TILE;
  const int last = p < 0 ? -1 : min(ntiles - 1, p / TILE);
  const int g = tid / TILE, c = tid % TILE;
  const bool act = g < G;

  float m_run = -INFINITY, l_run = 0.f;   // replicated over the 16 lanes of head g
  float acc[MAXG][CPT];
#pragma unroll
  for (int gg = 0; gg < MAXG; ++gg)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[gg][j] = 0.f;

  for (int t = 0; t <= last; ++t) {
    const long long base = block_tables
        ? (long long)block_tables[(long long)b * nb + t] * s_page
        : (long long)b * s_b + (long long)t * TILE * s_l;
    __syncthreads();
    for (int i = tid; i < TILE * D; i += DNT) {
      const int cc = i / D, d = i % D, slot = t * TILE + cc;
      const bool ok = slot < lc && slot <= p;
      const long long a = base + (long long)cc * s_l + (long long)kvh * s_kv + d;
      Ks[cc][d] = ok ? to_float(k[a]) : 0.f;
      Vs[cc][d] = ok ? to_float(v[a]) : 0.f;
    }
    __syncthreads();

    const int slot = t * TILE + c;
    const bool valid = act && slot < lc && slot <= p;
    float s = -INFINITY;
    if (valid) {
      float a = 0.f;
      for (int d = 0; d < D; ++d) a = fmaf(Qs[g][d], Ks[c][d], a);
      s = a;
    }
    float mx = s;
#pragma unroll
    for (int w = 8; w >= 1; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, w, 16));
    const float m_new = fmaxf(m_run, mx);
    const float m_safe = m_new == -INFINITY ? 0.f : m_new;
    const float pr = valid ? expf(s - m_safe) : 0.f;
    float sum = pr;
#pragma unroll
    for (int w = 8; w >= 1; w >>= 1) sum += __shfl_xor_sync(FULL, sum, w, 16);
    const float corr = m_run == -INFINITY ? 0.f : expf(m_run - m_safe);
    l_run = l_run * corr + sum;
    m_run = m_new;
    if (act) {
      Ps[g][c] = pr;
      if (c == 0) Cs[g] = corr;
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int d = tid + j * DNT;
      if (d >= D) continue;
#pragma unroll
      for (int gg = 0; gg < MAXG; ++gg) {
        if (gg >= G) break;
        float pv = 0.f;
#pragma unroll
        for (int cc = 0; cc < TILE; ++cc) pv = fmaf(Ps[gg][cc], Vs[cc][d], pv);
        acc[gg][j] = acc[gg][j] * Cs[gg] + pv;
      }
    }
  }

  __syncthreads();
  if (act && c == 0) Ls[g] = l_run;
  __syncthreads();
  T* ob = o + ((long long)b * H + (long long)kvh * G) * D;
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int d = tid + j * DNT;
    if (d >= D) continue;
#pragma unroll
    for (int gg = 0; gg < MAXG; ++gg) {
      if (gg >= G) break;
      ob[gg * D + d] = from_float<T>(acc[gg][j] / fmaxf(Ls[gg], 1e-30f));
    }
  }
}

template <typename T, int D>
cudaError_t launch_decode(const void* q, const void* k, const void* v, void* o,
                          const void* pos, const void* bt, int B, int H, int KV,
                          int lc, int nb, long long s_b, long long s_page,
                          long long s_l, long long s_kv, float scale,
                          cudaStream_t stream) {
  dim3 grid(KV, B);
  decode_kernel<T, D><<<grid, DNT, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (const int*)pos,
      (const int*)bt, H, KV, lc, nb, s_b, s_page, s_l, s_kv, scale);
  return cudaGetLastError();
}

// dtype codes shared with kernel.py: 0 float32, 1 bfloat16, 2 float16
#define DISPATCH(DTYPE, D, FN, ...)                                         \
  switch (DTYPE * 1000 + D) {                                               \
    case 64: return (int)FN<float, 64>(__VA_ARGS__);                             \
    case 128: return (int)FN<float, 128>(__VA_ARGS__);                           \
    case 256: return (int)FN<float, 256>(__VA_ARGS__);                           \
    case 1064: return (int)FN<__nv_bfloat16, 64>(__VA_ARGS__);                   \
    case 1128: return (int)FN<__nv_bfloat16, 128>(__VA_ARGS__);                  \
    case 1256: return (int)FN<__nv_bfloat16, 256>(__VA_ARGS__);                  \
    case 2064: return (int)FN<__half, 64>(__VA_ARGS__);                          \
    case 2128: return (int)FN<__half, 128>(__VA_ARGS__);                         \
    case 2256: return (int)FN<__half, 256>(__VA_ARGS__);                         \
    default: return (int)cudaErrorInvalidValue;                             \
  }

}  // namespace

extern "C" {

int repro_fa_prefill(const void* q, const void* k, const void* v, void* o,
                     int dtype, int B, int Sq, int Sk, int H, int KV, int D,
                     long long qsb, long long qss, long long qsh,
                     long long ksb, long long kss, long long ksh,
                     long long vsb, long long vss, long long vsh,
                     long long osb, long long oss, long long osh,
                     int causal, int window, float scale, void* stream) {
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh,
                            vsb, vss, vsh, osb, oss, osh};
  DISPATCH(dtype, D, launch_prefill, q, k, v, o, B, Sq, Sk, H, KV, st,
           causal, window, scale, (cudaStream_t)stream)
}

int repro_fa_decode(const void* q, const void* k, const void* v, void* o,
                    const void* pos, const void* block_tables, int dtype,
                    int B, int H, int KV, int D, int lc, int nb,
                    long long s_b, long long s_page, long long s_l,
                    long long s_kv, float scale, void* stream) {
  DISPATCH(dtype, D, launch_decode, q, k, v, o, pos, block_tables, B,
           H, KV, lc, nb, s_b, s_page, s_l, s_kv, scale, (cudaStream_t)stream)
}

}  // extern "C"
