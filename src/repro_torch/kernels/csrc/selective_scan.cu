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
// What bounds it on an H100.  Per (b, t, d, n) one exponential, which only
// the SFU computes (MUFU.EX2, 16 a clock an SM, 4 for each of the 4 warp
// schedulers), and a handful of FMA-pipe instructions.  At Jamba's serve
// shapes (Di 16384, N 16) the exponentials bound it: Ba 2, S 512 is 268 M of
// them, 64 us at 1.98 GHz on 132 SMs, against 41 us for its ~138 MB.  The
// schedulers issue 128 thread-instructions a clock an SM, 8 for each
// exponential the SFU retires: a loop that issues more than 8 instructions
// per (t, d, n) is bound by issue, not by the SFU, and one with a long
// dependent chain per step needs many warps to hide it.  That 64 us is this
// design's bound, every exponential on the SFU; a kernel that computed a
// share of them as a polynomial on the FMA pipe could reach ~22 a clock an
// SM (47 us), the bound chip_smoke.py reports.
//
// Design.  Every exponential is computed once: exactly one exp(dt * A) per
// (b, t, d, n), as one FMUL by A * log2(e) (folded into A once per thread)
// and one ex2.approx.ftz, which is a bare MUFU.EX2 (expf adds a range
// reduction of ~7 instructions).  There is no re-scan of a time chunk and no
// correction that exponentiates again: a thread walks its channel's whole
// sequence, so blocks need no order among themselves (the TPU's grid walks
// time in order and carries the state in VMEM; nothing carries between
// blocks here).
//  - Lanes.  A channel's N states are split over N / 4 lanes, 4 states a
//    lane, so the card gets 4x the threads of one thread a channel (at Ba 1,
//    Di 16384, N 16: 64 K threads, 2048 warps).  A block is CHANNELS = 32
//    consecutive channels of one batch row, CHANNELS * N / 4 threads, grid
//    (ceil(Di / CHANNELS), Ba); warp q of a block holds states 4q .. 4q + 3
//    of all 32 channels, so a step's B and C quads are one address for the
//    whole warp (a broadcast) and y is stored 32 channels wide.  kernel.py
//    reads CHANNELS, TILE and QUAD from this file, and the launch takes the
//    grid and block size of its scan_plan.  MIN_BLOCKS holds the registers
//    to 4 blocks (16 warps) an SM.
//  - Staging.  The block walks time in tiles of TILE steps.  A tile's u, dt,
//    B and C are copied to shared memory with 16-byte cp.async (zero-filled
//    past S and Di), double-buffered: the next tile is in flight while this
//    one is computed; each thread's copy sources move a tile on by one add.
//    One pass then turns u and dt into (dt, dt * u) pairs, so a step reads
//    one 8-byte pair and two 16-byte B / C quads.  Where an array is not
//    16-byte aligned, or Di is not a multiple of 8, the same tiles are
//    staged by plain loads (VEC = false).
//  - Shared memory is the third limit beside the SFU and issue: a step costs
//    a warp ~4 shared-memory wavefronts (the pair 2, each broadcast quad 1)
//    against 16 exponentials, so the tile staging, the pairs and the y sum
//    are kept to one pass each.
//  - The y sum.  A lane keeps the partial sum of its 4 states for every step
//    of the tile in registers; after the tile the partials go through shared
//    memory, and each lane of a channel sums the lanes' partials of TILE /
//    lanes steps in a fixed order, ((p0 + p1) + (p2 + p3)), adds D * u and
//    writes y.  Deterministic: no atomics, no order that depends on timing.
//  - Edges are masked, not padded: channels >= Di and steps >= S are never
//    stored, and the last, partial tile runs a guarded copy of the step
//    loop, so no exponential is computed for a step past S.  h0 starts the
//    registers, so a resumed scan needs no detour to a plain version (the
//    TPU wrapper takes one, kernel.py:107-109).
//
// The backward (repro_selective_scan_bwd) is the gradient JAX takes of the
// scan; the TPU kernel has none.  Under grad the forward runs with SAVE and
// writes the state entering every tile (TILE = 16 steps) to a buffer: at
// Ba 8, S 1024, Di 16384, N 16 that is 64 x 8 x 16384 x 16 x 4 B = 537 MB
// a layer, held from the forward to the backward.  scan_bwd_kernel takes the
// forward's grid and lanes and walks the tiles in reverse: it recomputes a
// tile's 16 states forward from the saved start in registers (the forward's
// arithmetic, so the states are the forward's bit for bit), then walks the
// tile back with the state gradient carried in registers.  Per (b, t, d, n)
// it computes two exponentials (the recompute's and the backward's), against
// the one a minimal backward needs: it is bound by the SFU at about twice
// the forward's time.  The reductions take no floating-point atomics: dB and
// dC (over channels) are summed within a warp by shuffles and written per
// block of channels, (Ba, S, Di / 32, 2N) fp32, 537 MB at that shape; dA and
// dD per batch row; then scan_bwd_reduce adds the partials in index order,
// reading the 537 MB once (~0.16 ms at 3.35 TB/s).  u, dt, dy, B and C are
// staged with plain loads whatever their alignment, so the backward serves
// both of the forward's staging paths; S and Di need not be multiples of the
// tile or of the block.
//
// Every entry point returns cudaGetLastError() after its launches; the Python
// wrapper raises on anything nonzero, since a refused launch never runs.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int CHANNELS = 32;    // channels a block
constexpr int TILE = 16;        // time steps a staged tile
constexpr int QUAD = 4;         // states a lane
constexpr int YPAD = 4;         // floats of padding a row of the y partials
// blocks an SM the registers must allow: 4 caps a 128-thread block's
// threads at 128 registers (ptxas uses ~117 at N 16), 16 warps an SM
constexpr int MIN_BLOCKS = 4;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// 2^x as one MUFU.EX2 (flush-to-zero; exp(dt * A) never needs denormals)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes global -> shared, asynchronously; where !in the 16 bytes are
// zero-filled and nothing is read (source size 0, from a valid ``base``)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           const void* base, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(in ? gmem : base), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

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
  // the state at the start of every tile, for the backward: (Ba, tiles,
  // N / QUAD, Di, QUAD) contiguous, or null (SAVE = false)
  float* states;
  int S, Di;
};

// One staged tile: the raw inputs of TILE steps, as they lie in memory.
template <typename T, int N>
struct Stage {
  alignas(16) T u[TILE][CHANNELS];
  alignas(16) float dt[TILE][CHANNELS];
  alignas(16) float B[TILE][N];
  alignas(16) float C[TILE][N];
};

// The (dt, dt * u) pairs of the tile being computed; once its steps are
// done, the same bytes hold the lanes' y partials.
template <int THREADS>
union Work {
  float2 dd[TILE][CHANNELS];
  float4 yp[THREADS][(TILE + YPAD) / 4];
};

template <typename T, int N>
struct Shared {
  static constexpr int THREADS = CHANNELS * N / QUAD;
  Stage<T, N> stage[2];
  Work<THREADS> work;
};

// The 16-byte chunks of a tile row: u, dt, B and C, and the passes of the
// block over each (the last may be partial).
template <typename T, int N>
struct Chunks {
  static constexpr int THREADS = CHANNELS * N / QUAD;
  static constexpr int UE = 16 / sizeof(T);          // u per chunk
  static constexpr int UC = CHANNELS / UE;           // chunks a row of u
  static constexpr int DC = CHANNELS / 4;            // of dt
  static constexpr int NC = N / 4;                   // of B and of C
  static constexpr int PU = (TILE * UC + THREADS - 1) / THREADS;
  static constexpr int PD = (TILE * DC + THREADS - 1) / THREADS;
  static constexpr int PN = (TILE * NC + THREADS - 1) / THREADS;
};

// Where one thread's 16-byte copies of the next tile read: set for tile 0,
// then advanced a tile at a time (so no 64-bit multiply a tile).  A chunk
// past the tile's rows keeps the array's base and is never read.
template <typename T, int N>
struct Sources {
  using K = Chunks<T, N>;
  const T* u[K::PU];
  const float* dt[K::PD];
  const float* B[K::PN];
  const float* C[K::PN];

  __device__ __forceinline__ Sources(const ScanArgs& a, int b, int d0) {
    const int tid = threadIdx.x;
    const T* ub = static_cast<const T*>(a.u) + b * a.u_sb + d0;
#pragma unroll
    for (int r = 0; r < K::PU; ++r) {
      const int i = tid + r * K::THREADS;
      u[r] = i < TILE * K::UC ? ub + (i / K::UC) * a.u_st + (i % K::UC) * K::UE
                              : ub;
    }
#pragma unroll
    for (int r = 0; r < K::PD; ++r) {
      const int i = tid + r * K::THREADS;
      const float* db = a.dt + b * a.dt_sb + d0;
      dt[r] = i < TILE * K::DC ? db + (i / K::DC) * a.dt_st + (i % K::DC) * 4
                               : db;
    }
#pragma unroll
    for (int r = 0; r < K::PN; ++r) {
      const int i = tid + r * K::THREADS;
      const int j = i < TILE * K::NC ? i / K::NC : 0, c = (i % K::NC) * 4;
      B[r] = a.B + b * a.b_sb + j * a.b_st + c;
      C[r] = a.C + b * a.c_sb + j * a.c_st + c;
    }
  }
};

// Copy the tile of steps t0 .. t0 + TILE - 1 of the block's channels d0 ..
// d0 + CHANNELS - 1 into ``s``: 16-byte cp.async where VEC (the wrapper has
// checked the alignment, and Di % 8 == 0, so no 16-byte chunk straddles Di),
// then ``src`` moves a tile on; else plain loads.  Steps >= S and channels
// >= Di are zeros.
template <typename T, int N, bool VEC>
__device__ __forceinline__ void stage_tile(Stage<T, N>& s, Sources<T, N>& src,
                                           const ScanArgs& a, int b, int d0,
                                           int t0) {
  constexpr int THREADS = CHANNELS * N / QUAD;
  const int tid = threadIdx.x;
  if constexpr (VEC) {
    using K = Chunks<T, N>;
#pragma unroll
    for (int r = 0; r < K::PU; ++r) {
      const int i = tid + r * THREADS;
      const int j = i / K::UC, c = (i % K::UC) * K::UE;
      if (TILE * K::UC % THREADS == 0 || i < TILE * K::UC)
        cp_async16(&s.u[j][c], src.u[r], a.u,
                   t0 + j < a.S && d0 + c < a.Di);
      src.u[r] += TILE * a.u_st;
    }
#pragma unroll
    for (int r = 0; r < K::PD; ++r) {
      const int i = tid + r * THREADS;
      const int j = i / K::DC, c = (i % K::DC) * 4;
      if (TILE * K::DC % THREADS == 0 || i < TILE * K::DC)
        cp_async16(&s.dt[j][c], src.dt[r], a.dt,
                   t0 + j < a.S && d0 + c < a.Di);
      src.dt[r] += TILE * a.dt_st;
    }
#pragma unroll
    for (int r = 0; r < K::PN; ++r) {
      const int i = tid + r * THREADS;
      const int j = i / K::NC, c = (i % K::NC) * 4;
      if (TILE * K::NC % THREADS == 0 || i < TILE * K::NC) {
        cp_async16(&s.B[j][c], src.B[r], a.B, t0 + j < a.S);
        cp_async16(&s.C[j][c], src.C[r], a.C, t0 + j < a.S);
      }
      src.B[r] += TILE * a.b_st;
      src.C[r] += TILE * a.c_st;
    }
  } else {
    const T* u = static_cast<const T*>(a.u) + b * a.u_sb + d0;
    const float* dt = a.dt + b * a.dt_sb + d0;
    const float* B = a.B + b * a.b_sb;
    const float* C = a.C + b * a.c_sb;
    for (int i = tid; i < TILE * CHANNELS; i += THREADS) {
      const int j = i / CHANNELS, c = i % CHANNELS, t = t0 + j;
      const bool in = t < a.S && d0 + c < a.Di;
      const long long tt = t;
      s.u[j][c] = in ? u[tt * a.u_st + c] : from_float<T>(0.f);
      s.dt[j][c] = in ? dt[tt * a.dt_st + c] : 0.f;
    }
    for (int i = tid; i < TILE * N; i += THREADS) {
      const int j = i / N, c = i % N, t = t0 + j;
      const bool in = t < a.S;
      const long long tt = t;
      s.B[j][c] = in ? B[tt * a.b_st + c] : 0.f;
      s.C[j][c] = in ? C[tt * a.c_st + c] : 0.f;
    }
  }
}

// One tile of the block's scan: wait for its stage, start the next one's
// copy, form the (dt, dt * u) pairs, run ``steps`` steps (all TILE when
// FULL, with no guard in the loop), sum the lanes' partials and write y.
template <typename T, int N, bool VEC, bool FULL, bool SAVE>
__device__ __forceinline__ void scan_tile(Shared<T, N>& sh,
                                          Sources<T, N>& src,
                                          const ScanArgs& a, int b, int d0,
                                          int k, int n_tiles, int steps,
                                          const float (&A2)[QUAD],
                                          float (&h)[QUAD], float Dv,
                                          T* y, bool live) {
  constexpr int THREADS = CHANNELS * N / QUAD;
  constexpr int LANES = N / QUAD;
  constexpr int OWN = TILE / LANES;              // steps of y a lane writes
  const int tid = threadIdx.x;
  const int ch = tid % CHANNELS, q = tid / CHANNELS;

  if (SAVE && live) {                  // the state entering tile k
    const long long at = ((static_cast<long long>(b) * n_tiles + k) * LANES
                          + q) * a.Di + d0 + ch;
    *reinterpret_cast<float4*>(a.states + at * QUAD) =
        make_float4(h[0], h[1], h[2], h[3]);
  }
  cp_async_wait_all();                 // this thread's copies of tile k
  __syncthreads();                     // everyone's; tile k - 1 is done
  if (k + 1 < n_tiles) {
    stage_tile<T, N, VEC>(sh.stage[(k + 1) & 1], src, a, b, d0,
                          (k + 1) * TILE);
    cp_async_commit();
  }
  const Stage<T, N>& s = sh.stage[k & 1];
#pragma unroll
  for (int r = 0; r < TILE / LANES; ++r) {   // rows q, q + LANES, ...
    const int j = q + r * LANES;
    const float dtv = s.dt[j][ch];
    sh.work.dd[j][ch] = make_float2(dtv, dtv * to_float(s.u[j][ch]));
  }
  __syncthreads();

  float part[TILE];                    // this lane's sum of C * h, a step
#pragma unroll
  for (int j = 0; j < TILE; ++j) {
    if (FULL || j < steps) {
      const float2 v = sh.work.dd[j][ch];
      const float4 bq = *reinterpret_cast<const float4*>(&s.B[j][q * QUAD]);
      const float4 cq = *reinterpret_cast<const float4*>(&s.C[j][q * QUAD]);
      h[0] = fmaf(ex2(v.x * A2[0]), h[0], v.y * bq.x);
      h[1] = fmaf(ex2(v.x * A2[1]), h[1], v.y * bq.y);
      h[2] = fmaf(ex2(v.x * A2[2]), h[2], v.y * bq.z);
      h[3] = fmaf(ex2(v.x * A2[3]), h[3], v.y * bq.w);
      part[j] = fmaf(h[3], cq.w, fmaf(h[2], cq.z,
                                      fmaf(h[1], cq.y, h[0] * cq.x)));
    } else {
      part[j] = 0.f;
    }
  }
  __syncthreads();                     // every lane is done with the pairs
#pragma unroll
  for (int j = 0; j < TILE; j += 4)
    sh.work.yp[tid][j / 4] = make_float4(part[j], part[j + 1], part[j + 2],
                                         part[j + 3]);
  __syncthreads();

  // lane q of channel ch writes steps q * OWN .. q * OWN + OWN - 1
  float sum[OWN];
#pragma unroll
  for (int r = 0; r < OWN; r += 4) {
    float4 p[LANES];
#pragma unroll
    for (int l = 0; l < LANES; ++l)
      p[l] = sh.work.yp[l * CHANNELS + ch][(q * OWN + r) / 4];
    float4 tot = p[0];
    if constexpr (LANES == 2) {
      tot = make_float4(p[0].x + p[1].x, p[0].y + p[1].y, p[0].z + p[1].z,
                        p[0].w + p[1].w);
    } else if constexpr (LANES == 4) {
      tot = make_float4((p[0].x + p[1].x) + (p[2].x + p[3].x),
                        (p[0].y + p[1].y) + (p[2].y + p[3].y),
                        (p[0].z + p[1].z) + (p[2].z + p[3].z),
                        (p[0].w + p[1].w) + (p[2].w + p[3].w));
    }
    sum[r] = tot.x; sum[r + 1] = tot.y; sum[r + 2] = tot.z; sum[r + 3] = tot.w;
  }
  if (live) {
    const int t0 = k * TILE;
#pragma unroll
    for (int r = 0; r < OWN; ++r) {
      const int j = q * OWN + r;
      if (FULL || j < steps)
        y[static_cast<long long>(t0 + j) * a.Di] =
            from_float<T>(fmaf(Dv, to_float(s.u[j][ch]), sum[r]));
    }
  }
}

template <typename T, int N, bool VEC, bool SAVE>
__global__ void __launch_bounds__(CHANNELS * N / QUAD, MIN_BLOCKS)
scan_kernel(ScanArgs a) {
  __shared__ Shared<T, N> sh;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CHANNELS;
  const int ch = threadIdx.x % CHANNELS, q = threadIdx.x / CHANNELS;
  const int d = d0 + ch;
  const bool live = d < a.Di;
  const long long dl = live ? d : 0;        // never stored to when dead
  T* y = static_cast<T*>(a.y) + static_cast<long long>(b) * a.S * a.Di + dl;
  const long long hrow = (static_cast<long long>(b) * a.Di + dl) * N
                         + q * QUAD;

  float A2[QUAD], h[QUAD];             // A * log2(e), and the state
#pragma unroll
  for (int i = 0; i < QUAD; ++i) {
    A2[i] = live ? a.A[dl * N + q * QUAD + i] * LOG2E : 0.f;
    h[i] = (live && a.h0 != nullptr) ? a.h0[hrow + i] : 0.f;
  }
  const float Dv = live ? a.D[dl] : 0.f;

  const int n_full = a.S / TILE, rest = a.S % TILE;
  const int n_tiles = n_full + (rest ? 1 : 0);
  Sources<T, N> src(a, b, d0);
  if (n_tiles > 0) {
    stage_tile<T, N, VEC>(sh.stage[0], src, a, b, d0, 0);
    cp_async_commit();
  }
  for (int k = 0; k < n_full; ++k)
    scan_tile<T, N, VEC, true, SAVE>(sh, src, a, b, d0, k, n_tiles, TILE,
                                     A2, h, Dv, y, live);
  if (rest)
    scan_tile<T, N, VEC, false, SAVE>(sh, src, a, b, d0, n_full, n_tiles,
                                      rest, A2, h, Dv, y, live);
  if (live) {
#pragma unroll
    for (int i = 0; i < QUAD; ++i) a.h_last[hrow + i] = h[i];
  }
}

template <typename T, int N, bool SAVE>
void launch_save(const ScanArgs& a, dim3 grid, int threads, bool vec,
                 cudaStream_t stream) {
  if (vec)
    scan_kernel<T, N, true, SAVE><<<grid, threads, 0, stream>>>(a);
  else
    scan_kernel<T, N, false, SAVE><<<grid, threads, 0, stream>>>(a);
}

template <typename T, int N>
int launch(const ScanArgs& a, dim3 grid, int threads, bool vec,
           cudaStream_t stream) {
  if (a.states != nullptr)
    launch_save<T, N, true>(a, grid, threads, vec, stream);
  else
    launch_save<T, N, false>(a, grid, threads, vec, stream);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_n(const ScanArgs& a, dim3 grid, int threads, int n, bool vec,
             cudaStream_t stream) {
  switch (n) {
    case 4: return launch<T, 4>(a, grid, threads, vec, stream);
    case 8: return launch<T, 8>(a, grid, threads, vec, stream);
    case 16: return launch<T, 16>(a, grid, threads, vec, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// The backward: the gradient JAX takes of the scan (selective_scan_tpu has no
// custom_vjp; JAX differentiates its reference through lax.associative_scan).
// ---------------------------------------------------------------------------

// blocks an SM the backward's registers must allow: its thread keeps a
// tile's TILE + 1 states of its 4 (68 registers) beside the carried
// gradient, so it is given up to 168 registers a thread
constexpr int BWD_MIN_BLOCKS = 3;
constexpr int REDUCE_THREADS = 256;   // threads a block of scan_bwd_reduce
constexpr unsigned FULL_MASK = 0xffffffffu;

struct BwdArgs {
  const void* u; long long u_sb, u_st;      // as ScanArgs
  const float* dt; long long dt_sb, dt_st;
  const float* A;
  const float* B; long long b_sb, b_st;
  const float* C; long long c_sb, c_st;
  const float* D;
  const float* states;                      // the forward's tile starts
  const void* dy;                           // (Ba, S, Di) contiguous, u's type
  const float* dh_last;                     // (Ba, Di, N) contiguous, or null
  void* du;                                 // (Ba, S, Di) contiguous, u's type
  float* ddt;                               // (Ba, S, Di) contiguous
  float* dbc_part;                          // (Ba, S, NB, 2N): dB | dC a block
  float* da_part;                           // (Ba, Di, N)
  float* dd_part;                           // (Ba, Di)
  float* dh0;                               // (Ba, Di, N), or null
  int S, Di, NB;
};

template <typename T, int N>
struct BwdShared {
  static constexpr int THREADS = CHANNELS * N / QUAD;
  float u[TILE][CHANNELS];
  float dt[TILE][CHANNELS];
  float dy[TILE][CHANNELS];
  alignas(16) float B[TILE][N];
  alignas(16) float C[TILE][N];
  float2 gp[TILE][THREADS];     // a lane's (sum g B, sum g A a h_prev), a step
  float dd[THREADS];            // a lane's share of dD
};

// Sum 8 values over the 32 lanes of a warp in 9 shuffles (a reduce-scatter:
// halve the values kept at each of xor 16, 8 and 4, then a full sum over xor
// 2 and 1).  Lane l with l % 4 == 0 returns the total of value
// 4 [l & 16] + 2 [l & 8] + [l & 4]; a fixed order, so it is deterministic.
__device__ __forceinline__ float warp_sum8(const float (&v)[8], int lane,
                                           int* index) {
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
  float w[4], x[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (h16 ? v[i + 4] : v[i])
           + __shfl_xor_sync(FULL_MASK, h16 ? v[i] : v[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    x[i] = (h8 ? w[i + 2] : w[i])
           + __shfl_xor_sync(FULL_MASK, h8 ? w[i] : w[i + 2], 8);
  float y = (h4 ? x[1] : x[0])
            + __shfl_xor_sync(FULL_MASK, h4 ? x[0] : x[1], 4);
  y += __shfl_xor_sync(FULL_MASK, y, 2);
  y += __shfl_xor_sync(FULL_MASK, y, 1);
  *index = (h16 ? 4 : 0) + (h8 ? 2 : 0) + (h4 ? 1 : 0);
  return y;
}

// One block: the forward's (32 channels of batch row b) x (N / 4 lanes of 4
// states).  It walks the tiles from the last to the first; for each it
// stages u, dt, dy, B and C (plain loads, any strides, zeros past S and Di),
// recomputes the tile's states forward from the saved start exactly as the
// forward computed them, then walks the tile back:
//   g_t   = C_t dy_t + exp(dt_{t+1} A) g_{t+1}     (g_{S-1} from dh_last)
//   dC_t += dy_t h_t          dB_t += g_t dt_t u_t       (over channels)
//   du_t  = D dy_t + dt_t sum_n g_t B_t               (over the lanes)
//   ddt_t = sum_n g_t (A exp(dt_t A) h_{t-1} + u_t B_t)
//   dA   += g_t dt_t exp(dt_t A) h_{t-1}              (over time and batch)
//   dD   += dy_t u_t
// and dh0 = exp(dt_0 A) g_0.  dB and dC are summed over the warp's 32
// channels by warp_sum8 and written per block to dbc_part; dA and dD per
// batch row to da_part and dd_part; scan_bwd_reduce adds the blocks and rows
// in a fixed order.  No floating-point atomics, so two calls are bitwise
// equal.
template <typename T, int N>
__global__ void __launch_bounds__(CHANNELS * N / QUAD, BWD_MIN_BLOCKS)
scan_bwd_kernel(BwdArgs a) {
  constexpr int THREADS = CHANNELS * N / QUAD;
  constexpr int LANES = N / QUAD;
  constexpr int OWN = TILE / LANES;              // steps a lane finishes
  __shared__ BwdShared<T, N> sh;
  const int tid = threadIdx.x;
  const int ch = tid % CHANNELS, q = tid / CHANNELS;
  const int b = blockIdx.y, blk = blockIdx.x;
  const int d0 = blk * CHANNELS, d = d0 + ch;
  const bool live = d < a.Di;
  const long long dl = live ? d : 0;
  const long long hrow = (static_cast<long long>(b) * a.Di + dl) * N
                         + q * QUAD;
  const int n_tiles = (a.S + TILE - 1) / TILE;

  float A1[QUAD], A2[QUAD], g[QUAD], dA[QUAD];
#pragma unroll
  for (int i = 0; i < QUAD; ++i) {
    A1[i] = live ? a.A[dl * N + q * QUAD + i] : 0.f;
    A2[i] = A1[i] * LOG2E;
    g[i] = (live && a.dh_last != nullptr) ? a.dh_last[hrow + i] : 0.f;
    dA[i] = 0.f;
  }
  const float Dv = live ? a.D[dl] : 0.f;
  float dd = 0.f;

  const T* u = static_cast<const T*>(a.u) + b * a.u_sb + d0;
  const float* dtp = a.dt + b * a.dt_sb + d0;
  const T* dy = static_cast<const T*>(a.dy)
                + static_cast<long long>(b) * a.S * a.Di + d0;
  const float* Bp = a.B + b * a.b_sb;
  const float* Cp = a.C + b * a.c_sb;
  T* du = static_cast<T*>(a.du) + static_cast<long long>(b) * a.S * a.Di
          + dl;
  float* ddt = a.ddt + static_cast<long long>(b) * a.S * a.Di + dl;

  for (int k = n_tiles - 1; k >= 0; --k) {
    const int t0 = k * TILE;
    const int steps = min(TILE, a.S - t0);
    __syncthreads();                   // the last tile's readers are done
    for (int i = tid; i < TILE * CHANNELS; i += THREADS) {
      const int j = i / CHANNELS, c = i % CHANNELS;
      const bool in = j < steps && d0 + c < a.Di;
      const long long t = t0 + j;
      sh.u[j][c] = in ? to_float(u[t * a.u_st + c]) : 0.f;
      sh.dt[j][c] = in ? dtp[t * a.dt_st + c] : 0.f;
      sh.dy[j][c] = in ? to_float(dy[t * a.Di + c]) : 0.f;
    }
    for (int i = tid; i < TILE * N; i += THREADS) {
      const int j = i / N, c = i % N;
      const long long t = t0 + j;
      sh.B[j][c] = j < steps ? Bp[t * a.b_st + c] : 0.f;
      sh.C[j][c] = j < steps ? Cp[t * a.c_st + c] : 0.f;
    }
    __syncthreads();

    // the tile's states: hs[j] enters step j, hs[j + 1] leaves it
    float hs[TILE + 1][QUAD];
    if (live) {
      const long long at = ((static_cast<long long>(b) * n_tiles + k) * LANES
                            + q) * a.Di + d;
      const float4 h4 = *reinterpret_cast<const float4*>(a.states
                                                          + at * QUAD);
      hs[0][0] = h4.x; hs[0][1] = h4.y; hs[0][2] = h4.z; hs[0][3] = h4.w;
    } else {
#pragma unroll
      for (int i = 0; i < QUAD; ++i) hs[0][i] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      if (j < steps) {
        const float dtv = sh.dt[j][ch];
        const float dtu = dtv * sh.u[j][ch];
        const float4 bq = *reinterpret_cast<const float4*>(&sh.B[j][q * QUAD]);
        hs[j + 1][0] = fmaf(ex2(dtv * A2[0]), hs[j][0], dtu * bq.x);
        hs[j + 1][1] = fmaf(ex2(dtv * A2[1]), hs[j][1], dtu * bq.y);
        hs[j + 1][2] = fmaf(ex2(dtv * A2[2]), hs[j][2], dtu * bq.z);
        hs[j + 1][3] = fmaf(ex2(dtv * A2[3]), hs[j][3], dtu * bq.w);
      }
    }

#pragma unroll
    for (int j = TILE - 1; j >= 0; --j) {
      if (j < steps) {
        const float dtv = sh.dt[j][ch], uv = sh.u[j][ch];
        const float dyv = sh.dy[j][ch];
        const float dtu = dtv * uv;
        const float4 b4 = *reinterpret_cast<const float4*>(&sh.B[j][q * QUAD]);
        const float4 c4 = *reinterpret_cast<const float4*>(&sh.C[j][q * QUAD]);
        const float bq[QUAD] = {b4.x, b4.y, b4.z, b4.w};
        const float cq[QUAD] = {c4.x, c4.y, c4.z, c4.w};
        float v[8];                    // dB (4 states), then dC
        float gb = 0.f, gah = 0.f;
#pragma unroll
        for (int i = 0; i < QUAD; ++i) {
          g[i] = fmaf(cq[i], dyv, g[i]);             // dL/dh_t
          v[i] = g[i] * dtu;
          v[QUAD + i] = dyv * hs[j + 1][i];
          const float ai = ex2(dtv * A2[i]);         // exp(dt_t A)
          const float ah = ai * hs[j][i];
          gb = fmaf(g[i], bq[i], gb);
          gah = fmaf(g[i] * A1[i], ah, gah);
          dA[i] = fmaf(g[i] * dtv, ah, dA[i]);
          g[i] *= ai;                                // on to dL/dh_{t-1}
        }
        int idx;
        const float tot = warp_sum8(v, ch, &idx);
        if ((ch & 3) == 0) {
          const int col = idx < QUAD ? q * QUAD + idx
                                     : N + q * QUAD + idx - QUAD;
          a.dbc_part[((static_cast<long long>(b) * a.S + t0 + j) * a.NB
                      + blk) * (2 * N) + col] = tot;
        }
        sh.gp[j][tid] = make_float2(gb, gah);
      }
    }
    __syncthreads();

    // lane q of channel ch finishes steps q * OWN .. q * OWN + OWN - 1
#pragma unroll
    for (int r = 0; r < OWN; ++r) {
      const int j = q * OWN + r;
      if (live && j < steps) {
        float gbs = 0.f, gahs = 0.f;
#pragma unroll
        for (int l = 0; l < LANES; ++l) {
          const float2 p = sh.gp[j][l * CHANNELS + ch];
          gbs += p.x;
          gahs += p.y;
        }
        const float dyv = sh.dy[j][ch], uv = sh.u[j][ch];
        const long long at = static_cast<long long>(t0 + j) * a.Di;
        du[at] = from_float<T>(fmaf(Dv, dyv, sh.dt[j][ch] * gbs));
        ddt[at] = fmaf(uv, gbs, gahs);
        dd = fmaf(dyv, uv, dd);
      }
    }
  }

  sh.dd[tid] = dd;
  __syncthreads();
  if (live) {
#pragma unroll
    for (int i = 0; i < QUAD; ++i) a.da_part[hrow + i] = dA[i];
    if (a.dh0 != nullptr) {
#pragma unroll
      for (int i = 0; i < QUAD; ++i) a.dh0[hrow + i] = g[i];
    }
    if (q == 0) {
      float s = 0.f;
#pragma unroll
      for (int l = 0; l < LANES; ++l) s += sh.dd[l * CHANNELS + ch];
      a.dd_part[static_cast<long long>(b) * a.Di + d] = s;
    }
  }
}

// The second pass: dB and dC (Ba, S, N) as the sums of the NB blocks'
// partials, dA (Di, N) and dD (Di,) as the sums of the Ba rows' partials,
// each in index order.  One thread an output element, grid-stride.
__global__ void scan_bwd_reduce(const float* dbc_part, const float* da_part,
                                const float* dd_part, float* dB, float* dC,
                                float* dA, float* dD, int ba, int s, int di,
                                int n, int nb) {
  const long long n_bc = static_cast<long long>(ba) * s * 2 * n;
  const long long n_a = static_cast<long long>(di) * n;
  const long long total = n_bc + n_a + di;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                     + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (i < n_bc) {
      const long long row = i / (2 * n);
      const int col = static_cast<int>(i % (2 * n));
      const float* p = dbc_part + row * nb * 2 * n + col;
      float acc = 0.f;
      for (int k = 0; k < nb; ++k) acc += p[static_cast<long long>(k) * 2 * n];
      if (col < n) dB[row * n + col] = acc;
      else dC[row * n + col - n] = acc;
    } else if (i < n_bc + n_a) {
      const long long j = i - n_bc;
      float acc = 0.f;
      for (int r = 0; r < ba; ++r) acc += da_part[r * n_a + j];
      dA[j] = acc;
    } else {
      const long long j = i - n_bc - n_a;
      float acc = 0.f;
      for (int r = 0; r < ba; ++r)
        acc += dd_part[static_cast<long long>(r) * di + j];
      dD[j] = acc;
    }
  }
}

template <typename T>
int launch_bwd(const BwdArgs& a, dim3 grid, int threads, int n,
               cudaStream_t stream) {
  switch (n) {
    case 4: scan_bwd_kernel<T, 4><<<grid, threads, 0, stream>>>(a); break;
    case 8: scan_bwd_kernel<T, 8><<<grid, threads, 0, stream>>>(a); break;
    case 16: scan_bwd_kernel<T, 16><<<grid, threads, 0, stream>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// u: (Ba, S, Di) with strides (u_sb, u_st, 1), dtype 0 fp32 / 1 bf16; dt:
// fp32 with strides (dt_sb, dt_st, 1); A: (Di, N) contiguous fp32; B, C:
// (Ba, S, N) fp32 with strides (sb, st, 1); D: (Di,) fp32; h0: contiguous
// (Ba, Di, N) fp32 or null (zeros); y: contiguous (Ba, S, Di) in u's dtype;
// h_last: contiguous (Ba, Di, N) fp32.  N is 4, 8 or 16.  The grid is
// (grid_x, Ba) blocks of ``threads``: ceil(Di / CHANNELS) and CHANNELS * N /
// QUAD, as scan_plan gives them; vec selects the 16-byte cp.async staging,
// which needs u, dt, B and C 16-byte aligned with strides to match and
// Di % 8 == 0.  states: null, or contiguous (Ba, ceil(S / TILE), N / QUAD,
// Di, QUAD) fp32 that receives the state entering every tile (for the
// backward).
int repro_selective_scan(const void* u, long long u_sb, long long u_st,
                         int u_dtype, const void* dt, long long dt_sb,
                         long long dt_st, const void* A, const void* B,
                         long long b_sb, long long b_st, const void* C,
                         long long c_sb, long long c_st, const void* D,
                         const void* h0, void* y, void* h_last,
                         void* states, int ba, int s, int di, int n,
                         int grid_x, int threads, int vec, void* stream) {
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
  a.states = static_cast<float*>(states);
  a.S = s; a.Di = di;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_x, ba);
  if (u_dtype == 0) return launch_n<float>(a, grid, threads, n, vec != 0, st);
  if (u_dtype == 1)
    return launch_n<__nv_bfloat16>(a, grid, threads, n, vec != 0, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward.  u, dt, A, B, C, D as for the forward (same strides), states
// as the forward wrote them, dy contiguous (Ba, S, Di) in u's type, dh_last
// contiguous (Ba, Di, N) fp32 or null.  Writes du (contiguous, u's type),
// ddt (contiguous fp32), dB and dC (contiguous (Ba, S, N)), dA (Di, N), dD
// (Di,) and, where dh0 is not null, dh0 (Ba, Di, N).  dbc_part (Ba, S,
// grid_x, 2N), da_part (Ba, Di, N) and dd_part (Ba, Di) are fp32 scratch.
// Two launches: scan_bwd_kernel on (grid_x, Ba) blocks of ``threads``, then
// scan_bwd_reduce on ``red_blocks`` blocks of REDUCE_THREADS.
int repro_selective_scan_bwd(
    const void* u, long long u_sb, long long u_st, int u_dtype,
    const void* dt, long long dt_sb, long long dt_st, const void* A,
    const void* B, long long b_sb, long long b_st, const void* C,
    long long c_sb, long long c_st, const void* D, const void* states,
    const void* dy, const void* dh_last, void* du, void* ddt, void* dB,
    void* dC, void* dA, void* dD, void* dh0, void* dbc_part, void* da_part,
    void* dd_part, int ba, int s, int di, int n, int grid_x, int threads,
    int red_blocks, void* stream) {
  BwdArgs a;
  a.u = u; a.u_sb = u_sb; a.u_st = u_st;
  a.dt = static_cast<const float*>(dt); a.dt_sb = dt_sb; a.dt_st = dt_st;
  a.A = static_cast<const float*>(A);
  a.B = static_cast<const float*>(B); a.b_sb = b_sb; a.b_st = b_st;
  a.C = static_cast<const float*>(C); a.c_sb = c_sb; a.c_st = c_st;
  a.D = static_cast<const float*>(D);
  a.states = static_cast<const float*>(states);
  a.dy = dy;
  a.dh_last = static_cast<const float*>(dh_last);
  a.du = du;
  a.ddt = static_cast<float*>(ddt);
  a.dbc_part = static_cast<float*>(dbc_part);
  a.da_part = static_cast<float*>(da_part);
  a.dd_part = static_cast<float*>(dd_part);
  a.dh0 = static_cast<float*>(dh0);
  a.S = s; a.Di = di; a.NB = grid_x;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_x, ba);
  int err;
  if (u_dtype == 0) err = launch_bwd<float>(a, grid, threads, n, st);
  else if (u_dtype == 1)
    err = launch_bwd<__nv_bfloat16>(a, grid, threads, n, st);
  else return static_cast<int>(cudaErrorInvalidValue);
  if (err != 0) return err;
  scan_bwd_reduce<<<red_blocks, REDUCE_THREADS, 0, st>>>(
      static_cast<const float*>(dbc_part), static_cast<const float*>(da_part),
      static_cast<const float*>(dd_part), static_cast<float*>(dB),
      static_cast<float*>(dC), static_cast<float*>(dA),
      static_cast<float*>(dD), ba, s, di, n, grid_x);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
