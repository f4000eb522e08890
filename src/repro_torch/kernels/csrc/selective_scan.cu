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
// writes the state entering every BWD_TILE = 8 steps to a buffer: at Ba 8,
// S 1024, Di 16384, N 16 that is 128 x 8 x 16384 x 16 x 4 B = 1.07 GB a
// layer, held from the forward to the backward.
//
// What bounds the backward on an H100.  Per (b, t, d, n) a minimal backward
// computes one exponential and ~12 FP32-pipe instructions (the recompute's
// 3, the gradient's 9), 0.75 ms at that shape over both pipes; its bytes
// (u, dt, dy read, du, ddt written, and the saved states) take ~0.7 ms.
// What a design adds on top is issue: reductions over channels (dB, dC)
// and over states (du, ddt) that cross threads, staging, and addresses.
// The first version of this kernel (one channel a thread, 16-step tiles)
// issued 53.5 instructions and two exponentials an element; on the card
// its time went to synchronous per-element staging (3.1 of its 7.1 ms), to
// a 9-shuffle warp reduction of dB and dC at every step (1.8 ms, 18.7
// instructions an element), and to issue at 168 registers, 12 warps an SM
// (PERF.md, scan_ab.py --probe).  The design below issues ~25 instructions
// and 1.5 exponentials an element; what bounds it now is issue (~70% of its
// time at 12 warps an SM), then its 3.2 GB of traffic (~40%) and the SFU
// (~1/3).
//
// Design (scan_bwd_kernel, then scan_bwd_reduce):
//  - Work.  A thread holds 4 states of 2 channels, 8 elements: their sums
//    over states (g B, g A h) stay in registers 4 at a time and their sums
//    over channels (dB, dC) 2 at a time, so half as many values cross
//    threads as with one channel a thread.  A block is BWD_CHANNELS = 64
//    channels of one batch row, N / 4 warps; warp q holds states 4q .. 4q +
//    3 of all 64 channels, so B and C are broadcasts.
//  - One exponential and a half an element.  A staged tile of BWD_TILE
//    steps is walked as two sub-tiles of SUB = 4 steps whose states and
//    factors exp(dt A) are recomputed forward into registers (64 a thread)
//    with the forward's arithmetic, so the states are the forward's bit for
//    bit, and reused by the walk back.  The later sub-tile goes first, from
//    the state recomputed to its start without keeping factors: 12
//    exponentials for 8 steps.  exp(dt A) h_{t-1} is taken as h_t - dt u B,
//    one FFMA and no register for h_{t-1}.
//  - dB and dC over channels.  After the pair's sum in registers, once a
//    sub-tile a warp writes its quads to shared memory and each lane sums
//    8 of them for one (step, half, group) and meets 3 other groups by two
//    shuffles, in a fixed order: one partial a (step, block, state),
//    dbc_part (Ba, S, Di / 64, N / 4, 8) fp32, 268 MB at that shape.  dA
//    and dD sum per batch row in registers; scan_bwd_reduce adds blocks and
//    rows in index order.  No floating-point atomics: two calls are bitwise
//    equal.
//  - du and ddt over states.  A thread's lane sums go to shared memory each
//    step; after one barrier a tile, each thread finishes BWD_TILE / lanes
//    steps of its two channels, adding the lanes pairwise as the forward
//    adds y.  Two barriers a tile in all: the sub-tiles' dB / dC sums stay
//    in the warp.
//  - Staging.  While a tile is walked the next one's u, dy, dt, B and C and
//    its saved state are in flight, by 16-byte cp.async, double-buffered;
//    where u, dt, B or C is not 16-byte aligned or Di is not a multiple of
//    8 (VEC = false; B and C arrive as column views of x_proj's output with
//    any row stride) the same tiles are staged by plain loads, the saved
//    state still by cp.async.  S and Di need not be multiples of the tile
//    or of the block: the last, partial tile runs a guarded copy before the
//    loop, and dead channels stage zeros.
//  - Registers.  __launch_bounds__ for BWD_MIN_BLOCKS = 3 blocks an SM: at
//    N 16 at most 168 registers a thread, 12 warps an SM (at 16 warps, 128,
//    ptxas spilled); the shared memory is dynamic (50.5 KB at bf16 N 16).
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
// The backward's tiling: a staged tile of BWD_TILE steps (the forward, under
// grad, saves the state entering every one), walked as two sub-tiles of SUB
// steps held in registers; a thread holds the states of BWD_PAIR channels,
// a block a warp's lanes of them, BWD_CHANNELS
constexpr int BWD_TILE = 8;
constexpr int SUB = 4;
constexpr int BWD_PAIR = 2;
constexpr int BWD_CHANNELS = 32 * BWD_PAIR;
// blocks an SM the backward's registers must allow: 3 caps a thread at 168
// registers at N 16, 12 warps an SM (at 4 blocks, 128 registers, ptxas
// spills); the smaller blocks of N 8 and 4 may take up to 255 (at 168 the
// plain-staged N 4 spilled)
constexpr int BWD_MIN_BLOCKS = 3;
static_assert(TILE % BWD_TILE == 0 && BWD_TILE == 2 * SUB, "tiling");

__host__ __device__ constexpr int cdiv(int x, int y) { return (x + y - 1) / y; }

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

// Under grad: the state entering step s * BWD_TILE of lane q of channel d,
// for the backward, into states (Ba, ceil(S / BWD_TILE), N / QUAD, Di,
// QUAD), so a warp's 32 channels store 512 consecutive bytes.
template <int N>
__device__ __forceinline__ void save_state(const ScanArgs& a, int b, int s,
                                           int q, int d,
                                           const float (&h)[QUAD]) {
  const int n_saves = cdiv(a.S, BWD_TILE);
  const long long at = ((static_cast<long long>(b) * n_saves + s) * (N / QUAD)
                        + q) * a.Di + d;
  *reinterpret_cast<float4*>(a.states + at * QUAD) =
      make_float4(h[0], h[1], h[2], h[3]);
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

  if (SAVE && live)                    // the state entering tile k
    save_state<N>(a, b, k * (TILE / BWD_TILE), q, d0 + ch, h);
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
      if (SAVE && live && j > 0 && j % BWD_TILE == 0)
        save_state<N>(a, b, (k * TILE + j) / BWD_TILE, q, d0 + ch, h);
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

constexpr int REDUCE_THREADS = 256;   // threads a block of scan_bwd_reduce
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr float LN2 = 0.6931471805599453f;

struct BwdArgs {
  const void* u; long long u_sb, u_st;      // as ScanArgs
  const float* dt; long long dt_sb, dt_st;
  const float* A;
  const float* B; long long b_sb, b_st;
  const float* C; long long c_sb, c_st;
  const float* D;
  const float* states;                      // the forward's saved states
  const void* dy;                           // (Ba, S, Di) contiguous, u's type
  const float* dh_last;                     // (Ba, Di, N) contiguous, or null
  void* du;                                 // (Ba, S, Di) contiguous, u's type
  float* ddt;                               // (Ba, S, Di) contiguous
  float* dbc_part;                          // (Ba, S, NB, N / QUAD, 8)
  float* da_part;                           // (Ba, Di, N)
  float* dd_part;                           // (Ba, Di)
  float* dh0;                               // (Ba, Di, N), or null
  int S, Di, NB;
};

// One staged tile of the backward: the inputs of BWD_TILE steps of the
// block's channels, as they lie in memory, and the saved state entering the
// tile.
template <typename T, int N>
struct BwdStage {
  static constexpr int LANES = N / QUAD;
  alignas(16) T u[BWD_TILE][BWD_CHANNELS];
  alignas(16) T dy[BWD_TILE][BWD_CHANNELS];
  alignas(16) float dt[BWD_TILE][BWD_CHANNELS];
  alignas(16) float B[BWD_TILE][N];
  alignas(16) float C[BWD_TILE][N];
  alignas(16) float4 h0[LANES][BWD_CHANNELS];
};

template <typename T, int N>
struct BwdShared {
  static constexpr int LANES = N / QUAD;
  BwdStage<T, N> stage[2];
  // a thread's (sum_n g B, sum_n g A2 a h) of each of its two channels, a
  // step of the tile
  float4 gp[BWD_TILE][LANES][32];
  // a warp's dB (half 0) and dC (half 1) quads, a step and lane; rows of 33
  // quads, so that the two halves a quarter-warp reads fall in other banks
  float4 red[LANES][2][SUB][33];
};

// What a thread carries across tiles: its two channels' A * log2(e), the
// state gradient dL/dh, and its partial dA and dD.
struct BwdCarry {
  float A2[BWD_PAIR][QUAD];
  float g[BWD_PAIR][QUAD];
  float dA[BWD_PAIR][QUAD];
  float dd[BWD_PAIR];
  float Dv[BWD_PAIR];
};

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Copy tile k (steps k * BWD_TILE ..) of the block's BWD_CHANNELS channels
// into ``s``: u, dy, dt, B and C by 16-byte cp.async where VEC (the wrapper
// has checked the alignment, and Di % 8 == 0), else by plain loads; the
// saved state entering the tile always by cp.async (the buffer is the
// wrapper's own, contiguous).  Steps >= S and channels >= Di are zeros.
template <typename T, int N, bool VEC>
__device__ __forceinline__ void bwd_stage(BwdStage<T, N>& s,
                                          const BwdArgs& a, int b, int d0,
                                          int k, int n_saves) {
  constexpr int LANES = N / QUAD, THREADS = 32 * LANES;
  const int tid = threadIdx.x, t0 = k * BWD_TILE;
  const int steps = min(BWD_TILE, a.S - t0);
  const T* u = static_cast<const T*>(a.u) + b * a.u_sb + d0;
  const T* dy = static_cast<const T*>(a.dy)
                + static_cast<long long>(b) * a.S * a.Di + d0;
  const float* dt = a.dt + b * a.dt_sb + d0;
  const float* B = a.B + b * a.b_sb;
  const float* C = a.C + b * a.c_sb;
  if constexpr (VEC) {
    constexpr int UE = 16 / sizeof(T), UC = BWD_CHANNELS / UE;
    constexpr int DC = BWD_CHANNELS / 4, NC = N / 4;
#pragma unroll
    for (int r = 0; r < cdiv(BWD_TILE * UC, THREADS); ++r) {
      const int i = tid + r * THREADS;
      const int j = i / UC, c = (i % UC) * UE;
      if (BWD_TILE * UC % THREADS == 0 || i < BWD_TILE * UC) {
        const bool in = j < steps && d0 + c < a.Di;
        const long long t = t0 + j;
        cp_async16(&s.u[j][c], u + t * a.u_st + c, a.u, in);
        cp_async16(&s.dy[j][c], dy + t * a.Di + c, a.dy, in);
      }
    }
#pragma unroll
    for (int r = 0; r < cdiv(BWD_TILE * DC, THREADS); ++r) {
      const int i = tid + r * THREADS;
      const int j = i / DC, c = (i % DC) * 4;
      if (BWD_TILE * DC % THREADS == 0 || i < BWD_TILE * DC)
        cp_async16(&s.dt[j][c], dt + static_cast<long long>(t0 + j) * a.dt_st
                   + c, a.dt, j < steps && d0 + c < a.Di);
    }
#pragma unroll
    for (int r = 0; r < cdiv(BWD_TILE * NC, THREADS); ++r) {
      const int i = tid + r * THREADS;
      const int j = i / NC, c = (i % NC) * 4;
      if (BWD_TILE * NC % THREADS == 0 || i < BWD_TILE * NC) {
        const long long t = t0 + j;
        cp_async16(&s.B[j][c], B + t * a.b_st + c, a.B, j < steps);
        cp_async16(&s.C[j][c], C + t * a.c_st + c, a.C, j < steps);
      }
    }
  } else {
#pragma unroll 4
    for (int i = tid; i < BWD_TILE * BWD_CHANNELS; i += THREADS) {
      const int j = i / BWD_CHANNELS, c = i % BWD_CHANNELS;
      const bool in = j < steps && d0 + c < a.Di;
      const long long t = t0 + j;
      s.u[j][c] = in ? u[t * a.u_st + c] : from_float<T>(0.f);
      s.dy[j][c] = in ? dy[t * a.Di + c] : from_float<T>(0.f);
      s.dt[j][c] = in ? dt[t * a.dt_st + c] : 0.f;
    }
    for (int i = tid; i < BWD_TILE * N; i += THREADS) {
      const int j = i / N, c = i % N;
      const long long t = t0 + j;
      s.B[j][c] = j < steps ? B[t * a.b_st + c] : 0.f;
      s.C[j][c] = j < steps ? C[t * a.c_st + c] : 0.f;
    }
  }
  static_assert(LANES * BWD_CHANNELS % THREADS == 0, "whole passes");
#pragma unroll
  for (int r = 0; r < LANES * BWD_CHANNELS / THREADS; ++r) {
    const int i = tid + r * THREADS;
    const int l = i / BWD_CHANNELS, c = i % BWD_CHANNELS;
    const long long at = ((static_cast<long long>(b) * n_saves + k) * LANES
                          + l) * a.Di + d0 + c;
    cp_async16(&s.h0[l][c], a.states + at * QUAD, a.states, d0 + c < a.Di);
  }
}

// A step's (dt, dt, dt u, dt u) of a thread's two channels.
template <typename T, int N>
__device__ __forceinline__ float4 step_dtu(const BwdStage<T, N>& s, int j,
                                           int p) {
  const float2 dt2 = load2(&s.dt[j][BWD_PAIR * p]);
  const float2 u2 = load2(&s.u[j][BWD_PAIR * p]);
  return make_float4(dt2.x, dt2.y, dt2.x * u2.x, dt2.y * u2.y);
}

// The state entering step ``SUB`` of a tile, from the one entering the tile,
// with the forward's arithmetic (so bit for bit the forward's state).
template <typename T, int N>
__device__ __forceinline__ void bwd_half(const BwdStage<T, N>& s,
                                         const BwdCarry& c, int p, int q,
                                         float (&h)[BWD_PAIR][QUAD]) {
#pragma unroll
  for (int j = 0; j < SUB; ++j) {
    const float4 v = step_dtu(s, j, p);
    const float4 bq = *reinterpret_cast<const float4*>(&s.B[j][q * QUAD]);
    const float dtv[BWD_PAIR] = {v.x, v.y};
    const float dtu[BWD_PAIR] = {v.z, v.w};
    const float bb[QUAD] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
    for (int k = 0; k < BWD_PAIR; ++k)
#pragma unroll
      for (int i = 0; i < QUAD; ++i)
        h[k][i] = fmaf(ex2(dtv[k] * c.A2[k][i]), h[k][i], dtu[k] * bb[i]);
  }
}

// One sub-tile: steps j0 .. j0 + n - 1 of staged tile ``s`` (t0 is the
// time of step j0; all SUB steps when FULL), from ``h``, the state entering
// step j0.  Recompute the sub-tile's states and factors exp(dt A) forward in
// registers, then walk it back:
//   g_t   = C_t dy_t + exp(dt_{t+1} A) g_{t+1}     (g_{S-1} from dh_last)
//   dC_t += dy_t h_t          dB_t += g_t dt_t u_t       (over channels)
//   du_t  = D dy_t + dt_t sum_n g_t B_t               (over the lanes)
//   ddt_t = sum_n g_t (A exp(dt_t A) h_{t-1} + u_t B_t)
//   dA   += g_t dt_t exp(dt_t A) h_{t-1}              (over time and batch)
//   dD   += dy_t u_t
// with exp(dt_t A) h_{t-1} taken as h_t - dt_t u_t B_t (one FFMA, and no
// register for h_{t-1}).  A thread's two channels are added in registers;
// the warp's 32 lanes (64 channels) through shared memory, once a sub-tile,
// into one dB / dC partial a (step, block, state); each thread's sums over
// its states (for du, ddt) go to shared memory for bwd_finish.
template <typename T, int N, bool FULL>
__device__ __forceinline__ void bwd_sub_tile(BwdShared<T, N>& sh,
                                             const BwdStage<T, N>& s,
                                             const BwdArgs& a, BwdCarry& c,
                                             float (&h)[BWD_PAIR][QUAD],
                                             int b, int blk, int t0, int j0,
                                             int n) {
  constexpr int LANES = N / QUAD;
  const int p = threadIdx.x % 32, q = threadIdx.x / 32;
  float hs[SUB][BWD_PAIR][QUAD];                 // h_t, leaving step t
  float fac[SUB][BWD_PAIR][QUAD];                // exp(dt_t A)
#pragma unroll
  for (int jj = 0; jj < SUB; ++jj) {
    if (FULL || jj < n) {
      const int j = j0 + jj;
      const float4 v = step_dtu(s, j, p);
      const float4 bq = *reinterpret_cast<const float4*>(&s.B[j][q * QUAD]);
      const float dtv[BWD_PAIR] = {v.x, v.y};
      const float dtu[BWD_PAIR] = {v.z, v.w};
      const float bb[QUAD] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
      for (int k = 0; k < BWD_PAIR; ++k)
#pragma unroll
        for (int i = 0; i < QUAD; ++i) {
          fac[jj][k][i] = ex2(dtv[k] * c.A2[k][i]);
          h[k][i] = fmaf(fac[jj][k][i], h[k][i], dtu[k] * bb[i]);
          hs[jj][k][i] = h[k][i];
        }
    }
  }

#pragma unroll
  for (int jj = SUB - 1; jj >= 0; --jj) {
    if (FULL || jj < n) {
      const int j = j0 + jj;
      const float4 v = step_dtu(s, j, p);
      const float2 dy2 = load2(&s.dy[j][BWD_PAIR * p]);
      const float4 bq = *reinterpret_cast<const float4*>(&s.B[j][q * QUAD]);
      const float4 cq = *reinterpret_cast<const float4*>(&s.C[j][q * QUAD]);
      const float dtv[BWD_PAIR] = {v.x, v.y};
      const float dyv[BWD_PAIR] = {dy2.x, dy2.y};
      const float dtu[BWD_PAIR] = {v.z, v.w};
      const float bb[QUAD] = {bq.x, bq.y, bq.z, bq.w};
      const float cc[QUAD] = {cq.x, cq.y, cq.z, cq.w};
      float gb[BWD_PAIR], gah[BWD_PAIR], db[QUAD], dc[QUAD];
#pragma unroll
      for (int k = 0; k < BWD_PAIR; ++k) {
        gb[k] = 0.f;
        gah[k] = 0.f;
#pragma unroll
        for (int i = 0; i < QUAD; ++i) {
          c.g[k][i] = fmaf(cc[i], dyv[k], c.g[k][i]);       // dL/dh_t
          const float ah = fmaf(-dtu[k], bb[i], hs[jj][k][i]);
          const float w = c.g[k][i] * ah;
          gb[k] = fmaf(c.g[k][i], bb[i], gb[k]);
          gah[k] = fmaf(w, c.A2[k][i], gah[k]);
          c.dA[k][i] = fmaf(w, dtv[k], c.dA[k][i]);
        }
      }
#pragma unroll
      for (int i = 0; i < QUAD; ++i) {
        db[i] = fmaf(c.g[1][i], dtu[1], c.g[0][i] * dtu[0]);
        dc[i] = fmaf(dyv[1], hs[jj][1][i], dyv[0] * hs[jj][0][i]);
      }
#pragma unroll
      for (int k = 0; k < BWD_PAIR; ++k)
#pragma unroll
        for (int i = 0; i < QUAD; ++i) c.g[k][i] *= fac[jj][k][i];
      sh.red[q][0][jj][p] = make_float4(db[0], db[1], db[2], db[3]);
      sh.red[q][1][jj][p] = make_float4(dc[0], dc[1], dc[2], dc[3]);
      sh.gp[j][q][p] = make_float4(gb[0], gah[0], gb[1], gah[1]);
    }
  }
  __syncwarp();

  // dB and dC over the warp's 64 channels: lane (jj, half, lg) sums the
  // quads of lanes lg, lg + 4, .., lg + 28 in order, then the four lg
  // groups' sums meet by two shuffles, ((G0 + G2) + (G1 + G3)), each lane
  // keeping state lg of its half.  A fixed order: no atomics.
  {
    const int jj = p >> 3, half = (p >> 2) & 1, lg = p & 3;
    float4 acc = sh.red[q][half][jj][lg];
#pragma unroll
    for (int r = 1; r < 8; ++r) {
      const float4 x = sh.red[q][half][jj][lg + 4 * r];
      acc.x += x.x; acc.y += x.y; acc.z += x.z; acc.w += x.w;
    }
    const bool b1 = lg & 2, b0 = lg & 1;
    float k0 = b1 ? acc.z : acc.x, k1 = b1 ? acc.w : acc.y;
    k0 += __shfl_xor_sync(FULL_MASK, b1 ? acc.x : acc.z, 2);
    k1 += __shfl_xor_sync(FULL_MASK, b1 ? acc.y : acc.w, 2);
    const float tot = (b0 ? k1 : k0)
                      + __shfl_xor_sync(FULL_MASK, b0 ? k0 : k1, 1);
    if (FULL || jj < n)
      a.dbc_part[((static_cast<long long>(b) * a.S + t0 + jj) * a.NB + blk)
                 * (8 * LANES) + q * 8 + half * QUAD + lg] = tot;
  }
}

// The tile's du and ddt, after both sub-tiles and one barrier: thread (q,
// p) finishes steps q * OWN .. q * OWN + OWN - 1 of its two channels, the
// lanes' sums added pairwise, as the forward adds y.  ``steps`` of the
// tile are live (all BWD_TILE when FULL).
template <typename T, int N, bool FULL>
__device__ __forceinline__ void bwd_finish(const BwdShared<T, N>& sh,
                                           const BwdStage<T, N>& s,
                                           const BwdArgs& a, BwdCarry& c,
                                           int b, int d0, int t0,
                                           int steps) {
  constexpr int LANES = N / QUAD;
  constexpr int OWN = BWD_TILE / LANES;          // steps a thread finishes
  const int p = threadIdx.x % 32, q = threadIdx.x / 32;
  const int dp = d0 + BWD_PAIR * p;
  const bool pair_store = (a.Di & 1) == 0 && dp + 1 < a.Di;
#pragma unroll
  for (int r = 0; r < OWN; ++r) {
    const int j = q * OWN + r;
    if (FULL || j < steps) {
      float4 pp[LANES];
#pragma unroll
      for (int l = 0; l < LANES; ++l) pp[l] = sh.gp[j][l][p];
      float4 tot = pp[0];
      if constexpr (LANES == 2) {
        tot = make_float4(pp[0].x + pp[1].x, pp[0].y + pp[1].y,
                          pp[0].z + pp[1].z, pp[0].w + pp[1].w);
      } else if constexpr (LANES == 4) {
        tot = make_float4((pp[0].x + pp[1].x) + (pp[2].x + pp[3].x),
                          (pp[0].y + pp[1].y) + (pp[2].y + pp[3].y),
                          (pp[0].z + pp[1].z) + (pp[2].z + pp[3].z),
                          (pp[0].w + pp[1].w) + (pp[2].w + pp[3].w));
      }
      const float2 dt2 = load2(&s.dt[j][BWD_PAIR * p]);
      const float2 u2 = load2(&s.u[j][BWD_PAIR * p]);
      const float2 dy2 = load2(&s.dy[j][BWD_PAIR * p]);
      const float du0 = fmaf(c.Dv[0], dy2.x, dt2.x * tot.x);
      const float du1 = fmaf(c.Dv[1], dy2.y, dt2.y * tot.z);
      const float ddt0 = fmaf(u2.x, tot.x, tot.y * LN2);
      const float ddt1 = fmaf(u2.y, tot.z, tot.w * LN2);
      c.dd[0] = fmaf(dy2.x, u2.x, c.dd[0]);
      c.dd[1] = fmaf(dy2.y, u2.y, c.dd[1]);
      const long long at = (static_cast<long long>(b) * a.S + t0 + j) * a.Di
                           + dp;
      T* du = static_cast<T*>(a.du) + at;
      float* ddt = a.ddt + at;
      if (pair_store) {
        store2(du, du0, du1);
        store2(ddt, ddt0, ddt1);
      } else if (dp < a.Di) {
        du[0] = from_float<T>(du0);
        ddt[0] = ddt0;
        if (dp + 1 < a.Di) {
          du[1] = from_float<T>(du1);
          ddt[1] = ddt1;
        }
      }
    }
  }
}

// One staged tile: steps 0 .. steps - 1 of tile k (all BWD_TILE when FULL).
// Past the first barrier (its copy in place, tile k + 1 done with its
// buffers) tile k - 1's copy starts; the second sub-tile is walked first:
// the state entering it is recomputed from the saved one (bwd_half), so
// steps 0 .. SUB - 1 take two exponentials and steps SUB .. BWD_TILE - 1
// one, 1.5 an element.  Past the second barrier (every warp's (gb, gah))
// the tile's du and ddt are finished.  Two barriers a tile.
template <typename T, int N, bool VEC, bool FULL>
__device__ __forceinline__ void bwd_tile(BwdShared<T, N>& sh,
                                         const BwdArgs& a, BwdCarry& c,
                                         int b, int blk, int d0, int k,
                                         int steps, int n_saves) {
  const int p = threadIdx.x % 32, q = threadIdx.x / 32;
  const int t0 = k * BWD_TILE;
  cp_async_wait_all();                 // this thread's copies of tile k
  __syncthreads();                     // everyone's; tile k + 1 is done
  if (k > 0) {
    bwd_stage<T, N, VEC>(sh.stage[(k - 1) & 1], a, b, d0, k - 1, n_saves);
    cp_async_commit();
  }
  const BwdStage<T, N>& s = sh.stage[k & 1];
  float h[BWD_PAIR][QUAD];
  if (FULL || steps > SUB) {
#pragma unroll
    for (int kk = 0; kk < BWD_PAIR; ++kk) {
      const float4 v = s.h0[q][BWD_PAIR * p + kk];
      h[kk][0] = v.x; h[kk][1] = v.y; h[kk][2] = v.z; h[kk][3] = v.w;
    }
    bwd_half<T, N>(s, c, p, q, h);
    bwd_sub_tile<T, N, FULL>(sh, s, a, c, h, b, blk, t0 + SUB, SUB,
                             steps - SUB);
  }
#pragma unroll
  for (int kk = 0; kk < BWD_PAIR; ++kk) {
    const float4 v = s.h0[q][BWD_PAIR * p + kk];
    h[kk][0] = v.x; h[kk][1] = v.y; h[kk][2] = v.z; h[kk][3] = v.w;
  }
  bwd_sub_tile<T, N, FULL>(sh, s, a, c, h, b, blk, t0, 0, min(steps, SUB));
  __syncthreads();                     // every warp's (gb, gah) of the tile
  bwd_finish<T, N, FULL>(sh, s, a, c, b, d0, t0, steps);
}

// One block: BWD_CHANNELS = 64 channels of batch row b, thread (q, p) the
// states 4q .. 4q + 3 of channels 2p and 2p + 1, so a warp holds the same
// four states of 64 channels (B and C quads are broadcasts).  It walks the
// tiles from the last to the first, the next one's copy in flight while one
// is computed (the last, partial tile of a ragged S first, outside the
// loop).  dB and dC are written per (step, block) to dbc_part, dA and dD
// per batch row to da_part and dd_part; scan_bwd_reduce adds the blocks and
// rows in a fixed order.  No floating-point atomics, so two calls are
// bitwise equal.
template <typename T, int N, bool VEC>
__global__ void __launch_bounds__(32 * N / QUAD, BWD_MIN_BLOCKS)
scan_bwd_kernel(BwdArgs a) {
  constexpr int LANES = N / QUAD;
  extern __shared__ float4 bwd_smem[];
  BwdShared<T, N>& sh = *reinterpret_cast<BwdShared<T, N>*>(bwd_smem);
  const int tid = threadIdx.x;
  const int p = tid % 32, q = tid / 32;
  const int b = blockIdx.y, blk = blockIdx.x;
  const int d0 = blk * BWD_CHANNELS;
  const int n_saves = (a.S + BWD_TILE - 1) / BWD_TILE;
  const int rest = a.S % BWD_TILE;

  BwdCarry c;
#pragma unroll
  for (int k = 0; k < BWD_PAIR; ++k) {
    const int d = d0 + BWD_PAIR * p + k;
    const bool live = d < a.Di;
    const long long row = (static_cast<long long>(b) * a.Di + d) * N
                          + q * QUAD;
#pragma unroll
    for (int i = 0; i < QUAD; ++i) {
      c.A2[k][i] = live ? a.A[static_cast<long long>(d) * N + q * QUAD + i]
                          * LOG2E : 0.f;
      c.g[k][i] = (live && a.dh_last != nullptr) ? a.dh_last[row + i] : 0.f;
      c.dA[k][i] = 0.f;
    }
    c.Dv[k] = live ? a.D[d] : 0.f;
    c.dd[k] = 0.f;
  }

  // the tiles from the last to the first, the next one's copy in flight
  // while one is walked; a ragged S's partial tile (the last) before the
  // loop, so the loop holds only the full tile's code
  int kt = n_saves - 1;
  if (kt >= 0) {
    bwd_stage<T, N, VEC>(sh.stage[kt & 1], a, b, d0, kt, n_saves);
    cp_async_commit();
  }
  if (rest) {
    bwd_tile<T, N, VEC, false>(sh, a, c, b, blk, d0, kt, rest, n_saves);
    --kt;
  }
  for (; kt >= 0; --kt)
    bwd_tile<T, N, VEC, true>(sh, a, c, b, blk, d0, kt, BWD_TILE, n_saves);

  __syncthreads();                     // the last finishing read gp
  float* dd_sh = reinterpret_cast<float*>(&sh.gp[0][0][0]);
#pragma unroll
  for (int k = 0; k < BWD_PAIR; ++k)
    dd_sh[q * BWD_CHANNELS + BWD_PAIR * p + k] = c.dd[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < BWD_PAIR; ++k) {
    const int d = d0 + BWD_PAIR * p + k;
    if (d >= a.Di) continue;
    const long long row = (static_cast<long long>(b) * a.Di + d) * N
                          + q * QUAD;
    *reinterpret_cast<float4*>(a.da_part + row) =
        make_float4(c.dA[k][0], c.dA[k][1], c.dA[k][2], c.dA[k][3]);
    if (a.dh0 != nullptr)
      *reinterpret_cast<float4*>(a.dh0 + row) =
          make_float4(c.g[k][0], c.g[k][1], c.g[k][2], c.g[k][3]);
    if (q == 0) {
      float s = 0.f;
#pragma unroll
      for (int l = 0; l < LANES; ++l)
        s += dd_sh[l * BWD_CHANNELS + BWD_PAIR * p + k];
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
      // a block's partials of a step: (N / QUAD, 8), dB's quad then dC's
      const int m = col < n ? col : col - n;
      const int off = (m / QUAD) * 8 + (col < n ? 0 : QUAD) + m % QUAD;
      const float* p = dbc_part + row * nb * 2 * n + off;
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

template <typename T, int N, bool VEC>
int launch_bwd_vec(const BwdArgs& a, dim3 grid, int threads,
                   cudaStream_t stream) {
  constexpr int bytes = sizeof(BwdShared<T, N>);
  const cudaError_t err = cudaFuncSetAttribute(
      scan_bwd_kernel<T, N, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_bwd_kernel<T, N, VEC><<<grid, threads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int N>
int launch_bwd_n(const BwdArgs& a, dim3 grid, int threads, bool vec,
                 cudaStream_t stream) {
  return vec ? launch_bwd_vec<T, N, true>(a, grid, threads, stream)
             : launch_bwd_vec<T, N, false>(a, grid, threads, stream);
}

template <typename T>
int launch_bwd(const BwdArgs& a, dim3 grid, int threads, int n, bool vec,
               cudaStream_t stream) {
  switch (n) {
    case 4: return launch_bwd_n<T, 4>(a, grid, threads, vec, stream);
    case 8: return launch_bwd_n<T, 8>(a, grid, threads, vec, stream);
    case 16: return launch_bwd_n<T, 16>(a, grid, threads, vec, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks of scan_bwd_kernel<T, N, VEC> an SM holds at once, by the CUDA
// occupancy calculator, with its dynamic shared memory.
template <typename T, int N>
int bwd_occupancy(bool vec) {
  constexpr int bytes = sizeof(BwdShared<T, N>);
  int blocks = 0;
  auto kern = vec ? scan_bwd_kernel<T, N, true> : scan_bwd_kernel<T, N, false>;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes) != cudaSuccess)
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kern, 32 * N / QUAD, bytes) != cudaSuccess)
    return -1;
  return blocks;
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
// grid_x, N / QUAD, 8), da_part (Ba, Di, N) and dd_part (Ba, Di) are fp32
// scratch.  Two launches: scan_bwd_kernel on (grid_x, Ba) blocks of
// ``threads`` (ceil(Di / BWD_CHANNELS) and 32 * N / QUAD, as bwd_plan gives
// them), then scan_bwd_reduce on ``red_blocks`` blocks of REDUCE_THREADS.
// vec selects the 16-byte cp.async staging of u, dy, dt, B and C, which
// needs them 16-byte aligned with strides to match and Di % 8 == 0; states
// must be 16-byte aligned.
int repro_selective_scan_bwd(
    const void* u, long long u_sb, long long u_st, int u_dtype,
    const void* dt, long long dt_sb, long long dt_st, const void* A,
    const void* B, long long b_sb, long long b_st, const void* C,
    long long c_sb, long long c_st, const void* D, const void* states,
    const void* dy, const void* dh_last, void* du, void* ddt, void* dB,
    void* dC, void* dA, void* dD, void* dh0, void* dbc_part, void* da_part,
    void* dd_part, int ba, int s, int di, int n, int grid_x, int threads,
    int red_blocks, int vec, void* stream) {
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
  if (u_dtype == 0) err = launch_bwd<float>(a, grid, threads, n, vec != 0, st);
  else if (u_dtype == 1)
    err = launch_bwd<__nv_bfloat16>(a, grid, threads, n, vec != 0, st);
  else return static_cast<int>(cudaErrorInvalidValue);
  if (err != 0) return err;
  scan_bwd_reduce<<<red_blocks, REDUCE_THREADS, 0, st>>>(
      static_cast<const float*>(dbc_part), static_cast<const float*>(da_part),
      static_cast<const float*>(dd_part), static_cast<float*>(dB),
      static_cast<float*>(dC), static_cast<float*>(dA),
      static_cast<float*>(dD), ba, s, di, n, grid_x);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the backward's scan_bwd_kernel for (u_dtype, n, vec) that an SM
// holds at once, by the CUDA occupancy calculator; -1 on an error.
int repro_selective_scan_bwd_occupancy(int u_dtype, int n, int vec) {
  const bool v = vec != 0;
  if (u_dtype == 0) {
    if (n == 4) return bwd_occupancy<float, 4>(v);
    if (n == 8) return bwd_occupancy<float, 8>(v);
    if (n == 16) return bwd_occupancy<float, 16>(v);
  } else if (u_dtype == 1) {
    if (n == 4) return bwd_occupancy<__nv_bfloat16, 4>(v);
    if (n == 8) return bwd_occupancy<__nv_bfloat16, 8>(v);
    if (n == 16) return bwd_occupancy<__nv_bfloat16, 16>(v);
  }
  return -1;
}

}  // extern "C"
