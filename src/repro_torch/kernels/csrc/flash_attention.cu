// Hand-written CUDA attention kernels for Hopper (sm_90a): prefill flash
// attention (optionally with each row's log-sum-exp) and its backward, and
// single-token decode over a contiguous (possibly ring) cache or a
// block-paged cache.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/flash_attention/kernel.py:
//   prefill_wgmma_kernel (bf16, fp16) <- flash_attention_tpu (_flash_kernel, :152 -> :223)
//   prefill_kernel       (fp32)       <- the same
//   attn_bwd_dq_wgmma_kernel, attn_bwd_dkdv_wgmma_kernel (bf16, fp16)
//                        <- the gradient JAX takes of flash_attention_tpu (it
//                        has no custom_vjp; on the CPU JAX differentiates
//                        ref.chunked_attention)
//   attn_bwd_dq_kernel, attn_bwd_dkdv_kernel (fp32) <- the same
//   decode_kernel   <- decode_attention_tpu       (_decode_kernel, :236 -> :304)
//                   <- paged_decode_attention_tpu (_paged_decode_kernel, :316 -> :366)
//
// Semantics follow repro/kernels/flash_attention/ref.py, not the Pallas
// causal mask: queries are aligned to the END of the keys (qpos = i + Sk - Sq),
// a row whose every key is masked returns 0 (never NaN), scores are scaled by
// D^-0.5, and softmax state (m, l, acc) and P.V accumulate in fp32.
//
// What bounds them on an H100, and what the design does about it:
// * prefill, bf16/fp16: operations for long prompts (4*S^2*H*D/2 causal
//   FLOPs against B*S*(H+2KV)*D bytes), so the products run on the tensor
//   cores.  One block per (query tile, head, batch), one block an SM (its
//   ring takes 128 KB of shared memory at D128): a producer warp issues
//   TMA loads (Q once; K and V in 64-key tiles into an NSTAGE-deep ring, one
//   mbarrier "full" and one "empty" per stage) and one or two consumer
//   warpgroups of 64 query rows each run S = Q.K^T as wgmma m64n64k16 with
//   both operands in 128-byte-swizzled shared memory, the online softmax on
//   the accumulator fragment (a row lives in a quad of threads: two shuffles),
//   and O += P.V as wgmma m64nDk16 with P converted to 16 bits in registers
//   as the A operand (the accumulator layout of two n8 blocks is the A
//   fragment layout of one k16 step) and V read (keys, D) through the
//   transpose bit, so nothing is transposed.  O stays in registers (D/2 fp32
//   a thread), is normalised by l, staged through the warpgroup's Q tile and
//   written by a TMA store, which also clips rows past Sq.  Tensor maps are
//   4-D over the caller's (B, S, heads, D) strides with 64 x 64 boxes (128
//   bytes of D: D128 is two boxes, D256 four), encoded per call by the host.
//   D80 takes two boxes too: its maps end at column 80, so TMA zero-fills
//   columns 80-127 of the second box on a load and clips them on a store;
//   Q.K^T runs 5 k-steps and P.V is wgmma m64n80k16, whose MN-major V
//   spans a swizzle atom and a quarter (the backward's dQ, dK, dV alike).
//   Key tiles wholly past the causal edge or before the window are never
//   loaded; within a block a warpgroup also skips the products of a tile
//   wholly past its own rows; only tiles that straddle an edge are masked.
//   TMA zero-fills keys past Sk, and a zero score is not -inf, so those are
//   masked too.  The grid runs every head's last query tile (the longest
//   under the causal mask) before any shorter one, so the long blocks do
//   not form a tail.  P is rounded to 16 bits for P.V, as in
//   FlashAttention-2/3: with bf16 inputs that costs about one bf16 ulp of
//   the output.
// * prefill, fp32: tensor cores have no fp32 mode but TF32 (about three
//   decimal digits, below the 1e-4 the fp32 reference tier holds), so fp32
//   runs on the CUDA cores: each 128-thread block owns a 64-row query tile
//   of one (b, head), keeps Q and a 64-key K/V tile in shared memory and a
//   4x8 score tile and 4x(D/8) output tile per thread in registers.
// * decode and paged decode: bytes (the K/V cache is read once per step and
//   reused by all G query heads of its KV head, so one block carries all G
//   heads of one KV head: 128 threads up to G 8, 256 up to G 16).  The
//   cache is cut into n_split runs of whole 16-slot tiles
//   (kernel.py::split_plan, a function of (Lc, B, KV) alone, so both
//   layouts cut alike) and the grid is (KV, B, n_split), enough
//   blocks to fill 132 SMs.  A block copies its tiles with 16-byte cp.async,
//   up to NBUF tiles in flight while one is computed, and writes an fp32
//   partial (m, l, acc[G][D]) to a workspace; the last block of each
//   (b, kv head) to take a ticket merges the partials of the splits that
//   hold a valid slot in the same launch, every sum in an order fixed by
//   the split count and the thread layout, so the result depends only on
//   the partials: two runs are bitwise equal.  A split is short (4 tiles at
//   Lc 1056, B 8, KV 2), so the latency of its chain (pos, the copies, the
//   ticket, the merge's loads) and not the bytes sets the time.
//   Contiguous and paged differ only in where a tile lives
//   (b * s_b + t * 16 * s_l, or block_tables[b, t] * s_page with the table
//   read by the block itself), so paged equals contiguous bitwise.
//
// Every entry point returns cudaGetLastError() after its launch; the Python
// wrapper raises on anything nonzero, since a refused launch never runs.
#include <cuda.h>           // CUtensorMap and its enums only: the encoder is
                            // looked up at run time, so no -lcuda
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) { return __float2bfloat16(x); }
template <> __device__ __forceinline__ __half from_float<__half>(float x) { return __float2half(x); }

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;

// Raises a kernel's dynamic shared-memory limit once per device and
// instantiation (``done`` is the instantiation's own flag array), not on
// every launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, unsigned char* done) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = 1;
  return err;
}

// ---------------------------------------------------------------------------
// prefill, bf16 / fp16: TMA + mbarrier ring + wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(smem_u32(bar)) : "memory");
}

// Spins until the phase of ``bar`` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// One 64 x 64 box of a 4-D (D, S, heads, B) tensor map into shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int d0, int row, int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(d0), "r"(row), "r"(head), "r"(batch)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src,
                                          int d0, int row, int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)),
         "r"(d0), "r"(row), "r"(head), "r"(batch)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (all in 16-byte units), layout
// type 1 (SWIZZLE_128B) in bits 62-63.  Tiles are 1024-byte aligned, so
// the base offset is 0.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait1() { asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory"); }

// Keeps the compiler from touching accumulator registers across an
// asynchronous wgmma: their values are defined only after the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// Accumulator operand lists of the wgmma instructions (32, 40, 64 and 128
// fp32 registers a thread) and their PTX operand strings.
#define WG_ACC32(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
  "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31])

#define WG_ACC40(d) WG_ACC32(d), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), \
  "+f"(d[38]), "+f"(d[39])

#define WG_ACC64(d) WG_ACC32(d), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), \
  "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
  "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
  "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), \
  "+f"(d[62]), "+f"(d[63])

#define WG_ACC128(d) WG_ACC64(d), \
  "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), \
  "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), \
  "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), \
  "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
  "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), \
  "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), \
  "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), \
  "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
  "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), \
  "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), \
  "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

#define WG_D32 "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" "}"

#define WG_D40 "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39" "}"

#define WG_D64 "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" "}"

#define WG_D128 "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127" "}"

// D[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, A and B K-major in shared memory.
#define WGMMA_SS64(T, PTX_T)                                                       \
  __device__ __forceinline__ void wgmma_ss64(const T*, float* d, uint64_t da,     \
                                             uint64_t db, int acc) {              \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                      \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." PTX_T "." PTX_T " " \
                 WG_D32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"                          \
                 : WG_ACC32(d)                                                    \
                 : "l"(da), "l"(db), "r"(acc)                                     \
                 : "memory");                                                     \
  }

// D[64 x N] (+)= A[64 x 16] . B[16 x N], A in registers, B MN-major in
// shared memory (imm-trans-b = 1).  N 80 spans one 128-byte swizzle atom
// and a quarter of the next (LBO apart), which the tensor cores take.
#define WGMMA_RS(N, NR, T, PTX_T, A_OPS, IB, IP)                                   \
  __device__ __forceinline__ void wgmma_rs##N(const T*, float* d, const uint32_t* a, \
                                              uint64_t db, int acc) {              \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IP ", 0;\n"                   \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." PTX_T "." PTX_T " " \
                 WG_D##NR ", " A_OPS ", %" IB ", p, 1, 1, 1;\n}\n"                 \
                 : WG_ACC##NR(d)                                                  \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc)  \
                 : "memory");                                                     \
  }

WGMMA_SS64(__nv_bfloat16, "bf16")
WGMMA_SS64(__half, "f16")
WGMMA_RS(64, 32, __nv_bfloat16, "bf16", "{%32, %33, %34, %35}", "36", "37")
WGMMA_RS(64, 32, __half, "f16", "{%32, %33, %34, %35}", "36", "37")
WGMMA_RS(80, 40, __nv_bfloat16, "bf16", "{%40, %41, %42, %43}", "44", "45")
WGMMA_RS(80, 40, __half, "f16", "{%40, %41, %42, %43}", "44", "45")
WGMMA_RS(128, 64, __nv_bfloat16, "bf16", "{%64, %65, %66, %67}", "68", "69")
WGMMA_RS(128, 64, __half, "f16", "{%64, %65, %66, %67}", "68", "69")
WGMMA_RS(256, 128, __nv_bfloat16, "bf16", "{%128, %129, %130, %131}", "132", "133")
WGMMA_RS(256, 128, __half, "f16", "{%128, %129, %130, %131}", "132", "133")

template <typename T, int D>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a, uint64_t db) {
  if constexpr (D == 64) wgmma_rs64((const T*)nullptr, o, a, db, 1);
  else if constexpr (D == 80) wgmma_rs80((const T*)nullptr, o, a, db, 1);
  else if constexpr (D == 128) wgmma_rs128((const T*)nullptr, o, a, db, 1);
  else wgmma_rs256((const T*)nullptr, o, a, db, 1);
}

// 2^x on the SFU, denormals flushed (2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack2(float a, float b, const __nv_bfloat16*) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);      // a in the low half
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack2(float a, float b, const __half*) {
  __half2 h = __floats2half2_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

constexpr int TB = 64;           // query rows a warpgroup, keys a tile, rows a box
constexpr int BOX_BYTES = TB * 128;   // one 64-row x 128-byte swizzled box

// A head dim that is not a multiple of 64 (D 80) takes whole boxes of DP
// columns: its tensor maps end at D, so TMA fills columns D .. DP - 1 of the
// last box with zeros when it loads and clips them when it stores.  Q.K^T
// runs D / 16 k-steps and the products whose N is the head dim run at N = D,
// so the zero columns are loaded but never computed on.
template <int D>
struct PrefillCfg {
  static_assert(D % 16 == 0, "a k-step of Q.K^T is 16 columns of D");
  static constexpr int NCH = (D + 63) / 64;             // boxes across D
  static constexpr int DP = NCH * 64;                   // D padded to whole boxes
  static constexpr int NWG = DP == 256 ? 1 : 2;         // consumer warpgroups
  static constexpr int BQ = TB * NWG;                   // query rows a block
  static constexpr int NSTAGE = DP == 64 ? 4 : (DP == 128 ? 3 : 2);
  static constexpr int TILE_BYTES = NCH * BOX_BYTES;    // a 64-row tile
  static constexpr int THREADS = NWG * 128 + 32;        // + the producer warp
  static constexpr size_t SMEM = 1024 + (size_t)TILE_BYTES * (NWG + 2 * NSTAGE)
                                 + 8 * (2 * NSTAGE + 1);
};

// Shared memory (1024-byte aligned): Q [NWG][NCH][64][64], K and V
// [NSTAGE][NCH][64][64], each box 128-byte swizzled as TMA wrote it; then
// the mbarriers full[NSTAGE], empty[NSTAGE], q.  LSE: the training forward's
// instantiation, which also writes each row's log-sum-exp; the serve path
// runs the one without, whose body is the kernel's before the lse was added.
template <typename T, int D, bool LSE>
__global__ void __launch_bounds__(PrefillCfg<D>::THREADS, 1) prefill_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
    float* __restrict__ lse, int Sq, int Sk, int H, int KV, int causal, int window,
    float scale_log2) {
  using C = PrefillCfg<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Qs = smem;
  unsigned char* Ks = Qs + C::NWG * C::TILE_BYTES;
  unsigned char* Vs = Ks + C::NSTAGE * C::TILE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + C::NSTAGE * C::TILE_BYTES);
  uint64_t* empty = full + C::NSTAGE;
  uint64_t* qbar = empty + C::NSTAGE;

  // grid (H * B, query tiles): every head's last (longest, when causal)
  // query tile is scheduled before any head's shorter ones
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int kvh = h / (H / KV);
  const int off = Sk - Sq;                       // queries aligned to the key end
  const int q0 = qt * C::BQ;

  int kt_end = (Sk + TB - 1) / TB;
  if (causal) {
    const int maxq = min(q0 + C::BQ, Sq) - 1 + off;   // last key any row may see
    kt_end = maxq < 0 ? 0 : min(kt_end, maxq / TB + 1);
  }
  int kt_begin = 0;
  if (window) {
    const int lo = q0 + off - window + 1;             // first key the top row may see
    kt_begin = lo > 0 ? lo / TB : 0;
  }
  const int n_tiles = max(0, kt_end - kt_begin);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::NSTAGE; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::NWG * 4);      // lane 0 of every consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == C::NWG * 4) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      mbar_expect_tx(qbar, C::NWG * C::TILE_BYTES);
      for (int w = 0; w < C::NWG; ++w)
        for (int c = 0; c < C::NCH; ++c)
          tma_load(Qs + w * C::TILE_BYTES + c * BOX_BYTES, &tq, qbar, c * 64,
                   q0 + w * TB, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int stage = i % C::NSTAGE;
        if (i >= C::NSTAGE) mbar_wait(&empty[stage], ((i / C::NSTAGE) & 1) ^ 1);
        mbar_expect_tx(&full[stage], 2 * C::TILE_BYTES);
        const int k0 = (kt_begin + i) * TB;
        for (int c = 0; c < C::NCH; ++c) {
          tma_load(Ks + stage * C::TILE_BYTES + c * BOX_BYTES, &tk, &full[stage],
                   c * 64, k0, kvh, b);
          tma_load(Vs + stage * C::TILE_BYTES + c * BOX_BYTES, &tv, &full[stage],
                   c * 64, k0, kvh, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup w: query rows q0 + 64w .. q0 + 64w + 63
  const int w = warp / 4, t = threadIdx.x % 128, wq = t / 32;
  unsigned char* Qw = Qs + w * C::TILE_BYTES;
  const int r0 = wq * 16 + (lane >> 2);          // this thread's rows: r0, r0 + 8
  int qpos[2];
  qpos[0] = q0 + w * TB + r0 + off;
  qpos[1] = qpos[0] + 8;
  const int qlo = q0 + w * TB + off, qhi = qlo + TB - 1;   // this warpgroup's rows

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};

  mbar_wait(qbar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int stage = i % C::NSTAGE;
    mbar_wait(&full[stage], (i / C::NSTAGE) & 1);
    const int k0 = (kt_begin + i) * TB;
    const bool skip = (causal && k0 > qhi) || (window && k0 + TB - 1 <= qlo - window);
    if (!skip) {
      unsigned char* Kt = Ks + stage * C::TILE_BYTES;
      unsigned char* Vt = Vs + stage * C::TILE_BYTES;
      float s[32];
      fence_regs<32>(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t koff = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
        wgmma_ss64((const T*)nullptr, s, sw128_desc(smem_u32(Qw) + koff, 16, 1024),
                   sw128_desc(smem_u32(Kt) + koff, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs<32>(s);

      const bool need_mask = k0 + TB > Sk || (causal && k0 + TB - 1 > qlo) ||
                             (window && k0 <= qhi - window);
      const int kbase = k0 + (lane & 3) * 2;
      uint32_t pa[16];
      // the max is taken on the raw scores (the scale is positive) and the
      // scale folded into one FMA before each ex2: p = 2^(s c - m c)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float x = s[n8 * 4 + r * 2 + j];
            if (need_mask) {
              const int key = kbase + n8 * 8 + j;
              bool ok = key < Sk;
              if (causal) ok = ok && key <= qpos[r];
              if (window) ok = ok && key > qpos[r] - window;
              if (!ok) x = -INFINITY;
            }
            s[n8 * 4 + r * 2 + j] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
        const float m_new = fmaxf(m_r[r], mx);
        const float mc = m_new == -INFINITY ? 0.f : m_new * scale_log2;
        const float corr = ex2(fmaf(m_r[r], scale_log2, -mc));   // 0 while m_r is -inf
        m_r[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float p = ex2(fmaf(s[n8 * 4 + r * 2 + j], scale_log2, -mc));   // -inf -> 0
            s[n8 * 4 + r * 2 + j] = p;
            sum += p;
          }
        l_r[r] = l_r[r] * corr + sum;                  // this thread's columns
#pragma unroll
        for (int n8 = 0; n8 < D / 8; ++n8) {
          o[n8 * 4 + r * 2] *= corr;
          o[n8 * 4 + r * 2 + 1] *= corr;
        }
      }
      // the accumulator of key columns 16kk..16kk+15 is the A fragment of
      // k-step kk: (row r0, k 0-7), (r0 + 8, k 0-7), (r0, k 8-15), (r0 + 8, k 8-15)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pa[kk * 4 + e] = pack2(s[kk * 8 + e * 2], s[kk * 8 + e * 2 + 1], (const T*)nullptr);

      fence_regs<D / 2>(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)      // 16 keys a step: 16 rows of 128 bytes
        wgmma_pv<T, D>(o, pa + kk * 4,
                       sw128_desc(smem_u32(Vt) + kk * 16 * 128, BOX_BYTES, 1024));
      wgmma_commit();
      wgmma_wait0();
      fence_regs<D / 2>(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
  }

  // normalise, stage the tile in this warpgroup's Q boxes (same swizzle),
  // and store it with TMA, which clips rows past Sq and columns past D.
  // With ``lse`` (the training forward) each row's natural log-sum-exp of
  // the scaled scores is written too: m * scale + ln(l), -inf for a row
  // with no valid key.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(FULL, l, 1);
    l += __shfl_xor_sync(FULL, l, 2);
    if constexpr (LSE) {
      const int row = q0 + w * TB + r0 + 8 * r;
      if ((lane & 3) == 0 && row < Sq)
        lse[((long long)b * H + h) * Sq + row] =
            m_r[r] == -INFINITY ? -INFINITY
                                : m_r[r] * scale_log2 * 0.6931471805599453f + logf(l);
    }
    l_r[r] = 1.f / fmaxf(l, 1e-30f);
  }
  asm volatile("bar.sync %0, 128;" :: "r"(1 + w) : "memory");   // Q no longer read
#pragma unroll
  for (int n8 = 0; n8 < D / 8; ++n8)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      const int unit = (n8 % 8) ^ (row & 7);
      unsigned char* dst = Qw + (n8 / 8) * BOX_BYTES + row * 128 + unit * 16 + (lane & 3) * 4;
      *reinterpret_cast<uint32_t*>(dst) =
          pack2(o[n8 * 4 + r * 2] * l_r[r], o[n8 * 4 + r * 2 + 1] * l_r[r], (const T*)nullptr);
    }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" :: "r"(1 + w) : "memory");
  if (t == 0) {
    for (int c = 0; c < C::NCH; ++c) tma_store(&to, Qw + c * BOX_BYTES, c * 64, q0 + w * TB, h, b);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the CUDA runtime.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// A 4-D map (D, S, heads, B) over a (B, S, heads, D) tensor with element
// strides (sb, ss, sh) and a contiguous D, in 64 x 64 boxes, 128-byte swizzle.
template <typename T>
cudaError_t encode_bshd(CUtensorMap* map, const void* ptr, int B, int S, int heads,
                        int D, long long sb, long long ss, long long sh) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const CUtensorMapDataType dt = std::is_same<T, __half>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * sizeof(T), (cuuint64_t)sh * sizeof(T),
                                 (cuuint64_t)sb * sizeof(T)};
  const cuuint32_t box[4] = {64, TB, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, dt, 4, const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int D>
cudaError_t launch_prefill_wgmma(const void* q, const void* k, const void* v, void* o,
                                 float* lse, int B, int Sq, int Sk, int H, int KV,
                                 const long long* st, int causal, int window,
                                 float scale, cudaStream_t stream) {
  using C = PrefillCfg<D>;
  static unsigned char smem_set[MAX_DEVICES], smem_set_lse[MAX_DEVICES];
  cudaError_t err = lse ? allow_smem(prefill_wgmma_kernel<T, D, true>, C::SMEM, smem_set_lse)
                        : allow_smem(prefill_wgmma_kernel<T, D, false>, C::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  CUtensorMap mq, mk, mv, mo;
  if ((err = encode_bshd<T>(&mq, q, B, Sq, H, D, st[0], st[1], st[2])) != cudaSuccess ||
      (err = encode_bshd<T>(&mk, k, B, Sk, KV, D, st[3], st[4], st[5])) != cudaSuccess ||
      (err = encode_bshd<T>(&mv, v, B, Sk, KV, D, st[6], st[7], st[8])) != cudaSuccess ||
      (err = encode_bshd<T>(&mo, o, B, Sq, H, D, st[9], st[10], st[11])) != cudaSuccess)
    return err;
  dim3 grid(H * B, (Sq + C::BQ - 1) / C::BQ);
  if (lse)
    prefill_wgmma_kernel<T, D, true><<<grid, C::THREADS, C::SMEM, stream>>>(
        mq, mk, mv, mo, lse, Sq, Sk, H, KV, causal, window, scale * 1.4426950408889634f);
  else
    prefill_wgmma_kernel<T, D, false><<<grid, C::THREADS, C::SMEM, stream>>>(
        mq, mk, mv, mo, nullptr, Sq, Sk, H, KV, causal, window,
        scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// prefill, fp32: CUDA cores
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
    T* __restrict__ o, float* __restrict__ lse, int Sq, int Sk, int H, int KV,
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
    if (lse != nullptr && tx == 0)   // scores are pre-scaled: m + ln(l)
      lse[((long long)b * H + h) * Sq + r] =
          m_r[i] == -INFINITY ? -INFINITY : m_r[i] + logf(l_r[i]);
    const float inv_l = 1.f / fmaxf(l_r[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      ob[(long long)r * oss + tx + 8 * j] = from_float<T>(acc[i][j] * inv_l);
  }
}

template <int D>
cudaError_t launch_prefill_fp32(const void* q, const void* k, const void* v, void* o,
                                float* lse, int B, int Sq, int Sk, int H, int KV,
                                const long long* st, int causal, int window,
                                float scale, cudaStream_t stream) {
  static unsigned char smem_set[MAX_DEVICES];
  const size_t smem = prefill_smem_bytes<D>();
  cudaError_t err = allow_smem(prefill_kernel<float, D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  prefill_kernel<float, D><<<grid, PNT, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, Sq, Sk, H, KV,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], causal, window, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// decode: split over the cache, one launch (contiguous and paged share it)
// ---------------------------------------------------------------------------

constexpr int TILE = 16;       // cache slots per tile == the paged block size
constexpr int MAX_GROUP = 16;  // query heads per KV head (kernel.py reads it)
constexpr int NBUF = 4;        // tiles in flight a block
constexpr int MAX_SPLIT = 264;  // kernel.py's DECODE_BLOCKS bounds n_split

// NT threads a block: 16 lanes (one a slot of a tile) for each of MAXG
// query heads.  Up to 8 heads a KV head the block has 128 threads, up to
// 16 (chatglm3's 32/2, mistral-large's 96/8) 256.
template <typename T, int D, int NT>
struct DecodeCfg {
  static constexpr int MAXG = NT / TILE;              // query heads a block
  static constexpr int VEC = 16 / (int)sizeof(T);     // elements per 16-byte copy
  static constexpr int ROW = D + VEC;                 // padded: conflict-free rows
  static constexpr int TILE_ELEMS = TILE * ROW;
  static constexpr int QROW = D + 4;
  static constexpr int CPT = (D + NT - 1) / NT;       // output columns a thread
  // the tile buffers, which the merge's (m, l) pairs reuse once the last
  // tile is summed: as many bytes as the larger of the two
  static constexpr size_t TILE_BYTES = sizeof(T) * 2 * NBUF * TILE_ELEMS;
  static constexpr size_t MERGE_BYTES = sizeof(float) * 2 * MAXG * MAX_SPLIT;
  static constexpr size_t BUF_BYTES = TILE_BYTES > MERGE_BYTES ? TILE_BYTES : MERGE_BYTES;
  static constexpr size_t SMEM = BUF_BYTES +
                                 sizeof(float) * (MAXG * QROW + MAXG * TILE + MAXG);
  static_assert(D % VEC == 0 && BUF_BYTES % 16 == 0, "16-byte rows and buffers");
};

// fp32 floats of one split's partial: acc[G][D], then (m, l) for each head,
// padded so every partial starts 16-byte aligned
__host__ __device__ constexpr long long partial_len(int G, int D) {
  return (long long)G * D + 2 * MAX_GROUP;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// Grid (KV, B, n_split); split z covers tiles [z * tiles_per_split, ...).
// ws holds, per (b, kv head, split), acc[G][D] then (m, l)[G] in fp32
// (partial_len floats); counters one int per (b, kv head), zero between
// launches.
template <typename T, int D, int NT>
__global__ void __launch_bounds__(NT) decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, const int* __restrict__ pos,
    const int* __restrict__ block_tables, float* __restrict__ ws,
    int* __restrict__ counters, int H, int KV, int lc, int nb, int tiles_per_split,
    long long s_b, long long s_page, long long s_l, long long s_kv, float scale) {
  using C = DecodeCfg<T, D, NT>;
  constexpr int MAXG = C::MAXG;
  extern __shared__ __align__(16) unsigned char dsmem[];
  T* Kb = reinterpret_cast<T*>(dsmem);                            // [NBUF][TILE][ROW]
  T* Vb = Kb + NBUF * C::TILE_ELEMS;                              // [NBUF][TILE][ROW]
  float* Qs = reinterpret_cast<float*>(dsmem + C::BUF_BYTES);     // [MAXG][QROW]
  float* Ps = Qs + MAXG * C::QROW;                                // [MAXG][TILE]
  float* Cs = Ps + MAXG * TILE;                                   // [MAXG]
  float* Wz = reinterpret_cast<float*>(dsmem);   // [MAXG][MAX_SPLIT][2], merge only
  __shared__ int is_last;
  __shared__ float Linv[MAXG];

  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int n_split = gridDim.z, tid = threadIdx.x;
  const int G = H / KV;
  const int p = pos[b];
  const int ntiles = (lc + TILE - 1) / TILE;
  const int last = p < 0 ? -1 : min(ntiles - 1, p / TILE);
  const int t0 = split * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split - 1, last);   // t0 > t1: an empty split
  const int g = tid / TILE, c = tid % TILE;
  const bool act = g < G;

  // 16-byte copies of tile t into buffer buf, one commit group a tile (an
  // empty group past t1, so the group count stays fixed); slots outside
  // the mask are zero-filled (never read from the cache: they may hold
  // anything)
  auto load = [&](int t, int buf) {
    if (t > t1) {
      cp_async_commit();
      return;
    }
    const long long base = block_tables
        ? (long long)block_tables[(long long)b * nb + t] * s_page
        : (long long)b * s_b + (long long)t * TILE * s_l;
    constexpr int PER_ROW = D / C::VEC;
    for (int i = tid; i < TILE * PER_ROW; i += NT) {
      const int cc = i / PER_ROW, d = (i % PER_ROW) * C::VEC, slot = t * TILE + cc;
      const bool ok = slot < lc && slot <= p;
      const long long a = base + (long long)cc * s_l + (long long)kvh * s_kv + d;
      const int at = buf * C::TILE_ELEMS + cc * C::ROW + d;
      cp_async16(Kb + at, ok ? k + a : k, ok);
      cp_async16(Vb + at, ok ? v + a : v, ok);
    }
    cp_async_commit();
  };

  float m_run = -INFINITY, l_run = 0.f;   // replicated over the 16 lanes of head g
  float acc[MAXG][C::CPT];
#pragma unroll
  for (int gg = 0; gg < MAXG; ++gg)
#pragma unroll
    for (int j = 0; j < C::CPT; ++j) acc[gg][j] = 0.f;

#pragma unroll
  for (int i = 0; i < NBUF - 1; ++i) load(t0 + i, i);
  // Q while the first tiles are in flight
  const T* qb = q + ((long long)b * H + (long long)kvh * G) * D;   // (B, 1, H, D)
  if (t0 <= t1)
    for (int i = tid; i < G * D; i += NT)
      Qs[(i / D) * C::QROW + i % D] = to_float(qb[i]) * scale;
  for (int t = t0; t <= t1; ++t) {
    const int buf = (t - t0) % NBUF;
    load(t + NBUF - 1, (t - t0 + NBUF - 1) % NBUF);
    cp_async_wait<NBUF - 1>();             // tile t has landed
    __syncthreads();                       // tile t (and Q) visible to all

    const int slot = t * TILE + c;
    const bool valid = act && slot < lc && slot <= p;
    float s = -INFINITY;
    if (valid) {
      const T* kr = Kb + buf * C::TILE_ELEMS + c * C::ROW;
      const float* qr = Qs + g * C::QROW;
      float a[4] = {0.f, 0.f, 0.f, 0.f};     // four chains, summed in one order
#pragma unroll 4
      for (int d = 0; d < D; d += C::VEC) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kr + d);
        const T* kv = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int e = 0; e < C::VEC; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + d + e);
          a[0] = fmaf(qv.x, to_float(kv[e]), a[0]);
          a[1] = fmaf(qv.y, to_float(kv[e + 1]), a[1]);
          a[2] = fmaf(qv.z, to_float(kv[e + 2]), a[2]);
          a[3] = fmaf(qv.w, to_float(kv[e + 3]), a[3]);
        }
      }
      s = (a[0] + a[1]) + (a[2] + a[3]);
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
      Ps[g * TILE + c] = pr;
      if (c == 0) Cs[g] = corr;
    }
    __syncthreads();

    const T* vt = Vb + buf * C::TILE_ELEMS;
#pragma unroll
    for (int j = 0; j < C::CPT; ++j) {
      const int d = tid + j * NT;
      if (d >= D) continue;
      float vc[TILE];
#pragma unroll
      for (int cc = 0; cc < TILE; ++cc) vc[cc] = to_float(vt[cc * C::ROW + d]);
#pragma unroll
      for (int gg = 0; gg < MAXG; ++gg) {
        if (gg >= G) break;
        const float4* pr4 = reinterpret_cast<const float4*>(Ps + gg * TILE);
        float pv = 0.f;
#pragma unroll
        for (int c4 = 0; c4 < TILE / 4; ++c4) {
          const float4 p4 = pr4[c4];
          pv = fmaf(p4.x, vc[4 * c4], pv);
          pv = fmaf(p4.y, vc[4 * c4 + 1], pv);
          pv = fmaf(p4.z, vc[4 * c4 + 2], pv);
          pv = fmaf(p4.w, vc[4 * c4 + 3], pv);
        }
        acc[gg][j] = acc[gg][j] * Cs[gg] + pv;
      }
    }
    __syncthreads();                       // buf and Ps free for the next tile
  }
  cp_async_wait<0>();                      // no copy outlives the block

  // this split's partial; an empty split leaves (m, l) = (-inf, 0), acc 0
  // splits past the last valid slot are empty: the merge never reads them
  const int n_used = last < 0 ? 0 : min(n_split, last / tiles_per_split + 1);
  const long long part_len = partial_len(G, D);
  float* mine = ws + ((long long)(b * KV + kvh) * n_split + split) * part_len;
  if (split < n_used) {
#pragma unroll
    for (int j = 0; j < C::CPT; ++j) {
      const int d = tid + j * NT;
      if (d >= D) continue;
#pragma unroll
      for (int gg = 0; gg < MAXG; ++gg) {
        if (gg >= G) break;
        mine[gg * D + d] = acc[gg][j];
      }
    }
    if (act && c == 0) {
      mine[G * D + 2 * g] = m_run;
      mine[G * D + 2 * g + 1] = l_run;
    }
  }
  // the block's writes, ordered by the barrier, then released by thread 0's
  // fence before its ticket (the pattern of a cooperative grid sync)
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    is_last = atomicAdd(&counters[b * KV + kvh], 1) == n_split - 1;
    if (is_last) __threadfence();          // acquire the other blocks' partials
  }
  __syncthreads();
  if (!is_last) return;

  // The last block merges the partials.  Every sum runs in an order fixed
  // by (n_split, thread layout) alone, so the result depends only on the
  // partials.  First the 16 lanes of head g take the max of m over the
  // splits and each split's weight exp(m - M) (0 for an empty split) and
  // sum l * weight; then every thread sums weight * acc over the splits
  // for four columns at a time.
  const float* parts = ws + (long long)(b * KV + kvh) * n_split * part_len;
  float2* ML = reinterpret_cast<float2*>(Wz) + g * MAX_SPLIT;
  float mx2 = -INFINITY;
  if (act)
    for (int z = c; z < n_used; z += TILE) {
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(
          parts + z * part_len + G * D + 2 * g));
      ML[z] = ml;
      mx2 = fmaxf(mx2, ml.x);
    }
#pragma unroll
  for (int w = 8; w >= 1; w >>= 1) mx2 = fmaxf(mx2, __shfl_xor_sync(FULL, mx2, w, 16));
  float lsum = 0.f;
  if (act)
    for (int z = c; z < n_used; z += TILE) {
      const float2 ml = ML[z];
      const float wz = ml.x == -INFINITY ? 0.f : expf(ml.x - mx2);
      ML[z].x = wz;                        // the weight replaces m
      lsum = fmaf(ml.y, wz, lsum);
    }
#pragma unroll
  for (int w = 8; w >= 1; w >>= 1) lsum += __shfl_xor_sync(FULL, lsum, w, 16);
  if (act && c == 0) Linv[g] = 1.f / fmaxf(lsum, 1e-30f);
  __syncthreads();
  // four columns of one head a group, two groups a thread summed side by
  // side, so a thread has both groups' loads in flight
  T* ob = o + ((long long)b * H + (long long)kvh * G) * D;
  const float2* MLw = reinterpret_cast<const float2*>(Wz);
  constexpr int GROUPS_PER_HEAD = D / 4;
  const int n_groups = G * GROUPS_PER_HEAD;
  for (int i = tid; i < n_groups; i += 2 * NT) {
    const int i2 = i + NT < n_groups ? i + NT : i;       // a duplicate when odd
    const int ga = i / GROUPS_PER_HEAD, da = (i % GROUPS_PER_HEAD) * 4;
    const int gb = i2 / GROUPS_PER_HEAD, db = (i2 % GROUPS_PER_HEAD) * 4;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f), Bs = A;
#pragma unroll 8
    for (int z = 0; z < n_used; ++z) {
      const float* pz = parts + z * part_len;
      const float4 a = __ldcg(reinterpret_cast<const float4*>(pz + ga * D + da));
      const float4 bv = __ldcg(reinterpret_cast<const float4*>(pz + gb * D + db));
      const float wa = MLw[ga * MAX_SPLIT + z].x, wb = MLw[gb * MAX_SPLIT + z].x;
      A.x = fmaf(a.x, wa, A.x);
      A.y = fmaf(a.y, wa, A.y);
      A.z = fmaf(a.z, wa, A.z);
      A.w = fmaf(a.w, wa, A.w);
      Bs.x = fmaf(bv.x, wb, Bs.x);
      Bs.y = fmaf(bv.y, wb, Bs.y);
      Bs.z = fmaf(bv.z, wb, Bs.z);
      Bs.w = fmaf(bv.w, wb, Bs.w);
    }
    const float la = Linv[ga], lb = Linv[gb];
    ob[ga * D + da] = from_float<T>(A.x * la);
    ob[ga * D + da + 1] = from_float<T>(A.y * la);
    ob[ga * D + da + 2] = from_float<T>(A.z * la);
    ob[ga * D + da + 3] = from_float<T>(A.w * la);
    if (i2 != i) {
      ob[gb * D + db] = from_float<T>(Bs.x * lb);
      ob[gb * D + db + 1] = from_float<T>(Bs.y * lb);
      ob[gb * D + db + 2] = from_float<T>(Bs.z * lb);
      ob[gb * D + db + 3] = from_float<T>(Bs.w * lb);
    }
  }
  if (tid == 0) counters[b * KV + kvh] = 0;     // ready for the next launch
}

template <typename T, int D, int NT>
cudaError_t launch_decode_nt(const void* q, const void* k, const void* v, void* o,
                             const void* pos, const void* bt, void* ws, void* counters,
                             int B, int H, int KV, int lc, int nb, int tiles_per_split,
                             int n_split, long long s_b, long long s_page, long long s_l,
                             long long s_kv, float scale, cudaStream_t stream) {
  using C = DecodeCfg<T, D, NT>;
  static unsigned char smem_set[MAX_DEVICES];
  cudaError_t err = allow_smem(decode_kernel<T, D, NT>, C::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(KV, B, n_split);
  decode_kernel<T, D, NT><<<grid, NT, C::SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (const int*)pos, (const int*)bt,
      (float*)ws, (int*)counters, H, KV, lc, nb, tiles_per_split, s_b, s_page, s_l,
      s_kv, scale);
  return cudaGetLastError();
}

// 128 threads a block up to 8 query heads a KV head, 256 up to MAX_GROUP
template <typename T, int D>
cudaError_t launch_decode(const void* q, const void* k, const void* v, void* o,
                          const void* pos, const void* bt, void* ws, void* counters,
                          int B, int H, int KV, int lc, int nb, int tiles_per_split,
                          int n_split, long long s_b, long long s_page, long long s_l,
                          long long s_kv, float scale, cudaStream_t stream) {
  const int G = H / KV;
  if (n_split > MAX_SPLIT || G > MAX_GROUP) return cudaErrorInvalidValue;
  return G <= 8 ? launch_decode_nt<T, D, 128>(q, k, v, o, pos, bt, ws, counters, B, H, KV,
                                              lc, nb, tiles_per_split, n_split, s_b, s_page,
                                              s_l, s_kv, scale, stream)
                : launch_decode_nt<T, D, 256>(q, k, v, o, pos, bt, ws, counters, B, H, KV,
                                              lc, nb, tiles_per_split, n_split, s_b, s_page,
                                              s_l, s_kv, scale, stream);
}

// ---------------------------------------------------------------------------
// backward: dQ (and delta) a query tile, then dK/dV a key tile
// ---------------------------------------------------------------------------
//
// Replaces the gradient JAX takes of flash_attention_tpu (kernel.py:196; it
// has no custom_vjp, and on the CPU JAX differentiates ref.chunked_attention).
// From q, k, v, the forward's row log-sum-exp and dO, at fp32 accumulation:
//   P = exp(scale q.k - lse) (0 where masked),  dP = dO.v,
//   delta = rowsum(P dP),  dS = P (dP - delta),
//   dV = sum P^T dO,  dK = scale sum dS^T q,  dQ = scale sum dS k.
// delta is softmax's own backward term (what autograd computes), not
// FlashAttention-2's rowsum(dO o): with a bf16 o, the rounded output would
// move a row's delta by ~|dO||o| 2^-9 and dS with it (7% of a dq row's RMS
// against fp32 autograd at qwen2's layer shape), while P dP is consistent
// with the P and dP the kernels use.  Two launches, in this order on the
// stream: the dQ kernel owns a query tile of one (head, batch), walks its
// key tiles twice (first delta, which it writes, then dQ), and the dK/dV
// kernel owns a 64-key tile of one (kv head, batch) and walks the G query
// heads of its group and their query tiles, reading that delta.  So the two
// run 9 products for the work's 5: S and dP twice in the dQ kernel, then
// S^T, dP^T, dV and dK.  No float atomics: every block owns its outputs,
// walks its tiles in a fixed order, and sums across threads in a fixed
// tree, so two calls are bitwise equal.
//
// What bounds it on an H100: operations, 10 D FLOPs a (query, key) pair
// under the mask (18 D for the 9 products the kernels run), against the
// B S (3H + 4KV) D 16-bit bytes moved once.
//
// bf16 / fp16 run on the tensor cores (attn_bwd_dq_wgmma_kernel,
// attn_bwd_dkdv_wgmma_kernel), with the prefill's machinery: 4-D tensor
// maps over the caller's strides, 64 x 64 boxes into 128-byte-swizzled
// shared memory, mbarrier rings fed by a producer warp, and wgmma in the
// prefill's two forms.
// * wgmma m64n64k16 with both operands K-major in shared memory (D the
//   reduction dim): S = Q.K^T and dP = dO.V^T in the dQ kernel, S^T = K.Q^T
//   and dP^T = V.dO^T in the dK/dV kernel, whose 64 keys are the M rows.
// * wgmma m64nDk16 with A in registers and B MN-major (the transpose bit):
//   dQ += dS.K (K tile as (keys, D)), dV += P^T.dO and dK += dS^T.Q (the
//   query tiles as (queries, D)).  P^T and dS^T are born in the
//   accumulator layout with keys as rows, which is the A fragment's layout
//   (two n8 blocks of the accumulator are one k16 step of A), so nothing
//   passes through shared memory transposed (FlashAttention-3's
//   arrangement).  P and dS are rounded to q's 16-bit type there, the only
//   rounding before the output's; delta and dS - from fp32 P and dP - and
//   every sum stay fp32.
// The dQ kernel: BWD_DQ_WGS consumer warpgroups of 64 query rows each hold
// their Q and dO tiles, K and V stream through an NSTAGE ring (the key
// range twice); dQ (D/2 fp32 a thread) stays in registers.  The dK/dV
// kernel: K and V stay resident; the G heads of the group are split over
// BWD_DKDV_WGS consumer warpgroups (head g to warpgroup g % BWD_DKDV_WGS),
// each with its own ring of Q, dO, lse and delta tiles and its own producer
// warp; dK and dV (2 x D/2 fp32 a thread) stay in registers
// (setmaxnreg moves the producer warpgroup's registers to the consumers),
// and the second warpgroup's sums are added to the first's through shared
// memory, in that order.  Query tiles that see none of a block's keys,
// and key tiles that none of its rows sees, are never loaded; only tiles
// that straddle an edge are masked.  TMA zero-fills rows past Sq or Sk:
// keys past Sk are masked, and a row past Sq or with no key (lse -inf)
// takes lse = +inf, so its P is 0.  The dQ grid runs the last query tile
// of every head (the longest, when causal) first, the dK/dV grid the first
// key tile of every group first.

constexpr int BWD_DQ_WGS = 2;     // consumer warpgroups a dQ block (64 rows each)
constexpr int BWD_DKDV_WGS = 2;   // consumer warpgroups a dK/dV block (heads split)

constexpr float LOG2E = 1.4426950408889634f;

// D 80 as the prefill takes it (PrefillCfg): whole boxes of DP columns,
// zero-filled past D; the products whose N is the head dim run at N = D.
template <int D>
struct BwdDqCfg {
  static constexpr int NWG = BWD_DQ_WGS;
  static constexpr int BQ = TB * NWG;                   // query rows a block
  static constexpr int NCH = PrefillCfg<D>::NCH;
  static constexpr int DP = PrefillCfg<D>::DP;
  static constexpr int NSTAGE = DP == 64 ? 4 : 3;
  static constexpr int TILE_BYTES = NCH * BOX_BYTES;
  static constexpr int THREADS = NWG * 128 + 32;        // + the producer warp
  static constexpr size_t SMEM = 1024 + (size_t)TILE_BYTES * (2 * NWG + 2 * NSTAGE)
                                 + 8 * (2 * NSTAGE + 1);
};

template <int D>
struct BwdDkdvCfg {
  static constexpr int NWG = BWD_DKDV_WGS;
  static constexpr int NCH = PrefillCfg<D>::NCH;
  static constexpr int DP = PrefillCfg<D>::DP;
  static constexpr int NSTAGE = DP == 64 ? 4 : 2;
  static constexpr int TILE_BYTES = NCH * BOX_BYTES;
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;    // a Q and a dO tile
  static constexpr int RING_BYTES = NSTAGE * STAGE_BYTES;
  static constexpr int THREADS = (NWG + 1) * 128;       // + the producer warpgroup
  static constexpr int NBAR = 2 * NWG * NSTAGE + 1;
  static constexpr size_t SMEM = 1024 + 2 * (size_t)TILE_BYTES + (size_t)NWG * RING_BYTES
                                 + sizeof(float) * 2 * TB * NWG * NSTAGE + 8 * NBAR;
  // a warpgroup's dK and dV, in fp32, fit in its ring for the final sum
  static_assert(RING_BYTES >= 2 * TB * D * (int)sizeof(float), "ring too small");
  static_assert(NWG == 2, "the final sum adds the second warpgroup's dK, dV to the first's");
};

// Row r's log-sum-exp in log2 units, +inf where the row lies past Sq or
// sees no key (lse -inf): exp2(x - inf) = 0 makes its P 0.
__device__ __forceinline__ float bwd_lse2(const float* __restrict__ lse, long long bh,
                                          int row, int Sq) {
  const float l = row < Sq ? lse[bh * Sq + row] : -INFINITY;
  return l == -INFINITY ? INFINITY : l * LOG2E;
}

// 16-bit pairs of consecutive accumulator values (the A fragment of 4 k16
// steps, as in the prefill's P.V) from a 64 x 64 fp32 accumulator
template <typename T>
__device__ __forceinline__ void bwd_pack(uint32_t* a, const float* s) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[kk * 4 + e] = pack2(s[kk * 8 + e * 2], s[kk * 8 + e * 2 + 1], (const T*)nullptr);
}

// acc[64 x 64] = A[64 x D] . B[64 x D]^T, both K-major tiles of NCH boxes
template <typename T, int D>
__device__ __forceinline__ void bwd_ss(float* acc, const unsigned char* a,
                                       const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t koff = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
    wgmma_ss64((const T*)nullptr, acc, sw128_desc(smem_u32(a) + koff, 16, 1024),
               sw128_desc(smem_u32(b) + koff, 16, 1024), kk > 0);
  }
}

// acc[64 x D] += A[64 x 64] . B[64 x D], A in registers (bwd_pack), B a
// (64 rows, D) tile read MN-major
template <typename T, int D>
__device__ __forceinline__ void bwd_rs(float* acc, const uint32_t* a, const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)      // 16 rows of B a step: 16 x 128 bytes
    wgmma_pv<T, D>(acc, a + kk * 4, sw128_desc(smem_u32(b) + kk * 16 * 128, BOX_BYTES, 1024));
}

// grid (H * B, ceil(Sq / BQ)); dq contiguous (B, Sq, H, D); delta (B, H, Sq)
template <typename T, int D>
__global__ void __launch_bounds__(BwdDqCfg<D>::THREADS, 1) attn_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, float* __restrict__ delta, T* __restrict__ dq, int Sq,
    int Sk, int H, int KV, int causal, int window, float scale, float scale_log2) {
  using C = BwdDqCfg<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Qs = smem;                               // [NWG] tiles
  unsigned char* dOs = Qs + C::NWG * C::TILE_BYTES;       // [NWG]
  unsigned char* Ks = dOs + C::NWG * C::TILE_BYTES;       // [NSTAGE]
  unsigned char* Vs = Ks + C::NSTAGE * C::TILE_BYTES;     // [NSTAGE]
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + C::NSTAGE * C::TILE_BYTES);
  uint64_t* empty = full + C::NSTAGE;
  uint64_t* qbar = empty + C::NSTAGE;

  const int qt = gridDim.y - 1 - blockIdx.y;        // the longest tiles first
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int kvh = h / (H / KV);
  const int off = Sk - Sq;
  const int q0 = qt * C::BQ;

  // the forward's key range for these rows (as the prefill's)
  int kt_end = (Sk + TB - 1) / TB;
  if (causal) {
    const int maxq = min(q0 + C::BQ, Sq) - 1 + off;
    kt_end = maxq < 0 ? 0 : min(kt_end, maxq / TB + 1);
  }
  int kt_begin = 0;
  if (window) {
    const int lo = q0 + off - window + 1;
    kt_begin = lo > 0 ? lo / TB : 0;
  }
  const int n_tiles = max(0, kt_end - kt_begin);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::NSTAGE; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::NWG * 4);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == C::NWG * 4) {
    // producer: Q and dO once, then the key range twice through the ring
    if (lane == 0) {
      mbar_expect_tx(qbar, 2 * C::NWG * C::TILE_BYTES);
      for (int w = 0; w < C::NWG; ++w)
        for (int c = 0; c < C::NCH; ++c) {
          const int off_b = w * C::TILE_BYTES + c * BOX_BYTES;
          tma_load(Qs + off_b, &tq, qbar, c * 64, q0 + w * TB, h, b);
          tma_load(dOs + off_b, &tdo, qbar, c * 64, q0 + w * TB, h, b);
        }
      for (int i = 0; i < 2 * n_tiles; ++i) {
        const int stage = i % C::NSTAGE;
        if (i >= C::NSTAGE) mbar_wait(&empty[stage], ((i / C::NSTAGE) & 1) ^ 1);
        mbar_expect_tx(&full[stage], 2 * C::TILE_BYTES);
        const int k0 = (kt_begin + i % n_tiles) * TB;
        for (int c = 0; c < C::NCH; ++c) {
          tma_load(Ks + stage * C::TILE_BYTES + c * BOX_BYTES, &tk, &full[stage], c * 64, k0,
                   kvh, b);
          tma_load(Vs + stage * C::TILE_BYTES + c * BOX_BYTES, &tv, &full[stage], c * 64, k0,
                   kvh, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup w: query rows q0 + 64w .. q0 + 64w + 63
  const int w = warp / 4, t = threadIdx.x % 128, wq = t / 32;
  const unsigned char* Qw = Qs + w * C::TILE_BYTES;
  const unsigned char* dOw = dOs + w * C::TILE_BYTES;
  const int r0 = wq * 16 + (lane >> 2);             // this thread's rows: r0, r0 + 8
  const int row0 = q0 + w * TB + r0;
  const int qlo = q0 + w * TB + off, qhi = qlo + TB - 1;
  const long long bh = (long long)b * H + h;
  float lq[2], dl[2] = {0.f, 0.f}, part[2] = {0.f, 0.f};
  int qpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lq[r] = bwd_lse2(lse, bh, row0 + 8 * r, Sq);
    qpos[r] = row0 + 8 * r + off;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(qbar, 0);
  for (int pass = 0; pass < 2; ++pass) {
    for (int j = 0; j < n_tiles; ++j) {
      const int i = pass * n_tiles + j;
      const int stage = i % C::NSTAGE;
      mbar_wait(&full[stage], (i / C::NSTAGE) & 1);
      const int k0 = (kt_begin + j) * TB;
      const bool skip = (causal && k0 > qhi) || (window && k0 + TB - 1 <= qlo - window);
      if (!skip) {
        const unsigned char* Kt = Ks + stage * C::TILE_BYTES;
        const unsigned char* Vt = Vs + stage * C::TILE_BYTES;
        float s[32], dp[32];
        // S and dP in two groups: P's exponentials run while dP is computed
        fence_regs<32>(s);
        fence_regs<32>(dp);
        wgmma_fence();
        bwd_ss<T, D>(s, Qw, Kt);
        wgmma_commit();
        bwd_ss<T, D>(dp, dOw, Vt);
        wgmma_commit();
        wgmma_wait1();
        fence_regs<32>(s);
        const bool need_mask = k0 + TB > Sk || (causal && k0 + TB - 1 > qlo) ||
                               (window && k0 <= qhi - window);
        const int kbase = k0 + (lane & 3) * 2;
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              const int idx = n8 * 4 + r * 2 + jj;
              float p = ex2(fmaf(s[idx], scale_log2, -lq[r]));
              if (need_mask) {
                const int key = kbase + n8 * 8 + jj;
                bool ok = key < Sk;
                if (causal) ok = ok && key <= qpos[r];
                if (window) ok = ok && key > qpos[r] - window;
                if (!ok) p = 0.f;
              }
              s[idx] = p;
            }
        wgmma_wait0();
        fence_regs<32>(dp);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              const int idx = n8 * 4 + r * 2 + jj;
              if (pass == 0) part[r] = fmaf(s[idx], dp[idx], part[r]);
              else s[idx] = s[idx] * (dp[idx] - dl[r]);     // dS
            }
        if (pass == 1) {
          uint32_t pa[16];
          bwd_pack<T>(pa, s);
          fence_regs<D / 2>(acc);
          wgmma_fence();
          bwd_rs<T, D>(acc, pa, Kt);
          wgmma_commit();
          wgmma_wait0();
          fence_regs<D / 2>(acc);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
    }
    if (pass == 0) {
      // delta: each thread's columns in key order, then the row's quad
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float d = part[r];
        d += __shfl_xor_sync(FULL, d, 1);
        d += __shfl_xor_sync(FULL, d, 2);
        dl[r] = d;
        if ((lane & 3) == 0 && row0 + 8 * r < Sq) delta[bh * Sq + row0 + 8 * r] = d;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    T* dst = dq + (((long long)b * Sq + row) * H + h) * D + (lane & 3) * 2;
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8)
      *reinterpret_cast<uint32_t*>(dst + n8 * 8) =
          pack2(acc[n8 * 4 + r * 2] * scale, acc[n8 * 4 + r * 2 + 1] * scale, (const T*)nullptr);
  }
}

// grid (KV * B, ceil(Sk / 64)); dk, dv contiguous (B, Sk, KV, D)
template <typename T, int D>
__global__ void __launch_bounds__(BwdDkdvCfg<D>::THREADS, 1) attn_bwd_dkdv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dk,
    T* __restrict__ dv, int Sq, int Sk, int H, int KV, int causal, int window, float scale,
    float scale_log2) {
  using C = BwdDkdvCfg<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Ks = smem;
  unsigned char* Vs = Ks + C::TILE_BYTES;
  unsigned char* ring = Vs + C::TILE_BYTES;               // [NWG][NSTAGE] {Q, dO}
  float* Ls = reinterpret_cast<float*>(ring + C::NWG * C::RING_BYTES);   // [NWG][NSTAGE][64]
  float* Dls = Ls + C::NWG * C::NSTAGE * TB;                             // [NWG][NSTAGE][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(Dls + C::NWG * C::NSTAGE * TB);
  uint64_t* empty = full + C::NWG * C::NSTAGE;
  uint64_t* kvbar = empty + C::NWG * C::NSTAGE;

  const int k0 = blockIdx.y * TB;                   // the first (longest) key tiles first
  const int kvh = blockIdx.x % KV, b = blockIdx.x / KV;
  const int G = H / KV, off = Sk - Sq;

  // the query tiles that may see a key of this tile
  int qt_begin = 0, qt_end = (Sq + TB - 1) / TB;
  if (causal) {
    const int first = k0 - off;                     // first row whose qpos >= k0
    qt_begin = first > 0 ? first / TB : 0;
  }
  if (window) {
    const int last = k0 + TB - 1 + window - 1 - off;   // last row that may see the tile
    qt_end = last < 0 ? 0 : min(qt_end, last / TB + 1);
  }
  const int nq = max(0, qt_end - qt_begin);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::NWG * C::NSTAGE; ++s) {
      mbar_init(&full[s], 1 + 32);      // the TMA bytes, and the 32 lanes' lse / delta
      mbar_init(&empty[s], 4);          // lane 0 of each warp of the consumer warpgroup
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= C::NWG * 4) {
    // producer warpgroup: warp pw feeds consumer warpgroup pw's ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    const int pw = warp - C::NWG * 4;
    if (pw == 0 && lane == 0) {
      mbar_expect_tx(kvbar, 2 * C::TILE_BYTES);
      for (int c = 0; c < C::NCH; ++c) {
        tma_load(Ks + c * BOX_BYTES, &tk, kvbar, c * 64, k0, kvh, b);
        tma_load(Vs + c * BOX_BYTES, &tv, kvbar, c * 64, k0, kvh, b);
      }
    }
    if (pw < C::NWG) {
      const int n_items = (G - pw + C::NWG - 1) / C::NWG * nq;
      for (int i = 0; i < n_items; ++i) {
        const int h = kvh * G + pw + C::NWG * (i / nq);
        const int q0 = (qt_begin + i % nq) * TB;
        const int ri = pw * C::NSTAGE + i % C::NSTAGE;
        if (i >= C::NSTAGE) mbar_wait(&empty[ri], ((i / C::NSTAGE) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&full[ri], C::STAGE_BYTES);
          unsigned char* st = ring + ri * C::STAGE_BYTES;
          for (int c = 0; c < C::NCH; ++c) {
            tma_load(st + c * BOX_BYTES, &tq, &full[ri], c * 64, q0, h, b);
            tma_load(st + C::TILE_BYTES + c * BOX_BYTES, &tdo, &full[ri], c * 64, q0, h, b);
          }
        }
        const long long bh = (long long)b * H + h;
        for (int r = lane; r < TB; r += 32) {
          Ls[ri * TB + r] = bwd_lse2(lse, bh, q0 + r, Sq);
          Dls[ri * TB + r] = q0 + r < Sq ? delta[bh * Sq + q0 + r] : 0.f;
        }
        mbar_arrive(&full[ri]);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");

  // consumer warpgroup w: heads w, w + NWG, ... of the group; keys k0 .. k0 + 63
  const int w = warp / 4, t = threadIdx.x % 128, wq = t / 32;
  const int r0 = wq * 16 + (lane >> 2);             // this thread's keys: k0 + r0, + 8
  int key[2];
  key[0] = k0 + r0;
  key[1] = key[0] + 8;
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  const int n_items = (G - w + C::NWG - 1) / C::NWG * nq;
  mbar_wait(kvbar, 0);
  for (int i = 0; i < n_items; ++i) {
    const int q0 = (qt_begin + i % nq) * TB;
    const int ri = w * C::NSTAGE + i % C::NSTAGE;
    mbar_wait(&full[ri], (i / C::NSTAGE) & 1);
    const unsigned char* Qt = ring + ri * C::STAGE_BYTES;
    const unsigned char* dOt = Qt + C::TILE_BYTES;
    const float* L = Ls + ri * TB;
    const float* Dl = Dls + ri * TB;
    float s[32], dp[32];
    // S^T and dP^T in two groups: P^T's exponentials run while dP^T is
    // computed, and dV's product is issued before dS^T is formed
    fence_regs<32>(s);
    fence_regs<32>(dp);
    wgmma_fence();
    bwd_ss<T, D>(s, Ks, Qt);                        // S^T = K Q^T
    wgmma_commit();
    bwd_ss<T, D>(dp, Vs, dOt);                      // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait1();
    fence_regs<32>(s);
    const bool need_mask = k0 + TB > Sk || (causal && k0 + TB - 1 > q0 + off) ||
                           (window && k0 <= q0 + TB - 1 + off - window);
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int col = n8 * 8 + (lane & 3) * 2 + jj;   // this element's query
        const float lq = L[col];
        const int qpos = q0 + col + off;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int idx = n8 * 4 + r * 2 + jj;
          float p = ex2(fmaf(s[idx], scale_log2, -lq));
          if (need_mask) {
            bool ok = key[r] < Sk;
            if (causal) ok = ok && key[r] <= qpos;
            if (window) ok = ok && key[r] > qpos - window;
            if (!ok) p = 0.f;
          }
          s[idx] = p;                                  // P^T
        }
      }
    uint32_t pa[16], pb[16];
    bwd_pack<T>(pa, s);
    wgmma_wait0();
    fence_regs<32>(dp);
    fence_regs<D / 2>(dva);
    wgmma_fence();
    bwd_rs<T, D>(dva, pa, dOt);                       // dV += P^T dO
    wgmma_commit();
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const float dl = Dl[n8 * 8 + (lane & 3) * 2 + jj];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int idx = n8 * 4 + r * 2 + jj;
          dp[idx] = s[idx] * (dp[idx] - dl);           // dS^T
        }
      }
    bwd_pack<T>(pb, dp);
    fence_regs<D / 2>(dka);
    wgmma_fence();
    bwd_rs<T, D>(dka, pb, Qt);                        // dK += dS^T Q
    wgmma_commit();
    wgmma_wait0();
    fence_regs<D / 2>(dva);
    fence_regs<D / 2>(dka);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[ri]);
  }

  // the second warpgroup's sums, through its own (drained) ring, added to
  // the first's: (heads 0, 2, ..) + (heads 1, 3, ..)
  float* red = reinterpret_cast<float*>(ring + C::RING_BYTES);
  if (w == 1) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      red[i * 128 + t] = dka[i];
      red[(D / 2 + i) * 128 + t] = dva[i];
    }
  }
  asm volatile("bar.sync 1, 256;" ::: "memory");
  if (w == 1) return;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dka[i] += red[i * 128 + t];
    dva[i] += red[(D / 2 + i) * 128 + t];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= Sk) continue;
    const long long base = (((long long)b * Sk + key[r]) * KV + kvh) * D + (lane & 3) * 2;
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8) {
      *reinterpret_cast<uint32_t*>(dk + base + n8 * 8) =
          pack2(dka[n8 * 4 + r * 2] * scale, dka[n8 * 4 + r * 2 + 1] * scale, (const T*)nullptr);
      *reinterpret_cast<uint32_t*>(dv + base + n8 * 8) =
          pack2(dva[n8 * 4 + r * 2], dva[n8 * 4 + r * 2 + 1], (const T*)nullptr);
    }
  }
}

// strides st: q, k, v, dO, three each (batch, seq, head), in elements, all
// multiples of 16 bytes (kernel.py checks)
template <typename T, int D>
cudaError_t launch_backward_wgmma(const void* q, const void* k, const void* v,
                                  const void* lse, const void* dout, void* dq, void* dk,
                                  void* dv, void* delta, int B, int Sq, int Sk, int H, int KV,
                                  const long long* st, int causal, int window, float scale,
                                  cudaStream_t stream) {
  using CQ = BwdDqCfg<D>;
  using CK = BwdDkdvCfg<D>;
  static unsigned char smem_dq[MAX_DEVICES], smem_dkdv[MAX_DEVICES];
  cudaError_t err = allow_smem(attn_bwd_dq_wgmma_kernel<T, D>, CQ::SMEM, smem_dq);
  if (err != cudaSuccess) return err;
  if ((err = allow_smem(attn_bwd_dkdv_wgmma_kernel<T, D>, CK::SMEM, smem_dkdv)) != cudaSuccess)
    return err;
  CUtensorMap mq, mk, mv, mdo;
  if ((err = encode_bshd<T>(&mq, q, B, Sq, H, D, st[0], st[1], st[2])) != cudaSuccess ||
      (err = encode_bshd<T>(&mk, k, B, Sk, KV, D, st[3], st[4], st[5])) != cudaSuccess ||
      (err = encode_bshd<T>(&mv, v, B, Sk, KV, D, st[6], st[7], st[8])) != cudaSuccess ||
      (err = encode_bshd<T>(&mdo, dout, B, Sq, H, D, st[9], st[10], st[11])) != cudaSuccess)
    return err;
  const float scale_log2 = scale * LOG2E;
  // dQ first: it writes the delta that dK/dV reads
  attn_bwd_dq_wgmma_kernel<T, D><<<dim3(H * B, (Sq + CQ::BQ - 1) / CQ::BQ), CQ::THREADS,
                                   CQ::SMEM, stream>>>(
      mq, mk, mv, mdo, (const float*)lse, (float*)delta, (T*)dq, Sq, Sk, H, KV, causal,
      window, scale, scale_log2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attn_bwd_dkdv_wgmma_kernel<T, D><<<dim3(KV * B, (Sk + TB - 1) / TB), CK::THREADS, CK::SMEM,
                                     stream>>>(
      mq, mk, mv, mdo, (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, Sq, Sk, H, KV,
      causal, window, scale, scale_log2);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward, fp32: the same two launches on the CUDA cores
// ---------------------------------------------------------------------------
//
// The tensor cores' only fp32 mode (TF32) keeps about three decimal digits,
// below the 1e-4 the fp32 tier holds, so fp32 runs attn_bwd_dq_kernel and
// attn_bwd_dkdv_kernel: tiles live in shared memory as fp32 rows padded to
// D + 1; 256 threads a block hold a 2 x 8 piece of each 64 x 64 score tile
// and a 2 x D/8 piece of the accumulators; the dQ kernel's first pass over
// its key tiles computes delta, its second dQ.

constexpr int BWD_THREADS = 256;   // 32 row pairs x 8 column lanes
constexpr int BT = 64;             // query rows and keys a tile

template <int D>
constexpr size_t bwd_smem_bytes() {
  // four (BT, D + 1) tiles, two (BT, BT + 1) tiles, lse and delta of a tile
  return sizeof(float) * (size_t)(4 * BT * (D + 1) + 2 * BT * (BT + 1) + 2 * BT);
}

// rows r0 .. r0 + BT - 1 of one (batch, head) slice ``base`` (row stride
// ``ss``, contiguous D) into a padded fp32 tile; rows past S read as zero
template <typename T, int D>
__device__ __forceinline__ void bwd_load_tile(float* dst, const T* __restrict__ base,
                                              long long ss, int r0, int S) {
  for (int idx = threadIdx.x; idx < BT * D; idx += BWD_THREADS) {
    const int r = idx / D, d = idx % D, sr = r0 + r;
    dst[r * (D + 1) + d] = sr < S ? to_float(base[(long long)sr * ss + d]) : 0.f;
  }
}

// s[i][j] = sum_d A[ty*2 + i][d] * Bm[tx + 8j][d] over two padded tiles
template <int D>
__device__ __forceinline__ void bwd_tile_dot(float (&s)[2][8], const float* A,
                                             const float* Bm, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[2], bv[8];
#pragma unroll
    for (int i = 0; i < 2; ++i) a[i] = A[(ty * 2 + i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 8; ++j) bv[j] = Bm[(tx + 8 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = fmaf(a[i], bv[j], s[i][j]);
  }
}

// the forward's mask: queries aligned to the end of the keys
__device__ __forceinline__ bool bwd_valid(int qrow, int key, int Sq, int Sk, int causal,
                                          int window) {
  if (qrow >= Sq || key >= Sk) return false;
  const int qpos = qrow + Sk - Sq;
  if (causal && key > qpos) return false;
  if (window && key <= qpos - window) return false;
  return true;
}

// P (into p) and dP (into dp) of this thread's 2 x 8 piece of one (query
// tile q0, key tile k0) pair, from the tiles and the rows' lse
template <int D>
__device__ __forceinline__ void bwd_p_dp(float (&p)[2][8], float (&dp)[2][8],
                                         const float* Qs, const float* Ks,
                                         const float* Vs, const float* dOs,
                                         const float* Ls, int q0, int k0, int Sq,
                                         int Sk, int causal, int window, float scale,
                                         int ty, int tx) {
  bwd_tile_dot<D>(p, Qs, Ks, ty, tx);
  bwd_tile_dot<D>(dp, dOs, Vs, ty, tx);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = ty * 2 + i;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      p[i][j] = bwd_valid(q0 + row, k0 + tx + 8 * j, Sq, Sk, causal, window)
                    ? expf(fmaf(p[i][j], scale, -Ls[row])) : 0.f;
  }
}

// grid (query tiles, H, B): delta of the tile's rows (first pass over the
// key tiles, written to ``delta`` for attn_bwd_dkdv_kernel), then dQ (second
// pass); dq contiguous (B, Sq, H, D)
template <typename T, int D>
__global__ void __launch_bounds__(BWD_THREADS) attn_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, T* __restrict__ dq, int Sq, int Sk, int H, int KV,
    long long qsb, long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh,
    long long dsb, long long dss, long long dsh, int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BT * (D + 1);
  float* Ks = dOs + BT * (D + 1);
  float* Vs = Ks + BT * (D + 1);
  float* dSs = Vs + BT * (D + 1);
  float* Ls = dSs + BT * (BT + 1);
  float* Dl = Ls + BT;
  constexpr int DJ = D / 8;
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV), off = Sk - Sq;
  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8;
  const long long bh = (long long)b * H + h;

  bwd_load_tile<T, D>(Qs, q + b * qsb + h * qsh, qss, q0, Sq);
  bwd_load_tile<T, D>(dOs, dout + b * dsb + h * dsh, dss, q0, Sq);
  for (int r = tid; r < BT; r += BWD_THREADS)
    Ls[r] = q0 + r < Sq ? lse[bh * Sq + q0 + r] : 0.f;

  // the forward's key range
  int kt_end = (Sk + BT - 1) / BT;
  if (causal) {
    const int maxq = min(q0 + BT, Sq) - 1 + off;
    kt_end = maxq < 0 ? 0 : min(kt_end, maxq / BT + 1);
  }
  int kt_begin = 0;
  if (window) {
    const int lo = q0 + off - window + 1;
    kt_begin = lo > 0 ? lo / BT : 0;
  }

  float p[2][8], dp[2][8];
  // pass 1: delta = rowsum(P dP), each thread over its columns in key
  // order, then the 8 lanes of a row pair in a fixed shuffle tree
  float part[2] = {0.f, 0.f};
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();                             // the last tile's reads are done
    bwd_load_tile<T, D>(Ks, k + b * ksb + kvh * ksh, kss, k0, Sk);
    bwd_load_tile<T, D>(Vs, v + b * vsb + kvh * vsh, vss, k0, Sk);
    __syncthreads();
    bwd_p_dp<D>(p, dp, Qs, Ks, Vs, dOs, Ls, q0, k0, Sq, Sk, causal, window, scale, ty,
                tx);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) part[i] = fmaf(p[i][j], dp[i][j], part[i]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int w = 4; w >= 1; w >>= 1) part[i] += __shfl_xor_sync(FULL, part[i], w);
    const int row = ty * 2 + i;
    if (tx == 0) {
      Dl[row] = part[i];
      if (q0 + row < Sq) delta[bh * Sq + q0 + row] = part[i];
    }
  }

  // pass 2: dQ = scale sum dS k
  float dq_acc[2][DJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq_acc[i][j] = 0.f;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();                             // the last tile's reads are done
    bwd_load_tile<T, D>(Ks, k + b * ksb + kvh * ksh, kss, k0, Sk);
    bwd_load_tile<T, D>(Vs, v + b * vsb + kvh * vsh, vss, k0, Sk);
    __syncthreads();
    bwd_p_dp<D>(p, dp, Qs, Ks, Vs, dOs, Ls, q0, k0, Sq, Sk, causal, window, scale, ty,
                tx);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dSs[(ty * 2 + i) * (BT + 1) + tx + 8 * j] = p[i][j] * (dp[i][j] - Dl[ty * 2 + i]);
    __syncthreads();
    for (int c = 0; c < BT; ++c) {
      float sr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) sr[i] = dSs[(ty * 2 + i) * (BT + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kv = Ks[c * (D + 1) + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < 2; ++i) dq_acc[i][j] = fmaf(sr[i], kv, dq_acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + ty * 2 + i;
    if (row >= Sq) continue;
    const long long base = (((long long)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq[base + tx + 8 * j] = from_float<T>(dq_acc[i][j] * scale);
  }
}

// grid (key tiles, KV, B); dk, dv contiguous (B, Sk, KV, D)
template <typename T, int D>
__global__ void __launch_bounds__(BWD_THREADS) attn_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int Sq, int Sk, int H, int KV,
    long long qsb, long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh,
    long long dsb, long long dss, long long dsh, int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BT * (D + 1);
  float* Qs = Vs + BT * (D + 1);
  float* dOs = Qs + BT * (D + 1);
  float* Ps = dOs + BT * (D + 1);
  float* dSs = Ps + BT * (BT + 1);
  float* Ls = dSs + BT * (BT + 1);
  float* Dl = Ls + BT;
  constexpr int DJ = D / 8;
  const int k0 = blockIdx.x * BT, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV, off = Sk - Sq;
  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8;

  bwd_load_tile<T, D>(Ks, k + b * ksb + kvh * ksh, kss, k0, Sk);
  bwd_load_tile<T, D>(Vs, v + b * vsb + kvh * vsh, vss, k0, Sk);

  // the query tiles that may see a key of this tile
  int qt_begin = 0, qt_end = (Sq + BT - 1) / BT;
  if (causal) {
    const int first = k0 - off;                  // first row whose qpos >= k0
    qt_begin = first > 0 ? first / BT : 0;
  }
  if (window) {
    const int last = k0 + BT - 1 + window - 1 - off;   // last row that may see the tile
    qt_end = last < 0 ? 0 : min(qt_end, last / BT + 1);
  }

  float dk_acc[2][DJ], dv_acc[2][DJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  float p[2][8], dp[2][8];
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const long long bh = (long long)b * H + h;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BT;
      __syncthreads();                           // the last tile's reads are done
      bwd_load_tile<T, D>(Qs, q + b * qsb + h * qsh, qss, q0, Sq);
      bwd_load_tile<T, D>(dOs, dout + b * dsb + h * dsh, dss, q0, Sq);
      for (int r = tid; r < BT; r += BWD_THREADS) {
        const bool ok = q0 + r < Sq;
        Ls[r] = ok ? lse[bh * Sq + q0 + r] : 0.f;
        Dl[r] = ok ? delta[bh * Sq + q0 + r] : 0.f;
      }
      __syncthreads();
      bwd_p_dp<D>(p, dp, Qs, Ks, Vs, dOs, Ls, q0, k0, Sq, Sk, causal, window, scale, ty,
                  tx);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = ty * 2 + i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          Ps[row * (BT + 1) + tx + 8 * j] = p[i][j];
          dSs[row * (BT + 1) + tx + 8 * j] = p[i][j] * (dp[i][j] - Dl[row]);
        }
      }
      __syncthreads();
      // this thread's keys ty*2 + i, columns tx + 8j: sums over the tile's rows
      for (int r = 0; r < BT; ++r) {
        float pk[2], sk[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          pk[i] = Ps[r * (BT + 1) + ty * 2 + i];
          sk[i] = dSs[r * (BT + 1) + ty * 2 + i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float dov = dOs[r * (D + 1) + tx + 8 * j];
          const float qv = Qs[r * (D + 1) + tx + 8 * j];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            dv_acc[i][j] = fmaf(pk[i], dov, dv_acc[i][j]);
            dk_acc[i][j] = fmaf(sk[i], qv, dk_acc[i][j]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + ty * 2 + i;
    if (key >= Sk) continue;
    const long long base = (((long long)b * Sk + key) * KV + kvh) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[base + tx + 8 * j] = from_float<T>(dk_acc[i][j] * scale);
      dv[base + tx + 8 * j] = from_float<T>(dv_acc[i][j]);
    }
  }
}

// strides st: q, k, v, dO, three each (batch, seq, head), in elements
template <int D>
cudaError_t launch_backward_fp32(const void* q, const void* k, const void* v, const void* lse,
                                 const void* dout, void* dq, void* dk, void* dv, void* delta,
                                 int B, int Sq, int Sk, int H, int KV, const long long* st,
                                 int causal, int window, float scale, cudaStream_t stream) {
  using T = float;
  static unsigned char smem_dkdv[MAX_DEVICES], smem_dq[MAX_DEVICES];
  constexpr size_t smem = bwd_smem_bytes<D>();
  cudaError_t err = allow_smem(attn_bwd_dkdv_kernel<T, D>, smem, smem_dkdv);
  if (err != cudaSuccess) return err;
  if ((err = allow_smem(attn_bwd_dq_kernel<T, D>, smem, smem_dq)) != cudaSuccess) return err;
  // dQ first: it writes the delta that dK/dV reads
  attn_bwd_dq_kernel<T, D><<<dim3((Sq + BT - 1) / BT, H, B), BWD_THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (float*)delta, (T*)dq, Sq, Sk, H, KV, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], causal, window, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attn_bwd_dkdv_kernel<T, D><<<dim3((Sk + BT - 1) / BT, KV, B), BWD_THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)delta, (T*)dk, (T*)dv, Sq, Sk, H, KV, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], causal, window, scale);
  return cudaGetLastError();
}

// bf16 / fp16 run the tensor-core kernels; fp32 the CUDA-core ones (TF32
// keeps about three decimal digits)
template <typename T, int D>
cudaError_t launch_backward(const void* q, const void* k, const void* v, const void* lse,
                            const void* dout, void* dq, void* dk, void* dv, void* delta,
                            int B, int Sq, int Sk, int H, int KV, const long long* st,
                            int causal, int window, float scale, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value)
    return launch_backward_fp32<D>(q, k, v, lse, dout, dq, dk, dv, delta, B, Sq, Sk, H, KV,
                                   st, causal, window, scale, stream);
  else
    return launch_backward_wgmma<T, D>(q, k, v, lse, dout, dq, dk, dv, delta, B, Sq, Sk, H,
                                       KV, st, causal, window, scale, stream);
}

// dtype codes shared with kernel.py: 0 float32, 1 bfloat16, 2 float16
#define DISPATCH(DTYPE, D, FN, ...)                                         \
  switch (DTYPE * 1000 + D) {                                               \
    case 64: return (int)FN<float, 64>(__VA_ARGS__);                        \
    case 80: return (int)FN<float, 80>(__VA_ARGS__);                        \
    case 128: return (int)FN<float, 128>(__VA_ARGS__);                      \
    case 256: return (int)FN<float, 256>(__VA_ARGS__);                      \
    case 1064: return (int)FN<__nv_bfloat16, 64>(__VA_ARGS__);              \
    case 1080: return (int)FN<__nv_bfloat16, 80>(__VA_ARGS__);              \
    case 1128: return (int)FN<__nv_bfloat16, 128>(__VA_ARGS__);             \
    case 1256: return (int)FN<__nv_bfloat16, 256>(__VA_ARGS__);             \
    case 2064: return (int)FN<__half, 64>(__VA_ARGS__);                     \
    case 2080: return (int)FN<__half, 80>(__VA_ARGS__);                     \
    case 2128: return (int)FN<__half, 128>(__VA_ARGS__);                    \
    case 2256: return (int)FN<__half, 256>(__VA_ARGS__);                    \
    default: return (int)cudaErrorInvalidValue;                             \
  }

// bf16 / fp16 run the tensor-core kernel; fp32 the CUDA-core one, since the
// tensor cores' only fp32 mode (TF32) keeps about three decimal digits
template <typename T, int D>
cudaError_t launch_prefill(const void* q, const void* k, const void* v, void* o,
                           float* lse, int B, int Sq, int Sk, int H, int KV,
                           const long long* st, int causal, int window, float scale,
                           cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value)
    return launch_prefill_fp32<D>(q, k, v, o, lse, B, Sq, Sk, H, KV, st, causal, window,
                                  scale, stream);
  else
    return launch_prefill_wgmma<T, D>(q, k, v, o, lse, B, Sq, Sk, H, KV, st, causal,
                                      window, scale, stream);
}

// the backward takes head dims 64, 80 and 128 (D 256's tiles would not fit)
#define DISPATCH_BWD(DTYPE, D, FN, ...)                                     \
  switch (DTYPE * 1000 + D) {                                               \
    case 64: return (int)FN<float, 64>(__VA_ARGS__);                        \
    case 80: return (int)FN<float, 80>(__VA_ARGS__);                        \
    case 128: return (int)FN<float, 128>(__VA_ARGS__);                      \
    case 1064: return (int)FN<__nv_bfloat16, 64>(__VA_ARGS__);              \
    case 1080: return (int)FN<__nv_bfloat16, 80>(__VA_ARGS__);              \
    case 1128: return (int)FN<__nv_bfloat16, 128>(__VA_ARGS__);             \
    case 2064: return (int)FN<__half, 64>(__VA_ARGS__);                     \
    case 2080: return (int)FN<__half, 80>(__VA_ARGS__);                     \
    case 2128: return (int)FN<__half, 128>(__VA_ARGS__);                    \
    default: return (int)cudaErrorInvalidValue;                             \
  }

}  // namespace

extern "C" {

int repro_fa_prefill(const void* q, const void* k, const void* v, void* o, void* lse,
                     int dtype, int B, int Sq, int Sk, int H, int KV, int D,
                     long long qsb, long long qss, long long qsh,
                     long long ksb, long long kss, long long ksh,
                     long long vsb, long long vss, long long vsh,
                     long long osb, long long oss, long long osh,
                     int causal, int window, float scale, void* stream) {
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh,
                            vsb, vss, vsh, osb, oss, osh};
  DISPATCH(dtype, D, launch_prefill, q, k, v, o, (float*)lse, B, Sq, Sk, H, KV, st,
           causal, window, scale, (cudaStream_t)stream)
}

int repro_fa_decode(const void* q, const void* k, const void* v, void* o,
                    const void* pos, const void* block_tables, void* ws,
                    void* counters, int dtype, int B, int H, int KV, int D, int lc,
                    int nb, int tiles_per_split, int n_split, long long s_b,
                    long long s_page, long long s_l, long long s_kv, float scale,
                    void* stream) {
  DISPATCH(dtype, D, launch_decode, q, k, v, o, pos,
           block_tables, ws, counters, B, H, KV, lc, nb, tiles_per_split, n_split,
           s_b, s_page, s_l, s_kv, scale, (cudaStream_t)stream)
}

int repro_fa_backward(const void* q, const void* k, const void* v, const void* lse,
                      const void* dout, void* dq, void* dk, void* dv, void* delta,
                      int dtype, int B, int Sq, int Sk, int H, int KV, int D,
                      long long qsb, long long qss, long long qsh,
                      long long ksb, long long kss, long long ksh,
                      long long vsb, long long vss, long long vsh,
                      long long dsb, long long dss, long long dsh,
                      int causal, int window, float scale, void* stream) {
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
                            dsb, dss, dsh};
  DISPATCH_BWD(dtype, D, launch_backward, q, k, v, lse, dout, dq, dk, dv, delta, B, Sq,
               Sk, H, KV, st, causal, window, scale, (cudaStream_t)stream)
}

}  // extern "C"
