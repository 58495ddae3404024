// Flash-attention forward for Hopper (sm_90a): two hand-written bodies.
//
// Replaces the Pallas TPU kernel `flash_attention_fwd` / `_fa_kernel` in
// src/repro/kernels/flash_attention/kernel.py (pallas_call at :103).  It
// computes the same function, not the same blocks:
//   q (B,H,S,hd), k/v (B,KV,S,hd); the kv head of q head h is h / (H/KV);
//   s = q.k^T / sqrt(hd) in fp32, causal positions above the diagonal masked;
//   an online softmax keeps m and l in fp32; o = acc / max(l, 1e-30), cast
//   to q's dtype.  Any S >= 1: the kernel masks the ragged edge itself (the
//   TPU kernel needs S % block == 0).  q/k/v/o are read and written through
//   their strides, so they can be the model's (B,S,heads,hd) memory viewed
//   as (B,heads,S,hd) with no copy.  The grid is (q tile, q head, batch),
//   the longest causal q tiles launched first; the TPU's sequential kv grid
//   axis is a loop inside the block, stopping at the diagonal under `causal`.
//
// Bound at the main-path shape (q (4,14,2048,64), k/v (4,2,2048,64),
// causal, bf16, 24 launches per qwen2-0.5b prefill): 4*hd*S(S+1)/2 FLOPs
// per head = 30.1 GFLOP, 30 us at 989 TFLOP/s bf16 dense; 33.6 MB moved,
// 10 us at 3.35 TB/s.  Operations bound it, on the tensor cores.  The
// training forward (fp32, q (2,14,2048,64)): 15.0 GFLOP, 0.22 ms at the
// 67 TFLOP/s fp32 rate of the CUDA cores; the reference trains in fp32
// without TF32, so that body stays off the tensor cores.
//
// bf16 body (`fa_bf16_wgmma_kernel`): tensor cores, tiles by TMA.
//   * A CTA holds two consumer warpgroups (warps 0-7), each owning 64 rows
//     of a 128-row q tile of one (b, h), and one producer warp (warp 8)
//     whose lane 0 loads the q tile once and then keeps 64-key K/V tiles in
//     flight by TMA in a ring of two shared-memory stages, which both
//     warpgroups read.  `full` mbarriers (expect_tx) say a stage has landed,
//     `empty` ones (256 arrivals) that the consumers are done with it; each
//     keeps its phase parity per stage.  Under `causal` the first
//     warpgroup's rows end a tile earlier: it only releases that stage.
//   * S = Q.K^T: `wgmma.mma_async` m64n64k16, Q and K both from shared
//     memory, K-major, with the swizzle of the TMA box.  A row of head_dim
//     is cut into chunks of CW = min(64, hd rounded up to 16) columns, one
//     TMA box and one swizzle atom of 2*CW bytes (32, 64 or 128 B) each.
//     hd 24 (48 B rows) is padded to 32 and hd 160 to 192: TMA zero-fills
//     the columns past hd, so the padded contraction adds zeros.  Stepping
//     16 columns along K moves the descriptor's start address by 32 B
//     inside the swizzle atom.
//   * Online softmax in fp32 in the accumulator registers: a row lives in
//     the 4 lanes of a quad; max and sum are trees over a thread's values,
//     then two shuffles (the sum only once, at the end), both rows side by
//     side.  scale*log2(e) is folded into exp2 (`ex2.approx`).  Keys >= S
//     must be masked to -inf: TMA's out-of-bounds zero fill gives them a
//     score of 0.  Only the tiles that cross the diagonal or the ragged
//     edge are masked, under one branch: a branch per key group split the
//     softmax into basic blocks the compiler could not interleave, and
//     cost 10-20 % of the kernel's time.
//   * O += P.V: P is converted to bf16 in registers, where the score
//     accumulator's layout is the A-fragment layout of m64k16, and is the
//     register A operand of the RS form (as FlashAttention-3 does).  V's tile
//     is [key][hd], MN-major for B, read with the transpose bit; its
//     descriptor's leading offset steps between 64-column chunks.
//   * Output: registers -> shared memory (the drained ring, padded rows)
//     -> coalesced 16-byte stores to the strided o.
//   * Budget: hd <= 64 is held to 112 registers a thread (96 and a 20-byte
//     spill at hd 64) and 49 KB, so that two CTAs share an SM; wider heads
//     run one CTA an SM (hd 192: 144 KB, an O accumulator of 96 fp32
//     registers a thread, 168 in all).
//   * What holds it back (measured, PERF.md): a 64x64 tile costs an SM
//     about 900 cycles against ~256 of tensor-core and ~256 of ex2 work,
//     and more warpgroups an SM did not raise the SM's rate.  Overlapping
//     the next tile's Q.K^T with this tile's softmax (two score register
//     sets) was slower in every variant tried, so each warpgroup runs its
//     tile's steps in order.
//   * Where trouble lies: cuTensorMapEncodeTiled is in the driver library;
//     it is taken with cudaGetDriverEntryPoint, so the build needs no
//     -lcuda, and each map is passed as a `const __grid_constant__
//     CUtensorMap`.  TMA wants the global address 16-byte aligned and every
//     stride a multiple of 16 bytes (the wrapper checks both and raises), and
//     shared buffers aligned to the swizzle's 1024-byte repeat.  wgmma's
//     accumulators are not touched between issue and `wait_group`, which
//     `fence_regs` makes explicit to the compiler.
//
// fp32 body (`fa_f32_simt_kernel`): exact fp32 on the CUDA cores (no TF32).
//   * 64-row q tile, 64-key tiles, 256 threads as 16 x 16.  Thread (ty, tx)
//     holds a 4 x 4 register micro-tile of scores (rows ty + 16i, keys tx +
//     16j) built from float4 reads of Q and K along head_dim: 64 FMAs for
//     eight 16-byte shared-memory reads.  A row's 16 threads share a warp
//     and meet by four shuffles.  exp2f (not ex2.approx) keeps it exact to
//     the fp32 contract.
//   * P goes through shared memory; each thread then holds a 4-row x
//     hd/16-column micro-tile of O, fed by float4 reads of P and vector
//     reads of V.
//   * K and V have one buffer each and are loaded by cp.async in turn: the
//     next K tile streams in while P.V runs, the next V tile while the next
//     Q.K^T runs.  Rows are padded by 4 floats, and a thread's keys are
//     16 apart, so the float4 reads of a quarter-warp hit distinct banks.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// ---- shared-memory, barrier, TMA and wgmma primitives (PTX) -----------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// one box of a 4-D tensor map (coordinates innermost first) into shared memory
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
        "r"(c3), "r"(bar) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>  // until at most N committed groups are in flight
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pins registers in place across a point of the asm stream, so that the
// compiler moves no access to a wgmma accumulator across issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle mode (1: 128 B, 2: 64 B, 3: 32 B).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)mode << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D(64 x N, fp32) (+)= A(64 x 16) . B(16 x N), A and B K-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int accumulate);
// D(64 x N, fp32) += A(64 x 16, bf16 registers) . B(16 x N), B MN-major in
// shared memory (transposed read)
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      " %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      " %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, "
      "1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<192>(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      " %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      " %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
      " %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, {%96, %97, %98, "
      "%99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---- bf16 body: wgmma + TMA -------------------------------------------------

constexpr int TC_WG = 2;  // consumer warpgroups a CTA, 64 q rows each
constexpr int TC_CONSUMERS = 128 * TC_WG;
constexpr int TC_THREADS = TC_CONSUMERS + 32;  // + the producer warp
constexpr int TC_BLOCK_Q = 64 * TC_WG;
constexpr int TC_BLOCK_K = 64;

template <int HD>
struct TcCfg {
  static constexpr int HDP = HD <= 64 ? round_up(HD, 16) : round_up(HD, 64);
  static constexpr int CW = HDP < 64 ? HDP : 64;  // columns of a chunk / TMA box
  static constexpr int NCH = HDP / CW;
  static constexpr int SW = 2 * CW;               // swizzle span, bytes
  static constexpr uint32_t MODE = SW == 128 ? 1 : (SW == 64 ? 2 : 3);
  static constexpr int STAGES = 2;
  static constexpr int Q_BYTES = TC_BLOCK_Q * HDP * 2;
  static constexpr int KV_BYTES = TC_BLOCK_K * HDP * 2;  // one of K or V
  static constexpr int O_PITCH = HDP + 8;  // output staging row, elements
  static_assert(TC_BLOCK_Q * O_PITCH * 2 <= STAGES * 2 * KV_BYTES, "O is staged in the ring");
  static constexpr int BAR_OFFSET = Q_BYTES + STAGES * 2 * KV_BYTES;
  static constexpr int SMEM = 1024 + BAR_OFFSET + 8 * (2 * STAGES + 1);
  // two CTAs an SM where the registers allow it (<= 113 a thread)
  static constexpr int MIN_CTAS = HD <= 64 ? 2 : 1;
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(TC_CONSUMERS) : "memory");
}

// Online softmax of one kv tile in base 2 on a thread's rows qrow and qrow + 8
// (accumulator layout: register 4j + 2i + e is row qrow + 8i, key k0 + 8j +
// cq + e): s becomes P, m and l move on, alpha is the accumulator's factor.
// The mask is one branch for the whole tile (taken only on the diagonal
// and ragged tiles), and both rows run side by side through trees for the
// max and the sum, so that the compiler can interleave their short chains.
template <int BK>
__device__ __forceinline__ void softmax_tile(float* s, float* m, float* l, float* alpha, int k0,
                                             int qrow, int cq, int S, int causal, bool edge,
                                             float scale_log2) {
  const float NEG_INF = -INFINITY;
  if (edge) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + cq + e;
          if (key >= S || (causal && key > qrow + 8 * i)) s[4 * j + 2 * i + e] = NEG_INF;
        }
  }
  float t[2][BK / 8];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) t[i][j] = fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]);
#pragma unroll
  for (int w = BK / 16; w >= 1; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) t[i][j] = fmaxf(t[i][j], t[i][j + w]);
  float m_use[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = fmaxf(t[i][0], __shfl_xor_sync(0xffffffffu, t[i][0], 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx * scale_log2);
    m_use[i] = m_new == NEG_INF ? 0.f : m_new;  // a row with no key yet
    alpha[i] = fast_exp2(m[i] - m_use[i]);
    m[i] = m_new;
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float& x0 = s[4 * j + 2 * i];
      float& x1 = s[4 * j + 2 * i + 1];
      x0 = fast_exp2(fmaf(x0, scale_log2, -m_use[i]));
      x1 = fast_exp2(fmaf(x1, scale_log2, -m_use[i]));
      t[i][j] = x0 + x1;
    }
#pragma unroll
  for (int w = BK / 16; w >= 1; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) t[i][j] += t[i][j + w];
#pragma unroll
  for (int i = 0; i < 2; ++i)  // this thread's keys; the quad's meet at the end
    l[i] = l[i] * alpha[i] + t[i][0];
}

template <int HD>
__global__ void __launch_bounds__(TC_THREADS, TcCfg<HD>::MIN_CTAS)
fa_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     __nv_bfloat16* __restrict__ o, int G, int S, int causal,
                     float scale_log2, int64_t sob, int64_t soh, int64_t sos) {
  using C = TcCfg<HD>;
  constexpr int BK = TC_BLOCK_K;
  const float NEG_INF = -INFINITY;
  extern __shared__ uint8_t smem_raw[];
  // TMA's 128-byte swizzle repeats every 1024 bytes: align the buffers to it
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Qs = base;                  // NCH chunks of [TC_BLOCK_Q][CW]
  uint8_t* KVs = base + C::Q_BYTES;    // stage st: K, then V, NCH chunks each; then O
  const uint32_t bar0 = smem_u32(base + C::BAR_OFFSET);
  const uint32_t q_bar = bar0 + 8 * (2 * C::STAGES);
  auto full_bar = [=](int st) { return bar0 + 8 * st; };
  auto empty_bar = [=](int st) { return bar0 + 8 * (C::STAGES + st); };

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * TC_BLOCK_Q;
  const int n_kt_all = (S + BK - 1) / BK;
  const int n_kt = causal ? min(n_kt_all, (q0 + TC_BLOCK_Q - 1) / BK + 1) : n_kt_all;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int st = 0; st < C::STAGES; ++st) {
      mbar_init(full_bar(st), 1);
      mbar_init(empty_bar(st), TC_CONSUMERS);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == TC_CONSUMERS / 32) {  // ---- producer warp: TMA only
    if (lane == 0) {
      const int hk = h / G;
      mbar_expect_tx(q_bar, C::Q_BYTES);
      for (int c = 0; c < C::NCH; ++c)
        tma_load_4d(smem_u32(Qs + c * TC_BLOCK_Q * C::SW), &qmap, q_bar, c * C::CW, q0, h, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % C::STAGES;
        if (kt >= C::STAGES) mbar_wait(empty_bar(st), ((kt / C::STAGES) - 1) & 1);
        mbar_expect_tx(full_bar(st), 2 * C::KV_BYTES);
        uint8_t* ks = KVs + st * 2 * C::KV_BYTES;
        for (int c = 0; c < C::NCH; ++c) {
          tma_load_4d(smem_u32(ks + c * BK * C::SW), &kmap, full_bar(st), c * C::CW,
                      kt * BK, hk, b);
          tma_load_4d(smem_u32(ks + C::KV_BYTES + c * BK * C::SW), &vmap, full_bar(st),
                      c * C::CW, kt * BK, hk, b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: warpgroup wg owns q rows q0 + 64 wg + [0, 64).
  // Accumulator layout of m64nN: register 4j + 2i + e holds row 16*(warp%4)
  // + lane/4 + 8i of the warpgroup's 64, column 8j + 2*(lane%4) + e.
  const int wg = warp / 4;
  const int r0 = 64 * wg + 16 * (warp % 4) + lane / 4;  // row in the CTA's q tile
  const int cq = 2 * (lane % 4);
  // under `causal` the first warpgroup's rows end a kv tile earlier
  const int n_kt_wg = causal ? min(n_kt_all, (q0 + 64 * wg + 63) / BK + 1) : n_kt_all;
  float acc[C::HDP / 2];
#pragma unroll
  for (int i = 0; i < C::HDP / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const uint32_t q_addr = smem_u32(Qs) + 64 * wg * C::SW;
  mbar_wait(q_bar, 0);

  for (int kt = 0; kt < n_kt_wg; ++kt) {
    const int st = kt % C::STAGES;
    mbar_wait(full_bar(st), (kt / C::STAGES) & 1);
    const uint32_t k_addr = smem_u32(KVs + st * 2 * C::KV_BYTES);
    const uint32_t v_addr = k_addr + C::KV_BYTES;

    // S = Q K^T, both K-major; 16 columns of head_dim a step
    float s[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::HDP / 16; ++kk) {
      const int c = kk * 16 / C::CW, off = (kk * 16 % C::CW) * 2;
      const uint64_t da =
          make_desc(q_addr + c * TC_BLOCK_Q * C::SW + off, 16, 8 * C::SW, C::MODE);
      const uint64_t db = make_desc(k_addr + c * BK * C::SW + off, 16, 8 * C::SW, C::MODE);
      wgmma_ss<BK>(s, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<BK / 2>(s);

    const int k0 = kt * BK;
    float alpha[2];
    softmax_tile<BK>(s, m, l, alpha, k0, q0 + r0, cq, S, causal,
                     k0 + BK > S || (causal && k0 + BK - 1 > q0 + 64 * wg), scale_log2);

    // P in bf16 as m64k16 A fragments: the accumulator layout, 16 keys apiece
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    }
#pragma unroll
    for (int j = 0; j < C::HDP / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[4 * j + r] *= alpha[r / 2];
    }

    // O += P V: V is [key][hd], MN-major for B, read transposed; the leading
    // offset steps between 64-column chunks, the stride between 8-key groups
    wgmma_fence();
    fence_regs<C::HDP / 2>(acc);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db = make_desc(v_addr + kk * 16 * C::SW, BK * C::SW, 8 * C::SW, C::MODE);
      wgmma_rs<C::HDP>(acc, pa[kk], db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<C::HDP / 2>(acc);
    mbar_arrive(empty_bar(st));
  }
  // tiles past this warpgroup's diagonal (the other's rows reach further):
  // release their stages once they have landed
  for (int kt = n_kt_wg; kt < n_kt; ++kt) {
    mbar_wait(full_bar(kt % C::STAGES), (kt / C::STAGES) & 1);
    mbar_arrive(empty_bar(kt % C::STAGES));
  }

  // epilogue: normalise, stage the tile in the drained ring, 16-byte stores
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float t = l[i];
    t += __shfl_xor_sync(0xffffffffu, t, 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    inv[i] = 1.f / fmaxf(t, 1e-30f);
  }
  consumer_sync();  // every wgmma has completed; the producer has loaded its last tile
  __nv_bfloat16* Os = reinterpret_cast<__nv_bfloat16*>(KVs);
#pragma unroll
  for (int j = 0; j < C::HDP / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      *reinterpret_cast<uint32_t*>(Os + (r0 + 8 * i) * C::O_PITCH + 8 * j + cq) =
          pack_bf16(acc[4 * j + 2 * i] * inv[i], acc[4 * j + 2 * i + 1] * inv[i]);
    }
  }
  consumer_sync();
  constexpr int VPR = HD / 8;  // 16-byte vectors in a row of o
  __nv_bfloat16* ob = o + b * sob + h * soh;
  for (int idx = tid; idx < TC_BLOCK_Q * VPR; idx += TC_CONSUMERS) {
    const int row = idx / VPR, cv = idx % VPR;
    const int pos = q0 + row;
    if (pos < S)
      *reinterpret_cast<uint4*>(ob + pos * sos + cv * 8) =
          *reinterpret_cast<const uint4*>(Os + row * C::O_PITCH + cv * 8);
  }
}

// ---- fp32 body: register-tiled on the CUDA cores ---------------------------

constexpr int SIMT_THREADS = 256;  // 16 x 16
constexpr int SIMT_BQ = 64;        // q rows a CTA
constexpr int SIMT_BK = 64;
constexpr int SIMT_LDP = SIMT_BK + 4;  // row of the P tile, floats

template <int HD>
struct SimtCfg {
  static constexpr int HDP = round_up(HD, 16);  // 16 threads split the columns
  static constexpr int LD = HDP + 4;            // row pitch, floats (16-byte multiple)
  static constexpr int CPT = HDP / 16;          // output columns a thread
  static constexpr int VW = CPT % 4 == 0 ? 4 : (CPT % 2 == 0 ? 2 : 1);  // vector width
  static constexpr int NV = CPT / VW;
  static constexpr int SMEM = 4 * (SIMT_BQ * LD + 2 * SIMT_BK * LD + SIMT_BQ * SIMT_LDP);
};

template <int W> struct FVec;
template <> struct FVec<1> { using T = float; };
template <> struct FVec<2> { using T = float2; };
template <> struct FVec<4> { using T = float4; };

template <int W>
__device__ __forceinline__ float lane_of(const typename FVec<W>::T& v, int e) {
  if constexpr (W == 1) return v;
  else return reinterpret_cast<const float*>(&v)[e];
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// rows row0.. row0+63 of a (S, hd) slice into a [64][LD] tile; rows >= S
// are zero-filled, the padding columns are left alone
template <int HD>
__device__ __forceinline__ void load_tile_async(float* dst, const float* src, int64_t srow,
                                                int row0, int S, int tid) {
  constexpr int VPR = HD / 4;
  for (int idx = tid; idx < 64 * VPR; idx += SIMT_THREADS) {
    const int row = idx / VPR, cv = idx % VPR;
    const int s = row0 + row;
    const bool valid = s < S;
    cp_async16(smem_u32(dst + row * SimtCfg<HD>::LD + cv * 4),
               valid ? src + s * srow + cv * 4 : src, valid);
  }
}

template <int HD>
__global__ void __launch_bounds__(SIMT_THREADS)
fa_f32_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o, int G, int S,
                   int causal, float scale_log2, int64_t sqb, int64_t sqh, int64_t sqs,
                   int64_t skb, int64_t skh, int64_t sks, int64_t svb, int64_t svh,
                   int64_t svs, int64_t sob, int64_t soh, int64_t sos) {
  using C = SimtCfg<HD>;
  constexpr int LD = C::LD;
  const float NEG_INF = -INFINITY;
  extern __shared__ __align__(16) float smem_f[];
  float* Qs = smem_f;               // [SIMT_BQ][LD]
  float* Ks = Qs + SIMT_BQ * LD;    // [SIMT_BK][LD]
  float* Vs = Ks + SIMT_BK * LD;    // [SIMT_BK][LD]
  float* Ps = Vs + SIMT_BK * LD;    // [SIMT_BQ][SIMT_LDP]

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * SIMT_BQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int n_kt_all = (S + SIMT_BK - 1) / SIMT_BK;
  const int n_kt = causal ? min(n_kt_all, (q0 + SIMT_BQ - 1) / SIMT_BK + 1) : n_kt_all;

  const float* qb = q + b * sqb + h * sqh;
  const float* kb = k + b * skb + (h / G) * skh;
  const float* vb = v + b * svb + (h / G) * svh;

  if constexpr (C::HDP > HD) {  // zero the padding columns once
    for (int idx = tid; idx < 3 * 64 * (C::HDP - HD); idx += SIMT_THREADS) {
      const int row = idx / (C::HDP - HD), col = HD + idx % (C::HDP - HD);
      Qs[row * LD + col] = 0.f;  // rows 0..191 run through Qs, Ks and Vs
    }
  }
  // cp.async groups, in order: (Q, K0), V0, then K(t+1) and V(t+1) in turn
  load_tile_async<HD>(Qs, qb, sqs, q0, S, tid);
  load_tile_async<HD>(Ks, kb, sks, 0, S, tid);
  cp_async_commit();
  load_tile_async<HD>(Vs, vb, svs, 0, S, tid);
  cp_async_commit();

  float acc[4][C::CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C::CPT; ++c) acc[i][c] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = NEG_INF, l[i] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * SIMT_BK;
    cp_async_wait1();  // Q and K(kt) have landed
    __syncthreads();

    // scores of rows ty + 16i, keys tx + 16j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < C::HDP; d += 4) {
      float4 qa[4], kf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kf[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qa[i].x, kf[j].x, sc[i][j]);
          sc[i][j] = fmaf(qa[i].y, kf[j].y, sc[i][j]);
          sc[i][j] = fmaf(qa[i].z, kf[j].z, sc[i][j]);
          sc[i][j] = fmaf(qa[i].w, kf[j].w, sc[i][j]);
        }
    }
    __syncthreads();  // every thread is done with Ks
    if (kt + 1 < n_kt) load_tile_async<HD>(Ks, kb, sks, k0 + SIMT_BK, S, tid);
    cp_async_commit();

    // the mask is one branch for the tile; the four rows then run side by
    // side, so that their shuffle and exp chains interleave
    if (k0 + SIMT_BK > S || (causal && k0 + SIMT_BK - 1 > q0)) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + tx + 16 * j;
          if (key >= S || (causal && key > q0 + ty + 16 * i)) sc[i][j] = NEG_INF;
        }
    }
    float mx[4], m_use[4], alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      mx[i] = fmaxf(fmaxf(sc[i][0], sc[i][1]), fmaxf(sc[i][2], sc[i][3]));
#pragma unroll
    for (int w = 1; w < 16; w *= 2)
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], w));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float m_new = fmaxf(m[i], mx[i] * scale_log2);
      m_use[i] = m_new == NEG_INF ? 0.f : m_new;  // a row with no key yet
      alpha[i] = exp2f(m[i] - m_use[i]);
      m[i] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = exp2f(fmaf(sc[i][j], scale_log2, -m_use[i]));
        Ps[(ty + 16 * i) * SIMT_LDP + tx + 16 * j] = p[j];
      }
      // this thread's keys; the row's 16 meet at the end
      l[i] = l[i] * alpha[i] + ((p[0] + p[1]) + (p[2] + p[3]));
#pragma unroll
      for (int c = 0; c < C::CPT; ++c) acc[i][c] *= alpha[i];
    }

    cp_async_wait1();  // V(kt) has landed; K(kt+1) may still be in flight
    __syncthreads();   // and every P row is written
    // O rows ty + 16i, columns VW*tx + 16*VW*n + e
#pragma unroll 2
    for (int j = 0; j < SIMT_BK; j += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * SIMT_LDP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = Vs + (j + jj) * LD + C::VW * tx;
#pragma unroll
        for (int n = 0; n < C::NV; ++n) {
          const typename FVec<C::VW>::T vv =
              *reinterpret_cast<const typename FVec<C::VW>::T*>(vrow + 16 * C::VW * n);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = reinterpret_cast<const float*>(&p4[i])[jj];
#pragma unroll
            for (int e = 0; e < C::VW; ++e)
              acc[i][n * C::VW + e] = fmaf(p, lane_of<C::VW>(vv, e), acc[i][n * C::VW + e]);
          }
        }
      }
    }
    __syncthreads();  // every thread is done with Vs and Ps
    if (kt + 1 < n_kt) load_tile_async<HD>(Vs, vb, svs, k0 + SIMT_BK, S, tid);
    cp_async_commit();
  }

  float* ob = o + b * sob + h * soh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float t = l[i];
#pragma unroll
    for (int w = 1; w < 16; w *= 2) t += __shfl_xor_sync(0xffffffffu, t, w);
    const float inv = 1.f / fmaxf(t, 1e-30f);
    const int s = q0 + ty + 16 * i;
    if (s >= S) continue;
#pragma unroll
    for (int n = 0; n < C::NV; ++n) {
      const int col = C::VW * tx + 16 * C::VW * n;
      if (col >= HD) continue;
      typename FVec<C::VW>::T out;
      float* of = reinterpret_cast<float*>(&out);
#pragma unroll
      for (int e = 0; e < C::VW; ++e) of[e] = acc[i][n * C::VW + e] * inv;
      *reinterpret_cast<typename FVec<C::VW>::T*>(ob + s * sos + col) = out;
    }
  }
}

// ---- host side --------------------------------------------------------------

// cuTensorMapEncodeTiled lives in the driver library: take it through the
// runtime, so that the library links against nothing but cudart.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The (B, heads, S, hd) bf16 view at `ptr` with element strides st = (batch,
// head, seq) as a 4-D map, innermost first; boxes of [rows][cw] columns.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int B, int heads, int S, int hd,
                     const int64_t* st, int rows, int cw, CUtensorMapSwizzle swizzle) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cw, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // zeros past the edges
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int H,
                        int KV, int S, int causal, const int64_t* st, cudaStream_t stream) {
  using C = TcCfg<HD>;
  const CUtensorMapSwizzle sw = C::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : C::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap qmap, kmap, vmap;
  cudaError_t err = make_map(&qmap, q, B, H, S, HD, st, TC_BLOCK_Q, C::CW, sw);
  if (err == cudaSuccess) err = make_map(&kmap, k, B, KV, S, HD, st + 3, TC_BLOCK_K, C::CW, sw);
  if (err == cudaSuccess) err = make_map(&vmap, v, B, KV, S, HD, st + 6, TC_BLOCK_K, C::CW, sw);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fa_bf16_wgmma_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err == cudaSuccess)  // as much shared memory as the SM has: more CTAs an SM
    err = cudaFuncSetAttribute(fa_bf16_wgmma_kernel<HD>,
                               cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + TC_BLOCK_Q - 1) / TC_BLOCK_Q, H, B);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)HD);
  fa_bf16_wgmma_kernel<HD><<<grid, TC_THREADS, C::SMEM, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), H / KV, S, causal, scale_log2, st[9],
      st[10], st[11]);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B, int H,
                       int KV, int S, int causal, const int64_t* st, cudaStream_t stream) {
  using C = SimtCfg<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      fa_f32_simt_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + SIMT_BQ - 1) / SIMT_BQ, H, B);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)HD);
  fa_f32_simt_kernel<HD><<<grid, SIMT_THREADS, C::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H / KV, S, causal, scale_log2,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, void* o, int B,
                   int H, int KV, int S, int causal, const int64_t* st, cudaStream_t stream) {
  if (dtype == 0) return launch_f32<HD>(q, k, v, o, B, H, KV, S, causal, st, stream);
  if (dtype == 1) return launch_bf16<HD>(q, k, v, o, B, H, KV, S, causal, st, stream);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_head_dim(int hd, int dtype, const void* q, const void* k, const void* v,
                              void* o, int B, int H, int KV, int S, int causal,
                              const int64_t* st, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<16>(dtype, q, k, v, o, B, H, KV, S, causal, st, stream);
    case 24: return launch<24>(dtype, q, k, v, o, B, H, KV, S, causal, st, stream);
    case 32: return launch<32>(dtype, q, k, v, o, B, H, KV, S, causal, st, stream);
    case 64: return launch<64>(dtype, q, k, v, o, B, H, KV, S, causal, st, stream);
    case 128: return launch<128>(dtype, q, k, v, o, B, H, KV, S, causal, st, stream);
    case 160: return launch<160>(dtype, q, k, v, o, B, H, KV, S, causal, st, stream);
    case 192: return launch<192>(dtype, q, k, v, o, B, H, KV, S, causal, st, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 element strides, the
// (batch, head, seq) strides of q, k, v and o in that order; each data
// pointer and each stride (in bytes) must be a multiple of 16, and the head
// dim contiguous (the Python wrapper checks).  Launches on `device` and
// restores the caller's current device.  Returns the cudaError_t of the
// launch (0 on success); the launch is asynchronous.
int repro_flash_attention_fwd(const void* q, const void* k, const void* v,
                              void* o, int dtype, int B, int H, int KV, int S,
                              int hd, int causal, const int64_t* strides,
                              int device, void* stream) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = dispatch_head_dim(hd, dtype, q, k, v, o, B, H, KV, S, causal, strides,
                          static_cast<cudaStream_t>(stream));
  const cudaError_t restore = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : restore);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
