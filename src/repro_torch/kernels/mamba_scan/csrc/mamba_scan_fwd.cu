// Mamba-1 selective scan forward for Hopper (sm_90a), CUDA C++ on the CUDA
// cores, all arithmetic in fp32.
//
// Replaces the Pallas TPU kernel `mamba_scan_fwd` / `_mamba_kernel` in
// src/repro/kernels/mamba_scan/kernel.py (pallas_call at :87).  It computes
// the same function, per batch b, channel d and state s (A diagonal):
//   h_t[d,s] = exp(dt_t[d] A[d,s]) h_{t-1}[d,s] + dt_t[d] u_t[d] B_t[s]
//   y_t[d]   = sum_s h_t[d,s] C_t[s] + D[d] u_t[d]
// from h_0 = h0, and returns every y_t and the final state, both fp32.
// u, dt, B, C are fp32 or bf16; A, D, h0 are fp32.
//
// Bounds at the main-path shape (jamba prefill: B=4, S=2048, di=16384,
// ds=16; bf16 u, dt, B, C; fp32 y, A, D, states; 7 launches a prefill),
// NVIDIA H100 80GB HBM3 at 700 W, SM clock 1980 MHz while the kernel runs
// (nvidia-smi clocks.sm; clock64 against %globaltimer reads 1.95-1.99 GHz):
//   * bytes: 1.08 GB, each input read once, each output written once:
//     0.3234 ms at 3.35 TB/s;
//   * special-function unit: one exp per (b, t, d, s), 2.15 G, at 16 a
//     clock an SM: 0.514 ms on 132 SMs, 0.530 ms on the 128 the grid uses;
//   * issue slots: a step of a lane's 16 states is 105 instructions (16
//     FMUL dt*A, 16 MUFU.EX2, 16 FMUL dt*u*B, 32 FFMA for h and y, 10 LDS,
//     15 more), 4 warps a scheduler: 0.434 ms at 1 instruction a clock.
// Neither pipe reaches its floor: the scan runs at 0.69 ms, ~169 cycles a
// warp-step against 128 of SFU work and 105 of issue.  Microbenchmarks of
// the step alone run at 150-160 cycles: the exps and the FP32 work overlap
// only in part, so each instruction moved off the SFU costs about as much
// as it saves.
//
// Design:
//   * A warp holds 32 channels, a lane one channel's 16 states.  (Two
//     channels a lane pair, half the B/C reads a state, measured slower.)
//   * u and dt never pass through a block: each warp copies its own rows,
//     `tile` steps at a time, into a two-stage ring by cp.async (16-byte
//     chunks; 8, 4 or 2 where a view is aligned to less), a tile ahead;
//     each lane reads its own u and dt from the ring a step ahead.
//   * B and C, shared by the block, are loaded a tile ahead into registers
//     (whole rows an instruction), stored as fp32 into one of two buffers,
//     and read by every lane as float4 broadcasts; one barrier a tile.
//   * y is stored under a predicate, not a branch, so the four steps of a
//     trip are one basic block that ptxas interleaves.
//   * At the prefill shape a block is 512 threads, all the warps an SM
//     holds, and its barrier every 128 steps keeps them in step, so no
//     warp runs on alone at the end; at smaller grids, 128 threads.
//   * KP of a channel's exps run on exp2_poly, on the FMA pipe (a template
//     parameter): KP = 1 at the bf16 prefill shape, where it measured a
//     little faster than KP = 0; KP = 0 elsewhere (slower at fp32; KP = 2
//     slower everywhere).
// Any S >= 1 (S = 1 is a decode step) and any di (the ragged edge masked).
// A thread reads its states once and writes the same states at the end,
// so hT may alias h0.  kernel.py's launch_config picks the launch for a
// shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int UNROLL = 4;      // steps a trip of the step loop
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may use
constexpr float LOG2E = 1.4426950408889634f;

// 2^f on [-1/2, 1/2] = 1 + f (C1 + f (C2 + f (C3 + f (C4 + f C5)))), a
// degree-5 fit of least relative error (1.7e-7 in fp32 with FMAs; degree
// 4, 2.7e-6, summed over the ~55 steps a slow state remembers, would
// break rtol 1e-4); kernel.py's EXP2_POLY mirrors these literals.
constexpr float EXP2_C1 = 6.931470037e-01f;
constexpr float EXP2_C2 = 2.402224243e-01f;
constexpr float EXP2_C3 = 5.550733581e-02f;
constexpr float EXP2_C4 = 9.671512991e-03f;
constexpr float EXP2_C5 = 1.326472848e-03f;
constexpr float ROUND_MAGIC = 12582912.f;  // 1.5 * 2^23

struct Params {
  const void* u;
  const void* dt;
  const float* A;
  const void* Bc;
  const void* Cc;
  const float* D;
  const float* h0;
  float* y;
  float* hT;
  int S, di, tile, chunk;  // tile: steps of u and dt a stage; chunk: copy bytes
  int64_t sbb, sbt, scb, sct;  // (batch, seq) strides of Bc and Cc, elements
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// a channel's u or dt as stored, and its fp32 value (a bf16 by a shift,
// not a conversion on the MUFU's quarter-rate pipe)
template <typename T> struct Raw;
template <> struct Raw<float> {
  using type = float;
  static __device__ __forceinline__ float f32(type v) { return v; }
};
template <> struct Raw<__nv_bfloat16> {
  using type = unsigned short;
  static __device__ __forceinline__ float f32(type v) {
    return __uint_as_float(static_cast<uint32_t>(v) << 16);
  }
};

// 2^x on the special-function unit (MUFU.EX2)
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// 2^x on the FMA pipe: x clamped to [-127, 128]; n = rint(x) by the
// 1.5 * 2^23 addition (a cvt would run on the MUFU's quarter-rate pipe),
// f = x - n in [-1/2, 1/2], 2^f by the polynomial, and n added to its
// exponent field.  x = 128 gives +inf, x = -127 gives 0, x = 0 gives 1.
__device__ __forceinline__ float exp2_poly(float x) {
  x = fminf(fmaxf(x, -127.f), 128.f);
  const float j = x + ROUND_MAGIC;  // n in the low bits of j's mantissa
  const float f = x - (j - ROUND_MAGIC);
  float p = fmaf(EXP2_C5, f, EXP2_C4);
  p = fmaf(p, f, EXP2_C3);
  p = fmaf(p, f, EXP2_C2);
  p = fmaf(p, f, EXP2_C1);
  p = fmaf(p, f, 1.f);
  return __int_as_float(__float_as_int(p) +
                        static_cast<int>(static_cast<uint32_t>(__float_as_int(j)) << 23));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One chunk of `bytes` (16, 8, 4, or 2 for a bf16 view aligned to nothing
// wider) from global to shared memory; a 2-byte chunk is copied by the
// thread itself.  Either is visible to the warp after cp_async_wait_all
// and a __syncwarp.
__device__ __forceinline__ void copy_chunk(unsigned char* dst, const unsigned char* src, int bytes) {
  const uint32_t d = smem_u32(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d), "l"(src) : "memory");
  else if (bytes == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
  else
    *reinterpret_cast<uint16_t*>(dst) = *reinterpret_cast<const uint16_t*>(src);
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;" ::: "memory"); }

// y_t of a channel, stored under a predicate rather than a branch: a
// branch would end the basic block at every step, and ptxas would not
// overlap one step's tail with the next step's exps.  No "memory" clobber:
// it would keep the next step's shared-memory loads below this store.
__device__ __forceinline__ void store_y(float* p, float v, bool live) {
  asm volatile("{\n .reg .pred q;\n setp.ne.u32 q, %2, 0;\n @q st.global.f32 [%0], %1;\n}"
               ::"l"(p), "f"(v), "r"(static_cast<uint32_t>(live)));
}

// Steps of B and C a block stages at once, and so steps between its
// barriers: 32 in a 128-thread block, 128 in a 512-thread one (fewer
// barriers, and its shared memory has room).
__host__ __device__ constexpr int bc_tile(int threads) { return threads == 512 ? 128 : 32; }

// Shared memory of a block, in bytes: per warp, a ring of two stages of
// `tile` steps of u and dt (each step a row of the warp's 32 channels of
// u, then of dt, as stored); then two buffers of bc_tile steps of B and C
// in fp32, shared by the block.  kernel.py's smem_bytes is the same
// formula.
__host__ __device__ constexpr int ud_ring_bytes(int itemsize, int tile) {
  return 2 * tile * 2 * 32 * itemsize;
}
__host__ __device__ constexpr int smem_bytes(int threads, int itemsize, int ds, int tile) {
  return threads / 32 * ud_ring_bytes(itemsize, tile) + 2 * 2 * bc_tile(threads) * ds * 4;
}

// A warp holds 32 channels, a lane one channel's DS states.  KP of the
// channel's DS exps (the last KP) run on exp2_poly, the rest on ex2.  A
// block is NT threads; at NT = 512 it is all the warps an SM holds, which
// its per-tile barrier keeps in step.
template <typename T, int DS, int KP, int NT>
__global__ void __launch_bounds__(NT, 512 / NT)
mamba_scan_fwd_kernel(const Params p) {
  static_assert(DS % 4 == 0, "B and C rows are read as float4");
  static_assert(KP >= 0 && KP <= DS, "KP of a channel's exps on the polynomial");
  constexpr int TILE = bc_tile(NT);
  constexpr int NBC = 2 * TILE * DS / NT;  // B and C values a thread stages a tile
  static_assert(NBC % 2 == 0, "a thread stages as many B values as C values");
  using P = typename Raw<T>::type;
  constexpr int ROW = 32 * sizeof(T);  // a step of u (or dt) for the warp's channels
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31;
  const int dw0 = blockIdx.x * NT + (tid - lane);  // the warp's first channel
  const int d0 = dw0 + lane;                       // the lane's channel
  const int S = p.S, di = p.di, tile = p.tile, chunk = p.chunk;
  // threads past di stay for the block's barriers; their loads and stores
  // are predicated off
  const bool live = d0 < di;
  unsigned char* ring = smem + (tid >> 5) * ud_ring_bytes(sizeof(T), tile);
  float* bcs = reinterpret_cast<float*>(smem + NT / 32 * ud_ring_bytes(sizeof(T), tile));

  const int b = blockIdx.y;
  const size_t row0 = (size_t)b * S * di;  // (b, 0, 0) of u, dt and y
  const unsigned char* uw = reinterpret_cast<const unsigned char*>(static_cast<const T*>(p.u) + row0 + dw0);
  const unsigned char* dw = reinterpret_cast<const unsigned char*>(static_cast<const T*>(p.dt) + row0 + dw0);
  float* yb = p.y + row0 + d0;
  const T* bb = static_cast<const T*>(p.Bc) + b * p.sbb;
  const T* cb = static_cast<const T*>(p.Cc) + b * p.scb;
  const size_t state_off = ((size_t)b * di + d0) * DS;

  // a lane's states and A entries are 16-byte aligned
  float h[DS], a2[DS];
  const float4* h04 = reinterpret_cast<const float4*>(p.h0 + state_off);
  const float4* a4 = reinterpret_cast<const float4*>(p.A + (size_t)d0 * DS);
#pragma unroll
  for (int q = 0; q < DS / 4; ++q) {
    const float4 hv = live ? h04[q] : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 av = live ? a4[q] : make_float4(0.f, 0.f, 0.f, 0.f);
    h[4 * q] = hv.x, h[4 * q + 1] = hv.y, h[4 * q + 2] = hv.z, h[4 * q + 3] = hv.w;
    a2[4 * q] = av.x * LOG2E, a2[4 * q + 1] = av.y * LOG2E;
    a2[4 * q + 2] = av.z * LOG2E, a2[4 * q + 3] = av.w * LOG2E;
  }
  const float dd = live ? p.D[d0] : 0.f;

  // u and dt: the warp copies a tile of rows (its 32 channels of a step)
  // into one stage of its ring, `chunk` bytes a lane, 32 / (ROW / chunk)
  // rows at a time; chunks past di are skipped (chunk divides di's bytes)
  const int cpr = ROW / chunk;                   // chunks a row, <= 32
  const int col = (lane & (cpr - 1)) * chunk;    // this lane's byte column
  const bool col_in = col < (di - dw0) * (int)sizeof(T);
  const size_t step_bytes = (size_t)di * sizeof(T);
  auto copy_ud = [&](int t0, int stage) {
    unsigned char* dst = ring + stage * tile * 2 * ROW + col;
    const int rows = min(tile, S - t0);
    if (col_in) {
      for (int r = lane / cpr; r < rows; r += 32 / cpr) {
        const size_t off = (size_t)(t0 + r) * step_bytes + col;
        copy_chunk(dst + r * 2 * ROW, uw + off, chunk);
        copy_chunk(dst + r * 2 * ROW + ROW, dw + off, chunk);
      }
    }
    cp_async_commit();
  };

  // B and C, shared by the block: the next tile's TILE x DS values of each
  // wait in registers, in the stored type, NBC a thread (element tid +
  // NT k of the row-major tile of B, then of C, so a load instruction
  // reads whole rows), while the block works on the current tile from one
  // of two fp32 buffers; one barrier a tile.
  T rbc[NBC];
  auto fetch_bc = [&](int t0) {
#pragma unroll
    for (int k = 0; k < NBC; ++k) {
      const int e = (k % (NBC / 2)) * NT + tid, t = t0 + e / DS, s = e % DS;
      const bool in = t < S;
      const T* src = k < NBC / 2 ? bb + (in ? t : 0) * p.sbt : cb + (in ? t : 0) * p.sct;
      rbc[k] = in ? src[s] : T(0.f);
    }
  };
  auto stage_bc = [&](float* buf) {
#pragma unroll
    for (int k = 0; k < NBC; ++k) buf[k * NT + tid] = to_f32(rbc[k]);
  };

  // one step: the lane's DS states, and y_t of its channel; B_t and C_t
  // are row `row` of the B and C tiles at bs and cs
  auto step = [&](int t, const float* bs, const float* cs, int row, P pu, P pd) {
    const float uf = Raw<T>::f32(pu), df = Raw<T>::f32(pd), dtu = df * uf;
    float acc[2] = {0.f, 0.f};
    const float4* b4 = reinterpret_cast<const float4*>(bs + row * DS);
    const float4* c4 = reinterpret_cast<const float4*>(cs + row * DS);
#pragma unroll
    for (int q = 0; q < DS / 4; ++q) {
      const float4 bv = b4[q], cv = c4[q];
      const float bq[4] = {bv.x, bv.y, bv.z, bv.w};
      const float cq[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = 4 * q + e;
        const float x = df * a2[s];
        const float dA = s >= DS - KP ? exp2_poly(x) : ex2(x);
        h[s] = fmaf(dA, h[s], dtu * bq[e]);
        acc[e & 1] = fmaf(h[s], cq[e], acc[e & 1]);
      }
    }
    store_y(yb + (size_t)t * di, (acc[0] + acc[1]) + dd * uf, live);
  };

  copy_ud(0, 0);
  fetch_bc(0);
  for (int t0 = 0, n = 0; t0 < S; t0 += tile, ++n) {
    cp_async_wait_all();  // this tile's u and dt (issued a tile ago) are in
    const float* bs = bcs + (t0 / TILE & 1) * 2 * TILE * DS;
    if (t0 % TILE == 0) {
      // the buffer was last read two B/C tiles ago, before the last barrier
      stage_bc(const_cast<float*>(bs));
      __syncthreads();  // B and C, and each warp's u and dt, are in
      if (t0 + TILE < S) fetch_bc(t0 + TILE);
    } else {
      __syncwarp();  // each warp's u and dt are in; it is done with the last stage
    }
    if (t0 + tile < S) copy_ud(t0 + tile, (n + 1) & 1);  // in flight during the tile
    const float* cs = bs + TILE * DS;
    // a step's u and dt are read from the ring a step ahead, off the
    // critical path of the exps that need them
    const unsigned char* st = ring + (n & 1) * tile * 2 * ROW + lane * sizeof(T);
    const int steps = min(tile, S - t0), row = t0 % TILE;
    P pu = *reinterpret_cast<const P*>(st), pd = *reinterpret_cast<const P*>(st + ROW);
#pragma unroll UNROLL
    for (int i = 0; i < steps; ++i) {
      const int j = min(i + 1, steps - 1);
      const P nu = *reinterpret_cast<const P*>(st + j * 2 * ROW);
      const P nd = *reinterpret_cast<const P*>(st + j * 2 * ROW + ROW);
      step(t0 + i, bs, cs, row + i, pu, pd);
      pu = nu, pd = nd;
    }
  }

  if (live) {
    float4* hT4 = reinterpret_cast<float4*>(p.hT + state_off);
#pragma unroll
    for (int q = 0; q < DS / 4; ++q)
      hT4[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
  }
}

// 2^x of n values by exp2_poly: the card-side check of the polynomial
__global__ void exp2_poly_kernel(const float* __restrict__ x, float* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = exp2_poly(x[i]);
}

template <typename T, int DS, int KP, int NT>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  auto kernel = mamba_scan_fwd_kernel<T, DS, KP, NT>;
  const int smem = smem_bytes(NT, sizeof(T), DS, p.tile);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  // set on every launch: the attributes belong to the current device's
  // context; all shared memory, so that the grid is one wave
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.di + NT - 1) / NT, B);
  kernel<<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

// The instantiated launches, each a (d_state, KP, NT) of kernel.py's
// CANDIDATES; anything else is refused.
template <typename T>
cudaError_t dispatch(int ds, int poly, int threads, const Params& p, int B, cudaStream_t stream) {
#define MS_CASE(DS_, KP_, NT_)                          \
  if (ds == DS_ && poly == KP_ && threads == NT_)       \
    return launch<T, DS_, KP_, NT_>(p, B, stream);
  MS_CASE(16, 1, 512)
  MS_CASE(16, 0, 512)
  MS_CASE(16, 0, 128)
  MS_CASE(8, 0, 128)
  MS_CASE(4, 0, 128)
#undef MS_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype (of u, dt, Bc, Cc): 0 = float32, 1 = bfloat16.  strides: 4 element
// strides, the (batch, seq) strides of Bc then Cc (their last dim is
// contiguous).  u, dt, y (B, S, di), A (di, ds), D (di,), h0 and hT
// (B, di, ds) are contiguous.  config: kernel.py's launch_config, in this
// order: poly KP, threads, tile, copy chunk bytes.  Launches on `device` and
// restores the caller's current device.  Returns the cudaError_t of the
// launch (0 on success); the launch is asynchronous.
int repro_mamba_scan_fwd(const void* u, const void* dt, const float* A, const void* Bc,
                         const void* Cc, const float* D, const float* h0, float* y, float* hT,
                         int dtype, int B, int S, int di, int ds, const int64_t* strides,
                         const int* config, int device, void* stream) {
  const int poly = config[0], threads = config[1], tile = config[2], chunk = config[3];
  const int itemsize = dtype == 0 ? 4 : 2;
  if (tile < 1 || bc_tile(threads) % tile || (chunk & (chunk - 1)) || chunk < itemsize ||
      chunk > 16)
    return (int)cudaErrorInvalidValue;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Params p{u, dt, A, Bc, Cc, D, h0, y, hT, S, di, tile, chunk,
                 strides[0], strides[1], strides[2], strides[3]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch<float>(ds, poly, threads, p, B, s);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(ds, poly, threads, p, B, s);
  else
    err = cudaErrorInvalidValue;
  const cudaError_t restore = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : restore);
}

// y[i] = exp2_poly(x[i]) for n fp32 values on `device`: the polynomial the
// scan uses, for its card-side check.  Returns the launch's cudaError_t.
int repro_mamba_scan_exp2_poly(const float* x, float* y, int n, int device, void* stream) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  exp2_poly_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(x, y, n);
  err = cudaGetLastError();
  const cudaError_t restore = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : restore);
}

const char* repro_mamba_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
