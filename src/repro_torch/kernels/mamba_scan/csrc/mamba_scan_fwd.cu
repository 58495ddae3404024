// Mamba-1 selective scan forward for Hopper (sm_90a), CUDA C++ on the CUDA
// cores.
//
// Replaces the Pallas TPU kernel `mamba_scan_fwd` / `_mamba_kernel` in
// src/repro/kernels/mamba_scan/kernel.py.  It computes the same function,
// per batch b, channel d and state s (A diagonal):
//   h_t[d,s] = exp(dt_t[d] A[d,s]) h_{t-1}[d,s] + dt_t[d] u_t[d] B_t[s]
//   y_t[d]   = sum_s h_t[d,s] C_t[s] + D[d] u_t[d]
// from h_0 = h0, and returns every y_t and the final state, both fp32.
// u, dt, B, C are fp32 or bf16; A, D, h0 are fp32; all math is fp32.
//
// Design.  The TPU kernel gives each program a (block_d, d_state) state slab
// in VMEM and walks time in chunks of 64 as a sequential grid axis, with
// the (T, block_d, d_state) decays of a chunk formed at once.  Here the
// channels, which never interact, are the parallel axis: one thread per
// (b, channel) keeps its d_state fp32 states, and A scaled by log2(e), in
// registers, and walks all S steps itself, so nothing is carried between
// blocks.  A block takes 128 consecutive channels of one b, so the loads of
// u and dt at (b, t, .) and the store of y coalesce.  Time goes in tiles
// of 16 steps: each thread loads its own column of u and dt for the tile,
// and the block loads the tile's B_t and C_t rows (d_state values a step,
// shared by every channel of the block) once, into shared memory; two
// barriers a tile, and the next tile's loads are issued into registers
// before the current tile's steps.  B and C are read through their (batch,
// seq) strides, since the model hands in column slices of its
// (B, S, dt_rank + 2 d_state) projection; u and dt are contiguous.  Any
// S >= 1 (S = 1 is a decode step) and any di: threads past di only load
// and wait at the barriers.  A thread reads its state elements once and
// writes the same elements at the end, so hT may alias h0.
//
// Bound at the main-path shape (B=4, S=2048, di=16384, ds=16; bf16 u, dt,
// B, C; fp32 y, A, D, states; 7 launches per jamba prefill): 1.08 GB moved
// (each input read once, each output written once), 0.32 ms at 3.35 TB/s;
// 6 fp32 flops per (b, t, d, s), 12.9 GFLOP, 0.19 ms at the 67 TFLOP/s
// fp32 CUDA-core peak.  So the bytes bound it.  But every (b, t, d, s)
// needs one exp: 2.15 G of them on the special-function units, 16 a clock
// on each of the 132 SMs, take 0.51 ms at 1.98 GHz, so a kernel that uses
// the hardware exp (ex2.approx here, one FMUL and one MUFU per element)
// cannot reach the byte bound.  The grid is di/128 * B = 512 blocks of 4
// warps; at <= 128 registers a thread, four blocks fit an SM and all 512
// run in one wave.  Computing part of the exps by polynomial on the FMA
// pipes, as FlashAttention-3 does, is the way below the SFU floor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // channels per block, one thread each
constexpr int TT = 16;   // time steps staged per tile
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// 2^x on the special-function unit; exp(dt A) = 2^(dt (A log2 e)).  The
// argument is <= 0 (dt > 0, A < 0), so the result lies in [0, 1].
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

template <typename T, int DS>
__global__ void __launch_bounds__(NT, 4)
mamba_scan_fwd_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ Bc,
                      const T* __restrict__ Cc, const float* __restrict__ D,
                      const float* h0, float* __restrict__ y, float* hT,
                      int S, int di, int64_t sbb, int64_t sbt, int64_t scb,
                      int64_t sct) {
  constexpr int BC_TILE = TT * DS;                  // B (or C) values a tile
  constexpr int BC_PER = (BC_TILE + NT - 1) / NT;   // ... each thread loads
  static_assert(DS % 4 == 0, "B and C rows are read as float4");
  __shared__ float us[TT][NT];
  __shared__ float dts[TT][NT];
  __shared__ __align__(16) float bs[BC_TILE];
  __shared__ __align__(16) float cs[BC_TILE];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int d = blockIdx.x * NT + tid;
  const bool live = d < di;

  const size_t row0 = (size_t)b * S * di + d;  // (b, 0, d) of u, dt and y
  const T* ub = u + row0;
  const T* db = dt + row0;
  float* yb = y + row0;
  const T* bb = Bc + b * sbb;
  const T* cb = Cc + b * scb;
  const size_t state_off = ((size_t)b * di + d) * DS;

  // a thread's d_state states and A row are 16-byte aligned: float4
  float h[DS], a2[DS];
  float dd = 0.f;
  if (live) {
    const float4* h04 = reinterpret_cast<const float4*>(h0 + state_off);
    const float4* a4 = reinterpret_cast<const float4*>(A + (size_t)d * DS);
#pragma unroll
    for (int q = 0; q < DS / 4; ++q) {
      const float4 hv = h04[q], av = a4[q];
      h[4 * q] = hv.x, h[4 * q + 1] = hv.y, h[4 * q + 2] = hv.z, h[4 * q + 3] = hv.w;
      a2[4 * q] = av.x * LOG2E, a2[4 * q + 1] = av.y * LOG2E;
      a2[4 * q + 2] = av.z * LOG2E, a2[4 * q + 3] = av.w * LOG2E;
    }
    dd = D[d];
  } else {
#pragma unroll
    for (int s = 0; s < DS; ++s) h[s] = a2[s] = 0.f;
  }

  // the next tile's values stay in their stored type until they are
  // written to shared memory: a conversion right after the load would wait
  // for it there and undo the prefetch
  T pu[TT], pd[TT], pb[BC_PER], pc[BC_PER];
  auto load_tile = [&](int t0) {
#pragma unroll
    for (int tt = 0; tt < TT; ++tt) {
      const int t = t0 + tt;
      const bool in = live && t < S;
      pu[tt] = in ? ub[(size_t)t * di] : zero<T>();
      pd[tt] = in ? db[(size_t)t * di] : zero<T>();
    }
#pragma unroll
    for (int c = 0; c < BC_PER; ++c) {
      const int i = tid + NT * c;
      const int t = t0 + i / DS;
      const bool in = i < BC_TILE && t < S;
      pb[c] = in ? bb[t * sbt + i % DS] : zero<T>();
      pc[c] = in ? cb[t * sct + i % DS] : zero<T>();
    }
  };

  load_tile(0);
  for (int t0 = 0; t0 < S; t0 += TT) {
    const int n = min(TT, S - t0);
    __syncthreads();  // the last tile's readers of bs and cs are done
#pragma unroll
    for (int tt = 0; tt < TT; ++tt) {
      us[tt][tid] = to_f32(pu[tt]);
      dts[tt][tid] = to_f32(pd[tt]);
    }
#pragma unroll
    for (int c = 0; c < BC_PER; ++c) {
      const int i = tid + NT * c;
      if (i < BC_TILE) {
        bs[i] = to_f32(pb[c]);
        cs[i] = to_f32(pc[c]);
      }
    }
    __syncthreads();
    if (t0 + TT < S) load_tile(t0 + TT);  // in flight during the tile

    if (live) {
#pragma unroll 2
      for (int tt = 0; tt < n; ++tt) {
        const float ut = us[tt][tid];
        const float dtt = dts[tt][tid];
        const float dtu = dtt * ut;
        const float4* b4 = reinterpret_cast<const float4*>(bs + tt * DS);
        const float4* c4 = reinterpret_cast<const float4*>(cs + tt * DS);
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int q = 0; q < DS / 4; ++q) {
          const float4 bv = b4[q];
          const float4 cv = c4[q];
          const float bq[4] = {bv.x, bv.y, bv.z, bv.w};
          const float cq[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int s = 4 * q + e;
            h[s] = fmaf(ex2(dtt * a2[s]), h[s], dtu * bq[e]);
            acc[e] = fmaf(h[s], cq[e], acc[e]);
          }
        }
        yb[(size_t)(t0 + tt) * di] = (acc[0] + acc[1]) + (acc[2] + acc[3]) + dd * ut;
      }
    }
  }

  if (live) {
    float4* hT4 = reinterpret_cast<float4*>(hT + state_off);
#pragma unroll
    for (int q = 0; q < DS / 4; ++q)
      hT4[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
  }
}

template <typename T, int DS>
cudaError_t launch(const void* u, const void* dt, const float* A,
                   const void* Bc, const void* Cc, const float* D,
                   const float* h0, float* y, float* hT, int B, int S, int di,
                   const int64_t* st, cudaStream_t stream) {
  const dim3 grid((di + NT - 1) / NT, B);
  mamba_scan_fwd_kernel<T, DS><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), A,
      static_cast<const T*>(Bc), static_cast<const T*>(Cc), D, h0, y, hT, S,
      di, st[0], st[1], st[2], st[3]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d_state(int ds, const void* u, const void* dt,
                             const float* A, const void* Bc, const void* Cc,
                             const float* D, const float* h0, float* y,
                             float* hT, int B, int S, int di,
                             const int64_t* st, cudaStream_t stream) {
  switch (ds) {
    case 4: return launch<T, 4>(u, dt, A, Bc, Cc, D, h0, y, hT, B, S, di, st, stream);
    case 8: return launch<T, 8>(u, dt, A, Bc, Cc, D, h0, y, hT, B, S, di, st, stream);
    case 16: return launch<T, 16>(u, dt, A, Bc, Cc, D, h0, y, hT, B, S, di, st, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype (of u, dt, Bc, Cc): 0 = float32, 1 = bfloat16.  strides: 4 element
// strides, the (batch, seq) strides of Bc then Cc (their last dim is
// contiguous).  u, dt, y (B, S, di), A (di, ds), D (di,), h0 and hT
// (B, di, ds) are contiguous.  Launches on `device` and restores the
// caller's current device.  Returns the cudaError_t of the launch (0 on
// success); the launch is asynchronous.
int repro_mamba_scan_fwd(const void* u, const void* dt, const float* A,
                         const void* Bc, const void* Cc, const float* D,
                         const float* h0, float* y, float* hT, int dtype,
                         int B, int S, int di, int ds, const int64_t* strides,
                         int device, void* stream) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch_d_state<float>(ds, u, dt, A, Bc, Cc, D, h0, y, hT, B, S, di, strides, s);
  else if (dtype == 1)
    err = dispatch_d_state<__nv_bfloat16>(ds, u, dt, A, Bc, Cc, D, h0, y, hT, B, S, di, strides, s);
  else
    err = cudaErrorInvalidValue;
  const cudaError_t restore = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : restore);
}

const char* repro_mamba_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
