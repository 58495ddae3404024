// WKV6 (RWKV6 "Finch") recurrence forward for Hopper (sm_90a), CUDA C++ on
// the CUDA cores.
//
// Replaces the Pallas TPU kernel `wkv6_fwd` / `_wkv6_kernel` in
// src/repro/kernels/wkv6/kernel.py.  It computes the same function, per
// (batch b, head h), key dim i, value dim j:
//   y_t[j] = sum_i r_t[i] * (S_{t-1}[i,j] + u[i] k_t[i] v_t[j])
//   S_t[i,j] = w_t[i] S_{t-1}[i,j] + k_t[i] v_t[j]
// from S_0 = s0, and returns every y_t and the final state, both fp32.
// r, k, v are fp32 or bf16; w, u, s0 are fp32; all math is fp32.
//
// Design.  The TPU kernel walks time in chunks of 32 with the state in VMEM
// and folds a chunk's decays into a (T, T, hd) tensor for the MXU.  Here the
// recurrence stays sequential, as in the oracle, so no exponent of a
// cumulative decay is ever formed (nothing to mask, nothing to overflow).
// One block per (b, h), hd * 4 threads.  Column j of the state belongs to
// four neighbouring lanes; lane q of the four keeps rows
// [q*hd/4, (q+1)*hd/4) of it in registers, and the four partial sums of y_j
// meet by two warp shuffles.  Columns never interact, so no barrier is
// needed inside a time step.  Time goes in tiles of 32 steps: the block
// stages a tile's r, k, w (padded so the four lanes' float4 reads fall in
// distinct banks) and v in shared memory, two barriers a tile, and the next
// tile's loads are issued into registers before the current tile is
// computed.  r, k, v, w and y are read and written through their strides,
// so the model's (B, S, H, hd) tensors go in and come out without copies;
// the last dim must be contiguous.  Any S >= 1 (S = 1 is a decode step).
// A thread reads its state elements once and writes the same elements at
// the end, so sT may alias s0.
//
// Bound at the main-path shape (B=4, H=32, S=2048, hd=64; bf16 r/k/v, fp32
// w/y/state; 24 launches per rwkv6-1.6b prefill): 239 MB moved (each input
// read once, each output written once), 0.071 ms at 3.35 TB/s; 5 flops per
// (t, i, j) -- the y dot product's multiply-add and the state's
// multiply-add with the k v^T outer product -- 5.4 GFLOP, 0.080 ms at the
// 67 TFLOP/s fp32 CUDA-core peak.  So operations bound it, barely.  The
// grid is B*H = 128 blocks of 8 warps on 132 SMs, one block per SM: each SM
// spends 4 instructions (7 FLOPs) per (t, i, j) here, as the u term is not
// factored out, on 2 warps per scheduler, so expect several times the bound.  The chunked
// form on tensor cores, and splitting a head's columns over more blocks,
// are the ways down.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TPC = 4;      // lanes per state column
constexpr int T_TILE = 32;  // time steps staged per barrier
constexpr int PER = T_TILE / TPC;  // elements of a tile each thread loads, per array

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int HD>
__global__ void __launch_bounds__(HD * TPC)
wkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* s0,
                float* __restrict__ y, float* sT, int H, int S,
                int64_t srb, int64_t srh, int64_t srs,
                int64_t skb, int64_t skh, int64_t sks,
                int64_t svb, int64_t svh, int64_t svs,
                int64_t swb, int64_t swh, int64_t sws,
                int64_t syb, int64_t syh, int64_t sys) {
  constexpr int ROWS = HD / TPC;  // state rows a lane keeps
  constexpr int LDR = ROWS + 4;   // padded row chunk (float4 reads conflict-free)
  constexpr int LDT = TPC * LDR;  // one time step of r, k or w
  static_assert(ROWS % 4 == 0, "a lane's rows are read as float4");
  __shared__ __align__(16) float rs[T_TILE * LDT];
  __shared__ __align__(16) float ks[T_TILE * LDT];
  __shared__ __align__(16) float ws[T_TILE * LDT];
  __shared__ float vs[T_TILE * HD];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int j = tid / TPC;  // state column
  const int q = tid % TPC;  // which quarter of its rows

  const T* rb = r + b * srb + h * srh;
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;
  const float* wb = w + b * swb + h * swh;
  float* yb = y + b * syb + h * syh;
  const size_t state_off = ((size_t)b * H + h) * HD * HD;

  float st[ROWS], uu[ROWS];
#pragma unroll
  for (int m = 0; m < ROWS; ++m) {
    const int i = q * ROWS + m;
    st[m] = s0[state_off + (size_t)i * HD + j];
    uu[m] = u[h * HD + i];
  }

  // tile loads: thread tid takes column `col` at steps tid/HD + TPC*c
  const int col = tid % HD;
  const int row0 = tid / HD;
  const int sm_col = (col / ROWS) * LDR + col % ROWS;
  float pr[PER], pk[PER], pv[PER], pw[PER];
  auto load_tile = [&](int t0) {
#pragma unroll
    for (int c = 0; c < PER; ++c) {
      const int t = t0 + row0 + TPC * c;
      const bool in = t < S;
      pr[c] = in ? to_f32(rb[t * srs + col]) : 0.f;
      pk[c] = in ? to_f32(kb[t * sks + col]) : 0.f;
      pv[c] = in ? to_f32(vb[t * svs + col]) : 0.f;
      pw[c] = in ? wb[t * sws + col] : 0.f;
    }
  };

  load_tile(0);
  for (int t0 = 0; t0 < S; t0 += T_TILE) {
    const int n = min(T_TILE, S - t0);
    __syncthreads();  // the last tile's readers are done
#pragma unroll
    for (int c = 0; c < PER; ++c) {
      const int tt = row0 + TPC * c;
      rs[tt * LDT + sm_col] = pr[c];
      ks[tt * LDT + sm_col] = pk[c];
      ws[tt * LDT + sm_col] = pw[c];
      vs[tt * HD + col] = pv[c];
    }
    __syncthreads();
    if (t0 + T_TILE < S) load_tile(t0 + T_TILE);  // in flight during the tile

    for (int tt = 0; tt < n; ++tt) {
      const float vj = vs[tt * HD + j];
      const float* rr = rs + tt * LDT + q * LDR;
      const float* kk = ks + tt * LDT + q * LDR;
      const float* ww = ws + tt * LDT + q * LDR;
      float acc[2] = {0.f, 0.f};
#pragma unroll
      for (int m = 0; m < ROWS; m += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(rr + m);
        const float4 k4 = *reinterpret_cast<const float4*>(kk + m);
        const float4 w4 = *reinterpret_cast<const float4*>(ww + m);
        const float rv[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kv4[4] = {k4.x, k4.y, k4.z, k4.w};
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float kv = kv4[e] * vj;
          acc[e & 1] = fmaf(rv[e], fmaf(uu[m + e], kv, st[m + e]), acc[e & 1]);
          st[m + e] = fmaf(wv[e], st[m + e], kv);
        }
      }
      float yj = acc[0] + acc[1];
      yj += __shfl_xor_sync(0xffffffffu, yj, 1);
      yj += __shfl_xor_sync(0xffffffffu, yj, 2);
      if (q == 0) yb[(int64_t)(t0 + tt) * sys + j] = yj;
    }
  }

#pragma unroll
  for (int m = 0; m < ROWS; ++m)
    sT[state_off + (size_t)(q * ROWS + m) * HD + j] = st[m];
}

template <typename T, int HD>
cudaError_t launch(const void* r, const void* k, const void* v, const float* w,
                   const float* u, const float* s0, float* y, float* sT,
                   int B, int H, int S, const int64_t* st, cudaStream_t stream) {
  const dim3 grid(H, B);
  wkv6_fwd_kernel<T, HD><<<grid, HD * TPC, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, y, sT, H, S,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], st[12], st[13], st[14]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(int hd, const void* r, const void* k,
                              const void* v, const float* w, const float* u,
                              const float* s0, float* y, float* sT, int B,
                              int H, int S, const int64_t* st,
                              cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(r, k, v, w, u, s0, y, sT, B, H, S, st, stream);
    case 32: return launch<T, 32>(r, k, v, w, u, s0, y, sT, B, H, S, st, stream);
    case 64: return launch<T, 64>(r, k, v, w, u, s0, y, sT, B, H, S, st, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype (of r, k, v): 0 = float32, 1 = bfloat16.  strides: 15 element
// strides, the (batch, head, seq) strides of r, k, v, w and y in that
// order.  u (H, hd), s0 and sT (B, H, hd, hd) are contiguous.  Launches on
// `device` and restores the caller's current device.  Returns the
// cudaError_t of the launch (0 on success); the launch is asynchronous.
int repro_wkv6_fwd(const void* r, const void* k, const void* v, const float* w,
                   const float* u, const float* s0, float* y, float* sT,
                   int dtype, int B, int H, int S, int hd,
                   const int64_t* strides, int device, void* stream) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch_head_dim<float>(hd, r, k, v, w, u, s0, y, sT, B, H, S, strides, s);
  else if (dtype == 1)
    err = dispatch_head_dim<__nv_bfloat16>(hd, r, k, v, w, u, s0, y, sT, B, H, S, strides, s);
  else
    err = cudaErrorInvalidValue;
  const cudaError_t restore = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : restore);
}

const char* repro_wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
