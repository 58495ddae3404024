// Flash-attention forward for Hopper (sm_90a), CUDA C++ on the CUDA cores.
//
// Replaces the Pallas TPU kernel `flash_attention_fwd` / `_fa_kernel` in
// src/repro/kernels/flash_attention/kernel.py.  It computes the same
// function, not the same blocks:
//   q (B,H,S,hd), k/v (B,KV,S,hd); the kv head of q head h is h / (H/KV);
//   s = q.k^T / sqrt(hd) in fp32, causal positions above the diagonal masked;
//   an online softmax keeps m and l in fp32; o = acc / max(l, 1e-30), cast
//   to q's dtype.  Inputs are fp32 or bf16; all math is fp32.
//
// Design.  One thread block per (64-row q tile, q head, batch), 256 threads:
// four threads share each q row.  The TPU's sequential kv grid axis becomes
// a loop inside the block, and under `causal` it stops at the diagonal tile
// (the TPU kernel's tile skip).  Each kv tile (64 rows) is staged in shared
// memory as fp32; for the scores each of a row's four threads takes every
// fourth key, and for P.V every fourth output column, so the softmax
// statistics need two warp shuffles per tile and P goes through shared
// memory.  Rows are padded to hd+1 floats so those strided reads hit
// distinct banks.  The kernel masks the ragged sequence edge itself and so
// takes any S >= 1 (the TPU kernel needs S % block == 0).  Strides are
// passed in, so q/k/v/o can be the model's (B,S,heads,hd) memory viewed as
// (B,heads,S,hd) with no copy; the last dim must be contiguous.
//
// Bound at the main-path shape (q (4,14,2048,64), k/v (4,2,2048,64),
// causal, bf16, 24 launches per qwen2-0.5b prefill): 4*hd*S(S+1)/2 per head
// = 30.1 GFLOP, 30 us at 989 TFLOP/s bf16 dense; 33.6 MB moved, 10 us at
// 3.35 TB/s.  So operations bound it, on the tensor cores.  This kernel
// runs on the CUDA cores in fp32 (>= 0.45 ms at 67 TFLOP/s), and its inner
// loops read one shared-memory word per FMA, which caps it near a quarter
// of that rate.  Tensor cores (wgmma with TMA-fed tiles) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_Q = 64;
constexpr int BLOCK_K = 64;
constexpr int TPR = 4;                  // threads per q row
constexpr int THREADS = BLOCK_Q * TPR;  // 256
constexpr int KPT = BLOCK_K / TPR;      // keys scored per thread per tile
constexpr int LDP = BLOCK_K + 1;        // padded row of the P tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(3 * BLOCK_Q * (HD + 1) + BLOCK_Q * LDP);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              int G, int S, int causal, float scale,
              int64_t sqb, int64_t sqh, int64_t sqs,
              int64_t skb, int64_t skh, int64_t sks,
              int64_t svb, int64_t svh, int64_t svs,
              int64_t sob, int64_t soh, int64_t sos) {
  static_assert(HD % TPR == 0, "a row's threads split head_dim evenly");
  constexpr int LD = HD + 1;       // padded smem row (floats)
  constexpr int DPT = HD / TPR;    // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                 // [BLOCK_Q][LD]; reused for the output
  float* Ks = Qs + BLOCK_Q * LD;    // [BLOCK_K][LD]
  float* Vs = Ks + BLOCK_K * LD;    // [BLOCK_K][LD]
  float* Ps = Vs + BLOCK_K * LD;    // [BLOCK_Q][LDP]

  // launch the longest causal tiles (highest q) first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * BLOCK_Q;
  const int tid = threadIdx.x;
  const int r = tid / TPR;          // q row in the tile; its 4 threads share a warp
  const int t = tid % TPR;
  const int qpos = q0 + r;

  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + (h / G) * skh;
  const T* vb = v + b * svb + (h / G) * svh;
  T* ob = o + b * sob + h * soh;

  for (int i = tid; i < BLOCK_Q * HD; i += THREADS) {
    const int row = i / HD, col = i % HD;
    const int s = q0 + row;
    Qs[row * LD + col] = s < S ? to_f32(qb[s * sqs + col]) : 0.f;
  }

  float m = NEG_INF, l = 0.f;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  const int n_kt_all = (S + BLOCK_K - 1) / BLOCK_K;
  const int n_kt = causal ? min(qt + 1, n_kt_all) : n_kt_all;
  float* prow = Ps + r * LDP;
  const float* qrow = Qs + r * LD;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BLOCK_K;
    __syncthreads();  // the last tile's readers are done; Qs is loaded
    for (int i = tid; i < BLOCK_K * HD; i += THREADS) {
      const int row = i / HD, col = i % HD;
      const int s = k0 + row;
      const bool in = s < S;
      Ks[row * LD + col] = in ? to_f32(kb[s * sks + col]) : 0.f;
      Vs[row * LD + col] = in ? to_f32(vb[s * svs + col]) : 0.f;
    }
    __syncthreads();

    float sc[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) sc[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int j = 0; j < KPT; ++j) sc[j] = fmaf(qd, Ks[(t + TPR * j) * LD + d], sc[j]);
    }

    unsigned valid = 0;
    float tile_max = NEG_INF;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int kpos = k0 + t + TPR * j;
      const bool ok = kpos < S && (!causal || kpos <= qpos);
      valid |= (unsigned)ok << j;
      sc[j] = ok ? sc[j] * scale : NEG_INF;
      tile_max = fmaxf(tile_max, sc[j]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const float p = ((valid >> j) & 1u) ? expf(sc[j] - m_new) : 0.f;
      prow[t + TPR * j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // the row's P is written by its 4 threads, all in this warp

#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll 4
    for (int j = 0; j < BLOCK_K; ++j) {
      const float p = prow[j];
      const float* vrow = Vs + j * LD;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(p, vrow[t + TPR * i], acc[i]);
    }
  }

  const float denom = fmaxf(l, 1e-30f);
  __syncthreads();  // every thread is done reading Qs
#pragma unroll
  for (int i = 0; i < DPT; ++i) Qs[r * LD + t + TPR * i] = acc[i] / denom;
  __syncthreads();
  for (int i = tid; i < BLOCK_Q * HD; i += THREADS) {
    const int row = i / HD, col = i % HD;
    const int s = q0 + row;
    if (s < S) store_from_f32(ob + s * sos + col, Qs[row * LD + col]);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KV, int S, int causal, const int64_t* st,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BLOCK_Q - 1) / BLOCK_Q, H, B);
  const float scale = 1.0f / sqrtf((float)HD);
  fa_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H / KV, S, causal, scale,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(int hd, const void* q, const void* k,
                              const void* v, void* o, int B, int H, int KV,
                              int S, int causal, const int64_t* st,
                              cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, KV, S, causal, st, stream);
    case 24: return launch<T, 24>(q, k, v, o, B, H, KV, S, causal, st, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, H, KV, S, causal, st, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, KV, S, causal, st, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, KV, S, causal, st, stream);
    case 160: return launch<T, 160>(q, k, v, o, B, H, KV, S, causal, st, stream);
    case 192: return launch<T, 192>(q, k, v, o, B, H, KV, S, causal, st, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 element strides, the
// (batch, head, seq) strides of q, k, v and o in that order.  Launches on
// `device` and restores the caller's current device.  Returns the
// cudaError_t of the launch (0 on success); the launch is asynchronous.
int repro_flash_attention_fwd(const void* q, const void* k, const void* v,
                              void* o, int dtype, int B, int H, int KV, int S,
                              int hd, int causal, const int64_t* strides,
                              int device, void* stream) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch_head_dim<float>(hd, q, k, v, o, B, H, KV, S, causal, strides, s);
  else if (dtype == 1)
    err = dispatch_head_dim<__nv_bfloat16>(hd, q, k, v, o, B, H, KV, S, causal, strides, s);
  else
    err = cudaErrorInvalidValue;
  const cudaError_t restore = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : restore);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
