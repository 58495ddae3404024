// Fused int8 quantize + error-feedback residual for Hopper (sm_90a), CUDA
// C++ on the CUDA cores.
//
// Replaces the Pallas TPU kernel `quantize_ef_fwd` / `_quant_kernel` in
// src/repro/kernels/quantize/kernel.py.  It computes the same function, the
// slow tier's int8 codec (repro.core.compression.Int8Codec) with its
// error-feedback residual: the flat x (n,) is viewed as (n/block, block) and
// for each quantization block
//   scale = max(max|x| / 127, 1e-30)
//   q     = clip(rint(x / scale), -127, 127)      (int8)
//   err   = x - q * scale                          (fp32)
// x is fp32 or bf16; like the TPU kernel it is cast to fp32 first, and all
// math is fp32.
//
// Bit-exactness.  q, scale and err must equal the plain version (and the
// codec in the JAX package) bit for bit, so every rounding step is the
// reference's: the division by 127 and by the scale are IEEE divisions
// (__fdiv_rn, never a multiply by a reciprocal), rint rounds half to even
// like jnp.round (roundf would round half away from zero), and err rounds
// the product q * scale before the subtraction (the codec decodes first),
// so it is written with __fmul_rn and __fsub_rn, which nvcc never contracts
// into an FMA.  The absmax is a max of magnitudes, exact in any order.
//
// Design.  One CTA per quantization block: 256 threads for a block of 2048
// (8 elements a thread), 128 for 512 and 32 for 128 (4 a thread).  Thread t
// loads 4-element vectors t, t + NT, ... of its block (16-byte loads of
// fp32, 8-byte loads of bf16; scalar loads when the base pointer is not
// aligned), so each warp reads contiguous 512-byte runs.  The absmax is a
// warp-shuffle max and, across warps, a max over shared memory; then each
// thread writes its q (4 bytes a vector) and err (16 bytes a vector) from
// the values it holds in registers: x is read once.
//
// Bound: bytes.  4n read (fp32), n written for q, 4n for err and 4n/block
// for the scales: 9n bytes.  At the training path's largest section (the
// qwen2-0.5b embedding, n = 136,134,656) that is 1.225 GB, 0.366 ms at
// 3.35 TB/s; the ~3 flops an element are nothing beside it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int BLOCK> struct Shape {
  static constexpr int NT = BLOCK >= 1024 ? 256 : BLOCK / 4;  // threads
  static constexpr int PER = BLOCK / NT;                      // elements a thread
  static constexpr int NV = PER / 4;                          // 4-vectors a thread
  static_assert(PER % 4 == 0 && NT % 32 == 0, "unsupported block");
};

__device__ __forceinline__ void load4(const float* p, float* v, bool vec) {
  if (vec) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = p[i];
  }
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v, bool vec) {
  if (vec) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
    v[0] = __low2float(a); v[1] = __high2float(a);
    v[2] = __low2float(b); v[3] = __high2float(b);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __bfloat162float(p[i]);
  }
}

template <typename T, int BLOCK, bool VEC>
__global__ void __launch_bounds__(Shape<BLOCK>::NT)
quantize_ef_fwd_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                       float* __restrict__ scales, float* __restrict__ err) {
  constexpr int NT = Shape<BLOCK>::NT, PER = Shape<BLOCK>::PER,
                NV = Shape<BLOCK>::NV, NW = NT / 32;
  __shared__ float warp_max[NW];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * BLOCK;
  const int tid = threadIdx.x;

  float v[PER];
#pragma unroll
  for (int k = 0; k < NV; ++k)
    load4(x + base + 4 * (k * NT + tid), &v[4 * k], VEC);

  float m = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) m = fmaxf(m, fabsf(v[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (NW > 1) {
    if ((tid & 31) == 0) warp_max[tid >> 5] = m;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < NW; ++w) m = fmaxf(m, warp_max[w]);
  }

  float s = __fdiv_rn(m, 127.f);
  s = s < 1e-30f ? 1e-30f : s;  // jnp.maximum(scale, 1e-30)
  if (tid == 0) scales[blockIdx.x] = s;

#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int64_t i = base + 4 * (k * NT + tid);
    float r[4], e[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float xv = v[4 * k + j];
      r[j] = fminf(fmaxf(rintf(__fdiv_rn(xv, s)), -127.f), 127.f);
      e[j] = __fsub_rn(xv, __fmul_rn(r[j], s));
    }
    const char4 qv = make_char4(static_cast<signed char>(r[0]), static_cast<signed char>(r[1]),
                                static_cast<signed char>(r[2]), static_cast<signed char>(r[3]));
    // q and err are fresh allocations, so always aligned
    *reinterpret_cast<char4*>(q + i) = qv;
    *reinterpret_cast<float4*>(err + i) = make_float4(e[0], e[1], e[2], e[3]);
  }
}

template <typename T, int BLOCK>
cudaError_t launch(const void* x, int8_t* q, float* scales, float* err,
                   int64_t n_blocks, bool aligned, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(n_blocks));
  const T* xt = static_cast<const T*>(x);
  if (aligned)
    quantize_ef_fwd_kernel<T, BLOCK, true><<<grid, Shape<BLOCK>::NT, 0, stream>>>(xt, q, scales, err);
  else
    quantize_ef_fwd_kernel<T, BLOCK, false><<<grid, Shape<BLOCK>::NT, 0, stream>>>(xt, q, scales, err);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_block(int block, const void* x, int8_t* q, float* scales,
                           float* err, int64_t n_blocks, bool aligned,
                           cudaStream_t stream) {
  switch (block) {
    case 128: return launch<T, 128>(x, q, scales, err, n_blocks, aligned, stream);
    case 512: return launch<T, 512>(x, q, scales, err, n_blocks, aligned, stream);
    case 2048: return launch<T, 2048>(x, q, scales, err, n_blocks, aligned, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype (of x): 0 = float32, 1 = bfloat16.  x (n,) contiguous, n = n_blocks
// * block; q (n,) int8, scales (n_blocks,) fp32, err (n,) fp32, contiguous
// and 16-byte aligned.  `aligned`: x is 16-byte aligned (fp32) or 8-byte
// aligned (bf16).  Launches on `device` and restores the caller's current
// device.  Returns the cudaError_t of the launch (0 on success); the launch
// is asynchronous.
int repro_quantize_ef_fwd(const void* x, int8_t* q, float* scales, float* err,
                          int dtype, int64_t n_blocks, int block, int aligned,
                          int device, void* stream) {
  if (n_blocks < 1 || n_blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    e = dispatch_block<float>(block, x, q, scales, err, n_blocks, aligned != 0, s);
  else if (dtype == 1)
    e = dispatch_block<__nv_bfloat16>(block, x, q, scales, err, n_blocks, aligned != 0, s);
  else
    e = cudaErrorInvalidValue;
  const cudaError_t restore = cudaSetDevice(prev);
  return (int)(e != cudaSuccess ? e : restore);
}

const char* repro_quantize_ef_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
