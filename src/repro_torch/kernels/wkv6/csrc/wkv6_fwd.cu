// WKV6 (RWKV6 "Finch") recurrence forward for Hopper (sm_90a), CUDA C++ on
// the CUDA cores, all arithmetic in fp32 (no TF32, no bf16 accumulation).
//
// Replaces the Pallas TPU kernel `wkv6_fwd` / `_wkv6_kernel` in
// src/repro/kernels/wkv6/kernel.py (pallas_call at :104).  It computes the
// same function, per (batch b, head h), key dim i, value dim j:
//   y_t[j] = sum_i r_t[i] * (S_{t-1}[i,j] + u[i] k_t[i] v_t[j])
//   S_t[i,j] = w_t[i] S_{t-1}[i,j] + k_t[i] v_t[j]
// from S_0 = s0, and returns every y_t and the final state, both fp32.
// r, k, v are fp32 or bf16; w, u, s0 are fp32.
//
// Design.
//   * The u term is one scalar a step: y_t = S_{t-1}^T r_t + a_t v_t with
//     a_t = sum_i r_t[i] u[i] k_t[i].  A step then costs 3 fp32 instructions
//     per (t, i, j): the FFMA of y's dot product, the FMUL of k v^T and the
//     FFMA of the state's decay.  The recurrence stays sequential, as in the
//     oracle, so no exponent of a cumulative decay is ever formed.
//   * Block: one (b, h) and one group of hd/NJ value columns (NJ > 1 splits a
//     head's columns when B*H alone cannot fill the card; each such block
//     reads its head's r, k, w again, from L2).  Compute warps and four
//     helper warps, joined by named barriers: FULL[b] (tile n's rows and a_t
//     are ready, b = n & 1) and EMPTY[b] (the compute warps are done with
//     tile n).
//   * Compute warps: an R x C micro-tile of the state in registers per
//     thread.  A step reads R values each of r, k, w and C of v from the
//     ring (bf16 widened in registers, one 4- to 16-byte load each), issues
//     3 R C fp32 instructions and stores its C partial sums of y_t (one
//     STS.128/64).  No shuffle and no barrier inside a tile; steps go UNROLL
//     a basic block, so step t+1's loads issue under step t's math.
//   * Helper warps: a ring of `stages` tiles of T steps of r, k, v (stored
//     type) and w, filled by 16-byte cp.async (4-, 8- or 2-byte chunks where
//     a view is aligned to less), stages - 2 tiles in flight.  Iteration n
//     forms a_t for tile n (4 lanes a step, 2 shuffles) while the compute
//     warps run tile n-1, then sums tile n-1's y partials over the hd/R row
//     groups, adds a_t v_t and writes y coalesced through y's strides while
//     they run tile n.
// r, k, v, w and y are read and written through their strides, so the
// model's (B, S, H, hd) tensors go in and come out without copies; the last
// dim must be contiguous.  Any S >= 1 (S = 1 is a decode step).  A thread
// reads its state elements once and writes the same elements at the end,
// so sT may alias s0.
//
// Bound at the main-path shape (B=4, H=32, S=2048, hd=64; bf16 r/k/v, fp32
// w/y/state; 24 launches per rwkv6-1.6b prefill): 239 MB moved (each input
// read once, each output written once), 0.071 ms at 3.35 TB/s; 5 flops per
// (t, i, j), 5.4 GFLOP, 0.080 ms at the 67 TFLOP/s fp32 CUDA-core peak, so
// operations bound it, barely.  The 3 instructions per (t, i, j) are 3.2 G
// on 128 SMs x 128 lanes: 0.11 ms at 1.755 GHz.  Not the chunked form of
// the TPU kernel: on the CUDA cores it costs about as much (3 T hd^2 per
// chunk of T steps against 3 T hd^2 here), and on the tensor cores the fp32
// contract (rtol 1e-4) needs 3xTF32 and a masked exponent.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may use
constexpr int HELPERS = 128;      // threads of the helper warps of a block
// Steps a trip of the step loop: the trip is one basic block, so the
// scheduler issues step t+1's shared loads under step t's math.
constexpr int UNROLL = 4;
// named barriers: FULL[b] (a tile's rows are ready), EMPTY[b] (the compute
// warps are done with a tile), b = tile & 1; BAR_HELPERS joins the helper
// warps alone
constexpr int BAR_FULL = 1, BAR_EMPTY = 3, BAR_HELPERS = 5;

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  const float* s0;
  float* y;
  float* sT;
  int H, S, nj, tile, stages, copy_bytes;
  int64_t sr[3], sk[3], sv[3], sw[3], sy[3];  // (batch, head, seq) strides
};

// Shared memory of one block, in bytes, laid out in this order: the ring
// (stages x [r | k | v | w] tiles, as stored), the y partials
// (2 x tile x hd/R x hd/NJ) and a_t (2 x tile).  kernel.py's smem_bytes is
// the same formula; the entry point refuses a launch where the two disagree.
__host__ __device__ constexpr int stage_bytes(int hd, int itemsize, int tile) {
  return tile * hd * (3 * itemsize + 4);
}
__host__ __device__ constexpr int smem_bytes(int hd, int itemsize, int rows, int nj,
                                             int tile, int stages) {
  return stages * stage_bytes(hd, itemsize, tile) + 2 * tile * (hd / rows) * (hd / nj) * 4 +
         2 * tile * 4;
}

// threads a block: the compute threads, in whole warps, and the helpers
__host__ __device__ constexpr int block_threads(int hd, int rows, int cols, int nj) {
  return ((hd / rows) * (hd / nj / cols) + 31) / 32 * 32 + HELPERS;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One chunk of `bytes` (8, 4, or 2 for a bf16 view aligned to nothing
// wider) from global to shared memory; a 2-byte chunk is copied by the
// thread itself and is visible after the next barrier, like the others.
__device__ __forceinline__ void copy_chunk(unsigned char* dst, const unsigned char* src,
                                           int bytes) {
  const uint32_t d = smem_u32(dst);
  if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d), "l"(src) : "memory");
  else if (bytes == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
  else
    *reinterpret_cast<uint16_t*>(dst) = *reinterpret_cast<const uint16_t*>(src);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most `pending` (0 or 1) groups are still in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending == 1)
    asm volatile("cp.async.wait_group 1;" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// `rows` rows of `row_bytes` each, `src_stride` bytes apart, into contiguous
// rows at dst, in chunks of `cb` bytes spread over the block; a row holds
// 2^shift chunks (row_bytes and cb are powers of two)
__device__ __forceinline__ void copy_rows(unsigned char* dst, const unsigned char* src,
                                          int64_t src_stride, int rows, int row_bytes,
                                          int cb, int tid, int nthreads) {
  const int shift = __ffs(row_bytes / cb) - 1;
  const int mask = (1 << shift) - 1;
  if (cb == 16) {  // the usual case, without a size test a chunk
#pragma unroll 4
    for (int idx = tid; idx < rows << shift; idx += nthreads) {
      const int t = idx >> shift, c = (idx & mask) * 16;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                   ::"r"(smem_u32(dst + t * row_bytes + c)), "l"(src + t * src_stride + c)
                   : "memory");
    }
    return;
  }
  for (int idx = tid; idx < rows << shift; idx += nthreads) {
    const int t = idx >> shift, c = (idx & mask) * cb;
    copy_chunk(dst + t * row_bytes + c, src + t * src_stride + c, cb);
  }
}

// the two bf16 in 32 bits as fp32: a bf16's bits are the high half of the
// fp32 value
__device__ __forceinline__ float bf16_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

// 4 consecutive elements as fp32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf16_lo(x.x), bf16_hi(x.x), bf16_lo(x.y), bf16_hi(x.y));
}

// N consecutive elements (N = 2, 4 or 8) as fp32, in one 4- to 16-byte
// shared load for bf16 and in float4/float2 loads for fp32

template <int N>
__device__ __forceinline__ void load_n(float (&dst)[N], const float* p) {
  if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    dst[0] = x.x; dst[1] = x.y;
  } else {
#pragma unroll
    for (int m = 0; m < N; m += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + m);
      dst[m] = x.x; dst[m + 1] = x.y; dst[m + 2] = x.z; dst[m + 3] = x.w;
    }
  }
}
template <int N>
__device__ __forceinline__ void load_n(float (&dst)[N], const __nv_bfloat16* p) {
  uint32_t x[N / 2];
  if constexpr (N == 2) {
    x[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (N == 4) {
    const uint2 y = *reinterpret_cast<const uint2*>(p);
    x[0] = y.x; x[1] = y.y;
  } else {
    static_assert(N == 8, "2, 4 or 8 elements");
    const uint4 y = *reinterpret_cast<const uint4*>(p);
    x[0] = y.x; x[1] = y.y; x[2] = y.z; x[3] = y.w;
  }
#pragma unroll
  for (int e = 0; e < N / 2; ++e) {
    dst[2 * e] = bf16_lo(x[e]);
    dst[2 * e + 1] = bf16_hi(x[e]);
  }
}

// C fp32 values to shared memory in one vector store (STS.128 or STS.64):
// written in PTX, as the compiler split the plain store into 4-byte stores
// that conflict on the banks
template <int C>
__device__ __forceinline__ void store_c(float* p, const float (&src)[C]) {
  if constexpr (C == 4)
    asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(smem_u32(p)), "f"(src[0]),
                 "f"(src[1]), "f"(src[2]), "f"(src[3]));
  else
    asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(smem_u32(p)), "f"(src[0]),
                 "f"(src[1]));
}

// One step's operands of a thread, in fp32: its R rows of r, k, w and C
// columns of v.
template <int R, int C>
struct StepIn {
  float r[R], k[R], w[R], v[C];
};

template <int R, int C, typename E>
__device__ __forceinline__ void load_step(StepIn<R, C>& in, const E* r, const E* k,
                                          const float* w, const E* v) {
  load_n<R>(in.r, r);
  load_n<R>(in.k, k);
  load_n<R>(in.w, w);
  load_n<C>(in.v, v);
}

// y's partial over the thread's rows (into yp), then the state update:
// 3 fp32 instructions per state element
template <int R, int C>
__device__ __forceinline__ void step(float (&st)[R][C], const StepIn<R, C>& in, float* yp) {
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = in.r[0] * st[0][c];
#pragma unroll
  for (int m = 1; m < R; ++m)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = fmaf(in.r[m], st[m][c], acc[c]);
#pragma unroll
  for (int m = 0; m < R; ++m)
#pragma unroll
    for (int c = 0; c < C; ++c) st[m][c] = fmaf(in.w[m], st[m][c], in.k[m] * in.v[c]);
  store_c<C>(yp, acc);
}

template <typename E, int HD, int R, int C>
__global__ void __launch_bounds__(block_threads(HD, R, C, 1), 1)
wkv6_fwd_kernel(const Params p) {
  constexpr int RG = HD / R;                 // row groups of the state
  static_assert(R % 4 == 0 && HD % R == 0 && HD % C == 0, "micro-tile");
  constexpr int AL = 4;                      // helper lanes a step of a_t, ...
  constexpr int AR = HD / AL;                // ... each summing AR rows
  static_assert(HELPERS % 32 == 0, "whole helper warps");
  extern __shared__ __align__(16) unsigned char smem[];

  const int tile = p.tile, S = p.S, stages = p.stages;
  const int CB = HD / p.nj;                  // state columns of this block
  const int NCG = CB / C;                    // column groups
  const int nc = RG * NCG;                   // compute threads
  const int ncp = (nc + 31) & ~31;           // ... in whole warps
  const int nbar = ncp + HELPERS;            // threads of FULL and EMPTY
  const int tid = threadIdx.x;
  const int jg = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int jb = jg * CB;                    // the block's first state column
  const int ntiles = (S + tile - 1) / tile;
  const int tel = tile * HD;                 // elements of one array's tile
  const int ybuf = tile * RG * CB;           // floats of one y-partial buffer

  const int sbytes = stage_bytes(HD, (int)sizeof(E), tile);
  unsigned char* ring = smem;
  float* ypart = reinterpret_cast<float*>(ring + stages * sbytes);
  float* abuf = ypart + 2 * ybuf;
  // tile n's rows of r, k, v (a = 0, 1, 2), as stored, and of w
  auto rkv = [&](int n, int a) {
    return reinterpret_cast<const E*>(ring + (n % stages) * sbytes) + a * tel;
  };
  auto wrows = [&](int n) {
    return reinterpret_cast<const float*>(ring + (n % stages) * sbytes +
                                          3 * tel * (int)sizeof(E));
  };
  const size_t soff = ((size_t)b * p.H + h) * HD * HD;

  if (tid < ncp) {
    // ---- compute warps: the state in registers, the step loop -------------
    const bool active = tid < nc;
    const int cg = tid % NCG, rg = min(tid / NCG, RG - 1);
    const int i0 = rg * R;                   // the thread's first state row
    const int j0 = jb + cg * C;              // the thread's first state column
    float st[R][C];
    if (active) {
#pragma unroll
      for (int m = 0; m < R; ++m)
#pragma unroll
        for (int c = 0; c < C; ++c) st[m][c] = p.s0[soff + (size_t)(i0 + m) * HD + j0 + c];
    }
    for (int n = 0; n < ntiles; ++n) {
      bar_sync(BAR_FULL + (n & 1), nbar);
      if (active) {
        const int rows = min(tile, S - n * tile);
        const E* rp = rkv(n, 0) + i0;
        const E* kp = rkv(n, 1) + i0;
        const E* vp = rkv(n, 2) + j0;
        const float* wp = wrows(n) + i0;
        float* yp = ypart + (n & 1) * ybuf + rg * CB + cg * C;
        const int yp_step = RG * CB;
        int t = 0;
        for (; t + UNROLL <= rows; t += UNROLL) {
          StepIn<R, C> in[UNROLL];
#pragma unroll
          for (int e = 0; e < UNROLL; ++e) {
            const int o = (t + e) * HD;
            load_step(in[e], rp + o, kp + o, wp + o, vp + o);
          }
#pragma unroll
          for (int e = 0; e < UNROLL; ++e) step<R, C>(st, in[e], yp + (t + e) * yp_step);
        }
        for (; t < rows; ++t) {
          StepIn<R, C> in;
          const int o = t * HD;
          load_step(in, rp + o, kp + o, wp + o, vp + o);
          step<R, C>(st, in, yp + t * yp_step);
        }
      }
      bar_arrive(BAR_EMPTY + (n & 1), nbar);
    }
    if (active) {
#pragma unroll
      for (int m = 0; m < R; ++m)
#pragma unroll
        for (int c = 0; c < C; ++c) p.sT[soff + (size_t)(i0 + m) * HD + j0 + c] = st[m][c];
    }
    return;
  }

  // ---- helper warps: the tile ring, a_t, y ---------------------------------
  const int hid = tid - ncp;
  const int part = hid % AL;  // the rows part * AR .. part * AR + AR of a_t's sum
  float ur[AR];
#pragma unroll
  for (int m = 0; m < AR; ++m) ur[m] = p.u[h * HD + part * AR + m];
  const unsigned char* src[4] = {
      static_cast<const unsigned char*>(p.r) + (b * p.sr[0] + h * p.sr[1]) * sizeof(E),
      static_cast<const unsigned char*>(p.k) + (b * p.sk[0] + h * p.sk[1]) * sizeof(E),
      static_cast<const unsigned char*>(p.v) + (b * p.sv[0] + h * p.sv[1]) * sizeof(E),
      reinterpret_cast<const unsigned char*>(p.w) + (b * p.sw[0] + h * p.sw[1]) * 4};
  const int64_t src_stride[4] = {p.sr[2] * (int64_t)sizeof(E), p.sk[2] * (int64_t)sizeof(E),
                                 p.sv[2] * (int64_t)sizeof(E), p.sw[2] * 4};
  float* yb = p.y + b * p.sy[0] + h * p.sy[1];

  // tile n of r, k, v, w into its stage of the ring (one cp.async group)
  auto issue = [&](int n) {
    unsigned char* stage = ring + (n % stages) * sbytes;
    const int t0 = n * tile, rows = min(tile, S - t0);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row_bytes = HD * (a < 3 ? (int)sizeof(E) : 4);
      copy_rows(stage + a * tel * (int)sizeof(E), src[a] + t0 * src_stride[a], src_stride[a],
                rows, row_bytes, p.copy_bytes, hid, HELPERS);
    }
  };
  for (int n = 0; n < stages - 2; ++n) {
    if (n < ntiles) issue(n);
    cp_async_commit();
  }

  // Iteration n prepares tile n while the compute warps run tile n-1, then
  // reduces tile n-1 while they run tile n.
  for (int n = 0; n <= ntiles; ++n) {
    if (n < ntiles) cp_async_wait(stages - 3);  // this thread's copies of tile n landed
    bar_sync(BAR_HELPERS, HELPERS);  // ... every helper's, and iteration n-1 is done
    if (n + stages - 2 < ntiles) issue(n + stages - 2);  // into tile n-2's stage
    cp_async_commit();

    if (n < ntiles) {  // tile n: a_t
      const int rows = min(tile, S - n * tile);
      const E* rs = rkv(n, 0);
      const E* ks = rkv(n, 1);
      float* ab = abuf + (n & 1) * tile;
      for (int base = 0; base < rows * AL; base += HELPERS) {  // the same trips in every lane
        const int idx = base + hid, t = idx / AL, e = t * HD + part * AR;
        float a = 0.f;
        if (idx < rows * AL) {
#pragma unroll
          for (int m = 0; m < AR; m += 4) {
            const float4 r4 = load4(rs + e + m), k4 = load4(ks + e + m);
            a += r4.x * ur[m] * k4.x + r4.y * ur[m + 1] * k4.y + r4.z * ur[m + 2] * k4.z +
                 r4.w * ur[m + 3] * k4.w;
          }
        }
        a += __shfl_xor_sync(0xffffffffu, a, 1);
        a += __shfl_xor_sync(0xffffffffu, a, 2);
        if (idx < rows * AL && part == 0) ab[t] = a;
      }
      bar_arrive(BAR_FULL + (n & 1), nbar);
    }
    if (n > 0) {  // tile n-1: y = the row groups' partials summed + a_t v_t
      bar_sync(BAR_EMPTY + ((n - 1) & 1), nbar);  // the compute warps are done with it
      const int m = n - 1, t0 = m * tile, rows = min(tile, S - t0);
      const float* yp = ypart + (m & 1) * ybuf;
      const float* ab = abuf + (m & 1) * tile;
      const E* vr = rkv(m, 2) + jb;
      const int c4_shift = __ffs(CB / 4) - 1;  // 4-column groups of a row: 2^c4_shift
#pragma unroll 4
      for (int idx = hid; idx < rows << c4_shift; idx += HELPERS) {
        const int t = idx >> c4_shift, c = 4 * (idx & ((1 << c4_shift) - 1));
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int g = 0; g < RG; ++g) {
          const float4 x = *reinterpret_cast<const float4*>(yp + (t * RG + g) * CB + c);
          s.x += x.x; s.y += x.y; s.z += x.z; s.w += x.w;
        }
        const float a = ab[t];
        const float4 v4 = load4(vr + t * HD + c);
        *reinterpret_cast<float4*>(yb + (t0 + t) * p.sy[2] + jb + c) =
            make_float4(fmaf(a, v4.x, s.x), fmaf(a, v4.y, s.y), fmaf(a, v4.z, s.z),
                        fmaf(a, v4.w, s.w));
      }
    }
  }
}

template <typename E, int HD, int R, int C>
cudaError_t launch(const Params& p, int B, int smem, cudaStream_t stream) {
  if ((HD / p.nj) % C != 0 || (HD / p.nj) % 4 != 0 || smem > MAX_SMEM ||
      smem != smem_bytes(HD, (int)sizeof(E), R, p.nj, p.tile, p.stages))
    return cudaErrorInvalidValue;
  auto kern = wkv6_fwd_kernel<E, HD, R, C>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(p.nj, p.H, B);
  kern<<<grid, block_threads(HD, R, C, p.nj), smem, stream>>>(p);
  return cudaGetLastError();
}

// the micro-tiles kernel.py's MICRO_TILES may pick
template <typename E, int HD>
cudaError_t dispatch_tile(int rows, int cols, const Params& p, int B, int smem,
                          cudaStream_t stream) {
  if (rows == 8 && cols == 4) return launch<E, HD, 8, 4>(p, B, smem, stream);
  if (rows == 4 && cols == 4) return launch<E, HD, 4, 4>(p, B, smem, stream);
  if (rows == 4 && cols == 2) return launch<E, HD, 4, 2>(p, B, smem, stream);
  return cudaErrorInvalidValue;
}

template <typename E>
cudaError_t dispatch_head_dim(int hd, int rows, int cols, const Params& p, int B, int smem,
                              cudaStream_t stream) {
  switch (hd) {
    case 16: return dispatch_tile<E, 16>(rows, cols, p, B, smem, stream);
    case 32: return dispatch_tile<E, 32>(rows, cols, p, B, smem, stream);
    case 64: return dispatch_tile<E, 64>(rows, cols, p, B, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype (of r, k, v): 0 = float32, 1 = bfloat16.  strides: 15 element
// strides, the (batch, head, seq) strides of r, k, v, w and y in that
// order.  u (H, hd), s0 and sT (B, H, hd, hd) are contiguous.  config: the
// launch configuration from kernel.py's launch_config, in this order:
// micro-tile rows R and columns C, column groups NJ, tile length, ring
// stages, cp.async chunk bytes (16, 8, 4 or 2), dynamic shared memory bytes.
// Launches on `device` and restores the caller's current device.  Returns
// the cudaError_t of the launch (0 on success); the launch is asynchronous.
int repro_wkv6_fwd(const void* r, const void* k, const void* v, const float* w,
                   const float* u, const float* s0, float* y, float* sT,
                   int dtype, int B, int H, int S, int hd,
                   const int64_t* strides, const int* config, int device, void* stream) {
  Params p;
  p.r = r; p.k = k; p.v = v; p.w = w; p.u = u; p.s0 = s0; p.y = y; p.sT = sT;
  p.H = H; p.S = S;
  p.nj = config[2]; p.tile = config[3]; p.stages = config[4]; p.copy_bytes = config[5];
  for (int d = 0; d < 3; ++d) {
    p.sr[d] = strides[d]; p.sk[d] = strides[3 + d]; p.sv[d] = strides[6 + d];
    p.sw[d] = strides[9 + d]; p.sy[d] = strides[12 + d];
  }
  if (p.stages < 3 || p.stages > 4 || p.tile < 1 || p.nj < 1 || hd % p.nj != 0)
    return (int)cudaErrorInvalidValue;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch_head_dim<float>(hd, config[0], config[1], p, B, config[6], s);
  else if (dtype == 1)
    err = dispatch_head_dim<__nv_bfloat16>(hd, config[0], config[1], p, B, config[6], s);
  else
    err = cudaErrorInvalidValue;
  const cudaError_t restore = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : restore);
}

const char* repro_wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
