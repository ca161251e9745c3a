// Shared pieces of the three flash-attention kernels (flash_fwd.cu,
// flash_bwd_dkv.cu, flash_bwd_dq.cu): tile sizes, dtype conversions, the
// tile loader and the 16-lane row reductions.
//
// Layout. q/k/v/out/dO and the gradients stay in the caller's BTHD layout
// ([batch, seq, heads, head_dim], contiguous); the kernels index rows with
// strides instead of transposing to [B*H, T, D] as the TPU version does.
// lse and delta are [B*H, Tq] float32. GQA: query head h reads kv head
// h / (H / Hkv), by index arithmetic; K/V are never expanded.
//
// Threads. A block has 256 threads, seen as a 16 x 16 grid (ty = tid / 16,
// tx = tid % 16). For a 64 x 64 score tile, thread (ty, tx) owns rows
// ty*4 .. ty*4+3 and columns tx + 16*j (j < 4); for a 64 x D accumulator
// it owns the same rows and columns tx + 16*j (j < D/16). The 16 threads of
// a row group are one half-warp, so row max and row sum are 4 xor-shuffles.
//
// Shared tiles hold f32 with a row stride of 129 floats: column c of 16
// consecutive rows falls in 16 different banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace oimflash {

constexpr int kBlockQ = 64;    // query rows per tile
constexpr int kBlockK = 64;    // key rows per tile
constexpr int kMaxD = 128;     // largest head_dim the kernels take
constexpr int kStride = kMaxD + 1;
constexpr int kThreads = 256;
constexpr int kCols = kMaxD / 16;  // accumulator columns per thread
constexpr float kNegInf = -1e30f;  // the JAX kernels' NEG_INF

// dtype codes shared with the Python wrappers
enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Round an f32 value through T (the precision a T-typed operand has).
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Rows [row0, row0 + 64) of head `head` of batch `b` of a BTHD tensor with
// `t` rows and `heads` heads -> tile[r * kStride + c] as f32; rows past the
// end read as zero (the ragged edge).
template <typename T>
__device__ __forceinline__ void load_tile(float* tile, const T* __restrict__ x, int b,
                                          int row0, int t, int heads, int head, int d) {
  for (int e = threadIdx.x; e < kBlockQ * d; e += kThreads) {
    const int r = e / d;
    const int c = e - r * d;
    const int row = row0 + r;
    float val = 0.f;
    if (row < t) val = to_f(x[(((int64_t)b * t + row) * heads + head) * d + c]);
    tile[r * kStride + c] = val;
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off, 16));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off, 16);
  return x;
}

// Number of key tiles a query tile starting at q_lo needs. Causal masks
// are bottom-right aligned (query row i sits at position i + tk - tq);
// key tiles wholly above the diagonal of the query tile are skipped, as
// the TPU kernels predicate them out.
__device__ __forceinline__ int key_tiles(int q_lo, int tq, int tk, int causal) {
  int nk = (tk + kBlockK - 1) / kBlockK;
  if (causal) {
    const int last = q_lo + (tk - tq) + kBlockQ - 1;
    nk = last < 0 ? 0 : min(nk, last / kBlockK + 1);
  }
  return nk;
}

// Opt `kernel` into `smem` bytes of dynamic shared memory (above 48 KB a
// kernel must ask); returns the CUDA status.
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// What the card gives `kernel` launched with `threads` threads and `smem`
// bytes of dynamic shared memory: out = {registers per thread, local
// memory bytes per thread (spills and stack), dynamic shared bytes per
// block, resident blocks per SM}. Returns the CUDA status.
template <typename Kernel>
__host__ int kernel_info(Kernel kernel, int threads, size_t smem, int* out) {
  cudaFuncAttributes attr;
  int blocks = 0;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  return 0;
}

}  // namespace oimflash
