// K3: flash-attention backward, dQ, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_bwd_dq_kernel` (oim_tpu/ops/attention.py
// :289, driven by `_flash_backward` at :410, pallas_call :418). For each
// query tile it walks the key tiles and accumulates, in f32,
//   p  = exp(q k^T * scale - lse)   (zero where masked)
//   dS = p * (dO v^T - delta) * scale,   dQ += dS k
// with the same recomputation as the dK/dV kernel.
//
// What bounds it on the H100: three causal products, ~52 GFLOP per
// sequence at the training shapes against ~59 MB of operands, so
// compute-bound. This first
// version runs them as f32 FMAs on the CUDA cores (67 TFLOP/s peak, not
// the 989 TFLOP/s of bf16 tensor cores): one block per (64-query tile,
// batch*head), the Q and dO tiles held in shared memory for the whole walk,
// dQ accumulating in registers, key tiles above the causal diagonal never
// loaded. wgmma and TMA are later work. Times against the bound: PERF.md.
#include "flash_common.cuh"

namespace oimflash {

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int tq, int tk, int h,
                    int hkv, int d, float scale, int causal) {
  extern __shared__ float smem[];
  float* qs = smem;                       // [64][kStride]
  float* dos = qs + kBlockQ * kStride;
  float* ks = dos + kBlockQ * kStride;
  float* vs = ks + kBlockK * kStride;
  float* dss = vs + kBlockK * kStride;    // [64 q][64 k]
  float* lse_s = dss + kBlockQ * kBlockK; // [64]
  float* delta_s = lse_s + kBlockQ;       // [64]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y, b = bh / h, hq = bh % h, hk = hq / (h / hkv);
  const int q_lo = blockIdx.x * kBlockQ;
  const int q_start = q_lo + (tk - tq);

  load_tile(qs, q, b, q_lo, tq, h, hq, d);
  load_tile(dos, dout, b, q_lo, tq, h, hq, d);
  if (threadIdx.x < kBlockQ) {
    const int row = q_lo + threadIdx.x;
    lse_s[threadIdx.x] = row < tq ? lse[(int64_t)bh * tq + row] : 0.f;
    delta_s[threadIdx.x] = row < tq ? delta[(int64_t)bh * tq + row] : 0.f;
  }

  float dq_acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) dq_acc[i][j] = 0.f;

  const int nk = key_tiles(q_lo, tq, tk, causal);
  for (int kb = 0; kb < nk; ++kb) {
    const int k_lo = kb * kBlockK;
    __syncthreads();
    load_tile(ks, k, b, k_lo, tk, hkv, hk, d);
    load_tile(vs, v, b, k_lo, tk, hkv, hk, d);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < d; ++c) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qs[(ty * 4 + i) * kStride + c];
        dov[i] = dos[(ty * 4 + i) * kStride + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = ks[(tx + 16 * j) * kStride + c];
        vv[j] = vs[(tx + 16 * j) * kStride + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int qpos = q_start + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k_lo + tx + 16 * j;
        const bool ok = q_lo + r < tq && kpos < tk && (!causal || qpos >= kpos);
        const float p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        dss[r * kBlockK + tx + 16 * j] = p * (dp[i][j] - delta_s[r]) * scale;
      }
    }
    __syncthreads();

    for (int kk = 0; kk < kBlockK; ++kk) {
      float kv[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + 16 * j;
        kv[j] = c < d ? ks[kk * kStride + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = dss[(ty * 4 + i) * kBlockK + kk];
#pragma unroll
        for (int j = 0; j < kCols; ++j) dq_acc[i][j] = fmaf(ds, kv[j], dq_acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q_lo + ty * 4 + i;
    if (row >= tq) continue;
    T* o = dq + (((int64_t)b * tq + row) * h + hq) * d;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = tx + 16 * j;
      if (c < d) o[c] = from_f<T>(dq_acc[i][j]);
    }
  }
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, int b, int tq, int tk, int h, int hkv, int d,
              float scale, int causal, cudaStream_t stream) {
  const size_t smem =
      (size_t)(4 * kBlockQ * kStride + kBlockQ * kBlockK + 2 * kBlockQ) * sizeof(float);
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((tq + kBlockQ - 1) / kBlockQ, b * h);
  flash_bwd_dq_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dq, tq, tk, h,
      hkv, d, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace oimflash

extern "C" int oim_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* delta, void* dq, int b, int tq,
                                int tk, int h, int hkv, int d, float scale, int causal,
                                int dtype, void* stream) {
  using namespace oimflash;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kF32:
      return launch_dq<float>(q, k, v, dout, lse, delta, dq, b, tq, tk, h, hkv, d, scale, causal,
                              s);
    case kBF16:
      return launch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, b, tq, tk, h, hkv, d, scale,
                                      causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
