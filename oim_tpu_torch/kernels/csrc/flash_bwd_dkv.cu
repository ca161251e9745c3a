// K2: flash-attention backward, dK and dV, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_bwd_dkv_kernel` (oim_tpu/ops/attention.py
// :226, driven by `_flash_backward` :344, pallas_call :380). For each key
// tile it walks the query tiles, recomputes the normalized probabilities
// from the saved logsumexp and accumulates
//   p  = exp(q k^T * scale - lse)   (zero where masked)
//   dV += p^T dO
//   dS = p * (dO v^T - delta) * scale,   dK += dS^T q
// all in f32, as the TPU kernel lifts every operand to f32. delta =
// rowsum(dO * O) - g_lse comes from the caller.
//
// GQA: one block owns a key tile of one KV head and walks every query
// head of that head's group, so dK/dV come out already group-summed in
// [B, Tk, Hkv, D]; the TPU version writes them per query head and sums
// after the kernel. Nothing races: each block writes only its own tile.
//
// What bounds it on the H100: four causal products, ~69 GFLOP per
// sequence at the training shapes against ~51 MB of operands, so
// compute-bound. This
// first version runs them as f32 FMAs on the CUDA cores (67 TFLOP/s peak,
// not the 989 TFLOP/s of bf16 tensor cores) with the K and V tiles held in
// shared memory for the whole walk and dK/dV accumulating in registers;
// query tiles wholly below the causal diagonal of the key tile are
// skipped. wgmma, TMA and a split over query tiles (more blocks per head
// for short sequences) are later work. Times against the bound: PERF.md.
#include "flash_common.cuh"

namespace oimflash {

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int tq, int tk, int h, int hkv, int d, float scale, int causal) {
  extern __shared__ float smem[];
  float* ks = smem;                       // [64][kStride]
  float* vs = ks + kBlockK * kStride;
  float* qs = vs + kBlockK * kStride;
  float* dos = qs + kBlockQ * kStride;
  float* ps = dos + kBlockQ * kStride;    // [64 q][64 k]
  float* dss = ps + kBlockQ * kBlockK;    // [64 q][64 k]
  float* lse_s = dss + kBlockQ * kBlockK; // [64]
  float* delta_s = lse_s + kBlockQ;       // [64]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bhk = blockIdx.y, b = bhk / hkv, hk = bhk % hkv;
  const int group = h / hkv;
  const int k_lo = blockIdx.x * kBlockK;
  const int q_offset = tk - tq;

  load_tile(ks, k, b, k_lo, tk, hkv, hk, d);
  load_tile(vs, v, b, k_lo, tk, hkv, hk, d);

  // Thread (ty, tx) accumulates key rows ty*4+i, head-dim columns tx+16*j.
  float dk_acc[4][kCols], dv_acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int nq = (tq + kBlockQ - 1) / kBlockQ;
  for (int g = 0; g < group; ++g) {
    const int hq = hk * group + g;
    const int64_t row_base = ((int64_t)b * h + hq) * tq;
    for (int qb = 0; qb < nq; ++qb) {
      const int q_lo = qb * kBlockQ;
      const int q_start = q_lo + q_offset;
      if (causal && k_lo > q_start + kBlockQ - 1) continue;  // wholly masked
      __syncthreads();
      load_tile(qs, q, b, q_lo, tq, h, hq, d);
      load_tile(dos, dout, b, q_lo, tq, h, hq, d);
      if (threadIdx.x < kBlockQ) {
        const int row = q_lo + threadIdx.x;
        lse_s[threadIdx.x] = row < tq ? lse[row_base + row] : 0.f;
        delta_s[threadIdx.x] = row < tq ? delta[row_base + row] : 0.f;
      }
      __syncthreads();

      // Score tile: thread owns query rows ty*4+i and key columns tx+16*j.
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
          ps[r * kBlockK + tx + 16 * j] = p;
          dss[r * kBlockK + tx + 16 * j] = p * (dp[i][j] - delta_s[r]) * scale;
        }
      }
      __syncthreads();

      for (int qq = 0; qq < kBlockQ; ++qq) {
        float dov[kCols], qv[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int c = tx + 16 * j;
          dov[j] = c < d ? dos[qq * kStride + c] : 0.f;
          qv[j] = c < d ? qs[qq * kStride + c] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = ps[qq * kBlockK + ty * 4 + i];
          const float ds = dss[qq * kBlockK + ty * 4 + i];
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            dv_acc[i][j] = fmaf(p, dov[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(ds, qv[j], dk_acc[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k_lo + ty * 4 + i;
    if (row >= tk) continue;
    const int64_t off = (((int64_t)b * tk + row) * hkv + hk) * d;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = tx + 16 * j;
      if (c < d) {
        dk[off + c] = from_f<T>(dk_acc[i][j]);
        dv[off + c] = from_f<T>(dv_acc[i][j]);
      }
    }
  }
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv, int b, int tq,
               int tk, int h, int hkv, int d, float scale, int causal, cudaStream_t stream) {
  const size_t smem = (size_t)(4 * kBlockQ * kStride + 2 * kBlockQ * kBlockK + 2 * kBlockQ) *
                      sizeof(float);
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((tk + kBlockK - 1) / kBlockK, b * hkv);
  flash_bwd_dkv_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dk, (T*)dv, tq,
      tk, h, hkv, d, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace oimflash

extern "C" int oim_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse, const float* delta,
                                 void* dk, void* dv, int b, int tq, int tk, int h, int hkv,
                                 int d, float scale, int causal, int dtype, void* stream) {
  using namespace oimflash;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kF32:
      return launch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, b, tq, tk, h, hkv, d, scale,
                               causal, s);
    case kBF16:
      return launch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, b, tq, tk, h, hkv,
                                       d, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
