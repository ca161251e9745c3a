// K1: flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel` (oim_tpu/ops/attention.py:100,
// driven by `_flash_forward` :171, pallas_call :198). It computes causal
// (bottom-right aligned) or full GQA attention with an online softmax and
// emits out plus the per-row logsumexp the backward consumes:
//   s = q k^T * scale (f32), masked to -1e30; m, l running max / sum;
//   p = exp(s - m) re-zeroed where masked; acc = acc * corr + p_T v, where
//   p is rounded to V's dtype before the product (as the TPU kernel casts
//   p to v.dtype); out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)).
//
// What bounds it on the H100: at the training shapes (T = 2048, D = 128,
// 32 q / 8 kv heads) the two causal products are ~34 GFLOP per sequence
// against ~42 MB of q/k/v/out/lse, so the work is compute-bound (far above
// the card's ~295 flop/byte ridge).
// This first version runs the products as f32 FMAs on the CUDA cores
// (67 TFLOP/s peak), not on the tensor cores (989 TFLOP/s bf16), so it is
// bound by that f32 rate and its own shared-memory traffic. Its design:
// one block per (64-query tile, batch*head); the sequential k-block grid
// dimension of the TPU kernel becomes a loop inside the block, carrying
// the accumulator in registers and m, l per row; each K/V tile is staged
// once in shared memory and read by all 64 query rows; key tiles above
// the causal diagonal are never loaded. Its operands are bf16 (p is
// rounded to V's dtype), so a wgmma/TMA version computes the same thing;
// that is later work. Times against the bound: PERF.md.
#include "flash_common.cuh"

namespace oimflash {

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int tq, int tk, int h,
                 int hkv, int d, float scale, int causal) {
  extern __shared__ float smem[];
  float* qs = smem;                       // [64][kStride]
  float* ks = qs + kBlockQ * kStride;     // [64][kStride]
  float* vs = ks + kBlockK * kStride;     // [64][kStride]
  float* ps = vs + kBlockK * kStride;     // [64][64] probabilities

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y, b = bh / h, hq = bh % h, hk = hq / (h / hkv);
  const int q_lo = blockIdx.x * kBlockQ;
  const int q_start = q_lo + (tk - tq);  // position of the tile's first row

  load_tile(qs, q, b, q_lo, tq, h, hq, d);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  const int nk = key_tiles(q_lo, tq, tk, causal);
  for (int kb = 0; kb < nk; ++kb) {
    const int k_lo = kb * kBlockK;
    __syncthreads();  // the previous tile's readers are done
    load_tile(ks, k, b, k_lo, tk, hkv, hk, d);
    load_tile(vs, v, b, k_lo, tk, hkv, hk, d);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * kStride + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * kStride + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_start + ty * 4 + i;
      bool ok[4];
      float bmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k_lo + tx + 16 * j;
        ok[j] = kpos < tk && (!causal || qpos >= kpos);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        bmax = fmaxf(bmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(bmax));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        ps[(ty * 4 + i) * kBlockK + tx + 16 * j] = round_to<T>(p);
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    for (int kk = 0; kk < kBlockK; ++kk) {
      float vv[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + 16 * j;
        vv[j] = c < d ? vs[kk * kStride + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty * 4 + i) * kBlockK + kk];
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q_lo + ty * 4 + i;
    if (row >= tq) continue;
    const float ll = fmaxf(l[i], 1e-30f);
    T* o = out + (((int64_t)b * tq + row) * h + hq) * d;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = tx + 16 * j;
      if (c < d) o[c] = from_f<T>(acc[i][j] / ll);
    }
    if (tx == 0) lse[(int64_t)bh * tq + row] = m[i] + logf(ll);
  }
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* out, float* lse, int b,
               int tq, int tk, int h, int hkv, int d, float scale, int causal,
               cudaStream_t stream) {
  const size_t smem = (size_t)(3 * kBlockQ * kStride + kBlockQ * kBlockK) * sizeof(float);
  cudaError_t err = allow_smem(flash_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((tq + kBlockQ - 1) / kBlockQ, b * h);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, tq, tk, h, hkv, d, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace oimflash

// Plain C entry point (loaded with ctypes). Returns a cudaError_t code.
extern "C" int oim_flash_fwd(const void* q, const void* k, const void* v, void* out,
                             float* lse, int b, int tq, int tk, int h, int hkv, int d,
                             float scale, int causal, int dtype, void* stream) {
  using namespace oimflash;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kF32: return launch_fwd<float>(q, k, v, out, lse, b, tq, tk, h, hkv, d, scale, causal, s);
    case kBF16:
      return launch_fwd<__nv_bfloat16>(q, k, v, out, lse, b, tq, tk, h, hkv, d, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
