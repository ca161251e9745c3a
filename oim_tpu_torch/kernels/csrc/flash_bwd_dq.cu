// K3: flash-attention backward, dQ, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_bwd_dq_kernel` (oim_tpu/ops/attention.py
// :289, driven by `_flash_backward` at :410, pallas_call :418). For each
// query tile it walks the key tiles and accumulates
//   p  = exp(q k^T * scale - lse)   (zero where masked)
//   dS = p * (dO v^T - delta) * scale,   dQ += dS k
// with the same recomputation as the dK/dV kernel (K2). K2 and K3 stay two
// kernels: both write only their own tiles, so the results are
// deterministic and dQ needs no atomics.
//
// What bounds it on the H100: three causal products, ~52 GFLOP per
// sequence at the training shapes against ~59 MB of operands, so
// compute-bound: the bf16 tensor cores (989 TFLOP/s) are the roof.
//
// Two routes, chosen by the wrapper (kernels.bwd_route):
//
// * wgmma (bf16, head_dim 64 or 128): flash_bwd_dq_wgmma_kernel. One
//   warpgroup owns 64 queries of one query head; Q and dO stay in shared
//   memory as swizzled bf16 (flash_sm90.cuh) and the K and V tiles stream
//   through a two-stage cp.async ring. Per key tile: S = Q K^T and
//   dP = dO V^T on the tensor cores, dS formed in the accumulators and
//   passed as the register A operand of dQ += dS K (K read as MN-major B
//   from the tile that just served as S's K-major B). exp is exp2 with
//   log2(e) folded into the scale; the mask (a select, never a multiply:
//   see K2) is computed only on tiles that cross the diagonal or a ragged
//   edge, and key tiles wholly above the diagonal are never loaded.
//   Block (x, y) = (batch*head, query tile nq-1-y): the last query tiles,
//   which see the most keys under a causal mask, start first. 128 threads,
//   97 KB of shared memory: two blocks per SM.
// * fma (f32, and bf16 at any other head_dim): flash_bwd_dq_kernel, the
//   first version: f32 FMAs on the CUDA cores.
//
// Precision: as K2. S and dP are bf16 x bf16 products summed in f32; dS is
// rounded to the input dtype before dQ += dS K (the identity at f32).
#include "flash_common.cuh"
#include "flash_sm90.cuh"

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
        dss[r * kBlockK + tx + 16 * j] = round_to<T>(p * (dp[i][j] - delta_s[r]) * scale);
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

constexpr size_t kDqSmem =
    (size_t)(4 * kBlockQ * kStride + kBlockQ * kBlockK + 2 * kBlockQ) * sizeof(float);

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, int b, int tq, int tk, int h, int hkv, int d,
              float scale, int causal, cudaStream_t stream) {
  const size_t smem = kDqSmem;
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((tq + kBlockQ - 1) / kBlockQ, b * h);
  flash_bwd_dq_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dq, tq, tk, h,
      hkv, d, scale, causal);
  return (int)cudaGetLastError();
}


// One warpgroup: queries q_lo .. q_lo+63 of query head hq of batch b.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 2)
flash_bwd_dq_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int tq, int tk, int h, int hkv,
                          float scale, int causal) {
  constexpr int kTile = 64 * D * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align_1k(smem_raw);
  uint8_t* dos = qs + kTile;
  uint8_t* ks = dos + kTile;       // [2 stages]
  uint8_t* vs = ks + 2 * kTile;    // [2 stages]

  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, c = tid & 3;
  const int bh = blockIdx.x, b = bh / h, hq = bh % h, hk = hq / (h / hkv);
  const int nq = (tq + 63) / 64;
  const int q_lo = (nq - 1 - (int)blockIdx.y) * 64;
  const int q_start = q_lo + (tk - tq);
  const int nk = key_tiles(q_lo, tq, tk, causal);

  // This thread's two query rows: 16*warp + g + 8i.
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q_lo + 16 * warp + g + 8 * i;
    lse2[i] = row < tq ? lse[(int64_t)bh * tq + row] * kLog2e : 0.f;
    dlt[i] = row < tq ? delta[(int64_t)bh * tq + row] : 0.f;
  }

  if (nk > 0) {
    load_tile_async<D>(qs, q, b, q_lo, tq, h, hq);
    load_tile_async<D>(dos, dout, b, q_lo, tq, h, hq);
    load_tile_async<D>(ks, k, b, 0, tk, hkv, hk);
    load_tile_async<D>(vs, v, b, 0, tk, hkv, hk);
  }
  cp_async_commit();

  float dq_acc[D / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  const float scale_log2 = scale * kLog2e;
  const uint32_t q_tile = smem_addr(qs), do_tile = smem_addr(dos);

  for (int kb = 0; kb < nk; ++kb) {
    const int stage = kb & 1;
    if (kb + 1 < nk) {
      load_tile_async<D>(ks + (stage ^ 1) * kTile, k, b, (kb + 1) * 64, tk, hkv, hk);
      load_tile_async<D>(vs + (stage ^ 1) * kTile, v, b, (kb + 1) * 64, tk, hkv, hk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();

    const int k_lo = kb * 64;
    const uint32_t k_tile = smem_addr(ks + stage * kTile);
    const uint32_t v_tile = smem_addr(vs + stage * kTile);

    // S = Q K^T and dP = dO V^T, [64 queries x 64 keys], as two groups.
    wgmma_fence();
    wgmma_ss_64x64<D>(s, q_tile, k_tile);
    wgmma_commit();
    wgmma_ss_64x64<D>(dp, do_tile, v_tile);
    wgmma_commit();

    const bool edge = (causal && k_lo + 63 > q_start) || q_lo + 64 > tq || k_lo + 64 > tk;
    wgmma_wait<1>();
    reg_fence(s);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int at = 4 * j + 2 * i + e;
          float p = exp2f(s[at] * scale_log2 - lse2[i]);
          if (edge) {
            const int qr = 16 * warp + g + 8 * i, kc = 8 * j + 2 * c + e;
            const bool ok = q_lo + qr < tq && k_lo + kc < tk &&
                            (!causal || q_start + qr >= k_lo + kc);
            p = ok ? p : 0.f;
          }
          s[at] = p;
        }

    wgmma_wait<0>();
    reg_fence(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int at = 4 * j + 2 * i + e;
          dp[at] = s[at] * (dp[at] - dlt[i]) * scale;  // dS
        }
    uint32_t dsa[16];
    pack_a(dp, dsa);  // dS rounded to bf16

    // dQ += dS K: A from registers, B the key tile read MN-major.
    wgmma_fence();
    wgmma_rs_64xD<D>(dq_acc, dsa, k_tile);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dq_acc);
    __syncthreads();  // every thread is done with this stage before it refills
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q_lo + 16 * warp + g + 8 * i;
    if (row >= tq) continue;
    __nv_bfloat16* o = dq + (((int64_t)b * tq + row) * h + hq) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j + 2 * c) =
          __floats2bfloat162_rn(dq_acc[4 * j + 2 * i], dq_acc[4 * j + 2 * i + 1]);
  }
}

// 1 KB of alignment slack, Q and dO, two stages of K and V.
template <int D>
constexpr size_t dq_wgmma_smem() {
  return 1024 + 6 * 64 * D * 2;
}

template <int D>
int launch_dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dq, int b, int tq, int tk, int h,
                    int hkv, float scale, int causal, cudaStream_t stream) {
  const size_t smem = dq_wgmma_smem<D>();
  cudaError_t err = allow_smem(flash_bwd_dq_wgmma_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(b * h, (tq + 63) / 64);
  flash_bwd_dq_wgmma_kernel<D><<<grid, kWgThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)dout, lse, delta, (__nv_bfloat16*)dq, tq, tk, h, hkv, scale, causal);
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

// The tensor-core route: bf16 only, head_dim 64 or 128.
extern "C" int oim_flash_bwd_dq_wgmma(const void* q, const void* k, const void* v,
                                      const void* dout, const float* lse, const float* delta,
                                      void* dq, int b, int tq, int tk, int h, int hkv, int d,
                                      float scale, int causal, void* stream) {
  using namespace oimflash;
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 64:
      return launch_dq_wgmma<64>(q, k, v, dout, lse, delta, dq, b, tq, tk, h, hkv, scale, causal,
                                 s);
    case 128:
      return launch_dq_wgmma<128>(q, k, v, dout, lse, delta, dq, b, tq, tk, h, hkv, scale,
                                  causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Resources of one route's kernel (kernel_info in flash_common.cuh): wgmma
// at head_dim d (64 or 128) when wgmma != 0, else the bf16 fma kernel.
extern "C" int oim_flash_bwd_dq_info(int wgmma, int d, int* out) {
  using namespace oimflash;
  if (!wgmma) return kernel_info(flash_bwd_dq_kernel<__nv_bfloat16>, kThreads, kDqSmem, out);
  switch (d) {
    case 64:
      return kernel_info(flash_bwd_dq_wgmma_kernel<64>, kWgThreads, dq_wgmma_smem<64>(), out);
    case 128:
      return kernel_info(flash_bwd_dq_wgmma_kernel<128>, kWgThreads, dq_wgmma_smem<128>(), out);
    default: return (int)cudaErrorInvalidValue;
  }
}
