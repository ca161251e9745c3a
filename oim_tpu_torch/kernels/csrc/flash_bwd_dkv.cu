// K2: flash-attention backward, dK and dV, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_bwd_dkv_kernel` (oim_tpu/ops/attention.py
// :226, driven by `_flash_backward` :344, pallas_call :380). For each key
// tile it walks the query tiles, recomputes the normalized probabilities
// from the saved logsumexp and accumulates
//   p  = exp(q k^T * scale - lse)   (zero where masked)
//   dV += p^T dO
//   dS = p * (dO v^T - delta) * scale,   dK += dS^T q
// delta = rowsum(dO * O) - g_lse comes from the caller.
//
// GQA: one block owns a key tile of one KV head and walks every query
// head of that head's group, so dK/dV come out already group-summed in
// [B, Tk, Hkv, D]; the TPU version writes them per query head and sums
// after the kernel. Nothing races: each block writes only its own tile.
//
// What bounds it on the H100: four causal products, ~69 GFLOP per
// sequence at the training shapes against ~51 MB of operands, so
// compute-bound: the bf16 tensor cores (989 TFLOP/s) are the roof.
//
// Two routes, chosen by the wrapper (kernels.bwd_route):
//
// * wgmma (bf16, head_dim 64 or 128): flash_bwd_dkv_wgmma_kernel. One
//   warpgroup owns 64 keys of one KV head; K and V stay in shared memory as
//   swizzled bf16 (flash_sm90.cuh), and the 64-row Q and dO tiles of every
//   (query head, query tile) the keys see stream through a two-stage
//   cp.async ring, the next tile landing while this one computes. Per tile
//   it computes S^T = K Q^T and dP^T = V dO^T on the tensor cores (keys in
//   rows), so P^T and dS^T leave the accumulators already in the register
//   A layout of dV += P^T dO and dK += dS^T Q (dO and Q read as MN-major B
//   from the same shared tiles), as FlashAttention-3 does: nothing goes
//   back through shared memory. exp is exp2 with log2(e) folded into the
//   scale. Only tiles that cross the causal diagonal or a ragged edge
//   compute the mask (a select: a row that sees no key has lse = -1e30 and
//   exp(s - lse) = inf there, which a multiply by 0 would turn into NaN).
//   Block (x, y) = (batch*kv head, key tile y): blocks start in linear
//   order, so key tile 0 of every head, the heaviest under a causal mask,
//   starts first. 128 threads, 98 KB of shared memory at head_dim 128: two
//   blocks per SM.
// * fma (f32, and bf16 at any other head_dim): flash_bwd_dkv_kernel, the
//   first version: f32 FMAs on the CUDA cores, f32 tiles in shared memory.
//
// Precision: S and dP are bf16 x bf16 products summed in f32 (the TPU
// kernel lifts dO and V to f32, which is exact, so the products agree up
// to summation order). P and dS are rounded to the input dtype before the
// products that take them (dV, dK), the point at which K1 and the TPU
// forward round p to V's dtype; at f32 that rounding is the identity.
#include "flash_common.cuh"
#include "flash_sm90.cuh"

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
          // P and dS enter the products at T's precision (a no-op at f32)
          ps[r * kBlockK + tx + 16 * j] = round_to<T>(p);
          dss[r * kBlockK + tx + 16 * j] = round_to<T>(p * (dp[i][j] - delta_s[r]) * scale);
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

constexpr size_t kDkvSmem =
    (size_t)(4 * kBlockQ * kStride + 2 * kBlockQ * kBlockK + 2 * kBlockQ) * sizeof(float);

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv, int b, int tq,
               int tk, int h, int hkv, int d, float scale, int causal, cudaStream_t stream) {
  const size_t smem = kDkvSmem;
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((tk + kBlockK - 1) / kBlockK, b * hkv);
  flash_bwd_dkv_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dk, (T*)dv, tq,
      tk, h, hkv, d, scale, causal);
  return (int)cudaGetLastError();
}


// One warpgroup: keys k_lo .. k_lo+63 of kv head hk of batch b.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 2)
flash_bwd_dkv_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                           int tq, int tk, int h, int hkv, float scale, int causal) {
  constexpr int kTile = 64 * D * 2;  // bytes of a 64-row bf16 tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = align_1k(smem_raw);
  uint8_t* vs = ks + kTile;
  uint8_t* qs = vs + kTile;          // [2 stages]
  uint8_t* dos = qs + 2 * kTile;     // [2 stages]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * kTile);  // [2][64]
  float* delta_s = lse_s + 2 * 64;                            // [2][64]

  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, c = tid & 3;
  const int b = blockIdx.x / hkv, hk = blockIdx.x % hkv, group = h / hkv;
  const int k_lo = blockIdx.y * 64;
  const int q_offset = tk - tq;
  const int nq = (tq + 63) / 64;
  // First query tile that reaches k_lo (its last row's position >= k_lo).
  int qb0 = 0;
  if (causal) {
    const int need = k_lo - q_offset - 63;
    qb0 = need <= 0 ? 0 : (need + 63) / 64;
  }
  const int per_head = nq > qb0 ? nq - qb0 : 0;
  const int n_items = group * per_head;

  // Work item i: query head hk*group + i / per_head, query tile qb0 + i % per_head.
  auto issue = [&](int item, int stage) {
    const int hq = hk * group + item / per_head;
    const int q_lo = (qb0 + item % per_head) * 64;
    load_tile_async<D>(qs + stage * kTile, q, b, q_lo, tq, h, hq);
    load_tile_async<D>(dos + stage * kTile, dout, b, q_lo, tq, h, hq);
    if (tid < 64) {
      const int row = q_lo + tid;
      const bool ok = row < tq;
      const int64_t at = ((int64_t)b * h + hq) * tq + row;
      cp_async_4(smem_addr(lse_s + stage * 64 + tid), ok ? lse + at : lse, ok);
      cp_async_4(smem_addr(delta_s + stage * 64 + tid), ok ? delta + at : delta, ok);
    }
  };

  load_tile_async<D>(ks, k, b, k_lo, tk, hkv, hk);
  load_tile_async<D>(vs, v, b, k_lo, tk, hkv, hk);
  if (n_items > 0) issue(0, 0);
  cp_async_commit();

  float dk_acc[D / 2], dv_acc[D / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  const float scale_log2 = scale * kLog2e;
  const uint32_t k_tile = smem_addr(ks), v_tile = smem_addr(vs);

  for (int it = 0; it < n_items; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_items) {
      issue(it + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();

    const int q_lo = (qb0 + it % per_head) * 64;
    const int q_start = q_lo + q_offset;  // position of query row q_lo
    const uint32_t q_tile = smem_addr(qs + stage * kTile);
    const uint32_t do_tile = smem_addr(dos + stage * kTile);
    const float* lse_t = lse_s + stage * 64;
    const float* delta_t = delta_s + stage * 64;

    // S^T = K Q^T and dP^T = V dO^T, [64 keys x 64 queries], as two groups.
    wgmma_fence();
    wgmma_ss_64x64<D>(s, k_tile, q_tile);
    wgmma_commit();
    wgmma_ss_64x64<D>(dp, v_tile, do_tile);
    wgmma_commit();

    // Mask only where the tile crosses the diagonal or a ragged edge.
    const bool edge = (causal && k_lo + 63 > q_start) || q_lo + 64 > tq || k_lo + 64 > tk;
    wgmma_wait<1>();
    reg_fence(s);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = 8 * j + 2 * c + e;  // query column
        const float lse2 = lse_t[qc] * kLog2e;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int kr = 16 * warp + g + 8 * i;  // key row
          float p = exp2f(s[4 * j + 2 * i + e] * scale_log2 - lse2);
          if (edge) {
            const bool ok = q_lo + qc < tq && k_lo + kr < tk &&
                            (!causal || q_start + qc >= k_lo + kr);
            p = ok ? p : 0.f;
          }
          s[4 * j + 2 * i + e] = p;
        }
      }
    uint32_t pa[16], dsa[16];
    pack_a(s, pa);  // P^T rounded to bf16

    wgmma_wait<0>();
    reg_fence(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dlt = delta_t[8 * j + 2 * c + e];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int at = 4 * j + 2 * i + e;
          dp[at] = s[at] * (dp[at] - dlt) * scale;  // dS^T, from P before rounding
        }
      }
    pack_a(dp, dsa);  // dS^T rounded to bf16

    // dV += P^T dO, dK += dS^T Q: A from registers, B the MN-major tiles.
    wgmma_fence();
    wgmma_rs_64xD<D>(dv_acc, pa, do_tile);
    wgmma_rs_64xD<D>(dk_acc, dsa, q_tile);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dv_acc);
    reg_fence(dk_acc);
    __syncthreads();  // every thread is done with this stage before it refills
  }

  // Thread holds key rows 16*warp + g + 8i, columns 8j + 2c, 8j + 2c + 1.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k_lo + 16 * warp + g + 8 * i;
    if (row >= tk) continue;
    const int64_t off = (((int64_t)b * tk + row) * hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * c;
      *reinterpret_cast<__nv_bfloat162*>(dk + off + col) =
          __floats2bfloat162_rn(dk_acc[4 * j + 2 * i], dk_acc[4 * j + 2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + col) =
          __floats2bfloat162_rn(dv_acc[4 * j + 2 * i], dv_acc[4 * j + 2 * i + 1]);
    }
  }
}

// 1 KB of alignment slack, K and V, two stages of Q and dO, two of lse and delta.
template <int D>
constexpr size_t dkv_wgmma_smem() {
  return 1024 + 6 * 64 * D * 2 + 4 * 64 * sizeof(float);
}

template <int D>
int launch_dkv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, void* dk, void* dv, int b, int tq,
                     int tk, int h, int hkv, float scale, int causal, cudaStream_t stream) {
  const size_t smem = dkv_wgmma_smem<D>();
  cudaError_t err = allow_smem(flash_bwd_dkv_wgmma_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(b * hkv, (tk + 63) / 64);
  flash_bwd_dkv_wgmma_kernel<D><<<grid, kWgThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)dout, lse, delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, tq, tk, h,
      hkv, scale, causal);
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

// The tensor-core route: bf16 only, head_dim 64 or 128.
extern "C" int oim_flash_bwd_dkv_wgmma(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse, const float* delta,
                                       void* dk, void* dv, int b, int tq, int tk, int h,
                                       int hkv, int d, float scale, int causal, void* stream) {
  using namespace oimflash;
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 64:
      return launch_dkv_wgmma<64>(q, k, v, dout, lse, delta, dk, dv, b, tq, tk, h, hkv, scale,
                                  causal, s);
    case 128:
      return launch_dkv_wgmma<128>(q, k, v, dout, lse, delta, dk, dv, b, tq, tk, h, hkv, scale,
                                   causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Resources of one route's kernel (kernel_info in flash_common.cuh): wgmma
// at head_dim d (64 or 128) when wgmma != 0, else the bf16 fma kernel.
extern "C" int oim_flash_bwd_dkv_info(int wgmma, int d, int* out) {
  using namespace oimflash;
  if (!wgmma) return kernel_info(flash_bwd_dkv_kernel<__nv_bfloat16>, kThreads, kDkvSmem, out);
  switch (d) {
    case 64:
      return kernel_info(flash_bwd_dkv_wgmma_kernel<64>, kWgThreads, dkv_wgmma_smem<64>(), out);
    case 128:
      return kernel_info(flash_bwd_dkv_wgmma_kernel<128>, kWgThreads, dkv_wgmma_smem<128>(), out);
    default: return (int)cudaErrorInvalidValue;
  }
}
