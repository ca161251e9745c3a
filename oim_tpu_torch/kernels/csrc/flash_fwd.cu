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
// the card's ~295 flop/byte ridge): the bf16 tensor cores (989 TFLOP/s)
// are the roof.
//
// Two routes, chosen by the wrapper (kernels.fwd_route):
//
// * wgmma (bf16, head_dim 64 or 128): flash_fwd_wgmma_kernel, K3's loop
//   (flash_bwd_dq.cu) with dP taken out and the online softmax put in. One
//   warpgroup owns 64 queries of one query head; Q stays in shared memory
//   as swizzled bf16 (flash_sm90.cuh) and the K and V tiles stream through
//   a two-stage cp.async ring. Per key tile: S = Q K^T on the tensor cores
//   into 32 f32 registers a thread; the online softmax in registers (a
//   row's 64 columns lie on the 4 threads of a quad, so the row max is two
//   xor-shuffles; exp is exp2 with log2(e) folded into the scale; O's
//   accumulators are rescaled by corr); then P, packed to bf16 pairs, is
//   the register A operand of O += P V, V read as MN-major B. Nothing goes
//   through shared memory but the operands. Each thread sums l over its own
//   16 columns of a row and the quad adds the four partial sums once, in
//   the epilogue. m is kept in the natural units of s * scale, so a row
//   that sees no key keeps m = -1e30 exactly and gets lse = -1e30 as the
//   plain version does. The mask (a select to -inf before the max, so a
//   masked score never enters it and exp2 maps it to exactly 0; nothing is
//   multiplied by a mask) is computed only on tiles that cross the diagonal
//   or a ragged edge, and key tiles wholly above the diagonal are never
//   loaded. Block (x, y) = (batch*head, query tile nq-1-y): the last query
//   tiles, which see the most keys under a causal mask, start first. 128
//   threads, 81 KB of shared memory at head_dim 128: two blocks per SM.
// * fma (f32, and bf16 at any other head_dim or with an unaligned pointer):
//   flash_fwd_kernel, the first version: f32 FMAs on the CUDA cores, one
//   block per (64-query tile, batch*head), f32 tiles in shared memory and P
//   through shared memory.
//
// Precision points, the same on both routes and in the plain version
// (ops/attention.py flash_forward_plain): S is a bf16 x bf16 product summed
// in f32; P is rounded to V's dtype (bf16) before O += P V; l is summed from
// the unrounded f32 p; out is rounded to the inputs' dtype once, at the end.
#include "flash_common.cuh"
#include "flash_sm90.cuh"

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

constexpr size_t kFwdSmem = (size_t)(3 * kBlockQ * kStride + kBlockQ * kBlockK) * sizeof(float);

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* out, float* lse, int b,
               int tq, int tk, int h, int hkv, int d, float scale, int causal,
               cudaStream_t stream) {
  const size_t smem = kFwdSmem;
  cudaError_t err = allow_smem(flash_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((tq + kBlockQ - 1) / kBlockQ, b * h);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, tq, tk, h, hkv, d, scale, causal);
  return (int)cudaGetLastError();
}

// One warpgroup: queries q_lo .. q_lo+63 of query head hq of batch b.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 2)
flash_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int tq, int tk, int h, int hkv, float scale,
                       int causal) {
  constexpr int kTile = 64 * D * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align_1k(smem_raw);
  uint8_t* ks = qs + kTile;     // [2 stages]
  uint8_t* vs = ks + 2 * kTile; // [2 stages]

  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, c = tid & 3;
  const int bh = blockIdx.x, b = bh / h, hq = bh % h, hk = hq / (h / hkv);
  const int nq = (tq + 63) / 64;
  const int q_lo = (nq - 1 - (int)blockIdx.y) * 64;
  const int q_start = q_lo + (tk - tq);
  const int nk = key_tiles(q_lo, tq, tk, causal);

  if (nk > 0) {
    load_tile_async<D>(qs, q, b, q_lo, tq, h, hq);
    load_tile_async<D>(ks, k, b, 0, tk, hkv, hk);
    load_tile_async<D>(vs, v, b, 0, tk, hkv, hk);
  }
  cp_async_commit();

  // This thread's two query rows are 16*warp + g + 8i (i < 2). m is the
  // row's running max of s * scale (natural units, -1e30 until the row sees
  // a key); l is this thread's share of the row sum (its 16 columns).
  float o[D / 2], s[32], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  const float scale_log2 = scale * kLog2e;
  const float masked = __uint_as_float(0xff800000u);  // -inf
  const uint32_t q_tile = smem_addr(qs);

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

    // S = Q K^T, [64 queries x 64 keys].
    wgmma_fence();
    wgmma_ss_64x64<D>(s, q_tile, k_tile);
    wgmma_commit();
    const bool edge = (causal && k_lo + 63 > q_start) || q_lo + 64 > tq || k_lo + 64 > tk;
    wgmma_wait<0>();
    reg_fence(s);

    if (edge) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qr = 16 * warp + g + 8 * i, kc = 8 * j + 2 * c + e;
            const bool ok = q_lo + qr < tq && k_lo + kc < tk &&
                            (!causal || q_start + qr >= k_lo + kc);
            s[4 * j + 2 * i + e] = ok ? s[4 * j + 2 * i + e] : masked;
          }
    }

    // Online softmax: p = exp(s * scale - m_new), exactly 0 where masked.
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = masked;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx * scale);
      corr[i] = exp2f((m[i] - m_new) * kLog2e);
      m[i] = m_new;
      const float mb = m_new * kLog2e;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(fmaf(s[4 * j + 2 * i + e], scale_log2, -mb));
          s[4 * j + 2 * i + e] = p;
          rs += p;
        }
      l[i] = l[i] * corr[i] + rs;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        o[4 * j + 2 * i] *= corr[i];
        o[4 * j + 2 * i + 1] *= corr[i];
      }
    uint32_t pa[16];
    pack_a(s, pa);  // P rounded to bf16

    // O += P V: A from registers, B the value tile read MN-major.
    wgmma_fence();
    wgmma_rs_64xD<D>(o, pa, v_tile);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(o);
    __syncthreads();  // every thread is done with this stage before it refills
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = l[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float ll = fmaxf(sum, 1e-30f);
    const int row = q_lo + 16 * warp + g + 8 * i;
    if (row >= tq) continue;
    __nv_bfloat16* dst = out + (((int64_t)b * tq + row) * h + hq) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + 2 * c) =
          __floats2bfloat162_rn(o[4 * j + 2 * i] / ll, o[4 * j + 2 * i + 1] / ll);
    if (c == 0) lse[(int64_t)bh * tq + row] = m[i] + logf(ll);
  }
}

// 1 KB of alignment slack, Q, two stages of K and V.
template <int D>
constexpr size_t fwd_wgmma_smem() {
  return 1024 + 5 * 64 * D * 2;
}

template <int D>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* out, float* lse, int b,
                     int tq, int tk, int h, int hkv, float scale, int causal,
                     cudaStream_t stream) {
  const size_t smem = fwd_wgmma_smem<D>();
  cudaError_t err = allow_smem(flash_fwd_wgmma_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(b * h, (tq + 63) / 64);
  flash_fwd_wgmma_kernel<D><<<grid, kWgThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)out, lse, tq, tk, h, hkv, scale, causal);
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

// The tensor-core route: bf16 only, head_dim 64 or 128.
extern "C" int oim_flash_fwd_wgmma(const void* q, const void* k, const void* v, void* out,
                                   float* lse, int b, int tq, int tk, int h, int hkv, int d,
                                   float scale, int causal, void* stream) {
  using namespace oimflash;
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 64: return launch_fwd_wgmma<64>(q, k, v, out, lse, b, tq, tk, h, hkv, scale, causal, s);
    case 128: return launch_fwd_wgmma<128>(q, k, v, out, lse, b, tq, tk, h, hkv, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Resources of one route's kernel (kernel_info in flash_common.cuh): wgmma
// at head_dim d (64 or 128) when wgmma != 0, else the bf16 fma kernel.
extern "C" int oim_flash_fwd_info(int wgmma, int d, int* out) {
  using namespace oimflash;
  if (!wgmma) return kernel_info(flash_fwd_kernel<__nv_bfloat16>, kThreads, kFwdSmem, out);
  switch (d) {
    case 64: return kernel_info(flash_fwd_wgmma_kernel<64>, kWgThreads, fwd_wgmma_smem<64>(), out);
    case 128:
      return kernel_info(flash_fwd_wgmma_kernel<128>, kWgThreads, fwd_wgmma_smem<128>(), out);
    default: return (int)cudaErrorInvalidValue;
  }
}
