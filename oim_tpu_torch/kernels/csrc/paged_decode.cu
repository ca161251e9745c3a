// Paged decode attention for sm_90a: the queries of a serving step over
// each row's pages of one layer's KV pool, read in place through the page
// table.
//
// What it replaces. No Pallas kernel: the JAX package's serving steps
// (oim_tpu/models/generate.py, decode_step and verify_step) gather each
// row's whole page table into a logical [B, S] cache and run the jnp
// `_cache_attention` over it. The port did the same in torch (`_gather` and
// `_cache_attention` in oim_tpu_torch/models/generate.py), which stay as
// the plain version on the CPU. This kernel computes exactly
//   _cache_attention(q, _gather(pk, tables, S), _gather(pv, tables, S), pos)
// with S = n_blocks * page: query t of row b sees the keys at absolute
// positions s <= pos[b] + t (s < S). Numerics are the plain version's: f32
// scores from the cache-dtype operands times head_dim^-0.5, an f32 (online)
// softmax, probabilities rounded to the cache dtype before the PV product
// (as K1 rounds them: unnormalised, against the running max), f32
// accumulation, the output in q's dtype.
//
// What bounds it. Bytes: each key of a row is two head rows (K and V) of
// head_dim values, read for g * T query rows, ~0.5 FLOP a byte at decode.
// The plain path moved ~25x the live K/V (the gather's copy of the whole
// table, f32 transposed copies of it, both read again). Here each live K/V
// head row is read once from the pool for its whole GQA group and
// nothing else of the table is touched: a row's keys past pos[b] + T - 1
// and its table entries past that page are never read.
//
// Design.
// * Grid (n_rc * n_max, kvh, B): one block per (row, KV head, split of the
//   row's live pages, chunk of the g * T query rows). A block holds every
//   query row of its chunk for its KV head, so each K/V head row is read
//   once for its whole GQA group, and loads its own table entries first.
// * Splits adapt on the device to each row's live length (no host sync):
//   a row of `pages` live pages takes n = min(n_max, ceil(pages /
//   min_pages)) splits of equal page counts. The host's rule
//   (kernels.paged_decode_splits) gives n_max, from the grid the call
//   needs against the card's SMs, min_pages and the query rows a block
//   takes (`rc`), all in Params: the device keeps no copy of them. Blocks
//   past a row's n exit.
// * Two routes (kernels.paged_route). "mma", bf16 at head_dim 16/32/64/128:
//   mma.sync tensor cores on chunks of 16 query rows (4 at Mistral's
//   decode: wgmma's 64 rows would be mostly padding), four warps each
//   streaming its own 16-key tiles through a TMA ring, with no block
//   barrier between tiles (below). "fma", f32 and every other head_dim:
//   CUDA cores in f32 on chunks of <= 8 query rows, 32-key tiles through a
//   3-stage cp.async ring (16 bytes a thread where the head row allows):
//   warp w takes a quarter of head_dim and lane j key j for the scores,
//   one warp a query row for the softmax, warp w keys 8w..8w+7 and lane l
//   head_dim entries [l*DPL, l*DPL+DPL) for PV.
// * Bound on the card (conv's shapes, PERF.md): the card's own streaming
//   reads reach ~79% of 3.35 TB/s; the mma route's copies alone reach
//   ~67% of it (256-byte head rows, scattered by the page table) and the
//   whole kernel ~61%.
// * A second kernel merges the splits' (max, sum, acc) in f32 and writes
//   the output in q's dtype (folding it into the last split block, by an
//   atomic count, measured ~3% slower: a fence and an atomic in every block).
#include <math.h>

#include "flash_common.cuh"

namespace oimpaged {

using oimflash::from_f;
using oimflash::round_to;
using oimflash::to_f;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileKeys = 32;
constexpr int kStages = 3;

struct Params {
  const void* q;        // [B, T, H, hd]
  const void* pk;       // [n_pages, page, kvh, hd]
  const void* pv;
  const int64_t* tables;  // [B, nb]
  const int64_t* pos;     // [B]
  float* part;          // [B, kvh, n_max, rows, hd] acc, then [B, kvh, n_max, rows, 2] (m, l)
  void* out;            // [B, T, H, hd]
  int B, T, H, kvh, hd, page, nb, n_max, rows, vec, tab_len;
  int min_pages;  // least pages a split takes
  int rc;         // query rows a block takes: 4 or 8 ("fma"), kMmaRows ("mma")
  float scale;
};

struct Split {
  int n;     // splits the row takes
  int keys;  // keys a split covers (the last one fewer)
  int live;  // keys any query of the row may see: min(pos + T, S)
};

// The one split rule, shared by both kernels.
__device__ __forceinline__ Split row_split(const Params& p, int b) {
  const int64_t S = (int64_t)p.nb * p.page;
  int64_t live = p.pos[b] + p.T;
  live = live < S ? live : S;
  live = live > 1 ? live : 1;
  const int pages = (int)((live + p.page - 1) / p.page);
  int n = min(p.n_max, (pages + p.min_pages - 1) / p.min_pages);
  const int pps = (pages + n - 1) / n;
  n = (pages + pps - 1) / pps;
  return {n, pps * p.page, (int)live};
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// `vec` bytes global -> shared; 16, 8 and 4 asynchronously, 2 (a bf16 head
// row of odd length) by a plain load and store.
__device__ __forceinline__ void copy_chunk(void* dst, const void* src, int vec) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (vec == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  } else if (vec == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
  } else if (vec == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
  } else {
    *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// N consecutive shared-memory values -> f32, in the widest loads their
// alignment allows (callers pass offsets that are multiples of N values).
template <int N>
__device__ __forceinline__ void load_f(const float* s, float* d) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(s)[i];
      d[4 * i] = v.x, d[4 * i + 1] = v.y, d[4 * i + 2] = v.z, d[4 * i + 3] = v.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 v = reinterpret_cast<const float2*>(s)[i];
      d[2 * i] = v.x, d[2 * i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) d[i] = s[i];
  }
}

// A bf16 pair in one 32-bit word -> two f32 (exact: bf16 is f32's top half).
__device__ __forceinline__ void bf16x2_to_f(uint32_t w, float* d) {
  d[0] = __uint_as_float(w << 16);
  d[1] = __uint_as_float(w & 0xffff0000u);
}

template <int N>
__device__ __forceinline__ void load_f(const __nv_bfloat16* s, float* d) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(s)[i];
      bf16x2_to_f(v.x, d + 8 * i), bf16x2_to_f(v.y, d + 8 * i + 2);
      bf16x2_to_f(v.z, d + 8 * i + 4), bf16x2_to_f(v.w, d + 8 * i + 6);
    }
  } else if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const uint2 v = reinterpret_cast<const uint2*>(s)[i];
      bf16x2_to_f(v.x, d + 4 * i), bf16x2_to_f(v.y, d + 4 * i + 2);
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) bf16x2_to_f(reinterpret_cast<const uint32_t*>(s)[i], d + 2 * i);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) d[i] = __bfloat162float(s[i]);
  }
}

// A head row in shared memory: HDP values (head_dim padded to 32, 64 or
// 128) and 16 bytes more, so that rows start 16-byte aligned and 8
// consecutive rows' 16-byte loads at one column fall in distinct banks.
template <typename E, int HDP>
__host__ __device__ constexpr int row_elems() { return HDP + 16 / (int)sizeof(E); }

template <typename E, int HDP, int RC>
struct Smem {
  static constexpr size_t ring = (size_t)kStages * 2 * kTileKeys * row_elems<E, HDP>() * sizeof(E);
  static constexpr size_t q = (size_t)RC * HDP * sizeof(float);
  static constexpr size_t sp = (size_t)kWarps * RC * kTileKeys * sizeof(float);
  static constexpr size_t ps = (size_t)kTileKeys * RC * sizeof(float);
  static constexpr size_t state = 3 * 8 * sizeof(float);  // m, l, alpha for <= 8 rows
  static constexpr size_t fixed = ring + q + sp + ps + state;
  static size_t bytes(int tab_len) { return fixed + (size_t)tab_len * sizeof(int); }
  // the end-of-block reduction reuses the ring: [kWarps][RC][HDP] f32
  static_assert((size_t)kWarps * RC * HDP * sizeof(float) <= ring, "reduction fits the ring");
};

// Issue this thread's copies of tile keys [k0, k0 + 32) ∩ [k0, k_end) of
// K and V into one ring stage. Keys are split into cprp-chunk runs
// (cprp = the row's chunk count rounded up to a power of two, <= 128).
template <typename E, int HDP>
__device__ __forceinline__ void issue_tile(const Params& p, E* ks, E* vs, const int* tab,
                                           int k0, int k_end, int key_base, int h,
                                           int cpr, int cprp_shift) {
  constexpr int ROW = row_elems<E, HDP>();
  const int c = threadIdx.x & ((1 << cprp_shift) - 1);
  if (c >= cpr) return;
  const int step = kThreads >> cprp_shift;
  const size_t row_bytes = (size_t)p.hd * sizeof(E);
  for (int key = threadIdx.x >> cprp_shift; key < kTileKeys; key += step) {
    const int s = k0 + key;
    if (s >= k_end) break;
    const int local = s - key_base;
    const int blk = local / p.page;
    const int off = local - blk * p.page;
    const int64_t row = ((int64_t)tab[blk] * p.page + off) * p.kvh + h;
    const size_t src = (size_t)row * row_bytes + (size_t)c * p.vec;
    const size_t dst = (size_t)key * ROW * sizeof(E) + (size_t)c * p.vec;
    copy_chunk(reinterpret_cast<char*>(ks) + dst, static_cast<const char*>(p.pk) + src, p.vec);
    copy_chunk(reinterpret_cast<char*>(vs) + dst, static_cast<const char*>(p.pv) + src, p.vec);
  }
}

template <typename E, int HDP, int RC>
__global__ void __launch_bounds__(kThreads) paged_decode_split(Params p) {
  using L = Smem<E, HDP, RC>;
  constexpr int ROW = row_elems<E, HDP>();
  constexpr int DW = HDP / kWarps;  // head_dim entries a warp takes in the scores
  constexpr int DPL = HDP / 32;     // head_dim entries a lane takes in PV
  const int split = blockIdx.x % p.n_max;
  const int row0 = (blockIdx.x / p.n_max) * RC;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const Split rs = row_split(p, b);
  if (split >= rs.n) return;
  const int k_begin = split * rs.keys;
  const int k_end = min(k_begin + rs.keys, rs.live);
  const int nr = min(RC, p.rows - row0);
  const int64_t pos_b = p.pos[b];
  const int g = p.H / p.kvh;

  extern __shared__ __align__(16) unsigned char smem[];
  E* ring = reinterpret_cast<E*>(smem);
  float* qs = reinterpret_cast<float*>(smem + L::ring);
  float* spart = reinterpret_cast<float*>(smem + L::ring + L::q);
  float* ps = reinterpret_cast<float*>(smem + L::ring + L::q + L::sp);
  float* m_s = reinterpret_cast<float*>(smem + L::ring + L::q + L::sp + L::ps);
  float* l_s = m_s + 8;
  float* a_s = m_s + 16;
  int* tab = reinterpret_cast<int*>(smem + L::fixed);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // Zero the ring once: head-row padding past head_dim is never copied,
  // and meets zero queries in the scores only if it holds finite values.
  for (int i = tid; i < (int)(L::ring / 16); i += kThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  const E* q = static_cast<const E*>(p.q);
  for (int i = tid; i < RC * HDP; i += kThreads) {
    const int r = i / HDP, d = i % HDP;
    float val = 0.f;
    if (r < nr && d < p.hd) {
      const int row = row0 + r, gi = row / p.T, t = row % p.T;
      val = to_f(q[(((int64_t)b * p.T + t) * p.H + (int64_t)h * g + gi) * p.hd + d]);
    }
    qs[i] = val;
  }
  const int first_blk = k_begin / p.page;
  const int n_blk = (k_end - k_begin + p.page - 1) / p.page;
  for (int i = tid; i < n_blk; i += kThreads)
    tab[i] = (int)p.tables[(int64_t)b * p.nb + first_blk + i];
  if (tid < 8) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
    a_s[tid] = 1.f;
  }
  __syncthreads();

  const int cpr = (int)((size_t)p.hd * sizeof(E) / p.vec);
  int cprp_shift = 0;
  while ((1 << cprp_shift) < cpr) ++cprp_shift;
  const int stage_elems = 2 * kTileKeys * ROW;
  const int n_tiles = (k_end - k_begin + kTileKeys - 1) / kTileKeys;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles)
      issue_tile<E, HDP>(p, ring + st * stage_elems, ring + st * stage_elems + kTileKeys * ROW,
                         tab, k_begin + st * kTileKeys, k_end, k_begin, h, cpr, cprp_shift);
    cp_async_commit();
  }

  float acc[RC][DPL];
#pragma unroll
  for (int r = 0; r < RC; ++r)
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile `it` has landed; every warp is done with tile it - 1
    {
      const int nt = it + kStages - 1;
      if (nt < n_tiles) {
        E* st = ring + (nt % kStages) * stage_elems;
        issue_tile<E, HDP>(p, st, st + kTileKeys * ROW, tab, k_begin + nt * kTileKeys, k_end,
                           k_begin, h, cpr, cprp_shift);
      }
      cp_async_commit();
    }
    const E* kt = ring + (it % kStages) * stage_elems;
    const E* vt = kt + kTileKeys * ROW;
    const int k0 = k_begin + it * kTileKeys;
    const int nvalid = min(kTileKeys, k_end - k0);

    // Partial scores: warp w's quarter of head_dim, lane j's key.
    {
      float kf[DW];
      load_f<DW>(kt + lane * ROW + warp * DW, kf);
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        if (r < nr) {
          float qf[DW];
          load_f<DW>(qs + r * HDP + warp * DW, qf);
          float s = 0.f;
#pragma unroll
          for (int d = 0; d < DW; ++d) s = fmaf(qf[d], kf[d], s);
          spart[(warp * RC + r) * kTileKeys + lane] = s;
        }
      }
    }
    __syncthreads();

    // Online softmax: warp w takes query rows w, w + 4; lane j key j.
    for (int r = warp; r < nr; r += kWarps) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += spart[(w * RC + r) * kTileKeys + lane];
      s *= p.scale;
      const int t = (row0 + r) % p.T;
      const bool valid = lane < nvalid && (int64_t)(k0 + lane) <= pos_b + t;
      s = valid ? s : -INFINITY;
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float pr = valid ? expf(s - m_new) : 0.f;
      const float alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
      const float tsum = warp_sum(pr);
      ps[lane * RC + r] = round_to<E>(pr);
      if (lane == 0) {
        l_s[r] = l_s[r] * alpha + tsum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // PV: warp w's keys 8w .. 8w + 7, lane l's head_dim entries.
    {
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        const float a = a_s[r];
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[r][e] *= a;
      }
      const int kb = warp * (kTileKeys / kWarps);
      const int ke = min(kb + kTileKeys / kWarps, nvalid);
      for (int key = kb; key < ke; ++key) {
        float vf[DPL], pr[RC];
        load_f<DPL>(vt + key * ROW + lane * DPL, vf);
        load_f<RC>(ps + key * RC, pr);
#pragma unroll
        for (int r = 0; r < RC; ++r)
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[r][e] = fmaf(pr[r], vf[e], acc[r][e]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // The four warps' sums, then this split's (acc, m, l).
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int r = 0; r < RC; ++r)
#pragma unroll
    for (int e = 0; e < DPL; ++e) red[(warp * RC + r) * HDP + lane * DPL + e] = acc[r][e];
  __syncthreads();
  const int64_t slot = ((int64_t)b * p.kvh + h) * p.n_max + split;
  float* part_acc = p.part + (slot * p.rows + row0) * p.hd;
  for (int i = tid; i < nr * p.hd; i += kThreads) {
    const int r = i / p.hd, d = i % p.hd;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[(w * RC + r) * HDP + d];
    part_acc[(int64_t)r * p.hd + d] = s;
  }
  if (tid < nr) {
    float* ml = p.part + (int64_t)p.B * p.kvh * p.n_max * p.rows * p.hd +
                (slot * p.rows + row0 + tid) * 2;
    ml[0] = m_s[tid];
    ml[1] = l_s[tid];
  }
}

// One block per (KV head, row): the row's splits merged in f32.
template <typename E>
__global__ void __launch_bounds__(kThreads) paged_decode_merge(Params p) {
  const int h = blockIdx.x, b = blockIdx.y;
  const Split rs = row_split(p, b);
  const int g = p.H / p.kvh;
  const int64_t slot0 = ((int64_t)b * p.kvh + h) * p.n_max;
  const float* acc = p.part + slot0 * p.rows * p.hd;
  const float* ml = p.part + (int64_t)p.B * p.kvh * p.n_max * p.rows * p.hd + slot0 * p.rows * 2;
  E* out = static_cast<E*>(p.out);
  for (int i = threadIdx.x; i < p.rows * p.hd; i += kThreads) {
    const int r = i / p.hd, d = i % p.hd;
    float M = -INFINITY;
    for (int c = 0; c < rs.n; ++c) M = fmaxf(M, ml[(c * p.rows + r) * 2]);
    float l = 0.f, o = 0.f;
    for (int c = 0; c < rs.n; ++c) {
      const float w = expf(ml[(c * p.rows + r) * 2] - M);
      l = fmaf(w, ml[(c * p.rows + r) * 2 + 1], l);
      o = fmaf(w, acc[((int64_t)c * p.rows + r) * p.hd + d], o);
    }
    const int gi = r / p.T, t = r % p.T;
    out[(((int64_t)b * p.T + t) * p.H + (int64_t)h * g + gi) * p.hd + d] = from_f<E>(o / l);
  }
}

// ---- The tensor-core route: bf16 at head_dim 16, 32, 64 or 128 ----------
//
// A block's 4 warps work alone: warp w takes the split's 16-key tiles w,
// w + 4, ... through a ring of its own (two stages of K and V, filled by
// TMA bulk copies, one head row a lane, completing on an mbarrier a
// stage; the next tile is asked for before this one is waited on), so no
// block barrier stands between tiles. Scores and PV are mma.sync m16n8k16 with
// f32 accumulators, the block's <= 16 query rows as M (Q held as A
// fragments in registers): S = Q K^T takes K rows straight from shared
// memory (ldmatrix), its two 8-key halves are exactly the A fragment of P
// for O += P V (V through ldmatrix.trans), so P never leaves registers.
// The online softmax runs on the S fragments: a row's four lanes meet by
// two shuffles. The warps' (max, sum, acc) merge in shared memory at the
// end, into the same split record the CUDA-core kernel writes.
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaRows = 16;  // query rows a block: mma's M
constexpr int kMmaKeys = 16;  // keys of a warp's tile: PV's reduction
constexpr int kMmaStages = 2;

template <int HD>
struct MmaSmem {
  // bf16 values a head row takes: 16 bytes past head_dim, so that the 8
  // rows of an ldmatrix fall in 8 distinct 16-byte bank groups
  static constexpr int ROW = HD + 8;
  static constexpr size_t stage = (size_t)2 * kMmaKeys * ROW * sizeof(__nv_bfloat16);
  static constexpr size_t ring = stage * kMmaStages * kMmaWarps;
  // the end-of-block merge reuses it: [warp][row][acc (HD), max, sum] f32
  static constexpr size_t red = (size_t)kMmaWarps * kMmaRows * (HD + 2) * sizeof(float);
  static constexpr size_t fixed = ring > red ? ring : red;
  static constexpr size_t bars = (size_t)kMmaStages * kMmaWarps * sizeof(uint64_t);
  static size_t bytes(int tab_len) { return fixed + bars + (size_t)tab_len * sizeof(int); }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// One arrival that also expects `bytes` of bulk copies on the barrier.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) global -> shared
// by the TMA unit, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a b: A 16 x 16 (row major), B 16 x 8 (column major), bf16; f32 d.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 -> a bf16 pair (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads) paged_decode_mma(Params p) {
  using L = MmaSmem<HD>;
  constexpr int ROW = L::ROW;
  const int split = blockIdx.x % p.n_max;
  const int row0 = (blockIdx.x / p.n_max) * kMmaRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const Split rs = row_split(p, b);
  if (split >= rs.n) return;
  const int k_begin = split * rs.keys;
  const int k_end = min(k_begin + rs.keys, rs.live);
  const int nr = min(kMmaRows, p.rows - row0);
  const int64_t pos_b = p.pos[b];
  const int gq = p.H / p.kvh;

  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::fixed);  // [warp][stage]
  int* tab = reinterpret_cast<int*>(smem + L::fixed + L::bars);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, qc = lane % 4;  // fragment row group, column pair
  uint64_t* my_bars = bars + warp * kMmaStages;
  __nv_bfloat16* ring =
      reinterpret_cast<__nv_bfloat16*>(smem + (size_t)warp * kMmaStages * L::stage);

  const int first_blk = k_begin / p.page;
  const int n_blk = (k_end - k_begin + p.page - 1) / p.page;
  for (int i = tid; i < n_blk; i += kMmaThreads)
    tab[i] = (int)p.tables[(int64_t)b * p.nb + first_blk + i];

  // Q as A fragments: rows gr and gr + 8 of the chunk; head_dim pairs 2qc
  // and 8 + 2qc of each 16-wide k-step. Rows past the chunk are zero.
  const uint32_t* q32 = static_cast<const uint32_t*>(p.q);
  uint32_t qa[HD / 16][4];
  int trow[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = gr + 8 * half, row = row0 + r;
    const bool ok = r < nr;
    const int gi = row / p.T, t = row % p.T;
    trow[half] = t;
    const int64_t base =
        ok ? (((int64_t)b * p.T + t) * p.H + (int64_t)h * gq + gi) * (HD / 2) : 0;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      qa[kk][half] = ok ? q32[base + 8 * kk + qc] : 0u;
      qa[kk][2 + half] = ok ? q32[base + 8 * kk + 4 + qc] : 0u;
    }
  }
  // The ring starts zeroed (slots past a split's last key are never
  // copied, and meet zero probabilities only as finite values); the async
  // proxy sees the zeros and the initialised barriers.
  if (lane < kMmaStages) mbar_init(my_bars + lane, 1);
  for (int e = lane; e < (int)(kMmaStages * L::stage / 16); e += 32)
    reinterpret_cast<uint4*>(ring)[e] = make_uint4(0u, 0u, 0u, 0u);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();  // the table

  const int n_tiles = (k_end - k_begin + kMmaKeys - 1) / kMmaKeys;
  const int my_tiles = n_tiles > warp ? (n_tiles - warp + kMmaWarps - 1) / kMmaWarps : 0;
  constexpr int kStageElems = 2 * kMmaKeys * ROW;
  // This warp's i-th tile into stage i % kMmaStages: lane j < 16 copies key
  // j's K head row, lane 16 + j its V head row, one bulk copy each.
  auto issue = [&](int i) {
    const int k0 = k_begin + (warp + i * kMmaWarps) * kMmaKeys;
    __nv_bfloat16* ks = ring + (i % kMmaStages) * kStageElems;
    uint64_t* bar = my_bars + i % kMmaStages;
    const int nvalid = min(kMmaKeys, k_end - k0);
    if (lane == 0) mbar_expect(bar, nvalid * 2 * HD * (int)sizeof(__nv_bfloat16));
    __syncwarp();
    const int key = lane % kMmaKeys;
    if (key < nvalid) {
      const int local = k0 + key - k_begin;
      const int blk = local / p.page;
      const int64_t row = ((int64_t)tab[blk] * p.page + (local - blk * p.page)) * p.kvh + h;
      const bool is_v = lane >= kMmaKeys;
      const char* src = static_cast<const char*>(is_v ? p.pv : p.pk) + row * HD * 2;
      // this warp's ldmatrix reads of the stage come before the copy's writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bulk_copy(ks + (is_v ? kMmaKeys * ROW : 0) + key * ROW, src, HD * 2, bar);
    }
  };

  float o[HD / 8][4];
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int mi = lane / 8, ii = lane % 8;  // ldmatrix: this lane's matrix and row

  for (int st = 0; st < kMmaStages - 1; ++st)
    if (st < my_tiles) issue(st);
  for (int i = 0; i < my_tiles; ++i) {
    if (i + kMmaStages - 1 < my_tiles) issue(i + kMmaStages - 1);  // into tile i - 1's stage
    mbar_wait(my_bars + i % kMmaStages, (i / kMmaStages) & 1);
    const __nv_bfloat16* ks = ring + (i % kMmaStages) * kStageElems;
    const __nv_bfloat16* vs = ks + kMmaKeys * ROW;
    const int k0 = k_begin + (warp + i * kMmaWarps) * kMmaKeys;

    // S = Q K^T: n-tile 0 is keys 0..7 of the tile, n-tile 1 keys 8..15.
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t bk[4];
      ldsm_x4(bk, ks + (8 * (mi / 2) + ii) * ROW + 16 * kk + 8 * (mi % 2));
      mma_bf16(sc[0], qa[kk], bk[0], bk[1]);
      mma_bf16(sc[1], qa[kk], bk[2], bk[3]);
    }
    // sc[nt][j]: query row gr + 8 (j / 2), key k0 + 8 nt + 2 qc + j % 2.
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + 8 * nt + 2 * qc + (j & 1);
        const bool valid = key < k_end && (int64_t)key <= pos_b + trow[j >> 1];
        sc[nt][j] = valid ? sc[nt][j] * p.scale : -INFINITY;
        tmax[j >> 1] = fmaxf(tmax[j >> 1], sc[nt][j]);
      }
    float alpha[2], tsum[2] = {0.f, 0.f};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      tmax[hf] = fmaxf(tmax[hf], __shfl_xor_sync(0xffffffffu, tmax[hf], 1));
      tmax[hf] = fmaxf(tmax[hf], __shfl_xor_sync(0xffffffffu, tmax[hf], 2));
      const float m_new = fmaxf(m[hf], tmax[hf]);
      alpha[hf] = m[hf] == -INFINITY ? 0.f : expf(m[hf] - m_new);
      m[hf] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float s = sc[nt][j];
        sc[nt][j] = s == -INFINITY ? 0.f : expf(s - m[j >> 1]);
        tsum[j >> 1] += sc[nt][j];
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      tsum[hf] += __shfl_xor_sync(0xffffffffu, tsum[hf], 1);
      tsum[hf] += __shfl_xor_sync(0xffffffffu, tsum[hf], 2);
      l[hf] = l[hf] * alpha[hf] + tsum[hf];
    }
    // P in bf16 (the cache dtype) as the A fragment of O += P V.
    const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]),
                            pack_bf16(sc[1][0], sc[1][1]), pack_bf16(sc[1][2], sc[1][3])};
    if (alpha[0] != 1.f || alpha[1] != 1.f) {  // a row's running max moved
#pragma unroll
      for (int dn = 0; dn < HD / 8; ++dn) {
        o[dn][0] *= alpha[0], o[dn][1] *= alpha[0];
        o[dn][2] *= alpha[1], o[dn][3] *= alpha[1];
      }
    }
#pragma unroll
    for (int dn = 0; dn < HD / 8; dn += 2) {
      uint32_t bv[4];
      ldsm_x4_t(bv, vs + (8 * (mi % 2) + ii) * ROW + 8 * dn + 8 * (mi / 2));
      mma_bf16(o[dn], pa, bv[0], bv[1]);
      mma_bf16(o[dn + 1], pa, bv[2], bv[3]);
    }
    __syncwarp();  // every lane is done with this stage before it is refilled
  }
  __syncthreads();

  // The four warps' (acc, max, sum) -> this split's record.
  float* red = reinterpret_cast<float*>(smem);
  constexpr int RS = HD + 2;
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      red[(warp * kMmaRows + gr + 8 * (j >> 1)) * RS + 8 * dn + 2 * qc + (j & 1)] = o[dn][j];
  if (qc == 0) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      red[(warp * kMmaRows + gr + 8 * hf) * RS + HD] = m[hf];
      red[(warp * kMmaRows + gr + 8 * hf) * RS + HD + 1] = l[hf];
    }
  }
  __syncthreads();
  const int64_t slot = ((int64_t)b * p.kvh + h) * p.n_max + split;
  float* part_acc = p.part + (slot * p.rows + row0) * HD;
  for (int e = tid; e < nr * HD; e += kMmaThreads) {
    const int r = e / HD, d = e % HD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) M = fmaxf(M, red[(w * kMmaRows + r) * RS + HD]);
    float acc = 0.f;
    if (M != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kMmaWarps; ++w)
        acc += expf(red[(w * kMmaRows + r) * RS + HD] - M) * red[(w * kMmaRows + r) * RS + d];
    }
    part_acc[(int64_t)r * HD + d] = acc;
  }
  if (tid < nr) {
    float M = -INFINITY, sum = 0.f;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) M = fmaxf(M, red[(w * kMmaRows + tid) * RS + HD]);
    if (M != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kMmaWarps; ++w)
        sum += expf(red[(w * kMmaRows + tid) * RS + HD] - M) *
               red[(w * kMmaRows + tid) * RS + HD + 1];
    }
    float* ml = p.part + (int64_t)p.B * p.kvh * p.n_max * p.rows * p.hd +
                (slot * p.rows + row0 + tid) * 2;
    ml[0] = M;
    ml[1] = sum;
  }
}

template <int HD>
int launch_mma(const Params& p, cudaStream_t stream) {
  const size_t smem = MmaSmem<HD>::bytes(p.tab_len);
  cudaError_t err = oimflash::allow_smem(paged_decode_mma<HD>, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_rc = (p.rows + kMmaRows - 1) / kMmaRows;  // p.rc == kMmaRows
  paged_decode_mma<HD><<<dim3(n_rc * p.n_max, p.kvh, p.B), kMmaThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_decode_merge<__nv_bfloat16><<<dim3(p.kvh, p.B), kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename E, int HDP, int RC>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = Smem<E, HDP, RC>::bytes(p.tab_len);
  cudaError_t err = oimflash::allow_smem(paged_decode_split<E, HDP, RC>, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_rc = (p.rows + RC - 1) / RC;
  paged_decode_split<E, HDP, RC>
      <<<dim3(n_rc * p.n_max, p.kvh, p.B), kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_decode_merge<E><<<dim3(p.kvh, p.B), kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename E, int HDP>
int launch_rows(const Params& p, cudaStream_t stream) {
  if (p.rc == 4) return launch<E, HDP, 4>(p, stream);
  if (p.rc == 8) return launch<E, HDP, 8>(p, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename E>
int launch_dtype(const Params& p, cudaStream_t stream) {
  if (p.hd <= 32) return launch_rows<E, 32>(p, stream);
  if (p.hd <= 64) return launch_rows<E, 64>(p, stream);
  return launch_rows<E, 128>(p, stream);
}

}  // namespace oimpaged

// Plain C entry point (loaded with ctypes). Returns a cudaError_t code.
// `part` holds B * kvh * n_max * rows * (hd + 2) floats, rows = (H / kvh) * T;
// `vec` is the copy width in bytes (16, 8, 4 or 2), dividing hd's bytes and
// both pools' addresses; `tab_len` bounds the pages of one split,
// `min_pages` is the least pages a split takes and `rc` (4 or 8) the query
// rows a block takes (kernels.paged_decode_splits).
extern "C" int oim_paged_decode(const void* q, const void* pk, const void* pv,
                                const void* tables, const void* pos, float* part, void* out,
                                int b, int t, int h, int kvh, int hd, int page, int nb,
                                int n_max, int vec, int tab_len, int min_pages, int rc,
                                float scale, int dtype, void* stream) {
  using namespace oimpaged;
  if (hd < 1 || hd > oimflash::kMaxD || kvh < 1 || h % kvh || n_max < 1 || page < 1 ||
      min_pages < 1)
    return (int)cudaErrorInvalidValue;
  Params p{q, pk, pv, static_cast<const int64_t*>(tables), static_cast<const int64_t*>(pos),
           part, out, b, t, h, kvh, hd, page, nb, n_max, (h / kvh) * t, vec, tab_len,
           min_pages, rc, scale};
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case oimflash::kF32: return launch_dtype<float>(p, s);
    case oimflash::kBF16: return launch_dtype<__nv_bfloat16>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The tensor-core route: bf16, head_dim 16, 32, 64 or 128, both pools and
// q 16-byte aligned (the wrapper's rule, kernels.paged_route). Same
// arguments as oim_paged_decode but for vec and dtype; `rc` must be
// kMmaRows.
extern "C" int oim_paged_decode_mma(const void* q, const void* pk, const void* pv,
                                    const void* tables, const void* pos, float* part, void* out,
                                    int b, int t, int h, int kvh, int hd, int page, int nb,
                                    int n_max, int tab_len, int min_pages, int rc, float scale,
                                    void* stream) {
  using namespace oimpaged;
  if (kvh < 1 || h % kvh || n_max < 1 || page < 1 || min_pages < 1 || rc != kMmaRows)
    return (int)cudaErrorInvalidValue;
  Params p{q, pk, pv, static_cast<const int64_t*>(tables), static_cast<const int64_t*>(pos),
           part, out, b, t, h, kvh, hd, page, nb, n_max, (h / kvh) * t, 16, tab_len,
           min_pages, rc, scale};
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 16: return launch_mma<16>(p, s);
    case 32: return launch_mma<32>(p, s);
    case 64: return launch_mma<64>(p, s);
    case 128: return launch_mma<128>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
