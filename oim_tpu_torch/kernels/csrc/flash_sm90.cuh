// Hopper (sm_90a) building blocks of the tensor-core route of K1
// (flash_fwd.cu), K2 (flash_bwd_dkv.cu) and K3 (flash_bwd_dq.cu): 16-byte
// cp.async with zero fill, the 128-byte swizzled tile layout that wgmma
// reads, shared-memory matrix descriptors, and the three wgmma shapes the
// kernels launch.
//
// Tile layout. A [rows][D] bf16 tile (rows a multiple of 8, D = 64 or 128)
// is stored as D/64 panels of [rows][64]: each panel row is 128 bytes, 8
// chunks of 16 bytes, and chunk c of row r sits at chunk c ^ (r % 8) of
// that row (the 128-byte swizzle, wgmma layout type 1). Eight rows make a
// 1024-byte swizzle atom, so every tile starts 1024-byte aligned. The same
// bytes serve as a K-major operand (D is the reduction: S = Q K^T) and as
// an MN-major one (the rows are the reduction: dV += P^T dO), which is why
// one copy of Q, dO or K in shared memory feeds two products.
//
// Accumulators (m64nN, f32): thread t of the warpgroup (warp w = t / 32,
// g = (t % 32) / 4, c = t % 4) holds d[4j + 2i + e] = element (row 16w + g
// + 8i, column 8j + 2c + e). Packed to bf16 pairs, d[8kk .. 8kk+7] are
// exactly the A fragment of a register-A wgmma whose reduction chunk kk is
// columns 16kk .. 16kk+15: a product's output feeds the next product
// without a trip through shared memory.
#pragma once

#include "flash_common.cuh"

namespace oimflash {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWgThreads = 128;  // one warpgroup

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// First 1024-byte aligned address at or after p (dynamic shared memory is
// only guaranteed 16-byte alignment; launchers ask for 1 KB extra).
__device__ __forceinline__ uint8_t* align_1k(uint8_t* p) {
  const uint32_t a = smem_addr(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (src
// must still be a mapped address: callers pass the tensor's base then).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's completed shared-memory writes visible to the async
// proxy that wgmma reads through; a barrier after it publishes them to the
// warpgroup.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of 16-byte chunk `chunk` (along D) of row r in a tile of
// `rows` rows.
__device__ __forceinline__ uint32_t swizzled(int r, int chunk, int rows) {
  return (uint32_t)((chunk >> 3) * rows * 128 + r * 128 + (((chunk & 7) ^ (r & 7)) << 4));
}

// Rows [row0, row0 + 64) of head `head` of batch b of a BTHD bf16 tensor
// with t rows and `heads` heads -> a swizzled 64 x D tile, one cp.async of
// 16 bytes per chunk; rows at or past t are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile_async(uint8_t* tile, const __nv_bfloat16* x, int b,
                                                int row0, int t, int heads, int head) {
  constexpr int kChunks = D / 8;  // per row
  const uint32_t base = smem_addr(tile);
#pragma unroll
  for (int j = 0; j < 64 * kChunks / kWgThreads; ++j) {
    const int i = (int)threadIdx.x + j * kWgThreads;
    const int r = i / kChunks, ch = i % kChunks;
    const int row = row0 + r;
    const bool ok = row < t;
    const __nv_bfloat16* src =
        ok ? x + (((int64_t)b * t + row) * heads + head) * D + ch * 8 : x;
    cp_async_16(base + swizzled(r, ch, 64), src, ok);
  }
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// A 64-row tile as a K-major operand (its rows are M or N, D the
// reduction), reduction chunk kk = columns 16kk .. 16kk+15: inside a panel
// a chunk is 32 bytes further along the swizzled row; 8-row groups are
// 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int kk) {
  return smem_desc(tile + (kk >> 2) * 64 * 128 + (kk & 3) * 32, 16, 1024);
}

// A 64-row tile as an MN-major operand (its rows are the reduction, D is
// N), reduction chunk kk = rows 16kk .. 16kk+15: 8-row groups 1024 bytes
// apart (stride byte offset), 64-column panels 64 x 128 bytes apart
// (leading byte offset).
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int kk) {
  return smem_desc(tile + kk * 16 * 128, 64 * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma wait (the hardware writes them asynchronously).
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulator of an m64n64 product (64 x 64, f32), rounded to bf16 and
// packed as the register A operand of the four k16 steps that reduce over
// its 64 columns: a[4kk .. 4kk+3] for columns 16kk .. 16kk+15.
__device__ __forceinline__ void pack_a(const float (&d)[32], uint32_t (&a)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = pack_bf16(d[2 * i], d[2 * i + 1]);
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A in registers (the accumulator
// layout of a previous product, packed to bf16 pairs), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 128] += A[64 x 16] B[16 x 128], A in registers (the accumulator
// layout of a previous product, packed to bf16 pairs), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// dst[64 x D] += A[64 x 64] (registers, a[16]) B[64 x D] (MN-major tile in
// shared memory): four k16 steps over the 64 rows of B.
template <int D>
__device__ __forceinline__ void wgmma_rs_64xD(float (&acc)[D / 2], const uint32_t (&a)[16],
                                              uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (D == 128) {
      wgmma_m64n128k16_rs(acc, a + 4 * kk, desc_mn_major(b_tile, kk));
    } else {
      wgmma_m64n64k16_rs(acc, a + 4 * kk, desc_mn_major(b_tile, kk));
    }
  }
}

// dst[64 x 64] = A[64 x D] B[64 x D]^T, both K-major tiles in shared memory.
template <int D>
__device__ __forceinline__ void wgmma_ss_64x64(float (&acc)[32], uint32_t a_tile,
                                               uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n64k16_ss(acc, desc_k_major(a_tile, kk), desc_k_major(b_tile, kk), kk > 0);
}

}  // namespace oimflash
