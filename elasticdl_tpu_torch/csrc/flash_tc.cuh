// Hopper tensor-core building blocks shared by the bf16 flash kernels
// (flash_fwd.cu and flash_bwd.cu): cp.async tile loads into 128-byte
// swizzled shared memory, wgmma descriptors and products (SS: both
// operands from shared memory, K-major; RS: A from registers, B read
// MN-major), the accumulator -> bf16 A-fragment packing, and the
// per-tile mask tests. Every tile is 64 rows (queries or keys) of D
// bf16 columns, stored as D / 64 panels of 64 rows x 128 bytes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace edl_tc {

constexpr int TB = 64;            // rows of every tile: queries or keys
constexpr int WG = 128;           // threads of a warpgroup
constexpr int PANEL = TB * 128;   // bytes of 64 rows x 64 bf16 columns

template <bool C, bool W, bool S, bool O>
struct Masks {
  static constexpr bool causal = C, window = W, segs = S, offset = O;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; `bytes` 0 zero-fills.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// cp.async writes through the generic proxy, wgmma reads through the
// async proxy: this orders the one before the other
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int R>
__device__ __forceinline__ void keep(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Rows [r0, r0 + 64) of a row-major [rows, D] bf16 matrix into a shared
// tile as wgmma reads it with the 128-byte swizzle: D / 64 panels of
// 64 rows x 128 bytes, the 16-byte chunk j of row r at chunk j ^ (r % 8)
// of its row. Rows past `rows` are zero-filled. The block's one
// warpgroup shares the copy.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src, int r0,
                                          int rows) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int n = 0; n < TB * CPR / WG; ++n) {
    const int i = threadIdx.x + WG * n;
    const int r = i / CPR, c = i % CPR;
    const bool in = r0 + r < rows;
    const __nv_bfloat16* g = src + (size_t)(in ? r0 + r : 0) * D + c * 8;
    cp_async16(dst + (c / 8) * PANEL + r * 128 + (((c % 8) ^ (r % 8)) << 4),
               g, in ? 16u : 0u);
  }
}

// wgmma's shared-memory matrix descriptor of such a tile: start address
// / 16, leading byte offset 16 (unused: a product reads one 64-column
// panel), stride byte offset 1024 (8 rows of 128 bytes), layout type 1
// (128-byte swizzle) in bits 62-63. It is made anew in every loop step
// through an opaque move, and moved from one depth step to the next in
// place (advance), so the compiler keeps one register pair per operand
// rather than one per depth step (32 pairs for a d = 128 tile pair).
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
  uint64_t desc = (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
                  (64ull << 32) | (1ull << 62);
  asm volatile("mov.b64 %0, %0;\n" : "+l"(desc));
  return desc;
}
// moves a descriptor's start address by `bytes` (a multiple of 16)
__device__ __forceinline__ void advance(uint64_t& desc, int bytes) {
  asm volatile("add.s64 %0, %0, %1;\n" : "+l"(desc) : "l"((int64_t)(bytes / 16)));
}

#define EDL_ACC32(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),        \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),    \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),    \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),    \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),    \
      "+f"(d[31])
#define EDL_OUT32(d)                                                        \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), \
      "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]),        \
      "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),    \
      "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]),    \
      "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]),    \
      "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]),    \
      "=f"(d[31])
#define EDL_D32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d[64 x 64] += A[64 x 16] B[16 x 64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " EDL_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : EDL_ACC32(d)
      : "l"(a), "l"(b), "r"(1));
}

// d[64 x 64] = A[64 x 16] B[16 x 64]: the first depth step, which
// overwrites d (scale-d false), so d needs no zeroing before it.
__device__ __forceinline__ void wgmma_ss_first(float (&d)[32], uint64_t a,
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " EDL_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : EDL_OUT32(d)
      : "l"(a), "l"(b), "r"(0));
}

#define EDL_ACC16(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),        \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define EDL_OUT16(d)                                                        \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), \
      "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]),        \
      "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
#define EDL_D16                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// The same products with N = 32 (16 accumulator registers a thread).
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " EDL_D16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : EDL_ACC16(d)
      : "l"(a), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_ss_first(float (&d)[16], uint64_t a,
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " EDL_D16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : EDL_OUT16(d)
      : "l"(a), "l"(b), "r"(0));
}

#undef EDL_ACC16
#undef EDL_OUT16
#undef EDL_D16

// d[64 x 64] += A[64 x 16] B[16 x 64], A from registers (four bf16
// pairs per thread), B MN-major in shared memory (transposed read).
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " EDL_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : EDL_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef EDL_ACC32
#undef EDL_OUT32
#undef EDL_D32

// d = A B^T over the depth D: A a [64][D] tile, B the first 2 R rows of
// one (R accumulator registers a thread: 64 x 64 or 64 x 32), both read
// K-major (depth step kk: columns 16 kk .. 16 kk + 15, 32 bytes into a
// panel's rows, the next panel after four steps)
template <int D, int R>
__device__ __forceinline__ void product_ss(float (&d)[R], uint32_t a,
                                           uint32_t b) {
  uint64_t da = tile_desc(a), db = tile_desc(b);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    if (kk == 0)
      wgmma_ss_first(d, da, db);
    else
      wgmma_ss(d, da, db);
    if (kk + 1 < D / 16) {
      const int step = kk % 4 == 3 ? PANEL - 96 : 32;
      advance(da, step);
      advance(db, step);
    }
  }
}

// acc[pn] += A B[:, 64 pn .. 64 pn + 63] over a depth of 16 KS: A the
// bf16 fragments of KS depth steps, B rows of a [64][64 NP] tile read
// MN-major (depth step kk: rows 16 kk .. 16 kk + 15, 2048 bytes on)
template <int NP, int KS>
__device__ __forceinline__ void product_rs(float (&acc)[NP][32],
                                           const uint32_t (&frag)[KS][4],
                                           uint32_t b) {
  uint64_t db = tile_desc(b);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) {
      wgmma_rs_t(acc[pn], frag[kk], db);
      if (kk + 1 < KS || pn + 1 < NP)
        advance(db, pn + 1 < NP ? PANEL : 16 * 128 - (NP - 1) * PANEL);
    }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a,
                                       float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Whether the tile of query positions p0 .. p0 + 63 and keys k0 ..
// k0 + 63 holds a pair that the causal or window mask hides, so that
// its elements must be tested one by one; with segments every tile is.
template <class M>
__device__ __forceinline__ bool straddles(int p0, int k0, int window) {
  if (M::segs) return true;
  bool edge = M::causal && k0 + TB - 1 > p0;
  if (M::window) {
    edge = edge || p0 + TB - 1 - k0 >= window;
    if (!M::causal) edge = edge || k0 + TB - 1 - p0 >= window;
  }
  return edge;
}

template <class M>
__device__ __forceinline__ bool visible(int qp, int kp, int window) {
  return (!M::causal || kp <= qp) &&
         (!M::window || (qp - kp < window && (M::causal || kp - qp < window)));
}

// Raises a kernel's dynamic shared-memory limit once (the launchers'
// `configured` flag is static per instance).
template <typename K>
int set_smem(K kernel, size_t bytes, bool* configured) {
  if (*configured) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  *configured = true;
  return 0;
}

}  // namespace edl_tc
