// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel elasticdl_tpu/ops/attention.py::_flash_kernel
// (launched by _flash_forward through pl.pallas_call). Same function:
// tiled online-softmax attention, causal or not, grouped-query heads
// through kv_head = q_head / group, output in the input dtype and the
// natural-log logsumexp in fp32 (an empty row gets lse = +1e30). The TPU
// kernel's masks are here too: a sliding window (`window` > 0: a query
// at p sees keys p - k < window, and k - p < window when not causal;
// _block_mask_apply) and packed segments (`q_seg` [b, lq] and `k_seg`
// [b, lk] int32 ids, or null: a query sees keys of its own id; the
// kernel body's has_segs branch), and ring attention's `pos_offset`:
// the query rows sit at positions row + pos_offset against keys at
// 0 .. lk - 1 (a rotation that holds a kv shard r shards older than its
// query shard runs at offset r * shard_len; negative r in the
// non-causal band), so the causal and window tests compare the shifted
// query position with the key position (_block_mask_apply). A row that
// sees no key, which a shifted mask can give, writes out 0 and lse
// +1e30.
//
// Rounding. For bf16 inputs the TPU kernel scales q in bf16, q *
// (scale * log2 e) with the constant rounded to bf16 by JAX's weak
// typing (:964), and rounds P to bf16 before P V (_mxu_cast, :981); S,
// the row max, l = rowsum(P) from the unrounded P and the output
// accumulator stay fp32. The bf16 kernel below does the same
// (flash_attention_plain(..., bf16_operands=True) is its plain
// version). fp32 inputs are not rounded (_mxu_cast leaves them), so they
// take the fp32 kernel below, on exact fp32 FMAs: q scaled by scale *
// log2 e in fp32 once, S and P V by FFMA, never a tensor-core or TF32
// product. ViT-Base trains in fp32 and runs it 12 times a step (d = 64,
// not causal). The entry point picks the kernel by dtype, never by a
// failed launch.
//
// What bounds it on the H100: 4 * d operations per visible (query, key)
// pair against 4 * d bytes per row moved (q, k, v read and out written
// once), so from a few hundred rows per head on it is bound by
// operations: by the tensor cores' bf16 rate for bf16, by the CUDA
// cores' fp32 FMA rate (67 TFLOP/s) for fp32.
//
// Design of the bf16 kernel (flash_fwd_tc): one warpgroup a block,
// owning 64 query rows, and 64-key tiles (two warpgroups of 64 rows
// each ran slower: the card gets half as many blocks, PERF.md); both
// products are wgmma.mma_async m64n64k16 with bf16 operands and fp32
// accumulators (flash_tc.cuh, shared with the backward). The block
// stages its Q tile once: loaded, multiplied by
// bf16(scale * log2 e), rounded to bf16 and stored into the 128-byte
// swizzled panels wgmma reads. K and V stream through a two-stage
// cp.async ring (zero-filled past lk), so the next tile's copy overlaps
// this tile's products. S = Q K^T reads both operands K-major from
// shared memory; the online softmax runs in the accumulator registers
// (row max and, at the end, the row sum by quad shuffles; exp2 and the
// correction factor per row), with no shared-memory score tile; P is
// rounded to bf16 straight into the A fragments of O += P V (the
// accumulator layout of a 64 x 64 product is the A layout of its four
// depth steps), with V read MN-major (the transposed descriptor read).
// O stays in fp32 registers (64 x d a block) until it is divided by
// max(l, 1e-30) and stored in bf16; m, l and the correction never leave
// registers. The masks are template parameters (CAUSAL, WINDOW, SEGS,
// OFFSET), so the unmasked instance carries no mask code, and the
// per-element test runs only on the tiles that straddle a mask edge:
// the diagonal, a window edge, the ragged key edge, and every tile when
// SEGS is set; a masked score becomes -inf, so its P is exactly 0. Rows
// past lq load as zeros and are never stored. The grid runs the q tiles
// with the most key tiles first.
//
// Design of the fp32 kernel (flash_fwd_f32). Bound by operations on the
// CUDA cores, it is held back by shared memory first: an SM returns
// about 128 bytes of it to registers a clock against 128 FMA lanes, so a
// thread whose a x b block of a product loads a + b values for a * b
// FMAs a depth step runs at most at ab / (a + b) / 4 of the FMA rate
// (flash_bwd.cu's fp32 kernels, PERF.md). So:
//   * 128 threads (4 warps) own 64 query rows; keys come in 64-row tiles.
//     Each warp owns 16 whole rows: lane l holds rows 8 (l / 16) .. + 7
//     of them, keys 4 (l % 16) .. + 3 of a tile, and features 4 (l % 16)
//     + 64 n, n < d / 64. A thread's block of S is 8 x 4 (ratio 2.67, at
//     most 67% of the FMA rate) and of the O accumulator 8 x 4 at d = 64
//     and 8 x 8 at d = 128 (ratio 4).
//   * Every operand is read as 16-byte float4 loads along the reduction
//     dimension: S = Q K^T reduces over d, along which Q and K rows are
//     contiguous; O += P V reduces over keys: a thread reads each of its
//     P rows as a float4 over 4 keys and each V row as a float4 over its
//     4 features. The Q and P reads are broadcasts (a quarter warp reads
//     one row), the V reads neighbouring chunks; only the K tile is
//     swizzled, not padded: chunk c of key row r lies at c ^ ((r / 4) %
//     8), so the 8 keys a quarter warp reads at once fall into 8 banks.
//   * The row max is a __shfl_xor reduction inside the 16 lanes that
//     hold a row, the correction factor stays in registers, and P goes
//     through a tile that only its warp reads. The block barriers are the
//     copies' alone.
//   * Q is loaded once, multiplied by scale * log2 e in fp32 and stored;
//     K and V stream by cp.async (zero-filled past lk) into one buffer
//     each, staggered: V of a tile is copied while S of the tile runs,
//     K of the next while P V runs. That takes two barriers a tile but
//     half the shared memory of a two-stage ring of both.
//   * Three instances a head dim: no mask code (every mask flag off:
//     ViT's path), the general one, and the general one with the offset.
//     On a tile at a mask edge (the diagonal, a window edge, the ragged
//     key edge, every tile under segments) a thread first finds which of
//     its 32 pairs are visible, as a 32-bit mask, while S's registers are
//     still free; after the product a hidden pair's score becomes -inf,
//     so its P is exactly 0. Interior tiles skip both steps.
//   * Registers: ptxas pipelines the shared-memory loads up to its cap,
//     so the live values are kept few: a row's q segment id is read from
//     global memory (L1) on an edge tile; at d = 64 each lane keeps the
//     rows' max and its own share of their sums in registers, summed at
//     the end; at d = 128, where O takes 64 registers, the rows' max and
//     sum live in shared memory, the sum reduced over the row's lanes
//     every tile. Both head dims run two blocks of 4 warps an SM (65,792
//     and 115,712 bytes of shared memory); ptxas spills nothing and keeps
//     no stack frame (chip_smoke.py checks).
//   * Eight depth chunks of S and 32 (d = 64) or 16 (d = 128) keys of
//     P V are unrolled, the rest is a loop, so the loop stays within the
//     instruction cache.
// Rows past lq load as zeros and are never stored. The grid runs the q
// tiles with the most key tiles first.
//
// Window skip (_kv_stream_clamp, _block_run), both kernels: a q tile
// reads only the key tiles that hold a key inside some row's window,
// from the tile of key p0 - window + 1 up to the diagonal (causal) or to
// key p0 + 64 - 2 + window (not causal), p0 = q0 + pos_offset being the
// tile's first query position, so a windowed row's work grows with the
// window, not the sequence. The offset is folded into p0 once, outside
// the tile loop; the bounds are clamped to [0, lk] before they are
// divided into tiles (C division truncates toward zero), so an offset
// that leaves no visible key runs no tile. Both kernels are compiled
// with and without the offset: a launch at offset 0, every call but a
// ring rotation's, runs an instance without it (one fp32 kernel for both
// ran 6% slower). Segment ids are staged per tile beside K (one id
// row per batch row, shared by every head); as in the TPU kernel, no
// tile is skipped for segments.
//
// Build: this file is compiled as seven objects, one nvcc each, linked
// into one library (ops/_build.py, PARTS): EDL_PART 0 holds the entry
// points, parts 1-4 the 8 mask instances (window, segments, offset) of
// one (head dim, causal) of the bf16 kernel each, parts 5 and 6 the
// three fp32 instances of d = 64 and of d = 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tc.cuh"

#ifndef EDL_PART
#define EDL_PART 0
#endif

// What the entry point passes to the parts' launchers.
namespace edl_fwd {

struct Args {
  const void *q, *k, *v;
  void *o, *lse;
  const int *q_seg, *k_seg;
  int b, h, hkv, lq, lk;
  float scale;
  int causal, window, pos_offset;
  cudaStream_t stream;
};

// The bf16 launcher of one (head dim, causal), defined by its part; it
// picks the mask instance from the runtime flags.
template <int D, bool CAUSAL>
int launch_part(const Args& a);
template <> int launch_part<64, false>(const Args&);
template <> int launch_part<64, true>(const Args&);
template <> int launch_part<128, false>(const Args&);
template <> int launch_part<128, true>(const Args&);

// The fp32 launcher of one head dim: parts 5 (d = 64) and 6 (d = 128).
template <int D>
int launch_f32(const Args& a);
template <> int launch_f32<64>(const Args&);
template <> int launch_f32<128>(const Args&);

// The fp32 kernel's block: 128 threads, 64 query rows, 64-key tiles, and
// its dynamic shared memory in bytes: the Q, K and V tiles [64][D], the
// warps' P rows [64][64], the key tile's segment ids [64] and, at d =
// 128 (SHARED_ROWS), the rows' running max and sum [2][64].
template <int D>
struct F32Shape {
  static constexpr int NT = 128, ROWS = 64, KEYS = 64;
  static constexpr bool SHARED_ROWS = D == 128;
  static constexpr size_t smem =
      4 * (3 * ROWS * D + ROWS * KEYS + KEYS + (SHARED_ROWS ? 2 * ROWS : 0));
};

}  // namespace edl_fwd

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Dynamic shared memory of a bf16 block: a [64][D] bf16 Q tile, a ring
// of two stages of K and V tiles, two stages of 64 key segment ids, and
// 1024 bytes of slack to align the tiles to the 128-byte swizzle's
// 1024-byte period.
template <int D>
constexpr size_t tc_smem_bytes() {
  return 5 * (64 * D * 2) + 1024 + 2 * 64 * 4;
}

}  // namespace

// ---------------------------------------------------------------------------
// The entry points: part 0.
#if EDL_PART == 0

// q [b, h, lq, d], k/v [b, hkv, lk, d], o like q, lse [b, h, lq] fp32;
// q_seg [b, lq] and k_seg [b, lk] int32 segment ids, or both NULL; all
// contiguous, q, k, v and o 16-byte aligned. window: 0 = none, else the
// sliding window (lq == lk). pos_offset: the shift of the query
// positions (any int; 0 = none). dtype: 0 = float32 (the fp32 FFMA
// kernel), 1 = bfloat16 (the tensor-core kernel). Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int edl_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, const void* q_seg,
                             const void* k_seg, int b, int h, int hkv,
                             int lq, int lk, int d, float scale, int causal,
                             int window, int pos_offset, int dtype,
                             void* stream) {
  if (hkv <= 0 || h % hkv != 0 || window < 0 ||
      (q_seg == nullptr) != (k_seg == nullptr))
    return (int)cudaErrorInvalidValue;
  const edl_fwd::Args a{q, k, v, o, lse,
                        static_cast<const int*>(q_seg),
                        static_cast<const int*>(k_seg), b, h, hkv, lq, lk,
                        scale, causal, window, pos_offset,
                        static_cast<cudaStream_t>(stream)};
  using edl_fwd::launch_f32;
  using edl_fwd::launch_part;
  if (dtype == 0 && d == 64) return launch_f32<64>(a);
  if (dtype == 0 && d == 128) return launch_f32<128>(a);
  if (dtype == 1 && d == 64)
    return causal ? launch_part<64, true>(a) : launch_part<64, false>(a);
  if (dtype == 1 && d == 128)
    return causal ? launch_part<128, true>(a) : launch_part<128, false>(a);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block in bytes of the kernel for dtype
// (0 float32, 1 bfloat16) and d; -1 where there is none. Reporting only.
extern "C" int edl_flash_fwd_smem_bytes(int dtype, int d) {
  using edl_fwd::F32Shape;
  if (dtype == 1 && (d == 64 || d == 128))
    return (int)(d == 64 ? tc_smem_bytes<64>() : tc_smem_bytes<128>());
  if (dtype == 0 && (d == 64 || d == 128))
    return (int)(d == 64 ? F32Shape<64>::smem : F32Shape<128>::smem);
  return -1;
}

#endif  // EDL_PART == 0

// ---------------------------------------------------------------------------
// The fp32 kernel: FFMA, part 5 d = 64, part 6 d = 128.
#if EDL_PART == 5 || EDL_PART == 6
namespace {

using edl_fwd::F32Shape;
using edl_tc::axpy4;
using edl_tc::cp_async16;
using edl_tc::cp_async_commit;
using edl_tc::cp_async_wait_all;
using edl_tc::dot4;
using edl_tc::f32_straddles;
using edl_tc::f32_visible;
using edl_tc::ld4;
using edl_tc::set_smem;
using edl_tc::smem_u32;

constexpr int NT = 128, FR = 64, KN = 64;  // F32Shape's

// Keys [k0, k0 + KN) of a row-major [lk, D] fp32 matrix into a [KN][D]
// shared tile with cp.async, 16 bytes a thread; keys past lk are
// zero-filled. SWZ: K's swizzle (chunk c of row r at c ^ ((r / 4) % 8)).
template <int D, bool SWZ>
__device__ __forceinline__ void stage_keys(float* dst, const float* src,
                                           int k0, int lk) {
  constexpr int CPR = D / 4;  // chunks per row
#pragma unroll
  for (int n = 0; n < KN * CPR / NT; ++n) {
    const int i = threadIdx.x + NT * n;
    const int r = i / CPR, c = i % CPR;
    const bool in = k0 + r < lk;
    cp_async16(smem_u32(dst + r * D + ((SWZ ? c ^ ((r >> 2) & 7) : c) << 2)),
               src + (size_t)(in ? k0 + r : 0) * D + 4 * c, in ? 16u : 0u);
  }
}

// The Q tile, rows q0 .. q0 + 63 of a [lq, D] matrix, multiplied by c in
// fp32, into a [FR][D] shared tile; rows past lq are zero.
template <int D>
__device__ __forceinline__ void stage_q(float* dst, const float* src, int q0,
                                        int lq, float c) {
  constexpr int CPR = D / 4;
#pragma unroll
  for (int n = 0; n < FR * CPR / NT; ++n) {
    const int i = threadIdx.x + NT * n;
    const int r = i / CPR, cc = i % CPR;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < lq) {
      x = ld4(src + (size_t)(q0 + r) * D + 4 * cc);
      x = make_float4(x.x * c, x.y * c, x.z * c, x.w * c);
    }
    *reinterpret_cast<float4*>(dst + r * D + 4 * cc) = x;
  }
}

// s = the thread's 8 x 4 block of Q K^T: its rows of the Q tile (qrow:
// the first), its keys of the swizzled K tile (krow: the first key's
// row; sw its swizzle, the same for the 4), over the depth D. Eight
// chunks of depth are unrolled, the rest is a loop.
template <int D>
__device__ __forceinline__ void scores(float (&s)[8][4], const float* qrow,
                                       const float* krow, int sw) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 1
  for (int hi = 0; hi < D; hi += 32) {  // chunks hi / 4 .. hi / 4 + 7
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      float4 kf[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kf[j] = ld4(krow + j * D + hi + ((u ^ sw) << 2));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 a = ld4(qrow + i * D + hi + 4 * u);
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dot4(a, kf[j], s[i][j]);
      }
    }
  }
}

// acc += the thread's rows of P (prow: its first row of the warp's P
// tile) times V (vcol: its first feature of the V tile), over the KN
// keys; NC float4s of features a row. 4 * PU keys are unrolled.
template <int D>
__device__ __forceinline__ void pv(float (&acc)[8][D / 64][4],
                                   const float* prow, const float* vcol) {
  constexpr int NC = D / 64, PU = D == 64 ? 8 : 4;
#pragma unroll 1
  for (int k4 = 0; k4 < KN; k4 += 4 * PU) {
#pragma unroll
    for (int u = 0; u < PU; ++u) {
      const int kk = k4 + 4 * u;  // keys kk .. kk + 3
      float4 y[NC][4];
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int t = 0; t < 4; ++t) y[n][t] = ld4(vcol + (kk + t) * D + 64 * n);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 x = ld4(prow + i * KN + kk);
#pragma unroll
        for (int n = 0; n < NC; ++n) axpy4(acc[i][n], x, y[n]);
      }
    }
  }
}

// GEN: the general instance (the masks from the runtime flags; OFFSET:
// with pos_offset); otherwise no mask code, only the ragged key edge.
template <int D, bool GEN, bool OFFSET>
__global__ void __launch_bounds__(NT, 2)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, const int* __restrict__ q_seg,
                  const int* __restrict__ k_seg, int h, int hkv, int lq,
                  int lk, float scale, int causal_arg, int window_arg,
                  int pos_offset) {
  constexpr int NC = D / 64;
  constexpr bool SHARED_ROWS = F32Shape<D>::SHARED_ROWS;
  extern __shared__ __align__(16) float smem_f32[];
  float* qs = smem_f32;                                // [FR][D], scaled
  float* ks = qs + FR * D;                             // [KN][D], swizzled
  float* vs = ks + KN * D;                             // [KN][D]
  float* ps = vs + KN * D;                             // [FR][KN]
  int* ks_seg = reinterpret_cast<int*>(ps + FR * KN);  // [KN]
  float* row_m = reinterpret_cast<float*>(ks_seg + KN);  // [FR] (d = 128)
  float* row_l = row_m + FR;                             // [FR] (d = 128)

  const bool causal = GEN && causal_arg != 0;
  const int window = GEN ? window_arg : 0;
  const bool segs = GEN && q_seg != nullptr;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FR;  // longest rows first
  const int b = bh / h;
  const int kvh = (bh % h) / (h / hkv);
  const size_t q_off = (size_t)bh * lq * D;
  const float* kb = k + (size_t)(b * hkv + kvh) * lk * D;
  const float* vb = v + (size_t)(b * hkv + kvh) * lk * D;
  const int p0 = q0 + (OFFSET ? pos_offset : 0);

  // the key tiles some row of the tile can see (_kv_stream_clamp)
  int k_lo = 0, k_end = causal ? min(lk, p0 + FR) : lk;
  if (window > 0) {
    k_lo = max(0, p0 - window + 1);
    if (!causal) k_end = min(lk, p0 + FR - 1 + window);
  }
  k_end = max(k_end, 0);
  const int kt_lo = k_lo / KN, kt_end = (k_end + KN - 1) / KN;

  auto stage_k = [&](int kt) {
    stage_keys<D, true>(ks, kb, kt * KN, lk);
    if (segs && tid < KN) {
      const int kp = kt * KN + tid;
      ks_seg[tid] = kp < lk ? k_seg[(size_t)b * lk + kp] : -1;
    }
  };
  if (kt_lo < kt_end) stage_k(kt_lo);
  cp_async_commit();
  stage_q<D>(qs, q + q_off, q0, lq, scale * LOG2E);

  // the thread's rows r0 .. r0 + 7, keys 4 c4 .. 4 c4 + 3 of a tile and
  // features 4 c4 + 64 n; sw: its keys' swizzle, (4 c4 + j) / 4 % 8
  const int r0 = 16 * warp + 8 * (lane / 16), c4 = lane % 16, sw = lane & 7;
  const float* qrow = qs + r0 * D;
  const float* krow = ks + 4 * c4 * D;
  float* prow = ps + r0 * KN;
  const float* vcol = vs + 4 * c4;

  float acc[8][NC][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][n][j] = 0.f;
  // the rows' running max m and sum l: in registers, each lane its share
  // of l, summed at the end; at d = 128, where O takes 64 registers, in
  // shared memory, l summed over the row's lanes every tile
  float m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  if (SHARED_ROWS && c4 == 0)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      row_m[r0 + i] = NEG_INF;
      row_l[r0 + i] = 0.f;
    }
  for (int kt = kt_lo; kt < kt_end; ++kt) {
    const int k0 = kt * KN;
    cp_async_wait_all();
    __syncthreads();  // K (and Q) landed; the last tile's V readers done
    stage_keys<D, false>(vs, vb, k0, lk);
    cp_async_commit();

    // at a mask edge, which of the thread's pairs are visible (bit 4 i +
    // j), found before the product, while S's registers are free
    const bool edge = k0 + KN > lk ||
        (GEN && f32_straddles(p0, FR, k0, KN, causal, window, segs));
    uint32_t seen = ~0u;
    if (edge) {
      seen = 0u;
      const int4 ksg = segs ? *reinterpret_cast<const int4*>(ks_seg + 4 * c4)
                            : make_int4(0, 0, 0, 0);
      const int kseg[4] = {ksg.x, ksg.y, ksg.z, ksg.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = q0 + r0 + i;
        const int qseg = segs && r < lq ? q_seg[(size_t)b * lq + r] : -1;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kp = k0 + 4 * c4 + j;
          bool vis = kp < lk;
          if (GEN)
            vis = vis && f32_visible(p0 + r0 + i, kp, causal, window) &&
                  (!segs || qseg == kseg[j]);
          seen |= (uint32_t)vis << (4 * i + j);
        }
      }
    }

    float s[8][4];
    scores<D>(s, qrow, krow, sw);  // S = Q K^T, log2 units
    if (edge) {
      const float neg_inf = __int_as_float(0xff800000);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (!((seen >> (4 * i + j)) & 1u)) s[i][j] = neg_inf;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int x = 1; x < 16; x <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
      const float m_old = SHARED_ROWS ? row_m[r0 + i] : m[i];
      const float m_new = fmaxf(m_old, mx);
      const float corr = exp2f(m_old - m_new);
      float p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) p[j] = exp2f(s[i][j] - m_new);
      float sum = (p[0] + p[1]) + (p[2] + p[3]);
      if (SHARED_ROWS) {
#pragma unroll
        for (int x = 1; x < 16; x <<= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, x);
        l[i] = row_l[r0 + i] * corr + sum;  // stored below
      } else {
        l[i] = l[i] * corr + sum;
      }
      m[i] = m_new;
      *reinterpret_cast<float4*>(prow + i * KN + 4 * c4) =
          make_float4(p[0], p[1], p[2], p[3]);
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][n][j] *= corr;
    }
    if (SHARED_ROWS) {
      __syncwarp();  // the row's lanes have read the old m and l
      if (c4 == 0)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          row_m[r0 + i] = m[i];
          row_l[r0 + i] = l[i];
        }
    }
    cp_async_wait_all();
    __syncthreads();  // V landed; K's readers and the P rows are done
    if (kt + 1 < kt_end) stage_k(kt + 1);
    cp_async_commit();
    pv<D>(acc, prow, vcol);  // O += P V
  }
  cp_async_wait_all();  // a block that ran no tile still has copies out
  if (SHARED_ROWS) __syncwarp();  // the last tile's m and l are stored

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float sum = SHARED_ROWS ? row_l[r0 + i] : l[i];
    const float mi = SHARED_ROWS ? row_m[r0 + i] : m[i];
    if (!SHARED_ROWS)
#pragma unroll
      for (int x = 1; x < 16; x <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, x);
    const int r = q0 + r0 + i;
    if (r >= lq) continue;
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    float* orow = o + q_off + (size_t)r * D + 4 * c4;
#pragma unroll
    for (int n = 0; n < NC; ++n)
      *reinterpret_cast<float4*>(orow + 64 * n) =
          make_float4(acc[i][n][0] * inv, acc[i][n][1] * inv,
                      acc[i][n][2] * inv, acc[i][n][3] * inv);
    if (c4 == 0)
      lse[(size_t)bh * lq + r] = sum > 0.f ? (mi + log2f(sum)) * LN2
                                           : -NEG_INF;
  }
}

template <int D, bool GEN, bool OFFSET>
int launch_f32_instance(const edl_fwd::Args& a) {
  constexpr size_t smem = F32Shape<D>::smem;
  static bool configured = false;
  int err = set_smem(flash_fwd_f32<D, GEN, OFFSET>, smem, &configured);
  if (err) return err;
  dim3 grid(a.b * a.h, (a.lq + FR - 1) / FR);
  flash_fwd_f32<D, GEN, OFFSET><<<grid, NT, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o),
      static_cast<float*>(a.lse), a.q_seg, a.k_seg, a.h, a.hkv, a.lq, a.lk,
      a.scale, a.causal, a.window, a.pos_offset);
  return (int)cudaGetLastError();
}

// the instance with no mask code when every mask flag is off
template <int D>
int launch_f32_fwd(const edl_fwd::Args& a) {
  if (a.pos_offset != 0) return launch_f32_instance<D, true, true>(a);
  const bool general = a.causal != 0 || a.window > 0 || a.q_seg != nullptr;
  return general ? launch_f32_instance<D, true, false>(a)
                 : launch_f32_instance<D, false, false>(a);
}

}  // namespace

namespace edl_fwd {
#if EDL_PART == 5
template <> int launch_f32<64>(const Args& a) { return launch_f32_fwd<64>(a); }
#else
template <> int launch_f32<128>(const Args& a) {
  return launch_f32_fwd<128>(a);
}
#endif
}  // namespace edl_fwd

#endif  // EDL_PART 5, 6

// ---------------------------------------------------------------------------
// The bf16 kernel: wgmma on tensor cores, parts 1-4.
#if EDL_PART >= 1 && EDL_PART <= 4
namespace {

using namespace edl_tc;

// The [64][D] Q tile of rows q0 .. q0 + 63 into shared memory as wgmma
// reads it (load_tile's swizzled panels), each element multiplied by the
// bf16 constant c in fp32 (exact: two 8-bit mantissas) and rounded to
// bf16, as the TPU kernel's bf16 product is; rows past lq are zero. The
// block's one warpgroup shares the copy.
template <int D>
__device__ __forceinline__ void stage_q(unsigned char* dst,
                                        const __nv_bfloat16* src, int q0,
                                        int lq, float c) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int n = 0; n < TB * CPR / WG; ++n) {
    const int i = threadIdx.x + WG * n;
    const int r = i / CPR, cc = i % CPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < lq) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(q0 + r) * D +
                                            cc * 8);
      uint32_t* w = reinterpret_cast<uint32_t*>(&val);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f =
            __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[e]));
        w[e] = pack_bf16(f.x * c, f.y * c);
      }
    }
    *reinterpret_cast<uint4*>(dst + (cc / 8) * PANEL + r * 128 +
                              (((cc % 8) ^ (r % 8)) << 4)) = val;
  }
}

// The key tiles [lo, end) that hold a key some row of the 64-row q tile
// at positions p0 .. p0 + 63 can see under the causal and window masks
// (_kv_stream_clamp); the bounds are clamped to [0, lk] before they are
// divided into tiles.
template <class M>
__device__ __forceinline__ void key_tiles(int p0, int lk, int window,
                                          int& lo, int& end) {
  int k_lo = 0, k_end = M::causal ? min(lk, p0 + TB) : lk;
  if (M::window) {
    k_lo = max(0, p0 - window + 1);
    if (!M::causal) k_end = min(lk, p0 + TB - 1 + window);
  }
  k_end = max(k_end, 0);
  lo = k_lo / TB;
  end = (k_end + TB - 1) / TB;
}

// One tile's online-softmax step in the accumulator registers. S (log2
// units, element i of a thread: row r0 + 8 * (i % 4 / 2), column
// 8 * (i / 4) + cq + i % 2) is masked where EDGE (a hidden pair's score
// becomes -inf, so its P is exactly 0), the rows' running max m moves
// to m_new = max(m, rowmax S) (quad shuffles: the four lanes of a quad
// hold one row's columns), corr = exp2(m - m_new), l = l * corr + the
// thread's share of rowsum(P) with P = exp2(S - m_new) unrounded, and P
// is rounded to bf16 into the A fragments of O += P V: frag[kk][r]
// packs elements 8 kk + 2 r and 8 kk + 2 r + 1, the A layout of depth
// step kk. qp0 is the position of row r0.
template <class M, bool EDGE>
__device__ __forceinline__ void softmax_step(
    float (&sacc)[32], uint32_t (&frag)[4][4], float (&m)[2], float (&l)[2],
    float (&corr)[2], const int (&qseg)[2], const int* kseg, int cq,
    int qp0, int k0, int lk, int window) {
  if (EDGE) {
    const float neg_inf = __int_as_float(0xff800000);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int rr = (i >> 1) & 1, col = 8 * (i / 4) + cq + (i & 1);
      const int kp = k0 + col;
      if (!(kp < lk && visible<M>(qp0 + 8 * rr, kp, window) &&
            (!M::segs || qseg[rr] == kseg[col])))
        sacc[i] = neg_inf;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int rr = (i >> 1) & 1;
    mx[rr] = fmaxf(mx[rr], sacc[i]);
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
    corr[rr] = exp2f(m[rr] - mx[rr]);
    m[rr] = mx[rr];
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 8 * kk + 2 * r, rr = r & 1;
      const float p0 = exp2f(sacc[i] - mx[rr]);
      const float p1 = exp2f(sacc[i + 1] - mx[rr]);
      sum[rr] += p0 + p1;
      frag[kk][r] = pack_bf16(p0, p1);
    }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) l[rr] = l[rr] * corr[rr] + sum[rr];
}

template <int D, class M>
__global__ void __launch_bounds__(WG) flash_fwd_tc(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, const int* __restrict__ q_seg,
    const int* __restrict__ k_seg, int h, int hkv, int lq, int lk,
    float scale, int window, int pos_offset) {
  constexpr int TILE = TB * D * 2;  // bytes of a [64][D] bf16 tile
  constexpr int NP = D / 64;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sp = smem_raw + (base - raw);
  const uint32_t qs = base, kv_ring = base + TILE;  // stage s: K, then V
  int* ks_seg = reinterpret_cast<int*>(sp + 5 * TILE);  // [2][TB]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x;
  // the q tiles with the most key tiles (the last, causal) first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TB;
  const int b = bh / h;
  const int kvh = (bh % h) / (h / hkv);
  const size_t q_off = (size_t)bh * lq * D;
  const __nv_bfloat16* kb = k + (size_t)(b * hkv + kvh) * lk * D;
  const __nv_bfloat16* vb = v + (size_t)(b * hkv + kvh) * lk * D;
  const int p0 = q0 + (M::offset ? pos_offset : 0);
  int kt_lo, kt_end;
  key_tiles<M>(p0, lk, window, kt_lo, kt_end);

  auto stage_kv = [&](int s, int kt) {
    load_tile<D>(kv_ring + 2 * s * TILE, kb, kt * TB, lk);
    load_tile<D>(kv_ring + (2 * s + 1) * TILE, vb, kt * TB, lk);
    if (M::segs && tid < TB) {
      const int kp = kt * TB + tid;
      ks_seg[s * TB + tid] = kp < lk ? k_seg[(size_t)b * lk + kp] : -1;
    }
  };
  if (kt_lo < kt_end) stage_kv(0, kt_lo);
  cp_async_commit();
  stage_q<D>(sp, q + q_off, q0, lq,
             __bfloat162float(__float2bfloat16_rn(scale * LOG2E)));

  const int r0 = warp * 16 + lane / 4, cq = 2 * (lane % 4);
  int qseg[2] = {-1, -1};
  if (M::segs) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = q0 + r0 + 8 * rr;
      if (r < lq) qseg[rr] = q_seg[(size_t)b * lq + r];
    }
  }

  float acc[NP][32];
#pragma unroll
  for (int pn = 0; pn < NP; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[pn][i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  for (int kt = kt_lo; kt < kt_end; ++kt) {
    const int s = (kt - kt_lo) & 1;
    const uint32_t ks = kv_ring + 2 * s * TILE, vs = ks + TILE;
    cp_async_wait_all();
    fence_async_smem();  // orders Q's stores and the copies before wgmma
    __syncthreads();  // tile kt landed; stage s ^ 1's readers are done
    if (kt + 1 < kt_end) stage_kv(s ^ 1, kt + 1);
    cp_async_commit();

    float sacc[32];
    wgmma_fence();
    product_ss<D, 32>(sacc, qs, ks);  // S = Q K^T, log2 units
    wgmma_commit();
    wgmma_wait_all();
    keep(sacc);

    const int k0 = kt * TB;
    uint32_t frag[4][4];
    float corr[2];
    if (k0 + TB > lk || straddles<M>(p0, k0, window))
      softmax_step<M, true>(sacc, frag, m, l, corr, qseg, ks_seg + s * TB,
                            cq, p0 + r0, k0, lk, window);
    else
      softmax_step<M, false>(sacc, frag, m, l, corr, qseg, ks_seg + s * TB,
                             cq, p0 + r0, k0, lk, window);
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[pn][i] *= corr[(i >> 1) & 1];
    wgmma_fence();
    product_rs<NP, 4>(acc, frag, vs);  // O += P V
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) keep(acc[pn]);
  }
  cp_async_wait_all();  // a block that ran no tile still has copies out

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float sum = l[rr];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int r = q0 + r0 + 8 * rr;
    if (r >= lq) continue;
    const float den = fmaxf(sum, 1e-30f);
    __nv_bfloat16* row = o + q_off + (size_t)r * D;
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        store2(row + 64 * pn + 8 * j + cq, acc[pn][4 * j + 2 * rr] / den,
               acc[pn][4 * j + 2 * rr + 1] / den);
    if (cq == 0)
      lse[(size_t)bh * lq + r] =
          sum > 0.f ? (m[rr] + log2f(sum)) * LN2 : -NEG_INF;
  }
}

template <int D, class M>
int launch_tc(const edl_fwd::Args& a) {
  constexpr size_t smem = tc_smem_bytes<D>();
  static bool configured = false;
  using bf = __nv_bfloat16;
  int err = set_smem(flash_fwd_tc<D, M>, smem, &configured);
  if (err) return err;
  dim3 grid(a.b * a.h, (a.lq + TB - 1) / TB);
  flash_fwd_tc<D, M><<<grid, WG, smem, a.stream>>>(
      static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
      static_cast<const bf*>(a.v), static_cast<bf*>(a.o),
      static_cast<float*>(a.lse), a.q_seg, a.k_seg, a.h, a.hkv, a.lq, a.lk,
      a.scale, a.window, a.pos_offset);
  return (int)cudaGetLastError();
}

// The runtime mask flags -> the instance compiled for them.
template <int D, bool... B>
struct MaskDispatch {
  static int run(const edl_fwd::Args& a) {
    return launch_tc<D, Masks<B...>>(a);
  }
  template <typename... R>
  static int run(const edl_fwd::Args& a, bool x, R... rest) {
    return x ? MaskDispatch<D, B..., true>::run(a, rest...)
             : MaskDispatch<D, B..., false>::run(a, rest...);
  }
};

}  // namespace

#define EDL_TC_PART(D, CAUSAL)                                            \
  namespace edl_fwd {                                                     \
  template <>                                                             \
  int launch_part<D, CAUSAL>(const Args& a) {                             \
    return MaskDispatch<D, CAUSAL>::run(a, a.window > 0,                  \
                                        a.q_seg != nullptr,               \
                                        a.pos_offset != 0);               \
  }                                                                       \
  }
#if EDL_PART == 1
EDL_TC_PART(64, false)
#elif EDL_PART == 2
EDL_TC_PART(64, true)
#elif EDL_PART == 3
EDL_TC_PART(128, false)
#elif EDL_PART == 4
EDL_TC_PART(128, true)
#endif
#undef EDL_TC_PART

#endif  // EDL_PART 1-4
