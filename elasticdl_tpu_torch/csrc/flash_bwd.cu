// Flash-attention backward for Hopper (sm_90a): two kernels.
//
// Replace the TPU kernels of elasticdl_tpu/ops/attention.py::_flash_backward:
//   * dq pass  <- _flash_bwd_dq_kernel  (pl.pallas_call at :1415)
//   * dkv pass <- _flash_bwd_dkv_kernel (pl.pallas_call at :1446)
// Same function: the standard two-pass flash backward that recomputes the
// probabilities from the forward's saved logsumexp,
//   P = exp(q k^T * scale - lse), dP = dO V^T, delta = rowsum(dO * O),
//   dS = P * (dP - delta) * scale,
//   dQ = dS K, dK = dS^T Q, dV = P^T dO,
// causal or not, grouped-query heads (kv_head = q_head / group), ragged
// lengths, head_dim 64 and 128, fp32 or bf16 in and out, fp32 inside,
// under the forward's masks: a sliding window (`window` > 0) and packed
// segment ids (`q_seg` [b, lq], `k_seg` [b, lk], or null; has_segs in the
// TPU kernels), and ring attention's `pos_offset`, the shift of the
// query positions (row + pos_offset) against the keys' (0 .. lk - 1) in
// the causal and window tests, any int (the TPU kernels' pos_offset,
// :1257, :1268, :1315, :1325). A ring rotation passes the ring's global
// lse, so a row that sees no key of the held shard but has a finite lse
// gets P = 0 from the mask and contributes nothing. The gradients come
// out in the input dtype or, with `grad_f32`, in fp32 (the ring sums
// each rotation's partial in fp32, as JAX's grad_dtype=f32 does).
// P is exactly 0 at masked pairs and on rows whose lse is a
// sentinel of either sign: the +1e30 of an empty row from the port's
// forward, or the -1e30 class the TPU forward gives a row the segment
// pair form masks fully (zeroed there too, :1277 and :1332), so dK and
// dV of a key that no query sees are exactly 0.
//
// Rounding. For bf16 inputs P and dS are rounded to bf16 before the
// second products (dV = P^T dO, dQ = dS K, dK = dS^T Q), as the TPU
// kernels' _mxu_cast (:927) does when the other operand is bf16; S, dP,
// delta and the three accumulators stay fp32. fp32 inputs are not
// rounded (_mxu_cast leaves them), so they take the fp32 kernels below,
// on exact fp32 FMAs: bf16 or TF32 tensor cores would miss the fp32
// limit of 1e-4. ViT-Base trains in fp32 and runs them 12 times a step
// each (d = 64, not causal). The entry points pick the kernels by dtype,
// never by a failed launch.
//
// What bounds them on the H100: at the training shapes (b = 8, h = 8,
// l = 1024, d = 128, causal) the dq pass does 6 * d operations per
// visible (query, key) pair and the dk/dv pass 8 * d, against a few
// bytes per row moved, so both are bound by operations: by the tensor
// cores' bf16 rate for bf16, by the fp32 FMA rate of the CUDA cores
// (67 TFLOP/s) for fp32 (ViT-Base's b = 64, h = 12, l = 256, d = 64 as
// well).
//
// Design of the bf16 kernels (flash_bwd_dq_tc, flash_bwd_dkv_tc): one
// warpgroup (128 threads) per block and 64 x 64 tiles; every product is
// a wgmma.mma_async m64n64k16 with bf16 operands and fp32 accumulators.
// Tiles are copied with cp.async (16 bytes a thread, zero-filled past
// the ragged edge) into shared memory in the 128-byte-swizzled layout
// wgmma reads (D / 64 panels of 64 rows x 128 bytes), and a ring of two
// stages keeps the next tile's copy in flight while the current tile's
// products run.
//   dq:  grid (b*h, q tile), the q tiles with the most key tiles first.
//        Q and dO are staged once; delta = rowsum(dO * O) is computed
//        from global memory while they land and written out for the dk/dv
//        pass (the TPU code computes it with a jnp sum before the
//        kernels). K and V stream through the ring: S = Q K^T and
//        dP = dO V^T with both operands from shared memory, K-major;
//        P = exp2(S * scale * log2e - lse * log2e) and dS in the
//        accumulator registers, converted in registers to the bf16 A
//        fragments of dQ += dS K (the accumulator layout of a 64 x 64
//        product is the A layout of four depth steps), with B = the K
//        tile read MN-major (the transposed descriptor read).
//   dkv: grid (b*hkv, key tile), key tile 0 (the longest walk) first. K
//        and V are staged once; the block walks every (q head of the
//        group, q tile) pair, as the TPU grid's streamed axis does
//        (_dkv_q_spec), Q, dO and their lse and delta rows streaming
//        through the ring. It computes the transposed scores S^T = K Q^T
//        and dP^T = V dO^T directly, turns P^T and dS^T into bf16 A
//        fragments, and adds dV += P^T dO and dK += dS^T Q with B = the
//        dO and Q tiles read MN-major, half a q tile (32 rows, m64n32
//        products) at a time: at d = 128 the dK and dV accumulators take
//        128 registers a thread, and a whole tile's S^T and dP^T beside
//        them made the masked instances spill. dK and dV accumulate in
//        registers across the whole group, so they come out group-summed
//        without atomics and are deterministic.
// Rows past lq or lk load as zeros and take an lse of +1e30 (P = 0);
// stores are masked at the edge. The masks are template parameters
// (CAUSAL, WINDOW, SEGS, OFFSET), so the unmasked instance carries no
// mask code, and in every instance the per-element test runs only on the
// tiles that straddle a mask edge: the diagonal, a window edge, the
// ragged key edge of the dq pass (the dk/dv pass never stores a key row
// past lk, and a query row past lq has P = 0), and every tile when SEGS
// is set. Interior tiles skip it.
// Resources (ptxas of CUDA 12.8 for sm_90a; chip_smoke.py prints them for
// every instance): dq 128-203 registers at d = 64 and 196-219 at
// d = 128, dk/dv 142-167 and 233-255, no spills; 51,712 bytes of shared
// memory a block at d = 64 and 100,864 at d = 128; so 2 blocks per SM
// (3 for dk/dv at d = 64), 8 warps, bound by registers and, at d = 128,
// by shared memory as well.
//
// Design of the fp32 kernels (flash_bwd_dq_f32, flash_bwd_dkv_f32): the
// same two passes, grids, walks, ring and tile skips as the bf16 kernels,
// on exact fp32 FMAs (FFMA), so bound by operations: the CUDA cores'
// fp32 rate. What keeps a product from it is shared memory: an SM
// returns about 128 bytes of it to registers a clock (one warp-wide
// 4-byte load, a quarter of a 16-byte one, broadcast or not) against 128
// FMA lanes, so a thread's a x b block of a product, which loads a + b
// values for a * b FMAs a depth step, runs at most at ab / (a + b) / 4 of
// the FMA rate. The design raises that ratio and wastes no load:
//   * 2 * d threads a block (4 warps at d = 64, 8 at d = 128) over 64
//     own rows (q rows in dq, keys in dk/dv) and SN = 64 streamed rows a
//     step (keys, q rows). A thread holds an 8 x SC block of S and of dP
//     (SC = 4 at d = 64: ratio 2.67; 2 at d = 128) and an 8 x 4 block of
//     each output accumulator (dQ, or dV and dK; ratio 2.67). Warp w owns
//     rows 32 (w % 2) .. + 31, lane l rows 8 (l / 8) .. + 7, score
//     columns 8 SC (w / 2) + SC (l % 8) and features 32 (w / 2) +
//     4 (l % 8).
//   * Every operand is read as 16-byte float4 loads along the reduction
//     dimension, which is contiguous in every tile (P and dS are stored
//     transposed for dk/dv), so a load is one instruction for 4 values.
//   * Shared tiles are swizzled, not padded: the 16-byte chunk c of row r
//     lies at c ^ swz(r) (swz<SC>), so the rows a warp reads at once
//     (8 lr + i over lr; SC lc + j over lc) and the chunks of one row
//     (the features of the dQ, dV, dK products) fall into different
//     banks. Each thread keeps the swizzled offsets of its rows in
//     registers (Lanes), so a load costs no address arithmetic.
//   * Operand tiles are copied with cp.async into a ring of two stages,
//     so the next step's copy runs under the current step's products:
//     K and V in dq, Q and dO in dk/dv.
//   * S and dP are two products one after the other (their registers
//     then hold P and dS), which leaves ptxas registers for its load
//     pipelining without spilling; eight depth chunks are unrolled and
//     the rest is a loop, so a kernel's loop stays within the instruction
//     cache (unrolled fully, d = 128's dk/dv ran 21% slower).
//   * P and dS go through shared memory once a step, as 16-byte (8-byte
//     at d = 128) stores into a swizzled [64][SN] tile, since the second
//     products reduce over the streamed rows that other threads hold. In
//     dk/dv one tile carries P^T for dV += P^T dO, then dS^T for dK +=
//     dS^T Q, and each step's lse and delta are read from global memory
//     into registers, so that two blocks fit an SM at d = 64; dq passes
//     its rows' lse and delta through the dS tile once, into registers.
//   * The masks are a template parameter: an instance with no mask code
//     (runtime flags all off: ViT's path) and a general one whose
//     per-element test runs only on the tiles at a mask edge. Both test
//     the ragged key edge of the dq pass.
// Shared memory a block: 115,200 (dq) and 114,688 (dk/dv) bytes at d =
// 64, two blocks of 4 warps an SM; 213,504 and 212,992 at d = 128, one
// block of 8 warps. chip_smoke.py prints the instances' registers and
// checks their SASS for tensor-core products and 16-bit or TF32
// conversions (there are none).
//
// Both designs skip fully masked tiles (never loaded), as _block_run
// skips them: the dq pass walks the key tiles of the forward's window
// range (_kv_stream_clamp), the dk/dv pass, per key tile and group member,
// the q tiles from the first that reaches the tile (causal: the
// diagonal; window, not causal: key k0 - window + 1) to the last whose
// window holds one of its keys (_q_stream_clamp), all shifted by
// pos_offset. The offset is folded into each tile's first query position
// once, outside the inner loops; the bounds are clamped to [0, lk] or
// [0, lq] before they are divided into tiles (C division truncates
// toward zero), so an offset that leaves no visible pair runs no tile
// and writes zeros. No tile is skipped for segments. Every launch raises
// the dynamic shared-memory limit first and returns cudaGetLastError.
//
// Build: this file is compiled as eleven objects, one nvcc each, linked
// into one library (ops/_build.py, PARTS): EDL_PART 0 holds the entry
// points, parts 1-8 the 16 mask instances of one (pass, head dim, output
// dtype) of the bf16 kernels each, parts 9 and 10 the fp32 dq and dk/dv
// instances. The tile loads, wgmma products and mask tests are
// flash_tc.cuh's, shared with the forward (flash_fwd.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_tc.cuh"

#ifndef EDL_PART
#define EDL_PART 0
#endif

// What the entry points pass to the parts' launchers.
namespace edl_bwd {

struct Args {
  const void *q, *k, *v, *o, *dout, *lse;
  void *dq, *dk, *dv, *delta;  // delta: written by dq, read by dk/dv
  const int *q_seg, *k_seg;
  int b, h, hkv, lq, lk;
  float scale;
  int causal, window, pos_offset;
  cudaStream_t stream;
};

// The launcher of one bf16 (pass, head dim, output dtype), defined by its
// part; it picks the mask instance from the runtime flags.
template <bool DKV, int D, bool F32>
int launch_part(const Args& a);
template <> int launch_part<false, 64, false>(const Args&);
template <> int launch_part<false, 64, true>(const Args&);
template <> int launch_part<false, 128, false>(const Args&);
template <> int launch_part<false, 128, true>(const Args&);
template <> int launch_part<true, 64, false>(const Args&);
template <> int launch_part<true, 64, true>(const Args&);
template <> int launch_part<true, 128, false>(const Args&);
template <> int launch_part<true, 128, true>(const Args&);

// The launcher of one fp32 (pass, head dim): parts 9 (dq) and 10 (dk/dv).
template <bool DKV, int D>
int launch_f32(const Args& a);
template <> int launch_f32<false, 64>(const Args&);
template <> int launch_f32<false, 128>(const Args&);
template <> int launch_f32<true, 64>(const Args&);
template <> int launch_f32<true, 128>(const Args&);

// The fp32 kernels' block: 2 * D threads, SN = D / 2 streamed rows a
// step, and their dynamic shared memory in bytes. dq: Q and dO [64][D],
// a ring of two stages of K and V [SN][D], dS [64][SN], the rows' lse,
// delta and segment ids [64], the keys' segment ids [2][SN]. dk/dv: K and
// V [64][D], a ring of two stages of Q and dO [SN][D], P^T and dS^T
// [64][SN], the q rows' lse, delta and segment ids [2][SN], the keys'
// segment ids [64].
template <int D>
struct F32Shape {
  static constexpr int NT = 2 * D, SN = 64, SC = 256 / D;
  static constexpr size_t dq_smem =
      4 * (2 * 64 * D + 4 * SN * D + 64 * SN + 2 * SN);
  static constexpr size_t dkv_smem = 4 * (2 * 64 * D + 4 * SN * D + 64 * SN);
};

}  // namespace edl_bwd

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// A row's lse in the exp2 domain, as the kernels subtract it; a sentinel
// of either sign (|lse| >= 0.5e30) becomes +1e30, so P = exp2(s - it) = 0.
[[maybe_unused]] __device__ __forceinline__ float lse_log2(float lse) {
  return fabsf(lse) >= 5e29f ? 1e30f : lse * LOG2E;
}

// Dynamic shared memory of a bf16 block: two [64][D] bf16 tiles staged
// once, a ring of two stages of two tiles, and behind them three
// two-stage rows of 64 4-byte values (lse, delta, segment ids); 1024
// bytes of slack to align the tiles to the 128-byte swizzle's 1024-byte
// period.
template <int D>
constexpr size_t tc_smem_bytes() {
  return 6 * (64 * D * 2) + 1024 + 3 * 2 * 64 * 4;
}

using edl_tc::set_smem;

}  // namespace

// ---------------------------------------------------------------------------
// The entry points: part 0.
#if EDL_PART == 0

// Both entry points: q_seg [b, lq] and k_seg [b, lk] int32 segment ids,
// or both NULL; window 0 = none, else the sliding window (lq == lk);
// pos_offset the shift of the query positions (any int; 0 = none);
// grad_f32 1 = write the gradients in fp32, 0 = in the input dtype.
// dtype 0 (float32) runs the fp32 kernels, 1 (bfloat16) the bf16
// tensor-core kernels; every tensor must be 16-byte aligned.
static bool masks_ok(int h, int hkv, int window, const void* q_seg,
                     const void* k_seg) {
  return hkv > 0 && h % hkv == 0 && window >= 0 &&
         (q_seg == nullptr) == (k_seg == nullptr);
}

template <bool DKV>
static int launch_pass(const edl_bwd::Args& a, int d, int dtype,
                       int grad_f32) {
  using edl_bwd::launch_f32;
  using edl_bwd::launch_part;
  if (dtype == 0) {  // fp32 gradients either way
    if (d == 64) return launch_f32<DKV, 64>(a);
    if (d == 128) return launch_f32<DKV, 128>(a);
  } else if (dtype == 1) {
    if (d == 64)
      return grad_f32 ? launch_part<DKV, 64, true>(a)
                      : launch_part<DKV, 64, false>(a);
    if (d == 128)
      return grad_f32 ? launch_part<DKV, 128, true>(a)
                      : launch_part<DKV, 128, false>(a);
  }
  return (int)cudaErrorInvalidValue;
}

// q, o, dout [b, h, lq, d]; dq like q in the input dtype or fp32; k, v
// [b, hkv, lk, d]; lse, delta [b, h, lq] fp32; all contiguous. dtype:
// 0 = float32, 1 = bfloat16. Writes dq and delta = rowsum(dout * o).
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int edl_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* o, const void* dout,
                                const void* lse, void* dq, void* delta,
                                const void* q_seg, const void* k_seg, int b,
                                int h, int hkv, int lq, int lk, int d,
                                float scale, int causal, int window,
                                int pos_offset, int dtype, int grad_f32,
                                void* stream) {
  if (!masks_ok(h, hkv, window, q_seg, k_seg))
    return (int)cudaErrorInvalidValue;
  const edl_bwd::Args a{q, k, v, o, dout, lse, dq, nullptr, nullptr, delta,
                        static_cast<const int*>(q_seg),
                        static_cast<const int*>(k_seg), b, h, hkv, lq, lk,
                        scale, causal, window, pos_offset,
                        static_cast<cudaStream_t>(stream)};
  return launch_pass<false>(a, d, dtype, grad_f32);
}

// q, dout [b, h, lq, d]; k, v [b, hkv, lk, d]; dk, dv like k in the
// input dtype or fp32; lse, delta [b, h, lq] fp32 (delta as
// edl_flash_bwd_dq wrote it); all contiguous. dk and dv are summed over
// the q heads of each kv head's group.
extern "C" int edl_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 const void* q_seg, const void* k_seg, int b,
                                 int h, int hkv, int lq, int lk, int d,
                                 float scale, int causal, int window,
                                 int pos_offset, int dtype, int grad_f32,
                                 void* stream) {
  if (!masks_ok(h, hkv, window, q_seg, k_seg))
    return (int)cudaErrorInvalidValue;
  const edl_bwd::Args a{q, k, v, nullptr, dout, lse, nullptr, dk, dv,
                        const_cast<void*>(delta),
                        static_cast<const int*>(q_seg),
                        static_cast<const int*>(k_seg), b, h, hkv, lq, lk,
                        scale, causal, window, pos_offset,
                        static_cast<cudaStream_t>(stream)};
  return launch_pass<true>(a, d, dtype, grad_f32);
}

// Dynamic shared memory of one block, in bytes (-1: no such kernel):
// dkv 0 = the dq pass, 1 = the dk/dv pass; dtype and d as above.
extern "C" int edl_flash_bwd_smem_bytes(int dkv, int dtype, int d) {
  using edl_bwd::F32Shape;
  if (dtype == 1 && (d == 64 || d == 128))
    return (int)(d == 64 ? tc_smem_bytes<64>() : tc_smem_bytes<128>());
  if (dtype == 0 && d == 64)
    return (int)(dkv ? F32Shape<64>::dkv_smem : F32Shape<64>::dq_smem);
  if (dtype == 0 && d == 128)
    return (int)(dkv ? F32Shape<128>::dkv_smem : F32Shape<128>::dq_smem);
  return -1;
}

#endif  // EDL_PART == 0

// ---------------------------------------------------------------------------
// The fp32 kernels: FFMA, part 9 the dq pass, part 10 the dk/dv pass.
#if EDL_PART == 9 || EDL_PART == 10
namespace {

using edl_bwd::F32Shape;
using edl_tc::axpy4;
using edl_tc::cp_async16;
using edl_tc::cp_async_commit;
using edl_tc::cp_async_wait_all;
using edl_tc::dot4;
using edl_tc::f32_straddles;
using edl_tc::f32_visible;
using edl_tc::ld4;
using edl_tc::smem_u32;

constexpr int FR = 64;  // a block's own rows: q rows (dq) or keys (dk/dv)

// The swizzle of the fp32 shared tiles: the 16-byte chunk c of row r lies
// at chunk c ^ swz<SC>(r) of its row. SC is the score columns a thread
// holds: with 4 (d = 64) the streamed rows a warp reads at once are
// 4 lc + j, with 2 (d = 128) 2 lc + j.
template <int SC>
__host__ __device__ constexpr int swz(int r) {
  return SC == 4 ? (r >> 2) & 7 : ((r >> 1) & 7) ^ ((r >> 4) & 1);
}

// Rows [r0, r0 + N) of a row-major [rows, W] fp32 matrix into a swizzled
// [N][W] shared tile with cp.async, 16 bytes a thread, NT threads; rows
// past `rows` are zero-filled.
template <int N, int W, int NT, int SC>
__device__ __forceinline__ void f32_tile(float* dst, const float* src,
                                         int r0, int rows) {
  constexpr int CPR = W / 4;  // chunks per row
  static_assert((N * CPR) % NT == 0, "the threads split the tile evenly");
#pragma unroll
  for (int n = 0; n < N * CPR / NT; ++n) {
    const int i = threadIdx.x + NT * n;
    const int r = i / CPR, c = i % CPR;
    const bool in = r0 + r < rows;
    cp_async16(smem_u32(dst + r * W + ((c ^ swz<SC>(r)) << 2)),
               src + (size_t)(in ? r0 + r : 0) * W + 4 * c, in ? 16u : 0u);
  }
}

// A thread's rows and columns (see the design notes) and the swizzled
// float offsets of its reads, so that every read is a register plus a
// constant: pa[m] / ps[m] for its own rows r0 + i of a [64][D] / [64][SN]
// tile, at chunk 8 k + (m ^ swz(i)) (swz(r0 + i) = swz(r0) ^ swz(i), r0
// a multiple of 8); pb[m] for the streamed rows c0 + j of a [SN][D] tile,
// at chunk 8 k + m (swz(c0 + j) = swz(c0)); pd[m] for its features'
// chunk f4 of a streamed row kr with swz(kr) = m.
template <int D>
struct Lanes {
  static constexpr int SN = F32Shape<D>::SN, SC = F32Shape<D>::SC;
  int r0, c0, f4;
  int pa[8], ps[8], pb[8], pd[8];
  __device__ __forceinline__ Lanes() {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    r0 = 32 * (warp % 2) + 8 * (lane / 8);
    c0 = (warp / 2) * 8 * SC + (lane % 8) * SC;
    f4 = 8 * (warp / 2) + lane % 8;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      pa[m] = r0 * D + ((m ^ swz<SC>(r0)) << 2);
      ps[m] = r0 * SN + ((m ^ swz<SC>(r0)) << 2);
      pb[m] = c0 * D + ((m ^ swz<SC>(c0)) << 2);
      pd[m] = (f4 ^ m) << 2;
    }
  }
  // stores the thread's P or dS values of row r0 + i (columns c0 ..
  // c0 + SC - 1, within one 16-byte chunk) into a [64][SN] tile
  __device__ __forceinline__ void store_row(float* t, int i,
                                            const float (&v)[SC]) const {
    float* at = t + (r0 + i) * SN + (((c0 >> 2) ^ swz<SC>(r0 + i)) << 2) +
                (c0 & 3);
    if constexpr (SC == 4)
      *reinterpret_cast<float4*>(at) = make_float4(v[0], v[1], v[2], v[3]);
    else
      *reinterpret_cast<float2*>(at) = make_float2(v[0], v[1]);
  }
};

// acc = A B^T over the depth D, the thread's 8 x SC block: A a [64][D]
// tile of the block's own rows, B a [SN][D] tile of the streamed rows.
// Eight chunks of depth are unrolled, the rest is a loop, so that the
// kernels' loops stay within the instruction cache.
template <int D>
__device__ __forceinline__ void scores(float (&acc)[8][F32Shape<D>::SC],
                                       const float* A, const float* B,
                                       const Lanes<D>& L) {
  constexpr int SC = F32Shape<D>::SC;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < SC; ++j) acc[i][j] = 0.f;
#pragma unroll 1
  for (int hi = 0; hi < D; hi += 32) {  // chunks 8 k .. 8 k + 7
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      float4 bf[SC];
#pragma unroll
      for (int j = 0; j < SC; ++j) bf[j] = ld4(B + L.pb[u] + j * D + hi);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 a = ld4(A + L.pa[u ^ swz<SC>(i)] + i * D + hi);
#pragma unroll
        for (int j = 0; j < SC; ++j) acc[i][j] = dot4(a, bf[j], acc[i][j]);
      }
    }
  }
}

// acc += X Y for the thread's 8 x 4 block: X a [64][SN] tile of P or dS
// (own rows), Y a [SN][D] tile of streamed rows, summed over the SN
// streamed rows, eight 4-row steps unrolled.
template <int D>
__device__ __forceinline__ void outer(float (&acc)[8][4], const float* X,
                                      const float* Y, const Lanes<D>& L) {
  constexpr int SN = F32Shape<D>::SN, SC = F32Shape<D>::SC;
#pragma unroll 1
  for (int k8 = 0; k8 < SN; k8 += 32) {  // streamed rows k8 .. k8 + 31
    const float* Yk = Y + k8 * D;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      float4 y[4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        y[t] = ld4(Yk + L.pd[swz<SC>(4 * u + t)] + (4 * u + t) * D);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        axpy4(acc[i], ld4(X + L.ps[u ^ swz<SC>(i)] + i * SN + k8), y);
    }
  }
}

// The dq pass. GEN: the general instance (the masks from the runtime
// flags); otherwise no mask code, only the ragged key edge.
template <int D, bool GEN>
__global__ void __launch_bounds__(F32Shape<D>::NT, D == 64 ? 2 : 1)
    flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ o,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse, float* __restrict__ dq,
                     float* __restrict__ delta, const int* __restrict__ q_seg,
                     const int* __restrict__ k_seg, int h, int hkv, int lq,
                     int lk, float scale, int causal_arg, int window_arg,
                     int pos_offset) {
  constexpr int NT = F32Shape<D>::NT, SN = F32Shape<D>::SN;
  constexpr int SC = F32Shape<D>::SC;
  constexpr int TILE = FR * D, STILE = SN * D;
  extern __shared__ __align__(16) float smem_f32[];
  float* qs = smem_f32;
  float* dos = qs + TILE;
  float* ring = dos + TILE;  // stage s: K at ring + 2 s STILE, then V
  float* dss = ring + 4 * STILE;  // dS [64][SN]
  int* ks_seg = reinterpret_cast<int*>(dss + FR * SN);  // [2][SN]

  const bool causal = GEN && causal_arg != 0;
  const int window = GEN ? window_arg : 0;
  const bool segs = GEN && q_seg != nullptr;
  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FR;  // longest rows first
  const int b = bh / h;
  const int kvh = (bh % h) / (h / hkv);
  const size_t q_off = (size_t)bh * lq * D;
  const float* kb = k + (size_t)(b * hkv + kvh) * lk * D;
  const float* vb = v + (size_t)(b * hkv + kvh) * lk * D;
  const int p0 = q0 + (GEN ? pos_offset : 0);

  // the forward's key range (_kv_stream_clamp)
  int k_lo = 0, k_end = causal ? min(lk, p0 + FR) : lk;
  if (window > 0) {
    k_lo = max(0, p0 - window + 1);
    if (!causal) k_end = min(lk, p0 + FR - 1 + window);
  }
  k_end = max(k_end, 0);
  const int kt_lo = k_lo / SN, kt_end = (k_end + SN - 1) / SN;

  auto stage_kv = [&](int s, int kt) {
    f32_tile<SN, D, NT, SC>(ring + 2 * s * STILE, kb, kt * SN, lk);
    f32_tile<SN, D, NT, SC>(ring + (2 * s + 1) * STILE, vb, kt * SN, lk);
    if (segs && tid < SN) {
      const int kp = kt * SN + tid;
      ks_seg[s * SN + tid] = kp < lk ? k_seg[(size_t)b * lk + kp] : -1;
    }
  };
  f32_tile<FR, D, NT, SC>(qs, q + q_off, q0, lq);
  f32_tile<FR, D, NT, SC>(dos, dout + q_off, q0, lq);
  if (kt_lo < kt_end) stage_kv(0, kt_lo);
  cp_async_commit();

  {  // delta = rowsum(dO * O), NT / 64 threads a row, while the tiles land;
     // the rows' lse, delta and segment ids pass through the dS tile
    constexpr int TPR = NT / FR, PER = D / TPR;  // PER = 32 columns
    const int r = tid / TPR, part = tid % TPR;
    const bool in = q0 + r < lq;
    float sum = 0.f;
    if (in) {
      const size_t at = q_off + (size_t)(q0 + r) * D + part * PER;
#pragma unroll
      for (int e = 0; e < PER; e += 4)
        sum = dot4(ld4(o + at + e), ld4(dout + at + e), sum);
    }
#pragma unroll
    for (int m = 1; m < TPR; m <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, m);
    if (part == 0) {
      // rows past lq: P = exp2(s - 1e30) = 0
      dss[r] = in ? lse_log2(lse[(size_t)bh * lq + q0 + r]) : 1e30f;
      dss[FR + r] = sum;
      if (in) delta[(size_t)bh * lq + q0 + r] = sum;
      if (segs)
        reinterpret_cast<int*>(dss)[2 * FR + r] =
            in ? q_seg[(size_t)b * lq + q0 + r] : -1;
    }
  }
  __syncthreads();
  const Lanes<D> L;
  float lse2[8], dlt[8];
  int qsg[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    lse2[i] = dss[L.r0 + i];
    dlt[i] = dss[FR + L.r0 + i];
    qsg[i] = segs ? reinterpret_cast<const int*>(dss)[2 * FR + L.r0 + i] : 0;
  }

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const float slog = scale * LOG2E;
  for (int kt = kt_lo; kt < kt_end; ++kt) {
    const int s = (kt - kt_lo) & 1;
    const float* ks = ring + 2 * s * STILE;
    const float* vs = ks + STILE;
    cp_async_wait_all();
    __syncthreads();  // tile kt landed; stage s ^ 1's and dS's readers done
    if (kt + 1 < kt_end) stage_kv(s ^ 1, kt + 1);
    cp_async_commit();

    float sc[8][SC], dp[8][SC];
    scores<D>(sc, qs, ks, L);   // S = Q K^T
    scores<D>(dp, dos, vs, L);  // dP = dO V^T

    const int k0 = kt * SN;
    const bool edge = k0 + SN > lk ||
                      f32_straddles(p0, FR, k0, SN, causal, window, segs);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float ds[SC];
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        float p = exp2f(fmaf(sc[i][j], slog, -lse2[i]));
        if (edge) {
          const int kp = k0 + L.c0 + j;
          if (!(kp < lk && f32_visible(p0 + L.r0 + i, kp, causal, window) &&
                (!segs || qsg[i] == ks_seg[s * SN + L.c0 + j])))
            p = 0.f;
        }
        ds[j] = p * (dp[i][j] - dlt[i]) * scale;
      }
      L.store_row(dss, i, ds);
    }
    __syncthreads();  // dS is complete
    outer<D>(acc, dss, ks, L);  // dQ += dS K
  }
  cp_async_wait_all();  // a block that ran no tile still has copies out

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = q0 + L.r0 + i;
    if (r < lq)
      *reinterpret_cast<float4*>(dq + q_off + (size_t)r * D + 4 * L.f4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// The dk/dv pass, GEN as for the dq pass. One [64][SN] tile carries P^T
// for dV += P^T dO, then dS^T for dK += dS^T Q, so that two blocks fit an
// SM at d = 64; the streamed rows' lse and delta are read from global
// memory into registers at the start of each step.
template <int D, bool GEN>
__global__ void __launch_bounds__(F32Shape<D>::NT, D == 64 ? 2 : 1)
    flash_bwd_dkv_f32(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, const int* __restrict__ q_seg,
                      const int* __restrict__ k_seg, int h, int hkv, int lq,
                      int lk, float scale, int causal_arg, int window_arg,
                      int pos_offset) {
  constexpr int NT = F32Shape<D>::NT, SN = F32Shape<D>::SN;
  constexpr int SC = F32Shape<D>::SC;
  constexpr int TILE = FR * D, STILE = SN * D;
  extern __shared__ __align__(16) float smem_f32[];
  float* ks = smem_f32;
  float* vs = ks + TILE;
  float* ring = vs + TILE;  // stage s: Q at ring + 2 s STILE, then dO
  float* pds = ring + 4 * STILE;  // P^T, then dS^T: [key][q row]

  const bool causal = GEN && causal_arg != 0;
  const int window = GEN ? window_arg : 0;
  const bool segs = GEN && q_seg != nullptr;
  const int off = GEN ? pos_offset : 0;
  const int bkv = blockIdx.x;      // b * hkv + kv head
  const int k0 = blockIdx.y * FR;  // key tile 0, the longest walk, first
  const int b = bkv / hkv, kvh = bkv % hkv;
  const int group = h / hkv;
  const size_t kv_off = (size_t)bkv * lk * D;

  // the q rows that can see a key of the tile (_q_stream_clamp), by their
  // positions row + pos_offset
  int q_lo = causal ? k0 - off : 0, q_end = lq;
  if (window > 0) {
    q_end = min(lq, k0 + FR - 1 + window - off);
    if (!causal) q_lo = k0 - window + 1 - off;
  }
  q_lo = min(max(q_lo, 0), lq);
  q_end = max(q_end, 0);
  const int qt_lo = q_lo / SN;
  const int nq = max((q_end + SN - 1) / SN - qt_lo, 0);
  const int steps = group * nq;  // (group member, q tile) pairs

  auto stage_q = [&](int s, int n) {
    const int q0 = (qt_lo + n % nq) * SN;
    const size_t qh = (size_t)b * h + kvh * group + n / nq;
    f32_tile<SN, D, NT, SC>(ring + 2 * s * STILE, q + qh * lq * D, q0, lq);
    f32_tile<SN, D, NT, SC>(ring + (2 * s + 1) * STILE, dout + qh * lq * D,
                            q0, lq);
  };
  f32_tile<FR, D, NT, SC>(ks, k + kv_off, k0, lk);
  f32_tile<FR, D, NT, SC>(vs, v + kv_off, k0, lk);
  if (steps > 0) stage_q(0, 0);
  cp_async_commit();

  const Lanes<D> L;
  int ksg[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int kp = k0 + L.r0 + i;
    ksg[i] = segs && kp < lk ? k_seg[(size_t)b * lk + kp] : -1;
  }
  float acc[2][8][4];  // dV, dK
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[x][i][j] = 0.f;
  const float slog = scale * LOG2E;
  for (int n = 0; n < steps; ++n) {
    const int s = n & 1;
    const float* qsm = ring + 2 * s * STILE;
    const float* dosm = qsm + STILE;
    cp_async_wait_all();
    __syncthreads();  // step n landed; stage s ^ 1's and dS^T's readers done
    if (n + 1 < steps) stage_q(s ^ 1, n + 1);
    cp_async_commit();

    // the thread's q columns' lse, delta and segment ids; rows past lq:
    // P = exp2(s - 1e30) = 0
    const int q0 = (qt_lo + n % nq) * SN;
    const size_t qrow = ((size_t)b * h + kvh * group + n / nq) * lq;
    float lse2[SC], dlt[SC];
    int qsg[SC];
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      const int qr = q0 + L.c0 + j;
      const bool in = qr < lq;
      lse2[j] = in ? lse_log2(lse[qrow + qr]) : 1e30f;
      dlt[j] = in ? delta[qrow + qr] : 0.f;
      qsg[j] = segs && in ? q_seg[(size_t)b * lq + qr] : -1;
    }

    float sc[8][SC], dp[8][SC];
    scores<D>(sc, ks, qsm, L);   // S^T = K Q^T
    scores<D>(dp, vs, dosm, L);  // dP^T = V dO^T

    const int p0 = q0 + off;
    const bool edge = f32_straddles(p0, SN, k0, FR, causal, window, segs);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        float p = exp2f(fmaf(sc[i][j], slog, -lse2[j]));
        if (edge && !(f32_visible(p0 + L.c0 + j, k0 + L.r0 + i, causal,
                                  window) &&
                      (!segs || qsg[j] == ksg[i])))
          p = 0.f;
        sc[i][j] = p;
        dp[i][j] = p * (dp[i][j] - dlt[j]) * scale;
      }
#pragma unroll
    for (int i = 0; i < 8; ++i) L.store_row(pds, i, sc[i]);
    __syncthreads();  // P^T is complete
    outer<D>(acc[0], pds, dosm, L);  // dV += P^T dO
    __syncthreads();  // P^T's readers are done
#pragma unroll
    for (int i = 0; i < 8; ++i) L.store_row(pds, i, dp[i]);
    __syncthreads();  // dS^T is complete
    outer<D>(acc[1], pds, qsm, L);  // dK += dS^T Q
  }
  cp_async_wait_all();  // a block that ran no step still has copies out

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = k0 + L.r0 + i;
    if (r >= lk) continue;
    const size_t at = kv_off + (size_t)r * D + 4 * L.f4;
    *reinterpret_cast<float4*>(dv + at) =
        make_float4(acc[0][i][0], acc[0][i][1], acc[0][i][2], acc[0][i][3]);
    *reinterpret_cast<float4*>(dk + at) =
        make_float4(acc[1][i][0], acc[1][i][1], acc[1][i][2], acc[1][i][3]);
  }
}

template <bool DKV, int D, bool GEN>
int launch_f32_instance(const edl_bwd::Args& a) {
  constexpr int NT = F32Shape<D>::NT;
  constexpr size_t smem = DKV ? F32Shape<D>::dkv_smem : F32Shape<D>::dq_smem;
  static bool configured = false;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  if constexpr (DKV) {
    int err = set_smem(flash_bwd_dkv_f32<D, GEN>, smem, &configured);
    if (err) return err;
    dim3 grid(a.b * a.hkv, (a.lk + FR - 1) / FR);
    flash_bwd_dkv_f32<D, GEN><<<grid, NT, smem, a.stream>>>(
        q, k, v, dout, lse, static_cast<const float*>(a.delta),
        static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.q_seg,
        a.k_seg, a.h, a.hkv, a.lq, a.lk, a.scale, a.causal, a.window,
        a.pos_offset);
  } else {
    int err = set_smem(flash_bwd_dq_f32<D, GEN>, smem, &configured);
    if (err) return err;
    dim3 grid(a.b * a.h, (a.lq + FR - 1) / FR);
    flash_bwd_dq_f32<D, GEN><<<grid, NT, smem, a.stream>>>(
        q, k, v, static_cast<const float*>(a.o), dout, lse,
        static_cast<float*>(a.dq), static_cast<float*>(a.delta), a.q_seg,
        a.k_seg, a.h, a.hkv, a.lq, a.lk, a.scale, a.causal, a.window,
        a.pos_offset);
  }
  return (int)cudaGetLastError();
}

// the instance with no mask code when every mask flag is off
template <bool DKV, int D>
int launch_f32_pass(const edl_bwd::Args& a) {
  const bool general = a.causal != 0 || a.window > 0 ||
                       a.q_seg != nullptr || a.pos_offset != 0;
  return general ? launch_f32_instance<DKV, D, true>(a)
                 : launch_f32_instance<DKV, D, false>(a);
}

}  // namespace

namespace edl_bwd {
#if EDL_PART == 9
template <> int launch_f32<false, 64>(const Args& a) {
  return launch_f32_pass<false, 64>(a);
}
template <> int launch_f32<false, 128>(const Args& a) {
  return launch_f32_pass<false, 128>(a);
}
#else
template <> int launch_f32<true, 64>(const Args& a) {
  return launch_f32_pass<true, 64>(a);
}
template <> int launch_f32<true, 128>(const Args& a) {
  return launch_f32_pass<true, 128>(a);
}
#endif
}  // namespace edl_bwd

#endif  // EDL_PART 9, 10
// ---------------------------------------------------------------------------
// The bf16 kernels: wgmma on tensor cores, parts 1-8.
#if EDL_PART >= 1 && EDL_PART <= 8
namespace {

using namespace edl_tc;

[[maybe_unused]] __device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = __bfloat1622float2(x[i]), fy = __bfloat1622float2(y[i]);
    s += fx.x * fy.x + fx.y * fy.y;
  }
  return s;
}

// The dq pass's P and dS of one tile, from S = Q K^T and dP = dO V^T in
// the accumulator layout (element i of a thread: row r0 + 8 * (i % 4 / 2),
// column 8 * (i / 4) + 2 * (lane % 4) + i % 2), into the bf16 A
// fragments of dQ += dS K: frag[kk][r] packs elements 8 kk + 2 r and
// 8 kk + 2 r + 1, which is the A layout of depth step kk.
template <class M, bool EDGE>
__device__ __forceinline__ void dq_frags(
    const float (&sacc)[32], const float (&pacc)[32], uint32_t (&frag)[4][4],
    const float (&lse2)[2], const float (&dlt)[2], const int (&qseg)[2],
    const int* kseg, int r0, int cq, int p0, int k0, int lk, float slog,
    float scale, int window) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 8 * kk + 2 * r + e, rr = r % 2;
        const int col = 8 * (i / 4) + cq + e;
        float p = exp2f(sacc[i] * slog - lse2[rr]);
        if (EDGE) {
          const int kp = k0 + col;
          if (!(kp < lk && visible<M>(p0 + r0 + 8 * rr, kp, window) &&
                (!M::segs || qseg[rr] == kseg[col])))
            p = 0.f;
        }
        ds[e] = p * (pacc[i] - dlt[rr]) * scale;
      }
      frag[kk][r] = pack_bf16(ds[0], ds[1]);
    }
}

// The dk/dv pass's P^T and dS^T of 64 keys x 16 KS query rows (columns;
// lse2, dlt and qseg start at the first, at position p0), into the
// bf16 A fragments of dV += P^T dO and dK += dS^T Q.
template <class M, bool EDGE, int KS>
__device__ __forceinline__ void dkv_frags(
    const float (&sacc)[8 * KS], const float (&pacc)[8 * KS],
    uint32_t (&pfrag)[KS][4], uint32_t (&dfrag)[KS][4], const float* lse2,
    const float* dlt, const int* qseg, const int (&kseg)[2], int r0, int cq,
    int p0, int k0, float slog, float scale, int window) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float pv[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 8 * kk + 2 * r + e, rr = r % 2;
        const int qc = 8 * (i / 4) + cq + e;
        float p = exp2f(sacc[i] * slog - lse2[qc]);
        if (EDGE) {
          if (!(visible<M>(p0 + qc, k0 + r0 + 8 * rr, window) &&
                (!M::segs || qseg[qc] == kseg[rr])))
            p = 0.f;
        }
        pv[e] = p;
        ds[e] = p * (pacc[i] - dlt[qc]) * scale;
      }
      pfrag[kk][r] = pack_bf16(pv[0], pv[1]);
      dfrag[kk][r] = pack_bf16(ds[0], ds[1]);
    }
}

template <typename TO, int D, class M>
__global__ void __launch_bounds__(WG) flash_bwd_dq_tc(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    TO* __restrict__ dq, float* __restrict__ delta,
    const int* __restrict__ q_seg, const int* __restrict__ k_seg, int h,
    int hkv, int lq, int lk, float scale, int window, int pos_offset) {
  constexpr int TILE = TB * D * 2;  // bytes of a [64][D] bf16 tile
  constexpr int NP = D / 64;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sp = smem_raw + (base - raw);
  const uint32_t qs = base, dos = base + TILE;
  const uint32_t kv_ring = base + 2 * TILE;  // stage s: K, then V
  float* row_lse = reinterpret_cast<float*>(sp + 6 * TILE);
  float* row_delta = row_lse + TB;
  int* ks_seg = reinterpret_cast<int*>(row_delta + TB);  // [2][TB]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TB;  // longest rows first
  const int b = bh / h;
  const int kvh = (bh % h) / (h / hkv);
  const size_t q_off = (size_t)bh * lq * D;
  const __nv_bfloat16* kb = k + (size_t)(b * hkv + kvh) * lk * D;
  const __nv_bfloat16* vb = v + (size_t)(b * hkv + kvh) * lk * D;
  const int p0 = q0 + (M::offset ? pos_offset : 0);

  // the forward's key range (_kv_stream_clamp), as the fp32 kernels
  int k_lo = 0, k_end = M::causal ? min(lk, p0 + TB) : lk;
  if (M::window) {
    k_lo = max(0, p0 - window + 1);
    if (!M::causal) k_end = min(lk, p0 + TB - 1 + window);
  }
  k_end = max(k_end, 0);
  const int kt_lo = k_lo / TB, kt_end = (k_end + TB - 1) / TB;

  auto stage_kv = [&](int s, int kt) {
    load_tile<D>(kv_ring + 2 * s * TILE, kb, kt * TB, lk);
    load_tile<D>(kv_ring + (2 * s + 1) * TILE, vb, kt * TB, lk);
    if (M::segs && tid < TB) {
      const int kp = kt * TB + tid;
      ks_seg[s * TB + tid] = kp < lk ? k_seg[(size_t)b * lk + kp] : -1;
    }
  };
  load_tile<D>(qs, q + q_off, q0, lq);
  load_tile<D>(dos, dout + q_off, q0, lq);
  if (kt_lo < kt_end) stage_kv(0, kt_lo);
  cp_async_commit();

  {  // delta = rowsum(dO * O), two threads a row, while the tiles land
    const int r = tid / 2, half = tid % 2;
    const bool in = q0 + r < lq;
    float sum = 0.f;
    if (in) {
      const size_t at = q_off + (size_t)(q0 + r) * D + half * (D / 2);
      const uint4* orow = reinterpret_cast<const uint4*>(o + at);
      const uint4* grow = reinterpret_cast<const uint4*>(dout + at);
#pragma unroll
      for (int e = 0; e < D / 16; ++e) sum += dot8(orow[e], grow[e]);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      row_delta[r] = sum;
      // rows past lq: P = exp2(s - 1e30) = 0
      row_lse[r] = in ? lse_log2(lse[(size_t)bh * lq + q0 + r]) : 1e30f;
      if (in) delta[(size_t)bh * lq + q0 + r] = sum;
    }
  }
  __syncthreads();
  const int r0 = warp * 16 + lane / 4, cq = 2 * (lane % 4);
  float lse2[2], dlt[2];
  int qseg[2] = {-1, -1};
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = r0 + 8 * rr;
    lse2[rr] = row_lse[r];
    dlt[rr] = row_delta[r];
    if (M::segs && q0 + r < lq) qseg[rr] = q_seg[(size_t)b * lq + q0 + r];
  }

  float acc[NP][32];
#pragma unroll
  for (int pn = 0; pn < NP; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[pn][i] = 0.f;
  const float slog = scale * LOG2E;
  for (int kt = kt_lo; kt < kt_end; ++kt) {
    const int s = (kt - kt_lo) & 1;
    const uint32_t ks = kv_ring + 2 * s * TILE, vs = ks + TILE;
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();  // tile kt landed; stage s ^ 1's readers are done
    if (kt + 1 < kt_end) stage_kv(s ^ 1, kt + 1);
    cp_async_commit();

    float sacc[32], pacc[32];
    wgmma_fence();
    product_ss<D, 32>(sacc, qs, ks);   // S = Q K^T
    product_ss<D, 32>(pacc, dos, vs);  // dP = dO V^T
    wgmma_commit();
    wgmma_wait_all();
    keep(sacc);
    keep(pacc);

    const int k0 = kt * TB;
    uint32_t frag[4][4];
    if (k0 + TB > lk || straddles<M>(p0, k0, window))
      dq_frags<M, true>(sacc, pacc, frag, lse2, dlt, qseg, ks_seg + s * TB,
                        r0, cq, p0, k0, lk, slog, scale, window);
    else
      dq_frags<M, false>(sacc, pacc, frag, lse2, dlt, qseg, ks_seg + s * TB,
                         r0, cq, p0, k0, lk, slog, scale, window);
    wgmma_fence();
    product_rs<NP, 4>(acc, frag, ks);  // dQ += dS K
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) keep(acc[pn]);
  }
  cp_async_wait_all();  // a block that ran no tile still has copies out

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = r0 + 8 * rr;
    if (q0 + r >= lq) continue;
    TO* row = dq + q_off + (size_t)(q0 + r) * D;
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        store2(row + 64 * pn + 8 * j + cq, acc[pn][4 * j + 2 * rr],
               acc[pn][4 * j + 2 * rr + 1]);
  }
}

template <typename TO, int D, class M>
__global__ void __launch_bounds__(WG) flash_bwd_dkv_tc(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, TO* __restrict__ dk,
    TO* __restrict__ dv, const int* __restrict__ q_seg,
    const int* __restrict__ k_seg, int h, int hkv, int lq, int lk,
    float scale, int window, int pos_offset) {
  constexpr int TILE = TB * D * 2;  // bytes of a [64][D] bf16 tile
  constexpr int NP = D / 64;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sp = smem_raw + (base - raw);
  const uint32_t ks = base, vs = base + TILE;
  const uint32_t q_ring = base + 2 * TILE;  // stage s: Q, then dO
  float* st_lse = reinterpret_cast<float*>(sp + 6 * TILE);  // [2][TB]
  float* st_delta = st_lse + 2 * TB;                        // [2][TB]
  int* st_seg = reinterpret_cast<int*>(st_delta + 2 * TB);  // [2][TB]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bkv = blockIdx.x;  // b * hkv + kv head
  const int k0 = blockIdx.y * TB;  // key tile 0, the longest walk, first
  const int b = bkv / hkv, kvh = bkv % hkv;
  const int group = h / hkv;
  const size_t kv_off = (size_t)bkv * lk * D;
  const int off = M::offset ? pos_offset : 0;

  // the q rows that can see a key of the tile (_q_stream_clamp), as the
  // fp32 kernels
  int q_lo = M::causal ? k0 - off : 0, q_end = lq;
  if (M::window) {
    q_end = min(lq, k0 + TB - 1 + window - off);
    if (!M::causal) q_lo = k0 - window + 1 - off;
  }
  q_lo = min(max(q_lo, 0), lq);
  q_end = max(q_end, 0);
  const int qt_lo = q_lo / TB;
  const int nq = max((q_end + TB - 1) / TB - qt_lo, 0);
  const int steps = group * nq;  // (group member, q tile) pairs

  auto stage_q = [&](int s, int n) {
    const int q0 = (qt_lo + n % nq) * TB;
    const size_t qh = (size_t)b * h + kvh * group + n / nq;
    load_tile<D>(q_ring + 2 * s * TILE, q + qh * lq * D, q0, lq);
    load_tile<D>(q_ring + (2 * s + 1) * TILE, dout + qh * lq * D, q0, lq);
    const int t = tid % TB;
    const bool in = q0 + t < lq;
    const size_t row = qh * lq + q0 + t;
    if (tid < TB) {
      // rows past lq: P = exp2(s - 1e30) = 0
      st_lse[s * TB + t] = in ? lse_log2(lse[row]) : 1e30f;
      if (M::segs) st_seg[s * TB + t] = in ? q_seg[(size_t)b * lq + q0 + t] : -1;
    } else {
      st_delta[s * TB + t] = in ? delta[row] : 0.f;
    }
  };
  load_tile<D>(ks, k + kv_off, k0, lk);
  load_tile<D>(vs, v + kv_off, k0, lk);
  if (steps > 0) stage_q(0, 0);
  cp_async_commit();

  const int r0 = warp * 16 + lane / 4, cq = 2 * (lane % 4);
  int kseg[2] = {-1, -1};
  if (M::segs) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int kp = k0 + r0 + 8 * rr;
      if (kp < lk) kseg[rr] = k_seg[(size_t)b * lk + kp];
    }
  }

  float dk_acc[NP][32], dv_acc[NP][32];
#pragma unroll
  for (int pn = 0; pn < NP; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[pn][i] = dv_acc[pn][i] = 0.f;
  const float slog = scale * LOG2E;
  for (int n = 0; n < steps; ++n) {
    const int s = n & 1;
    const uint32_t qsm = q_ring + 2 * s * TILE, dosm = qsm + TILE;
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();  // step n landed; stage s ^ 1's readers are done
    if (n + 1 < steps) stage_q(s ^ 1, n + 1);
    cp_async_commit();

    // half the q tile at a time: S^T and dP^T of 64 keys x 32 rows take
    // 16 registers each beside dK and dV's 128 (at d = 128), where a
    // whole tile's 64 pushed the instances with masks past 255
    const int p0 = (qt_lo + n % nq) * TB + off;
    const bool edge = straddles<M>(p0, k0, window);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c0 = 32 * half;  // its first q row in the tile
      float sacc[16], pacc[16];
      wgmma_fence();
      product_ss<D, 16>(sacc, ks, qsm + c0 * 128);   // S^T = K Q^T
      product_ss<D, 16>(pacc, vs, dosm + c0 * 128);  // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait_all();
      keep(sacc);
      keep(pacc);

      uint32_t pfrag[2][4], dfrag[2][4];
      const int row = s * TB + c0;
      if (edge)
        dkv_frags<M, true, 2>(sacc, pacc, pfrag, dfrag, st_lse + row,
                              st_delta + row, st_seg + row, kseg, r0, cq,
                              p0 + c0, k0, slog, scale, window);
      else
        dkv_frags<M, false, 2>(sacc, pacc, pfrag, dfrag, st_lse + row,
                               st_delta + row, st_seg + row, kseg, r0, cq,
                               p0 + c0, k0, slog, scale, window);
      wgmma_fence();
      product_rs<NP, 2>(dv_acc, pfrag, dosm + c0 * 128);  // dV += P^T dO
      product_rs<NP, 2>(dk_acc, dfrag, qsm + c0 * 128);   // dK += dS^T Q
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int pn = 0; pn < NP; ++pn) {
        keep(dk_acc[pn]);
        keep(dv_acc[pn]);
      }
    }
  }
  cp_async_wait_all();  // a block that ran no step still has copies out

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = r0 + 8 * rr;
    if (k0 + r >= lk) continue;
    TO* krow = dk + kv_off + (size_t)(k0 + r) * D;
    TO* vrow = dv + kv_off + (size_t)(k0 + r) * D;
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 64 * pn + 8 * j + cq, i = 4 * j + 2 * rr;
        store2(krow + c, dk_acc[pn][i], dk_acc[pn][i + 1]);
        store2(vrow + c, dv_acc[pn][i], dv_acc[pn][i + 1]);
      }
  }
}

template <bool DKV, int D, typename TO, class M>
int launch_tc(const edl_bwd::Args& a) {
  constexpr size_t smem = tc_smem_bytes<D>();
  static bool configured = false;
  using bf = __nv_bfloat16;
  if constexpr (DKV) {
    int err = set_smem(flash_bwd_dkv_tc<TO, D, M>, smem, &configured);
    if (err) return err;
    dim3 grid(a.b * a.hkv, (a.lk + TB - 1) / TB);
    flash_bwd_dkv_tc<TO, D, M><<<grid, WG, smem, a.stream>>>(
        static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
        static_cast<const bf*>(a.v), static_cast<const bf*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<TO*>(a.dk), static_cast<TO*>(a.dv), a.q_seg, a.k_seg,
        a.h, a.hkv, a.lq, a.lk, a.scale, a.window, a.pos_offset);
  } else {
    int err = set_smem(flash_bwd_dq_tc<TO, D, M>, smem, &configured);
    if (err) return err;
    dim3 grid(a.b * a.h, (a.lq + TB - 1) / TB);
    flash_bwd_dq_tc<TO, D, M><<<grid, WG, smem, a.stream>>>(
        static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
        static_cast<const bf*>(a.v), static_cast<const bf*>(a.o),
        static_cast<const bf*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<TO*>(a.dq), static_cast<float*>(a.delta), a.q_seg,
        a.k_seg, a.h, a.hkv, a.lq, a.lk, a.scale, a.window, a.pos_offset);
  }
  return (int)cudaGetLastError();
}

// The runtime mask flags -> the instance compiled for them.
template <bool DKV, int D, typename TO, bool... B>
struct MaskDispatch {
  static int run(const edl_bwd::Args& a) {
    return launch_tc<DKV, D, TO, Masks<B...>>(a);
  }
  template <typename... R>
  static int run(const edl_bwd::Args& a, bool x, R... rest) {
    return x ? MaskDispatch<DKV, D, TO, B..., true>::run(a, rest...)
             : MaskDispatch<DKV, D, TO, B..., false>::run(a, rest...);
  }
};

}  // namespace

#define EDL_TC_PART(DKV, D, F32)                                          \
  namespace edl_bwd {                                                     \
  template <>                                                             \
  int launch_part<DKV, D, F32>(const Args& a) {                           \
    using TO = std::conditional_t<F32, float, __nv_bfloat16>;             \
    return MaskDispatch<DKV, D, TO>::run(a, a.causal != 0, a.window > 0,  \
                                         a.q_seg != nullptr,              \
                                         a.pos_offset != 0);              \
  }                                                                       \
  }
#if EDL_PART == 1
EDL_TC_PART(false, 64, false)
#elif EDL_PART == 2
EDL_TC_PART(false, 64, true)
#elif EDL_PART == 3
EDL_TC_PART(false, 128, false)
#elif EDL_PART == 4
EDL_TC_PART(false, 128, true)
#elif EDL_PART == 5
EDL_TC_PART(true, 64, false)
#elif EDL_PART == 6
EDL_TC_PART(true, 64, true)
#elif EDL_PART == 7
EDL_TC_PART(true, 128, false)
#elif EDL_PART == 8
EDL_TC_PART(true, 128, true)
#endif
#undef EDL_TC_PART

#endif  // EDL_PART 1-8
