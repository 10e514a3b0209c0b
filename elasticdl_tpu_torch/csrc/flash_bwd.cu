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
// rounded (_mxu_cast leaves them), so they keep the scalar fp32 kernels
// below: bf16 tensor cores would miss the fp32 limit of 1e-4, and no
// training path runs fp32 attention (tests, oracle checks and small fp32
// runs do). The entry points pick the kernels by dtype, never by a
// failed launch.
//
// What bounds them on the H100: at the training shapes (b = 8, h = 8,
// l = 1024, d = 128, causal) the dq pass does 6 * d operations per
// visible (query, key) pair and the dk/dv pass 8 * d, against a few
// bytes per row moved, so both are bound by operations: by the tensor
// cores' bf16 rate.
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
// Design of the fp32 kernels (flash_bwd_dq_kernel, flash_bwd_dkv_kernel):
// 64 x 64 tiles and 256 threads in a 16 x 16 grid; a thread owns a 4 x 4
// block of a score tile and a 4 x D/16 block of an output tile in
// registers; scalar fp32 FMAs out of padded fp32 shared-memory tiles;
// the masks are runtime arguments. They need ~146 KB (dq) and ~162 KB
// (dk/dv) of shared memory at d = 128.
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
// Build: this file is compiled as nine objects, one nvcc each, linked
// into one library (ops/_build.py, PARTS): EDL_PART 0 holds the entry
// points and the fp32 kernels, parts 1-8 the 16 mask instances of one
// (pass, head dim, output dtype) of the bf16 kernels each. The tile
// loads, wgmma products and mask tests are flash_tc.cuh's, shared with
// the forward (flash_fwd.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_tc.cuh"

#ifndef EDL_PART
#define EDL_PART 0
#endif

// What the entry points pass to the bf16 kernels' launchers.
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

// The launcher of one (pass, head dim, output dtype), defined by its
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

}  // namespace edl_bwd

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// A row's lse in the exp2 domain, as the kernels subtract it; a sentinel
// of either sign (|lse| >= 0.5e30) becomes +1e30, so P = exp2(s - it) = 0.
__device__ __forceinline__ float lse_log2(float lse) {
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
// The fp32 kernels and the entry points: part 0.
#if EDL_PART == 0
namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

template <int D>
constexpr size_t dq_smem_bytes() {
  // qs, dos, ks, vs: [64][D+1]; ds: [64][BK+1]; row lse, delta
  return sizeof(float) * (4 * 64 * (D + 1) + BQ * (BK + 1) + 2 * BQ);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // ks, vs, qs, dos: [64][D+1]; ps, dss: [BQ][BK+1]; row lse, delta
  return sizeof(float) * (4 * 64 * (D + 1) + 2 * BQ * (BK + 1) + 2 * BQ);
}

// Stage rows [r0, r0 + 64) of a [rows, D] matrix as fp32 into a padded
// [64][D+1] shared tile, times `mul`; rows past `rows` are zero.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0,
                                      int rows, float mul) {
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, e = i % D;
    dst[r * DP + e] =
        (r0 + r < rows) ? to_f(src[(size_t)(r0 + r) * D + e]) * mul : 0.f;
  }
}

// Whether query position qp sees key position kp under the window and
// segment masks (the causal and ragged-edge tests are the caller's).
__device__ __forceinline__ bool in_window(int qp, int kp, int causal,
                                          int window) {
  return window <= 0 || (qp - kp < window && (causal || kp - qp < window));
}

template <typename T, typename TO, int D>
__global__ void __launch_bounds__(NT)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse, TO* __restrict__ dq,
                        float* __restrict__ delta,
                        const int* __restrict__ q_seg,
                        const int* __restrict__ k_seg, int h, int hkv, int lq,
                        int lk, float scale, int causal, int window,
                        int pos_offset) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int DP = D + 1;  // padded row stride: no bank conflicts
  constexpr int SP = BK + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + BQ * DP;
  float* ks = dos + BQ * DP;
  float* vs = ks + BK * DP;
  float* ds = vs + BK * DP;
  float* row_lse = ds + BQ * SP;  // lse * log2e
  float* row_delta = row_lse + BQ;
  __shared__ int qs_seg[BQ], ks_seg[BK];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / h;
  const int kvh = (bh % h) / (h / hkv);
  const size_t q_off = (size_t)bh * lq * D;
  const bool segs = q_seg != nullptr;
  if (segs && tid < BQ)
    qs_seg[tid] = q0 + tid < lq ? q_seg[(size_t)b * lq + q0 + tid] : -1;
  const T* kb = k + (size_t)(b * hkv + kvh) * lk * D;
  const T* vb = v + (size_t)(b * hkv + kvh) * lk * D;

  stage<T, D>(qs, q + q_off, q0, lq, scale * LOG2E);
  stage<T, D>(dos, dout + q_off, q0, lq, 1.f);
  __syncthreads();
  {  // delta = rowsum(dO * O): four neighbouring lanes share one row
    const int r = tid / 4, part = tid % 4;
    const bool in = q0 + r < lq;
    float sum = 0.f;
    if (in) {
      const T* orow = o + q_off + (size_t)(q0 + r) * D;
      for (int e = part; e < D; e += 4) sum += dos[r * DP + e] * to_f(orow[e]);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (part == 0) {
      row_delta[r] = sum;
      row_lse[r] = in ? lse_log2(lse[(size_t)bh * lq + q0 + r]) : 0.f;
      if (in) delta[(size_t)bh * lq + q0 + r] = sum;
    }
  }

  // 16 x 16 thread grid: rows ty*4 + i, columns tx + 16*j
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  // the forward's key range: up to the diagonal (causal), from the
  // window of the tile's first row, to that of its last (not causal),
  // at the rows' shifted positions p0 ..
  const int p0 = q0 + pos_offset;
  int k_lo = 0, k_end = causal ? min(lk, p0 + BQ) : lk;
  if (window > 0) {
    k_lo = max(0, p0 - window + 1);
    if (!causal) k_end = min(lk, p0 + BQ - 1 + window);
  }
  k_end = max(k_end, 0);
  const int n_kt = (k_end + BK - 1) / BK;
  for (int kt = k_lo / BK; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    stage<T, D>(ks, kb, k0, lk, 1.f);
    stage<T, D>(vs, vb, k0, lk, 1.f);
    if (segs && tid < BK)
      ks_seg[tid] = k0 + tid < lk ? k_seg[(size_t)b * lk + k0 + tid] : -1;
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int e = 0; e < D; ++e) {
      float a[4], g[4], c[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qs[(ty * 4 + i) * DP + e];
        g[i] = dos[(ty * 4 + i) * DP + e];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = ks[(tx + 16 * j) * DP + e];
        w[j] = vs[(tx + 16 * j) * DP + e];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += a[i] * c[j];
          dp[i][j] += g[i] * w[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, c = tx + 16 * j;
        const int qp = p0 + r, kp = k0 + c;
        const bool valid = q0 + r < lq && kp < lk && (!causal || kp <= qp) &&
                           in_window(qp, kp, causal, window) &&
                           (!segs || qs_seg[r] == ks_seg[c]);
        const float p = valid ? exp2f(s[i][j] - row_lse[r]) : 0.f;
        ds[r * SP + c] = p * (dp[i][j] - row_delta[r]) * scale;
      }
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = ds[(ty * 4 + i) * SP + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kv = ks[kk * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += dsv[i] * kv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r < lq) {
      TO* row = dq + q_off + (size_t)(q0 + r) * D;
#pragma unroll
      for (int j = 0; j < DJ; ++j) store(row + tx + 16 * j, acc[i][j]);
    }
  }
}

template <typename T, typename TO, int D>
__global__ void __launch_bounds__(NT)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, TO* __restrict__ dk,
                         TO* __restrict__ dv, const int* __restrict__ q_seg,
                         const int* __restrict__ k_seg, int h, int hkv,
                         int lq, int lk, float scale, int causal,
                         int window, int pos_offset) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int DP = D + 1;
  constexpr int SP = BK + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + BK * DP;
  float* qs = vs + BK * DP;
  float* dos = qs + BQ * DP;
  float* ps = dos + BQ * DP;  // P as [q row][key]
  float* dss = ps + BQ * SP;  // dS as [q row][key]
  float* row_lse = dss + BQ * SP;
  float* row_delta = row_lse + BQ;
  __shared__ int qs_seg[BQ], ks_seg[BK];

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BK;
  const int bkv = blockIdx.y;  // b * hkv + kv head
  const int b = bkv / hkv;
  const int kvh = bkv % hkv;
  const int group = h / hkv;
  const size_t kv_off = (size_t)bkv * lk * D;
  const float slog = scale * LOG2E;

  stage<T, D>(ks, k + kv_off, k0, lk, 1.f);
  stage<T, D>(vs, v + kv_off, k0, lk, 1.f);
  const bool segs = q_seg != nullptr;
  if (segs && tid < BK)
    ks_seg[tid] = k0 + tid < lk ? k_seg[(size_t)b * lk + k0 + tid] : -1;

  // 16 x 16 thread grid: key rows ty*4 + i; score columns (q rows) and
  // output columns (head features) tx + 16*j
  const int ty = tid / 16, tx = tid % 16;
  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // the q rows that can see a key of the tile, by their positions
  // row + pos_offset: causal, from the diagonal on; under a window, those
  // before key k0 + BK - 1 + window, and (not causal) from key
  // k0 - window + 1 on
  int q_lo = causal ? k0 - pos_offset : 0, q_end = lq;
  if (window > 0) {
    q_end = min(lq, k0 + BK - 1 + window - pos_offset);
    if (!causal) q_lo = k0 - window + 1 - pos_offset;
  }
  q_lo = min(max(q_lo, 0), lq);
  q_end = max(q_end, 0);
  const int qt_start = q_lo / BQ;
  const int qt_end = (q_end + BQ - 1) / BQ;
  for (int g = 0; g < group; ++g) {
    const int qh = b * h + kvh * group + g;
    const size_t q_off = (size_t)qh * lq * D;
    for (int qt = qt_start; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      const int p0 = q0 + pos_offset;
      __syncthreads();  // the previous tile's readers are done
      stage<T, D>(qs, q + q_off, q0, lq, 1.f);
      stage<T, D>(dos, dout + q_off, q0, lq, 1.f);
      if (tid < BQ) {
        const bool in = q0 + tid < lq;
        const size_t row = (size_t)qh * lq + q0 + tid;
        row_lse[tid] = in ? lse_log2(lse[row]) : 0.f;
        row_delta[tid] = in ? delta[row] : 0.f;
        if (segs)
          qs_seg[tid] = in ? q_seg[(size_t)b * lq + q0 + tid] : -1;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
      for (int e = 0; e < D; ++e) {
        float a[4], w[4], c[4], g2[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = ks[(ty * 4 + i) * DP + e];
          w[i] = vs[(ty * 4 + i) * DP + e];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          c[j] = qs[(tx + 16 * j) * DP + e];
          g2[j] = dos[(tx + 16 * j) * DP + e];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] += a[i] * c[j];
            dp[i][j] += w[i] * g2[j];
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kr = ty * 4 + i, qr = tx + 16 * j;
          const int qp = p0 + qr, kp = k0 + kr;
          const bool valid = q0 + qr < lq && kp < lk &&
                             (!causal || kp <= qp) &&
                             in_window(qp, kp, causal, window) &&
                             (!segs || qs_seg[qr] == ks_seg[kr]);
          const float p = valid ? exp2f(s[i][j] * slog - row_lse[qr]) : 0.f;
          ps[qr * SP + kr] = p;
          dss[qr * SP + kr] = p * (dp[i][j] - row_delta[qr]) * scale;
        }
      __syncthreads();

      for (int qr = 0; qr < BQ; ++qr) {
        float pv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = ps[qr * SP + ty * 4 + i];
          dsv[i] = dss[qr * SP + ty * 4 + i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float gv = dos[qr * DP + tx + 16 * j];
          const float qv = qs[qr * DP + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][j] += pv[i] * gv;
            dk_acc[i][j] += dsv[i] * qv;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (k0 + r < lk) {
      TO* krow = dk + kv_off + (size_t)(k0 + r) * D;
      TO* vrow = dv + kv_off + (size_t)(k0 + r) * D;
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        store(krow + tx + 16 * j, dk_acc[i][j]);
        store(vrow + tx + 16 * j, dv_acc[i][j]);
      }
    }
  }
}

template <typename T, typename TO, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* dq, void* delta,
              const void* q_seg, const void* k_seg, int b, int h, int hkv,
              int lq, int lk, float scale, int causal, int window,
              int pos_offset, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  static bool configured = false;
  int err = set_smem(flash_bwd_dq_kernel<T, TO, D>, smem, &configured);
  if (err) return err;
  dim3 grid((lq + BQ - 1) / BQ, b * h);
  flash_bwd_dq_kernel<T, TO, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<TO*>(dq), static_cast<float*>(delta),
      static_cast<const int*>(q_seg), static_cast<const int*>(k_seg), h, hkv,
      lq, lk, scale, causal, window, pos_offset);
  return (int)cudaGetLastError();
}

template <typename T, typename TO, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               const void* q_seg, const void* k_seg, int b, int h, int hkv,
               int lq, int lk, float scale, int causal, int window,
               int pos_offset, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  static bool configured = false;
  int err = set_smem(flash_bwd_dkv_kernel<T, TO, D>, smem, &configured);
  if (err) return err;
  dim3 grid((lk + BK - 1) / BK, b * hkv);
  flash_bwd_dkv_kernel<T, TO, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<TO*>(dk), static_cast<TO*>(dv),
      static_cast<const int*>(q_seg), static_cast<const int*>(k_seg), h, hkv,
      lq, lk, scale, causal, window, pos_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// Both entry points: q_seg [b, lq] and k_seg [b, lk] int32 segment ids,
// or both NULL; window 0 = none, else the sliding window (lq == lk);
// pos_offset the shift of the query positions (any int; 0 = none);
// grad_f32 1 = write the gradients in fp32, 0 = in the input dtype.
// dtype 0 (float32) runs the fp32 kernels, 1 (bfloat16) the bf16
// tensor-core kernels, whose tensors must be 16-byte aligned.
static bool masks_ok(int h, int hkv, int window, const void* q_seg,
                    const void* k_seg) {
  return hkv > 0 && h % hkv == 0 && window >= 0 &&
         (q_seg == nullptr) == (k_seg == nullptr);
}

template <bool DKV>
static int launch_bf16(const edl_bwd::Args& a, int d, int grad_f32) {
  using edl_bwd::launch_part;
  if (d == 64)
    return grad_f32 ? launch_part<DKV, 64, true>(a)
                    : launch_part<DKV, 64, false>(a);
  if (d == 128)
    return grad_f32 ? launch_part<DKV, 128, true>(a)
                    : launch_part<DKV, 128, false>(a);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!masks_ok(h, hkv, window, q_seg, k_seg))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    const edl_bwd::Args a{q, k, v, o, dout, lse, dq, nullptr, nullptr, delta,
                          static_cast<const int*>(q_seg),
                          static_cast<const int*>(k_seg), b, h, hkv, lq, lk,
                          scale, causal, window, pos_offset, s};
    return launch_bf16<false>(a, d, grad_f32);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  if (d == 64)
    return launch_dq<float, float, 64>(q, k, v, o, dout, lse, dq, delta,
                                       q_seg, k_seg, b, h, hkv, lq, lk,
                                       scale, causal, window, pos_offset, s);
  if (d == 128)
    return launch_dq<float, float, 128>(q, k, v, o, dout, lse, dq, delta,
                                        q_seg, k_seg, b, h, hkv, lq, lk,
                                        scale, causal, window, pos_offset, s);
  return (int)cudaErrorInvalidValue;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!masks_ok(h, hkv, window, q_seg, k_seg))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    const edl_bwd::Args a{q, k, v, nullptr, dout, lse, nullptr, dk, dv,
                          const_cast<void*>(delta),
                          static_cast<const int*>(q_seg),
                          static_cast<const int*>(k_seg), b, h, hkv, lq, lk,
                          scale, causal, window, pos_offset, s};
    return launch_bf16<true>(a, d, grad_f32);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  if (d == 64)
    return launch_dkv<float, float, 64>(q, k, v, dout, lse, delta, dk, dv,
                                        q_seg, k_seg, b, h, hkv, lq, lk,
                                        scale, causal, window, pos_offset, s);
  if (d == 128)
    return launch_dkv<float, float, 128>(q, k, v, dout, lse, delta, dk, dv,
                                         q_seg, k_seg, b, h, hkv, lq, lk,
                                         scale, causal, window, pos_offset,
                                         s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block, in bytes (-1: no such kernel):
// dkv 0 = the dq pass, 1 = the dk/dv pass; dtype and d as above.
extern "C" int edl_flash_bwd_smem_bytes(int dkv, int dtype, int d) {
  if (dtype == 1 && (d == 64 || d == 128))
    return (int)(d == 64 ? tc_smem_bytes<64>() : tc_smem_bytes<128>());
  if (dtype == 0 && d == 64)
    return (int)(dkv ? dkv_smem_bytes<64>() : dq_smem_bytes<64>());
  if (dtype == 0 && d == 128)
    return (int)(dkv ? dkv_smem_bytes<128>() : dq_smem_bytes<128>());
  return -1;
}

#endif  // EDL_PART == 0

// ---------------------------------------------------------------------------
// The bf16 kernels: wgmma on tensor cores, parts 1-8.
#if EDL_PART > 0
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

  // the forward's key range (_kv_stream_clamp), as the scalar kernel
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
  // scalar kernel
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

#endif  // EDL_PART > 0
