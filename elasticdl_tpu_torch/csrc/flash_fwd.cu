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
// version). fp32 inputs are not rounded, and keep the scalar fp32
// kernel: bf16 tensor cores would miss the fp32 limits. ViT-Base trains
// in fp32 and runs it 12 times a step (d = 64, not causal); it has not
// been redesigned for the H100 yet. The entry point picks the kernel by
// dtype, never by a failed launch.
//
// What bounds it on the H100: 4 * d operations per visible (query, key)
// pair against 4 * d bytes per row moved (q, k, v read and out written
// once), so from a few hundred rows per head on it is bound by
// operations, i.e. by the tensor cores' bf16 rate.
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
// Design of the fp32 kernel (flash_fwd_kernel): grid (q-tile, b*h),
// BQ = BK = 64 rows, 256 threads. The Q tile is staged once in shared
// memory (scaled by scale*log2e so the inner loop uses exp2), then
// every key tile that is not wholly above the causal diagonal is staged
// (K, V as fp32) and consumed: S = Q K^T in a 4x4 register block per
// thread, masked (ragged key edge, causal) in place, a per-row online
// softmax by four threads per row with warp shuffles, and O += P V into
// a 4 x D/16 register block per thread. Masked scores contribute exactly
// 0 (they are never exponentiated), so a row with no visible key keeps
// l = 0. Ragged query rows are zero-filled and never written. The block
// needs ~114 KB of shared memory at d = 128, so the launch raises the
// dynamic shared-memory limit first.
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
// with and without the offset (OFFSET): a launch at offset 0, every call
// but a ring rotation's, runs the instance without it (one fp32 kernel
// for both ran 6% slower, PR 6). Segment ids are staged per tile beside
// K (one id row per batch row, shared by every head); as in the TPU
// kernel, no tile is skipped for segments.
//
// Build: this file is compiled as five objects, one nvcc each, linked
// into one library (ops/_build.py, PARTS): EDL_PART 0 holds the entry
// points and the fp32 kernel, parts 1-4 the 8 mask instances (window,
// segments, offset) of one (head dim, causal) of the bf16 kernel each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tc.cuh"

#ifndef EDL_PART
#define EDL_PART 0
#endif

// What the entry point passes to the bf16 kernel's launchers.
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

// The launcher of one (head dim, causal), defined by its part; it picks
// the mask instance from the runtime flags.
template <int D, bool CAUSAL>
int launch_part(const Args& a);
template <> int launch_part<64, false>(const Args&);
template <> int launch_part<64, true>(const Args&);
template <> int launch_part<128, false>(const Args&);
template <> int launch_part<128, true>(const Args&);

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
// The fp32 kernel and the entry points: part 0.
#if EDL_PART == 0
namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;

template <int D>
constexpr size_t smem_bytes() {
  // qs, ks: [64][D+1]; vs: [64][D]; ss: [64][BK+1]; row m, l, corr
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1) + 3 * BQ);
}

template <int D, bool OFFSET>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, const int* __restrict__ q_seg,
                     const int* __restrict__ k_seg, int h, int hkv, int lq,
                     int lk, float scale, int causal, int window,
                     int pos_offset) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int DP = D + 1;  // padded row stride: no bank conflicts
  constexpr int SP = BK + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + BQ * DP;
  float* vs = ks + BK * DP;
  float* ss = vs + BK * D;
  float* row_m = ss + BQ * SP;
  float* row_l = row_m + BQ;
  float* row_c = row_l + BQ;
  __shared__ int qs_seg[BQ], ks_seg[BK];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / h;
  const int kvh = (bh % h) / (h / hkv);
  const float* qb = q + (size_t)bh * lq * D;
  const float* kb = k + (size_t)(b * hkv + kvh) * lk * D;
  const float* vb = v + (size_t)(b * hkv + kvh) * lk * D;
  const float qscale = scale * LOG2E;
  const bool segs = q_seg != nullptr;
  if (segs && tid < BQ)
    qs_seg[tid] = q0 + tid < lq ? q_seg[(size_t)b * lq + q0 + tid] : -1;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, e = i % D;
    qs[r * DP + e] = (q0 + r < lq) ? qb[(size_t)(q0 + r) * D + e] * qscale
                                   : 0.f;
  }
  if (tid < BQ) {
    row_m[tid] = NEG_INF;
    row_l[tid] = 0.f;
  }

  // 16 x 16 thread grid: rows ty*4 + i, columns tx + 16*j
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  // causal: keys past the tile's last position are invisible to all its
  // rows; window: keys before p0 - window + 1 are invisible to all of
  // them, and (not causal) keys past p0 + BQ - 2 + window too
  const int p0 = OFFSET ? q0 + pos_offset : q0;
  int k_lo = 0, k_end = causal ? min(lk, p0 + BQ) : lk;
  if (window > 0) {
    k_lo = max(0, p0 - window + 1);
    if (!causal) k_end = min(lk, p0 + BQ - 1 + window);
  }
  if (OFFSET) k_end = max(k_end, 0);
  const int n_kt = (k_end + BK - 1) / BK;
  for (int kt = k_lo / BK; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, e = i % D;
      const bool in = k0 + r < lk;
      ks[r * DP + e] = in ? kb[(size_t)(k0 + r) * D + e] : 0.f;
      vs[r * D + e] = in ? vb[(size_t)(k0 + r) * D + e] : 0.f;
    }
    if (segs && tid < BK)
      ks_seg[tid] = k0 + tid < lk ? k_seg[(size_t)b * lk + k0 + tid] : -1;
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int e = 0; e < D; ++e) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * DP + e];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = ks[(tx + 16 * j) * DP + e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += a[i] * c[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, c = tx + 16 * j;
        const int kp = k0 + c, qp = p0 + r;
        bool valid = kp < lk && (!causal || kp <= qp);
        if (window > 0)
          valid = valid && qp - kp < window && (causal || kp - qp < window);
        if (segs) valid = valid && qs_seg[r] == ks_seg[c];
        ss[r * SP + c] = valid ? s[i][j] : NEG_INF;
      }
    __syncthreads();

    {  // online softmax: four neighbouring lanes share one row
      const int r = tid / 4, part = tid % 4;
      float mx = NEG_INF;
      for (int c = part; c < BK; c += 4) mx = fmaxf(mx, ss[r * SP + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = part; c < BK; c += 4) {
        const float sv = ss[r * SP + c];
        const float p = sv > 0.5f * NEG_INF ? exp2f(sv - m_new) : 0.f;
        ss[r * SP + c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = exp2f(m_prev - m_new);
        row_l[r] = row_l[r] * corr + sum;
        row_m[r] = m_new;
        row_c[r] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = row_c[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ss[(ty * 4 + i) * SP + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = vs[kk * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += p[i] * vv;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r < lq) {
      const float inv = 1.f / fmaxf(row_l[r], 1e-30f);
      float* orow = o + ((size_t)bh * lq + q0 + r) * D;
#pragma unroll
      for (int j = 0; j < DJ; ++j) orow[tx + 16 * j] = acc[i][j] * inv;
    }
  }
  if (tid < BQ && q0 + tid < lq) {
    const float l = row_l[tid];
    lse[(size_t)bh * lq + q0 + tid] =
        l > 0.f ? (row_m[tid] + log2f(l)) * LN2 : -NEG_INF;
  }
}

template <int D, bool OFFSET>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           const void* q_seg, const void* k_seg, int b, int h, int hkv,
           int lq, int lk, float scale, int causal, int window,
           int pos_offset, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;
  int err = edl_tc::set_smem(flash_fwd_kernel<D, OFFSET>, smem, &configured);
  if (err) return err;
  dim3 grid((lq + BQ - 1) / BQ, b * h);
  flash_fwd_kernel<D, OFFSET><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), static_cast<const int*>(q_seg),
      static_cast<const int*>(k_seg), h, hkv, lq, lk, scale, causal, window,
      pos_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// q [b, h, lq, d], k/v [b, hkv, lk, d], o like q, lse [b, h, lq] fp32;
// q_seg [b, lq] and k_seg [b, lk] int32 segment ids, or both NULL; all
// contiguous. window: 0 = none, else the sliding window (lq == lk).
// pos_offset: the shift of the query positions (any int; 0 = none).
// dtype: 0 = float32 (the scalar kernel), 1 = bfloat16 (the tensor-core
// kernel, whose q, k, v must be 16-byte aligned). Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int edl_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, const void* q_seg,
                             const void* k_seg, int b, int h, int hkv,
                             int lq, int lk, int d, float scale, int causal,
                             int window, int pos_offset, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hkv <= 0 || h % hkv != 0 || window < 0 ||
      (q_seg == nullptr) != (k_seg == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    using edl_fwd::launch_part;
    const edl_fwd::Args a{q, k, v, o, lse,
                          static_cast<const int*>(q_seg),
                          static_cast<const int*>(k_seg), b, h, hkv, lq, lk,
                          scale, causal, window, pos_offset, s};
    if (d == 64)
      return causal ? launch_part<64, true>(a) : launch_part<64, false>(a);
    if (d == 128)
      return causal ? launch_part<128, true>(a) : launch_part<128, false>(a);
    return (int)cudaErrorInvalidValue;
  }
#define EDL_FWD(D)                                                        \
  return pos_offset != 0                                                 \
             ? launch<D, true>(q, k, v, o, lse, q_seg, k_seg, b, h, hkv, \
                               lq, lk, scale, causal, window, pos_offset,\
                               s)                                        \
             : launch<D, false>(q, k, v, o, lse, q_seg, k_seg, b, h,     \
                                hkv, lq, lk, scale, causal, window, 0, s)
  if (dtype == 0 && d == 64) EDL_FWD(64);
  if (dtype == 0 && d == 128) EDL_FWD(128);
#undef EDL_FWD
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block in bytes of the kernel for dtype
// (0 float32, 1 bfloat16) and d; -1 where there is none. Reporting only.
extern "C" int edl_flash_fwd_smem_bytes(int dtype, int d) {
  if (dtype == 1 && (d == 64 || d == 128))
    return (int)(d == 64 ? tc_smem_bytes<64>() : tc_smem_bytes<128>());
  if (dtype == 0 && (d == 64 || d == 128))
    return (int)(d == 64 ? smem_bytes<64>() : smem_bytes<128>());
  return -1;
}

#endif  // EDL_PART == 0

// ---------------------------------------------------------------------------
// The bf16 kernel: wgmma on tensor cores, parts 1-4.
#if EDL_PART > 0
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

#endif  // EDL_PART > 0
