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
// What bounds it on the H100: at the prefill shapes of the serving path
// (head_dim 128, a few hundred to 1024 rows per head) the work is
// about 4 * lq * lk * d / 2 operations per head against 4 * l * d bytes
// moved, so it is bound by operations, i.e. by how fast the block can
// multiply. This first version multiplies with scalar fp32 FMAs out of
// shared memory (no tensor cores), so it runs far below the bf16 peak;
// wgmma with TMA-fed tiles is later work.
//
// Design: grid (q-tile, b*h), BQ = BK = 64 rows, 256 threads. The Q
// tile is staged once in shared memory (scaled by scale*log2e so the
// inner loop uses exp2), then every key tile that is not wholly above
// the causal diagonal is staged (K, V as fp32) and consumed: S = Q K^T
// in a 4x4 register block per thread, masked (ragged key edge, causal)
// in place, a per-row online softmax by four threads per row with warp
// shuffles, and O += P V into a 4 x D/16 register block per thread.
// Masked scores contribute exactly 0 (they are never exponentiated), so
// a row with no visible key keeps l = 0. Ragged query rows are
// zero-filled and never written. The block needs ~114 KB of shared
// memory at d = 128, so the launch raises the dynamic shared-memory
// limit first.
//
// Window skip (_kv_stream_clamp, _block_run): the block reads only the
// key tiles that hold a key inside some row's window, from the tile of
// key p0 - window + 1 up to the diagonal (causal) or to key
// p0 + BQ - 2 + window (not causal), p0 = q0 + pos_offset being the
// tile's first query position, so a windowed row's work grows with the
// window, not the sequence. The offset is folded into p0 once, outside
// the tile loop; the bounds are clamped to [0, lk] before they are
// divided into tiles (C division truncates toward zero), so an offset
// that leaves no visible key runs no tile. The kernel is compiled with
// and without the offset (OFFSET): a launch at offset 0, every call but
// a ring rotation's, runs the instance without it. One kernel for both
// ran the unmasked causal forward 6% slower on an H100 (b 8, h 8,
// l 1024, d 128, bf16: 1.163 against 1.100 ms,
// elasticdl_tpu_torch/tools/flash_timing.py); the two instances match
// the kernel from before the offset to 0.1%. Segment ids are staged per tile beside
// Q and K (one id row per batch row, shared by every head); as in the TPU
// kernel, no tile is skipped for segments.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int D>
constexpr size_t smem_bytes() {
  // qs, ks: [64][D+1]; vs: [64][D]; ss: [64][BK+1]; row m, l, corr
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1) + 3 * BQ);
}

template <typename T, int D, bool OFFSET>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
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
  const T* qb = q + (size_t)bh * lq * D;
  const T* kb = k + (size_t)(b * hkv + kvh) * lk * D;
  const T* vb = v + (size_t)(b * hkv + kvh) * lk * D;
  const float qscale = scale * LOG2E;
  const bool segs = q_seg != nullptr;
  if (segs && tid < BQ)
    qs_seg[tid] = q0 + tid < lq ? q_seg[(size_t)b * lq + q0 + tid] : -1;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, e = i % D;
    qs[r * DP + e] =
        (q0 + r < lq) ? to_f(qb[(size_t)(q0 + r) * D + e]) * qscale : 0.f;
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
      ks[r * DP + e] = in ? to_f(kb[(size_t)(k0 + r) * D + e]) : 0.f;
      vs[r * D + e] = in ? to_f(vb[(size_t)(k0 + r) * D + e]) : 0.f;
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
      T* orow = o + ((size_t)bh * lq + q0 + r) * D;
#pragma unroll
      for (int j = 0; j < DJ; ++j) store(orow + tx + 16 * j, acc[i][j] * inv);
    }
  }
  if (tid < BQ && q0 + tid < lq) {
    const float l = row_l[tid];
    lse[(size_t)bh * lq + q0 + tid] =
        l > 0.f ? (row_m[tid] + log2f(l)) * LN2 : -NEG_INF;
  }
}

template <typename T, int D, bool OFFSET>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           const void* q_seg, const void* k_seg, int b, int h, int hkv,
           int lq, int lk, float scale, int causal, int window,
           int pos_offset, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D, OFFSET>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((lq + BQ - 1) / BQ, b * h);
  flash_fwd_kernel<T, D, OFFSET><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      static_cast<const int*>(q_seg), static_cast<const int*>(k_seg), h, hkv,
      lq, lk, scale, causal, window, pos_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// q [b, h, lq, d], k/v [b, hkv, lk, d], o like q, lse [b, h, lq] fp32;
// q_seg [b, lq] and k_seg [b, lk] int32 segment ids, or both NULL; all
// contiguous. window: 0 = none, else the sliding window (lq == lk).
// pos_offset: the shift of the query positions (any int; 0 = none).
// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the
// launch (0 = launched).
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
#define EDL_FWD(T, D)                                                     \
  return pos_offset != 0                                                 \
             ? launch<T, D, true>(q, k, v, o, lse, q_seg, k_seg, b, h,   \
                                  hkv, lq, lk, scale, causal, window,    \
                                  pos_offset, s)                         \
             : launch<T, D, false>(q, k, v, o, lse, q_seg, k_seg, b, h,  \
                                   hkv, lq, lk, scale, causal, window,   \
                                   0, s)
  if (dtype == 0 && d == 64) EDL_FWD(float, 64);
  if (dtype == 0 && d == 128) EDL_FWD(float, 128);
  if (dtype == 1 && d == 64) EDL_FWD(__nv_bfloat16, 64);
  if (dtype == 1 && d == 128) EDL_FWD(__nv_bfloat16, 128);
#undef EDL_FWD
  return (int)cudaErrorInvalidValue;
}
