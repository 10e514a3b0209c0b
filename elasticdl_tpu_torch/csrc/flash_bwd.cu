// Flash-attention backward for Hopper (sm_90a): two kernels.
//
// Replace the TPU kernels of elasticdl_tpu/ops/attention.py::_flash_backward:
//   * flash_bwd_dq_kernel  <- _flash_bwd_dq_kernel  (pl.pallas_call at :1415)
//   * flash_bwd_dkv_kernel <- _flash_bwd_dkv_kernel (pl.pallas_call at :1446)
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
// What bounds them on the H100: at the training shapes (b = 8, h = 8,
// l = 1024, d = 128, causal) the dq pass does 6 * d operations per
// visible (query, key) pair and the dk/dv pass 8 * d, against a few
// bytes per row moved, so both are bound by operations, i.e. by how fast
// a block multiplies. Like the forward (flash_fwd.cu), this first version
// multiplies with scalar fp32 FMAs out of shared memory (no tensor
// cores), far below the bf16 peak; wgmma with TMA-fed tiles is later
// work.
//
// Design. Both kernels use 64 x 64 tiles and 256 threads in a 16 x 16
// grid; a thread owns a 4 x 4 block of a score tile and a 4 x D/16 block
// of an output tile, kept in registers.
//   dq:  grid (q tile, b*h). The Q tile (scaled by scale*log2e, so the
//        kernel works in the exp2 domain as the TPU kernel does) and the
//        dO tile are staged once; delta = rowsum(dO * O) is computed for
//        the tile's rows and written out for the dk/dv kernel (the TPU
//        code computes it with a jnp sum before the kernels). The block
//        walks the key tiles up to the causal diagonal: S and dP in one
//        pass over d, P = exp2(S - lse * log2e), dS into shared memory,
//        then dQ += dS K into registers.
//   dkv: grid (key tile, b*hkv). K and V are staged once; the block walks
//        every (q head of the group, q tile) pair, as the TPU grid's
//        streamed axis does (_dkv_q_spec), starting at the first q tile
//        that reaches the key tile when causal (_q_stream_clamp). dK and
//        dV accumulate in registers across the whole group, so they come
//        out group-summed without atomics and are deterministic.
// Fully masked tiles are skipped (never loaded), as _block_run skips
// them: the dq pass walks the key tiles of the forward's window range
// (_kv_stream_clamp), the dk/dv pass, per key tile and group member, the
// q tiles from the first that reaches the tile (causal: the diagonal;
// window, not causal: key k0 - window + 1) to the last whose window holds
// one of its keys (_q_stream_clamp), all shifted by pos_offset. The
// offset is folded into each tile's first query position once, outside
// the inner loops; the bounds are clamped to [0, lk] or [0, lq] before
// they are divided into tiles (C division truncates toward zero), so an
// offset that leaves no visible pair runs no tile and writes zeros. Segment ids ride beside the tiles
// in shared memory; no tile is skipped for segments. The blocks need
// ~146 KB (dq) and ~162 KB (dk/dv) of shared memory at d = 128, so each
// launch raises the dynamic shared-memory limit first, and every launch
// returns cudaGetLastError.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

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

// A row's lse in the exp2 domain, as the kernels subtract it; a sentinel
// of either sign (|lse| >= 0.5e30) becomes +1e30, so P = exp2(s - it) = 0.
__device__ __forceinline__ float lse_log2(float lse) {
  return fabsf(lse) >= 5e29f ? 1e30f : lse * LOG2E;
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

template <typename K>
int set_smem(K kernel, size_t bytes, bool* configured) {
  if (*configured) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  *configured = true;
  return 0;
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
static bool masks_ok(int h, int hkv, int window, const void* q_seg,
                     const void* k_seg) {
  return hkv > 0 && h % hkv == 0 && window >= 0 &&
         (q_seg == nullptr) == (k_seg == nullptr);
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
#define EDL_DQ(T, TO, D)                                                  \
  return launch_dq<T, TO, D>(q, k, v, o, dout, lse, dq, delta, q_seg,    \
                             k_seg, b, h, hkv, lq, lk, scale, causal,    \
                             window, pos_offset, s)
  if (dtype == 0 && d == 64) EDL_DQ(float, float, 64);
  if (dtype == 0 && d == 128) EDL_DQ(float, float, 128);
  if (dtype == 1 && d == 64 && grad_f32) EDL_DQ(__nv_bfloat16, float, 64);
  if (dtype == 1 && d == 128 && grad_f32) EDL_DQ(__nv_bfloat16, float, 128);
  if (dtype == 1 && d == 64) EDL_DQ(__nv_bfloat16, __nv_bfloat16, 64);
  if (dtype == 1 && d == 128) EDL_DQ(__nv_bfloat16, __nv_bfloat16, 128);
#undef EDL_DQ
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
#define EDL_DKV(T, TO, D)                                                 \
  return launch_dkv<T, TO, D>(q, k, v, dout, lse, delta, dk, dv, q_seg,  \
                              k_seg, b, h, hkv, lq, lk, scale, causal,   \
                              window, pos_offset, s)
  if (dtype == 0 && d == 64) EDL_DKV(float, float, 64);
  if (dtype == 0 && d == 128) EDL_DKV(float, float, 128);
  if (dtype == 1 && d == 64 && grad_f32) EDL_DKV(__nv_bfloat16, float, 64);
  if (dtype == 1 && d == 128 && grad_f32)
    EDL_DKV(__nv_bfloat16, float, 128);
  if (dtype == 1 && d == 64) EDL_DKV(__nv_bfloat16, __nv_bfloat16, 64);
  if (dtype == 1 && d == 128) EDL_DKV(__nv_bfloat16, __nv_bfloat16, 128);
#undef EDL_DKV
  return (int)cudaErrorInvalidValue;
}
