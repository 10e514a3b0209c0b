// Paged decode attention partials for Hopper (sm_90a).
//
// Replaces the TPU kernel elasticdl_tpu/ops/attention.py::_paged_kernel
// (launched by _paged_decode_fused through pl.pallas_call). Same
// function: for each (sequence, kv head), the online-softmax partials
// (o, l, m) of its group*t query rows over the cached K/V rows that its
// block table names in the shared [num_blocks, block_size, hkv, d]
// arenas, masked by k_pos < length; m is returned in natural-log units.
// The current-tile merge and the finalize stay outside, in PyTorch.
//
// Sliding window (`window` > 0; _paged_valid's window term): row r of the
// group-major (group * t) query axis is tile token r % t, at position
// length + r % t, and sees pool rows k_pos > length + r % t - window
// (_paged_kernel's row_pos). A row that sees none (window <= r % t + 1)
// keeps the partials (0, 0, -1e30). Both kernels walk the keys from
// position length - window + 1, the first that any row of the tile can
// see, so a windowed decode reads about window rows, not length.
//
// What bounds it on the H100: at t = 1, bytes (each cached row is read
// once and used for group*t dot products, about two operations per
// byte); for a 128-row suffix tile, fp32 operations on the CUDA cores.
// The arithmetic is fp32 throughout, as the TPU kernel's (K/V cast to
// fp32, fp32 dots): no tensor-core product. The kernels read only what
// the mask keeps: they stop at the sequence's length and skip -1
// (unallocated) slots without reading them, where the TPU kernel streams
// every table slot and masks. Query rows are prescaled by scale on the
// host and by log2e here, so the loops use exp2; masked scores
// contribute exactly 0, so a row that sees no pool row leaves
// (o, l, m) = (0, 0, -1e30).
//
// Arenas are fp32, bf16 or int8. int8 arenas (the TPU kernel's quantized
// branch, _paged_kernel's `quantized`) come with fp32 per-row scale pools
// [num_blocks, block_size, hkv, 1], read beside the rows; the dequantize
// runs in registers and no float copy of a row is ever written. The
// split kernel folds each key row's scale into its score and each value
// row's scale into its softmax weight (the JAX scan's deferral: the
// softmax denominator takes the weight unscaled); the tile kernel
// multiplies each staged row element by its row scale (the TPU kernel's
// choice). The two differ only by rounding.
//
// Build: this file is compiled as three objects, one nvcc each, linked
// into one library (ops/_build.py, PARTS): EDL_PART 0 holds the entry
// points and the fp32 arenas' instances, part 1 the bf16 arenas', part 2
// the int8 arenas'.
//
// Both kernels cut a sequence's live key range [lo, min(length, m*bs))
// evenly across n_split blocks (<= 8, about four blocks per SM over the
// card), which the launch groups into one thread-block cluster. Each
// block pushes its partials of each query row into the shared memory of
// the row's owner block (remote stores, through distributed shared
// memory); after one cluster barrier every owner merges its rows. So a
// call is one launch, with no scratch in device memory, and no block
// walks more of its sequence's keys than another.
//
// * split (n_rows <= 8: the decode step, GQA groups, short tiles): grid
//   (split, b*hkv), 4 warps. Every row is read 16 bytes a lane (4 fp32,
//   8 bf16 or 16 int8 columns; 8 int8 columns at 4 or more query rows),
//   so d*itemsize/16 lanes hold a row and a warp reads 32/(that) rows at
//   once; the sequence's table row is read into shared memory once,
//   beside its length. Each lane issues the loads of its next KR rows
//   (K, V and int8 scales, into registers) before it consumes the
//   current ones, so two steps of rows are in flight. Scores are reduced
//   across a row's lanes by shuffles; each lane group keeps its own
//   online softmax; groups merge by shuffles, warps through shared
//   memory, splits through the cluster.
// * tile (n_rows > 8: the shared-prefix suffix tile): grid (split, 32-row
//   tile, b*hkv), 4 warps. 32-key tiles (pool blocks gathered through
//   the table) are staged raw by cp.async into a 2-stage ring, one
//   __syncthreads per key tile. A thread holds a 4 x 2 (row x key) micro
//   tile of S = q K^T and a 4-row x d/16-column micro tile of O; the row
//   softmax reduces over the 16 lanes of a half warp by shuffles, and P
//   passes through shared memory within that half warp.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>
#include <type_traits>

#include "flash_tc.cuh"

namespace cg = cooperative_groups;

#ifndef EDL_PART
#define EDL_PART 0
#endif

namespace edl_paged {

// The pointers and sizes every launch takes, bundled so the dispatch
// over (dtype, d, rows) stays short.
struct PagedArgs {
  const void *qf, *k_pool, *v_pool, *k_scale, *v_scale, *table, *length;
  void *o, *l, *mx;
  int b, hkv, n_rows, m, bs, window, t;
  int n_split;  // blocks a cluster: chosen by paged_decode
};

// the split (tile = false) or tile kernel over arenas of T, head dim d;
// part 0 holds float's instances, part 1 bf16's, part 2 int8's
template <typename T>
int launch_dtype(bool tile, int d, const PagedArgs& a, cudaStream_t s);
template <>
int launch_dtype<float>(bool, int, const PagedArgs&, cudaStream_t);
template <>
int launch_dtype<__nv_bfloat16>(bool, int, const PagedArgs&, cudaStream_t);
template <>
int launch_dtype<int8_t>(bool, int, const PagedArgs&, cudaStream_t);

}  // namespace edl_paged

namespace {

using edl_paged::PagedArgs;

using edl_tc::cp_async16;
using edl_tc::cp_async_commit;
using edl_tc::cp_async_wait_all;
using edl_tc::smem_u32;

constexpr int NW = 4;  // warps a block, both kernels
constexpr int NT = NW * 32;
constexpr int MAX_SPLIT = 8;  // the portable cluster size
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <typename T>
constexpr bool kQuant = std::is_same<T, int8_t>::value;

// elements of T in 16 bytes: 4 fp32, 8 bf16, 16 int8
template <typename T>
constexpr int kPer16 = 16 / (int)sizeof(T);

// element e of T in the 32-bit words w, as fp32 (bf16 by its bits)
template <typename T>
__device__ __forceinline__ float word_elem(const uint32_t* w, int e) {
  if constexpr (std::is_same<T, float>::value) {
    return __uint_as_float(w[e]);
  } else if constexpr (kQuant<T>) {
    return (float)(int8_t)(w[e >> 2] >> (8 * (e & 3)));
  } else {
    return __uint_as_float((e & 1) ? (w[e >> 1] & 0xffff0000u)
                                   : (w[e >> 1] << 16));
  }
}

// 16 or 8 raw bytes of T as fp32
template <typename T>
__device__ __forceinline__ void unpack(const uint4& r,
                                       float (&out)[kPer16<T>]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int e = 0; e < kPer16<T>; ++e) out[e] = word_elem<T>(w, e);
}
template <typename T>
__device__ __forceinline__ void unpack(const uint2& r,
                                       float (&out)[kPer16<T> / 2]) {
  const uint32_t w[2] = {r.x, r.y};
#pragma unroll
  for (int e = 0; e < kPer16<T> / 2; ++e) out[e] = word_elem<T>(w, e);
}

// N consecutive elements of T at p (shared memory, 4-byte aligned, and
// 16-byte aligned where N * sizeof(T) >= 16) as fp32
template <typename T, int N>
__device__ __forceinline__ void load_f(const T* p, float (&out)[N]) {
  constexpr int BYTES = N * (int)sizeof(T);
  uint32_t w[BYTES / 4];
  if constexpr (BYTES >= 16) {
#pragma unroll
    for (int q = 0; q < BYTES / 16; ++q) {
      const uint4 x = reinterpret_cast<const uint4*>(p)[q];
      w[4 * q] = x.x; w[4 * q + 1] = x.y; w[4 * q + 2] = x.z;
      w[4 * q + 3] = x.w;
    }
  } else if constexpr (BYTES == 8) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    w[0] = x.x; w[1] = x.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int e = 0; e < N; ++e) out[e] = word_elem<T>(w, e);
}

// 4 bytes global -> shared, asynchronously; `bytes` 0 zero-fills
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          uint32_t bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// The keys [*k0, *k1) that split `split` of n_split walks: an even cut
// of the live keys from position len - window + 1 (0 without a window),
// the first any row can see, to min(len, m * bs).
__device__ __forceinline__ void key_range(int len, int m, int bs, int window,
                                          int n_split, int split, int* k0,
                                          int* k1) {
  const int hi = min(len, m * bs);
  const int lo = window > 0 ? min(hi, max(0, len - window + 1)) : 0;
  const int per = (hi - lo + n_split - 1) / n_split;
  *k0 = min(hi, lo + split * per);
  *k1 = min(hi, *k0 + per);
}

// Row i's window floor (rows are tile tokens i % t): it sees pool rows
// k_pos > floor; INT_MIN without a window.
__device__ __forceinline__ int window_floor(int len, int window, int t,
                                            int i) {
  return window > 0 ? len + i % t - window : INT_MIN;
}

// The cluster's merge. Row i of a block's partials belongs to block
// i % n_split of the cluster, which keeps, for each block `src`, slot
// [src][i / n_split] of D + 4 floats in its `recv` array (o, then m in
// log2 units and l; 16-byte aligned): recv holds n_split * ceil(rows /
// n_split) slots. Every block pushes its rows there by remote stores
// (they do not wait on a reply, where loads from another block's shared
// memory would), the cluster syncs, and each block merges the rows it
// owns from its own shared memory.

// slots a block's recv holds for `rows` rows: at most rows + 7
__host__ __device__ constexpr int recv_slots(int rows) {
  return rows + MAX_SPLIT - 1;
}

// the address, in the shared memory of row i's owner, of the slot that
// block `split` fills for it
__device__ __forceinline__ float* recv_slot(cg::cluster_group& cluster,
                                            float* recv, int i, int split,
                                            int n_split, int rows, int D) {
  const int per = (rows + n_split - 1) / n_split;
  return cluster.map_shared_rank(recv, i % n_split) +
         (size_t)(split * per + i / n_split) * (D + 4);
}

// After the pushes and a cluster.sync(): this block merges its rows and
// writes o [.., n_rows, D], l and m (natural log) for the rows r0 + i <
// n_rows, out_row0 the output row of i = 0.
template <int D>
__device__ __forceinline__ void merge_owned(
    const float* recv, int rows, int n_split, int split, size_t out_row0,
    int r0, int n_rows, float* __restrict__ o, float* __restrict__ l_out,
    float* __restrict__ m_out) {
  const int per = (rows + n_split - 1) / n_split;
  for (int idx = threadIdx.x; idx < per * D; idx += NT) {
    const int slot = idx / D, e = idx % D;
    const int i = slot * n_split + split;
    if (i >= rows || r0 + i >= n_rows) continue;
    float big = NEG_INF;
    for (int src = 0; src < n_split; ++src)
      big = fmaxf(big, recv[(size_t)(src * per + slot) * (D + 4) + D]);
    float out = 0.f, l = 0.f;
    for (int src = 0; src < n_split; ++src) {
      const float* from = recv + (size_t)(src * per + slot) * (D + 4);
      const float w = exp2f(from[D] - big);
      out += from[e] * w;
      l += from[D + 1] * w;
    }
    const size_t row = out_row0 + i;
    o[row * D + e] = out;
    if (e == 0) {
      l_out[row] = l;
      m_out[row] = l > 0.f ? big * LN2 : NEG_INF;
    }
  }
}

// the cluster barrier in two halves: arrive at the kernel's start, wait
// before the first remote store, so no block writes into a block that
// has not started
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// ------------------------------------------------------------ split kernel

// rows each lane group reads a step, before the next step's loads
// (half for int8, whose 16-column lanes hold twice the values)
template <typename T, int NR>
constexpr int kSplitRows =
    NR >= 8 ? 1 : (NR >= 2 ? 2 : 4) / (kQuant<T> ? 2 : 1);

// blocks an SM must hold: five at one query row (the decode step): at
// four, an H100 cannot hold all 64 clusters of 8 of a decode step over 8
// sequences x 8 kv heads at once, and the last start a wave late
template <int NR>
constexpr int kSplitMinBlocks = NR == 1 ? 5 : (NR == 2 ? 4 : 1);

// bytes of a row a lane reads: 16, but 8 for int8 arenas at 4 or more
// query rows, whose 16 columns a lane would need 16 accumulators a row
template <typename T, int NR>
constexpr int kLaneBytes = kQuant<T> && NR >= 4 ? 8 : 16;

// one step's rows of a lane: raw K / V bytes (R: uint4 or uint2) and,
// for int8, their scales
template <typename R, int KR>
struct Rows {
  R k[KR], v[KR];
  float ks[KR], vs[KR];
  bool ok[KR];  // read (in range, slot allocated)
};

// One block per (split, sequence * kv head), a cluster per sequence * kv
// head; NR = n_rows rounded up to a power of two (<= 8).
template <typename T, int D, int NR>
__global__ void __launch_bounds__(NT, kSplitMinBlocks<NR>) paged_split_kernel(
    const float* __restrict__ qf, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ table,
    const int* __restrict__ length, float* __restrict__ o,
    float* __restrict__ l_out, float* __restrict__ m_out, int hkv,
    int n_rows, int m, int bs, int window, int t) {
  constexpr int LB = kLaneBytes<T, NR>;
  using Raw = std::conditional_t<LB == 16, uint4, uint2>;
  constexpr int CPL = LB / (int)sizeof(T);  // columns a lane
  constexpr int LPR = D / CPL;    // lanes a row
  constexpr int G = 32 / LPR;     // rows a warp reads at once
  constexpr int KR = kSplitRows<T, NR>;
  constexpr int STEP = NW * G * KR;  // rows a block reads a step
  constexpr int QS = CPL + 4;  // floats per column chunk of qs: the lanes
                               // of a row read distinct banks
  extern __shared__ int tbl_s[];  // the sequence's table row
  __shared__ __align__(16) float qs[NR][LPR * QS];
  __shared__ float wm[NW][NR], wl[NW][NR];
  __shared__ __align__(16) float wo[NW][NR][D];
  __shared__ __align__(16) float recv[recv_slots(NR) * (D + 4)];

  cluster_arrive();
  cg::cluster_group cluster = cg::this_cluster();
  const int n_split = gridDim.x, split = blockIdx.x;  // the cluster spans x
  const int bk = blockIdx.y, batch = bk / hkv, kvh = bk % hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / LPR, chunk = lane % LPR;
  // the length, the table row and the query rows, all loads in flight
  // at once (the row does not wait for the length)
  const int len = max(length[batch], 0);
  for (int i = threadIdx.x; i < m; i += NT)
    tbl_s[i] = table[(size_t)batch * m + i];
  for (int idx = threadIdx.x; idx < NR * D; idx += NT) {
    const int i = idx / D, e = idx % D;
    qs[i][(e / CPL) * QS + e % CPL] =
        i < n_rows ? qf[((size_t)bk * n_rows + i) * D + e] * LOG2E : 0.f;
  }
  __syncthreads();
  int k0, k1;
  key_range(len, m, bs, window, n_split, split, &k0, &k1);

  int row_lo[NR];
  float acc[NR][CPL], mr[NR], lr[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    row_lo[i] = window_floor(len, window, t, i);
#pragma unroll
    for (int e = 0; e < CPL; ++e) acc[i][e] = 0.f;
    mr[i] = NEG_INF;
    lr[i] = 0.f;
  }

  const size_t row_stride = (size_t)hkv * D;
  auto row_of = [&](int it, int u) {
    return k0 + ((it * KR + u) * NW + warp) * G + grp;
  };
  // the lane group's next row as (table slot, row in the block), walked
  // in steps of NW * G rows rather than divided out row by row: load
  // visits the rows in order
  int slot = row_of(0, 0) / bs, in_slot = row_of(0, 0) % bs;
  auto load = [&](int it, Rows<Raw, KR>& r) {
#pragma unroll
    for (int u = 0; u < KR; ++u) {
      const int kp = row_of(it, u);
      const int bid = kp < k1 ? tbl_s[slot] : -1;
      const int w = in_slot;
      for (in_slot += NW * G; in_slot >= bs; in_slot -= bs) ++slot;
      r.ok[u] = bid >= 0;
      if (bid >= 0) {  // -1 slots are never read
        const size_t prow = (size_t)(bid * bs + w);
        const size_t off = prow * row_stride + (size_t)kvh * D + chunk * CPL;
        r.k[u] = __ldg(reinterpret_cast<const Raw*>(k_pool + off));
        r.v[u] = __ldg(reinterpret_cast<const Raw*>(v_pool + off));
        if constexpr (kQuant<T>) {
          r.ks[u] = __ldg(k_scale + prow * hkv + kvh);
          r.vs[u] = __ldg(v_scale + prow * hkv + kvh);
        }
      } else {
        r.k[u] = r.v[u] = Raw{};
        r.ks[u] = r.vs[u] = 0.f;
      }
    }
  };
  auto consume = [&](int it, const Rows<Raw, KR>& r) {
    float s[NR][KR];
#pragma unroll
    for (int u = 0; u < KR; ++u) {
      float kf[CPL];
      unpack<T>(r.k[u], kf);
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const float4* q = reinterpret_cast<const float4*>(&qs[i][chunk * QS]);
        float dot = 0.f;
#pragma unroll
        for (int e4 = 0; e4 < CPL / 4; ++e4) {
          const float4 x = q[e4];
          dot += x.x * kf[4 * e4] + x.y * kf[4 * e4 + 1] +
                 x.z * kf[4 * e4 + 2] + x.w * kf[4 * e4 + 3];
        }
        s[i][u] = dot;
      }
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < NR; ++i)
#pragma unroll
        for (int u = 0; u < KR; ++u)
          s[i][u] += __shfl_xor_sync(FULL_MASK, s[i][u], off);
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int u = 0; u < KR; ++u) {
        const bool valid = r.ok[u] && row_of(it, u) > row_lo[i];
        // int8: the k-scale multiplies the reduced score
        s[i][u] = valid ? (kQuant<T> ? s[i][u] * r.ks[u] : s[i][u]) : NEG_INF;
        mx = fmaxf(mx, s[i][u]);
      }
      const float m_new = fmaxf(mr[i], mx);
      const float corr = exp2f(mr[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < KR; ++u) {
        s[i][u] = s[i][u] > 0.5f * NEG_INF ? exp2f(s[i][u] - m_new) : 0.f;
        sum += s[i][u];
      }
#pragma unroll
      for (int e = 0; e < CPL; ++e) acc[i][e] *= corr;
      lr[i] = lr[i] * corr + sum;
      mr[i] = m_new;
    }
#pragma unroll
    for (int u = 0; u < KR; ++u) {
      float vf[CPL];
      unpack<T>(r.v[u], vf);
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        // int8: the v-scale multiplies the weight of the value product only
        const float pv = kQuant<T> ? s[i][u] * r.vs[u] : s[i][u];
#pragma unroll
        for (int e = 0; e < CPL; ++e) acc[i][e] += pv * vf[e];
      }
    }
  };

  // two register sets of rows: the next step's loads are issued before
  // the current step is consumed
  const int n_it = k1 > k0 ? (k1 - k0 + STEP - 1) / STEP : 0;
  Rows<Raw, KR> ra, rb;
  if (n_it > 0) load(0, ra);
  for (int it = 0; it < n_it; it += 2) {
    if (it + 1 < n_it) load(it + 1, rb);
    consume(it, ra);
    if (it + 1 >= n_it) break;
    if (it + 2 < n_it) load(it + 2, ra);
    consume(it + 1, rb);
  }

  // merge the lane groups (same column chunk, lanes LPR apart)
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1)
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const float m_o = __shfl_xor_sync(FULL_MASK, mr[i], off);
      const float l_o = __shfl_xor_sync(FULL_MASK, lr[i], off);
      const float m_new = fmaxf(mr[i], m_o);
      const float a = exp2f(mr[i] - m_new), b = exp2f(m_o - m_new);
      lr[i] = lr[i] * a + l_o * b;
#pragma unroll
      for (int e = 0; e < CPL; ++e)
        acc[i][e] =
            acc[i][e] * a + __shfl_xor_sync(FULL_MASK, acc[i][e], off) * b;
      mr[i] = m_new;
    }
  // then the warps, into the block's partials
  if (grp == 0) {
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      if (chunk == 0) {
        wm[warp][i] = mr[i];
        wl[warp][i] = lr[i];
      }
#pragma unroll
      for (int e = 0; e < CPL; ++e) wo[warp][i][chunk * CPL + e] = acc[i][e];
    }
  }
  __syncthreads();
  // the block's partials, warps merged, pushed to each row's owner
  cluster_wait();
  for (int idx = threadIdx.x; idx < NR * D; idx += NT) {
    const int i = idx / D, e = idx % D;
    float big = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) big = fmaxf(big, wm[w][i]);
    float out = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float wgt = exp2f(wm[w][i] - big);
      out += wo[w][i][e] * wgt;
      l += wl[w][i] * wgt;
    }
    float* slot = recv_slot(cluster, recv, i, split, n_split, NR, D);
    slot[e] = out;
    if (e == 0) {
      slot[D] = big;
      slot[D + 1] = l;
    }
  }
  cluster.sync();
  merge_owned<D>(recv, NR, n_split, split, (size_t)bk * n_rows, 0, n_rows, o,
                 l_out, m_out);
}

// ------------------------------------------------------------- tile kernel

constexpr int TR = 32;  // query rows a block
constexpr int TK = 32;  // keys a staged tile: two pool blocks of 16
constexpr int RPT = TR / 8;   // query rows a thread
constexpr int KPT = TK / 16;  // keys a thread scores in a tile
constexpr int TPK = NT / TK;  // threads that stage a key

// the tile kernel's dynamic shared memory: a 2-stage ring of raw K and V
// tiles (rows padded by 16 bytes, so the lanes reading 16 bytes of 16
// keys hit distinct banks), int8 scales and key flags per stage, the fp32
// query rows and P. After the key loop the ring holds the block's
// partials for the cluster's merge.
template <typename T, int D>
struct TileLayout {
  static constexpr int KS = D + kPer16<T>;  // elements a staged key row
  static constexpr int QS = D + 4;          // floats a query row
  static constexpr int PS = TK + 4;         // floats a row of P
  static constexpr size_t KV = sizeof(T) * TK * KS;  // one tensor, stage
  // the ring, which the merge's slots reuse once the key loop is done
  static constexpr size_t RING =
      4 * KV > sizeof(float) * recv_slots(TR) * (D + 4)
          ? 4 * KV
          : sizeof(float) * recv_slots(TR) * (D + 4);
  static constexpr size_t Q_OFF = RING;
  static constexpr size_t P_OFF = Q_OFF + sizeof(float) * TR * QS;
  static constexpr size_t SC_OFF = P_OFF + sizeof(float) * TR * PS;
  static constexpr size_t OK_OFF = SC_OFF + sizeof(float) * 4 * TK;
  static constexpr size_t BYTES = OK_OFF + sizeof(int) * 2 * TK;
};

// One block per (split, 32-row tile, sequence * kv head), a cluster per
// (tile, sequence * kv head). Thread (r, c) = (tid / 16, tid % 16) holds
// rows r + 8 i (i < RPT): scores of keys c + 16 j (j < KPT) of each tile,
// and output columns c * D/16 .. + D/16. At about 57 KB of shared memory
// (bf16, d 128) four blocks fit an SM, so the card holds every cluster of
// the path's tile at once.
template <typename T, int D>
__global__ void __launch_bounds__(NT) paged_tile_kernel(
    const float* __restrict__ qf, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ table,
    const int* __restrict__ length, float* __restrict__ o,
    float* __restrict__ l_out, float* __restrict__ m_out, int hkv,
    int n_rows, int m, int bs, int window, int t) {
  using L = TileLayout<T, D>;
  constexpr int E = kPer16<T>;  // elements a 16-byte chunk
  constexpr int CH = D / E;     // chunks a row
  constexpr int CPT = D / 16;   // output columns a thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = reinterpret_cast<T*>(smem + 2 * L::KV);
  float* qs = reinterpret_cast<float*>(smem + L::Q_OFF);
  float* ps = reinterpret_cast<float*>(smem + L::P_OFF);
  float* ksc = reinterpret_cast<float*>(smem + L::SC_OFF);  // [2][TK]
  float* vsc = ksc + 2 * TK;                                // [2][TK]
  int* kok = reinterpret_cast<int*>(smem + L::OK_OFF);      // [2][TK]

  cg::cluster_group cluster = cg::this_cluster();
  const int n_split = gridDim.x, split = blockIdx.x;  // the cluster spans x
  const int r0 = blockIdx.y * TR;
  const int bk = blockIdx.z, batch = bk / hkv, kvh = bk % hkv;
  const int tid = threadIdx.x, r = tid / 16, c = tid % 16;
  const int len = max(length[batch], 0);
  int k0, k1;
  key_range(len, m, bs, window, n_split, split, &k0, &k1);
  const int n_tiles = k1 > k0 ? (k1 - k0 + TK - 1) / TK : 0;
  const int* tbl = table + (size_t)batch * m;

  // keys kbase .. kbase + TK into stage kt % 2; keys past k1 and -1
  // slots are zero-filled (never read) and flagged
  auto issue = [&](int kt) {
    const int st = kt & 1, key = tid / TPK, kp = k0 + kt * TK + key;
    const int bid = kp < k1 ? __ldg(tbl + kp / bs) : -1;
    const size_t row = bid >= 0 ? (size_t)bid * bs + kp % bs : 0;
    const size_t off = (row * hkv + kvh) * D;
    const uint32_t bytes = bid >= 0 ? 16 : 0;
    const size_t dst = (size_t)(st * TK + key) * L::KS;
#pragma unroll
    for (int ch = tid % TPK; ch < CH; ch += TPK) {
      cp_async16(smem_u32(ks + dst + ch * E), k_pool + off + ch * E, bytes);
      cp_async16(smem_u32(vs + dst + ch * E), v_pool + off + ch * E, bytes);
    }
    if (tid % TPK == 0) {
      kok[st * TK + key] = bid >= 0;
      if constexpr (kQuant<T>) {
        cp_async4(smem_u32(ksc + st * TK + key), k_scale + row * hkv + kvh,
                  bytes / 4);
        cp_async4(smem_u32(vsc + st * TK + key), v_scale + row * hkv + kvh,
                  bytes / 4);
      }
    }
    cp_async_commit();
  };

  if (n_tiles > 0) issue(0);
  // the query rows, 16 bytes a load, all of a thread's loads in flight
#pragma unroll
  for (int k = 0; k < TR * D / 4 / NT; ++k) {
    const int idx = (k * NT + tid) * 4, i = idx / D, e = idx % D;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + i < n_rows)
      x = __ldg(reinterpret_cast<const float4*>(
          qf + ((size_t)bk * n_rows + r0 + i) * D + e));
    *reinterpret_cast<float4*>(&qs[i * L::QS + e]) =
        make_float4(x.x * LOG2E, x.y * LOG2E, x.z * LOG2E, x.w * LOG2E);
  }
  int row_lo[RPT];
  float acc[RPT][CPT], mrow[RPT], lrow[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    row_lo[i] = window_floor(len, window, t, r0 + r + 8 * i);
#pragma unroll
    for (int e = 0; e < CPT; ++e) acc[i][e] = 0.f;
    mrow[i] = NEG_INF;
    lrow[i] = 0.f;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait_all();
    __syncthreads();  // stage kt has landed; stage kt + 1 is free
    if (kt + 1 < n_tiles) issue(kt + 1);
    const int st = kt & 1, kbase = k0 + kt * TK;
    const int n_keys = min(TK, k1 - kbase);
    const T* kst = ks + (size_t)st * TK * L::KS;
    const T* vst = vs + (size_t)st * TK * L::KS;

    // S = q K^T over this thread's rows and keys
    float s[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
    for (int d0 = 0; d0 < D; d0 += E) {
      float qv[RPT][E];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int e4 = 0; e4 < E / 4; ++e4) {
          const float4 x = *reinterpret_cast<const float4*>(
              &qs[(r + 8 * i) * L::QS + d0 + 4 * e4]);
          qv[i][4 * e4] = x.x; qv[i][4 * e4 + 1] = x.y;
          qv[i][4 * e4 + 2] = x.z; qv[i][4 * e4 + 3] = x.w;
        }
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        if (16 * j >= n_keys) break;  // block-uniform
        const int key = c + 16 * j;
        float kf[E];
        load_f<T, E>(kst + key * L::KS + d0, kf);
        if constexpr (kQuant<T>) {
          const float sc = ksc[st * TK + key];  // each element by its scale
#pragma unroll
          for (int e = 0; e < E; ++e) kf[e] *= sc;
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int e = 0; e < E; ++e) s[i][j] += qv[i][e] * kf[e];
      }
    }

    // the online softmax of each row over its 16 lanes
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int key = c + 16 * j, kp = kbase + key;
        const bool valid = key < n_keys && kok[st * TK + key] &&
                           kp > row_lo[i];
        s[i][j] = valid ? s[i][j] : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, off));
      const float m_new = fmaxf(mrow[i], mx);
      const float corr = exp2f(mrow[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float p =
            s[i][j] > 0.5f * NEG_INF ? exp2f(s[i][j] - m_new) : 0.f;
        ps[(r + 8 * i) * L::PS + c + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(FULL_MASK, sum, off);
      lrow[i] = lrow[i] * corr + sum;
      mrow[i] = m_new;
#pragma unroll
      for (int e = 0; e < CPT; ++e) acc[i][e] *= corr;
    }
    __syncwarp();  // P of these rows was written by this half warp

    // O += P V over the tile's keys
    for (int k4 = 0; k4 < n_keys; k4 += 4) {
      float p[RPT][4];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 x =
            *reinterpret_cast<const float4*>(&ps[(r + 8 * i) * L::PS + k4]);
        p[i][0] = x.x; p[i][1] = x.y; p[i][2] = x.z; p[i][3] = x.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int key = k4 + jj;
        float vf[CPT];
        load_f<T, CPT>(vst + key * L::KS + c * CPT, vf);
        if constexpr (kQuant<T>) {
          const float sc = vsc[st * TK + key];
#pragma unroll
          for (int e = 0; e < CPT; ++e) vf[e] *= sc;
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int e = 0; e < CPT; ++e) acc[i][e] += p[i][jj] * vf[e];
      }
    }
  }

  // the block's partials pushed to each row's owner, into its ring once
  // every block of the cluster is done with its own
  cluster.sync();
  float* recv = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    float* slot = recv_slot(cluster, recv, r + 8 * i, split, n_split, TR, D);
#pragma unroll
    for (int e = 0; e < CPT; e += 4)
      *reinterpret_cast<float4*>(slot + c * CPT + e) = make_float4(
          acc[i][e], acc[i][e + 1], acc[i][e + 2], acc[i][e + 3]);
    if (c == 0)
      *reinterpret_cast<float2*>(slot + D) = make_float2(mrow[i], lrow[i]);
  }
  cluster.sync();
  merge_owned<D>(recv, TR, n_split, split, (size_t)bk * n_rows + r0, r0,
                 n_rows, o, l_out, m_out);
}

// ------------------------------------------------------------------ launch

// launches Kernel on `grid` as clusters of n_split blocks along x,
// raising its dynamic shared memory limit first where `smem` needs it
template <auto Kernel, typename T>
int launch_cluster(dim3 grid, size_t smem, const PagedArgs& a,
                   cudaStream_t stream) {
  constexpr auto kernel = Kernel;
  static size_t configured = 0;  // one per kernel instance
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float*>(a.qf),
      static_cast<const T*>(a.k_pool), static_cast<const T*>(a.v_pool),
      static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.table),
      static_cast<const int*>(a.length), static_cast<float*>(a.o),
      static_cast<float*>(a.l), static_cast<float*>(a.mx), a.hkv, a.n_rows,
      a.m, a.bs, a.window, a.t);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int D, int NR>
int launch_split(const PagedArgs& a, cudaStream_t stream) {
  const size_t smem = sizeof(int) * (size_t)a.m;  // the table row
  return launch_cluster<paged_split_kernel<T, D, NR>, T>(
      dim3(a.n_split, a.b * a.hkv), smem, a, stream);
}

template <typename T, int D>
int dispatch_split(const PagedArgs& a, cudaStream_t s) {
  if (a.n_rows <= 1) return launch_split<T, D, 1>(a, s);
  if (a.n_rows <= 2) return launch_split<T, D, 2>(a, s);
  if (a.n_rows <= 4) return launch_split<T, D, 4>(a, s);
  if (a.n_rows <= 8) return launch_split<T, D, 8>(a, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int D>
int launch_tile(const PagedArgs& a, cudaStream_t s) {
  return launch_cluster<paged_tile_kernel<T, D>, T>(
      dim3(a.n_split, (a.n_rows + TR - 1) / TR, a.b * a.hkv),
      TileLayout<T, D>::BYTES, a, s);
}

template <typename T>
int by_d(bool tile, int d, const PagedArgs& a, cudaStream_t s) {
  if (d == 64)
    return tile ? launch_tile<T, 64>(a, s) : dispatch_split<T, 64>(a, s);
  if (d == 128)
    return tile ? launch_tile<T, 128>(a, s) : dispatch_split<T, 128>(a, s);
  return (int)cudaErrorInvalidValue;
}

// the keys fewer than which a split kernel's block is not worth a split
constexpr int SPLIT_KEYS = 32;

// The blocks (one cluster) that cut each unit's live keys: about four
// blocks per SM across `units` (sequence * kv head, times the 32-row
// tiles for the tile kernel), at most MAX_SPLIT, and no more than one per
// `keys_per_split` of the `keys` a row can see.
int choose_splits(int units, int keys, int keys_per_split, int* n_split) {
  static int sms = 0;  // one card per process
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int by_card = (4 * sms + units - 1) / units;
  const int by_keys = (keys + keys_per_split - 1) / keys_per_split;
  *n_split = std::max(1, std::min({MAX_SPLIT, by_card, by_keys}));
  return 0;
}

[[maybe_unused]] int paged_decode(bool tile, PagedArgs a, int d, int dtype,
                                  cudaStream_t s) {
  // int8 arenas need both scale pools, float arenas take none; the query
  // rows are whole tiles of t, and the window is 0 (none) or positive
  const bool scales = dtype == 2
                          ? (a.k_scale != nullptr && a.v_scale != nullptr)
                          : (a.k_scale == nullptr && a.v_scale == nullptr);
  if (!scales || a.window < 0 || a.t < 1 || a.n_rows % a.t != 0)
    return (int)cudaErrorInvalidValue;
  // the keys a row can see: under a window, positions length - window + 1
  // .. length - 1 of the table's m * bs
  const int keys =
      a.window > 0 ? std::min(a.m * a.bs, a.window - 1) : a.m * a.bs;
  const int err =
      tile ? choose_splits(a.b * a.hkv * ((a.n_rows + TR - 1) / TR), keys,
                           TK, &a.n_split)
           : choose_splits(a.b * a.hkv, keys, SPLIT_KEYS, &a.n_split);
  if (err != 0) return err;
  if (dtype == 0) return edl_paged::launch_dtype<float>(tile, d, a, s);
  if (dtype == 1)
    return edl_paged::launch_dtype<__nv_bfloat16>(tile, d, a, s);
  if (dtype == 2) return edl_paged::launch_dtype<int8_t>(tile, d, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

#define EDL_PAGED_PART(T)                                                  \
  template <>                                                              \
  int edl_paged::launch_dtype<T>(bool tile, int d, const PagedArgs& a,     \
                                 cudaStream_t s) {                         \
    return by_d<T>(tile, d, a, s);                                         \
  }
#if EDL_PART == 0
EDL_PAGED_PART(float)
#elif EDL_PART == 1
EDL_PAGED_PART(__nv_bfloat16)
#elif EDL_PART == 2
EDL_PAGED_PART(int8_t)
#endif
#undef EDL_PAGED_PART

#if EDL_PART == 0

// qf [b, hkv, n_rows, d] fp32 (already multiplied by scale); k_pool and
// v_pool [num_blocks, bs, hkv, d] (dtype 0 = float32, 1 = bfloat16, 2 =
// int8), 16-byte aligned; for int8, k_scale and v_scale [num_blocks, bs,
// hkv, 1] fp32 per-row scales, else NULL; table [b, m] int32 (-1 =
// unallocated); length [b] int32; o [b, hkv, n_rows, d], l and m [b, hkv,
// n_rows] fp32; d 64 or 128; window 0 (none) or the sliding window; t
// the tile length (query row r is tile token r % t). All contiguous.
// Each returns the cudaError_t of its one launch (0 = ok).

// n_rows <= 8: the split kernel.
extern "C" int edl_paged_decode_split(
    const void* qf, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* table,
    const void* length, void* o, void* l, void* mx, int b, int hkv,
    int n_rows, int m, int bs, int d, int dtype, int window, int t,
    void* stream) {
  const PagedArgs a{qf, k_pool, v_pool, k_scale, v_scale, table, length,
                    o,  l,      mx,     b,       hkv,     n_rows, m,
                    bs, window, t,      1};
  return paged_decode(false, a, d, dtype, static_cast<cudaStream_t>(stream));
}

// n_rows > 8: the tile kernel.
extern "C" int edl_paged_decode_tile(
    const void* qf, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* table,
    const void* length, void* o, void* l, void* mx, int b, int hkv,
    int n_rows, int m, int bs, int d, int dtype, int window, int t,
    void* stream) {
  const PagedArgs a{qf, k_pool, v_pool, k_scale, v_scale, table, length,
                    o,  l,      mx,     b,       hkv,     n_rows, m,
                    bs, window, t,      1};
  return paged_decode(true, a, d, dtype, static_cast<cudaStream_t>(stream));
}

#endif  // EDL_PART == 0
