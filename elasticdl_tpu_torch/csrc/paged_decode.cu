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
// keeps the partials (0, 0, -1e30). Every kernel starts its table walk at
// the slot of position length - window + 1, the first that any row of
// the tile can see, so a windowed decode reads about window rows, not
// length; the split kernel cuts that range, not the whole table, across
// its splits.
//
// What bounds it on the H100: bytes. Each cached row is read once and
// used for group*t dot products, so at t = 1 the kernel does about two
// operations per byte, far below the ~295 the card needs to be bound by
// operations. The design therefore reads only what the mask keeps: the
// TPU kernel streams every table slot and masks unallocated (-1) and
// out-of-length slots; these kernels stop at ceil(length / block_size)
// and skip -1 slots without reading them. Query rows are prescaled by
// scale on the host and by log2e here, so the loops use exp2; masked
// scores contribute exactly 0, so a sequence with length 0 leaves
// (o, l, m) = (0, 0, -1e30).
//
// Arenas are fp32, bf16 or int8. int8 arenas (the TPU kernel's quantized
// branch, _paged_kernel's `quantized`) come with fp32 per-row scale pools
// [num_blocks, block_size, hkv, 1], read beside the rows; the dequantize
// runs in registers and no float copy of a row is ever written. The int8
// split kernel folds each key row's scale into its score and each value
// row's scale into its softmax weight (the JAX scan's deferral: the
// softmax denominator takes the weight unscaled); the tile kernel
// multiplies each staged row element by its row scale (the TPU kernel's
// choice). The two differ only by rounding. int8 halves a bf16 arena's
// bytes, and the scales add 4 bytes per row and kv head. Rows are read 16
// int8 values (16 bytes) at a time; d is 64 or 128, a multiple of 16, so
// no row needs a narrower loader.
//
// Two kernels, chosen by the number of query rows per (sequence, kv
// head):
//
// * split (n_rows <= 8: the decode step, GQA groups, short tiles). The
//   TPU grid walks a sequence's table in order on one core; on the H100
//   one block per (sequence, kv head) would leave most of the 132 SMs
//   idle and serialize the walk. So the table is cut into splits, one
//   block each (grid (split, b*hkv)), and each of the block's 4 warps
//   takes every 4th slot of its split. A lane holds d/32 columns of the
//   query rows and of its running output; K and V rows are read as one
//   vector per lane straight into registers (no shared memory, no
//   barrier in the loop), scores are reduced across the warp with
//   shuffles. The warps' partials merge through shared memory, and a
//   second small kernel merges the splits. int8 arenas take their own
//   split kernel, in which d/16 lanes hold a row (16 bytes each), so a
//   warp reads 32/(d/16) rows at once; each such lane group keeps its own
//   online softmax, and the groups merge by shuffles before the warps do.
// * tile (n_rows > 8: the shared-prefix suffix tile). One block per
//   (16-row tile, b*hkv) stages each live block's (bs, d) K and V rows in
//   shared memory as fp32 and accumulates P V for its 16 rows in
//   registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int R = 16;
constexpr int NT = 128;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
constexpr bool kQuant = std::is_same<T, int8_t>::value;

// element e (0..15, a constant after unrolling) of 16 int8 values read
// as one int4
__device__ __forceinline__ float i8_at(const int4& x, int e) {
  const int w = e < 4 ? x.x : (e < 8 ? x.y : (e < 12 ? x.z : x.w));
  return (float)(int8_t)(w >> (8 * (e & 3)));
}

template <int D>
size_t tile_smem_bytes(int bs) {
  // qs [R][D+1], ks [bs][D+1], vs [bs][D], ss [R][bs+1], row m, l, corr
  return sizeof(float) * ((size_t)R * (D + 1) + (size_t)bs * (D + 1) +
                          (size_t)bs * D + (size_t)R * (bs + 1) + 3 * R);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) paged_tile_kernel(
    const float* __restrict__ qf, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ table,
    const int* __restrict__ length, float* __restrict__ o,
    float* __restrict__ l_out, float* __restrict__ m_out, int hkv,
    int n_rows, int m, int bs, int window, int t) {
  static_assert((R * D) % NT == 0, "R*D must be a multiple of NT");
  constexpr int DP = D + 1;
  constexpr int PER = R * D / NT;
  const int SP = bs + 1;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + R * DP;
  float* vs = ks + bs * DP;
  float* ss = vs + bs * D;
  float* row_m = ss + R * SP;
  float* row_l = row_m + R;
  float* row_c = row_l + R;

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * R;
  const int bk = blockIdx.y;  // batch * hkv + kv head
  const int batch = bk / hkv, kvh = bk % hkv;
  const int len = length[batch];
  const float* qb = qf + (size_t)bk * n_rows * D;

  for (int i = tid; i < R * D; i += NT) {
    const int r = i / D, e = i % D;
    qs[r * DP + e] =
        (r0 + r < n_rows) ? qb[(size_t)(r0 + r) * D + e] * LOG2E : 0.f;
  }
  if (tid < R) {
    row_m[tid] = NEG_INF;
    row_l[tid] = 0.f;
  }
  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;

  const int n_slots = min(m, (max(len, 0) + bs - 1) / bs);
  const int j_lo = window > 0 ? max(0, len - window + 1) / bs : 0;
  const size_t row_stride = (size_t)hkv * D;
  for (int j = j_lo; j < n_slots; ++j) {
    const int bid = table[(size_t)batch * m + j];
    if (bid < 0) continue;  // unallocated slot: never read (block-uniform)
    __syncthreads();        // the previous slot's readers are done
    const size_t base = (size_t)bid * bs * row_stride + (size_t)kvh * D;
    if constexpr (kQuant<T>) {
      // 16 int8 elements per 16-byte load (D is 64 or 128), each scaled
      // by its row's scale on the way into shared memory
      constexpr int V = 16, CH = D / V;
      for (int i = tid; i < bs * CH; i += NT) {
        const int r = i / CH, e = (i % CH) * V;
        const size_t off = base + (size_t)r * row_stride + e;
        const int4 kr = *reinterpret_cast<const int4*>(k_pool + off);
        const int4 vr = *reinterpret_cast<const int4*>(v_pool + off);
        const size_t srow = ((size_t)bid * bs + r) * hkv + kvh;
        const float ksc = k_scale[srow], vsc = v_scale[srow];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          ks[r * DP + e + j] = i8_at(kr, j) * ksc;
          vs[r * D + e + j] = i8_at(vr, j) * vsc;
        }
      }
    } else {
      for (int i = tid; i < bs * D; i += NT) {
        const int r = i / D, e = i % D;
        const size_t off = base + (size_t)r * row_stride + e;
        ks[r * DP + e] = to_f(k_pool[off]);
        vs[r * D + e] = to_f(v_pool[off]);
      }
    }
    __syncthreads();
    for (int i = tid; i < R * bs; i += NT) {
      const int r = i / bs, c = i % bs;
      const int kp = j * bs + c;
      float s = 0.f;
#pragma unroll 8
      for (int e = 0; e < D; ++e) s += qs[r * DP + e] * ks[c * DP + e];
      const bool valid =
          kp < len && (window <= 0 || kp > len + (r0 + r) % t - window);
      ss[r * SP + c] = valid ? s : NEG_INF;
    }
    __syncthreads();
    if (tid < R) {
      float mx = NEG_INF;
      for (int c = 0; c < bs; ++c) mx = fmaxf(mx, ss[tid * SP + c]);
      const float m_prev = row_m[tid];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = 0; c < bs; ++c) {
        const float sv = ss[tid * SP + c];
        const float p = sv > 0.5f * NEG_INF ? exp2f(sv - m_new) : 0.f;
        ss[tid * SP + c] = p;
        sum += p;
      }
      const float corr = exp2f(m_prev - m_new);
      row_l[tid] = row_l[tid] * corr + sum;
      row_m[tid] = m_new;
      row_c[tid] = corr;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = tid + NT * i;
      const int r = idx / D, e = idx % D;
      float a = acc[i] * row_c[r];
      for (int c = 0; c < bs; ++c) a += ss[r * SP + c] * vs[c * D + e];
      acc[i] = a;
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int idx = tid + NT * i;
    const int r = idx / D, e = idx % D;
    if (r0 + r < n_rows) o[((size_t)bk * n_rows + r0 + r) * D + e] = acc[i];
  }
  if (tid < R && r0 + tid < n_rows) {
    const size_t out = (size_t)bk * n_rows + r0 + tid;
    const float l = row_l[tid];
    l_out[out] = l;
    m_out[out] = l > 0.f ? row_m[tid] * LN2 : NEG_INF;
  }
}

// ------------------------------------------------------------ split kernel

constexpr int SPLIT_WARPS = 4;
constexpr unsigned FULL_MASK = 0xffffffffu;

// `n` consecutive elements at p (a lane's columns of one row) as fp32,
// read as one vector.
template <int N>
__device__ __forceinline__ void load_cols(const float* p, float (&out)[N]) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  }
}

template <int N>
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p,
                                          float (&out)[N]) {
  if constexpr (N == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  } else {
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = a.x; out[1] = a.y;
  }
}

// The block's warps' partials (m in log2 units) merged into the split's
// partials at pbase = (split * b*hkv + bk) * n_rows of o_part / l_part /
// m_part; each warp has left its (m, l, o) in sm / sl / so. Call after
// __syncthreads().
template <int D, int NR>
__device__ __forceinline__ void store_split_partials(
    const float (&sm)[SPLIT_WARPS][NR], const float (&sl)[SPLIT_WARPS][NR],
    const float (&so)[SPLIT_WARPS][NR][D], size_t pbase, int n_rows,
    float* __restrict__ o_part, float* __restrict__ l_part,
    float* __restrict__ m_part) {
  for (int idx = threadIdx.x; idx < NR * D; idx += SPLIT_WARPS * 32) {
    const int i = idx / D, e = idx % D;
    if (i >= n_rows) continue;
    float big = NEG_INF;
#pragma unroll
    for (int w = 0; w < SPLIT_WARPS; ++w) big = fmaxf(big, sm[w][i]);
    float out = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < SPLIT_WARPS; ++w) {
      const float wgt = exp2f(sm[w][i] - big);
      out += so[w][i][e] * wgt;
      l += sl[w][i] * wgt;
    }
    o_part[(pbase + i) * D + e] = out;
    if (e == 0) {
      l_part[pbase + i] = l;
      m_part[pbase + i] = big;
    }
  }
}

// The table slots [*j0, *j1) that split `split` walks: without a window,
// slots_per_split of the live ones (k_pos < len); under a window, an even
// cut of the live slots from that of position len - window + 1, the first
// any row can see, across the gridDim.x splits.
__device__ __forceinline__ void split_range(int len, int m, int bs,
                                            int window, int slots_per_split,
                                            int split, int* j0, int* j1) {
  const int n_slots = min(m, (len + bs - 1) / bs);
  int lo = 0, per = slots_per_split;
  if (window > 0) {
    lo = min(n_slots, max(0, len - window + 1) / bs);
    per = (n_slots - lo + gridDim.x - 1) / gridDim.x;
  }
  *j0 = lo + split * per;
  *j1 = min(n_slots, *j0 + per);
}

// Row i's window floor: it sees pool rows k_pos > row_lo[i] (INT_MIN
// without a window); row i is tile token i % t.
template <int NR>
__device__ __forceinline__ void window_floors(int len, int window, int t,
                                              int (&row_lo)[NR]) {
#pragma unroll
  for (int i = 0; i < NR; ++i)
    row_lo[i] = window > 0 ? len + i % t - window : INT_MIN;
}

// One block per (split, sequence * kv head); NR = n_rows rounded up to
// a power of two (<= 8). Writes the split's partials (o, l, m) with m
// in log2 units to o_part [split, b*hkv, n_rows, D] etc.
template <typename T, int D, int NR>
__global__ void __launch_bounds__(SPLIT_WARPS * 32) paged_split_kernel(
    const float* __restrict__ qf, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ table,
    const int* __restrict__ length, float* __restrict__ o_part,
    float* __restrict__ l_part, float* __restrict__ m_part, int hkv,
    int n_rows, int m, int bs, int slots_per_split, int window, int t) {
  constexpr int DL = D / 32;          // columns per lane
  constexpr int KC = NR >= 8 ? 4 : 8;  // key rows per register chunk
  const int split = blockIdx.x, bk = blockIdx.y, nbk = gridDim.y;
  const int batch = bk / hkv, kvh = bk % hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = max(length[batch], 0);
  int j0, j1, row_lo[NR];
  split_range(len, m, bs, window, slots_per_split, split, &j0, &j1);
  window_floors<NR>(len, window, t, row_lo);

  float q[NR][DL], o[NR][DL], mr[NR], lr[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
#pragma unroll
    for (int e = 0; e < DL; ++e) {
      q[i][e] = i < n_rows
                    ? qf[((size_t)bk * n_rows + i) * D + lane * DL + e] * LOG2E
                    : 0.f;
      o[i][e] = 0.f;
    }
    mr[i] = NEG_INF;
    lr[i] = 0.f;
  }

  const size_t row_stride = (size_t)hkv * D;
  for (int j = j0 + warp; j < j1; j += SPLIT_WARPS) {
    const int bid = table[(size_t)batch * m + j];
    if (bid < 0) continue;  // unallocated slot: never read (warp-uniform)
    const size_t base =
        (size_t)bid * bs * row_stride + (size_t)kvh * D + lane * DL;
    for (int r0 = 0; r0 < bs; r0 += KC) {
      float kf[KC][DL], vf[KC][DL];
#pragma unroll
      for (int r = 0; r < KC; ++r) {
        if (r0 + r < bs) {
          load_cols(k_pool + base + (size_t)(r0 + r) * row_stride, kf[r]);
          load_cols(v_pool + base + (size_t)(r0 + r) * row_stride, vf[r]);
        } else {
#pragma unroll
          for (int e = 0; e < DL; ++e) kf[r][e] = vf[r][e] = 0.f;
        }
      }
      float s[NR][KC];
#pragma unroll
      for (int i = 0; i < NR; ++i)
#pragma unroll
        for (int r = 0; r < KC; ++r) {
          float acc = 0.f;
#pragma unroll
          for (int e = 0; e < DL; ++e) acc += q[i][e] * kf[r][e];
          s[i][r] = acc;
        }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int i = 0; i < NR; ++i)
#pragma unroll
          for (int r = 0; r < KC; ++r)
            s[i][r] += __shfl_xor_sync(FULL_MASK, s[i][r], off);
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        float mx = NEG_INF;
#pragma unroll
        for (int r = 0; r < KC; ++r) {
          const int kp = j * bs + r0 + r;
          const bool valid = r0 + r < bs && kp < len && kp > row_lo[i];
          s[i][r] = valid ? s[i][r] : NEG_INF;
          mx = fmaxf(mx, s[i][r]);
        }
        const float m_new = fmaxf(mr[i], mx);
        const float corr = exp2f(mr[i] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int e = 0; e < DL; ++e) o[i][e] *= corr;
#pragma unroll
        for (int r = 0; r < KC; ++r) {
          const float p = s[i][r] > 0.5f * NEG_INF ? exp2f(s[i][r] - m_new)
                                                   : 0.f;
          sum += p;
#pragma unroll
          for (int e = 0; e < DL; ++e) o[i][e] += p * vf[r][e];
        }
        lr[i] = lr[i] * corr + sum;
        mr[i] = m_new;
      }
    }
  }

  // merge the warps' partials
  __shared__ float sm[SPLIT_WARPS][NR], sl[SPLIT_WARPS][NR];
  __shared__ float so[SPLIT_WARPS][NR][D];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    if (lane == 0) {
      sm[warp][i] = mr[i];
      sl[warp][i] = lr[i];
    }
#pragma unroll
    for (int e = 0; e < DL; ++e) so[warp][i][lane * DL + e] = o[i][e];
  }
  __syncthreads();
  store_split_partials<D, NR>(sm, sl, so, ((size_t)split * nbk + bk) * n_rows,
                              n_rows, o_part, l_part, m_part);
}

// ------------------------------------------------------ int8 split kernel

constexpr int I8V = 16;              // int8 columns a lane reads (an int4)
constexpr int I8_QSTRIDE = I8V + 4;  // floats per 16-column chunk of qs:
                                     // the lanes of a row read distinct banks

// The split kernel for int8 arenas: same grid, walk and output as
// paged_split_kernel. LPR = D / 16 lanes hold a row, 16 int8 columns
// each, so a warp reads G = 32 / LPR rows (KR per lane group) per step;
// the k-scale multiplies the reduced score, the v-scale the weight of
// the value product. Each lane group keeps an online softmax over the
// rows it reads; the groups merge by shuffles (lanes of one column chunk
// are LPR apart), then the warps through shared memory. The query rows
// sit in shared memory (each lane reads its 16 columns).
template <int D, int NR>
__global__ void __launch_bounds__(SPLIT_WARPS * 32) paged_split_int8_kernel(
    const float* __restrict__ qf, const int8_t* __restrict__ k_pool,
    const int8_t* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ table,
    const int* __restrict__ length, float* __restrict__ o_part,
    float* __restrict__ l_part, float* __restrict__ m_part, int hkv,
    int n_rows, int m, int bs, int slots_per_split, int window, int t) {
  constexpr int LPR = D / I8V;  // 8 at d = 128, 4 at d = 64
  constexpr int G = 32 / LPR;
  constexpr int KR = NR >= 8 ? 1 : (NR >= 4 ? 2 : 4);
  __shared__ float qs[NR][(D / I8V) * I8_QSTRIDE];
  __shared__ float sm[SPLIT_WARPS][NR], sl[SPLIT_WARPS][NR];
  __shared__ float so[SPLIT_WARPS][NR][D];
  const int split = blockIdx.x, bk = blockIdx.y, nbk = gridDim.y;
  const int batch = bk / hkv, kvh = bk % hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / LPR, chunk = lane % LPR;
  const int len = max(length[batch], 0);
  int j0, j1, row_lo[NR];
  split_range(len, m, bs, window, slots_per_split, split, &j0, &j1);
  window_floors<NR>(len, window, t, row_lo);

  for (int idx = threadIdx.x; idx < NR * D; idx += SPLIT_WARPS * 32) {
    const int i = idx / D, e = idx % D;
    qs[i][(e / I8V) * I8_QSTRIDE + e % I8V] =
        i < n_rows ? qf[((size_t)bk * n_rows + i) * D + e] * LOG2E : 0.f;
  }
  __syncthreads();

  float o[NR][I8V], mr[NR], lr[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
#pragma unroll
    for (int e = 0; e < I8V; ++e) o[i][e] = 0.f;
    mr[i] = NEG_INF;
    lr[i] = 0.f;
  }

  const size_t row_stride = (size_t)hkv * D;
  for (int j = j0 + warp; j < j1; j += SPLIT_WARPS) {
    const int bid = table[(size_t)batch * m + j];
    if (bid < 0) continue;  // unallocated slot: never read (warp-uniform)
    const size_t base =
        (size_t)bid * bs * row_stride + (size_t)kvh * D + chunk * I8V;
    const size_t sbase = (size_t)bid * bs * hkv + kvh;
    for (int r0 = 0; r0 < bs; r0 += G * KR) {
      int4 kr[KR], vr[KR];
      float ksc[KR], vsc[KR];
      bool valid[KR];
      int kp[KR];
#pragma unroll
      for (int u = 0; u < KR; ++u) {
        const int r = r0 + u * G + grp;
        kp[u] = j * bs + r;
        valid[u] = r < bs && kp[u] < len;
        if (r < bs) {
          kr[u] = *reinterpret_cast<const int4*>(
              k_pool + base + (size_t)r * row_stride);
          vr[u] = *reinterpret_cast<const int4*>(
              v_pool + base + (size_t)r * row_stride);
          ksc[u] = k_scale[sbase + (size_t)r * hkv];
          vsc[u] = v_scale[sbase + (size_t)r * hkv];
        } else {
          kr[u] = vr[u] = make_int4(0, 0, 0, 0);
          ksc[u] = vsc[u] = 0.f;
        }
      }
      float s[NR][KR];
#pragma unroll
      for (int i = 0; i < NR; ++i)
#pragma unroll
        for (int u = 0; u < KR; ++u) {
          const float* q = &qs[i][chunk * I8_QSTRIDE];
          float acc = 0.f;
#pragma unroll
          for (int e = 0; e < I8V; ++e) acc += q[e] * i8_at(kr[u], e);
          s[i][u] = acc;
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
          s[i][u] = valid[u] && kp[u] > row_lo[i] ? s[i][u] * ksc[u]
                                                  : NEG_INF;  // k-scale
          mx = fmaxf(mx, s[i][u]);
        }
        const float m_new = fmaxf(mr[i], mx);
        const float corr = exp2f(mr[i] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int e = 0; e < I8V; ++e) o[i][e] *= corr;
#pragma unroll
        for (int u = 0; u < KR; ++u) {
          const float p = s[i][u] > 0.5f * NEG_INF ? exp2f(s[i][u] - m_new)
                                                   : 0.f;
          sum += p;
          const float pv = p * vsc[u];  // v-scale: value product only
#pragma unroll
          for (int e = 0; e < I8V; ++e) o[i][e] += pv * i8_at(vr[u], e);
        }
        lr[i] = lr[i] * corr + sum;
        mr[i] = m_new;
      }
    }
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
      for (int e = 0; e < I8V; ++e)
        o[i][e] = o[i][e] * a + __shfl_xor_sync(FULL_MASK, o[i][e], off) * b;
      mr[i] = m_new;
    }
  // then the warps
  if (grp == 0) {
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      if (chunk == 0) {
        sm[warp][i] = mr[i];
        sl[warp][i] = lr[i];
      }
#pragma unroll
      for (int e = 0; e < I8V; ++e) so[warp][i][chunk * I8V + e] = o[i][e];
    }
  }
  __syncthreads();
  store_split_partials<D, NR>(sm, sl, so, ((size_t)split * nbk + bk) * n_rows,
                              n_rows, o_part, l_part, m_part);
}

// Merge the splits: grid (n_rows, b*hkv), D threads.
__global__ void paged_merge_kernel(const float* __restrict__ o_part,
                                   const float* __restrict__ l_part,
                                   const float* __restrict__ m_part,
                                   float* __restrict__ o,
                                   float* __restrict__ l_out,
                                   float* __restrict__ m_out, int n_split,
                                   int n_rows, int d) {
  const int i = blockIdx.x, bk = blockIdx.y, nbk = gridDim.y;
  const int e = threadIdx.x;
  float big = NEG_INF;
  for (int s = 0; s < n_split; ++s)
    big = fmaxf(big, m_part[((size_t)s * nbk + bk) * n_rows + i]);
  float out = 0.f, l = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const size_t row = ((size_t)s * nbk + bk) * n_rows + i;
    const float wgt = exp2f(m_part[row] - big);
    out += o_part[row * d + e] * wgt;
    l += l_part[row] * wgt;
  }
  const size_t row = (size_t)bk * n_rows + i;
  o[row * d + e] = out;
  if (e == 0) {
    l_out[row] = l;
    m_out[row] = l > 0.f ? big * LN2 : NEG_INF;
  }
}

// The pointers and sizes every launch takes, bundled so the dispatch
// over (dtype, d, rows) stays short.
struct PagedArgs {
  const void *qf, *k_pool, *v_pool, *k_scale, *v_scale, *table, *length;
  void *o, *l, *mx;
  int b, hkv, n_rows, m, bs, window, t;
};

template <typename T, int D, int NR>
int launch_split(const PagedArgs& a, void* o_part, void* l_part,
                 void* m_part, int n_split, int slots_per_split,
                 cudaStream_t stream) {
  dim3 grid(n_split, a.b * a.hkv);
  if constexpr (kQuant<T>) {
    paged_split_int8_kernel<D, NR><<<grid, SPLIT_WARPS * 32, 0, stream>>>(
        static_cast<const float*>(a.qf), static_cast<const T*>(a.k_pool),
        static_cast<const T*>(a.v_pool),
        static_cast<const float*>(a.k_scale),
        static_cast<const float*>(a.v_scale),
        static_cast<const int*>(a.table), static_cast<const int*>(a.length),
        static_cast<float*>(o_part), static_cast<float*>(l_part),
        static_cast<float*>(m_part), a.hkv, a.n_rows, a.m, a.bs,
        slots_per_split, a.window, a.t);
  } else {
    paged_split_kernel<T, D, NR><<<grid, SPLIT_WARPS * 32, 0, stream>>>(
        static_cast<const float*>(a.qf), static_cast<const T*>(a.k_pool),
        static_cast<const T*>(a.v_pool), static_cast<const int*>(a.table),
        static_cast<const int*>(a.length), static_cast<float*>(o_part),
        static_cast<float*>(l_part), static_cast<float*>(m_part), a.hkv,
        a.n_rows, a.m, a.bs, slots_per_split, a.window, a.t);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_merge_kernel<<<dim3(a.n_rows, a.b * a.hkv), D, 0, stream>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(l_part),
      static_cast<const float*>(m_part), static_cast<float*>(a.o),
      static_cast<float*>(a.l), static_cast<float*>(a.mx), n_split, a.n_rows,
      D);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dispatch_split(const PagedArgs& a, void* o_part, void* l_part,
                   void* m_part, int n_split, int slots_per_split,
                   cudaStream_t s) {
#define EDL_SPLIT(NR) \
  return launch_split<T, D, NR>(a, o_part, l_part, m_part, n_split, \
                                slots_per_split, s)
  if (a.n_rows <= 1) EDL_SPLIT(1);
  if (a.n_rows <= 2) EDL_SPLIT(2);
  if (a.n_rows <= 4) EDL_SPLIT(4);
  if (a.n_rows <= 8) EDL_SPLIT(8);
#undef EDL_SPLIT
  return (int)cudaErrorInvalidValue;
}

template <typename T, int D>
int launch_tile(const PagedArgs& a, cudaStream_t stream) {
  const size_t smem = tile_smem_bytes<D>(a.bs);
  static size_t configured = 48 * 1024;
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_tile_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = smem;
  }
  dim3 grid((a.n_rows + R - 1) / R, a.b * a.hkv);
  paged_tile_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(a.qf), static_cast<const T*>(a.k_pool),
      static_cast<const T*>(a.v_pool), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.table),
      static_cast<const int*>(a.length), static_cast<float*>(a.o),
      static_cast<float*>(a.l), static_cast<float*>(a.mx), a.hkv, a.n_rows,
      a.m, a.bs, a.window, a.t);
  return (int)cudaGetLastError();
}

// int8 arenas need both scale pools, float arenas take none; the query
// rows are whole tiles of t, and the window is 0 (none) or positive
bool args_ok(int dtype, const void* k_scale, const void* v_scale,
             int n_rows, int window, int t) {
  const bool scales = dtype == 2 ? (k_scale != nullptr && v_scale != nullptr)
                                 : (k_scale == nullptr && v_scale == nullptr);
  return scales && window >= 0 && t >= 1 && n_rows % t == 0;
}

}  // namespace

// Common arguments: qf [b, hkv, n_rows, d] fp32 (already multiplied by
// scale); k_pool and v_pool [num_blocks, bs, hkv, d] (dtype 0 = float32,
// 1 = bfloat16, 2 = int8); for int8, k_scale and v_scale [num_blocks, bs,
// hkv, 1] fp32 per-row scales, else NULL; table [b, m] int32 (-1 =
// unallocated); length [b] int32; o [b, hkv, n_rows, d], l and m [b, hkv,
// n_rows] fp32; d 64 or 128; window 0 (none) or the sliding window; t the
// tile length (query row r is tile token r % t). All contiguous. Each
// returns the cudaError_t of its launches (0 = ok).

// n_rows > 8: the shared-memory tile kernel.
extern "C" int edl_paged_decode_tile(const void* qf, const void* k_pool,
                                     const void* v_pool, const void* k_scale,
                                     const void* v_scale, const void* table,
                                     const void* length, void* o, void* l,
                                     void* mx, int b, int hkv, int n_rows,
                                     int m, int bs, int d, int dtype,
                                     int window, int t, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!args_ok(dtype, k_scale, v_scale, n_rows, window, t))
    return (int)cudaErrorInvalidValue;
  const PagedArgs a{qf, k_pool, v_pool, k_scale, v_scale, table, length,
                    o,  l,      mx,     b,       hkv,     n_rows, m,
                    bs, window, t};
#define EDL_TILE(T)                                             \
  return d == 64 ? launch_tile<T, 64>(a, s)                     \
                 : (d == 128 ? launch_tile<T, 128>(a, s)        \
                             : (int)cudaErrorInvalidValue)
  if (dtype == 0) EDL_TILE(float);
  if (dtype == 1) EDL_TILE(__nv_bfloat16);
  if (dtype == 2) EDL_TILE(int8_t);
#undef EDL_TILE
  return (int)cudaErrorInvalidValue;
}

// n_rows <= 8: the split kernel and its merge. o_part [n_split, b*hkv,
// n_rows, d], l_part and m_part [n_split, b*hkv, n_rows] fp32 scratch;
// split k covers table slots [k*slots_per_split, (k+1)*slots_per_split)
// (under a window: its even share of the slots the window can reach).
extern "C" int edl_paged_decode_split(
    const void* qf, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* table,
    const void* length, void* o, void* l, void* mx, void* o_part,
    void* l_part, void* m_part, int n_split, int slots_per_split, int b,
    int hkv, int n_rows, int m, int bs, int d, int dtype, int window, int t,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!args_ok(dtype, k_scale, v_scale, n_rows, window, t))
    return (int)cudaErrorInvalidValue;
  const PagedArgs a{qf, k_pool, v_pool, k_scale, v_scale, table, length,
                    o,  l,      mx,     b,       hkv,     n_rows, m,
                    bs, window, t};
#define EDL_SPLIT_D(T)                                                    \
  return d == 64 ? dispatch_split<T, 64>(a, o_part, l_part, m_part,       \
                                         n_split, slots_per_split, s)     \
                 : (d == 128 ? dispatch_split<T, 128>(a, o_part, l_part,  \
                                                      m_part, n_split,    \
                                                      slots_per_split, s) \
                             : (int)cudaErrorInvalidValue)
  if (dtype == 0) EDL_SPLIT_D(float);
  if (dtype == 1) EDL_SPLIT_D(__nv_bfloat16);
  if (dtype == 2) EDL_SPLIT_D(int8_t);
#undef EDL_SPLIT_D
  return (int)cudaErrorInvalidValue;
}
