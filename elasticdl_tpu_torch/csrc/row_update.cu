// Row-sparse optimizer updates for Hopper (sm_90a), over up to MAX_TABLES
// tables in one launch.
//
// Replaces the TPU kernels built by
// elasticdl_tpu/ops/embedding_ops.py::_make_row_kernel (_sgd_row_kernel,
// _momentum_row_kernel, _adam_row_kernel, _adagrad_row_kernel, launched
// by _row_update_call through pl.pallas_call). Same function, per table:
// for each id in [0, vocab) read the table row and its slot rows, apply
// the rule of elasticdl_tpu/ops/update_math.py with the id's gradient
// row, write them back in place; ids < 0 (padding) and ids >= vocab are
// skipped. The ids of a table must be unique, the TPU kernel's contract
// too: two lanes updating one row would race. The row tier deduplicates
// before every call. A DLRM step updates its 26 tables at once, each
// with its own hyperparameters (its own update count and schedule); the
// TPU kernel took them one pallas_call each.
//
// What bounds it on the H100: a few operations per element against
// 4 bytes read and written per table element and 4 read per gradient
// element, so it is bound by memory bytes (3.35 TB/s): 12.3 us for a
// DLRM step's 26 SGD updates of 4096 rows of 32 fp32. As in the gather,
// the rows are scattered over tables far larger than L2 and a row's
// address waits for its id, so what counts are the launches and the
// rows in flight.
//
// Design: the gather's (csrc/embedding_gather.cu). One launch for all
// the tables a call gives, each table's pointers, counts and
// hyperparameters passed by value in the kernel's parameters
// (__grid_constant__); grid row y is table y, whose blocks' warps walk
// its 32-id chunks, load a chunk's 32 ids in one coalesced load and hand
// them out by shuffle. A row is split over float4 units when dim is a
// multiple of 4 and every pointer is 16-byte aligned (8 lanes a row at
// dim 32, 4 rows a warp pass), over floats otherwise; each lane loads
// its units' table, slot and gradient values for BATCH passes before the
// math, none of the loads predicated (a lane that updates nothing reads
// row 0 and stores nothing), then stores them. The rule is a device
// functor of update_rules.cuh (shared with the dense kernel,
// optimizer_update.cu), applied to each float on its own, so every
// operation rounds as the plain version's does: sgd (1 table), momentum
// (2: velocity), adam (3: m, v), adagrad (2: accumulator). fp32 only;
// offsets are 64-bit.

#include <cuda_runtime.h>

#include "update_rules.cuh"

namespace {

constexpr int MAX_TABLES = 32;  // ops/embedding_ops.py's GROUP_TABLES
constexpr int SMS = 132;

struct RowTable {
  float* t[3];  // the table, then its slot tables
  const int* ids;
  const float* grads;
  long long n;
  long long vocab;
  float h[6];  // the rule's hyperparameters, unused ones 0
};

struct RowArgs {
  RowTable t[MAX_TABLES];  // table y is grid row y
  int units;               // units of U in a row
};

template <class Rule>
__device__ __forceinline__ Rule rule_of(const float* h);
template <>
__device__ __forceinline__ edl::Sgd rule_of<edl::Sgd>(const float* h) {
  return {h[0]};
}
template <>
__device__ __forceinline__ edl::Momentum rule_of<edl::Momentum>(
    const float* h) {
  return {h[0], h[1], h[2]};
}
template <>
__device__ __forceinline__ edl::Adam rule_of<edl::Adam>(const float* h) {
  return {h[0], h[1], h[2], h[3], h[4], h[5]};
}
template <>
__device__ __forceinline__ edl::Adagrad rule_of<edl::Adagrad>(
    const float* h) {
  return {h[0], h[1]};
}

template <class Rule>
__device__ __forceinline__ void apply(const Rule& rule, float& p, float* s,
                                      float g) {
  rule(p, s, g);
}

// the rule on each float of a float4 unit, in order
template <class Rule>
__device__ __forceinline__ void apply(const Rule& rule, float4& p, float4* s,
                                      float4 g) {
  constexpr int S = Rule::kSlots;
  float* pp = reinterpret_cast<float*>(&p);
  const float* gg = reinterpret_cast<const float*>(&g);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float se[S > 0 ? S : 1];
#pragma unroll
    for (int k = 0; k < S; ++k) se[k] = reinterpret_cast<float*>(s + k)[e];
    rule(pp[e], se, gg[e]);
#pragma unroll
    for (int k = 0; k < S; ++k) reinterpret_cast<float*>(s + k)[e] = se[k];
  }
}

// U: float4 (16-byte units) or float
template <class Rule, typename U>
__global__ void __launch_bounds__(256)
    row_update_kernel(const __grid_constant__ RowArgs args) {
  constexpr int S = Rule::kSlots;
  // passes whose loads a lane issues before its math: 8 units of the
  // table and the gradient for sgd, 4 of every tensor otherwise
  constexpr int BATCH = S == 0 ? 8 : 4;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const RowTable& d = args.t[blockIdx.y];
  const Rule rule = rule_of<Rule>(d.h);
  const int units = args.units;
  const int q = 32 / units, r = 32 % units;
  for (long long first = ((long long)blockIdx.x * warps + (threadIdx.x >> 5))
                         * 32;
       first < d.n; first += (long long)gridDim.x * warps * 32) {
    const int count = (int)min(32LL, d.n - first);
    int id = -1;  // -1: a row this lane's chunk does not update
    if (lane < count) {
      const long long raw = __ldg(d.ids + first + lane);
      if (raw >= 0 && raw < d.vocab) id = (int)raw;
    }
    U* rows[S + 1];
#pragma unroll
    for (int k = 0; k <= S; ++k) rows[k] = reinterpret_cast<U*>(d.t[k]);
    const U* __restrict__ g = reinterpret_cast<const U*>(d.grads)
                              + first * units;
    const int n_units = count * units;
    int row = lane / units, u = lane % units;
    for (int base = 0; base < n_units; base += 32 * BATCH) {
      U p[BATCH], s[BATCH][S > 0 ? S : 1], gv[BATCH];
      long long at[BATCH];  // the unit's offset in the tables, -1: none
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        // every lane loads, from row 0 and the chunk's last gradient
        // unit where it updates nothing, so no load is predicated (as in
        // the gather: a predicated load's value is moved into place
        // behind the next load, which waits on it)
        const int src = __shfl_sync(0xffffffffu, id, row & 31);
        const int f = base + 32 * k + lane;
        const long long from = (long long)(src < 0 ? 0 : src) * units + u;
        at[k] = f < n_units && src >= 0 ? from : -1;
        p[k] = rows[0][from];
#pragma unroll
        for (int j = 0; j < S; ++j) s[k][j] = rows[j + 1][from];
        gv[k] = __ldcs(g + min(f, n_units - 1));
        row += q;
        u += r;
        if (u >= units) {
          u -= units;
          ++row;
        }
      }
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        if (at[k] < 0) continue;
        apply(rule, p[k], s[k], gv[k]);
        rows[0][at[k]] = p[k];
#pragma unroll
        for (int j = 0; j < S; ++j) rows[j + 1][at[k]] = s[k][j];
      }
    }
  }
}

int warps_per_block(long long chunks) {
  int w = 8;
  while (w > 1 && chunks < (long long)w * SMS * 8) w >>= 1;
  return w;
}

// grid as the gather's: a row per table, blocks enough for the largest
// table's chunks (grid-stride beyond SMS * 32 blocks in all)
template <class Rule>
int launch(const RowArgs& args, int n_tables, long long chunks,
           long long most_chunks, int vec16, cudaStream_t stream) {
  const int warps = warps_per_block(chunks);
  long long x = (most_chunks + warps - 1) / warps;
  if (x * n_tables > SMS * 32) x = (SMS * 32 + n_tables - 1) / n_tables;
  const dim3 grid((unsigned)x, (unsigned)n_tables);
  if (vec16)
    row_update_kernel<Rule, float4><<<grid, warps * 32, 0, stream>>>(args);
  else
    row_update_kernel<Rule, float><<<grid, warps * 32, 0, stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace

// rule: 0 sgd (h0 = lr), 1 momentum (lr, mu, nesterov 0/1), 2 adam
// (alpha, b1, b2, eps, 1 - b1, 1 - b2), 3 adagrad (lr, eps). n_tables
// tables (1..MAX_TABLES), each described by 7 values in `desc`: the
// table and its two slot tables (0 where the rule has none), all
// [vocab, dim] fp32 contiguous, ids [n] int32 unique, grads [n, dim]
// fp32 (pointers as integers), n > 0, vocab > 0; and by 6 values in
// `hyper` (unused ones 0). vec16: 1 when dim is a multiple of 4 and
// every table, slot and grads pointer is 16-byte aligned. One launch.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int edl_row_update(int rule, int n_tables, const long long* desc,
                              const float* hyper, int dim, int vec16,
                              void* stream) {
  static const int kTables[4] = {1, 2, 3, 2};
  if (rule < 0 || rule > 3 || n_tables < 1 || n_tables > MAX_TABLES ||
      dim <= 0)
    return (int)cudaErrorInvalidValue;
  RowArgs args;
  long long chunks = 0, most = 0;
  for (int i = 0; i < n_tables; ++i) {
    const long long* v = desc + 7 * i;
    RowTable& d = args.t[i];
    for (int k = 0; k < 3; ++k) {
      d.t[k] = reinterpret_cast<float*>(v[k]);
      if (k < kTables[rule] && d.t[k] == nullptr)
        return (int)cudaErrorInvalidValue;
    }
    d.ids = reinterpret_cast<const int*>(v[3]);
    d.grads = reinterpret_cast<const float*>(v[4]);
    d.n = v[5];
    d.vocab = v[6];
    if (d.n <= 0 || d.vocab <= 0) return (int)cudaErrorInvalidValue;
    for (int k = 0; k < 6; ++k) d.h[k] = hyper[6 * i + k];
    chunks += (d.n + 31) / 32;
    if ((d.n + 31) / 32 > most) most = (d.n + 31) / 32;
  }
  args.units = vec16 ? dim / 4 : dim;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rule) {
    case 0:
      return launch<edl::Sgd>(args, n_tables, chunks, most, vec16, s);
    case 1:
      return launch<edl::Momentum>(args, n_tables, chunks, most, vec16, s);
    case 2:
      return launch<edl::Adam>(args, n_tables, chunks, most, vec16, s);
    default:
      return launch<edl::Adagrad>(args, n_tables, chunks, most, vec16, s);
  }
}
