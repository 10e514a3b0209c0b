// Row-sparse optimizer updates for Hopper (sm_90a).
//
// Replaces the TPU kernels built by
// elasticdl_tpu/ops/embedding_ops.py::_make_row_kernel (_sgd_row_kernel,
// _momentum_row_kernel, _adam_row_kernel, _adagrad_row_kernel, launched
// by _row_update_call through pl.pallas_call). Same function: for each id
// in [0, vocab) read the table row and its slot rows, apply the rule of
// elasticdl_tpu/ops/update_math.py with the id's gradient row, write them
// back in place; ids < 0 (padding) and ids >= vocab are skipped. The ids
// must be unique, the TPU kernel's contract too: two warps updating one
// row would race. The row tier deduplicates before every call.
//
// What bounds it on the H100: a few operations per element against
// 4 bytes read and written per table element and 4 read per gradient
// element, so it is bound by memory bytes (3.35 TB/s). As in the gather,
// the rows are scattered over tables far larger than L2, so rows in
// flight are what count.
//
// Design: one templated kernel, the rule a device functor from
// update_rules.cuh (shared with the dense kernel, optimizer_update.cu)
// holding its hyperparameters by value: sgd (1 table), momentum (2:
// velocity), adam (3: m, v), adagrad (2: accumulator). One warp per id,
// grid-stride over ids, one element a lane per pass over the row; the row
// offset is computed in 64 bits. fp32 tables only.

#include <cuda_runtime.h>

#include "update_rules.cuh"

namespace {

constexpr int NT = 256;  // 8 warps a block
constexpr int WARPS = NT / 32;

struct Tables {
  float* t[3];
};

template <class Rule>
__global__ void __launch_bounds__(NT)
    row_update_kernel(Tables tables, const int* __restrict__ ids,
                      const float* __restrict__ grads, long long n,
                      long long vocab, int dim, Rule rule) {
  constexpr int S = Rule::kSlots;
  const int lane = threadIdx.x & 31;
  const long long nwarps = (long long)gridDim.x * WARPS;
  for (long long i = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
       i < n; i += nwarps) {
    const long long r = __ldg(ids + i);
    if (r < 0 || r >= vocab) continue;
    float* rows[S + 1];
#pragma unroll
    for (int k = 0; k <= S; ++k) rows[k] = tables.t[k] + r * dim;
    const float* g = grads + i * dim;
    for (int j = lane; j < dim; j += 32) {
      float p = rows[0][j];
      float s[S > 0 ? S : 1];
#pragma unroll
      for (int k = 0; k < S; ++k) s[k] = rows[k + 1][j];
      rule(p, s, __ldg(g + j));
      rows[0][j] = p;
#pragma unroll
      for (int k = 0; k < S; ++k) rows[k + 1][j] = s[k];
    }
  }
}

template <class Rule>
int launch(const Tables& tables, const void* ids, const void* grads,
           long long n, long long vocab, int dim, Rule rule,
           cudaStream_t stream) {
  for (int k = 0; k <= Rule::kSlots; ++k)
    if (tables.t[k] == nullptr) return (int)cudaErrorInvalidValue;
  long long blocks = (n + WARPS - 1) / WARPS;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond this
  row_update_kernel<Rule><<<(unsigned)blocks, NT, 0, stream>>>(
      tables, static_cast<const int*>(ids), static_cast<const float*>(grads),
      n, vocab, dim, rule);
  return (int)cudaGetLastError();
}

}  // namespace

// rule: 0 sgd (h0 = lr), 1 momentum (lr, mu, nesterov 0/1), 2 adam
// (alpha, b1, b2, eps, 1 - b1, 1 - b2), 3 adagrad (lr, eps); unused h are
// 0. t0 is the table, t1/t2 its slot tables (NULL where the rule has
// none), all [vocab, dim] fp32 contiguous; ids [n] int32, unique; grads
// [n, dim] fp32. Returns the cudaError_t of the launch (0 = launched).
extern "C" int edl_row_update(int rule, void* t0, void* t1, void* t2,
                              const void* ids, const void* grads, long long n,
                              long long vocab, int dim, float h0, float h1,
                              float h2, float h3, float h4, float h5,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || dim <= 0) return 0;
  Tables tables{{static_cast<float*>(t0), static_cast<float*>(t1),
                 static_cast<float*>(t2)}};
  switch (rule) {
    case 0:
      return launch(tables, ids, grads, n, vocab, dim, edl::Sgd{h0}, s);
    case 1:
      return launch(tables, ids, grads, n, vocab, dim,
                    edl::Momentum{h0, h1, h2}, s);
    case 2:
      return launch(tables, ids, grads, n, vocab, dim,
                    edl::Adam{h0, h1, h2, h3, h4, h5}, s);
    case 3:
      return launch(tables, ids, grads, n, vocab, dim,
                    edl::Adagrad{h0, h1}, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
