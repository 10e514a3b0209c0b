// Dense optimizer updates for Hopper (sm_90a).
//
// Replaces the TPU kernels of elasticdl_tpu/ops/optimizer_kernels.py
// (_sgd_kernel, _momentum_kernel, _adam_kernel, _adam_amsgrad_kernel,
// _adagrad_kernel, launched by _blocked_call through pl.pallas_call).
// Same function: for same-shaped tensors of any shape, the new parameter
// and slots of one update rule of elasticdl_tpu/ops/update_math.py,
// element by element, written to new tensors (the inputs stay as they
// are, as JAX arrays do). Storage is fp32 or bf16; the arithmetic is fp32
// and a bf16 result is rounded once, where it is stored.
//
// What bounds it on the H100: bytes. A rule does 2 to 15 operations per
// element against 4 to 9 tensors of 4 (or 2) bytes read or written, far
// below the ~20 operations per byte at which fp32 arithmetic would bound
// it, so the least time is the tensors' bytes over 3.35 TB/s.
//
// Design: one kernel, templated on the storage type, the rule (a functor
// from update_rules.cuh, shared with row_update.cu) and the index type
// (32-bit below 2^31 elements). Every access is 16 bytes (4 fp32 or 8
// bf16 elements): each thread reads one 16-byte vector of every tensor,
// applies the rule and writes the results, and the grid covers the
// vectors once (as PyTorch's own elementwise kernels do), the thread
// past the last vector taking the scalar tail (fewer than a vector's
// elements). A tensor not 16-byte aligned takes the scalar path, one
// element a thread. Measured on an H100 (PERF.md, PR 9), this one-shot
// grid beats a grid of the card's resident blocks walking tiles by 4-7%,
// and plain loads and stores beat streaming cache hints (ld/st.global.cs)
// and 2-4 vectors a thread by 1-5%. The TPU wrapper pads every tensor to
// 256 x 128 blocks and reshapes it, a Mosaic layout rule that here would
// only copy each tensor twice more: any element count, the 0-d scalar
// included, runs as it is.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

#include "update_rules.cuh"

namespace {

constexpr int NT = 256;

// in[0] the parameter, in[1..S] its slots, in[S+1] the gradient; out[0]
// the new parameter, out[1..S] the new slots
template <typename T>
struct Arrays {
  const T* in[5];
  T* out[4];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16 bytes as fp32 values: 4 fp32 or 8 bf16 elements
template <typename T>
constexpr int kVec = 16 / sizeof(T);

__device__ __forceinline__ void unpack(const uint4& r, float (&v)[4]) {
  v[0] = __uint_as_float(r.x); v[1] = __uint_as_float(r.y);
  v[2] = __uint_as_float(r.z); v[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&v)[8]) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]));
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ uint4 pack(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    w[k] = *reinterpret_cast<const unsigned*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T, typename I>
__device__ __forceinline__ uint4 load_vec(const T* x, I i) {
  return __ldg(reinterpret_cast<const uint4*>(x) + i);
}

// one 16-byte vector of every tensor, given as read: the rule on each of
// its elements, the results stored at vector index i
template <typename T, class Rule, typename I>
__device__ __forceinline__ void update_vec(const Arrays<T>& a, I i,
                                           const uint4 (&raw)[Rule::kSlots + 2],
                                           const Rule& rule) {
  constexpr int S = Rule::kSlots, V = kVec<T>;
  float p[V], g[V], s[S > 0 ? S : 1][V];
  unpack(raw[0], p);
#pragma unroll
  for (int k = 0; k < S; ++k) unpack(raw[k + 1], s[k]);
  unpack(raw[S + 1], g);
#pragma unroll
  for (int e = 0; e < V; ++e) {
    float se[S > 0 ? S : 1];
#pragma unroll
    for (int k = 0; k < S; ++k) se[k] = s[k][e];
    rule(p[e], se, g[e]);
#pragma unroll
    for (int k = 0; k < S; ++k) s[k][e] = se[k];
  }
  reinterpret_cast<uint4*>(a.out[0])[i] = pack(p);
#pragma unroll
  for (int k = 0; k < S; ++k)
    reinterpret_cast<uint4*>(a.out[k + 1])[i] = pack(s[k]);
}

// one rule on element i, as read and written in T
template <typename T, class Rule, typename I>
__device__ __forceinline__ void update_elem(const Arrays<T>& a, I i,
                                            const Rule& rule) {
  constexpr int S = Rule::kSlots;
  float p = to_f(a.in[0][i]);
  float s[S > 0 ? S : 1];
#pragma unroll
  for (int k = 0; k < S; ++k) s[k] = to_f(a.in[k + 1][i]);
  rule(p, s, to_f(a.in[S + 1][i]));
  a.out[0][i] = from_f<T>(p);
#pragma unroll
  for (int k = 0; k < S; ++k) a.out[k + 1][i] = from_f<T>(s[k]);
}

// vec: thread i takes vector i, and thread n / V the scalar tail; else
// thread i takes element i
template <typename T, class Rule, typename I>
__global__ void __launch_bounds__(NT)
    dense_update_kernel(Arrays<T> a, I n, int vec, Rule rule) {
  constexpr int NA = Rule::kSlots + 2, V = kVec<T>;
  const I i = (I)blockIdx.x * NT + threadIdx.x;
  if (!vec) {
    if (i < n) update_elem<T, Rule, I>(a, i, rule);
    return;
  }
  const I nv = n / V;
  if (i < nv) {
    uint4 raw[NA];
#pragma unroll
    for (int k = 0; k < NA; ++k) raw[k] = load_vec(a.in[k], i);
    update_vec<T, Rule, I>(a, i, raw, rule);
  } else if (i == nv) {
    for (I j = nv * V; j < n; ++j) update_elem<T, Rule, I>(a, j, rule);
  }
}

template <typename T, class Rule, typename I>
int launch_as(const Arrays<T>& a, long long n, int vec, const Rule& rule,
              cudaStream_t stream) {
  const long long threads = vec ? n / kVec<T> + 1 : n;
  const long long blocks = (threads + NT - 1) / NT;
  dense_update_kernel<T, Rule, I><<<(unsigned)blocks, NT, 0, stream>>>(
      a, (I)n, vec, rule);
  return (int)cudaGetLastError();
}

template <typename T, class Rule>
int launch(const void* const* in, void* const* out, long long n, int vec,
           Rule rule, cudaStream_t stream) {
  constexpr int S = Rule::kSlots;
  Arrays<T> a{};
  for (int k = 0; k < S + 2; ++k) {
    if (in[k] == nullptr) return (int)cudaErrorInvalidValue;
    a.in[k] = static_cast<const T*>(in[k]);
  }
  for (int k = 0; k < S + 1; ++k) {
    if (out[k] == nullptr) return (int)cudaErrorInvalidValue;
    a.out[k] = static_cast<T*>(out[k]);
  }
  // 32-bit indices where the last thread's index fits
  if (n < INT_MAX - NT)
    return launch_as<T, Rule, int>(a, n, vec, rule, stream);
  return launch_as<T, Rule, long long>(a, n, vec, rule, stream);
}

template <typename T>
int by_rule(int rule, const void* const* in, void* const* out, long long n,
            int vec, const float* h, cudaStream_t s) {
  switch (rule) {
    case 0:
      return launch<T>(in, out, n, vec, edl::Sgd{h[0]}, s);
    case 1:
      return launch<T>(in, out, n, vec, edl::Momentum{h[0], h[1], h[2]}, s);
    case 2:
      return launch<T>(in, out, n, vec,
                       edl::Adam{h[0], h[1], h[2], h[3], h[4], h[5]}, s);
    case 3:
      return launch<T>(in, out, n, vec, edl::Adagrad{h[0], h[1]}, s);
    case 4:
      return launch<T>(in, out, n, vec,
                       edl::AdamAmsgrad{h[0], h[1], h[2], h[3], h[4], h[5]},
                       s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// rule: 0 sgd (h0 = lr), 1 momentum (lr, mu, nesterov 0/1), 2 adam and
// 4 adam with amsgrad (alpha, b1, b2, eps, 1 - b1, 1 - b2), 3 adagrad (lr,
// eps); unused h are 0. dtype 0 = float32, 1 = bfloat16, for every
// tensor. in0 the parameter, in1..in3 its slots in the rule's order (m, v,
// max v for adam; the velocity; the accumulator), then the gradient in
// the first unused in slot; out0 the new parameter, out1..out3 the new
// slots; NULL where the rule has none. All hold n contiguous elements;
// vec = 1 only when every pointer is aligned to 16 bytes. Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int edl_dense_update(int rule, int dtype, const void* in0,
                                const void* in1, const void* in2,
                                const void* in3, const void* in4, void* out0,
                                void* out1, void* out2, void* out3,
                                long long n, int vec, float h0, float h1,
                                float h2, float h3, float h4, float h5,
                                void* stream) {
  if (n <= 0) return 0;
  const void* in[5] = {in0, in1, in2, in3, in4};
  void* out[4] = {out0, out1, out2, out3};
  const float h[6] = {h0, h1, h2, h3, h4, h5};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_rule<float>(rule, in, out, n, vec, h, s);
  if (dtype == 1) return by_rule<__nv_bfloat16>(rule, in, out, n, vec, h, s);
  return (int)cudaErrorInvalidValue;
}
