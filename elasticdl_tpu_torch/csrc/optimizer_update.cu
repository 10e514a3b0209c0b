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
// Design: one kernel, templated on the storage type and on the rule, a
// functor from update_rules.cuh (shared with row_update.cu). A
// grid-stride loop walks the flat element count; where every pointer is
// aligned for it, each thread moves 4 elements at a time with one vector
// access per tensor (float4 for fp32, 8 bytes for bf16) and a scalar loop
// takes the tail. The TPU wrapper pads every tensor to 256 x 128 blocks
// and reshapes it, a Mosaic layout rule that here would only copy each
// tensor twice more: any element count, the 0-d scalar included, runs as
// it is.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "update_rules.cuh"

namespace {

constexpr int NT = 256;
constexpr int VEC = 4;  // elements per vector access

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

__device__ __forceinline__ void load_vec(const float* x, long long i,
                                         float (&v)[VEC]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(x) + i);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* x, long long i,
                                         float (&v)[VEC]) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(x) + i);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store_vec(float* x, long long i,
                                          const float (&v)[VEC]) {
  reinterpret_cast<float4*>(x)[i] = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* x, long long i,
                                          const float (&v)[VEC]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&a);
  raw.y = *reinterpret_cast<const unsigned*>(&b);
  reinterpret_cast<uint2*>(x)[i] = raw;
}

template <typename T, class Rule>
__global__ void __launch_bounds__(NT)
    dense_update_kernel(Arrays<T> a, long long n, int vec, Rule rule) {
  constexpr int S = Rule::kSlots;
  const long long stride = (long long)gridDim.x * NT;
  const long long tid = (long long)blockIdx.x * NT + threadIdx.x;
  long long tail = 0;
  if (vec) {
    const long long nv = n / VEC;
    for (long long i = tid; i < nv; i += stride) {
      float p[VEC], g[VEC], s[S > 0 ? S : 1][VEC];
      load_vec(a.in[0], i, p);
#pragma unroll
      for (int k = 0; k < S; ++k) load_vec(a.in[k + 1], i, s[k]);
      load_vec(a.in[S + 1], i, g);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float se[S > 0 ? S : 1];
#pragma unroll
        for (int k = 0; k < S; ++k) se[k] = s[k][e];
        rule(p[e], se, g[e]);
#pragma unroll
        for (int k = 0; k < S; ++k) s[k][e] = se[k];
      }
      store_vec(a.out[0], i, p);
#pragma unroll
      for (int k = 0; k < S; ++k) store_vec(a.out[k + 1], i, s[k]);
    }
    tail = nv * VEC;
  }
  for (long long i = tail + tid; i < n; i += stride) {
    float p = to_f(a.in[0][i]);
    float s[S > 0 ? S : 1];
#pragma unroll
    for (int k = 0; k < S; ++k) s[k] = to_f(a.in[k + 1][i]);
    rule(p, s, to_f(a.in[S + 1][i]));
    a.out[0][i] = from_f<T>(p);
#pragma unroll
    for (int k = 0; k < S; ++k) a.out[k + 1][i] = from_f<T>(s[k]);
  }
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
  const long long work = vec ? n / VEC + n % VEC : n;
  long long blocks = (work + NT - 1) / NT;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  dense_update_kernel<T, Rule><<<(unsigned)blocks, NT, 0, stream>>>(
      a, n, vec, rule);
  return (int)cudaGetLastError();
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
// vec = 1 only when every pointer is aligned to 4 elements. Returns the
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
