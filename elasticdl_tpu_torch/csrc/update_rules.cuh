// Optimizer update rules as device functors, shared by the row-sparse
// kernel (row_update.cu) and the dense kernel (optimizer_update.cu).
//
// The rules of elasticdl_tpu/ops/update_math.py, one element at a time:
// each functor holds its hyperparameters by value and updates the
// parameter p and its kSlots slot values s[0..kSlots) in place, given the
// gradient g. Every multiply, add and subtract is rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn never contract into a fused
// multiply-add) and the square roots and divisions are the IEEE-rounded
// ones, in the order elasticdl_tpu_torch/ops/update_math.py writes them,
// so a rule gives exactly the fp32 values its plain PyTorch version gives
// op by op.
//
// Adam's c1 = 1 - b1 and c2 = 1 - b2 come from the host, computed in
// double and rounded once: 1.f - b2 here would round b2 first (1.3e-5
// off at 0.999). Its step size alpha is bias-corrected on the host
// (adam_alpha), as the TPU kernels receive it.

#pragma once

namespace edl {

struct Sgd {
  static constexpr int kSlots = 0;
  float lr;
  __device__ __forceinline__ void operator()(float& p, float*, float g) const {
    p = __fsub_rn(p, __fmul_rn(lr, g));
  }
};

// nesterov is 0 or 1 (the JAX package passes it as a float flag too)
struct Momentum {
  static constexpr int kSlots = 1;
  float lr, mu, nesterov;
  __device__ __forceinline__ void operator()(float& p, float* s,
                                             float g) const {
    const float v = __fadd_rn(__fmul_rn(mu, s[0]), g);
    const float step = nesterov > 0.f ? __fadd_rn(__fmul_rn(mu, v), g) : v;
    p = __fsub_rn(p, __fmul_rn(lr, step));
    s[0] = v;
  }
};

struct Adam {
  static constexpr int kSlots = 2;  // m, v
  float alpha, b1, b2, eps, c1, c2;
  __device__ __forceinline__ void operator()(float& p, float* s,
                                             float g) const {
    const float m = __fadd_rn(__fmul_rn(b1, s[0]), __fmul_rn(c1, g));
    const float v =
        __fadd_rn(__fmul_rn(b2, s[1]), __fmul_rn(__fmul_rn(c2, g), g));
    p = __fsub_rn(p, __fdiv_rn(__fmul_rn(alpha, m),
                               __fadd_rn(__fsqrt_rn(v), eps)));
    s[0] = m;
    s[1] = v;
  }
};

// Adam whose denominator reads the running maximum of v
struct AdamAmsgrad {
  static constexpr int kSlots = 3;  // m, v, max v
  float alpha, b1, b2, eps, c1, c2;
  __device__ __forceinline__ void operator()(float& p, float* s,
                                             float g) const {
    const float m = __fadd_rn(__fmul_rn(b1, s[0]), __fmul_rn(c1, g));
    const float v =
        __fadd_rn(__fmul_rn(b2, s[1]), __fmul_rn(__fmul_rn(c2, g), g));
    const float ms = fmaxf(s[2], v);
    p = __fsub_rn(p, __fdiv_rn(__fmul_rn(alpha, m),
                               __fadd_rn(__fsqrt_rn(ms), eps)));
    s[0] = m;
    s[1] = v;
    s[2] = ms;
  }
};

struct Adagrad {
  static constexpr int kSlots = 1;  // accumulator
  float lr, eps;
  __device__ __forceinline__ void operator()(float& p, float* s,
                                             float g) const {
    const float a = __fadd_rn(s[0], __fmul_rn(g, g));
    p = __fsub_rn(p, __fdiv_rn(__fmul_rn(lr, g),
                               __fadd_rn(__fsqrt_rn(a), eps)));
    s[0] = a;
  }
};

}  // namespace edl
