"""Dense optimizer updates for the PyTorch port: the counterpart of
elasticdl_tpu/ops/optimizer_kernels.py.

`sgd_update`, `momentum_update`, `adam_update` (with or without
amsgrad) and `adagrad_update` take same-shaped tensors of any shape and
return the new parameter and slots as new tensors; the inputs stay as
they are, as the JAX functions leave their arrays. Every tensor takes the
parameter's dtype, as the JAX kernels cast to `arrays[0].dtype`.

Kernel: `csrc/optimizer_update.cu`, the port of `_sgd_kernel`,
`_momentum_kernel`, `_adam_kernel`, `_adam_amsgrad_kernel` and
`_adagrad_kernel` (one kernel, the rule a functor of
`csrc/update_rules.cuh`), for CUDA tensors in fp32 or bf16 (arithmetic in
fp32, a bf16 result rounded once where it is stored; 16-byte streaming
accesses where every tensor is 16-byte aligned, a scalar loop where one
is not). CPU tensors run the
plain version, `dense_update_plain`: the rules of `ops/update_math.py` in
fp32 on the same values, rounded once to the parameter's dtype.
`KERNEL_LAUNCHES` counts kernel launches per rule.

Adam's bias-corrected step size comes from `adam_alpha`, on the host;
its 1 - b1 and 1 - b2 reach the kernel computed in double and rounded
once, as the plain version's Python scalars have them (the TPU kernel
forms them in fp32 from fp32 b1, b2: 1.3e-5 off at b2 = 0.999).
"""

import ctypes

import torch

from elasticdl_tpu_torch.ops import _build
from elasticdl_tpu_torch.ops import update_math as um
from elasticdl_tpu_torch.ops.dispatch import on_kernel_path

# rule -> (code of csrc/optimizer_update.cu, number of slots)
_RULES = {"sgd": (0, 0), "momentum": (1, 1), "adam": (2, 2),
          "adagrad": (3, 1), "adam_amsgrad": (4, 3)}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches per rule; chip_smoke.py resets and reads these to show
#: that the dense update API went through the kernel
KERNEL_LAUNCHES = {"dense_" + rule: 0 for rule in _RULES}


def reset_launch_counts():
    for name in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[name] = 0


@torch.no_grad()
def dense_update_plain(rule, arrays, hyper):
    """Plain version of the dense-update kernel: `arrays` = [param,
    *slots, grad] cast to the parameter's dtype, the rule computed in
    fp32, each result rounded once to that dtype. `hyper` as the kernel
    takes them (sgd: lr; momentum: lr, mu, nesterov 0/1; adam and
    adam_amsgrad: alpha, b1, b2, eps; adagrad: lr, eps). Returns new
    tensors [param', *slots']."""
    dtype = arrays[0].dtype
    *state, g = [a.detach().to(dtype).float() for a in arrays]
    return [t.to(dtype) for t in um.rule_math(rule, state, g, hyper)]


def _dense_update(rule, arrays, hyper):
    """Run `rule` over `arrays` = [param, *slots, grad]: the kernel for
    CUDA tensors, `dense_update_plain` for CPU tensors. Returns new
    tensors [param', *slots'] in the parameter's dtype."""
    code, n_slots = _RULES[rule]
    if len(arrays) != n_slots + 2:
        raise ValueError("%s takes a parameter, %d slots and a gradient"
                         % (rule, n_slots))
    shape = arrays[0].shape
    if any(a.shape != shape for a in arrays):
        raise ValueError("%s: tensors of one shape needed, got %s"
                         % (rule, [tuple(a.shape) for a in arrays]))
    if not on_kernel_path(*arrays):
        return dense_update_plain(rule, arrays, hyper)
    dtype = arrays[0].dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError("dense update kernel takes %s parameters, got %s"
                        % ([str(d) for d in _DTYPE_CODES], dtype))
    ins = [a.detach().to(dtype).contiguous() for a in arrays]
    outs = [torch.empty_like(ins[0]) for _ in range(n_slots + 1)]
    n = ins[0].numel()
    if n == 0:
        return outs
    # the kernel's 16-byte accesses need every tensor 16-byte aligned;
    # otherwise it runs its scalar loop
    vec = int(all(t.data_ptr() % 16 == 0 for t in ins + outs))
    ptr_in = [t.data_ptr() for t in ins] + [None] * (5 - len(ins))
    ptr_out = [t.data_ptr() for t in outs] + [None] * (4 - len(outs))
    h = [float(x) for x in hyper] + [0.0] * (4 - len(hyper))
    # Adam's 1 - b1 and 1 - b2, in double and rounded once (see above)
    h += [1.0 - h[1], 1.0 - h[2]] if rule.startswith("adam") else [0.0, 0.0]
    err = _dense_lib().edl_dense_update(
        code, _DTYPE_CODES[dtype], *ptr_in, *ptr_out, n, vec, *h,
        torch.cuda.current_stream(ins[0].device).cuda_stream)
    if err != 0:
        raise RuntimeError("dense_update kernel launch failed: cudaError %d"
                           % err)
    KERNEL_LAUNCHES["dense_" + rule] += 1
    return outs


def _dense_lib():
    lib = _build.load("optimizer_update")
    fn = lib.edl_dense_update
    if not fn.argtypes:
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 9
                       + [ctypes.c_longlong, ctypes.c_int]
                       + [ctypes.c_float] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def sgd_update(param, grad, lr):
    """param - lr * grad, as a new tensor (kernel_api.cc `SGD`)."""
    return _dense_update("sgd", [param, grad], [lr])[0]


def momentum_update(param, velocity, grad, lr, momentum=0.9,
                    nesterov=False):
    """Heavy-ball or Nesterov momentum (kernel_api.cc `Momentum`).
    Returns (new_param, new_velocity)."""
    return tuple(_dense_update("momentum", [param, velocity, grad],
                               [lr, momentum, 1.0 if nesterov else 0.0]))


def adam_update(param, m, v, grad, step, lr, beta1=0.9, beta2=0.999,
                eps=1e-8, max_square=None):
    """Bias-corrected Adam, with amsgrad when `max_square` is given
    (kernel_api.cc `Adam`); `step` is the 1-based update count. Returns
    (new_param, new_m, new_v), or (..., new_max_square) with amsgrad."""
    hyper = [um.adam_alpha(lr, beta1, beta2, step), beta1, beta2, eps]
    if max_square is None:
        return tuple(_dense_update("adam", [param, m, v, grad], hyper))
    return tuple(_dense_update("adam_amsgrad",
                               [param, m, v, max_square, grad], hyper))


def adagrad_update(param, accum, grad, lr, eps=1e-10):
    """Adagrad (kernel_api.cc `Adagrad`). Returns (new_param,
    new_accum)."""
    return tuple(_dense_update("adagrad", [param, accum, grad], [lr, eps]))
