"""The port's dense optimizer updates against the JAX package's.

Same numpy-seeded inputs through `elasticdl_tpu.ops.optimizer_kernels`
(its Pallas kernels in interpret mode, and its jnp path) and through
`elasticdl_tpu_torch.ops.optimizer_kernels`, which runs its kernel's
plain version on the CPU (chip_smoke.py holds the CUDA kernel against
that plain version on the card). Shapes: a 0-d scalar, (7, 33), (50,),
(40,) and (3, 5, 7), none a multiple of the TPU's 256 x 128 block.

Tolerances, as max |err| / max |ref| of each output:

* fp32 against the jnp path: 1e-7. Both compute the same fp32
  operations in the same order from the same Python-float
  hyperparameters (measured 0 for all rules but Adagrad, 6e-9).
* fp32 against the interpreted kernel: 1e-6. The kernel receives its
  hyperparameters as fp32 and forms Adam's 1 - b1 and 1 - b2 from them
  (1 - 0.999f is 1.3e-5 off 0.001), where the port rounds them once
  from double (measured 4.5e-7 for Adam, under 1e-7 for the others).
* bf16: the JAX kernel refuses bf16 parameters here (it stores an fp32
  value into a bf16 ref), so the reference is its fp32 kernel on the
  bf16 values, rounded to bf16 once: the port's contract (fp32
  arithmetic, one rounding). Within 2^-7, one bf16 unit in the last
  place of an element (an fp32 difference can tip a rounding). Against
  the jnp path, which rounds to bf16 after every operation: 2^-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elasticdl_tpu.ops import optimizer_kernels as jok
from elasticdl_tpu_torch.ops import optimizer_kernels as tok
from elasticdl_tpu_torch.ops import update_math as um

torch.set_num_threads(2)

SHAPES = [(), (7, 33), (50,), (40,), (3, 5, 7)]
TOL_JNP_FP32 = 1e-7
TOL_KERNEL_FP32 = 1e-6
TOL_KERNEL_BF16 = 2.0 ** -7
TOL_JNP_BF16 = 2.0 ** -6

# rule -> (the update function, its tensor inputs by name, its
# hyperparameters); "amsgrad" is adam_update with max_square
RULES = {
    "sgd": ("sgd_update", ("p", "g"), dict(lr=0.1)),
    "momentum": ("momentum_update", ("p", "vel", "g"),
                 dict(lr=0.1, momentum=0.9, nesterov=False)),
    "nesterov": ("momentum_update", ("p", "vel", "g"),
                 dict(lr=0.1, momentum=0.9, nesterov=True)),
    "adam": ("adam_update", ("p", "m", "v", "g"), dict(step=3, lr=1e-3)),
    "amsgrad": ("adam_update", ("p", "m", "v", "g"),
                dict(step=3, lr=1e-3, beta1=0.8, beta2=0.99, eps=1e-6)),
    "adagrad": ("adagrad_update", ("p", "acc", "g"), dict(lr=0.1)),
}


def _inputs(shape, seed):
    rs = np.random.RandomState(seed)

    def draw(scale=1.0, positive=False):
        x = np.asarray(rs.randn(*shape) * scale, np.float32)
        return np.asarray(np.abs(x) if positive else x, np.float32)

    return {"p": draw(), "g": draw(), "vel": draw(0.1), "m": draw(0.1),
            "v": draw(0.1, True), "acc": draw(0.1, True),
            "ms": draw(0.12, True)}


def _port(rule, arrays, dtype):
    fn, names, kw = RULES[rule]
    tensors = [torch.from_numpy(arrays[n]).to(dtype) for n in names]
    kw = dict(kw)
    inputs = list(tensors)
    if rule == "amsgrad":
        kw["max_square"] = torch.from_numpy(arrays["ms"]).to(dtype)
        inputs.append(kw["max_square"])
    before = [t.clone() for t in inputs]
    out = getattr(tok, fn)(*tensors, **kw)
    out = [out] if isinstance(out, torch.Tensor) else list(out)
    assert all(torch.equal(a, b) for a, b in zip(before, inputs)), \
        "an input was modified"
    assert all(o.dtype == dtype and o.shape == tensors[0].shape
               for o in out)
    return [o.float().numpy() for o in out]


def _jax(rule, arrays, store, compute, monkeypatch, kernel):
    """The JAX update on the inputs rounded to `store`, computed in
    `compute`, the results rounded to `store` and widened to fp32."""
    monkeypatch.setenv("ELASTICDL_TPU_FORCE_INTERPRET", "1" if kernel
                       else "0")
    monkeypatch.setenv("ELASTICDL_TPU_DISABLE_PALLAS", "0" if kernel
                       else "1")
    fn, names, kw = RULES[rule]

    def arr(x):
        return jnp.asarray(jnp.asarray(x, store), compute)

    kw = dict(kw)
    if rule == "amsgrad":
        kw["max_square"] = arr(arrays["ms"])
    out = getattr(jok, fn)(*[arr(arrays[n]) for n in names], **kw)
    out = [out] if not isinstance(out, (tuple, list)) else out
    return [np.asarray(jnp.asarray(o, store), np.float32) for o in out]


def _rel(got, ref):
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


@pytest.mark.parametrize("rule", sorted(RULES))
def test_fp32_matches_jax_kernel_and_jnp_path(rule, monkeypatch):
    for i, shape in enumerate(SHAPES):
        arrays = _inputs(shape, seed=i)
        got = _port(rule, arrays, torch.float32)
        n_out = len(RULES[rule][1]) - 1 + (rule == "amsgrad")
        assert len(got) == n_out
        for kernel, tol in ((True, TOL_KERNEL_FP32), (False, TOL_JNP_FP32)):
            ref = _jax(rule, arrays, jnp.float32, jnp.float32, monkeypatch,
                       kernel)
            for g, r in zip(got, ref):
                assert g.shape == r.shape
                assert _rel(g, r) <= tol, (rule, shape, kernel, _rel(g, r))


@pytest.mark.parametrize("rule", sorted(RULES))
def test_bf16_rounds_once_like_the_fp32_kernel(rule, monkeypatch):
    for i, shape in enumerate(SHAPES):
        arrays = _inputs(shape, seed=10 + i)
        got = _port(rule, arrays, torch.bfloat16)
        for kernel, tol in ((True, TOL_KERNEL_BF16), (False, TOL_JNP_BF16)):
            ref = _jax(rule, arrays, jnp.bfloat16,
                       jnp.float32 if kernel else jnp.bfloat16, monkeypatch,
                       kernel)
            for g, r in zip(got, ref):
                assert _rel(g, r) <= tol, (rule, shape, kernel, _rel(g, r))


def test_jax_kernel_refuses_bf16_parameters(monkeypatch):
    """The reference's own limit (recorded in ROADMAP Queue 3): its
    interpreted kernel stores the fp32 result into a bf16 ref, which
    this jax refuses; the port's kernel and plain version take bf16."""
    monkeypatch.setenv("ELASTICDL_TPU_FORCE_INTERPRET", "1")
    x = jnp.ones((8,), jnp.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        jok.sgd_update(x, x, 0.1)
    out = tok.sgd_update(torch.ones(8, dtype=torch.bfloat16),
                         torch.ones(8, dtype=torch.bfloat16), 0.1)
    assert out.dtype == torch.bfloat16 and float(out[0]) == 0.8984375


def test_plain_version_is_update_math_and_casts_to_the_param_dtype():
    """Slots of another dtype take the parameter's, as the JAX kernels
    cast every array to arrays[0].dtype; the CPU path counts no launch;
    the hyperparameters reach update_math as the kernel takes them."""
    tok.reset_launch_counts()
    rs = np.random.RandomState(3)
    p, m, v, g = (torch.from_numpy(np.asarray(rs.randn(4, 5), np.float32))
                  for _ in range(4))
    v = v.abs()
    alpha = um.adam_alpha(1e-3, 0.9, 0.999, 2)
    got = tok.adam_update(p, m.double(), v, g, step=2, lr=1e-3)
    ref = um.adam_math(p, m, v, g, alpha, 0.9, 0.999, 1e-8)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    plain = tok.dense_update_plain("momentum", [p, m, g], [0.1, 0.9, 1.0])
    ref = um.momentum_math(p, m, g, 0.1, 0.9, True)
    assert all(torch.equal(a, b) for a, b in zip(plain, ref))
    assert set(tok.KERNEL_LAUNCHES.values()) == {0}


def test_bad_inputs_raise():
    p = torch.zeros(3, 4)
    with pytest.raises(ValueError, match="one shape"):
        tok.sgd_update(p, torch.zeros(4, 3), 0.1)
    meta = torch.empty(3, 4, device="meta")
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        tok.sgd_update(p, meta, 0.1)
    # empty tensors update to empty tensors
    e = torch.zeros(0, 3)
    assert tok.sgd_update(e, e, 0.1).shape == (0, 3)
