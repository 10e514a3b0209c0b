"""The optimizer update rules, as functions of tensors: the port's copy
of elasticdl_tpu/ops/update_math.py.

They are the body of the row-update and dense-update kernels' plain
versions (`ops/embedding_ops.py`, `ops/optimizer_kernels.py`);
`csrc/update_rules.cuh` computes the same formulas per element, op by
op. Each maps (param, slots, grad, hyperparameters) to new values;
inputs are tensors of one shape (a whole table, a block of rows or a
dense tensor).
"""

import numpy as np
import torch


def sgd_math(p, g, lr):
    return p - lr * g


def momentum_math(p, v, g, lr, mu, nesterov):
    """optax `trace` then the learning rate: v' = mu v + g, the step is
    v' (or g + mu v' with Nesterov). Returns (p', v')."""
    v_new = mu * v + g
    step = mu * v_new + g if nesterov else v_new
    return p - lr * step, v_new


def adam_math(p, m, v, g, alpha, b1, b2, eps):
    """`alpha` is the bias-corrected step size lr sqrt(1 - b2^t) /
    (1 - b1^t) from `adam_alpha`. Returns (p', m', v')."""
    m_new = b1 * m + (1.0 - b1) * g
    v_new = b2 * v + (1.0 - b2) * g * g
    p_new = p - alpha * m_new / (v_new.sqrt() + eps)
    return p_new, m_new, v_new


def adam_amsgrad_math(p, m, v, ms, g, alpha, b1, b2, eps):
    """Adam whose denominator uses the running maximum `ms` of v.
    Returns (p', m', v', ms')."""
    m_new = b1 * m + (1.0 - b1) * g
    v_new = b2 * v + (1.0 - b2) * g * g
    ms_new = torch.maximum(ms, v_new)
    p_new = p - alpha * m_new / (ms_new.sqrt() + eps)
    return p_new, m_new, v_new, ms_new


def adam_alpha(lr, beta1, beta2, step):
    """Bias-corrected Adam step size for the 1-based update count
    `step`, in float32 as the JAX package computes it; a Python float,
    which the kernel takes by value."""
    f = np.float32
    t = f(step)
    return float(f(lr) * np.sqrt(f(1.0) - f(beta2) ** t)
                 / (f(1.0) - f(beta1) ** t))


def adagrad_math(p, a, g, lr, eps):
    """Returns (p', a') with a' = a + g^2 and eps outside the root."""
    a_new = a + g * g
    p_new = p - lr * g / (a_new.sqrt() + eps)
    return p_new, a_new


def rule_math(rule, state, g, hyper):
    """The update of `rule` (sgd, momentum, adam, adam_amsgrad, adagrad)
    of `state` = [param, *slots] by the gradient `g`, the
    hyperparameters as the kernels take them (sgd: lr; momentum: lr, mu,
    nesterov 0/1; adam, adam_amsgrad: alpha, b1, b2, eps; adagrad: lr,
    eps). Returns [param', *slots']."""
    if rule == "sgd":
        return [sgd_math(state[0], g, hyper[0])]
    if rule == "momentum":
        return list(momentum_math(*state, g, hyper[0], hyper[1],
                                  hyper[2] > 0))
    if rule == "adam":
        return list(adam_math(*state, g, *hyper))
    if rule == "adam_amsgrad":
        return list(adam_amsgrad_math(*state, g, *hyper))
    return list(adagrad_math(*state, g, hyper[0], hyper[1]))
