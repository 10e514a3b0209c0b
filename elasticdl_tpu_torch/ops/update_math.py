"""The optimizer update rules, as functions of tensors: the port's copy
of elasticdl_tpu/ops/update_math.py.

They are the body of the row-update kernel's plain version
(`ops/embedding_ops.py`); `csrc/row_update.cu` computes the same
formulas per element. Each maps (param, slots, grad, hyperparameters)
to new values; inputs are tensors of one shape (a whole table or a
block of rows).
"""

import numpy as np


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
