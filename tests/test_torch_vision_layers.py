"""The port's flax layers for the vision zoo (model_zoo/flax_layers.py:
Conv, BatchNorm, max_pool, Dropout) against flax's, on the CPU.

Inputs and flax-layout weights are drawn by numpy from a seed; every
conv filter is asymmetric (a filter transposed in space would pass any
shape check but not these values). Tolerances:

* Conv: 1e-5 absolute over outputs of order 1 (XLA and PyTorch sum the
  kh * kw * in products in other orders);
* BatchNorm outputs and updated `mean` / `var`: 1e-5 (both use flax's
  E[x^2] - E[x]^2 variance in fp32);
* max_pool: exact (a max picks one input);
* Dropout: the kept share within 4 standard deviations of 1 - rate,
  kept values exactly x / (1 - rate), the same mask for the same
  (seed, step), another for another step.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from elasticdl_tpu_torch.model_zoo.flax_layers import (
    BatchNorm,
    Conv,
    Dropout,
    dropout_generator,
    dropout_rng,
    max_pool,
    model_state_buffers,
)

torch.set_num_threads(2)

TOL = 1e-5


def _nchw(x):
    return torch.as_tensor(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


CONV_CASES = {
    # (in, out, kernel, strides, padding, input hw)
    "same_3x3": (3, 5, (3, 3), (1, 1), "SAME", (9, 8)),
    "valid_3x3": (2, 4, (3, 3), (1, 1), "VALID", (8, 7)),
    "same_stride2_even": (3, 4, (3, 3), (2, 2), "SAME", (8, 8)),
    "same_stride2_odd": (3, 4, (3, 2), (2, 2), "SAME", (7, 9)),
    "same_2x4_one_sided": (2, 3, (2, 4), (1, 1), "SAME", (6, 7)),
    "explicit_7x7_stride2": (3, 4, (7, 7), (2, 2), [(3, 3), (3, 3)],
                             (16, 16)),
    "explicit_asymmetric": (2, 3, (3, 3), (1, 2), [(0, 2), (1, 0)], (6, 9)),
    "1x1_stride2_no_bias": (4, 6, (1, 1), (2, 2), "SAME", (7, 7)),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_matches_flax(case):
    c_in, c_out, kernel, strides, padding, hw = CONV_CASES[case]
    rs = np.random.RandomState(0)
    use_bias = "no_bias" not in case
    flax_conv = fnn.Conv(c_out, kernel, strides=strides, padding=padding,
                         use_bias=use_bias)
    x = rs.randn(2, hw[0], hw[1], c_in).astype(np.float32)
    kernel_w = rs.randn(kernel[0], kernel[1], c_in, c_out).astype(np.float32)
    params = {"kernel": kernel_w}
    if use_bias:
        params["bias"] = rs.randn(c_out).astype(np.float32)
    ref = np.asarray(flax_conv.apply({"params": params}, jnp.asarray(x)))
    conv = Conv(c_in, c_out, kernel, strides=strides, padding=padding,
                use_bias=use_bias, device="cpu")
    with torch.no_grad():
        conv.weight.copy_(torch.as_tensor(kernel_w.transpose(3, 2, 0, 1)))
        if use_bias:
            conv.bias.copy_(torch.as_tensor(params["bias"]))
        got = _nhwc(conv(_nchw(x)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    if kernel[0] == kernel[1] > 1:
        # the filter transposed in space fits every shape and gives
        # another answer
        with torch.no_grad():
            conv.weight.copy_(torch.as_tensor(kernel_w.transpose(3, 2, 1,
                                                                 0)))
            assert np.abs(_nhwc(conv(_nchw(x))) - ref).max() > 1e-2


def test_conv_init_is_lecun_normal_over_the_receptive_field():
    gen = torch.Generator().manual_seed(0)
    conv = Conv(16, 64, (3, 3), device="cpu", generator=gen)
    w = conv.weight.detach().numpy()
    assert w.shape == (64, 16, 3, 3)
    assert not conv.bias.detach().numpy().any()
    fan_in = 3 * 3 * 16
    # a normal cut at 2 std, rescaled to variance 1 / fan_in
    assert abs(w.std() * np.sqrt(fan_in) - 1.0) < 0.05
    assert np.abs(w).max() <= 2 * np.sqrt(1.0 / fan_in) / 0.8796 + 1e-6


@pytest.mark.parametrize("momentum,epsilon", [(0.99, 1e-5), (0.9, 1e-6),
                                              (0.0, 1e-3)])
@pytest.mark.parametrize("ndim", [2, 4])
def test_batch_norm_matches_flax(momentum, epsilon, ndim):
    rs = np.random.RandomState(1)
    shape = (6, 5, 4, 3) if ndim == 4 else (7, 3)
    x = (2.0 + 1.5 * rs.randn(*shape)).astype(np.float32)
    scale = (1.0 + 0.1 * rs.randn(3)).astype(np.float32)
    bias = (0.1 * rs.randn(3)).astype(np.float32)
    mean0 = (0.5 * rs.randn(3)).astype(np.float32)
    var0 = (1.0 + rs.rand(3)).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    bn = fnn.BatchNorm(momentum=momentum, epsilon=epsilon)
    ref_train, mutated = bn.apply(variables, jnp.asarray(x),
                                  use_running_average=False,
                                  mutable=["batch_stats"])
    ref_eval = bn.apply(variables, jnp.asarray(x), use_running_average=True)

    port = BatchNorm(3, momentum=momentum, epsilon=epsilon, device="cpu")
    port.load_state_dict({"scale": torch.as_tensor(scale),
                          "bias": torch.as_tensor(bias),
                          "mean": torch.as_tensor(mean0),
                          "var": torch.as_tensor(var0)})
    assert sorted(dict(port.named_parameters())) == ["bias", "scale"]
    assert sorted(model_state_buffers(port)) == ["mean", "var"]
    xt = _nchw(x) if ndim == 4 else torch.as_tensor(x)
    back = _nhwc if ndim == 4 else (lambda t: t.detach().numpy())
    with torch.no_grad():
        got_eval = back(port(xt, training=False))
        # evaluation reads the running averages and moves nothing
        np.testing.assert_array_equal(port.mean.numpy(), mean0)
        got_train = back(port(xt, training=True))
    np.testing.assert_allclose(got_eval, np.asarray(ref_eval), atol=TOL)
    np.testing.assert_allclose(got_train, np.asarray(ref_train), atol=TOL)
    for leaf in ("mean", "var"):
        np.testing.assert_allclose(
            getattr(port, leaf).numpy(),
            np.asarray(mutated["batch_stats"][leaf]), atol=TOL, rtol=TOL)
    # flax keeps the biased variance (torch's BatchNorm2d the unbiased)
    if momentum == 0.0:
        axes = tuple(i for i in range(x.ndim) if i != x.ndim - 1)
        np.testing.assert_allclose(port.var.numpy(), x.var(axis=axes),
                                   rtol=1e-4)


def test_batch_norm_gradients_match_flax():
    """The batch statistics are part of the training graph, as flax's."""
    rs = np.random.RandomState(2)
    x = rs.randn(4, 3, 3, 2).astype(np.float32)
    scale = (1.0 + 0.1 * rs.randn(2)).astype(np.float32)
    bias = (0.1 * rs.randn(2)).astype(np.float32)
    w = rs.randn(4, 3, 3, 2).astype(np.float32)
    bn = fnn.BatchNorm(momentum=0.9)

    def f(x, scale, bias):
        y, _ = bn.apply({"params": {"scale": scale, "bias": bias},
                         "batch_stats": {"mean": jnp.zeros(2),
                                         "var": jnp.ones(2)}},
                        x, use_running_average=False, mutable=["batch_stats"])
        return jnp.sum(y * w)

    gx, gs, gb = jax.grad(f, argnums=(0, 1, 2))(x, scale, bias)
    port = BatchNorm(2, momentum=0.9, device="cpu")
    with torch.no_grad():
        port.scale.copy_(torch.as_tensor(scale))
        port.bias.copy_(torch.as_tensor(bias))
    xt = _nchw(x).requires_grad_()
    (port(xt, training=True) * _nchw(w)).sum().backward()
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(gx), atol=TOL)
    np.testing.assert_allclose(port.scale.grad.numpy(), np.asarray(gs),
                               atol=1e-4)
    np.testing.assert_allclose(port.bias.grad.numpy(), np.asarray(gb),
                               atol=1e-4)


POOL_CASES = {
    "2x2_stride2": ((2, 2), (2, 2), "VALID", (8, 8)),
    "2x2_stride2_odd": ((2, 2), (2, 2), "VALID", (7, 9)),
    "3x3_stride2_pad1": ((3, 3), (2, 2), [(1, 1), (1, 1)], (16, 15)),
    "3x3_stride1_same": ((3, 3), None, "SAME", (6, 7)),
    "3x3_stride2_asymmetric": ((3, 3), (2, 2), [(0, 2), (2, 0)], (7, 6)),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_max_pool_matches_flax(case):
    window, strides, padding, hw = POOL_CASES[case]
    rs = np.random.RandomState(3)
    # negative inputs: a pad of zeros instead of -inf would show
    x = (rs.randn(2, hw[0], hw[1], 3) - 3.0).astype(np.float32)
    ref = np.asarray(fnn.max_pool(jnp.asarray(x), window, strides=strides,
                                  padding=padding))
    got = _nhwc(max_pool(_nchw(x), window, strides=strides, padding=padding))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_dropout_statistics_and_masks():
    x = torch.ones(64, 8, 16, 16)
    layer = Dropout(0.25)
    # evaluation and rate 0 are the identity, with no generator
    assert layer(x, training=False) is x
    assert Dropout(0.0)(x, training=True) is x
    with pytest.raises(RuntimeError):
        layer(x, training=True)

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.drop = layer

    net = Net()

    def masked(seed, step):
        with dropout_rng(net, dropout_generator(seed, step, "cpu")):
            return layer(x, training=True)

    y = masked(0, 5)
    kept = (y != 0).float().mean().item()
    n = x.numel()
    assert abs(kept - 0.75) < 4 * np.sqrt(0.75 * 0.25 / n)
    assert set(np.unique(y.numpy()).tolist()) == {
        0.0, float(np.float32(1.0) / np.float32(0.75))}
    assert torch.equal(masked(0, 5), y)
    assert not torch.equal(masked(0, 6), y)
    assert not torch.equal(masked(1, 5), y)
    # the context closes: no generator is left behind
    assert layer._generator is None
    with pytest.raises(RuntimeError):
        layer(x, training=True)
    assert not Dropout(1.0)(x, training=True).any()
