"""Model state through the port's Trainer, checkpoints and exports,
against the JAX package's, on the CPU: BatchNorm's running averages
(flax's `batch_stats`), dropout and conv weights of the vision zoo, and
the decayed momentum SGD of the ResNet stacks.

Both Trainers start from the JAX Trainer's own initial state, carried
into the port by `convert.zoo_params_from_flax` (parameters and running
averages in one state_dict); batches are drawn by numpy, the last one
padded (its padded rows enter the batch statistics in both packages,
only the loss is weighted). Dropout is the identity on both sides (a
flax interceptor; the port's rates set to 0), as the two packages' masks
are different bits. Tolerances, fp32 on the CPU (XLA and PyTorch sum the
conv products in other orders):

* losses: 1e-5 relative;
* parameters, running averages and momentum traces after 3 steps: 5e-5
  absolute, 1e-4 relative (at lr 0.1 a step moves a conv bias by up to
  1, its gradient a sum over 2,704 positions; measured up to 3.5e-5);
* eval logits after the steps: 1e-4 of the largest; of a state
  restored in the other package, or an export: 1e-5;
* checkpoint and export leaf names and order: equal.
"""

import contextlib
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import FrozenDict

from elasticdl_tpu.api import exporter as jexporter
from elasticdl_tpu.api.callbacks import (
    LearningRateScheduler as JLearningRateScheduler,
)
from elasticdl_tpu.checkpoint.saver import CheckpointSaver as JSaver
from elasticdl_tpu.checkpoint.saver import flatten_state as jflatten_state
from elasticdl_tpu.checkpoint.saver import (
    restore_state_from_checkpoint as jrestore,
)
from elasticdl_tpu.common.model_utils import get_model_spec as jget_spec
from elasticdl_tpu.parallel import mesh as mesh_lib
from elasticdl_tpu.training.trainer import Trainer as JTrainer
from elasticdl_tpu_torch.api import exporter
from elasticdl_tpu_torch.api.callbacks import LearningRateScheduler
from elasticdl_tpu_torch.checkpoint import (
    CheckpointSaver,
    flatten_state,
    restore_state_from_checkpoint,
)
from elasticdl_tpu_torch.common.model_utils import get_model_spec
from elasticdl_tpu_torch.convert import (
    flatten_params,
    zoo_params_from_flax,
    zoo_params_to_flax,
)
from elasticdl_tpu_torch.training.trainer import Trainer
from test_torch_vision_zoo import (
    JAX_ZOO,
    MODELS,
    PORT_ZOO,
    no_jax_dropout,
    no_port_dropout,
)

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
ATOL, RTOL = 5e-5, 1e-4
LOGIT_TOL = 1e-5
STEPS = 3

# a narrow ConvBlock under the ResNet stacks' optimizer chain, one spec
# file for each package
JAX_BLOCK_SPEC = '''
import jax.numpy as jnp
import optax
from flax import linen as nn

from model_zoo.resnet50_subclass.resnet50_model import (
    L2_WEIGHT_DECAY, ConvBlock)


class Net(nn.Module):
    @nn.compact
    def __call__(self, features, training=False):
        x = ConvBlock(3, (4, 4, 8))(features["image"], training)
        return nn.Dense(10, name="head")(x.mean(axis=(1, 2)))


def custom_model():
    return Net()


def loss(labels, predictions):
    return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
        predictions, labels.reshape(-1)))


def optimizer(lr=0.05):
    return optax.chain(optax.add_decayed_weights(L2_WEIGHT_DECAY),
                       optax.sgd(lr, momentum=0.9))


def eval_metrics_fn():
    return {}
'''
PORT_BLOCK_SPEC = '''
import torch

from elasticdl_tpu_torch.convert import zoo_flax_param_path
from elasticdl_tpu_torch.model_zoo.flax_layers import Dense, flax_generator
from elasticdl_tpu_torch.model_zoo.image_spec import mean_cross_entropy
from elasticdl_tpu_torch.model_zoo.resnet50_subclass.resnet50_model import (
    L2_WEIGHT_DECAY, ConvBlock)
from elasticdl_tpu_torch.training.optimizers import sgd


class Net(torch.nn.Module):
    def __init__(self, device="cuda", seed=0):
        super().__init__()
        gen = flax_generator(device, seed)
        self.ConvBlock_0 = ConvBlock(5, 3, (4, 4, 8), device=device,
                                     generator=gen)
        self.head = Dense(8, 10, device=device, generator=gen)

    def forward(self, features, training=False):
        x = features["image"].permute(0, 3, 1, 2)
        return self.head(self.ConvBlock_0(x, training).mean(dim=(2, 3)))


def custom_model(device="cuda", seed=0):
    return Net(device=device, seed=seed)


loss = mean_cross_entropy


def optimizer(lr=0.05):
    return sgd(lr, momentum=0.9, weight_decay=L2_WEIGHT_DECAY)


flax_param_path = zoo_flax_param_path


def eval_metrics_fn():
    return {}
'''
BLOCK_SHAPE = (7, 6, 5)


def _specs(name, tmp_path):
    if name == "conv_block":
        for fname, src in (("jax_block", JAX_BLOCK_SPEC),
                           ("port_block", PORT_BLOCK_SPEC)):
            with open(os.path.join(str(tmp_path), fname + ".py"), "w") as f:
                f.write(src)
        return (jget_spec(str(tmp_path), "jax_block.custom_model"),
                get_model_spec(str(tmp_path), "port_block.custom_model"))
    model_def = MODELS[name][0]
    return jget_spec(JAX_ZOO, model_def), get_model_spec(PORT_ZOO, model_def)


def _batch(name, seed, n=4):
    shape = BLOCK_SHAPE if name == "conv_block" else MODELS[name][2]
    rs = np.random.RandomState(seed)
    return ({"image": rs.rand(n, *shape).astype(np.float32)},
            rs.randint(10, size=n).astype(np.int32))


def _batch_stats(jstate):
    return jax.tree.map(np.asarray,
                        dict(jstate.model_state).get("batch_stats", {}))


def trainers(name, tmp_path, lr=None, **kwargs):
    """The JAX Trainer and the port's from the JAX Trainer's own
    initial state; `lr` replaces the spec's learning rate in both."""
    jspec, spec = _specs(name, tmp_path)
    if lr is not None:
        jspec.optimizer = functools.partial(jspec.optimizer, lr=lr)
        spec.optimizer = functools.partial(spec.optimizer, lr=lr)
    mesh = mesh_lib.build_mesh({"dp": 1}, devices=jax.devices()[:1])
    jtrainer = JTrainer(jspec, mesh=mesh, **kwargs)
    with no_jax_dropout():
        jstate = jtrainer.init_state(_batch(name, 0))
    trainer = Trainer(spec, device="cpu", **kwargs)
    state = trainer.init_state(None, params=zoo_params_from_flax(
        jax.tree.map(np.asarray, jstate.params), _batch_stats(jstate)))
    return jtrainer, jstate, trainer, state


def _flat_port(trainer, state):
    sd = trainer.model.state_dict()
    return (flatten_params(zoo_params_to_flax(sd)),
            flatten_params(zoo_params_to_flax(sd, "batch_stats")))


def _flat_jax(jstate):
    return (flatten_params(jax.tree.map(np.asarray, jstate.params)),
            flatten_params(_batch_stats(jstate)))


def _assert_states_close(trainer, state, jstate):
    for got, want in zip(_flat_port(trainer, state), _flat_jax(jstate)):
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], atol=ATOL,
                                       rtol=RTOL, err_msg=key)


def _eval_logits(trainer, state, jtrainer, jstate, name):
    features, _ = _batch(name, 9)
    got = trainer.forward(state, features).numpy()
    want = np.asarray(jtrainer._build_eval_step()(jstate, features))
    return got, want


# cifar10 at its own lr 0.1 diverges on random images in the second
# step (loss 2.7 -> 46.5 in both packages), where fp32 rounding
# differences grow by orders of magnitude: it runs at lr 0.01 in both
TRAINER_CASES = {
    "mnist_functional_api": ("mnist_functional_api", {}),
    "mnist_subclass": ("mnist_subclass", {}),
    "cifar10_functional_api_schedule": ("cifar10_functional_api",
                                        {"lr": 0.01}),
    "mnist_functional_api_accum2": ("mnist_functional_api",
                                    {"grad_accum_steps": 2}),
    "conv_block_decayed_momentum": ("conv_block", {}),
}


@pytest.mark.parametrize("case", sorted(TRAINER_CASES))
def test_trainer_steps_match_jax(case, tmp_path):
    name, kwargs = TRAINER_CASES[case]
    jtrainer, jstate, trainer, state = trainers(name, tmp_path, **kwargs)
    _assert_states_close(trainer, state, jstate)
    before = dict(_flat_jax(jstate)[1])
    steps = STEPS + (1 if kwargs.get("grad_accum_steps") else 0)
    with no_port_dropout(trainer.model):
        for step in range(steps):
            batch = _batch(name, 10 + step)
            true_count = 3 if step == steps - 1 else None
            with no_jax_dropout():
                jstate, jloss = jtrainer.train_step(jstate, batch,
                                                    true_count)
            state, loss = trainer.train_step(state, batch, true_count)
            np.testing.assert_allclose(loss, float(jloss), rtol=LOSS_RTOL)
    assert state.step == int(jstate.step) == steps
    _assert_states_close(trainer, state, jstate)
    # every running average moved, in both packages
    for key, arr in _flat_port(trainer, state)[1].items():
        assert not np.array_equal(arr, before[key]), key
    # the live state's model_state is the model's buffers
    assert {id(b) for b in state.model_state.values()} == {
        id(b) for _k, b in trainer.model.named_buffers()}
    # the optimizer state: names, order and values through a checkpoint
    flat = flatten_state(trainer, state)
    jflat = jflatten_state(jstate)
    assert list(flat) == list(jflat)
    for key, want in jflat.items():
        got = np.asarray(flat[key])
        assert got.dtype == want.dtype and got.shape == want.shape, key
        if key.startswith((".opt_state", ".model_state")):
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL,
                                       err_msg=key)
    if name == "conv_block":
        traces = [k for k in flat if k.startswith(".opt_state[1][0].trace")]
        assert len(traces) == len(jflat) - 2 - len(
            [k for k in jflat if k.startswith((".params", ".model_state"))])
        assert ".opt_state[1][0].trace['ConvBlock_0']['Conv_3']['kernel']" in (
            flat)
    # the eval logits read running averages that lag the trained
    # activations (momentum 0.99): up to ~4e3 after 3 steps, so held to
    # RTOL of their largest
    got, want = _eval_logits(trainer, state, jtrainer, jstate, name)
    np.testing.assert_allclose(got, want, atol=RTOL * np.abs(want).max(),
                               rtol=0)


# the decayed chain under each wrapper the JAX Trainer composes: the
# schedule (chain(tx, scale_by_schedule)), the freeze and MultiSteps
# (the split needs tapped tables, which have no decayed row rule)
WRAPPERS = {
    "schedule": {"schedule": True},
    "freeze": {"trainable_pattern": "Conv_[02]|head"},
    "accum2": {"grad_accum_steps": 2},
    "all": {"schedule": True, "trainable_pattern": "Conv_[13]|BatchNorm",
            "grad_accum_steps": 2},
}


@pytest.mark.parametrize("case", sorted(WRAPPERS))
def test_decayed_momentum_leaf_names_under_every_wrapper(case, tmp_path):
    kwargs = dict(WRAPPERS[case])
    port_kwargs = dict(kwargs)
    if kwargs.pop("schedule", False):
        port_kwargs.pop("schedule")
        kwargs["callbacks"] = [JLearningRateScheduler(
            lambda count: jnp.where(count < 1, 1.0, 0.5))]
        port_kwargs["callbacks"] = [LearningRateScheduler(
            lambda count: 1.0 if count < 1 else 0.5)]
    jtrainer, jstate, trainer, state = trainers("conv_block", tmp_path,
                                                **kwargs)
    if port_kwargs != kwargs:
        trainer = Trainer(trainer.spec, device="cpu", **port_kwargs)
        state = trainer.init_state(None, params=zoo_params_from_flax(
            jax.tree.map(np.asarray, jstate.params), _batch_stats(jstate)))
    for step in range(2 * jtrainer.grad_accum_steps):
        batch = _batch("conv_block", 70 + step)
        jstate, jloss = jtrainer.train_step(jstate, batch)
        state, loss = trainer.train_step(state, batch)
        np.testing.assert_allclose(loss, float(jloss), rtol=LOSS_RTOL)
    flat, jflat = flatten_state(trainer, state), jflatten_state(jstate)
    assert list(flat) == list(jflat)
    assert any("[1][0].trace['ConvBlock_0']" in k for k in flat)
    for key, want in jflat.items():
        np.testing.assert_allclose(np.asarray(flat[key]), want, atol=ATOL,
                                   rtol=RTOL, err_msg=key)


def test_a_frozen_model_keeps_updating_its_running_averages(tmp_path):
    """trainable_pattern freezes parameters, not the model state, as in
    the JAX Trainer."""
    kwargs = {"trainable_pattern": "Dense_0"}
    jtrainer, jstate, trainer, state = trainers("mnist_functional_api",
                                                tmp_path, **kwargs)
    conv = trainer.model.Conv_0.weight.detach().clone()
    with no_port_dropout(trainer.model):
        for step in range(2):
            batch = _batch("mnist_functional_api", 20 + step)
            with no_jax_dropout():
                jstate, jloss = jtrainer.train_step(jstate, batch)
            state, loss = trainer.train_step(state, batch)
            np.testing.assert_allclose(loss, float(jloss), rtol=LOSS_RTOL)
    assert torch.equal(trainer.model.Conv_0.weight, conv)
    assert float(trainer.model.BatchNorm_0.mean.abs().sum()) > 0
    _assert_states_close(trainer, state, jstate)
    assert list(flatten_state(trainer, state)) == list(
        jflatten_state(jstate))


def _port_only(name, tmp_path, seed=0):
    """A port Trainer and its own fresh state (no JAX)."""
    trainer = Trainer(_specs(name, tmp_path)[1], device="cpu", seed=seed)
    return trainer, trainer.init_state(None)


def test_dropout_generator_is_per_step_and_reproducible(tmp_path):
    """With dropout on, the port's step draws its masks from (seed,
    step): two Trainers of one seed give the same losses, and the masks
    differ from the rate-0 run's."""
    def run(seed, rate_zero=False):
        trainer, state = _port_only("mnist_functional_api", tmp_path)
        trainer.seed = seed  # the init stays seed 0's
        losses = []
        scope = (no_port_dropout(trainer.model) if rate_zero
                 else contextlib.nullcontext())
        with scope:
            for step in range(2):
                state, loss = trainer.train_step(
                    state, _batch("mnist_functional_api", 30 + step))
                losses.append(loss)
        return losses

    assert run(0) == run(0)
    assert run(0) != run(1)
    assert run(0) != run(0, rate_zero=True)


CKPT_CASES = ("mnist_functional_api", "conv_block")


@pytest.mark.parametrize("name", CKPT_CASES)
def test_checkpoints_restore_across_packages(name, tmp_path):
    """Each package trains 2 steps on batches of its own, so the states
    differ; each checkpoint then restores into the other package's
    trained state (strict) and takes its values bit for bit."""
    jtrainer, jstate, trainer, state = trainers(name, tmp_path)
    with no_port_dropout(trainer.model):
        for step in range(2):
            with no_jax_dropout():
                jstate, _ = jtrainer.train_step(jstate, _batch(name,
                                                               40 + step))
            state, _ = trainer.train_step(state, _batch(name, 60 + step))
    CheckpointSaver(trainer, str(tmp_path / "port")).save(state, 2)
    JSaver(str(tmp_path / "jax")).save(jstate, 2)
    port_flat, jax_flat = flatten_state(trainer, state), jflatten_state(
        jstate)
    assert list(port_flat) == list(jax_flat)
    assert not np.array_equal(np.asarray(port_flat[".params['%s']['kernel']"
                                                   % _first_conv(name)]),
                              jax_flat[".params['%s']['kernel']"
                                       % _first_conv(name)])
    # the port's checkpoint into the JAX state
    jrestored, version = jrestore(jstate, str(tmp_path / "port"))
    assert version == 2 and int(jrestored.step) == 2
    for key, want in jflatten_state(jrestored).items():
        np.testing.assert_array_equal(want, np.asarray(port_flat[key]))
    got, want = _eval_logits(trainer, state, jtrainer, jrestored, name)
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    # the JAX checkpoint into the port's state
    state, version = restore_state_from_checkpoint(trainer, state,
                                                   str(tmp_path / "jax"))
    assert version == 2 and state.step == 2
    for key, want in flatten_state(trainer, state).items():
        np.testing.assert_array_equal(np.asarray(want), jax_flat[key])
    got, want = _eval_logits(trainer, state, jtrainer, jstate, name)
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    # and the port's checkpoint into a fresh port state
    fresh, fresh_state = _port_only(name, tmp_path, seed=1)
    restore_state_from_checkpoint(fresh, fresh_state, str(tmp_path / "port"))
    for key, value in flatten_state(fresh, fresh_state).items():
        np.testing.assert_array_equal(np.asarray(value),
                                      np.asarray(port_flat[key]))


def _first_conv(name):
    return "ConvBlock_0']['Conv_0" if name == "conv_block" else "Conv_0"


def test_conv_kernel_round_trips_in_flax_layout(tmp_path):
    """An asymmetric conv kernel through convert, a checkpoint and an
    export, held in flax's [kh, kw, in, out] layout at every stop."""
    _jt, jstate, trainer, state = trainers("mnist_functional_api", tmp_path)
    kernel = np.asarray(jstate.params["Conv_1"]["kernel"])
    assert kernel.shape == (3, 3, 32, 64)
    assert not np.array_equal(kernel, kernel.transpose(1, 0, 2, 3))
    torch_w = trainer.model.Conv_1.weight.detach().numpy()
    np.testing.assert_array_equal(torch_w, kernel.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        zoo_params_to_flax(trainer.model.state_dict())["Conv_1"]["kernel"],
        kernel)
    flat = flatten_state(trainer, state)
    np.testing.assert_array_equal(flat[".params['Conv_1']['kernel']"],
                                  kernel)
    CheckpointSaver(trainer, str(tmp_path / "ck")).save(state, 0)
    with torch.no_grad():
        trainer.model.Conv_1.weight.zero_()
    restore_state_from_checkpoint(trainer, state, str(tmp_path / "ck"))
    np.testing.assert_array_equal(
        trainer.model.Conv_1.weight.detach().numpy(), torch_w)
    exporter.export_model(trainer.model, state, str(tmp_path / "ex"))
    payload, _meta = exporter.load_exported(str(tmp_path / "ex"))
    np.testing.assert_array_equal(payload["params"]["Conv_1"]["kernel"],
                                  kernel)


def test_exports_carry_model_state_both_ways(tmp_path):
    jtrainer, jstate, trainer, state = trainers("mnist_functional_api",
                                                tmp_path)
    with no_port_dropout(trainer.model):
        for step in range(2):
            batch = _batch("mnist_functional_api", 50 + step)
            with no_jax_dropout():
                jstate, _ = jtrainer.train_step(jstate, batch)
            state, _ = trainer.train_step(state, batch)
    features, _ = _batch("mnist_functional_api", 9)
    # the port's export through the JAX loader and serving function
    exporter.export_model(trainer.model, state, str(tmp_path / "port"))
    payload, meta = jexporter.load_exported(str(tmp_path / "port"))
    assert meta["version"] == 2 and meta["num_params"] == 111114
    assert sorted(payload["model_state"]) == ["batch_stats"]
    np.testing.assert_array_equal(
        payload["model_state"]["batch_stats"]["BatchNorm_0"]["var"],
        trainer.model.BatchNorm_0.var.numpy())
    want = trainer.forward(state, features).numpy()
    got = np.asarray(jexporter.make_serving_fn(jtrainer.model, payload)(
        jax.tree.map(jnp.asarray, features)))
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    # the JAX export through the port's loader and serving function
    jexporter.export_model(jtrainer.model, jstate, str(tmp_path / "jax"))
    payload, _meta = exporter.load_exported(str(tmp_path / "jax"))
    serve = exporter.make_serving_fn(trainer.model, payload)
    got = serve({k: torch.as_tensor(v) for k, v in features.items()})
    want = np.asarray(jtrainer._build_eval_step()(jstate, features))
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    # the caller's model keeps its own running averages
    assert not torch.equal(
        trainer.model.BatchNorm_0.mean,
        torch.as_tensor(np.asarray(
            jstate.model_state["batch_stats"]["BatchNorm_0"]["mean"])))
    # an export of a checkpoint carries the same model state
    CheckpointSaver(trainer, str(tmp_path / "ck")).save(state, 2)
    exporter.export_from_checkpoint(trainer.model, state,
                                    str(tmp_path / "ck"),
                                    str(tmp_path / "from_ck"))
    a, _ = exporter.load_exported(str(tmp_path / "port"))
    b, _ = exporter.load_exported(str(tmp_path / "from_ck"))
    for x, y in zip(flatten_params(a), flatten_params(b)):
        assert x == y
    with open(str(tmp_path / "port" / "params.msgpack"), "rb") as f1, open(
            str(tmp_path / "from_ck" / "params.msgpack"), "rb") as f2:
        assert f1.read() == f2.read()


def test_model_state_frozen_dict_is_what_jax_exports(tmp_path):
    """A model without BatchNorm exports `model_state` {} in both
    packages (the tabular zoo's heart)."""
    spec = get_model_spec(PORT_ZOO,
                          "heart_functional_api.heart_functional_api."
                          "custom_model")
    trainer = Trainer(spec, device="cpu")
    state = trainer.init_state(None)
    assert state.model_state == {}
    exporter.export_model(trainer.model, state, str(tmp_path / "ex"))
    payload, _ = exporter.load_exported(str(tmp_path / "ex"))
    assert payload["model_state"] == {}
    assert FrozenDict({}) == {}
