"""The port's vision zoo (mnist_functional_api, mnist_subclass,
cifar10_functional_api, cifar10_subclass, resnet50_subclass,
imagenet_resnet50) against the JAX package's, on the CPU.

Models are found by the JAX `--model_def` strings in both zoos; records
come from the copied generators (each file equal to the JAX generator's
byte for byte). flax-layout weights and running averages are drawn by
numpy over the names and shapes of `jax.eval_shape` and carried into
the port by `convert.zoo_params_from_flax`. Dropout is made the
identity for the training-mode forwards: on the JAX side by
`flax.linen.intercept_methods`, on the port's by setting each Dropout
instance's rate to 0. The two ResNet stacks run one forward each at 32
x 32, batch 2, in evaluation, and in training where they are
well-conditioned (see `test_resnet50_stack_training_forward_matches_flax`);
their blocks are held at narrow filters in both modes. Tolerances:

* eval-mode logits: 2e-5 absolute for the small nets, 1e-4 for the
  ResNet stacks and blocks (53 convs in fp32, summed in other orders);
* training-mode logits and the updated `batch_stats`: the same;
* names: equal to `jax.eval_shape`'s, parameters and batch_stats;
* dataset_fn: exact (decoded floats; the ResNet division by 255 in
  float32 as the JAX module divides).
"""

import contextlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from elasticdl_tpu.common.model_utils import get_model_spec as jget_spec
from elasticdl_tpu.data import recordio_gen as jrecordio_gen
from elasticdl_tpu.data.dataset import Dataset as JDataset
from elasticdl_tpu_torch.api.local_executor import LocalExecutor
from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.common.model_utils import get_model_spec
from elasticdl_tpu_torch.convert import (
    flatten_params,
    zoo_flax_param_path,
    zoo_params_from_flax,
    zoo_params_to_flax,
)
from elasticdl_tpu_torch.data import recordio_gen
from elasticdl_tpu_torch.data.dataset import Dataset
from elasticdl_tpu_torch.data.record_format import Scanner
from elasticdl_tpu_torch.model_zoo.flax_layers import (
    Dropout,
    model_state_buffers,
)
from elasticdl_tpu_torch.model_zoo.resnet50_subclass import (
    resnet50_model as presnet,
)
from model_zoo.resnet50_subclass import resnet50_model as jresnet

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ZOO = os.path.join(REPO, "model_zoo")
PORT_ZOO = os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo")
TOL = 2e-5
RESNET_TOL = 1e-4

# name -> (model_def, generator, image shape of one record, batch)
MODELS = {
    "mnist_functional_api": (
        "mnist_functional_api.mnist_functional_api.custom_model",
        "gen_mnist_like", (28, 28), 4),
    "mnist_subclass": ("mnist_subclass.mnist_subclass.custom_model",
                       "gen_mnist_like", (28, 28), 4),
    "cifar10_functional_api": (
        "cifar10_functional_api.cifar10_functional_api.custom_model",
        "gen_cifar10_like", (32, 32, 3), 4),
    "cifar10_subclass": ("cifar10_subclass.cifar10_subclass.custom_model",
                         "gen_cifar10_like", (32, 32, 3), 4),
    "resnet50_subclass": (
        "resnet50_subclass.resnet50_subclass.custom_model",
        "gen_cifar10_like", (32, 32, 3), 2),
    "imagenet_resnet50": ("imagenet_resnet50.imagenet_resnet50.custom_model",
                          "gen_cifar10_like", (32, 32, 3), 2),
}
GENERATORS = ("gen_mnist_like", "gen_cifar10_like", "gen_imagenet_like")


def specs(name):
    model_def = MODELS[name][0]
    return jget_spec(JAX_ZOO, model_def), get_model_spec(PORT_ZOO, model_def)


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, fnn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


def no_jax_dropout():
    """flax Dropout as the identity, with no edit to the JAX package."""
    return fnn.intercept_methods(_no_dropout)


@contextlib.contextmanager
def no_port_dropout(model):
    """Every Dropout instance of the port model at rate 0."""
    layers = [m for m in model.modules() if isinstance(m, Dropout)]
    rates = [m.rate for m in layers]
    for m in layers:
        m.rate = 0.0
    try:
        yield
    finally:
        for m, rate in zip(layers, rates):
            m.rate = rate


def draw_leaf(path, shape, rs):
    """A numpy draw for a flax leaf by its name: kernels normal over
    sqrt(fan in) (every axis but the last), BatchNorm scales near 1,
    biases and means near 0, variances in [0.5, 1.5)."""
    leaf = path[-1]
    if leaf == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        return (rs.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
    if leaf == "scale":
        return (1.0 + 0.1 * rs.randn(*shape)).astype(np.float32)
    if leaf == "var":
        return (0.5 + rs.rand(*shape)).astype(np.float32)
    return (0.1 * rs.randn(*shape)).astype(np.float32)


def numpy_variables(jmodel, features, seed=0):
    """{"params": ..., "batch_stats": ...} of the JAX model, every leaf
    drawn by numpy over the names and shapes of its init."""
    shapes = jax.eval_shape(
        lambda f: jmodel.init({"params": jax.random.PRNGKey(0),
                               "dropout": jax.random.PRNGKey(0)}, f,
                              training=False), features)
    rs = np.random.RandomState(seed)
    out = {}
    for collection in ("params", "batch_stats"):
        flat = {}
        for path, leaf in sorted(
                jax.tree_util.tree_flatten_with_path(
                    shapes.get(collection, {}))[0],
                key=lambda kv: jax.tree_util.keystr(kv[0])):
            keys = tuple(k.key for k in path)
            flat["/".join(keys)] = draw_leaf(keys, leaf.shape, rs)
        out[collection] = flat
    return out


def unflat(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        for part in key.split("/")[:-1]:
            node = node.setdefault(part, {})
        node[key.split("/")[-1]] = v
    return tree


def image_batch(name, n=None, seed=1):
    shape, batch = MODELS[name][2], MODELS[name][3]
    rs = np.random.RandomState(seed)
    n = n or batch
    return ({"image": rs.rand(n, *shape).astype(np.float32)},
            rs.randint(10, size=n).astype(np.int32))


def port_model(spec, variables):
    model = spec.create_model("", device="cpu")
    sd = zoo_params_from_flax(unflat(variables["params"]),
                              unflat(variables["batch_stats"]))
    model.load_state_dict(sd, strict=True)
    return model


def _tol(name):
    return RESNET_TOL if "resnet" in name else TOL


# ---------------------------------------------------------------- data


@pytest.mark.parametrize("gen", GENERATORS)
def test_generators_write_the_jax_records(gen, tmp_path):
    kwargs = dict(num_files=2, records_per_file=3, seed=3)
    if gen == "gen_imagenet_like":
        kwargs.update(image_size=16, num_classes=7)
    paths = getattr(recordio_gen, gen)(str(tmp_path / "p"), **kwargs)
    jpaths = getattr(jrecordio_gen, gen)(str(tmp_path / "j"), **kwargs)
    assert [os.path.basename(p) for p in paths] == [
        os.path.basename(p) for p in jpaths]
    for p, j in zip(paths, jpaths):
        with open(p, "rb") as a, open(j, "rb") as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_dataset_fn_matches_jax(name, tmp_path):
    jspec, spec = specs(name)
    getattr(recordio_gen, MODELS[name][1])(str(tmp_path), num_files=1,
                                           records_per_file=5, seed=2)
    (fname,) = os.listdir(str(tmp_path))
    records = list(Scanner(os.path.join(str(tmp_path), fname)))
    for mode in (Mode.TRAINING, Mode.EVALUATION, Mode.PREDICTION):
        got = list(spec.dataset_fn(Dataset.from_list(records), mode, None))
        want = list(jspec.dataset_fn(JDataset.from_list(records), mode,
                                     None))
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            if mode != Mode.PREDICTION:
                assert g[1].dtype == w[1].dtype and g[1] == w[1]
                g, w = g[0], w[0]
            assert g["image"].dtype == w["image"].dtype == np.float32
            np.testing.assert_array_equal(g["image"], w["image"])


# --------------------------------------------------------------- models


@pytest.mark.parametrize("name", sorted(MODELS))
def test_names_forwards_and_batch_stats_match_flax(name):
    jspec, spec = specs(name)
    features, _labels = image_batch(name)
    jmodel = jspec.model_fn()
    variables = numpy_variables(jmodel, features)
    model = port_model(spec, variables)
    # names: the flax paths, parameters and running averages
    params = dict(model.named_parameters())
    buffers = model_state_buffers(model)
    assert sorted(zoo_flax_param_path(k) for k in params) == sorted(
        variables["params"])
    assert sorted(zoo_flax_param_path(k) for k in buffers) == sorted(
        variables["batch_stats"])
    assert sorted(model.state_dict()) == sorted(list(params) + list(buffers))
    # flax -> port -> flax is bit for bit, conv kernels included
    sd = model.state_dict()
    for collection in ("params", "batch_stats"):
        back = flatten_params(zoo_params_to_flax(sd, collection))
        assert sorted(back) == sorted(variables[collection])
        for key, arr in variables[collection].items():
            np.testing.assert_array_equal(back[key], arr)
    jvars = {"params": unflat(variables["params"]),
             "batch_stats": unflat(variables["batch_stats"])}
    x = {k: torch.as_tensor(v) for k, v in features.items()}
    tol = _tol(name)
    # the eval-mode forward of every model, the full ResNet stacks too
    ref = jmodel.apply(jvars, features, training=False)
    with torch.no_grad():
        out = model(x, training=False)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=tol,
                               rtol=tol)
    if "resnet" not in name:  # the stacks' training mode: below
        check_training_forward(jmodel, jvars, model, features, tol,
                               variables["batch_stats"])


def check_training_forward(jmodel, jvars, model, features, tol, before,
                           stats_of=None):
    """The training-mode logits (unless `stats_of`) and the updated
    running averages (those `stats_of` keeps, else all) of one forward,
    dropout the identity on both sides."""
    with no_jax_dropout():
        ref, mutated = jmodel.apply(jvars, features, training=True,
                                    mutable=["batch_stats"],
                                    rngs={"dropout": jax.random.PRNGKey(1)})
    with torch.no_grad(), no_port_dropout(model):
        out = model({k: torch.as_tensor(v) for k, v in features.items()},
                    training=True)
    if stats_of is None:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=tol,
                                   rtol=tol)
    new = flatten_params(jax.tree.map(np.asarray,
                                      dict(mutated["batch_stats"])))
    got = flatten_params(zoo_params_to_flax(model.state_dict(),
                                            "batch_stats"))
    assert sorted(got) == sorted(new)
    checked = [k for k in new if stats_of is None or stats_of(k)]
    assert checked
    for key in checked:
        np.testing.assert_allclose(got[key], new[key], atol=tol, rtol=tol)
        # the step moved every running average
        assert not np.array_equal(got[key], before[key])


def test_resnet50_stack_training_forward_matches_flax():
    """The full stack in training mode at 32 x 32, batch 2: the stem's
    and the first stage's running averages (128 or more values a channel
    at 8 x 8 and above) against flax's. The logits are not compared: at
    stage 4 each channel's batch is 2 values at 1 x 1, where BatchNorm's
    output is set by rounding (E[x^2] - E[x]^2 over 2 values), in both
    packages; the blocks hold the training mode at narrow filters."""
    jspec, spec = specs("resnet50_subclass")
    features, _labels = image_batch("resnet50_subclass")
    jmodel = jspec.model_fn()
    variables = numpy_variables(jmodel, features)
    model = port_model(spec, variables)
    jvars = {"params": unflat(variables["params"]),
             "batch_stats": unflat(variables["batch_stats"])}
    first_stage = ("resnet50/BatchNorm_0/", "resnet50/ConvBlock_0/",
                   "resnet50/IdentityBlock_0/", "resnet50/IdentityBlock_1/")
    check_training_forward(
        jmodel, jvars, model, features, RESNET_TOL, variables["batch_stats"],
        stats_of=lambda key: key.startswith(first_stage))


def test_mnist_dropout_is_live_in_training():
    """With the interceptor off, flax's dropout changes the logits; the
    port's too, and the port's masks follow its generator."""
    from elasticdl_tpu_torch.model_zoo.flax_layers import (
        dropout_generator,
        dropout_rng,
    )

    jspec, spec = specs("mnist_functional_api")
    features, _ = image_batch("mnist_functional_api")
    jmodel = jspec.model_fn()
    variables = numpy_variables(jmodel, features)
    jvars = {"params": unflat(variables["params"]),
             "batch_stats": unflat(variables["batch_stats"])}
    outs = [np.asarray(jmodel.apply(
        jvars, features, training=True, mutable=["batch_stats"],
        rngs={"dropout": jax.random.PRNGKey(k)})[0]) for k in (1, 2)]
    assert np.abs(outs[0] - outs[1]).max() > 1e-3
    model = port_model(spec, variables)
    x = {k: torch.as_tensor(v) for k, v in features.items()}

    def run(step):
        with torch.no_grad(), dropout_rng(model,
                                          dropout_generator(0, step, "cpu")):
            return model(x, training=True).numpy()

    with pytest.raises(RuntimeError):
        with torch.no_grad():
            model(x, training=True)
    np.testing.assert_array_equal(run(3), run(3))
    assert np.abs(run(3) - run(4)).max() > 1e-3


BLOCKS = {
    # (JAX block, port block, in channels, filters, strides, hw)
    "identity": (jresnet.IdentityBlock, presnet.IdentityBlock, 8, (4, 4, 8),
                 None, (6, 6)),
    "conv_stride2": (jresnet.ConvBlock, presnet.ConvBlock, 5, (4, 4, 8),
                     (2, 2), (7, 6)),
    "conv_stride1": (jresnet.ConvBlock, presnet.ConvBlock, 5, (3, 4, 6),
                     (1, 1), (5, 5)),
}


@pytest.mark.parametrize("case", sorted(BLOCKS))
def test_resnet_blocks_match_flax(case):
    jcls, pcls, c_in, filters, strides, hw = BLOCKS[case]
    kwargs = {} if strides is None else {"strides": strides}
    jblock = jcls(3, filters, **kwargs)
    rs = np.random.RandomState(4)
    x = rs.randn(3, hw[0], hw[1], c_in).astype(np.float32)
    variables = numpy_variables(jblock, x)
    block = pcls(c_in, 3, filters, device="cpu", **kwargs)
    block.load_state_dict(zoo_params_from_flax(
        unflat(variables["params"]), unflat(variables["batch_stats"])))
    names = [zoo_flax_param_path(k) for k in block.state_dict()]
    assert sorted(names) == sorted(list(variables["params"])
                                   + list(variables["batch_stats"]))
    jvars = {"params": unflat(variables["params"]),
             "batch_stats": unflat(variables["batch_stats"])}
    xt = torch.as_tensor(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    for training in (False, True):
        if training:
            ref, mutated = jblock.apply(jvars, x, training=True,
                                        mutable=["batch_stats"])
        else:
            ref = jblock.apply(jvars, x, training=False)
        with torch.no_grad():
            got = block(xt, training=training).numpy().transpose(0, 2, 3, 1)
        np.testing.assert_allclose(got, np.asarray(ref), atol=RESNET_TOL,
                                   rtol=RESNET_TOL)
    new = flatten_params(jax.tree.map(np.asarray,
                                      dict(mutated["batch_stats"])))
    got = flatten_params(zoo_params_to_flax(block.state_dict(),
                                            "batch_stats"))
    for key, arr in new.items():
        np.testing.assert_allclose(got[key], arr, atol=RESNET_TOL,
                                   rtol=RESNET_TOL)


def test_imagenet_rounds_the_pixels_to_bf16_then_computes_in_fp32():
    """flax's Conv promotes the bf16 image to its fp32 parameters: the
    JAX model's logits equal the fp32 model's on bf16-rounded pixels."""
    jspec, spec = specs("imagenet_resnet50")
    features, _ = image_batch("imagenet_resnet50")
    rounded = {"image": np.array(jnp.asarray(features["image"]).astype(
        jnp.bfloat16).astype(jnp.float32))}
    assert not np.array_equal(rounded["image"], features["image"])
    model = spec.create_model("", device="cpu")
    with torch.no_grad():
        a = model({"image": torch.as_tensor(features["image"])})
        b = model.resnet50(torch.as_tensor(rounded["image"]))
    assert a.dtype == torch.float32
    np.testing.assert_array_equal(a.numpy(), b.numpy())


# ------------------------------------------------------------ executor


def test_local_executor_trains_mnist(tmp_path):
    """The README's model through the port's LocalExecutor on 2 x 32
    records: 4 steps of 16, then an evaluation (as
    tests/test_model_zoo.py runs the JAX zoo)."""
    _jspec, spec = specs("mnist_functional_api")
    train = recordio_gen.gen_mnist_like(str(tmp_path / "train"),
                                        num_files=2, records_per_file=32)
    del train
    valid = str(tmp_path / "valid")
    recordio_gen.gen_mnist_like(valid, num_files=1, records_per_file=20,
                                seed=1)
    executor = LocalExecutor(spec, training_data=str(tmp_path / "train"),
                             validation_data=valid, minibatch_size=16,
                             records_per_task=32, device="cpu")
    state, metrics = executor.train()
    assert state.step == 4 and len(executor.losses) == 4
    assert np.isfinite(executor.losses).all()
    assert sorted(metrics) == ["accuracy"]
    assert 0.0 <= metrics["accuracy"] <= 1.0
    # the running averages moved away from flax's init (0, 1)
    assert float(state.model_state["BatchNorm_0.mean"].abs().sum()) > 0
    assert state.model_state["BatchNorm_0.mean"] is (
        executor.trainer.model.BatchNorm_0.mean)
