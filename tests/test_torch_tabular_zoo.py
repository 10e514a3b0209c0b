"""The port's tabular and CTR zoo (heart, census dnn x 3, census
wide&deep, census_model_sqlflow dnn and wide&deep, dac_ctr wide_deep /
deepfm / dcn / xdeepfm) against the JAX package's, on the CPU.

Records come from the copied generators (each file equal to the JAX
generator's byte for byte). Models are found by the JAX `--model_def`
strings in both zoos. dac_ctr runs at max_hashing_bucket_size=997, as
tests/test_model_zoo.py does. Tolerances:

* dataset_fn features, labels and dtypes: exact (md5 hashes, lookups
  and buckets are ids);
* flax -> port -> flax weights: bit for bit, every flax leaf used once;
* forward with flax-layout weights drawn by numpy: 1e-5; the loss on
  it: 1e-5 relative;
* LocalExecutor steps from one JAX checkpoint: losses rtol 2e-4, atol
  2e-5 (XLA and PyTorch sum in other orders); the evaluation metrics
  1e-6.
"""

import os
import random

import numpy as np
import pytest
import torch

import jax

from elasticdl_tpu.api.local_executor import LocalExecutor as JLocalExecutor
from elasticdl_tpu.checkpoint.saver import CheckpointSaver as JSaver
from elasticdl_tpu.common.model_utils import get_model_spec as jget_spec
from elasticdl_tpu.data import recordio_gen as jrecordio_gen
from elasticdl_tpu.data.dataset import Dataset as JDataset
from elasticdl_tpu.data.record_format import Scanner as JScanner
from elasticdl_tpu_torch.api.local_executor import LocalExecutor
from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.common.model_utils import (
    get_dict_from_params_str,
    get_model_spec,
)
from elasticdl_tpu_torch.convert import (
    flatten_params,
    zoo_flax_param_path,
    zoo_params_from_flax,
    zoo_params_to_flax,
)
from elasticdl_tpu_torch.data import recordio_gen
from elasticdl_tpu_torch.data.dataset import Dataset
from elasticdl_tpu_torch.data.record_format import Scanner

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ZOO = os.path.join(REPO, "model_zoo")
PORT_ZOO = os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo")
TOL = 1e-5
RTOL, ATOL = 2e-4, 2e-5
METRIC_TOL = 1e-6
BATCH = 8
STEPS = 3

GENERATORS = ("gen_census_like", "gen_census_raw", "gen_heart_like",
              "gen_criteo_like")
CTR = "ctr_model='%s'; max_hashing_bucket_size=997"
# name -> (model_def, generator, model_params)
MODELS = {
    "heart": ("heart_functional_api.heart_functional_api.custom_model",
              "gen_heart_like", ""),
    "sqlflow_dnn": ("census_model_sqlflow.dnn.census_dnn.custom_model",
                    "gen_census_raw", ""),
    "sqlflow_wide_deep": ("census_model_sqlflow.wide_and_deep."
                          "census_wide_and_deep.custom_model",
                          "gen_census_raw", ""),
    "census_wide_deep": ("census_wide_deep_model.wide_deep_functional_api."
                         "custom_model", "gen_census_raw", ""),
}
for _variant in ("census_functional_api", "census_sequential",
                 "census_subclass"):
    MODELS["census_dnn_" + _variant] = (
        "census_dnn_model.%s.custom_model" % _variant, "gen_census_raw", "")
for _ctr in ("wide_deep", "deepfm", "dcn", "xdeepfm"):
    MODELS["dac_ctr_" + _ctr] = ("dac_ctr.elasticdl_train.custom_model",
                                 "gen_criteo_like", CTR % _ctr)


def _specs(name):
    model_def = MODELS[name][0]
    return jget_spec(JAX_ZOO, model_def), get_model_spec(PORT_ZOO, model_def)


def _write(name, path, n, seed=0):
    getattr(recordio_gen, MODELS[name][1])(path, num_files=1,
                                           records_per_file=n, seed=seed)
    return path


def _records(path):
    (name,) = os.listdir(path)
    return list(Scanner(os.path.join(path, name)))


def _parsed(spec, dataset_cls, records, mode):
    return list(spec.dataset_fn(dataset_cls.from_list(records), mode, None))


def _stack(items):
    features = {k: np.stack([f[k] for f, _ in items]) for k in items[0][0]}
    return features, np.stack([label for _, label in items])


def _assert_items_equal(got, want):
    assert len(got) == len(want)
    for (gf, gl), (wf, wl) in zip(got, want):
        assert sorted(gf) == sorted(wf)
        for key in wf:
            g, w = np.asarray(gf[key]), np.asarray(wf[key])
            assert g.dtype == w.dtype and g.shape == w.shape, key
            np.testing.assert_array_equal(g, w, err_msg=key)
        assert np.asarray(gl).dtype == np.asarray(wl).dtype
        np.testing.assert_array_equal(gl, wl)


# ---------------------------------------------------------------- data


@pytest.mark.parametrize("gen", GENERATORS)
def test_generators_write_the_jax_records(gen, tmp_path):
    paths = getattr(recordio_gen, gen)(str(tmp_path / "p"), num_files=2,
                                       records_per_file=5, seed=3)
    jpaths = getattr(jrecordio_gen, gen)(str(tmp_path / "j"), num_files=2,
                                         records_per_file=5, seed=3)
    assert [os.path.basename(p) for p in paths] == [
        os.path.basename(p) for p in jpaths]
    for p, j in zip(paths, jpaths):
        with open(p, "rb") as a, open(j, "rb") as b:
            assert a.read() == b.read()
    assert recordio_gen.CENSUS_CATEGORICAL_VOCAB == (
        jrecordio_gen.CENSUS_CATEGORICAL_VOCAB)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_dataset_fn_matches_jax(name, tmp_path):
    jspec, spec = _specs(name)
    params = get_dict_from_params_str(MODELS[name][2])
    jspec.model_fn(**params)  # dac_ctr: sets the hash spaces
    spec.model_fn(device="cpu", **params)
    records = _records(_write(name, str(tmp_path), 24))
    jrecords = list(JScanner(os.path.join(str(tmp_path),
                                          os.listdir(str(tmp_path))[0])))
    assert records == jrecords
    for mode in (Mode.TRAINING, Mode.EVALUATION):
        _assert_items_equal(_parsed(spec, Dataset, records, mode),
                            _parsed(jspec, JDataset, records, mode))
    got = _parsed(spec, Dataset, records, Mode.PREDICTION)
    want = _parsed(jspec, JDataset, records, Mode.PREDICTION)
    _assert_items_equal([(f, 0) for f in got], [(f, 0) for f in want])


# --------------------------------------------------------------- model


def _batch(jspec, name, tmp_path, n=16, seed=1):
    jspec.model_fn(**get_dict_from_params_str(MODELS[name][2]))  # dac_ctr
    records = _records(_write(name, str(tmp_path / "b"), n, seed=seed))
    return _stack(_parsed(jspec, JDataset, records, Mode.EVALUATION))


def numpy_params(jspec, name, features, seed=0):
    """The JAX model's param tree (its names and shapes from init), every
    leaf drawn by numpy: a normal of stddev 1/sqrt(fan in) (the second
    last axis; the last for a vector)."""
    model = jspec.model_fn(**get_dict_from_params_str(MODELS[name][2]))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), features)
    rs = np.random.RandomState(seed)
    flat = {}
    for path, leaf in sorted(jax.tree_util.tree_flatten_with_path(
            shapes["params"])[0], key=lambda kv: jax.tree_util.keystr(kv[0])):
        shape = leaf.shape
        fan_in = shape[-2] if len(shape) > 1 else shape[-1]
        flat["/".join(k.key for k in path)] = (
            rs.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
    return model, flat


def _unflat(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        for part in key.split("/")[:-1]:
            node = node.setdefault(part, {})
        node[key.split("/")[-1]] = v
    return tree


@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_and_weights_match_flax(name, tmp_path):
    jspec, spec = _specs(name)
    features, labels = _batch(jspec, name, tmp_path)
    jmodel, flat = numpy_params(jspec, name, features)
    params = _unflat(flat)
    model = spec.create_model(MODELS[name][2], device="cpu")
    sd = zoo_params_from_flax(params)
    # strict: every flax leaf is a parameter of the port and the other
    # way round
    model.load_state_dict(sd, strict=True)
    assert sorted(sd) == sorted(model.state_dict())
    back = flatten_params(zoo_params_to_flax(model.state_dict()))
    assert sorted(back) == sorted(flat)
    for key, arr in flat.items():
        assert back[key].dtype == arr.dtype
        np.testing.assert_array_equal(back[key], arr)
        assert zoo_flax_param_path(
            [t for t in sd if zoo_flax_param_path(t) == key][0]) == key
    assert flatten_params(zoo_params_to_flax(sd)).keys() == flat.keys()
    ref = jmodel.apply({"params": params}, features)
    out = model({k: torch.as_tensor(v) for k, v in features.items()})
    if isinstance(ref, dict):
        assert sorted(out) == sorted(ref)
        pairs = [(out[k], ref[k]) for k in ref]
    else:
        pairs = [(out, ref)]
    for got, want in pairs:
        assert tuple(got.shape) == np.shape(want)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=TOL, rtol=TOL)
    np.testing.assert_allclose(
        float(spec.loss(torch.as_tensor(labels), out).detach()),
        float(jspec.loss(jax.numpy.asarray(labels), ref)), rtol=TOL)


def test_zoo_param_path_names():
    assert zoo_flax_param_path("inner.DNN_0.Dense_1.weight") == (
        "inner/DNN_0/Dense_1/kernel")
    assert zoo_flax_param_path("thal_embedding.embedding") == (
        "thal_embedding/embedding")
    assert zoo_flax_param_path("inner.CIN_0.cin_w_0") == "inner/CIN_0/cin_w_0"
    with pytest.raises(KeyError):
        zoo_flax_param_path("Dense_0.kernel")
    with pytest.raises(KeyError):
        zoo_params_from_flax({"Dense_0": {"weight": np.zeros((1, 1))}})


# ------------------------------------------------------------ executor


@pytest.mark.parametrize("name", sorted(MODELS))
def test_local_executor_matches_jax(name, tmp_path):
    """STEPS steps of BATCH and one evaluation through both
    LocalExecutors over the same records, from one JAX checkpoint."""
    jspec, spec = _specs(name)
    model_params = MODELS[name][2]
    train = _write(name, str(tmp_path / "train"), STEPS * BATCH)
    val = _write(name, str(tmp_path / "val"), 2 * BATCH + 3, seed=7)
    init = str(tmp_path / "init")
    common = dict(training_data=train, validation_data=val,
                  minibatch_size=BATCH, records_per_task=STEPS * BATCH,
                  model_params=model_params)
    ref = JLocalExecutor(jspec, **common)
    # the JAX executor's own initial state (its one init) is the
    # checkpoint the port's executor starts from
    ref.state = ref.trainer.init_state(_batch(jspec, name, tmp_path,
                                              n=BATCH))
    JSaver(init).save(ref.state, 0)
    random.seed(0)  # the task shuffle
    _jstate, jmetrics = ref.train()
    ours = LocalExecutor(spec, device="cpu", checkpoint_dir_for_init=init,
                         **common)
    random.seed(0)
    state, metrics = ours.train()
    assert state.step == STEPS
    assert len(ours.losses) == len(ref.losses) == STEPS
    assert np.isfinite(ours.losses).all()
    np.testing.assert_allclose(ours.losses, ref.losses, rtol=RTOL,
                               atol=ATOL)
    assert sorted(metrics) == sorted(jmetrics)
    for key, value in jmetrics.items():
        assert 0.0 <= metrics[key] <= 1.0
        np.testing.assert_allclose(metrics[key], value, atol=METRIC_TOL)
