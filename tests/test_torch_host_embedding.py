"""The port's host-DRAM embedding tier against the JAX package's, on the
CPU: the native row store (csrc/host_embedding.cc, built here with the
host C++ compiler), the host-spill engine and the manager's pull.

The JAX stores are the numpy `_PythonStore` (force_python=True), which
every checkout has. Tolerances:

* lazy-init rows: bit for bit (both stores run splitmix64 over (seed,
  id) and round to float32 alike); the port's own numpy store too;
* the four row rules after 3 updates with repeated ids: rtol 1e-5,
  atol 1e-7 against the JAX numpy store, which rounds some of its
  hyperparameters from float64 where the C++ store computes in float32
  (1 - b1, 1 - b2 and Adam's alpha), so the last bits differ; bit for
  bit against the port's numpy store, whose arithmetic is the C++
  store's;
* `prepare`'s rows and idx, engine state and checkpoint leaves: bit for
  bit.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from elasticdl_tpu.embedding.host_spill import (
    HostSpillEmbeddingEngine as JEngine,
)
from elasticdl_tpu.native import host_embedding as jstore
from elasticdl_tpu_torch.common.model_utils import (
    load_model_spec_from_module,
)
from elasticdl_tpu_torch.embedding import host_bridge
from elasticdl_tpu_torch.embedding.host_spill import HostSpillEmbeddingEngine
from elasticdl_tpu_torch.model_zoo import deepfm_host_embedding as hzoo
from elasticdl_tpu_torch.native import host_embedding as store
from elasticdl_tpu_torch.ops import _build
from elasticdl_tpu_torch.training.trainer import Trainer
from tests.test_torch_deepfm import (
    DIM,
    FC,
    LENGTH,
    _batches,
    _jax_manager,
    _port_manager,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RULE_RTOL, RULE_ATOL = 1e-5, 1e-7
RULES = {
    "sgd": dict(lr=0.1),
    "momentum": dict(lr=0.05, momentum=0.9, nesterov=True),
    "adam": dict(lr=0.01, beta1=0.9, beta2=0.999, eps=1e-8),
    "adagrad": dict(lr=0.2, eps=1e-10),
}


def test_native_store_builds_and_is_the_default():
    s = store.HostEmbeddingStore(4, seed=1)
    assert isinstance(s, store._NativeStore)
    assert isinstance(store.HostEmbeddingStore(4, force_python=True),
                      store._PythonStore)
    assert os.path.exists(_build.library_path("host_embedding"))
    assert _build.library_path("host_embedding").startswith(
        _build.BUILD_DIR)


@pytest.mark.parametrize("seed,dim,low,high", [
    (0, 8, -0.05, 0.05), (7, 13, -0.05, 0.05), (2**63 + 5, 1, -1.0, 3.0),
    (3, 64, 0.0, 0.0)])
def test_lazy_rows_bit_for_bit(seed, dim, low, high):
    ids = np.array([0, 1, 5, -1, 10**7 + 3, 2**40, 5, -(2**35)], np.int64)
    ref = jstore._PythonStore(dim, seed, low, high).lookup(ids)
    native = store.HostEmbeddingStore(dim, seed, low, high)
    got = native.lookup(ids)
    assert got.dtype == np.float32 and got.shape == (len(ids), dim)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        store.HostEmbeddingStore(dim, seed, low, high,
                                 force_python=True).lookup(ids), ref)
    assert len(native) == len(set(ids.tolist()))


def _rule_call(s, slots, rule, ids, grads, step):
    hp = RULES[rule]
    if rule == "sgd":
        s.sgd(ids, grads, hp["lr"])
    elif rule == "momentum":
        s.momentum(slots[0], ids, grads, hp["lr"], hp["momentum"],
                   hp["nesterov"])
    elif rule == "adam":
        s.adam(slots[0], slots[1], ids, grads, hp["lr"], hp["beta1"],
               hp["beta2"], hp["eps"], step=step)
    else:
        s.adagrad(slots[0], ids, grads, hp["lr"], hp["eps"])


@pytest.mark.parametrize("rule", sorted(RULES))
def test_row_rules_match_jax_store(rule):
    """3 updates, each with a repeated id (applied twice in one call, as
    both stores do) and ids never looked up before (lazily made)."""
    dim, rs = 6, np.random.RandomState(4)
    n_slots = {"sgd": 0, "momentum": 1, "adam": 2, "adagrad": 1}[rule]
    stores = {}
    for name, make in (("jax", jstore._PythonStore),
                       ("native", lambda *a: store.HostEmbeddingStore(*a)),
                       ("numpy", store._PythonStore)):
        stores[name] = (make(dim, 3, -0.05, 0.05),
                        [make(dim, 3, 0.0, 0.0) for _ in range(n_slots)])
    for step in range(1, 4):
        ids = np.array([1, 7, 1, 40 + step, 9], np.int64)
        grads = rs.randn(len(ids), dim).astype(np.float32)
        for s, slots in stores.values():
            _rule_call(s, slots, rule, ids, grads, step)
    every = np.array([1, 7, 9, 41, 42, 43, 500], np.int64)
    want = stores["jax"][0].lookup(every)
    got = stores["native"][0].lookup(every)
    np.testing.assert_allclose(got, want, rtol=RULE_RTOL, atol=RULE_ATOL)
    np.testing.assert_array_equal(got, stores["numpy"][0].lookup(every))
    for i in range(n_slots):
        np.testing.assert_allclose(
            stores["native"][1][i].lookup(every),
            stores["jax"][1][i].lookup(every), rtol=RULE_RTOL,
            atol=RULE_ATOL)
    # untouched row 500 is its lazy initial value
    np.testing.assert_array_equal(
        got[-1], jstore._PythonStore(dim, 3, -0.05, 0.05).lookup([500])[0])


def test_store_set_export_clear_and_size_checks():
    s = store.HostEmbeddingStore(3, seed=0)
    s.set_rows([4, 2], np.arange(6, dtype=np.float32).reshape(2, 3))
    ids, values = s.export_rows()
    order = np.argsort(ids)
    np.testing.assert_array_equal(ids[order], [2, 4])
    np.testing.assert_array_equal(values[order], [[3, 4, 5], [0, 1, 2]])
    with pytest.raises(ValueError, match="rows of dim"):
        s.sgd([1, 2], np.zeros((2, 2), np.float32), 0.1)
    s.clear()
    assert len(s) == 0 and s.export_rows()[0].size == 0


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_engine_state_round_trips_across_packages(optimizer):
    rs = np.random.RandomState(1)
    ours = HostSpillEmbeddingEngine(5, optimizer=optimizer, seed=2, lr=0.05)
    ref = JEngine(5, optimizer=optimizer, seed=2, lr=0.05,
                  force_python=True)
    for _ in range(2):
        uniq, rows, inverse = ours.pull(rs.randint(0, 30, (4, 3)))
        juniq, jrows, jinverse = ref.pull(np.asarray(uniq)[inverse])
        np.testing.assert_array_equal(uniq, juniq)
        np.testing.assert_allclose(rows, jrows, rtol=RULE_RTOL,
                                   atol=RULE_ATOL)
        grads = rs.randn(len(uniq), 5).astype(np.float32)
        ours.apply_gradients(uniq, grads, lr_scale=0.5)
        ref.apply_gradients(juniq, grads, lr_scale=0.5)
    sd = ours.state_dict()
    assert sd["step"] == 2 and sorted(sd) == sorted(ref.state_dict())
    # a fresh clone is empty; the state loads into it and into the JAX
    # engine, and the JAX engine's into ours, all to the same rows
    clone = ours.fresh_clone()
    assert len(clone.param) == 0 and clone.optimizer == optimizer
    clone.load_state_dict(sd)
    back = JEngine(5, optimizer=optimizer, seed=2, lr=0.05,
                   force_python=True)
    back.load_state_dict(sd)
    used = HostSpillEmbeddingEngine(5, optimizer=optimizer, seed=2, lr=0.05)
    used.pull(np.arange(100))  # rows made since the checkpoint go back
    used.load_state_dict(ref.state_dict())
    for name in ["param"] + list(ours.slots):
        want_ids, want = sd[name]
        order = np.argsort(want_ids)
        for other in (clone.state_dict(), back.state_dict(),
                      used.state_dict()):
            got_ids, got = other[name]
            o = np.argsort(got_ids)
            np.testing.assert_array_equal(got_ids[o], want_ids[order])
            np.testing.assert_allclose(got[o], want[order], rtol=RULE_RTOL,
                                       atol=RULE_ATOL)
    assert used.state_dict()["step"] == 2
    np.testing.assert_array_equal(
        used.param.lookup([99]),
        JEngine(5, seed=2, force_python=True).param.lookup([99]))


def _managers(pad=8):
    return _port_manager(pad=pad), _jax_manager(pad=pad)


@pytest.mark.parametrize("shape,pad", [((4, 5), 8), ((3, 7), 8), ((1, 1), 4)])
def test_prepare_matches_jax(shape, pad):
    ids = np.random.RandomState(sum(shape)).randint(0, 12, shape)
    ids[0, 0] = host_bridge.PADDING_ID  # maps to row 0
    ours, ref = _managers(pad)
    got = ours.prepare({"feature": ids.astype(np.int32)})
    want = ref.prepare({"feature": ids.astype(np.int32)})
    assert sorted(got) == sorted(want)
    cap = -(-ids.size // pad) * pad
    for key in ("edl_embedding.rows", "edl_id_bias.rows"):
        assert got[key].shape[0] == cap and got[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(got["edl_embedding.idx"],
                                  want["edl_embedding.idx"])
    assert got["edl_embedding.idx"].dtype == np.int32
    assert ours.pending_row_count() == ref.pending_row_count()
    assert ours.rows_keys() == ref.rows_keys()
    # flat_state keys are the JAX manager's, the values equal
    ours_flat, ref_flat = ours.flat_state(), ref.flat_state()
    assert sorted(ours_flat) == sorted(ref_flat)
    for key, val in ref_flat.items():
        if key.endswith(".ids"):
            np.testing.assert_array_equal(np.sort(ours_flat[key]),
                                          np.sort(val))
        else:
            assert ours_flat[key].dtype == np.asarray(val).dtype


def _trainer(accum=1):
    spec = load_model_spec_from_module(hzoo)
    trainer = Trainer(spec, model_params="input_length=%d; fc_unit=%d; "
                      "embedding_dim=%d" % (LENGTH, FC, DIM),
                      grad_accum_steps=accum, device="cpu")
    manager, _ref = _managers()
    trainer.attach_host_embeddings(manager)
    return trainer, manager


def test_engine_failure_counts_dropped_rows():
    """A failed apply is contained (the step completes, no retry) and
    counted: one failed cycle, the pulled rows dropped; a healed engine
    stops the counters."""
    trainer, manager = _trainer()
    batches = _batches(3)
    state = trainer.init_state(None)
    state, _ = trainer.train_step(state, batches[0])
    assert trainer.tier_health == {"host_failed_cycles": 0,
                                   "host_dropped_row_updates": 0}
    engine = manager.tables()["edl_embedding"].engine
    real = engine.apply_gradients

    def broken(*a, **kw):
        raise RuntimeError("injected engine failure")

    engine.apply_gradients = broken
    state, loss = trainer.train_step(state, batches[1])
    assert np.isfinite(loss) and state.step == 2
    assert trainer.tier_health["host_failed_cycles"] == 1
    assert trainer.tier_health["host_dropped_row_updates"] == (
        manager.pending_row_count()) > 0
    engine.apply_gradients = real
    trainer.train_step(state, batches[2])
    assert trainer.tier_health["host_failed_cycles"] == 1


def test_engine_failure_in_accum_cycle_counts_all_staged_rows():
    trainer, manager = _trainer(accum=2)
    batches = _batches(2)
    state = trainer.init_state(None)
    for t in manager.tables().values():
        t.engine.apply_gradients = lambda *a, **kw: (_ for _ in ()).throw(
            RuntimeError("injected"))
    state, _ = trainer.train_step(state, batches[0])  # stages
    staged = manager.staged_row_count()
    assert staged > 0 and trainer.tier_health["host_failed_cycles"] == 0
    state, _ = trainer.train_step(state, batches[1])  # boundary fails
    assert trainer.tier_health["host_failed_cycles"] == 1
    assert trainer.tier_health["host_dropped_row_updates"] >= (
        staged + manager.pending_row_count())


def test_apply_before_prepare_raises_and_refusals():
    ours, _ref = _managers()
    with pytest.raises(RuntimeError, match="before prepare"):
        ours.apply({"edl_embedding.rows": np.zeros((8, DIM), np.float32),
                    "edl_id_bias.rows": np.zeros((8, 1), np.float32)})
    with pytest.raises(RuntimeError, match="before prepare"):
        ours.stage({})
    with pytest.raises(NotImplementedError, match="parallel"):
        ours.enable_spmd(object())
    with pytest.raises(ValueError, match="already registered"):
        ours.register("edl_embedding", "feature", None)
    trainer, _manager = _trainer()
    state = trainer.init_state(None)
    trainer.train_step(state, _batches(1)[0])
    with pytest.raises(RuntimeError, match="precede"):
        trainer.attach_host_embeddings(_managers()[0])
    with pytest.raises(TypeError, match="HostEmbeddingManager"):
        Trainer(load_model_spec_from_module(hzoo), device="cpu"
                ).attach_host_embeddings(_ref)
    frozen = Trainer(load_model_spec_from_module(hzoo), device="cpu",
                     trainable_pattern="Dense_1")
    frozen.attach_host_embeddings(_managers()[0])
    with pytest.raises(NotImplementedError, match="host-spill"):
        frozen.init_state(None)


_RACE = """
import sys
from elasticdl_tpu_torch.ops import _build
_build.BUILD_DIR = sys.argv[1]
from elasticdl_tpu_torch.native import host_embedding as store
print(store.HostEmbeddingStore(4, seed=9).lookup([3]).sum())
"""


def test_concurrent_builds_and_a_failed_build(tmp_path, monkeypatch):
    """Two processes that build the library into one empty directory at
    once both load it (each writes its own file and renames it into
    place); a compiler that fails raises with its output."""
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _RACE, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert outs[0][0] == outs[1][0]
    built = [f for f in os.listdir(tmp_path) if f.endswith(".so")]
    assert built == [os.path.basename(_build.library_path("host_embedding"))]
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "fails"))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="host_embedding"):
        _build.load("host_embedding")
