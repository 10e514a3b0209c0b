"""The port's checkpoints against the JAX package's, same inputs.

Each case is one composition of the Trainer's optimizer state: AdamW;
AdamW with a learning-rate schedule; accumulation k = 2, saved between
microbatches; a trainable_pattern; DLRM with tapped tables under SGD,
momentum and Adam; DLRM's masked dense tier under Adam. For each:

* the port's flatten_state names, shapes, dtypes and orders every leaf
  as the JAX Trainer's flatten_state does;
* a port checkpoint of the converted initial state is the JAX
  CheckpointSaver's byte for byte (file names, shard bytes, meta.json
  with its shard digests);
* a JAX checkpoint taken after a few steps restores into the port, and a
  port checkpoint into the JAX Trainer with strict=True; the next step
  then matches at the tolerances of tests/test_torch_training.py and
  tests/test_torch_dlrm.py (loss 1e-5 relative; transformer parameters
  by assert_params_close, DLRM parameters and row slots to 1e-5).

Then the saver's own rules: bf16 (wire id 13) bytes against JAX's,
pruning, the validity rule, verify_checkpoint, the maybe_save cadence,
async_save, strict=False warm starts, in-place restore and the state key
(threefry) against jax.random.
"""

import json
import os
import shutil

import ml_dtypes
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from elasticdl_tpu.api.callbacks import (
    LearningRateScheduler as JLearningRateScheduler,
)
from elasticdl_tpu.checkpoint.saver import CheckpointSaver as JSaver
from elasticdl_tpu.checkpoint.saver import flatten_state as jflatten_state
from elasticdl_tpu.checkpoint.saver import (
    restore_state_from_checkpoint as jrestore,
)
from elasticdl_tpu.common import tensor_utils as jtu
from elasticdl_tpu_torch.api.callbacks import LearningRateScheduler
from elasticdl_tpu_torch.checkpoint import (
    CheckpointCorruptError,
    CheckpointSaver,
    flatten_state,
    get_latest_checkpoint_version,
    load_checkpoint,
    restore_state_from_checkpoint,
    restore_state_from_flat,
    verify_checkpoint,
)
from elasticdl_tpu_torch.common import prng
from elasticdl_tpu_torch.common import tensor_utils as tu
from elasticdl_tpu_torch.training import optimizers
from tests import test_torch_dlrm as D
from tests import test_torch_training as T

torch.set_num_threads(2)

SCHEDULE = lambda count: 0.5 ** count  # noqa: E731
PATTERN = "head|block_1"


class Case(object):
    """A composition: how to build both trainers over the same numpy
    params, and the batches of the steps before and after the
    checkpoint."""

    def __init__(self, name, dlrm=None, jopt=None, popt=None, before=2,
                 **kwargs):
        self.name, self.dlrm, self.before = name, dlrm, before
        self.jopt, self.popt, self.kwargs = jopt, popt, kwargs

    def params(self, seed=0):
        return (D.numpy_params(self.dlrm, seed=seed) if self.dlrm
                else T.numpy_params(seed=seed))

    def batches(self):
        if self.dlrm:
            return [(D.dlrm_batch(40 + i, bsz=4,
                                  table_size=self.dlrm["table_size"]), None)
                    for i in range(self.before + 1)]
        bsz = 2 if self.kwargs.get("grad_accum_steps") else 4
        return [(T.tokens_batch(40 + i, bsz=bsz), None)
                for i in range(self.before + 1)]

    def _kwargs(self, port):
        kw = dict(self.kwargs)
        if kw.pop("schedule", False):
            kw["callbacks"] = [(LearningRateScheduler if port
                                else JLearningRateScheduler)(SCHEDULE)]
        return kw

    def jax(self, params):
        if self.dlrm:
            return D.jax_trainer(self.dlrm, params, self.batches()[0][0],
                                 self.jopt, **self._kwargs(False))
        return T.jax_trainer(params, self.batches()[0][0],
                             **self._kwargs(False))

    def port(self, params):
        if self.dlrm:
            return D.port_trainer(self.dlrm, params, self.popt,
                                  **self._kwargs(True))
        return T.port_trainer(params, **self._kwargs(True))

    def assert_close(self, ps, js):
        if not self.dlrm:
            T.assert_params_close(ps, js)
            return
        D.assert_params_close(ps, js)
        for key, state in ps.embed_opt_state.items():
            ref = D.jax_row_slots(js, key)
            assert len(ref) == len(state.slots)
            for got, want in zip(state.slots, ref):
                np.testing.assert_allclose(got.numpy(), want, atol=D.TOL,
                                           rtol=D.TOL, err_msg=key)


def _sgd(momentum=None):
    return (lambda: optax.sgd(0.05, momentum=momentum),
            lambda: optimizers.sgd(0.05, momentum=momentum))


CASES = [
    Case("adamw"),
    Case("adamw_schedule", schedule=True),
    Case("accum2_between_microbatches", before=3, grad_accum_steps=2),
    Case("trainable_pattern", trainable_pattern=PATTERN),
    Case("dlrm_tapped_sgd", D.TAPPED, *_sgd()),
    Case("dlrm_tapped_momentum", D.TAPPED, *_sgd(0.9)),
    Case("dlrm_tapped_adam", D.TAPPED, lambda: optax.adam(0.01),
         lambda: optimizers.adam(0.01)),
    Case("dlrm_masked_adam", D.MASKED, lambda: optax.adam(0.01),
         lambda: optimizers.adam(0.01)),
]
CASE_IDS = [c.name for c in CASES]


def _files(path):
    return {name: open(os.path.join(path, name), "rb").read()
            for name in sorted(os.listdir(path))}


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_leaf_names_and_initial_bytes_match_jax(case, tmp_path):
    params = case.params()
    _jt, js = case.jax(params)
    pt, ps = case.port(params)
    ref, ours = jflatten_state(js), flatten_state(pt, ps)
    assert list(ours) == list(ref)
    for name, want in ref.items():
        got = ours[name]
        assert (got.shape, got.dtype) == (want.shape, want.dtype), name
        np.testing.assert_array_equal(got, want, err_msg=name)
    JSaver(str(tmp_path / "jax"), num_shards=3).save(js, 1)
    CheckpointSaver(pt, str(tmp_path / "port"), num_shards=3).save(ps, 1)
    want = _files(str(tmp_path / "jax" / "version-1"))
    got = _files(str(tmp_path / "port" / "version-1"))
    assert sorted(got) == sorted(want) == [
        "meta.json"] + ["variables-%d-of-3.ckpt" % i for i in range(3)]
    for name in want:
        assert got[name] == want[name], name
    meta = json.loads(got["meta.json"])
    assert meta["leaf_count"] == len(ref) and len(meta["shard_digests"]) == 3


def _steps(trainer, state, batches):
    loss = None
    for batch, n in batches:
        state, loss = trainer.train_step(state, batch, n)
    return state, float(loss)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_jax_checkpoint_resumes_in_port(case, tmp_path):
    params, batches = case.params(), case.batches()
    jt, js = case.jax(params)
    js, _ = _steps(jt, js, batches[:-1])
    JSaver(str(tmp_path)).save(js, int(js.step))
    # the port starts from other weights: everything comes from the file
    pt, ps = case.port(case.params(seed=1))
    ps, version = restore_state_from_checkpoint(pt, ps, str(tmp_path))
    assert version == ps.step == case.before
    js, jl = _steps(jt, js, batches[-1:])
    ps, pl = _steps(pt, ps, batches[-1:])
    np.testing.assert_allclose(pl, jl, rtol=T.TOL, atol=0)
    case.assert_close(ps, js)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_port_checkpoint_resumes_in_jax(case, tmp_path):
    params, batches = case.params(), case.batches()
    pt, ps = case.port(params)
    ps, _ = _steps(pt, ps, batches[:-1])
    CheckpointSaver(pt, str(tmp_path)).save(ps, ps.step)
    jt, js = case.jax(case.params(seed=1))
    js, version = jrestore(js, str(tmp_path), strict=True)
    assert version == int(js.step) == case.before
    js, jl = _steps(jt, js, batches[-1:])
    ps, pl = _steps(pt, ps, batches[-1:])
    np.testing.assert_allclose(pl, jl, rtol=T.TOL, atol=0)
    case.assert_close(ps, js)


# ------------------------------------------------------- the saver's rules


def test_bf16_wire_bytes_match_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(3, 5).astype(np.float32)
    ref = jtu.serialize_ndarray_dict({
        "b": x.astype(ml_dtypes.bfloat16), "f": x,
        "s": np.array([b"ab", b"c"]), "i": np.int32(7)})
    t = torch.from_numpy(x).to(torch.bfloat16)
    ours = tu.serialize_ndarray_dict({"b": t, "f": x,
                                      "s": np.array([b"ab", b"c"]),
                                      "i": np.int32(7)})
    assert ours == ref
    back = tu.deserialize_ndarray_dict(ref)
    assert back["b"].dtype == torch.bfloat16 and torch.equal(back["b"], t)
    assert back["i"].shape == () and back["s"].tolist() == [b"ab", b"c"]
    jback = jtu.deserialize_ndarray_dict(ours)
    np.testing.assert_array_equal(
        jback["b"].view(np.uint16), t.view(torch.int16).numpy().view(
            np.uint16))


@pytest.fixture
def rig():
    pt, ps = T.port_trainer(T.numpy_params())
    return pt, ps


def _versions(path):
    return sorted(d for d in os.listdir(path) if d.startswith("version-"))


def test_prune_and_maybe_save_cadence(rig, tmp_path):
    pt, ps = rig
    saver = CheckpointSaver(pt, str(tmp_path), checkpoint_steps=3,
                            keep_max_version=2)
    assert not saver.maybe_save(ps, version=0)
    assert not saver.maybe_save(ps, version=2)
    assert saver.maybe_save(ps, version=3)
    assert not saver.maybe_save(ps, version=3)  # no double save
    for v in (6, 9):
        assert saver.maybe_save(ps, version=v)
    assert _versions(str(tmp_path)) == ["version-6", "version-9"]
    assert not saver.maybe_save(ps)  # state.step 0
    assert not CheckpointSaver(pt, str(tmp_path)).maybe_save(ps, version=3)


def test_validity_rule_torn_and_mixed_shard_sets(rig, tmp_path):
    pt, ps = rig
    root = str(tmp_path)
    CheckpointSaver(pt, root, num_shards=2).save(ps, 1)
    CheckpointSaver(pt, root, num_shards=3).save(ps, 2)
    assert get_latest_checkpoint_version(root) == 2
    # a torn set: version 2 loses a shard, so version 1 is the latest
    os.remove(os.path.join(root, "version-2", "variables-1-of-3.ckpt"))
    assert get_latest_checkpoint_version(root) == 1
    with pytest.raises(CheckpointCorruptError):
        verify_checkpoint(root, 2)
    # mixed counts: a complete 2-set beside the torn 3-set meta names
    for name in os.listdir(os.path.join(root, "version-1")):
        if name.startswith("variables-"):
            shutil.copy(os.path.join(root, "version-1", name),
                        os.path.join(root, "version-2", name))
    assert get_latest_checkpoint_version(root) == 2
    flat, version = load_checkpoint(root)  # the complete 2-set
    assert version == 2 and list(flat) and len(flat) == len(
        flatten_state(pt, ps))
    with pytest.raises(CheckpointCorruptError, match="meta names 3"):
        verify_checkpoint(root, 2)
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "none"))
    assert get_latest_checkpoint_version(str(tmp_path / "none")) == -1


def test_verify_checkpoint_catches_a_flipped_byte(rig, tmp_path):
    pt, ps = rig
    root = str(tmp_path)
    CheckpointSaver(pt, root, num_shards=2).save(ps, 4)
    manifest = verify_checkpoint(root, 4)
    sizes = sum(os.path.getsize(os.path.join(root, "version-4", n))
                for n in os.listdir(os.path.join(root, "version-4"))
                if n.startswith("variables-"))
    assert manifest == {"version": 4, "num_shards": 2,
                        "leaf_count": len(flatten_state(pt, ps)),
                        "bytes": sizes, "verified_digests": 2}
    path = os.path.join(root, "version-4", "variables-0-of-2.ckpt")
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0x01
    open(path, "wb").write(bytes(data))
    with pytest.raises(CheckpointCorruptError, match="digest mismatch"):
        verify_checkpoint(root, 4)
    with pytest.raises(FileNotFoundError):
        verify_checkpoint(root, 5)


def test_async_save_snapshots_the_state_and_surfaces_failures(rig, tmp_path):
    pt, ps = rig
    root = str(tmp_path / "a")
    want = flatten_state(pt, ps)
    saver = CheckpointSaver(pt, root, checkpoint_steps=1, keep_max_version=2,
                            async_save=True)
    saver.save(ps, 1)
    # train on while the write may be in flight: the host copy is taken
    ps, _ = pt.train_step(ps, T.tokens_batch(1))
    saver.save(ps, 2)  # joins version 1's write first
    saver.wait()
    assert _versions(root) == ["version-1", "version-2"]
    got, _ = load_checkpoint(root, 1)
    assert list(got) == sorted(want)
    for name, value in want.items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)
    assert set(saver.last_timing) == {
        "device_to_host_s", "serialize_sha256_s", "write_rename_s", "bytes"}
    CheckpointSaver(pt, str(tmp_path / "s")).save(ps, 2)
    assert _files(os.path.join(root, "version-2")) == _files(
        str(tmp_path / "s" / "version-2"))
    # a failed background write re-raises in wait(), and the cadence
    # retries the version
    real, calls = saver._write_and_log, []

    def flaky(*args):
        calls.append(args)
        if len(calls) == 1:
            raise OSError("disk full")
        return real(*args)

    saver._write_and_log = flaky
    saver.save(ps, 3)
    with pytest.raises(OSError, match="disk full"):
        saver.wait()
    assert _versions(root) == ["version-1", "version-2"]
    assert saver.maybe_save(ps, version=3)
    saver.wait()
    assert _versions(root) == ["version-2", "version-3"]


def test_restore_is_in_place_and_strict_false_warm_starts(rig, tmp_path):
    pt, ps = rig
    ps, _ = pt.train_step(ps, T.tokens_batch(2))
    CheckpointSaver(pt, str(tmp_path)).save(ps, 1)
    flat, _ = load_checkpoint(str(tmp_path))
    qt, qs = T.port_trainer(T.numpy_params(seed=3))
    qs, _ = qt.train_step(qs, T.tokens_batch(3))
    head = qs.params["head.weight"]
    slot = qs.opt_state.optimizer.state[head]["exp_avg"]
    fresh_wpe = qs.params["wpe.weight"].detach().clone()
    partial = {k: v for k, v in flat.items() if "['wpe']" not in k}
    with pytest.raises(ValueError, match="missing 3 leaves"):
        restore_state_from_flat(qt, qs, partial)
    restore_state_from_flat(qt, qs, partial, strict=False)
    # the same Parameter objects and slot tensors, new values
    assert qs.params["head.weight"] is head
    assert qs.opt_state.optimizer.state[head]["exp_avg"] is slot
    torch.testing.assert_close(head, ps.params["head.weight"], rtol=0,
                               atol=0)
    torch.testing.assert_close(
        slot, ps.opt_state.optimizer.state[ps.params["head.weight"]][
            "exp_avg"], rtol=0, atol=0)
    assert torch.equal(qs.params["wpe.weight"], fresh_wpe)
    assert float(qs.opt_state.optimizer.state[head]["step"]) == 1
    assert qs.step == 1 and qs.opt_state.count == 1
    # a restore before any step makes the slots as the first step does
    rt, rs = T.port_trainer(T.numpy_params(seed=4))
    restore_state_from_flat(rt, rs, flat)
    for key, p in rs.params.items():
        st = rs.opt_state.optimizer.state[p]
        assert float(st["step"]) == 1 and st["exp_avg"].shape == p.shape


def test_uncovered_compositions_raise(tmp_path):
    params = T.numpy_params()
    for factory in (lambda: lambda ps: torch.optim.Adagrad(ps, lr=0.1),
                    lambda: optimizers.OptimizerFactory(
                        torch.optim.AdamW, lr=0.1, amsgrad=True)):
        pt, ps = T.port_trainer(params, optimizer=factory)
        with pytest.raises(NotImplementedError, match="checkpoint names"):
            flatten_state(pt, ps)
        with pytest.raises(NotImplementedError):
            CheckpointSaver(pt, str(tmp_path)).save(ps, 1)
        assert get_latest_checkpoint_version(str(tmp_path)) == -1


@pytest.mark.parametrize("seed", [0, 1, 42, -3, 2 ** 31 - 1])
def test_state_rng_matches_jax_random_split(seed):
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed))[1])
    got = prng.state_rng(seed)
    assert got.dtype == np.uint32 and np.array_equal(got, want)
    key = np.asarray(jax.random.PRNGKey(seed))
    np.testing.assert_array_equal(prng.prng_key(seed), key)
    np.testing.assert_array_equal(prng.split(key, 5),
                                  np.asarray(jax.random.split(
                                      jnp.asarray(key), 5)))
    pt, ps = T.port_trainer(T.numpy_params())
    assert np.array_equal(ps.rng, prng.state_rng(0))
