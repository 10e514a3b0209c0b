"""The port's crash recovery and prediction against the JAX package's.

* the job state store: journal, snapshot, torn tails, the completion
  marker and restart count, each package reading what the other wrote;
* the dispatcher's journal: a JAX journal restores in the port and a
  port journal in JAX, to the same queues, ids, retry counts, epoch and
  model version as the writer's own package restores;
* fault rules for each action; MaxStepsStopping on the dispatcher;
* LocalExecutor: a run killed at the dispatch boundary (the drop rule)
  resumes from its job state and retrains no range; checkpoint resume
  as the JAX executor does it, and each package resuming the other's
  checkpoint to the same losses (1e-5 relative) and parameters
  (assert_params_close of tests/test_torch_training.py); predict and the
  outputs processor against the JAX executor (1e-5);
* serving/main.py --checkpoint_dir: the same greedy tokens as the same
  parameters through --params_npz.

No subprocess and no real SIGKILL here: the card's chip_smoke phase
kills a training process and resumes it.
"""

import json
import os
import random
import shutil

import numpy as np
import pytest
import torch

import jax

from elasticdl_tpu.api.callbacks import CallbackList as JCallbackList
from elasticdl_tpu.api.callbacks import MaxStepsStopping as JMaxSteps
from elasticdl_tpu.api.local_executor import LocalExecutor as JLocalExecutor
from elasticdl_tpu.checkpoint.saver import CheckpointSaver as JSaver
from elasticdl_tpu.checkpoint.saver import load_checkpoint as jload
from elasticdl_tpu.common import fault_injection as jfault
from elasticdl_tpu.common.model_utils import (
    load_model_spec_from_module as jax_spec_of,
)
from elasticdl_tpu.data import recordio_gen
from elasticdl_tpu.master.state_store import JobStateStore as JStore
from elasticdl_tpu.master.task_dispatcher import (
    TaskDispatcher as JDispatcher,
)
from elasticdl_tpu.parallel import mesh as mesh_lib
from elasticdl_tpu.worker.prediction_outputs_processor import (
    BasePredictionOutputsProcessor as JBaseProcessor,
)
from elasticdl_tpu_torch.api.callbacks import CallbackList, MaxStepsStopping
from elasticdl_tpu_torch.api.local_executor import LocalExecutor
from elasticdl_tpu_torch.checkpoint.saver import load_checkpoint
from elasticdl_tpu_torch.common.fault_injection import (
    FaultInjector,
    FaultRule,
    InjectedRpcError,
)
from elasticdl_tpu_torch.common.model_utils import (
    load_model_spec_from_module,
)
from elasticdl_tpu_torch.master.state_store import JobStateStore
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.model_zoo import transformer_lm as tzoo
from elasticdl_tpu_torch.serving import main as port_main
from elasticdl_tpu_torch.worker.prediction_outputs_processor import (
    BasePredictionOutputsProcessor,
    resolve_processor,
)
from model_zoo.transformer_lm import transformer_lm as zoo
from tests import test_torch_training as T

torch.set_num_threads(2)

PACKAGES = {"jax": (JStore, JDispatcher), "port": (JobStateStore,
                                                   TaskDispatcher)}


# ---------------------------------------------------------- state store


@pytest.mark.parametrize("tail,kept", [
    ('{"ev": "tor', ["a", "b"]),  # a JSON prefix
    (b"\xff\xfe\x00garbage", ["a", "b"]),  # binary block garbage
    ('{"ev": "torn"\n', ["a", "b"]),  # a newline-terminated torn line
])
def test_state_store_round_trips_with_jax_and_trims_torn_tails(
        tmp_path, tail, kept):
    d = str(tmp_path / "s")
    store = JobStateStore(d)
    assert not store.has_state() and store.load() == (None, [])
    store.append({"ev": "a", "x": 1})
    store.close()
    jstore = JStore(d)  # the JAX store appends to the port's journal
    jstore.append({"ev": "b"})
    jstore.close()
    with open(os.path.join(d, "journal.jsonl"),
              "ab" if isinstance(tail, bytes) else "a") as f:
        f.write(tail)
    ours = JobStateStore(d)
    assert ours.restart_count == 2  # the JAX store counted one too
    snapshot, events = ours.load()
    assert snapshot is None and [e["ev"] for e in events] == kept
    assert ours.torn_lines >= 1
    ours.append({"ev": "c"})  # trims a newline-less tail, never concatenates
    ours.close()
    if tail.endswith("\n" if isinstance(tail, str) else b"\n"):
        # a whole torn line is not the tail any more: data loss, which
        # both packages refuse to skip
        for store_cls in (JStore, JobStateStore):
            with pytest.raises(ValueError):
                store_cls(d).load()
        return
    _, events = JStore(d).load()
    assert [e["ev"] for e in events] == kept + ["c"]
    ours.write_snapshot({"format": 1, "epoch": 3})
    assert JStore(d).load() == ({"format": 1, "epoch": 3}, [])
    assert not ours.is_job_complete()
    ours.mark_job_complete()
    assert JStore(d).is_job_complete()
    with open(os.path.join(d, "journal.jsonl"), "w") as f:
        f.write('{"ev": "tor\n{"ev": "b"}\n')
    with pytest.raises(ValueError):
        JobStateStore(d).load()


# ------------------------------------------------------ dispatcher journal


def _crash_run(pkg, d):
    """A job that dies mid-flight: two epochs over two shards, one task
    done, one failed, one still doing, an evaluation task doing, a
    model version and the deferred train-end task journaled."""
    store_cls, disp_cls = PACKAGES[pkg]
    random.seed(3)
    disp = disp_cls({"a": (0, 30), "b": (5, 25)}, {"e": (0, 20)}, {}, 10, 2,
                    state_store=store_cls(d, snapshot_every=4))
    ids = [disp.get("w%d" % i) for i in range(4)]
    disp.report(ids[0][0], True)
    disp.report(ids[1][0], False)
    disp.report(ids[2][0], True)
    disp.create_tasks("EVALUATION", model_version=3)
    disp.get_eval_task("w9")
    disp.record_model_version(5)
    disp.add_deferred_callback_create_train_end_task()
    return ids


def _queues(disp):
    def payloads(tasks):
        return [list(t._info()) for t in tasks]

    return {
        "todo": payloads(disp._todo), "eval_todo": payloads(disp._eval_todo),
        "recovered": {k: [v[0], list(v[1])]
                      for k, v in disp._recovered_doing.items()},
        "retry": sorted([list(k), v] for k, v in
                        disp._task_retry_count.items()),
        "epoch": disp.epoch, "task_id": disp._task_id,
        "model_version": disp.model_version,
        "stop": disp.stop_training,
        "deferred": len(disp._tasks_done_deferred_callbacks),
        "requeued": disp.requeued_on_recovery,
    }


def _drain(disp):
    random.seed(4)  # the second epoch's shuffle
    order = []
    while True:
        tid, task = disp.get("w0")
        if task is None:
            if not disp.invoke_deferred_callback():
                break
            continue
        order.append(list(task._info()))
        disp.report(tid, True)
    return order


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                          ("port", "jax")])
def test_dispatcher_journal_restores_in_the_other_package(tmp_path, writer,
                                                          reader):
    d = str(tmp_path / "written")
    ids = _crash_run(writer, d)
    restored = {}
    for pkg in (writer, reader):
        copy = str(tmp_path / pkg)
        shutil.copytree(d, copy)
        store_cls, disp_cls = PACKAGES[pkg]
        restored[pkg] = disp_cls({"a": (0, 30), "b": (5, 25)},
                                 {"e": (0, 20)}, {}, 10, 2,
                                 state_store=store_cls(copy))
    ours, ref = _queues(restored[reader]), _queues(restored[writer])
    assert ours == ref
    assert ours["requeued"] == 2 and ours["model_version"] == 5
    assert ids[3][0] in restored[reader]._recovered_doing
    # a late success of a pre-crash task is reconciled, not rerun
    for disp in restored.values():
        disp.report(ids[3][0], True)
        assert disp.recovered_late_completions == 1
    assert _drain(restored[reader]) == _drain(restored[writer])
    for pkg in (writer, reader):
        _, events = PACKAGES[reader][0](str(tmp_path / pkg)).load()
        assert events and events[-1]["ev"] == "done"


def test_max_steps_stopping_on_the_dispatcher_matches_jax():
    orders = []
    for cbs_cls, stop_cls, disp_cls in (
            (JCallbackList, JMaxSteps, JDispatcher),
            (CallbackList, MaxStepsStopping, TaskDispatcher)):
        for seeded in (0, 4):
            random.seed(1)
            stop = stop_cls(5, minibatch_size=4)
            stop.set_completed_steps(seeded)
            disp = disp_cls({"a": (0, 40)}, {}, {}, 8, 1,
                            callbacks_list=cbs_cls([stop]))
            stop.set_task_dispatcher(disp)
            order = []
            while True:
                tid, task = disp.get("w0")
                if task is None:
                    break
                order.append(list(task._info()))
                disp.report(tid, True)
            assert disp.stop_training and disp.finished()
            orders.append(order)
    assert orders[:2] == orders[2:]
    assert [len(o) for o in orders[2:]] == [3, 1]


# ------------------------------------------------------------ fault rules


@pytest.mark.parametrize("spec", ["local_get_task:drop:2:skip=1",
                                  "local_report:error:1:code=ABORTED",
                                  "*:delay:*:secs=0.01",
                                  "local_get_task:kill:1:skip=2"])
def test_fault_rule_parse_and_fire_as_jax(spec):
    rule, ref = FaultRule.parse(spec), jfault.FaultRule.parse(spec)
    for attr in ("rpc", "action", "count", "skip", "secs", "code"):
        assert getattr(rule, attr) == getattr(ref, attr), attr
    kills = []
    injector = FaultInjector(spec=spec, kill_fn=lambda: kills.append(1))
    fired = []
    for call in range(4):
        for when in ("before", "after"):
            try:
                injector.intercept(rule.rpc if rule.rpc != "*" else "x",
                                   when=when)
            except InjectedRpcError as e:
                fired.append((call, when, e.code()))
    if rule.action == "drop":
        assert fired == [(1, "before", "UNAVAILABLE"),
                         (2, "before", "UNAVAILABLE")]
    elif rule.action == "error":
        assert fired == [(0, "after", "ABORTED")]
    elif rule.action == "kill":
        assert kills == [1] and not fired
    else:
        assert not fired and injector.injected == {"x": 4}
    for bad in ("get_task", "get_task:explode", "get_task:drop:1:foo=1"):
        with pytest.raises(ValueError):
            FaultRule.parse(bad)
    assert FaultInjector.from_env({}) is None
    env = FaultInjector.from_env({"EDL_FAULT_SPEC": spec + ";x:drop"})
    assert [r.action for r in env.rules] == [rule.action, "drop"]


# --------------------------------------------------------- LocalExecutor


def _tokens(path, files=1, records=16):
    recordio_gen.gen_tokens_like(path, num_files=files,
                                 records_per_file=records,
                                 seq_len=T.CFG["seq_len"] + 1,
                                 vocab_size=T.CFG["vocab_size"])
    return path


def _port_executor(**kwargs):
    random.seed(0)  # the task shuffle
    return LocalExecutor(load_model_spec_from_module(tzoo),
                         model_params=T.PARAMS, device="cpu", **kwargs)


def _jax_executor(**kwargs):
    random.seed(0)
    mesh = mesh_lib.build_mesh({"dp": 1}, devices=jax.devices()[:1])
    return JLocalExecutor(jax_spec_of(zoo), model_params=T.PARAMS,
                          mesh=mesh, **kwargs)


def _done_ranges(state_dir):
    _, events = JobStateStore(state_dir).load()
    return [tuple(e["task"][:3]) for e in events if e["ev"] == "done"]


def test_local_executor_crash_resume_with_the_drop_rule(tmp_path):
    data = _tokens(str(tmp_path / "train"), files=2, records=16)
    runs = {}
    for pkg, make, fault in (("port", _port_executor, FaultInjector),
                             ("jax", _jax_executor, jfault.FaultInjector)):
        state_dir = str(tmp_path / pkg)
        common = dict(training_data=data, minibatch_size=4,
                      records_per_task=8, job_state_dir=state_dir)
        run1 = make(fault_injector=fault(spec="local_get_task:drop:1:skip=2"),
                    **common)
        with pytest.raises(Exception) as err:
            run1.train()
        assert "injected fault: drop local_get_task" in str(err.value)
        first = _done_ranges(state_dir)
        run2 = make(**common)
        run2.train()
        # the restore compacted run 1's journal into a snapshot: run 2's
        # journal holds its own tasks only
        runs[pkg] = (len(run1.losses), len(run2.losses), first,
                     first + _done_ranges(state_dir))
    # two tasks (2 steps each) before the crash, the other two after
    assert runs["port"][:2] == runs["jax"][:2] == (4, 4)
    first, done = runs["port"][2:]
    assert first == runs["jax"][2] and len(first) == 2
    # every range trained exactly once over both runs
    shards = sorted(os.path.join(data, f) for f in os.listdir(data))
    assert sorted(done) == sorted(runs["jax"][3]) == [
        (shard, s, s + 8) for shard in shards for s in (0, 8)]


def test_checkpoint_resume_matches_jax_executor(tmp_path):
    data = _tokens(str(tmp_path / "train"))
    got = {}
    for pkg, make in (("port", _port_executor), ("jax", _jax_executor)):
        ckpt = str(tmp_path / ("ckpt_" + pkg))
        common = dict(training_data=data, minibatch_size=4,
                      records_per_task=8)
        run1 = make(checkpoint_dir=ckpt, checkpoint_steps=2,
                    keep_checkpoint_max=1, **common)
        state1, _ = run1.run()
        assert int(state1.step) == 4
        assert sorted(os.listdir(ckpt)) == ["version-4"]
        state2, _ = make(checkpoint_dir_for_init=ckpt, **common).run()
        assert int(state2.step) == 8  # resumed at 4, one more epoch
        got[pkg] = ckpt
    # each package resumes the port's checkpoint: the same steps follow
    pair = {}
    for pkg, make in (("port", _port_executor), ("jax", _jax_executor)):
        ex = make(checkpoint_dir_for_init=got["port"], training_data=data,
                  minibatch_size=4, records_per_task=8)
        ex.run()
        pair[pkg] = ex
    np.testing.assert_allclose(pair["port"].losses, pair["jax"].losses,
                               rtol=T.TOL)
    assert pair["port"].restored_version == 4
    T.assert_params_close(pair["port"].state, pair["jax"].state)
    # and the port resumes the JAX package's checkpoint
    flat, _ = jload(got["jax"])
    ex = _port_executor(checkpoint_dir_for_init=got["jax"],
                        training_data=data, minibatch_size=4,
                        records_per_task=8, max_steps=5)
    ex.run()
    assert ex.state.step == 5 and len(ex.losses) == 1
    assert np.asarray(flat[".step"]) == 4


class _Collect(BasePredictionOutputsProcessor):
    seen = []

    def process(self, predictions, worker_id):
        type(self).seen.append((predictions, worker_id))


class _JCollect(JBaseProcessor):
    seen = []

    def process(self, predictions, worker_id):
        type(self).seen.append((predictions, worker_id))


def test_predict_and_outputs_processor_match_jax_executor(tmp_path):
    data = _tokens(str(tmp_path / "predict"), records=10)
    ckpt = str(tmp_path / "ckpt")
    jt, js = T.jax_trainer(T.numpy_params(), T.tokens_batch(0))
    JSaver(ckpt).save(js, 1)
    common = dict(prediction_data=data, minibatch_size=4,
                  checkpoint_dir_for_init=ckpt)
    port = _port_executor(**common)
    port.spec.prediction_outputs_processor = _Collect
    ref_ex = _jax_executor(**common)
    ref_ex.spec.prediction_outputs_processor = _JCollect
    ours, ref = port.run(), ref_ex.run()
    assert ours.shape == ref.shape == (10, T.CFG["seq_len"],
                                       T.CFG["vocab_size"])
    np.testing.assert_allclose(ours, ref, atol=T.TOL, rtol=T.TOL)
    (seen, worker), = _Collect.seen
    assert worker == 0 and seen is ours and len(_JCollect.seen) == 1
    calls = []
    resolve_processor(lambda p: calls.append(p))("x", 3)
    assert calls == ["x"] and resolve_processor(None) is None


# ------------------------------------------------------------- serving


def test_serving_main_checkpoint_dir_matches_params_npz(tmp_path):
    params = T.numpy_params(seed=2)
    flat = T.flatten_params(params)
    npz = str(tmp_path / "params.npz")
    np.savez(npz, **flat)
    ckpt = str(tmp_path / "ckpt")
    # the JAX Trainer's checkpoint of the same params, at version 7
    jt, js = T.jax_trainer(params, T.tokens_batch(0))
    JSaver(ckpt).save(js, 7)
    lines = ['{"prompt": [1, 2, 3], "max_new_tokens": 6}',
             '{"prompt": [5, 4], "max_new_tokens": 4}', '{"status": true}']
    common = ["--device", "cpu", "--model_params", T.PARAMS,
              "--num_slots", "2", "--kv_paged", "1", "--kv_block_size", "4"]
    answers = {}
    for name, extra in (("npz", ["--params_npz", npz]),
                        ("ckpt", ["--checkpoint_dir", ckpt]),
                        ("empty", ["--checkpoint_dir",
                                   str(tmp_path / "none")]),
                        ("seeded", [])):
        server = port_main.build_server(
            port_main.parse_serving_args(common + extra)).start()
        try:
            answers[name] = port_main.serve_lines(server, lines)
        finally:
            server.stop(timeout=30)
    assert answers["ckpt"][:2] == answers["npz"][:2]
    assert answers["ckpt"][2]["status"]["model_version"] == 7
    assert answers["npz"][2]["status"]["model_version"] == 0
    assert answers["empty"][:2] == answers["seeded"][:2] != answers["npz"][:2]
    assert all(len(a["tokens"]) == n for a, n in zip(answers["ckpt"],
                                                     (9, 6)))
    json.dumps(answers)  # JSON lines, as main prints them
    assert load_checkpoint(ckpt)[1] == 7
