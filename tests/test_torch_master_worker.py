"""The port's elastic training job against the JAX package's, at the
tiny transformer_lm of tests/test_torch_training.py, on the CPU.

* parity: the JAX in-process Master and Worker(master_servicer=...) and
  the port's, both starting from one JAX checkpoint
  (checkpoint_dir_for_init), the task shuffle seeded alike, for
  training with evaluation, evaluation only and prediction only: the
  dispatched task sequence, the per-step losses (1e-5 relative, as
  tests/test_torch_training.py), `completed_job_metrics` of every
  version (token accuracy, 1e-6), the prediction outputs (1e-5) and the
  final checkpoint read back by the JAX saver: parameters 999 in 1,000
  elements to 2e-6 and all to 5e-4 (test_torch_training.py's bounds),
  each AdamW slot leaf to 1e-4 of its largest magnitude (mu and nu
  follow the gradients, whose fp32 sum order differs between XLA and
  PyTorch; measured: at most 7e-6 of it after 8 steps),
  the step and counts exactly;
* over the transport on localhost: two worker threads report every
  task range exactly once and train every record once; the straggler
  watchdog requeues a stalled task and removes its worker, as JAX's;
* InstanceManagerBase's exit handling on fake processes, against
  JAX's: -9 (137) is preemption and spends no relaunch, other codes
  spend the budget until it runs out, an OOM kill spends it,
  disable_relaunch, remove_worker, a clean exit;
* a subprocess drill: LocalInstanceManager launches two
  `python -m elasticdl_tpu_torch.worker.main --device cpu` processes,
  the one holding tasks is SIGKILLed, its tasks are requeued, a worker
  with a new id is launched and the job completes, within a deadline;
* a master restart over the transport with job_state_dir: the worker
  retries, re-registers with the new master and the job completes with
  every range done once;
* the CLI: `python -m elasticdl_tpu_torch.client.main train --device
  cpu` (the master in that process, a `worker.main` subprocess) ends
  with its status file Succeeded and a checkpoint; the entry points
  default to --device cuda and raise without a card.
"""

import json
import os
import random
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax

from elasticdl_tpu.checkpoint.saver import CheckpointSaver as JSaver
from elasticdl_tpu.checkpoint.saver import load_checkpoint as jload
from elasticdl_tpu.common.model_utils import (
    load_model_spec_from_module as jax_spec_of,
)
from elasticdl_tpu.data import recordio_gen
from elasticdl_tpu.master import instance_manager as jim
from elasticdl_tpu.master.master import Master as JMaster
from elasticdl_tpu.parallel import mesh as mesh_lib
from elasticdl_tpu.worker.worker import Worker as JWorker
from elasticdl_tpu_torch.common import job_status
from elasticdl_tpu_torch.common.model_utils import (
    load_model_spec_from_module,
)
from elasticdl_tpu_torch.common.retry import RetryPolicy
from elasticdl_tpu_torch.master import instance_manager as pim
from elasticdl_tpu_torch.master.master import Master
from elasticdl_tpu_torch.master.state_store import JobStateStore
from elasticdl_tpu_torch.model_zoo import transformer_lm as tzoo
from elasticdl_tpu_torch.worker import main as worker_main
from elasticdl_tpu_torch.worker.worker import Worker
from model_zoo.transformer_lm import transformer_lm as zoo
from tests import test_torch_training as T

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOT_TOL = 1e-4
METRIC_TOL = 1e-6
MINIBATCH, PER_TASK = 4, 8
DEADLINE_S = 120


def _tokens(path, files=2, records=16, seed=0):
    recordio_gen.gen_tokens_like(path, num_files=files,
                                 records_per_file=records, seed=seed,
                                 seq_len=T.CFG["seq_len"] + 1,
                                 vocab_size=T.CFG["vocab_size"])
    return path


@pytest.fixture(scope="module")
def job_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("job")
    ckpt = str(root / "init")
    _jt, js = T.jax_trainer(T.numpy_params(), T.tokens_batch(0))
    JSaver(ckpt).save(js, 1)
    return {"train": _tokens(str(root / "train")),
            "val": _tokens(str(root / "val"), files=1, records=8, seed=5),
            "predict": _tokens(str(root / "predict"), files=1, records=10,
                               seed=6),
            "init": ckpt, "root": root}


MODES = {
    "train_eval": dict(data=("train", "val"),
                       job_type="training_with_evaluation"),
    "eval": dict(data=(None, "val"), job_type="evaluation_only"),
    "predict": dict(data=(None, None, "predict"),
                    job_type="prediction_only"),
}


def _job(pkg, mode, dirs, out):
    """One in-process job of `pkg`; returns what the parity test holds."""
    cfg = MODES[mode]
    data = dict(zip(("training_data", "validation_data", "prediction_data"),
                    [dirs[d] if d else None for d in cfg["data"]]))
    random.seed(0)  # the task shuffle
    master_cls, worker_cls = (JMaster, JWorker) if pkg == "jax" else (
        Master, Worker)
    spec = jax_spec_of(zoo) if pkg == "jax" else load_model_spec_from_module(
        tzoo)
    master = master_cls(spec, minibatch_size=MINIBATCH,
                        records_per_task=PER_TASK, evaluation_steps=2,
                        **data)
    dispatched = []
    for name in ("get", "get_eval_task"):
        fn = getattr(master.task_d, name)

        def recorded(worker_id, fn=fn):
            task_id, task = fn(worker_id)
            if task is not None:
                dispatched.append((os.path.basename(task.shard_name),
                                   task.start, task.end, task.type,
                                   task.model_version))
            return task_id, task

        setattr(master.task_d, name, recorded)
    ckpt = os.path.join(out, pkg)
    common = dict(master_servicer=master.servicer, job_type=cfg["job_type"],
                  minibatch_size=MINIBATCH,
                  training_data=data["training_data"],
                  model_params=T.PARAMS, wait_sleep_secs=0.01,
                  checkpoint_dir_for_init=dirs["init"])
    if pkg == "jax":
        worker = JWorker(0, spec, mesh=mesh_lib.build_mesh(
            {"dp": 1}, devices=jax.devices()[:1]),
            checkpoint_saver=JSaver(ckpt, checkpoint_steps=2), **common)
    else:
        worker = Worker(0, spec, checkpoint_dir=ckpt, checkpoint_steps=2,
                        device="cpu", **common)
    result = worker.run()
    assert master.task_d.finished() and worker.job_complete
    metrics = (master.evaluation_service.completed_job_metrics
               if master.evaluation_service else [])
    return dict(tasks=dispatched, losses=list(worker.losses),
                metrics=metrics, result=result, ckpt=ckpt)


def _assert_checkpoints_close(ours_dir, ref_dir):
    ours, v_ours = jload(ours_dir)
    ref, v_ref = jload(ref_dir)
    assert v_ours == v_ref and sorted(ours) == sorted(ref)
    diffs = []
    for name, want in ref.items():
        got = np.asarray(ours[name])
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == want.dtype, name
        if not np.issubdtype(want.dtype, np.floating):
            np.testing.assert_array_equal(got, want, err_msg=name)
        elif name.startswith(".params"):
            np.testing.assert_allclose(got, want, atol=T.PARAM_TOL_WORST,
                                       rtol=0, err_msg=name)
            diffs.append(np.abs(got - want).ravel())
        else:
            scale = float(np.max(np.abs(want))) if want.size else 0.0
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=SLOT_TOL * scale, err_msg=name)
    diffs = np.concatenate(diffs)
    assert (diffs > T.PARAM_TOL).mean() <= 1e-3, np.sort(diffs)[-10:]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_job_matches_jax(mode, job_dirs, tmp_path):
    ref = _job("jax", mode, job_dirs, str(tmp_path))
    ours = _job("port", mode, job_dirs, str(tmp_path))
    assert ours["tasks"] == ref["tasks"] and ours["tasks"]
    np.testing.assert_allclose(ours["losses"], ref["losses"], rtol=T.TOL,
                               atol=0)
    assert [v for v, _ in ours["metrics"]] == [v for v, _ in ref["metrics"]]
    for (_, got), (_, want) in zip(ours["metrics"], ref["metrics"]):
        assert sorted(got) == sorted(want) == ["token_accuracy"]
        assert abs(got["token_accuracy"] - want["token_accuracy"]) \
            <= METRIC_TOL
    if mode == "train_eval":
        assert len(ours["losses"]) == 32 // MINIBATCH
        # the step-based trigger at every second model version (the
        # initial checkpoint holds step 0)
        assert [v for v, _ in ours["metrics"]] == [2, 4, 6, 8]
        _assert_checkpoints_close(ours["ckpt"], ref["ckpt"])
    elif mode == "eval":
        assert [v for v, _ in ours["metrics"]] == [-1]
        # restored (the initial checkpoint's step), not trained
        assert ours["result"].step == int(ref["result"].step) == 0
    else:
        assert ours["result"].shape == (10, T.CFG["seq_len"],
                                        T.CFG["vocab_size"])
        np.testing.assert_allclose(ours["result"], ref["result"],
                                   atol=T.TOL, rtol=T.TOL)


# ------------------------------------------------- over the transport


def _done_ranges(state_dir):
    _, events = JobStateStore(state_dir).load()
    return sorted(tuple(e["task"][:3]) for e in events
                  if e["ev"] in ("done", "done_recovered"))


def _all_ranges(data, per_task=PER_TASK):
    return sorted((os.path.join(data, f), s, s + per_task)
                  for f in os.listdir(data) for s in range(0, 16, per_task))


def _port_worker(worker_id, addr, data, **kwargs):
    return Worker(worker_id, load_model_spec_from_module(tzoo),
                  master_addr=addr, minibatch_size=MINIBATCH,
                  training_data=data, model_params=T.PARAMS,
                  wait_sleep_secs=0.01, device="cpu", **kwargs)


def _run_threads(targets):
    errors = []

    def guard(fn):
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=guard, args=(fn,), daemon=True)
               for fn in targets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=DEADLINE_S)
    assert not any(t.is_alive() for t in threads), "a worker thread hung"
    if errors:
        raise errors[0]


def test_two_workers_over_the_transport_train_every_record_once(tmp_path):
    data = _tokens(str(tmp_path / "train"), files=4)
    state_dir = str(tmp_path / "state")
    master = Master(load_model_spec_from_module(tzoo), training_data=data,
                    minibatch_size=MINIBATCH, records_per_task=PER_TASK,
                    job_state_dir=state_dir)
    master.prepare()
    try:
        addr = "localhost:%d" % master.port
        workers = [_port_worker(i, addr, data) for i in range(2)]
        _run_threads([w.run for w in workers])
        assert master.task_d.finished()
    finally:
        master.stop()
        for w in workers:
            w.close()
    assert _done_ranges(state_dir) == _all_ranges(data)
    assert sum(len(w.losses) for w in workers) == 64 // MINIBATCH
    assert all(w.job_complete for w in workers)
    for w in workers:
        assert len(w.rpc_seconds["register_worker"]) == 1
        assert w.rpc_seconds["get_task"] and all(
            0 < s < 5 for s in w.rpc_seconds["get_task"])
    assert sorted(master.servicer._workers) == [0, 1]


class _FakeManager(object):
    def __init__(self):
        self.removed = []

    def remove_worker(self, worker_id):
        self.removed.append(worker_id)

    def start_workers(self):
        pass

    def all_workers_failed(self):
        return False

    def stop(self):
        pass


def test_check_timeout_tasks_recovers_a_stalled_task_as_jax(tmp_path):
    data = _tokens(str(tmp_path / "train"))
    seen = {}
    for pkg, master_cls, spec in (
            ("jax", JMaster, jax_spec_of(zoo)),
            ("port", Master, load_model_spec_from_module(tzoo))):
        random.seed(0)
        manager = _FakeManager()
        master = master_cls(spec, training_data=data,
                            minibatch_size=MINIBATCH,
                            records_per_task=PER_TASK,
                            instance_manager=manager)
        (task_id, task), _ = master.task_d.get(7), master.task_d.get(8)
        master.check_timeout_tasks()  # nothing is late yet
        doing = master.task_d._doing
        worker, stalled, _start = doing[task_id]
        doing[task_id] = (worker, stalled, time.time() - 3 * 300.0 - 1)
        master.check_timeout_tasks()
        todo, in_flight = master.task_d._todo, master.task_d.doing_tasks()
        seen[pkg] = (manager.removed, sorted(
            w for w, _t, _s in in_flight.values()), [
            (t.shard_name, t.start) for t in todo])
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == [7] and seen["port"][1] == [8]


# --------------------------------------------- instance manager (fakes)


def _fake_manager(pkg, num_workers=1, **kwargs):
    base = jim.InstanceManagerBase if pkg == "jax" \
        else pim.InstanceManagerBase

    class Recover(object):
        def __init__(self):
            self.calls = []

        def recover_tasks(self, worker_id):
            self.calls.append(worker_id)

    class Fake(base):
        def __init__(self):
            super().__init__(Recover(), num_workers, **kwargs)
            self.launched, self.killed = [], []

        def _launch(self, worker_id, original_index):
            self.launched.append((worker_id, original_index))

        def _kill(self, worker_id):
            self.killed.append(worker_id)

    return Fake()


EXITS = {
    "preempted": ({"relaunch_on_worker_failure": 1},
                  [(0, dict(exit_code=137)), (1, dict(exit_code=137)),
                   (2, dict(exit_code=137))]),
    "budget": ({"relaunch_on_worker_failure": 2},
               [(0, dict(exit_code=1)), (1, dict(exit_code=1)),
                (2, dict(exit_code=1))]),
    "oom": ({"relaunch_on_worker_failure": 1},
            [(0, dict(exit_code=137, oom=True)),
             (1, dict(exit_code=137, oom=True))]),
    "disabled": ({"disable_relaunch": True}, [(0, dict(exit_code=137))]),
    "remove": ({}, ["remove", (0, dict(exit_code=137)),
                    (1, dict(exit_code=0, succeeded=True))]),
    "deleted_and_stale": ({}, [(0, dict(deleted=True)),
                               (0, dict(exit_code=1)), (9, {})]),
}


@pytest.mark.parametrize("case", sorted(EXITS))
def test_instance_manager_exit_handling_matches_jax(case):
    kwargs, events = EXITS[case]
    seen = {}
    for pkg in ("jax", "port"):
        m = _fake_manager(pkg, num_workers=1, **kwargs)
        m.start_workers()
        trace = []
        for ev in events:
            if ev == "remove":
                m.remove_worker(0)
            else:
                worker_id, kw = ev
                kw = dict(kw)
                m._handle_worker_exit(worker_id,
                                      succeeded=kw.pop("succeeded", False),
                                      **kw)
            trace.append((list(m.launched), list(m._task_d.calls),
                          {w: m.worker_phase(w) for w in range(4)},
                          m.all_workers_failed()))
        seen[pkg] = (trace, m.killed)
    assert seen["port"] == seen["jax"]
    trace = seen["port"][0]
    if case == "preempted":
        assert len(trace[-1][0]) == 4  # every preemption relaunched
    if case == "budget":
        assert len(trace[-1][0]) == 3 and trace[-1][3]
    if case == "disabled":
        assert trace[-1][0] == [(0, 0)] and trace[-1][3]
    if case == "remove":
        assert seen["port"][1] == [0] and trace[-1][2][1] == "Succeeded"


# ---------------------------------------------------- subprocess drill


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    env.pop("EDL_FAULT_SPEC", None)
    env["OMP_NUM_THREADS"] = "1"
    return env


def _wait_until(cond, what, timeout=DEADLINE_S, poll=0.05):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError("timed out waiting for " + what)
        time.sleep(poll)


def _worker_args(data, addr):
    return ["--model_zoo", os.path.join(REPO, "elasticdl_tpu_torch",
                                        "model_zoo"),
            "--model_def", "transformer_lm.custom_model",
            "--model_params", T.PARAMS, "--training_data", data,
            "--minibatch_size", str(MINIBATCH),
            "--records_per_task", str(PER_TASK), "--device", "cpu",
            "--master_addr", addr, "--job_type", "training_only"]


def test_subprocess_drill_relaunches_a_killed_worker(tmp_path):
    data = _tokens(str(tmp_path / "train"))
    state_dir = str(tmp_path / "state")
    master = Master(load_model_spec_from_module(tzoo), training_data=data,
                    minibatch_size=MINIBATCH, records_per_task=PER_TASK,
                    num_epochs=2, job_state_dir=state_dir)
    master.prepare()
    manager = pim.LocalInstanceManager(
        master.task_d, num_workers=2,
        worker_args=_worker_args(data, "localhost:%d" % master.port),
        env=_env(), log_dir=str(tmp_path / "logs"))
    master.instance_manager = manager
    try:
        manager.start_workers()
        _wait_until(lambda: master.task_d.doing_tasks(), "a task in flight")
        held = {w for w, _t, _s in master.task_d.doing_tasks().values()}
        victim = min(held)
        manager.remove_worker(victim)
        _wait_until(lambda: manager.worker_phase(2) is not None,
                    "the relaunch")
        assert manager.worker_phase(victim) in ("Failed", "Deleted")
        _wait_until(master.task_d.finished, "the job to finish")
        assert not manager.all_workers_failed()
        assert manager.wait_all(timeout=DEADLINE_S)
    finally:
        master.stop()
    workers = manager.workers()
    # -9 maps to 137: preemption, no relaunch spent
    assert workers[victim][4] == 137 and workers[2][2] == 0
    assert workers[2][0] == victim  # the new worker fills the victim's slot
    _, events = JobStateStore(state_dir).load()
    failed = [tuple(e["task"][:3]) for e in events if e["ev"] == "fail"]
    assert failed  # the victim's tasks were requeued
    assert _done_ranges(state_dir) == sorted(_all_ranges(data) * 2)


def test_master_restart_worker_reregisters_and_job_completes(tmp_path):
    data = _tokens(str(tmp_path / "train"), files=4)
    state_dir = str(tmp_path / "state")
    spec = load_model_spec_from_module(tzoo)

    def master(port=0):
        m = Master(spec, training_data=data, minibatch_size=MINIBATCH,
                   records_per_task=PER_TASK, job_state_dir=state_dir,
                   port=port)
        m.prepare()
        return m

    first = master()
    port = first.port
    worker = _port_worker(0, "localhost:%d" % port, data,
                          retry_policy=RetryPolicy(
                              rpc_timeout_secs=5.0, base_delay_secs=0.01,
                              max_delay_secs=0.1,
                              reconnect_window_secs=60.0))
    step = worker.trainer.train_step
    stepped = threading.Event()
    released = threading.Event()

    def held_step(*args, **kwargs):
        out = step(*args, **kwargs)
        stepped.set()
        released.wait(timeout=DEADLINE_S)  # hold the worker mid-job
        return out

    worker.trainer.train_step = held_step
    second = None
    try:
        thread = threading.Thread(target=worker.run, daemon=True)
        thread.start()
        assert stepped.wait(timeout=DEADLINE_S)
        first.stop()
        # the worker's next calls find no master: it retries
        released.set()
        _wait_until(lambda: worker.rpc_retry_count >= 2, "retries")
        second = master(port)
        assert second.state_store.restart_count == 1
        thread.join(timeout=DEADLINE_S)
        assert not thread.is_alive()
        assert second.task_d.finished() and worker.job_complete
    finally:
        released.set()
        first.stop()
        if second is not None:
            second.stop()
        worker.close()
    assert worker.reconnect_count >= 1 and worker.rpc_retry_count >= 1
    assert 0 in second.servicer._workers  # registered with the new master
    assert _done_ranges(state_dir) == _all_ranges(data)
    assert len(worker.losses) == 64 // MINIBATCH


# ------------------------------------------------------------------ CLI


def test_cli_train_end_to_end_and_entry_points_default_to_cuda(tmp_path):
    data = _tokens(str(tmp_path / "train"))
    status = str(tmp_path / "status.json")
    ckpt = str(tmp_path / "ckpt")
    cmd = [sys.executable, "-m", "elasticdl_tpu_torch.client.main",
           "train", "--model_zoo",
           os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo"),
           "--model_def", "transformer_lm.custom_model",
           "--model_params", T.PARAMS, "--training_data", data,
           "--minibatch_size", str(MINIBATCH), "--records_per_task",
           str(PER_TASK), "--num_workers", "1", "--port", "0",
           "--device", "cpu", "--job_status_file", status,
           "--checkpoint_dir", ckpt, "--checkpoint_steps", "4"]
    proc = subprocess.run(cmd, env=_env(), cwd=str(tmp_path),
                          capture_output=True, text=True,
                          timeout=DEADLINE_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert job_status.read_job_status(status)["status"] == \
        job_status.SUCCEEDED
    assert sorted(os.listdir(ckpt)) == ["version-4", "version-8"]
    with open(status) as f:
        assert json.load(f)["status"] == "Succeeded"
    # the entry points train on the card unless told otherwise
    args = worker_main.parse_worker_args(
        _worker_args(data, "localhost:1")[:-6] + ["--worker_id", "0",
                                                  "--master_addr", "h:1"])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            worker_main.build_worker(args)
