"""Instance managers: the elastic core, the port's copy of the local
part of elasticdl_tpu/master/instance_manager.py.

* `start_workers` launches the worker fleet;
* a worker that dies has its tasks in flight requeued
  (`task_d.recover_tasks`) and is relaunched with a new worker id, at
  most `relaunch_on_worker_failure` times per slot; an exit by SIGKILL
  (-9, `_EXIT_PREEMPTED`) counts as preemption and spends no relaunch;
  `disable_relaunch` relaunches nothing;
* `remove_worker` kills a worker (the straggler watchdog's path): its
  exit is handled like any other;
* `all_workers_failed` lets the master's wait loop abort the job.

`LocalInstanceManager` runs each worker as a subprocess,
`python -m elasticdl_tpu_torch.worker.main ... --worker_id N`, started
with `subprocess.Popen` (never a fork of a process that may hold a CUDA
context); a waiter thread per process turns its exit into
`_handle_worker_exit`. The Kubernetes manager is not ported (there is no
Kubernetes client).
"""

import logging
import os
import subprocess
import sys
import threading
import time

from elasticdl_tpu_torch.common.fault_injection import FaultInjector

logger = logging.getLogger(__name__)

_EXIT_PREEMPTED = 137  # SIGKILL: evicted / preempted unless OOMKilled

_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class _WorkerRecord(object):
    def __init__(self, worker_id, original_index):
        self.worker_id = worker_id
        self.original_index = original_index  # the slot it fills
        self.phase = "Pending"
        self.relaunch_count = 0
        self.launch_time = None
        self.exit_code = None


class InstanceManagerBase(object):
    """The elasticity state machine over an abstract launch / kill
    backend."""

    def __init__(
        self,
        task_d,
        num_workers,
        relaunch_on_worker_failure=3,
        disable_relaunch=False,
    ):
        self._task_d = task_d
        self._num_workers = num_workers
        self._max_relaunch = (
            0 if disable_relaunch else relaunch_on_worker_failure
        )
        self._lock = threading.Lock()
        self._workers = {}  # worker_id -> _WorkerRecord
        self._next_worker_id = 0
        self._stopping = False
        # drill hooks: EDL_FAULT_SPEC rules named worker_launch /
        # worker_exit fire here
        self._fault_injector = FaultInjector.from_env()

    # backend hooks ------------------------------------------------------

    def _launch(self, worker_id, original_index):
        raise NotImplementedError

    def _kill(self, worker_id):
        raise NotImplementedError

    # the master's API ---------------------------------------------------

    def start_workers(self):
        for i in range(self._num_workers):
            self._start_worker(i)

    def _start_worker(self, original_index, relaunch_count=0):
        with self._lock:
            worker_id = self._next_worker_id
            self._next_worker_id += 1
            record = _WorkerRecord(worker_id, original_index)
            record.relaunch_count = relaunch_count
            record.launch_time = time.time()
            self._workers[worker_id] = record
        logger.info(
            "Starting worker %d (slot %d)", worker_id, original_index
        )
        if self._fault_injector is not None:
            self._fault_injector.intercept("worker_launch")
        self._launch(worker_id, original_index)
        return worker_id

    def remove_worker(self, worker_id):
        """Kill a worker; its exit relaunches it like any failure."""
        logger.info("Removing worker %d", worker_id)
        self._kill(worker_id)

    def all_workers_failed(self):
        with self._lock:
            if not self._workers:
                return False
            return all(
                r.phase in ("Failed", "Deleted")
                for r in self._workers.values()
            )

    def stop(self):
        with self._lock:
            self._stopping = True
            ids = list(self._workers)
        for worker_id in ids:
            try:
                self._kill(worker_id)
            except Exception:
                logger.warning("killing worker %d failed", worker_id,
                               exc_info=True)

    # event handling -----------------------------------------------------

    def _handle_worker_exit(
        self, worker_id, *, succeeded, exit_code=None, oom=False,
        deleted=False,
    ):
        """One dead worker: recover its tasks, decide on a relaunch."""
        if self._fault_injector is not None:
            self._fault_injector.intercept("worker_exit")
        with self._lock:
            record = self._workers.get(worker_id)
            if self._stopping or record is None or record.phase in (
                "Succeeded", "Failed", "Deleted",
            ):
                return
            record.exit_code = exit_code
            if succeeded:
                record.phase = "Succeeded"
                return
            record.phase = "Deleted" if deleted else "Failed"
            preempted = (
                exit_code == _EXIT_PREEMPTED and not oom
            ) or deleted
            relaunch = self._max_relaunch > 0 and (
                preempted or record.relaunch_count < self._max_relaunch
            )
            original_index = record.original_index
            relaunch_count = (
                record.relaunch_count
                if preempted
                else record.relaunch_count + 1
            )
        self._task_d.recover_tasks(worker_id)
        if relaunch:
            logger.info(
                "Relaunching worker %d (slot %d, relaunches used %d/%d%s)",
                worker_id, original_index, relaunch_count,
                self._max_relaunch,
                ", preempted" if preempted else "",
            )
            self._start_worker(
                original_index, relaunch_count=relaunch_count
            )
        else:
            logger.info("Worker %d will not be relaunched", worker_id)

    def worker_phase(self, worker_id):
        with self._lock:
            record = self._workers.get(worker_id)
            return record.phase if record else None

    def workers(self):
        """{worker_id: (slot, phase, relaunches used, launch time, exit
        code)} of every worker launched so far."""
        with self._lock:
            return {wid: (r.original_index, r.phase, r.relaunch_count,
                          r.launch_time, r.exit_code)
                    for wid, r in self._workers.items()}


class LocalInstanceManager(InstanceManagerBase):
    """Workers are local subprocesses running
    `python -m elasticdl_tpu_torch.worker.main` (the no-cluster elastic
    path). `env` is the workers' environment (default: this process's,
    with the package's root put first on PYTHONPATH); `log_dir`, when
    set, takes each worker's output as worker-<id>.log."""

    def __init__(
        self,
        task_d,
        *,
        num_workers,
        worker_args,
        relaunch_on_worker_failure=3,
        disable_relaunch=False,
        env=None,
        log_dir=None,
    ):
        super().__init__(
            task_d,
            num_workers,
            relaunch_on_worker_failure=relaunch_on_worker_failure,
            disable_relaunch=disable_relaunch,
        )
        self._worker_args = list(worker_args)
        self._procs = {}
        if env is None:
            env = dict(os.environ)
            env["PYTHONPATH"] = os.pathsep.join(
                p for p in (_PACKAGE_ROOT, env.get("PYTHONPATH")) if p)
        self._env = env
        self._log_dir = log_dir

    def _launch(self, worker_id, original_index):
        cmd = (
            [sys.executable, "-m", "elasticdl_tpu_torch.worker.main"]
            + self._worker_args
            + ["--worker_id", str(worker_id)]
        )
        out = None
        if self._log_dir:
            os.makedirs(self._log_dir, exist_ok=True)
            out = open(os.path.join(self._log_dir,
                                    "worker-%d.log" % worker_id), "w")
        try:
            proc = subprocess.Popen(
                cmd, env=self._env, stdout=out,
                stderr=subprocess.STDOUT if out else None)
        finally:
            if out is not None:
                out.close()  # the child holds its own descriptor
        with self._lock:
            self._procs[worker_id] = proc
        threading.Thread(
            target=self._wait_proc,
            args=(worker_id, proc),
            daemon=True,
        ).start()

    def _wait_proc(self, worker_id, proc):
        code = proc.wait()
        if code == 0:
            self._handle_worker_exit(worker_id, succeeded=True,
                                     exit_code=0)
        else:
            self._handle_worker_exit(
                worker_id,
                succeeded=False,
                exit_code=(
                    _EXIT_PREEMPTED if code == -9 else code
                ),
            )

    def _kill(self, worker_id):
        with self._lock:
            proc = self._procs.get(worker_id)
        if proc is not None and proc.poll() is None:
            proc.kill()

    def stop(self, timeout=10.0):
        """Kill every worker and reap them, waiting at most `timeout`
        seconds."""
        super().stop()
        self.wait_all(timeout)

    def wait_all(self, timeout):
        """Wait up to `timeout` seconds for every worker process to exit;
        True when all have."""
        deadline = time.monotonic() + timeout
        with self._lock:
            procs = list(self._procs.values())
        for proc in procs:
            try:
                proc.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                return False
        return True
