"""The port's router tier as processes on localhost (CPU): `router_main
--cells 2` with a CellFront in front and a cell SIGKILLed, `--rollout`
over two replicas and tiny checkpoints (a commit, then a torn abort),
and `--autoscale` spawning a `--device cpu` replica, adopting it and
draining it. Every router-side process is checked, through its memory
map, to have loaded no torch, jax or grpc library; the modules import
none either. Every wait is bounded and every child killed in a finally.
"""

import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest
import torch

from elasticdl_tpu_torch.checkpoint.saver import (
    CheckpointSaver,
    params_tree,
    params_tree_leaves,
)
from elasticdl_tpu_torch.convert import flax_param_path
from elasticdl_tpu_torch.model_zoo.transformer_lm import TransformerLM
from elasticdl_tpu_torch.proto import messages as pb
from elasticdl_tpu_torch.proto import service
from elasticdl_tpu_torch.serving import main as serving_main
from elasticdl_tpu_torch.serving.router_cell import CellFront

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=256, seq_len=128, embed_dim=32, num_heads=2,
           num_layers=2)
PARAMS = "; ".join("%s=%r" % kv for kv in CFG.items())
BLOCK = 4
WAIT = 120  # seconds: every wait in this file is bounded by it
REPLICA_FLAGS = ["--device", "cpu", "--model_params", PARAMS, "--kv_paged",
                 "1", "--kv_block_size", str(BLOCK), "--port", "0"]
ROUTER_FLAGS = ["--poll_secs", "0.1", "--affinity_block_tokens", str(BLOCK)]


def wait_for(cond, what, secs=WAIT):
    deadline = time.monotonic() + secs
    while True:
        got = cond()
        if got:
            return got
        assert time.monotonic() < deadline, "timed out waiting for " + what
        time.sleep(0.02)


class Child(object):
    """A router_main process; its output lines are collected."""

    def __init__(self, argv):
        env = dict(os.environ, PYTHONPATH=REPO)
        env.pop("EDL_FAULT_SPEC", None)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "elasticdl_tpu_torch.serving.router_main"]
            + argv, cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self.lines = []
        self._reader = threading.Thread(target=lambda: self.lines.extend(
            iter(self.proc.stdout.readline, "")), daemon=True)
        self._reader.start()

    def line(self, prefix):
        hit = wait_for(lambda: [x for x in list(self.lines)
                                if x.startswith(prefix)]
                       or self.proc.poll() is not None, prefix)
        assert hit is not True and self.proc.poll() is None, "".join(
            self.lines)[-3000:]
        return hit[0]

    def port(self):
        # the digits only: a log line of another thread may follow them
        return int(re.match(r"\d+", self.line("ROUTER_READY").split(
            "port=")[1]).group())

    def stop(self):
        self.proc.send_signal(signal.SIGTERM)
        assert self.proc.wait(timeout=WAIT) == 0, "".join(self.lines)[-3000:]

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=WAIT)
        self._reader.join(timeout=WAIT)
        self.proc.stdout.close()


def loads_no_device_library(pid):
    """True when the process maps no torch, jaxlib or grpc library."""
    with open("/proc/%d/maps" % pid) as f:
        maps = f.read()
    return not any(name in maps for name in ("/torch/", "libtorch",
                                             "jaxlib", "grpc"))


def _children(pid):
    out = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open("/proc/%s/stat" % name) as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open("/proc/%s/cmdline" % name, "rb") as f:
                argv = f.read().split(b"\0")
        except (OSError, ValueError, IndexError):
            continue
        if ppid == pid and b"--cell_id" in argv:
            out[int(argv[argv.index(b"--cell_id") + 1])] = int(name)
    return out


def _router_stub(port):
    return service.RouterStub(service.build_channel("localhost:%d" % port))


def _status(port):
    try:
        return _router_stub(port).router_status(pb.RouterStatusRequest(),
                                                timeout=5)
    except service.RpcError:
        return None


def _free_base(n):
    """A port p with p .. p+n-1 free on localhost."""
    for _ in range(50):
        with socket.socket() as s:
            s.bind(("localhost", 0))
            base = s.getsockname()[1]
        if base + n > 65535:
            continue
        try:
            socks = []
            for p in range(base, base + n):
                socks.append(socket.socket())
                socks[-1].bind(("localhost", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise AssertionError("no %d consecutive free ports" % n)


def _replica(ckpt=""):
    flags = REPLICA_FLAGS + (["--checkpoint_dir", ckpt,
                              "--reload_poll_secs", "0"] if ckpt else [])
    return serving_main.build_server(serving_main.parse_serving_args(
        flags)).start(transport=True)


def _gen(call, prompt):
    """The tokens `call` (a stub's or a CellFront's unary method)
    answers for `prompt`."""
    return list(call(pb.GenerateRequest(prompt=prompt, max_new_tokens=4),
                     timeout=WAIT).tokens)


@pytest.fixture(scope="module")
def fleet():
    servers = [_replica() for _ in range(2)]
    yield servers
    for s in servers:
        s.stop(timeout=WAIT)


def _addrs(servers):
    return ["localhost:%d" % s.port for s in servers]


def test_modules_import_no_device_library():
    code = ("import sys\n"
            "import elasticdl_tpu_torch.serving.router_cell\n"
            "import elasticdl_tpu_torch.serving.rollout\n"
            "import elasticdl_tpu_torch.serving.autoscaler\n"
            "print(sorted(m for m in ('torch', 'jax', 'grpc') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=WAIT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_cells_survive_a_killed_cell(fleet, tmp_path):
    base = _free_base(2)
    journal = str(tmp_path / "cells")
    argv = ["--cells", "2", "--port", str(base), "--cell_journal_dir",
            journal] + ROUTER_FLAGS
    for addr in _addrs(fleet):
        argv += ["--replica", addr]
    sup, third, front = Child(argv), None, None
    try:
        sup.line("ROUTER_CELLS_READY")
        cells = ["localhost:%d" % (base + i) for i in range(2)]
        for port in (base, base + 1):
            wait_for(lambda p=port: (_status(p) or pb.RouterStatusResponse())
                     .healthy == 2, "cell on %d" % port)
        pids = wait_for(lambda: len(_children(sup.proc.pid)) == 2
                        and _children(sup.proc.pid), "two cell processes")
        for pid in [sup.proc.pid] + list(pids.values()):
            assert loads_no_device_library(pid), pid
        front = CellFront(cells, block_tokens=BLOCK, reroute_window_secs=30)
        direct = service.ServingStub(service.build_channel(
            _addrs(fleet)[0]))
        prompts = [[7] * 16 + [k] for k in range(4)] + [
            [k, k + 1, k + 2] for k in range(8)]
        want = [_gen(direct.generate, p) for p in prompts]
        assert [_gen(front.generate, p) for p in prompts] == want
        assert front.counters["rerouted"] == 0
        os.kill(pids[0], signal.SIGKILL)
        assert [_gen(front.generate, p) for p in prompts] == want
        assert front.counters["rerouted"] >= 1
        assert front.counters["cell_failures"] >= 1
        # the supervisor restarts cell 0, which replays the journal
        st = wait_for(lambda: (lambda s: s if s and s.replicas == 2
                               and s.cell_restarts >= 1 else None)(
            _status(base)), "cell 0 restarted")
        assert st.journal_replayed > 0 and st.cell_id == 0
        assert _children(sup.proc.pid)[0] != pids[0]
        # a cell started with no --replica learns the fleet from disk
        third = Child(["--cell_id", "2", "--cells", "3", "--port", "0",
                       "--cell_journal_dir", journal] + ROUTER_FLAGS)
        st = _status(third.port())
        assert (st.replicas, st.cell_id, st.cells) == (2, 2, 3)
        assert sorted(r.address for r in st.replica) == sorted(
            _addrs(fleet))
        assert "ROUTER_CELL cell=2 cells=3\n" in third.lines
        third.stop()
        sup.stop()
        assert not _children(sup.proc.pid)
    finally:
        if front is not None:
            front.close()
        for child in (third, sup):
            if child is not None:
                child.close()


def _save(model, ckpt, version):
    flat = params_tree_leaves(params_tree(dict(model.named_parameters()),
                                          flax_param_path))
    CheckpointSaver(None, ckpt, num_shards=2).save_flat(flat, version)


def _events(journal):
    path = os.path.join(journal, "journal.jsonl")
    with open(path) as f:
        return [json.loads(x) for x in f if x.strip()]


def test_rollout_commits_then_aborts_a_torn_version(tmp_path):
    ckpt, journal = str(tmp_path / "ck"), str(tmp_path / "roll")
    _save(TransformerLM(device="cpu", seed=0, **CFG), ckpt, 1)
    servers = [_replica(ckpt) for _ in range(2)]
    router = None
    try:
        assert [s.model_version for s in servers] == [1, 1]
        # version 2 republishes version 1's bytes; version 3 is torn
        for v in (2, 3):
            shutil.copytree(os.path.join(ckpt, "version-1"),
                            os.path.join(ckpt, "version-%d" % v))
        os.remove(os.path.join(ckpt, "version-3", "variables-1-of-2.ckpt"))
        for target, phase in ((2, "committed"), (3, "aborted")):
            router = Child(
                ["--port", "0", "--rollout", str(target),
                 "--rollout_journal_dir", journal, "--rollout_checkpoint_dir",
                 ckpt, "--rollout_soak_secs", "0.2",
                 "--rollout_parity_prompts", "1,2,3;4,5"] + ROUTER_FLAGS
                + sum((["--replica", a] for a in _addrs(servers)), []))
            port = router.port()
            # the journal's last rollout shows until this one begins
            st = wait_for(lambda: (lambda s: s if s and s.rollout.phase in (
                "committed", "rolled_back", "aborted")
                and s.rollout.target_version == target else None)(
                _status(port)), "rollout to version %d" % target)
            assert loads_no_device_library(router.proc.pid)
            assert st.rollout.phase == phase, st.rollout
            assert st.rollout.target_version == target
            router.stop()
            router.close()
            router = None
        events = _events(journal)
        swaps = [(e["addr"], e["to"]) for e in events
                 if e["ev"] == "swap_start"]
        assert sorted(swaps) == sorted((a, 2) for a in _addrs(servers))
        assert [s.model_version for s in servers] == [2, 2]
        assert [s.scheduler.reloads for s in servers] == [1, 1]
        assert "verification" in st.rollout.last_error
    finally:
        if router is not None:
            router.close()
        for s in servers:
            s.stop(timeout=WAIT)


def test_autoscale_spawns_adopts_and_drains_a_replica(tmp_path):
    journal = str(tmp_path / "fleet")
    reference = _replica()
    router = None
    try:
        router = Child(["--port", "0", "--autoscale", "--min_replicas", "1",
                        "--max_replicas", "1", "--journal_dir", journal,
                        "--replica_args", " ".join(
                            REPLICA_FLAGS[:3] + ["'%s'" % PARAMS]
                            + REPLICA_FLAGS[4:] + ["--warmup_tokens", "2"])]
                       + ROUTER_FLAGS)
        port = router.port()
        st = wait_for(lambda: (lambda s: s if s and s.autoscaler.live == 1
                               and s.healthy == 1 else None)(_status(port)),
                      "an adopted replica")
        assert (st.autoscaler.target, st.autoscaler.starting) == (1, 0)
        launched = [e for e in _events(journal) if e["ev"] == "launched"]
        assert len(launched) == 1
        replica_pid = launched[0]["pid"]
        assert loads_no_device_library(router.proc.pid)
        assert not loads_no_device_library(replica_pid)  # the check bites
        direct = service.ServingStub(service.build_channel(
            "localhost:%d" % reference.port))
        for prompt in ([1, 2, 3], [9] * 12):
            assert (_gen(_router_stub(port).router_generate, prompt)
                    == _gen(direct.generate, prompt))
        router.stop()  # the supervisor drains its replica first
        assert wait_for(lambda: not os.path.exists("/proc/%d" % replica_pid)
                        or open("/proc/%d/stat" % replica_pid).read().split(
                            ")")[-1].split()[0] == "Z", "the replica's exit")
        kinds = [e["ev"] for e in _events(journal)]
        assert kinds[-1] == "retire" and "adopt" in kinds
        assert any("ROUTER_READY" in x for x in router.lines)
    finally:
        if router is not None:
            router.close()
        reference.stop(timeout=WAIT)
