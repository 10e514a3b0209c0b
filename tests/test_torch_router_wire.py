"""The port's router on its transport, in front of tiny port replicas on
localhost (CPU), and its entry point.

* routed unary and streamed answers equal a direct replica's tokens;
  router_status round-trips over the wire; an injected fault at the
  router boundary answers its code;
* a replica stopped mid-run: a request that had not started is
  re-dispatched to the survivor, a stream past its first chunk fails
  with UNAVAILABLE after the chunks it delivered;
* each server answers only its own table (UNIMPLEMENTED otherwise);
* the entry: the JAX parser's defaults and its results for the cell,
  supervisor and rollout flags (and what each builds), the metrics
  port's and the TensorBoard writer's flags parsing as JAX's, an import
  that loads
  neither torch nor jax, and
  `python -m elasticdl_tpu_torch.serving.router_main` as a process
  (ROUTER_READY, routed calls, exit 0 on SIGTERM).
"""

import os
import signal
import subprocess
import sys
import threading
import time

import pytest
import torch

from elasticdl_tpu.serving import router_main as jrouter_main
from elasticdl_tpu_torch.common.fault_injection import FaultInjector
from elasticdl_tpu_torch.model_zoo.transformer_lm import TransformerLM
from elasticdl_tpu_torch.proto import messages as pb
from elasticdl_tpu_torch.proto import service
from elasticdl_tpu_torch.serving import router_main
from elasticdl_tpu_torch.serving.router import Router, RouterConfig
from elasticdl_tpu_torch.serving.server import GenerationServer, ServingConfig

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=256, seq_len=128, embed_dim=32, num_heads=2,
           num_layers=2)
BLOCK = 4
WAIT = 60  # seconds: every wait in this file is bounded by it
PROMPTS = [list(range(40, 52)) + [1, 2], list(range(40, 52)) + [3],
           [9, 8, 7], list(range(100, 121))]


def _replica(model, **cfg):
    base = dict(num_slots=4, kv_paged=True, kv_block_size=BLOCK,
                kv_shared=True, port=0)
    base.update(cfg)
    return GenerationServer(model, ServingConfig(**base)).start(
        transport=True)


def _stub(cls, port):
    return cls(service.build_channel("localhost:%d" % port))


def code_of(fn):
    try:
        fn()
    except service.RpcError as e:
        return e.code()
    raise AssertionError("the call did not fail")


def wait_for(cond, what):
    deadline = time.monotonic() + WAIT
    while not cond():
        assert time.monotonic() < deadline, "timed out waiting for " + what
        time.sleep(0.005)


@pytest.fixture(scope="module")
def fleet():
    """Two port replicas over the same seeded weights."""
    model = TransformerLM(device="cpu", seed=0, **CFG)
    servers = [_replica(model) for _ in range(2)]
    yield servers
    for s in servers:
        s.stop(timeout=WAIT)


def _router(addrs, injector=None, **cfg):
    knobs = dict(poll_secs=0.05, affinity_block_tokens=BLOCK, port=0)
    knobs.update(cfg)
    return Router(addrs, RouterConfig(**knobs)).start(injector=injector)


def _addrs(servers):
    return ["localhost:%d" % s.port for s in servers]


def test_routed_answers_equal_a_direct_replica(fleet):
    direct = _stub(service.ServingStub, fleet[0].port)
    router = _router(_addrs(fleet), injector=FaultInjector(
        spec="router_status:drop:1"))
    try:
        stub = _stub(service.RouterStub, router.port)
        assert code_of(lambda: stub.router_status(
            pb.RouterStatusRequest(), timeout=WAIT)) == "UNAVAILABLE"
        for prompt in PROMPTS * 2:
            req = pb.GenerateRequest(prompt=prompt, max_new_tokens=6)
            want = list(direct.generate(req, timeout=WAIT).tokens)
            assert list(stub.router_generate(req, timeout=WAIT).tokens) \
                == want
            chunks = list(stub.router_generate_stream(req, timeout=WAIT))
            assert chunks[-1].done
            assert prompt + [t for c in chunks for t in c.tokens] == want
        wait_for(lambda: router.poll_once() == 2, "two healthy replicas")
        got = stub.router_status(pb.RouterStatusRequest(), timeout=WAIT)
        back = pb.RouterStatusResponse.FromString(got.SerializeToString())
        assert back == got
        local = router.status_response()
        n = 2 * len(PROMPTS) * 2
        for name in ("replicas", "healthy", "routed", "completed",
                     "affinity_hits", "affinity_misses", "shed",
                     "redispatched", "ttft_p50_ms", "ttft_p99_ms"):
            assert getattr(got, name) == getattr(local, name), name
        assert (got.replicas, got.healthy, got.routed, got.completed) == (
            2, 2, n, n)
        assert got.affinity_hits + got.affinity_misses == n - 4
        assert [r.address for r in got.replica] == sorted(_addrs(fleet))
        assert all(r.breaker == "closed" and r.role == "unified"
                   and r.kv_blocks_free > 0 for r in got.replica)
        assert [s.name for s in got.slo] == ["ttft_p99", "e2e_p99",
                                             "goodput"]
        assert not got.HasField("autoscaler") and got.rollout is None
        assert got.e2e_p99_ms > 0 and got.ttft_p99_ms > 0
    finally:
        router.stop()


def test_each_server_answers_only_its_own_table(fleet):
    router = _router(_addrs(fleet))
    try:
        for port, path in ((fleet[0].port,
                            "/elasticdl_tpu.Router/router_status"),
                           (router.port,
                            "/elasticdl_tpu.Serving/server_status")):
            assert code_of(lambda: service.Channel(
                "localhost:%d" % port).call(path, b"", timeout=WAIT)) \
                == "UNIMPLEMENTED"
    finally:
        router.stop()


def _slow(server, secs):
    engine = server.engine
    step = type(engine).step.__get__(engine)

    def slow():
        time.sleep(secs)
        return step()

    engine.step = slow


def test_a_stopped_replica_redispatches_unstarted_and_fails_started():
    model = TransformerLM(device="cpu", seed=0, **CFG)
    servers = [_replica(model) for _ in range(2)]
    for s in servers:
        _slow(s, 0.02)
    # one sweep at start: equal polled loads, so ties go by address
    router = _router(_addrs(servers), poll_secs=1000.0, lease_secs=600.0)
    try:
        wait_for(lambda: router.telemetry.snapshot()["polls"] == 1,
                 "the first sweep")
        stub = _stub(service.RouterStub, router.port)
        first = min(_addrs(servers))
        victim = servers[_addrs(servers).index(first)]
        survivor = servers[1 - servers.index(victim)]
        stream = iter(stub.router_generate_stream(pb.GenerateRequest(
            prompt=PROMPTS[0], max_new_tokens=60), timeout=WAIT))
        got = list(next(stream).tokens)
        victim.stop(drain=False, grace=0.5)
        with pytest.raises(service.RpcError) as err:
            for chunk in stream:
                got.extend(chunk.tokens)
        assert err.value.code() == "UNAVAILABLE"
        assert "mid-stream" in err.value.details() and 1 <= len(got) < 60
        req = pb.GenerateRequest(prompt=PROMPTS[3], max_new_tokens=5)
        routed = list(stub.router_generate(req, timeout=WAIT).tokens)
        want = list(_stub(service.ServingStub, survivor.port).generate(
            req, timeout=WAIT).tokens)
        assert routed == want
        st = router.status_response()
        assert (st.routed, st.completed, st.redispatched, st.shed) == (
            2, 1, 1, 0)
        by = {r.address: r for r in st.replica}
        assert by[first].failures == 2 and by[first].breaker == "closed"
    finally:
        router.stop()
        for s in servers:
            s.stop(drain=False, timeout=WAIT)


# ---------------------------------------------------------------- entry


def test_parser_defaults_equal_jax():
    argv = ["--replica", "localhost:1", "--replica", "localhost:2"]
    assert vars(router_main.parse_router_args(argv)) == vars(
        jrouter_main.parse_router_args(argv))
    with pytest.raises(SystemExit):
        router_main.parse_router_args([])


@pytest.mark.parametrize("flags,item", [
    (["--metrics_port", "0"], "item 6"),
    (["--tensorboard_log_dir", "tb"], "item 6")])
def test_unported_flags_raise_naming_their_item(flags, item):
    # both of item 6's flags are ported (the metrics plane, the
    # TensorBoard writer): each parses as JAX's does
    del item
    argv = ["--replica", "localhost:1"] + flags
    assert vars(router_main.parse_router_args(argv)) == vars(
        jrouter_main.parse_router_args(argv))


ITEM4_FLAGS = {
    "cells": ["--replica", "localhost:1", "--cells", "2",
              "--cell_journal_dir", "{d}/cells", "--port", "7000"],
    "cell_id": ["--replica", "localhost:1", "--cell_id", "0",
                "--cells", "2", "--cell_journal_dir", "{d}/cells"],
    "journal_only": ["--cell_journal_dir", "{d}/cells", "--cell_id", "1"],
    "autoscale": ["--autoscale", "--replica_args", "--port 0 --device cpu",
                  "--journal_dir", "{d}/fleet"],
    "autoscale_knobs": ["--autoscale", "--replica_args", "--port 0",
                        "--journal_dir", "{d}/fleet", "--min_replicas", "2",
                        "--max_replicas", "8", "--decide_secs", "0.25",
                        "--up_queue_wait_ms", "50", "--up_window_secs", "1",
                        "--down_window_secs", "3",
                        "--scale_cooldown_secs", "2", "--max_restarts", "5"],
    "rollout": ["--replica", "localhost:1", "--rollout", "3",
                "--rollout_journal_dir", "{d}/roll",
                "--rollout_checkpoint_dir", "{d}/ck"],
    "rollout_knobs": ["--replica", "localhost:1", "--rollout_journal_dir",
                      "{d}/roll", "--rollout_wave_size", "2",
                      "--rollout_soak_secs", "1", "--rollout_parity_prompts",
                      "4,5;6", "--rollout_judge_timeout_secs", "9"],
    "rollout_needs_ckpt": ["--replica", "localhost:1", "--rollout", "3",
                           "--rollout_journal_dir", "d"],
    "autoscale_needs_args": ["--autoscale"],
}


def _built(mod, args):
    """(the controllers' settings, stop) for what `mod`'s router_main
    builds from `args`, started nowhere."""
    router = mod.build_router(args)
    out, stops = {"router": type(router).__name__}, [router.stop]
    if args.cells > 1:
        out["cell_argv"] = mod._cell_child_argv(args, 1)[3:]
    if args.autoscale:
        sup = mod.build_supervisor(args, router)
        out["autoscaler"] = vars(sup.config)
        stops.insert(0, sup.stop)
    if args.rollout_journal_dir:
        from importlib import import_module

        ctl = import_module(mod.__name__.replace(
            "router_main", "rollout")).build_rollout(args, router)
        out["rollout"] = vars(ctl.config)
        stops.insert(0, ctl.stop)
    for stop in stops:
        stop()
    return out


@pytest.mark.parametrize("case", sorted(ITEM4_FLAGS))
def test_item4_flags_parse_as_jax_and_build(tmp_path, case):
    argv = [a.format(d=tmp_path) for a in ITEM4_FLAGS[case]]
    if case.endswith(("needs_ckpt", "needs_args")):
        for mod in (jrouter_main, router_main):
            with pytest.raises(SystemExit):
                mod.parse_router_args(argv)
        return
    args = router_main.parse_router_args(argv)
    assert vars(args) == vars(jrouter_main.parse_router_args(argv))
    want = _built(jrouter_main, jrouter_main.parse_router_args(argv))
    got = _built(router_main, args)
    assert got == want
    assert got["router"] == ("RouterCell" if "--cell_journal_dir" in argv
                             else "Router")


def test_router_main_imports_neither_torch_nor_jax():
    code = ("import sys, elasticdl_tpu_torch.serving.router_main; "
            "print(sorted(m for m in ('torch', 'jax', 'grpc') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=WAIT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_router_main_serves_and_stops_on_sigterm(fleet):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("EDL_FAULT_SPEC", None)
    argv = [sys.executable, "-m", "elasticdl_tpu_torch.serving.router_main",
            "--port", "0", "--affinity_block_tokens", str(BLOCK)]
    for addr in _addrs(fleet):
        argv += ["--replica", addr]
    proc = subprocess.Popen(argv, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    out, err = [], []
    readers = [threading.Thread(target=lambda p=p, l=l: l.extend(
        iter(p.readline, "")), daemon=True)
        for p, l in ((proc.stdout, out), (proc.stderr, err))]
    for t in readers:
        t.start()
    try:
        wait_for(lambda: any(l.startswith("ROUTER_READY") for l in out)
                 or proc.poll() is not None, "ROUTER_READY")
        ready = [l for l in out if l.startswith("ROUTER_READY")]
        assert ready, "".join(err)
        stub = _stub(service.RouterStub, int(ready[0].split("port=")[1]))
        req = pb.GenerateRequest(prompt=PROMPTS[1], max_new_tokens=4)
        want = list(_stub(service.ServingStub, fleet[1].port).generate(
            req, timeout=WAIT).tokens)
        assert list(stub.router_generate(req, timeout=WAIT).tokens) == want
        st = stub.router_status(pb.RouterStatusRequest(), timeout=WAIT)
        assert (st.replicas, st.routed, st.completed) == (2, 1, 1)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=WAIT) == 0, "".join(err)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=WAIT)
        for t in readers:
            t.join(timeout=WAIT)
        proc.stdout.close()
        proc.stderr.close()
