"""The rest of the port's router tier against the JAX package's (no
sockets: fake clocks, fake replica and cell stubs, a fake launcher; the
processes are in tests/test_torch_router_tier_wire.py).

Each scenario runs the same script through the JAX objects and the
port's, each over its own on-disk journal, and the two traces are held
equal step by step: every decision, roster and seat state, journal event
(the files themselves) and status block.

* cells: CellRegistryJournal learn / propagate / compact / resync, lease
  beacons, the cell block, the `cell_kill` hook; CellFront's ring,
  reroute, breakers, backpressure and stream rules;
* rollout: the verdicts, a healthy commit, a torn abort, parity / burn /
  timeout rollbacks, a wave alert, and resumes mid-canary / mid-wave /
  mid-rollback;
* supervisor: spawn to min, scaling with windows, cooldown and KV
  headroom, drains, crash replacement, backoff and circuit, the lease
  and stalled wedge paths, the three hooks, recovery and compaction.

The port's journals then go through the JAX PROTOCOL declarations
(analysis/protocol_testgen's validation, coverage, crash-point and
double-replay batteries), and each package replays the other's journal
to the same state.
"""

import json
import os
import random
import re

import numpy as np
import pytest
from test_torch_router import FakeClock, FakeReplicaStub, Side, _normalize

from elasticdl_tpu.analysis import protocol_testgen as ptg
from elasticdl_tpu.checkpoint import CheckpointSaver
from elasticdl_tpu.serving import autoscaler as jauto
from elasticdl_tpu.serving import rollout as jroll
from elasticdl_tpu.serving import router_cell as jcell
from elasticdl_tpu_torch.common import fault_injection as pfault
from elasticdl_tpu_torch.proto import messages as pb
from elasticdl_tpu_torch.serving import autoscaler as pauto
from elasticdl_tpu_torch.serving import rollout as proll
from elasticdl_tpu_torch.serving import router_cell as pcell

SIDES = ("jax", "port")


class Tier(Side):
    def __init__(self, name):
        Side.__init__(self, name)
        self.cell, self.roll, self.auto = ((jcell, jroll, jauto)
                                           if name == "jax" else
                                           (pcell, proll, pauto))


def _files(d):
    """The journal dir's journal events and snapshot, read raw."""
    out = {"events": [], "snapshot": None}
    path = os.path.join(str(d), "journal.jsonl")
    if os.path.exists(path):
        with open(path) as f:
            out["events"] = [json.loads(x) for x in f if x.strip()]
    path = os.path.join(str(d), "snapshot.json")
    if os.path.exists(path):
        with open(path) as f:
            out["snapshot"] = json.load(f)
    return out


def _run_both(fn, tmp_path, *args):
    """fn(Tier, dir, *args) for each package in its own dir, with the
    jitter seeded alike; the traces with each dir's path scrubbed."""
    traces = []
    for name in SIDES:
        random.seed(1234)
        d = tmp_path / name
        d.mkdir(parents=True)
        text = json.dumps(fn(Tier(name), d, *args), default=repr)
        # an injected error's repr is each package's own
        text = re.sub(r"InjectedRpcError\([^)]*\)", "InjectedRpcError",
                      text.replace(str(d), "DIR"))
        traces.append(json.loads(text))
    return traces


def _assert_equal(traces):
    want, got = traces
    assert [t[0] for t in got] == [t[0] for t in want]
    for g, w in zip(got, want):
        assert g == w, g[0]


# ------------------------------------------------------------ the cells


def _cell(t, d, seeds=(), cell_id=0, stubs=None):
    clock = FakeClock()
    stubs = {} if stubs is None else stubs

    def factory(addr):
        if addr not in stubs:
            stubs[addr] = FakeReplicaStub(t, 100 * (len(stubs) + 1))
        return stubs[addr]

    cfg = t.mod.RouterConfig(
        lease_secs=10.0, breaker_threshold=2, breaker_cooldown_secs=5.0,
        redispatch_window_secs=8.0, base_delay_secs=0.01,
        max_delay_secs=0.05, poll_secs=1000.0, cell_id=cell_id, cells=2)
    return t.cell.RouterCell(list(seeds), config=cfg, journal_dir=str(d),
                             stub_factory=factory, clock=clock,
                             sleep=clock.advance,
                             telemetry=t.telemetry(clock))


CELL_BLOCK = ("cell_id", "cells", "journal_events", "journal_replayed",
              "cell_restarts", "replicas")


def sc_cell_registry(t, d):
    tr = []

    def view(label, *cells):
        tr.append((label, [sorted(r.address for r in c.replicas())
                           for c in cells],
                   [(c._journal.appends, c._journal.replayed,
                     c._journal.resyncs, c._journal.restarts)
                    for c in cells]))

    c0 = _cell(t, d, ["rep0", "rep1", "rep2"])
    c1 = _cell(t, d, cell_id=1)
    view("learned", c0, c1)
    c0.add_replica("rep9")
    view("before tick", c0, c1)
    c1.poll_once()
    view("after tick", c0, c1)
    c0.remove_replica("rep9")
    c0.add_replica("rep1")  # known: not journaled
    c1.remove_replica("nope")  # unknown: not journaled
    c1.poll_once()
    c0.poll_once()  # its own appends are never replayed back
    view("retired", c0, c1)
    c0._journal._store.snapshot_every = 4
    for i in range(3):
        c0.add_replica("x%d" % i)
        c0.remove_replica("x%d" % i)
    tr.append(("journal", c0._journal._pending_compact, _files(d)))
    tr.append(("compact", c0._journal.compact_at_tick(),
               c0._journal.compact_at_tick(), _files(d)))
    c1.poll_once()  # the journal shrank under c1's offset: a resync
    view("resync", c0, c1)
    for _ in range(9):
        c0.poll_once()  # the 8th tick journals a lease beacon
    tr.append(("beacons", _files(d)))
    for c in (c0, c1):
        st = c.status_response()
        tr.append(("status", [getattr(st, f) for f in CELL_BLOCK]))
        c.stop()
    c2 = _cell(t, d)  # a restart over the state: the fleet from disk
    view("restarted", c2)
    st = c2.status_response()
    tr.append(("status", [getattr(st, f) for f in CELL_BLOCK]))
    c2.stop()
    return tr


def sc_cell_kill_hook(t, d):
    kills = []
    inj = t.fault.FaultInjector(spec="cell_kill:kill:1:skip=2",
                                kill_fn=lambda: kills.append(1))
    c0 = _cell(t, d, ["rep0"])
    t.start(c0, injector=inj)  # the first sweep is the first tick
    try:
        out = []
        for _ in range(3):
            c0.poll_once()
            out.append(len(kills))
        return [("kills", out, inj.injected)]
    finally:
        c0.stop()


def test_cells_match_jax(tmp_path):
    for sc in (sc_cell_kill_hook, sc_torn_tail, sc_cell_registry):
        traces = _run_both(sc, tmp_path / sc.__name__)
        _assert_equal(traces)
        if sc is sc_torn_tail:
            assert traces[1][1][1] == ["rep0", "rep7"]
    by = dict((x[0], x[1:]) for x in traces[1])
    assert by["learned"][0] == [["rep0", "rep1", "rep2"]] * 2
    assert by["after tick"][0][1] == ["rep0", "rep1", "rep2", "rep9"]
    assert by["resync"][1][1][2] == 1  # c1 resynced once
    assert by["restarted"][0] == [["rep0", "rep1", "rep2"]]


def sc_torn_tail(t, d):
    """A line torn by a writer killed mid-append: the tailer skips it,
    and the next append, concatenated onto it through an open handle,
    still reaches the tailer."""
    c0, c1 = _cell(t, d, ["rep0"]), _cell(t, d, cell_id=1)
    with open(os.path.join(str(d), "journal.jsonl"), "a") as f:
        f.write('{"op": "adopt", "address": "torn')
    tr = [("torn", c1.poll_once(), sorted(r.address for r in c1.replicas()))]
    c0.add_replica("rep7")
    c1.poll_once()
    tr.append(("next", sorted(r.address for r in c1.replicas())))
    c0.stop()
    c1.stop()
    return tr


class FakeCellStub(object):
    """A router cell's stub: scripted errors, streams that fail after n
    chunks, and the calls it saw."""

    def __init__(self, t, token):
        self.t, self.token = t, token
        self.errors, self.stream_errors = [], []
        self.fail_after = None
        self.calls, self.closed = [], 0

    def router_generate(self, request, timeout=None):
        self.calls.append("gen")
        if self.errors:
            raise self.errors.pop(0)
        return self.t.pb.GenerateResponse(tokens=[self.token])

    def router_generate_stream(self, request, timeout=None):
        self.calls.append("stream")
        if self.stream_errors:
            raise self.stream_errors.pop(0)
        fail_after, err, p = self.fail_after, self.t.err, self.t.pb

        def chunks():
            for i in range(3):
                if fail_after is not None and i >= fail_after:
                    raise err("UNAVAILABLE", "cell died")
                yield p.TokenChunk(tokens=[self.token + i])
            yield p.TokenChunk(done=True)

        return chunks()

    def router_status(self, request, timeout=None):
        self.calls.append("status")
        if self.errors:
            raise self.errors.pop(0)
        return self.t.pb.RouterStatusResponse(cell_id=self.token)

    def close(self):
        self.closed += 1


def sc_cell_front(t, _d):
    clock = FakeClock()
    cells = {"cell%d" % i: FakeCellStub(t, 10 * i) for i in range(3)}
    front = t.cell.CellFront(
        sorted(cells), stub_factory=lambda a: cells[a],
        reroute_window_secs=2.0, base_delay_secs=0.1, max_delay_secs=0.4,
        breaker_threshold=2, breaker_cooldown_secs=5.0, block_tokens=4,
        max_blocks=2, clock=clock, sleep=clock.advance)
    tr = []

    def call(label, fn, *args):
        try:
            out = fn(*args)
        except t.mod.RouterError as e:
            # the front's own words; a stub's error reads per package
            words = str(e).split(" ")
            out = ("err", e.code, " ".join(words[:4])
                   if words[0] in ("no", "cell") else "")
        tr.append((label, out, dict(front.counters),
                   {a: (s.calls[-3:], s.closed) for a, s in cells.items()},
                   {a: b.state for a, b in front._breakers.items()},
                   round(clock(), 6)))

    def gen(r):
        return list(front.generate(r).tokens)

    def stream(r):
        return [c.tokens[0] for c in front.generate_stream(r) if c.tokens]

    def req(prompt):
        return t.pb.GenerateRequest(prompt=list(prompt), max_new_tokens=3)

    shared = [req([7, 7, 7, 7, 1, 2, 3, 4, k]) for k in range(4)]
    for i, r in enumerate(shared):
        call("shared %d" % i, gen, r)  # one cell owns the family
    owner = max(cells, key=lambda a: len(cells[a].calls))
    for k in range(6):
        call("short %d" % k, gen, req([k, k + 1]))
    cells[owner].errors = [t.err("UNAVAILABLE") for _ in range(2)]
    call("reroute", gen, shared[0])
    call("breaker open", gen, shared[1])
    cells[owner].errors = [t.err("RESOURCE_EXHAUSTED")]
    clock.advance(6.0)
    call("backpressure", gen, shared[2])
    cells[owner].errors = [t.err("INVALID_ARGUMENT")]
    call("own fault", gen, shared[2])
    cells[owner].stream_errors = [t.err("UNAVAILABLE")]
    call("stream before first", stream, shared[3])
    cells[owner].fail_after = 1
    clock.advance(6.0)
    call("stream after first", stream, shared[3])
    cells[owner].fail_after = None
    for s in cells.values():
        s.errors = [t.err("UNAVAILABLE") for _ in range(50)]
    clock.advance(6.0)
    call("all down", gen, shared[0])
    for s in cells.values():
        s.errors = []
    clock.advance(6.0)
    call("status", lambda: front.status().cell_id)
    front.remove_cell(owner)
    call("removed", gen, shared[0])
    tr.append(("cells", front.cells()))
    front.close()
    tr.append(("closed", {a: s.closed for a, s in cells.items()}))
    return tr


def test_cell_front_matches_jax(tmp_path):
    traces = _run_both(sc_cell_front, tmp_path)
    _assert_equal(traces)
    by = {x[0]: x[1] for x in traces[1]}
    assert by["reroute"] != by["shared 0"]
    assert by["backpressure"][:2] == ["err", "RESOURCE_EXHAUSTED"]
    assert by["stream after first"][:2] == ["err", "UNAVAILABLE"]
    assert by["all down"][:2] == ["err", "UNAVAILABLE"]


# ---------------------------------------------------------- the rollout


OLD, NEW = 1, 2


class FakeReplica(object):
    def __init__(self, address):
        self.address = address
        self.model_version = OLD
        self.reload_failed = False
        self.inflight = 0


class FakeRolloutRouter(object):
    def __init__(self, addrs):
        self.fleet = {a: FakeReplica(a) for a in addrs}
        self.reports = []
        self.held = set()
        self.holds = []

    def replicas(self):
        return list(self.fleet.values())

    def slo_reports(self):
        return list(self.reports)

    def hold_replica(self, address):
        self.held.add(address)
        self.holds.append(address)

    def release_replica(self, address):
        self.held.discard(address)

    def held_replicas(self):
        return set(self.held)


def _report(fast=0.0, slow=0.0, fast_samples=10, alerting=False):
    return {"name": "ttft_p99", "fast_burn": fast, "slow_burn": slow,
            "fast_samples": fast_samples, "slow_samples": 10,
            "alerting": alerting}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ckpt"))
    saver = CheckpointSaver(d, checkpoint_steps=1, num_shards=2)
    for v in (NEW, 3):
        saver.save({"w": np.arange(8, dtype=np.float32) * v}, version=v)
    # version 3 torn: one shard short
    os.remove(os.path.join(d, "version-3", "variables-1-of-2.ckpt"))
    return d


class RolloutRig(object):
    def __init__(self, t, d, ckpt, poisoned=False, broken=False,
                 fail_addrs=(), router=None):
        self.t, self.d, self.ckpt = t, d, ckpt
        self.router = router or FakeRolloutRouter(("a:1", "b:1", "c:1"))
        self.poisoned, self.broken = poisoned, broken
        self.fail_addrs = fail_addrs
        self.calls = []
        self.lives = 0
        self.new_life()

    def new_life(self):
        self.clock = FakeClock(100.0)
        cfg = self.t.roll.RolloutConfig(
            checkpoint_dir=self.ckpt if not self.lives else "",
            journal_dir=str(self.d / "journal"), soak_secs=3.0,
            judge_timeout_secs=20.0, parity_prompts=((1, 2, 3), (4, 5)))
        self.lives += 1
        self.ctl = self.t.roll.RolloutController(
            self.router, cfg, clock=self.clock, swap_fn=self.swap,
            generate_fn=self.generate)

    def swap(self, addr, version):
        self.calls.append((addr, version))
        rep = self.router.fleet[addr]
        if addr in self.fail_addrs:
            return False, rep.model_version, "injected"
        rep.model_version = version
        return True, version, ""

    def generate(self, addr, prompt, max_tokens):
        v = self.router.fleet[addr].model_version
        if self.broken and v != OLD:
            raise RuntimeError("judge path down")
        if self.poisoned and v != OLD:
            return [999] * len(prompt)
        return [x + 1 for x in prompt]

    def tick(self, trace):
        self.ctl.decide_once()
        c = self.ctl
        trace.append(("tick", c.phase, list(c.swapped), c.verdict,
                      c.wave, c.wave_committed, list(c.wave_addrs),
                      c.swaps, c.rollbacks, c.last_error,
                      {a: r.model_version
                       for a, r in sorted(self.router.fleet.items())}))
        self.clock.advance(1.0)
        return c.phase

    def drive(self, trace, until=None, max_ticks=60):
        for _ in range(max_ticks):
            phase = self.tick(trace)
            if phase in self.t.roll.TERMINAL or (until and until(self)):
                return phase
        raise AssertionError("no terminal phase, stuck at %s"
                             % self.ctl.phase)

    def finish(self, trace):
        trace.append(("end", _normalize(self.ctl.status_block(),
                                        pb.RolloutStatus),
                      self.calls, self.ctl.rollout_restarts,
                      self.ctl.config.checkpoint_dir,
                      sorted(self.router.held), _files(self.d / "journal")))
        return trace


def _wave2(rig):
    return rig.ctl.phase == "wave" and len(rig.ctl.swapped) == 2


def _resume(rig, trace, **kw):
    """abandon() (nothing journals on the way down, as a kill), then a
    controller over the same journal with only the journal dir."""
    rig.ctl.abandon()
    for k, v in kw.items():
        setattr(rig, k, v)
    rig.new_life()
    trace.append(("resumed", rig.ctl.phase, list(rig.ctl.swapped)))


def sc_rollout(t, d, ckpt, case):
    kw = {"parity": dict(poisoned=True), "broken": dict(broken=True),
          "canary_fails": dict(fail_addrs=("a:1",)),
          "resume_rollback": dict(poisoned=True)}.get(case, {})
    rig = RolloutRig(t, d, ckpt, **kw)
    tr = []
    c = rig.ctl
    if case == "guards":
        fleet = dict(rig.router.fleet)
        rig.router.fleet.clear()
        tr.append(("empty", c.begin(NEW), c.last_error))
        c.request(NEW)
        rig.tick(tr)  # the deferred request waits for a fleet
        rig.router.fleet.update(fleet)
        rig.tick(tr)
        tr.append(("again", c.begin(NEW), c.last_error))
        rig.drive(tr)
        c.request(NEW)  # the committed target again: a no-op
        rig.tick(tr)
        return rig.finish(tr)
    target = 3 if case == "torn" else NEW
    if case == "already_serving":
        rig.router.fleet["b:1"].model_version = NEW
    if case == "burn":
        rig.router.reports = [_report(fast=3.0, slow=0.1)]
    if case == "slow_burn_only":
        rig.router.reports = [_report(fast=0.3, slow=4.0)]
    assert c.begin(target)
    if case == "wave_alert":
        rig.drive(tr, until=_wave2)
        rig.router.reports = [_report(fast=2.0, slow=2.0, alerting=True)]
    elif case == "resume_canary":
        rig.tick(tr)
        rig.tick(tr)
        _resume(rig, tr)
    elif case in ("resume_wave", "resume_landed"):
        rig.drive(tr, until=_wave2)
        if case == "resume_landed":
            rig.router.fleet["c:1"].model_version = NEW
        _resume(rig, tr)
    elif case == "resume_rollback":
        rig.drive(tr, until=lambda r: r.ctl.phase == "rolling_back")
        _resume(rig, tr)
    rig.drive(tr)
    if case == "resume_wave":
        _resume(rig, tr)  # a terminal journal stays terminal
    return rig.finish(tr)


ROLLOUT_CASES = ("commit", "already_serving", "guards", "torn", "parity",
                 "burn", "slow_burn_only", "broken", "wave_alert",
                 "canary_fails", "resume_canary", "resume_wave",
                 "resume_landed", "resume_rollback")
ROLLOUT_ENDS = {"commit": "committed", "already_serving": "committed",
                "torn": "aborted", "parity": "rolled_back",
                "burn": "rolled_back", "slow_burn_only": "committed",
                "broken": "rolled_back", "wave_alert": "rolled_back",
                "canary_fails": "aborted", "resume_canary": "committed",
                "resume_wave": "committed", "resume_landed": "committed",
                "resume_rollback": "rolled_back", "guards": "committed"}


@pytest.mark.parametrize("case", ROLLOUT_CASES)
def test_rollout_matches_jax(tmp_path, ckpt, case):
    traces = _run_both(sc_rollout, tmp_path, ckpt, case)
    _assert_equal(traces)
    end = traces[1][-1]
    assert end[1]["phase"] == ROLLOUT_ENDS[case]
    calls = [tuple(x) for x in end[2]]
    assert len(calls) == len(set(calls))  # no replica swapped twice
    assert end[5] == []  # nothing left held


def test_rollout_verdicts_and_parity_hold(ckpt):
    for mod in (jroll, proll):
        assert mod.burn_verdict([_report(fast=2.5)])[0]
        assert not mod.burn_verdict([_report(fast=0.3, slow=4.0)])[0]
        assert not mod.burn_verdict([_report(fast=9.0, fast_samples=0)])[0]
        assert mod.wave_alerting([_report(2.0, 2.0, alerting=True)]) == [
            "ttft_p99"]
        assert mod.parity_verdict([[1], [3]], [[1], [9]]) == (True, 1, 2)
        assert mod.parity_verdict([[1], [2]], [[1], [9]], 0.5)[0] is False
        assert mod.parse_parity_prompts("1,2,3; 4,5 ;") == ((1, 2, 3),
                                                            (4, 5))
    assert vars(proll.RolloutConfig()) == vars(jroll.RolloutConfig())
    # the port's parity passes hold the canary and wait out its routed
    # work: the baseline and the judgment each run alone on it
    router = FakeRolloutRouter(("a:1", "b:1"))
    seen = []

    def generate(addr, prompt, n):
        seen.append((addr, sorted(router.held), router.fleet[addr].inflight))
        return list(prompt)

    router.fleet["a:1"].inflight = 2
    ctl = proll.RolloutController(
        router, proll.RolloutConfig(checkpoint_dir=ckpt,
                                    rpc_timeout_secs=0.05,
                                    parity_prompts=((1,),)),
        swap_fn=lambda a, v: (True, v, ""), generate_fn=generate)
    ctl.begin(NEW)
    ctl.decide_once()
    router.fleet["a:1"].inflight = 0
    ctl.decide_once()
    ctl.decide_once()
    assert seen == [("a:1", ["a:1"], 2), ("a:1", ["a:1"], 0)]
    assert router.holds == ["a:1", "a:1", "a:1"] and not router.held
    # and it decides nothing while a replica's first heartbeat is due
    # inside its registration lease (model_version is not known yet)
    router = FakeRolloutRouter(("a:1",))
    rep = router.fleet["a:1"]
    rep.polls, rep.lease_ok = 0, lambda now: True
    ctl = proll.RolloutController(router, proll.RolloutConfig(
        checkpoint_dir=ckpt), swap_fn=lambda a, v: (True, v, ""),
        generate_fn=lambda a, p, n: list(p))
    ctl.request(NEW)
    ctl.decide_once()
    assert ctl.phase == "idle"
    rep.polls = 1
    ctl.decide_once()
    assert (ctl.phase, ctl.old_version) == ("canary", OLD)
    rep.polls, rep.lease_ok = 0, lambda now: False  # lapsed unpolled
    ctl.decide_once()
    assert ctl.phase == "judging"


# ------------------------------------------------------- the supervisor


class FakeAutoStub(object):
    def __init__(self, t):
        self.t = t
        self.poll_ok = True
        self.status = dict(kv_blocks_free=8)
        self.closed = 0

    def server_status(self, request, timeout=None):
        if not self.poll_ok:
            raise RuntimeError("poll down")
        return self.t.pb.ServerStatusResponse(**self.status)

    def close(self):
        self.closed += 1


class FakeHandle(object):
    def __init__(self, pid, seat_id):
        self.pid, self.seat_id = pid, seat_id
        self.rc = self.address = None
        self.log_path = "log-%d" % seat_id
        self.terminated = self.killed = False
        self.exit_on_terminate = True

    def poll(self):
        return self.rc

    def ready(self):
        return self.address

    def terminate(self):
        self.terminated = True
        if self.exit_on_terminate and self.rc is None:
            self.rc = 0

    def kill(self):
        self.killed = True
        if self.rc is None:
            self.rc = -9


class FakeLauncher(object):
    def __init__(self, t):
        self.t, self.stubs, self.spawned = t, {}, []
        self.auto_ready = True
        self._pid = 4000

    def make_ready(self, handle):
        handle.address = "rep%d" % handle.pid
        self.stubs[handle.address] = FakeAutoStub(self.t)

    def spawn(self, seat_id):
        self._pid += 1
        handle = FakeHandle(self._pid, seat_id)
        if self.auto_ready:
            self.make_ready(handle)
        self.spawned.append(handle)
        return handle

    def attach(self, seat_id, pid, log_path):
        for handle in self.spawned:
            if handle.pid == pid:
                return handle
        dead = FakeHandle(pid, seat_id)
        dead.rc = 1
        return dead


class AutoRig(object):
    KW = dict(min_replicas=1, max_replicas=3, decide_secs=0.1,
              up_queue_wait_ms=100.0, up_queue_depth=4, up_window_secs=1.0,
              idle_queue_wait_ms=20.0, down_window_secs=2.0,
              down_free_kv_blocks=1, cooldown_secs=3.0,
              ready_timeout_secs=30.0, drain_timeout_secs=10.0,
              wedged_after_secs=2.0, max_restarts=3, base_delay_secs=0.1,
              max_delay_secs=1.0)

    def __init__(self, t, d, spec="", lease_secs=1000.0, **kw):
        self.t, self.d, self.trace = t, d, []
        self.clock = FakeClock()
        self.launcher = FakeLauncher(t)
        self.kw = dict(self.KW, journal_dir=str(d / "fleet"), **kw)
        self.router = t.mod.Router(
            [], config=t.mod.RouterConfig(lease_secs=lease_secs),
            stub_factory=lambda a: self.launcher.stubs[a], clock=self.clock,
            sleep=lambda s: None, telemetry=t.telemetry(self.clock))
        self.injector = (t.fault.FaultInjector(spec=spec, kill_fn=lambda: 0)
                         if spec else None)
        self.sup = None
        self.new_life(0)

    def new_life(self, seed):
        self.sup = self.t.auto.ReplicaSupervisor(
            self.router, self.launcher, self.t.auto.AutoscalerConfig(
                **self.kw), clock=self.clock, injector=self.injector,
            rng=random.Random(seed))
        self.router.set_autoscaler(self.sup)

    def stubs(self):
        return self.launcher.stubs

    def settle(self, ticks=4):
        for _ in range(ticks):
            self.sup.decide_once()
            self.router.poll_once()

    def pressure(self, on=True):
        for stub in self.stubs().values():
            stub.status.update(queue_wait_ms=500.0 if on else 0.0,
                               queue_depth=1 if on else 0)
        self.router.poll_once()

    def step(self, label, fn=None, *args):
        out = (fn or self.sup.decide_once)(*args)
        s = self.sup
        self.trace.append((
            label, out, s.roster(), s.target, s.circuit_open,
            _normalize(s.status_block(), pb.AutoscalerStatus),
            sorted(r.address for r in self.router.replicas()),
            [(h.pid, h.terminated, h.killed, h.rc)
             for h in self.launcher.spawned],
            {a: st.closed for a, st in sorted(self.stubs().items())}))

    def done(self):
        self.trace.append(("journal", _files(self.d / "fleet"),
                           self.injector.injected if self.injector else {}))
        self.router.stop()
        return self.trace


def sc_auto(t, d, case):
    kw = {"wedged": dict(lease_secs=5.0),
          "stalled": dict(wedged_after_secs=30.0,
                          stalled_kill_after_secs=1.0),
          "stall_recovers": dict(stalled_kill_after_secs=2.0),
          "kv_headroom": dict(down_free_kv_blocks=100),
          "compaction": dict(min_replicas=2, snapshot_every=3),
          "spawn_hook": dict(spec="supervisor_spawn:drop:1"),
          "adopt_hook": dict(spec="supervisor_adopt:drop:1"),
          "ready_hook": dict(spec="supervisor_ready:delay:1:secs=0.01")}
    kw.update({k: dict(min_replicas=2) for k in (
        "recover", "recover_mid_spawn", "recover_dead", "stop")})
    r = AutoRig(t, d, **kw.get(case, {}))
    sup, clock, launcher = r.sup, r.clock, r.launcher
    if case in ("scale_up", "cooldown_max", "counters"):
        r.settle()
        r.pressure()
        r.step("window opens")
        if case == "scale_up":
            r.pressure(False)
            r.step("pressure breaks")
            clock.advance(2.0)
            r.pressure()
            r.step("window restarts")
        clock.advance(1.1)
        r.pressure()
        r.step("scale up")
        r.settle()
        r.step("adopted")
        if case == "cooldown_max":
            for dt in (1.2, 3.0, 1.1, 5.0, 5.0, 5.0):
                clock.advance(dt)
                r.pressure()
                r.step("pressure +%.1f" % dt)
                r.settle()
        if case == "counters":
            launcher.spawned[0].rc = -9
            r.step("reap and replace")
            r.settle()
            sup.abandon()
            r.new_life(1)
            r.step("recovered")
    elif case == "unsettled":
        r.settle()
        launcher.auto_ready = False
        sup.target = 2
        r.step("spawn unready")
        for dt in (0.0, 5.0):
            clock.advance(dt)
            r.pressure()
            r.step("blind")
    elif case in ("scale_down", "stale_ewma", "kv_headroom", "drain_timeout"):
        sup.target = 2
        r.settle(6)
        r.step("two live")
        if case in ("scale_down", "drain_timeout"):
            launcher.spawned[1].exit_on_terminate = False
        if case == "stale_ewma":
            for stub in r.stubs().values():
                stub.status["queue_wait_ms"] = 5000.0
        if case == "kv_headroom":
            for stub in r.stubs().values():
                stub.status["kv_blocks_free"] = 10
        r.router.poll_once()
        r.step("idle window opens")
        if case == "stale_ewma":
            r.step("routed unchanged")
        clock.advance(2.1 if case != "kv_headroom" else 3.0)
        r.router.poll_once()
        r.step("scale down")
        if case == "kv_headroom":
            for stub in r.stubs().values():
                stub.status.update(kv_blocks_free=0, kv_blocks_cached=60)
            r.router.poll_once()
            r.step("headroom: window opens")
            clock.advance(2.1)
            r.router.poll_once()
            r.step("scale down")
        if case == "scale_down":
            launcher.spawned[1].rc = 0
            r.step("retired")
        if case == "drain_timeout":
            clock.advance(10.1)
            r.step("drain timeout kill")
            r.step("retired")
    elif case == "crash":
        r.settle()
        launcher.spawned[0].rc = -9
        r.step("reap and respawn")
        r.settle()
        r.step("replaced")
    elif case in ("circuit", "streak_reset"):
        launcher.auto_ready = False
        r.step("spawn 1")
        launcher.spawned[-1].rc = 1
        r.step("failure 1")
        r.step("inside backoff")
        clock.advance(1.1)
        r.step("spawn 2")
        if case == "streak_reset":
            launcher.make_ready(launcher.spawned[-1])
            r.step("adopt resets the streak")
        else:
            for k in (2, 3):
                launcher.spawned[-1].rc = 1
                r.step("failure %d" % k)
                clock.advance(1.1)
                r.step("after failure %d" % k)
            for _ in range(3):
                clock.advance(5.0)
                r.step("circuit holds")
    elif case == "wedged":
        r.settle()
        r.stubs()[launcher.spawned[0].address].poll_ok = False
        clock.advance(6.0)
        r.router.poll_once()
        r.step("unhealthy window")
        clock.advance(2.1)
        r.step("killed")
        r.step("replaced")
        r.settle()
    elif case in ("stalled", "stall_recovers"):
        r.settle()
        stub = r.stubs()[launcher.spawned[0].address]
        stub.status.update(health_state="stalled",
                           last_progress_age_ms=4000.0)
        r.router.poll_once()
        r.step("stalled window")
        clock.advance(1.0 if case == "stall_recovers" else 1.1)
        if case == "stall_recovers":
            stub.status["health_state"] = "ok"
        r.router.poll_once()
        r.step("kill or reset")
        clock.advance(5.0)
        r.router.poll_once()
        r.step("after")
        r.settle()
    elif case in ("spawn_hook", "adopt_hook", "ready_hook"):
        r.step("first")
        r.step("second")
        clock.advance(1.1)
        r.settle()
        r.step("settled")
    elif case in ("recover", "recover_dead", "compaction"):
        r.settle(6)
        r.step("two live")
        sup.abandon()
        if case == "recover_dead":
            launcher.spawned[0].rc = -9
        r.new_life(1)
        r.step("recovered")
        r.settle(6)
        r.step("settled")
    elif case == "recover_mid_spawn":
        launcher.auto_ready = False
        r.step("spawn 1")
        r.step("spawn 2")
        sup.abandon()
        r.new_life(1)
        r.step("recovered")
        for handle in launcher.spawned:
            launcher.make_ready(handle)
        r.settle()
        r.step("adopted")
    elif case == "stop":
        r.settle(6)
        r.step("stop", sup.stop, 1.0)
        r.new_life(1)
        r.step("successor")
    else:  # spawn_to_min
        r.step("spawn")
        r.step("adopt")
        r.settle()
        r.trace.append(("router_status", _normalize(
            r.router.status_response(), pb.RouterStatusResponse)[
                "autoscaler"]))
    return r.done()


AUTO_CASES = ("spawn_to_min", "scale_up", "cooldown_max", "unsettled",
              "scale_down", "stale_ewma", "kv_headroom", "drain_timeout",
              "crash", "circuit", "streak_reset", "wedged", "stalled",
              "stall_recovers", "spawn_hook", "adopt_hook", "ready_hook",
              "recover", "recover_mid_spawn", "recover_dead", "stop",
              "counters", "compaction")


@pytest.mark.parametrize("case", AUTO_CASES)
def test_supervisor_matches_jax(tmp_path, case):
    traces = _run_both(sc_auto, tmp_path, case)
    _assert_equal(traces)
    by = {x[0]: x for x in traces[1]}
    expect = {"scale_up": ("scale_ups", 1), "crash": ("replacements", 1),
              "wedged": ("replacements", 1), "stalled": ("replacements", 1),
              "stall_recovers": ("replacements", 0),
              "circuit": ("circuit_open", True),
              "stale_ewma": ("scale_downs", 1),
              "kv_headroom": ("scale_downs", 1),
              "recover": ("supervisor_restarts", 1),
              "counters": ("replacements", 1)}.get(case)
    if expect:
        block = traces[1][-2][5]
        assert block[expect[0]] == expect[1], block
    if case in ("recover", "recover_mid_spawn"):
        assert len(by["settled" if case == "recover" else "adopted"][7]) == 2
    if case == "unsettled":
        assert by["blind"][3] == 2 and by["blind"][5]["scale_ups"] == 0


# ------------------------------------------------- journals and replays


def _recorded(tmp_path, kind):
    """The port's journals, each from a scenario above."""
    if kind == "cell":
        trace = sc_cell_registry(Tier("port"), tmp_path)
        return [ev for x in trace if x[0] == "journal" for ev in
                x[2]["events"]] + _files(tmp_path)["events"]
    if kind == "autoscaler":
        out = []
        for case in ("crash", "scale_down", "stop"):
            d = tmp_path / case
            d.mkdir()
            out.append(sc_auto(Tier("port"), d, case)[-1][1]["events"])
        return out
    out = []
    for case in ("commit", "wave_alert", "resume_rollback"):
        d = tmp_path / case
        d.mkdir()
        out.append(sc_rollout(Tier("port"), d, _CKPT[0], case)[-1][6][
            "events"])
    return out


_CKPT = []


def _apply_all(apply_event, events, state):
    for ev in events:
        apply_event(state, json.loads(json.dumps(ev)))
    return state


def _roll_state():
    return {"phase": "idle", "counters": {}}


def _auto_state():
    return {"target": 0, "next_seat": 0, "seats": {}, "counters": {}}


@pytest.mark.parametrize("kind", ("rollout", "autoscaler"))
def test_port_journals_pass_the_jax_protocol(tmp_path, ckpt, kind):
    _CKPT[:] = [ckpt]
    jmod, pmod, cls, fresh = {
        "rollout": (jroll, proll, "RolloutController", _roll_state),
        "autoscaler": (jauto, pauto, "ReplicaSupervisor", _auto_state),
    }[kind]
    spec = jmod.PROTOCOL
    papply = getattr(pmod, cls)._apply_event
    japply = getattr(jmod, cls)._apply_event

    def recover(snapshot, events):
        state = json.loads(json.dumps(snapshot)) if snapshot else fresh()
        return _apply_all(papply, events, state)

    covered = set()
    for events in _recorded(tmp_path, kind):
        ptg.validate_journal(spec, events)
        covered |= {ev["ev"] for ev in events}
        assert ptg.replay_battery(spec, events, recover) == len(events) + 1
        ptg.double_replay_idempotent(
            spec, events, recover,
            snapshot_of=lambda s: json.loads(json.dumps(s)),
            fingerprint=lambda s: {k: v for k, v in s.items()
                                   if k != "counters"})
        # each package replays the other's journal to the same state
        assert (_apply_all(japply, events, fresh())
                == _apply_all(papply, events, fresh()))
    assert spec.replayed_kinds() <= covered


def test_cell_journals_cross_replay(tmp_path):
    spec = jcell.PROTOCOL
    events = _recorded(tmp_path / "p", "cell")
    ptg.validate_journal(spec, events)
    assert ptg.kind_coverage(spec, events) == []
    jt = Tier("jax")
    jevents = [ev for x in sc_cell_registry(jt, tmp_path / "j")
               if x[0] == "journal" for ev in x[2]["events"]]

    def members(mod, t, snapshot, evs):
        cell = mod.RouterCell(
            snapshot["replicas"] if snapshot else [],
            config=t.mod.RouterConfig(cell_id=0, cells=2),
            stub_factory=lambda a: FakeReplicaStub(t, 7), clock=FakeClock(),
            sleep=lambda s: None, telemetry=t.telemetry(FakeClock()))
        try:
            for ev in evs:
                cell._apply_event(ev)
            return sorted(r.address for r in cell.replicas())
        finally:
            cell.stop()

    pt = Tier("port")

    def recover(snapshot, evs):
        return members(pcell, pt, snapshot, evs)

    def check(k, sim, addrs):
        assert addrs == sorted(a for a, s in sim[1].items()
                               if s == "member"), k

    assert ptg.replay_battery(spec, events, recover, check=check) == (
        len(events) + 1)
    ptg.double_replay_idempotent(spec, events, recover,
                                 snapshot_of=lambda a: {"replicas": a})
    for evs in (events, jevents):
        assert members(jcell, jt, None, evs) == members(pcell, pt, None, evs)


def test_hook_tables_equal_jax():
    from elasticdl_tpu.common import fault_injection as jfault

    assert pfault.SUPERVISOR_RPCS == jfault.SUPERVISOR_RPCS
    assert pfault.CELL_HOOKS == jfault.CELL_HOOKS
    assert vars(pauto.AutoscalerConfig()) == vars(jauto.AutoscalerConfig())
    assert (pcell.RouterCell.LEASE_JOURNAL_EVERY
            == jcell.RouterCell.LEASE_JOURNAL_EVERY)
    for spec in ("rollout_swap:kill:1:skip=1", "supervisor_spawn:drop:2",
                 "cell_spawn:drop:1;cell_kill:kill:1:skip=4",
                 "rollout_judge:drop:*"):
        fired = []
        for mod in (jfault, pfault):
            inj = mod.FaultInjector(spec=spec, kill_fn=lambda: None)
            seen = []
            for name in ("rollout_swap", "cell_kill", "supervisor_spawn",
                         "rollout_judge", "cell_spawn") * 3:
                try:
                    inj.intercept(name)
                    seen.append("pass")
                except Exception:  # noqa: BLE001 - either package's error
                    seen.append("drop")
            fired.append((seen, inj.injected))
        assert fired[0] == fired[1], spec
