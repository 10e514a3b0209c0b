"""Fleet-wide model rollout, a journaled wave controller: the port of
elasticdl_tpu/serving/rollout.py.

The controller takes a target checkpoint version and drives every
registered replica through

    stage -> canary -> judge -> progressive waves -> commit

with every transition journaled write-ahead through the same
JobStateStore the dispatcher trusts, so a controller killed and
restarted resumes mid-wave with no replica swapped twice and none left
on a mixed version.

* **stage**: the checkpoint must pass verify_checkpoint (a complete
  shard set and its sha256 digests) before any replica swaps, so a torn
  or corrupt checkpoint aborts with no fleet impact. The parity
  baseline is then recorded: the pinned prompts generated greedily on
  the canary while it still serves the OLD version.
* **canary**: plan[0] reloads through the reload_checkpoint call while
  the router steers new traffic away from it (hold_replica).
* **judge**: the canary must reproduce the baseline tokens (greedy
  parity) and survive a soak with the fast-window SLO burn under the
  failure threshold (a slow-burn-only breach passes). No verdict inside
  judge_timeout_secs is itself a verdict: no promotion.
* **waves**: the rest of the plan swaps in wave_size chunks, each soaked
  against the multi-window alert (both burns > 1.0). An alert rolls
  every swapped replica back in REVERSE swap order, canary last.

The router's process imports no torch, so the controller verifies
checkpoints through common/checkpoint_integrity.py and speaks to the
replicas through proto/service.py's ServingStub.

One difference from the JAX controller: each parity pass (the baseline
and the canary's judgment) runs with the canary held and after the
router's in-flight dispatches to it have ended, waiting at most
`rpc_timeout_secs`. At bf16 a greedy stream depends on what shares its
batch, so a pass that shares the canary with routed traffic can drift
from the other on the same weights and roll a healthy republish back.
And the port's controller decides nothing while a registered replica
awaits its first heartbeat: router_main registers the fleet and starts
the controller at once, and a tick ahead of the first poll would read
model_version 0, open a rollout whose rollback target is version 0, or
reload a replica a resumed journal's swap had already reached. The JAX
journals, decisions and status blocks are unchanged by either.

router_main owns the controller's lifecycle; the controller calls into
the router (hold / release, replicas, slo_reports), never the reverse.
`abandon()` stops deciding without journaling: a stand-in for SIGKILL.
"""

import logging
import threading
import time

from elasticdl_tpu_torch.common.checkpoint_integrity import verify_checkpoint
from elasticdl_tpu_torch.common.fault_injection import FaultInjector
from elasticdl_tpu_torch.master.state_store import JobStateStore
from elasticdl_tpu_torch.proto import messages as pb

logger = logging.getLogger(__name__)

# lifecycle phases; the terminal ones leave the controller idle
STAGING = "staging"
CANARY = "canary"
JUDGING = "judging"
WAVE = "wave"
ROLLING_BACK = "rolling_back"
IDLE = "idle"
COMMITTED = "committed"
ROLLED_BACK = "rolled_back"
ABORTED = "aborted"
TERMINAL = (IDLE, COMMITTED, ROLLED_BACK, ABORTED)


def burn_verdict(reports, fast_burn_fail=1.0):
    """Canary burn judgment over one slo_reports() evaluation; returns
    (failed, reason). A fast-window burn above the threshold fails; a
    slow-burn-only breach passes (the slow window averages history the
    canary never touched); an unsampled window is silent."""
    for r in reports:
        if (float(r.get("fast_burn", 0.0)) > fast_burn_fail
                and int(r.get("fast_samples", 0)) > 0):
            return True, "%s fast burn %.2f > %.2f" % (
                r.get("name", "?"), r["fast_burn"], fast_burn_fail)
    return False, ""


def wave_alerting(reports):
    """Objectives in multi-window alert (both burns > 1.0): the wave
    pause trigger."""
    return [r.get("name", "?") for r in reports if r.get("alerting")]


def parity_verdict(baseline, actual, min_match=1.0):
    """Greedy parity: actual[i] must equal baseline[i] for at least
    min_match of the pinned prompts. Returns (failed, matched, total)."""
    total = len(baseline)
    if total == 0:
        return False, 0, 0
    matched = sum(1 for want, got in zip(baseline, actual)
                  if list(want) == list(got))
    return (matched < min_match * total), matched, total


class CheckpointStager(object):
    """stage_checkpoint -> activate | discard: stage verifies the target
    version's integrity manifest; activate hands the manifest over as
    the staged checkpoint's acceptance; discard closes the failure path
    and returns the verification error. Nothing is copied: replicas read
    the checkpoint store themselves."""

    def __init__(self, checkpoint_dir, injector=None):
        self._dir = checkpoint_dir
        self._injector = injector
        self._manifest = None
        self._error = None

    def stage_checkpoint(self, version):
        """Verify `version`; True when it staged clean."""
        if self._injector is not None:
            self._injector.intercept("checkpoint_read")
        try:
            self._manifest = verify_checkpoint(self._dir, version)
            return True
        except Exception as e:  # noqa: BLE001 - a structured verdict
            self._error = e
            return False

    def activate(self):
        """Accept the staged checkpoint; returns its manifest."""
        if self._manifest is None:
            raise RuntimeError("activate() without a staged checkpoint")
        manifest, self._manifest = self._manifest, None
        return manifest

    def discard(self):
        """Close the failure path; returns the verification error."""
        error, self._error, self._manifest = self._error, None, None
        return error


class RolloutConfig(object):
    """The wave controller's knobs, the JAX controller's with its
    defaults. checkpoint_dir is the store every replica reads;
    journal_dir enables the write-ahead journal and crash recovery."""

    def __init__(self, checkpoint_dir="", journal_dir="",
                 snapshot_every=64, decide_secs=0.5, wave_size=1,
                 soak_secs=3.0, judge_timeout_secs=60.0,
                 swap_timeout_secs=120.0, parity_prompts=((1, 2, 3),),
                 parity_max_tokens=8, parity_min_match=1.0,
                 fast_burn_fail=1.0, rpc_timeout_secs=30.0):
        self.checkpoint_dir = checkpoint_dir
        self.journal_dir = journal_dir
        self.snapshot_every = int(snapshot_every)
        self.decide_secs = float(decide_secs)
        self.wave_size = max(1, int(wave_size))
        self.soak_secs = float(soak_secs)
        self.judge_timeout_secs = float(judge_timeout_secs)
        self.swap_timeout_secs = float(swap_timeout_secs)
        self.parity_prompts = tuple(tuple(int(t) for t in p)
                                    for p in parity_prompts)
        self.parity_max_tokens = int(parity_max_tokens)
        self.parity_min_match = float(parity_min_match)
        self.fast_burn_fail = float(fast_burn_fail)
        self.rpc_timeout_secs = float(rpc_timeout_secs)


class RolloutController(object):
    """The journaled canary -> judge -> waves -> commit state machine.

    swap_fn(address, version) -> (ok, serving_version, error) and
    generate_fn(address, prompt, max_tokens) -> [tokens] are injectable
    for tests; the defaults speak the Serving calls. reports_fn defaults
    to router.slo_reports (the heartbeat's cached burn evaluation)."""

    def __init__(self, router, config=None, clock=time.monotonic,
                 injector=None, swap_fn=None, generate_fn=None,
                 reports_fn=None):
        self.config = config or RolloutConfig()
        self._router = router
        self._clock = clock
        self._injector = injector or FaultInjector.from_env()
        self._swap_fn = swap_fn or self._default_swap
        self._generate_fn = generate_fn or self._default_generate
        self._reports_fn = reports_fn or router.slo_reports
        self._lock = threading.Lock()
        # journal-backed state (_state_dict is the schema)
        self.phase = IDLE
        self.target_version = 0
        self.old_version = 0
        self.plan = []
        self.versions = {}
        self.swapped = []  # swap order; rollback reverses it
        self.baseline = []
        self.verdict = ""
        self.wave = 0
        self.wave_committed = 0
        self.wave_addrs = []
        self.last_error = ""
        self.swaps = 0
        self.rollbacks = 0
        self.rollout_restarts = 0
        self._pending_target = None
        # in memory only: a resumed judgment re-earns its soak
        self._judge_started = None
        self._parity_ok = False
        self._soak_until = None
        self._stop = threading.Event()
        self._thread = None
        self._store = None
        self._compact_pending = False
        if self.config.journal_dir:
            self._store = JobStateStore(
                self.config.journal_dir,
                snapshot_every=self.config.snapshot_every)
            if self._store.has_state():
                self._recover()

    # ------------------------------------------------------- journaling

    def _journal(self, event):
        if self._store is None:
            return
        if self._store.append(event):
            # compaction waits for the end of the decide tick: a
            # snapshot between an event and its in-memory transition
            # would truncate the journal around a half-applied swap
            self._compact_pending = True

    def _maybe_compact(self):
        if self._store is not None and self._compact_pending:
            self._store.write_snapshot(self._state_dict())
            self._compact_pending = False

    def _state_dict(self):
        return {
            "phase": self.phase,
            "target": self.target_version,
            "old": self.old_version,
            "dir": self.config.checkpoint_dir,
            "plan": list(self.plan),
            "versions": dict(self.versions),
            "swapped": list(self.swapped),
            "baseline": [list(t) for t in self.baseline],
            "verdict": self.verdict,
            "wave": self.wave,
            "wave_committed": self.wave_committed,
            "wave_addrs": list(self.wave_addrs),
            "last_error": self.last_error,
            "counters": {"swaps": self.swaps, "rollbacks": self.rollbacks},
        }

    @staticmethod
    def _apply_event(state, ev):
        """Replay one journal event onto a snapshot dict. Idempotent: a
        swap_done for an address already at the target rewrites the same
        value and `swapped` is deduplicated, so no replay double-swaps."""
        kind = ev.get("ev")
        counters = state.setdefault("counters", {})
        if kind == "begin":
            state.update(
                phase=STAGING, target=int(ev["target"]),
                old=int(ev["old"]), plan=list(ev["plan"]),
                dir=ev.get("dir", ""),
                versions={a: int(ev["old"]) for a in ev["plan"]},
                swapped=[], baseline=[], verdict="", wave=0,
                wave_committed=0, wave_addrs=[], last_error="")
        elif kind == "phase":
            state["phase"] = ev["to"]
            if "why" in ev:
                state["last_error"] = ev["why"]
        elif kind == "staged":
            state["baseline"] = [list(t) for t in ev.get("baseline", [])]
        elif kind == "swap_done":
            if not ev.get("ok"):
                return
            addr, to = ev["addr"], int(ev["to"])
            state.setdefault("versions", {})[addr] = to
            swapped = state.setdefault("swapped", [])
            if to == int(state.get("target", -1)):
                if addr not in swapped:
                    swapped.append(addr)
                counters["swaps"] = int(counters.get("swaps", 0)) + 1
            else:
                if addr in swapped:
                    swapped.remove(addr)
                if ev.get("why") == "rollback":
                    counters["rollbacks"] = (
                        int(counters.get("rollbacks", 0)) + 1)
        elif kind == "judge":
            state["verdict"] = ev["verdict"]
        elif kind == "wave_begin":
            state["wave"] = int(ev["wave"])
            state["wave_addrs"] = list(ev["addrs"])
        elif kind == "wave_commit":
            state["wave_committed"] = int(ev["wave"])
            state["wave_addrs"] = []
        elif kind == "wave_rollback":
            state["wave_addrs"] = []
        elif kind == "commit":
            # the event is the transition: a journal ending in it
            # recovers straight to COMMITTED
            state["phase"] = COMMITTED

    def _recover(self):
        """Snapshot plus event replay, then resume from the recovered
        phase; swap truth is checked against each replica's advertised
        model_version at the next tick, so a swap acted on but not yet
        journaled is recognized, not repeated."""
        snapshot, events = self._store.load()
        state = snapshot or self._state_dict()
        for ev in events:
            self._apply_event(state, ev)
        self.phase = state.get("phase", IDLE)
        self.target_version = int(state.get("target", 0))
        self.old_version = int(state.get("old", 0))
        if state.get("dir"):
            # a bare --rollout_journal_dir restart finds the store here
            self.config.checkpoint_dir = state["dir"]
        self.plan = list(state.get("plan", []))
        self.versions = dict(state.get("versions", {}))
        self.swapped = list(state.get("swapped", []))
        self.baseline = [list(t) for t in state.get("baseline", [])]
        self.verdict = state.get("verdict", "")
        self.wave = int(state.get("wave", 0))
        self.wave_committed = int(state.get("wave_committed", 0))
        self.wave_addrs = list(state.get("wave_addrs", []))
        self.last_error = state.get("last_error", "")
        counters = state.get("counters", {})
        self.swaps = int(counters.get("swaps", 0))
        self.rollbacks = int(counters.get("rollbacks", 0))
        self.rollout_restarts = self._store.restart_count
        logger.info(
            "rollout controller recovered: phase=%s target=%d swapped=%d/%d "
            "(restart #%d)", self.phase, self.target_version,
            len(self.swapped), len(self.plan), self.rollout_restarts)
        self._maybe_compact()

    # -------------------------------------------------------- lifecycle

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="rollout-controller")
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.is_set():
            try:
                self.decide_once()
            except Exception:  # noqa: BLE001 - the loop must survive
                logger.exception("rollout decide tick failed")
            self._stop.wait(self.config.decide_secs)

    def _join(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None

    def stop(self):
        """Stop deciding, release any held replica, close the journal;
        an unfinished rollout stays journaled for the next controller."""
        self._join()
        for addr in list(self._router.held_replicas()):
            self._router.release_replica(addr)
        with self._lock:
            self._maybe_compact()
            if self._store is not None:
                self._store.close()

    def abandon(self):
        """Stop deciding without journaling or releasing anything, as a
        SIGKILL would leave journal and fleet."""
        self._join()
        if self._store is not None:
            self._store.close()

    def _intercept(self, name):
        if self._injector is not None:
            self._injector.intercept(name)

    # ------------------------------------------------------- public API

    def begin(self, target_version):
        """Start a rollout to `target_version` over the fleet registered
        now, sorted by address (plan[0] the canary). False, with
        last_error set, when one is in flight or no replica is
        registered."""
        with self._lock:
            return self._begin_locked(target_version)

    def request(self, target_version):
        """A deferred begin: the first decide tick that finds a fleet
        starts it (the CLI path, before the autoscaler has spawned)."""
        with self._lock:
            self._pending_target = int(target_version)

    def _begin_locked(self, target_version):
        if self.phase not in TERMINAL:
            self.last_error = ("rollout already in flight (phase=%s)"
                               % self.phase)
            return False
        reps = {r.address: r for r in self._router.replicas()}
        plan = sorted(reps)
        if not plan:
            self.last_error = "no replicas registered"
            return False
        old = int(reps[plan[0]].model_version)
        ev = {"ev": "begin", "target": int(target_version), "old": old,
              "plan": plan, "dir": self.config.checkpoint_dir}
        self._journal(ev)
        self._apply_to_self(ev)
        self._judge_started = None
        self._parity_ok = False
        self._soak_until = None
        logger.info("rollout begin: version-%d -> version-%d over %d "
                    "replicas (canary %s)", old, int(target_version),
                    len(plan), plan[0])
        return True

    def _heartbeat_pending(self):
        """True while a registered replica awaits its first heartbeat
        inside its registration lease: its model_version is not known
        yet. A replica whose lease lapsed unpolled counts as known (its
        swap fails, as in the JAX controller)."""
        now = self._clock()
        return any(getattr(r, "polls", 1) == 0 and r.lease_ok(now)
                   for r in self._router.replicas())

    def decide_once(self):
        with self._lock:
            if self._heartbeat_pending():
                return
            if (self._pending_target is not None
                    and self.phase in TERMINAL):
                # a restart re-passing the committed target is a no-op
                if (self.phase == COMMITTED
                        and self._pending_target == self.target_version):
                    self._pending_target = None
                elif self._begin_locked(self._pending_target):
                    self._pending_target = None
            tick = {STAGING: self._tick_staging, CANARY: self._tick_canary,
                    JUDGING: self._tick_judging, WAVE: self._tick_wave,
                    ROLLING_BACK: self._tick_rollback}.get(self.phase)
            if tick is not None:
                tick()
            self._maybe_compact()

    def status_block(self):
        with self._lock:
            waves_total = 0
            if self.plan:
                rest = len(self.plan) - 1
                waves_total = 1 + ((rest + self.config.wave_size - 1)
                                   // self.config.wave_size)
            return pb.RolloutStatus(
                enabled=True, phase=self.phase,
                target_version=self.target_version,
                old_version=self.old_version, wave=self.wave,
                waves_total=waves_total, swapped=len(self.swapped),
                fleet=len(self.plan),
                canary=self.plan[0] if self.plan else "",
                verdict=self.verdict, last_error=self.last_error,
                rollbacks=self.rollbacks,
                rollout_restarts=self.rollout_restarts)

    # --------------------------------------------------------- wave API

    def begin_wave(self, wave, addrs):
        """Open wave `wave` over `addrs` and swap each to the target;
        True when every member converged. Members already advertising the
        target are journaled done without a second reload."""
        if self.wave != wave or list(self.wave_addrs) != list(addrs):
            self._journal({"ev": "wave_begin", "wave": wave,
                           "addrs": list(addrs)})
            self.wave = wave
            self.wave_addrs = list(addrs)
        return self._swap_unit(addrs, self.target_version)

    def commit_wave(self, wave):
        self._journal({"ev": "wave_commit", "wave": wave})
        self.wave_committed = wave
        self.wave_addrs = []
        self._soak_until = None

    def rollback_wave(self, wave, why):
        """Close the wave on the failure path and roll back every
        swapped replica in reverse order."""
        self._journal({"ev": "wave_rollback", "wave": wave})
        self.wave_addrs = []
        self._soak_until = None
        self._enter_rollback(why)

    # ------------------------------------------------------ phase ticks

    def _parity_pass(self):
        """The pinned prompts on the canary, each alone: the canary is
        held and its routed work allowed to end first (at most
        rpc_timeout_secs of wall time)."""
        cfg = self.config
        canary = self.plan[0]
        self._router.hold_replica(canary)
        try:
            deadline = time.monotonic() + cfg.rpc_timeout_secs
            while time.monotonic() < deadline:
                rep = {r.address: r
                       for r in self._router.replicas()}.get(canary)
                if rep is None or not getattr(rep, "inflight", 0):
                    break
                time.sleep(0.01)
            return [list(self._generate_fn(canary, list(p),
                                           cfg.parity_max_tokens))
                    for p in cfg.parity_prompts]
        finally:
            self._router.release_replica(canary)

    def _tick_staging(self):
        stager = CheckpointStager(self.config.checkpoint_dir,
                                  self._injector)
        if not stager.stage_checkpoint(self.target_version):
            err = stager.discard()
            self._abort("checkpoint failed verification: %s" % err)
            return
        manifest = stager.activate()
        # the baseline: recorded before any swap, on the old version
        try:
            baseline = self._parity_pass()
        except Exception as e:  # noqa: BLE001 - staging must not raise
            self._abort("parity baseline generation failed: %r" % e)
            return
        ev = {"ev": "staged", "baseline": baseline, "manifest": manifest}
        self._journal(ev)
        self._apply_to_self(ev)
        self._set_phase(CANARY)
        logger.info("rollout staged version-%d (%d digests verified), "
                    "baseline over %d prompts", self.target_version,
                    manifest.get("verified_digests", 0), len(baseline))

    def _tick_canary(self):
        if self._swap_unit([self.plan[0]], self.target_version):
            self._judge_started = None
            self._parity_ok = False
            self._set_phase(JUDGING)
        else:
            self._enter_rollback("canary swap failed: %s" % self.last_error)

    def _tick_judging(self):
        cfg = self.config
        now = self._clock()
        if self._judge_started is None:
            self._judge_started = now
        if now - self._judge_started > cfg.judge_timeout_secs:
            # no verdict is a verdict: no promotion
            self._judge("timeout", "no verdict within %.0fs"
                        % cfg.judge_timeout_secs)
            return
        try:
            self._intercept("rollout_judge")
            if not self._parity_ok:
                failed, matched, total = parity_verdict(
                    self.baseline, self._parity_pass(),
                    cfg.parity_min_match)
                if failed:
                    self._judge("parity_fail",
                                "canary reproduced %d/%d pinned prompts"
                                % (matched, total))
                    return
                self._parity_ok = True
            failed, reason = burn_verdict(self._reports_fn(),
                                          cfg.fast_burn_fail)
            if failed:
                self._judge("burn_fail", reason)
                return
        except Exception as e:  # noqa: BLE001 - no evidence this tick
            # the timeout turns sustained silence into a failure
            logger.warning("rollout judge evaluation failed: %r", e)
            return
        if now - self._judge_started >= cfg.soak_secs:
            self._judge("pass", "")

    def _judge(self, verdict, why):
        self._journal({"ev": "judge", "verdict": verdict})
        self.verdict = verdict
        if verdict == "pass":
            logger.info("rollout canary judged: pass")
            self._set_phase(WAVE)
        else:
            logger.warning("rollout canary judged: %s (%s)", verdict, why)
            self._enter_rollback("canary %s: %s" % (verdict, why))

    def _tick_wave(self):
        cfg = self.config
        # resume the open wave, or open the next one over plan[1:]
        if self.wave_addrs:
            wave, addrs = self.wave, list(self.wave_addrs)
        else:
            wave = self.wave_committed + 1
            lo = (wave - 1) * cfg.wave_size
            addrs = self.plan[1:][lo:lo + cfg.wave_size]
            if not addrs:
                ev = {"ev": "commit"}
                self._journal(ev)
                self._apply_to_self(ev)
                logger.info("rollout committed: fleet of %d on version-%d "
                            "(%d swaps)", len(self.plan),
                            self.target_version, self.swaps)
                return
        if not self.begin_wave(wave, addrs):
            self.rollback_wave(wave, "wave %d swap failed: %s"
                               % (wave, self.last_error))
            return
        now = self._clock()
        if self._soak_until is None:
            self._soak_until = now + cfg.soak_secs
        alerting = wave_alerting(self._reports_fn())
        if alerting:
            self.rollback_wave(wave, "SLO burn alert during wave %d: %s"
                               % (wave, ", ".join(alerting)))
            return
        if now >= self._soak_until:
            self.commit_wave(wave)

    def _tick_rollback(self):
        for addr in reversed(self.swapped):  # canary last
            if not self._swap_one(addr, self.old_version, why="rollback"):
                # the replica keeps its reload_failed latch; next tick
                logger.error("rollout rollback of %s blocked: %s",
                             addr, self.last_error)
                return
        self._set_phase(ROLLED_BACK)
        logger.warning("rollout rolled back: fleet of %d uniform on "
                       "version-%d", len(self.plan), self.old_version)

    # ---------------------------------------------------- swap plumbing

    def _swap_unit(self, addrs, to_version):
        """Swap every address to `to_version`; True when all converged.
        A member whose journaled or advertised version matches is not
        reloaded again (a reload that landed before a crash but after its
        swap_start entry is recognized)."""
        for addr in addrs:
            if not self._swap_one(addr, to_version):
                return False
        return True

    def _swap_done(self, addr, to_version, ok, why="", note=""):
        ev = {"ev": "swap_done", "addr": addr, "to": to_version,
              "ok": bool(ok)}
        if note:
            ev["note"] = note
        if why:
            ev["why"] = why
        self._journal(ev)
        self._apply_to_self(ev)

    def _swap_one(self, addr, to_version, why=""):
        if self.versions.get(addr) == to_version:
            return True
        rep = {r.address: r for r in self._router.replicas()}.get(addr)
        if rep is None:
            # left the fleet mid-rollout: nothing to swap
            self._swap_done(addr, to_version, True, note="gone")
            return True
        if int(rep.model_version) == to_version and not rep.reload_failed:
            self._swap_done(addr, to_version, True, why=why,
                            note="already-serving")
            return True
        self._journal({"ev": "swap_start", "addr": addr, "to": to_version})
        self._router.hold_replica(addr)
        try:
            self._intercept("rollout_swap")
            ok, _serving, error = self._swap_fn(addr, to_version)
        except Exception as e:  # noqa: BLE001 - a structured failure
            ok, error = False, "%r" % (e,)
        finally:
            self._router.release_replica(addr)
        self._swap_done(addr, to_version, ok, why=why)
        if not ok:
            self.last_error = "swap %s -> version-%d: %s" % (
                addr, to_version, error)
            logger.error("rollout %s", self.last_error)
        return bool(ok)

    # ------------------------------------------------------ transitions

    def _apply_to_self(self, ev):
        """Apply an event through the replay function recovery uses and
        adopt the result: live and recovered state cannot drift."""
        state = self._state_dict()
        self._apply_event(state, ev)
        self.phase = state["phase"]
        self.target_version = int(state["target"])
        self.old_version = int(state["old"])
        self.plan = list(state["plan"])
        self.versions = dict(state["versions"])
        self.swapped = list(state["swapped"])
        self.baseline = [list(t) for t in state["baseline"]]
        self.verdict = state["verdict"]
        self.wave = int(state["wave"])
        self.wave_committed = int(state["wave_committed"])
        self.wave_addrs = list(state["wave_addrs"])
        self.last_error = state["last_error"]
        self.swaps = int(state["counters"].get("swaps", 0))
        self.rollbacks = int(state["counters"].get("rollbacks", 0))

    def _set_phase(self, phase, why=None):
        ev = {"ev": "phase", "to": phase}
        if why is not None:
            ev["why"] = why
        self._journal(ev)
        self._apply_to_self(ev)

    def _enter_rollback(self, why):
        logger.warning("rollout pausing and rolling back: %s", why)
        if self.swapped:
            self._set_phase(ROLLING_BACK, why=why)
        else:
            # nothing swapped: the fleet never left the old version
            self._abort(why)

    def _abort(self, why):
        logger.error("rollout aborted: %s", why)
        self._set_phase(ABORTED, why=why)

    # ----------------------------------------------------- default calls

    def _call(self, address, method, request, timeout):
        from elasticdl_tpu_torch.proto.service import (
            ServingStub,
            build_channel,
        )

        channel = build_channel(address)
        try:
            return getattr(ServingStub(channel), method)(request,
                                                         timeout=timeout)
        finally:
            channel.close()

    def _default_swap(self, address, version):
        resp = self._call(address, "reload_checkpoint",
                          pb.ReloadCheckpointRequest(version=version),
                          self.config.swap_timeout_secs)
        return bool(resp.ok), int(resp.model_version), resp.error

    def _default_generate(self, address, prompt, max_tokens):
        resp = self._call(address, "generate", pb.GenerateRequest(
            prompt=list(prompt), max_new_tokens=max_tokens,
            temperature=0.0), self.config.rpc_timeout_secs)
        return list(resp.tokens)


def build_rollout(args, router):
    """router_main's constructor from the CLI arguments; None without a
    --rollout_journal_dir (the rollout plane is opt-in)."""
    if not getattr(args, "rollout_journal_dir", ""):
        return None
    prompts = parse_parity_prompts(getattr(args, "rollout_parity_prompts",
                                           ""))
    cfg = RolloutConfig(
        checkpoint_dir=args.rollout_checkpoint_dir,
        journal_dir=args.rollout_journal_dir,
        wave_size=args.rollout_wave_size,
        soak_secs=args.rollout_soak_secs,
        judge_timeout_secs=args.rollout_judge_timeout_secs,
        parity_prompts=prompts or ((1, 2, 3),))
    return RolloutController(router, cfg)


def parse_parity_prompts(text):
    """"1,2,3;4,5" -> ((1, 2, 3), (4, 5)): semicolon-separated
    comma-lists of token ids."""
    prompts = []
    for part in (text or "").split(";"):
        part = part.strip()
        if part:
            prompts.append(tuple(int(t) for t in part.split(",")
                                 if t.strip()))
    return tuple(prompts)
