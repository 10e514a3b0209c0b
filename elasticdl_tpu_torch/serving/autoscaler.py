"""The replica supervisor and autoscaler: the port of
elasticdl_tpu/serving/autoscaler.py.

The router owns the replica REGISTRY (leases, breakers, load signals);
this supervisor owns the replica PROCESSES (`python -m
elasticdl_tpu_torch.serving.main`), holds a desired count and converges
the live roster onto it.

    ReplicaSupervisor --spawn / SIGTERM / SIGKILL--> replica processes
          |  ^                                            |
          |  +-- lease / queue-wait / KV signals -- Router registry
          +------- add_replica / remove_replica ----------+

One single-threaded decide loop runs three passes a tick, so the whole
state machine is clockable:

* **poll**: a STARTING seat that printed `SERVING_READY port=N` is
  ADOPTED (journaled, then registered with the router). A LIVE seat that
  exits is REAPED and replaced; so is a wedged one: a replica that
  self-reports `health_state == "stalled"` is killed after
  `stalled_kill_after_secs`, one that merely goes silent (lease expired
  or breaker stuck open) after the conservative `wedged_after_secs`. A
  DRAINING seat that exits is RETIRED.
* **reconcile**: a deficit spawns one replica a tick, behind a
  full-jitter backoff after failures and a `max_restarts` circuit; a
  surplus drains one a tick (SIGTERM, wait for the exit, retire).
* **policy**: queue-wait / queue-depth pressure sustained for
  `up_window_secs` raises the target; a fleet idle for
  `down_window_secs` lowers it. Decisions need a SETTLED fleet (no seat
  starting or draining), each starts a `cooldown_secs` dead time, and
  min / max bound the target.

Every lifecycle transition is journaled write-ahead through
master/state_store.py; a supervisor restarted over its journal replays
it and RE-ADOPTS still-alive replicas (their pids, and the ready line in
their log files) instead of orphaning or respawning them.

The supervisor's hooks are `supervisor_spawn`, `supervisor_ready` and
`supervisor_adopt` (common/fault_injection.py SUPERVISOR_RPCS). The
port's replicas run the runtime-health plane by default
(observability/runtime_health.py) and report `health_state` "ok" or
"stalled"; one started with `--runtime_health 0` reports "", and on it
only the lease path detects a wedge.
"""

import logging
import os
import random
import signal
import subprocess
import sys
import threading
import time

from elasticdl_tpu_torch.common.fault_injection import FaultInjector
from elasticdl_tpu_torch.master.state_store import JobStateStore
from elasticdl_tpu_torch.proto import messages as pb

logger = logging.getLogger(__name__)

STARTING = "starting"
LIVE = "live"
DRAINING = "draining"


class AutoscalerConfig(object):
    """Policy and supervision knobs, the JAX supervisor's with its
    defaults. up_free_kv_blocks / down_free_kv_blocks (0 = off) gate on
    the decode replicas' free + cached paged-KV blocks;
    stalled_kill_after_secs bounds a self-reported stall,
    wedged_after_secs a silent one."""

    def __init__(self, min_replicas=1, max_replicas=4,
                 decide_secs=0.5,
                 up_queue_wait_ms=200.0, up_queue_depth=4,
                 up_window_secs=2.0, up_free_kv_blocks=0,
                 idle_queue_wait_ms=25.0, down_window_secs=6.0,
                 down_free_kv_blocks=0,
                 cooldown_secs=5.0,
                 ready_timeout_secs=180.0, drain_timeout_secs=60.0,
                 wedged_after_secs=30.0, stalled_kill_after_secs=3.0,
                 max_restarts=3, base_delay_secs=0.2,
                 max_delay_secs=5.0,
                 journal_dir="", snapshot_every=100):
        self.min_replicas = max(0, int(min_replicas))
        self.max_replicas = max(self.min_replicas, int(max_replicas))
        self.decide_secs = float(decide_secs)
        self.up_queue_wait_ms = float(up_queue_wait_ms)
        self.up_queue_depth = int(up_queue_depth)
        self.up_window_secs = float(up_window_secs)
        self.up_free_kv_blocks = int(up_free_kv_blocks)
        self.idle_queue_wait_ms = float(idle_queue_wait_ms)
        self.down_window_secs = float(down_window_secs)
        self.down_free_kv_blocks = int(down_free_kv_blocks)
        self.cooldown_secs = float(cooldown_secs)
        self.ready_timeout_secs = float(ready_timeout_secs)
        self.drain_timeout_secs = float(drain_timeout_secs)
        self.wedged_after_secs = float(wedged_after_secs)
        self.stalled_kill_after_secs = float(stalled_kill_after_secs)
        self.max_restarts = int(max_restarts)
        self.base_delay_secs = float(base_delay_secs)
        self.max_delay_secs = float(max_delay_secs)
        self.journal_dir = journal_dir
        self.snapshot_every = int(snapshot_every)


# ----------------------------------------------------------- launchers


def _pid_alive(pid):
    """(alive, returncode or None) for a pid this process may or may not
    be the parent of: waitpid reaps a child, signal 0 and /proc's state
    cover the rest."""
    try:
        done, status = os.waitpid(pid, os.WNOHANG)
        if done == 0:
            return True, None
        return False, os.waitstatus_to_exitcode(status)
    except ChildProcessError:
        pass
    except OSError:
        return False, None
    try:
        os.kill(pid, 0)
    except OSError:
        return False, None
    try:
        with open("/proc/%d/stat" % pid) as f:
            if f.read().split(")")[-1].split()[0] == "Z":
                return False, None
    except (OSError, IndexError):
        pass
    return True, None


def _scan_ready_line(log_path, marker):
    """The port of the `<marker> port=N` line in a replica's log file, or
    None. A file, not a pipe: a supervisor restarted after the line was
    written still finds it."""
    try:
        with open(log_path, errors="replace") as f:
            for line in f:
                if line.startswith(marker):
                    return int(line.strip().split("port=")[1])
    except (OSError, ValueError, IndexError):
        return None
    return None


class _SpawnedHandle(object):
    """A replica process this supervisor launched (Popen-backed)."""

    def __init__(self, proc, log_path, marker, host):
        self._proc = proc
        self.pid = proc.pid
        self.log_path = log_path
        self._marker = marker
        self._host = host

    def poll(self):
        return self._proc.poll()

    def ready(self):
        port = _scan_ready_line(self.log_path, self._marker)
        return None if port is None else "%s:%d" % (self._host, port)

    def terminate(self):
        if self._proc.poll() is None:
            self._proc.terminate()

    def kill(self):
        if self._proc.poll() is None:
            self._proc.kill()


class _AttachedHandle(object):
    """A replica process inherited from a dead supervisor: a pid to
    watch and its log file for the ready line."""

    def __init__(self, pid, log_path, marker, host):
        self.pid = pid
        self.log_path = log_path
        self._marker = marker
        self._host = host
        self._rc = None
        self._dead = False

    def poll(self):
        if self._dead:
            return self._rc if self._rc is not None else 1
        alive, rc = _pid_alive(self.pid)
        if alive:
            return None
        self._dead = True
        self._rc = rc
        return self._rc if self._rc is not None else 1

    def ready(self):
        if not self.log_path:
            return None
        port = _scan_ready_line(self.log_path, self._marker)
        return None if port is None else "%s:%d" % (self._host, port)

    def _signal(self, sig):
        try:
            os.kill(self.pid, sig)
        except OSError:
            pass

    def terminate(self):
        self._signal(signal.SIGTERM)

    def kill(self):
        self._signal(signal.SIGKILL)


class SubprocessReplicaLauncher(object):
    """Launches `python -m elasticdl_tpu_torch.serving.main
    <replica_args>` with stdout and stderr to a per-seat log file under
    log_dir, never a pipe: a file outlives the supervisor, so its
    successor can read the ready line of a replica it did not spawn."""

    def __init__(self, replica_args, log_dir, env=None,
                 ready_marker="SERVING_READY", host="localhost",
                 cwd=None):
        self.replica_args = list(replica_args)
        self.log_dir = log_dir
        self.env = dict(env) if env is not None else None
        self.ready_marker = ready_marker
        self.host = host
        self.cwd = cwd
        os.makedirs(log_dir, exist_ok=True)

    def _log_path(self, seat_id):
        return os.path.join(self.log_dir, "replica-%d.log" % seat_id)

    def spawn(self, seat_id):
        cmd = ([sys.executable, "-m", "elasticdl_tpu_torch.serving.main"]
               + self.replica_args)
        log_path = self._log_path(seat_id)
        log = open(log_path, "ab")
        try:
            proc = subprocess.Popen(cmd, cwd=self.cwd, env=self.env,
                                    stdout=log, stderr=subprocess.STDOUT)
        finally:
            log.close()  # the child holds its own descriptor
        return _SpawnedHandle(proc, log_path, self.ready_marker, self.host)

    def attach(self, seat_id, pid, log_path):
        return _AttachedHandle(pid, log_path, self.ready_marker, self.host)


# ---------------------------------------------------------- supervisor


class _Seat(object):
    """One replica slot: a process handle and its lifecycle state."""

    __slots__ = ("seat_id", "handle", "state", "address", "spawned_at",
                 "drain_since", "unhealthy_since", "stalled_since")

    def __init__(self, seat_id, handle, state, spawned_at, address=""):
        self.seat_id = seat_id
        self.handle = handle
        self.state = state
        self.address = address
        self.spawned_at = spawned_at
        self.drain_since = None
        self.unhealthy_since = None
        self.stalled_since = None


class ReplicaSupervisor(object):
    """Desired-state supervisor over replica processes and the live
    Router registry. Every transition runs inside `decide_once` under one
    lock, which `status_block()` reads under too. Built over a
    journal_dir that has state, it recovers: live replicas re-adopted,
    dead ones reaped, none respawned twice or orphaned."""

    def __init__(self, router, launcher, config=None,
                 clock=time.monotonic, injector=None, rng=None):
        self.config = config or AutoscalerConfig()
        self._router = router
        self._launcher = launcher
        self._clock = clock
        self._injector = injector or FaultInjector.from_env()
        self._rng = rng or random.Random()
        self._lock = threading.Lock()
        self._seats = {}
        self._next_seat = 0
        self.target = self.config.min_replicas
        self.scale_ups = 0
        self.scale_downs = 0
        self.replacements = 0
        self.spawn_failures = 0
        self.circuit_open = False
        self.last_decision = "init"
        self.last_reason = "supervisor created"
        self.last_decision_at = self._clock()
        self.supervisor_restarts = 0
        # the SLO burn alerting set last logged (advisory only)
        self._slo_alerting = ()
        # hysteresis
        self._above_since = None
        self._idle_since = None
        self._idle_routed = None  # routed count when the fleet went quiet
        self._cooldown_until = 0.0
        self._consec_failures = 0
        self._next_spawn_at = 0.0
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
            else:
                self._journal({"ev": "target", "n": self.target,
                               "why": "init"})

    # ------------------------------------------------------- journaling

    def _journal(self, event):
        if self._store is None:
            return
        if self._store.append(event):
            # compaction waits for the end of the tick: a snapshot
            # between an event and the roster change would drop the seat
            self._compact_pending = True

    def _maybe_compact(self):
        if self._store is not None and self._compact_pending:
            self._store.write_snapshot(self._state_dict())
            self._compact_pending = False

    def _state_dict(self):
        seats = {}
        for seat in self._seats.values():
            seats[str(seat.seat_id)] = {
                "state": seat.state,
                "pid": seat.handle.pid,
                "address": seat.address,
                "log": getattr(seat.handle, "log_path", ""),
            }
        return {
            "target": self.target,
            "next_seat": self._next_seat,
            "seats": seats,
            "counters": {
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "replacements": self.replacements,
                "spawn_failures": self.spawn_failures,
            },
        }

    @staticmethod
    def _apply_event(state, ev):
        """Replay one journal event onto a snapshot dict; transitions of
        unknown seats are no-ops (the snapshot holds them already)."""
        kind = ev.get("ev")
        seats = state["seats"]
        sid = str(ev.get("seat", ""))
        counters = state.setdefault("counters", {})

        def bump(name):
            counters[name] = int(counters.get(name, 0)) + 1

        if kind == "target":
            state["target"] = int(ev["n"])
            if ev.get("why") == "scale_up":
                bump("scale_ups")
            elif ev.get("why") == "scale_down":
                bump("scale_downs")
        elif kind == "spawn":
            state["next_seat"] = max(state.get("next_seat", 0),
                                     int(ev["seat"]) + 1)
        elif kind == "launched":
            seats[sid] = {"state": STARTING, "pid": int(ev["pid"]),
                          "address": "", "log": ev.get("log", "")}
        elif kind == "adopt":
            if sid in seats:
                seats[sid]["state"] = LIVE
                seats[sid]["address"] = ev.get("address", "")
        elif kind == "begin_drain":
            if sid in seats:
                seats[sid]["state"] = DRAINING
        elif kind in ("retire", "reap"):
            if kind == "reap":
                # the `cause` key wins; the why-prefix decodes journals
                # written before it existed
                cause = ev.get("cause")
                if cause is None:
                    why = str(ev.get("why", ""))
                    if why.startswith("exited"):
                        cause = "replacement"
                    elif why == "dead at recovery":
                        cause = "recovery"
                    else:
                        cause = "spawn_failure"
                if cause == "replacement":
                    bump("replacements")
                elif cause == "spawn_failure":
                    bump("spawn_failures")
            seats.pop(sid, None)

    def _recover(self):
        """Rebuild the roster from the journal and re-adopt the replicas
        that outlived the supervisor; reap the dead ones."""
        snapshot, events = self._store.load()
        state = snapshot or {"target": self.target, "next_seat": 0,
                             "seats": {}, "counters": {}}
        for ev in events:
            self._apply_event(state, ev)
        self.target = max(self.config.min_replicas,
                          min(self.config.max_replicas,
                              int(state.get("target", 0))))
        self._next_seat = int(state.get("next_seat", 0))
        counters = state.get("counters", {})
        self.scale_ups = int(counters.get("scale_ups", 0))
        self.scale_downs = int(counters.get("scale_downs", 0))
        self.replacements = int(counters.get("replacements", 0))
        self.spawn_failures = int(counters.get("spawn_failures", 0))
        self.supervisor_restarts = self._store.restart_count
        now = self._clock()
        for sid_text, info in sorted(state.get("seats", {}).items(),
                                     key=lambda kv: int(kv[0])):
            sid = int(sid_text)
            handle = self._launcher.attach(sid, int(info["pid"]),
                                           info.get("log", ""))
            if handle.poll() is not None:
                # died during the outage: reap it and its registration;
                # the deficit path respawns the capacity
                self._journal({"ev": "reap", "seat": sid,
                               "why": "dead at recovery",
                               "cause": "recovery"})
                if info.get("address"):
                    self._router.remove_replica(info["address"])
                continue
            seat = _Seat(sid, handle, info.get("state", STARTING),
                         spawned_at=now, address=info.get("address", ""))
            if seat.state == STARTING:
                # it may have become ready meanwhile: its log remembers
                address = handle.ready()
                if address:
                    seat.address = address
                    seat.state = LIVE
                    self._journal({"ev": "adopt", "seat": sid,
                                   "pid": handle.pid, "address": address})
            if seat.state in (LIVE, DRAINING) and seat.address:
                self._router.add_replica(seat.address)
            self._seats[sid] = seat
            logger.info("autoscaler recovery: re-adopted seat %d pid %d "
                        "(%s, %s)", sid, handle.pid, seat.state,
                        seat.address or "no address yet")
        self._record(now, "recover", "re-adopted %d seats from the journal"
                     % len(self._seats))
        self._maybe_compact()

    # -------------------------------------------------------- lifecycle

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="replica-supervisor")
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.is_set():
            try:
                self.decide_once()
            except Exception:  # noqa: BLE001 - the loop must survive
                logger.exception("autoscaler decide tick failed")
            self._stop.wait(self.config.decide_secs)

    def _join(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None

    def stop(self, grace=60.0):
        """SIGTERM every replica, wait for the drains (then SIGKILL),
        retire the roster and close the journal."""
        self._join()
        with self._lock:
            for seat in self._seats.values():
                seat.handle.terminate()
            deadline = time.monotonic() + grace
            while time.monotonic() < deadline and any(
                    s.handle.poll() is None for s in self._seats.values()):
                time.sleep(0.1)
            for seat in list(self._seats.values()):
                if seat.handle.poll() is None:
                    seat.handle.kill()
                self._journal({"ev": "retire", "seat": seat.seat_id,
                               "why": "supervisor stop"})
                if seat.address:
                    self._router.remove_replica(seat.address)
                del self._seats[seat.seat_id]
            self._maybe_compact()
            if self._store is not None:
                self._store.close()

    def abandon(self):
        """Stop deciding without journaling or touching a replica, as a
        SIGKILL would leave the journal and the processes."""
        self._join()
        if self._store is not None:
            self._store.close()

    # ------------------------------------------------------ decide tick

    def decide_once(self):
        with self._lock:
            now = self._clock()
            self._poll_seats(now)
            self._policy(now)
            self._reconcile(now)
            self._maybe_compact()

    def _intercept(self, name):
        if self._injector is not None:
            self._injector.intercept(name)

    def _record(self, now, decision, reason):
        self.last_decision = decision
        self.last_reason = reason
        self.last_decision_at = now
        logger.info("autoscaler: %s (%s)", decision, reason)

    # ---- pass 1: seat lifecycle

    def _poll_seats(self, now):
        for seat in list(self._seats.values()):
            rc = seat.handle.poll()
            if seat.state == STARTING:
                self._poll_starting(seat, rc, now)
            elif seat.state == LIVE:
                self._poll_live(seat, rc, now)
            else:
                self._poll_draining(seat, rc, now)

    def _poll_starting(self, seat, rc, now):
        if rc is not None:
            self._spawn_failed(seat, now, "died before ready (rc=%s)" % rc)
            return
        if now - seat.spawned_at > self.config.ready_timeout_secs:
            seat.handle.kill()
            self._spawn_failed(seat, now, "not ready after %.0fs"
                               % self.config.ready_timeout_secs)
            return
        address = seat.handle.ready()
        if not address:
            return
        try:
            # slow-ready rules delay here; adopt-drop rules abort the
            # adoption, reaped and respawned like any spawn failure
            self._intercept("supervisor_ready")
            self._intercept("supervisor_adopt")
        except Exception as e:  # noqa: BLE001 - injected faults
            seat.handle.kill()
            self._spawn_failed(seat, now, "adopt failed: %r" % e)
            return
        seat.address = address
        seat.state = LIVE
        self._journal({"ev": "adopt", "seat": seat.seat_id,
                       "pid": seat.handle.pid, "address": address})
        self._router.add_replica(address)
        self._consec_failures = 0
        logger.info("autoscaler: adopted seat %d -> %s (pid %d)",
                    seat.seat_id, address, seat.handle.pid)

    def _poll_live(self, seat, rc, now):
        if rc is not None:
            self._reap_live(seat, now, "exited rc=%s" % rc)
            return
        rep = self._router_view().get(seat.address)
        # the replica's own stall report: direct evidence, seconds
        if rep is not None and rep.health_state == "stalled":
            if seat.stalled_since is None:
                seat.stalled_since = now
            elif (now - seat.stalled_since
                    >= self.config.stalled_kill_after_secs):
                logger.warning(
                    "autoscaler: seat %d (%s) reports stalled for %.1fs "
                    "(last progress %.0fms ago): killing for replacement",
                    seat.seat_id, seat.address, now - seat.stalled_since,
                    rep.last_progress_age_ms)
                seat.handle.kill()  # the exit lands in a later tick
                return
        else:
            seat.stalled_since = None
        # the fallback: a lease that cannot renew or a breaker stuck
        # open, for the conservative wedged_after_secs (under overload a
        # status call can starve behind busy handlers)
        unhealthy = rep is not None and (
            not rep.lease_ok(now) or rep.breaker.state == "open")
        if not unhealthy:
            seat.unhealthy_since = None
            return
        if seat.unhealthy_since is None:
            seat.unhealthy_since = now
            return
        if now - seat.unhealthy_since >= self.config.wedged_after_secs:
            logger.warning("autoscaler: seat %d (%s) wedged for %.1fs: "
                           "killing for replacement", seat.seat_id,
                           seat.address, now - seat.unhealthy_since)
            seat.handle.kill()

    def _poll_draining(self, seat, rc, now):
        if rc is not None:
            self._journal({"ev": "retire", "seat": seat.seat_id, "rc": rc})
            if seat.address:
                self._router.remove_replica(seat.address)
            del self._seats[seat.seat_id]
            logger.info("autoscaler: retired seat %d (rc=%s)",
                        seat.seat_id, rc)
            return
        if (seat.drain_since is not None and now - seat.drain_since
                > self.config.drain_timeout_secs):
            logger.warning("autoscaler: seat %d drain exceeded %.0fs: "
                           "killing", seat.seat_id,
                           self.config.drain_timeout_secs)
            seat.handle.kill()

    def _count_failure(self, now, why):
        """One more consecutive spawn failure: open the circuit at
        max_restarts, else arm the backoff. True when the circuit is
        open."""
        self.spawn_failures += 1
        self._consec_failures += 1
        if self._consec_failures >= self.config.max_restarts:
            if not self.circuit_open:
                self.circuit_open = True
                self._record(now, "circuit_open",
                             "%d consecutive spawn failures (last: %s)"
                             % (self._consec_failures, why))
            return True
        self._next_spawn_at = now + self._backoff(self._consec_failures - 1)
        return False

    def _spawn_failed(self, seat, now, why):
        self._journal({"ev": "reap", "seat": seat.seat_id, "why": why,
                       "cause": "spawn_failure"})
        del self._seats[seat.seat_id]
        if self._count_failure(now, why):
            logger.error("autoscaler: restart circuit OPEN after %d "
                         "consecutive failures", self._consec_failures)
            return
        logger.warning("autoscaler: seat %d spawn failed (%s); retry at "
                       "%.2f (failure %d/%d)", seat.seat_id, why,
                       self._next_spawn_at, self._consec_failures,
                       self.config.max_restarts)

    def _reap_live(self, seat, now, why):
        """Unplanned loss of a LIVE replica: the deficit path respawns
        the capacity."""
        self._journal({"ev": "reap", "seat": seat.seat_id, "why": why,
                       "cause": "replacement"})
        if seat.address:
            self._router.remove_replica(seat.address)
        del self._seats[seat.seat_id]
        self.replacements += 1
        self._record(now, "replace", "seat %d %s" % (seat.seat_id, why))

    def _backoff(self, attempt):
        """Full-jitter exponential backoff on the supervisor's rng."""
        cap = min(self.config.max_delay_secs,
                  self.config.base_delay_secs * (2 ** attempt))
        return self._rng.uniform(0, cap)

    # ---- pass 2: scaling policy

    def _router_view(self):
        return {r.address: r for r in self._router.replicas()}

    def _slo_advisory(self):
        """Log the router's SLO alerting set on each change: advisory
        only, the decisions stay on the queue-wait policy."""
        reports = getattr(self._router, "slo_reports", None)
        if reports is None:
            return
        reports = reports()
        alerting = tuple(sorted(r["name"] for r in reports
                                if r["alerting"]))
        if alerting == self._slo_alerting:
            return
        if alerting:
            logger.warning(
                "autoscaler: SLO burn advisory: %s (advisory only)",
                "; ".join("%s fast=%.1fx slow=%.1fx" % (
                    r["name"], r["fast_burn"], r["slow_burn"])
                    for r in reports if r["alerting"]))
        else:
            logger.info("autoscaler: SLO burn advisory cleared (%s)",
                        ", ".join(self._slo_alerting))
        self._slo_alerting = alerting

    def _reset_windows(self):
        self._above_since = None
        self._idle_since = None
        self._idle_routed = None

    def _policy(self, now):
        self._slo_advisory()
        states = [s.state for s in self._seats.values()]
        live = [s for s in self._seats.values() if s.state == LIVE]
        # decide only on a settled fleet: a spawn or drain in flight is
        # not in the signals yet
        if STARTING in states or DRAINING in states or not live:
            self._reset_windows()
            return
        view = self._router_view()
        sigs = [view[s.address] for s in live if s.address in view]
        if not sigs:
            self._reset_windows()
            return
        cfg = self.config
        # a disaggregated fleet reads prompt pressure on its prefill
        # pool, decode pressure as KV headroom
        prefill_sigs = [r for r in sigs if getattr(r, "role", "") == "prefill"]
        decode_sigs = [r for r in sigs if getattr(r, "role", "") != "prefill"]
        wait_sigs = prefill_sigs or sigs
        busiest_wait = max(r.queue_wait_ms for r in wait_sigs)
        deepest_queue = max(r.queue_depth for r in wait_sigs)
        quiet = all(r.queue_depth == 0 and r.inflight == 0
                    and r.active_slots == 0 for r in sigs)
        kv_pressure = False
        if cfg.up_free_kv_blocks > 0 and decode_sigs:
            kv_pressure = sum(r.kv_blocks_free + r.kv_blocks_cached
                              for r in decode_sigs) < cfg.up_free_kv_blocks
        # the wait EWMA lags: alone, over an empty fleet, it is history
        pressure = ((not quiet and busiest_wait >= cfg.up_queue_wait_ms)
                    or deepest_queue >= cfg.up_queue_depth
                    or kv_pressure)
        # a burst that stops dead freezes the EWMA high: no routed
        # traffic across the idle window is evidence of idleness too
        routed = self._router.telemetry.snapshot()["routed"]
        ewma_ok = busiest_wait <= cfg.idle_queue_wait_ms
        no_traffic = (self._idle_routed is not None
                      and routed == self._idle_routed)
        idle = quiet and (ewma_ok or no_traffic)
        if cfg.down_free_kv_blocks > 0:
            # cached refcount-0 chains are evictable: headroom too
            idle = idle and sum(r.kv_blocks_free + r.kv_blocks_cached
                                for r in sigs) >= cfg.down_free_kv_blocks
        self._above_since = (self._above_since or now) if pressure else None
        if quiet:
            if self._idle_routed is None:
                self._idle_routed = routed
        else:
            self._idle_routed = None
        self._idle_since = (self._idle_since or now) if idle else None
        if now < self._cooldown_until:
            return
        if (self._above_since is not None
                and now - self._above_since >= cfg.up_window_secs
                and self.target < cfg.max_replicas):
            self.target += 1
            self.scale_ups += 1
            self._cooldown_until = now + cfg.cooldown_secs
            self._above_since = None
            self._record(now, "scale_up",
                         "queue_wait %.0fms / depth %d%s sustained %.1fs -> "
                         "target %d" % (busiest_wait, deepest_queue,
                                        " / decode KV headroom low"
                                        if kv_pressure else "",
                                        cfg.up_window_secs, self.target))
            self._journal({"ev": "target", "n": self.target,
                           "why": "scale_up"})
        elif (self._idle_since is not None
                and now - self._idle_since >= cfg.down_window_secs
                and self.target > cfg.min_replicas):
            self.target -= 1
            self.scale_downs += 1
            self._cooldown_until = now + cfg.cooldown_secs
            self._idle_since = None
            self._record(now, "scale_down", "fleet idle %.1fs -> target %d"
                         % (cfg.down_window_secs, self.target))
            self._journal({"ev": "target", "n": self.target,
                           "why": "scale_down"})

    # ---- pass 3: converge the roster onto the target

    def _reconcile(self, now):
        active = [s for s in self._seats.values()
                  if s.state in (STARTING, LIVE)]
        if len(active) < self.target:
            if self.circuit_open or now < self._next_spawn_at:
                return
            self._spawn(now)
        elif len(active) > self.target:
            self._shrink_one(now)

    def _spawn(self, now):
        seat_id = self._next_seat
        self._next_seat += 1
        self._journal({"ev": "spawn", "seat": seat_id})
        try:
            self._intercept("supervisor_spawn")
            handle = self._launcher.spawn(seat_id)
        except Exception as e:  # noqa: BLE001 - spawn-failure drills
            self._journal({"ev": "reap", "seat": seat_id,
                           "why": "spawn raised: %r" % e,
                           "cause": "spawn_failure"})
            self._count_failure(now, "%r" % (e,))
            logger.warning("autoscaler: spawn of seat %d failed: %r",
                           seat_id, e)
            return
        self._journal({"ev": "launched", "seat": seat_id, "pid": handle.pid,
                       "log": getattr(handle, "log_path", "")})
        self._seats[seat_id] = _Seat(seat_id, handle, STARTING,
                                     spawned_at=now)
        logger.info("autoscaler: spawned seat %d (pid %d)", seat_id,
                    handle.pid)

    def _shrink_one(self, now):
        # a seat that never went live first (nothing to drain), then the
        # least-loaded live seat, newest first
        starting = [s for s in self._seats.values() if s.state == STARTING]
        if starting:
            seat = max(starting, key=lambda s: s.seat_id)
            seat.handle.kill()
            seat.state = DRAINING  # the exit retires it
            seat.drain_since = now
            self._journal({"ev": "begin_drain", "seat": seat.seat_id,
                           "why": "surplus before ready"})
            return
        view = self._router_view()

        def load(seat):
            rep = view.get(seat.address)
            if rep is None:
                return (0, -seat.seat_id)
            return (rep.queue_depth + rep.active_slots + rep.inflight,
                    -seat.seat_id)

        live = [s for s in self._seats.values() if s.state == LIVE]
        if live:
            self._begin_drain(min(live, key=load), now)

    def _begin_drain(self, seat, now):
        self._journal({"ev": "begin_drain", "seat": seat.seat_id})
        seat.state = DRAINING
        seat.drain_since = now
        # SIGTERM: the replica closes admission, advertises draining,
        # finishes its in-flight work and exits 0; the exit retires it
        seat.handle.terminate()
        logger.info("autoscaler: draining seat %d (%s)", seat.seat_id,
                    seat.address)

    # ----------------------------------------------------------- status

    def counts(self):
        with self._lock:
            return {state: sum(1 for s in self._seats.values()
                               if s.state == state)
                    for state in (STARTING, LIVE, DRAINING)}

    def roster(self):
        """The seats, by seat id."""
        with self._lock:
            return [{"seat": s.seat_id, "state": s.state,
                     "pid": s.handle.pid, "address": s.address}
                    for s in sorted(self._seats.values(),
                                    key=lambda s: s.seat_id)]

    def status_block(self):
        """The router_status autoscaler block."""
        with self._lock:
            now = self._clock()
            n = {state: 0 for state in (STARTING, LIVE, DRAINING)}
            for seat in self._seats.values():
                n[seat.state] += 1
            return pb.AutoscalerStatus(
                enabled=True, target=self.target, live=n[LIVE],
                starting=n[STARTING], draining=n[DRAINING],
                scale_ups=self.scale_ups, scale_downs=self.scale_downs,
                replacements=self.replacements,
                spawn_failures=self.spawn_failures,
                circuit_open=self.circuit_open,
                last_decision=self.last_decision,
                last_reason=self.last_reason,
                last_decision_age_secs=max(0.0,
                                           now - self.last_decision_at),
                supervisor_restarts=self.supervisor_restarts)
