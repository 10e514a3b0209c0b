"""The runtime-health plane of the PyTorch port: the port of
elasticdl_tpu/observability/runtime_health.py (the recompile sentry, the
device-memory ledger, the progress watchdog with its flight recorder,
the diagnostic bundle and the SIGUSR2 stack dump). No torch is imported
at module level: the collector CLI installs the SIGUSR2 dump without it.

Three layers behind one `ServingConfig.runtime_health` switch:

* **RecompileSentry** with `tracked_call` -- the counterpart of
  `tracked_jit`. The port has no jit; a "compile" is the exact condition
  under which `jax.jit` would trace again: a call signature a tracked
  site has not seen before. A tensor (or a numpy array) contributes its
  shape, dtype and device, a static argument its value, any other
  Python argument only its type; the walk goes into lists, tuples and
  dicts. A second compile of a name is a RECOMPILE, and after
  `mark_steady()` a STEADY RECOMPILE: a counted, logged, trace-evented
  anomaly in the family `edl_serving_recompiles_total{fn=}`. On the card
  this is the port's shape-churn count: the captures a captured step
  would pay. A kernel build (ops/_build.py: nvcc at first use) is not a
  compile; the sentry's snapshot and the bundle carry the builds under
  their own key, `builds`.

* **DeviceMemoryAccountant** -- reconciles the runtime's byte ledger
  (the KV pool's bytes, the host tier's, the parameters and buffers of
  the model and the draft, deduplicated by storage, and the draft's
  pool) against the allocator's view: `torch.cuda.memory_allocated` on
  the card (never `memory_reserved`: the caching allocator keeps
  reserved bytes), the deduplicated storages of live CPU tensors
  otherwise. Drift since the steady baseline lands in
  `memory_unaccounted_bytes` with a monotone peak. The `health_leak`
  fault hook leaks 8 MiB on purpose, so a drill can prove the
  accountant convicts it.

* **ProgressWatchdog + FlightRecorder** -- a bounded ring of per-tick
  engine snapshots fed by the scheduler, and a watchdog on its own
  thread that reads `stalled` only when work is seated or queued and the
  progress counter (tokens committed plus compiles plus finished kernel
  builds) has not moved for `stall_after_secs`; a kernel build in flight
  and a tracked site's first run of a new signature (the cold launch
  that is the port's counterpart of a compile) count as progress all
  along, so a replica that builds or warms at first use with work seated
  is not a stalled one. Idle is healthy. On the
  transition to stalled it dumps a diagnostic bundle to
  $EDL_HEALTH_DIR: all-thread stacks, the ring, the pool ledger, the
  reconciliation, the recompile counters and the builds.
  `health_state` and `last_progress_age_ms` ride ServerStatus so the
  autoscaler replaces a self-reported stalled replica in seconds.

Thread model: the scheduler feeds (`record_tick`; tracked calls run on
it), the health thread checks and reconciles, status threads read
snapshots; every structure has its own lock. The health thread's CUDA
calls read allocator counters only, which never synchronize the
scheduler's stream.

`install_sigusr2_dump()` is what every long-running entry point
registers: SIGUSR2 dumps all threads' stacks to stderr, or to
`$EDL_HEALTH_DIR/sigusr2-<pid>.txt`, without stopping the process.
"""

import faulthandler
import io
import json
import logging
import os
import signal
import sys
import threading
import time
import traceback
from collections import deque

logger = logging.getLogger(__name__)

HEALTH_DIR_ENV = "EDL_HEALTH_DIR"
HEALTH_ENV = "EDL_RUNTIME_HEALTH"
STALL_AFTER_ENV = "EDL_STALL_AFTER_SECS"

#: the closed health-state set (ServerStatus.health_state); "" on the
#: wire means a replica with the plane off: the autoscaler's cue to fall
#: back to lease decay
HEALTH_STATES = ("ok", "stalled")

BUNDLE_SCHEMA = "edl-health-bundle/1"


def runtime_health_default():
    """EDL_RUNTIME_HEALTH resolves the plane when the config leaves it
    unset: on unless it is "0"."""
    return os.environ.get(HEALTH_ENV, "1") != "0"


def stall_after_default():
    """EDL_STALL_AFTER_SECS resolves the watchdog budget when the config
    leaves it unset (default 10 s: far above a healthy step, far below
    the autoscaler's 30 s lease heuristic)."""
    try:
        return float(os.environ.get(STALL_AFTER_ENV, "") or 10.0)
    except ValueError:
        return 10.0


def health_dir_default():
    """$EDL_HEALTH_DIR, or "" = bundles off (stalls still count and
    advertise; only the dump is skipped)."""
    return os.environ.get(HEALTH_DIR_ENV, "")


# ------------------------------------------------------ recompile sentry


class RecompileSentry(object):
    """Per-named-site compile counts with a steady-state boundary, as in
    the JAX package: a COMPILE is a new call signature of a tracked
    site, a RECOMPILE a compile of a name compiled before, a STEADY
    RECOMPILE one after `mark_steady()`. First compiles of a new name
    after the boundary are the cold path (a prefill bucket first used
    mid-serve), not churn. `builds_fn` (a zero-argument callable) adds
    the process's kernel builds under `builds` in the snapshot."""

    #: anomaly ring bound
    MAX_ANOMALIES = 256

    def __init__(self, clock=time.monotonic, builds_fn=None):
        self._lock = threading.Lock()
        self._clock = clock
        self._builds_fn = builds_fn
        self.compiles = {}  # fn name -> compile count
        self.recompiles = 0
        self.steady_recompiles = 0
        self.steady_at = None
        self.anomalies = deque(maxlen=self.MAX_ANOMALIES)
        # first calls of a new signature running now (tracked_call): the
        # port's counterpart of a compile in progress
        self.compiling = 0

    def compile_started(self):
        with self._lock:
            self.compiling += 1

    def compile_finished(self):
        with self._lock:
            self.compiling -= 1

    def record_compile(self, name):
        anomaly = False
        with self._lock:
            n = self.compiles.get(name, 0) + 1
            self.compiles[name] = n
            if n > 1:
                self.recompiles += 1
                if self.steady_at is not None:
                    self.steady_recompiles += 1
                    self.anomalies.append(
                        {"fn": name, "count": n, "at": self._clock()})
                    anomaly = True
        if anomaly:
            try:
                from elasticdl_tpu_torch.observability.tracing import (
                    recorder,
                )

                recorder().start_span(
                    "recompile_anomaly", fn=name, compile_count=n,
                ).finish("anomaly")
            except Exception:  # noqa: BLE001 - never fail a tracked call
                pass
            logger.warning(
                "runtime health: STEADY-STATE RECOMPILE of %r (compile #%d):"
                " the zero-recompile invariant is broken", name, n)

    def mark_steady(self):
        """Declare the warmup over. Idempotent: the first mark wins."""
        with self._lock:
            if self.steady_at is None:
                self.steady_at = self._clock()

    def total_compiles(self):
        with self._lock:
            return sum(self.compiles.values())

    def snapshot(self):
        with self._lock:
            snap = {
                "compiles": dict(self.compiles),
                "total_compiles": sum(self.compiles.values()),
                "recompiles": self.recompiles,
                "steady_recompiles": self.steady_recompiles,
                "steady_marked": self.steady_at is not None,
                "anomalies": list(self.anomalies),
            }
        snap["builds"] = (self._builds_fn() if self._builds_fn is not None
                          else None)
        return snap

    def prometheus(self):
        """The closed labeled family: one `fn` series per tracked name
        that compiled at least once."""
        from elasticdl_tpu_torch.observability.metrics import (
            labeled_counter_family,
        )

        with self._lock:
            series = [({"fn": name}, n)
                      for name, n in sorted(self.compiles.items())]
        return [labeled_counter_family(
            "edl_serving_recompiles_total",
            "jit compilations per named executable (recompile sentry; "
            "count > 1 for any fn = the zero-recompile invariant is "
            "broken)",
            series,
        )]


def _arg_signature(x, tensor_type, array_type):
    if tensor_type is not None and isinstance(x, tensor_type):
        return (x.shape, x.dtype, x.device)
    t = type(x)
    if t is list or t is tuple:
        return (t, tuple(_arg_signature(v, tensor_type, array_type)
                         for v in x))
    if t is dict:
        return (t, tuple((k, _arg_signature(v, tensor_type, array_type))
                         for k, v in sorted(x.items())))
    if array_type is not None and t is array_type:
        return (x.shape, x.dtype, "cpu")
    return t


class _TrackedCall(object):
    """`fn` behind the sentry's compile condition (see tracked_call)."""

    def __init__(self, fn, name, sentry, static_argnums, static_argnames):
        self.fn = fn
        self.name = name
        self._sentry = sentry
        self._static_argnums = frozenset(static_argnums)
        self._static_argnames = frozenset(static_argnames)
        self._seen = set()

    def signature(self, args, kwargs):
        mods = sys.modules
        torch_mod, np_mod = mods.get("torch"), mods.get("numpy")
        tt = torch_mod.Tensor if torch_mod is not None else None
        at = np_mod.ndarray if np_mod is not None else None
        statics = self._static_argnums
        sig = tuple(a if i in statics else _arg_signature(a, tt, at)
                    for i, a in enumerate(args))
        if kwargs:
            names = self._static_argnames
            sig += tuple((k, v if k in names else _arg_signature(v, tt, at))
                         for k, v in sorted(kwargs.items()))
        return sig

    def __call__(self, *args, **kwargs):
        sig = self.signature(args, kwargs)
        if sig in self._seen:
            return self.fn(*args, **kwargs)
        self._seen.add(sig)
        s = self._sentry() if callable(self._sentry) else self._sentry
        if s is None:
            return self.fn(*args, **kwargs)
        s.record_compile(self.name)
        # the first run of a signature is the compile's counterpart (a
        # cold first launch: module loads, library handles): in flight,
        # it is progress
        s.compile_started()
        try:
            return self.fn(*args, **kwargs)
        finally:
            s.compile_finished()


def tracked_call(fn, name, sentry, static_argnums=(), static_argnames=()):
    """`fn` with compile counting, the port's `tracked_jit`: a call whose
    signature this wrapper has not seen is a compile of `name`, recorded
    in `sentry` (a RecompileSentry, None = counting off, or a zero-arg
    callable resolving to either at call time, so a wrapper made before
    the server attaches its sentry still counts). The signature: each
    tensor's (shape, dtype, device), a numpy array's (shape, dtype), the
    value of an argument named in `static_argnums` / `static_argnames`,
    the type of any other argument, through lists, tuples and dicts. One
    wrapper keeps its own seen set, as one jitted function keeps its own
    cache."""
    return _TrackedCall(fn, name, sentry, static_argnums, static_argnames)


# -------------------------------------------------- memory accountant


def _live_bytes(device=None):
    """(bytes the allocator holds for live tensors, integer allocator
    stats or None). On CUDA: `memory_allocated(device)` and the integer
    fields of `memory_stats(device)`; otherwise the deduplicated storages
    of live CPU tensors (the counterpart of `jax.live_arrays()`)."""
    import gc

    import torch

    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        live = int(torch.cuda.memory_allocated(dev))
        try:
            stats = {k: int(v) for k, v in
                     torch.cuda.memory_stats(dev).items()
                     if isinstance(v, int)}
        except Exception:  # noqa: BLE001 - an allocator without stats
            stats = None
        return live, stats
    seen, live = set(), 0
    tensor = torch.Tensor
    for obj in gc.get_objects():
        # the type, not isinstance: some module proxies warn on __class__
        if not issubclass(type(obj), tensor):
            continue
        try:
            if obj.device.type != "cpu":
                continue
            storage = obj.untyped_storage()
            key = storage.data_ptr()
            if key in seen or not key:
                continue
            seen.add(key)
            live += int(storage.nbytes())
        except Exception:  # noqa: BLE001 - a tensor torn down mid-walk
            continue
    return live, None


def _tensor_bytes(tensors, seen):
    total = 0
    for t in tensors:
        try:
            storage = t.untyped_storage()
        except Exception:  # noqa: BLE001 - not a tensor with storage
            continue
        key = storage.data_ptr()
        if key in seen:
            continue  # one storage behind two names
        seen.add(key)
        total += int(storage.nbytes())
    return total


class DeviceMemoryAccountant(object):
    """Reconciles the runtime's byte ledger against the allocator:

        unaccounted = max(0, (live - ledger) - baseline)

    baselined at `rebase()` (the steady boundary), with a monotone peak.
    `live_bytes_fn` (zero-arg, returning (live, stats)) is injectable;
    the default reads the engine's device (`_live_bytes`)."""

    def __init__(self, engine, live_bytes_fn=None):
        self._engine = engine
        self._live_bytes = live_bytes_fn or (
            lambda: _live_bytes(getattr(engine, "device", None)))
        self._lock = threading.Lock()
        self._baseline = None
        self.unaccounted_bytes = 0
        self.unaccounted_peak_bytes = 0
        self.reconciles = 0
        self.last = {}
        # the drill's deliberate leak, held here: absent from every line
        self._leaked = []

    def _param_bytes(self):
        """The parameters and buffers of the served model (its matmul
        and embedding weights are the compute-dtype copies
        `use_compute_weights` made in place) and of the draft, each
        storage once."""
        seen, total = set(), 0
        for attr in ("model", "_draft"):
            module = getattr(self._engine, attr, None)
            if module is None or not hasattr(module, "parameters"):
                continue
            total += _tensor_bytes(module.parameters(), seen)
            total += _tensor_bytes(module.buffers(), seen)
        return total

    def _draft_pool_bytes(self):
        pool = getattr(self._engine, "_d_pool", None)
        if pool is None:
            return 0
        return _tensor_bytes((leaf for layer in pool for leaf in layer),
                             set())

    def ledger(self):
        """The bytes the runtime can name, by line item."""
        kv = self._engine.kv_stats()
        return {
            "kv_bytes_total": int(kv.get("kv_bytes_total", 0)),
            "kv_host_bytes": int(kv.get("kv_host_bytes", 0)),
            "param_bytes": self._param_bytes(),
            "draft_pool_bytes": self._draft_pool_bytes(),
        }

    def reconcile(self, now=None):
        """One pass: updates the drift gauge and peak; returns the view."""
        ledger = self.ledger()
        ledger_total = sum(ledger.values())
        live, device_stats = self._live_bytes()
        raw_gap = live - ledger_total
        with self._lock:
            if self._baseline is None:
                self._baseline = raw_gap
            unaccounted = max(0, raw_gap - self._baseline)
            self.unaccounted_bytes = unaccounted
            self.unaccounted_peak_bytes = max(self.unaccounted_peak_bytes,
                                              unaccounted)
            self.reconciles += 1
            self.last = {
                "ledger": ledger,
                "ledger_bytes": ledger_total,
                "live_bytes": live,
                "baseline_gap_bytes": self._baseline,
                "unaccounted_bytes": unaccounted,
                "unaccounted_peak_bytes": self.unaccounted_peak_bytes,
                "device_stats": device_stats,
            }
            return dict(self.last)

    def rebase(self):
        """Re-baseline at the current gap (the steady boundary); the peak
        resets: it answers 'has it drifted since steady'."""
        ledger_total = sum(self.ledger().values())
        live, _ = self._live_bytes()
        with self._lock:
            self._baseline = live - ledger_total
            self.unaccounted_bytes = 0
            self.unaccounted_peak_bytes = 0

    def leak_for_drill(self, nbytes):
        """Allocate and hold a buffer on the engine's device that no
        ledger line names (only the health_leak hook calls this)."""
        import torch

        buf = torch.zeros(max(1, int(nbytes)), dtype=torch.int8,
                          device=getattr(self._engine, "device", "cpu"))
        with self._lock:
            self._leaked.append(buf)
        logger.warning("runtime health: health_leak fault leaked %d device "
                       "bytes on purpose", buf.numel())
        return int(buf.numel())

    def snapshot(self):
        with self._lock:
            return {
                "unaccounted_bytes": self.unaccounted_bytes,
                "unaccounted_peak_bytes": self.unaccounted_peak_bytes,
                "reconciles": self.reconciles,
                "leaked_buffers": len(self._leaked),
                "last": dict(self.last),
            }


# ---------------------------------------------- watchdog + flight ring


class FlightRecorder(object):
    """Bounded ring of per-tick engine snapshots: drop-oldest, with a
    monotone `dropped`."""

    def __init__(self, capacity=256):
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._ring = deque(maxlen=self.capacity)
        self.recorded = 0
        self.dropped = 0

    def record(self, snap):
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(dict(snap))
            self.recorded += 1

    def snapshot(self):
        with self._lock:
            return [dict(s) for s in self._ring]


class ProgressWatchdog(object):
    """Stall = work seated or queued while the progress counter has not
    moved for `stall_after_secs`; idle is healthy. `observe()` returns
    True exactly on the ok -> stalled transition. `busy` (the port's
    addition: a kernel build in flight) counts as progress, as a change
    of the counter does."""

    def __init__(self, stall_after_secs=10.0, clock=time.monotonic):
        self.stall_after_secs = float(stall_after_secs)
        self._clock = clock
        self._lock = threading.Lock()
        self.state = "ok"
        self.stalls = 0
        self._last_progress_at = clock()
        self._last_counter = None
        self._last_work = 0

    def observe(self, work, progress_counter, now=None, busy=False):
        now = self._clock() if now is None else now
        with self._lock:
            if (busy or self._last_counter is None
                    or progress_counter != self._last_counter
                    or not work):
                self._last_progress_at = now
            self._last_counter = progress_counter
            self._last_work = work
            age = now - self._last_progress_at
            stalled = bool(work) and age >= self.stall_after_secs
            transition = stalled and self.state != "stalled"
            self.state = "stalled" if stalled else "ok"
            if transition:
                self.stalls += 1
            return transition

    def last_progress_age_ms(self, now=None):
        """Ms since progress last moved with work present; 0 when idle."""
        now = self._clock() if now is None else now
        with self._lock:
            if not self._last_work:
                return 0.0
            return max(0.0, (now - self._last_progress_at) * 1000.0)

    def snapshot(self, now=None):
        now = self._clock() if now is None else now
        with self._lock:
            age = (max(0.0, (now - self._last_progress_at) * 1000.0)
                   if self._last_work else 0.0)
            return {
                "state": self.state,
                "stalls": self.stalls,
                "last_progress_age_ms": age,
                "stall_after_secs": self.stall_after_secs,
            }


# ------------------------------------------------------- bundle writer


def _all_thread_stacks():
    """faulthandler's raw all-thread dump plus a named python-level
    walk (the part that makes a bundle readable)."""
    fh = ""
    try:
        buf = io.StringIO()
        faulthandler.dump_traceback(file=buf, all_threads=True)
        fh = buf.getvalue()
    except Exception:  # noqa: BLE001 - a StringIO has no file descriptor
        fh = ""
    names = {t.ident: t.name for t in threading.enumerate()}
    try:
        frames = sys._current_frames()
    except Exception:  # noqa: BLE001 - best effort
        frames = {}
    threads = [{"thread": names.get(ident, "ident-%s" % ident),
                "stack": traceback.format_stack(frame)}
               for ident, frame in frames.items()]
    return {"faulthandler": fh, "threads": threads}


#: required bundle keys -> required type (the schema gate)
_BUNDLE_SCHEMA_KEYS = {
    "schema": str,
    "reason": str,
    "pid": int,
    "unix_ts": float,
    "health": dict,
    "ring": list,
    "kv_ledger": dict,
    "memory": dict,
    "recompiles": dict,
    "stacks": dict,
}


def validate_bundle(bundle):
    """The problems of a diagnostic bundle dict ([] = valid)."""
    problems = []
    if not isinstance(bundle, dict):
        return ["bundle is not a dict"]
    for key, typ in _BUNDLE_SCHEMA_KEYS.items():
        if key not in bundle:
            problems.append("missing key %r" % key)
        elif not isinstance(bundle[key], typ):
            problems.append("key %r: expected %s, got %s"
                            % (key, typ.__name__, type(bundle[key]).__name__))
    if bundle.get("schema") != BUNDLE_SCHEMA:
        problems.append("schema %r != %r"
                        % (bundle.get("schema"), BUNDLE_SCHEMA))
    stacks = bundle.get("stacks")
    if isinstance(stacks, dict) and not (
            stacks.get("faulthandler") or stacks.get("threads")):
        problems.append("stacks carry neither faulthandler text nor a "
                        "thread walk")
    return problems


def write_bundle(health_dir, bundle):
    """Atomic (tmp + rename) JSON dump; returns the final path."""
    os.makedirs(health_dir, exist_ok=True)
    name = "health-bundle-%d-%d.json" % (bundle.get("pid", os.getpid()),
                                         bundle.get("seq", 0))
    path = os.path.join(health_dir, name)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(bundle, f, indent=1, default=str)
    os.replace(tmp, path)
    return path


def kernel_builds():
    """The process's kernel builds (ops/_build.py's build_stats)."""
    from elasticdl_tpu_torch.ops import _build

    return _build.build_stats()


# --------------------------------------------------------- the owner


class RuntimeHealth(object):
    """The plane's owner: one sentry, accountant, watchdog and flight
    ring, and the daemon thread that checks and reconciles apart from
    the scheduler. GenerationServer builds it when
    `ServingConfig.runtime_health` is on, attaches `self.sentry` to the
    engine (which forwards it to the pool and the offline decode
    sites), hands `record_tick` to the scheduler and reads `snapshot()`
    for ServerStatus. The telemetry's counters and gauges get deltas of
    the sentry's and the watchdog's counts. `builds_fn` reads the
    process's kernel builds (default: ops/_build.py's)."""

    def __init__(self, engine, queue, telemetry, stall_after_secs=None,
                 check_secs=0.25, reconcile_secs=2.0, ring_capacity=256,
                 health_dir=None, injector=None, clock=time.monotonic,
                 live_bytes_fn=None, builds_fn=kernel_builds):
        self._engine = engine
        self._queue = queue
        self._telemetry = telemetry
        self._clock = clock
        self.check_secs = float(check_secs)
        self.reconcile_secs = float(reconcile_secs)
        self.health_dir = (health_dir_default() if health_dir is None
                           else health_dir)
        self._injector = injector
        self._builds_fn = builds_fn
        self.sentry = RecompileSentry(clock=clock, builds_fn=builds_fn)
        self.accountant = DeviceMemoryAccountant(engine,
                                                 live_bytes_fn=live_bytes_fn)
        self.watchdog = ProgressWatchdog(
            stall_after_default() if stall_after_secs is None
            else stall_after_secs, clock=clock)
        self.recorder = FlightRecorder(capacity=ring_capacity)
        self.bundles = []
        self._bundle_seq = 0
        self._steady_seen = 0
        self._last_reconcile = 0.0
        self._stop = threading.Event()
        self._thread = None

    # ------------------------------------------------------ lifecycle

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="runtime-health")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def _run(self):
        while not self._stop.is_set():
            try:
                now = self._clock()
                self.check(now)
                if now - self._last_reconcile >= self.reconcile_secs:
                    self.reconcile(now)
                    self._last_reconcile = now
            except Exception:  # noqa: BLE001 - the loop must survive
                logger.exception("runtime health tick failed")
            self._stop.wait(self.check_secs)

    # ------------------------------------------------------- feeding

    def mark_steady(self):
        """The post-warmup boundary: recompiles become anomalies and the
        memory baseline re-anchors."""
        self.sentry.mark_steady()
        try:
            self.accountant.rebase()
        except Exception:  # noqa: BLE001 - a bare test engine
            logger.exception("runtime health: rebase failed")

    def record_tick(self, queue_depth, active_slots, step_secs,
                    tokens_committed):
        """One scheduler tick into the flight ring (scheduler thread)."""
        try:
            kv = self._engine.kv_stats()
        except Exception:  # noqa: BLE001 - mid-teardown
            kv = {}
        self.recorder.record({
            "t": self._clock(),
            "queue_depth": int(queue_depth),
            "active_slots": int(active_slots),
            "step_ms": round(float(step_secs) * 1000.0, 3),
            "tokens_committed": int(tokens_committed),
            "kv_blocks_free": kv.get("kv_blocks_free", 0),
            "kv_blocks_cached": kv.get("kv_blocks_cached", 0),
            "kv_host_blocks": kv.get("kv_host_blocks", 0),
            "kv_bytes_in_use": kv.get("kv_bytes_in_use", 0),
        })

    # ------------------------------------------------------- checking

    def _builds(self):
        try:
            return self._builds_fn() if self._builds_fn is not None else None
        except Exception:  # noqa: BLE001 - never fail a check
            return None

    def _progress(self):
        """(tokens committed + compiles + finished builds, a build or a
        compile's first run in flight). The counter reads are lock-free
        int fetches: a stale one delays detection by one check, never
        fabricates a stall."""
        tokens = self._telemetry.counters.get("tokens_generated", 0)
        builds = self._builds() or {}
        return (tokens + self.sentry.total_compiles()
                + int(builds.get("finished", 0)),
                bool(builds.get("in_flight")) or self.sentry.compiling > 0)

    def _work_present(self):
        try:
            seated = self._engine.active_count()
        except Exception:  # noqa: BLE001 - mid-teardown
            seated = 0
        try:
            queued = len(self._queue)
        except Exception:  # noqa: BLE001
            queued = 0
        return seated + queued

    def check(self, now=None):
        """One watchdog evaluation (the health thread, or a status read).
        On the ok -> stalled transition: count the stall, log it, dump
        the bundle."""
        now = self._clock() if now is None else now
        counter, building = self._progress()
        transition = self.watchdog.observe(self._work_present(), counter,
                                           now=now, busy=building)
        if transition:
            self._telemetry.count("stalls")
            age_ms = self.watchdog.last_progress_age_ms(now)
            try:
                from elasticdl_tpu_torch.observability.tracing import (
                    recorder,
                )

                recorder().start_span("progress_stall",
                                      age_ms=age_ms).finish("stalled")
            except Exception:  # noqa: BLE001 - best effort
                pass
            logger.warning("runtime health: progress stall (no progress for "
                           "%.0f ms with work seated)", age_ms)
            self.dump_bundle("progress_stall", now=now)
        return transition

    def reconcile(self, now=None):
        """One reconciliation and telemetry mirror pass. The health_leak
        hook fires here, after the steady boundary only."""
        self._maybe_leak()
        try:
            self.accountant.reconcile(now)
        except Exception:  # noqa: BLE001 - bare test engines
            logger.exception("runtime health: reconcile failed")
        snap = self.accountant.snapshot()
        self._telemetry.gauge("memory_unaccounted_bytes",
                              snap["unaccounted_peak_bytes"])
        self._telemetry.gauge("last_progress_age_ms",
                              self.watchdog.last_progress_age_ms(now))
        steady = self.sentry.snapshot()["steady_recompiles"]
        if steady > self._steady_seen:
            self._telemetry.count("steady_recompiles",
                                  steady - self._steady_seen)
            self._steady_seen = steady

    def _maybe_leak(self):
        if (self._injector is None
                or not self.sentry.snapshot()["steady_marked"]):
            return
        try:
            self._injector.intercept("health_leak")
        except Exception:  # noqa: BLE001 - the armed rule fired
            self.accountant.leak_for_drill(8 << 20)

    # ------------------------------------------------------- reading

    def health_state(self, now=None):
        return self.watchdog.state

    def snapshot(self, now=None):
        now = self._clock() if now is None else now
        wd = self.watchdog.snapshot(now)
        sentry = self.sentry.snapshot()
        mem = self.accountant.snapshot()
        return {
            "health_state": wd["state"],
            "last_progress_age_ms": wd["last_progress_age_ms"],
            "stalls": wd["stalls"],
            "jit_compiles": sentry["total_compiles"],
            "recompiles": sentry["recompiles"],
            "steady_recompiles": sentry["steady_recompiles"],
            "steady_marked": sentry["steady_marked"],
            "memory_unaccounted_bytes": mem["unaccounted_peak_bytes"],
            "bundles": list(self.bundles),
            "ring_recorded": self.recorder.recorded,
        }

    def prometheus(self):
        """The per-fn recompile family (the scalar gauges and counters
        ride the telemetry's closed sets)."""
        return self.sentry.prometheus()

    # --------------------------------------------------------- bundle

    def dump_bundle(self, reason, now=None):
        """Atomically dump the diagnostic bundle; returns the path, or
        None without a health directory."""
        now = self._clock() if now is None else now
        if not self.health_dir:
            return None
        try:
            kv = self._engine.kv_stats()
        except Exception:  # noqa: BLE001
            kv = {}
        self._bundle_seq += 1
        bundle = {
            "schema": BUNDLE_SCHEMA,
            "reason": reason,
            "pid": os.getpid(),
            "seq": self._bundle_seq,
            "unix_ts": time.time(),
            "health": self.watchdog.snapshot(now),
            "ring": self.recorder.snapshot(),
            "ring_dropped": self.recorder.dropped,
            "kv_ledger": kv,
            "memory": self.accountant.snapshot(),
            "recompiles": self.sentry.snapshot(),
            "builds": self._builds(),
            "stacks": _all_thread_stacks(),
        }
        try:
            path = write_bundle(self.health_dir, bundle)
        except OSError:
            logger.exception("runtime health: bundle dump failed")
            return None
        self.bundles.append(path)
        logger.warning("runtime health: %s bundle dumped to %s", reason, path)
        return path


# ------------------------------------------------------------- SIGUSR2


def install_sigusr2_dump(to_health_dir=True):
    """Register SIGUSR2 -> faulthandler's all-thread stack dump, so a
    live wedged process can be read without killing it
    (`kill -USR2 <pid>`). With $EDL_HEALTH_DIR set (and to_health_dir)
    the stacks append to `sigusr2-<pid>.txt` there, else they go to
    stderr. Returns the file path ("" = stderr), None when it could not
    be registered (no SIGUSR2, not the main thread, a bad directory):
    entry points call it unconditionally."""
    try:
        target, stream = "", None
        hdir = health_dir_default()
        if to_health_dir and hdir:
            os.makedirs(hdir, exist_ok=True)
            target = os.path.join(hdir, "sigusr2-%d.txt" % os.getpid())
            stream = open(target, "a")  # noqa: SIM115 - lives forever
        faulthandler.register(
            signal.SIGUSR2, all_threads=True, chain=False,
            **({"file": stream} if stream is not None else {}))
        logger.info("SIGUSR2 stack dump armed (-> %s)", target or "stderr")
        return target
    except (AttributeError, ValueError, OSError):
        logger.warning("SIGUSR2 stack dump could not be registered")
        return None
