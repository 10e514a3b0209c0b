"""Health-checked multi-replica serving router: the port of
elasticdl_tpu/serving/router.py over the port's transport.

The routing tier in front of N GenerationServer replicas. The invariant
it sells is robustness, not speed: a request the router ACCEPTED
completes, or fails with an explicit status the client can act on;
never a hang, never a dropped stream the client has to time out.

    clients --router_generate[_stream]--> Router --generate--> replica 1
                                            |  ^                replica 2
                              heartbeat ----+  +- server_status replica 3

Mechanisms, each its own small state machine:

* **Leases**: a heartbeat polls every replica's `server_status` each
  `poll_secs`, concurrently (a wedged replica never stalls the others'
  renewals; a sweep waits at most min(poll_timeout, lease / 2)); a
  successful poll renews the replica's lease for `lease_secs` and
  refreshes its load signals and drain flag. A replica whose lease
  expires leaves the rotation passively.
* **Least-loaded routing**: among in-rotation replicas (lease valid, not
  draining or stalled, breaker not open) dispatch goes to the lowest
  queue_depth + active_slots + in-flight + queue_wait_ms / 50, ties
  broken toward more free KV blocks, then by address.
* **Prefix-affine dispatch**: a request with at least one full KV block
  of prompt is fingerprinted over its leading blocks
  (serving/prefix_affinity.py) and steered to the replica that last
  served that chain, so a shared system prompt prefills once. Affinity
  is a hint with a decay ladder: the learned target must be in rotation,
  report warm prefix capacity, and sit within `affinity_load_margin` of
  the least-loaded candidate; any rung failing decays the request to
  least-loaded routing.
* **Circuit breakers**: per replica, CLOSED -> OPEN after
  `breaker_threshold` consecutive transient dispatch failures; OPEN
  rejects dispatch for `breaker_cooldown_secs`, then HALF_OPEN admits
  one probe: success closes, a transient failure re-opens, any other
  outcome releases the probe slot. RESOURCE_EXHAUSTED (backpressure
  from a live replica) re-routes without counting against the breaker.
* **Bounded re-dispatch**: transient (UNAVAILABLE / CANCELLED /
  DEADLINE_EXCEEDED) and backpressure failures re-dispatch to another
  replica with full-jitter backoff inside `redispatch_window_secs`;
  anything else (INVALID_ARGUMENT, a client deadline spent) propagates.
  Unary generates re-dispatch at any point (a token stream depends only
  on the params, prompt, seed and temperature); streams only BEFORE the
  first chunk reaches the client, after which a replica loss fails the
  stream explicitly (UNAVAILABLE and the delivered token count).
* **Hedged dispatch**: with `hedge_delay_secs > 0` a unary generate that
  has not answered within the delay is duplicated to the next-best
  replica; the first success wins.
* **Degradation**: draining replicas leave the rotation for new
  requests; with no replica in rotation the router sheds with an
  immediate RESOURCE_EXHAUSTED, counted in `shed`.
* **Disaggregated handoff** (serving/disagg.py): with `disagg` on and a
  replica advertising role "prefill" in rotation, a cold-prefix request
  is first prefilled there and its chain moved to the least-loaded
  decode replica, which then serves it by prefix hit; every failure
  falls back to a plain cold dispatch.

Status codes are the port's (`RpcError.code()`, a gRPC status name as a
string, read through `status_name`); only an RpcError, which is what a
stub raises, is classified for re-dispatch, as the JAX router classifies
only grpc.RpcError.

Fault injection: the servicer is wrapped at the replicas' choke point
(common/fault_injection.py, EDL_FAULT_SPEC) under the router RPC names
(`router_generate:drop:1`, ...), and the handoff consults the
`disagg_handoff` hook (drop / delay / kill fire before a handler, so a
`disagg_handoff:drop:1` rule forces one fallback).

Observability: every routed request is one span tree
(observability/tracing.py): a `router_generate[_stream]` root (adopting
the client's trace when the request carries one) and one `dispatch`
child per leg, whose span id the replica receives as its parent. The
router records its end-to-end latency in the shared log-linear histogram
(router_status e2e_p50/90/99_ms) and merges the replicas' TTFT and
queue-wait histogram BUCKETS from their heartbeats into fleet-wide
percentiles (bucket addition, never percentile averaging); the SLO
burn-rate engine (observability/slo.py) reads the telemetry's ring.

The /metrics exposition (`RouterConfig.metrics_port`): the telemetry's
families with the fleet-merged histograms, the SLO burn and alerting
gauges, and the autoscaler's and rollout controller's series when they
are attached. The autoscaler and rollout blocks come from the
controllers `set_autoscaler` / `set_rollout` attach
(serving/autoscaler.py, serving/rollout.py; any object with
`status_block()` will do).
"""

import logging
import queue as _queue
import threading
import time

from elasticdl_tpu_torch.common.fault_injection import (
    SERVING_RPCS,
    FaultInjector,
    InjectedRpcError,
    maybe_wrap_servicer,
)
from elasticdl_tpu_torch.common.retry import (
    RetryPolicy,
    is_backpressure_rpc_error,
    is_transient_rpc_error,
)
from elasticdl_tpu_torch.observability.histogram import LogLinearHistogram
from elasticdl_tpu_torch.observability.metrics import (
    MetricsServer,
    add_counts,
    counter_family,
    gauge_family,
    metrics_port_default,
)
from elasticdl_tpu_torch.observability.slo import (
    BurnRateEngine,
    default_router_slos,
)
from elasticdl_tpu_torch.observability.tracing import recorder
from elasticdl_tpu_torch.proto import messages as pb
from elasticdl_tpu_torch.proto.service import RpcError, status_name
from elasticdl_tpu_torch.serving.admission import AdmissionError
from elasticdl_tpu_torch.serving.disagg import HandoffCoordinator
from elasticdl_tpu_torch.serving.prefix_affinity import (
    AffinityIndex,
    prefix_fingerprint,
)
from elasticdl_tpu_torch.serving.telemetry import RouterTelemetry

logger = logging.getLogger(__name__)


class RouterError(AdmissionError):
    """A terminal router-side failure; `code` is the status name the
    transport answers with."""


class RouterConfig(object):
    """Routing-tier knobs, the JAX router's with its defaults.
    lease_secs should cover a few poll periods; a sweep waits at most
    min(poll_timeout_secs, lease_secs / 2); redispatch_window_secs
    bounds the TOTAL time one request may spend being re-dispatched.

    SLO knobs: the burn-rate engine windows the telemetry's ring with
    `slo_fast/slow_window_secs` and evaluates fleet TTFT p99 under
    `slo_ttft_p99_ms`, router e2e p99 under `slo_e2e_p99_ms` (both with
    error budget `slo_latency_goal`) and the goodput floor (shed + errors
    over routed under `slo_goodput_goal`). metrics_port (None resolves
    from EDL_METRICS_PORT, unset = off; 0 = an ephemeral port) arms the
    /metrics exposition.

    Affinity knobs: with `affinity` on, a prompt of at least one full
    `affinity_block_tokens` block (match the replicas' kv_block_size) is
    fingerprinted over at most `affinity_max_blocks` blocks and routed
    to the replica that last served it, provided the entry is younger
    than `affinity_ttl_secs` and the ladder holds (see the module
    docstring). cell_id / cells identify this process inside a
    multi-cell tier (1 cell by default). `disagg` orchestrates
    prefill -> decode handoffs when a replica advertises role "prefill"
    (off: prefill replicas sit out of rotation), each leg bounded by
    `disagg_timeout_secs`. max_workers bounds the handlers the router's
    transport runs at once (a stream holds its slot for its life)."""

    def __init__(self, poll_secs=0.5, poll_timeout_secs=2.0,
                 lease_secs=2.5, breaker_threshold=3,
                 breaker_cooldown_secs=2.0, hedge_delay_secs=0.0,
                 dispatch_timeout_secs=120.0,
                 redispatch_window_secs=30.0, base_delay_secs=0.05,
                 max_delay_secs=1.0, port=0, max_workers=64,
                 telemetry_dir="", telemetry_flush_every=20,
                 metrics_port=None, slo_ttft_p99_ms=30000.0,
                 slo_e2e_p99_ms=60000.0, slo_latency_goal=0.01,
                 slo_goodput_goal=0.02, slo_fast_window_secs=30.0,
                 slo_slow_window_secs=120.0, affinity=True,
                 affinity_block_tokens=16, affinity_max_blocks=4,
                 affinity_ttl_secs=60.0, affinity_load_margin=2.0,
                 affinity_capacity=4096, cell_id=0, cells=1,
                 disagg=True, disagg_timeout_secs=10.0):
        self.poll_secs = float(poll_secs)
        self.poll_timeout_secs = float(poll_timeout_secs)
        self.lease_secs = float(lease_secs)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_secs = float(breaker_cooldown_secs)
        self.hedge_delay_secs = float(hedge_delay_secs)
        self.dispatch_timeout_secs = float(dispatch_timeout_secs)
        self.redispatch_window_secs = float(redispatch_window_secs)
        self.base_delay_secs = float(base_delay_secs)
        self.max_delay_secs = float(max_delay_secs)
        self.port = int(port)
        self.max_workers = int(max_workers)
        self.telemetry_dir = telemetry_dir
        self.telemetry_flush_every = int(telemetry_flush_every)
        self.metrics_port = (metrics_port_default() if metrics_port is None
                             else int(metrics_port))
        self.slo_ttft_p99_ms = float(slo_ttft_p99_ms)
        self.slo_e2e_p99_ms = float(slo_e2e_p99_ms)
        self.slo_latency_goal = float(slo_latency_goal)
        self.slo_goodput_goal = float(slo_goodput_goal)
        self.slo_fast_window_secs = float(slo_fast_window_secs)
        self.slo_slow_window_secs = float(slo_slow_window_secs)
        self.affinity = bool(affinity)
        self.affinity_block_tokens = int(affinity_block_tokens)
        self.affinity_max_blocks = int(affinity_max_blocks)
        self.affinity_ttl_secs = float(affinity_ttl_secs)
        self.affinity_load_margin = float(affinity_load_margin)
        self.affinity_capacity = int(affinity_capacity)
        self.cell_id = int(cell_id)
        self.cells = int(cells)
        self.disagg = bool(disagg)
        self.disagg_timeout_secs = float(disagg_timeout_secs)


class CircuitBreaker(object):
    """Per-replica breaker: CLOSED -> OPEN on `threshold` consecutive
    transient failures; OPEN -> HALF_OPEN after `cooldown_secs`;
    HALF_OPEN admits ONE in-flight probe: success closes, a transient
    failure re-opens and restarts the cooldown, and release_probe frees
    the slot for outcomes that judge neither way."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, threshold=3, cooldown_secs=2.0):
        self.threshold = int(threshold)
        self.cooldown_secs = float(cooldown_secs)
        self.state = self.CLOSED
        self.failures = 0  # consecutive transient failures
        self._opened_at = None
        self._probe_inflight = False
        self._lock = threading.Lock()

    def eligible(self, now):
        """Whether a dispatch could go here now (no state change)."""
        with self._lock:
            if self.state == self.CLOSED:
                return True
            if self.state == self.OPEN:
                return (now - self._opened_at >= self.cooldown_secs
                        and not self._probe_inflight)
            return not self._probe_inflight  # HALF_OPEN

    def acquire(self, now):
        """Commit to dispatching here: OPEN -> HALF_OPEN once the
        cooldown has elapsed, claiming the single probe slot. False if
        another thread took the probe."""
        with self._lock:
            if self.state == self.CLOSED:
                return True
            if (self.state == self.OPEN
                    and now - self._opened_at >= self.cooldown_secs):
                self.state = self.HALF_OPEN
            if self.state == self.HALF_OPEN and not self._probe_inflight:
                self._probe_inflight = True
                return True
            return False

    def record_success(self):
        with self._lock:
            closed_now = self.state != self.CLOSED
            self.state = self.CLOSED
            self.failures = 0
            self._probe_inflight = False
            return closed_now

    def release_probe(self):
        """Release a held probe slot without judging the replica: every
        dispatch outcome lands in exactly one of record_success /
        record_failure / release_probe, or a half-open replica would be
        out of rotation for good."""
        with self._lock:
            self._probe_inflight = False

    def record_failure(self, now):
        """One transient failure; True when it TRIPS the breaker."""
        with self._lock:
            self.failures += 1
            self._probe_inflight = False
            if (self.state == self.HALF_OPEN
                    or self.failures >= self.threshold):
                tripped = self.state != self.OPEN
                self.state = self.OPEN
                self._opened_at = now
                return tripped
            return False


class Replica(object):
    """Registry entry: address, stub, lease, breaker, load signals.

    The heartbeat signals live in declared tables: `OBSERVED_SCALARS`
    (name -> reset default, whose type is the coercion `observe`
    applies) and `OBSERVED_LISTS` name every field one ServerStatus
    refreshes; `STATUS_FORWARD` names every attribute status_response
    forwards verbatim into ReplicaStatus, `STATUS_COMPUTED` the
    router-derived rest. Together they cover the two messages exactly
    (the tests hold them to the descriptors)."""

    #: every scalar one heartbeat refreshes, with its reset default:
    #: kv_blocks_cached / kv_blocks_shared / kv_host_blocks /
    #: prefix_hit_rate_window are the warm-capacity ladder affinity
    #: ranks by; health_state "stalled" leaves rotation; role "prefill"
    #: serves cache-warming handoffs only ("" = unified)
    OBSERVED_SCALARS = {
        "draining": False,
        "queue_depth": 0,
        "active_slots": 0,
        "kv_blocks_free": 0,
        "kv_blocks_cached": 0,
        "kv_blocks_shared": 0,
        "kv_cache_dtype": "",
        "kv_host_blocks": 0,
        "kv_host_bytes": 0,
        "revive_uploads": 0,
        "prefill_tokens_revived": 0,
        "host_drops": 0,
        "prefix_hit_rate_window": 0.0,
        "queue_wait_ms": 0.0,
        "health_state": "",
        "last_progress_age_ms": 0.0,
        "role": "",
        "model_version": 0,
        "reload_failed": False,
    }

    #: repeated heartbeat fields (histogram buckets, mergeable by
    #: addition; slow_cause_counts in the forensics taxonomy's order)
    OBSERVED_LISTS = ("ttft_hist", "queue_wait_hist", "slow_cause_counts")

    #: ReplicaStatus fields forwarded verbatim (attribute == field name)
    STATUS_FORWARD = (
        "address", "draining", "queue_depth", "active_slots",
        "kv_blocks_free", "kv_blocks_cached", "kv_blocks_shared",
        "kv_cache_dtype", "kv_host_blocks", "kv_host_bytes",
        "revive_uploads", "prefill_tokens_revived", "host_drops",
        "prefix_hit_rate_window", "queue_wait_ms", "dispatched",
        "failures", "inflight", "slow_cause_counts", "health_state",
        "last_progress_age_ms", "role", "model_version",
        "reload_failed",
    )

    #: the router-derived remainder of ReplicaStatus
    STATUS_COMPUTED = ("healthy", "breaker", "lease_remaining_secs")

    def __init__(self, address, stub, breaker, lease_until):
        self.address = address
        self.stub = stub
        self.breaker = breaker
        # remove_replica retires the entry; its channel closes once every
        # in-flight poll and dispatch has settled
        self.retired = False
        self._closed = False
        # registration grants one lease period of grace
        self.lease_expires_at = lease_until
        for name, default in self.OBSERVED_SCALARS.items():
            setattr(self, name, default)
        for name in self.OBSERVED_LISTS:
            setattr(self, name, [])
        self.dispatched = 0
        self.failures = 0
        self.poll_failures = 0
        # heartbeats observed: 0 until model_version and the load
        # signals are known (the rollout controller waits for the first)
        self.polls = 0
        # router-side in-flight dispatches: the polled signals freeze
        # between heartbeats, so this breaks ties inside a poll window
        self.inflight = 0
        self._inflight_lock = threading.Lock()
        # one status poll in flight at a time
        self._poll_inflight = False

    def begin_poll(self):
        with self._inflight_lock:
            if self._poll_inflight:
                return False
            self._poll_inflight = True
            return True

    def end_poll(self):
        with self._inflight_lock:
            self._poll_inflight = False
        self._maybe_close()

    def begin_dispatch(self):
        with self._inflight_lock:
            self.dispatched += 1
            self.inflight += 1

    def end_dispatch(self):
        with self._inflight_lock:
            self.inflight -= 1
        self._maybe_close()

    def retire(self):
        """Take the entry out of service for good: close its channel now
        if nothing is in flight, else when the last poll or dispatch
        settles. Idempotent."""
        with self._inflight_lock:
            self.retired = True
        return self._maybe_close()

    def _maybe_close(self):
        close_now = False
        with self._inflight_lock:
            if (self.retired and not self._closed
                    and not self._poll_inflight and not self.inflight):
                self._closed = True
                close_now = True
        if not close_now:
            return False
        close = getattr(self.stub, "close", None)
        if callable(close):
            try:
                close()
            except Exception as e:  # noqa: BLE001 - best-effort close
                logger.debug("closing channel to %s failed: %r",
                             self.address, e)
        return True

    def lease_ok(self, now):
        return now < self.lease_expires_at

    def in_rotation(self, now):
        return (self.lease_ok(now) and not self.draining
                and self.health_state != "stalled"
                and self.breaker.eligible(now))

    def load_score(self):
        """Lower = dispatch here: ~50 ms of queue wait weighs like one
        queued request; in-flight (read under its lock) is the router's
        live correction to the heartbeat's stale rest."""
        with self._inflight_lock:
            inflight = self.inflight
        return (self.queue_depth + self.active_slots + inflight
                + self.queue_wait_ms / 50.0)

    def warm_capacity(self):
        """Whether the replica plausibly still holds warm prefix state:
        shared or cached device blocks, spilled host chains, or a recent
        window of prompt tokens seated without prefill."""
        return (self.kv_blocks_shared > 0 or self.kv_blocks_cached > 0
                or self.kv_host_blocks > 0
                or self.prefix_hit_rate_window > 0.0)

    def observe(self, status, lease_until):
        """One heartbeat's signal copy, driven by the declared tables."""
        self.lease_expires_at = lease_until
        self.polls += 1
        for name, default in self.OBSERVED_SCALARS.items():
            setattr(self, name, type(default)(getattr(status, name)))
        for name in self.OBSERVED_LISTS:
            setattr(self, name, list(getattr(status, name)))


def _default_stub_factory(address):
    from elasticdl_tpu_torch.proto.service import ServingStub, build_channel

    channel = build_channel(address)
    stub = ServingStub(channel)
    # remove_replica closes the channel through this handle
    stub.close = channel.close
    return stub


def _code_name(exc, default="UNAVAILABLE"):
    """The status name of a stub's RpcError; `default` for anything else
    (a RouterError included, as the JAX router reads only
    grpc.RpcError's code)."""
    if isinstance(exc, RpcError):
        return status_name(exc) or default
    return default


def _transient(exc):
    return isinstance(exc, RpcError) and is_transient_rpc_error(exc)


def _backpressure(exc):
    return isinstance(exc, RpcError) and is_backpressure_rpc_error(exc)


class Router(object):
    """The registry, heartbeat and dispatch engine. Transport-agnostic:
    `stub_factory(address)` returns an object with the ServingStub
    surface (generate / generate_stream / server_status, and the
    handoff's export_chain / transfer_chain / abort_transfer, each
    taking `timeout=`): the port's stubs in production, fakes in tests.
    `clock` and `sleep` drive leases, breakers and backoff."""

    #: root-span events that retain a trace even when the request
    #: succeeded
    RETAIN_EVENTS = frozenset(("redispatched", "hedged", "breaker_trip",
                               "shed"))

    def __init__(self, replica_addrs, config=None, stub_factory=None,
                 clock=time.monotonic, sleep=time.sleep, telemetry=None):
        self.config = config or RouterConfig()
        self._stub_factory = stub_factory or _default_stub_factory
        self._clock = clock
        self._sleep = sleep
        self.telemetry = telemetry or RouterTelemetry(
            log_dir=self.config.telemetry_dir or None,
            flush_every=self.config.telemetry_flush_every)
        self._policy = RetryPolicy(
            base_delay_secs=self.config.base_delay_secs,
            max_delay_secs=self.config.max_delay_secs,
            reconnect_window_secs=self.config.redispatch_window_secs)
        # fingerprint -> last replica that served it (TTL'd, LRU bound)
        self._affinity = AffinityIndex(
            ttl_secs=self.config.affinity_ttl_secs,
            capacity=self.config.affinity_capacity)
        self._disagg = HandoffCoordinator(
            timeout_secs=self.config.disagg_timeout_secs)
        self._injector = None
        self._lock = threading.Lock()
        self._replicas = {}
        for addr in replica_addrs:
            self.add_replica(addr)
        self._stop = threading.Event()
        self._heartbeat = None
        self._server = None
        self.servicer = None
        self.port = None
        self.metrics = None  # the MetricsServer with config.metrics_port
        # the last-seen CUMULATIVE replica buckets per address (an entry
        # outlives its replica, so a killed replica's history stays in
        # the fleet sum), bucket-added into the ring each heartbeat
        self._fleet_hists = {}
        self._slo_engine = BurnRateEngine(
            default_router_slos(
                self.config.slo_ttft_p99_ms, self.config.slo_e2e_p99_ms,
                self.config.slo_goodput_goal,
                latency_goal=self.config.slo_latency_goal),
            fast_window_secs=self.config.slo_fast_window_secs,
            slow_window_secs=self.config.slo_slow_window_secs)
        self._slo_lock = threading.Lock()
        self._slo_reports = []
        # optional controllers contributing router_status blocks; the
        # router never calls into them while holding _lock
        self.autoscaler = None
        self.rollout = None
        self._rollout_hold = set()
        # tail-based trace retention for the request roots
        recorder().add_classifier(self._root_span_classifier)

    def _root_span_classifier(self, span):
        """Errors, shed, re-dispatched / hedged legs and e2e beyond the
        declared SLO threshold retain a routed request's trace; clean
        fast roots are sampled."""
        if span.name not in ("router_generate", "router_generate_stream"):
            return None
        if span.status != "ok":
            return True
        if any(name in self.RETAIN_EVENTS
               for _ts, name, _attrs in span.events):
            return True
        if span.end is not None:
            if (span.end - span.start) * 1000.0 > self.config.slo_e2e_p99_ms:
                return True
        return False

    def set_autoscaler(self, supervisor):
        """Attach a supervisor whose status_block() fills
        router_status.autoscaler (its lifecycle stays the caller's)."""
        self.autoscaler = supervisor

    def set_rollout(self, controller):
        """Attach a rollout controller whose status_block() fills
        router_status.rollout (its lifecycle stays the caller's)."""
        self.rollout = controller

    # ------------------------------------------------- rollout steering

    def hold_replica(self, address):
        """Steer NEW dispatches away from `address` (in-flight work is
        untouched) until release_replica."""
        with self._lock:
            self._rollout_hold.add(address)

    def release_replica(self, address):
        with self._lock:
            self._rollout_hold.discard(address)

    def held_replicas(self):
        with self._lock:
            return set(self._rollout_hold)

    # ------------------------------------------------------- membership

    def add_replica(self, address):
        with self._lock:
            if address in self._replicas:
                return self._replicas[address]
            rep = Replica(
                address, self._stub_factory(address),
                CircuitBreaker(self.config.breaker_threshold,
                               self.config.breaker_cooldown_secs),
                lease_until=self._clock() + self.config.lease_secs)
            self._replicas[address] = rep
            return rep

    def remove_replica(self, address):
        """Unregister and retire `address`: no new dispatch picks it,
        its channel closes once in-flight polls and dispatches settle,
        and affinity forgets it. Returns the entry (None if unknown)."""
        with self._lock:
            rep = self._replicas.pop(address, None)
        if rep is not None:
            rep.retire()
            self._affinity.forget_address(address)
        return rep

    def replicas(self):
        with self._lock:
            return list(self._replicas.values())

    # -------------------------------------------------------- heartbeat

    def _poll_replica(self, rep):
        try:
            status = rep.stub.server_status(
                pb.ServerStatusRequest(),
                timeout=self.config.poll_timeout_secs)
            rep.observe(status, self._clock() + self.config.lease_secs)
        except Exception as e:  # noqa: BLE001 - silence = lease decay
            rep.poll_failures += 1
            logger.debug("router poll %s failed: %r", rep.address, e)
        finally:
            rep.end_poll()

    def poll_once(self):
        """One heartbeat sweep, concurrent (one thread a replica; a
        replica whose previous poll is still in flight is skipped),
        waiting at most min(poll_timeout, lease / 2); then the fleet
        histograms into the ring and the SLO evaluation. Returns the
        number of in-rotation replicas."""
        spawned = []
        for rep in self.replicas():
            if not rep.begin_poll():
                continue
            t = threading.Thread(target=self._poll_replica, args=(rep,),
                                 daemon=True,
                                 name="router-poll-%s" % rep.address)
            t.start()
            spawned.append(t)
        deadline = time.monotonic() + min(self.config.poll_timeout_secs,
                                          self.config.lease_secs / 2.0)
        for t in spawned:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        now = self._clock()
        healthy = sum(1 for r in self.replicas() if r.in_rotation(now))
        for rep in self.replicas():
            if rep.ttft_hist:
                self._fleet_hists[rep.address] = (list(rep.ttft_hist),
                                                  list(rep.queue_wait_hist))
        ttft_cum, wait_cum = [], []
        for ttft, wait in self._fleet_hists.values():
            ttft_cum = add_counts(ttft_cum, ttft)
            wait_cum = add_counts(wait_cum, wait)
        self.telemetry.record_poll(
            healthy, len(self.replicas()),
            fleet_hists={"fleet_ttft_ms": ttft_cum,
                         "fleet_queue_wait_ms": wait_cum})
        reports = self.telemetry.evaluate_slos(self._slo_engine)
        with self._slo_lock:
            self._slo_reports = reports
        return healthy

    def slo_reports(self):
        """The last heartbeat's burn-rate evaluations (plain dicts)."""
        with self._slo_lock:
            return list(self._slo_reports)

    def _heartbeat_loop(self):
        while not self._stop.is_set():
            self.poll_once()
            self._stop.wait(self.config.poll_secs)

    # -------------------------------------------------------- selection

    def _fingerprint(self, request):
        """The request's prefix fingerprint, or None when affinity is
        off or the prompt holds no complete block."""
        if not self.config.affinity:
            return None
        return prefix_fingerprint(
            request.prompt, block_tokens=self.config.affinity_block_tokens,
            max_blocks=self.config.affinity_max_blocks)

    def _acquire_replica(self, now, exclude=(), fingerprint=None):
        """The best in-rotation replica with its breaker slot acquired,
        as (replica, affine); (None, False) = shed. With a fingerprint
        the affinity ladder runs first: a fresh learned entry whose
        target is among the in-rotation candidates, reports warm
        capacity, sits within affinity_load_margin of the least-loaded
        candidate and grants its breaker slot; any rung failing falls
        through to least-loaded order."""
        with self._lock:
            candidates = [
                r for r in self._replicas.values()
                if r.address not in exclude and r.in_rotation(now)
                and r.role != "prefill"
                and r.address not in self._rollout_hold
            ]
        candidates.sort(
            key=lambda r: (r.load_score(), -r.kv_blocks_free, r.address))
        if fingerprint is not None and candidates:
            target = self._affinity.lookup(fingerprint, now)
            if target is not None:
                affine = next((r for r in candidates
                               if r.address == target), None)
                if (affine is not None and affine.warm_capacity()
                        and affine.load_score()
                        <= (candidates[0].load_score()
                            + self.config.affinity_load_margin)):
                    if affine.breaker.acquire(now):
                        return affine, True
        for rep in candidates:
            if rep.breaker.acquire(now):
                return rep, False
        return None, False

    def _acquire_prefill(self, now):
        """The least-loaded in-rotation PREFILL replica with its breaker
        slot acquired, or None."""
        with self._lock:
            pool = [r for r in self._replicas.values()
                    if r.in_rotation(now) and r.role == "prefill"
                    and r.address not in self._rollout_hold]
        pool.sort(key=lambda r: (r.load_score(), r.address))
        for rep in pool:
            if rep.breaker.acquire(now):
                return rep
        return None

    def _decode_target(self, now):
        """The least-loaded in-rotation decode-capable replica, in
        _acquire_replica's order; no breaker slot is held."""
        with self._lock:
            candidates = [r for r in self._replicas.values()
                          if r.in_rotation(now) and r.role != "prefill"
                          and r.address not in self._rollout_hold]
        if not candidates:
            return None
        candidates.sort(
            key=lambda r: (r.load_score(), -r.kv_blocks_free, r.address))
        return candidates[0]

    def _maybe_handoff(self, request, fp, root):
        """Cache warming for a COLD prefix: prefill on a dedicated
        prefill replica, move the chain to the least-loaded decode
        replica and teach affinity, so the dispatch that follows seats
        there by prefix hit. Every failure falls back to a plain cold
        dispatch. A no-op without a fingerprint, with disagg off, with
        no prefill replica in rotation, or when affinity already knows a
        target."""
        if fp is None or not self.config.disagg:
            return
        now = self._clock()
        if self._affinity.lookup(fp, now) is not None:
            return
        prefill_rep = self._acquire_prefill(now)
        if prefill_rep is None:
            return
        decode_rep = self._decode_target(now)
        if decode_rep is None:
            prefill_rep.breaker.release_probe()
            return
        if self._injector is not None:
            try:
                self._injector.intercept("disagg_handoff")
            except InjectedRpcError as e:
                prefill_rep.breaker.release_probe()
                self.telemetry.count("disagg_fallbacks")
                root.event("disagg_fallback", error=str(e))
                return
        disagg = self._disagg
        tid = disagg.new_transfer_id()
        prefill_rep.begin_dispatch()
        decode_rep.begin_dispatch()
        try:
            payload = disagg.export_chain(prefill_rep, request, tid)
            disagg.import_chain(decode_rep, payload)
        except Exception as e:  # noqa: BLE001 - fallback is the policy
            disagg.abort_transfer(prefill_rep, tid)
            prefill_rep.breaker.release_probe()
            self.telemetry.count("disagg_fallbacks")
            root.event("disagg_fallback", prefill=prefill_rep.address,
                       decode=decode_rep.address, error=_code_name(e))
            return
        finally:
            prefill_rep.end_dispatch()
            decode_rep.end_dispatch()
        self._on_success(prefill_rep)
        self.telemetry.count("disagg_handoffs")
        root.event("disagg_handoff", prefill=prefill_rep.address,
                   decode=decode_rep.address, transfer_id=tid)
        self._affinity.learn(fp, decode_rep.address, self._clock())

    # --------------------------------------------------------- dispatch

    def _sub_request(self, request, remaining_ms, trace_id="",
                     parent_span_id=""):
        return pb.GenerateRequest(
            prompt=list(request.prompt),
            max_new_tokens=request.max_new_tokens,
            temperature=request.temperature,
            seed=request.seed,
            deadline_ms=remaining_ms,
            trace_id=trace_id,
            parent_span_id=parent_span_id)

    def _root_span(self, name, request):
        """The request's root span: adopts the client's trace when the
        request carries one, mints one otherwise."""
        return recorder().start_span(
            name, trace_id=getattr(request, "trace_id", "") or None,
            parent_span_id=getattr(request, "parent_span_id", ""),
            prompt_len=len(request.prompt),
            max_new_tokens=request.max_new_tokens)

    def _budget(self, request, t0):
        """(remaining_ms, call_timeout) for a dispatch starting now
        (remaining_ms 0 = no deadline); raises DEADLINE_EXCEEDED when
        the client's budget is spent, which is never retried."""
        timeout = self.config.dispatch_timeout_secs
        if request.deadline_ms <= 0:
            return 0, timeout
        remaining = request.deadline_ms / 1000.0 - (self._clock() - t0)
        if remaining <= 0:
            raise RouterError(
                "DEADLINE_EXCEEDED",
                "deadline spent after %.0f ms of routing"
                % (request.deadline_ms,))
        return int(remaining * 1000.0), min(timeout, remaining)

    def _on_success(self, rep):
        rep.breaker.record_success()

    def _on_failure(self, rep, exc, span=None):
        """Breaker accounting for one failed dispatch; every path settles
        a held probe slot."""
        rep.failures += 1
        now = self._clock()
        if _transient(exc):
            if rep.breaker.record_failure(now):
                self.telemetry.count("breaker_trips")
                if span is not None:
                    span.event("breaker_trip", replica=rep.address)
                logger.warning(
                    "router breaker OPEN for %s after %d consecutive "
                    "transient failures (%r)",
                    rep.address, rep.breaker.failures, exc)
        elif _backpressure(exc):
            # the replica answered: alive, explicitly shedding
            rep.breaker.record_success()
        else:
            # an application error says nothing about transport health
            rep.breaker.release_probe()

    def _call_unary(self, rep, request, remaining_ms, timeout, root,
                    hedge=False, attempt=0):
        """One dispatch leg under its own `dispatch` span."""
        span = recorder().start_span(
            "dispatch", trace_id=root.trace_id, parent_span_id=root.span_id,
            replica=rep.address, hedge=hedge, attempt=attempt)
        sub = self._sub_request(request, remaining_ms,
                                trace_id=root.trace_id,
                                parent_span_id=span.span_id)
        rep.begin_dispatch()
        try:
            resp = rep.stub.generate(sub, timeout=timeout)
        except Exception as e:
            self._on_failure(rep, e, span=span)
            span.set(error=_code_name(e))
            span.finish("error")
            raise
        finally:
            rep.end_dispatch()
        self._on_success(rep)
        span.finish("ok")
        return resp

    def _raise_terminal(self, exc, root=None):
        self.telemetry.count("errors")
        if isinstance(exc, RouterError):
            if root is not None:
                root.finish(exc.code)
            raise exc
        if root is not None:
            root.finish(_code_name(exc))
        raise RouterError(_code_name(exc), str(exc))

    def _finish_e2e(self, root, t0, status="ok"):
        self.telemetry.record_e2e((self._clock() - t0) * 1000.0,
                                  trace_id=root.trace_id)
        root.finish(status)

    def _pick(self, now, failed, fp, root, attempt):
        """The attempt's replica, forgiving `failed` once every live
        replica has failed this request; sheds when none is left. Counts
        the affinity verdict on the first attempt. Returns (replica,
        the failed set to carry on with)."""
        rep, affine = self._acquire_replica(now, exclude=failed,
                                            fingerprint=fp)
        if rep is None and failed:
            failed = set()
            rep, affine = self._acquire_replica(now, fingerprint=fp)
        if rep is None:
            self.telemetry.count("shed")
            root.event("shed")
            root.finish("RESOURCE_EXHAUSTED")
            raise RouterError("RESOURCE_EXHAUSTED",
                              "no healthy replicas in rotation (shed)")
        if fp is not None and attempt == 0:
            self.telemetry.count("affinity_hits" if affine
                                 else "affinity_misses")
            if affine:
                root.event("affinity", replica=rep.address)
        return rep, failed

    def _retry_or_raise(self, e, request, window_ends, root, rep, attempt):
        """After a failed attempt: raise the terminal error (not
        retryable, a spent client deadline, or the window over), else
        count the re-dispatch and sleep its backoff."""
        retryable = _transient(e) or _backpressure(e)
        spent_deadline = (request.deadline_ms > 0
                          and _code_name(e, "") == "DEADLINE_EXCEEDED")
        if not retryable or spent_deadline:
            self._raise_terminal(e, root=root)
        if self._clock() >= window_ends:
            logger.error("router giving up on request after %d "
                         "re-dispatches over %.0fs window", attempt,
                         self.config.redispatch_window_secs)
            self._raise_terminal(e, root=root)
        self.telemetry.count("redispatched")
        root.event("redispatched", attempt=attempt,
                   failed_replica=rep.address, error=_code_name(e))
        self._sleep(min(self._policy.backoff(attempt),
                        max(0.0, window_ends - self._clock())))

    def dispatch_generate(self, request):
        """Unary generate with re-dispatch and optional hedging: the
        response is atomic, so re-dispatch is safe at any point."""
        self.telemetry.count("routed")
        root = self._root_span("router_generate", request)
        fp = self._fingerprint(request)
        t0 = self._clock()
        self._maybe_handoff(request, fp, root)
        window_ends = t0 + self.config.redispatch_window_secs
        attempt = 0
        failed = set()  # addresses that failed THIS request
        while True:
            try:
                remaining_ms, timeout = self._budget(request, t0)
            except RouterError as e:
                self._raise_terminal(e, root=root)
            rep, failed = self._pick(self._clock(), failed, fp, root,
                                     attempt)
            try:
                resp = self._dispatch_maybe_hedged(
                    rep, request, remaining_ms, timeout, failed, root,
                    attempt)
                self.telemetry.count("completed")
                # a success teaches affinity: the chain is resident there
                if fp is not None:
                    self._affinity.learn(fp, rep.address, self._clock())
                self._finish_e2e(root, t0)
                return resp
            except Exception as e:  # noqa: BLE001 - classified below
                failed.add(rep.address)
                self._retry_or_raise(e, request, window_ends, root, rep,
                                     attempt)
                attempt += 1

    def _dispatch_maybe_hedged(self, primary, request, remaining_ms,
                               timeout, failed, root, attempt):
        """One attempt. With hedging on and a second replica in rotation,
        a primary that has not answered within hedge_delay is duplicated
        and the first success wins; raises the primary's error when
        every leg failed. Each leg is its own `dispatch` span."""
        if self.config.hedge_delay_secs <= 0:
            return self._call_unary(primary, request, remaining_ms,
                                    timeout, root, attempt=attempt)
        results = _queue.Queue()

        def leg(rep, hedge):
            try:
                results.put(("ok", rep, self._call_unary(
                    rep, request, remaining_ms, timeout, root,
                    hedge=hedge, attempt=attempt)))
            except Exception as e:  # noqa: BLE001 - the datum
                results.put(("err", rep, e))

        threading.Thread(target=leg, args=(primary, False),
                         daemon=True).start()
        outstanding, hedged = 1, False
        primary_err = None
        while outstanding:
            try:
                wait = (self.config.hedge_delay_secs if not hedged
                        else timeout + 5.0)
                kind, rep, payload = results.get(timeout=wait)
            except _queue.Empty:
                if hedged:
                    raise RouterError(
                        "DEADLINE_EXCEEDED",
                        "hedged dispatch timed out on every leg")
                hedged = True
                # no fingerprint: the hedge lands somewhere else
                hedge_rep, _ = self._acquire_replica(
                    self._clock(), exclude=set(failed) | {primary.address})
                if hedge_rep is not None:
                    self.telemetry.count("hedges")
                    root.event("hedged", replica=hedge_rep.address)
                    threading.Thread(target=leg, args=(hedge_rep, True),
                                     daemon=True).start()
                    outstanding += 1
                continue
            outstanding -= 1
            if kind == "ok":
                if rep is not primary:
                    self.telemetry.count("hedge_wins")
                    root.event("hedge_win", replica=rep.address)
                return payload
            failed.add(rep.address)
            if rep is primary:
                primary_err = payload
        raise primary_err if primary_err is not None else payload

    def dispatch_stream(self, request):
        """Streaming generate: re-dispatch only BEFORE the first chunk
        reaches the client; after it, a replica loss fails the stream
        explicitly (UNAVAILABLE and the delivered token count). A client
        that abandons the generator cancels the replica's stream."""
        self.telemetry.count("routed")
        root = self._root_span("router_generate_stream", request)
        fp = self._fingerprint(request)
        t0 = self._clock()
        self._maybe_handoff(request, fp, root)
        window_ends = t0 + self.config.redispatch_window_secs

        def gen():
            attempt, failed, delivered = 0, set(), 0
            while True:
                try:
                    remaining_ms, timeout = self._budget(request, t0)
                except RouterError as e:
                    self._raise_terminal(e, root=root)
                rep, failed = self._pick(self._clock(), failed, fp, root,
                                         attempt)
                span = recorder().start_span(
                    "dispatch", trace_id=root.trace_id,
                    parent_span_id=root.span_id, replica=rep.address,
                    attempt=attempt, stream=True)
                rep.begin_dispatch()
                stream = None
                try:
                    stream = rep.stub.generate_stream(
                        self._sub_request(request, remaining_ms,
                                          trace_id=root.trace_id,
                                          parent_span_id=span.span_id),
                        timeout=timeout)
                    for chunk in stream:
                        delivered += len(chunk.tokens)
                        yield chunk
                    self._on_success(rep)
                    span.finish("ok")
                    self.telemetry.count("completed")
                    if fp is not None:
                        self._affinity.learn(fp, rep.address, self._clock())
                    self._finish_e2e(root, t0)
                    return
                except GeneratorExit:
                    cancel = getattr(stream, "cancel", None)
                    if callable(cancel):
                        cancel()
                    raise
                except Exception as e:  # noqa: BLE001 - classified
                    self._on_failure(rep, e, span=span)
                    span.set(error=_code_name(e), delivered=delivered)
                    span.finish("error")
                    failed.add(rep.address)
                    if delivered:
                        self.telemetry.count("errors")
                        root.finish("UNAVAILABLE")
                        raise RouterError(
                            "UNAVAILABLE",
                            "replica %s lost mid-stream after %d delivered "
                            "tokens (%s)" % (rep.address, delivered,
                                             _code_name(e)))
                    self._retry_or_raise(e, request, window_ends, root, rep,
                                         attempt)
                    attempt += 1
                finally:
                    rep.end_dispatch()

        return gen()

    # ----------------------------------------------------------- status

    def status_response(self):
        now = self._clock()
        snap = self.telemetry.snapshot()
        # fleet latency: the replicas' buckets merge by addition
        fleet_ttft = LogLinearHistogram()
        fleet_wait = LogLinearHistogram()
        for rep in self.replicas():
            if rep.ttft_hist:
                fleet_ttft.merge(LogLinearHistogram.from_counts(rep.ttft_hist))
            if rep.queue_wait_hist:
                fleet_wait.merge(
                    LogLinearHistogram.from_counts(rep.queue_wait_hist))
        reps = []
        for rep in sorted(self.replicas(), key=lambda r: r.address):
            kwargs = {name: getattr(rep, name)
                      for name in Replica.STATUS_FORWARD}
            kwargs.update(
                healthy=rep.in_rotation(now),
                breaker=rep.breaker.state,
                lease_remaining_secs=max(0.0, rep.lease_expires_at - now))
            reps.append(pb.ReplicaStatus(**kwargs))
        autoscaler = (self.autoscaler.status_block()
                      if self.autoscaler is not None else None)
        rollout = (self.rollout.status_block()
                   if self.rollout is not None else None)
        fleet = self.replicas()
        slo_blocks = [
            pb.SloObjective(**{name: r[name] for name in (
                "name", "kind", "threshold_ms", "goal", "fast_burn",
                "slow_burn", "fast_window_secs", "slow_window_secs",
                "fast_samples", "slow_samples", "alerting")})
            for r in self.slo_reports()
        ]
        return pb.RouterStatusResponse(
            autoscaler=autoscaler,
            rollout=rollout,
            slo=slo_blocks,
            replicas=len(reps),
            healthy=sum(1 for r in reps if r.healthy),
            kv_host_blocks=sum(r.kv_host_blocks for r in fleet),
            kv_host_bytes=sum(r.kv_host_bytes for r in fleet),
            revive_uploads=sum(r.revive_uploads for r in fleet),
            prefill_tokens_revived=sum(r.prefill_tokens_revived
                                       for r in fleet),
            host_drops=sum(r.host_drops for r in fleet),
            replica=reps,
            routed=snap["routed"],
            completed=snap["completed"],
            redispatched=snap["redispatched"],
            hedges=snap["hedges"],
            hedge_wins=snap["hedge_wins"],
            shed=snap["shed"],
            breaker_trips=snap["breaker_trips"],
            affinity_hits=snap["affinity_hits"],
            affinity_misses=snap["affinity_misses"],
            disagg_handoffs=snap["disagg_handoffs"],
            disagg_fallbacks=snap["disagg_fallbacks"],
            cell_id=self.config.cell_id,
            cells=self.config.cells,
            uptime_secs=snap["uptime_secs"],
            e2e_p50_ms=snap["e2e_p50_ms"],
            e2e_p90_ms=snap["e2e_p90_ms"],
            e2e_p99_ms=snap["e2e_p99_ms"],
            ttft_p50_ms=fleet_ttft.percentile(50),
            ttft_p90_ms=fleet_ttft.percentile(90),
            ttft_p99_ms=fleet_ttft.percentile(99),
            queue_wait_p50_ms=fleet_wait.percentile(50),
            queue_wait_p90_ms=fleet_wait.percentile(90),
            queue_wait_p99_ms=fleet_wait.percentile(99),
        )

    # ----------------------------------------------------- /metrics

    def _metrics_families(self):
        """One router scrape: the telemetry's families (the fleet-merged
        histograms among them), the SLO burn and alerting gauges, and the
        attached autoscaler's and rollout controller's series. On the
        metrics thread; every collector locks itself."""
        fams = self.telemetry.prometheus()
        burn, alerting = [], []
        for r in self.slo_reports():
            burn.append(({"slo": r["name"], "window": "fast"},
                         r["fast_burn"]))
            burn.append(({"slo": r["name"], "window": "slow"},
                         r["slow_burn"]))
            alerting.append(({"slo": r["name"]},
                             1.0 if r["alerting"] else 0.0))
        fams.append(gauge_family(
            "edl_router_slo_burn",
            "SLO error-budget burn rate per objective and window "
            "(1.0 = spending the budget exactly on schedule)", burn))
        fams.append(gauge_family(
            "edl_router_slo_alerting",
            "1 when BOTH burn windows exceed 1.0 (multi-window rule)",
            alerting))
        if self.autoscaler is not None:
            block = self.autoscaler.status_block()
            for name in ("target", "live", "starting", "draining"):
                fams.append(gauge_family(
                    "edl_autoscaler_%s" % name,
                    "autoscaler roster gauge %s" % name,
                    [({}, getattr(block, name))]))
            for name in ("scale_ups", "scale_downs", "replacements",
                         "spawn_failures"):
                fams.append(counter_family(
                    "edl_autoscaler_%s_total" % name,
                    "autoscaler decision counter %s" % name,
                    getattr(block, name)))
            fams.append(gauge_family(
                "edl_autoscaler_circuit_open",
                "1 when the restart circuit is open",
                [({}, 1.0 if block.circuit_open else 0.0)]))
        if self.rollout is not None:
            block = self.rollout.status_block()
            for name in ("target_version", "old_version", "wave",
                         "waves_total", "swapped", "fleet"):
                fams.append(gauge_family(
                    "edl_rollout_%s" % name,
                    "rollout controller gauge %s" % name,
                    [({}, getattr(block, name))]))
            fams.append(gauge_family(
                "edl_rollout_active",
                "1 while a rollout is in flight (any non-terminal "
                "phase)",
                [({"phase": block.phase},
                  0.0 if block.phase in ("idle", "committed",
                                         "rolled_back", "aborted")
                  else 1.0)]))
            fams.append(counter_family(
                "edl_rollout_rollbacks_total",
                "replica checkpoint swaps reversed by judgment or "
                "burn (rollback swap count)", block.rollbacks))
        return fams

    # -------------------------------------------------------- lifecycle

    def start(self, transport=True, injector=None):
        """Start the heartbeat and wrap the servicer (EDL_FAULT_SPEC, or
        `injector`); with config.metrics_port, serve /metrics (its port in
        `self.metrics.port`); with `transport`, serve the Router table
        on config.port (0: an ephemeral port, in `self.port`) with
        config.max_workers handlers."""
        self.telemetry.gauge("cell_id", self.config.cell_id)
        self.telemetry.gauge("cells", self.config.cells)
        self._heartbeat = threading.Thread(
            target=self._heartbeat_loop, daemon=True,
            name="router-heartbeat")
        self._heartbeat.start()
        injector = injector or FaultInjector.from_env()
        self._injector = injector
        self.servicer = maybe_wrap_servicer(RouterServicer(self), injector,
                                            rpcs=SERVING_RPCS)
        if self.config.metrics_port is not None:
            self.metrics = MetricsServer(self._metrics_families,
                                         port=self.config.metrics_port)
            logger.info("Router /metrics exposition on port %d",
                        self.metrics.port)
        if transport:
            from elasticdl_tpu_torch.proto.service import (
                add_router_servicer_to_server,
                build_server,
            )

            server = build_server(max_workers=self.config.max_workers)
            add_router_servicer_to_server(self.servicer, server)
            self.port = server.add_insecure_port(
                "[::]:%d" % self.config.port)
            server.start()
            self._server = server
            logger.info(
                "Serving router started on port %d (%d replicas, "
                "poll=%.2fs lease=%.2fs)", self.port, len(self.replicas()),
                self.config.poll_secs, self.config.lease_secs)
        return self

    def stop(self, grace=5.0):
        self._stop.set()
        recorder().remove_classifier(self._root_span_classifier)
        if self._heartbeat is not None:
            self._heartbeat.join(timeout=10.0)
        if self._server is not None:
            self._server.stop(grace)
            self._server = None
        if self.metrics is not None:
            self.metrics.close()
            self.metrics = None
        self.telemetry.close()
        # export the spans when EDL_TRACE_DIR is set (no-op otherwise)
        recorder().flush()


class RouterServicer(object):
    """The Router methods (proto/service.py's Router table). A failure
    raises RouterError with its status name, which the transport
    answers with that status; a stream's later failure ends it in that
    trailer."""

    def __init__(self, router):
        self._router = router

    def router_generate(self, request, context=None):
        del context
        return self._router.dispatch_generate(request)

    def router_generate_stream(self, request, context=None):
        del context
        return self._router.dispatch_stream(request)

    def router_status(self, request, context=None):
        del request, context
        return self._router.status_response()
