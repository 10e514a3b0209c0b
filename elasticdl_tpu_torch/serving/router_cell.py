"""The multi-cell router tier: the port of
elasticdl_tpu/serving/router_cell.py over the port's transport.

One router process is a single point of failure in front of the fleet.
This module removes it with the journaled-state machinery that makes the
dispatcher restartable (master/state_store.py):

``CellRegistryJournal``
    A write-ahead journal and compacted snapshot of the REPLICA REGISTRY,
    shared by every cell through one ``--cell_journal_dir``. Membership
    transitions (``adopt`` / ``retire``) and periodic ``lease`` beacons
    are appended write-ahead and replayed at cell start, so a cell that
    crashes, or a new cell started with no ``--replica``, rebuilds the
    fleet from disk alone. One ``flock`` serializes every append,
    refresh and compaction across processes; each cell tails the journal
    from its own byte offset, so a change cell 0 records reaches cell 1
    at its next heartbeat tick. Compaction runs at tick boundaries; a
    tailing cell that sees the journal shrink under its offset resyncs
    from the snapshot. A line torn by a writer killed mid-append is
    skipped.

``RouterCell``
    A ``Router`` whose membership is journal-backed: local
    ``add_replica`` / ``remove_replica`` journal the transition, remote
    ones arrive through ``refresh()`` at each heartbeat tick, and
    ``router_status`` carries the cell block (cell_id, cells,
    journal_events, journal_replayed, cell_restarts). The ``cell_kill``
    fault hook fires at the tick, so a spec can SIGKILL a live cell.

``CellFront``
    The client-side cell map: requests are consistent-hashed by prefix
    fingerprint over the cells (a shared-prompt family lands on one
    cell, whose affinity index keeps it on one replica), and a dead
    cell's requests walk the ring to the survivors: transient failures
    reroute with full-jitter backoff inside a bounded window,
    backpressure propagates (the registry is shared, so every cell would
    shed the same fleet), and a stream reroutes only before its first
    delivered chunk. Per-cell circuit breakers keep a dead cell from
    eating a probe per request.

As in serving/router.py, only the port's RpcError (what a stub raises)
is classified for reroute; the JAX module's `PROTOCOL` declaration is
for its linter and stays there.
"""

import contextlib
import json
import logging
import os
import threading
import time

try:
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX
    fcntl = None

from elasticdl_tpu_torch.common.retry import RetryPolicy
from elasticdl_tpu_torch.master.state_store import JOURNAL_FILE, JobStateStore
from elasticdl_tpu_torch.proto import messages as pb
from elasticdl_tpu_torch.serving.prefix_affinity import (
    HashRing,
    prefix_fingerprint,
)
from elasticdl_tpu_torch.serving.router import (
    CircuitBreaker,
    Router,
    RouterError,
    _backpressure,
    _code_name,
    _transient,
)

logger = logging.getLogger(__name__)

#: one flock in the journal dir serializes every cell's journal work
REGISTRY_LOCK_FILE = ".registry.lock"


class CellRegistryJournal(object):
    """The flock-serialized write-ahead journal of the replica registry,
    one JSON object a line:

        {"op": "adopt",  "address": "<addr>", "cell": <id>}
        {"op": "retire", "address": "<addr>", "cell": <id>}
        {"op": "lease",  "addresses": ["<addr>", ...], "cell": <id>}

    All three are idempotent under replay (adopt of a member, retire of
    an absent address and every lease are no-ops), which lets compaction
    truncate mid-stream. The snapshot is ``{"replicas": [addr, ...]}``.
    Each process tails from its own byte offset, advanced past its own
    appends inside the same flock."""

    def __init__(self, journal_dir, cell_id=0, snapshot_every=64):
        self.cell_id = int(cell_id)
        self._store = JobStateStore(journal_dir,
                                    snapshot_every=snapshot_every)
        self._journal_path = os.path.join(journal_dir, JOURNAL_FILE)
        self._lock_path = os.path.join(journal_dir, REGISTRY_LOCK_FILE)
        # the heartbeat tick and a membership change in this process
        # must not interleave inside the flock
        self._mutex = threading.RLock()
        self._offset = 0
        self._pending_compact = False
        self._apply = None
        self._snapshot_state = None
        self.replayed = 0
        self.appends = 0
        self.resyncs = 0

    @property
    def restarts(self):
        return self._store.restart_count

    @contextlib.contextmanager
    def _flock(self):
        with self._mutex:
            f = open(self._lock_path, "a+")
            try:
                if fcntl is not None:
                    fcntl.flock(f.fileno(), fcntl.LOCK_EX)
                yield
            finally:
                if fcntl is not None:
                    fcntl.flock(f.fileno(), fcntl.LOCK_UN)
                f.close()

    def bind(self, apply_event, snapshot_state):
        """`apply_event(event)` applies one event to the registry without
        journaling it; `snapshot_state()` returns the snapshot dict."""
        self._apply = apply_event
        self._snapshot_state = snapshot_state

    def replay(self):
        """Rebuild the registry at cell start: the snapshot, then every
        journal event in order. Returns the items replayed."""
        with self._flock():
            return self._resync_locked(initial=True)

    def _resync_locked(self, initial=False):
        snapshot, events = self._store.load()
        n = 0
        if snapshot:
            for addr in snapshot.get("replicas", ()):
                self._apply({"op": "adopt", "address": addr})
                n += 1
        for event in events:
            self._apply(event)
            n += 1
        self._offset = self._journal_size()
        if initial:
            self.replayed = n
        else:
            self.resyncs += 1
        return n

    def _journal_size(self):
        try:
            return os.path.getsize(self._journal_path)
        except OSError:
            return 0

    def refresh(self):
        """Apply what other cells appended since our offset (at each
        heartbeat tick, and before every append)."""
        with self._flock():
            return self._refresh_locked()

    def _refresh_locked(self):
        size = self._journal_size()
        if size < self._offset:
            # another cell compacted: the snapshot owns our prefix now
            return self._resync_locked()
        if size == self._offset:
            return 0
        n = 0
        with open(self._journal_path) as f:
            f.seek(self._offset)
            for line in f.readlines():
                line = line.strip()
                if not line:
                    continue
                try:
                    self._apply(json.loads(line))
                    n += 1
                except ValueError:
                    # a line torn by a writer killed mid-append: skipped
                    # (the next append, through an open handle, lands
                    # after it and starts at our new offset)
                    break
            self._offset = f.tell()
        return n

    def record(self, event):
        """Write one event ahead, after every remote event not yet
        applied (refresh first, under the same flock)."""
        event = dict(event)
        event.setdefault("cell", self.cell_id)
        with self._flock():
            self._refresh_locked()
            if self._store.append(event):
                self._pending_compact = True
            self.appends += 1
            # applied locally already: refresh must not replay it
            self._offset = self._journal_size()

    def compact_at_tick(self):
        """At a tick boundary, when an append crossed snapshot_every:
        snapshot and truncate under one flock, refreshing first so no
        event is lost."""
        if not self._pending_compact:
            return False
        with self._flock():
            if not self._pending_compact:
                return False
            self._refresh_locked()
            self._store.write_snapshot(self._snapshot_state())
            self._offset = 0
            self._pending_compact = False
        return True

    def close(self):
        self._store.close()


class RouterCell(Router):
    """A Router whose registry is journal-backed and shared with sibling
    cells. The journal attributes exist before Router.__init__ runs,
    which registers the seeds through the overridden add_replica."""

    #: journal a lease beacon every N heartbeat ticks (forensic only)
    LEASE_JOURNAL_EVERY = 8

    def __init__(self, replica_addrs, config=None, journal_dir=None,
                 **kwargs):
        self._journal = None
        self._tick = 0
        self._cell_injector = None
        super(RouterCell, self).__init__(replica_addrs, config=config,
                                         **kwargs)
        if journal_dir:
            self._journal = CellRegistryJournal(
                journal_dir, cell_id=self.config.cell_id)
            self._journal.bind(self._apply_event, self._snapshot_state)
            replayed = self._journal.replay()
            # seeds become adopt events, so a sibling started with no
            # --replica still learns the whole fleet
            for rep in self.replicas():
                self._journal.record({"op": "adopt",
                                      "address": rep.address})
            logger.info(
                "router cell %d/%d: journal %s replayed %d items "
                "(restart #%d)", self.config.cell_id, self.config.cells,
                journal_dir, replayed, self._journal.restarts)

    def _apply_event(self, event):
        """One journal event into the registry through the base class's
        membership calls (nothing journaled)."""
        op = event.get("op")
        addr = event.get("address")
        if op == "adopt" and addr:
            Router.add_replica(self, addr)
        elif op == "retire" and addr:
            Router.remove_replica(self, addr)
        # "lease" and unknown ops: forensic only

    def _snapshot_state(self):
        return {"replicas": sorted(r.address for r in self.replicas())}

    def add_replica(self, address):
        with self._lock:
            known = address in self._replicas
        rep = Router.add_replica(self, address)
        if not known and self._journal is not None:
            self._journal.record({"op": "adopt", "address": address})
        return rep

    def remove_replica(self, address):
        rep = Router.remove_replica(self, address)
        if rep is not None and self._journal is not None:
            self._journal.record({"op": "retire", "address": address})
        return rep

    def poll_once(self):
        if self._journal is not None:
            try:
                self._journal.refresh()
            except Exception as e:  # noqa: BLE001 - the next tick retries
                logger.warning("cell %d journal refresh failed: %r",
                               self.config.cell_id, e)
        healthy = Router.poll_once(self)
        self._tick += 1
        if self._journal is not None:
            if self._tick % self.LEASE_JOURNAL_EVERY == 0:
                now = self._clock()
                self._journal.record({
                    "op": "lease",
                    "addresses": sorted(r.address for r in self.replicas()
                                        if r.in_rotation(now))})
            try:
                self._journal.compact_at_tick()
            except Exception as e:  # noqa: BLE001 - the next tick retries
                logger.warning("cell %d journal compact failed: %r",
                               self.config.cell_id, e)
        if self._cell_injector is not None:
            # a `cell_kill:kill` rule SIGKILLs this process at the tick
            self._cell_injector.intercept("cell_kill", context=None,
                                          when="before")
        return healthy

    def start(self, transport=True, injector=None):
        self._cell_injector = injector
        return Router.start(self, transport=transport, injector=injector)

    def stop(self, grace=5.0):
        Router.stop(self, grace=grace)
        if self._journal is not None:
            self._journal.close()

    def status_response(self):
        resp = Router.status_response(self)
        if self._journal is not None:
            resp.journal_events = self._journal.appends
            resp.journal_replayed = self._journal.replayed
            resp.cell_restarts = self._journal.restarts
        return resp


def _default_cell_stub_factory(address):
    from elasticdl_tpu_torch.proto.service import RouterStub, build_channel

    channel = build_channel(address)
    stub = RouterStub(channel)
    stub.close = channel.close
    return stub


class CellFront(object):
    """The client-side cell map: consistent-hash dispatch by prefix
    fingerprint and bounded reroute on cell death.

    A transient failure (UNAVAILABLE / CANCELLED / DEADLINE_EXCEEDED)
    means this cell died or wedged: reroute to the next ring successor,
    with full-jitter backoff inside `reroute_window_secs`. Backpressure
    (RESOURCE_EXHAUSTED) means the shared fleet is out of capacity: it
    propagates. Anything else is the request's own fault and propagates.
    A unary generate is idempotent end to end, so it reroutes at any
    point; a stream only before its first delivered chunk. Failures
    raise RouterError with the terminal status name."""

    def __init__(self, cell_addrs, stub_factory=None,
                 reroute_window_secs=15.0, base_delay_secs=0.05,
                 max_delay_secs=0.5, timeout_secs=120.0,
                 breaker_threshold=3, breaker_cooldown_secs=1.0,
                 block_tokens=16, max_blocks=4,
                 clock=time.monotonic, sleep=time.sleep):
        self._stub_factory = stub_factory or _default_cell_stub_factory
        self._clock = clock
        self._sleep = sleep
        self._timeout = float(timeout_secs)
        self._window = float(reroute_window_secs)
        self._block_tokens = int(block_tokens)
        self._max_blocks = int(max_blocks)
        self._breaker_threshold = int(breaker_threshold)
        self._breaker_cooldown = float(breaker_cooldown_secs)
        self._policy = RetryPolicy(
            base_delay_secs=base_delay_secs, max_delay_secs=max_delay_secs,
            reconnect_window_secs=reroute_window_secs)
        self._lock = threading.Lock()
        self._ring = HashRing()
        self._stubs = {}
        self._breakers = {}
        self.counters = {"routed": 0, "completed": 0, "rerouted": 0,
                         "cell_failures": 0, "shed": 0}
        for addr in cell_addrs:
            self.add_cell(addr)

    def add_cell(self, address):
        with self._lock:
            if address in self._stubs:
                return
            self._stubs[address] = self._stub_factory(address)
            self._breakers[address] = CircuitBreaker(
                self._breaker_threshold, self._breaker_cooldown)
            self._ring.add(address)

    def remove_cell(self, address):
        with self._lock:
            stub = self._stubs.pop(address, None)
            self._breakers.pop(address, None)
            self._ring.remove(address)
        close = getattr(stub, "close", None)
        if callable(close):
            try:
                close()
            except Exception as e:  # noqa: BLE001 - best effort
                logger.debug("closing cell channel %s failed: %r",
                             address, e)

    def cells(self):
        with self._lock:
            return self._ring.nodes()

    def close(self):
        for addr in list(self.cells()):
            self.remove_cell(addr)

    def _route_key(self, request):
        fp = prefix_fingerprint(request.prompt,
                                block_tokens=self._block_tokens,
                                max_blocks=self._max_blocks)
        if fp is not None:
            return fp
        # no full block to share: any deterministic key spreads them
        return "short:%d:%s" % (
            len(request.prompt),
            ",".join(str(t) for t in list(request.prompt)[:8]))

    def _targets(self, key):
        """The owner of `key`, then every other cell in ring order."""
        with self._lock:
            return [(addr, self._stubs[addr], self._breakers[addr])
                    for addr in self._ring.successors(key)
                    if addr in self._stubs]

    def _count(self, name):
        with self._lock:
            self.counters[name] += 1

    def _give_up(self, last_exc):
        return RouterError(
            _code_name(last_exc) if last_exc is not None else "UNAVAILABLE",
            "no router cell reachable inside the %.1fs reroute window: %r"
            % (self._window, last_exc))

    def _backoff(self, attempt, deadline):
        self._sleep(min(self._policy.backoff(attempt),
                        max(0.0, deadline - self._clock())))

    def generate(self, request, timeout=None):
        """Unary generate through the owning cell, walking the ring on a
        transient cell failure."""
        self._count("routed")
        key = self._route_key(request)
        timeout = self._timeout if timeout is None else timeout
        deadline = self._clock() + self._window
        attempt = 0
        last_exc = None
        while True:
            dispatched = False
            for _addr, stub, breaker in self._targets(key):
                if not breaker.acquire(self._clock()):
                    continue
                if attempt or dispatched:
                    self._count("rerouted")
                dispatched = True
                try:
                    resp = stub.router_generate(request, timeout=timeout)
                except Exception as e:  # noqa: BLE001 - classified
                    last_exc = e
                    if _backpressure(e):
                        # the cell answered: alive, the fleet saturated
                        breaker.record_success()
                        self._count("shed")
                        raise RouterError(_code_name(e), str(e))
                    if _transient(e):
                        breaker.record_failure(self._clock())
                        self._count("cell_failures")
                        continue
                    breaker.release_probe()
                    raise RouterError(_code_name(e), str(e))
                breaker.record_success()
                self._count("completed")
                return resp
            if self._clock() >= deadline:
                raise self._give_up(last_exc)
            self._backoff(attempt, deadline)
            attempt += 1

    def generate_stream(self, request, timeout=None):
        """Streamed generate: reroutes only before the first chunk
        reaches the caller; after it a cell loss fails the stream with
        UNAVAILABLE, as the router's own streams do."""
        self._count("routed")
        key = self._route_key(request)
        call_timeout = self._timeout if timeout is None else timeout
        deadline = self._clock() + self._window

        def gen():
            attempt = 0
            delivered = 0
            last_exc = None
            while True:
                for addr, stub, breaker in self._targets(key):
                    if not breaker.acquire(self._clock()):
                        continue
                    if attempt or last_exc is not None:
                        self._count("rerouted")
                    try:
                        for chunk in stub.router_generate_stream(
                                request, timeout=call_timeout):
                            delivered += len(chunk.tokens)
                            yield chunk
                        breaker.record_success()
                        self._count("completed")
                        return
                    except Exception as e:  # noqa: BLE001 - classified
                        last_exc = e
                        if delivered:
                            breaker.record_failure(self._clock())
                            raise RouterError(
                                "UNAVAILABLE",
                                "cell %s lost mid-stream after %d "
                                "delivered tokens (%s)"
                                % (addr, delivered, _code_name(e)))
                        if _backpressure(e):
                            breaker.record_success()
                            self._count("shed")
                            raise RouterError(_code_name(e), str(e))
                        if _transient(e):
                            breaker.record_failure(self._clock())
                            self._count("cell_failures")
                            continue
                        breaker.release_probe()
                        raise RouterError(_code_name(e), str(e))
                if self._clock() >= deadline:
                    raise self._give_up(last_exc)
                self._backoff(attempt, deadline)
                attempt += 1

        return gen()

    def status(self, request=None, timeout=5.0):
        """router_status from the first cell that answers, in the ring
        order of a fixed key."""
        request = request or pb.RouterStatusRequest()
        last_exc = None
        for _addr, stub, breaker in self._targets("status"):
            if not breaker.acquire(self._clock()):
                continue
            try:
                resp = stub.router_status(request, timeout=timeout)
            except Exception as e:  # noqa: BLE001 - try the next cell
                last_exc = e
                if _transient(e):
                    breaker.record_failure(self._clock())
                else:
                    breaker.release_probe()
                continue
            breaker.record_success()
            return resp
        raise RouterError(
            _code_name(last_exc) if last_exc is not None else "UNAVAILABLE",
            "no router cell answered status: %r" % (last_exc,))
