"""Routing-tier process entry point: the port of
elasticdl_tpu/serving/router_main.py.

Stands the health-checked router (serving/router.py) in front of N
replicas of `elasticdl_tpu_torch.serving.main` and serves router_generate
/ router_generate_stream / router_status over the port's transport until
SIGTERM or SIGINT. A control plane only: the process imports neither
torch nor jax, in every mode below.

    python -m elasticdl_tpu_torch.serving.router_main \\
        --replica localhost:50051 --replica localhost:50052 --port 50050

It prints `ROUTER_READY port=N` once bound (`--port 0`: an ephemeral
port) and names its span recorder `router:N` (spans export to
$EDL_TRACE_DIR on stop). `--affinity_block_tokens` must equal the
replicas' `--kv_block_size`.

With --autoscale the fleet is elastic: the replica supervisor
(serving/autoscaler.py) spawns `elasticdl_tpu_torch.serving.main`
replicas with --replica_args, replaces dead ones, scales between
--min_replicas and --max_replicas on the router's load signals, and
journals every transition to --journal_dir, so a restarted router
re-adopts the live fleet:

    python -m elasticdl_tpu_torch.serving.router_main --port 50050 \\
        --autoscale --min_replicas 1 --max_replicas 4 \\
        --journal_dir /var/lib/edl/fleet \\
        --replica_args "--model_params '...' --kv_paged 1 --port 0"

With --cells N (> 1) the process supervises N router cells
(serving/router_cell.py) on ports --port .. --port+N-1, sharing one
replica registry through the journal in --cell_journal_dir, printing
`CELL_STARTED cell=i port=P` for each and `ROUTER_CELLS_READY count=N`,
and restarting a cell that dies (at most MAX_CELL_RESTARTS times). Each
cell is this entry point with an explicit --cell_id (it prints
`ROUTER_CELL cell=i cells=N` before its ready line); a cell started with
--cell_journal_dir and no --replica learns the fleet from the journal.
Clients reach the tier through router_cell.CellFront or any one cell.

With --rollout V the process also runs the rollout controller
(serving/rollout.py): canary, greedy-parity and SLO-burn judgment,
progressive waves, commit, journaled to --rollout_journal_dir, so a
restart with that flag alone resumes an unfinished rollout:

    python -m elasticdl_tpu_torch.serving.router_main --port 50050 \\
        --replica localhost:50051 --replica localhost:50052 \\
        --rollout 7 --rollout_checkpoint_dir /ckpt \\
        --rollout_journal_dir /var/lib/edl/rollout

Fault injection uses EDL_FAULT_SPEC: the router RPC names
(`router_generate:error:2`), the handoff hook (`disagg_handoff:drop:1`),
the supervisor's and the rollout's hooks (`supervisor_spawn`,
`supervisor_ready`, `supervisor_adopt`, `rollout_swap`,
`rollout_judge`) and the cells' (`cell_spawn`, `cell_kill`).

`--metrics_port N` (-1 resolves from EDL_METRICS_PORT, unset = off; 0 =
an ephemeral port) serves the router's Prometheus page at `GET /metrics`
and prints `METRICS_READY port=N` before ROUTER_READY.

Not accepted yet: `--tensorboard_log_dir` raises NotImplementedError
(ROADMAP Queue 1 item 6, the TensorBoard writers). The JAX entry's
SIGUSR2 all-thread stack dump comes from runtime_health.py (item 6, the
runtime-health plane) and is left out.
"""

import argparse
import logging
import os
import shlex
import signal
import subprocess
import sys
import threading

from elasticdl_tpu_torch.common.fault_injection import FaultInjector
from elasticdl_tpu_torch.observability.tracing import configure
from elasticdl_tpu_torch.serving.router import Router, RouterConfig

logger = logging.getLogger(__name__)

_ITEM6 = "ROADMAP Queue 1 item 6, the TensorBoard writers"


def parse_router_args(args=None):
    parser = argparse.ArgumentParser(
        description="elasticdl-tpu serving router (PyTorch port)")
    parser.add_argument("--replica", action="append", default=[],
                        help="replica address host:port (repeatable)")
    parser.add_argument("--port", type=int, default=50050)
    parser.add_argument("--poll_secs", type=float, default=0.5)
    parser.add_argument("--poll_timeout_secs", type=float, default=2.0)
    parser.add_argument("--lease_secs", type=float, default=2.5)
    parser.add_argument("--breaker_threshold", type=int, default=3)
    parser.add_argument("--breaker_cooldown_secs", type=float, default=2.0)
    parser.add_argument("--hedge_delay_ms", type=float, default=0.0,
                        help="0 disables hedged duplicate dispatch")
    parser.add_argument("--dispatch_timeout_secs", type=float,
                        default=120.0)
    parser.add_argument("--redispatch_window_secs", type=float,
                        default=30.0)
    parser.add_argument("--tensorboard_log_dir", default="")
    parser.add_argument("--metrics_port", type=int, default=-1,
                        help="the /metrics port; -1 resolves from "
                             "EDL_METRICS_PORT (unset = off), 0 = an "
                             "ephemeral one")
    parser.add_argument("--slo_ttft_p99_ms", type=float, default=30000.0)
    parser.add_argument("--slo_e2e_p99_ms", type=float, default=60000.0)
    parser.add_argument("--slo_latency_goal", type=float, default=0.01,
                        help="allowed fraction of requests over a latency "
                             "threshold (the error budget)")
    parser.add_argument("--slo_goodput_goal", type=float, default=0.02,
                        help="allowed failed fraction (shed + errors over "
                             "routed)")
    parser.add_argument("--slo_fast_window_secs", type=float, default=30.0)
    parser.add_argument("--slo_slow_window_secs", type=float,
                        default=120.0)
    parser.add_argument("--affinity", type=int, default=1,
                        help="1 = prefix-affine dispatch (decays to "
                             "least-loaded), 0 = prefix-blind")
    parser.add_argument("--affinity_block_tokens", type=int, default=16,
                        help="the KV block the fingerprint chains over "
                             "(match the replicas' --kv_block_size)")
    parser.add_argument("--affinity_ttl_secs", type=float, default=60.0)
    parser.add_argument("--affinity_load_margin", type=float, default=2.0,
                        help="max load-score excess over the least-loaded "
                             "candidate an affine target may carry")
    parser.add_argument("--disagg", type=int, default=1,
                        help="1 = orchestrate prefill -> decode chain "
                             "handoffs when a replica advertises --role "
                             "prefill, 0 = every replica unified")
    parser.add_argument("--disagg_timeout_secs", type=float, default=10.0,
                        help="per-leg deadline of the handoff's calls")
    parser.add_argument("--cells", type=int, default=1)
    parser.add_argument("--cell_id", type=int, default=-1)
    parser.add_argument("--cell_journal_dir", default="")
    parser.add_argument("--autoscale", action="store_true")
    parser.add_argument("--replica_args", default="")
    parser.add_argument("--min_replicas", type=int, default=1)
    parser.add_argument("--max_replicas", type=int, default=4)
    parser.add_argument("--journal_dir", default="")
    parser.add_argument("--decide_secs", type=float, default=0.5)
    parser.add_argument("--up_queue_wait_ms", type=float, default=200.0)
    parser.add_argument("--up_window_secs", type=float, default=2.0)
    parser.add_argument("--down_window_secs", type=float, default=6.0)
    parser.add_argument("--scale_cooldown_secs", type=float, default=5.0)
    parser.add_argument("--max_restarts", type=int, default=3)
    parser.add_argument("--rollout_journal_dir", default="")
    parser.add_argument("--rollout_checkpoint_dir", default="")
    parser.add_argument("--rollout", type=int, default=-1)
    parser.add_argument("--rollout_wave_size", type=int, default=1)
    parser.add_argument("--rollout_soak_secs", type=float, default=3.0)
    parser.add_argument("--rollout_judge_timeout_secs", type=float,
                        default=60.0)
    parser.add_argument("--rollout_parity_prompts", default="1,2,3")
    parsed = parser.parse_args(args)
    if parsed.tensorboard_log_dir:
        raise NotImplementedError(
            "--tensorboard_log_dir is not ported yet (%s)" % _ITEM6)
    if (not parsed.replica and not parsed.autoscale
            and not parsed.cell_journal_dir):
        parser.error("at least one --replica is required (or pass "
                     "--autoscale, or --cell_journal_dir to replay the "
                     "fleet from a sibling cell's journal)")
    if parsed.autoscale and not parsed.replica_args:
        parser.error("--autoscale needs --replica_args to know how to "
                     "launch replicas")
    if parsed.rollout >= 0 and not parsed.rollout_journal_dir:
        parser.error("--rollout needs --rollout_journal_dir: an "
                     "unjournaled fleet swap cannot survive a controller "
                     "crash")
    if parsed.rollout >= 0 and not parsed.rollout_checkpoint_dir:
        parser.error("--rollout needs --rollout_checkpoint_dir to verify "
                     "the target checkpoint before any swap")
    return parsed


def build_router(args):
    config = RouterConfig(
        poll_secs=args.poll_secs,
        poll_timeout_secs=args.poll_timeout_secs,
        lease_secs=args.lease_secs,
        breaker_threshold=args.breaker_threshold,
        breaker_cooldown_secs=args.breaker_cooldown_secs,
        hedge_delay_secs=args.hedge_delay_ms / 1000.0,
        dispatch_timeout_secs=args.dispatch_timeout_secs,
        redispatch_window_secs=args.redispatch_window_secs,
        port=args.port,
        metrics_port=(None if args.metrics_port < 0 else args.metrics_port),
        slo_ttft_p99_ms=args.slo_ttft_p99_ms,
        slo_e2e_p99_ms=args.slo_e2e_p99_ms,
        slo_latency_goal=args.slo_latency_goal,
        slo_goodput_goal=args.slo_goodput_goal,
        slo_fast_window_secs=args.slo_fast_window_secs,
        slo_slow_window_secs=args.slo_slow_window_secs,
        affinity=bool(args.affinity),
        affinity_block_tokens=args.affinity_block_tokens,
        affinity_ttl_secs=args.affinity_ttl_secs,
        affinity_load_margin=args.affinity_load_margin,
        disagg=bool(args.disagg),
        disagg_timeout_secs=args.disagg_timeout_secs,
        cell_id=max(0, args.cell_id),
        cells=max(1, args.cells),
    )
    if args.cell_journal_dir:
        from elasticdl_tpu_torch.serving.router_cell import RouterCell

        return RouterCell(args.replica, config,
                          journal_dir=args.cell_journal_dir)
    return Router(args.replica, config)


def build_supervisor(args, router):
    from elasticdl_tpu_torch.serving.autoscaler import (
        AutoscalerConfig,
        ReplicaSupervisor,
        SubprocessReplicaLauncher,
    )

    journal_dir = args.journal_dir or os.path.join(
        ".", "edl_fleet_%d" % os.getpid())
    launcher = SubprocessReplicaLauncher(
        shlex.split(args.replica_args),
        log_dir=os.path.join(journal_dir, "logs"))
    supervisor = ReplicaSupervisor(router, launcher, AutoscalerConfig(
        min_replicas=args.min_replicas,
        max_replicas=args.max_replicas,
        decide_secs=args.decide_secs,
        up_queue_wait_ms=args.up_queue_wait_ms,
        up_window_secs=args.up_window_secs,
        down_window_secs=args.down_window_secs,
        cooldown_secs=args.scale_cooldown_secs,
        max_restarts=args.max_restarts,
        journal_dir=journal_dir,
    ))
    router.set_autoscaler(supervisor)
    return supervisor


def _cell_child_argv(args, cell_id):
    """One cell's command line: this entry point with an explicit
    --cell_id (so it never recurses into the cell supervisor), its own
    port and the shared journal dir; the tier's shared flags verbatim."""
    argv = [
        sys.executable, "-m", "elasticdl_tpu_torch.serving.router_main",
        "--cell_id", str(cell_id),
        "--cells", str(args.cells),
        "--port", str(args.port + cell_id),
        "--cell_journal_dir", args.cell_journal_dir,
        "--poll_secs", str(args.poll_secs),
        "--poll_timeout_secs", str(args.poll_timeout_secs),
        "--lease_secs", str(args.lease_secs),
        "--breaker_threshold", str(args.breaker_threshold),
        "--breaker_cooldown_secs", str(args.breaker_cooldown_secs),
        "--dispatch_timeout_secs", str(args.dispatch_timeout_secs),
        "--redispatch_window_secs", str(args.redispatch_window_secs),
        "--affinity", str(args.affinity),
        "--affinity_block_tokens", str(args.affinity_block_tokens),
        "--affinity_ttl_secs", str(args.affinity_ttl_secs),
        "--affinity_load_margin", str(args.affinity_load_margin),
        "--disagg", str(int(args.disagg)),
        "--disagg_timeout_secs", str(args.disagg_timeout_secs),
    ]
    for addr in args.replica:
        argv += ["--replica", addr]
    return argv


class CellRoster(object):
    """The cell supervisor's process roster: every spawn_cell() settles
    in adopt() (the cell joins the roster) or retire() (terminate and
    wait). Each cell's output goes to a log file under the journal dir,
    not a pipe."""

    def __init__(self, args, log_dir=None):
        self._args = args
        self._log_dir = log_dir or os.path.join(args.cell_journal_dir,
                                                "logs")
        os.makedirs(self._log_dir, exist_ok=True)
        self._cells = {}  # cell_id -> subprocess.Popen
        self.restarts = {}  # cell_id -> count

    def spawn_cell(self, cell_id):
        log = open(os.path.join(self._log_dir, "cell_%d.log" % cell_id),
                   "a")
        try:
            proc = subprocess.Popen(_cell_child_argv(self._args, cell_id),
                                    stdout=log, stderr=subprocess.STDOUT)
        finally:
            log.close()  # the child holds its own descriptor
        proc.cell_id = cell_id
        return proc

    def adopt(self, proc):
        self._cells[proc.cell_id] = proc
        logger.info("cell %d adopted (pid %d, port %d)", proc.cell_id,
                    proc.pid, self._args.port + proc.cell_id)

    def retire(self, proc):
        self._cells.pop(proc.cell_id, None)
        if proc.poll() is None:
            proc.terminate()
        try:
            proc.wait(timeout=10.0)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()

    def live(self):
        return dict(self._cells)

    def reap_dead(self):
        """The ids of cells that exited on their own (waited for)."""
        dead = [cid for cid, p in self._cells.items()
                if p.poll() is not None]
        for cid in dead:
            self._cells.pop(cid)
        return dead


#: a cell that died this many times stays down
MAX_CELL_RESTARTS = 3


def launch_cells(args):
    """--cells N: spawn one router cell an id on ports --port ..
    --port+N-1, restart a dead cell (at most MAX_CELL_RESTARTS times),
    SIGTERM the roster on shutdown. The registry journal carries the
    fleet, so a restarted cell replays it."""
    if not args.cell_journal_dir:
        args.cell_journal_dir = os.path.join(".", "edl_cells_%d"
                                             % os.getpid())
    os.makedirs(args.cell_journal_dir, exist_ok=True)
    injector = FaultInjector.from_env()
    roster = CellRoster(args)

    def spawn_adopted(cell_id):
        if injector is not None:
            # a `cell_spawn:drop` rule fails this launch
            injector.intercept("cell_spawn", context=None, when="before")
        proc = roster.spawn_cell(cell_id)
        try:
            roster.adopt(proc)
        except Exception:
            roster.retire(proc)
            raise
        return proc

    for i in range(args.cells):
        spawn_adopted(i)
        print("CELL_STARTED cell=%d port=%d" % (i, args.port + i),
              flush=True)
    print("ROUTER_CELLS_READY count=%d" % args.cells, flush=True)
    done = threading.Event()

    def _graceful(_signum, _frame):
        logger.info("signal received: stopping %d router cells",
                    len(roster.live()))
        done.set()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)
    while not done.wait(0.5):
        for cell_id in roster.reap_dead():
            n = roster.restarts.get(cell_id, 0)
            if n >= MAX_CELL_RESTARTS:
                logger.error("cell %d exceeded %d restarts; leaving it "
                             "down", cell_id, MAX_CELL_RESTARTS)
                continue
            roster.restarts[cell_id] = n + 1
            logger.warning("cell %d died; restarting (%d/%d)", cell_id,
                           n + 1, MAX_CELL_RESTARTS)
            try:
                spawn_adopted(cell_id)
            except Exception as e:  # noqa: BLE001 - retried next tick
                logger.error("cell %d respawn failed: %r", cell_id, e)
    for proc in roster.live().values():
        roster.retire(proc)
    return 0


def main(argv=None):
    args = parse_router_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.cells > 1 and args.cell_id < 0:
        return launch_cells(args)
    router = build_router(args).start()
    supervisor = None
    if args.autoscale:
        supervisor = build_supervisor(args, router).start()
    rollout = None
    if args.rollout_journal_dir:
        from elasticdl_tpu_torch.serving.rollout import build_rollout

        rollout = build_rollout(args, router)
        router.set_rollout(rollout)
        if args.rollout >= 0:
            # deferred to the first decide tick that finds a fleet
            rollout.request(args.rollout)
        rollout.start()
    configure(service="router:%d" % router.port)
    done = threading.Event()

    def _graceful(_signum, _frame):
        logger.info("signal received: stopping router")
        done.set()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)
    if router.metrics is not None:
        print("METRICS_READY port=%d" % router.metrics.port, flush=True)
    if args.cell_id >= 0:
        # a line of its own: readers parse `port=` off the READY line
        print("ROUTER_CELL cell=%d cells=%d" % (args.cell_id, args.cells),
              flush=True)
    print("ROUTER_READY port=%d" % router.port, flush=True)
    done.wait()
    # the controller first (it calls into the fleet), then the
    # supervisor (it drains the fleet it owns), then the router
    if rollout is not None:
        rollout.stop()
    if supervisor is not None:
        supervisor.stop()
    router.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
