"""Routing-tier process entry point: the port of
elasticdl_tpu/serving/router_main.py.

Stands the health-checked router (serving/router.py) in front of N
replicas of `elasticdl_tpu_torch.serving.main` and serves router_generate
/ router_generate_stream / router_status over the port's transport until
SIGTERM or SIGINT. A control plane only: the process imports neither
torch nor jax and starts in well under a second.

    python -m elasticdl_tpu_torch.serving.router_main \\
        --replica localhost:50051 --replica localhost:50052 --port 50050

It prints `ROUTER_READY port=N` once bound (`--port 0`: an ephemeral
port) and names its span recorder `router:N` (spans export to
$EDL_TRACE_DIR on stop). `--affinity_block_tokens` must equal the
replicas' `--kv_block_size`. Fault injection at the router boundary uses
EDL_FAULT_SPEC under the router RPC names (`router_generate:error:2`) and
the handoff hook (`disagg_handoff:drop:1`).

The parser takes every flag of the JAX entry with its default. Not
accepted yet, each raising NotImplementedError with the ROADMAP item
that ports it: `--cells` > 1, `--cell_id` >= 0 and `--cell_journal_dir`
(the multi-cell tier, router_cell.py), `--autoscale` and its flags (the
replica supervisor, autoscaler.py), `--rollout*` (the rollout
controller, rollout.py), all ROADMAP Queue 1 item 4; `--metrics_port` >=
0 and `--tensorboard_log_dir` (item 6, the metrics plane). The JAX
entry's SIGUSR2 all-thread stack dump comes from runtime_health.py
(item 6) and is left out.
"""

import argparse
import logging
import signal
import sys
import threading

from elasticdl_tpu_torch.observability.tracing import configure
from elasticdl_tpu_torch.serving.router import Router, RouterConfig

logger = logging.getLogger(__name__)

_ITEM4 = "ROADMAP Queue 1 item 4, the %s"
_ITEM6 = "ROADMAP Queue 1 item 6, the metrics plane"

# flag -> (its default, what ports it); a value other than the default
# raises, as do --cells > 1, --cell_id >= 0 and --metrics_port >= 0
_UNPORTED = (
    ("cell_journal_dir", "", _ITEM4 % "multi-cell tier (router_cell.py)"),
    ("autoscale", False, _ITEM4 % "replica supervisor (autoscaler.py)"),
    ("replica_args", "", _ITEM4 % "replica supervisor (autoscaler.py)"),
    ("min_replicas", 1, _ITEM4 % "replica supervisor (autoscaler.py)"),
    ("max_replicas", 4, _ITEM4 % "replica supervisor (autoscaler.py)"),
    ("journal_dir", "", _ITEM4 % "replica supervisor (autoscaler.py)"),
    ("decide_secs", 0.5, _ITEM4 % "replica supervisor (autoscaler.py)"),
    ("up_queue_wait_ms", 200.0,
     _ITEM4 % "replica supervisor (autoscaler.py)"),
    ("up_window_secs", 2.0, _ITEM4 % "replica supervisor (autoscaler.py)"),
    ("down_window_secs", 6.0,
     _ITEM4 % "replica supervisor (autoscaler.py)"),
    ("scale_cooldown_secs", 5.0,
     _ITEM4 % "replica supervisor (autoscaler.py)"),
    ("max_restarts", 3, _ITEM4 % "replica supervisor (autoscaler.py)"),
    ("rollout_journal_dir", "", _ITEM4 % "rollout controller (rollout.py)"),
    ("rollout_checkpoint_dir", "",
     _ITEM4 % "rollout controller (rollout.py)"),
    ("rollout", -1, _ITEM4 % "rollout controller (rollout.py)"),
    ("rollout_wave_size", 1, _ITEM4 % "rollout controller (rollout.py)"),
    ("rollout_soak_secs", 3.0, _ITEM4 % "rollout controller (rollout.py)"),
    ("rollout_judge_timeout_secs", 60.0,
     _ITEM4 % "rollout controller (rollout.py)"),
    ("rollout_parity_prompts", "1,2,3",
     _ITEM4 % "rollout controller (rollout.py)"),
    ("tensorboard_log_dir", "", _ITEM6),
)


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
                        help="-1 resolves from EDL_METRICS_PORT (unset = "
                             "off); not ported yet")
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
    for name, default, item in _UNPORTED:
        if getattr(parsed, name) != default:
            raise NotImplementedError(
                "--%s is not ported yet (%s)" % (name, item))
    for name, unported, item in (
            ("cells", parsed.cells > 1,
             _ITEM4 % "multi-cell tier (router_cell.py)"),
            ("cell_id", parsed.cell_id >= 0,
             _ITEM4 % "multi-cell tier (router_cell.py)"),
            ("metrics_port", parsed.metrics_port >= 0, _ITEM6)):
        if unported:
            raise NotImplementedError(
                "--%s is not ported yet (%s)" % (name, item))
    if not parsed.replica:
        parser.error("at least one --replica is required")
    return parsed


def build_router(args):
    return Router(args.replica, RouterConfig(
        poll_secs=args.poll_secs,
        poll_timeout_secs=args.poll_timeout_secs,
        lease_secs=args.lease_secs,
        breaker_threshold=args.breaker_threshold,
        breaker_cooldown_secs=args.breaker_cooldown_secs,
        hedge_delay_secs=args.hedge_delay_ms / 1000.0,
        dispatch_timeout_secs=args.dispatch_timeout_secs,
        redispatch_window_secs=args.redispatch_window_secs,
        port=args.port,
        metrics_port=None,
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
    ))


def main(argv=None):
    args = parse_router_args(argv)
    logging.basicConfig(level=logging.INFO)
    router = build_router(args).start()
    configure(service="router:%d" % router.port)
    done = threading.Event()

    def _graceful(_signum, _frame):
        logger.info("signal received: stopping router")
        done.set()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)
    print("ROUTER_READY port=%d" % router.port, flush=True)
    done.wait()
    router.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
