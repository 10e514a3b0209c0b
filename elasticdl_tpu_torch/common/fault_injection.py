"""Config/env-driven fault injection: the port's copy of the rules and
the injector of elasticdl_tpu/common/fault_injection.py.

Drill tests manufacture exactly the failures the fault-tolerance layer
claims to survive, without patching internals: the LocalExecutor calls
`intercept` at its dispatch boundary (``local_get_task``,
``local_report``), and a rule can drop the call, fail it after the
handler, delay it, or SIGKILL the process.

Spec grammar (EDL_FAULT_SPEC env var or the FaultInjector constructor),
semicolon-separated rules:

    <rpc>:<action>[:<count>[:<k>=<v>,...]]

    rpc     hook name (local_get_task, local_report, ...) or * for any
    action  drop   reject BEFORE the handler runs (request lost)
            error  run the handler, then reject (response lost)
            delay  sleep secs=... then proceed
            kill   SIGKILL the current process (crash drill)
    count   how many calls the rule fires on (default 1; * = forever)
    kwargs  secs=<float> (delay), skip=<int> (let N calls through
            first), code=<status name> (default UNAVAILABLE)

Examples:
    local_get_task:drop:1:skip=2    the third task fetch is lost
    local_get_task:kill:1:skip=2    the process dies on its 3rd fetch

The master's servicer is wrapped by `maybe_wrap_servicer` (the five
Master methods, `get_task:drop:3`, `report_task_result:error:1` ...),
the serving replica's with `rpcs=SERVING_RPCS` (`generate:error:3`,
`generate_stream:drop:1`, `server_status:delay:1:secs=2` ...), and the
local instance manager intercepts `worker_launch` / `worker_exit`.

The card's machine has no grpc, so a rejected call raises the port's
`InjectedRpcError`, an `RpcError` of the port's transport
(proto/service.py) whose `code()` is the status name as a string: the
transport answers it with that status, and common/retry.py classifies
it as a transport failure, as the JAX package's subclass of
grpc.RpcError is.
"""

import logging
import os
import signal
import threading
import time

from elasticdl_tpu_torch.proto.service import RpcError

logger = logging.getLogger(__name__)

FAULT_SPEC_ENV = "EDL_FAULT_SPEC"


class InjectedRpcError(RpcError):
    """An injected fault: `code()` is the status name (e.g.
    "UNAVAILABLE"), `details()` what was injected where."""

    def __str__(self):
        return "InjectedRpcError(%s, %r)" % (self.code(), self.details())


class FaultRule(object):
    def __init__(self, rpc, action, count=1, skip=0, secs=0.0,
                 code="UNAVAILABLE"):
        if action not in ("drop", "error", "delay", "kill"):
            raise ValueError("unknown fault action %r" % action)
        self.rpc = rpc
        self.action = action
        self.count = count  # None = forever
        self.skip = skip
        self.secs = secs
        self.code = code
        self._seen = 0
        self._fired = 0

    def matches(self, rpc_name):
        return self.rpc in ("*", rpc_name)

    def consume(self):
        """One call against this rule; True if the fault fires."""
        self._seen += 1
        if self._seen <= self.skip:
            return False
        if self.count is not None and self._fired >= self.count:
            return False
        self._fired += 1
        return True

    @classmethod
    def parse(cls, text):
        parts = text.strip().split(":")
        if len(parts) < 2:
            raise ValueError("bad fault rule %r" % text)
        rpc, action = parts[0], parts[1]
        count = 1
        kwargs = {}
        if len(parts) > 2 and parts[2]:
            count = None if parts[2] == "*" else int(parts[2])
        if len(parts) > 3 and parts[3]:
            for kv in parts[3].split(","):
                k, _, v = kv.partition("=")
                if k == "secs":
                    kwargs["secs"] = float(v)
                elif k == "skip":
                    kwargs["skip"] = int(v)
                elif k == "code":
                    kwargs["code"] = v
                else:
                    raise ValueError("bad fault kwarg %r in %r" % (kv, text))
        return cls(rpc, action, count=count, **kwargs)


class FaultInjector(object):
    """Holds the active rules; `intercept` is the single choke point.

    Thread-safe: intercept may be called from many threads.
    """

    def __init__(self, spec="", rules=None, kill_fn=None):
        self._lock = threading.Lock()
        self.rules = list(rules or [])
        if spec:
            self.rules.extend(
                FaultRule.parse(r) for r in spec.split(";") if r.strip()
            )
        self.injected = {}  # rpc_name -> fired-fault count
        self._kill_fn = kill_fn or (
            lambda: os.kill(os.getpid(), signal.SIGKILL)
        )

    @classmethod
    def from_env(cls, env=None):
        """Injector from EDL_FAULT_SPEC, or None when unset (the
        zero-overhead production default)."""
        spec = (env or os.environ).get(FAULT_SPEC_ENV, "")
        return cls(spec=spec) if spec else None

    def _fire(self, rpc_name, when):
        with self._lock:
            for rule in self.rules:
                if not rule.matches(rpc_name):
                    continue
                # drop rejects pre-handler, error rejects post-handler;
                # delay/kill apply pre-handler
                pre = rule.action in ("drop", "delay", "kill")
                if (when == "before") != pre:
                    continue
                if rule.consume():
                    self.injected[rpc_name] = (
                        self.injected.get(rpc_name, 0) + 1
                    )
                    return rule
        return None

    def intercept(self, rpc_name, context=None, when="before",
                  trace_id=""):
        """Apply the first matching armed rule: raise InjectedRpcError
        for drop (when="before") and error (when="after"), sleep for
        delay, SIGKILL the process for kill; no-op when nothing
        matches. `context` and `trace_id` are the JAX signature's: the
        port's transport answers the raised error with its code, and
        tracing is not ported."""
        del context, trace_id
        rule = self._fire(rpc_name, when)
        if rule is None:
            return
        if rule.action == "delay":
            logger.warning(
                "[fault] delaying %s by %.2fs", rpc_name, rule.secs
            )
            time.sleep(rule.secs)
            return
        if rule.action == "kill":
            logger.warning("[fault] SIGKILL self on %s", rpc_name)
            self._kill_fn()
            return
        logger.warning(
            "[fault] %s %s (%s)", rule.action, rpc_name, rule.code
        )
        raise InjectedRpcError(
            rule.code, "injected fault: %s %s" % (rule.action, rpc_name))


# RPCs the servicer wrapper intercepts (proto/service.py's table)
_SERVICER_RPCS = (
    "get_task",
    "report_task_result",
    "report_evaluation_metrics",
    "report_version",
    "register_worker",
)


# The routing tier's surface (serving/router.py); its names ride in
# SERVING_RPCS so one spec grammar covers both boundaries
ROUTER_RPCS = (
    "router_generate",
    "router_generate_stream",
    "router_status",
)

# The serving front-end's RPC surface and intercept hooks, as the JAX
# package names them; a servicer exposes only its own subset and the
# wrapper skips the names it does not have. The port's replica serves
# generate, generate_stream, server_status, the three chain-transfer
# methods and reload_checkpoint; the router serves the three router_*
# methods and consults the disagg_handoff hook itself.
SERVING_RPCS = (
    "generate",
    "generate_stream",
    "server_status",
    "export_chain",
    "transfer_chain",
    "abort_transfer",
    "disagg_handoff",
    "reload_checkpoint",
    "checkpoint_read",
) + ROUTER_RPCS

# The replica supervisor's process boundary (serving/autoscaler.py) and
# the rollout controller's (serving/rollout.py): hooks the controllers
# intercept() directly, not servicer methods, as the JAX package names
# them --
#   supervisor_spawn:drop:1          one spawn fails outright
#   supervisor_ready:delay:*:secs=2  every replica is slow to ready
#   supervisor_adopt:drop:1          one adoption is dropped (the seat is
#                                    reaped and respawned)
#   rollout_swap:kill:1:skip=1       the controller dies before its
#                                    second reload dispatch (mid-wave)
#   rollout_judge:drop:1             one canary judgment is skipped
SUPERVISOR_RPCS = (
    "supervisor_spawn",
    "supervisor_ready",
    "supervisor_adopt",
    "rollout_swap",
    "rollout_judge",
)

# The router cell tier's hooks (serving/router_cell.py, router_main
# --cells): the cell supervisor intercepts `cell_spawn` at each cell
# launch, each cell `cell_kill` at its heartbeat tick --
#   cell_kill:kill:1:skip=4    the cell dies on its 5th heartbeat
#   cell_spawn:drop:1          one cell launch fails outright
CELL_HOOKS = (
    "cell_spawn",
    "cell_kill",
)

# The runtime-health plane's hooks (observability/runtime_health.py,
# serving/server.py), direct intercept() call sites as in the JAX
# package: a spec makes exactly the failures the plane observes --
#   engine_step:delay:1:secs=600,skip=5   the scheduler wedges on its
#                                         6th decode tick (work stays
#                                         seated, tokens stop)
#   health_leak:drop:1                    the health thread leaks one
#                                         8 MiB device buffer no ledger
#                                         line names; the memory
#                                         accountant must convict it
HEALTH_RPCS = (
    "engine_step",
    "health_leak",
)


class FaultInjectingServicer(object):
    """Transparent servicer wrapper: the same RPC surface, with
    injector.intercept applied before and after each handler. Other
    attributes (get_model_version, the watchdog helpers ...) proxy
    through. `rpcs` selects the intercepted surface (default: the
    Master table; serving processes pass SERVING_RPCS); names the
    servicer does not implement are skipped."""

    def __init__(self, servicer, injector, rpcs=_SERVICER_RPCS):
        self._servicer = servicer
        self._injector = injector
        for name in rpcs:
            if hasattr(servicer, name):
                setattr(self, name, self._wrap(name))

    def _wrap(self, name):
        handler = getattr(self._servicer, name)

        def rpc(request, _context=None):
            self._injector.intercept(name, context=_context, when="before")
            response = handler(request, _context)
            self._injector.intercept(name, context=_context, when="after")
            return response

        rpc.__name__ = name
        return rpc

    def __getattr__(self, name):
        return getattr(self._servicer, name)


def maybe_wrap_servicer(servicer, injector=None, rpcs=_SERVICER_RPCS):
    """Wrap when an injector is active (explicit or via EDL_FAULT_SPEC);
    otherwise return the servicer untouched."""
    injector = injector or FaultInjector.from_env()
    if injector is None or not injector.rules:
        return servicer
    logger.warning(
        "Fault injection ACTIVE on servicer %s: %s",
        type(servicer).__name__,
        [(r.rpc, r.action, r.count) for r in injector.rules],
    )
    return FaultInjectingServicer(servicer, injector, rpcs=rpcs)
