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

The card's machine has no grpc, so a rejected call raises the port's
`InjectedRpcError`, whose `code()` is the status name as a string. The
servicer wrappers wait for the port's transport.
"""

import logging
import os
import signal
import threading
import time

logger = logging.getLogger(__name__)

FAULT_SPEC_ENV = "EDL_FAULT_SPEC"


class InjectedRpcError(Exception):
    """An injected fault: `code()` is the status name (e.g.
    "UNAVAILABLE"), `details()` what was injected where."""

    def __init__(self, code, details):
        super().__init__(details)
        self._code = code
        self._details = details

    def code(self):
        return self._code

    def details(self):
        return self._details

    def __str__(self):
        return "InjectedRpcError(%s, %r)" % (self._code, self._details)


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

    def intercept(self, rpc_name, when="before"):
        """Apply the first matching armed rule: raise InjectedRpcError
        for drop (when="before") and error (when="after"), sleep for
        delay, SIGKILL the process for kill; no-op when nothing
        matches."""
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
