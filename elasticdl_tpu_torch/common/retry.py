"""Bounded retries for worker -> master calls: the port's copy of
elasticdl_tpu/common/retry.py.

Per-call deadlines, exponential backoff with full jitter (sleep =
uniform(0, min(cap, base * 2**attempt))) and a bounded reconnect window,
after which the caller gets the real error back, so a dead master fails
the worker loudly instead of hanging it.

The classifiers read the status name of the port's `RpcError`
(proto/service.py; the fault injector's `InjectedRpcError` is one) as
the JAX package reads `grpc.RpcError.code()`: UNAVAILABLE, CANCELLED and
DEADLINE_EXCEEDED are transient (a restarting master), RESOURCE_EXHAUSTED
is backpressure from a live server, anything else is not retried.
"""

import logging
import random
import time

from elasticdl_tpu_torch.proto.service import status_name

logger = logging.getLogger(__name__)

_TRANSIENT = ("UNAVAILABLE", "CANCELLED", "DEADLINE_EXCEEDED")


class RetryPolicy(object):
    """Backoff / deadline knobs for one class of calls.
    reconnect_window_secs bounds the total time spent retrying one
    logical call."""

    def __init__(
        self,
        rpc_timeout_secs=30.0,
        base_delay_secs=0.1,
        max_delay_secs=5.0,
        reconnect_window_secs=120.0,
    ):
        self.rpc_timeout_secs = rpc_timeout_secs
        self.base_delay_secs = base_delay_secs
        self.max_delay_secs = max_delay_secs
        self.reconnect_window_secs = reconnect_window_secs

    def backoff(self, attempt):
        """Full-jitter exponential backoff delay for `attempt` (0-based)."""
        cap = min(
            self.max_delay_secs, self.base_delay_secs * (2 ** attempt)
        )
        return random.uniform(0, cap)


def is_transient_rpc_error(exc):
    """True for the statuses a server restart produces: UNAVAILABLE,
    CANCELLED, DEADLINE_EXCEEDED. Not RESOURCE_EXHAUSTED (see
    is_backpressure_rpc_error)."""
    return status_name(exc) in _TRANSIENT


def is_backpressure_rpc_error(exc):
    """True for RESOURCE_EXHAUSTED: the server is alive but shedding
    load."""
    return status_name(exc) == "RESOURCE_EXHAUSTED"


def is_retryable_rpc_error(exc):
    """Transient or backpressure: what a multi-replica caller retries."""
    return is_transient_rpc_error(exc) or is_backpressure_rpc_error(exc)


def retry_call(
    fn,
    policy=None,
    is_retryable=is_transient_rpc_error,
    on_retry=None,
    sleep=time.sleep,
    clock=time.monotonic,
    what="rpc",
):
    """Call `fn()`, retrying failures `is_retryable` accepts with
    `policy.backoff(attempt)` sleeps until `policy.reconnect_window_secs`
    has passed, then let the last error propagate. `on_retry(attempt,
    exc)` fires before each sleep. Returns (result, attempts_used)."""
    policy = policy or RetryPolicy()
    deadline = clock() + policy.reconnect_window_secs
    attempt = 0
    while True:
        try:
            return fn(), attempt
        except Exception as e:
            if not is_retryable(e):
                raise
            now = clock()
            if now >= deadline:
                logger.error(
                    "%s still failing after %d retries over %.0fs "
                    "reconnect window; giving up",
                    what, attempt, policy.reconnect_window_secs,
                )
                raise
            delay = policy.backoff(attempt)
            # never sleep past the window
            delay = min(delay, max(0.0, deadline - now))
            if on_retry is not None:
                on_retry(attempt, e)
            logger.warning(
                "%s failed (attempt %d, transient): retrying in %.2fs",
                what, attempt + 1, delay,
            )
            sleep(delay)
            attempt += 1
