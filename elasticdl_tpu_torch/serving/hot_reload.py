"""Hot checkpoint reload: the port of elasticdl_tpu/serving/
hot_reload.py's CheckpointWatcher and ReloadError.

The watcher follows a training run's checkpoint directory (the JAX
package's format, `version-<V>/variables-*-of-M.ckpt`, valid iff the
shard set is complete; written by either package's saver) and loads a
NEWER valid version than the one serving. The swap itself is the
engine's `set_params` between two decode steps, on the scheduler
thread: in-flight requests keep their caches and positions, and their
remaining tokens come from the new weights.

Failure isolation: a checkpoint that fails integrity (torn shard set,
digest mismatch), load or its fit to the serving model (a parameter of
another shape) leaves the old weights serving, since nothing is copied
until the whole checkpoint has passed. Each load retries with backoff up
to `retries` times; exhaustion latches `reload_failed` and `last_error`
until a load succeeds, and the poll path remembers the failed version
so it does not re-read the same bytes every tick (only a newer version
clears that). `load_version` is the explicit handshake: any target,
an older one included (a rollback), ReloadError on exhaustion.
`poll_secs` <= 0 leaves explicit reloads only.
"""

import logging
import time

from elasticdl_tpu_torch.checkpoint.saver import (
    check_params_flat,
    get_latest_checkpoint_version,
    load_checkpoint,
    verify_checkpoint,
)
from elasticdl_tpu_torch.model_zoo.transformer_lm import flax_param_path

logger = logging.getLogger(__name__)


class ReloadError(Exception):
    """Every load attempt of an explicitly requested checkpoint version
    failed; the old weights are still serving."""


class CheckpointWatcher(object):
    """Poll `checkpoint_dir` for new valid versions.

    template: the serving model; a loaded checkpoint's `.params` leaves
    must fit its parameters (strict=False: a leaf the checkpoint lacks
    keeps its value). A load returns (flat, version), flat being
    `load_checkpoint`'s {leaf name: array}.

    retries/backoff_secs: the ladder of one reload (attempt, sleep b,
    attempt, sleep 2b, ...). injector: a FaultInjector whose
    `checkpoint_read` hook fires before every load attempt."""

    def __init__(self, checkpoint_dir, template, poll_secs=2.0,
                 start_version=-1, clock=time.monotonic, retries=3,
                 backoff_secs=0.2, sleep=time.sleep, injector=None):
        self.checkpoint_dir = checkpoint_dir
        self.template = template
        self.poll_secs = float(poll_secs)
        self.version = int(start_version)
        self._clock = clock
        self._sleep = sleep
        self._next_poll = 0.0
        self._failed_version = None
        self.retries = max(1, int(retries))
        self.backoff_secs = float(backoff_secs)
        self.injector = injector
        self.reload_failed = False
        self.last_error = ""

    def _try_load(self, version):
        """One integrity-checked load attempt; raises on any failure."""
        if self.injector is not None:
            self.injector.intercept("checkpoint_read")
        verify_checkpoint(self.checkpoint_dir, version)
        flat, got = load_checkpoint(self.checkpoint_dir, version=version)
        check_params_flat(self.template, flax_param_path, flat)
        return flat, got

    def _load_with_retries(self, version):
        """The retry ladder around _try_load: (flat, version), or the
        last error after `retries` attempts, self.version untouched."""
        last = None
        for attempt in range(self.retries):
            try:
                out = self._try_load(version)
                self.reload_failed = False
                self.last_error = ""
                return out
            except Exception as e:  # noqa: BLE001 - keep serving
                last = e
                logger.error(
                    "checkpoint version-%d load attempt %d/%d failed "
                    "(still serving version-%d): %s",
                    version, attempt + 1, self.retries, self.version, e)
                if attempt + 1 < self.retries:
                    self._sleep(self.backoff_secs * (2 ** attempt))
        self.reload_failed = True
        self.last_error = "%s: %s" % (type(last).__name__, last)
        raise last

    def poll(self, force=False):
        """(flat, version) when a newer valid checkpoint loaded, else
        None. Rate-limited to poll_secs; `force` bypasses the limiter,
        not poll_secs <= 0 (explicit reloads only)."""
        if not self.checkpoint_dir:
            return None
        if self.poll_secs <= 0 and not force:
            return None
        now = self._clock()
        if not force and now < self._next_poll:
            return None
        self._next_poll = now + self.poll_secs
        latest = get_latest_checkpoint_version(self.checkpoint_dir)
        if latest <= self.version or latest == self._failed_version:
            return None
        try:
            flat, version = self._load_with_retries(latest)
        except Exception:  # noqa: BLE001 - keep serving on failure
            self._failed_version = latest
            return None
        self.version = version
        self._failed_version = None
        logger.info("hot reload: serving checkpoint version-%d", version)
        return flat, version

    def load_version(self, version):
        """Load `version`, newer or older. (flat, version) on success,
        None when it is already serving; ReloadError after the retry
        ladder, the old weights untouched and reload_failed latched."""
        version = int(version)
        if not self.checkpoint_dir:
            raise ReloadError("no checkpoint_dir configured")
        if version == self.version:
            return None
        try:
            flat, got = self._load_with_retries(version)
        except Exception as e:  # noqa: BLE001 - structured failure
            raise ReloadError(
                "reload to version-%d failed after %d attempts: %s"
                % (version, self.retries, e))
        self.version = got
        self._failed_version = None
        logger.info("explicit reload: serving checkpoint version-%d", got)
        return flat, got
