"""Per-phase wall-clock accumulation: the port's copy of
elasticdl_tpu/common/timing_utils.py.

`Timing(sync_device=...)` synchronizes that CUDA device before each
stamp, so a phase's time includes the kernels it queued (the JAX
package fetches a scalar, `fetch_sync`, for the same reason); on the
CPU, or without a device, it reads the clock alone.
"""

import time
from contextlib import contextmanager


def cuda_sync(device):
    """Wait for the work queued on `device` when it is a CUDA device."""
    if device is not None and getattr(device, "type", device) == "cuda":
        import torch

        torch.cuda.synchronize(device)


class Timing(object):
    def __init__(self, enabled=True, logger=None, sync_device=None):
        self._enabled = enabled
        self._logger = logger
        self._sync_device = sync_device
        self.reset()

    def reset(self):
        self._start = {}
        self.totals = {}
        self.counts = {}

    def _now(self):
        cuda_sync(self._sync_device)
        return time.time()

    def start_record_time(self, phase):
        if self._enabled:
            self._start[phase] = self._now()

    def end_record_time(self, phase):
        if self._enabled and phase in self._start:
            dt = self._now() - self._start.pop(phase)
            self.totals[phase] = self.totals.get(phase, 0.0) + dt
            self.counts[phase] = self.counts.get(phase, 0) + 1

    @contextmanager
    def record(self, phase):
        self.start_record_time(phase)
        try:
            yield
        finally:
            self.end_record_time(phase)

    def report_timing(self, reset=False):
        if self._enabled and self._logger:
            for phase, total in sorted(self.totals.items()):
                self._logger.debug(
                    "Timing %s: total=%.3fs count=%d avg=%.1fms",
                    phase,
                    total,
                    self.counts[phase],
                    1000.0 * total / max(1, self.counts[phase]),
                )
        if reset:
            self.reset()
