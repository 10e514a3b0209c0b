"""The master's TensorBoard service: the port's copy of
elasticdl_tpu/master/tensorboard_service.py.

Evaluation metrics become scalar summaries at their model version, and
the servicer's per-worker `tier/` and `fault/` gauges and the master's
recovery gauges ride the same writer (common/tb_events.py), opened at
the first write. `start()` launches a `tensorboard` process over the
directory only when that binary is on the PATH; otherwise it warns and
the files are still written. Writes after `stop()` are dropped (a
worker's report can race the shutdown), so a late metric never reopens
the writer.
"""

import logging
import shutil
import subprocess

from elasticdl_tpu_torch.common.tb_events import EventFileWriter

logger = logging.getLogger(__name__)


class TensorboardService(object):
    def __init__(self, tensorboard_log_dir, master_ip="", port=6006):
        self._log_dir = tensorboard_log_dir
        self._master_ip = master_ip
        self._port = port
        self._writer = None
        self._tb_process = None
        self._closed = False

    def _ensure_writer(self):
        if self._closed:
            return None
        if self._writer is None:
            self._writer = EventFileWriter(self._log_dir)
        return self._writer

    def write_dict_to_summary(self, dictionary, version):
        """One scalar per entry at step `version`; a value that is not a
        scalar is skipped with a warning."""
        writer = self._ensure_writer()
        if writer is None:
            logger.debug("Dropping metrics after stop(): %s", dictionary)
            return
        for key, value in dictionary.items():
            try:
                writer.add_scalar(key, float(value), version)
            except (TypeError, ValueError):
                logger.warning("Skipping non-scalar metric %s=%r", key,
                               value)

    def start(self):
        """Launch `tensorboard` over the log dir if it is installed;
        returns whether it was."""
        if shutil.which("tensorboard") is None:
            logger.warning(
                "tensorboard binary not found; summaries are still "
                "written to %s", self._log_dir)
            return False
        self._tb_process = subprocess.Popen(
            ["tensorboard", "--logdir", self._log_dir,
             "--port", str(self._port), "--bind_all"],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        logger.info("TensorBoard serving %s on :%d", self._log_dir,
                    self._port)
        return True

    def is_active(self):
        return (self._tb_process is not None
                and self._tb_process.poll() is None)

    def stop(self):
        self._closed = True
        if self._writer:
            self._writer.close()
            self._writer = None
        if self.is_active():
            self._tb_process.terminate()
            self._tb_process = None
