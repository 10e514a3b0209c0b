"""Job status as a file: the port's copy of
elasticdl_tpu/common/job_status.py. The local master writes its phase
(Pending / Running / Succeeded / Failed, as pod phases) to
--job_status_file; a client or a script polls it."""

import json
import logging
import os
import tempfile
import time

logger = logging.getLogger(__name__)

PENDING = "Pending"
RUNNING = "Running"
SUCCEEDED = "Succeeded"
FAILED = "Failed"

PHASES = (PENDING, RUNNING, SUCCEEDED, FAILED)


def write_job_status(path, status, **extra):
    """Atomically write {"status": ..., "time": ..., **extra}. IO errors
    are logged and swallowed (returns False): status reporting must not
    mask the job's own outcome. Unknown phases raise."""
    if not path:
        return False
    if status not in PHASES:
        raise ValueError("unknown job status %r (valid: %s)"
                         % (status, PHASES))
    payload = dict(extra, status=status, time=time.time())
    tmp = None
    try:
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=directory, prefix=".job_status.")
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        tmp = None
        return True
    except OSError:
        logger.warning("failed to write job status %r to %s", status, path,
                       exc_info=True)
        return False
    finally:
        if tmp is not None and os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


def read_job_status(path):
    """The parsed status dict, or None when absent / partially written."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None
