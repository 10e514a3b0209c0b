"""Write-ahead journal + compacted snapshot for the dispatcher's state:
the port's copy of elasticdl_tpu/master/state_store.py, in the same file
layout, so either package restores a job the other journaled.

* every task-lifecycle transition (tasks created, dispatched, done,
  failed, epoch rollover, model version) is appended to
  ``journal.jsonl`` in the job state dir BEFORE the in-memory change is
  observable (write-ahead);
* a compacted ``snapshot.json`` is written atomically (tmp + rename)
  every ``snapshot_every`` appends, and the journal truncated;
* a ``JOB_COMPLETE`` marker records that the job finished;
* a ``restarts`` file counts the times a dispatcher came up over
  existing state.

Crash model: SIGKILL of the process. Appends are flushed to the OS on
every write, which survives process death; fsync=True also survives
host power loss. A torn final journal line (the one write a SIGKILL can
interrupt) is trimmed and skipped; corruption earlier raises.

The journal line format is the TaskDispatcher's (snapshot()/restore());
this module handles durability, atomicity and replay tolerance.
`JobStateReader` reads a job state dir and writes nothing: under a mesh
world rank 0 alone journals, and every other rank restores its own
dispatcher from the state rank 0 restores from.
"""

import json
import logging
import os
import tempfile

logger = logging.getLogger(__name__)

JOURNAL_FILE = "journal.jsonl"
SNAPSHOT_FILE = "snapshot.json"
COMPLETE_MARKER = "JOB_COMPLETE"
RESTARTS_FILE = "restarts"


class JobStateStore(object):
    def __init__(self, job_state_dir, snapshot_every=200, fsync=False):
        self._dir = job_state_dir
        self.snapshot_every = max(1, int(
            os.environ.get("EDL_STATE_SNAPSHOT_EVERY", snapshot_every)
        ))
        self._fsync = fsync
        os.makedirs(job_state_dir, exist_ok=True)
        self._journal_path = os.path.join(job_state_dir, JOURNAL_FILE)
        self._snapshot_path = os.path.join(job_state_dir, SNAPSHOT_FILE)
        self._had_state = (
            os.path.exists(self._journal_path)
            or os.path.exists(self._snapshot_path)
        )
        self._journal = None
        self._appends_since_snapshot = 0
        self.journal_appends = 0
        self.compactions = 0
        self.torn_lines = 0
        if self._had_state:
            self._bump_restarts()

    # ------------------------------------------------------------ loading

    def has_state(self):
        return self._had_state

    def load(self):
        """(snapshot dict or None, [journal events]). Tolerates a torn
        final journal line — the one write a SIGKILL can interrupt —
        whether it is a JSON prefix, non-UTF-8 block garbage, or
        missing its newline entirely; every dropped tail bumps the
        ``torn_lines`` counter. Corruption anywhere EARLIER in the
        journal still raises: that is data loss, not a crash artifact."""
        snapshot = None
        if os.path.exists(self._snapshot_path):
            with open(self._snapshot_path) as f:
                snapshot = json.load(f)
        events = []
        if os.path.exists(self._journal_path):
            lines = self._journal_lines()
            for i, raw in enumerate(lines):
                raw = raw.strip()
                if not raw:
                    continue
                try:
                    events.append(json.loads(raw.decode("utf-8")))
                except ValueError:  # includes UnicodeDecodeError
                    if i == len(lines) - 1:
                        self.torn_lines += 1
                        logger.warning(
                            "Dropping torn final journal line (%d bytes)",
                            len(raw),
                        )
                    else:
                        raise
        return snapshot, events

    def _journal_lines(self):
        """The journal's lines after the torn tail's trim."""
        self._trim_torn_tail()
        # binary read: a torn tail of raw block garbage must not blow up
        # the WHOLE read with UnicodeDecodeError before per-line
        # tolerance gets a chance
        with open(self._journal_path, "rb") as f:
            return f.readlines()

    # ------------------------------------------------------------ writing

    def _trim_torn_tail(self):
        """Physically drop a newline-less journal tail. Without the
        trim, the next append would concatenate onto the torn line,
        promoting recoverable TAIL garbage into a corrupt mid-file
        line that load() rightly refuses to skip."""
        try:
            size = os.path.getsize(self._journal_path)
        except OSError:
            return
        if size == 0:
            return
        with open(self._journal_path, "rb+") as f:
            f.seek(-1, os.SEEK_END)
            if f.read(1) == b"\n":
                return
            f.seek(0)
            keep = f.read().rfind(b"\n") + 1  # 0: no newline at all
            f.truncate(keep)
        self.torn_lines += 1
        logger.warning(
            "Trimmed torn journal tail (%d bytes) before append",
            size - keep,
        )

    def _open_journal(self):
        if self._journal is None:
            self._trim_torn_tail()
            self._journal = open(self._journal_path, "a")
        return self._journal

    def append(self, event):
        """Write-ahead one lifecycle event. Returns True when the caller
        should compact (hand back a snapshot via write_snapshot)."""
        f = self._open_journal()
        f.write(json.dumps(event, separators=(",", ":")) + "\n")
        f.flush()
        if self._fsync:
            os.fsync(f.fileno())
        self.journal_appends += 1
        self._appends_since_snapshot += 1
        return self._appends_since_snapshot >= self.snapshot_every

    def write_snapshot(self, state):
        """Atomically persist the full state and truncate the journal —
        snapshot first, truncate after, so a crash between the two
        replays the journal against the NEW snapshot (events are
        idempotent under replay: dispatch of an absent task and done of
        an unknown id are no-ops)."""
        fd, tmp = tempfile.mkstemp(
            dir=self._dir, prefix=".snapshot."
        )
        with os.fdopen(fd, "w") as f:
            json.dump(state, f)
            f.flush()
            if self._fsync:
                os.fsync(f.fileno())
        os.replace(tmp, self._snapshot_path)
        if self._journal is not None:
            self._journal.close()
            self._journal = None
        open(self._journal_path, "w").close()
        self._appends_since_snapshot = 0
        self.compactions += 1

    def close(self):
        if self._journal is not None:
            self._journal.close()
            self._journal = None

    # ------------------------------------------------- completion marker

    def mark_job_complete(self):
        path = os.path.join(self._dir, COMPLETE_MARKER)
        with open(path, "w") as f:
            f.write("complete\n")

    def is_job_complete(self):
        return os.path.exists(os.path.join(self._dir, COMPLETE_MARKER))

    # ------------------------------------------------- restart counting

    def _bump_restarts(self):
        path = os.path.join(self._dir, RESTARTS_FILE)
        try:
            with open(path) as f:
                n = int(f.read().strip() or 0)
        except (OSError, ValueError):
            n = 0
        with open(path, "w") as f:
            f.write("%d\n" % (n + 1))

    @property
    def restart_count(self):
        """How many times a master has come up over existing state."""
        path = os.path.join(self._dir, RESTARTS_FILE)
        try:
            with open(path) as f:
                return int(f.read().strip() or 0)
        except (OSError, ValueError):
            return 0


class JobStateReader(JobStateStore):
    """A job state dir read as JobStateStore reads it, and never written:
    no restart is counted, nothing is trimmed, journaled or compacted.
    A newline-less journal tail is left out, as the writer's trim drops
    it, so a reader restores the state a JobStateStore over the same
    files restores."""

    def __init__(self, job_state_dir):
        self._dir = job_state_dir
        self._journal_path = os.path.join(job_state_dir, JOURNAL_FILE)
        self._snapshot_path = os.path.join(job_state_dir, SNAPSHOT_FILE)
        self._had_state = (os.path.exists(self._journal_path)
                           or os.path.exists(self._snapshot_path))
        self._journal = None
        self.journal_appends = self.compactions = self.torn_lines = 0

    def _journal_lines(self):
        with open(self._journal_path, "rb") as f:
            lines = f.readlines()
        if lines and not lines[-1].endswith(b"\n"):
            lines.pop()
        return lines

    def append(self, event):
        return False

    def write_snapshot(self, state):
        pass

    def mark_job_complete(self):
        pass
