"""Checkpoint integrity without loading a checkpoint: the shard-set and
digest checks of elasticdl_tpu/checkpoint/saver.py's `verify_checkpoint`,
in a module that imports neither torch nor numpy.

The rollout controller (serving/rollout.py) verifies a target version in
the router's process, which loads no torch; checkpoint/saver.py
re-exports these names, so its callers see one `verify_checkpoint` and
one `CheckpointCorruptError`.

    <dir>/version-<V>/variables-<i>-of-<M>.ckpt
    <dir>/version-<V>/meta.json     num_shards, leaf_count, shard_digests
"""

import hashlib
import json
import os
import re

_SHARD_RE = re.compile(r"^variables-(\d+)-of-(\d+)\.ckpt$")


class CheckpointCorruptError(Exception):
    """A checkpoint version failed integrity verification (torn shard
    set, digest mismatch, unreadable meta)."""


def _complete_set_counts(path):
    """Shard counts M for which all M ``variables-*-of-M.ckpt`` exist."""
    if not os.path.isdir(path):
        return []
    counts = {}
    for name in os.listdir(path):
        m = _SHARD_RE.match(name)
        if m:
            counts.setdefault(int(m.group(2)), set()).add(int(m.group(1)))
    return [total for total, seen in counts.items()
            if seen == set(range(total))]


def _read_meta(vdir):
    with open(os.path.join(vdir, "meta.json")) as f:
        return json.load(f)


def verify_checkpoint(checkpoint_dir, version):
    """Integrity-check one version without deserializing it: the shard
    set is complete, meta.json's shard count names a complete set, and
    every shard meta.json lists hashes to its recorded sha256. Returns
    {version, num_shards, leaf_count, bytes, verified_digests}. Raises
    FileNotFoundError when the version dir does not exist,
    CheckpointCorruptError when it is torn or corrupt."""
    vdir = os.path.join(checkpoint_dir, "version-%d" % int(version))
    if not os.path.isdir(vdir):
        raise FileNotFoundError("No checkpoint dir %r" % vdir)
    complete = _complete_set_counts(vdir)
    if not complete:
        raise CheckpointCorruptError(
            "torn checkpoint %r: no complete shard set" % vdir)
    meta = {}
    if os.path.exists(os.path.join(vdir, "meta.json")):
        try:
            meta = _read_meta(vdir)
        except (ValueError, OSError) as e:
            raise CheckpointCorruptError(
                "unreadable meta.json in %r: %s" % (vdir, e))
    want = meta.get("num_shards")
    if want is not None and int(want) not in complete:
        raise CheckpointCorruptError(
            "torn checkpoint %r: meta names %s shards but complete sets "
            "are %s" % (vdir, want, complete))
    if want is None:
        want = max(complete)
    verified = total_bytes = 0
    for name, recorded in sorted((meta.get("shard_digests") or {}).items()):
        path = os.path.join(vdir, name)
        try:
            with open(path, "rb") as f:
                payload = f.read()
        except OSError as e:
            raise CheckpointCorruptError("missing digested shard %r: %s"
                                         % (path, e))
        total_bytes += len(payload)
        if hashlib.sha256(payload).hexdigest() != recorded:
            raise CheckpointCorruptError(
                "digest mismatch for %r: checkpoint bytes do not match the "
                "manifest written at save time" % path)
        verified += 1
    return {"version": int(version), "num_shards": int(want),
            "leaf_count": meta.get("leaf_count"), "bytes": total_bytes,
            "verified_digests": verified}
