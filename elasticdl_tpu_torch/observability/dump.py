"""Merge per-process span exports into one Chrome-trace JSON.

The port of elasticdl_tpu/observability/dump.py.

Every traced process (router, replicas) writes its recorder to
``$EDL_TRACE_DIR/spans-<service>-<pid>.json`` on a clean stop
(tracing.SpanRecorder.flush). This tool stitches those files into one
timeline; spans keep their trace, span and parent ids, so a request the
router dispatched is ONE tree, the router's dispatch spans parenting each
replica's serve span.

    python -m elasticdl_tpu_torch.observability.dump \\
        --dir /tmp/edl-traces --out trace.json

Open ``trace.json`` at ui.perfetto.dev or chrome://tracing. It imports
no torch.
"""

import argparse
import glob
import json
import os
import sys

from elasticdl_tpu_torch.observability.tracing import (
    TRACE_DIR_ENV,
    chrome_trace,
    group_by_trace,
)


def merge_dir(trace_dir):
    """(span dicts, per-process meta) from every spans-*.json export
    under `trace_dir`. Unreadable files are reported in meta, not
    fatal: a SIGKILLed process's missing/partial export must never
    block merging the survivors."""
    spans, meta = [], []
    for path in sorted(glob.glob(
            os.path.join(trace_dir, "spans-*.json"))):
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            meta.append({"path": path, "error": str(e)})
            continue
        meta.append({
            "path": path,
            "service": doc.get("service", "?"),
            "pid": doc.get("pid", 0),
            "spans": len(doc.get("spans", ())),
            "dropped": doc.get("dropped", 0),
            # the two-tier recorder's other loss accounting: retained-
            # tier evictions and healthy roots sampled out (tail-based
            # retention, tracing.py) — zero on pre-tier exports
            "retained": doc.get("retained", 0),
            "retained_dropped": doc.get("retained_dropped", 0),
            "sampled_out": doc.get("sampled_out", 0),
        })
        spans.extend(doc.get("spans", ()))
    return spans, meta


def drops_by_service(meta):
    """{service: spans irrecoverably dropped} across the merged
    exports (ring drop-oldest + retained-tier evictions; sampled-out
    healthy roots are NOT drops — they were declined, not lost). A
    forensics verdict over a service with nonzero drops is evidence-
    incomplete and must say so rather than pose as the whole story."""
    out = {}
    for m in meta:
        if "error" in m:
            continue
        d = int(m.get("dropped", 0)) + int(m.get("retained_dropped", 0))
        if d:
            out[m["service"]] = out.get(m["service"], 0) + d
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--dir", default=os.environ.get(TRACE_DIR_ENV, ""),
        help="directory of spans-*.json exports (default: "
             "$EDL_TRACE_DIR)",
    )
    parser.add_argument("--out", default="trace.json",
                        help="merged Chrome-trace JSON output path")
    args = parser.parse_args(argv)
    if not args.dir:
        print("dump: no --dir and no $%s set" % TRACE_DIR_ENV,
              file=sys.stderr)
        return 2
    spans, meta = merge_dir(args.dir)
    drops = drops_by_service(meta)
    doc = chrome_trace(spans)
    # Chrome-trace "otherData" rides unknown keys through Perfetto
    # untouched: the merged evidence accounting lives IN the artifact,
    # so a trace file can say its own evidence is incomplete
    doc["otherData"] = {
        "exports": meta,
        "drops_by_service": drops,
        "evidence_complete": not drops
        and not any("error" in m for m in meta),
    }
    with open(args.out, "w") as f:
        json.dump(doc, f)
    errors = [m for m in meta if "error" in m]
    print(
        "dump: merged %d spans across %d traces from %d exports -> %s"
        " (%d unreadable exports)"
        % (len(spans), len(group_by_trace(spans)),
           len(meta) - len(errors), args.out, len(errors))
    )
    if drops:
        print(
            "dump: EVIDENCE INCOMPLETE — spans dropped before export: "
            + ", ".join("%s=%d" % (svc, n)
                        for svc, n in sorted(drops.items()))
        )
    else:
        print("dump: evidence complete (zero recorder drops)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
