"""The fleet collector: scrape /metrics, re-evaluate SLOs, join traces.

The port of elasticdl_tpu/observability/collector.py: it scrapes
/metrics fleet-wide, re-evaluates the SLOs, and joins burning windows to
the traces that explain them.

    python -m elasticdl_tpu_torch.observability.collector \\
        --endpoints 127.0.0.1:9100,127.0.0.1:9101 \\
        --scrapes 3 --interval 2 \\
        --trace_dir /tmp/edl-traces --out INCIDENT_REPORT.json

A standalone process with no privileged access: all it knows comes from
the `/metrics` pages any Prometheus scraper reads (each validated by the
independent parser, observability/promparse.py) and the span exports
under ``$EDL_TRACE_DIR``.

1. Scrape each endpoint's ``/metrics`` ``--scrapes`` rounds,
   ``--interval`` seconds apart; every page must parse clean.
2. Merge each round across endpoints: counters add, histogram buckets
   add, exemplars keep the largest sample a bucket.
3. Window: the merged cumulative rounds feed a TimeSeriesRing, rebased
   on the first round, so between-scrape deltas are true windows.
4. Re-evaluate the declared objectives (the --slo_* flags, or with
   ``--router`` the router's own router_status.slo blocks) with the
   BurnRateEngine over those windows.
5. Join each latency objective's buckets to the exemplars scraped off
   them: trace ids with values and timestamps.
6. Attribute the exemplar traces found in ``--trace_dir`` with
   forensics.attribute() and histogram their dominant causes.
7. Report: one JSON document (and a text summary); `validate_report` is
   its schema gate. It carries the recorders' drops per service, so a
   verdict over incomplete evidence says so.

Scrape the router OR the replicas, not both: the router's fleet-merged
histograms already hold its replicas' buckets. SIGUSR2 dumps every
thread's stack (runtime_health.install_sigusr2_dump), as in every
long-running process of the fleet. It imports no torch.
"""

import argparse
import json
import os
import sys
import time
import urllib.request

from elasticdl_tpu_torch.observability import forensics
from elasticdl_tpu_torch.observability.dump import drops_by_service, merge_dir
from elasticdl_tpu_torch.observability.histogram import (
    NUM_BUCKETS,
    LogLinearHistogram,
    bucket_bounds,
    bucket_index,
)
from elasticdl_tpu_torch.observability.metrics import (
    TimeSeriesRing,
    add_counts,
    merge_exemplars,
)
from elasticdl_tpu_torch.observability.promparse import parse_prometheus_text
from elasticdl_tpu_torch.observability.slo import (
    BurnRateEngine,
    SloSpec,
    default_router_slos,
)
from elasticdl_tpu_torch.observability.tracing import (
    TRACE_DIR_ENV,
    group_by_trace,
)

REPORT_SCHEMA = "edl-incident-report/1"

#: upper bucket bound (as the renderer formats it, re-parsed to float)
#: -> bucket index: exact float equality holds because both sides
#: compute the same bound from the same shared scheme
_LE_TO_IDX = {bucket_bounds(i)[1]: i for i in range(NUM_BUCKETS)}

#: scraped family name -> the ring-histogram name the declared SLOs
#: read. Replica TTFT and the router's fleet merge are the SAME series
#: fleet-wide, so both map onto fleet_ttft_ms.
_HIST_ALIASES = {
    "edl_serving_ttft_ms": "fleet_ttft_ms",
    "edl_router_fleet_ttft_ms": "fleet_ttft_ms",
    "edl_serving_queue_wait_ms": "fleet_queue_wait_ms",
    "edl_router_fleet_queue_wait_ms": "fleet_queue_wait_ms",
    "edl_serving_e2e_ms": "e2e_ms",
    "edl_router_e2e_ms": "e2e_ms",
    "edl_serving_step_ms": "step_ms",
}


def default_fetch(endpoint, timeout=10.0):
    """GET an endpoint's /metrics page. `endpoint` is host:port or a
    full URL; returns the exposition text."""
    url = endpoint
    if "://" not in url:
        url = "http://%s" % url
    if not url.rstrip("/").endswith("/metrics"):
        url = url.rstrip("/") + "/metrics"
    return urllib.request.urlopen(url, timeout=timeout).read().decode(
        "utf-8"
    )


def _counts_from_hist_family(info):
    """Trimmed shared-scheme bucket counts from one parsed histogram
    family (all series of the family summed — labels like `phase`
    collapse into the fleet view), plus the family's exemplars mapped
    to bucket indices."""
    counts = []
    series = {}
    for name, labels, value in info["samples"]:
        if not name.endswith("_bucket") or "le" not in labels:
            continue
        key = tuple(sorted(
            (k, v) for k, v in labels.items() if k != "le"
        ))
        series.setdefault(key, []).append(
            (float("inf") if labels["le"] == "+Inf"
             else float(labels["le"]), value)
        )
    for buckets in series.values():
        buckets.sort(key=lambda p: p[0])
        dense = [0] * NUM_BUCKETS
        prev = 0.0
        for le, cum in buckets:
            delta = cum - prev
            prev = cum
            if delta <= 0:
                continue
            idx = _LE_TO_IDX.get(le)
            if idx is None:
                # not a shared-scheme bound (+Inf tail or a foreign
                # exposition): clamp into the top bucket
                idx = NUM_BUCKETS - 1
            dense[idx] += int(delta)
        counts = add_counts(counts, _trim(dense))
    exemplars = {}
    for _name, labels, ex_labels, value, ts in info.get(
            "exemplars", ()):
        tid = ex_labels.get("trace_id")
        if not tid:
            continue
        idx = _LE_TO_IDX.get(
            float("inf") if labels.get("le") == "+Inf"
            else float(labels.get("le", "inf")),
            NUM_BUCKETS - 1,
        )
        exemplars = merge_exemplars(
            exemplars,
            {idx: (tid, float(value),
                   float(ts) if ts is not None else 0.0)},
        )
    return counts, exemplars


def _trim(dense):
    last = 0
    for i, c in enumerate(dense):
        if c:
            last = i + 1
    return dense[:last]


def _observation_from_page(families):
    """(counters, hists, exemplars) in ring shape from one parsed
    exposition: counter families lose their `edl_<svc>_`/`_total`
    affixes (labeled counters key as name.label_value), histogram
    families map through _HIST_ALIASES."""
    counters, hists, exemplars = {}, {}, {}
    for fam, info in families.items():
        if info["type"] == "counter":
            base = fam
            if base.endswith("_total"):
                base = base[:-len("_total")]
            for prefix in ("edl_serving_", "edl_router_",
                           "edl_autoscaler_", "edl_master_"):
                if base.startswith(prefix):
                    base = base[len(prefix):]
                    break
            for _name, labels, value in info["samples"]:
                key = base
                if labels:
                    key = "%s.%s" % (base, ".".join(
                        str(labels[k]) for k in sorted(labels)
                    ))
                counters[key] = counters.get(key, 0) + value
        elif info["type"] == "histogram":
            name = _HIST_ALIASES.get(fam)
            if name is None:
                continue
            counts, exes = _counts_from_hist_family(info)
            hists[name] = add_counts(hists.get(name, []), counts)
            if exes:
                exemplars[name] = merge_exemplars(
                    exemplars.get(name, {}), exes
                )
    return counters, hists, exemplars


def _merge_observations(obs):
    """Fleet merge of per-endpoint observations for one round:
    counters add, buckets add, exemplars keep max-value-per-bucket."""
    counters, hists, exemplars = {}, {}, {}
    for c, h, e in obs:
        for k, v in c.items():
            counters[k] = counters.get(k, 0) + v
        for k, v in h.items():
            hists[k] = add_counts(hists.get(k, []), v)
        for k, v in e.items():
            exemplars[k] = merge_exemplars(exemplars.get(k, {}), v)
    return counters, hists, exemplars


def scrape_fleet(endpoints, scrapes=2, interval_secs=2.0,
                 fetch=default_fetch, sleep=time.sleep,
                 clock=time.monotonic):
    """Scrape every endpoint `scrapes` times, `interval_secs` apart.
    Every page must parse through the independent parser (a violation
    raises — a scrape is a pass/fail check). Returns the serializable
    scrape BUNDLE that build_report later turns into the incident
    report, so scraping (mid-incident) and trace joining (after spans
    export) can happen at different times."""
    if scrapes < 2:
        raise ValueError(
            "scrapes must be >= 2 — burn rates need at least one "
            "between-scrape window, got %d" % scrapes
        )
    rounds = []
    for n in range(int(scrapes)):
        if n:
            sleep(interval_secs)
        at = clock()
        per_endpoint = []
        for ep in endpoints:
            families = parse_prometheus_text(fetch(ep))
            per_endpoint.append(
                (ep, _observation_from_page(families),
                 len(families))
            )
        counters, hists, exemplars = _merge_observations(
            [o for _ep, o, _n in per_endpoint]
        )
        rounds.append({
            "at": at,
            "unix": time.time(),
            "families": {ep: n for ep, _o, n in per_endpoint},
            "counters": counters,
            "hists": hists,
            "exemplars": {
                name: {str(k): list(v) for k, v in exes.items()}
                for name, exes in exemplars.items()
            },
        })
    return {
        "endpoints": list(endpoints),
        "interval_secs": float(interval_secs),
        "rounds": rounds,
    }


def specs_from_flags(args):
    """The declared objectives, from CLI flags mirroring
    RouterConfig.slo_* defaults."""
    return default_router_slos(
        args.slo_ttft_p99_ms, args.slo_e2e_p99_ms,
        args.slo_goodput_goal, latency_goal=args.slo_latency_goal,
    )


def specs_from_router(address, timeout=10.0):
    """The declared objectives straight from a live port router's
    router_status.slo blocks (over the port's transport), the same
    declarations its own burn engine evaluates. Returns ([SloSpec],
    replica addresses)."""
    from elasticdl_tpu_torch.proto import messages as pb
    from elasticdl_tpu_torch.proto.service import RouterStub, build_channel

    stub = RouterStub(build_channel(address))
    status = stub.router_status(pb.RouterStatusRequest(), timeout=timeout)
    specs = []
    for blk in status.slo:
        if blk.kind == "latency":
            specs.append(SloSpec(
                blk.name, "latency", blk.goal,
                hist=("e2e_ms" if blk.name.startswith("e2e")
                      else "fleet_ttft_ms"),
                threshold_ms=blk.threshold_ms,
            ))
        else:
            specs.append(SloSpec(
                blk.name, "availability", blk.goal,
                bad_counters=("shed", "errors"),
                total_counters=("routed",),
            ))
    return specs, [r.address for r in status.replica]


def _ring_from_bundle(bundle):
    """Replay the bundle's merged rounds into a TimeSeriesRing: the
    first round REBASES (a long-lived process's lifetime totals are
    not a window), every later round closes one true delta window."""
    rounds = bundle["rounds"]
    interval = bundle["interval_secs"]
    ring = TimeSeriesRing(
        interval_secs=max(1e-9, interval * 0.5),
        capacity=max(16, len(rounds) + 1),
        clock=lambda: rounds[0]["at"],
    )
    for n, rnd in enumerate(rounds):
        exemplars = {
            name: {int(k): tuple(v) for k, v in exes.items()}
            for name, exes in rnd.get("exemplars", {}).items()
        }
        ring.observe(counters=rnd["counters"], hists=rnd["hists"],
                     exemplars=exemplars, now=rnd["at"],
                     roll=n > 0)
        if n == 0:
            ring.rebase(now=rnd["at"])
    return ring


def build_report(bundle, specs, trace_dir=None,
                 fast_windows=1, slow_windows=None):
    """The incident report from a scrape bundle: re-run the burn
    engine fleet-wide over the bundle's windows, join latency
    objectives to their scraped exemplars, pull those traces from
    `trace_dir`'s span exports, attribute each, and histogram the
    dominant causes. Pure given the bundle (no network)."""
    rounds = bundle["rounds"]
    interval = bundle["interval_secs"]
    ring = _ring_from_bundle(bundle)
    now = rounds[-1]["at"]
    n_windows = len(rounds) - 1
    if slow_windows is None:
        slow_windows = n_windows
    # horizons in whole scrape intervals: real inter-scrape gaps run a
    # hair OVER the nominal interval (sleep + scrape time), so a
    # horizon of exactly k*interval selects the last k windows
    engine = BurnRateEngine(
        specs,
        fast_window_secs=interval * fast_windows,
        slow_window_secs=interval * slow_windows,
    )
    slo_reports = engine.evaluate(ring, now=now)
    alerting = [r["name"] for r in slo_reports if r["alerting"]]

    # ---- metrics -> traces: exemplars per latency objective
    exemplar_rows = []
    for spec in specs:
        if spec.kind != "latency":
            continue
        exes = ring.merged_exemplars(spec.hist, now=now)
        # the latest cumulative state also carries exemplars the
        # rebase filtered out of windows (recorded before round 0) —
        # they still name real traces, flagged as pre-window
        cumulative = ring.latest()["exemplars"].get(spec.hist, {})
        cut = bucket_index(spec.threshold_ms)
        seen = set()
        for source, exmap in (("window", exes),
                              ("cumulative", cumulative)):
            for idx, (tid, value, ts) in sorted(exmap.items()):
                if (tid, idx) in seen:
                    continue
                seen.add((tid, idx))
                exemplar_rows.append({
                    "slo": spec.name,
                    "hist": spec.hist,
                    "bucket": idx,
                    "bucket_le_ms": bucket_bounds(idx)[1],
                    "trace_id": tid,
                    "value_ms": value,
                    "unix_ts": ts,
                    "source": source,
                    "above_threshold": idx > cut,
                })

    # ---- pull + attribute the exemplar traces
    traces = {}
    cause_counts = {}
    span_evidence = {
        "trace_dir": trace_dir or "",
        "exports": 0,
        "unreadable": 0,
        "drops_by_service": {},
        "complete": True,
    }
    if trace_dir:
        spans, meta = merge_dir(trace_dir)
        by_trace = group_by_trace(spans)
        span_evidence["exports"] = sum(
            1 for m in meta if "error" not in m
        )
        span_evidence["unreadable"] = sum(
            1 for m in meta if "error" in m
        )
        drops = drops_by_service(meta)
        span_evidence["drops_by_service"] = drops
        span_evidence["complete"] = (
            not drops and not span_evidence["unreadable"]
        )
        verdicts = []
        for row in exemplar_rows:
            tid = row["trace_id"]
            if tid in traces or tid not in by_trace:
                continue
            verdict = forensics.attribute(by_trace[tid])
            verdicts.append(verdict)
            traces[tid] = {
                "spans": len(by_trace[tid]),
                "services": sorted(
                    {s["service"] for s in by_trace[tid]}
                ),
                "attribution": verdict,
            }
        cause_counts = forensics.cause_histogram(verdicts)
    for row in exemplar_rows:
        row["resolved"] = row["trace_id"] in traces

    dominant = (max(cause_counts, key=cause_counts.get)
                if cause_counts else None)
    report = {
        "schema": REPORT_SCHEMA,
        "generated_unix": time.time(),
        "endpoints": bundle["endpoints"],
        "scrapes": len(rounds),
        "interval_secs": interval,
        "slo": slo_reports,
        "alerting": alerting,
        "exemplars": exemplar_rows,
        "traces": traces,
        "cause_histogram": cause_counts,
        "dominant_cause": dominant,
        "span_evidence": span_evidence,
    }
    return report


def validate_report(report):
    """Schema gate for the incident report (the drill asserts through
    it): raises ValueError on any violation, returns the report."""
    def need(cond, msg):
        if not cond:
            raise ValueError("incident report: %s" % msg)

    need(isinstance(report, dict), "not a dict")
    need(report.get("schema") == REPORT_SCHEMA,
         "schema is %r, want %r" % (report.get("schema"),
                                    REPORT_SCHEMA))
    for key in ("generated_unix", "endpoints", "scrapes",
                "interval_secs", "slo", "alerting", "exemplars",
                "traces", "cause_histogram", "span_evidence"):
        need(key in report, "missing key %r" % key)
    need(report["scrapes"] >= 2, "fewer than 2 scrapes")
    for r in report["slo"]:
        for k in ("name", "kind", "fast_burn", "slow_burn",
                  "alerting"):
            need(k in r, "slo entry missing %r" % k)
        need(r["fast_burn"] == r["fast_burn"]
             and abs(r["fast_burn"]) != float("inf"),
             "non-finite fast burn on %r" % r["name"])
        need(r["slow_burn"] == r["slow_burn"]
             and abs(r["slow_burn"]) != float("inf"),
             "non-finite slow burn on %r" % r["name"])
    for row in report["exemplars"]:
        for k in ("slo", "hist", "trace_id", "value_ms", "bucket",
                  "resolved"):
            need(k in row, "exemplar row missing %r" % k)
        need(bool(row["trace_id"]), "exemplar without trace_id")
    for tid, entry in report["traces"].items():
        need("attribution" in entry,
             "trace %s has no attribution" % tid)
        verdict = entry["attribution"]
        need(verdict.get("dominant_cause") is None
             or verdict["dominant_cause"] in forensics.CAUSES,
             "trace %s: unknown dominant cause %r"
             % (tid, verdict.get("dominant_cause")))
    for cause in report["cause_histogram"]:
        need(cause in forensics.CAUSES,
             "unknown cause %r in cause_histogram" % cause)
    ev = report["span_evidence"]
    for k in ("exports", "unreadable", "drops_by_service",
              "complete"):
        need(k in ev, "span_evidence missing %r" % k)
    return report


def render_text(report):
    """The human-readable incident summary next to the JSON."""
    lines = []
    lines.append("EDL INCIDENT REPORT (%s)" % report["schema"])
    lines.append("generated: %s" % time.strftime(
        "%Y-%m-%d %H:%M:%S UTC",
        time.gmtime(report["generated_unix"]),
    ))
    lines.append("endpoints: %s  (%d scrapes, %.1fs apart)"
                 % (", ".join(report["endpoints"]),
                    report["scrapes"], report["interval_secs"]))
    lines.append("")
    lines.append("SLO burn (fleet-wide re-evaluation):")
    for r in report["slo"]:
        flag = "  ALERTING" if r["alerting"] else ""
        lines.append(
            "  %-12s %-13s fast=%-8.3f slow=%-8.3f goal=%.3g%s"
            % (r["name"], r["kind"], r["fast_burn"], r["slow_burn"],
               r["goal"], flag)
        )
    lines.append("")
    n_above = sum(1 for e in report["exemplars"]
                  if e["above_threshold"])
    lines.append("exemplars: %d scraped (%d above an SLO threshold, "
                 "%d resolved to traces)"
                 % (len(report["exemplars"]), n_above,
                    sum(1 for e in report["exemplars"]
                        if e["resolved"])))
    for e in report["exemplars"][:10]:
        lines.append(
            "  [%s] %s=%.1f ms trace=%s%s%s"
            % (e["slo"], e["hist"], e["value_ms"], e["trace_id"],
               " >thr" if e["above_threshold"] else "",
               " (resolved)" if e["resolved"] else " (no spans)")
        )
    lines.append("")
    if report["cause_histogram"]:
        total = sum(report["cause_histogram"].values())
        lines.append("cause attribution over %d exemplar traces "
                     "(dominant: %s):"
                     % (total, report["dominant_cause"]))
        for cause in forensics.CAUSES:
            n = report["cause_histogram"].get(cause, 0)
            if n:
                lines.append("  %-26s %3d  (%.0f%%)"
                             % (cause, n, 100.0 * n / total))
    else:
        lines.append("cause attribution: no exemplar trace resolved "
                     "in the span exports")
    ev = report["span_evidence"]
    if ev["complete"]:
        lines.append("evidence: complete (%d exports, zero recorder "
                     "drops)" % ev["exports"])
    else:
        lines.append(
            "evidence: INCOMPLETE — %d unreadable exports, drops: %s"
            % (ev["unreadable"], ev["drops_by_service"] or "{}")
        )
    return "\n".join(lines) + "\n"


def percentile_of_counts(counts, q):
    """Convenience for report consumers: percentile over trimmed
    shared-scheme counts (the one histogram definition)."""
    return LogLinearHistogram.from_counts(counts).percentile(q)


def main(argv=None):
    # a long-running collector can be read without killing it
    from elasticdl_tpu_torch.observability.runtime_health import (
        install_sigusr2_dump,
    )

    install_sigusr2_dump()
    parser = argparse.ArgumentParser(
        description=__doc__.splitlines()[0]
    )
    parser.add_argument(
        "--endpoints", default="",
        help="comma-separated /metrics endpoints (host:port or URL); "
             "scrape the router OR the replicas, not both",
    )
    parser.add_argument(
        "--router", default="",
        help="router gRPC address: pull the DECLARED SLO objectives "
             "from router_status.slo instead of the --slo_* flags",
    )
    parser.add_argument("--scrapes", type=int, default=3)
    parser.add_argument("--interval", type=float, default=2.0)
    parser.add_argument(
        "--trace_dir", default=os.environ.get(TRACE_DIR_ENV, ""),
        help="span-export directory (default: $EDL_TRACE_DIR); empty "
             "= skip the trace join",
    )
    parser.add_argument("--out", default="INCIDENT_REPORT.json")
    parser.add_argument(
        "--text", default="",
        help="also write the rendered text summary here",
    )
    # declared objectives (defaults mirror RouterConfig.slo_*)
    parser.add_argument("--slo_ttft_p99_ms", type=float,
                        default=30000.0)
    parser.add_argument("--slo_e2e_p99_ms", type=float,
                        default=60000.0)
    parser.add_argument("--slo_latency_goal", type=float, default=0.01)
    parser.add_argument("--slo_goodput_goal", type=float, default=0.02)
    args = parser.parse_args(argv)

    endpoints = [e.strip() for e in args.endpoints.split(",")
                 if e.strip()]
    if not endpoints:
        print("collector: no --endpoints given", file=sys.stderr)
        return 2
    if args.router:
        specs, replicas = specs_from_router(args.router)
        print("collector: %d declared objectives from router %s "
              "(%d replicas registered)"
              % (len(specs), args.router, len(replicas)))
    else:
        specs = specs_from_flags(args)
    bundle = scrape_fleet(endpoints, scrapes=args.scrapes,
                          interval_secs=args.interval)
    report = build_report(bundle, specs,
                          trace_dir=args.trace_dir or None)
    validate_report(report)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    text = render_text(report)
    if args.text:
        with open(args.text, "w") as f:
            f.write(text)
    print(text, end="")
    print("collector: report -> %s" % args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
