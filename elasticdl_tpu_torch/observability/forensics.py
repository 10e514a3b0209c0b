"""Per-request cause attribution, the port of
elasticdl_tpu/observability/forensics.py: why was this request slow?

`attribute(spans)` folds one request's span tree (the span dicts of
`Span.to_dict()` or a merged export) into an ordered latency breakdown
and one dominant cause from the closed taxonomy:

    queue_wait              admitted, not seated, net of the time another
                            request's prefill held the scheduler
    dispatch_retries        router time before the winning dispatch leg
                            (failed legs, breaker cool-downs, backoff)
    prefill_own             this request's prefill or suffix tile (seated
                            -> first token), less any revival upload
    prefill_blocked_by_other  the wait spent while another slot's prefill
                            ran (`prefill_blocked_ms` on the `seated` /
                            `expired` events, from the scheduler's
                            cumulative prefill-busy clock)
    revive_upload           the upload of a spilled prefix chain at seat
    decode                  first token -> terminal on the replica
    stream_stall            the winning dispatch leg beyond the replica's
                            serve span

It reads no live state, so it runs alike in a replica (over the
request's own serve span) and in the fleet collector (over
$EDL_TRACE_DIR exports). Missing evidence degrades, never raises:
components without events are 0.0 ms and `evidence_complete` is False.
`is_terminally_slow` is the replica's classifier, `cause_histogram`
the distribution of why over many verdicts.
"""

#: the closed cause set, in causal order (admission -> stream). The
#: replica's slow_cause counter family, EDL401's declared union, the
#: collector's cause histogram and the bench tail_report all key on
#: EXACTLY these names.
CAUSES = ("queue_wait", "dispatch_retries", "prefill_own",
          "prefill_blocked_by_other", "revive_upload", "decode",
          "stream_stall")

#: a completed request is "terminally slow" when it consumed at least
#: this fraction of its own deadline budget (the replica's deadline is
#: the classifier — no new config surface); breaches/errors always are
SLOW_DEADLINE_FRACTION = 0.8

#: root-span statuses that are slow/failed by definition
_BAD_STATUSES = ("DEADLINE_EXCEEDED",)


def is_terminally_slow(status, e2e_ms, deadline_ms):
    """The replica-side slow classifier: a deadline breach is slow, an
    error is not (it is FAST and wrong — a different counter), and a
    completed request is slow when it burned >= SLOW_DEADLINE_FRACTION
    of its own deadline budget. No deadline => never classified (the
    fleet-wide SLOs own that story through the collector)."""
    if status in _BAD_STATUSES:
        return True
    if not deadline_ms or deadline_ms <= 0:
        return False
    return (status == "ok"
            and e2e_ms >= SLOW_DEADLINE_FRACTION * deadline_ms)


def _events(span):
    """{name: [(ts, attrs)...]} for one span dict."""
    out = {}
    for ev in span.get("events", ()):
        out.setdefault(ev["name"], []).append(
            (ev["ts"], ev.get("attrs", {}))
        )
    return out


def _span_ms(span):
    end = span.get("end")
    start = span.get("start")
    if end is None or start is None:
        return None
    return max(0.0, (end - start) * 1000.0)


def _pick_root(spans):
    """The request root: a router_generate[_stream] span when the tree
    has one, else the serve span, else the earliest span."""
    ids = {s["span_id"] for s in spans}
    roots = [s for s in spans
             if not s.get("parent_span_id")
             or s["parent_span_id"] not in ids]
    for pool in (roots, spans):
        for name in ("router_generate", "router_generate_stream"):
            named = [s for s in pool if s["name"] == name]
            if named:
                return min(named, key=lambda s: s["start"])
        named = [s for s in pool if s["name"] == "serve"]
        if named:
            return min(named, key=lambda s: s["start"])
    return min(spans, key=lambda s: s["start"])


def _pick_serve(spans):
    """The serve span that carried the answer: prefer status ok, then
    the LATEST by start (a re-dispatched request's earlier serve legs
    failed)."""
    serves = [s for s in spans if s["name"] == "serve"]
    if not serves:
        return None
    ok = [s for s in serves if s.get("status") == "ok"]
    pool = ok or serves
    return max(pool, key=lambda s: s["start"])


def _winning_dispatch(spans, serve):
    """The dispatch leg the answering serve span rode under (matched
    by parent id), else the last ok dispatch, else None."""
    dispatches = [s for s in spans if s["name"] == "dispatch"]
    if not dispatches:
        return None
    if serve is not None:
        for d in dispatches:
            if serve.get("parent_span_id") == d["span_id"]:
                return d
    ok = [d for d in dispatches if d.get("status") == "ok"]
    pool = ok or dispatches
    return max(pool, key=lambda s: s["start"])


def attribute(spans):
    """Fold ONE request's span dicts into the ordered cause breakdown.

    Returns::

        {"trace_id": ..., "status": <root status>,
         "total_ms": <root duration>,
         "breakdown": [{"cause": c, "ms": x} for c in CAUSES],
         "dominant_cause": <argmax cause>, "dominant_ms": x,
         "evidence_complete": bool}

    Pure and total: any span subset yields a verdict; thin evidence
    zeroes components and clears `evidence_complete`.
    """
    if not spans:
        return {
            "trace_id": None, "status": None, "total_ms": 0.0,
            "breakdown": [{"cause": c, "ms": 0.0} for c in CAUSES],
            "dominant_cause": None, "dominant_ms": 0.0,
            "evidence_complete": False,
        }
    root = _pick_root(spans)
    serve = _pick_serve(spans)
    win = _winning_dispatch(spans, serve)
    ms = {c: 0.0 for c in CAUSES}
    complete = True

    total_ms = _span_ms(root)
    if total_ms is None:
        total_ms = 0.0
        complete = False

    if win is not None:
        # time the router burned before the winning leg started:
        # failed legs, breaker cooldowns, full-jitter backoff
        ms["dispatch_retries"] = max(
            0.0, (win["start"] - root["start"]) * 1000.0
        )

    if serve is None:
        complete = False
    else:
        ev = _events(serve)
        serve_ms = _span_ms(serve) or 0.0
        queued = ev.get("queued")
        seated = ev.get("seated")
        expired = ev.get("expired")
        first = ev.get("first_token")
        # queue wait: queued -> seated (or -> span end for a request
        # that expired in the queue), split into pure backlog vs time
        # another slot's prefill held the single-threaded scheduler
        if queued:
            q_ts = queued[0][0]
            if seated:
                s_ts, s_attrs = seated[0]
                wait_ms = max(0.0, (s_ts - q_ts) * 1000.0)
                blocked = float(s_attrs.get("prefill_blocked_ms", 0.0))
            elif expired or serve.get("end") is not None:
                end_ts = (expired[0][0] if expired
                          else serve["end"])
                wait_ms = max(0.0, (end_ts - q_ts) * 1000.0)
                blocked = float(
                    (expired[0][1] if expired else {})
                    .get("prefill_blocked_ms", 0.0)
                )
            else:
                wait_ms, blocked = 0.0, 0.0
                complete = False
            blocked = min(blocked, wait_ms)
            ms["prefill_blocked_by_other"] = blocked
            ms["queue_wait"] = wait_ms - blocked
        else:
            complete = False
        for _ts, attrs in ev.get("revive_upload", ()):
            ms["revive_upload"] += float(attrs.get("ms", 0.0))
        if seated and first:
            ms["prefill_own"] = max(
                0.0,
                (first[0][0] - seated[0][0]) * 1000.0
                - ms["revive_upload"],
            )
        if first and serve.get("end") is not None:
            ms["decode"] = max(
                0.0, (serve["end"] - first[0][0]) * 1000.0
            )
        elif seated and not first:
            complete = False
        if win is not None:
            win_ms = _span_ms(win)
            if win_ms is not None:
                ms["stream_stall"] = max(0.0, win_ms - serve_ms)

    dominant = max(CAUSES, key=lambda c: ms[c])
    return {
        "trace_id": root.get("trace_id"),
        "status": root.get("status"),
        "total_ms": round(total_ms, 3),
        "breakdown": [
            {"cause": c, "ms": round(ms[c], 3)} for c in CAUSES
        ],
        "dominant_cause": dominant if ms[dominant] > 0.0 else None,
        "dominant_ms": round(ms[dominant], 3),
        "evidence_complete": complete,
    }


def cause_histogram(verdicts):
    """{cause: count} over a batch of attribute() verdicts (None
    dominants — no measurable component — are skipped): the
    "distribution of why" the bench tail_report and the collector
    report record."""
    out = {}
    for v in verdicts:
        cause = v.get("dominant_cause")
        if cause:
            out[cause] = out.get(cause, 0) + 1
    return out
