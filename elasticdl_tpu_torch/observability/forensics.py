"""The slow-request cause taxonomy: the port's copy of `CAUSES` from
elasticdl_tpu/observability/forensics.py, which fixes the order of the
serving status's `slow_cause_counts`.

Not ported: the attribution over spans, retention and the tail
classifier (ROADMAP Queue 1 item 6); the port's replica counts no slow
cause yet, so its `slow_cause_counts` are zeros in this order.
"""

#: the closed cause set, in declared order
CAUSES = ("queue_wait", "dispatch_retries", "prefill_own",
          "prefill_blocked_by_other", "revive_upload", "decode",
          "stream_stall")
