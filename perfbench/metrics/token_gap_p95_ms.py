"""token_gap_p95_ms: the 95th percentile of the wall gaps between one
request's successive tokens, both inside the window, in ms."""

from perfbench.harness.record import percentile


def read(rec):
    return percentile(rec.token_gaps_ms, 95)
