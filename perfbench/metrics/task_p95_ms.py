"""task_p95_ms: the 95th percentile, over every task retired inside the
window, of the wall time from its stage-1 batch (``on_batch``) to its
retirement (``on_exit``)."""

from perfbench.harness.record import percentile


def read(rec):
    return percentile(rec.task_ms, 95)
