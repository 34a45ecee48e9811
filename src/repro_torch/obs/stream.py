"""The instrumentation stream: one set of engine call sites, N consumers.

A copy of ``repro.obs.stream``.  The engine emits each event ONCE to an
:class:`InstrumentationStream`, which fans it out to whatever subscribed —
the control plane's :class:`~repro_torch.control.telemetry.Telemetry`, a
:class:`~repro_torch.obs.trace.SpanTracer`, a
:class:`~repro_torch.obs.metrics.MetricsCollector` — each consuming the
subset of hooks it defines.

Dispatch cost is kept off the hot path:

  * no subscribers  -> the engine holds ``stream = None`` and skips the
    emission entirely (the disabled path is bitwise identical to an
    uninstrumented build);
  * one subscriber defining a hook -> the stream binds that method directly
    (zero fan-out indirection — the common telemetry-only serve pays exactly
    one bound-method call per event, as before the refactor);
  * several -> a tuple loop.

Hook vocabulary (all timestamps are simulated seconds):

  on_submit(t, rid, ed, arrival)      first hop submitted at the source ED
  on_arrival(t, node, rid)            first-hop transfer completed (legacy
                                      arrival-rate estimator semantics)
  on_transfer(t0, t1, wall, src, dst, rid, mb)   residual-stream hop
  on_loopback(t0, t1, src, dst, rid, mb)         stage-H -> stage-1 token hop
  on_enqueue(t, rid, node)            joined a replica's queue
  on_batch(done, node, gflops, wall, queue_depth, **detail)
                                      one stage batch; detail carries stage,
                                      rids, t_dispatch, t_start, n_rows,
                                      n_tokens, is_decode, wall_clock_s
  on_pool(t, node, used_fraction, hit_blocks, total_blocks)  paged pool sample
  on_exit(t, rid, stage, conf)        retirement
  on_resubmit(t, rid)                 fail-stop re-execution restart
  on_failure(t, node)                 replica fail-stop

A subscriber implements any subset; extra positional/keyword detail it does
not care about must be absorbed (``**_``) so the vocabulary can grow without
touching every consumer.
"""
from __future__ import annotations

from typing import Any

__all__ = ["HOOKS", "InstrumentationStream", "build_stream"]

HOOKS = (
    "on_submit",
    "on_arrival",
    "on_transfer",
    "on_loopback",
    "on_enqueue",
    "on_batch",
    "on_pool",
    "on_exit",
    "on_resubmit",
    "on_failure",
)


def _noop(*args: Any, **kwargs: Any) -> None:
    return None


def _fanout(fns: tuple):
    def dispatch(*args: Any, **kwargs: Any) -> None:
        for f in fns:
            f(*args, **kwargs)

    return dispatch


class InstrumentationStream:
    """Fans each hook out to the subscribers that define it."""

    def __init__(self, subscribers):
        self.subscribers = tuple(s for s in subscribers if s is not None)
        #: any subscriber wants REAL wall-clock timings of stage programs
        #: (the engine only pays the perf_counter reads when this is set)
        self.wants_wall = any(
            getattr(s, "wants_wall_clock", False) for s in self.subscribers
        )
        for name in HOOKS:
            fns = tuple(
                getattr(s, name)
                for s in self.subscribers
                if callable(getattr(s, name, None))
            )
            if not fns:
                setattr(self, name, _noop)
            elif len(fns) == 1:
                setattr(self, name, fns[0])
            else:
                setattr(self, name, _fanout(fns))


def build_stream(*subscribers) -> InstrumentationStream | None:
    """A stream over the non-None subscribers, or None when there are none
    (the engine then skips every emission — the zero-cost disabled path)."""
    subs = [s for s in subscribers if s is not None]
    return InstrumentationStream(subs) if subs else None
