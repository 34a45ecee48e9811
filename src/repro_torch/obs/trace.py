"""Per-request span tracing for the serving engine.

A copy of ``repro.obs.trace``.  The engine's instrumentation stream
(:mod:`repro_torch.obs.stream`) emits one observation per event as its
simulated clock advances.  :class:`SpanTracer`
folds those observations into one **span tree per request**: a contiguous
tiling of the interval ``[arrival, retirement]`` by typed spans —

  ``admission``   arrival at the ED until the first hop is submitted
  ``transfer``    a residual-stream / token hop between two nodes
  ``queue``       waiting in a replica's batcher (includes slot / block
                  admission blocking; ``lost=True`` marks time at a replica
                  that failed before serving the request)
  ``batch_wait``  popped into a batch, waiting for the replica to free
  ``compute``     the stage forward of the batch the request rode in

plus zero-duration *instants* (exit-head decisions, retirements, failures,
re-executions) and counter samples (queue depth, block-pool occupancy).

Because every span is delimited by the same event timestamps that delimit
its neighbours, the tiling is exact: span ``k`` ends on the very float where
span ``k+1`` begins, the first span begins at ``Request.arrival`` and the
last ends at ``Request.t_done`` — so the per-request component sums
reconcile with the reported delay (asserted in tests and by
:func:`repro_torch.obs.attribution.decompose`).

Hot-path cost: each hook appends ONE compact event tuple; span trees,
instants, counters, and the roofline accumulators are materialized lazily by
replaying the event log on first view access (views are read after the
serve, so the serve itself pays only the appends).  On a CUDA device the
larger cost is elsewhere: a tracer asks for wall-clock times, and the engine
then synchronizes the device after every stage batch.

Timestamps are **simulated** seconds; the tracer has no clock of its own —
callers inject event times explicitly (:class:`SimClock` tracks the latest
one for exporters).  Wall-clock durations of the real stage programs
(device work included: the engine synchronizes before reading the clock)
ride along separately (``wants_wall_clock``) and feed the roofline join in
:mod:`repro_torch.obs.roofline_hook`.

When tracing is off the engine skips every emission (``stream is None``), so
the disabled path is bitwise identical to an untraced build; :class:`NullTracer`
is the explicit no-op stub for call sites that want an unconditional object.
"""
from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["Span", "SpanTracer", "NullTracer", "SimClock", "SPAN_KINDS"]

#: the component vocabulary of the per-request tiling
SPAN_KINDS = ("admission", "transfer", "queue", "batch_wait", "compute")


@dataclasses.dataclass(slots=True)
class Span:
    rid: int
    kind: str
    t0: float
    t1: float
    node: int = -1
    stage: int = -1
    attrs: dict | None = None

    @property
    def duration(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class SimClock:
    """Injectable simulated-time clock: event sources set ``now`` as their
    heap advances, exporters read the high-water mark."""

    now: float = 0.0

    def advance(self, t: float) -> None:
        if t > self.now:
            self.now = t


@dataclasses.dataclass
class _ComputeWall:
    """Accumulated REAL wall-clock of one (stage, phase) program across a
    serve — the measured half of the roofline join."""

    wall_s: float = 0.0
    calls: int = 0
    rows: int = 0  # padded device rows (machine work)
    live_rows: int = 0
    tokens: int = 0  # padded rows x pass seq length (device tokens)
    gflops: float = 0.0  # modeled GFLOPs charged by the sim clock


class _Materialized:
    """Span trees etc. rebuilt from the event log by :meth:`SpanTracer._replay`."""

    __slots__ = (
        "spans", "instants", "counters", "compute_wall", "arrival", "done",
        "attempts", "batches", "cursor", "queue_start",
    )

    def __init__(self):
        self.spans: dict[int, list[Span]] = {}
        self.instants: list[dict] = []
        self.counters: list[tuple[float, str, int, float]] = []
        self.compute_wall: dict[tuple[int, str], _ComputeWall] = {}
        self.arrival: dict[int, float] = {}
        self.done: dict[int, float] = {}
        self.attempts: dict[int, int] = {}
        # (t_start, t_done, node, stage, live, rows, is_decode) per batch —
        # the per-node busy track of the exported trace
        self.batches: list[tuple] = []
        self.cursor: dict[int, float] = {}
        self.queue_start: dict[int, tuple[float, int]] = {}

    def add_span(
        self, rid: int, kind: str, t0: float, t1: float,
        node: int = -1, stage: int = -1, attrs: dict | None = None,
    ) -> None:
        self.spans.setdefault(rid, []).append(
            Span(rid, kind, t0, t1, node, stage, attrs)
        )


class SpanTracer:
    """Subscriber of the engine's instrumentation stream building span trees.

    Also usable directly (:meth:`add_span` / :meth:`add_instant`) by event
    sources that do their own bookkeeping, e.g. the discrete-event
    simulator.  Every hook is one tuple append; the views below replay the
    log on demand.
    """

    wants_wall_clock = True  # ask the engine to time its stage programs

    def __init__(self):
        self.clock = SimClock()
        self._events: list[tuple] = []
        self._mat: _Materialized | None = None
        self._n_mat = -1

    # -- generic span API (simulator & tests) -------------------------------
    def add_span(
        self, rid: int, kind: str, t0: float, t1: float,
        node: int = -1, stage: int = -1, **attrs,
    ) -> None:
        self._events.append(("span", rid, kind, t0, t1, node, stage,
                             attrs or None))

    def add_instant(
        self, t: float, kind: str, rid: int = -1, node: int = -1,
        stage: int = -1, **attrs,
    ) -> None:
        self._events.append(("inst", t, kind, rid, node, stage, attrs))

    def add_counter(self, t: float, name: str, node: int, value: float) -> None:
        self._events.append(("ctr", t, name, node, value))

    # -- stream hooks (called by the engine via InstrumentationStream) ------
    def on_submit(self, t: float, rid: int, ed: int, arrival: float) -> None:
        self._events.append(("submit", t, rid, ed, arrival))

    def on_resubmit(self, t: float, rid: int) -> None:
        self._events.append(("resubmit", t, rid))

    def on_transfer(
        self, t0: float, t1: float, wall: float, src: int, dst: int,
        rid: int, mb: float,
    ) -> None:
        self._events.append(("transfer", t0, t1, src, dst, rid, mb, False))

    def on_loopback(
        self, t0: float, t1: float, src: int, dst: int, rid: int, mb: float
    ) -> None:
        # stage-H -> stage-1 token loopback of an autoregressive request
        # (not a Telemetry link observation — the modeled time is per-token)
        self._events.append(("transfer", t0, t1, src, dst, rid, mb, True))

    def on_enqueue(self, t: float, rid: int, node: int) -> None:
        self._events.append(("enq", t, rid, node))

    def on_batch(
        self,
        t: float,
        node: int,
        gflops: float,
        wall: float,
        queue_depth: int,
        *,
        stage: int = -1,
        rids: tuple = (),
        t_dispatch: float = 0.0,
        t_start: float = 0.0,
        n_rows: int = 0,
        n_tokens: int = 0,
        is_decode: bool = False,
        wall_clock_s: float = 0.0,
        **_: Any,
    ) -> None:
        self._events.append((
            "batch", t, node, gflops, queue_depth, stage, rids, t_dispatch,
            t_start, n_rows, n_tokens, is_decode, wall_clock_s,
        ))

    def on_pool(
        self, t: float, node: int, used_fraction: float,
        hit_blocks: int = 0, total_blocks: int = 0,
    ) -> None:
        self._events.append(("ctr", t, "pool_occupancy", node, used_fraction))

    def on_exit(self, t: float, rid: int, stage: int, conf: float) -> None:
        self._events.append(("exit", t, rid, stage, conf))

    def on_failure(self, t: float, node: int) -> None:
        self._events.append(("fail", t, node))

    # -- replay -------------------------------------------------------------
    def _replay(self) -> _Materialized:
        """(Re)build span trees from the event log; cached until it grows."""
        if self._mat is not None and self._n_mat == len(self._events):
            return self._mat
        m = _Materialized()
        clock = self.clock
        for ev in self._events:
            op = ev[0]
            if op == "transfer":
                _, t0, t1, src, dst, rid, mb, loop = ev
                attrs = {"src": src, "mb": mb}
                if loop:
                    attrs["loopback"] = True
                m.add_span(rid, "transfer", t0, t1, dst, -1, attrs)
                m.cursor[rid] = t1
                clock.advance(t1)
            elif op == "enq":
                _, t, rid, node = ev
                m.queue_start[rid] = (t, node)
            elif op == "batch":
                (_, t, node, gflops, queue_depth, stage, rids, t_dispatch,
                 t_start, n_rows, n_tokens, is_decode, wall_clock_s) = ev
                for rid in rids:
                    qs = m.queue_start.pop(rid, (t_dispatch, node))
                    m.add_span(rid, "queue", qs[0], t_dispatch, node, stage)
                    m.add_span(rid, "batch_wait", t_dispatch, t_start, node,
                               stage)
                    m.add_span(rid, "compute", t_start, t, node, stage,
                               {"decode": is_decode})
                    m.cursor[rid] = t
                m.counters.append((t, "queue_depth", node, float(queue_depth)))
                key = (stage, "decode" if is_decode else "prefill")
                cw = m.compute_wall.get(key)
                if cw is None:
                    cw = m.compute_wall[key] = _ComputeWall()
                cw.wall_s += wall_clock_s
                cw.calls += 1
                cw.rows += n_rows
                cw.live_rows += len(rids)
                cw.tokens += n_tokens
                cw.gflops += gflops
                m.batches.append(
                    (t_start, t, node, stage, len(rids), n_rows, is_decode)
                )
                clock.advance(t)
            elif op == "submit":
                _, t, rid, ed, arrival = ev
                if rid not in m.arrival:
                    m.arrival[rid] = arrival
                    m.attempts[rid] = 1
                    # admission wait: ED arrival -> first-hop submission
                    # (zero today; deadline-aware admission control will
                    # stretch it)
                    m.add_span(rid, "admission", arrival, t, ed, 0)
                    m.cursor[rid] = t
                    clock.advance(t)
            elif op == "resubmit":
                # fail-stop re-execution: close the open wait as lost time,
                # restart the tiling cursor at the re-submission instant
                _, t, rid = ev
                qs = m.queue_start.pop(rid, None)
                cur = m.cursor.get(rid, t)
                if qs is not None:
                    m.add_span(rid, "queue", qs[0], t, qs[1], -1,
                               {"lost": True})
                elif t > cur:
                    # in flight / in service when the failure landed: the
                    # preceding span already tiles up to the detection event
                    # in the engine; anything left is unattributed lost time
                    m.add_span(rid, "queue", cur, t, -1, -1, {"lost": True})
                m.cursor[rid] = t
                m.attempts[rid] = m.attempts.get(rid, 0) + 1
                m.instants.append(
                    {"t": t, "kind": "resubmit", "rid": rid, "node": -1,
                     "stage": -1, "attempt": m.attempts[rid]}
                )
                clock.advance(t)
            elif op == "exit":
                _, t, rid, stage, conf = ev
                m.done[rid] = t
                m.queue_start.pop(rid, None)
                m.cursor[rid] = t
                m.instants.append(
                    {"t": t, "kind": "retire", "rid": rid, "node": -1,
                     "stage": stage, "conf": conf}
                )
                clock.advance(t)
            elif op == "fail":
                _, t, node = ev
                m.instants.append(
                    {"t": t, "kind": "failure", "rid": -1, "node": node,
                     "stage": -1}
                )
                clock.advance(t)
            elif op == "span":
                _, rid, kind, t0, t1, node, stage, attrs = ev
                m.add_span(rid, kind, t0, t1, node, stage, attrs)
                clock.advance(t1)
            elif op == "inst":
                _, t, kind, rid, node, stage, attrs = ev
                m.instants.append(
                    {"t": t, "kind": kind, "rid": rid, "node": node,
                     "stage": stage, **attrs}
                )
                clock.advance(t)
            elif op == "ctr":
                _, t, name, node, value = ev
                m.counters.append((t, name, node, float(value)))
                clock.advance(t)
        self._mat = m
        self._n_mat = len(self._events)
        return m

    # materialized state, replayed on demand
    @property
    def spans(self) -> dict[int, list[Span]]:
        return self._replay().spans

    @property
    def instants(self) -> list[dict]:
        return self._replay().instants

    @property
    def counters(self) -> list[tuple[float, str, int, float]]:
        return self._replay().counters

    @property
    def compute_wall(self) -> dict[tuple[int, str], _ComputeWall]:
        return self._replay().compute_wall

    @property
    def arrival(self) -> dict[int, float]:
        return self._replay().arrival

    @property
    def done(self) -> dict[int, float]:
        return self._replay().done

    @property
    def attempts(self) -> dict[int, int]:
        return self._replay().attempts

    @property
    def batches(self) -> list[tuple]:
        return self._replay().batches

    # -- views --------------------------------------------------------------
    def closed(self, rid: int) -> bool:
        return rid in self._replay().done

    def components(self, rid: int) -> dict[str, float]:
        """Per-kind span-duration sums of one request's tree."""
        out = {k: 0.0 for k in SPAN_KINDS}
        for s in self._replay().spans.get(rid, ()):
            out[s.kind] = out.get(s.kind, 0.0) + s.duration
        return out

    def check_tree(self, rid: int) -> list[str]:
        """Invariant check of one request's span tree; returns violations.

        A closed tree tiles ``[arrival, done]`` contiguously: every span
        starts exactly (float equality) where its predecessor ended, spans
        are monotone (t1 >= t0), and the endpoints match the request's
        recorded arrival / retirement.
        """
        m = self._replay()
        errs: list[str] = []
        spans = m.spans.get(rid)
        if not spans:
            return [f"rid {rid}: no spans"]
        if rid not in m.done:
            errs.append(f"rid {rid}: tree never closed (no retirement)")
        for i, s in enumerate(spans):
            if not (s.t1 >= s.t0):
                errs.append(f"rid {rid} span {i} ({s.kind}): t1 < t0")
            if i and spans[i - 1].t1 != s.t0:
                errs.append(
                    f"rid {rid} span {i} ({s.kind}): starts at {s.t0!r}, "
                    f"previous ended at {spans[i - 1].t1!r}"
                )
        if rid in m.arrival and spans[0].t0 != m.arrival[rid]:
            errs.append(f"rid {rid}: first span does not start at arrival")
        if rid in m.done and spans[-1].t1 != m.done[rid]:
            errs.append(f"rid {rid}: last span does not end at retirement")
        return errs


class NullTracer:
    """Zero-cost stub: every hook is a no-op.  The engine never calls into a
    tracer unless one is attached, so this exists for call sites that want
    an unconditional object (e.g. library code taking ``tracer=NullTracer()``)."""

    wants_wall_clock = False

    def __getattr__(self, name: str):
        if name.startswith("on_") or name.startswith("add_"):
            return self._noop
        raise AttributeError(name)

    @staticmethod
    def _noop(*args: Any, **kwargs: Any) -> None:
        return None
