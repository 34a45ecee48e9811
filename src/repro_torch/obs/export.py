"""Exporters: Chrome-trace/Perfetto JSON from a :class:`SpanTracer`.

A copy of ``repro.obs.export``.

The Trace Event Format (the JSON Chrome's ``about:tracing`` and Perfetto's
legacy importer read) wants microsecond ``ts``/``dur`` integers, ``"X"``
complete events for spans, ``"i"`` instants, ``"C"`` counter samples, and
``"M"`` metadata naming the process/thread tracks.  We lay the serve out as

  * one ``pid`` per request track group (``pid=1`` "requests"), one ``tid``
    per request id — a request's span tiling reads left-to-right with no
    gaps;
  * one ``pid`` per serving node (``pid = 1000 + node``), ``tid=0`` the
    replica's batch busy track (each dispatched batch one ``X`` event);
  * counter events (queue depth, pool occupancy) on the node pids.

Timestamps are simulated seconds scaled by 1e6 — open the file in
https://ui.perfetto.dev and the timeline is the simulated serve.

``validate_chrome_trace`` is the invariant checker (the port's counterpart
of what ``tools/check_trace.py`` runs for the JAX package, which needs JAX):
schema well-formedness, no unclosed/backwards spans, per-request tracks
monotone and non-overlapping.
"""
from __future__ import annotations

import json
from typing import Any

__all__ = ["chrome_trace", "write_chrome_trace", "validate_chrome_trace"]

_REQ_PID = 1
_NODE_PID0 = 1000
_US = 1e6  # simulated seconds -> trace microseconds
#: adjacent spans share their boundary float in seconds, but ts/dur are
#: rounded to 1 ns in the export — neighbours may disagree by one quantum
_ROUND_SLOP_US = 2e-3


def _us(t: float) -> float:
    return round(float(t) * _US, 3)


def chrome_trace(tracer) -> dict:
    """Trace Event Format payload (``{"traceEvents": [...]}``) of a serve."""
    ev: list[dict] = [
        {"ph": "M", "pid": _REQ_PID, "name": "process_name",
         "args": {"name": "requests"}},
    ]
    nodes_seen: set[int] = set()

    def node_pid(node: int) -> int:
        if node not in nodes_seen:
            nodes_seen.add(node)
            ev.append({"ph": "M", "pid": _NODE_PID0 + node,
                       "name": "process_name", "args": {"name": f"node{node}"}})
        return _NODE_PID0 + node

    for rid in sorted(tracer.spans):
        ev.append({"ph": "M", "pid": _REQ_PID, "tid": rid,
                   "name": "thread_name", "args": {"name": f"req{rid}"}})
        for s in tracer.spans[rid]:
            args: dict[str, Any] = {"node": s.node, "stage": s.stage}
            if s.attrs:
                args.update(s.attrs)
            ev.append({
                "ph": "X", "pid": _REQ_PID, "tid": rid, "name": s.kind,
                "cat": "request", "ts": _us(s.t0), "dur": _us(s.duration),
                "args": args,
            })

    for (t_start, t_done, node, stage, live, rows, is_decode) in tracer.batches:
        ev.append({
            "ph": "X", "pid": node_pid(node), "tid": 0,
            "name": f"stage{stage}.{'decode' if is_decode else 'prefill'}",
            "cat": "batch", "ts": _us(t_start), "dur": _us(t_done - t_start),
            "args": {"live": live, "rows": rows},
        })

    for inst in tracer.instants:
        pid, tid = (_REQ_PID, inst["rid"])
        if inst["rid"] < 0 and inst["node"] >= 0:
            pid, tid = node_pid(inst["node"]), 0
        args = {k: v for k, v in inst.items() if k not in ("t", "kind")}
        ev.append({"ph": "i", "pid": pid, "tid": tid, "name": inst["kind"],
                   "cat": "event", "ts": _us(inst["t"]), "s": "t",
                   "args": args})

    for (t, name, node, value) in tracer.counters:
        ev.append({"ph": "C", "pid": node_pid(node), "tid": 0, "name": name,
                   "ts": _us(t), "args": {"value": value}})

    return {"traceEvents": ev, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, tracer) -> dict:
    payload = chrome_trace(tracer)
    with open(path, "w") as f:
        json.dump(payload, f)
    return payload


def validate_chrome_trace(payload: Any) -> list[str]:
    """Schema / invariant violations of a Trace Event Format payload.

    Checks: top-level shape, per-event required fields by phase, non-negative
    ``X`` durations, balanced ``B``/``E`` stacks per track, and per-request
    span tracks (``pid == 1``) monotone and non-overlapping.
    """
    errs: list[str] = []
    if not isinstance(payload, dict) or "traceEvents" not in payload:
        return ["payload is not an object with a traceEvents list"]
    events = payload["traceEvents"]
    if not isinstance(events, list):
        return ["traceEvents is not a list"]
    if not events:
        errs.append("traceEvents is empty")

    open_stacks: dict[tuple, int] = {}
    req_tracks: dict[tuple, list[tuple[float, float]]] = {}
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            errs.append(f"event {i}: not an object")
            continue
        ph = e.get("ph")
        if ph not in ("X", "B", "E", "i", "I", "C", "M"):
            errs.append(f"event {i}: unknown phase {ph!r}")
            continue
        if "pid" not in e:
            errs.append(f"event {i}: missing pid")
        if ph != "M":
            ts = e.get("ts")
            if not isinstance(ts, (int, float)):
                errs.append(f"event {i}: missing/non-numeric ts")
                continue
        if ph == "M":
            continue
        if "name" not in e:
            errs.append(f"event {i}: missing name")
        key = (e.get("pid"), e.get("tid"))
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)):
                errs.append(f"event {i}: X event missing dur")
            elif dur < 0:
                errs.append(f"event {i}: negative duration {dur}")
            elif e.get("pid") == _REQ_PID:
                req_tracks.setdefault(key, []).append((ts, ts + dur))
        elif ph == "B":
            open_stacks[key] = open_stacks.get(key, 0) + 1
        elif ph == "E":
            n = open_stacks.get(key, 0)
            if n == 0:
                errs.append(f"event {i}: E without matching B on track {key}")
            else:
                open_stacks[key] = n - 1

    for key, n in open_stacks.items():
        if n:
            errs.append(f"track {key}: {n} unclosed B span(s)")

    for (pid, tid), ivals in req_tracks.items():
        prev_end = None
        for (t0, t1) in ivals:  # events were emitted in span order
            if prev_end is not None and t0 < prev_end - _ROUND_SLOP_US:
                errs.append(
                    f"request track tid={tid}: span at ts={t0} overlaps "
                    f"previous span ending at {prev_end}"
                )
            prev_end = t1
    return errs
