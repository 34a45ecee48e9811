"""What a run records: wall-clock times at the engine's instrumentation
hooks, the heads' outputs, and the counts the metric readers read.

``Observer`` subscribes to the engine's stream as its ``metrics``
observer.  It sets no ``wants_wall_clock``, so the engine adds no device
synchronisation for it; the times it takes are the host's clock when a hook
fires:

* ``on_batch`` (a stage batch dispatched; after a head batch the engine has
  pulled its confidences to the host, so the batch's device work is done);
* ``on_loopback`` (a token emitted, the request goes on) and ``on_exit``
  (the last token emitted, the request retired).

It also closes the window: the first ``on_batch`` past the deadline raises
``WindowClosed`` out of ``serve``.  The slot in flight is cut there; what it
retired before the deadline counts for the metrics, the rest is dropped
(the check still reads the head outputs of the requests it cut).

The heads' outputs reach it from a wrapper of ``kernels.ops.
exit_confidence`` (``head_output``), with no synchronisation: the
wrapper keeps the device tensors, and the next ``on_batch`` names the
stage and the rows they belong to.
"""
from __future__ import annotations

import math
from time import perf_counter

import numpy as np


class WindowClosed(Exception):
    """Raised from a hook when the run's window (and traced span) is over."""


class Observer:
    def __init__(self, head_stages):
        self.head_stages = set(head_stages)
        self.slot = -1
        self.window_end = math.inf  # counting stops here
        self.deadline = math.inf  # the serve is cut here
        self.span = None  # a trace.TraceSpan in a traced run
        self.prompt_lens: dict[int, list[int]] = {}
        self.stats: dict[int, object] = {}  # slot -> the engine's ServeStats
        # (t, slot, stage, real rows, padded rows, is_decode)
        self.batches: list[tuple] = []
        # (t, slot, rid, pass index) of every emitted token
        self.tokens: list[tuple] = []
        self.exits: list[tuple] = []  # (t, slot, rid, stage)
        self.first_batch: dict[tuple, float] = {}  # (slot, rid) -> first stage-1 batch
        self.heads: list[tuple] = []  # (slot, stage, rids, conf, tok) device tensors
        self.emitted: dict[tuple, int] = {}  # (slot, rid) -> tokens emitted
        self._head = None

    # -- driven by the harness -------------------------------------------
    def begin_slot(self, slot: int, prompts) -> None:
        self.slot = slot
        self.prompt_lens[slot] = [int(p.shape[0]) for p in prompts]

    def head_output(self, conf, tok) -> None:
        self._head = (conf, tok)

    # -- hooks -----------------------------------------------------------
    def on_batch(self, done, node, gflops, wall, queue_depth, stage=0, rids=(), n_rows=0,
                 is_decode=False, **_):
        now = perf_counter()
        if stage in self.head_stages and self._head is not None:
            self.heads.append((self.slot, stage, rids) + self._head)
            self._head = None
        self.batches.append((now, self.slot, stage, len(rids), n_rows, is_decode))
        if stage == 1 and not is_decode:
            for r in rids:
                self.first_batch.setdefault((self.slot, r), now)
        if self.span is not None:
            self.span.tick(now, self.window_end)
        if now > self.deadline:
            raise WindowClosed

    def _token(self, now: float, rid: int) -> None:
        key = (self.slot, rid)
        k = self.emitted.get(key, 0)
        self.emitted[key] = k + 1
        self.tokens.append((now, self.slot, rid, k))

    def on_loopback(self, t0, t1, src, dst, rid, mb, **_):
        self._token(perf_counter(), rid)

    def on_exit(self, t, rid, stage, conf, **_):
        now = perf_counter()
        self._token(now, rid)
        self.exits.append((now, self.slot, rid, stage))


class Record:
    """What the metric readers read: the window's counts and times, the
    traced span's summary (``trace``, None in an untraced run), set-up."""

    def __init__(self, obs: Observer, t0: float, seconds: float, setup_s: float, model: dict,
                 trace=None):
        end = t0 + seconds
        self.seconds = seconds
        self.setup_s = setup_s
        self.model = model
        self.trace = trace
        self.prompt_lens = obs.prompt_lens
        self.tokens = [x for x in obs.tokens if t0 <= x[0] <= end]
        self.exits = [x for x in obs.exits if t0 <= x[0] <= end]
        self.batches = [x for x in obs.batches if t0 <= x[0] <= end]
        self.task_ms = [(t - obs.first_batch[(s, r)]) * 1e3 for t, s, r, _ in self.exits
                        if (s, r) in obs.first_batch]
        # per request, the wall times of its tokens inside the window
        per_req: dict[tuple, list[float]] = {}
        for t, s, r, _ in self.tokens:
            per_req.setdefault((s, r), []).append(t)
        self.token_gaps_ms = [(b - a) * 1e3 for ts in per_req.values()
                              for a, b in zip(ts, ts[1:])]


def percentile(values, q: float) -> float | None:
    return float(np.percentile(np.asarray(values, np.float64), q)) if len(values) else None
