"""Metrics registry: counters, gauges, fixed-bucket log-scale histograms.

A copy of ``repro.obs.metrics``.

The registry is deliberately boring — named metric objects with O(1) updates
and a JSON-able ``snapshot()`` — so it can sit on the serving hot path.
:class:`MetricsCollector` is the instrumentation-stream subscriber that feeds
one: per-replica batch occupancy and padded-row waste, queue depths,
block-pool occupancy and prefix-hit rate, delay / service / transfer
histograms (p50/p95/p99 from log-scale buckets), and the realized
``(confidence, exit_stage)`` pairs the control plane needs to recalibrate
exit profiles online (ROADMAP: "a control plane that learns").

Histogram buckets are fixed at construction (log-spaced, ``per_decade``
buckets per decade of seconds) so observation is one ``bisect`` into a small
sorted list and two scalar adds — no allocation, no resizing, mergeable
across replicas/serves by bucket-count addition.
"""
from __future__ import annotations

import dataclasses
from bisect import bisect_right
from typing import Any

import numpy as np

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "MetricsCollector",
]


@dataclasses.dataclass
class Counter:
    name: str
    value: float = 0.0

    def inc(self, v: float = 1.0) -> None:
        # float() keeps numpy scalars out: one np.float64 would infect the
        # accumulator and make every later += pay numpy-scalar dispatch
        self.value += float(v)

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self.value}


@dataclasses.dataclass
class Gauge:
    name: str
    value: float = float("nan")
    max_value: float = float("-inf")
    n_samples: int = 0
    _sum: float = 0.0

    def set(self, v: float) -> None:
        v = float(v)  # numpy-scalar comparisons cost ~10x a float compare
        self.value = v
        self.n_samples += 1
        self._sum += v
        if v > self.max_value:
            self.max_value = v

    @property
    def mean(self) -> float:
        return self._sum / self.n_samples if self.n_samples else float("nan")

    def snapshot(self) -> dict:
        return {
            "type": "gauge",
            "value": self.value,
            "max": self.max_value if self.n_samples else float("nan"),
            "mean": self.mean,
            "n": self.n_samples,
        }


class Histogram:
    """Fixed log-scale buckets over ``[10**lo_decade, 10**hi_decade]``.

    Bucket 0 catches everything below the range (including zeros), the last
    bucket everything above; quantiles interpolate within a bucket on a log
    scale, so p50/p95/p99 are exact to bucket resolution (default: 8 buckets
    per decade ~ 33% worst-case ratio error, far below the decade-scale
    spreads tail-latency work cares about).
    """

    def __init__(
        self, name: str, lo_decade: int = -7, hi_decade: int = 3,
        per_decade: int = 8,
    ):
        self.name = name
        self.bounds = np.logspace(
            lo_decade, hi_decade, (hi_decade - lo_decade) * per_decade + 1
        )
        # plain-Python mirrors keep observe() off numpy's scalar paths (the
        # histogram sits on the serving hot path: the tracing A/B budget)
        self._bounds = self.bounds.tolist()
        self.counts = [0] * (self.bounds.size + 1)
        self.n = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        # float() first: bisecting with an np.float64 key would pay a
        # numpy-scalar __lt__ per probe (~10x a float compare)
        v = float(v)
        self.counts[bisect_right(self._bounds, v)] += 1
        self.n += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    @property
    def mean(self) -> float:
        return self.sum / self.n if self.n else float("nan")

    def quantile(self, q: float) -> float:
        """Approximate quantile from the bucket counts (log interpolation)."""
        if self.n == 0:
            return float("nan")
        target = q * self.n
        acc = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if acc + c >= target:
                frac = (target - acc) / c
                lo = self.bounds[i - 1] if i >= 1 else self.min
                hi = self.bounds[i] if i < self.bounds.size else self.max
                lo = max(min(lo, self.max), min(self.min, hi))
                if lo <= 0 or hi <= 0:
                    return lo + frac * (hi - lo)
                return float(lo * (hi / lo) ** frac)
            acc += c
        return self.max

    def snapshot(self) -> dict:
        return {
            "type": "histogram",
            "n": self.n,
            "mean": self.mean,
            "min": self.min if self.n else float("nan"),
            "max": self.max if self.n else float("nan"),
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }


class MetricsRegistry:
    """Named metrics with get-or-create accessors and a JSON snapshot."""

    def __init__(self):
        self._metrics: dict[str, Any] = {}

    def _get(self, name: str, factory):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = factory(name)
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, **kw) -> Histogram:
        return self._get(name, lambda n: Histogram(n, **kw))

    def names(self) -> list[str]:
        return sorted(self._metrics)

    def snapshot(self) -> dict:
        return {name: self._metrics[name].snapshot() for name in self.names()}


class MetricsCollector:
    """Instrumentation-stream subscriber feeding a :class:`MetricsRegistry`.

    Attach to ``serve(metrics=...)`` alongside (or instead of) a tracer;
    unlike the tracer it keeps no per-request span lists, only aggregates —
    cheap enough to leave on for every serve.
    """

    wants_wall_clock = False

    def __init__(self, registry: MetricsRegistry | None = None):
        self.registry = registry or MetricsRegistry()
        #: realized (confidence, exit_stage) pairs — the control plane's
        #: raw material for online exit-profile recalibration
        self.exit_pairs: list[tuple[float, int]] = []
        self._arrival: dict[int, float] = {}
        # hot metrics resolved once (hooks fire per event; registry lookups
        # per call would dominate the tracing A/B budget)
        r = self.registry
        self._h_transfer = r.histogram("transfer_s")
        self._h_delay = r.histogram("delay_s")
        self._h_service = r.histogram("batch_service_s")
        self._c_submitted = r.counter("requests_submitted")
        self._c_batches = r.counter("batches")
        self._c_fwd_rows = r.counter("forward_rows")
        self._c_real_rows = r.counter("real_rows")
        self._g_occupancy: dict[int, Gauge] = {}
        self._g_depth: dict[int, Gauge] = {}
        self._g_pool: dict[int, Gauge] = {}
        self._c_exits: dict[int, Counter] = {}

    # -- hooks --------------------------------------------------------------
    def on_submit(self, t: float, rid: int, ed: int, arrival: float) -> None:
        if rid not in self._arrival:
            self._arrival[rid] = arrival
            self._c_submitted.inc()

    def on_resubmit(self, t: float, rid: int) -> None:
        self.registry.counter("requests_resubmitted").inc()

    def on_transfer(
        self, t0: float, t1: float, wall: float, src: int, dst: int,
        rid: int, mb: float,
    ) -> None:
        self._h_transfer.observe(wall)

    def on_loopback(
        self, t0: float, t1: float, src: int, dst: int, rid: int, mb: float
    ) -> None:
        self._h_transfer.observe(t1 - t0)

    def on_batch(
        self,
        t: float,
        node: int,
        gflops: float,
        wall: float,
        queue_depth: int,
        *,
        rids: tuple = (),
        n_rows: int = 0,
        is_decode: bool = False,
        **_: Any,
    ) -> None:
        self._c_batches.inc()
        self._c_fwd_rows.inc(n_rows)
        self._c_real_rows.inc(len(rids))
        self._h_service.observe(wall)
        if n_rows:
            g = self._g_occupancy.get(node)
            if g is None:
                g = self._g_occupancy[node] = self.registry.gauge(
                    f"batch_occupancy.node{node}"
                )
            g.set(len(rids) / n_rows)
        g = self._g_depth.get(node)
        if g is None:
            g = self._g_depth[node] = self.registry.gauge(
                f"queue_depth.node{node}"
            )
        g.set(queue_depth)

    def on_pool(
        self, t: float, node: int, used_fraction: float,
        hit_blocks: int = 0, total_blocks: int = 0,
    ) -> None:
        g = self._g_pool.get(node)
        if g is None:
            g = self._g_pool[node] = self.registry.gauge(
                f"pool_occupancy.node{node}"
            )
        g.set(used_fraction)
        if total_blocks:
            self.registry.counter("prefix_hit_blocks").inc(hit_blocks)
            self.registry.counter("prefix_total_blocks").inc(total_blocks)

    def on_exit(self, t: float, rid: int, stage: int, conf: float) -> None:
        c = self._c_exits.get(stage)
        if c is None:
            c = self._c_exits[stage] = self.registry.counter(
                f"exits.stage{stage}"
            )
        c.inc()
        self.exit_pairs.append((float(conf), int(stage)))
        arrival = self._arrival.get(rid)
        if arrival is not None:
            self._h_delay.observe(t - arrival)

    def on_failure(self, t: float, node: int) -> None:
        self.registry.counter("node_failures").inc()

    # -- views --------------------------------------------------------------
    def padded_row_frac(self) -> float:
        fwd = self.registry.counter("forward_rows").value
        real = self.registry.counter("real_rows").value
        return 1.0 - real / fwd if fwd else 0.0

    def realized_exit_histogram(self) -> dict[int, int]:
        out: dict[int, int] = {}
        for _, stage in self.exit_pairs:
            out[stage] = out.get(stage, 0) + 1
        return out

    def snapshot(self) -> dict:
        return {
            "metrics": self.registry.snapshot(),
            "padded_row_frac": self.padded_row_frac(),
            "exit_histogram": {
                str(k): v for k, v in sorted(self.realized_exit_histogram().items())
            },
            "num_exit_pairs": len(self.exit_pairs),
        }
