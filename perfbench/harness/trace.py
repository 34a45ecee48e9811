"""The traced span of a ``--trace 1`` run: ``torch.profiler`` (host and
device activity) over a bounded span after the window, with the
benchmark's own spans around the calls into each layer.

The span starts at the first stage batch after the window closes and ends
``seconds`` later (after a synchronisation, so every kernel launched in it
is recorded).  Inside it:

* ``perfbench.stage.<method>`` spans wrap the engine's stage programs
  (``StagePrograms.embed``, ``run_stage``, ``stage_prefill``,
  ``stage_decode``, ``slot_write``, ``exit_head``, ``final_head``);
* ``perfbench.op.<name>`` spans wrap the program's kernel entry points
  (``kernels.ops.flash_attention``, ``decode_attention``,
  ``exit_confidence``), and each call's least time on the chip is counted
  from its shapes (``flops.py``; decode's lengths are copied to the host
  without a wait and summed after the span).

From the profiler's events: the device's busy time (the union of its
kernels', copies' and memsets' intervals), each op span's device time (the
kernels whose launch lies inside the span, matched by the profiler's
correlation ids), the idle gaps, each labelled by the benchmark span the
host was inside at the gap's middle, and the device time by kernel.
"""
from __future__ import annotations

import bisect
import contextlib
from time import perf_counter

import torch

from perfbench.harness import flops
from perfbench.harness.record import WindowClosed

STAGE_METHODS = ("embed", "run_stage", "stage_prefill", "stage_decode", "slot_write",
                 "exit_head", "final_head")
OPS = ("flash_attention", "decode_attention", "exit_confidence")
HOST_LOOP = "engine host loop (no stage program)"


class TraceSpan:
    def __init__(self, seconds: float, device):
        self.seconds = seconds
        self.device = device
        self.prof = None
        self.t_start = self.t_stop = None
        self.active = False
        self.calls = {op: 0 for op in OPS}
        self.least_s = {op: 0.0 for op in OPS}
        self._lengths: list = []  # (host tensor of decode lengths, B, hq, kvh, hd)
        self.batches = 0

    # -- clock -----------------------------------------------------------
    def tick(self, now: float, window_end: float) -> None:
        """Called at every stage batch: start after the window, stop at the end."""
        if self.t_stop is not None:
            return
        if self.t_start is None:
            if now >= window_end:
                self.prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
                self.prof.start()
                self.t_start = perf_counter()
                self.active = True
            return
        self.batches += 1
        if now >= self.t_start + self.seconds:
            if torch.device(self.device).type == "cuda":
                torch.cuda.synchronize(self.device)
            self.t_stop = perf_counter()
            self.active = False
            self.prof.stop()
            raise WindowClosed

    # -- wrappers ----------------------------------------------------------
    def _op(self, name, fn):
        def wrapped(*a, **k):
            if not self.active:
                return fn(*a, **k)
            self.calls[name] += 1
            if name == "flash_attention":
                q, kk = a[0], a[1]
                self.least_s[name] += flops.least_seconds(*flops.flash_attention(
                    q.shape[0], q.shape[1], q.shape[2], kk.shape[2], q.shape[3]))
            elif name == "exit_confidence":
                h, w = a
                self.least_s[name] += flops.least_seconds(*flops.exit_confidence(
                    h.shape[0], h.shape[1], w.shape[1]))
            else:
                q, kk, _, lengths = a
                host = torch.empty(lengths.shape, dtype=lengths.dtype, pin_memory=True)
                host.copy_(lengths, non_blocking=True)
                self._lengths.append((host, q.shape[0], q.shape[1], kk.shape[2], q.shape[2]))
            with torch.profiler.record_function(f"perfbench.op.{name}"):
                return fn(*a, **k)
        return wrapped

    def _stage(self, name, fn):
        def wrapped(*a, **k):
            if not self.active:
                return fn(*a, **k)
            with torch.profiler.record_function(f"perfbench.stage.{name}"):
                return fn(*a, **k)
        return wrapped

    @contextlib.contextmanager
    def installed(self, engine):
        """The wrappers in place on ``engine``'s stage programs and on
        ``kernels.ops`` while the run lasts."""
        from repro_torch.kernels import ops

        progs = engine.programs
        saved_ops = {op: getattr(ops, op) for op in OPS}
        for op in OPS:
            setattr(ops, op, self._op(op, saved_ops[op]))
        for m in STAGE_METHODS:
            setattr(progs, m, self._stage(m, getattr(progs, m)))
        try:
            yield self
        finally:
            for op, fn in saved_ops.items():
                setattr(ops, op, fn)
            for m in STAGE_METHODS:
                progs.__dict__.pop(m, None)
            if self.active:
                self.prof.stop()
                self.active = False

    # -- reading -----------------------------------------------------------
    def summary(self) -> dict | None:
        """The span's readings; None when no span was traced.  Raises where
        the profiler recorded no device event."""
        if self.t_start is None or self.t_stop is None:
            return None
        for host, B, hq, kvh, hd in self._lengths:
            self.least_s["decode_attention"] += flops.least_seconds(
                *flops.decode_attention(int(host.sum()), B, hq, kvh, hd))
        events = self.prof.profiler.kineto_results.events()
        cuda = torch.autograd.DeviceType.CUDA
        # the device's own work: kernels, copies, memsets (the profiler also
        # draws each benchmark span on the device's track: left out)
        dev = [e for e in events if e.device_type() == cuda and e.duration_ns() > 0
               and not e.name().startswith("perfbench.")]
        if not dev:
            raise RuntimeError("the profiler recorded no device event in the traced span")
        host = [e for e in events if e.device_type() != cuda]
        # the launch of each device event: the CUDA runtime or driver call
        # (``cuda...``, ``cu...``) with its correlation id; the host's ops
        # number their own events from 1 too, so they are left out
        launch_at = {e.correlation_id(): e.start_ns() for e in host
                     if e.name().startswith("cu")}
        ops_spans = sorted((e.start_ns(), e.end_ns(), e.name()[len("perfbench.op."):])
                           for e in host if e.name().startswith("perfbench.op."))
        op_starts = [s for s, _, _ in ops_spans]
        op_device_s = {op: 0.0 for op in OPS}
        op_kernels = {op: {} for op in OPS}
        by_kernel: dict[str, float] = {}
        unmatched = 0
        for e in dev:
            name = e.name()[:120]
            by_kernel[name] = by_kernel.get(name, 0.0) + e.duration_ns() / 1e9
            t = launch_at.get(e.correlation_id())
            if t is None:
                unmatched += 1
                continue
            i = bisect.bisect_right(op_starts, t) - 1
            if i >= 0 and ops_spans[i][0] <= t <= ops_spans[i][1]:
                op = ops_spans[i][2]
                op_device_s[op] += e.duration_ns() / 1e9
                k = op_kernels[op].setdefault(e.name()[:60], [0, 0.0])
                k[0] += 1
                k[1] += e.duration_ns() / 1e9
        # the device's busy intervals, merged
        iv = sorted((e.start_ns(), e.end_ns()) for e in dev)
        merged = [list(iv[0])]
        for s, t in iv[1:]:
            if s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        busy_s = sum(t - s for s, t in merged) / 1e9
        # idle gaps between busy intervals, by the benchmark span the host was in
        spans = sorted((e.start_ns(), e.end_ns(), e.name()) for e in host
                       if e.name().startswith("perfbench."))
        gaps: dict[str, float] = {}
        stack: list[tuple] = []  # the spans open at the sweep's time, nested
        j = 0
        for (_, a), (b, _) in zip(merged, merged[1:]):
            mid = (a + b) // 2
            while j < len(spans) and spans[j][0] <= mid:
                while stack and stack[-1][1] < spans[j][0]:
                    stack.pop()
                stack.append(spans[j])
                j += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            label = stack[-1][2] if stack else HOST_LOOP
            gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e9
        window_s = self.t_stop - self.t_start
        return {
            "busy_s": busy_s,
            "window_s": window_s,
            "batches": self.batches,
            "calls": dict(self.calls),
            "least_s": dict(self.least_s),
            "op_device_s": op_device_s,
            "op_kernels": op_kernels,
            "unmatched": unmatched,
            "device_ops": sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:10],
        }
