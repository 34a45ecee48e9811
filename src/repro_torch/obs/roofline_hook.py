"""Roofline join: measured stage-program wall time vs the H100 bound.

The tracer accumulates REAL ``perf_counter`` wall seconds around every
stage-program call the engine makes (``wants_wall_clock``), keyed by
``(stage, phase)`` and carrying the device work actually shipped (padded
rows, device tokens, call count).  On a CUDA device the engine synchronizes
before it reads the clock, so each wall holds the batch's device work as
well as the host's dispatch.  This module joins that with the analytic
per-stage FLOP/byte counts in :mod:`repro_torch.roofline.analysis` to report,
per stage and phase, how far measured compute sits from the roofline bound.

The bound uses the published peaks of one H100 SXM
(``roofline/constants.py``).  Measured on an H100, a utilization above 1 is
a fault: either the wall time missed device work, or the analytic counts
undercount what the stage must move.  On the CPU the constants describe
another device, and only the analytic columns mean anything.
"""
from __future__ import annotations

from repro_torch.roofline.analysis import (
    stage_roofline_bound_s,
    stage_step_bytes,
    stage_step_flops,
)

__all__ = ["roofline_utilization"]


def roofline_utilization(tracer, cfg) -> dict:
    """Measured-vs-roofline utilization per (stage, phase) of one serve.

    Returns ``{"stage{h}.{phase}": {...}}`` rows with the measured wall
    time, the analytic FLOP/byte totals for the device work shipped, the
    roofline bound, and ``utilization = bound_s / measured_s``.
    """
    out: dict[str, dict] = {}
    for (stage, phase), cw in sorted(tracer.compute_wall.items()):
        flops = stage_step_flops(cfg, stage, cw.tokens)
        nbytes = stage_step_bytes(cfg, stage, cw.calls, cw.tokens)
        bound_s = stage_roofline_bound_s(flops, nbytes)
        row = {
            "stage": stage,
            "phase": phase,
            "calls": cw.calls,
            "device_rows": cw.rows,
            "live_rows": cw.live_rows,
            "device_tokens": cw.tokens,
            "modeled_gflops": cw.gflops,
            "analytic_gflops": flops / 1e9,
            "analytic_gbytes": nbytes / 1e9,
            "bound_s": bound_s,
            "measured_wall_s": cw.wall_s,
            "utilization": bound_s / cw.wall_s if cw.wall_s > 0 else 0.0,
            "padded_row_frac": 1.0 - cw.live_rows / cw.rows if cw.rows else 0.0,
        }
        out[f"stage{stage}.{phase}"] = row
    return out
