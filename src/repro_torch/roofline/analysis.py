"""Analytic roofline of one serving stage on one H100.

The counterpart of the per-stage half of ``repro.roofline.analysis``:

    compute term = 2 * params_h * tokens / PEAK_FLOPS_BF16
    memory term  = (calls * params_h + 2 * tokens * d_model) * 2 bytes / HBM_BW

The whole-program report built from a compiled dry run (``RooflineReport``,
``build_report``, ``model_flops_for``) and its HLO collective parser wait
for the multi-device slice.
"""
from __future__ import annotations

from repro_torch.core.profiles import stage_param_counts
from repro_torch.roofline import constants


def stage_step_flops(cfg, stage: int, n_tokens: int) -> float:
    """Forward FLOPs of serving-stage ``stage`` (1-based) over ``n_tokens``
    device tokens: 2 * params_h per token (param-FLOPs dominate; attention
    against the cache is charged to the byte side)."""
    return 2.0 * stage_param_counts(cfg)[stage - 1] * n_tokens


def stage_step_bytes(cfg, stage: int, n_calls: int, n_tokens: int, dtype_bytes: int = 2) -> float:
    """HBM traffic of ``n_calls`` invocations of stage ``stage``: the weight
    stream (params * dtype_bytes, re-read every call — the decode-side
    floor) plus the activation stream (tokens * d_model in and out)."""
    params = stage_param_counts(cfg)[stage - 1]
    weights = float(n_calls) * params * dtype_bytes
    activations = 2.0 * n_tokens * cfg.d_model * dtype_bytes
    return weights + activations


def stage_roofline_bound_s(flops: float, nbytes: float) -> float:
    """Single-card roofline time bound: max of the compute and memory terms."""
    return max(flops / constants.PEAK_FLOPS_BF16, nbytes / constants.HBM_BW)
