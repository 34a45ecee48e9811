"""Roofline bounds on H100s: the counterpart of ``repro.roofline.analysis``.

Per serving stage on one card:

    compute term = 2 * params_h * tokens / PEAK_FLOPS_BF16
    memory term  = (calls * params_h + 2 * tokens * d_model) * 2 bytes / HBM_BW

Whole program on a mesh (``RooflineReport``, from the dry run's counts):

    compute term    = FLOPs / (devices * PEAK_FLOPS_BF16)
    memory term     = bytes / (devices * HBM_BW)
    collective term = collective_bytes / (devices * LINK_BW)

The reference takes FLOPs and bytes from XLA's ``cost_analysis`` and the
collective bytes from the SPMD HLO; ``build_report`` takes the dry run's
per-device counts (``launch.dryrun``) and ``roofline.collectives``' stats.
MODEL_FLOPS = 6*N*D for dense archs (6*N_active*D for MoE) measures how much
of the counted compute is "useful": recompute, padding and dead work show up
as a low ratio.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.profiles import stage_param_counts
from repro_torch.roofline import constants
from repro_torch.roofline.collectives import CollectiveStats


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    num_devices: int
    hlo_flops: float  # counted FLOPs, all devices (the reference's HLO FLOPs)
    hlo_bytes: float  # counted bytes, all devices
    collective: CollectiveStats
    model_flops: float
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops > 0 else 0.0

    @property
    def roofline_fraction(self) -> float:
        """What fraction of the bound-term time is useful model compute:
        model_flops_time / achievable_step_time."""
        ideal = self.model_flops / (self.num_devices * constants.PEAK_FLOPS_BF16)
        return ideal / self.bound_s if self.bound_s > 0 else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "devices": self.num_devices,
            "hlo_gflops": self.hlo_flops / 1e9,
            "hlo_gbytes": self.hlo_bytes / 1e9,
            "coll_gbytes_global": self.collective.global_bytes / 1e9,
            "compute_ms": self.compute_s * 1e3,
            "memory_ms": self.memory_s * 1e3,
            "collective_ms": self.collective_s * 1e3,
            "dominant": self.dominant,
            "model_gflops": self.model_flops / 1e9,
            "useful_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


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


def model_flops_for(cfg, shape) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); decode counts one new token."""
    n = cfg.param_count(active_only=cfg.moe is not None)
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens  # forward only
    # decode: one token per sequence; attention reads the cache but
    # param-FLOPs dominate the 6ND-style accounting (2*N per token fwd)
    return 2.0 * n * shape.global_batch


def build_report(
    *,
    arch: str,
    shape_name: str,
    mesh_name: str,
    num_devices: int,
    flops_per_device: float,
    bytes_per_device: float,
    collective: CollectiveStats,
    model_flops: float,
) -> RooflineReport:
    """The three-term report from one device's counted FLOPs and bytes (the
    SPMD program is the same on every device; globalized here)."""
    flops = float(flops_per_device) * num_devices
    nbytes = float(bytes_per_device) * num_devices
    return RooflineReport(
        arch=arch,
        shape=shape_name,
        mesh=mesh_name,
        num_devices=num_devices,
        hlo_flops=flops,
        hlo_bytes=nbytes,
        collective=collective,
        model_flops=model_flops,
        compute_s=flops / (num_devices * constants.PEAK_FLOPS_BF16),
        memory_s=nbytes / (num_devices * constants.HBM_BW),
        collective_s=collective.global_bytes / (num_devices * constants.LINK_BW),
    )
