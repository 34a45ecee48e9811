"""Analytic cost corrections: the counterpart of
``repro.roofline.corrections``, copied.

In the reference the only loop the unrolled measurement cannot open is
sLSTM's per-timestep recurrence (h_{t-1} feeds the gates, trip count ==
seq_len): XLA counts its body once, and this module adds the missing
(seq_len - 1) iterations by a fit.  The port's dry run counts that loop as
a scan (``launch.dryrun.CostMode`` over ``models.layers.scan``): it runs a
step or two and counts the steady step's ops once for every step left,
which is exactly what running every step counts.  So nothing is corrected
here; the formula stays as the yardstick the counted steps are held to.

Per-step body cost (see ssm.slstm_cell):
  flops : recurrent gate matmul  B * H * P * 4P * 2   (+ O(B*H*P) elementwise)
  bytes : r_gates weights H*P*4P*4  +  state r/w ~ 9*B*H*P*4  +  w_t B*4d*4
Training multiplies flops by ~4 (fwd + remat-recompute-fwd + ~2x bwd).
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, ShapeSpec


def slstm_missing_cost(cfg: ArchConfig, shape: ShapeSpec) -> tuple[float, float]:
    """(extra_flops, extra_bytes) to add to fitted totals; (0, 0) if no sLSTM."""
    if cfg.xlstm is None or "slstm" not in cfg.period:
        return 0.0, 0.0
    if shape.mode == "decode":
        return 0.0, 0.0  # single step: body count is already right
    d = cfg.xlstm.d_model
    H = cfg.xlstm.num_heads
    P = d // H
    B = shape.global_batch
    S = shape.seq_len
    n_slstm = cfg.period.count("slstm") * (cfg.num_layers // len(cfg.period))

    per_step_flops = B * H * P * (4 * P) * 2 + 24.0 * B * H * P
    per_step_bytes = (
        H * P * 4 * P * 4.0  # r_gates re-read
        + 9.0 * B * H * P * 4.0  # carry state read/write
        + B * 4 * d * 4.0  # w_t slice
    )
    steps_missing = S - 1
    flops = per_step_flops * steps_missing * n_slstm
    nbytes = per_step_bytes * steps_missing * n_slstm
    if shape.mode == "train":
        flops *= 4.0  # fwd + remat fwd + ~2x bwd
        nbytes *= 3.0
    return flops, nbytes
