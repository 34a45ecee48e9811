"""Bridge ArchConfig -> ModelProfile: per-stage cost/accuracy profiles.

The paper drives its queueing layer from profiled per-stage costs (Table 2).
For the assigned architectures we derive the same quantities analytically:

  alpha_h : GFLOPs to run stage h for one request (2 * params_h * tokens,
            plus the attention term) — the forward-pass cost the ES pays.
  beta_h  : MB shipped into stage h — the residual stream (tokens x d_model
            x 2 bytes) for h > 1, token ids for h = 1.
  A_h     : branch accuracy — anchored to the paper's BERT branch curve,
            scaled into (floor, ceiling) by relative depth (synthetic; the
            engine's real exit decisions use live model confidences).
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core.types import ModelProfile
from repro_torch.models import moe as moe_lib


def stage_param_counts(cfg: ArchConfig) -> list[int]:
    """Approximate active parameters per stage (MoE counts top-k experts),
    as ``repro.core.profiles.stage_param_counts`` counts them: the Mamba
    block by its projections and conv, each xLSTM block as 6 d^2, the FFN
    as 3 d d_ff (GLU) or 2 d d_ff (MLP)."""
    d = cfg.d_model
    per_block: dict[str, int] = {}
    for kind in set(cfg.period):
        if kind == "mamba":
            m = cfg.mamba
            per_block[kind] = d * 2 * m.d_inner + m.d_inner * d + d * m.conv_dim
            continue
        if kind in ("mlstm", "slstm"):
            per_block[kind] = 6 * d * d  # projections + gates, coarse
            continue
        if cfg.mla is not None:
            m = cfg.mla
            attn = d * m.num_heads * m.qk_head_dim + d * (m.kv_lora_rank + m.qk_rope_head_dim)
            attn += m.kv_lora_rank * m.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
            attn += m.num_heads * m.v_head_dim * d
        else:
            a = cfg.attn_dims()
            attn = d * a.q_dim + 2 * d * a.kv_dim + a.q_dim * d
        if kind == "moe_attn":
            ffn = moe_lib.moe_active_params(cfg.moe)
        elif cfg.ffn == "mlp":
            ffn = 2 * d * cfg.d_ff  # two-matmul MLP
        else:
            ffn = 3 * d * cfg.d_ff  # GLU FFN
        per_block[kind] = attn + ffn
    return [n_periods * sum(per_block[k] for k in cfg.period) for n_periods in cfg.stage_periods()]


def profile_from_arch(
    cfg: ArchConfig,
    tokens_per_task: int = 128,
    acc_floor: float = 0.45,
    acc_ceiling: float = 0.75,
) -> ModelProfile:
    params_per_stage = stage_param_counts(cfg)
    alpha = tuple(2.0 * p * tokens_per_task / 1e9 for p in params_per_stage)
    beta_hidden = tokens_per_task * cfg.d_model * 2 / 1e6  # bf16 residuals, MB
    beta = (tokens_per_task * 4 / 1e6,) + (beta_hidden,) * (cfg.num_stages - 1)
    has_exit = tuple(
        (h + 1) in cfg.exit_stages for h in range(cfg.num_stages - 1)
    ) + (False,)
    depth = np.cumsum(cfg.stage_periods()) / sum(cfg.stage_periods())
    acc = acc_floor + (acc_ceiling - acc_floor) * np.sqrt(depth)
    branch_acc = tuple(
        float(acc[h]) if (h + 1 in cfg.exit_stages or h == cfg.num_stages - 1) else 0.0
        for h in range(cfg.num_stages)
    )
    return ModelProfile(
        name=cfg.name,
        alpha=alpha,
        beta=beta,
        has_exit=has_exit,
        branch_accuracy=branch_acc,
    )
