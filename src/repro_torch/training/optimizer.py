"""AdamW on trees of tensors: the counterpart of ``repro.training.optimizer``.

The state mirrors the parameter tree leaf for leaf (``{"m": ..., "v": ...,
"step": int32 []}``, m and v in f32).  The math is the reference's: linear
warmup then cosine decay to ``min_lr_ratio``, clipping by the global norm,
bias-corrected moments, and decoupled weight decay on every leaf with
``ndim >= 2``.  Block leaves are stacked over their stage's periods, so that
rule also decays the stacked norm scales and QKV biases (``[n_periods, d]``),
as the reference does.

``adamw_update`` writes the new parameters and moments into the tensors it
is given, under ``torch.no_grad()``: at full width an out-of-place update
would hold a second copy of the f32 masters.  It returns ``(params, state,
metrics)`` as the reference does, the trees holding the same tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def init_opt_state(params: Any) -> dict:
    """Zero f32 moments shaped like ``params`` and a zero int32 step counter
    (on the first leaf's device)."""
    device = tree_leaves(params)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=device)  # noqa: E731
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def lr_schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_ratio`` (f32 scalar)."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.learning_rate * warm * decay


def _square_sum(leaf: torch.Tensor) -> torch.Tensor:
    """The f32 sum of squares of a leaf; of a DTensor leaf, summed over its
    shards (a plain scalar on every rank)."""
    s = torch.sum(torch.square(leaf.float()))
    return s.full_tensor() if hasattr(s, "full_tensor") else s


def global_norm(tree: Any) -> torch.Tensor:
    """The f32 2-norm over every leaf of ``tree``."""
    return torch.sqrt(torch.sum(torch.stack([_square_sum(leaf) for leaf in tree_leaves(tree)])))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    """``(grads scaled to a global norm of at most max_norm, the norm before)``."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), norm


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: dict, cfg: AdamWConfig
                 ) -> tuple[Any, dict, dict]:
    """One AdamW step, in place; returns (params', state', metrics) with
    metrics ``grad_norm`` (before clipping) and ``lr``."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip_norm) if cfg.grad_clip_norm > 0 else None
    step = state["step"] + 1
    lr = lr_schedule(step, cfg)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()

    flat_p, spec = tree_flatten(params)
    flat_g = tree_leaves(grads)
    flat_m, flat_v = tree_leaves(state["m"]), tree_leaves(state["v"])
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("params, grads and optimizer state differ in their leaves")
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        g = g.float() if scale is None else g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if cfg.weight_decay > 0 and p.ndim >= 2:  # decay matrices (and stacked leaves) only
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    state_new = {"m": state["m"], "v": state["v"], "step": step}
    return params, state_new, {"grad_norm": gnorm, "lr": lr}
