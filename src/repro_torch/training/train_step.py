"""The train step: the counterpart of ``repro.training.train_step`` on one
device.

``make_train_step(cfg, opt_cfg, microbatches=k)`` returns ``(params,
opt_state, batch) -> (params', opt_state', metrics)``: the batch is cut into
k microbatches run one after another, their gradients accumulated in f32
(each stage's periods are recomputed in the backward pass, so activation
memory stays one period deep), then one AdamW step.  ``REPRO_BF16_PARAMS=1``
computes the loss on a bf16 copy of the f32 matrices, as in the reference.

Not here: the reference's ``REPRO_GRAD_RS`` (a sharding constraint, a no-op
without a mesh) and ``make_compressed_train_step`` (int8 gradients across
the pods of a mesh); both wait for the port's device mesh.
"""
from __future__ import annotations

import os
from typing import Any, Callable

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as model_lib
from repro_torch.training import optimizer as opt_lib


def _split_microbatches(batch: dict, k: int) -> list[dict]:
    """The batch as k microbatches along its first dim, in order."""
    def resh(x):
        b = x.shape[0]
        assert b % k == 0, f"batch {b} not divisible by microbatches {k}"
        return x.reshape(k, b // k, *x.shape[1:])

    split = {key: resh(v) for key, v in batch.items()}
    return [{key: v[i] for key, v in split.items()} for i in range(k)]


def value_and_grad(loss_fn: Callable, params: Any, batch: dict):
    """``(loss, metrics, grads)`` of ``loss_fn(params, batch) -> (loss,
    metrics)``, grads by autograd with respect to every leaf of ``params``
    (the leaves are differentiated through detached aliases, so the
    caller's tensors never require grad); metrics come back detached."""
    leaves, spec = tree_flatten(params)
    inputs = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten(inputs, spec), batch)
        grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(inputs, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(grads, spec)


def accumulate_grads(loss_fn: Callable, params: Any, batch: dict, k: int):
    """``(loss, grads, metrics)`` over k microbatches: grads accumulated in
    f32 as ``g / k``, loss as the sum of ``loss / k``, metrics averaged."""
    if k <= 1:
        loss, metrics, grads = value_and_grad(loss_fn, params, batch)
        return loss, grads, metrics
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    loss_sum = torch.zeros((), dtype=torch.float32, device=tree_flatten(params)[0][0].device)
    per_mb: list[dict] = []
    for mb in _split_microbatches(batch, k):
        loss, metrics, grads = value_and_grad(loss_fn, params, mb)
        with torch.no_grad():
            for a, g in zip(tree_flatten(acc)[0], tree_flatten(grads)[0]):
                a.add_(g.float() / k)
            loss_sum = loss_sum + loss / k
        per_mb.append(metrics)
    metrics = {key: torch.stack([m[key] for m in per_mb]).mean() for key in per_mb[0]}
    return loss_sum, acc, metrics


def _cast_matrices(params: Any, dtype) -> Any:
    """A copy of the f32 master tree with every matrix (``ndim >= 2``) in
    ``dtype``; 1-D leaves (norm scales, biases) stay f32."""
    return tree_map(lambda p: p.to(dtype) if p.dtype == torch.float32 and p.ndim >= 2 else p,
                    params)


def make_train_step(
    cfg: ArchConfig,
    opt_cfg: opt_lib.AdamWConfig | None = None,
    microbatches: int = 1,
    loss_fn: Callable | None = None,
):
    opt_cfg = opt_cfg or opt_lib.AdamWConfig()
    inner_loss = loss_fn or (lambda p, b: model_lib.loss_fn(p, b, cfg))
    if os.environ.get("REPRO_BF16_PARAMS", "0") == "1":
        base_loss = lambda p, b: inner_loss(_cast_matrices(p, cfg.dtype), b)  # noqa: E731
    else:
        base_loss = inner_loss

    def train_step(params: Any, opt_state: dict, batch: dict):
        loss, grads, metrics = accumulate_grads(base_loss, params, batch, microbatches)
        params_new, opt_new, opt_metrics = opt_lib.adamw_update(params, grads, opt_state, opt_cfg)
        return params_new, opt_new, dict(metrics, **opt_metrics)

    return train_step
