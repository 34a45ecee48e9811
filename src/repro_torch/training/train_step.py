"""The train step: the counterpart of ``repro.training.train_step``.

``make_train_step(cfg, opt_cfg, microbatches=k)`` returns ``(params,
opt_state, batch) -> (params', opt_state', metrics)``: the batch is cut into
k microbatches run one after another, their gradients accumulated in f32
(each stage's periods are recomputed in the backward pass, so activation
memory stays one period deep), then one AdamW step.  ``REPRO_BF16_PARAMS=1``
computes the loss on a bf16 copy of the f32 matrices, as in the reference.

Under a device mesh the trees hold DTensors laid out by
``sharding.param_specs`` / ``batch_specs``, and DTensor reduces the
gradients over the batch axes.  ``REPRO_GRAD_RS=1`` redistributes the
gradients to the parameters' layout (``constrain_like_params``: a partial
sum becomes a reduce-scatter).  ``make_compressed_train_step`` reduces the
gradients across the "pod" axis in int8 with error feedback instead.
"""
from __future__ import annotations

import os
from typing import Any, Callable

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as model_lib
from repro_torch.sharding import constrain_like_params, mesh_scope
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
        # a DTensor loss is reduced first (a partial sum would seed autograd
        # with a one on every rank)
        loss = _replicated(loss)
        grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(inputs, grads)]
    metrics = {k: _replicated(v).detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(grads, spec)


def _replicated(x: torch.Tensor) -> torch.Tensor:
    """A DTensor redistributed to every mesh dim replicated; a plain tensor
    as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(x, DTensor):
        return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)
    return x


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
        with mesh_scope(params):
            loss, grads, metrics = accumulate_grads(base_loss, params, batch, microbatches)
            # ZeRO-2 hint: the gradients in the parameters' layout, so the
            # cross-data reduction is a reduce-scatter, not an all-reduce
            if os.environ.get("REPRO_GRAD_RS", "0") == "1":
                grads = constrain_like_params(grads)
            params_new, opt_new, opt_metrics = opt_lib.adamw_update(params, grads, opt_state,
                                                                    opt_cfg)
        return params_new, opt_new, dict(metrics, **opt_metrics)

    return train_step


def _drop_axis(t: torch.Tensor, sub, axis: int) -> torch.Tensor:
    """The DTensor ``t`` seen on ``sub``, its mesh without mesh dim ``axis``
    (this rank's shard unchanged; a plain tensor where ``sub`` is None)."""
    from torch.distributed.tensor import DTensor

    if sub is None:
        return t.to_local()
    pl = [p for i, p in enumerate(t.placements) if i != axis]
    return DTensor.from_local(t.to_local(), sub, pl, run_check=False)


def _like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The DTensor ``g`` redistributed to ``p``'s placements (partial sums
    reduced); a plain ``g`` as it is."""
    from torch.distributed.tensor import DTensor

    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _add_axis(t: torch.Tensor, mesh, axis: int):
    """A tensor of one pod back on ``mesh``, replicated over dim ``axis``
    (this rank's shard unchanged)."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(t, DTensor):
        local, pl = t.to_local(), list(t.placements)
    else:
        local, pl = t, []
    pl.insert(axis, Replicate())
    return DTensor.from_local(local, mesh, pl, run_check=False)


def make_compressed_train_step(
    cfg: ArchConfig,
    mesh,
    opt_cfg: opt_lib.AdamWConfig | None = None,
    microbatches: int = 1,
):
    """Cross-pod int8 gradient reduction (the reference's beyond-paper
    optimization).

    ``mesh`` is a ``DeviceMesh`` with a "pod" axis; parameters, optimizer
    state and ``opt_state["error"]`` are DTensors replicated over "pod", and
    the batch arrives sharded over ("pod", "data").  Each pod computes the
    gradients of its own rows on the mesh without "pod" (reduced inside the
    pod by DTensor), quantizes them with error feedback
    (``runtime.compression.compress_tree``) and sums the int8 payloads as
    int32 over the pod axis's group, the scales reduced by max; the sum is
    dequantized and divided by the pod count, 4x less cross-pod traffic than
    an f32 all-reduce.  Loss and metrics are averaged over the pods; each
    pod keeps its own error residual, as the reference's does.
    """
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.runtime import compression

    opt_cfg = opt_cfg or opt_lib.AdamWConfig()
    base_loss = lambda p, b: model_lib.loss_fn(p, b, cfg)  # noqa: E731
    names = list(mesh.mesh_dim_names)
    axis = names.index("pod")
    npods = mesh.size(axis)
    sub = mesh[tuple(n for n in names if n != "pod")] if len(names) > 1 else None
    group = mesh.get_group("pod")

    def to_sub(tree):
        return tree_map(lambda t: _drop_axis(t, sub, axis), tree)

    def pod_sum(t: torch.Tensor, op) -> torch.Tensor:
        """All-reduce this rank's shard over the pod axis's group."""
        local = t.to_local() if isinstance(t, DTensor) else t
        local = local.clone()
        dist.all_reduce(local, op=op, group=group)
        if isinstance(t, DTensor):
            return DTensor.from_local(local, t.device_mesh, t.placements, run_check=False)
        return local

    def train_step(params: Any, opt_state: dict, batch: dict):
        p_sub, err_sub, b_sub = to_sub(params), to_sub(opt_state["error"]), to_sub(batch)
        with mesh_scope(p_sub):
            loss, grads, metrics = accumulate_grads(base_loss, p_sub, b_sub, microbatches)
            # the pod's own gradients, reduced inside the pod to the params' layout
            grads = tree_map(lambda g, p: _like(g, p), grads, p_sub)
            q, s, err_new = compression.compress_tree(grads, err_sub)
            # int8 payload across pods, accumulated in int32 against overflow
            q_sum = tree_map(lambda x: pod_sum(x.to(torch.int32), dist.ReduceOp.SUM), q)
            s_max = tree_map(lambda x: pod_sum(_replicated(x), dist.ReduceOp.MAX), s)
            grads_global = tree_map(lambda qi, si: qi.float() * si / npods, q_sum, s_max)
            loss = pod_sum(_replicated(loss), dist.ReduceOp.SUM) / npods
            metrics = {k: pod_sum(_replicated(v), dist.ReduceOp.SUM) / npods
                       for k, v in metrics.items()}
        grads_full = tree_map(lambda g: _add_axis(g, mesh, axis), grads_global)
        with mesh_scope(params):
            params_new, opt_new, opt_metrics = opt_lib.adamw_update(
                params, grads_full, {k: v for k, v in opt_state.items() if k != "error"}, opt_cfg)
        opt_new["error"] = tree_map(lambda e: _add_axis(e, mesh, axis), err_new)
        metrics = {k: _add_axis(v, mesh, axis) for k, v in metrics.items()}
        return params_new, opt_new, dict(metrics, **opt_metrics)

    return train_step
