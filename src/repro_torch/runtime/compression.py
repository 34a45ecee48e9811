"""int8 gradient compression with error feedback: the counterpart of
``repro.runtime.compression``.

A per-tensor symmetric scale (``max|x| / 127``), values rounded half to
even (``torch.round``, as ``jnp.round``) and clipped to [-127, 127]; the
residual of each step (input minus its dequantized value) is fed back into
the next step's input, so the bias does not accumulate.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map, tree_unflatten


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (q int8, scale f32)."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads: Any, error: Any) -> tuple[Any, Any, Any]:
    """Quantize ``grads + error`` leaf by leaf; returns (q_tree,
    scale_tree, new_error), new_error the residual fed back next step."""
    flat_g, spec = tree_flatten(grads)
    flat_e = tree_leaves(error)
    q, s, e = [], [], []
    for g, err in zip(flat_g, flat_e):
        x = g.float() + err
        qi, si = quantize_int8(x)
        q.append(qi)
        s.append(si)
        e.append(x - dequantize_int8(qi, si))
    return tree_unflatten(q, spec), tree_unflatten(s, spec), tree_unflatten(e, spec)


def decompress_tree(q_tree: Any, s_tree: Any) -> Any:
    flat_q, spec = tree_flatten(q_tree)
    return tree_unflatten([dequantize_int8(q, s) for q, s in zip(flat_q, tree_leaves(s_tree))],
                          spec)


def init_error(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
