"""The benchmark's weights: made from ``--seed`` on the device, in the tree
the program's engine takes and in the types it serves them in.

The tree's shapes and dtypes come from the program's own meta-device init
(nothing drawn).  Every bf16 leaf is a view of one flat bf16 buffer, every
f32 leaf of one flat f32 buffer; each buffer is filled with standard
normals by one call on the card's generator, then each leaf is scaled in
place:

* a weight matrix ``[..., in, out]`` to std ``1 / sqrt(in)`` (the
  embedding table, a lookup, keeps std 1);
* a norm's scale to ``1 + 0.1 z``, every bias (the norms', Q/K/V's) to
  ``0.1 z``, so that a program that dropped a scale or a bias would part
  from the reference.

The reference reads the same tensors.
"""
from __future__ import annotations

import math

import torch


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _rebuild(tree, fill, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, fill, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, fill, path + (i,)) for i, v in enumerate(tree))
    return fill[path]


def make_weights(meta_tree, seed: int, device) -> dict:
    """The tree of ``meta_tree`` (meta tensors) filled from ``seed`` on ``device``."""
    leaves = list(_leaves(meta_tree))
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    filled = {}
    for dtype in (torch.bfloat16, torch.float32):
        group = [(p, t) for p, t in leaves if t.dtype == dtype]
        if not group:
            continue
        flat = torch.empty(sum(t.numel() for _, t in group), dtype=dtype, device=device)
        flat.normal_(generator=gen)
        off = 0
        for path, t in group:
            leaf = flat[off:off + t.numel()].view(t.shape)
            off += t.numel()
            name = path[-1]
            if name == "embed":
                pass
            elif name == "scale":
                leaf.mul_(0.1).add_(1.0)
            elif name == "bias" or name.startswith("b_"):
                leaf.mul_(0.1)
            elif t.dim() >= 2:
                leaf.mul_(1.0 / math.sqrt(t.shape[-2]))
            else:
                raise ValueError(f"no law for the weight leaf {'/'.join(map(str, path))}")
            filled[path] = leaf
    return _rebuild(meta_tree, filled)
