"""Logical-axis sharding rules (DP/TP/SP/EP) with divisibility fallbacks:
the counterpart of ``repro.sharding.specs``.

Models are written as global math; this module decides layouts:

  * ``param_specs(params)`` — a ``PartitionSpec`` tree for the parameter
    tree, keyed off leaf path names (w_q/w_down/embed/...).  2-D weights get
    (fsdp, tp) or (tp, fsdp); stacked period leaves get a leading None.
  * ``constrain(x, *logical)`` — ``DTensor.redistribute`` to the layout of
    the logical axis names ("batch", "seq", "tp", ...); a no-op for a plain
    tensor, with no mesh installed, or where a dim is not divisible by its
    axis size.

Logical axes:
  batch -> ("pod", "data") when the mesh has a pod axis, else ("data",)
  fsdp  -> "data"   (ZeRO/FSDP weight + optimizer-state sharding)
  tp    -> "model"  (tensor parallel)
  seq   -> "model"  (Megatron-style sequence parallelism of the residual
                     stream between blocks)

A spec is a ``PartitionSpec``: a tuple with, per tensor dim, a mesh axis
name, a tuple of names (the dim split over those axes, major first) or None.
The rules read only a mesh's axis names and sizes, so they take a
``torch.distributed.DeviceMesh`` or an ``AbstractMesh`` (names and sizes,
no process group).  ``placements(spec, mesh)`` turns a spec into DTensor
placements over a ``DeviceMesh`` (the reference's ``named_shardings``).
"""
from __future__ import annotations

import dataclasses
import math
import os
import re
import threading
from typing import Any

import torch
from torch.utils._pytree import MappingKey, SequenceKey, tree_map, tree_map_with_path

_state = threading.local()


class PartitionSpec(tuple):
    """Per tensor dim: an axis name, a tuple of names, or None.  A tuple
    subclass, so a tree of specs keeps each spec as one leaf."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes alone (no devices, no process group)."""
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis name: size}`` of an ``AbstractMesh`` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class MeshRules:
    mesh: Any  # DeviceMesh | AbstractMesh
    batch_axes: tuple[str, ...]
    fsdp_axis: str | None
    tp_axis: str | None

    @classmethod
    def standard(cls, mesh) -> "MeshRules":
        names = tuple(mesh_shape(mesh))
        batch = tuple(a for a in ("pod", "data") if a in names)
        return cls(
            mesh=mesh,
            batch_axes=batch or (names[0],),
            fsdp_axis="data" if "data" in names else None,
            tp_axis="model" if "model" in names else None,
        )

    def as_serving(self) -> "MeshRules":
        """Inference layout: weights TP-sharded only, REPLICATED across the
        data axis (no FSDP): decode reads every weight every step, and an
        FSDP layout would all-gather the whole model per token."""
        return dataclasses.replace(self, fsdp_axis=None)

    @classmethod
    def pure_dp(cls, mesh) -> "MeshRules":
        """All mesh axes act as data parallelism; no tensor parallelism (for
        models far smaller than the mesh): weights replicate, every device
        gets its own batch rows, the gradient reduction is the only
        collective left."""
        names = tuple(mesh_shape(mesh))
        batch = tuple(a for a in ("pod", "data", "model") if a in names)
        return cls(
            mesh=mesh,
            batch_axes=batch or names,
            fsdp_axis="data" if "data" in names else None,
            tp_axis=None,
        )

    def axis_size(self, axis: str | tuple[str, ...] | None) -> int:
        if axis is None:
            return 1
        if isinstance(axis, str):
            axis = (axis,)
        shape = mesh_shape(self.mesh)
        return math.prod(shape[a] for a in axis)

    def resolve(self, logical: str | None):
        if logical is None:
            return None
        if logical == "batch":
            return self.batch_axes if len(self.batch_axes) > 1 else self.batch_axes[0]
        if logical == "fsdp":
            return self.fsdp_axis
        if logical in ("tp", "seq", "vocab"):
            return self.tp_axis
        raise ValueError(f"unknown logical axis {logical!r}")


def set_mesh(mesh, policy: str = "dp_tp") -> MeshRules:
    if policy == "pure_dp":
        rules = MeshRules.pure_dp(mesh)
    elif policy == "dp_tp":
        rules = MeshRules.standard(mesh)
    else:
        raise ValueError(f"unknown sharding policy {policy!r}")
    _state.rules = rules
    return rules


def get_mesh() -> MeshRules | None:
    return getattr(_state, "rules", None)


def clear_mesh() -> None:
    _state.rules = None


# ---------------------------------------------------------------------------
# Specs to DTensor placements
# ---------------------------------------------------------------------------


def placements(spec: tuple, mesh) -> list:
    """DTensor placements of ``spec`` over a ``DeviceMesh``: per mesh dim,
    ``Shard(d)`` for the tensor dim ``d`` whose entry names it (if the dim
    has more than one device), else ``Replicate()``.  A dim split over several axes is split in mesh order,
    so its tuple must list them in that order."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} out of the mesh's order {names}")
        for i in idx:
            # a split over one device is no split: left replicated, so a dim
            # is not sharded over a size-1 axis beside a real one (DTensor
            # plans such redistributions by a search that grows with the mesh)
            if mesh.size(i) > 1:
                out[i] = Shard(d)
    return out


def local_chunk(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's shard of the whole tensor ``x`` under ``spec`` (a dim
    split over several axes is cut in mesh order, as ``placements`` lays
    it out)."""
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        idx, n = 0, 1
        for a in ((entry,) if isinstance(entry, str) else entry):
            i = names.index(a)
            idx, n = idx * mesh.size(i) + coord[i], n * mesh.size(i)
        x = torch.chunk(x, n, dim=d)[idx]
    return x


def distribute(x: torch.Tensor, spec: tuple, mesh, device=None):
    """A DTensor of ``x`` laid out by ``spec``.  Every rank holds the whole
    ``x`` (the same seed) and keeps a copy of its own shard (on ``device``
    if given; ``x`` itself where the shard is all of it), so nothing
    crosses the wire.  A meta ``x`` gives a meta shard; a DTensor ``x`` is
    redistributed to ``spec``."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements(spec, mesh))
    local = local_chunk(x, spec, mesh)
    if device is not None:
        local = local.to(device, copy=True)
    elif local.numel() < x.numel():
        local = local.clone()  # its own storage: the shard is all a device holds
    return DTensor.from_local(local, mesh, placements(spec, mesh), run_check=False,
                              shape=x.shape, stride=x.stride())


def distribute_tree(tree: Any, specs: Any, mesh) -> Any:
    """``distribute`` leaf by leaf over two trees of the same structure."""
    return tree_map(lambda s, x: distribute(x, s, mesh), specs, tree)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a ``DeviceMesh`` (the reference's ``NamedSharding``)."""
    mesh: Any
    spec: PartitionSpec


def named_shardings(specs: Any, mesh) -> Any:
    return tree_map(lambda s: NamedSharding(mesh, s), specs)


def local_shard_shape(shape, spec: tuple, axes: dict[str, int]) -> tuple[int, ...]:
    """The shape of one device's shard of a ``shape`` tensor under ``spec``
    (divisible dims, as the rules make them)."""
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        out[d] = -(-out[d] // math.prod(axes[a] for a in names))
    return tuple(out)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose gradient is made contiguous: a local shard's gradient
    goes back into a DTensor, whose views assume its shards are laid out
    densely."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local_shard(a, mesh, target: list, grad: list | None = None) -> torch.Tensor:
    """This device's shard of ``a`` laid out as ``target`` (a DTensor is
    redistributed there if it is not, a plain tensor, taken as replicated,
    is cut here), its gradient coming back laid out as ``grad`` (default
    ``target``)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(a, DTensor):
        a = a.redistribute(mesh, target) if list(a.placements) != list(target) else a
    else:
        a = distribute_tensor(a, mesh, target, src_data_rank=None)
    a = a.to_local(grad_placements=grad or target)
    return _ContiguousGrad.apply(a) if a.requires_grad else a


def local_map(fn, args: tuple, roles: tuple, out_roles: tuple):
    """Run ``fn`` on the local shards of ``args`` (DTensors or plain
    tensors, the latter taken as replicated) and wrap its outputs.

    ``roles[i]`` names each dim of ``args[i]``: "b" (batch rows), "h"
    (heads), "s" (sequence), "c" (channels), "v" (vocab) or None.  Per
    mesh dim, the DTensor arguments are read in order and the first that
    shards one of its dims with a role there decides: that mesh dim stays
    sharded, and every argument with that role is laid out sharded alike
    along it (if each such dim divides); a mesh dim no argument shards by a
    role is gathered.  So the first DTensor argument's layout comes first
    (lead with the argument whose split must stay, a sharded cache's
    sequence, say), and a later one's role fills a mesh dim the first
    leaves unsplit (a vocab-split head beside batch-split rows).
    ``out_roles`` names the outputs' dims.
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    dts = [(a, r) for a, r in zip(args, roles) if isinstance(a, DTensor)]
    mesh = dts[0][0].device_mesh
    kept: list[str | None] = []
    split: dict[str, int] = {}
    for i in range(mesh.ndim):
        role = None
        for a, r in dts:
            p = a.placements[i]
            cand = r[p.dim] if isinstance(p, Shard) else None
            if cand is None:
                continue
            n = split.get(cand, 1) * mesh.size(i)
            if not any(cand in r_ and a_.shape[r_.index(cand)] % n for a_, r_ in zip(args, roles)):
                role = cand
                split[cand] = n
                break
        kept.append(role)

    def layout(r):
        return [Shard(r.index(k)) if k is not None and k in r else Replicate() for k in kept]

    local = []
    for a, r in zip(args, roles):
        target = layout(r)
        # an argument replicated along a mesh dim that splits the others'
        # rows or heads gets only this device's part of its gradient there
        grad = [Partial() if k is not None and k not in r else p for k, p in zip(kept, target)]
        local.append(local_shard(a, mesh, target, grad))
    out = fn(*local)
    if isinstance(out, tuple):
        return tuple(DTensor.from_local(o, mesh, layout(r), run_check=False)
                     for o, r in zip(out, out_roles))
    return DTensor.from_local(out, mesh, layout(out_roles[0]), run_check=False)


# ---------------------------------------------------------------------------
# Activation constraints
# ---------------------------------------------------------------------------


def _spec_for(shape: tuple[int, ...], logical: tuple[str | None, ...], rules: MeshRules) -> P:
    parts = []
    for dim, name in zip(shape, logical):
        axis = rules.resolve(name)
        if axis is None:
            parts.append(None)
            continue
        size = rules.axis_size(axis)
        parts.append(axis if dim % size == 0 and dim >= size else None)
    return P(*parts)


def activation_spec(shape: tuple[int, ...], *logical: str | None) -> P | None:
    rules = get_mesh()
    if rules is None:
        return None
    if len(logical) < len(shape):
        logical = tuple(logical) + (None,) * (len(shape) - len(logical))
    return _spec_for(tuple(shape), logical, rules)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (a tensor laid out over a device mesh)."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def split_dims(x, dim: int) -> list[int]:
    """The mesh dims (of more than one device) along which the DTensor ``x``
    splits its dim ``dim``; [] for a plain tensor."""
    if not is_dtensor(x):
        return []
    from torch.distributed.tensor import Shard

    dim %= x.ndim
    return [i for i, p in enumerate(x.placements)
            if isinstance(p, Shard) and p.dim == dim and x.device_mesh.size(i) > 1]


def mesh_scope(*trees: Any):
    """The context a step runs in: with a DTensor among the first leaves of
    ``trees`` (the parameters, say), plain tensors the step makes (positions,
    masks, constants) are taken as replicated over the mesh
    (``implicit_replication``); otherwise nothing."""
    import contextlib

    from torch.utils._pytree import tree_leaves

    for tree in trees:
        leaves = tree_leaves(tree)
        if leaves and is_dtensor(leaves[0]):
            from torch.distributed.tensor.experimental import implicit_replication

            return implicit_replication()
    return contextlib.nullcontext()


def _within(entry, names: set):
    """A spec entry with the axes outside ``names`` dropped (None if none
    is left)."""
    if entry is None:
        return None
    axes = tuple(a for a in ((entry,) if isinstance(entry, str) else entry) if a in names)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def constrain(x, *logical: str | None):
    """Redistribute the DTensor ``x`` to the layout of ``logical``; a no-op
    for a plain tensor or without an installed mesh."""
    rules = get_mesh()
    if rules is None or not is_dtensor(x):
        return x
    spec = activation_spec(x.shape, *logical)
    # axes the tensor's mesh lacks (a pod's sub-mesh has no "pod") are left out
    names = set(x.device_mesh.mesh_dim_names)
    spec = P(*(_within(e, names) for e in spec))
    target = placements(spec, x.device_mesh)
    if tuple(target) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, target)


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

# leaf-name -> logical layout for the *trailing* dims (stacked period dims get
# a leading None automatically).  "in" = (fsdp, tp), "out" = (tp, fsdp).
_IN_PROJ = (
    "w_q|w_k|w_v|w_gate|w_up|up_proj|in_proj|w_if|w_gates|router|w_dkv|w_kpe|"
    "w_uk|w_uv"
)
_OUT_PROJ = "w_o|w_down|down_proj|out_proj"

_RULES: list[tuple[re.Pattern, tuple[str | None, ...]]] = [
    (re.compile(r"embed$"), ("tp", "fsdp")),
    (re.compile(r"lm_head$"), ("fsdp", "tp")),
    (re.compile(rf"({_IN_PROJ})$"), ("fsdp", "tp")),
    (re.compile(rf"({_OUT_PROJ})$"), ("tp", "fsdp")),
    (re.compile(r"(conv_w)$"), (None, "tp")),
    (re.compile(r"(conv_b|b_q|b_k|b_v|if_bias|gate_bias)$"), ("tp",)),
    (re.compile(r"r_gates$"), (None, None, "tp")),
    (re.compile(r"(scale|bias|a_log|d_skip|dt_bias)$"), (None,)),
]


def _leaf_logical(path_str: str, ndim: int) -> tuple[str | None, ...]:
    for pat, layout in _RULES:
        if pat.search(path_str):
            if len(layout) > ndim:
                return layout[-ndim:] if ndim > 0 else ()
            return (None,) * (ndim - len(layout)) + tuple(layout)
    return (None,) * ndim


def _path_str(path) -> str:
    parts = []
    for k in path:
        if isinstance(k, MappingKey):
            parts.append(str(k.key))
        elif isinstance(k, SequenceKey):
            parts.append(str(k.idx))
        else:
            parts.append(str(k))
    return "/".join(parts)


def param_specs(params: Any, rules: MeshRules | None = None) -> Any:
    """PartitionSpec tree for a parameter (or gradient/opt-state) tree."""
    rules = rules or get_mesh()

    def spec_leaf(path, leaf):
        ps = _path_str(path)
        ndim = len(leaf.shape)
        logical = _leaf_logical(ps, ndim)
        # stacked period params under stages/: the leading dim is the stack
        if "stages" in ps and ndim >= 1 and len(logical) == ndim and ndim > 1:
            logical = (None,) + logical[1:]
        if rules is None:
            return P()
        return _spec_for(tuple(leaf.shape), logical, rules)

    return tree_map_with_path(spec_leaf, params)


# ---------------------------------------------------------------------------
# Batch + KV/state cache specs (serving)
# ---------------------------------------------------------------------------


def batch_specs(batch: Any, rules: MeshRules | None = None) -> Any:
    """Shard dim 0 (global batch) over the batch axes, rest replicated."""
    rules = rules or get_mesh()

    def one(leaf):
        if rules is None:
            return P()
        return _spec_for(tuple(leaf.shape), ("batch",) + (None,) * (len(leaf.shape) - 1), rules)

    return tree_map(one, batch)


# cache leaf name -> (num_trailing_dims, kind)
#   kind "kv"    : (..., B, S, *rest)  — batch over data, seq over model
#   kind "state" : (..., B, H, *rest)  — batch over data, heads over model
#   kind "convd" : (..., B, K, D)      — batch over data, D over model
#   kind "scalar": replicated
_CACHE_KINDS: dict[str, tuple[int, str]] = {
    "k": (4, "kv"),
    "v": (4, "kv"),
    "c_kv": (3, "kv"),
    "k_pe": (3, "kv"),
    "ssd": (4, "state"),
    "C": (4, "state"),
    "n": (3, "state"),
    "m": (2, "state"),
    "c": (3, "state"),
    "h": (3, "state"),
    "conv": (3, "convd"),
    "pos": (0, "scalar"),
    "slot_pos": (1, "scalar"),
}


def _axes_tuple(axis) -> tuple[str, ...]:
    if axis is None:
        return ()
    return axis if isinstance(axis, tuple) else (axis,)


def cache_specs(cache: Any, rules: MeshRules | None = None) -> Any:
    """PartitionSpec tree for decode caches (stacked or unstacked).

    Policy: shard batch over the batch axes and the long dim (sequence for
    KV, heads for recurrent state) over the model axis.  When the batch is
    too small to shard (long context, batch 1), the long dim is sharded over
    (data x model) jointly: the distributed flash-decode layout, every
    device holding a KV slice.  ``REPRO_CACHE_SHARD=feature`` shards a KV
    leaf's trailing feature dim over the model axis instead (the default
    "seq" keeps the sequence).  Every choice degrades to replication when a
    dim is not divisible.
    """
    rules = rules or get_mesh()

    def leaf_spec(path, leaf):
        if rules is None:
            return P()
        name = None
        for k in reversed(path):
            if isinstance(k, MappingKey) and isinstance(k.key, str):
                name = k.key
                break
        shape = tuple(leaf.shape)
        nd = len(shape)
        info = _CACHE_KINDS.get(name)
        if info is None or info[1] == "scalar":
            return P(*([None] * nd))
        trailing, kind = info
        off = nd - trailing  # leading stack dims (periods)
        parts: list = [None] * nd
        b_dim = off
        long_dim = nd - 1 if kind == "convd" else off + 1  # convd: the channel dim
        feature_first = kind == "kv" and os.environ.get("REPRO_CACHE_SHARD", "seq") == "feature"
        batch_axis = rules.resolve("batch")
        model_axis = rules.resolve("tp")
        b_size = rules.axis_size(batch_axis)
        m_size = rules.axis_size(model_axis)
        b_ok = batch_axis is not None and shape[b_dim] % b_size == 0 and shape[b_dim] >= b_size
        if b_ok:
            parts[b_dim] = batch_axis
            feat_dim = nd - 1
            if (
                feature_first
                and model_axis is not None
                and shape[feat_dim] % m_size == 0
                and shape[feat_dim] >= m_size
            ):
                parts[feat_dim] = model_axis
            elif model_axis is not None and shape[long_dim] % m_size == 0 and shape[long_dim] >= m_size:
                parts[long_dim] = model_axis
        else:
            # batch unshardable: spread the long dim over every axis we can
            all_axes = _axes_tuple(batch_axis) + _axes_tuple(model_axis)
            total = rules.axis_size(all_axes) if all_axes else 1
            if all_axes and shape[long_dim] % total == 0 and shape[long_dim] >= total:
                parts[long_dim] = all_axes
            elif model_axis is not None and shape[long_dim] % m_size == 0:
                parts[long_dim] = model_axis
        return P(*parts)

    return tree_map_with_path(leaf_spec, cache)


def constrain_like_params(tree: Any) -> Any:
    """Redistribute a params-shaped tree of DTensors (e.g. gradients) to the
    param layout: told the target at the partial-sum source, a gradient's
    cross-data reduction becomes a reduce-scatter (ZeRO-2) instead of an
    all-reduce.  A no-op without an installed mesh, and for plain leaves."""
    rules = get_mesh()
    if rules is None:
        return tree
    specs = param_specs(tree, rules)
    return tree_map(lambda s, x: x if not is_dtensor(x) else
                    x.redistribute(x.device_mesh, placements(s, x.device_mesh)),
                    specs, tree)
