"""Collective traffic of a program run under a device mesh: the counterpart
of ``repro.roofline.hlo``.

The reference regexes the compiled SPMD HLO for every collective, its
result shape and its replica-group size.  Torch has no HLO: a DTensor
program issues its collectives eagerly as functional c10d ops
(``torch.ops._c10d_functional``), so ``CollectiveRecorder``, a dispatch
mode, records each one as ``(op kind, result bytes, group size)`` on the
local tensors of this rank, and ``collective_stats`` prices the records.

Per-device wire-bytes model (ring algorithms):
    all-gather        : result_bytes * (g-1)/g         (receives all but own shard)
    reduce-scatter    : result_bytes * (g-1)           (input = g * result)
    all-reduce        : 2 * result_bytes * (g-1)/g     (RS + AG phases)
    all-to-all        : result_bytes * (g-1)/g
    collective-permute: result_bytes

``global_bytes`` is per-device bytes * num_devices, so the roofline term
global_bytes / (devices * link_bw) reduces to per-device wire bytes over
per-device link bandwidth.  Groups of size 1 move nothing and are skipped.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_FACTORS = {
    "all-gather": lambda g: (g - 1) / g,
    "reduce-scatter": lambda g: float(g - 1),
    "all-reduce": lambda g: 2.0 * (g - 1) / g,
    "all-to-all": lambda g: (g - 1) / g,
    "collective-permute": lambda g: 1.0,
}


@dataclasses.dataclass
class CollectiveStats:
    per_device_bytes: float
    global_bytes: float
    by_op: dict[str, float]  # per-device bytes per op kind
    counts: dict[str, int]

    def dominant(self) -> str:
        return max(self.by_op, key=self.by_op.get) if self.by_op else "none"


def collective_stats(records: Iterable[tuple[str, int, int]], num_devices: int) -> CollectiveStats:
    """Price ``(op kind, result bytes, group size)`` records by the ring
    model; ``op kind`` is one of ``_FACTORS``' HLO names."""
    per_dev = 0.0
    by_op: dict[str, float] = defaultdict(float)
    counts: dict[str, int] = defaultdict(int)
    for op, nbytes, g in records:
        if g <= 1 and op != "collective-permute":
            continue  # degenerate group: no wire traffic
        moved = nbytes * _FACTORS[op](g)
        per_dev += moved
        by_op[op] += moved
        counts[op] += 1
    return CollectiveStats(
        per_device_bytes=per_dev,
        global_bytes=per_dev * num_devices,
        by_op=dict(by_op),
        counts=dict(counts),
    )


# functional c10d op -> (HLO name, index of its group-size argument or None)
_C10D_OPS = {
    "all_gather_into_tensor": ("all-gather", 1),
    "all_gather_into_tensor_coalesced": ("all-gather", 1),
    "reduce_scatter_tensor": ("reduce-scatter", 2),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 2),
    "all_reduce": ("all-reduce", None),
    "all_reduce_coalesced": ("all-reduce", None),
    "all_to_all_single": ("all-to-all", None),
}


def _tensor_bytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_tensor_bytes(o) for o in out)
    return 0


def _group_size(args: tuple, size_arg: int | None) -> int:
    if size_arg is not None:
        return int(args[size_arg])
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(args[-1]).size()


def c10d_record(func, args: tuple, out) -> tuple[str, int, int] | None:
    """``(op kind, result bytes, group size)`` of a functional c10d op, or
    None for any other op."""
    if func.namespace != "_c10d_functional":
        return None
    entry = _C10D_OPS.get(func._opname)
    if entry is None:
        return None
    kind, size_arg = entry
    return kind, _tensor_bytes(out), _group_size(args, size_arg)


class CollectiveRecorder(TorchDispatchMode):
    """Records every functional c10d collective issued while active."""

    def __init__(self) -> None:
        super().__init__()
        self.records: list[tuple[str, int, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        rec = c10d_record(func, args, out)
        if rec is not None:
            self.records.append(rec)
        return out

    def stats(self, num_devices: int) -> CollectiveStats:
        return collective_stats(self.records, num_devices)
