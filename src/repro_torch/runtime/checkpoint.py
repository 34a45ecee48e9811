"""Fault-tolerant checkpointing: the counterpart of
``repro.runtime.checkpoint``, with its on-disk layout, so that either
package restores the other's checkpoint of an f32 / int32 tree.

Layout (one directory per step):

    <root>/step_00000123/
        manifest.json        # step, leaf index (name, key, dtype, shape), extra
        shard_00000.npz      # the leaves, ``leaf_00000`` ... in leaf order
    <root>/LATEST            # atomic pointer file

Leaves are named and ordered as ``jax.tree_util.tree_flatten_with_path``
names and orders them: dict keys sorted, list and tuple indices, joined by
``/``.  Writes go to ``step_x.tmp-<pid>`` and then ``os.replace``, so a torn
write is never seen as a checkpoint, and ``LATEST`` flips after the step
directory is in place.  The archive is the one ``np.savez`` writes, but
written and read one leaf at a time, a CUDA leaf through one page-locked
host buffer, so no more than one leaf is held on the host.

numpy has no bf16 without ``ml_dtypes`` (which the port does not use), so a
bf16 leaf is refused, on save and on restore; training state is f32 and
int32.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import time
import zipfile
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.sharding import distribute


def _leaf_paths(tree: Any, prefix: tuple[str, ...] = ()) -> Iterator[tuple[str, Any]]:
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaf_paths(tree[key], prefix + (str(key),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, prefix + (str(i),))
    elif tree is not None:
        yield "/".join(prefix), tree


def _rebuild(tree: Any, leaves: Iterator[Any]) -> Any:
    """``tree``'s structure with its leaves taken in order from ``leaves``."""
    if isinstance(tree, dict):
        rebuilt = {key: _rebuild(tree[key], leaves) for key in sorted(tree)}
        return {key: rebuilt[key] for key in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return None if tree is None else next(leaves)


class _Staging:
    """One page-locked host buffer, grown to the largest leaf it carries: a
    CUDA leaf crosses to the host (and back) through it, several times
    faster than through pageable memory."""

    def __init__(self) -> None:
        self._buf: torch.Tensor | None = None

    def view(self, dtype: torch.dtype, shape) -> torch.Tensor:
        n = max(1, math.prod(shape)) * torch.empty((), dtype=dtype).element_size()
        if self._buf is None or self._buf.numel() < n:
            self._buf = None
            self._buf = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        return self._buf[:n].view(dtype)[: math.prod(shape)].view(shape)


def _host_array(name: str, leaf: Any, staging: _Staging) -> np.ndarray:
    """The leaf as a C-ordered numpy array (a CUDA leaf through ``staging``,
    valid until its next use)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError(f"{name}: bf16 leaves cannot be checkpointed (numpy has no bf16)")
        leaf = leaf.detach()
        if leaf.is_cuda:
            return staging.view(leaf.dtype, leaf.shape).copy_(leaf).numpy()
        return np.require(leaf.numpy(), requirements="C")
    return np.require(np.asarray(leaf), requirements="C")


def _write_npy(f, arr: np.ndarray) -> None:
    """``arr`` in the .npy format (what ``np.save`` writes), its data in one write."""
    np.lib.format.write_array_header_1_0(f, np.lib.format.header_data_from_array_1_0(arr))
    f.write(memoryview(arr.reshape(-1)).cast("B"))


def _read_npy(f, staging: _Staging, device: torch.device | None) -> torch.Tensor:
    """A tensor on ``device`` from an .npy stream in C order (what both
    packages write), read straight into its host buffer (the staging buffer
    for a CUDA device; for ``device`` None the host tensor in the staging
    buffer itself, valid until its next use)."""
    version = np.lib.format.read_magic(f)
    read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                   else np.lib.format.read_array_header_2_0)
    shape, fortran, dtype = read_header(f)
    if fortran:
        raise ValueError("checkpoint leaf is in Fortran order")
    if device is None or device.type == "cuda":
        host = staging.view(torch.from_numpy(np.empty(0, dtype)).dtype, shape).numpy()
    else:
        host = np.empty(shape, dtype)
    view = memoryview(host.reshape(-1)).cast("B")
    if f.readinto(view) != view.nbytes:
        raise ValueError("checkpoint leaf is truncated")
    return torch.from_numpy(host) if device is None else torch.from_numpy(host).to(device)


@dataclasses.dataclass
class CheckpointManager:
    root: str
    keep: int = 3

    def __post_init__(self) -> None:
        os.makedirs(self.root, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: dict | None = None) -> str:
        final = os.path.join(self.root, f"step_{step:08d}")
        tmp = final + f".tmp-{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)

        index = []
        staging = _Staging()
        with zipfile.ZipFile(os.path.join(tmp, "shard_00000.npz"), "w",
                             compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
            for i, (name, leaf) in enumerate(_leaf_paths(tree)):
                arr = _host_array(name, leaf, staging)
                key = f"leaf_{i:05d}"
                with zf.open(key + ".npy", "w", force_zip64=True) as f:
                    _write_npy(f, arr)
                index.append({"name": name, "key": key, "dtype": str(arr.dtype),
                              "shape": list(arr.shape)})
                del arr
        manifest = {
            "step": step,
            "time": time.time(),
            "num_leaves": len(index),
            "index": index,
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)

        latest_tmp = os.path.join(self.root, f".LATEST.tmp-{os.getpid()}")
        with open(latest_tmp, "w") as f:
            f.write(os.path.basename(final))
            f.flush()
            os.fsync(f.fileno())
        os.replace(latest_tmp, os.path.join(self.root, "LATEST"))
        self._gc()
        return final

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"), ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.root):
            if name.startswith("step_") and ".tmp" not in name:
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> int | None:
        pointer = os.path.join(self.root, "LATEST")
        if os.path.exists(pointer):
            with open(pointer) as f:
                name = f.read().strip()
            if os.path.exists(os.path.join(self.root, name, "manifest.json")):
                return int(name.split("_")[1])
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like: Any, step: int | None = None,
                shardings: Any = None) -> tuple[Any, dict]:
        """Rebuild a tree shaped like ``tree_like``; returns (tree, manifest).

        ``tree_like`` holds tensors, or ``torch.empty(..., device="meta")``
        for shapes alone.  The leaf count, names and shapes are validated
        leaf by leaf, so restoring into another config fails loudly.  Each
        leaf comes back with the checkpoint's dtype, on its ``tree_like``
        leaf's device (the CPU for meta).  With ``shardings`` (a tree of
        ``sharding.NamedSharding`` shaped like ``tree_like``) each leaf comes
        back as a DTensor laid out by its sharding, on its mesh's device:
        read one leaf at a time (a CUDA mesh's through the page-locked
        buffer), each rank keeping its own shard.
        """
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.root}")
        d = os.path.join(self.root, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)

        want = list(_leaf_paths(tree_like))
        if len(want) != manifest["num_leaves"]:
            raise ValueError(
                f"checkpoint has {manifest['num_leaves']} leaves, model expects {len(want)}"
            )
        by_name = {e["name"]: e for e in manifest["index"]}
        flat_shardings = ([s for _, s in _leaf_paths(shardings)] if shardings is not None
                          else None)
        leaves = []
        staging = _Staging()
        with zipfile.ZipFile(os.path.join(d, "shard_00000.npz")) as zf:
            for i, (name, leaf) in enumerate(want):
                entry = by_name.get(name)
                if entry is None:
                    raise KeyError(f"checkpoint missing leaf {name!r}")
                if entry["dtype"] == "bfloat16":
                    raise TypeError(f"{name}: bf16 leaves cannot be restored (numpy has no bf16)")
                if tuple(entry["shape"]) != tuple(leaf.shape):
                    raise ValueError(
                        f"{name}: checkpoint shape {tuple(entry['shape'])} != model "
                        f"{tuple(leaf.shape)}"
                    )
                if flat_shardings is not None:
                    sh = flat_shardings[i]
                    on_card = sh.mesh.device_type == "cuda"
                    with zf.open(entry["key"] + ".npy") as f:
                        host = _read_npy(f, staging, None if on_card else torch.device("cpu"))
                    # the shard is copied out (of the staging buffer, or of
                    # the whole leaf) before the next leaf is read
                    leaves.append(distribute(host, sh.spec, sh.mesh, device=sh.mesh.device_type))
                    continue
                target = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
                target = "cpu" if torch.device(target).type == "meta" else target
                with zf.open(entry["key"] + ".npy") as f:
                    leaves.append(_read_npy(f, staging, torch.device(target)))
        return _rebuild(tree_like, iter(leaves)), manifest
